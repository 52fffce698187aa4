"""moonshot-v1-16b-a3b: 48L d_model=2048 16H (kv=16) d_ff(expert)=1408
vocab=163840, MoE 64 experts top-6 [hf:moonshotai/Moonlight-16B-A3B]

The assignment specifies 64 routed experts, top-6 (no shared experts listed;
Moonlight itself carries 2 shared — we follow the assignment literally and
note the delta here)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=0, vocab=163840,
    moe_experts=64, moe_top_k=6, moe_shared=0, moe_d_ff=1408,
    rope_theta=50_000.0,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="moonshot-v1-16b-a3b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, vocab=256, moe_experts=8, moe_top_k=2,
        moe_d_ff=32, max_seq=128)
