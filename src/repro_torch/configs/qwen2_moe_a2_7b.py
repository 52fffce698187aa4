"""qwen2-moe-a2.7b: 24L d_model=2048 16H (kv=16) d_ff(expert)=1408
vocab=151936, MoE 60 experts top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=0, vocab=151936, qkv_bias=True,
    moe_experts=60, moe_top_k=4, moe_shared=4, moe_d_ff=1408,
    rope_theta=1_000_000.0,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-moe-a2.7b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, vocab=256, moe_experts=8, moe_top_k=2,
        moe_shared=2, moe_d_ff=32, max_seq=128)
