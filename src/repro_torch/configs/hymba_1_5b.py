"""hymba-1.5b: 32L d_model=1600 25H (GQA kv=5) d_ff=5504, parallel
attn+mamba heads, ssm_state=16; sliding-window attention with 3 global
full-attention layers (first/middle/last) [arXiv:2411.13676]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_head=64, d_ff=5504, vocab=32001,
    ssm_state=16, ssm_d_head=64, window=1024, global_layers=(0, 15, 31),
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="hymba-1.5b-reduced", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256, ssm_state=8,
        ssm_d_head=16, window=32, global_layers=(0, 3), max_seq=128)
