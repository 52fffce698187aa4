"""qwen2-0.5b: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936,
QKV bias [arXiv:2407.10671]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense", n_layers=24, d_model=896, n_heads=14,
    n_kv_heads=2, d_ff=4864, vocab=151936, qkv_bias=True,
    tie_embeddings=True, rope_theta=1_000_000.0,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-0.5b-reduced", n_layers=2, d_model=56, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, max_seq=128)
