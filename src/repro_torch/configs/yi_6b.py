"""yi-6b: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
[arXiv:2403.04652; llama-arch GQA]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=4, d_ff=11008, vocab=64000, rope_theta=5_000_000.0,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="yi-6b-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, max_seq=128)
