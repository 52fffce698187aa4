"""tinyllama-1.1b: 22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000
[arXiv:2401.02385; llama2-arch small]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=5632, vocab=32000,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="tinyllama-1.1b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, max_seq=128)
