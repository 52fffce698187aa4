"""deepseek-coder-33b: 62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256
[arXiv:2401.14196; llama-arch]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense", n_layers=62, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=19200, vocab=32256, rope_theta=100_000.0,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-coder-33b-reduced", n_layers=2, d_model=56,
        n_heads=4, n_kv_heads=2, d_ff=96, vocab=256, max_seq=128)
