"""mamba2-130m: 24L d_model=768 attn-free, ssm_state=128 — SSD
[arXiv:2405.21060]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768, n_heads=24,
    d_ff=0, vocab=50280, ssm_state=128, ssm_d_head=64, ssm_expand=2,
    conv_width=4,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-130m-reduced", n_layers=2, d_model=64,
        n_heads=2, vocab=256, ssm_state=16, ssm_d_head=32, max_seq=128)
