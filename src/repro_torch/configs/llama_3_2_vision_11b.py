"""llama-3.2-vision-11b: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — gated cross-attn image layers every 5th layer (8 total);
vision tower is a STUB: input_specs() supplies patch embeddings
[hf:meta-llama/Llama-3.2-11B-Vision]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256,
    cross_attn_interval=5, n_img_tokens=1601, rope_theta=500_000.0,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llama-3.2-vision-11b-reduced", n_layers=10, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, cross_attn_interval=5,
        n_img_tokens=16, max_seq=128)
