"""whisper-small: enc-dec 12L+12L d_model=768 12H d_ff=3072 vocab=51865 —
conv/mel frontend STUB: input_specs() supplies 1500 frame embeddings
[arXiv:2212.04356]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865, encoder_layers=12,
    n_audio_frames=1500, max_seq=32768,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-small-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, encoder_layers=2,
        n_audio_frames=32, max_seq=128)
