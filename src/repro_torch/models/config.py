"""Unified model configuration covering all assigned architecture families.

A copy of the JAX package's ``repro.models.config`` (the port imports
nothing of ``repro``): the same fields, defaults and parameter counts, so
a configuration carries across unchanged.  Fields that only steer JAX
compilation or sharding are kept and say that they have no effect here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | ssm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: int = 0         # 0 -> = n_heads
    d_head: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0         # shared experts (each of width moe_d_ff)
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_d_head: int = 64
    conv_width: int = 4
    ssm_expand: int = 2         # d_inner = expand * d_model (mamba2)

    # hybrid (hymba): sliding-window attention + parallel SSM heads
    window: int = 0             # 0 -> full attention
    global_layers: Tuple[int, ...] = ()

    # VLM
    cross_attn_interval: int = 0    # 5 -> cross-attn at 5g+3 (llama-vision)
    n_img_tokens: int = 0

    # enc-dec (whisper; conv/mel frontend is a stub -> frame embeddings)
    encoder_layers: int = 0
    n_audio_frames: int = 0

    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    max_seq: int = 8192

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # As in the JAX package: when a gradient is taken, each layer runs
    # under torch.utils.checkpoint (models.zoo.forward) and its
    # activations are recomputed in the backward.
    remat: bool = True
    # Kept so configs carry across; no effect here.  On CUDA, attention
    # takes the hand-written flash kernel whenever the JAX package's shape
    # conditions for its Pallas kernel hold (repro_torch.models.common.
    # attention), on the CPU its plain PyTorch version.
    use_pallas_attention: bool = False
    # Kept so configs carry across; no effect here: the layer stack is a
    # Python loop over the stacked (L, ...) leaves.
    scan_layers: bool = True
    banded_attention: bool = False   # O(S-window) sliding-window blocks
    # As in the JAX package: the train step casts the float32 leaves to
    # bf16 once a step (train.step); the gradient lands on the float32
    # leaves.  No gathers here: nothing is sharded.
    cast_params_bf16: bool = False
    # Kept so configs carry across; no effect here (expert sharding:
    # nothing is sharded on one device).
    moe_mode: str = "auto"           # auto | ep | ftp (expert sharding)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        if self.family == "hybrid":
            return self.n_heads * self.head_dim
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return self.d_inner // self.ssm_d_head

    def n_params(self) -> int:
        """Total parameter count (used for 6·N·D roofline math).

        The JAX package's formula, kept as it is.  It leaves out the qkv
        biases (qwen2-0.5b, qwen2-moe-a2.7b) and counts the ssm, hybrid,
        vlm and audio trees otherwise than they are built (``ROADMAP.md``
        §3); the tree's own size is the sum of the sizes of
        ``models.api.abstract_params(cfg)``'s leaves."""
        d, ff, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        h, kv, hd = self.n_heads, self.kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "vlm", "audio", "hybrid"):
            per_layer += attn + 3 * d * ff + 2 * d
        if self.family == "moe":
            per_layer += attn + 2 * d
            per_layer += self.moe_experts * 3 * d * self.moe_d_ff
            per_layer += self.moe_shared * 3 * d * self.moe_d_ff
            per_layer += d * self.moe_experts
        if self.family == "ssm":
            din, ns, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            per_layer = (d * (2 * din + 2 * ns + nh) + din * d
                         + self.conv_width * (din + 2 * ns) + 2 * nh + d)
        if self.family == "hybrid":
            din, ns, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            per_layer += d * 2 * din + din * d + self.conv_width * (din + 2 * ns) \
                + d * 2 * ns + 2 * nh
        total = L * per_layer + emb + d
        if self.family == "vlm":
            k = self.n_layers // self.cross_attn_interval
            total += k * (attn + 2 * d)   # gated cross-attn blocks
        if self.family == "audio":
            total += self.encoder_layers * (attn + 3 * d * ff + 2 * d)
            total += self.n_audio_frames * d      # learned enc positions
        return int(total)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE): 6·N_active·D."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        routed_all = self.n_layers * self.moe_experts * 3 * d * self.moe_d_ff
        routed_act = self.n_layers * self.moe_top_k * 3 * d * self.moe_d_ff
        return self.n_params() - routed_all + routed_act
