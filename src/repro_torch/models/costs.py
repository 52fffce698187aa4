"""Analytic FLOP/byte model (exact, auditable — the roofline compute term).

A copy of the JAX package's ``repro.models.costs`` (pure Python; the port
imports nothing of ``repro``): the same counts for every configuration, so
a model FLOP utilisation on the card is measured against the JAX
package's own count.  ``cell_flops(cfg, "train", b, s)`` counts forward,
backward (twice the forward) and, with ``cfg.remat``, the recomputed
forward.  ``attn_hbm_bytes`` counts the blocked-attention K/V re-reads
with the port's own chunk sizes (:mod:`repro_torch.models.common`).
"""
from __future__ import annotations

from .config import ModelConfig

BYTES = 2  # bf16 activations/weights on the wire


def _attn_flops(cfg: ModelConfig, b: int, s: int, t: int,
                causal: bool) -> float:
    """Score+value flops for one attention layer (projections excluded)."""
    h, hd = cfg.n_heads, cfg.head_dim
    pairs = b * s * t * (0.5 if causal and s == t else 1.0)
    return 2.0 * pairs * h * hd * 2       # qk^T and pv

def _proj_flops(cfg: ModelConfig, b: int, s: int) -> float:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    return 2.0 * b * s * (d * h * hd + 2 * d * kv * hd + h * hd * d)


def _mlp_flops(cfg: ModelConfig, b: int, s: int) -> float:
    return 2.0 * b * s * 3 * cfg.d_model * cfg.d_ff


def _moe_flops(cfg: ModelConfig, b: int, s: int) -> float:
    act = 2.0 * b * s * 3 * cfg.d_model * cfg.moe_d_ff * cfg.moe_top_k \
        * cfg.capacity_factor
    shared = 2.0 * b * s * 3 * cfg.d_model * cfg.moe_d_ff * cfg.moe_shared
    router = 2.0 * b * s * cfg.d_model * cfg.moe_experts
    return act + shared + router


def _ssm_flops(cfg: ModelConfig, b: int, s: int) -> float:
    d, din, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    proj = 2.0 * b * s * (d * (2 * din + 2 * ns + nh) + din * d)
    q = min(128, s)
    ssd = 2.0 * b * s * (q * ns + q * nh * cfg.ssm_d_head
                         + 2 * ns * nh * cfg.ssm_d_head)
    conv = 2.0 * b * s * cfg.conv_width * (din + 2 * ns)
    return proj + ssd + conv


def fwd_flops(cfg: ModelConfig, b: int, s: int, t: int | None = None) -> float:
    """Forward flops for s new tokens attending to t total positions."""
    t = t if t is not None else s
    causal = s == t
    f = 2.0 * b * s * cfg.d_model * cfg.vocab          # unembed
    f += 2.0 * b * s * cfg.d_model                      # embed gather ~free
    L = cfg.n_layers
    fam = cfg.family
    if fam in ("dense", "vlm"):
        f += L * (_proj_flops(cfg, b, s) + _attn_flops(cfg, b, s, t, causal)
                  + _mlp_flops(cfg, b, s))
        if fam == "vlm":
            g = L // cfg.cross_attn_interval
            f += g * (_proj_flops(cfg, b, s)
                      + _attn_flops(cfg, b, s, cfg.n_img_tokens, False)
                      + _mlp_flops(cfg, b, s))
    elif fam == "moe":
        f += L * (_proj_flops(cfg, b, s) + _attn_flops(cfg, b, s, t, causal)
                  + _moe_flops(cfg, b, s))
    elif fam == "ssm":
        f += L * _ssm_flops(cfg, b, s)
    elif fam == "hybrid":
        for l in range(L):
            if l in cfg.global_layers:
                tt = t
            elif getattr(cfg, "banded_attention", False):
                # banded sliding window: only the band is visited
                tt = min(cfg.window + 256, t)
            else:
                # baseline blocked attention scans the full key range and
                # masks outside the window (quadratic)
                tt = t
            f += (_proj_flops(cfg, b, s) + _attn_flops(cfg, b, s, tt, causal)
                  + _ssm_flops(cfg, b, s) + _mlp_flops(cfg, b, s))
    elif fam == "audio":
        se = cfg.n_audio_frames
        f += cfg.encoder_layers * (_proj_flops(cfg, b, se)
                                   + _attn_flops(cfg, b, se, se, False)
                                   + _mlp_flops(cfg, b, se))
        f += L * (_proj_flops(cfg, b, s) + _attn_flops(cfg, b, s, t, causal)
                  + _proj_flops(cfg, b, s)
                  + _attn_flops(cfg, b, s, se, False) + _mlp_flops(cfg, b, s))
    return f


def cell_flops(cfg: ModelConfig, kind: str, b: int, s: int) -> float:
    """Global analytic flops for one step of a (kind, batch, seq) cell."""
    if kind == "train":
        mult = 4.0 if cfg.remat else 3.0   # fwd + 2x bwd (+1 remat fwd)
        return mult * fwd_flops(cfg, b, s)
    if kind == "prefill":
        return fwd_flops(cfg, b, s)
    if kind == "decode":
        return fwd_flops(cfg, b, 1, t=s)
    raise ValueError(kind)


def attn_hbm_bytes(cfg: ModelConfig, kind: str, b: int, s: int) -> float:
    """Flash-attention HBM traffic not visible to the scanned-HLO probes:
    K/V re-read once per query chunk (q-chunk 512)."""
    if kind == "decode":
        return 0.0   # decode reads the cache once; probes capture it
    from .common import BLOCK_Q, BLOCK_THRESHOLD
    t = s
    if s * t <= BLOCK_THRESHOLD:
        return 0.0
    mult = 2.0 if kind == "train" else 1.0   # backward re-streams K/V
    kv_row = 2.0 * cfg.kv_heads * cfg.head_dim * BYTES

    def layer_bytes(t_eff, qc):
        nq = max(s // qc, 1)
        return nq * b * t_eff * kv_row

    if cfg.family == "hybrid":
        total = len(cfg.global_layers) * layer_bytes(t, BLOCK_Q)
        banded = getattr(cfg, "banded_attention", False)
        n_sw = cfg.n_layers - len(cfg.global_layers)
        t_sw = min(cfg.window + 256, t) if banded else t
        qc_sw = 256 if banded else BLOCK_Q
        total += n_sw * layer_bytes(t_sw, qc_sw)
        return mult * total
    return mult * cfg.n_layers * layer_bytes(t, BLOCK_Q)
