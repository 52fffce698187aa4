"""Shared transformer layers (pure functions over param dicts).

The counterpart of the JAX package's ``repro.models.common``, with the
same layouts at every public function: activations (B, S, D), heads
(B, S, H, Dh), positions (B, S).  ``attention`` routes to the flash
kernel (:func:`repro_torch.kernels.ops.attention`) under the JAX
package's shape conditions for its Pallas kernel; on CUDA tensors that
launches the hand-written kernel, on CPU tensors its plain version.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops

from .config import ModelConfig

F32 = torch.float32

#: whether ``attention`` may take the flash-kernel route (see
#: :func:`einsum_route`)
_FLASH_ROUTE = contextvars.ContextVar("flash_route", default=True)


@contextlib.contextmanager
def einsum_route():
    """Within this context ``attention`` never takes the flash-kernel
    route: it computes what the JAX package computes with its Pallas
    kernel switched off.  A reference for the kernel route at full
    width."""
    with _route(False):
        yield


@contextlib.contextmanager
def _route(flash: bool):
    token = _FLASH_ROUTE.set(flash)
    try:
        yield
    finally:
        _FLASH_ROUTE.reset(token)


def current_route():
    """A context manager that restores the attention route in force now,
    for work that runs later and perhaps on another thread: the recompute
    of ``torch.utils.checkpoint`` runs in the backward, which the
    autograd engine runs on a thread of its own for CUDA tensors, where
    the route would be the default (the flash kernel)."""
    return _route(_FLASH_ROUTE.get())


def cdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); pos: (B, S) or (S,)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                     / half)
    if pos.dim() == 1:
        pos = pos[None, :]
    ang = pos[..., None].float() * freq                     # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _mask_logits(logits: torch.Tensor, q_pos: torch.Tensor,
                 k_pos: torch.Tensor, causal: bool,
                 window: int) -> torch.Tensor:
    """logits: (B, H, S, T); positions broadcastable (B, S)/(B, T)."""
    ok = torch.ones(logits.shape[-2:], dtype=torch.bool,
                    device=logits.device)[None, None]
    qp = q_pos[:, None, :, None]
    kp = k_pos[:, None, None, :]
    if causal:
        ok = ok & (qp >= kp)
    if window > 0:
        ok = ok & (qp - kp < window)
    return torch.where(ok, logits, -1e30)


#: chunk sizes for the blocked (flash-style) attention path
BLOCK_Q = 512
BLOCK_K = 1024
#: use blocked attention when S*T exceeds this (full scores would be large)
BLOCK_THRESHOLD = 2048 * 2048


def _blocked_attention(q, k, v, q_pos, k_pos, causal, window,
                       qc=BLOCK_Q, kc=BLOCK_K, banded: bool = False):
    """Online-softmax attention, chunked over queries and keys.

    Peak memory per step is (B, KV, rep, qc, kc) instead of (B, H, S, T).

    ``banded=True`` (sliding-window path): each query chunk visits only the
    k-chunks intersecting its [q-window, q] band — O(S·window) instead of
    O(S·T) compute/traffic.  Requires contiguous positions (train/prefill).
    """
    b, s, h, d = q.shape
    t = k.shape[1]
    kvh = k.shape[2]
    rep = h // kvh
    qc = min(qc, s)
    kc = min(kc, t)
    while s % qc:
        qc //= 2
    while t % kc:
        kc //= 2
    nq, nk = s // qc, t // kc
    qf = (q.float() / (d ** 0.5)).reshape(b, nq, qc, kvh, rep, d)
    qpos_c = q_pos.reshape(b, nq, qc)

    use_band = banded and window > 0 and causal
    # k-chunks per band: cover [qi*qc - window + 1 .. qi*qc + qc - 1]
    nk_band = min(nk, (window + qc - 2) // kc + 2) if use_band else nk

    outs = []
    for qi in range(nq):
        qcur, qp = qf[:, qi], qpos_c[:, qi]
        m = torch.full((b, kvh, rep, qc), -1e30, dtype=F32, device=q.device)
        l = torch.zeros((b, kvh, rep, qc), dtype=F32, device=q.device)
        acc = torch.zeros((b, qc, kvh, rep, d), dtype=F32, device=q.device)
        lo = max(qi * qc - (window - 1), 0) // kc if use_band else 0
        for j in range(nk_band):
            in_range = (lo + j) < nk     # banded tail: mask, never revisit
            kj = min(max(lo + j, 0), nk - 1)
            ks = k[:, kj * kc:(kj + 1) * kc].float()
            vs = v[:, kj * kc:(kj + 1) * kc].float()
            kp = k_pos[:, kj * kc:(kj + 1) * kc]
            lg = torch.einsum("bqkrd,btkd->bkrqt", qcur, ks)
            qp_ = qp[:, None, None, :, None]
            kp_ = kp[:, None, None, None, :]
            ok = torch.full((b, 1, 1, qc, kc), in_range, dtype=torch.bool,
                            device=q.device)
            if causal:
                ok = ok & (qp_ >= kp_)
            if window > 0:
                ok = ok & (qp_ - kp_ < window)
            lg = torch.where(ok, lg, -1e30)
            m_new = torch.maximum(m, lg.amax(dim=-1))
            p = torch.exp(lg - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + \
                torch.einsum("bkrqt,btkd->bqkrd", p, vs)
            m = m_new
        denom = torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        outs.append(acc / denom)                    # (b, qc, kvh, rep, d)
    out = torch.stack(outs, dim=1).reshape(b, s, h, d)
    return out.to(q.dtype)


def attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA attention.  q: (B, S, H, D); k/v: (B, T, KV, D) -> (B, S, H, D).

    Takes the flash kernel under the JAX package's shape conditions for
    its Pallas kernel (no window, equal position shapes, S and T
    multiples of 128); otherwise the blocked or the einsum path, as the
    JAX package does.
    """
    b, s, h, d = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    if _FLASH_ROUTE.get() and window == 0 \
            and q_pos.shape == k_pos.shape \
            and s % 128 == 0 and k.shape[1] % 128 == 0:
        # K/V keep their KV heads: the kernel reads head h // rep itself
        o = kops.attention(q.transpose(1, 2).contiguous(),
                           k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous(), causal=causal)
        return o.transpose(1, 2)
    if s > 1 and s * k.shape[1] > BLOCK_THRESHOLD:
        if cfg.banded_attention and window > 0:
            # window-matched chunks: visited pairs ~ S*(window+qc) instead
            # of S*T — small chunks tighten the band
            return _blocked_attention(q, k, v, q_pos, k_pos, causal, window,
                                      qc=256, kc=256, banded=True)
        return _blocked_attention(q, k, v, q_pos, k_pos, causal, window)
    qf = q.float() / (d ** 0.5)
    qg = qf.reshape(b, s, kvh, rep, d)
    logits = torch.einsum("bskrd,btkd->bkrst", qg, k.float())
    logits = logits.reshape(b, kvh * rep, s, k.shape[1])
    logits = _mask_logits(logits, q_pos, k_pos, causal, window)
    w = torch.softmax(logits, dim=-1)
    wg = w.reshape(b, kvh, rep, s, k.shape[1])
    o = torch.einsum("bkrst,btkd->bskrd", wg, v.float())
    return o.reshape(b, s, h, d).to(q.dtype)


def attn_block(cfg: ModelConfig, p: dict, x: torch.Tensor, pos: torch.Tensor,
               cache: Optional[Tuple] = None, causal: bool = True,
               window: int = 0, rope_on: bool = True):
    """Self-attention block (pre-norm, residual).  Returns (x, new_cache).

    cache = (k_cache (B, T, KV, D), v_cache, write_idx) for decode, with
    ``write_idx`` a 0-d int32 tensor on the cache's device; the write
    index is a rolling pointer when ``window`` bounds the cache.  The
    cache is not written in place: the new one is returned.
    """
    b, s, _ = x.shape
    y = rmsnorm(x, p["ln"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", y, p["wq"].to(y.dtype))
    k = torch.einsum("bsd,dhk->bshk", y, p["wk"].to(y.dtype))
    v = torch.einsum("bsd,dhk->bshk", y, p["wv"].to(y.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(y.dtype)
        k = k + p["bk"].to(y.dtype)
        v = v + p["bv"].to(y.dtype)
    if rope_on:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)

    if cache is None:
        bpos = pos if pos.dim() == 2 else pos[None].expand(b, s)
        o = attention(cfg, q, k, v, bpos, bpos, causal=causal, window=window)
        new_cache = None
    else:
        kc, vc, idx = cache
        t = kc.shape[1]
        slot = idx % t if window > 0 else idx
        # dynamic_update_slice semantics: the start is clamped so that the
        # s new rows fit, [0, t - s]
        start = torch.clamp(slot, 0, t - s)
        rows = (start + torch.arange(s, device=kc.device)).long()
        kc = kc.index_copy(1, rows, k.to(kc.dtype))
        vc = vc.index_copy(1, rows, v.to(vc.dtype))
        # absolute positions of cache slots
        ar = torch.arange(t, dtype=torch.int32, device=kc.device)[None, :]
        if window > 0:
            base = idx - slot
            kpos = ar + base
            kpos = torch.where(ar <= slot, kpos, kpos - t)
        else:
            kpos = ar.expand(b, t)
        qpos = (pos[None] if pos.dim() == 1 else pos).expand(b, s)
        valid = (kpos >= 0) & (kpos <= idx)
        kpos_m = torch.where(valid, kpos, 1 << 30)
        o = attention(cfg, q, kc, vc, qpos, kpos_m, causal=True,
                      window=window)
        new_cache = (kc, vc, idx + s)

    o = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
    return x + o, new_cache


def swiglu(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    y = rmsnorm(x, p["ln"], cfg.norm_eps)
    g = torch.einsum("bsd,df->bsf", y, p["w1"].to(y.dtype))
    u = torch.einsum("bsd,df->bsf", y, p["w3"].to(y.dtype))
    z = torch.nn.functional.silu(g.float()).to(y.dtype) * u
    return x + torch.einsum("bsf,fd->bsd", z, p["w2"].to(y.dtype))


def cross_attn_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     kv_embed: torch.Tensor, gated: bool = True):
    """Cross-attention onto precomputed embeddings (vision / audio):
    pre-norm, no mask, no RoPE, residual; ``gated`` scales the output by
    ``tanh(p["gate"])``."""
    b, s, _ = x.shape
    t = kv_embed.shape[1]
    y = rmsnorm(x, p["ln"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", y, p["wq"].to(y.dtype))
    kvn = rmsnorm(kv_embed, p["ln_kv"], cfg.norm_eps) if "ln_kv" in p \
        else kv_embed
    k = torch.einsum("btd,dhk->bthk", kvn.to(y.dtype), p["wk"].to(y.dtype))
    v = torch.einsum("btd,dhk->bthk", kvn.to(y.dtype), p["wv"].to(y.dtype))
    qpos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    kpos = torch.zeros((b, t), dtype=torch.int32, device=x.device)
    o = attention(cfg, q, k, v, qpos, kpos, causal=False)
    o = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
    if gated:
        o = o * torch.tanh(p["gate"].float()).to(o.dtype)
    return x + o
