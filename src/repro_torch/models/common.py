"""Shared transformer layers (pure functions over param dicts).

The counterpart of the JAX package's ``repro.models.common``, with the
same layouts at every public function: activations (B, S, D), heads
(B, S, H, Dh), positions (B, S).  ``attention`` routes to the flash
kernel (:func:`repro_torch.kernels.ops.attention`) under the JAX
package's shape conditions for its Pallas kernel; on CUDA tensors that
launches the hand-written kernel, on CPU tensors its plain version.

On a device mesh the activations and weights are DTensors
(``torch.distributed.tensor``) and the same functions run SPMD on every
rank of the mesh.  A block gathers its input's sequence over the model
axis and its weights over the data axes (FSDP), multiplies on the local
heads or columns (Megatron tensor parallelism), and reduce-scatters its
output back onto the residual stream's placement
(:func:`shard_act`, the JAX package's sharding constraints).  Attention
and RoPE run on each rank's local batch rows and heads through
``local_map``: the flash kernel reads raw device pointers, and positions
are per row.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Tuple

import torch

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import ops as kops
from repro_torch.parallel.sharding import P, placements, resolve_pspec

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


# ---------------------------------------------------------------------------
# sharding on a device mesh
# ---------------------------------------------------------------------------

#: the mesh axes that split the batch and, for FSDP, the weights
DATA_AXES = ("pod", "data")


def is_sharded(x) -> bool:
    return isinstance(x, DTensor)


def shard_act(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """Megatron-style activation sharding: ``x`` redistributed to
    ``spec`` resolved on ``mesh`` for its shape (an ``UNCONSTRAINED``
    entry keeps the dim's sharding).  The identity without a mesh.

    Used to keep the residual stream sequence-sharded between layers so
    remat-saved activations shrink by the tensor-parallel degree; the
    blocks gather it before their matmuls and reduce-scatter after.  A
    dim of size 1 is left whole (:func:`unit_dims_whole`)."""
    if mesh is None:
        return x
    spec = resolve_pspec(spec, mesh, x.shape)
    return x.redistribute(mesh, unit_dims_whole(
        x, placements(spec, mesh, x.placements)))


def unit_dims_whole(x: torch.Tensor, pl) -> list:
    """The placements ``pl`` of ``x`` with each split of a dim of size 1
    made whole.  Only a mesh axis of size 1 divides such a dim, and there
    the split holds the same block; but torch's ``einsum`` moves a size-1
    dim among its operands' dims with a ``permute``, and DTensor cannot
    propagate a split of it through the ``view`` that follows (a batch of
    one on a (1, 1) mesh)."""
    return [Replicate() if isinstance(p, Shard) and x.shape[p.dim] == 1
            else p for p in pl]


def weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` cast to ``dtype``; a DTensor then gathered over the data axes
    (FSDP: its gradient is reduce-scattered back in the backward) and
    left as it is over the model axis (tensor parallelism)."""
    w = w.to(dtype)
    if not is_sharded(w):
        return w
    mesh = w.device_mesh
    pl = [Replicate() if a in DATA_AXES else p
          for a, p in zip(mesh.mesh_dim_names, w.placements)]
    return w.redistribute(mesh, pl)


def replicated(w: torch.Tensor) -> torch.Tensor:
    """``w`` whole on every rank (a plain tensor stays as it is)."""
    if not is_sharded(w):
        return w
    return w.redistribute(w.device_mesh, [Replicate()] * w.device_mesh.ndim)


def rows_whole(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, ...) split over the batch only: the placement every rank
    computes a block's matmuls on (the JAX package's ``P(DP, None, ..)``)."""
    if not is_sharded(x):
        return x
    return shard_act(x, P(DATA_AXES, *([None] * (x.ndim - 1))),
                     x.device_mesh)


def like(o: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``o`` placed as ``x`` (a partial sum is reduced, or reduce-scattered,
    onto ``x``'s placement)."""
    if not is_sharded(x):
        return o
    return o.redistribute(x.device_mesh, x.placements)


def batch_like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` (B, ...), whole or a DTensor, placed as ``x``'s batch dim:
    split where ``x`` splits its dim 0, whole elsewhere."""
    mesh = x.device_mesh
    pl = [Shard(0) if p == Shard(0) else Replicate() for p in x.placements]
    if not is_sharded(t):
        t = DTensor.from_local(t.contiguous(), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
    return t.redistribute(mesh, pl)


def local_map(fn, out_placements, *args):
    """``fn`` on each rank's local blocks of the DTensor ``args`` (other
    arguments pass as they are); its result a DTensor of
    ``out_placements`` (a sequence of placements), or its results
    DTensors of the placements in ``out_placements`` (a tuple of such
    sequences).  ``torch``'s ``local_map``: autograd
    runs through it, and an input that is whole over a mesh dim on which
    the results are split takes its gradient there as a partial sum.  A
    partial-sum input is reduced first, so an output placed as one is
    whole."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map as lm
    mesh = next(a.device_mesh for a in args if is_sharded(a))
    # partial sums are reduced first: local_map's backward is wrong for
    # a partial input (it was, through RoPE, on the row-parallel k)
    args = tuple(a.redistribute(mesh, [Replicate() if p.is_partial() else p
                                       for p in a.placements])
                 if is_sharded(a) else a for a in args)
    in_pl = tuple(a.placements if is_sharded(a) else None for a in args)
    # one output's placements are a list; a tuple holds one per output;
    # with its inputs reduced, no output is a partial sum
    whole = lambda pl: [Replicate() if p.is_partial() else p  # noqa: E731
                        for p in pl]
    if isinstance(out_placements[0], Placement):
        out_placements = whole(out_placements)
        outs = [out_placements]
    else:
        out_placements = tuple(whole(p) for p in out_placements)
        outs = list(out_placements)
    # an input whole over a mesh dim on which the results differ (they
    # are split there) gets a different gradient on each rank of it: a
    # partial sum
    varies = [any(o[i] != Replicate() for o in outs)
              for i in range(mesh.ndim)]
    grad_pl = tuple(None if pl is None else
                    [Partial() if v and p == Replicate() else p
                     for p, v in zip(pl, varies)] for pl in in_pl)
    return lm(fn, out_placements=out_placements, in_placements=in_pl,
              in_grad_placements=grad_pl, device_mesh=mesh)(*args)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); pos: (B, S) or (S,).  A DTensor ``x`` rotates on
    each rank's local rows and heads."""
    if is_sharded(x):
        if pos.dim() == 1:
            pos = pos[None].expand(x.shape[0], -1)
        return local_map(lambda xl, pl: rope(xl, pl, theta), x.placements,
                         x, batch_like(pos, x))
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


class _Remat(torch.autograd.Function):
    """``fn(*args)`` (tensors in, a tensor or a tuple of tensors out)
    keeping only ``args`` for the backward, which computes ``fn`` again
    there: the JAX package's ``jax.checkpoint``.  Made by hand rather
    than with ``torch.utils.checkpoint``: the inputs go through
    ``ctx.save_for_backward``, so in the first pass of a layer that
    ``checkpoint`` itself recomputes they are dropped with every other
    save of that pass, where a nested ``checkpoint`` pins its inputs
    until the backward."""

    @staticmethod
    def forward(ctx, fn, *args):
        ctx.fn = fn
        ctx.save_for_backward(*args)
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            xs = [a.detach().requires_grad_(n)
                  for a, n in zip(ctx.saved_tensors, need)]
            outs = ctx.fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        want = [x for x, n in zip(xs, need) if n]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], want, [g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(want))
        return (None,) + tuple(next(got) if n else None for n in need)


def _key_chunk(qcur, qp, ks, vs, kp, ok, m, l, acc, causal: bool,
               window: int):
    """One key chunk of the online softmax: the running max ``m``, sum
    ``l`` and output ``acc`` of a query chunk updated with keys ``ks``,
    values ``vs`` at positions ``kp``; ``ok`` (B, 1, 1, 1, kc) masks the
    keys that lie outside the band or past the key count."""
    lg = torch.einsum("bqkrd,btkd->bkrqt", qcur, ks.float())
    qp_ = qp[:, None, None, :, None]
    kp_ = kp[:, None, None, None, :]
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
        torch.einsum("bkrqt,btkd->bqkrd", p, vs.float())
    return m_new, l, acc


def _blocked_attention(q, k, v, q_pos, k_pos, causal, window,
                       qc=BLOCK_Q, kc=BLOCK_K, banded: bool = False):
    """Online-softmax attention, chunked over queries and keys.

    Peak memory per step is (B, KV, rep, qc, kc) instead of (B, H, S, T).
    Under autograd each query chunk and, inside it, each key chunk is
    checkpointed (the JAX package's ``jax.checkpoint`` of both), so the
    backward holds one chunk's scores at a time, not every chunk's.

    The key count need not divide ``kc``: the keys are padded to a
    multiple of it, and the padded keys are masked.  (The JAX package
    halves its key chunk until it divides the key count, which leaves
    one-key chunks for a prime count such as 1,601 image tokens.)  The
    query chunk still halves until it divides the query count.

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
    nq, nk = s // qc, -(-t // kc)
    pad = nk * kc - t
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad))
    # the chunk functions close over no activation: a _Remat node keeps
    # its function until the backward
    dev = q.device
    key_ok = torch.arange(nk * kc, device=dev) < t
    qf = (q.float() / (d ** 0.5)).reshape(b, nq, qc, kvh, rep, d)
    qpos_c = q_pos.reshape(b, nq, qc)

    use_band = banded and window > 0 and causal
    # k-chunks per band: cover [qi*qc - window + 1 .. qi*qc + qc - 1]
    nk_band = min(nk, (window + qc - 2) // kc + 2) if use_band else nk
    # without a gradient to take, _Remat.apply records nothing and runs
    # its function once
    key_chunk = lambda *t: _key_chunk(*t, causal, window)  # noqa: E731

    def q_chunk(qcur, qp, k, v, k_pos, qi: int):
        m = torch.full((b, kvh, rep, qc), -1e30, dtype=F32, device=dev)
        l = torch.zeros((b, kvh, rep, qc), dtype=F32, device=dev)
        acc = torch.zeros((b, qc, kvh, rep, d), dtype=F32, device=dev)
        lo = max(qi * qc - (window - 1), 0) // kc if use_band else 0
        for j in range(nk_band):
            in_range = (lo + j) < nk     # banded tail: mask, never revisit
            kj = min(max(lo + j, 0), nk - 1)
            cut = slice(kj * kc, (kj + 1) * kc)
            ok = (key_ok[cut] & in_range)[None, None, None, None, :]
            m, l, acc = _Remat.apply(key_chunk, qcur, qp, k[:, cut],
                                     v[:, cut], k_pos[:, cut], ok, m, l, acc)
        denom = torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        return acc / denom                          # (b, qc, kvh, rep, d)

    # the keys and values are each query chunk's inputs too: the
    # recompute takes their gradient
    outs = [_Remat.apply(lambda *t, i=qi: q_chunk(*t, i), qf[:, qi],
                         qpos_c[:, qi], k, v, k_pos) for qi in range(nq)]
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
    if is_sharded(q):
        return _sharded_attention(cfg, q, k, v, q_pos, k_pos, causal, window)
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


def _sharded_attention(cfg: ModelConfig, q, k, v, q_pos, k_pos, causal,
                       window):
    """:func:`attention` of DTensors, on each rank's local batch rows and,
    when q's heads are split over the model axis, its local heads.

    Each rank's q heads are a contiguous block of ``H / tp``.  When k
    and v split their KV heads over the model axis too, the local KV
    heads are the ones the local q heads read (GQA groups are
    contiguous).  When they do not (the KV heads do not divide the
    model axis, and ``wk``/``wv`` resolved row-parallel), k and v are
    gathered whole and each rank takes the KV heads of its q heads,
    which works when the local q heads cover whole GQA groups or lie in
    one; otherwise q is gathered too and every rank computes every
    head."""
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    tp = [i for i, a in enumerate(names) if a not in DATA_AXES]
    h, kvh = q.shape[2], k.shape[2]
    rep = h // kvh
    heads = Shard(2)

    def on_model(t, keep: bool):
        pl = list(t.placements)
        for i in tp:
            pl[i] = heads if keep and pl[i] == heads else Replicate()
        return t.redistribute(mesh, pl)

    q_heads = bool(tp) and all(q.placements[i] == heads for i in tp)
    kv_heads = q_heads and all(t.placements[i] == heads for t in (k, v)
                               for i in tp)
    sel = None
    if q_heads and not kv_heads:
        n = math.prod(mesh.size(i) for i in tp)
        c = 0
        for i in tp:
            c = c * mesh.size(i) + mesh.get_coordinate()[i]
        hl = h // n
        if hl % rep == 0 or rep % hl == 0:
            lo = c * hl // rep
            sel = slice(lo, lo + max(hl // rep, 1))
        else:
            q_heads = False
    q = on_model(q, q_heads)
    k, v = on_model(k, kv_heads), on_model(v, kv_heads)

    def local(ql, kl, vl, qp, kp):
        if sel is not None:
            kl, vl = kl[:, :, sel], vl[:, :, sel]
        return attention(cfg, ql, kl, vl, qp, kp, causal=causal,
                         window=window)

    return local_map(local, q.placements, q, k, v, batch_like(q_pos, q),
                     batch_like(k_pos, k))


def _cache_write(kc, vc, k, v, idx, pos, window: int = 0):
    """``k``, ``v`` (B, S, KV, D) written into the cache ``kc``, ``vc``
    (B, T, KV, D) at ``idx`` (a rolling slot when ``window`` bounds the
    cache): (kc, vc, query positions (B, S), key positions (B, T)), the
    slots not yet written at position ``1 << 30``, past every query."""
    b, s = k.shape[:2]
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
    return kc, vc, qpos, torch.where(valid, kpos, 1 << 30).expand(b, t)


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
    y = rows_whole(rmsnorm(x, p["ln"], cfg.norm_eps))
    q = torch.einsum("bsd,dhk->bshk", y, weight(p["wq"], y.dtype))
    k = torch.einsum("bsd,dhk->bshk", y, weight(p["wk"], y.dtype))
    v = torch.einsum("bsd,dhk->bshk", y, weight(p["wv"], y.dtype))
    if cfg.qkv_bias:
        q = q + weight(p["bq"], y.dtype)
        k = k + weight(p["bk"], y.dtype)
        v = v + weight(p["bv"], y.dtype)
    if rope_on:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)

    if cache is None:
        bpos = pos if pos.dim() == 2 else pos[None].expand(b, s)
        o = attention(cfg, q, k, v, bpos, bpos, causal=causal, window=window)
        new_cache = None
    else:
        kc, vc, idx = cache
        write = lambda *a: _cache_write(*a, window=window)  # noqa: E731
        if is_sharded(kc):
            # each rank writes its own rows; the new keys and values come
            # whole over the axes the cache is whole over (their heads
            # may be split over the model axis, the cache's are not)
            k, v = like(k, kc), like(v, kc)
            rows = [Shard(0) if p_ == Shard(0) else Replicate()
                    for p_ in kc.placements]
            kc, vc, qpos, kpos_m = local_map(
                write, (kc.placements, vc.placements, rows, rows), kc, vc,
                k, v, idx, batch_like(pos if pos.dim() == 2 else
                                      pos[None].expand(b, s), kc))
        else:
            kc, vc, qpos, kpos_m = write(kc, vc, k, v, idx, pos)
        o = attention(cfg, q, kc, vc, qpos, kpos_m, causal=True,
                      window=window)
        new_cache = (kc, vc, idx + s)

    o = torch.einsum("bshk,hkd->bsd", o, weight(p["wo"], o.dtype))
    return x + like(o, x), new_cache


def swiglu(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    y = rows_whole(rmsnorm(x, p["ln"], cfg.norm_eps))
    g = torch.einsum("bsd,df->bsf", y, weight(p["w1"], y.dtype))
    u = torch.einsum("bsd,df->bsf", y, weight(p["w3"], y.dtype))
    z = torch.nn.functional.silu(g.float()).to(y.dtype) * u
    return x + like(torch.einsum("bsf,fd->bsd", z,
                                 weight(p["w2"], y.dtype)), x)


def cross_attn_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     kv_embed: torch.Tensor, gated: bool = True):
    """Cross-attention onto precomputed embeddings (vision / audio):
    pre-norm, no mask, no RoPE, residual; ``gated`` scales the output by
    ``tanh(p["gate"])``."""
    b, s, _ = x.shape
    t = kv_embed.shape[1]
    y = rows_whole(rmsnorm(x, p["ln"], cfg.norm_eps))
    q = torch.einsum("bsd,dhk->bshk", y, weight(p["wq"], y.dtype))
    kvn = rmsnorm(kv_embed, p["ln_kv"], cfg.norm_eps) if "ln_kv" in p \
        else kv_embed
    kvn = rows_whole(kvn).to(y.dtype)
    k = torch.einsum("btd,dhk->bthk", kvn, weight(p["wk"], y.dtype))
    v = torch.einsum("btd,dhk->bthk", kvn, weight(p["wv"], y.dtype))
    qpos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    kpos = torch.zeros((b, t), dtype=torch.int32, device=x.device)
    o = attention(cfg, q, k, v, qpos, kpos, causal=False)
    o = torch.einsum("bshk,hkd->bsd", o, weight(p["wo"], o.dtype))
    if gated:
        o = o * torch.tanh(p["gate"].float()).to(o.dtype)
    return x + like(o, x)
