"""Mamba-2 SSD (state-space duality, arXiv:2405.21060).

The counterpart of the JAX package's ``repro.models.ssm``, with the same
arithmetic in the same dtypes.  The chunked SSD form runs the forward
(training/prefill): intra-chunk terms are dense products, and the
inter-chunk recurrence is a short loop over chunk states (``lax.scan``
there).  Decode is the O(1) recurrent update, whose state comes out in
float32 whatever dtype it went in with.  Single SSM group (B/C shared
across heads), like mamba2-130m.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .common import (is_sharded, like, local_map, replicated, rmsnorm,
                     rows_whole, weight)
from .config import ModelConfig

F32 = torch.float32
CHUNK = 128


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q) -> (..., Q, Q) lower-tri segment sums: out[i,j] = sum_{j<m<=i} x[m]."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor,
                h0: Optional[torch.Tensor] = None):
    """SSD scan.

    x:  (B, S, H, P)  inputs per head
    dt: (B, S, H)     softplus'd step sizes
    a_log: (H,)       -exp(a_log) is the decay rate
    b, c: (B, S, N)   shared-input/output projections (single group)
    h0: (B, H, P, N)  optional initial state.
    Returns (y (B, S, H, P) in x's dtype, h_final (B, H, P, N) float32).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(CHUNK, s)
    assert s % q == 0, (s, q)
    nc = s // q

    a = -torch.exp(a_log.float())                        # (H,) negative
    dta = dt.float() * a[None, None, :]                  # (B, S, H)
    xdt = x.float() * dt.float()[..., None]              # (B, S, H, P)

    # reshape into chunks
    dta_c = dta.reshape(bsz, nc, q, h)
    x_c = xdt.reshape(bsz, nc, q, h, p)
    b_c = b.float().reshape(bsz, nc, q, n)
    c_c = c.float().reshape(bsz, nc, q, n)

    # intra-chunk (diagonal) term: attention-like with decay kernel
    # (the exp(segsum) factor is 0 above the diagonal -> causal by mask)
    l = torch.exp(segsum(dta_c.permute(0, 1, 3, 2)))     # (B, nc, H, Q, Q)
    scores = torch.einsum("bcqn,bckn->bcqk", c_c, b_c)   # (B, nc, Q, Q)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores[:, :, None] * l, x_c)

    # chunk-final states: sum_k decay(end..k) * B_k x_k
    dta_cs = torch.cumsum(dta_c, dim=2)                  # (B, nc, Q, H)
    decay_to_end = torch.exp(dta_cs[:, :, -1:, :] - dta_cs)  # (B, nc, Q, H)
    states = torch.einsum("bckn,bckhp->bchpn", b_c,
                          decay_to_end[..., None] * x_c)

    # inter-chunk recurrence over chunk index; each chunk sees the state
    # from before it
    chunk_decay = torch.exp(dta_cs[:, :, -1, :])         # (B, nc, H)
    carry = torch.zeros((bsz, h, p, n), dtype=F32, device=x.device) \
        if h0 is None else h0.float()
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    h_prevs = torch.stack(h_prevs, dim=1)                # (B, nc, H, P, N)

    # off-diagonal: contribution of carried state into each position
    decay_from_start = torch.exp(dta_cs)                 # (B, nc, Q, H)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", c_c, h_prevs) \
        * decay_from_start[..., None]

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), carry


def ssd_decode(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
    """One-token recurrent update.  x: (B, 1, H, P); b/c: (B, 1, N);
    h: (B, H, P, N) -> (y (B, 1, H, P) in x's dtype, h' float32)."""
    a = -torch.exp(a_log.float())
    dta = dt[:, 0].float() * a[None, :]                  # (B, H)
    decay = torch.exp(dta)[:, :, None, None]
    xdt = x[:, 0].float() * dt[:, 0].float()[..., None]  # (B, H, P)
    h_new = h.float() * decay + torch.einsum("bhp,bn->bhpn", xdt,
                                             b[:, 0].float())
    y = torch.einsum("bhpn,bn->bhp", h_new, c[:, 0].float())
    return y[:, None].to(x.dtype), h_new


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  xbc: (B, S, D); w: (K, D); state (B, K-1, D).
    Returns (y (B, S, D), new_state (B, K-1, D)), both in xbc's dtype.

    The taps are summed in order, in the promoted dtype of xbc and w (a
    bfloat16 input against float32 weights sums in float32, as jnp
    promotes it)."""
    k = w.shape[0]
    if state is None:
        pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    else:
        pad = state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                  # (B, S+K-1, D)
    s = xbc.shape[1]
    y = sum(full[:, i:i + s] * w[i][None, None, :] for i in range(k))
    new_state = full[:, full.shape[1] - (k - 1):] if k > 1 else pad
    return torch.nn.functional.silu((y + bias[None, None]).float()
                                    ).to(xbc.dtype), new_state


def _scan_and_skip(xh, dt, a_log, d_skip, dt_bias, bb, cc,
                   h: Optional[torch.Tensor] = None):
    """The mixer after its conv: softplus'd step sizes, the SSD scan
    (``h`` None) or the decode step from the state ``h``, and the skip.
    xh: (B, S, H, P) -> (y (B, S, H*P), the new state or None)."""
    # jax.nn.softplus is logaddexp(x, 0)
    dt = dt.float() + dt_bias.float()
    dt = torch.logaddexp(dt, torch.zeros_like(dt))
    if h is None:
        y, h_new = ssd_chunked(xh, dt, a_log, bb, cc)[0], None
    else:
        y, h_new = ssd_decode(xh, dt, a_log, bb, cc, h)
    y = y + xh.float().to(y.dtype) * d_skip.to(y.dtype)[None, None, :, None]
    return y.reshape(*y.shape[:2], -1), h_new


def _mix_core(cfg: ModelConfig, xi, bb, cc, dt, z, conv_w, conv_b, a_log,
              d_skip, dt_bias, cache: Optional[Tuple]):
    """The mixer between its input and output projections: softplus'd
    step sizes, the causal conv, the SSD scan (or decode step), the skip
    and the gate.  Returns (y (B, S, din), new_cache)."""
    bsz, s, _ = xi.shape
    din = cfg.d_inner
    nh, ph, ns = cfg.n_ssm_heads, cfg.ssm_d_head, cfg.ssm_state

    xbc = torch.cat([xi, bb, cc], dim=-1)
    conv_state = None if cache is None else cache[0]
    xbc, conv_state_new = causal_conv(xbc, conv_w, conv_b, conv_state)
    xi = xbc[..., :din]
    bb = xbc[..., din:din + ns]
    cc = xbc[..., din + ns:]

    xh = xi.reshape(bsz, s, nh, ph)
    y, h_fin = _scan_and_skip(xh, dt, a_log, d_skip, dt_bias, bb, cc,
                              None if cache is None else cache[1])
    new_cache = None if cache is None else (conv_state_new, h_fin)
    if z is not None:
        y = y * torch.nn.functional.silu(z.float()).to(y.dtype)
    return y, new_cache


def _decode_on_mesh(cfg: ModelConfig, xi, bb, cc, dt, z, conv_w, conv_b,
                    a_log, d_skip, dt_bias, cache: Tuple):
    """:func:`_mix_core`'s decode step of DTensors, split as the cache
    is: the conv on the conv state's channels (split over the model
    axis, with ``conv_w`` and ``conv_b``), the recurrence on the SSM
    state's heads, each rank on its batch rows.  No weight is gathered
    over the model axis; the activations between are a token's.
    Returns (y (B, 1, din), split as the state's heads, the new
    cache)."""
    from torch.distributed.tensor import Replicate, Shard

    conv_s, h = cache
    mesh = conv_s.device_mesh
    bsz = xi.shape[0]
    din, ns = cfg.d_inner, cfg.ssm_state
    nh, ph = cfg.n_ssm_heads, cfg.ssm_d_head

    def channels(w, dim):
        """``w`` split on its ``dim`` as the conv state splits its
        channels (a slice of a whole ``w``, no gather)."""
        return w.redistribute(mesh, [Shard(dim) if p == Shard(2) else
                                     Replicate() for p in conv_s.placements])

    rows = [p if p == Shard(0) else Replicate() for p in conv_s.placements]
    xbc = torch.cat([rows_whole(t) for t in (xi, bb, cc)], dim=-1)
    xbc, conv_new = local_map(
        causal_conv, (conv_s.placements, conv_s.placements),
        xbc.redistribute(mesh, conv_s.placements),
        channels(conv_w, 1), channels(conv_b, 0), conv_s)
    xbc = xbc.redistribute(mesh, rows)
    xh = xbc[..., :din].reshape(bsz, 1, nh, ph)
    bb, cc = xbc[..., din:din + ns], xbc[..., din + ns:]

    heads = [Shard(2) if p == Shard(1) else p for p in h.placements]
    per_head = [Shard(0) if p == Shard(1) else Replicate()
                for p in h.placements]

    y, h_new = local_map(
        _scan_and_skip, (heads, h.placements), xh.redistribute(mesh, heads),
        rows_whole(dt).redistribute(mesh, heads),
        *(w.redistribute(mesh, per_head) for w in (a_log, d_skip, dt_bias)),
        bb, cc, h)
    if z is not None:
        y = y * torch.nn.functional.silu(z.float()).to(y.dtype)
    return y, (conv_new, h_new)


def mamba2_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
               cache: Optional[Tuple] = None, gated: bool = True):
    """Full mamba2 mixer.  x: (B, S, d_model) -> (y, new_cache).

    cache = (conv_state (B, K-1, conv_dim), ssm_state (B, H, P, N)).
    Param dict p: in_z (d, din) [optional], in_x (d, din), in_b (d, N),
    in_c (d, N), in_dt (d, H), conv_w (K, din+2N), conv_b, a_log (H,),
    d_skip (H,), dt_bias (H,), out (din, d).

    On a mesh (DTensor ``x``, no cache) the projections run as the
    attention block's do, on the batch rows of each rank with the
    sequence whole; the conv and the scan, which have no DTensor rules
    (``cumsum``, segment sums, the chunk loop), run on each rank's batch
    rows through ``local_map``; the output projection's partial sums are
    reduce-scattered back onto ``x``'s placement.  A decode step on a
    mesh runs on the cache's split (:func:`_decode_on_mesh`).
    """
    xt = rows_whole(x)
    proj = lambda w: torch.einsum("bsd,de->bse", xt,  # noqa: E731
                                  weight(w, x.dtype))
    xi, bb, cc, dt = (proj(p[k]) for k in ("in_x", "in_b", "in_c", "in_dt"))
    z = proj(p["in_z"]) if gated and "in_z" in p else None
    small = [p[k] for k in ("conv_w", "conv_b", "a_log", "d_skip",
                            "dt_bias")]
    if is_sharded(x) and cache is not None:
        y, new_cache = _decode_on_mesh(cfg, xi, bb, cc, dt, z, *small, cache)
    elif is_sharded(x):
        ins = [rows_whole(t) for t in (xi, bb, cc, dt)]
        ins.append(None if z is None else rows_whole(z))
        ins += [replicated(w) for w in small]
        y = local_map(
            lambda *a: _mix_core(cfg, *a, None)[0],
            ins[0].placements, *ins)
        new_cache = None
    else:
        y, new_cache = _mix_core(cfg, xi, bb, cc, dt, z, *small, cache)
    out = torch.einsum("bse,ed->bsd", y, weight(p["out"], y.dtype))
    return like(out, x), new_cache


def mamba_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                cache: Optional[Tuple] = None):
    y = rmsnorm(x, p["ln"], cfg.norm_eps)
    o, new_cache = mamba2_mix(cfg, p, y, cache)
    return x + o, new_cache
