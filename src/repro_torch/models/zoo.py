"""The architecture zoo: one parameter-tree function + forward per family.

The counterpart of the JAX package's ``repro.models.zoo``, for all six
families: dense (llama/qwen GQA), moe (qwen2-moe / moonlight), ssm
(mamba2 SSD), hybrid (hymba: parallel attn+SSM heads, sliding window),
vlm (llama-3.2-vision: a gated cross-attn block in every group of
layers) and audio (whisper enc-dec; the conv/mel frontend is stubbed as
precomputed frame embeddings).

Everything is a pure function over nested dict params.  Layer leaves are
stacked (L, ...) as in the JAX package, so parameters convert one to one;
the JAX package's ``lax.scan`` over the stack is a Python loop here, and
its ``jax.checkpoint`` of the layer body (``cfg.remat``) is
``torch.utils.checkpoint`` of the same body when a gradient is taken.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import Shard
from torch.utils.checkpoint import checkpoint

from .common import (attn_block, batch_like, cdt, cross_attn_block,
                     current_route, is_sharded, local_map, rmsnorm,
                     rows_whole, shard_act, swiglu, weight)
from .config import ModelConfig
from .moe import moe_block
from .params import Alt, Leaf
from .ssm import mamba2_mix, mamba_block
from repro_torch.parallel.sharding import P

# mesh axis aliases used in the PartitionSpecs below
DP = ("pod", "data")     # batch axis
TP = "model"             # tensor axis
FS = ("pod", "data")     # FSDP axis: params/grads/moments sharded over data
                         # (each layer gathers its weights over data and
                         # reduce-scatters their gradients: ZeRO-3)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def _attn_tree(cfg: ModelConfig, leaf: Leaf, pre: str, ln_kv: bool = False,
               gate: bool = False, lead: tuple = ()) -> Dict[str, Any]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    sc = 0.02
    lp = tuple(None for _ in lead)
    # primary: Megatron head-sharding (+FSDP on d); fallback: input-dim
    # row-parallel (+FSDP on head_dim)
    qkv_spec = Alt(P(*lp, FS, TP, None), P(*lp, TP, None, FS),
                   P(*lp, FS, None, None), P(*lp, None, None, None))
    o_spec = Alt(P(*lp, TP, None, FS), P(*lp, FS, None, TP),
                 P(*lp, None, None, FS), P(*lp, None, None, None))
    t = {
        "ln": leaf(pre + ".ln", lead + (d,), P(*lp, None), 1.0),
        "wq": leaf(pre + ".wq", lead + (d, h, hd), qkv_spec, sc),
        "wk": leaf(pre + ".wk", lead + (d, kv, hd), qkv_spec, sc),
        "wv": leaf(pre + ".wv", lead + (d, kv, hd), qkv_spec, sc),
        "wo": leaf(pre + ".wo", lead + (h, hd, d), o_spec, sc),
    }
    if cfg.qkv_bias:
        b_spec = Alt(P(*lp, TP, None), P(*lp, None, None))
        t["bq"] = leaf(pre + ".bq", lead + (h, hd), b_spec, 0.0)
        t["bk"] = leaf(pre + ".bk", lead + (kv, hd), b_spec, 0.0)
        t["bv"] = leaf(pre + ".bv", lead + (kv, hd), b_spec, 0.0)
    if ln_kv:
        t["ln_kv"] = leaf(pre + ".ln_kv", lead + (d,), P(*lp, None), 1.0)
    if gate:
        t["gate"] = leaf(pre + ".gate", lead + (1,), P(*lp, None), 0.0)
    return t


def _mlp_tree(cfg: ModelConfig, leaf: Leaf, pre: str, lead: tuple = ()):
    d, f = cfg.d_model, cfg.d_ff
    lp = tuple(None for _ in lead)
    return {
        "ln": leaf(pre + ".ln", lead + (d,), P(*lp, None), 1.0),
        "w1": leaf(pre + ".w1", lead + (d, f), Alt(P(*lp, FS, TP),
                                                   P(*lp, None, TP)), 0.02),
        "w3": leaf(pre + ".w3", lead + (d, f), Alt(P(*lp, FS, TP),
                                                   P(*lp, None, TP)), 0.02),
        "w2": leaf(pre + ".w2", lead + (f, d), Alt(P(*lp, TP, FS),
                                                   P(*lp, TP, None)), 0.02),
    }


def _moe_tree(cfg: ModelConfig, leaf: Leaf, pre: str, lead: tuple = ()):
    d, e, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    lp = tuple(None for _ in lead)
    # primary: expert parallelism (+FSDP on d); fallback: TP inside each
    # expert's FFN (+FSDP on d)
    w13_spec = Alt(P(*lp, TP, FS, None), P(*lp, None, FS, TP),
                   P(*lp, None, None, TP), P(*lp, None, None, None))
    w2_spec = Alt(P(*lp, TP, None, FS), P(*lp, None, TP, FS),
                  P(*lp, None, TP, None), P(*lp, None, None, None))
    t = {
        "ln": leaf(pre + ".ln", lead + (d,), P(*lp, None), 1.0),
        "router": leaf(pre + ".router", lead + (d, e), P(*lp, None, None),
                       0.02),
        "w1": leaf(pre + ".w1", lead + (e, d, f), w13_spec, 0.02),
        "w3": leaf(pre + ".w3", lead + (e, d, f), w13_spec, 0.02),
        "w2": leaf(pre + ".w2", lead + (e, f, d), w2_spec, 0.02),
    }
    if cfg.moe_shared:
        fs = cfg.moe_shared * f
        t["w1s"] = leaf(pre + ".w1s", lead + (d, fs), Alt(
            P(*lp, FS, TP), P(*lp, None, TP)), 0.02)
        t["w3s"] = leaf(pre + ".w3s", lead + (d, fs), Alt(
            P(*lp, FS, TP), P(*lp, None, TP)), 0.02)
        t["w2s"] = leaf(pre + ".w2s", lead + (fs, d), Alt(
            P(*lp, TP, FS), P(*lp, TP, None)), 0.02)
    return t


def _mamba_tree(cfg: ModelConfig, leaf: Leaf, pre: str, lead: tuple = (),
                gated: bool = True):
    d, din, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.n_ssm_heads
    k = cfg.conv_width
    convd = din + 2 * ns
    lp = tuple(None for _ in lead)
    t = {
        "ln": leaf(pre + ".ln", lead + (d,), P(*lp, None), 1.0),
        "in_x": leaf(pre + ".in_x", lead + (d, din), Alt(
            P(*lp, FS, TP), P(*lp, None, TP)), 0.02),
        "in_b": leaf(pre + ".in_b", lead + (d, ns), P(*lp, FS, None), 0.02),
        "in_c": leaf(pre + ".in_c", lead + (d, ns), P(*lp, FS, None), 0.02),
        "in_dt": leaf(pre + ".in_dt", lead + (d, nh), P(*lp, FS, None),
                      0.02),
        "conv_w": leaf(pre + ".conv_w", lead + (k, convd), P(*lp, None, TP),
                       0.1),
        "conv_b": leaf(pre + ".conv_b", lead + (convd,), P(*lp, TP), 0.0),
        "a_log": leaf(pre + ".a_log", lead + (nh,), P(*lp, None), 0.5),
        "d_skip": leaf(pre + ".d_skip", lead + (nh,), P(*lp, None), 1.0),
        "dt_bias": leaf(pre + ".dt_bias", lead + (nh,), P(*lp, None), 0.5),
        "out": leaf(pre + ".out", lead + (din, d), Alt(
            P(*lp, TP, FS), P(*lp, TP, None)), 0.02),
    }
    if gated:
        t["in_z"] = leaf(pre + ".in_z", lead + (d, din), Alt(
            P(*lp, FS, TP), P(*lp, None, TP)), 0.02)
    return t


def param_tree(cfg: ModelConfig, leaf: Leaf) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab
    t: Dict[str, Any] = {
        "embed": leaf("embed", (v, d), Alt(P(TP, FS), P(FS, TP),
                                           P(None, TP)), 0.02),
        "ln_f": leaf("ln_f", (d,), P(None), 1.0),
    }
    if not cfg.tie_embeddings:
        t["head"] = leaf("head", (d, v), Alt(P(FS, TP), P(TP, FS),
                                             P(TP, None)), 0.02)
    L = (cfg.n_layers,)

    if cfg.family == "dense":
        t["layers"] = {"attn": _attn_tree(cfg, leaf, "L.attn", lead=L),
                       "mlp": _mlp_tree(cfg, leaf, "L.mlp", lead=L)}
    elif cfg.family == "moe":
        t["layers"] = {"attn": _attn_tree(cfg, leaf, "L.attn", lead=L),
                       "moe": _moe_tree(cfg, leaf, "L.moe", lead=L)}
    elif cfg.family == "ssm":
        t["layers"] = {"mamba": _mamba_tree(cfg, leaf, "L.mamba", lead=L)}
    elif cfg.family == "hybrid":
        t["layers"] = {
            "attn": _attn_tree(cfg, leaf, "L.attn", lead=L),
            "mamba": _mamba_tree(cfg, leaf, "L.mamba", lead=L, gated=False),
            "mix_a": leaf("L.mix_a", L + (d,), P(None, None), 1.0),
            "mix_s": leaf("L.mix_s", L + (d,), P(None, None), 1.0),
            "mlp": _mlp_tree(cfg, leaf, "L.mlp", lead=L),
        }
    elif cfg.family == "vlm":
        g = cfg.n_layers // cfg.cross_attn_interval
        inner = (g, cfg.cross_attn_interval - 1)
        t["layers"] = {"attn": _attn_tree(cfg, leaf, "L.attn", lead=inner),
                       "mlp": _mlp_tree(cfg, leaf, "L.mlp", lead=inner)}
        t["xlayers"] = {"xattn": _attn_tree(cfg, leaf, "X.attn", ln_kv=True,
                                            gate=True, lead=(g,)),
                        "mlp": _mlp_tree(cfg, leaf, "X.mlp", lead=(g,)),
                        "gate_mlp": leaf("X.gate_mlp", (g, 1), P(None, None),
                                         0.0)}
    elif cfg.family == "audio":
        eL = (cfg.encoder_layers,)
        t["enc_pos"] = leaf("enc_pos", (cfg.n_audio_frames, d),
                            P(None, FS), 0.02)
        t["enc_layers"] = {"attn": _attn_tree(cfg, leaf, "E.attn", lead=eL),
                           "mlp": _mlp_tree(cfg, leaf, "E.mlp", lead=eL)}
        t["enc_ln_f"] = leaf("enc_ln_f", (d,), P(None), 1.0)
        t["dec_pos"] = leaf("dec_pos", (cfg.max_seq, d), P(FS, None), 0.02)
        t["layers"] = {"attn": _attn_tree(cfg, leaf, "D.attn", lead=L),
                       "xattn": _attn_tree(cfg, leaf, "D.xattn", ln_kv=True,
                                           lead=L),
                       "mlp": _mlp_tree(cfg, leaf, "D.mlp", lead=L)}
    else:
        raise ValueError(cfg.family)
    return t


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_tree(cfg: ModelConfig, leaf, batch_size: int, cache_len: int):
    """Decode-cache tree via the leaf callback ``leaf(name, shape, spec,
    scale)``.  The hybrid family's cache holds one (k, v, conv, h) tuple
    a layer: window layers keep ``min(window, cache_len)`` rows, global
    layers ``cache_len``."""
    L, kv, hd = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    fam = cfg.family
    mk = lambda name, shape, spec: leaf(name, shape, spec, 0.0)  # noqa: E731
    idx = leaf("idx", (), P(), 0.0)
    if fam in ("dense", "moe"):
        return {"k": mk("ck", (L, batch_size, cache_len, kv, hd),
                        P(None, DP, None, None, None)),
                "v": mk("cv", (L, batch_size, cache_len, kv, hd),
                        P(None, DP, None, None, None)),
                "idx": idx}
    if fam == "ssm":
        convd = cfg.d_inner + 2 * cfg.ssm_state
        return {"conv": mk("conv", (L, batch_size, cfg.conv_width - 1, convd),
                           P(None, DP, None, TP)),
                "h": mk("h", (L, batch_size, cfg.n_ssm_heads, cfg.ssm_d_head,
                              cfg.ssm_state), P(None, DP, TP, None, None)),
                "idx": idx}
    if fam == "hybrid":
        convd = cfg.d_inner + 2 * cfg.ssm_state
        layers = []
        for l in range(L):
            t = cache_len if l in cfg.global_layers else min(cfg.window,
                                                             cache_len)
            layers.append((
                mk(f"ck{l}", (batch_size, t, kv, hd), P(DP, None, None, None)),
                mk(f"cv{l}", (batch_size, t, kv, hd), P(DP, None, None, None)),
                mk(f"conv{l}", (batch_size, cfg.conv_width - 1, convd),
                   P(DP, None, TP)),
                mk(f"h{l}", (batch_size, cfg.n_ssm_heads, cfg.ssm_d_head,
                             cfg.ssm_state), P(DP, TP, None, None)),
            ))
        return {"layers": tuple(layers), "idx": idx}
    if fam == "vlm":
        g = cfg.n_layers // cfg.cross_attn_interval
        k_inner = cfg.cross_attn_interval - 1
        return {"k": mk("ck", (g, k_inner, batch_size, cache_len, kv, hd),
                        P(None, None, DP, None, None, None)),
                "v": mk("cv", (g, k_inner, batch_size, cache_len, kv, hd),
                        P(None, None, DP, None, None, None)),
                "img": mk("img", (batch_size, cfg.n_img_tokens, cfg.d_model),
                          P(DP, None, None)),
                "idx": idx}
    if fam == "audio":
        return {"k": mk("ck", (L, batch_size, cache_len, kv, hd),
                        P(None, DP, None, None, None)),
                "v": mk("cv", (L, batch_size, cache_len, kv, hd),
                        P(None, DP, None, None, None)),
                "enc": mk("enc", (batch_size, cfg.n_audio_frames, cfg.d_model),
                          P(DP, None, None)),
                "idx": idx}
    raise ValueError(fam)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``; a DTensor table is gathered over the data axes and
    looked up where its rows lie (a vocabulary split over the model axis
    gives partial sums that the caller's placement reduces)."""
    if not is_sharded(table):
        return table[idx.long()]
    return torch.nn.functional.embedding(idx.long(),
                                         weight(table, table.dtype))


def _embed(cfg: ModelConfig, params, tokens):
    # gather, then cast: the same values as casting the table first; the
    # gradient's duplicate rows add up in the table's dtype (the JAX
    # package adds them in the compute dtype)
    return _rows(params["embed"], tokens).to(cdt(cfg))


def _unembed(cfg: ModelConfig, params, x):
    x = rows_whole(rmsnorm(x, params["ln_f"], cfg.norm_eps))
    w = weight(params["embed"].T if cfg.tie_embeddings else params["head"],
               x.dtype)
    if is_sharded(w) and Shard(0) in w.placements:
        # a head split over d (a vocabulary that does not divide the model
        # axis) is split over the vocabulary instead, unevenly, before it
        # multiplies.  Its logits would be partial sums: reduce-scattered
        # onto the vocabulary, their gradient is gathered whole in the
        # backward; left partial, DTensor splits the loss's sequence over
        # the model axis at the production meshes, and cannot propagate
        # that split through the head's backward.  (Another head is left
        # alone: even a redistribute to the placements it has reduces its
        # gradient in the backward, an all-reduce where the FSDP gather's
        # backward would reduce-scatter.)
        w = w.redistribute(w.device_mesh, [Shard(1) if p == Shard(0) else p
                                           for p in w.placements])
    return torch.einsum("bsd,dv->bsv", x, w)


def _dense_layer(cfg, pl_, x, pos, cache, window=0):
    x, cache = attn_block(cfg, pl_["attn"], x, pos, cache, window=window)
    x = swiglu(cfg, pl_["mlp"], x)
    return x, cache


def _moe_layer(cfg, pl_, x, pos, cache, mesh=None):
    x, cache = attn_block(cfg, pl_["attn"], x, pos, cache)
    x = moe_block(cfg, pl_["moe"], x, mesh)
    return x, cache


def _hybrid_layer(cfg, pl_, x, pos, cache, is_global):
    """Hymba: attention heads and SSM heads in parallel on the same input.
    ``cache`` is ((k, v, idx), (conv, h)) or None."""
    window = 0 if is_global else cfg.window
    y = rmsnorm(x, pl_["attn"]["ln"], cfg.norm_eps)
    # attention branch (shares pl_["attn"] projections; no inner
    # residual): its output is taken back off the residual, in the
    # compute dtype
    res, attn_cache = attn_block(
        cfg, pl_["attn"], x, pos,
        None if cache is None else cache[0], window=window)
    o_attn = res - x
    # SSM branch on the same normalized input
    o_ssm, ssm_cache = mamba2_mix(cfg, pl_["mamba"], y,
                                  None if cache is None else cache[1],
                                  gated=False)
    mixed = 0.5 * (o_attn * pl_["mix_a"].to(x.dtype)
                   + o_ssm * pl_["mix_s"].to(x.dtype))
    x = x + mixed
    x = swiglu(cfg, pl_["mlp"], x)
    new_cache = None if cache is None else (attn_cache, ssm_cache)
    return x, new_cache


def _layers(tree, n: int):
    """The ``n`` layers of a stacked (L, ...) tree, as views.  Each leaf
    is unbound once: under autograd the backward of ``torch.unbind``
    stacks the layers' gradients once, where indexing ``v[l]`` per layer
    would build a zero tensor the size of the whole leaf for each layer."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _layers(v, n) if isinstance(v, dict) else torch.unbind(v)
        for l in range(n):
            out[l][k] = parts[l]
    return out


def _recompute_as_now():
    """``checkpoint``'s contexts: the forward runs as it is, the
    recompute in the route of the forward."""
    return contextlib.nullcontext(), current_route()


def _body(fn, x, remat: bool):
    """``fn(x)``; with ``remat``, keeping only its input for the backward,
    which recomputes the rest (the JAX package's ``jax.checkpoint`` of a
    layer body)."""
    if not remat:
        return fn(x)
    return checkpoint(fn, x, use_reentrant=False,
                      context_fn=_recompute_as_now)


def _encode_audio(cfg: ModelConfig, params, frames, remat: bool = False):
    """Whisper encoder over precomputed (stub) frame embeddings."""
    b, t, _ = frames.shape
    dt = cdt(cfg)
    x = frames.to(dt) + weight(params["enc_pos"], dt)[:t][None]
    pos = torch.arange(t, dtype=torch.int32,
                       device=frames.device)[None].expand(b, t)

    def ebody(xx, pl_):
        xx, _ = attn_block(cfg, pl_["attn"], xx, pos, None, causal=False,
                           rope_on=False)
        return swiglu(cfg, pl_["mlp"], xx)

    for pl_ in _layers(params["enc_layers"], cfg.encoder_layers):
        x = _body(lambda xx, pp=pl_: ebody(xx, pp), x, remat)
    return rmsnorm(x, params["enc_ln_f"], cfg.norm_eps)


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            cache: Optional[Dict] = None, mesh=None):
    """Returns (logits, new_cache).  Train/prefill when cache is None.

    Decode caches are not written in place: the new one is returned.  An
    SSM state leaves a decode step in float32 whatever dtype it came in
    with, as in the JAX package.

    ``mesh`` (a ``DeviceMesh``; ``params`` and ``batch`` DTensors on it)
    runs the cache-free forward SPMD, with the sequence-parallel
    constraint ``P(DP, TP, None)`` on the residual stream between layers
    (remat-saved activations shrink by the TP degree); the logits come
    out as a DTensor, the vocabulary split over the model axis.  With a
    cache (DTensors placed by ``cache_pspecs``) a decode step runs on
    each rank's rows of the cache: the weights stay split as their
    specs place them (heads and columns over the model axis, gathered
    over the data axes at each use as in the forward), each rank writes
    its rows of the K/V cache and its channels and heads of the SSM
    state, and the new cache comes out placed as the old one.  The
    residual stream of a one-token step has no sequence to split."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    # the residual stream's placement between layers: sequence-parallel,
    # or for a decode step (one token) the batch rows only
    sp = P(DP, TP, None) if cache is None else P(DP, None, None)
    sa = lambda t: shard_act(t, sp, mesh)  # noqa: E731
    x = sa(_embed(cfg, params, tokens))
    ar = torch.arange(s, dtype=torch.int32, device=dev)[None]
    if cache is None:
        pos = ar.expand(b, s)
        idx = None
    else:
        idx = cache["idx"]
        pos = local_map(lambda i: (i + ar).expand(b, s), idx.placements,
                        idx) if is_sharded(idx) else (idx + ar).expand(b, s)

    # remat as the JAX package's jax.checkpoint of the layer body: each
    # layer (a vlm group) keeps only its input and recomputes the rest in
    # the backward
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    fam = cfg.family
    L = cfg.n_layers
    new_cache = None

    if fam in ("dense", "moe", "ssm"):
        def layer(xx, pl_, c_l):
            if fam == "dense":
                return _dense_layer(cfg, pl_, xx, pos, c_l)
            if fam == "moe":
                return _moe_layer(cfg, pl_, xx, pos, c_l, mesh)
            return mamba_block(cfg, pl_["mamba"], xx, c_l)

        outs = []
        for l, pl_ in enumerate(_layers(params["layers"], L)):
            if cache is None:
                x = _body(lambda xx, pp=pl_: sa(layer(xx, pp, None)[0]), x,
                          remat)
                continue
            c_l = (cache["conv"][l], cache["h"][l]) if fam == "ssm" \
                else (cache["k"][l], cache["v"][l], idx)
            x, c_out = layer(x, pl_, c_l)
            outs.append(c_out)
        if cache is not None:
            names = ("conv", "h") if fam == "ssm" else ("k", "v")
            new_cache = {n: torch.stack([o[i] for o in outs])
                         for i, n in enumerate(names)}
            new_cache["idx"] = idx + s

    elif fam == "hybrid":
        layer_caches = []
        for l, pl_ in enumerate(_layers(params["layers"], L)):
            is_global = l in cfg.global_layers
            if cache is None:
                x = sa(_body(lambda xx, pp=pl_, gl=is_global: _hybrid_layer(
                    cfg, pp, xx, pos, None, gl)[0], x, remat))
                continue
            kc, vc, conv_s, h_s = cache["layers"][l]
            x, ((kc, vc, _), (conv_s, h_s)) = _hybrid_layer(
                cfg, pl_, x, pos, ((kc, vc, idx), (conv_s, h_s)), is_global)
            layer_caches.append((kc, vc, conv_s, h_s))
        if cache is not None:
            new_cache = {"layers": tuple(layer_caches), "idx": idx + s}

    elif fam == "vlm":
        img = batch["img"] if cache is None else cache["img"]
        g = cfg.n_layers // cfg.cross_attn_interval
        k_inner = cfg.cross_attn_interval - 1

        def group(xx, gi, pl_, px_):
            """One group = (interval-1) self layers with a gated
            cross-attn block (xattn + gated FFN, llama-3.2-vision style)
            before the last self layer.  Returns (x, [(k, v) a layer])."""
            kv_out = []
            for j, pj in enumerate(_layers(pl_, k_inner)):
                cj = None if cache is None else \
                    (cache["k"][gi, j], cache["v"][gi, j], idx)
                if j == k_inner - 1:   # cross-attn before the last layer
                    xx = cross_attn_block(cfg, px_["xattn"], xx, img)
                    gate = torch.tanh(px_["gate_mlp"].float()).to(xx.dtype)
                    xx = xx + gate * (swiglu(cfg, px_["mlp"], xx) - xx)
                xx, cj_out = _dense_layer(cfg, pj, xx, pos, cj)
                if cache is not None:
                    kv_out.append(cj_out)
            return xx, kv_out

        ks, vs = [], []
        for gi, (pl_, px_) in enumerate(zip(_layers(params["layers"], g),
                                            _layers(params["xlayers"], g))):
            if cache is None:
                x = _body(lambda xx, gg=gi, pp=pl_, qq=px_:
                          sa(group(xx, gg, pp, qq)[0]), x, remat)
                continue
            x, kv_out = group(x, gi, pl_, px_)
            ks.append(torch.stack([o[0] for o in kv_out]))
            vs.append(torch.stack([o[1] for o in kv_out]))
        if cache is not None:
            new_cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                         "img": img, "idx": idx + s}

    elif fam == "audio":
        enc = _encode_audio(cfg, params, batch["frames"], remat) \
            if cache is None else cache["enc"]
        # gather, then cast: the same values as casting the table first
        x = x + _rows(params["dec_pos"],
                      batch_like(pos, x) if is_sharded(x) else pos
                      ).to(x.dtype)

        def dlayer(xx, pl_, c_l):
            xx, c_out = attn_block(cfg, pl_["attn"], xx, pos, c_l,
                                   rope_on=False)
            xx = cross_attn_block(cfg, pl_["xattn"], xx, enc, gated=False)
            return swiglu(cfg, pl_["mlp"], xx), c_out

        outs = []
        for l, pl_ in enumerate(_layers(params["layers"], L)):
            if cache is None:
                x = _body(lambda xx, pp=pl_: sa(dlayer(xx, pp, None)[0]), x,
                          remat)
                continue
            x, c_out = dlayer(x, pl_, (cache["k"][l], cache["v"][l], idx))
            outs.append(c_out)
        if cache is not None:
            new_cache = {"k": torch.stack([o[0] for o in outs]),
                         "v": torch.stack([o[1] for o in outs]),
                         "enc": enc, "idx": idx + s}
    else:
        raise ValueError(fam)

    logits = _unembed(cfg, params, x)
    return logits, new_cache
