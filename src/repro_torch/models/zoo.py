"""The architecture zoo: one parameter-tree function + forward per family.

The counterpart of the JAX package's ``repro.models.zoo``.  This slice
ports the dense family (llama/qwen GQA); the moe, ssm, hybrid, vlm and
audio families raise ``NotImplementedError`` (``ROADMAP.md`` §1, item 7,
"LM, the other families").

Everything is a pure function over nested dict params.  Layer leaves are
stacked (L, ...) as in the JAX package, so parameters convert one to one;
the JAX package's ``lax.scan`` over the stack is a Python loop here, and
its ``jax.checkpoint`` of the layer body (``cfg.remat``) is
``torch.utils.checkpoint`` of each layer when a gradient is taken.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .common import attn_block, cdt, current_route, rmsnorm, swiglu
from .config import ModelConfig
from .params import Leaf

_LATER = ("the {} family is not ported yet (ROADMAP.md §1, item 7, 'LM, "
          "the other families'); the port's LM stack has the dense family")


def _attn_tree(cfg: ModelConfig, leaf: Leaf, pre: str,
               lead: tuple = ()) -> Dict[str, Any]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    sc = 0.02
    t = {
        "ln": leaf(pre + ".ln", lead + (d,), None, 1.0),
        "wq": leaf(pre + ".wq", lead + (d, h, hd), None, sc),
        "wk": leaf(pre + ".wk", lead + (d, kv, hd), None, sc),
        "wv": leaf(pre + ".wv", lead + (d, kv, hd), None, sc),
        "wo": leaf(pre + ".wo", lead + (h, hd, d), None, sc),
    }
    if cfg.qkv_bias:
        t["bq"] = leaf(pre + ".bq", lead + (h, hd), None, 0.0)
        t["bk"] = leaf(pre + ".bk", lead + (kv, hd), None, 0.0)
        t["bv"] = leaf(pre + ".bv", lead + (kv, hd), None, 0.0)
    return t


def _mlp_tree(cfg: ModelConfig, leaf: Leaf, pre: str, lead: tuple = ()):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln": leaf(pre + ".ln", lead + (d,), None, 1.0),
        "w1": leaf(pre + ".w1", lead + (d, f), None, 0.02),
        "w3": leaf(pre + ".w3", lead + (d, f), None, 0.02),
        "w2": leaf(pre + ".w2", lead + (f, d), None, 0.02),
    }


def param_tree(cfg: ModelConfig, leaf: Leaf) -> Dict[str, Any]:
    if cfg.family != "dense":
        raise NotImplementedError(_LATER.format(cfg.family))
    d, v = cfg.d_model, cfg.vocab
    t: Dict[str, Any] = {
        "embed": leaf("embed", (v, d), None, 0.02),
        "ln_f": leaf("ln_f", (d,), None, 1.0),
    }
    if not cfg.tie_embeddings:
        t["head"] = leaf("head", (d, v), None, 0.02)
    L = (cfg.n_layers,)
    t["layers"] = {"attn": _attn_tree(cfg, leaf, "L.attn", lead=L),
                   "mlp": _mlp_tree(cfg, leaf, "L.mlp", lead=L)}
    return t


def cache_tree(cfg: ModelConfig, leaf, batch_size: int, cache_len: int):
    """Decode-cache tree via the leaf callback ``leaf(name, shape, spec,
    scale)``."""
    if cfg.family != "dense":
        raise NotImplementedError(_LATER.format(cfg.family))
    L, kv, hd = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    return {"k": leaf("ck", (L, batch_size, cache_len, kv, hd), None, 0.0),
            "v": leaf("cv", (L, batch_size, cache_len, kv, hd), None, 0.0),
            "idx": leaf("idx", (), None, 0.0)}


def _embed(cfg: ModelConfig, params, tokens):
    # gather, then cast: the same values as casting the table first; the
    # gradient's duplicate rows add up in the table's dtype (the JAX
    # package adds them in the compute dtype)
    return params["embed"][tokens.long()].to(cdt(cfg))


def _unembed(cfg: ModelConfig, params, x):
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))


def _dense_layer(cfg, pl_, x, pos, cache, window=0):
    x, cache = attn_block(cfg, pl_["attn"], x, pos, cache, window=window)
    x = swiglu(cfg, pl_["mlp"], x)
    return x, cache


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


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            cache: Optional[Dict] = None):
    """Returns (logits, new_cache).  Train/prefill when cache is None."""
    if cfg.family != "dense":
        raise NotImplementedError(_LATER.format(cfg.family))
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    x = _embed(cfg, params, tokens)
    ar = torch.arange(s, dtype=torch.int32, device=dev)[None]
    if cache is None:
        pos = ar.expand(b, s)
        idx = None
    else:
        idx = cache["idx"]
        pos = (idx + ar).expand(b, s)

    # remat as the JAX package's jax.checkpoint of the layer body: each
    # layer keeps only its input and recomputes the rest in the backward
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    ks, vs = [], []
    for l, pl_ in enumerate(_layers(params["layers"], cfg.n_layers)):
        if remat:
            x = checkpoint(lambda xx, pp=pl_: _dense_layer(
                cfg, pp, xx, pos, None)[0], x, use_reentrant=False,
                context_fn=_recompute_as_now)
            continue
        c_l = None if cache is None else (cache["k"][l], cache["v"][l], idx)
        x, c_out = _dense_layer(cfg, pl_, x, pos, c_l)
        if cache is not None:
            ks.append(c_out[0])
            vs.append(c_out[1])
    new_cache = None if cache is None else \
        {"k": torch.stack(ks), "v": torch.stack(vs), "idx": idx + s}

    logits = _unembed(cfg, params, x)
    return logits, new_cache
