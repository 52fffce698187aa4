"""Port parity: sharding specs and their resolution, against the JAX
package, with no process group.

* ``resolve_pspec`` on ``tests/test_sharding_resolve.py``'s cases and on
  production-size meshes, against ``repro.parallel.sharding``;
* the resolved parameter, cache and input spec trees of every
  architecture at full width, on the meshes (16, 16), (2, 16, 16),
  (2, 2), (1, 4) and (4, 1), against the JAX package's trees resolved on
  ``jax.sharding.AbstractMesh`` (which needs no devices);
* placements: a resolved spec as DTensor placements, and each rank's
  block in JAX's order.
"""
import itertools

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh as JMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.models.params import Alt as JAlt
from repro.parallel import sharding as jsharding

from repro_torch.configs import registry
from repro_torch.models import api
from repro_torch.models.params import Alt
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P, UNC, AbstractMesh

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model")),
          ((4, 1), ("data", "model"))]


def _norm_entry(e):
    """A spec entry as the tuple of axes that split its dim."""
    if e is None:
        return ()
    if e is UNC or e is JP.UNCONSTRAINED:
        return "UNC"
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)


def _norm(spec, ndim):
    entries = [_norm_entry(e) for e in spec]
    return tuple(entries + [()] * (ndim - len(entries)))


def _to_jax(spec):
    if isinstance(spec, Alt):
        return JAlt(*(_to_jax(s) for s in spec))
    return JP(*(JP.UNCONSTRAINED if e is UNC else e for e in spec))


CASES = [
    (P(("pod", "data"), None), (8, 4)),
    (Alt(P(None, "model", None), P("model", None, None)), (64, 14, 8)),
    (P("data", "model"), (7, 5)),
    (Alt(P(("pod", "data"), "model", None), P("model", None,
                                              ("pod", "data"))),
     (64, 4, 64)),
    (Alt(P(("pod", "data"), "model", None), P("model", None,
                                              ("pod", "data")),
         P(None, None, None)), (56, 14, 128)),
    (P("model", ("pod", "data")), (32000, 2048)),
    (P(None, "model", UNC, UNC), (32, 60, 10, 8)),
    (P(), ()),
]


@pytest.mark.parametrize("shape,axes", MESHES + [((1, 1), ("data", "model")),
                                                 ((1,), ("model",))])
def test_resolve_pspec_equals_jax(shape, axes):
    tm, jm = AbstractMesh(shape, axes), JMesh(shape, axes)
    for spec, arr in CASES:
        for s in (arr, None):
            got = sharding.resolve_pspec(spec, tm, s)
            want = jsharding.resolve_pspec(_to_jax(spec), jm, s)
            n = len(arr)
            assert _norm(got, n) == _norm(want, n), (spec, arr, shape)


def _jax_trees(arch, mesh):
    cfg = jregistry.get(arch)
    a = japi.abstract_params(cfg)
    p = jsharding.tree_pspecs_resolved(japi.param_pspecs(cfg), mesh, a)
    ac = japi.abstract_cache(cfg, 32, 256)
    c = jsharding.tree_pspecs_resolved(japi.cache_pspecs(cfg, 32, 256), mesh,
                                       ac)
    ins = {}
    for kind in ("train", "prefill", "decode"):
        ai = japi.input_specs(cfg, kind, 32, 256)
        ins[kind] = jsharding.tree_pspecs_resolved(
            japi.input_pspecs(cfg, kind), mesh, ai)
    leaves = lambda t, a_: [  # noqa: E731
        _norm(s, len(x.shape)) for s, x in zip(
            jax.tree_util.tree_leaves(
                t, is_leaf=lambda v: isinstance(v, JP)),
            jax.tree_util.tree_leaves(a_))]
    return (leaves(p, a), leaves(c, ac),
            {k: leaves(v, japi.input_specs(cfg, k, 32, 256))
             for k, v in ins.items()},
            jax.tree_util.tree_structure(a))


def _port_trees(arch, mesh):
    cfg = registry.get(arch)
    a = api.abstract_params(cfg)
    p = sharding.tree_pspecs_resolved(api.param_pspecs(cfg), mesh, a)
    ac = api.init_cache(cfg, 32, 256, device="meta")
    c = sharding.tree_pspecs_resolved(api.cache_pspecs(cfg, 32, 256), mesh,
                                      ac)

    def leaves(t, a_):
        # JAX's leaf order: dict keys sorted, tuples in order
        out = []

        def walk(s, x):
            if isinstance(x, dict):
                for k in sorted(x):
                    walk(s[k], x[k])
            elif isinstance(x, tuple):
                for si, xi in zip(s, x):
                    walk(si, xi)
            else:
                out.append(_norm(s, x.dim()))
        walk(t, a_)
        return out

    ins = {kind: leaves(sharding.tree_pspecs_resolved(
        api.input_pspecs(cfg, kind), mesh,
        api.input_specs(cfg, kind, 32, 256)),
        api.input_specs(cfg, kind, 32, 256))
        for kind in ("train", "prefill", "decode")}
    return leaves(p, a), leaves(c, ac), ins


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_resolved_spec_trees_equal_jax(arch):
    """Parameter, cache and input spec trees, leaf for leaf, resolved at
    full width on every mesh."""
    for shape, axes in MESHES:
        jp, jc, ji, _ = _jax_trees(arch, JMesh(shape, axes))
        tp, tc, ti = _port_trees(arch, AbstractMesh(shape, axes))
        assert tp == jp, (arch, shape)
        assert tc == jc, (arch, shape)
        assert ti == ji, (arch, shape)
        assert len(tp) > 3


def test_gqa_fallback_is_row_parallel_where_kv_heads_do_not_divide():
    """tinyllama-1.1b at (16, 16): 32 q heads split over the model axis,
    its 4 KV heads do not, so ``wk`` resolves row-parallel (the case the
    sharded attention handles with whole KV heads on each rank)."""
    cfg = registry.get("tinyllama-1.1b")
    mesh = AbstractMesh((16, 16), ("data", "model"))
    r = sharding.tree_pspecs_resolved(api.param_pspecs(cfg), mesh,
                                      api.abstract_params(cfg))
    attn = r["layers"]["attn"]
    assert attn["wq"] == P(None, ("data",), "model", None)
    assert attn["wk"] == P(None, "model", None, ("data",))
    assert attn["wv"] == P(None, "model", None, ("data",))


def test_placements_of_resolved_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert sharding.placements(P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert sharding.placements(P(None, ("data",)), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert sharding.placements(P(), mesh) == (Replicate(),) * 3
    # UNCONSTRAINED keeps the current split of its dim
    cur = (Shard(1), Shard(0), Shard(2))
    assert sharding.placements(P(("pod",), UNC, "model"), mesh, cur) == (
        Shard(0), Replicate(), Shard(2))
    with pytest.raises(NotImplementedError, match="order"):
        sharding.placements(P(("data", "pod")), mesh)


def test_local_blocks_follow_jax_order():
    """Each rank's block (``sharding.block``) under ``P(("pod", "data"),
    "model")`` on a (2, 2, 2) mesh: the dim's chunk ``pod * 2 + data``,
    as JAX orders the devices of an entry, first axis major."""
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    mesh.size = lambda i: 2
    pl = sharding.placements(P(("pod", "data"), "model"), mesh)
    full = torch.arange(48).reshape(8, 6)
    for pod, data, model in itertools.product(range(2), repeat=3):
        i = pod * 2 + data
        got = sharding.block(full, mesh, pl, (pod, data, model))
        assert torch.equal(got, full[2 * i:2 * i + 2,
                                     3 * model:3 * model + 3])


def test_specs_pickle_as_themselves():
    import pickle
    for s in (P(("pod", "data"), None, UNC), Alt(P("model"), P(None))):
        t = pickle.loads(pickle.dumps(s))
        assert t == s and type(t) is type(s)
        assert (t[-1] is UNC) == (s[-1] is UNC)
