"""Application trace models (paper §6.2.3) + the uniform injector.

The paper feeds the simulator "representative traces" produced by Multi2sim
for five applications (matmul, apsi, mgrid, wupwise, equake) with ``M``
(=200) address references per core, and notes Multi2sim cannot produce traces
beyond ~100 cores.  We reproduce the *representative trace* methodology with
parameterized per-application access-pattern models that scale to any core
count, plus uniform-random traffic and traces derived from an LM model's
layer schedule (so the trace source scales with the simulated machine, which
is exactly the capability gap the paper calls out).

A trace is an ``(num_nodes, M) int32`` array of byte addresses, ``-1`` padded.

Synthesis is fully vectorized numpy sampling (node-slab batches of fixed
size, so output is independent of mesh size vs slab boundaries): at 100k+
cores the per-node Python loop of the original generator dominated sweep
setup; the vectorized form draws every random stream as a ``(nodes, M)``
block.  The original per-node-loop generator is kept verbatim as
:func:`app_trace_loop` — it is the distribution reference for
:func:`app_trace` (same access-pattern model, *different* PCG64 draw
order, so arrays differ but region/locality statistics match) and it
reproduces the exact (cfg, trace) combinations catalogued in ROADMAP
(e.g. the 16x16/matmul/seed-0/refs=20 protocol livelock).

Every generator here is registered as a :class:`~.base.TrafficGen`:
each app name, ``random``, and the ``loop`` reference family dispatch
through the shared :func:`~.base.resolve` grammar.  The generators are
copies of the JAX package's; ``tests/test_torch_config_workloads.py``
holds every output byte-identical to theirs.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..config import SimConfig
from .base import Param, TrafficGen, register

__all__ = ["TRACE_APPS", "app_trace", "app_trace_loop", "random_trace",
           "from_model_schedule"]

#: node-slab size for vectorized synthesis; fixed so the generated trace is
#: a pure function of (cfg, app, refs, seed), never of how slabs divide n.
_SLAB = 8192


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.PCG64(seed))


# ---------------------------------------------------------------------------
# Application models.  Each is characterized by:
#   stride         dominant access stride in bytes
#   p_shared       probability an access lands in the globally shared region
#   p_local        probability an access re-touches the node's hot set
#   hot_blocks     size of the node's hot set (in L2 blocks)
#   p_neighbour    probability of touching a mesh-neighbour's private region
#                  (stencil-style sharing)
# Values chosen to mimic the qualitative traffic mix of the SPEC-OMP codes
# the paper uses (matmul: heavy shared-B reuse; mgrid: stencil; equake:
# irregular sparse; wupwise: long strides; apsi: mixed).
# ---------------------------------------------------------------------------
TRACE_APPS = {
    "matmul": dict(stride=8, p_shared=0.45, p_local=0.35, hot_blocks=8, p_neighbour=0.05),
    "apsi": dict(stride=16, p_shared=0.20, p_local=0.50, hot_blocks=16, p_neighbour=0.10),
    "mgrid": dict(stride=8, p_shared=0.10, p_local=0.45, hot_blocks=12, p_neighbour=0.30),
    "wupwise": dict(stride=64, p_shared=0.25, p_local=0.40, hot_blocks=8, p_neighbour=0.10),
    "equake": dict(stride=4, p_shared=0.30, p_local=0.25, hot_blocks=24, p_neighbour=0.10),
}


def _app_seed(app: str, seed: int) -> int:
    stable = sum(ord(ch) * (i + 1) for i, ch in enumerate(app)) % 65536
    return seed * 1_000_003 + stable


def _region_layout(cfg: SimConfig):
    addr_space = 1 << cfg.addr_bits
    blk = cfg.cache.l2_block
    shared_hi = addr_space // 4
    priv_size = max(blk * 4, (addr_space - shared_hi) // cfg.num_nodes)
    return addr_space, blk, shared_hi, priv_size


def _neighbour_table(cfg: SimConfig, nodes: np.ndarray):
    """(len(nodes), 4) neighbour node ids (repeat-padded) + counts."""
    r, c = nodes // cfg.cols, nodes % cfg.cols
    cand = np.stack([
        np.where(r > 0, nodes - cfg.cols, -1),
        np.where(r < cfg.rows - 1, nodes + cfg.cols, -1),
        np.where(c > 0, nodes - 1, -1),
        np.where(c < cfg.cols - 1, nodes + 1, -1),
    ], axis=1)
    # compact valid neighbours to the front (stable order: up, down, left,
    # right — the same enumeration order as the loop reference)
    order = np.argsort(cand < 0, axis=1, kind="stable")
    cand = np.take_along_axis(cand, order, axis=1)
    count = (cand >= 0).sum(axis=1)
    # pad with the first neighbour so any index is safe (never selected:
    # picks are drawn modulo count)
    cand = np.where(cand < 0, cand[:, :1], cand)
    return cand, count


def app_trace(cfg: SimConfig, app: str, refs_per_core: int = 200, seed: int = 0) -> np.ndarray:
    """Representative trace for one of the paper's five applications.

    Vectorized synthesis: all randomness is drawn as ``(slab, M)`` blocks
    (one slab = up to ``_SLAB`` nodes), so generation is O(numpy ops), not
    O(n*M) Python iterations.  Draw order differs from the historical
    per-node loop (:func:`app_trace_loop`), so addresses differ draw-by-draw
    while the access-pattern *distribution* (region mix, hot-set reuse,
    stride behaviour) is identical — see ``tests/test_trace_vec.py``.
    """
    if app not in TRACE_APPS:
        raise ValueError(f"unknown app {app!r}; choose from {sorted(TRACE_APPS)}")
    p = TRACE_APPS[app]
    n, m = cfg.num_nodes, refs_per_core
    addr_space, blk, shared_hi, priv_size = _region_layout(cfg)
    priv_blocks = max(1, priv_size // blk)
    n_shared_blocks = max(1, shared_hi // blk)

    # bounded zipf(1.6) over the shared blocks by inverse CDF: one uniform
    # draw + searchsorted instead of numpy's rejection sampler.  The loop
    # reference draws unbounded zipf then wraps modulo n_shared_blocks; the
    # wrap moves < 1% of the mass at realistic block counts, so the two are
    # distribution-equivalent (asserted by tests/test_trace_vec.py).
    zcdf = np.cumsum(np.arange(1, n_shared_blocks + 1, dtype=np.float64)
                     ** -1.6)
    zcdf /= zcdf[-1]

    # int32 arithmetic end-to-end (addresses are bounded by
    # shared_hi + n*priv_size + priv_size): at 13M samples per 256x256
    # trace the generator is memory-bandwidth bound, so halving the
    # element width matters.  Fall back to int64 for astronomically
    # large meshes.
    top = shared_hi + (n + 1) * priv_size
    idt = np.int32 if top < 2**31 else np.int64
    t_local = p["p_shared"] + p["p_local"]
    t_nb = t_local + p["p_neighbour"]

    out = np.empty((n, m), dtype=np.int32)

    def fill_slab(slab_index: int) -> None:
        # per-slab generator derived from (app, seed, slab): slabs are
        # independent streams, so synthesis parallelizes over host threads
        # (numpy releases the GIL in the fill/searchsorted/cumsum kernels)
        # while staying a pure function of (cfg, app, refs, seed).
        g = np.random.default_rng(np.random.PCG64(
            np.random.SeedSequence([_app_seed(app, seed), slab_index])))
        lo = slab_index * _SLAB
        nodes = np.arange(lo, min(lo + _SLAB, n), dtype=idt)
        ns = len(nodes)
        base = (shared_hi + nodes * priv_size).astype(idt)

        hot = base[:, None] + g.integers(
            0, priv_blocks, (ns, p["hot_blocks"]), dtype=idt) * blk
        kinds = g.random((ns, m), dtype=np.float32)
        hot_idx = g.integers(0, p["hot_blocks"], (ns, m), dtype=np.int32)
        # uniform over each node's own neighbour count (2..4): scale one
        # uniform draw by the count — a modulo of a fixed-range draw would
        # bias the first neighbour on 3-neighbour border nodes
        nb_u = g.random((ns, m), dtype=np.float32)
        nb_block = g.integers(0, priv_blocks, (ns, m), dtype=idt)

        # default: the strided-cursor branch (cursor advances only on
        # strided references: a cumulative count, not a sequential loop)
        is_else = kinds >= t_nb
        strided = np.cumsum(is_else, axis=1, dtype=idt) * p["stride"]
        a = base[:, None] + strided % priv_size

        shared_m = kinds < p["p_shared"]
        local_m = (kinds >= p["p_shared"]) & (kinds < t_local)
        nb_m = (kinds >= t_local) & ~is_else & ~local_m

        # shared branch: draw exactly the uniforms it needs (the count is
        # a pure function of `kinds`, so generation stays deterministic)
        zu = g.random(int(shared_m.sum()), dtype=np.float32)
        zb = (np.searchsorted(zcdf, zu).astype(idt) + 1) % n_shared_blocks
        a[shared_m] = zb * blk

        a_local = np.take_along_axis(hot, hot_idx.astype(idt), axis=1)
        a[local_m] = a_local[local_m]

        nb_table, nb_count = _neighbour_table(cfg, nodes)
        nb_pick = (nb_u * nb_count[:, None]).astype(idt)
        nb = np.take_along_axis(nb_table.astype(idt), nb_pick, axis=1)
        a_nb = shared_hi + nb * priv_size + nb_block * blk
        a[nb_m] = a_nb[nb_m]

        out[lo:lo + ns] = a % addr_space

    n_slabs = -(-n // _SLAB)
    if n_slabs == 1:
        fill_slab(0)
    else:
        workers = min(n_slabs, os.cpu_count() or 1)
        with ThreadPoolExecutor(workers) as ex:
            list(ex.map(fill_slab, range(n_slabs)))
    return out


def app_trace_loop(cfg: SimConfig, app: str, refs_per_core: int = 200, seed: int = 0) -> np.ndarray:
    """Historical per-node-loop generator (the project's original trace
    source), kept verbatim: the distribution reference for the vectorized
    :func:`app_trace` and the exact reproducer for trace-dependent protocol
    pathologies catalogued in ROADMAP.  O(n*M) Python iterations — do not
    use for large meshes."""
    if app not in TRACE_APPS:
        raise ValueError(f"unknown app {app!r}; choose from {sorted(TRACE_APPS)}")
    p = TRACE_APPS[app]
    n = cfg.num_nodes
    g = _rng(_app_seed(app, seed))
    addr_space, blk, shared_hi, priv_size = _region_layout(cfg)

    out = np.full((n, refs_per_core), -1, dtype=np.int64)
    for node in range(n):
        base = shared_hi + node * priv_size
        r, c = divmod(node, cfg.cols)
        neighbours = [nr * cfg.cols + nc
                      for nr, nc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1))
                      if 0 <= nr < cfg.rows and 0 <= nc < cfg.cols]
        hot = base + (g.integers(0, max(1, priv_size // blk), p["hot_blocks"]) * blk)
        cursor = base
        kinds = g.random(refs_per_core)
        for i in range(refs_per_core):
            k = kinds[i]
            if k < p["p_shared"]:
                # shared region, zipf-ish: few very hot shared blocks
                zb = int(g.zipf(1.6)) % max(1, shared_hi // blk)
                a = zb * blk
            elif k < p["p_shared"] + p["p_local"]:
                a = int(hot[g.integers(0, len(hot))])
            elif k < p["p_shared"] + p["p_local"] + p["p_neighbour"] and neighbours:
                nb = neighbours[int(g.integers(0, len(neighbours)))]
                a = shared_hi + nb * priv_size + int(g.integers(0, priv_size // blk)) * blk
            else:
                cursor = base + (cursor - base + p["stride"]) % priv_size
                a = cursor
            out[node, i] = a % addr_space
    return out.astype(np.int32)


def random_trace(cfg: SimConfig, refs_per_core: int = 200, seed: int = 0) -> np.ndarray:
    """Uniform-random traffic (the paper's synthetic injector)."""
    g = _rng(seed)
    addr_space = 1 << cfg.addr_bits
    a = g.integers(0, addr_space, size=(cfg.num_nodes, refs_per_core), dtype=np.int64)
    # align to word
    return ((a >> 2) << 2).astype(np.int32)


def from_model_schedule(
    cfg: SimConfig,
    layer_params_bytes: int,
    d_model: int,
    n_layers: int,
    refs_per_core: int = 200,
    seed: int = 0,
) -> np.ndarray:
    """Derive an LCMP trace from an LM layer schedule.

    Nodes are tiled over (layer-shard, token-shard): node ``i`` repeatedly
    streams its weight shard (private, strided) and the activation blocks it
    exchanges with its layer neighbours (shared).  This replaces the paper's
    Multi2sim front-end, which could not scale past ~100 cores.

    Vectorized, bit-identical to the original per-node loop: the reference
    pattern is 6 strided weight-block reads then one random activation
    touch, so the only random draws are the activation block indices —
    numpy's bounded-integer sampling consumes the PCG64 stream identically
    whether drawn one scalar at a time or as one ``(n, k)`` block.
    """
    g = _rng(seed)
    n = cfg.num_nodes
    addr_space = 1 << cfg.addr_bits
    blk = cfg.cache.l2_block
    w_region = addr_space // 2
    act_region = addr_space - w_region

    shard = max(blk * 8, min(layer_params_bytes // max(1, n // n_layers), w_region // n))
    act_blocks = max(1, (d_model * 2) // blk)  # one bf16 activation vector

    nodes = np.arange(n, dtype=np.int64)
    layer = nodes % n_layers
    wbase = (nodes * shard) % max(blk, w_region - shard)
    abase = w_region + (layer * act_blocks * blk) % max(blk, act_region - act_blocks * blk)

    i = np.arange(refs_per_core, dtype=np.int64)
    is_act = (i % 7) == 6                          # 6 weight reads, 1 act touch
    n_act = int(is_act.sum())
    act_draw = g.integers(0, act_blocks, size=(n, n_act))

    out = np.empty((n, refs_per_core), dtype=np.int64)
    w_addr = wbase[:, None] + (i[None, :] * blk) % shard
    out[:] = w_addr
    if n_act:
        out[:, is_act] = abase[:, None] + act_draw * blk
    return (out % addr_space).astype(np.int32)


# ---------------------------------------------------------------------------
# Registration: the app models, the uniform injector, and the per-node-loop
# reference family all dispatch through the shared registry grammar.
# ---------------------------------------------------------------------------

_APP_HELP = {
    "matmul": "dense matmul: heavy shared-B reuse (zipf shared blocks)",
    "apsi": "mixed locality (SPEC-OMP apsi-like traffic mix)",
    "mgrid": "stencil: strong mesh-neighbour sharing",
    "wupwise": "long strided streams, moderate sharing",
    "equake": "irregular sparse accesses, large hot set",
}

for _app in TRACE_APPS:
    register(TrafficGen(
        name=_app, kind="app", help=_APP_HELP[_app],
        fn=(lambda cfg, refs, seed, _a=_app: app_trace(cfg, _a, refs, seed))))

register(TrafficGen(
    name="random", kind="injector",
    help="uniform-random addresses over the whole space (the paper's "
         "synthetic injector)",
    fn=lambda cfg, refs, seed: random_trace(cfg, refs, seed)))

register(TrafficGen(
    name="loop", kind="reference",
    help="historical per-node-loop app generator — exact reproducer of "
         "trace-dependent pathologies (e.g. loop:matmul, the former "
         "16x16/seed-0/refs-20 S14 wedge); O(n*M) Python, small meshes only",
    params={"app": Param("matmul", str, "which application model",
                         choices=tuple(TRACE_APPS))},
    positional=("app",),
    fn=lambda cfg, refs, seed, app="matmul":
        app_trace_loop(cfg, app, refs, seed)))
