"""The paper's application models and its uniform injector, as numpy.

Frozen copies of the port's ``core/workloads/apps.py`` generators
``app_trace`` and ``random_trace``: the same draws from the same seeds,
so the same ``(num_nodes, refs)`` int32 address traces.  ``cfg`` is any
object with the configuration's ``num_nodes``, ``rows``, ``cols``,
``addr_bits`` and ``cache.l2_block``.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.PCG64(seed))


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


def _region_layout(cfg):
    addr_space = 1 << cfg.addr_bits
    blk = cfg.cache.l2_block
    shared_hi = addr_space // 4
    priv_size = max(blk * 4, (addr_space - shared_hi) // cfg.num_nodes)
    return addr_space, blk, shared_hi, priv_size


def _neighbour_table(cfg, nodes: np.ndarray):
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


def app_trace(cfg, app: str, refs_per_core: int = 200, seed: int = 0) -> np.ndarray:
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


def random_trace(cfg, refs_per_core: int = 200, seed: int = 0) -> np.ndarray:
    """Uniform-random traffic (the paper's synthetic injector)."""
    g = _rng(seed)
    addr_space = 1 << cfg.addr_bits
    a = g.integers(0, addr_space, size=(cfg.num_nodes, refs_per_core), dtype=np.int64)
    # align to word
    return ((a >> 2) << 2).astype(np.int32)
