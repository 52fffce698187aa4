"""Synthetic NoC destination patterns realized as address streams.

Frozen copies of the port's ``core/workloads/patterns.py`` generators:
each pattern reference uses a tag whose directory home (``tag % N``
under a distributed directory) is the pattern's destination, and with
probability ``1 - rate`` a reference re-touches a small node-local hot
set instead.  Patterns: ``transpose``, ``bitcomp``, ``tornado``,
``neighbor`` (fixed maps) and ``hotspot`` (a fraction ``frac`` aimed at
``hot`` evenly spaced nodes, the rest uniform).
"""
from __future__ import annotations

import numpy as np

#: the patterns with a fixed destination map
PERMUTATIONS = ("transpose", "bitcomp", "tornado", "neighbor")

#: per-node local hot-set size for filler (sub-``rate``) references.
_FILLER_HOT = 4


def _pat_seed(name: str, seed: int):
    # same stable-hash construction as apps._app_seed, offset so a pattern
    # and an app with the same seed never share a stream
    stable = sum(ord(ch) * (i + 1) for i, ch in enumerate(name)) % 65536
    return np.random.SeedSequence([0x5E7A, stable, seed])


def _rc(cfg):
    i = np.arange(cfg.num_nodes, dtype=np.int64)
    return i // cfg.cols, i % cfg.cols


def dst_map(cfg, name: str) -> np.ndarray:
    """The ``(N,)`` destination-node map of a deterministic pattern
    (``transpose`` / ``bitcomp`` / ``tornado`` / ``neighbor``) for
    ``cfg``'s mesh — the ground truth the property tests assert against.
    ``hotspot`` is stochastic and has no fixed map (``ValueError``)."""
    r, c = _rc(cfg)
    if name == "transpose":
        return (c * cfg.rows + r).astype(np.int64)
    if name == "bitcomp":
        return cfg.num_nodes - 1 - np.arange(cfg.num_nodes, dtype=np.int64)
    if name == "tornado":
        return (((r + cfg.rows // 2) % cfg.rows) * cfg.cols
                + (c + cfg.cols // 2) % cfg.cols)
    if name == "neighbor":
        return (r * cfg.cols + (c + 1) % cfg.cols).astype(np.int64)
    raise ValueError(f"pattern {name!r} has no deterministic destination "
                     f"map; deterministic patterns: "
                     f"{list(PERMUTATIONS)}")


def pattern_trace(cfg, refs_per_core: int, seed: int,
                  dst, rate: float, name: str) -> np.ndarray:
    """Synthesize the address stream realizing a destination pattern.

    Args:
        cfg: simulated machine (mesh + address-space geometry).
        refs_per_core: references per node (the trace's ``M``).
        seed: RNG seed; the stream is a pure function of
            ``(cfg, name, seed, params)``.
        dst: destination node per reference — ``(N,)`` (broadcast over
            references) or ``(N, M)``.
        rate: injection rate in ``[0, 1]`` — probability a reference
            carries pattern traffic; the rest re-touch a node-local
            hot set (home == self, so no network traffic after the
            first-touch memory fill).
        name: pattern name (seeds the per-pattern RNG stream).

    Returns: ``(N, M) int32`` addresses.  A pattern reference uses tag
    ``dst + k*N`` with ``k`` uniform over the tag space, so its
    directory home is exactly ``dst`` and repeated tags (which would be
    cache-hot and silent) are rare.

    Raises ``ValueError`` when the directory has fewer entries than the
    mesh has nodes: the home map ``tag % N`` then cannot reach every
    destination and the ``% entries`` wrap would silently scramble both
    the pattern and the rate throttle — grow ``cfg.addr_bits`` (or
    shrink ``cfg.cache.l2_block``) instead."""
    n, m = cfg.num_nodes, refs_per_core
    if cfg.dir_entries < n:
        raise ValueError(
            f"pattern {name!r} needs at least one directory entry per "
            f"node to realize destination homes, but dir_entries="
            f"{cfg.dir_entries} < num_nodes={n} "
            f"(addr_bits={cfg.addr_bits}, l2_block={cfg.cache.l2_block}); "
            "increase addr_bits")
    g = np.random.default_rng(np.random.PCG64(_pat_seed(name, seed)))
    entries = cfg.dir_entries
    k_span = max(1, entries // n)
    dst = np.asarray(dst, np.int64)
    if dst.ndim == 1:
        dst = dst[:, None]

    nodes = np.arange(n, dtype=np.int64)[:, None]
    kdraw = g.integers(0, k_span, (n, m))
    is_pat = g.random((n, m)) < rate
    # filler hot set: tags congruent to the own node id → inline directory,
    # cache-hot after first touch
    hot = nodes + g.integers(0, k_span, (n, _FILLER_HOT)) * n
    filler = np.take_along_axis(hot, g.integers(0, _FILLER_HOT, (n, m)),
                                axis=1)
    tag = np.where(is_pat, dst + kdraw * n, filler) % entries
    return (tag << cfg.cache.l2_shift).astype(np.int32)


def _hotspot_dst(cfg, g: np.random.Generator, m: int,
                 frac: float, hot: int) -> np.ndarray:
    n = cfg.num_nodes
    hot = min(hot, n)
    hot_ids = (np.arange(hot, dtype=np.int64) * n) // hot   # evenly spaced
    pick = g.integers(0, hot, (n, m))
    uni = g.integers(0, n, (n, m))
    return np.where(g.random((n, m)) < frac, hot_ids[pick], uni)


def permutation(cfg, refs: int, seed: int, name: str,
                rate: float = 1.0) -> np.ndarray:
    """A fixed-map pattern's trace."""
    return pattern_trace(cfg, refs, seed, dst_map(cfg, name), rate, name)


def hotspot(cfg, refs: int, seed: int, rate: float = 1.0, frac: float = 0.5,
            hot: int = 1) -> np.ndarray:
    """The hotspot pattern's trace."""
    g = np.random.default_rng(np.random.PCG64(_pat_seed("hotspot@", seed)))
    dst = _hotspot_dst(cfg, g, refs, frac, hot)
    return pattern_trace(cfg, refs, seed, dst, rate, "hotspot")
