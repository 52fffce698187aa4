"""Synthetic NoC traffic patterns, realized as address streams.

The deflection-routing literature (e.g. Ausavarungnirun & Mutlu's
deflection-network studies, Dally & Towles ch. 3) stresses bufferless
networks with classic destination patterns — transpose, bit-complement,
hotspot, tornado, neighbor — at controlled injection rates.  This
simulator is trace-driven: a node consumes *addresses*, and network
traffic materializes from the cache/directory protocol.  Each pattern is
therefore realized as an address stream whose **directory home nodes**
form the target destination pattern:

* with a distributed directory the home of tag ``t`` is ``t % N``
  (:func:`repro_torch.core.cache.dir_home_v`), so a reference to a fresh tag
  ``dst + k*N`` makes the source send a 1-flit DA to exactly ``dst``
  (and receive the DR back; the later victim DU rides the same pair);
* a reference whose tag is congruent to the *source* node is handled
  inline (no flits) — these "filler" references implement the
  injection-rate throttle: with probability ``1 - rate`` a reference
  re-touches a tiny node-local hot set (cache-hot after first touch)
  instead of injecting pattern traffic.

The patterns assume a **distributed** directory
(``centralized_directory=False``); under the paper-default centralized
directory every home is node 0 and any pattern degenerates to the
node-0 hotspot.

Destination maps for source ``(r, c)`` on a ``rows x cols`` mesh:

=============  ==========================================================
transpose      ``(r, c) -> (c, r)`` as index ``c*rows + r`` (works on
               non-square meshes too; classic matrix-transpose stress)
bitcomp        index ``i -> N-1-i`` (bitwise complement for power-of-two
               ``N``); maximal-distance corner-to-corner crossing
tornado        half-ring shift in both dimensions:
               ``((r + rows//2) % rows, (c + cols//2) % cols)`` —
               adversarial for dimension-ordered-style deflection routing
neighbor       ``(r, c) -> (r, (c+1) % cols)`` — best-case 1-hop traffic
hotspot        fraction ``frac`` of pattern references target one of
               ``hot`` evenly-spaced hot nodes; the rest are uniform
=============  ==========================================================

All generators are pure functions of ``(cfg, refs_per_core, seed,
params)`` and emit ``(N, M) int32`` addresses with no ``-1`` (the
exhaustion sentinel is reserved for padding by ``stacked_traces``).
"""
from __future__ import annotations

import numpy as np

from ..config import SimConfig
from .base import Param, TrafficGen, register

__all__ = ["pattern_trace", "PATTERN_NAMES", "dst_map"]

#: registered synthetic-pattern generator names (registration order).
PATTERN_NAMES = ("transpose", "bitcomp", "hotspot", "tornado", "neighbor")

#: per-node local hot-set size for filler (sub-``rate``) references.
_FILLER_HOT = 4


def _pat_seed(name: str, seed: int):
    # same stable-hash construction as apps._app_seed, offset so a pattern
    # and an app with the same seed never share a stream
    stable = sum(ord(ch) * (i + 1) for i, ch in enumerate(name)) % 65536
    return np.random.SeedSequence([0x5E7A, stable, seed])


def _rc(cfg: SimConfig):
    i = np.arange(cfg.num_nodes, dtype=np.int64)
    return i // cfg.cols, i % cfg.cols


def dst_map(cfg: SimConfig, name: str) -> np.ndarray:
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
                     f"{[n for n in PATTERN_NAMES if n != 'hotspot']}")


def pattern_trace(cfg: SimConfig, refs_per_core: int, seed: int,
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


def _hotspot_dst(cfg: SimConfig, g: np.random.Generator, m: int,
                 frac: float, hot: int) -> np.ndarray:
    n = cfg.num_nodes
    hot = min(hot, n)
    hot_ids = (np.arange(hot, dtype=np.int64) * n) // hot   # evenly spaced
    pick = g.integers(0, hot, (n, m))
    uni = g.integers(0, n, (n, m))
    return np.where(g.random((n, m)) < frac, hot_ids[pick], uni)


_RATE = Param(1.0, float, "injection rate: fraction of references that "
                          "carry pattern traffic", lo=0.0, hi=1.0)


def _make_perm(pname: str, helptext: str) -> TrafficGen:
    def fn(cfg, refs, seed, rate=1.0, _p=pname):
        return pattern_trace(cfg, refs, seed, dst_map(cfg, _p), rate, _p)
    return TrafficGen(name=pname, kind="pattern", help=helptext,
                      params={"rate": _RATE}, positional=("rate",), fn=fn)


register(_make_perm(
    "transpose", "destination (c, r): matrix-transpose permutation"))
register(_make_perm(
    "bitcomp", "destination N-1-i (bit-complement): maximal-distance "
               "corner-to-corner crossing"))


def _hotspot_fn(cfg, refs, seed, rate=1.0, frac=0.5, hot=1):
    g = np.random.default_rng(np.random.PCG64(_pat_seed("hotspot@", seed)))
    dst = _hotspot_dst(cfg, g, refs, frac, hot)
    return pattern_trace(cfg, refs, seed, dst, rate, "hotspot")


register(TrafficGen(
    name="hotspot", kind="pattern",
    help="fraction `frac` of pattern references target `hot` evenly-spaced "
         "hot nodes, the rest are uniform random",
    params={"rate": _RATE,
            "frac": Param(0.5, float, "fraction of pattern references "
                                      "aimed at the hot nodes",
                          lo=0.0, hi=1.0),
            "hot": Param(1, int, "number of hot nodes", lo=1)},
    positional=("frac",),
    fn=_hotspot_fn))

register(_make_perm(
    "tornado", "half-ring shift in both mesh dimensions: adversarial "
               "long-haul traffic for deflection routing"))
register(_make_perm(
    "neighbor", "destination (r, c+1 mod cols): best-case 1-hop traffic"))
