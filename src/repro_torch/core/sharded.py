"""Multi-device NoC simulation: the spatial and composed backends.

The PyTorch counterpart of the JAX package's ``repro.core.sharded``.
JAX runs one ``shard_map`` program over a device mesh; here every rank is
a process with a device of its own (:mod:`repro_torch.dist`), and every
rank runs the same host loop, SPMD, over ``torch.distributed``.

* **Spatial (2-D)** — the router grid ``(R, C)`` is block-partitioned
  over a ``row_tiles x col_tiles`` grid of ranks (JAX's row axes, such
  as ``("pod", "data")``, are one factor of ``row_tiles`` here).  Every
  phase is tile-local except Phase 3's flit transfer, whose cross-tile
  edges become four halo slabs a cycle, exchanged with the wraparound
  neighbours by one ``dist.batch_isend_irecv``; the global mesh's edges
  have no links, so ``valid_port`` masks what wraps around.  A tile axis
  of size 1 takes its own slab, with no collective.
* **Composed (3-D)** — a batch of B scenarios of one mesh shape over a
  ``(batch_shards, row_tiles, col_tiles)`` grid: each scenario shard
  holds ``B / batch_shards`` scenarios, and each of its tiles steps them
  through the same per-tile cycle.  The local scenarios' slabs for one
  direction travel in ONE message, so a cycle pays the collective's
  fixed cost once per direction, not once per scenario.  Termination is
  per scenario: a finished scenario freezes bit-identically to its solo
  run while its batch-mates step on.  :func:`run_composed` drives it.

The directory must be distributed (``dir_layout="home"``): the entry of
tag t lives at node ``t % N``, which alone touches it, so the directory
shards exactly like the nodes and needs no collective of its own.

Per cycle a tile: reduces its scenarios' termination flags over its
spatial subgroup (one ``all_reduce``, no host sync: on NCCL it stays on
the stream), widens the state, runs Phases 1a, 1b and 2 (the fused
Phase-2 router kernel on CUDA, with the tile's router count and global
node ids) per scenario, exchanges the halos, runs ``deliver``, narrows
the state, and freezes every leaf of a scenario that had finished.  The
statistics are NOT folded each cycle: they start the chunk replicated,
gather tile-local deltas, and at the chunk's end both words' deltas are
summed over the spatial subgroup and folded once, which makes them
bit-equal to the dense run's per-cycle fold at chunk edges.  The host
checks termination and the livelock monitor once a chunk
(:meth:`ShardedSim.run`).

Every rank of the default process group must make the same calls in the
same order: :class:`ProcessGrid` creates subgroups collectively, and
:func:`run_sharded` / :func:`run_composed` return the results on every
rank.  Without a process group only the grid ``(1, 1, 1)`` exists, and
it runs with no collective at all.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..dist import rank as _rank, world_size as _world_size
from .cache import phase1a, phase1b
from .config import SimConfig
from .noc import deliver, phase2
from .sim import (ABORT_LIVELOCK, DIAG_FIELDS, ExecAux, _PROG_IDX,
                  check_cycle_cap, diag_counts, finished, stats_dicts)
from .state import (I32, NODE_LEAVES, NUM_F, SimState, fold_stats,
                    init_state, leaf_dtypes, make_tile_ctx, narrow_state,
                    tile_state, widen_state)

__all__ = ["ProcessGrid", "ShardedSim", "run_sharded", "run_composed"]

Grid3 = Tuple[int, int, int]
#: SimState's knob leaves, in ``SweepSpec.knob_arrays`` order
_KNOBS = ("knob_mig", "knob_mig_thr", "knob_central", "knob_ej_age")


class ProcessGrid:
    """A ``(batch_shards, row_tiles, col_tiles)`` grid of ranks: the
    first ``batch_shards * row_tiles * col_tiles`` ranks of the default
    process group, rank ``(b * row_tiles + r) * col_tiles + c`` at
    coordinate ``(b, r, c)`` (the JAX package's mesh order).

    Every rank of the default group must build it, in the same order as
    the others: it creates the grid's group (when the grid leaves ranks
    out) and one subgroup per scenario shard (the shard's spatial tiles,
    which reduce termination flags and statistics) collectively.  A rank
    off the grid has ``member`` false.  Without a process group only
    ``(1, 1, 1)`` exists.  :meth:`close` destroys the subgroups.
    """

    def __init__(self, batch_shards: int, row_tiles: int, col_tiles: int):
        self.shape: Grid3 = (batch_shards, row_tiles, col_tiles)
        if min(self.shape) < 1:
            raise ValueError(f"grid {self.shape}: every axis must be >= 1")
        self.size = batch_shards * row_tiles * col_tiles
        self.world = _world_size()
        self.rank = _rank()
        if self.world < self.size:
            raise ValueError(
                f"grid {self.shape} needs {self.size} rank(s), the process "
                f"group has {self.world}")
        self.distributed = dist.is_initialized()
        self.member = self.rank < self.size
        self._made: List = []
        self.group = self.spatial = None
        nspat = row_tiles * col_tiles
        if self.distributed:
            self.group = self._subgroup(range(self.size))
            if batch_shards == 1:
                self.spatial = self.group
            else:
                for b in range(batch_shards):
                    g = self._subgroup(range(b * nspat, (b + 1) * nspat))
                    if b == self.rank // nspat:
                        self.spatial = g
        r = self.rank if self.member else 0
        self.coord: Grid3 = (r // nspat, r // col_tiles % row_tiles,
                             r % col_tiles)

    def _subgroup(self, ranks):
        ranks = list(ranks)
        if len(ranks) == self.world:
            return dist.group.WORLD
        g = dist.new_group(ranks)           # collective over the world
        if self.rank in ranks:
            self._made.append(g)
        return g

    def peer(self, dr: int, dc: int) -> int:
        """Global rank of the tile ``(dr, dc)`` away from this one, in
        this rank's scenario shard, with wraparound."""
        b, r, c = self.coord
        _, rt, ct = self.shape
        return (b * rt + (r + dr) % rt) * ct + (c + dc) % ct

    def close(self) -> None:
        for g in self._made:
            dist.destroy_process_group(g)
        self._made = []


class ShardedSim:
    """One rank's part of a sharded simulation: its scenario shard's
    scenarios, each cut to its tile.

    Args:
        cfg: the structural config; it must use the distributed,
            home-sharded directory (``centralized_directory=False``,
            ``dir_layout="home"``), and ``rows``/``cols`` must divide by
            the grid's row/col tiles.
        trace: ``(num_nodes, M)`` for a solo spatial run, or ``(B,
            num_nodes, M)`` for a batched (composed) run, whose B must
            divide by the grid's scenario shards.  The whole trace, as
            every rank of the grid receives it.
        grid: the :class:`ProcessGrid`; this rank must be on it.
        knobs: optional ``(migration, threshold, centralized,
            eject_age)`` int32 vectors of length B, as
            :meth:`repro_torch.core.sweep.SweepSpec.knob_arrays` gives
            them.
        device: this rank's device (``None``: the current CUDA device).

    Every rank builds its scenarios' initial state on the host
    (``init_state`` on the CPU) and keeps its tile of it on ``device``.
    :meth:`run` returns one statistics dict (solo) or a list of B
    (batched), each bit-identical to the solo
    :func:`repro_torch.core.sim.run`, on every rank of the grid."""

    def __init__(self, cfg: SimConfig, trace: np.ndarray, grid: ProcessGrid,
                 knobs: Optional[Sequence[np.ndarray]] = None, device=None):
        if cfg.centralized_directory or cfg.dir_layout != "home":
            raise ValueError("sharded simulation requires the distributed, "
                             "home-sharded directory")
        bs, rt, ct = grid.shape
        if cfg.rows % rt or cfg.cols % ct:
            raise ValueError(f"mesh {cfg.rows}x{cfg.cols} not divisible by "
                             f"tiles {rt}x{ct}")
        if not grid.member:
            raise ValueError(f"rank {grid.rank} is not on the grid "
                             f"{grid.shape}")
        trace = np.asarray(trace)
        if trace.ndim == 3:
            if trace.shape[0] % bs:
                raise ValueError(
                    f"batch {trace.shape[0]} not divisible by {bs} scenario "
                    f"shard(s); pad like run_composed does")
        elif trace.ndim != 2 or bs != 1:
            raise ValueError("a solo (num_nodes, M) trace runs on one "
                             "scenario shard; scenario shards need a "
                             "(B, num_nodes, M) trace")
        self.cfg = cfg
        self.grid = grid
        self.device = resolve_device(device)
        self.batch = trace.shape[0] if trace.ndim == 3 else None
        b, r, c = grid.coord
        self.tile_rows, self.tile_cols = cfg.rows // rt, cfg.cols // ct
        rows = slice(r * self.tile_rows, (r + 1) * self.tile_rows)
        cols = slice(c * self.tile_cols, (c + 1) * self.tile_cols)
        local = slice(None)
        if self.batch is not None:
            per = self.batch // bs
            local = slice(b * per, (b + 1) * per)
            trace = trace[local]
        s = init_state(cfg, trace, "cpu")
        if knobs is not None:
            s = s._replace(**{k: torch.as_tensor(np.asarray(v)[local],
                                                 dtype=I32)
                              for k, v in zip(_KNOBS, knobs)})
        tile = tile_state(s, cfg, rows, cols)
        tile = SimState(*(x.to(self.device) for x in tile))
        #: the local scenarios' tile states, each solo-shaped
        self.states: List[SimState] = (
            [tile] if self.batch is None
            else [SimState(*(x[i] for x in tile))
                  for i in range(tile.cycle.shape[0])])
        self.ctx = make_tile_ctx(cfg, rows, cols, self.device)
        self.dtypes = leaf_dtypes(cfg, trace.shape[-1])
        self.ntiles = rt * ct
        self._vp4 = self.ctx.valid_port.reshape(self.tile_rows,
                                                self.tile_cols, 4, 1)
        # gloo's send/recv read host memory: on that backend CUDA slabs
        # travel through host tensors (the compute stays on the card)
        self._halo_via_host = (
            grid.distributed and self.device.type == "cuda"
            and dist.get_backend(grid.spatial) == "gloo")

    # -- collectives ------------------------------------------------------

    def _tile_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the spatial tiles of this scenario shard."""
        if self.grid.distributed:
            dist.all_reduce(t, group=self.grid.spatial)
        return t

    def _global_finished(self) -> torch.Tensor:
        """(Bl,) bool: each local scenario finished on every tile."""
        local = torch.stack([finished(s) for s in self.states]).to(I32)
        return self._tile_sum(local) == self.ntiles

    def _exchange(self, slabs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The halo slabs' trip: ``slabs`` are the four directions' sends
        (to the tile below, above, right, left); returns what arrives
        from above, below, left, right.  An axis of one tile sends to
        itself, with no collective."""
        _, rt, ct = self.grid.shape
        routes = ((1, 0, rt), (-1, 0, rt), (0, 1, ct), (0, -1, ct))
        got: List[Optional[torch.Tensor]] = [None] * 4
        ops = []
        for k, (slab, (dr, dc, size)) in enumerate(zip(slabs, routes)):
            if size == 1:
                got[k] = slab
                continue
            if self._halo_via_host:
                slab = slab.cpu()
            recv = torch.empty_like(slab)
            # tags keep the two directions apart when both neighbours
            # along an axis are the same rank (an axis of two tiles)
            ops += [dist.P2POp(dist.isend, slab, self.grid.peer(dr, dc),
                               self.grid.spatial, tag=k),
                    dist.P2POp(dist.irecv, recv, self.grid.peer(-dr, -dc),
                               self.grid.spatial, tag=k)]
            got[k] = recv
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [g.to(self.device) for g in got]

    def _halo_transfer(self, out4: torch.Tensor) -> torch.Tensor:
        """Phase 3's transfer for the local scenarios' ``(Bl, Rt, Ct, 4,
        F)`` outputs: input port p of a router reads the opposite output
        of its neighbour in direction p, across tile edges through the
        halo slabs; returns ``(Bl, Nl, 4, F)``."""
        above, below, left, right = self._exchange([
            out4[:, -1, :, 2].contiguous(),   # my S outputs feed the N
            out4[:, 0, :, 0].contiguous(),    # my N outputs feed the S
            out4[:, :, -1, 1].contiguous(),   # my E outputs feed the W
            out4[:, :, 0, 3].contiguous()])   # my W outputs feed the E
        in_n = torch.cat([above[:, None], out4[:, :-1, :, 2]], dim=1)
        in_s = torch.cat([out4[:, 1:, :, 0], below[:, None]], dim=1)
        in_w = torch.cat([left[:, :, None], out4[:, :, :-1, 1]], dim=2)
        in_e = torch.cat([out4[:, :, 1:, 3], right[:, :, None]], dim=2)
        inp = torch.stack([in_n, in_e, in_s, in_w], dim=3)
        inp = torch.where(self._vp4, inp, 0)
        return inp.reshape(out4.shape[0], -1, 4, NUM_F)

    # -- stepping ---------------------------------------------------------

    def _cycle(self) -> None:
        """One cycle of every local scenario on this tile; a scenario that
        had finished on every tile keeps its state, leaf for leaf."""
        cfg, ctx = self.cfg, self.ctx
        fin = self._global_finished()
        mid = []
        for s in self.states:
            w = phase1b(phase1a(widen_state(s), cfg, ctx), cfg, ctx)
            mid.append(phase2(w, cfg, ctx))
        out4 = torch.stack([arb.out for _, arb in mid]).reshape(
            len(mid), self.tile_rows, self.tile_cols, 4, NUM_F)
        inp = self._halo_transfer(out4)
        new = []
        for i, (s, (w, arb)) in enumerate(zip(self.states, mid)):
            w = deliver(w, cfg, ctx, arb, inp[i])
            w = narrow_state(w._replace(cycle=w.cycle + 1), self.dtypes)
            new.append(SimState(*(
                a if a is n else torch.where(fin[i], a, n)
                for a, n in zip(s, w))))
        self.states = new

    @torch.inference_mode()
    def step(self, n_cycles: int) -> None:
        """Advance every local scenario ``n_cycles`` cycles (a finished
        one stays frozen), then bring the statistics to their replicated,
        folded form."""
        in_hi = [s.stats_hi for s in self.states]
        in_lo = [s.stats for s in self.states]
        for _ in range(n_cycles):
            self._cycle()
        delta = self._tile_sum(torch.stack([
            torch.stack([s.stats_hi - h, s.stats - lo])
            for s, h, lo in zip(self.states, in_hi, in_lo)]))
        for i, (h, lo) in enumerate(zip(in_hi, in_lo)):
            hi, lo = fold_stats(h + delta[i, 0], lo + delta[i, 1])
            self.states[i] = self.states[i]._replace(stats=lo, stats_hi=hi)

    # -- the host loop ------------------------------------------------------

    def run(self, max_cycles: Optional[int] = None, chunk: int = 256
            ) -> Union[Dict[str, int], List[Dict[str, int]]]:
        """Host-chunked loop, the JAX package's ``ShardedSim.run``.

        All active (unfinished, unaborted) scenarios share one clock and
        step together a chunk at a time; the tail chunk is clamped, so an
        unfinished run stops at exactly ``max_cycles``.  Termination and
        the livelock monitor are checked once a chunk (chunk granularity:
        progress must be absent across whole chunks, a conservative form
        of the solo run's per-cycle monitor).  An aborted scenario
        keeps stepping, with its statistics snapshotted at the abort's
        chunk edge.  There is no directory-saturation monitor (the
        directory is distributed).

        Args:
            max_cycles: cycle cap (default ``cfg.max_cycles``).
            chunk: cycles per termination/livelock check (one host sync).

        Returns: one stats dict (solo) or a list of B dicts in scenario
        order (batched), on every rank of the grid."""
        cfg = self.cfg
        check_cycle_cap(cfg, max_cycles)
        limit = max_cycles or cfg.max_cycles
        lw = cfg.livelock_window_effective
        nb = len(self.states)
        nstats = int(self.states[0].stats.shape[-1])
        prev_prog: List = [None] * nb
        frozen = np.zeros(nb, np.int64)
        abort = np.zeros(nb, np.int32)
        ab_cycle = np.zeros(nb, np.int32)
        ab_stats = np.zeros((nb, nstats), np.int32)
        ab_hi = np.zeros((nb, nstats), np.int32)
        diag = np.zeros((nb, len(DIAG_FIELDS)), np.int32)
        fin = self._global_finished().cpu().numpy()
        while True:
            active = ~fin & (abort == 0)
            if not active.any():
                break
            cycles = np.asarray([int(s.cycle) for s in self.states])
            cyc = int(cycles[active].max())
            if cyc >= limit:
                break
            n_step = min(chunk, limit - cyc)
            self.step(n_step)
            # one predicate evaluation a chunk: the monitor's guard and
            # the next iteration's activity mask
            fin = self._global_finished().cpu().numpy()
            if not lw:
                continue
            stats = torch.stack([s.stats for s in self.states]).cpu().numpy()
            for b in np.nonzero(active)[0]:
                prog = stats[b, list(_PROG_IDX)].tobytes()
                if prog == prev_prog[b]:
                    frozen[b] += n_step
                else:
                    prev_prog[b], frozen[b] = prog, 0
                if frozen[b] >= lw and not fin[b]:
                    s = self.states[b]
                    abort[b] = ABORT_LIVELOCK
                    ab_cycle[b] = int(s.cycle)
                    ab_stats[b] = stats[b]
                    ab_hi[b] = s.stats_hi.cpu().numpy()
                    diag[b] = self._tile_sum(
                        diag_counts(s.st, s.inp, s.q_size)).cpu().numpy()
        aux = ExecAux(abort=abort, abort_cycle=ab_cycle, abort_stats=ab_stats,
                      abort_stats_hi=ab_hi,
                      **{k: diag[:, j] for j, k in enumerate(DIAG_FIELDS)})
        stack = lambda k: torch.stack(  # noqa: E731
            [getattr(s, k) for s in self.states])
        local = stats_dicts(stack("stats_hi"), stack("stats"), stack("cycle"),
                            fin, aux)
        out = self._gather_shards(local)
        return out[0] if self.batch is None else out

    def _gather_shards(self, local: List) -> List:
        """Every scenario shard's list, in shard order, on every rank of
        the grid (the tiles of a shard hold the same list)."""
        if not self.grid.distributed:
            return local
        lead = self.grid.coord[1:] == (0, 0)
        parts: List = [None] * self.grid.size
        dist.all_gather_object(parts, local if lead else None,
                               group=self.grid.group)
        return [d for p in parts if p is not None for d in p]

    def gather_state(self) -> SimState:
        """The whole state, every tile of every scenario shard put back
        together on the host: CPU tensors, node-major, with a leading
        scenario axis for a batched run.  Every rank of the grid gets it.
        For tests and small meshes: it moves the whole state."""
        mine = {"coord": self.grid.coord,
                "leaves": [torch.stack(xs).cpu().numpy()
                           for xs in zip(*self.states)]}
        parts = [mine]
        if self.grid.distributed:
            parts = [None] * self.grid.size
            dist.all_gather_object(parts, mine, group=self.grid.group)
        bs, rt, ct = self.grid.shape
        cfg, tr, tc = self.cfg, self.tile_rows, self.tile_cols
        leaves = []
        for j, name in enumerate(SimState._fields):
            if name not in NODE_LEAVES:
                full = np.concatenate([p["leaves"][j] for p in parts
                                       if p["coord"][1:] == (0, 0)])
            else:
                x0 = parts[0]["leaves"][j]
                bl = x0.shape[0]
                full = np.empty((bs * bl, cfg.rows, cfg.cols) + x0.shape[2:],
                                x0.dtype)
                for p in parts:
                    b, r, c = p["coord"]
                    x = p["leaves"][j]
                    full[b * bl:(b + 1) * bl, r * tr:(r + 1) * tr,
                         c * tc:(c + 1) * tc] = x.reshape(
                             (bl, tr, tc) + x.shape[2:])
                full = full.reshape((bs * bl, cfg.num_nodes) + x0.shape[2:])
            leaves.append(torch.from_numpy(np.array(
                full[0] if self.batch is None else full)))
        return SimState(*leaves)



def run_sharded(cfg: SimConfig, trace: np.ndarray, grid: Grid3,
                max_cycles: Optional[int] = None, chunk: int = 256,
                knobs: Optional[Sequence[np.ndarray]] = None, device=None,
                return_state: bool = False):
    """Run one sharded simulation over ``grid`` = ``(batch_shards,
    row_tiles, col_tiles)``: every rank of the default process group
    calls it with the same arguments, the grid's ranks step their tiles
    (:class:`ShardedSim`), and every rank returns the results (ranks off
    the grid receive them from rank 0).  With ``return_state`` it returns
    ``(results, state)``, the final state put back together on the host
    (:meth:`ShardedSim.gather_state`; ``None`` off the grid)."""
    pg = ProcessGrid(*grid)
    try:
        res = state = None
        if pg.member:
            sim = ShardedSim(cfg, trace, pg, knobs, device)
            res = sim.run(max_cycles, chunk)
            if return_state:
                state = sim.gather_state()
        if pg.distributed and pg.size < pg.world:
            box = [res]
            dist.broadcast_object_list(box, src=0)
            res = box[0]
        return (res, state) if return_state else res
    finally:
        pg.close()


def run_composed(spec, grid: Grid3, max_cycles: Optional[int] = None,
                 chunk: int = 256, device=None) -> List[Dict[str, int]]:
    """Composed backend: B scenarios x spatial tiles on one 3-D grid of
    ranks.

    Args:
        spec: a :class:`repro_torch.core.sweep.SweepSpec`; its
            ``dir_layout`` is forced to ``"home"``, so a
            centralized-directory scenario is rejected.
        grid: ``(batch_shards, row_tiles, col_tiles)``; its product is
            the number of ranks used, the first of the default group.
            ``(1, rt, ct)`` degenerates to the spatial backend and ``(1,
            1, 1)`` to a solo run, both bit-identically.
        max_cycles: cycle cap (default ``cfg.max_cycles``).
        chunk: cycles per termination check.
        device: each rank's device (``None``: its current CUDA device).

    The batch is padded to a multiple of ``batch_shards`` with copies of
    the last scenario, as :func:`repro_torch.core.sweep.run_sweep` pads
    (the copies finish with their original and are dropped).  Every rank
    of the default group must call it; every rank returns one stats dict
    per scenario, in scenario order, bit-identical to solo
    :func:`repro_torch.core.sim.run` calls."""
    from .sweep import SweepSpec        # deferred: sweep imports this module
    cfg = dataclasses.replace(spec.cfg, dir_layout="home")
    spec = SweepSpec(cfg, spec.scenarios)
    spec.validate()
    traces = spec.traces()
    knobs = spec.knob_arrays()
    pad = (-spec.size) % grid[0]
    if pad:
        traces = np.concatenate([traces, np.repeat(traces[-1:], pad, 0)])
        knobs = tuple(np.concatenate([a, np.repeat(a[-1:], pad, 0)])
                      for a in knobs)
    return run_sharded(cfg, traces, grid, max_cycles, chunk, knobs,
                       device)[:spec.size]
