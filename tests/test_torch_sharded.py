"""Port parity of the spatial backend (``repro_torch.core.sharded``).

The ``tests/test_sharded.py`` case (8x8, ``addr_bits=16``, ``home``
directory, ``migrate_threshold=2``, ``app_trace(cfg, "mgrid", 30,
seed=2)``) over 2x4 and 4x2 tiles, each tile a gloo rank on the CPU
started by :func:`repro_torch.dist.spawn`: every rank's statistics must
equal ``repro.core.sim.run`` and the port's solo ``run``.  Also the
``max_cycles`` clamp, the whole state at chunk edges against the solo
run's, the tile helpers, and the rank launcher's failure path.
"""
import numpy as np
import pytest
import torch

from repro.core import sim as jsim
from repro.core.config import SimConfig as JConfig
from repro.core.trace import app_trace

from repro_torch import dist as rdist
from repro_torch.core import sim as tsim
from repro_torch.core.config import SimConfig as TConfig
from repro_torch.core.sharded import ProcessGrid, run_sharded
from repro_torch.core.state import (NODE_LEAVES, SimState, init_state,
                                    make_geometry, make_tile_ctx,
                                    tile_state, to_grid)

torch.set_num_threads(1)

KW = dict(rows=8, cols=8, addr_bits=16, centralized_directory=False,
          dir_layout="home", migrate_threshold=2)
#: seconds each group of ranks may take
TIMEOUT = 600


def ranks(tmp_path, fn, n, *args):
    """``fn(*args)`` on ``n`` gloo ranks on the CPU; results by rank."""
    return rdist.spawn(fn, n, args, device="cpu",
                       init_method=f"file://{tmp_path}/store",
                       timeout_s=TIMEOUT)


def diff(want, got):
    return {k: (want.get(k), got.get(k)) for k in set(want) | set(got)
            if want.get(k) != got.get(k)}


@pytest.fixture(scope="module")
def case():
    """The test_sharded.py case: (port config, trace, JAX stats)."""
    jc = JConfig(**KW)
    tr = app_trace(jc, "mgrid", 30, seed=2)
    return TConfig(**KW), tr, jsim.run(jc, tr)


def test_solo_run_equals_the_reference(case):
    cfg, tr, want = case
    got = tsim.run(cfg, tr, chunk=64, device="cpu")
    assert got == want, diff(want, got)
    assert got["finished"] == 1


@pytest.mark.parametrize("tiles", [(2, 4), (4, 2)])
def test_spatial_backend_equals_the_dense_run(case, tmp_path, tiles):
    cfg, tr, want = case
    got = ranks(tmp_path, run_sharded, tiles[0] * tiles[1], cfg, tr,
                (1,) + tiles, None, 64, None, "cpu")
    for r, g in enumerate(got):
        assert g == want, (r, diff(want, g))


def test_sharded_clamps_max_cycles_to_dense_backend(tmp_path):
    """An unfinished capped run stops at exactly max_cycles though 64
    does not divide 100: the tail chunk is clamped."""
    kw = dict(rows=4, cols=4, addr_bits=14, centralized_directory=False,
              dir_layout="home")
    cfg = TConfig(**kw)
    tr = app_trace(JConfig(**kw), "mgrid", 25, seed=1)
    want = tsim.run(cfg, tr, max_cycles=100, device="cpu")
    got = ranks(tmp_path, run_sharded, 4, cfg, tr, (1, 2, 2), 100, 64,
                None, "cpu")
    for g in got:
        assert g["cycles"] == 100 and g["finished"] == 0
        assert g == want, diff(want, g)


def test_state_at_chunk_edges_equals_the_solo_state(case, tmp_path):
    """After two 64-cycle chunks (cycle 128, mid-run), the tiles put back
    together equal the solo run's state leaf for leaf: the statistics
    folded once a chunk after the cross-tile sum equal the per-cycle
    fold."""
    cfg, tr, _ = case
    got = ranks(tmp_path, run_sharded, 4, cfg, tr, (1, 2, 2), 128, 64,
                None, "cpu", True)
    vs = tsim.VectorSim(cfg, tr, device="cpu")
    for _ in range(128):
        vs.step()
    for stats, state in got:
        assert stats["cycles"] == 128 and stats["finished"] == 0
        for name, g, w in zip(SimState._fields, state, vs.state):
            assert g.dtype == w.dtype and torch.equal(g, w), name


def test_tile_ctx_has_local_rows_and_global_ids():
    """``node`` indexes the tile's own arrays (0..Nl-1); ``node_id``,
    ``node_r``, ``node_c`` and ``valid_port`` are the global mesh's."""
    cfg = TConfig(rows=8, cols=8)
    ctx = make_tile_ctx(cfg, slice(4, 8), slice(2, 4), "cpu")
    rr, cc = np.meshgrid(np.arange(4, 8), np.arange(2, 4), indexing="ij")
    gid = (rr * 8 + cc).reshape(-1)
    assert torch.equal(ctx.node, torch.arange(8))
    assert ctx.node_id.tolist() == gid.tolist()
    assert ctx.node_id.dtype == torch.int32
    geo = make_geometry(8, 8)
    assert ctx.node_r.tolist() == geo.node_r[gid].tolist()
    assert ctx.node_c.tolist() == geo.node_c[gid].tolist()
    assert torch.equal(ctx.valid_port, torch.as_tensor(geo.valid_port[gid]))
    # the bottom row of the tile is the mesh's: no south links
    assert not ctx.valid_port.reshape(4, 2, 4)[-1, :, 2].any()


def test_tile_state_cuts_tiles_and_scenario_shards():
    cfg = TConfig(rows=4, cols=6, centralized_directory=False,
                  dir_layout="home", state_dtype_policy="packed")
    tr = np.arange(3 * 24 * 5, dtype=np.int32).reshape(3, 24, 5) % 50
    s = init_state(cfg, tr, "cpu")
    s = s._replace(stats=torch.arange(3 * s.stats.shape[1],
                                      dtype=torch.int32).reshape(3, -1))
    t = tile_state(s, cfg, slice(2, 4), slice(3, 6), scenarios=slice(1, 3))
    g = to_grid(s, cfg)
    for name, full, part in zip(SimState._fields, g, t):
        if name in NODE_LEAVES:
            want = full[1:3, 2:4, 3:6].reshape((2, 6) + full.shape[3:])
        else:
            want = full[1:3]
        assert part.dtype == full.dtype and torch.equal(part, want), name
        assert part.is_contiguous()
    with pytest.raises(ValueError, match="batched"):
        tile_state(tsim._index(s, 0), cfg, slice(0, 2), slice(0, 3),
                   scenarios=slice(0, 1))


def test_process_grid_without_a_group():
    """Without a process group only (1, 1, 1) exists, with no
    collective; a larger grid names the ranks it needs."""
    g = ProcessGrid(1, 1, 1)
    assert g.member and not g.distributed and g.coord == (0, 0, 0)
    with pytest.raises(ValueError, match="needs 4 rank"):
        ProcessGrid(1, 2, 2)
    with pytest.raises(ValueError, match=">= 1"):
        ProcessGrid(0, 1, 1)


def test_nccl_refuses_two_ranks_on_one_card():
    rdist.check_devices(["h:GPU a", "h:GPU b", "g:GPU a"])
    with pytest.raises(RuntimeError, match="ranks 0 and 2 are both on"):
        rdist.check_devices(["h:GPU a", "h:GPU b", "h:GPU a"])


def test_a_failing_rank_fails_the_run(tmp_path):
    """Every rank raises (a grid of 4 over a group of 2): the launcher
    reports a rank's traceback and leaves no rank running."""
    cfg = TConfig(**KW)
    with pytest.raises(RuntimeError, match="needs 4 rank"):
        ranks(tmp_path, run_sharded, 2, cfg,
              np.zeros((64, 2), np.int32), (1, 2, 2))
