"""Dev harness: step the PyTorch port's ``SerialSim`` (the numpy golden
model) and ``VectorSim`` (the simulator, on the GPU or with ``--device
cpu`` on the CPU) in lockstep, and report the first cycle and state leaf
at which they diverge.  The port's counterpart of
``scripts/compare_debug.py``.

    PYTHONPATH=src python scripts/compare_debug_torch.py --rows 4 --cols 4 --refs 40
    PYTHONPATH=src python scripts/compare_debug_torch.py --device cpu --distdir
"""
import argparse
import sys

import numpy as np

sys.path.insert(0, "src")

from repro_torch.core import state as S
from repro_torch.core.config import SimConfig
from repro_torch.core.ref_serial import STAT_NAMES, SerialSim
from repro_torch.core.sim import VectorSim
from repro_torch.core.workloads import resolve_trace


def serial_snapshot(ss: SerialSim) -> dict:
    n = ss.cfg.num_nodes
    inp = np.zeros((n, 4, S.NUM_F), np.int64)
    for node in range(n):
        for p, f in enumerate(ss.inp[node]):
            if f is not None:
                inp[node, p] = [1, f.age, f.src, f.dst, f.osrc, f.typ, f.tag,
                                f.pkt, f.fid, f.nfl]
    pc = np.zeros((n, ss.cfg.pc_depth, 5), np.int64)
    for node in range(n):
        for i, (t, src, osrc, tag) in enumerate(ss.pending[node]):
            pc[node, i] = [1, t, src, osrc, tag]
    return dict(st=ss.st.copy(), ctr=ss.ctr.copy(), tr_ptr=ss.tr_ptr.copy(),
                pend=ss.pend_addr.copy(), inp=inp,
                qsize=np.array([len(q) for q in ss.sendq]), pc=pc,
                rob_counts=np.array([len(r) for r in ss.rob]),
                l1_tag=ss.l1_tag.copy(), l2_tag=ss.l2_tag.copy(),
                l1_lru=ss.l1_lru.copy(), l2_lru=ss.l2_lru.copy(),
                l1_owner=ss.l1_owner.copy(),
                l2_mig=ss.l2_mig.copy(), l2_streak=ss.l2_streak.copy(),
                dir=ss.dir_loc.copy(),
                fwd_tag=ss.fwd_tag.copy(), fwd_dst=ss.fwd_dst.copy(),
                qfid=ss.q_fid.copy(),
                stats=np.array([ss.stats[k] for k in STAT_NAMES]))


def vector_snapshot(vs: VectorSim) -> dict:
    s = S.widen_state(vs.state)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    return dict(st=host(s.st), ctr=host(s.ctr), tr_ptr=host(s.tr_ptr),
                pend=host(s.pend_addr), inp=host(s.inp),
                qsize=host(s.q_size), pc=host(s.pc),
                rob_counts=np.sum(host(s.rob[:, :, S.R_NFL]) > 0, axis=1),
                l1_tag=host(s.l1_tag), l2_tag=host(s.l2_tag),
                l1_lru=host(s.l1_lru), l2_lru=host(s.l2_lru),
                l1_owner=host(s.l1_owner),
                l2_mig=host(s.l2_mig), l2_streak=host(s.l2_streak),
                dir=host(s.dir_loc)[:-1],
                fwd_tag=host(s.fwd_tag), fwd_dst=host(s.fwd_dst),
                qfid=host(s.q_fid),
                stats=S.stats_totals(s.stats_hi, s.stats))


def compare(a: dict, b: dict, cycle: int):
    """The first leaf on which the snapshots differ (printed), or None."""
    for k in a:
        av, bv = np.asarray(a[k]), np.asarray(b[k])
        if av.shape != bv.shape:
            print(f"cycle {cycle}: SHAPE mismatch {k}: {av.shape} vs "
                  f"{bv.shape}")
            return k
        if not np.array_equal(av, bv):
            idx = np.argwhere(av != bv)
            print(f"cycle {cycle}: MISMATCH {k} at {idx[:8].tolist()}")
            for i in idx[:8]:
                print(f"   serial={av[tuple(i)]} vector={bv[tuple(i)]}")
            if k == "stats":
                for i in idx[:20]:
                    print(f"   stat {STAT_NAMES[i[0]]}: serial="
                          f"{av[tuple(i)]} vector={bv[tuple(i)]}")
            return k
    return None


def main(rows=4, cols=4, refs=40, seed=1, app="matmul", cycles=4000,
         device=None, **kw):
    """Lockstep run; returns (the cycle, the leaf) of the first
    divergence, or (the last cycle, None)."""
    cfg = SimConfig(rows=rows, cols=cols, addr_bits=14,
                    migrate_threshold=2, **kw)
    tr = resolve_trace(cfg, app, refs, seed)
    ss = SerialSim(cfg, tr)
    vs = VectorSim(cfg, tr, device=device)
    bad = compare(serial_snapshot(ss), vector_snapshot(vs), -1)
    if bad:
        return -1, bad
    for cyc in range(cycles):
        ss.step()
        vs.step()
        bad = compare(serial_snapshot(ss), vector_snapshot(vs), cyc)
        if bad:
            print(f"diverged at cycle {cyc} on {bad}")
            return cyc, bad
        if ss.finished():
            print(f"finished identically at cycle {cyc}, "
                  f"stats match: {ss.stats['injected']} flits injected, "
                  f"{ss.stats['trap']} traps, "
                  f"{ss.stats['migrations']} migrations")
            return cyc, None
    print(f"no divergence in {cycles} cycles (not finished)")
    return cycles - 1, None


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--cols", type=int, default=4)
    ap.add_argument("--refs", type=int, default=40)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--app", default="matmul")
    ap.add_argument("--cycles", type=int, default=4000)
    ap.add_argument("--distdir", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:<i>' or "
                         "'cpu'")
    a = ap.parse_args()
    main(a.rows, a.cols, a.refs, a.seed, a.app, a.cycles, device=a.device,
         centralized_directory=not a.distdir)
