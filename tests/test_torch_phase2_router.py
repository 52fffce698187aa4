"""Port parity: the fused Phase-2 router kernel and its plain version.

* The plain version (``repro_torch.kernels.ref.phase2_router_ref``) is held
  leaf for leaf against the JAX package's ``repro.core.noc.phase2`` (XLA
  arbitration, ``use_pallas_router=False``) on seeded cases.
* A scalar transcription of the CUDA kernel (``csrc/router_arbitrate.cu``,
  ``phase2_router_kernel``) — its tiles, the staging of the tile's slabs
  into shared memory at odd strides, the per-router order (ejection,
  injection, the five greedy rounds, routing, pop) and the last-CTA
  statistics — is held against the plain version, since the kernel itself
  runs only on the card (``tests/test_torch_gpu.py``).
* The dispatch, the wrapper's input checks and the copied field indices.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import noc as jnoc
from repro.core import state as jstate
from repro.core.config import SimConfig as JConfig

from repro_torch.core import state as tstate
from repro_torch.core import noc as tnoc
from repro_torch.core.config import SimConfig as TConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.router_phase import (LAUNCHES, check_phase2_inputs,
                                              phase2_router_cuda)

torch.set_num_threads(1)

ARGS = ("inp", "rob", "pc", "q_desc", "q_head", "q_size", "q_fid", "node_id",
        "node_r", "node_c", "valid_port", "knob_ej_age", "stats")


def case(seed, n, K, depth, qp, rows, cols):
    arrs = ref.random_phase2_case(np.random.default_rng(seed), n, K, depth,
                                  qp, rows, cols)
    return {k: torch.from_numpy(arrs[k]) for k in ARGS}


def plain(args, cols):
    return ref.phase2_router_ref(*(args[k] for k in ARGS), cols=cols)


# ---------------------------------------------------------------------------
# (a) plain version against the JAX package's phase2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,cols", [(4, 4), (3, 5)])
@pytest.mark.parametrize("depth", [1, 4])
def test_plain_version_matches_jax_phase2(rows, cols, depth):
    K, qp = 8, 16
    jc = JConfig(rows=rows, cols=cols, pc_depth=depth, rob_slots=K,
                 send_queue=qp, use_pallas_router=False)
    n = rows * cols
    base = jstate.init_state(jc, np.zeros((n, 4), np.int32))
    jctx = jstate.make_node_ctx(jc)
    phase2 = jax.jit(jnoc.phase2, static_argnums=1)
    for seed in range(6):
        args = case(100 * depth + seed, n, K, depth, qp, rows, cols)
        js = base._replace(**{k: jnp.asarray(args[k].numpy())
                              for k in ("inp", "rob", "pc", "q_desc",
                                        "q_head", "q_size", "q_fid",
                                        "knob_ej_age", "stats")})
        js, jarb = phase2(js, jc, jctx)
        got = plain(args, cols)
        want = dict(out=jarb.out, ej_port=jarb.ej_port, has_ej=jarb.has_ej,
                    n_deflected=jarb.n_deflected, n_injected=jarb.n_injected,
                    q_head=js.q_head, q_size=js.q_size, q_fid=js.q_fid,
                    stats=js.stats)
        for k, w in want.items():
            g = getattr(got, k).numpy()
            w = np.asarray(w)
            assert g.shape == w.shape and np.array_equal(g, w), (seed, k)
        # the cases reach every branch the kernel has
        assert bool(got.has_ej.any()) and not bool(got.has_ej.all())
        assert int(got.n_injected) > 0 and int(got.n_deflected) > 0


def test_random_phase2_case_covers_the_corners():
    n, K, depth, qp = 512, 8, 4, 16
    a = ref.random_phase2_case(np.random.default_rng(0), n, K, depth, qp,
                               3, 5)
    rob_used = a["rob"][..., ref.R_NFL] > 0
    pc_used = a["pc"][..., ref.P_VALID] > 0
    flit = a["inp"][..., ref.F_VALID] > 0
    assert rob_used.all(1).any() and pc_used.all(1).any()      # full
    assert (a["q_size"] == 0).any() and (a["q_size"] == qp).any()
    assert (flit & (a["inp"][..., ref.F_DST] == a["node_id"][:, None])).any()
    assert not (flit & ~a["valid_port"]).any()     # flits on real ports only
    assert (~a["valid_port"]).any(1).any()         # edge routers
    multi = flit & (a["inp"][..., ref.F_NFL] > 1)
    m = ((a["rob"][:, None, :, ref.R_SRC] == a["inp"][..., ref.F_SRC, None])
         & (a["rob"][:, None, :, ref.R_PKT] == a["inp"][..., ref.F_PKT, None])
         & rob_used[:, None, :]).any(-1)
    assert (multi & m).any()                       # a multi-flit match
    assert (a["q_desc"][..., ref.Q_DST] == -1).any()
    head = a["q_desc"][np.arange(n), a["q_head"]]
    assert (head[a["q_size"] > 0, ref.Q_DST] >= 0).all()
    assert (a["q_fid"] < head[:, ref.Q_NFL]).all()


# ---------------------------------------------------------------------------
# (b) the kernel's algorithm, transcribed per router
# ---------------------------------------------------------------------------

TILE = 128


def odd(w):
    return w | 1


def stage_in(g, off, nw, sw, align):
    """``stage_in`` of the kernel: words g[off:off+nw] into a shared-memory
    list at stride odd(sw); ``align`` is the word offset of g[0] from a
    16-byte boundary (a view's storage offset)."""
    sp = odd(sw)
    s = [None] * (TILE * sp)
    lead = min(nw, ((16 - ((align + off) * 4) % 16) % 16) // 4)
    for w in range(lead):
        s[w // sw * sp + w % sw] = int(g[off + w])
    nvec = (nw - lead) // 4
    for j in range(nvec):
        w = lead + 4 * j
        r, f = divmod(w, sw)
        for e in range(4):
            s[r * sp + f] = int(g[off + w + e])
            f += 1
            if f == sw:
                f, r = 0, r + 1
    for w in range(lead + 4 * nvec, nw):
        s[w // sw * sp + w % sw] = int(g[off + w])
    return s


def stage_out(s, nw, sw, g, off):
    sp = odd(sw)
    for w in range(nw):          # the 16-byte split moves the same words
        g[off + w] = s[w // sw * sp + w % sw]


def argmin4(e):
    m = min(e)
    return e.index(m)


def arbitrate_router(age, valid, we, dc, dr, vpp):
    key, sc, fp = [], [], []
    for s in range(5):
        key.append(age[s] * 8 + (7 - s) if valid[s] else -1)
        c, r = dc[s], dr[s]
        sc.append([(1 if r < 0 else 10) if vpp[0] else 1000,
                   (0 if c > 0 else 11) if vpp[1] else 1000,
                   (1 if r > 0 else 12) if vpp[2] else 1000,
                   (0 if c < 0 else 13) if vpp[3] else 1000])
        fp.append(argmin4(sc[s]))
    done = [not v for v in valid]
    asg, dfl = [-1] * 5, [False] * 5
    taken = [False] * 4
    for _ in range(5):
        best, bkey = 0, -1
        for s in range(5):
            kk = -1 if done[s] else key[s]
            if kk > bkey:
                bkey, best = kk, s
        if bkey < 0:
            continue
        port = argmin4([sc[best][p] + (10000 if taken[p] else 0)
                        for p in range(4)])
        asg[best] = port
        dfl[best] = we[best] or port != fp[best]
        done[best] = True
        taken[port] = True
    return asg, dfl


def fmod_floor(a, b):
    r = abs(a) % b * (1 if a >= 0 else -1)      # C's truncated %
    return r + b if r < 0 else r


def kernel_transcription(args, cols, align=0):
    """``phase2_router_kernel`` for every CTA, in Python integers."""
    a = {k: v.numpy() for k, v in args.items()}
    n = a["inp"].shape[0]
    K, D = a["rob"].shape[1], a["pc"].shape[1]
    qp = a["q_desc"].shape[1] - 1
    rw, pw, iw = K * 7, D * 5, 40
    g_inp, g_rob, g_pc = (a[k].reshape(-1) for k in ("inp", "rob", "pc"))
    g_out = [None] * (n * iw)
    ej_port, has_ej = np.zeros(n, np.int64), np.zeros(n, bool)
    qh_out, qs_out, qf_out = (np.zeros(n, np.int32) for _ in range(3))
    scratch = [0, 0, 0]
    blocks = -(-n // TILE)
    for b in range(blocks):
        i0 = b * TILE
        nr = min(TILE, n - i0)
        s_inp = stage_in(g_inp, i0 * iw, nr * iw, iw, align)
        s_rob = stage_in(g_rob, i0 * rw, nr * rw, rw, align)
        s_pc = stage_in(g_pc, i0 * pw, nr * pw, pw, align)
        blk_inj = blk_defl = 0
        for t in range(nr):
            i = i0 + t
            fl = t * odd(iw)
            rb = t * odd(rw)
            pq = t * odd(pw)
            nid = int(a["node_id"][i])
            f = [[s_inp[fl + p * 10 + k] for k in range(10)]
                 for p in range(4)]
            vpp = [bool(x) for x in a["valid_port"][i]]
            n_vp = sum(vpp)
            # ejection
            has_free = rob_free = False
            match = [False] * 4
            for k in range(K):
                rnfl = s_rob[rb + k * 7 + ref.R_NFL]
                rsrc = s_rob[rb + k * 7 + ref.R_SRC]
                rpkt = s_rob[rb + k * 7 + ref.R_PKT]
                has_free |= not rnfl > 0
                rob_free |= rnfl == 0
                for p in range(4):
                    match[p] |= (rnfl > 0 and rsrc == f[p][ref.F_SRC]
                                 and rpkt == f[p][ref.F_PKT])
            pc_cnt = sum(s_pc[pq + d * 5 + ref.P_VALID] > 0 for d in range(D))
            pc_empty, pc_has_slot = pc_cnt == 0, pc_cnt < D
            ej_age = int(a["knob_ej_age"]) if D > 1 else 0
            ej, ej_key = 0, -1
            valid_in = []
            for p in range(4):
                valid_in.append(f[p][ref.F_VALID] > 0)
                acc = f[p][ref.F_NFL] == 1 or match[p] or has_free
                if D > 1:
                    ej_ok = pc_empty or (f[p][ref.F_AGE] >= ej_age and (
                        pc_has_slot or f[p][ref.F_NFL] > 1 or rob_free))
                else:
                    ej_ok = pc_empty
                want = (valid_in[p] and f[p][ref.F_DST] == nid and acc
                        and ej_ok)
                key = f[p][ref.F_AGE] * 4 + (3 - p) if want else -1
                if key > ej_key or p == 0:
                    ej_key, ej = key, p
            hej = ej_key >= 0
            # injection
            valid = [valid_in[p] and not (hej and p == ej) for p in range(4)]
            n_rem = sum(valid)
            qh, qs, qf = (int(a[k][i]) for k in ("q_head", "q_size", "q_fid"))
            head = a["q_desc"][i, fmod_floor(qh, qp)]
            can_inj = qs > 0 and n_rem < n_vp
            valid.append(can_inj)
            inj = [int(can_inj), 0, nid, int(head[ref.Q_DST]),
                   int(head[ref.Q_OSRC]), int(head[ref.Q_TYP]),
                   int(head[ref.Q_TAG]), int(head[ref.Q_PKT]), qf,
                   int(head[ref.Q_NFL])]
            # arbitration
            nr_, nc_ = int(a["node_r"][i]), int(a["node_c"][i])
            age, dc, dr, we = [], [], [], []
            for s in range(5):
                dst = (f[s][ref.F_DST] if valid[s] else 0) if s < 4 \
                    else inj[ref.F_DST]
                age.append((f[s][ref.F_AGE] if valid[s] else 0)
                           if s < 4 else 0)
                dr.append((dst // cols if dst >= 0 else 0) - nr_)
                dc.append((dst % cols if dst >= 0 else 0) - nc_)
                we.append(valid[s] and dst == nid)
            asg, dfl = arbitrate_router(age, valid, we, dc, dr, vpp)
            # routing, over the router's own flit slab
            for p in range(4):
                src = -1
                for s in range(4, -1, -1):
                    if valid[s] and asg[s] == p:
                        src = s
                for k in range(10):
                    x = 0 if src < 0 else (f[src][k] if src < 4 else inj[k])
                    if k == ref.F_AGE and src >= 0 and dfl[src]:
                        x += 1
                    if k == ref.F_VALID:
                        x = int(src >= 0)
                    s_inp[fl + p * 10 + k] = x
            # pop
            qf1 = qf + int(can_inj)
            done = can_inj and qf1 >= int(head[ref.Q_NFL])
            qh_out[i] = fmod_floor(qh + 1, qp) if done else qh
            qs_out[i] = qs - 1 if done else qs
            qf_out[i] = 0 if done else qf1
            ej_port[i], has_ej[i] = ej, hej
            blk_inj += int(can_inj)
            blk_defl += sum(dfl[s] and valid[s] for s in range(5))
        stage_out(s_inp, nr * iw, iw, g_out, i0 * iw)
        scratch[0] += blk_inj
        scratch[1] += blk_defl
        scratch[2] += 1
    assert scratch[2] == blocks              # the last CTA writes the stats
    stats = a["stats"].astype(np.int64)
    stats[ref.STAT_INJECTED] += scratch[0]
    stats[ref.STAT_DEFLECTIONS] += scratch[1]
    stats = ((stats + 2**31) % 2**32 - 2**31).astype(np.int32)
    return dict(out=np.array(g_out, np.int32).reshape(n, 4, 10),
                ej_port=ej_port, has_ej=has_ej, q_head=qh_out,
                q_size=qs_out, q_fid=qf_out, stats=stats,
                n_deflected=np.int32(scratch[1]),
                n_injected=np.int32(scratch[0]))


@pytest.mark.parametrize("n,K,depth,qp,rows,cols,align", [
    (16, 8, 4, 16, 4, 4, 0),
    (15, 8, 1, 16, 3, 5, 1),
    (1, 8, 4, 64, 4, 4, 0),
    (127, 8, 4, 64, 16, 16, 0),
    (129, 8, 1, 64, 16, 16, 3),     # pending depth 1: 20 B a router
    (300, 3, 2, 4, 5, 7, 2),        # odd ROB slab, a short send queue
])
def test_kernel_transcription_matches_plain_version(n, K, depth, qp, rows,
                                                    cols, align):
    args = case(7 * n + depth, n, K, depth, qp, rows, cols)
    got = kernel_transcription(args, cols, align)
    want = plain(args, cols)
    for k, g in got.items():
        w = getattr(want, k).numpy()
        assert np.array_equal(np.asarray(g), w), k


def test_stage_in_fills_every_word_once_at_every_alignment():
    for sw in (40, 56, 21, 20, 5):
        for nr in (1, 3, 127, 128):
            g = np.arange(TILE * sw + 8)
            for align in range(4):
                s = stage_in(g, 0, nr * sw, sw, align)
                sp = odd(sw)
                got = [s[r * sp + f] for r in range(nr) for f in range(sw)]
                assert got == list(range(nr * sw)), (sw, nr, align)


# ---------------------------------------------------------------------------
# dispatch, input checks, copied constants
# ---------------------------------------------------------------------------

def test_field_indices_and_stat_slots_match_the_state():
    for k in ("F_VALID", "F_AGE", "F_SRC", "F_DST", "F_OSRC", "F_TYP",
              "F_TAG", "F_PKT", "F_FID", "F_NFL", "NUM_F", "Q_TYP", "Q_DST",
              "Q_OSRC", "Q_TAG", "Q_PKT", "Q_NFL", "NUM_Q", "R_SRC", "R_PKT",
              "R_TYP", "R_TAG", "R_OSRC", "R_NFL", "R_CNT", "NUM_R",
              "P_VALID", "P_TYP", "P_SRC", "P_OSRC", "P_TAG", "NUM_P",
              "NUM_STATS"):
        assert getattr(ref, k) == getattr(tstate, k), k
    assert ref.STAT_INJECTED == tstate.STAT_INDEX["injected"]
    assert ref.STAT_DEFLECTIONS == tstate.STAT_INDEX["deflections"]


def test_ops_dispatches_cpu_tensors_to_the_plain_version():
    args = case(3, 40, 8, 4, 16, 5, 8)
    before = LAUNCHES.n
    got = ops.phase2_router(*(args[k] for k in ARGS), cols=8)
    want = plain(args, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert LAUNCHES.n == before


def test_cuda_wrapper_refuses_cpu_tensors():
    args = case(4, 8, 8, 4, 16, 2, 4)
    before = LAUNCHES.n
    with pytest.raises(ValueError, match="CUDA"):
        phase2_router_cuda(*(args[k] for k in ARGS), cols=4)
    assert LAUNCHES.n == before


def test_input_checks_reject_what_the_kernel_does_not_take():
    args = case(5, 8, 8, 4, 16, 2, 4)
    check_phase2_inputs(*(args[k] for k in ARGS), cols=4)
    bad = [("inp", args["inp"].to(torch.int64), TypeError),
           ("valid_port", args["valid_port"].to(torch.int32), TypeError),
           ("rob", args["rob"][:4], ValueError),
           ("stats", args["stats"][:24], ValueError),
           ("knob_ej_age", args["knob_ej_age"].reshape(1), ValueError),
           ("q_desc", args["q_desc"].transpose(1, 2).contiguous()
            .transpose(1, 2), ValueError)]
    for name, t, err in bad:
        with pytest.raises(err, match=name):
            check_phase2_inputs(*(t if k == name else args[k]
                                  for k in ARGS), cols=4)
    with pytest.raises(ValueError, match="cols"):
        check_phase2_inputs(*(args[k] for k in ARGS), cols=0)
    with pytest.raises(ValueError, match="routers 0"):
        check_phase2_inputs(*(args[k][:0] if args[k].dim() and k != "stats"
                              else args[k] for k in ARGS), cols=4)


@pytest.mark.parametrize("policy", ["wide", "packed"])
def test_phase2_hands_the_kernel_what_it_takes(policy, monkeypatch):
    """Mid-run, ``noc.phase2`` passes the dispatch inputs the kernel's
    wrapper accepts (int32, contiguous, the expected shapes) under both
    storage layouts."""
    from repro_torch.core import sim as tsim
    from repro_torch.core.workloads import random_trace
    cfg = TConfig(rows=3, cols=4, centralized_directory=False,
                  state_dtype_policy=policy, addr_bits=14)
    vs = tsim.VectorSim(cfg, random_trace(cfg, 10, 1), device="cpu")
    seen = []
    real = ops.phase2_router

    def spy(*args, cols):
        check_phase2_inputs(*args, cols=cols)
        seen.append(cols)
        return real(*args, cols=cols)

    monkeypatch.setattr(tnoc.kops, "phase2_router", spy)
    for _ in range(20):
        vs.step()
    assert seen == [cfg.cols] * 20
