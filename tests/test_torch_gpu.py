"""The port on the card: the CUDA kernels and the main paths.

Every test here needs a CUDA GPU (marker ``gpu``) and skips itself
without one; the file imports neither JAX nor ``repro``, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import dataclasses

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import sim
from repro_torch.core.config import CacheConfig, SimConfig
from repro_torch.core.workloads import app_trace
from repro_torch.kernels import flash_attention, ops
from repro_torch.kernels.ref import (arbitrate_ref, attention_ref,
                                     phase2_router_ref, random_arb_case,
                                     random_phase2_case)
from repro_torch.kernels.router_phase import (ARB_LAUNCHES, LAUNCHES,
                                              phase2_router_cuda,
                                              router_arbitrate_cuda)
from repro_torch.models import api

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def case(seed, n, device):
    return [torch.from_numpy(a).to(device)
            for a in random_arb_case(np.random.default_rng(seed), n)]


def test_kernel_bit_exact_against_plain_version(cuda):
    for seed, n in enumerate(list(range(1, 401)) + [127, 128, 129, 43_264]):
        args = case(seed, n, cuda)
        before = ARB_LAUNCHES.n
        got_a, got_d = ops.arbitrate(*args)
        assert ARB_LAUNCHES.n == before + 1
        ref_a, ref_d = arbitrate_ref(*args)
        assert torch.equal(got_a, ref_a) and torch.equal(got_d, ref_d), n


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = case(0, 8, cuda)
    before = ARB_LAUNCHES.n
    with pytest.raises(TypeError):
        router_arbitrate_cuda(args[0].to(torch.int64), *args[1:])
    with pytest.raises(ValueError):
        router_arbitrate_cuda(args[0][:, :4], *args[1:])
    with pytest.raises(ValueError):
        router_arbitrate_cuda(args[0].t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError):
        router_arbitrate_cuda(args[0], args[1].cpu(), *args[2:])
    assert ARB_LAUNCHES.n == before


P2_ARGS = ("inp", "rob", "pc", "q_desc", "q_head", "q_size", "q_fid",
           "node_id", "node_r", "node_c", "valid_port", "knob_ej_age",
           "stats")


def p2_case(seed, n, K, depth, qp, rows, cols):
    a = random_phase2_case(np.random.default_rng(seed), n, K, depth, qp,
                           rows, cols)
    return {k: torch.from_numpy(a[k]) for k in P2_ARGS}


def offset_view(t, n, off):
    """``t`` again, as a contiguous view ``off`` routers into a larger
    storage when its first axis is the routers' (16-byte alignment then
    varies with the slab's width)."""
    if off and t.dim() and t.shape[0] == n:
        return torch.cat([t[:off], t])[off:]
    return t


P2_CASES = ([(n, 8, 4, 64, 4, 4, 0) for n in (1, 2, 3, 16, 31, 33)]
            + [(n, 8, 4, 64, 16, 16, 0) for n in (127, 128, 129, 255, 256,
                                                    257, 1000)]
            + [(n, 8, 1, 64, 16, 16, 0) for n in (127, 128, 129)]
            + [(129, 3, 2, 4, 5, 7, 0), (300, 8, 1, 16, 3, 5, 1),
               (300, 8, 4, 16, 3, 5, 3), (43_264, 8, 4, 64, 208, 208, 0),
               (43_264, 8, 1, 64, 208, 208, 0)])


def test_phase2_kernel_bit_exact_against_plain_version(cuda):
    """The fused kernel against the plain version run on CPU copies: tile
    edges (127/128/129), pending depth 1 and 4, an odd ROB slab, views
    that start off a 16-byte boundary, and the 208x208 mesh."""
    for seed, (n, K, depth, qp, rows, cols, off) in enumerate(P2_CASES):
        cpu = p2_case(seed, n, K, depth, qp, rows, cols)
        card = {k: offset_view(t.to(cuda), n, off) for k, t in cpu.items()}
        before = LAUNCHES.n
        got = phase2_router_cuda(*(card[k] for k in P2_ARGS), cols=cols)
        assert LAUNCHES.n == before + 1
        want = phase2_router_ref(*(cpu[k] for k in P2_ARGS), cols=cols)
        for name, g, w in zip(want._fields, got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, (n, name)
            assert torch.equal(g.cpu(), w), (n, K, depth, off, name)


def test_phase2_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = {k: t.to(cuda) for k, t in p2_case(0, 40, 8, 4, 16, 5, 8).items()}
    before = LAUNCHES.n
    for name, bad, err in (
            ("inp", args["inp"].to(torch.int64), TypeError),
            ("valid_port", args["valid_port"].to(torch.uint8), TypeError),
            ("rob", args["rob"][:, :4, :3].contiguous(), ValueError),
            ("q_head", args["q_head"][:39], ValueError),
            ("pc", args["pc"].transpose(1, 2).contiguous().transpose(1, 2),
             ValueError),
            ("stats", args["stats"].cpu(), ValueError)):
        with pytest.raises(err, match=name):
            phase2_router_cuda(*(bad if k == name else args[k]
                                 for k in P2_ARGS), cols=8)
    with pytest.raises(ValueError, match="CUDA"):
        phase2_router_cuda(*(args[k].cpu() for k in P2_ARGS), cols=8)
    assert LAUNCHES.n == before


def test_main_path_on_the_card_equals_the_cpu_run(cuda):
    cfg = SimConfig(rows=4, cols=4, addr_bits=14, migrate_threshold=2,
                    centralized_directory=False,
                    state_dtype_policy="packed")
    tr = app_trace(cfg, "mgrid", 20, 2)
    LAUNCHES.reset()
    ARB_LAUNCHES.reset()
    got = sim.run(cfg, tr, chunk=16)              # default device: cuda
    # one fused Phase-2 launch a stepped cycle, no standalone arbitration
    assert LAUNCHES.n > 0 and ARB_LAUNCHES.n == 0
    assert got == sim.run(cfg, tr, chunk=16, device="cpu")
    assert got["finished"] == 1


def test_sweep_knob_views_on_the_card_equal_solo_runs(cuda):
    """A 16x16 sweep whose scenarios differ only in the ejection age
    threshold: the fused kernel reads each scenario's knob through a 0-d
    view at offset b of a (3,) tensor.  Each scenario equals its solo run
    on the card (the wedge workload, capped at 600 cycles, where the
    three thresholds give three different runs)."""
    from repro_torch.core import sweep
    cfg = SimConfig(rows=16, cols=16, centralized_directory=False,
                    max_cycles=600)
    spec = sweep.SweepSpec(cfg, tuple(
        sweep.ScenarioSpec("loop:matmul", 0, 20, eject_age_threshold=e)
        for e in (0, 4, 8)))
    LAUNCHES.reset()
    ARB_LAUNCHES.reset()
    got = sweep.run_sweep(spec, chunk=32)             # default device: cuda
    assert LAUNCHES.n == 3 * 600 and ARB_LAUNCHES.n == 0
    assert got == sweep.run_sequential(spec, chunk=32)
    assert len({g["send_drop"] for g in got}) == 3


@pytest.mark.parametrize("b,h,kv,s,d,dtype,causal,t", [
    (1, 2, 2, 256, 64, torch.float32, True, None),
    (2, 1, 1, 128, 128, torch.bfloat16, True, None),
    (1, 4, 4, 384, 64, torch.float32, False, None),
    (2, 2, 2, 512, 32, torch.bfloat16, True, None),
    (2, 8, 2, 256, 64, torch.float32, True, None),   # GQA: 4 per KV head
    (2, 8, 2, 256, 64, torch.bfloat16, True, None),  # GQA, the main path's D
    (1, 32, 4, 1024, 128, torch.bfloat16, True, None),   # yi-6b's heads
    (1, 32, 4, 1024, 128, torch.float32, True, None),
    (2, 4, 1, 512, 32, torch.bfloat16, True, None),  # GQA at D 32
    (2, 4, 1, 512, 32, torch.float32, True, None),
    (2, 4, 2, 128, 64, torch.bfloat16, False, 384),  # S != T
    (2, 4, 2, 128, 64, torch.float32, False, 384),
    (1, 4, 1, 128, 128, torch.bfloat16, False, 384),
    (1, 4, 1, 128, 128, torch.float32, False, 384),
    # head dims with no instance, padded to the next: the reduced configs'
    (2, 4, 2, 256, 16, torch.bfloat16, True, None),
    (2, 4, 2, 256, 16, torch.float32, True, None),
    (1, 4, 2, 128, 14, torch.bfloat16, True, None),
    (1, 4, 2, 128, 14, torch.float32, True, None),
    (2, 4, 2, 256, 48, torch.float32, True, None),
    (2, 4, 2, 256, 96, torch.bfloat16, False, 384),
])
def test_flash_attention_kernel_matches_plain_version(cuda, b, h, kv, s, d,
                                                      dtype, causal, t):
    """K2 against attention_ref at test_kernels.py's shapes and
    tolerances (1e-5 float32, 5e-2 bfloat16), grouped-query and S != T
    shapes at D 32, 64 and 128 in both dtypes, and head dims run padded
    (``t`` None: T = S)."""
    t = s if t is None else t
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).to(cuda, dtype)
               for shape in ((b, h, s, d), (b, kv, t, d), (b, kv, t, d)))
    before = flash_attention.LAUNCHES.n
    got = ops.attention(q, k, v, causal=causal)
    assert flash_attention.LAUNCHES.n == before + 1
    want = attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err < (5e-2 if dtype == torch.bfloat16 else 1e-5), err


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    z = lambda *shape: torch.zeros(shape, device=cuda)   # noqa: E731
    x = z(1, 2, 128, 64)
    before = flash_attention.LAUNCHES.n
    for bad, err in (((x.double(),) * 3, TypeError),
                     ((z(1, 2, 128, 160),) * 3, ValueError),     # D
                     ((z(1, 2, 96, 64),) * 3, ValueError),       # S % 128
                     ((z(1, 3, 128, 64), x, x), ValueError),     # H % KV
                     ((x, x, z(1, 2, 256, 64)), ValueError),     # k != v
                     ((x.transpose(2, 3).contiguous().transpose(2, 3), x,
                       x), ValueError),                          # strided
                     ((x, x.cpu(), x), ValueError)):             # device
        with pytest.raises(err):
            flash_attention.flash_attention_cuda(*bad)
    with pytest.raises(ValueError, match="S == T"):
        flash_attention.flash_attention_cuda(x, z(1, 2, 256, 64),
                                             z(1, 2, 256, 64), causal=True)
    assert flash_attention.LAUNCHES.n == before


def test_lm_forward_on_the_card_equals_the_cpu_run(cuda):
    """Reduced tinyllama at float32 compute, head_dim 64, S = 128: the
    kernel route on the card (one K2 launch a layer) against the plain
    route on the CPU, within 1e-4 on logits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.reduced("tinyllama-1.1b"),
                              compute_dtype="float32", d_model=128,
                              n_heads=2, n_kv_heads=1)
    params = api.init_params(cfg, 0, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 128))
    want, _ = api.forward_logits(cfg, params, {"tokens": tokens},
                                 device="cpu")
    on_card = convert.params_from_numpy(convert.params_to_numpy(params),
                                        cuda, cfg)
    flash_attention.LAUNCHES.reset()
    got, _ = api.forward_logits(cfg, on_card, {"tokens": tokens})
    assert flash_attention.LAUNCHES.n == cfg.n_layers
    assert float((got.cpu() - want).abs().max()) < 1e-4


def test_flash_attention_refuses_inputs_that_need_a_gradient(cuda):
    x = torch.zeros(1, 2, 128, 64, device=cuda)
    before = flash_attention.LAUNCHES.n
    for args in ((x.clone().requires_grad_(), x, x),
                 (x, x, x.clone().requires_grad_())):
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention.flash_attention_cuda(*args)
        with pytest.raises(RuntimeError, match="no backward"):
            ops.attention(*args)
    assert flash_attention.LAUNCHES.n == before
    with torch.no_grad():      # nothing needs a gradient: it launches
        flash_attention.flash_attention_cuda(x.clone().requires_grad_(), x,
                                             x)
    assert flash_attention.LAUNCHES.n == before + 1


def test_train_step_on_the_card_equals_the_cpu_run(cuda):
    """Reduced tinyllama, float32 compute, S = 128 (the flash route's
    shape, which the train step leaves for the einsum route): three train
    steps on the card against the CPU's: loss and grad norm within 1e-5
    relative (float32 in another summation order); parameters as
    ``tests/test_torch_train.py`` holds them against JAX, every element
    within 6 x lr and all but 0.1% within 1e-6 (AdamW's first updates are
    about lr x sign(g), which a gradient at rounding level can flip)."""
    from repro_torch.train import optim, step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.reduced("tinyllama-1.1b"),
                              compute_dtype="float32")
    opt = optim.OptConfig(lr=1e-3, warmup=2, total_steps=10)
    params = api.init_params(cfg, 0, device="cpu")
    on_card = convert.params_from_numpy(convert.params_to_numpy(params),
                                        cuda, cfg)
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, cfg.vocab, (2, 128)).astype(np.int32)
             for k in ("tokens", "labels")}
    runs = {}
    for dev, p in (("cpu", params), (cuda, on_card)):
        fn = step.make_train_step(cfg, opt, device=dev)
        st = optim.init_opt(opt, p)
        flash_attention.LAUNCHES.reset()
        ms = []
        for _ in range(3):
            p, st, m = fn(p, st, batch)
            ms.append({k: float(v) for k, v in m.items()})
        assert flash_attention.LAUNCHES.n == 0
        runs[str(dev)] = (p, ms)
    (p_cpu, m_cpu), (p_card, m_card) = runs["cpu"], runs[str(cuda)]
    for a, b in zip(m_cpu, m_card):
        assert a["step"] == b["step"]
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(a[k]), (k, a, b)
    off = total = 0
    for (path, a), (_, b) in zip(optim.tree_items(p_cpu),
                                 optim.tree_items(p_card)):
        d = (a - b.cpu()).abs()
        assert float(d.max()) <= 6 * opt.lr, path
        off += int((d > 1e-6).sum())
        total += d.numel()
    assert off <= 1e-3 * total, (off, total)


def _sharded_case():
    cfg = SimConfig(rows=8, cols=8, addr_bits=16, centralized_directory=False,
                    dir_layout="home", migrate_threshold=2)
    tr = app_trace(cfg, "mgrid", 10, 2)
    return cfg, tr, sim.run(cfg, tr, chunk=64, device="cpu")


def test_sharded_one_nccl_rank_equals_the_cpu_run(cuda, tmp_path):
    """The whole sharded path (subgroups, termination and statistics
    all-reduces) on one NCCL rank; NCCL with more ranks needs a card
    each, which a one-card machine cannot show."""
    from repro_torch import dist as rdist
    from repro_torch.core.sharded import run_sharded
    cfg, tr, want = _sharded_case()
    (got,) = rdist.spawn(run_sharded, 1, (cfg, tr, (1, 1, 1), None, 64),
                         device="cuda:0", backend="nccl",
                         init_method=f"file://{tmp_path}/store",
                         timeout_s=600)
    assert got == want


def test_sharded_two_gloo_ranks_on_one_card_equal_the_cpu_run(cuda,
                                                              tmp_path):
    """Two tiles (1 x 2) as two gloo ranks on cuda:0: the compute on the
    card, the halo slabs through host tensors."""
    from repro_torch import dist as rdist
    from repro_torch.core.sharded import run_sharded
    cfg, tr, want = _sharded_case()
    got = rdist.spawn(run_sharded, 2, (cfg, tr, (1, 1, 2), None, 64),
                      device="cuda:0", backend="gloo",
                      init_method=f"file://{tmp_path}/store", timeout_s=600)
    assert got == [want, want]


def test_two_nccl_ranks_on_one_card_fail_clearly(cuda, tmp_path):
    from repro_torch import dist as rdist
    from repro_torch.core.sharded import run_sharded
    cfg, tr, _ = _sharded_case()
    with pytest.raises(RuntimeError,
                       match="NCCL cannot hold two ranks on one GPU"):
        rdist.spawn(run_sharded, 2, (cfg, tr, (1, 1, 2), None, 64),
                    device="cuda:0", backend="nccl",
                    init_method=f"file://{tmp_path}/store", timeout_s=300)


def gloo_send_a_cuda_tensor():
    """Rank 0 sends a CUDA tensor to rank 1 over gloo."""
    import torch.distributed as dist
    dev = torch.device("cuda", torch.cuda.current_device())
    t = torch.arange(4, device=dev, dtype=torch.int32)
    peer = 1 - dist.get_rank()
    ops = [dist.P2POp(dist.isend, t, peer),
           dist.P2POp(dist.irecv, torch.empty_like(t), peer)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()


def test_gloo_cannot_send_cuda_tensors(cuda, tmp_path):
    """Why the sharded backend stages its halo slabs through host tensors
    on gloo with a CUDA device: gloo's point-to-point send of a CUDA
    tensor aborts the rank (a host write of a device address); if a
    later torch takes them, the staging can go."""
    from repro_torch import dist as rdist
    with pytest.raises(RuntimeError, match="rank"):
        rdist.spawn(gloo_send_a_cuda_tensor, 2, device="cuda:0",
                    backend="gloo", init_method=f"file://{tmp_path}/store",
                    timeout_s=120)


@pytest.mark.parametrize("arch,kw", [
    ("qwen2-moe-a2.7b", dict(d_model=128, n_heads=2, n_kv_heads=2)),
    ("mamba2-130m", {}),
    ("hymba-1.5b", dict(n_heads=2, n_kv_heads=1, d_head=64)),
    ("llama-3.2-vision-11b", dict(d_model=128, n_heads=2, n_kv_heads=1)),
    ("whisper-small", dict(d_model=128, n_heads=2, n_kv_heads=2))])
def test_lm_families_on_the_card_equal_the_cpu_run(cuda, arch, kw):
    """Each of the other families, reduced with head_dim 64 (a K2 shape),
    float32 compute: the S = 128 forward (the kernel route where the
    layer takes it) and 12 decode steps on the card against the CPU,
    within 1e-4 on logits, with the CPU's cache dtypes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.reduced(arch),
                              compute_dtype="float32", **kw)
    params = api.init_params(cfg, 0, device="cpu")
    on_card = convert.params_from_numpy(convert.params_to_numpy(params),
                                        cuda, cfg)
    batch = api.make_inputs(cfg, "prefill", 2, 128,
                            np.random.default_rng(1), device="cpu")
    want, _ = api.forward_logits(cfg, params, batch, device="cpu")
    got, _ = api.forward_logits(cfg, on_card, batch)
    assert float((got.cpu() - want).abs().max()) < 1e-4
    c_cpu = api.init_cache(cfg, 2, 32, device="cpu")
    c_card = api.init_cache(cfg, 2, 32)
    for t in range(12):
        tok = batch["tokens"][:, t:t + 1]
        lw, c_cpu = api.decode_step(cfg, params, c_cpu, tok, device="cpu")
        lg, c_card = api.decode_step(cfg, on_card, c_card, tok)
        assert float((lg.cpu() - lw).abs().max()) < 1e-4, t
    assert _dtypes(c_card) == _dtypes(c_cpu)


def _dtypes(tree):
    """The dtypes of a cache's leaves (dicts and tuples), in order."""
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, tuple):
        return [d for v in tree for d in _dtypes(v)]
    return [tree.dtype]


def _sharded_lm_cfg():
    """Reduced tinyllama with head_dim 64, which K2 takes (the reduced
    config's 16 it does not)."""
    return dataclasses.replace(registry.reduced("tinyllama-1.1b"),
                               d_model=256, n_heads=4, n_kv_heads=2,
                               d_head=64, compute_dtype="bfloat16")


def sharded_prefill(shape):
    """The prefill step on a mesh of gloo ranks sharing cuda:0: (last
    token's logits whole, K2 launches on this rank, the largest |error|
    of K2 against ``attention_ref`` on this rank's own inputs in a second
    prefill)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import step
    cfg = _sharded_lm_cfg()
    mesh = make_mesh(shape, ("data", "model"))
    params = api.init_params(cfg, 0, mesh=mesh)
    batch = api.make_inputs(cfg, "prefill", 4, 256,
                            np.random.default_rng(0))
    prefill = step.make_prefill_step(cfg, mesh=mesh)
    flash_attention.LAUNCHES.reset()
    last = prefill(params, batch)
    launches = flash_attention.LAUNCHES.n
    own, errs = ops.attention, []

    def checked(q, k, v, causal=True):
        out = own(q, k, v, causal=causal)
        want = attention_ref(q, k, v, causal=causal)
        errs.append(float((out.float() - want.float()).abs().max()))
        return out

    ops.attention = checked
    try:
        prefill(params, batch)
    finally:
        ops.attention = own
    assert len(errs) == cfg.n_layers
    return last.full_tensor().float().cpu().numpy(), launches, max(errs)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_sharded_prefill_on_gloo_ranks_sharing_the_card_equals_one_rank(
        cuda, tmp_path, shape):
    """Four gloo ranks on cuda:0 (DTensor's collectives staged through
    host copies), K2 on each rank's local heads, against the one-device
    prefill on the card (bf16, 3e-2), and each K2 call against
    ``attention_ref`` on its own inputs (5e-2, as chip_smoke.py holds
    K2 in bf16)."""
    from repro_torch import dist as rdist
    from repro_torch.train import step
    cfg = _sharded_lm_cfg()
    params = api.init_params(cfg, 0)
    batch = api.make_inputs(cfg, "prefill", 4, 256,
                            np.random.default_rng(0))
    want = step.make_prefill_step(cfg)(params, batch).float().cpu().numpy()
    got = rdist.spawn(sharded_prefill, 4, (shape,), device="cuda:0",
                      backend="gloo", init_method=f"file://{tmp_path}/store",
                      timeout_s=600)
    for last, launches, k2_err in got:
        assert launches == cfg.n_layers
        assert k2_err < 5e-2
        np.testing.assert_allclose(last, want, atol=3e-2, rtol=0)


def unstaged_dtensor_gather():
    """An all-gather of a DTensor on a CUDA mesh over gloo, without the
    host staging of ``launch.mesh.make_mesh``."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    mesh = DeviceMesh("cuda", torch.arange(2))
    dev = torch.device("cuda", torch.cuda.current_device())
    x = DTensor.from_local(torch.ones(4, device=dev), mesh, [Shard(0)],
                           run_check=False)
    return float(x.full_tensor().sum())


def test_dtensor_gathers_crash_gloo_ranks_on_cuda(cuda, tmp_path):
    """Why a CUDA mesh over gloo stages DTensor's collectives through
    host copies (``dist.stage_through_host``): the functional all-gather
    that DTensor calls kills the rank (SIGSEGV, torch 2.11); if a later
    torch runs it, the staging can go."""
    from repro_torch import dist as rdist
    with pytest.raises(RuntimeError, match="rank"):
        rdist.spawn(unstaged_dtensor_gather, 2, device="cuda:0",
                    backend="gloo", init_method=f"file://{tmp_path}/store",
                    timeout_s=120)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-130m",
                                  "hymba-1.5b", "llama-3.2-vision-11b",
                                  "whisper-small"])
def test_family_train_step_on_the_card_equals_the_cpu_run(cuda, arch):
    """One float32 ``value_and_grad`` of each non-dense family, reduced,
    B 2 x S 32 (the train step takes the einsum route): loss within 1e-5
    relative, every gradient within 1e-4 of its leaf's largest
    |gradient| (``tests/test_torch_train.py``'s tolerances against JAX);
    hymba's unread ``layers.mamba.ln`` exactly zero on both."""
    from repro_torch.train import optim, step
    from repro_torch.train.data import DataConfig, DataSource, DataState
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.reduced(arch),
                              compute_dtype="float32")
    params = api.init_params(cfg, 0, device="cpu")
    on_card = convert.params_from_numpy(convert.params_to_numpy(params),
                                        cuda, cfg)
    batch = DataSource(DataConfig(batch=2, seq=32), cfg).batch_at(
        DataState(0))
    flash_attention.LAUNCHES.reset()
    lw, gw = step.value_and_grad(cfg, params, batch, device="cpu")
    lg, gg = step.value_and_grad(cfg, on_card, batch)
    assert flash_attention.LAUNCHES.n == 0
    assert abs(float(lg) - float(lw)) <= 1e-5 * abs(float(lw))
    for (path, a), (_, b) in zip(optim.tree_items(gw),
                                 optim.tree_items(gg)):
        assert b.is_cuda and b.dtype == a.dtype, path
        scale = float(a.abs().max())
        assert float((b.cpu() - a).abs().max()) <= 1e-4 * scale, path
    if cfg.family == "hybrid":
        ln = gg["layers"]["mamba"]["ln"]
        assert not torch.any(ln) and ln.is_cuda


def test_dry_run_fake_group_runs_with_the_cards_torch(cuda):
    """The dry run's fake process group, fake tensors and meters import
    and run with this machine's torch: a reduced train cell on (2, 2)
    and a simulator tile, nothing placed on the card."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    # the peak from here on: the dry run frees the simulator's cached
    # tables (on the card too), and must allocate nothing there
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec = dryrun.lm_cell("tinyllama-1.1b", ShapeSpec("x", 128, 4, "train"),
                         ((2, 2), ("data", "model")),
                         cfg=registry.reduced("tinyllama-1.1b"))
    assert rec["mem"]["argument"] == sum(rec["argument_parts"].values())
    assert rec["flops"] > 0 and rec["collective_bytes"]["all-gather"] > 0
    noc = dryrun.noc_cell("noc_43k")
    assert noc["collective_bytes"]["collective-permute"] > 0
    assert torch.cuda.max_memory_allocated() == before


#: the families of the mesh decode on the card, reduced, float32
MESH_DECODE_ARCHS = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "mamba2-130m",
                     "hymba-1.5b", "llama-3.2-vision-11b", "whisper-small")


def sharded_decode(shape, steps, cache_len):
    """``steps`` decode steps of every arch of MESH_DECODE_ARCHS on a mesh
    of gloo ranks sharing cuda:0, the weights split by ``param_pspecs``
    and the cache by ``cache_pspecs``: {arch: logits whole (B, steps,
    V)}."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import (distribute, placements,
                                               resolve_pspec)
    from repro_torch.train import optim, step
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(shape, ("data", "model"))
    out = {}
    for arch in MESH_DECODE_ARCHS:
        cfg = dataclasses.replace(registry.reduced(arch),
                                  compute_dtype="float32")
        params = api.init_params(cfg, 0, mesh=mesh)
        cache = optim.tree_map(
            lambda c, sp: distribute(c, mesh, placements(
                resolve_pspec(sp, mesh, c.shape), mesh)),
            api.init_cache(cfg, 4, cache_len),
            api.cache_pspecs(cfg, 4, cache_len),
            is_leaf=lambda x: isinstance(x, torch.Tensor))
        toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, steps))
        serve = step.make_serve_step(cfg, mesh=mesh)
        got = []
        for t in range(steps):
            lg, cache = serve(params, cache, toks[:, t:t + 1])
            got.append(lg.full_tensor().cpu().numpy())
        out[arch] = np.stack(got, 1)
    return out


def test_mesh_decode_on_gloo_ranks_sharing_the_card_equals_one_device(
        cuda, tmp_path):
    """Every family's decode on a (2, 2) mesh of four gloo ranks on
    cuda:0, the weights left split, against the one-device decode on the
    card (float32, 1e-4, the CPU tests' decode tolerance)."""
    from repro_torch import dist as rdist
    torch.backends.cuda.matmul.allow_tf32 = False
    steps, cache_len = 3, 16
    got = rdist.spawn(sharded_decode, 4, ((2, 2), steps, cache_len),
                      device="cuda:0", backend="gloo",
                      init_method=f"file://{tmp_path}/store",
                      timeout_s=600)
    for arch in MESH_DECODE_ARCHS:
        cfg = dataclasses.replace(registry.reduced(arch),
                                  compute_dtype="float32")
        params = api.init_params(cfg, 0)
        cache = api.init_cache(cfg, 4, cache_len)
        toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, steps))
        want = []
        for t in range(steps):
            lg, cache = api.decode_step(cfg, params, cache, toks[:, t:t + 1])
            want.append(lg.cpu().numpy())
        for rank in got:
            assert np.max(np.abs(rank[arch] - np.stack(want, 1))) < 1e-4, \
                arch


def test_prefill_on_the_card_equals_the_cpu_run(cuda):
    """``api.prefill`` (defect R4 kept) on the card against the CPU,
    reduced tinyllama, float32, B 2 x S 12 into a 16-slot cache, 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.reduced("tinyllama-1.1b"),
                              compute_dtype="float32")
    params = api.init_params(cfg, 0, device="cpu")
    on_card = convert.params_from_numpy(convert.params_to_numpy(params),
                                        cuda, cfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 12))
    want, wc = api.prefill(cfg, params, {"tokens": toks},
                           api.init_cache(cfg, 2, 16, "cpu"), device="cpu")
    got, gc = api.prefill(cfg, on_card, {"tokens": toks},
                          api.init_cache(cfg, 2, 16))
    assert float((got.cpu() - want).abs().max()) < 1e-4
    assert int(gc["idx"]) == int(wc["idx"]) == 12
    for name in ("k", "v"):
        assert float((gc[name].cpu() - wc[name]).abs().max()) < 1e-4


def paper_cfg(rows, **kw):
    """The benchmark's paper-208 configuration (``portbench/configs/``)
    at ``rows`` x ``rows`` routers."""
    return SimConfig(rows=rows, cols=rows, centralized_directory=False,
                     dir_layout="home", state_dtype_policy="packed", **kw)


#: the benchmark's sweep4 scenarios (seed, migration off, eject age 8,
#: migrate threshold 1) over two seeds
SWEEP4 = [("random", 11, 64, {}),
          ("random", 11, 64, {"migration_enabled": False}),
          ("random", 12, 64, {"eject_age_threshold": 8}),
          ("random", 12, 64, {"migrate_threshold": 1})]
#: Table 4 row 1's caches (``portbench/configs/paper-208-bigcache.json``)
TABLE4_ROW1 = CacheConfig(l1_sets=128, l1_ways=4, l1_block=32,
                          l2_sets=512, l2_ways=8, l2_block=64)
#: (config, scenarios, cycles, chunk, the first scenario's abort); the
#: centralized directory saturates at 32x32 by the second 64-cycle edge
GRAPHED = {
    "solo": (paper_cfg(32), SWEEP4[:1], 200, 8, 0),
    "table4-row1-matmul": (paper_cfg(32, cache=TABLE4_ROW1),
                           [("matmul", 11, 256, {})], 200, 8, 0),
    "sweep4": (paper_cfg(32), SWEEP4, 200, 8, 0),
    "saturation-abort": (SimConfig(rows=32, cols=32, sat_window=64,
                                   state_dtype_policy="packed"),
                         [("random", 5, 64, {})], 256, 8,
                         sim.ABORT_SATURATION),
}


@pytest.mark.parametrize("name", list(GRAPHED))
def test_graphed_drive_equals_eager_steps(cuda, name):
    """``_drive`` on the card replays each scenario's cycle as a CUDA
    graph over its own state: every statistic, abort record and state
    leaf equals eager ``VectorSim.step``'s, each scenario's leaves stay
    where they are, every scenario-cycle after a scenario's first is a
    replay, and K1 and the cache-phase kernel count one launch a
    scenario-cycle."""
    import torch_drive_eager as de
    cfg, scenarios, cycles, chunk, abort = GRAPHED[name]
    d = de.drive(cfg, scenarios, cycles, chunk, cuda)
    b = len(scenarios)
    assert sim.stats_list(d.out, d.aux) == [w for w, _, _ in d.want]
    assert d.records() == [r for _, r, _ in d.want]
    assert d.records()[0][0] == abort
    assert d.unequal_leaves() == []
    assert d.counters["graph_captures"] == b
    assert d.counters["graph_replays"] == b * (d.steps - 1)
    assert d.launches == b * d.steps and len(d.ptrs) == b * d.steps
    assert d.cache_launches == b * d.steps
    per = [d.ptrs[i::b] for i in range(b)]
    assert all(p == p[:1] * len(p) for p in per)
    assert [x.data_ptr() for x in d.state] == d.before
    assert d.shared == []


#: (config, app, refs, cycles): real mid-run states at 32x32 for the
#: cache-phase kernel, one every CACHE_PHASE_EVERY cycles: the benchmark's
#: paper-208 geometry under random traffic, Table 4 row 1 under matmul,
#: pending depth 1, migration off, migration threshold 1, a centralized
#: directory and a flat one spread over the nodes
CACHE_PHASE_CASES = {
    "paper-random": (paper_cfg(32), "random", 64, 240),
    "table4-row1-matmul": (paper_cfg(32, cache=TABLE4_ROW1), "matmul", 256,
                           240),
    "pc-depth-1": (paper_cfg(32, pc_depth=1), "random", 64, 240),
    "migration-off": (paper_cfg(32, migration_enabled=False), "random", 64,
                      240),
    "threshold-1": (paper_cfg(32, migrate_threshold=1), "random", 64, 240),
    "centralized": (SimConfig(rows=32, cols=32, state_dtype_policy="packed"),
                    "random", 64, 240),
    "flat-wide": (SimConfig(rows=32, cols=32, centralized_directory=False),
                  "random", 64, 240),
}
CACHE_PHASE_EVERY = 12


@pytest.mark.parametrize("name", list(CACHE_PHASE_CASES))
def test_cache_phase_kernel_equals_the_torch_phases(cuda, name):
    """One launch of the cache-phase kernel on a mid-run state, widened
    as the in-place cycle widens it, equals ``phase1b(phase1a(...))`` on
    the same state widened whole: every leaf (the send queue's and the
    directory's sink slots included; the L1 and L2 arrays in their
    storage dtypes) and every statistic."""
    from repro_torch.core import cache
    from repro_torch.core.state import (CACHE_LEAVES, SimState,
                                        make_node_ctx, widen_state)
    from repro_torch.core.workloads import resolve_trace
    from repro_torch.kernels import cache_phase
    cfg, app, refs, cycles = CACHE_PHASE_CASES[name]
    vs = sim.VectorSim(cfg, resolve_trace(cfg, app, refs, 3), device=cuda)
    ctx = make_node_ctx(cfg, cuda)
    fired = torch.zeros_like(vs.state.stats)
    for c in range(1, cycles + 1):
        vs.step()
        if c % CACHE_PHASE_EVERY:
            continue
        s = vs.state
        with torch.inference_mode():
            want = cache.phase1b(cache.phase1a(widen_state(s), cfg, ctx),
                                 cfg, ctx)
            w = SimState(*(x.clone() for x in widen_state(s, CACHE_LEAVES)))
            before = cache_phase.LAUNCHES.n
            assert cache_phase.phase1_cache_cuda(w, cfg) is w
        assert cache_phase.LAUNCHES.n == before + 1
        for k, got, ref in zip(SimState._fields, w, want):
            if k in CACHE_LEAVES:
                assert got.dtype == getattr(s, k).dtype, k
            assert torch.equal(got.to(torch.int32), ref), (c, k)
        fired += want.stats - s.stats
    assert int(fired.sum()) > 0


def test_graphed_run_holds_no_more_memory_than_eager_steps(cuda,
                                                           monkeypatch):
    """A graphed ``run`` peaks in device memory above the same run
    stepped eagerly (each scenario's cycle run in place, with the same
    monitors) by no more than the graphs' bookkeeping, at 32x32 and at
    64x64 alike: the graphs' shared pool holds one cycle's work, as an
    eager cycle does.  The bookkeeping is PyTorch's RNG seed and offset
    for a capture and K1's scratch words for the capture stream, a
    512-byte block each, whatever the mesh."""
    from repro_torch.core.workloads import resolve_trace

    def peak(cfg, tr):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        LAUNCHES.reset()
        out = sim.run(cfg, tr, max_cycles=40, chunk=8)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, out, LAUNCHES.n

    for rows in (32, 64):
        cfg = paper_cfg(rows)
        tr = resolve_trace(cfg, "random", 64, 3)
        graphed = peak(cfg, tr)
        with monkeypatch.context() as m:
            m.setattr(sim.CycleGraph, "step", lambda self, body: body())
            eager = peak(cfg, tr)
        assert graphed[1:] == eager[1:] and eager[2] == 40
        assert graphed[0] - eager[0] <= 3 * 512, (rows, graphed[0],
                                                  eager[0])
