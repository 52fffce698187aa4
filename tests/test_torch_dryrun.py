"""Port parity: the dry run (``repro_torch.launch.dryrun``) and its shape
cells (``repro_torch.configs.shapes``) against the JAX package, on the
CPU.

* ``shapes.SHAPES`` and ``applicable()`` equal ``repro``'s for every
  (family, shape).
* ``mem.argument`` of the port's dry run of reduced archs equals the
  per-device ``argument_size_in_bytes`` of ``repro.launch.dryrun.
  _lower_lm(...).compile().memory_analysis()`` on a mesh of the same
  shape: (1, 1) in this process, (2, 2) in a subprocess with 8 XLA host
  devices (``tests/test_sharded.py``'s way).  ``jax.jit`` drops the
  arguments its program never reads (``keep_unused=False``): hymba's
  prefill never reads ``layers.mamba.ln``, so there the port's argument
  is larger by exactly that leaf's local bytes.  ``repro``'s meshes are
  made with ``Auto`` axes: jax 0.9's ``make_mesh`` defaults to
  ``Explicit`` ones, on which ``repro``'s ``with_sharding_constraint``
  raises.
* ``analytic_flops_global`` equals ``repro``'s ``costs.cell_flops``.
* The FLOPs counted for a one-layer dense prefill equal the count worked
  out by hand; the collective sizer, fed hand-built collective calls,
  returns the byte counts ``tests/test_sharding_resolve.py::
  test_collective_parser`` expects of ``repro``'s HLO parser for the
  same shapes.
* The launcher writes ``repro``'s file names and records: a skipped
  cell with ``repro``'s ``why``, a simulator cell, a failure.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from repro.configs import shapes as jshapes
from repro.configs import registry as jregistry
from repro.models import costs as jcosts

from repro_torch.configs import registry, shapes
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
B, S = 4, 128
#: (arch, kind) cells held against repro on (2, 2): every family; the
#: hybrid prefill is the cell where jit drops an unread leaf
CELLS_22 = [("tinyllama-1.1b", "train"), ("qwen2-moe-a2.7b", "train"),
            ("mamba2-130m", "decode"), ("llama-3.2-vision-11b", "prefill"),
            ("whisper-small", "train"), ("hymba-1.5b", "prefill")]
CELLS_11 = [("tinyllama-1.1b", "train"), ("tinyllama-1.1b", "prefill")]

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys, json
    sys.path.insert(0, "src")
    import jax
    from repro.configs import registry
    from repro.configs.shapes import ShapeSpec
    from repro.launch.dryrun import _lower_lm
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch, kind in %r:
        c = _lower_lm(registry.reduced(arch), ShapeSpec("x", %d, %d, kind),
                      mesh).compile()
        out[arch + "/" + kind] = c.memory_analysis().argument_size_in_bytes
    print("RESULT " + json.dumps(out))
""")


def port_cell(arch, kind, dims, axes=("data", "model")):
    return dryrun.lm_cell(arch, ShapeSpec("x", S, B, kind), (dims, axes),
                          cfg=registry.reduced(arch))


def test_shapes_and_rules_equal_repro():
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, spec in shapes.SHAPES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            jshapes.SHAPES[name])
    assert shapes.SUBQUADRATIC == jshapes.SUBQUADRATIC
    families = {registry.get(a).family for a in registry.ARCH_IDS}
    assert families == {jregistry.get(a).family for a in jregistry.ARCH_IDS}
    for fam in sorted(families) + ["unknown"]:
        for shp in list(shapes.SHAPES) + ["other"]:
            assert shapes.applicable(fam, shp) == \
                jshapes.applicable(fam, shp), (fam, shp)


@pytest.fixture(scope="module")
def jax_22():
    code = JAX_SCRIPT % (CELLS_22, S, B)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(out.stderr[-3000:])


@pytest.mark.parametrize("arch,kind", CELLS_22)
def test_argument_bytes_equal_repro_on_2x2(jax_22, arch, kind):
    rec = port_cell(arch, kind, (2, 2))
    want = jax_22[f"{arch}/{kind}"]
    got = rec["mem"]["argument"]
    assert got == sum(rec["argument_parts"].values())
    unread = 0
    if arch == "hymba-1.5b":
        cfg = registry.reduced(arch)
        unread = cfg.n_layers * cfg.d_model * 4    # replicated float32
    assert got - unread == want, (got, want, rec["argument_parts"])
    assert rec["devices"] == 4 and rec["kind"] == kind
    assert set(rec["mem"]) == {"argument", "temp", "output"}
    assert rec["mem"]["temp"] > 0 and rec["mem"]["output"] > 0
    assert rec["flops"] > 0 and rec["corrected"]["flops"] == rec["flops"]
    assert set(rec["collective_bytes"]) <= set(dryrun.KINDS)
    cfg_j = jregistry.reduced(arch)
    assert rec["analytic_flops_global"] == jcosts.cell_flops(cfg_j, kind, B,
                                                             S)
    assert rec["attn_hbm_topup_global"] == jcosts.attn_hbm_bytes(
        cfg_j, kind, B, S)


def test_argument_bytes_equal_repro_on_one_device():
    jax.devices()         # JAX's backend first: the import below sets
    before = os.environ.get("XLA_FLAGS")   # XLA_FLAGS for 512 devices
    try:
        from repro.launch.dryrun import _lower_lm
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    from repro.configs.shapes import ShapeSpec as JShape
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for arch, kind in CELLS_11:
        want = _lower_lm(jregistry.reduced(arch), JShape("x", S, B, kind),
                         mesh).compile().memory_analysis()
        rec = port_cell(arch, kind, (1, 1))
        assert rec["mem"]["argument"] == want.argument_size_in_bytes, kind


def test_flops_of_one_dense_layer_by_hand():
    cfg = dataclasses.replace(registry.reduced("tinyllama-1.1b"),
                              n_layers=1)
    rec = dryrun.lm_cell("tinyllama-1.1b", ShapeSpec("x", S, B, "prefill"),
                         ((1, 1), ("data", "model")), cfg=cfg)
    d, h, kv, hd, f, v = (cfg.d_model, cfg.n_heads, cfg.kv_heads,
                          cfg.head_dim, cfg.d_ff, cfg.vocab)
    t = B * S
    proj = 2 * t * d * (h * hd + 2 * kv * hd) + 2 * t * h * hd * d
    # K2's plain version: every (query, key) pair, masked or not, in
    # both products
    attn = 2 * (2 * B * h * S * S * hd)
    mlp = 3 * 2 * t * d * f
    unembed = 2 * t * d * v
    assert rec["flops"] == proj + attn + mlp + unembed
    # rank 0 of (2, 2): batch split in two, heads and MLP columns in two,
    # the vocabulary in two: a quarter of it
    rec4 = dryrun.lm_cell("tinyllama-1.1b", ShapeSpec("x", S, B, "prefill"),
                          ((2, 2), ("data", "model")), cfg=cfg)
    assert rec4["flops"] == rec["flops"] / 4


def test_collective_sizer_counts_result_buffers():
    """The shapes of ``test_collective_parser``: all-reduce f32[128,256]
    and f32[16]; two all-gathers with bf16[64] results; a
    collective-permute (a point-to-point receive) of s32[16,4]; a
    reduce-scatter with an f32[8] result; an all-to-all of f32[4,4]."""
    f = torch.ops._c10d_functional
    with dryrun.fake_world(8), dryrun.fake_tensors():
        g = dist.group.WORLD.group_name
        with dryrun.Meter() as m:
            for shape in ((128, 256), (16,)):
                f.wait_tensor(f.all_reduce(torch.zeros(shape), "sum", g))
            for _ in range(2):
                f.wait_tensor(f.all_gather_into_tensor(
                    torch.zeros(8, dtype=torch.bfloat16), 8, g))
            dist.recv(torch.zeros((16, 4), dtype=torch.int32), src=1)
            f.wait_tensor(f.reduce_scatter_tensor(torch.zeros(64), "sum",
                                                  8, g))
            # over four of the eight ranks, one row to each
            g4 = dist.new_group([0, 1, 2, 3]).group_name
            f.wait_tensor(f.all_to_all_single(torch.zeros((4, 4)), [1] * 4,
                                              [1] * 4, g4))
    got = m.collectives
    assert got["all-reduce"] == 128 * 256 * 4 + 16 * 4
    assert got["all-gather"] == 64 * 2 + 64 * 2
    assert got["collective-permute"] == 16 * 4 * 4
    assert got["reduce-scatter"] == 8 * 4
    assert got["all-to-all"] == 16 * 4
    assert m.flops == 0


def test_fake_world_is_the_fake_backend_and_goes_away():
    with dryrun.fake_world(256):
        assert dist.get_world_size() == 256 and dist.get_rank() == 0
        assert dist.get_backend() == "fake"
        with pytest.raises(RuntimeError, match="process group exists"):
            with dryrun.fake_world(4):
                pass
    assert not dist.is_initialized()


def test_launcher_writes_records(tmp_path):
    out = str(tmp_path)
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "long_500k",
                 "--out", out])
    rec = json.loads((tmp_path / "tinyllama-1.1b__long_500k__single.json")
                     .read_text())
    assert rec["skipped"] and rec["why"] == jshapes.applicable(
        "dense", "long_500k")[1]
    dryrun.main(["--arch", "noc-sim", "--shape", "noc_43k", "--out", out])
    rec = json.loads((tmp_path / "noc-sim__noc_43k__single.json")
                     .read_text())
    assert rec["devices"] == 256 and rec["tile"] == [16, 16]
    assert rec["sim_nodes"] == 256 * 256 and rec["cycles_per_call"] == 8
    # per cycle a termination all-reduce and four halo slabs; one
    # statistics all-reduce a call
    assert rec["collective_bytes"]["collective-permute"] > 0
    assert rec["collective_bytes"]["all-reduce"] > 0
    assert rec["tile_state_bytes"] > 0 and "plain version" in rec["phase2"]
    assert rec["mem"]["argument"] > rec["tile_state_bytes"]
    # the simulator's per-device constant tables made under the fake mode
    # are gone: a real run in this process still works
    from repro_torch.core import sim
    from repro_torch.core.config import SimConfig
    tr = np.full((4, 2), 64, np.int32)
    assert sim.run(SimConfig(rows=2, cols=2), tr, device="cpu")[
        "finished"] == 1
    dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                 "--out", out])
    rec = json.loads((tmp_path / "no-such-arch__train_4k__single.json")
                     .read_text())
    assert set(rec) == {"arch", "shape", "mesh", "error"}
    assert not dist.is_initialized()
