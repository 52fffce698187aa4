"""Port parity: config, statistic names and trace generators.

The PyTorch port (``repro_torch``) keeps its own copies of the JAX
package's JAX-free modules; these tests hold each copy against the
original with zero tolerance (every value is an integer).
"""
import dataclasses

import numpy as np
import pytest

from repro.core import config as jconfig
from repro.core import workloads as jwl
from repro.core.ref_serial import STAT_NAMES as J_STAT_NAMES

from repro_torch.core import config as tconfig
from repro_torch.core import state as tstate
from repro_torch.core import workloads as twl


def test_constants_identical():
    names = [k for k in vars(jconfig) if k.isupper()]
    assert names, "no constants found"
    for k in names:
        assert getattr(tconfig, k) == getattr(jconfig, k), k
    assert tstate.STAT_NAMES == J_STAT_NAMES


@pytest.mark.parametrize("cls", ["CacheConfig", "SimConfig"])
def test_config_fields_and_defaults_identical(cls):
    jf = dataclasses.fields(getattr(jconfig, cls))
    tf = dataclasses.fields(getattr(tconfig, cls))
    assert [f.name for f in tf] == [f.name for f in jf]
    jd = dataclasses.asdict(getattr(jconfig, cls)())
    td = dataclasses.asdict(getattr(tconfig, cls)())
    assert td == jd


def test_config_carries_across_and_derives_the_same():
    jc = jconfig.SimConfig(rows=3, cols=5, addr_bits=13, pc_depth=2,
                           state_dtype_policy="packed",
                           cache=jconfig.CacheConfig(16, 4, 32, 8, 2, 64))
    d = dataclasses.asdict(jc)
    tc = tconfig.SimConfig(**{**d, "cache": tconfig.CacheConfig(**d["cache"])})
    for prop in ("num_nodes", "livelock_window_effective", "dir_entries",
                 "pkt_wrap"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert [tc.dir_home(t) for t in range(40)] == \
        [jc.dir_home(t) for t in range(40)]
    bad = dict(state_dtype_policy="packed", migrate_threshold=40_000)
    with pytest.raises(ValueError):
        jconfig.SimConfig(**bad).validate()
    with pytest.raises(ValueError):
        tconfig.SimConfig(**bad).validate()


def test_registry_identical():
    assert twl.gen_names() == jwl.gen_names()
    for name in jwl.gen_names():
        jg, tg = jwl.get_gen(name), twl.get_gen(name)
        assert (tg.kind, tg.help, tg.positional) == \
            (jg.kind, jg.help, jg.positional), name
        assert {k: dataclasses.asdict(p) for k, p in tg.params.items()} == \
            {k: dataclasses.asdict(p) for k, p in jg.params.items()}, name
    assert twl.source_summary() == jwl.source_summary()


@pytest.mark.parametrize("rows,cols,dist", [(4, 4, False), (3, 5, True)])
def test_every_generator_byte_identical(rows, cols, dist):
    jc = jconfig.SimConfig(rows=rows, cols=cols, addr_bits=14,
                           centralized_directory=not dist)
    tc = tconfig.SimConfig(rows=rows, cols=cols, addr_bits=14,
                           centralized_directory=not dist)
    specs = list(jwl.gen_names()) + ["loop:equake", "hotspot:frac=0.8,hot=2",
                                     "transpose:rate=0.5"]
    for spec in specs:
        for seed in (0, 3):
            a = jwl.resolve_trace(jc, spec, 15, seed)
            b = twl.resolve_trace(tc, spec, 15, seed)
            assert a.dtype == b.dtype and a.shape == b.shape, spec
            assert a.tobytes() == b.tobytes(), (spec, seed)
    mixed = [("matmul", 1, 10), ("random", 2), ("neighbor", 0, 20)]
    a = jwl.stacked_traces(jc, mixed, default_refs=15)
    b = twl.stacked_traces(tc, mixed, default_refs=15)
    assert a.tobytes() == b.tobytes()
    a = jwl.from_model_schedule(jc, 4096, 64, 2, 15, 1)
    b = twl.from_model_schedule(tc, 4096, 64, 2, 15, 1)
    assert np.array_equal(a, b) and a.dtype == b.dtype
