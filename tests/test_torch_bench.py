"""The port's ``repro_torch.bench`` held against the JAX package's
``repro.bench`` on the CPU, every comparison exact: the JSON text of
metrics and reports (and a report written by either package read by the
other), the inputs each refuses, the gate's findings and rendered text,
the entry contract's parse, printed table and output files, the
collectors' metrics, and ``scripts/check_doc_coverage_torch.py``.
Inputs are built here from numpy seeds or written to ``tmp_path``.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import repro.bench as jb
from repro.bench import collect as jcollect
from repro.bench import contract as jcontract
from repro.core.state import STAT_NAMES as J_STAT_NAMES

import repro_torch.bench as tb
from repro_torch.bench import collect as tcollect
from repro_torch.bench import contract as tcontract
from repro_torch.core import sim as tsim
from repro_torch.core.config import SimConfig as TConfig
from repro_torch.core.state import STAT_NAMES
from repro_torch.core.workloads import app_trace

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PKGS = (jb, tb)

UNITS = ("count", "s", "ratio", "cycles", "x")


def seeded_metric_kwargs(seed: int, n: int = 6):
    """``n`` seeded ``Metric`` keyword sets: ints and floats, both
    directions, gated and not, with and without tags (plain Python
    values, as a report holds them)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        value = (int(rng.integers(-1000, 1000)) if rng.random() < 0.5
                 else float(rng.standard_normal()
                             * 10.0 ** int(rng.integers(-3, 4))))
        kw = dict(name=f"area.m{i}", value=value,
                  unit=UNITS[int(rng.integers(len(UNITS)))],
                  direction=("lower", "higher")[int(rng.integers(2))],
                  slack=float(rng.uniform(0, 1)),
                  gate=bool(rng.random() < 0.7))
        if rng.random() < 0.5:
            kw["tags"] = {"mesh": f"{int(rng.integers(2, 9))}x4",
                          "app": "matmul"}
        out.append(kw)
    return out


def report(pkg, area, kws, meta=None, raw=None):
    return pkg.BenchReport(area, meta=meta,
                           metrics=[pkg.Metric(**kw) for kw in kws], raw=raw)


def test_same_exports_and_constants():
    assert tb.__all__ == jb.__all__
    for mod in ("schema", "contract", "gate", "collect"):
        assert getattr(tb, mod).__all__ == getattr(jb, mod).__all__, mod
    assert tb.SCHEMA_VERSION == jb.SCHEMA_VERSION == 1
    assert (tcollect.COUNT_SLACK, tcollect.RATIO_SLACK,
            tcollect.SPEEDUP_SLACK) == (jcollect.COUNT_SLACK,
                                        jcollect.RATIO_SLACK,
                                        jcollect.SPEEDUP_SLACK) \
        == (0.0, 0.02, 0.5)
    assert tb.gate._KINDS == jb.gate._KINDS
    assert STAT_NAMES == J_STAT_NAMES


# ---------------------------------------------------------------- schema

@pytest.mark.parametrize("kw", [
    dict(name="a.b", value=3),
    dict(name="a.b", value=3.5, unit="s", direction="higher", slack=0.25,
         gate=False, tags={"mesh": "8x8"}),
    dict(name="flag", value=True, unit="bool"),
    dict(name="zero", value=0.0, slack=0.5),
])
def test_metric_dict_and_json_equal(kw):
    j, t = jb.Metric(**kw), tb.Metric(**kw)
    assert t.to_dict() == j.to_dict()
    assert type(t.value) is type(j.value)
    assert tb.Metric.from_dict(j.to_dict()) == t
    assert jb.Metric.from_dict(t.to_dict()) == j


@pytest.mark.parametrize("seed", range(3))
def test_report_json_equal_and_read_across(seed, tmp_path):
    kws = seeded_metric_kwargs(seed)
    meta = {"smoke": bool(seed % 2), "params": {"rows": 8, "seed": seed}}
    raw = {"free": ["form", seed]} if seed else None
    j, t = (report(p, "toy", kws, meta, raw) for p in PKGS)
    assert t.to_dict() == j.to_dict()
    assert t.to_json() == j.to_json() and t.to_json().endswith("}\n")
    assert ("raw" in t.to_dict()) == bool(raw)
    assert t.render() == j.render()
    assert t.names() == j.names()
    # each package writes; the other reads it back to the same text
    for a, b, name in ((jb, tb, "j"), (tb, jb, "t")):
        path = str(tmp_path / f"BENCH_{name}.json")
        report(a, "toy", kws, meta, raw).write(path)
        back = b.BenchReport.read(path)
        assert back == report(b, "toy", kws, meta, raw)
        with open(path) as f:
            assert back.to_json() == f.read()


def test_report_building_and_access_equal():
    kws = seeded_metric_kwargs(7)
    j, t = (report(p, "toy", kws[:3]) for p in PKGS)
    for rep, pkg in ((j, jb), (t, tb)):
        rep.add("extra.one", 2.5, unit="s", gate=False)
        rep.extend([pkg.Metric(**kw) for kw in kws[3:]])
    assert t.to_json() == j.to_json()
    assert repr(t) == repr(j)
    assert t.metric("extra.one").to_dict() == j.metric("extra.one").to_dict()
    assert t.metric("nope") is None and j.metric("nope") is None


def _raised(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", [
    dict(name="", value=1.0),
    dict(name="bad", value=1.0, direction="sideways"),
    dict(name="bad", value=float("nan")),
    dict(name="bad", value=float("inf")),
    dict(name="bad", value=1.0, slack=-0.1),
    dict(name="bad", value=np.int64(3)),
    dict(name="bad", value=np.int32(3)),
    dict(name="bad", value="3"),
], ids=["empty-name", "direction", "nan", "inf", "negative-slack",
        "numpy-int64", "numpy-int32", "str"])
def test_metric_rejections_equal(kw):
    assert (_raised(lambda: tb.Metric(**kw))
            == _raised(lambda: jb.Metric(**kw)))


@pytest.mark.parametrize("case", ["init", "add", "extend", "future",
                                  "empty-area"])
def test_report_rejections_equal(case):
    def attempt(pkg):
        m = pkg.Metric("x", 1)
        if case == "init":
            return lambda: pkg.BenchReport("toy", metrics=[m, m])
        if case == "add":
            return lambda: pkg.BenchReport("toy", metrics=[m]).add("x", 2)
        if case == "extend":
            return lambda: pkg.BenchReport("toy", metrics=[m]).extend([m])
        if case == "future":
            d = pkg.BenchReport("toy", metrics=[m]).to_dict()
            d["schema_version"] = pkg.SCHEMA_VERSION + 1
            return lambda: pkg.BenchReport.from_dict(d)
        return lambda: pkg.BenchReport("", metrics=[m])
    assert _raised(attempt(tb)) == _raised(attempt(jb))


# ------------------------------------------------------------------ gate

def M(name, value, **kw):
    """A metric's keyword set: lower-better, 10% slack unless given."""
    return dict(name=name, value=value, **{"slack": 0.1, **kw})


#: (base metrics, fresh metrics, slack_scale)
GATE_CASES = {
    "within-slack": ([M("a", 100)], [M("a", 105)], 1.0),
    "beyond-slack": ([M("a", 100)], [M("a", 120)], 1.0),
    "improvement": ([M("a", 100)], [M("a", 80)], 1.0),
    "higher-regression": ([M("a", 10, direction="higher")],
                          [M("a", 8, direction="higher")], 1.0),
    "higher-improvement": ([M("a", 10, direction="higher")],
                           [M("a", 12, direction="higher")], 1.0),
    "vanished": ([M("a", 1), M("b", 2, gate=False)], [], 1.0),
    "new": ([M("a", 1)], [M("a", 1), M("b", 5)], 1.0),
    "zero-base-within": ([M("z", 0, slack=0.5)], [M("z", 0.4)], 1.0),
    "zero-base-beyond": ([M("z", 0, slack=0.5)], [M("z", 0.6)], 1.0),
    "zero-base-zero-slack": ([M("z", 0, slack=0.0)], [M("z", 1)], 1.0),
    "ungated": ([M("t", 1.0, gate=False)], [M("t", 9.0, gate=False)], 1.0),
    "slack-scale": ([M("a", 100)], [M("a", 115)], 2.0),
    "slack-scale-beyond": ([M("a", 100)], [M("a", 125)], 2.0),
}


def _seeded_gate_case(seed):
    rng = np.random.default_rng(seed)
    base = seeded_metric_kwargs(seed, 8)
    fresh = []
    for kw in base[1:]:             # the first vanishes
        v = kw["value"]
        drift = float(rng.uniform(-0.6, 0.6))
        fresh.append({**kw, "value": (int(v * (1 + drift))
                                      if isinstance(v, int)
                                      else v * (1 + drift))})
    fresh.append(dict(name="area.new", value=1.5))
    return base, fresh, float(rng.choice([0.5, 1.0, 2.0]))


for _s in range(3):
    GATE_CASES[f"seeded-{_s}"] = _seeded_gate_case(_s)


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_findings_equal(case):
    base, fresh, scale = GATE_CASES[case]
    got = {}
    for pkg in PKGS:
        found = pkg.compare_reports(report(pkg, "toy", base),
                                    report(pkg, "toy", fresh),
                                    slack_scale=scale)
        got[pkg] = ([dataclasses.astuple(f) for f in found],
                    pkg.gate_passes(found),
                    pkg.render_findings("toy", found))
    assert got[tb] == got[jb]
    assert got[tb][0]                 # every case has findings


def test_gate_verdicts_of_the_named_cases():
    """The named cases say what they are named (the port's verdicts; the
    test above holds them equal to ``repro``'s)."""
    want = {"within-slack": ["ok"], "beyond-slack": ["regression"],
            "improvement": ["improvement"],
            "higher-regression": ["regression"],
            "higher-improvement": ["improvement"],
            "vanished": ["vanished", "vanished"], "new": ["ok", "new"],
            "zero-base-within": ["ok"], "zero-base-beyond": ["regression"],
            "zero-base-zero-slack": ["regression"], "ungated": ["info"],
            "slack-scale": ["ok"], "slack-scale-beyond": ["regression"]}
    for case, kinds in want.items():
        base, fresh, scale = GATE_CASES[case]
        found = tb.compare_reports(report(tb, "toy", base),
                                   report(tb, "toy", fresh), scale)
        assert [f.kind for f in found] == kinds, case
    vanished = tb.compare_reports(report(tb, "toy", GATE_CASES["vanished"][0]),
                                  report(tb, "toy", []))
    assert [f.fails for f in vanished] == [True, False]


def test_gate_area_mismatch_raises_in_both():
    def attempt(pkg):
        return lambda: pkg.compare_reports(report(pkg, "a", [M("x", 1)]),
                                           report(pkg, "b", [M("x", 1)]))
    assert _raised(attempt(tb)) == _raised(attempt(jb))


def test_render_findings_of_nothing_equal():
    assert tb.render_findings("toy", []) == jb.render_findings("toy", [])


@pytest.mark.parametrize("names,max_cols", [(None, 8), (["area.m1", "gone"],
                                                         2)])
def test_render_trend_equal(names, max_cols):
    texts = {}
    for pkg in PKGS:
        history = [(f"c{s:06d}", report(pkg, "toy", seeded_metric_kwargs(s)))
                   for s in range(4)]
        texts[pkg] = (pkg.render_trend(history, names=names,
                                       max_cols=max_cols),
                      pkg.render_trend([]))
    assert texts[tb] == texts[jb]
    assert texts[tb][1] == "(no history)"


# -------------------------------------------------------------- contract

def toy_bench(pkg):
    """A toy benchmark under ``pkg``'s entry contract: two flags, a smoke
    tier that changes one, a report of both and a raw payload."""
    def add_args(ap):
        ap.add_argument("--rows", type=int, default=16)
        ap.add_argument("--name", default="full")

    def run(args):
        rep = pkg.BenchReport("toy", meta={"rows": args.rows},
                              raw={"rows": args.rows, "name": args.name})
        rep.add("toy.rows", args.rows, unit="rows")
        rep.add("toy.speedup", 1.5, unit="x", direction="higher",
                slack=0.5, tags={"name": args.name})
        return rep
    return pkg.Benchmark(area="toy", title="a toy benchmark",
                         add_args=add_args, run=run, smoke={"rows": 4})


@pytest.mark.parametrize("argv,rows", [([], 16), (["--smoke"], 4),
                                       (["--smoke", "--rows", "9"], 9),
                                       (["--rows", "9"], 9)])
def test_parse_bench_args_equal(argv, rows):
    t = tcontract.parse_bench_args(toy_bench(tb), argv)
    j = jcontract.parse_bench_args(toy_bench(jb), argv)
    assert vars(t) == vars(j)
    assert t.rows == rows


def test_parsers_equal():
    assert (tcontract.build_parser(toy_bench(tb)).format_help()
            == jcontract.build_parser(toy_bench(jb)).format_help())


@pytest.mark.parametrize("argv", [[], ["--smoke"], ["--smoke", "--rows", "9",
                                                    "--name", "mine"]])
def test_bench_main_output_and_files_equal(argv, tmp_path, capsys):
    got = {}
    for pkg, tag in ((jb, "j"), (tb, "t")):
        out, js = tmp_path / f"{tag}.out.json", tmp_path / f"{tag}.raw.json"
        rep = pkg.bench_main(toy_bench(pkg),
                             argv + ["--out", str(out), "--json", str(js)])
        got[tag] = (capsys.readouterr().out, out.read_bytes(),
                    js.read_bytes(), rep.to_json())
    assert got["t"] == got["j"]
    assert b'"smoke": ' in got["t"][1]


# ------------------------------------------------------------ collectors

def seeded_stats(seed: int):
    """One to three seeded per-scenario stats dicts over ``STAT_NAMES``
    (plain ints, as ``stats_dicts`` gives them)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(1, 4))):
        d = {k: int(rng.integers(0, 10 ** int(rng.integers(1, 7))))
             for k in STAT_NAMES}
        d["cycles"] = int(rng.integers(1, 5000))
        d["finished"] = int(rng.integers(0, 2))
        out.append(d)
    return out


def assert_health_equal(stats, prefix="plan.net", tags=None):
    t = tcollect.health_metrics(stats, prefix, tags=tags)
    j = jcollect.health_metrics(stats, prefix, tags=tags)
    assert [m.to_dict() for m in t] == [m.to_dict() for m in j]
    assert [type(m.value) for m in t] == [type(m.value) for m in j]
    return t


@pytest.mark.parametrize("seed", range(16))
def test_health_metrics_equal_on_seeded_stats(seed):
    tags = {"seed": str(seed)} if seed % 2 else None
    got = assert_health_equal(seeded_stats(seed), tags=tags)
    assert [m.name for m in got] == [
        "plan.net.deflection_rate", "plan.net.hops_per_flit",
        "plan.net.deflections_per_flit", "plan.net.drops_recovered",
        "plan.net.stray_responses"]


@pytest.mark.parametrize("zero", ["hops", "flits_delivered", "both",
                                  "no-scenarios"])
def test_health_metrics_equal_on_empty_aggregates(zero):
    stats = seeded_stats(99)
    if zero == "no-scenarios":
        stats = []
    for d in stats:
        if zero in ("hops", "both"):
            d["hops"] = 0
        if zero in ("flits_delivered", "both"):
            d["flits_delivered"] = 0
    got = assert_health_equal(stats)
    if zero in ("hops", "both", "no-scenarios"):
        assert got[0].value == 0.0


def test_health_metrics_equal_on_a_port_run():
    """The stats of a short 4x4 run of the port's simulator on the CPU
    (``test_torch_sim.py``'s centralized config and matmul trace, cut
    to 48 cycles)."""
    cfg = TConfig(rows=4, cols=4, addr_bits=14, migrate_threshold=2,
                  centralized_directory=True)
    stats = tsim.run(cfg, app_trace(cfg, "matmul", 30, 1), max_cycles=48,
                     device="cpu")
    assert stats["cycles"] == 48 and stats["hops"] > 0
    assert all(type(v) is int for v in stats.values())
    got = assert_health_equal([stats], prefix="plan")
    assert got[1].value > 0


@pytest.mark.parametrize("fn,args,kw", [
    ("timing_metric", ("t.wall", 1.23456789), {}),
    ("timing_metric", ("t.wall", 7), {"unit": "ms", "tags": {"a": "b"}}),
    ("ratio_metric", ("r.speedup", 2.718281828), {}),
    ("ratio_metric", ("r.frac", 0.333333), {"direction": "lower",
                                            "slack": 0.02}),
    ("count_metric", ("c.cycles", 1234), {}),
    ("count_metric", ("c.cycles", 7.9), {"slack": 1.0}),
    ("flag_metric", ("f.ok", True), {}),
    ("flag_metric", ("f.ok", 0), {"gate": False}),
])
def test_scalar_collectors_equal(fn, args, kw):
    t = getattr(tcollect, fn)(*args, **kw)
    j = getattr(jcollect, fn)(*args, **kw)
    assert t.to_dict() == j.to_dict()
    assert type(t.value) is type(j.value)


# ---------------------------------------------------------- doc coverage

def load(rel: str):
    """The script at ``rel`` (from the repo root) as a module."""
    path = os.path.join(ROOT, rel)
    spec = importlib.util.spec_from_file_location(
        os.path.basename(rel)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_doc_coverage_of_the_port_passes():
    mine = load("scripts/check_doc_coverage_torch.py")
    ref = load("scripts/check_doc_coverage.py")
    assert mine.MODULES == [m.replace("repro.", "repro_torch.", 1)
                            for m in ref.MODULES]
    assert mine.NAMED_SURFACE == [(m.replace("repro.", "repro_torch.", 1),
                                   n) for m, n in ref.NAMED_SURFACE]
    assert mine.MIN_DOC == ref.MIN_DOC == 40
    assert "repro_torch.bench" in mine.MODULES
    assert mine.main() == 0
