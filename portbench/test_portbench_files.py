"""BENCHMARK.json and the files it names: the contract's shapes, every
configuration and mix loads, every per-layer metric has its reader and
every reader its metric."""
import json
import re
from pathlib import Path

import pytest

from portbench import bench, traffic, yardstick
from portbench.reference import config as ref_config
from portbench.reference.state import leaf_dtypes
from repro_torch.core.config import CacheConfig, SimConfig

ROOT = Path(bench.ROOT)
B = bench.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_the_top_level_keys_command_and_paths():
    assert set(B) == KEYS
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert 1 <= B["run_seconds"] <= 51
    for p in ROOT.joinpath("portbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in B[k]}) == len(B[k])
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    cells = {w["name"] for w in B["workloads"]}
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


CONFIG_FILES = sorted(p.stem for p in (ROOT / "portbench" / "configs").glob(
    "*.json"))
MIX_FILES = sorted(p.stem for p in (ROOT / "portbench" / "traffic").glob(
    "*.json"))


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_a_configuration_file_builds_both_sides(name):
    """Every configuration file, named in BENCHMARK.json or kept for a
    later entry there."""
    raw = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    for c in B["configs"]:
        if c["name"] == name:
            assert c["file"] == f"portbench/configs/{name}.json"
            assert (raw["source"], raw["reduced"]) == (c["source"],
                                                       c["reduced"])
    cfg, fields = bench.load_config(name)
    assert set(fields) == set(ref_config.FIELDS)
    port = SimConfig(**dict(fields, cache=CacheConfig(**fields["cache"])))
    port.validate()
    assert (cfg.num_nodes, cfg.dir_entries, cfg.pkt_wrap) == (
        port.num_nodes, port.dir_entries, port.pkt_wrap)


def test_every_configuration_in_benchmark_json_is_used_by_a_cell():
    for c in B["configs"]:
        assert c["name"] in CONFIG_FILES
        assert any(w["config"] == c["name"] for w in B["workloads"])


@pytest.mark.parametrize("name", MIX_FILES)
def test_a_traffic_mix_file_loads(name):
    mix = traffic.load_mix(name)
    assert mix["cycles_per_s"] > 0


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_a_cell_names_known_files(w):
    cell = bench.load_cell(w["name"])
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                    "node_cycles_per_s"}
    assert cell.per_layer


def test_every_per_layer_metric_has_a_reader_and_no_reader_is_spare():
    readers = {p.stem for p in (ROOT / "portbench" / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in B["per_layer"]}
    for name in readers:
        assert callable(bench.reader(name))


def test_the_sweep_mix_sets_its_knobs():
    cell = bench.load_cell("paper-208.sweep4")
    cfgs = traffic.scenario_configs(cell.cfg, cell.mix)
    assert [c.migration_enabled for c in cfgs] == [True, False, True, True]
    assert [c.eject_age_threshold for c in cfgs] == [0, 0, 8, 0]
    assert [c.migrate_threshold for c in cfgs] == [3, 3, 3, 1]


def test_phase2_bytes_at_the_packed_storage_types():
    cfg, _ = bench.load_config("paper-208")
    dt = leaf_dtypes(cfg, 64)
    assert [dt[k].itemsize for k in ("inp", "rob", "pc", "q_desc",
                                     "q_head", "q_size", "q_fid")] == \
        [4, 4, 4, 4, 1, 1, 1]
    # a router reads 160 + 224 + 80 + 24 + 3 B and writes 160 + 3 + 1 B
    assert yardstick.phase2_bytes(cfg, 64) == 43_264 * 655 + 204
    # below the fused kernel's own count of what it moves (int32 queue
    # words, an int64 port, the routers' ids)
    assert yardstick.phase2_bytes(cfg, 64) < 30_155_220


def test_union_and_gaps_of_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (8.0, 9.0)]
    assert yardstick.union_seconds(iv) == 5.0
    assert yardstick.idle_gaps(iv) == [(3.0, 5.0), (6.0, 8.0)]


def test_compare_counts_mismatches_and_missing_scenarios():
    want = [{"hops": 3, "cycles": 8, "finished": 0}] * 2
    assert yardstick.compare(want, want) == (0, 0)
    assert yardstick.compare([dict(want[0], hops=4), want[1]], want) == (1, 1)
    assert yardstick.compare(want[:1], want) == (3, 1)
