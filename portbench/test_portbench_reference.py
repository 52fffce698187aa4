"""The frozen reference against the port, and the control against the
reference, on the CPU at an 8x8 mesh for every cell's configuration and
traffic mix."""
import pytest
import torch

from portbench import bench, traffic, yardstick

B = bench.load_benchmark()
#: cells whose files the benchmark keeps for a later entry in
#: BENCHMARK.json (its spread on the card, PERF.md)
HELD_BACK = [{"name": "paper-208-bigcache.matmul",
              "config": "paper-208-bigcache", "traffic": "matmul",
              "chips": 1}]
CELLS = {w["name"]: w for w in B["workloads"] + HELD_BACK}
CYCLES = 40
CPU = torch.device("cpu")


def small(name):
    return bench.cell_of(CELLS[name], B, rehearse=True)


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_port(name):
    cell = small(name)
    traces, entry = bench.prepare(cell, 2_500_000_007, CPU)
    got = entry(CYCLES)
    want = bench.reference_stats(cell, traces, CYCLES, CPU)
    assert got == want
    assert all(w["cycles"] == CYCLES and w["finished"] == 0 for w in want)
    assert sum(w["injected"] for w in want) > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_comes_out_wrong(name):
    cell = small(name)
    traces = traffic.make_traces(cell.cfg, cell.mix, 11)
    want = bench.reference_stats(cell, traces, 24, CPU)
    ctl = bench.reference_stats(cell, traces, 24, CPU, control=True)
    mismatches, failed = yardstick.compare(ctl, want)
    assert mismatches > 0 and failed == len(want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_cards_graph_replay_equals_the_eager_reference(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the reference replays CUDA graphs there")
    cell = small(name)
    traces = traffic.make_traces(cell.cfg, cell.mix, 2_500_000_011)
    card = torch.device("cuda", 0)
    for control in (False, True):
        assert (bench.reference_stats(cell, traces, CYCLES, card,
                                      control=control)
                == bench.reference_stats(cell, traces, CYCLES, CPU,
                                         control=control))
