"""The PyTorch port's drivers outside the package, run in-process on the
CPU at reduced sizes: ``examples/quickstart_torch.py`` (its statistics
identical to the serial model's), ``examples/serve_lm_torch.py`` (ten
requests served), ``scripts/compare_debug_torch.py`` (the serial model
and the simulator in lockstep, no divergence; a perturbed leaf found),
``scripts/smoke_zoo_torch.py`` (every reduced arch through forward,
loss, gradient and two decode steps) and
``scripts/gen_cli_docs_torch.py --check`` (``docs/cli_torch.md`` equals
what the launchers' parsers give).
"""
import importlib.util
import os

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def load(rel: str):
    """The script at ``rel`` (from the repo root) as a module."""
    path = os.path.join(ROOT, rel)
    spec = importlib.util.spec_from_file_location(
        os.path.basename(rel)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_docs_are_current():
    assert load("scripts/gen_cli_docs_torch.py").main(["--check"]) == 0


def test_quickstart_matches_the_serial_model():
    stats = load("examples/quickstart_torch.py").main(
        ["--device", "cpu"], rows=4, cols=4, refs=3)
    assert stats["finished"] == 1 and stats["injected"] > 0


def test_serve_lm_serves_ten_requests():
    done = load("examples/serve_lm_torch.py").main(["--device", "cpu"])
    assert sorted(r.rid for r in done) == list(range(10))
    assert all(len(r.out) == 12 for r in done)


def test_compare_debug_steps_in_lockstep_and_finds_a_divergence():
    cd = load("scripts/compare_debug_torch.py")
    cycle, leaf = cd.main(rows=4, cols=4, refs=3, device="cpu")
    assert leaf is None and cycle > 0
    a = {"st": np.zeros(4), "stats": np.zeros(3)}
    b = {"st": np.zeros(4), "stats": np.array([0, 1, 0])}
    assert cd.compare(a, b, 7) == "stats"


def test_smoke_zoo_runs_every_reduced_arch():
    assert load("scripts/smoke_zoo_torch.py").main(["--device", "cpu"]) == 0
