"""Port parity of the simulator launcher (``repro_torch.launch.simulate``).

Each mode runs in-process on the CPU (``--device cpu``) and its JSON
payload must equal the JAX launcher's (``repro.launch.simulate``) for the
same flags, bit for bit, leaving out the wall-clock keys and the port's
own ``device`` and ``arbitration_kernel_launches``.  ``--zoo list`` and
the mode-conflict errors must read the same.

Every planner mode here plans 4x4 buckets of one structural config at
one trace length, so the JAX launcher compiles two programs (batch 1 and
batch 2), about 20 s each on the CPU.
"""
import json
import warnings

import pytest
import torch

from repro.launch import simulate as jlaunch

from repro_torch.launch import simulate as tlaunch

torch.set_num_threads(1)

#: flags shared by every planner mode: one structural config, one trace
#: length (two references a core, about 200 cycles a scenario)
COMMON = ["--rows", "4", "--cols", "4", "--refs", "2"]
#: keys that only one launcher prints, or that measure the host
OWN_KEYS = ("wall_s", "scenarios_per_sec", "device",
            "arbitration_kernel_launches")


def payloads(capsys, argv):
    """(JAX payload, port payload) for the same flags."""
    jlaunch.main(argv)
    want = json.loads(capsys.readouterr().out)
    tlaunch.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert got["device"] == "cpu" and got["arbitration_kernel_launches"] == 0
    return ({k: v for k, v in want.items() if k not in OWN_KEYS},
            {k: v for k, v in got.items() if k not in OWN_KEYS})


def test_solo_mode_with_the_deprecated_sharded_alias(capsys):
    with pytest.warns(DeprecationWarning, match="--sharded is deprecated"):
        want, got = payloads(capsys, COMMON + ["--app", "matmul", "--seed",
                                               "1", "--sharded"])
    assert got == want
    assert got["finished"] == 1 and got["nodes"] == 16
    assert got["backend"] == "sweep"
    assert got["backend_note"].startswith("sharded unavailable")


@pytest.mark.parametrize("argv", [
    ["--sweep", "--apps", "matmul,random", "--seeds", "1"],
    ["--plan", "4x4:bitcomp:0:2;4x4:loop:matmul:3:2", "--backend", "composed",
     "--mem-budget", "64M"],
    ["--zoo", "patterns-tiny:refs=2,seeds=0,sources=transpose+tornado"],
], ids=["sweep", "plan", "zoo"])
def test_planner_modes(capsys, argv):
    want, got = payloads(capsys, COMMON + argv)
    assert got == want
    assert got["n_scenarios"] == len(got["scenarios"]) == 2
    assert got["plan"]["n_buckets"] == 1 and got["plan"]["devices"] == 1
    assert all(s["finished"] == 1 for s in got["scenarios"])


def test_serial_mode(capsys, tmp_path):
    out = tmp_path / "serial.json"
    argv = COMMON + ["--serial", "--app", "random", "--seed", "4",
                     "--pc-depth", "2", "--eject-age-threshold", "3"]
    jlaunch.main(argv)
    want = json.loads(capsys.readouterr().out)
    tlaunch.main(argv + ["--json", str(out)])
    got = json.loads(capsys.readouterr().out)
    assert json.loads(out.read_text()) == got
    assert got.pop("wall_s") >= 0 and want.pop("wall_s") >= 0
    assert got == want and got["finished"] == 1


def test_zoo_list(capsys):
    jlaunch.main(["--zoo", "list"])
    want = capsys.readouterr().out
    tlaunch.main(["--zoo", "list"])
    assert capsys.readouterr().out == want
    assert len(want.splitlines()) == 6


@pytest.mark.parametrize("argv", [
    ["--sweep", "--plan", "4x4"],
    ["--serial", "--zoo", "wedge"],
    ["--serial", "--backend", "sweep"],
    ["--serial", "--sharded"],
    ["--sharded", "--backend", "composed"],
])
def test_mode_conflicts_fail_with_the_reference_message(capsys, argv):
    errs = []
    for launcher in (jlaunch, tlaunch):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(SystemExit) as e:
                launcher.main(argv)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.split(": error: ")[-1])
    assert errs[0] == errs[1]


def test_memory_budget_error_is_the_reference(capsys):
    argv = COMMON + ["--sweep", "--apps", "matmul,random", "--mem-budget",
                     "10K"]
    msgs = []
    for launcher, extra in ((jlaunch, []), (tlaunch, ["--device", "cpu"])):
        with pytest.raises(ValueError) as e:
            launcher.main(argv + extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "over the 10.0K budget" in msgs[0]
