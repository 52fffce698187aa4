"""``state_copy_ms`` over the device's busy time in the traced
sub-window (``Trace.busy_s``), in percent: the share of the device's
work that copies and casts state."""
from portbench import bench


def read(t):
    ms = bench.reader("state_copy_ms")(t)
    if ms is None or not t.busy_s:
        return None
    return ms * t.scenario_cycles * 1e-3 / t.busy_s * 100.0
