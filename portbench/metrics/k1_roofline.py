"""Kernel K1 (``phase2_router_kernel``, all of Phase 2) against its byte
bound, in percent: the least time the card could take to move the bytes
Phase 2 must read and write once (``yardstick.phase2_bytes``, at the
configuration's storage types) at the card's published memory rate,
over K1's device time per scenario-cycle.  Nothing to read where K1 did
not run or the card is not in ``peaks.json``."""
from portbench import yardstick

KERNEL = "phase2_router_kernel"


def read(t):
    peak = yardstick.peaks(t.device_name) if t.on_device else None
    us = sum(b - a for name, a, b in t.device_events if KERNEL in name)
    if peak is None or us <= 0:
        return None
    bound_s = (yardstick.phase2_bytes(t.cell.cfg, t.trace_len)
               / peak["hbm_bytes_per_s"])
    return bound_s / (us * 1e-6 / t.scenario_cycles) * 100.0
