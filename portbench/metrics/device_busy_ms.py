"""Device milliseconds per scenario-cycle in which some operation ran:
the union of the traced sub-window's device operations."""


def read(t):
    if not t.on_device or t.busy_s is None:
        return None
    return t.busy_s / t.scenario_cycles * 1e3
