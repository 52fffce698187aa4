"""Operations the device ran per scenario-cycle: kernels, copies and
fills in the traced sub-window's device trace."""


def read(t):
    if not t.device_events:
        return None
    return len(t.device_events) / t.scenario_cycles
