"""Host milliseconds per scenario-cycle outside the four phase spans:
the driver's monitors, stacking and termination checks, and the state's
casts and statistics fold around the phases."""


def read(t):
    return (t.window_s - sum(t.spans.values())) / t.scenario_cycles * 1e3
