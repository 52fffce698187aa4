"""Host milliseconds per scenario-cycle in the port's ``phase2``: the
benchmark's spans around each call, over the traced sub-window."""


def read(t):
    return t.spans["phase2"] / t.scenario_cycles * 1e3
