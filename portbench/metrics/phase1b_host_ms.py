"""Host milliseconds per scenario-cycle in the port's ``phase1b``: the
benchmark's spans around each call, over the traced sub-window."""


def read(t):
    return t.spans["phase1b"] / t.scenario_cycles * 1e3
