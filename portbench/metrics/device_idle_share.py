"""Share of the traced sub-window's host seconds in which no operation
ran on the device, in percent."""


def read(t):
    if not t.on_device or t.busy_s is None:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100.0
