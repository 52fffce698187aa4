"""Device milliseconds per scenario-cycle in copy and cast operations:
what ``clone``, ``copy_`` and ``.to()`` run as.  The profiler names a
same-dtype copy ``Memcpy DtoD (Device -> Device)`` and a casting one
an elementwise kernel of ``direct_copy_kernel_cuda`` (its
``unrolled_elementwise_kernel`` and ``vectorized_elementwise_kernel``
instances), so a name holding ``Memcpy DtoD`` or ``copy_kernel``
counts.  Nothing to read off the card."""

COPIES = ("Memcpy DtoD", "copy_kernel")


def read(t):
    if not t.on_device or not t.device_events:
        return None
    us = sum(b - a for name, a, b in t.device_events
             if any(k in name for k in COPIES))
    return us * 1e-3 / t.scenario_cycles
