"""Back-compat shim over :mod:`repro_torch.core.workloads`.

The counterpart of the JAX package's ``repro.core.trace``: it re-exports
the historical trace surface (``app_trace``, ``app_trace_loop``,
``random_trace``, ``resolve_trace``, ``stacked_traces``,
``from_model_schedule``, ``TRACE_APPS``, ``valid_app``) so code written
against that module's names keeps working.  New code should import from
:mod:`repro_torch.core.workloads` directly.
"""
from __future__ import annotations

from .workloads import (TRACE_APPS, app_trace, app_trace_loop,
                        from_model_schedule, random_trace, resolve_trace,
                        stacked_traces, valid_app)

__all__ = [
    "app_trace",
    "app_trace_loop",
    "random_trace",
    "resolve_trace",
    "from_model_schedule",
    "stacked_traces",
    "TRACE_APPS",
    "valid_app",
]
