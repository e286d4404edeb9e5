"""Unified observability plane: typed metrics + request-path tracing.

One :class:`Observability` bundle travels down the serving stack —
``FrontDesk`` → ``MOOService`` → ``ProbeExecutor`` → ``FrontierVault``
— so every component registers its instruments in one
:class:`MetricsRegistry` (snapshot-consistent JSON / Prometheus export)
and emits spans through one :class:`Tracer` (Chrome-trace export).
Components construct their own bundle when none is supplied, so
standalone use keeps working and the legacy ``stats()`` dicts remain
views over the registry.  See DESIGN.md §14.
"""

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import NOOP_SPAN, Span, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NOOP_SPAN", "Observability", "Span", "Tracer"]


class Observability:
    """Metrics registry + tracer, shared down one serving stack.

    ``trace=True`` (or an explicit :class:`Tracer`) turns span recording
    on; the default keeps the tracer on its no-op fast path so an
    uninstrumented-feeling deployment pays ~nothing (gated in
    ``benchmarks/obsbench.py``).
    """

    def __init__(self, metrics: MetricsRegistry | None = None,
                 tracer: Tracer | None = None, trace: bool = False):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=trace)
