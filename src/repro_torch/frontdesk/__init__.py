"""Async admission plane for MOOService (DESIGN.md §12).

admission → adaptive micro-batching window → EDF scheduler → executor:
bounded-queue backpressure at the front door, arrivals held just long
enough to fill the executor's (G, R) structure buckets, deadline-aware
dispatch with load-shedding of already-missed work, and a dispatcher
thread so ``recommend`` stays non-blocking throughout.
"""

from .admission import (
    DONE,
    ERROR,
    PENDING,
    REJECTED,
    SHED,
    SLO_CLASSES,
    AdmissionQueue,
    SLOClass,
    Ticket,
)
from .batcher import AdaptiveBatcher
from .plane import FrontDesk
from .scheduler import EDFScheduler

__all__ = [
    "AdaptiveBatcher",
    "AdmissionQueue",
    "EDFScheduler",
    "FrontDesk",
    "SLOClass",
    "SLO_CLASSES",
    "Ticket",
    "PENDING",
    "DONE",
    "REJECTED",
    "SHED",
    "ERROR",
]
