"""Deadline-aware scheduling of pending probe work (DESIGN.md §12).

The :class:`EDFScheduler` replaces uniform ``step_all`` round-robin for
queued traffic: pending tickets are grouped by their session's dispatch
key (one group = one future executor dispatch) and groups drain in
earliest-deadline-first order.  Already-missed deadlines are load-shed
*before* dispatch — probe work for a caller who has given up is pure
waste, and shedding it is what keeps the p95 of *admitted* work bounded
past saturation.

Scans are O(pending tickets), which admission control bounds by the
queue capacity — no heap is needed at frontdesk scales, and a flat scan
keeps shed/claim trivially correct under the plane lock.
"""

from __future__ import annotations

from .admission import PENDING, Ticket


class EDFScheduler:
    """Pending tickets, grouped by dispatch key, ordered by deadline."""

    def __init__(self):
        self._groups: dict[tuple, dict[int, Ticket]] = {}

    def __len__(self) -> int:
        return sum(len(g) for g in self._groups.values())

    def add(self, ticket: Ticket) -> None:
        self._groups.setdefault(ticket.group_key, {})[
            ticket.ticket_id] = ticket

    def shed_expired(self, now: float) -> list[Ticket]:
        """Remove every sheddable pending ticket whose deadline has
        passed.  The caller marks them (and releases their admission
        slots); the scheduler only decides membership."""
        out: list[Ticket] = []
        for key in list(self._groups):
            group = self._groups[key]
            for tid in list(group):
                t = group[tid]
                if t.state != PENDING:
                    del group[tid]
                elif t.slo.sheddable and t.deadline <= now:
                    del group[tid]
                    out.append(t)
            if not group:
                del self._groups[key]
        return out

    def group_sizes(self) -> dict[tuple, int]:
        return {k: len(g) for k, g in self._groups.items()}

    def earliest_deadline(self, key: tuple) -> float:
        return min(t.deadline for t in self._groups[key].values())

    def group_order(self) -> list[tuple]:
        """Group keys sorted by their most urgent member — the dispatch
        order.  A tight-deadline tenant's group preempts a loose one
        even if the loose group arrived first."""
        return sorted(self._groups, key=self.earliest_deadline)

    def claim_group(self, key: tuple) -> list[Ticket]:
        """Remove and return a whole group for dispatch (micro-batch =
        every pending ticket sharing the compiled structure)."""
        group = self._groups.pop(key, {})
        return list(group.values())
