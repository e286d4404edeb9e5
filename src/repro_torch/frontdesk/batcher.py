"""Adaptive micro-batching window (DESIGN.md §12).

The executor pads every dispatch up to its (G, R) structure bucket, so a
half-full micro-batch pays the full bucket's FLOPs.  The batcher holds
arrivals just long enough to fill the bucket: each dispatch group keeps
a window ``w`` in ``[w_min, w_max]`` and a dispatch fires when any of

* the group has reached its **target** size — the power-of-2 bucket the
  executor would pad its recent batch sizes to (no point waiting once
  the bucket is full: more arrivals would only grow the padding target);
* the window has been open longer than ``w``;
* the group's most urgent deadline is within ~2 recent dispatch walls —
  waiting longer would turn an admitted request into a shed one.

The window adapts on *window-expiry* dispatches only (target/deadline
fires carry no signal about whether waiting helped): expiring at or
above the recent average size means the window is long enough — shrink
it to cut queueing latency under load; expiring far below average means
arrivals are sparse — grow it to catch stragglers while idle.
"""

from __future__ import annotations

import dataclasses
import math

from ..exec.executor import bucket


@dataclasses.dataclass
class _GroupWindow:
    window_s: float
    opened_at: float | None = None  # None — no pending work, window shut
    ema_size: float = 1.0  # recent dispatched batch sizes
    ema_wall_s: float = 0.05  # recent dispatch wall time


class AdaptiveBatcher:
    """Per-dispatch-group hold-and-release policy."""

    def __init__(
        self,
        w_min: float = 0.002,
        w_max: float = 0.200,
        w_init: float | None = None,
        shrink: float = 0.5,
        grow: float = 2.0,
        ema_alpha: float = 0.3,
        bucket_fn=bucket,
    ):
        if not 0 < w_min <= w_max:
            raise ValueError("need 0 < w_min <= w_max")
        self.w_min = w_min
        self.w_max = w_max
        self.w_init = min(w_max, max(w_min, w_init if w_init is not None
                                     else math.sqrt(w_min * w_max)))
        self.shrink = shrink
        self.grow = grow
        self.ema_alpha = ema_alpha
        self.bucket_fn = bucket_fn
        self._groups: dict[tuple, _GroupWindow] = {}

    def _group(self, key: tuple) -> _GroupWindow:
        g = self._groups.get(key)
        if g is None:
            g = self._groups[key] = _GroupWindow(window_s=self.w_init)
        return g

    def note_arrival(self, key: tuple, now: float) -> None:
        """A ticket joined the group: open its window if shut."""
        g = self._group(key)
        if g.opened_at is None:
            g.opened_at = now

    def target(self, key: tuple) -> int:
        """The batch size worth waiting for: the executor bucket of the
        recent average dispatch size (never below 1)."""
        g = self._group(key)
        return max(1, self.bucket_fn(max(1, math.ceil(g.ema_size))))

    def ready(self, key: tuple, size: int, earliest_deadline: float,
              now: float) -> bool:
        """Should this group dispatch now?  (See module docstring.)"""
        if size <= 0:
            return False
        g = self._group(key)
        if g.opened_at is None:  # arrivals raced ahead of note_arrival
            g.opened_at = now
        if size >= self.target(key):
            return True
        if now - g.opened_at >= g.window_s:
            return True
        return earliest_deadline - now <= 2.0 * g.ema_wall_s

    def window_opened_at(self, key: tuple) -> float | None:
        """When the group's current window opened (None — window shut).
        The frontdesk's latency attribution uses this to split a claimed
        ticket's wait into queue time vs deliberate batching hold."""
        g = self._groups.get(key)
        return None if g is None else g.opened_at

    def wall_ema(self, key: tuple) -> float:
        """The group's recent dispatch wall-time EMA (0.0 for a group
        never dispatched) — the budget policy's deadline guard compares
        ticket slack against this (DESIGN.md §15)."""
        g = self._groups.get(key)
        return 0.0 if g is None else float(g.ema_wall_s)

    def window_expired(self, key: tuple, now: float) -> bool:
        g = self._group(key)
        return g.opened_at is not None and now - g.opened_at >= g.window_s

    def on_dispatch(self, key: tuple, size: int, wall_s: float,
                    expired: bool, now: float) -> None:
        """Fold one dispatch into the group's stats and adapt ``w``."""
        g = self._group(key)
        a = self.ema_alpha
        if expired:
            # only expiry dispatches say whether waiting was worth it
            if size >= g.ema_size:
                g.window_s = max(self.w_min, g.window_s * self.shrink)
            elif size < 0.5 * g.ema_size:
                g.window_s = min(self.w_max, g.window_s * self.grow)
        g.ema_size = (1 - a) * g.ema_size + a * size
        g.ema_wall_s = (1 - a) * g.ema_wall_s + a * wall_s
        g.opened_at = None  # reopens on the next arrival / leftover

    def wait_hint(self, pending_keys, now: float) -> float | None:
        """Longest safe dispatcher sleep: time until the soonest open
        window expires (None — nothing pending, sleep indefinitely)."""
        soonest: float | None = None
        for key in pending_keys:
            g = self._group(key)
            opened = now if g.opened_at is None else g.opened_at
            left = max(0.0, opened + g.window_s - now)
            soonest = left if soonest is None else min(soonest, left)
        return soonest

    def snapshot(self) -> dict:
        return {
            str(k): {
                "window_s": g.window_s,
                "ema_size": g.ema_size,
                "ema_wall_s": g.ema_wall_s,
                "target": self.target(k),
            }
            for k, g in self._groups.items()
        }
