"""Array-native incremental Pareto frontier store (DESIGN.md §3).

:class:`FrontierStore` keeps probe results in preallocated, grow-on-demand
host arrays and maintains the Pareto mask *incrementally*: each probe batch
is scored against the live frontier in one dominance pass — the dense
``(B, cap, k)`` comparison in torch (:func:`_incremental_pass`), or, with
``use_kernel=True``, three calls of the cross-set dominator-count kernel
(``kernels.pareto_filter.cross_dominator_counts``), which never builds the
comparison tensor.  Both passes run on the store's device and compare in
float32, as the reference does with JAX x64 off.

Invariant: after every ``add`` the live rows are exactly the Pareto set of
all points ever offered (under minimization, with near-duplicates deduped
at 1e-9 resolution).  ``finalize`` is therefore a plain read.

Shapes are kept bucketed: the backing arrays live at power-of-two capacity
and incoming batches are padded to power-of-two buckets, as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.platform import resolve_device
from .problem import feasible_mask


def _incremental_pass(E: torch.Tensor, alive: torch.Tensor, B: torch.Tensor,
                      bvalid: torch.Tensor):
    """One dense dominance pass of a padded batch against the padded store.

    ``E: (cap, k)`` float32 stored points with live-mask ``alive: (cap,)``;
    ``B: (bb, k)`` float32 new points with validity mask ``bvalid: (bb,)``.
    Returns ``(keep_new: (bb,), still_alive: (cap,))`` — the new points that
    enter the frontier and the stored points that survive them.
    """
    inf = torch.full((), float("inf"), dtype=E.dtype, device=E.device)
    Ei = torch.where(alive[:, None], E, inf)  # dead rows dominate nothing
    Bi = torch.where(bvalid[:, None], B, inf)
    # (1) new vs live frontier: is B_i dominated by any live E_j?
    le = torch.all(Ei[None, :, :] <= Bi[:, None, :], dim=-1)  # (bb, cap)
    lt = torch.any(Ei[None, :, :] < Bi[:, None, :], dim=-1)
    dom_by_live = torch.any(torch.logical_and(le, lt), dim=1)
    # (2) new vs new: within-batch Pareto mask (duplicates were deduped
    # upstream, so equal rows cannot occur and do not dominate each other).
    leb = torch.all(Bi[None, :, :] <= Bi[:, None, :], dim=-1)  # (i, j)
    ltb = torch.any(Bi[None, :, :] < Bi[:, None, :], dim=-1)
    dom_in_batch = torch.any(torch.logical_and(leb, ltb), dim=1)
    keep = torch.logical_and(
        bvalid, ~torch.logical_or(dom_by_live, dom_in_batch))
    # (3) surviving new points retire the live points they dominate.
    Bk = torch.where(keep[:, None], B, inf)
    lek = torch.all(Bk[None, :, :] <= Ei[:, None, :], dim=-1)  # (cap, bb)
    ltk = torch.any(Bk[None, :, :] < Ei[:, None, :], dim=-1)
    killed = torch.any(torch.logical_and(lek, ltk), dim=1)
    return keep, torch.logical_and(alive, ~killed)


def _bucket(n: int, floor: int = 4) -> int:
    """Capacity bucketing via the single shared policy (``exec.bucket``)."""
    from ..exec import bucket

    return bucket(n, base=floor)


class FrontierStore:
    """Grow-on-demand array store with a live incremental Pareto mask.

    ``device`` is where the dominance passes run (``None`` means ``cuda``);
    ``use_kernel`` routes them through the dominator-count kernel."""

    def __init__(self, k: int, dim: int, capacity: int = 256,
                 use_kernel: bool = False,
                 bounds: np.ndarray | None = None, bounds_tol: float = 1e-6,
                 device=None):
        cap = _bucket(capacity, floor=64)
        self.k = int(k)
        self.dim = int(dim)
        self.use_kernel = use_kernel
        self.device = resolve_device(device)
        # Hard value constraints (k, 2) rows (lo, hi), ±inf = open edge.
        # Offers violating them are marked infeasible and excluded — the
        # frontier can never contain a point outside a declared budget cap.
        # Tolerance semantics are shared with MOGD and the baselines via
        # problem.feasible_mask.
        self._bounds = None
        self._bounds_tol = bounds_tol
        if bounds is not None:
            b = np.asarray(bounds, dtype=np.float64).reshape(self.k, 2)
            if np.any(np.isfinite(b)):
                self._bounds = b
        self._F = np.full((cap, self.k), np.inf, dtype=np.float64)
        self._X = np.zeros((cap, self.dim), dtype=np.float64)
        self._alive = np.zeros(cap, dtype=bool)
        self._n = 0  # appended rows (high-water mark, includes dead rows)
        # Dedup keys of LIVE rows only (memory stays O(capacity)): an offer
        # equal to a dead or once-rejected point is re-rejected by the
        # dominance pass anyway — see the transitivity note in ``add``.
        self._keys: set = set()
        self._row_keys: list = []  # key per appended row, aligned with [0, n)
        self.total_offered = 0
        self.total_accepted = 0
        self.total_infeasible = 0  # offers excluded by the value constraints

    # ------------------------------------------------------------------
    # Export/import: the state dict is the exact row history [0, n) —
    # live AND dead rows with the alive mask — so a restored store
    # reproduces the frontier, the pareto mask, the dedup keys, and every
    # counter bit-for-bit.
    def state_dict(self) -> tuple[dict, dict]:
        """Export as ``(arrays, meta)`` numpy arrays and plain values.

        ``arrays`` holds the appended rows ``F/X`` with their ``alive``
        mask (dead rows included: the mask IS the pareto mask) and the
        value-constraint box when declared; ``meta`` holds shapes,
        tolerances, and the offered/accepted/infeasible counters.
        """
        arrays = {
            "F": self._F[: self._n].copy(),
            "X": self._X[: self._n].copy(),
            "alive": self._alive[: self._n].copy(),
        }
        if self._bounds is not None:
            arrays["bounds"] = self._bounds.copy()
        meta = {
            "k": self.k,
            "dim": self.dim,
            "bounds_tol": self._bounds_tol,
            "total_offered": self.total_offered,
            "total_accepted": self.total_accepted,
            "total_infeasible": self.total_infeasible,
        }
        return arrays, meta

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, use_kernel: bool = False,
                   device=None) -> "FrontierStore":
        """Rebuild a store from :meth:`state_dict` output.

        Kernel routing (``use_kernel``) and ``device`` follow the
        *restoring* process's configuration, not the saved one — the stored
        values already carry any fp32 cast applied at add time, so
        continued adds keep the Pareto invariant either way.
        """
        F = np.asarray(arrays["F"], dtype=np.float64)
        n = F.shape[0]
        store = cls(
            k=int(meta["k"]), dim=int(meta["dim"]), capacity=max(n, 1),
            use_kernel=use_kernel, bounds=arrays.get("bounds"),
            bounds_tol=float(meta["bounds_tol"]), device=device)
        store._F[:n] = F
        store._X[:n] = np.asarray(arrays["X"], dtype=np.float64)
        store._alive[:n] = np.asarray(arrays["alive"], dtype=bool)
        store._n = n
        for row, live in zip(np.round(F, 9), store._alive[:n]):
            key = row.tobytes()
            store._row_keys.append(key)
            if live:
                store._keys.add(key)
        store.total_offered = int(meta["total_offered"])
        store.total_accepted = int(meta["total_accepted"])
        store.total_infeasible = int(meta["total_infeasible"])
        return store

    # ------------------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Rows allocated in the backing arrays."""
        return self._F.shape[0]

    @property
    def n_points(self) -> int:
        """Number of live (non-dominated) points."""
        return int(self._alive.sum())

    def __len__(self) -> int:
        """Number of live points."""
        return self.n_points

    def frontier(self) -> tuple[np.ndarray, np.ndarray]:
        """Live Pareto set: ``(F: (N, k), X: (N, D))`` in insertion order."""
        idx = np.nonzero(self._alive)[0]
        return self._F[idx].copy(), self._X[idx].copy()

    # ------------------------------------------------------------------
    def _compact(self) -> None:
        """Drop dead rows in place (they can never re-enter the frontier)."""
        idx = np.nonzero(self._alive[: self._n])[0]
        m = len(idx)
        self._F[:m] = self._F[idx]
        self._X[:m] = self._X[idx]
        self._row_keys = [self._row_keys[r] for r in idx]
        self._F[m: self._n] = np.inf
        self._alive[: self._n] = False
        self._alive[:m] = True
        self._n = m

    def _ensure_capacity(self, extra: int) -> None:
        if self._n + extra <= self.capacity:
            return
        self._compact()
        if self._n + extra <= self.capacity // 2:
            return  # compaction freed enough; keep jit shapes stable
        cap = _bucket(self._n + extra, floor=self.capacity * 2)
        F = np.full((cap, self.k), np.inf, dtype=np.float64)
        X = np.zeros((cap, self.dim), dtype=np.float64)
        alive = np.zeros(cap, dtype=bool)
        F[: self._n] = self._F[: self._n]
        X[: self._n] = self._X[: self._n]
        alive[: self._n] = self._alive[: self._n]
        self._F, self._X, self._alive = F, X, alive

    # ------------------------------------------------------------------
    def _f32(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _kernel_pass(self, Bp: np.ndarray, bvalid: np.ndarray):
        """Dominance pass via the cross-set dominator-count kernel: three
        calls (batch vs live, batch vs batch, live vs kept batch) between
        one upload and one read-back.  The padded live rows, the padded
        batch and the batch's validity travel as one float32 buffer;
        ``keep`` and the kept batch are formed on the device, and ``keep``
        and ``killed`` come back in one copy."""
        from ..kernels.pareto_filter import cross_dominator_counts

        cap, bb, k = len(self._F), len(Bp), self.k
        buf = np.empty((cap + bb) * k + bb, dtype=np.float32)
        buf[: cap * k] = np.where(self._alive[:, None], self._F,
                                  np.inf).ravel()
        buf[cap * k: (cap + bb) * k] = np.where(bvalid[:, None], Bp,
                                                np.inf).ravel()
        buf[(cap + bb) * k:] = bvalid
        dev = torch.as_tensor(buf, device=self.device)
        Ej = dev[: cap * k].view(cap, k)
        Bj = dev[cap * k: (cap + bb) * k].view(bb, k)
        keep = ((dev[(cap + bb) * k:] != 0)
                & (cross_dominator_counts(Bj, Ej) == 0)
                & (cross_dominator_counts(Bj, Bj) == 0))
        Bk = torch.where(keep[:, None], Bj, float("inf"))
        killed = cross_dominator_counts(Ej, Bk) > 0
        back = torch.cat([keep, killed]).cpu().numpy()
        return back[:bb], self._alive & ~back[bb:]

    # ------------------------------------------------------------------
    def add(self, F_new, X_new) -> int:
        """Offer a batch of candidate points; returns how many entered the
        frontier.  ``F_new: (B, k)``, ``X_new: (B, D)`` (or single rows)."""
        F_new = np.atleast_2d(np.asarray(F_new, dtype=np.float64))
        X_new = np.atleast_2d(np.asarray(X_new, dtype=np.float64))
        if F_new.shape[0] != X_new.shape[0]:
            raise ValueError("F/X batch length mismatch")
        if self.use_kernel:
            # The kernel compares in fp32.  Cast offers up front so
            # stored values and dominance comparisons agree exactly — the
            # Pareto invariant then holds at fp32 resolution (points that
            # collide in fp32 dedupe instead of wrongly killing each other).
            F_new = np.float64(np.float32(F_new))
        self.total_offered += F_new.shape[0]
        if self._bounds is not None:
            # mark-and-exclude: infeasible offers never enter the frontier

            ok = feasible_mask(self._bounds, F_new, self._bounds_tol)
            self.total_infeasible += int((~ok).sum())
            if not ok.any():
                return 0
            F_new, X_new = F_new[ok], X_new[ok]
        # Dedupe (within the batch and against the live frontier) at the
        # seed finalize's 1e-9 resolution.  Offers equal to dead or
        # previously rejected points need no keys: their old dominator is
        # either still live or was retired by a point that dominates it too
        # (domination is transitive), so the dominance pass re-rejects them.
        sel, sel_keys = [], []
        seen_local = set()
        for i, row in enumerate(np.round(F_new, 9)):
            key = row.tobytes()
            if (key in self._keys or key in seen_local
                    or not np.all(np.isfinite(row))):
                continue
            seen_local.add(key)
            sel.append(i)
            sel_keys.append(key)
        if not sel:
            return 0
        Fb, Xb = F_new[sel], X_new[sel]
        self._ensure_capacity(len(Fb))
        bb = _bucket(len(Fb))
        Bp = np.full((bb, self.k), np.inf, dtype=np.float64)
        Bp[: len(Fb)] = Fb
        bvalid = np.zeros(bb, dtype=bool)
        bvalid[: len(Fb)] = True
        if self.use_kernel:
            keep, still_alive = self._kernel_pass(Bp, bvalid)
        else:
            keep, still_alive = _incremental_pass(
                self._f32(self._F),
                torch.as_tensor(self._alive, device=self.device),
                self._f32(Bp), torch.as_tensor(bvalid, device=self.device))
            keep = keep.cpu().numpy()
            still_alive = still_alive.cpu().numpy()
        keep = np.asarray(keep)[: len(Fb)]
        still_alive = np.asarray(still_alive).copy()
        for r in np.nonzero(self._alive & ~still_alive)[0]:
            self._keys.discard(self._row_keys[r])  # retired rows free keys
        self._alive = still_alive
        idx = np.nonzero(keep)[0]
        m = len(idx)
        if m:
            rows = slice(self._n, self._n + m)
            self._F[rows] = Fb[idx]
            self._X[rows] = Xb[idx]
            self._alive[self._n: self._n + m] = True
            for i in idx:
                self._keys.add(sel_keys[i])
                self._row_keys.append(sel_keys[i])
            self._n += m
        self.total_accepted += m
        return m
