"""FrontierVault: the content-addressed durable store (DESIGN.md §13).

Layout (all entries use the :mod:`repro_torch.persist.store` atomic protocol)::

    <root>/
        frontiers/
            <entry-id>/            # data.npz + manifest.json
            _tombstones.json       # invalidation ledger (atomic replace)
        models/
            <workload-sig>/        # one entry per workload record

Key schema — an entry id is ``entry_id(task_signature)``.  Since a
modelserver task signature already hashes ``(workload signature, model
version)`` through ``TaskSpec.model_id``, the single id is equivalent to
the full ``(task signature, workload signature, model version)`` triple;
the manifest ``meta`` carries the workload/version components explicitly
so invalidation and seed-donor lookups can scan by workload without
recomputing any signature.

Lifecycle:

* **put** — write-behind by default: exports are enqueued (numpy copies,
  made under the caller's lock) and a single daemon writer commits them;
  ``flush()`` drains the queue.  Puts against a tombstoned key — or a
  tombstoned ``(workload, version<=watermark)`` regime — are *refused*,
  so a late flush of a drift-invalidated session can never resurrect a
  dead frontier.
* **tombstone** — drift invalidation calls
  :meth:`tombstone_workload` *synchronously*: matching entries are
  deleted, their keys recorded in the ledger, and the workload's version
  watermark raised.  A restarted replica consults the ledger before
  serving, so a stale frontier never warm-starts a new regime.
* **get** — reads verify per-file sha256 by default; a missing,
  tombstoned, or corrupt entry returns ``None`` / raises ``IOError``
  respectively.
"""

from __future__ import annotations

import itertools
import json
import os
import pathlib
import queue
import shutil
import threading
import time
import warnings

from . import store

_vault_ids = itertools.count()  # per-instance metric label suffix

_SENTINEL = object()
_TOMBSTONE_FILE = "_tombstones.json"


class FrontierVault:
    """Durable, content-addressed frontier + model-snapshot store.

    Thread-safe: disk mutations and ledger updates run under one lock;
    the write-behind worker is a single daemon thread, so entry commits
    are serialized (last write wins via atomic replace).
    """

    def __init__(self, root: str | os.PathLike, verify: bool = True,
                 write_behind: bool = True, obs=None):
        self.root = pathlib.Path(root)
        self.verify = verify
        self.write_behind = write_behind
        self.frontiers_dir = self.root / "frontiers"
        self.models_dir = self.root / "models"
        self.frontiers_dir.mkdir(parents=True, exist_ok=True)
        self.models_dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()
        self._queue: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        # typed write-path counters (DESIGN.md §14); the int ``writes``
        # / ``write_errors`` / ``puts_refused`` attributes stay as
        # read-only views over the registry.
        from ..obs import Observability

        self.obs = obs if obs is not None else Observability()
        m = self.obs.metrics
        self._labels = {"vault": f"v{next(_vault_ids)}"}
        self._c_writes = m.counter(
            "vault.writes", self._labels, help="committed entry writes")
        self._c_write_errors = m.counter(
            "vault.write_errors", self._labels,
            help="writes swallowed by the writer (readers just miss)")
        self._c_puts_refused = m.counter(
            "vault.puts_refused", self._labels,
            help="puts refused by the tombstone ledger")
        # crash hygiene + ledger load happen at open
        self.swept_tmp = (store.sweep_tmp(self.frontiers_dir)
                          + store.sweep_tmp(self.models_dir))
        self._tombstones = self._load_tombstones()

    # legacy int counter surface: views over the registry ------------------
    @property
    def writes(self) -> int:
        return int(self._c_writes.value)

    @property
    def write_errors(self) -> int:
        return int(self._c_write_errors.value)

    @property
    def puts_refused(self) -> int:
        return int(self._c_puts_refused.value)

    # -- tombstone ledger ---------------------------------------------
    def _ledger_path(self) -> pathlib.Path:
        return self.frontiers_dir / _TOMBSTONE_FILE

    def _load_tombstones(self) -> dict:
        path = self._ledger_path()
        if not path.exists():
            return {"keys": {}, "workloads": {}}
        try:
            return json.loads(path.read_text())
        except (OSError, ValueError):
            warnings.warn(f"unreadable tombstone ledger {path}; "
                          f"starting empty", RuntimeWarning, stacklevel=2)
            return {"keys": {}, "workloads": {}}

    def _save_tombstones_locked(self) -> None:
        path = self._ledger_path()
        tmp = path.with_name(path.name + f".tmp-{os.getpid()}")
        tmp.write_text(json.dumps(self._tombstones, indent=1))
        os.replace(tmp, path)

    def _refused_locked(self, key: str, workload, version) -> bool:
        """True iff a put under this identity must be rejected."""
        if key in self._tombstones["keys"]:
            return True
        if workload is not None:
            mark = self._tombstones["workloads"].get(workload)
            if mark is not None and (version is None
                                     or int(version) <= int(mark)):
                return True
        return False

    # -- frontier entries ---------------------------------------------
    @staticmethod
    def frontier_key(task_sig: str) -> str:
        """The entry id of one task signature."""
        return store.entry_id("frontier", task_sig)

    def put_frontier(self, task_sig: str, arrays: dict, meta: dict,
                     workload: str | None = None,
                     version: int | None = None,
                     wait: bool = False) -> bool:
        """Persist one exported PF state under its task signature.

        Returns False (and writes nothing) when the identity is
        tombstoned.  ``wait=True`` commits synchronously; otherwise the
        write-behind worker commits it (see :meth:`flush`).
        """
        key = self.frontier_key(task_sig)
        with self._lock:
            if self._refused_locked(key, workload, version):
                self._c_puts_refused.inc()
                return False
        meta = dict(meta)
        meta.update(task_sig=task_sig, workload=workload,
                    version=version, saved_at=time.time())
        job = ("frontier", key, dict(arrays), meta, workload, version)
        if wait or not self.write_behind:
            self._commit(job)
        else:
            self._enqueue(job)
        return True

    def get_frontier(self, task_sig: str) -> tuple[dict, dict] | None:
        """Load the persisted state for one task signature, or None when
        absent or tombstoned.  Verifies checksums when ``verify``."""
        key = self.frontier_key(task_sig)
        with self._lock:
            if key in self._tombstones["keys"]:
                return None
            path = self.frontiers_dir / key
            if not store.is_entry(path):
                return None
            return store.read_entry(path, verify=self.verify)

    def frontier_entries(self) -> list[dict]:
        """The manifest ``meta`` of every committed frontier entry."""
        with self._lock:
            out = []
            for d in sorted(self.frontiers_dir.iterdir()):
                if store.is_entry(d):
                    out.append(store.read_manifest(d)["meta"])
            return out

    def latest_for_workload(self, workload: str,
                            exclude_version: int | None = None
                            ) -> tuple[dict, dict] | None:
        """The highest-version surviving entry for a workload — the seed
        donor for a session whose model has moved past every persisted
        frontier (warm start via ``ProgressiveFrontier.seed``)."""
        with self._lock:
            best, best_v = None, None
            for d in self.frontiers_dir.iterdir():
                if not store.is_entry(d):
                    continue
                meta = store.read_manifest(d)["meta"]
                if meta.get("workload") != workload:
                    continue
                v = meta.get("version")
                if exclude_version is not None and v == exclude_version:
                    continue
                if best is None or (v or 0) > (best_v or 0):
                    best, best_v = d, v
            if best is None:
                return None
            return store.read_entry(best, verify=self.verify)

    def tombstone_workload(self, workload: str,
                           version: int | None = None,
                           reason: str = "drift") -> int:
        """Invalidate every persisted frontier of a workload (synchronous).

        Entries are deleted, their keys enter the ledger, and the
        workload's version watermark rises to ``version`` (or the highest
        version seen among the killed entries) — so a late write-behind
        put from the dead regime is refused, while entries minted after
        the next promotion (higher version ⇒ new task signature) pass.
        Returns the number of entries killed.
        """
        with self._lock:
            killed = 0
            high = -1 if version is None else int(version)
            for d in list(self.frontiers_dir.iterdir()):
                if not store.is_entry(d):
                    continue
                meta = store.read_manifest(d)["meta"]
                if meta.get("workload") != workload:
                    continue
                v = meta.get("version")
                if v is not None:
                    high = max(high, int(v))
                self._tombstones["keys"][d.name] = {
                    "workload": workload, "version": v,
                    "reason": reason, "time": time.time()}
                shutil.rmtree(d, ignore_errors=True)
                killed += 1
            if high >= 0:
                mark = self._tombstones["workloads"].get(workload, -1)
                self._tombstones["workloads"][workload] = max(
                    int(mark), high)
            if killed or version is not None:
                self._save_tombstones_locked()
            return killed

    # -- model entries -------------------------------------------------
    def put_model(self, workload: str, arrays: dict, meta: dict,
                  wait: bool = False) -> None:
        """Persist one workload record (snapshot lineage + traces)."""
        meta = dict(meta)
        meta.update(saved_at=time.time())
        job = ("model", workload, dict(arrays), meta, None, None)
        if wait or not self.write_behind:
            self._commit(job)
        else:
            self._enqueue(job)

    def get_model(self, workload: str) -> tuple[dict, dict] | None:
        """Load one persisted workload record, or None when absent."""
        path = self.models_dir / workload
        with self._lock:
            if not store.is_entry(path):
                return None
            return store.read_entry(path, verify=self.verify)

    def model_workloads(self) -> list[str]:
        """Signatures of every persisted workload record."""
        with self._lock:
            return sorted(d.name for d in self.models_dir.iterdir()
                          if store.is_entry(d))

    # -- write-behind machinery ---------------------------------------
    def _enqueue(self, job) -> None:
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._drain, name="frontier-vault-writer",
                    daemon=True)
                self._worker.start()
        self._queue.put(job)

    def _drain(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if job is _SENTINEL:
                    return
                self._commit(job)
            finally:
                self._queue.task_done()

    def _commit(self, job) -> None:
        kind, key, arrays, meta, workload, version = job
        base = self.frontiers_dir if kind == "frontier" else self.models_dir
        tr = self.obs.tracer
        t0 = tr.now()
        try:
            with self._lock:
                if kind == "frontier" and self._refused_locked(
                        key, workload, version):
                    self._c_puts_refused.inc()
                    return
                store.write_entry(base, key, arrays, meta, overwrite=True)
                self._c_writes.inc()
        except BaseException:  # noqa: BLE001 — a failed write must not
            with self._lock:   # kill the writer thread; readers just miss
                self._c_write_errors.inc()
        finally:
            if tr.enabled:
                tr.record_span("vault.commit", t0, tr.now(), cat="vault",
                               args={"kind": kind, "key": key})

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every queued write has committed."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._queue.unfinished_tasks == 0:
                return True
            time.sleep(0.005)
        return False

    def close(self) -> None:
        """Flush pending writes and stop the writer thread."""
        self.flush()
        with self._lock:
            worker = self._worker
            self._worker = None
        if worker is not None and worker.is_alive():
            self._queue.put(_SENTINEL)
            worker.join(timeout=10.0)

    def __enter__(self) -> "FrontierVault":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- telemetry -----------------------------------------------------
    def stats(self) -> dict:
        """Entry counts + write/refusal counters (one consistent view)."""
        with self._lock:
            return {
                "frontier_entries": sum(
                    1 for d in self.frontiers_dir.iterdir()
                    if store.is_entry(d)),
                "model_entries": sum(
                    1 for d in self.models_dir.iterdir()
                    if store.is_entry(d)),
                "tombstoned_keys": len(self._tombstones["keys"]),
                "tombstoned_workloads": len(self._tombstones["workloads"]),
                "writes": self.writes,
                "write_errors": self.write_errors,
                "puts_refused": self.puts_refused,
                "pending_writes": self._queue.unfinished_tasks,
            }
