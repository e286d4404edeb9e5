"""Self-contained checkpointing of trees of tensors, in the reference's
on-disk format.

Layout:

    <dir>/step_000100/
        manifest.json        # tree structure, shapes, dtypes, shard map,
                             # per-file sha256, step, mesh — written LAST
        shard_00000.npz      # flat {leaf_path: host-local array piece}

Guarantees:
* **Atomic commit** — data files are written into ``step_x.tmp-<nonce>``;
  the manifest is written last and the directory is os.rename'd into
  place (the protocol shared with :mod:`repro_torch.persist.store`, which
  the frontier vault layers on too).  A crash mid-write never yields a
  directory that ``latest_step`` will pick up.
* **Re-save policy** — ``save_checkpoint`` on an existing step raises
  ``FileExistsError`` *before* writing anything (no wasted tmp dir);
  ``overwrite=True`` replaces the step atomically (the old data survives
  until the new commit lands).
* **Async** — ``CheckpointManager.save_async`` snapshots device tensors to
  host (blocking only for the device->host copy) and writes on a
  background thread; training continues.  ``wait()`` joins before the
  next save so at most one write is in flight, and raises a
  :class:`CheckpointError` naming every step whose background write
  failed — interleaved ``save_async`` calls never silently swallow an
  earlier failure.
* **Restore onto the target's device** — ``load_checkpoint`` puts every
  leaf on the device and in the dtype of the matching leaf of ``like_tree``
  (the one-device counterpart of the reference's target shardings).
* **Integrity** — per-file sha256 verified on load.

Trees are nested ``dict`` / ``list`` / ``tuple`` containers of tensors,
numpy arrays or Python scalars; ``None`` is an empty subtree.  Leaf keys
are the reference's: the path of dict keys (sorted) and sequence indices
joined by ``/`` (``params/layers/0/w``), so a checkpoint one package
writes the other loads.  bfloat16 leaves are written as the reference
writes them, two raw bytes an element (numpy ``V2``) with ``"bfloat16"``
as the manifest's dtype, and read back from those bytes into a bfloat16
tensor (numpy itself has no bfloat16: a numpy ``like`` leaf takes the
values cast to its own dtype).
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile
import threading
import time

import numpy as np
import torch

from ..persist.store import commit_dir, sha256_file, sweep_tmp

_BF16 = "bfloat16"


class CheckpointError(RuntimeError):
    """A background checkpoint write failed.

    ``steps`` lists every step whose write failed since the last
    successful :meth:`CheckpointManager.wait`; the first failure is the
    ``__cause__``.
    """

    def __init__(self, failures: list):
        self.steps = [step for step, _ in failures]
        super().__init__(
            f"checkpoint write failed for step(s) {self.steps}: "
            f"{failures[0][1]!r}")


def _leaves(tree, path: tuple = ()):
    """``(path, leaf)`` pairs of a dict/list/tuple tree in the reference's
    order: dict keys sorted, sequences in order, ``None`` an empty
    subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _treedef(tree) -> str:
    """The tree's structure in the reference's ``PyTreeDef`` notation
    (``*`` a leaf), kept in the manifest for the reader's eye."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    """One leaf as the numpy array the npz holds (bf16 as raw ``V2``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype is torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray, leaf) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype is torch.bfloat16:
        return _BF16
    return str(arr.dtype)


def save_checkpoint(directory: str | os.PathLike, step: int, tree,
                    extra: dict | None = None,
                    overwrite: bool = False) -> pathlib.Path:
    """Synchronous atomic save; returns the committed directory.

    An existing step raises ``FileExistsError`` up front — before any
    tmp-dir write — unless ``overwrite=True``, which replaces the step
    via the atomic rename-aside/rename-in/delete dance (a crash mid-swap
    keeps the old step loadable).
    """
    base = pathlib.Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    if final.exists() and not overwrite:
        # short-circuit BEFORE writing the tmp dir: a refused re-save
        # must not cost a full serialization pass (or leak tmp data)
        raise FileExistsError(final)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=final.name + ".tmp-",
                                        dir=base))
    try:
        pairs = [(_key(path), leaf) for path, leaf in _leaves(tree)]
        flat = {k: _to_host(leaf) for k, leaf in pairs}
        shard_file = tmp / "shard_00000.npz"
        np.savez(shard_file, **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": {k: {"shape": list(flat[k].shape),
                           "dtype": _dtype_name(flat[k], leaf)}
                       for k, leaf in pairs},
            "shards": {"shard_00000.npz": sha256_file(shard_file)},
            "treedef": f"PyTreeDef({_treedef(tree)})",
            "extra": extra or {},
        }
        # manifest last => a readable manifest implies complete data
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        return commit_dir(tmp, final, overwrite=overwrite)
    except BaseException:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(directory: str | os.PathLike) -> int | None:
    """The newest committed (manifest-bearing) step, or None."""
    base = pathlib.Path(directory)
    if not base.exists():
        return None
    steps = []
    for d in base.iterdir():
        if d.is_dir() and d.name.startswith("step_") and \
                (d / "manifest.json").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def _leaf_like(arr: np.ndarray, stored: str, like):
    """A stored array as a leaf like ``like``: a tensor on its device and
    in its dtype, or a numpy array in its dtype."""
    if stored == _BF16 or arr.dtype == np.dtype("V2"):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = None
    if isinstance(like, torch.Tensor):
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(device=like.device, dtype=like.dtype)
    if t is not None:
        return t.float().numpy().astype(np.asarray(like).dtype)
    return arr.astype(np.asarray(like).dtype)


def load_checkpoint(directory: str | os.PathLike, like_tree,
                    step: int | None = None, verify: bool = True):
    """Load into the structure of ``like_tree``: every leaf lands on the
    device and in the dtype of its ``like`` leaf."""
    base = pathlib.Path(directory)
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {base}")
    d = base / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if verify:
        for fname, digest in manifest["shards"].items():
            actual = sha256_file(d / fname)
            if actual != digest:
                raise IOError(f"checksum mismatch in {d / fname}")
    with np.load(d / "shard_00000.npz") as z:
        flat = {k: z[k] for k in z.files}

    leaves = manifest.get("leaves", {})
    out = []
    for path, like in _leaves(like_tree):
        key = _key(path)
        if key not in flat:
            raise KeyError(f"leaf {key} missing from checkpoint")
        arr = flat[key]
        shape = tuple(like.shape) if hasattr(like, "shape") else ()
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape} != target {shape}")
        out.append(_leaf_like(arr, leaves.get(key, {}).get("dtype", ""),
                              like))
    return _rebuild(like_tree, iter(out)), manifest


class CheckpointManager:
    """Async checkpointing with retention.

    At most one background write in flight; ``save_async`` first snapshots
    to host memory (device->host copy is the only blocking part), then the
    writer thread does the npz+manifest+rename dance.

    Failure semantics: a failed background write is recorded with its
    step and raised — as :class:`CheckpointError` — by the next
    ``wait()`` (which ``save_async`` calls first).  Multiple failures
    across interleaved ``save_async`` calls accumulate rather than
    overwrite, so no failure is ever silently swallowed; after the raise
    the manager is clean and usable again.
    """

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._errors: list[tuple[int, BaseException]] = []
        self._elock = threading.Lock()

    def wait(self) -> None:
        """Join the in-flight write; raise :class:`CheckpointError` if any
        background save failed since the last successful wait."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._elock:
            failures, self._errors = self._errors, []
        if failures:
            raise CheckpointError(failures) from failures[0][1]

    def save_async(self, step: int, tree, extra: dict | None = None,
                   overwrite: bool = False) -> None:
        """Snapshot ``tree`` to host and write it on a background thread.

        Calls :meth:`wait` first, so an earlier failed write raises HERE
        (with its own step attributed) before this save starts — the
        caller always learns about a failure no later than its next
        checkpoint attempt.
        """
        self.wait()
        # snapshot now: the device->host copy is the only blocking part
        host_tree = _rebuild(tree, iter(
            leaf.detach().cpu().clone() if isinstance(leaf, torch.Tensor)
            else np.array(leaf) for _, leaf in _leaves(tree)))

        def _work():
            try:
                save_checkpoint(self.dir, step, host_tree, extra,
                                overwrite=overwrite)
                self._gc()
            except BaseException as e:  # noqa: BLE001
                with self._elock:
                    self._errors.append((step, e))

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        import shutil

        steps = sorted(
            int(d.name.split("_")[1]) for d in self.dir.iterdir()
            if d.is_dir() and d.name.startswith("step_")
            and (d / "manifest.json").exists())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
        # sweep orphaned tmp/old dirs from crashed writers
        sweep_tmp(self.dir)

    def restore_latest(self, like_tree):
        """Load the newest step into ``like_tree``'s structure."""
        return load_checkpoint(self.dir, like_tree)
