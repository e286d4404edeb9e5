"""Atomic, integrity-checked directory entries — the durability primitive.

One *entry* is a directory holding a single ``data.npz`` (flat
``{name: array}``) plus a ``manifest.json`` carrying per-file sha256
digests and a JSON ``meta`` payload.  The commit protocol is the one
proven in ``repro_torch.runtime.checkpoint`` and is shared with it:

1. data files are written into a sibling ``<final>.tmp-<nonce>`` dir;
2. the manifest is written LAST — a readable manifest implies the data
   files are complete;
3. the tmp dir is ``os.rename``'d into place (atomic on POSIX).

A crash at any point leaves either the previous committed entry or an
orphaned ``.tmp-`` dir that :func:`sweep_tmp` removes — never a
half-written entry that a reader could load.  Overwrites rename the old
entry aside first and roll it back if the swap fails, so a committed
entry is never lost to a failed replace.

This module is dependency-free (stdlib + numpy) so both the training
checkpointer and the frontier vault can layer on it.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import tempfile
import time

import numpy as np

DATA_FILE = "data.npz"
MANIFEST_FILE = "manifest.json"


def sha256_file(path: str | os.PathLike) -> str:
    """Streaming sha256 hex digest of one file."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def entry_id(*parts) -> str:
    """Content-addressed entry name: sha256 over the ``repr`` of the key
    parts (stable across processes — no ``id()``, no hash randomization)."""
    payload = "||".join(repr(p) for p in parts)
    return hashlib.sha256(payload.encode()).hexdigest()[:32]


def commit_dir(tmp: pathlib.Path, final: pathlib.Path,
               overwrite: bool = False) -> pathlib.Path:
    """Atomically publish a fully-written tmp dir as ``final``.

    With ``overwrite=False`` an existing ``final`` raises
    ``FileExistsError`` (the tmp dir is cleaned up).  With
    ``overwrite=True`` the old entry is renamed aside, the tmp dir is
    renamed in, and only then is the old entry deleted — a failure
    mid-swap restores the original.
    """
    tmp, final = pathlib.Path(tmp), pathlib.Path(final)
    if final.exists():
        if not overwrite:
            shutil.rmtree(tmp, ignore_errors=True)
            raise FileExistsError(final)
        aside = final.with_name(
            final.name + ".old-" + next(tempfile._get_candidate_names()))
        os.rename(final, aside)
        try:
            os.rename(tmp, final)
        except BaseException:
            os.rename(aside, final)  # roll back: keep the committed entry
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        shutil.rmtree(aside, ignore_errors=True)
    else:
        os.rename(tmp, final)
    return final


def sweep_tmp(base: str | os.PathLike) -> int:
    """Remove orphaned ``.tmp-`` / ``.old-`` dirs left by crashed writers.

    Returns how many were swept.  Safe to call concurrently with reads:
    committed entries are never touched.
    """
    base = pathlib.Path(base)
    if not base.exists():
        return 0
    n = 0
    for d in base.iterdir():
        if d.is_dir() and (".tmp-" in d.name or ".old-" in d.name):
            shutil.rmtree(d, ignore_errors=True)
            n += 1
    return n


def write_entry(base: str | os.PathLike, name: str,
                arrays: dict, meta: dict,
                overwrite: bool = True) -> pathlib.Path:
    """Commit one entry ``<base>/<name>`` via the atomic protocol.

    ``arrays`` maps flat names to numpy arrays (saved as one npz);
    ``meta`` must be JSON-serializable.  Returns the committed path.
    """
    base = pathlib.Path(base)
    base.mkdir(parents=True, exist_ok=True)
    final = base / name
    if final.exists() and not overwrite:
        raise FileExistsError(final)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=name + ".tmp-", dir=base))
    try:
        data = tmp / DATA_FILE
        np.savez(data, **{k: np.asarray(v) for k, v in arrays.items()})
        manifest = {
            "time": time.time(),
            "files": {DATA_FILE: sha256_file(data)},
            "meta": meta,
        }
        # manifest last => a readable manifest implies complete data
        (tmp / MANIFEST_FILE).write_text(json.dumps(manifest, indent=1))
        return commit_dir(tmp, final, overwrite=overwrite)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def is_entry(path: str | os.PathLike) -> bool:
    """True iff ``path`` is a committed (manifest-bearing) entry dir."""
    path = pathlib.Path(path)
    return path.is_dir() and (path / MANIFEST_FILE).exists()


def read_manifest(path: str | os.PathLike) -> dict:
    """The manifest of a committed entry (raises if absent)."""
    return json.loads(
        (pathlib.Path(path) / MANIFEST_FILE).read_text())


def read_entry(path: str | os.PathLike,
               verify: bool = True) -> tuple[dict, dict]:
    """Load one committed entry: returns ``(arrays, meta)``.

    ``verify=True`` checks every data file against its manifest sha256
    and raises ``IOError`` on mismatch (bit-rot / torn copy detection).
    """
    path = pathlib.Path(path)
    manifest = read_manifest(path)
    if verify:
        for fname, digest in manifest["files"].items():
            actual = sha256_file(path / fname)
            if actual != digest:
                raise IOError(f"checksum mismatch in {path / fname}")
    with np.load(path / DATA_FILE) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, manifest["meta"]
