"""Durable frontier plane: content-addressed persistence (DESIGN.md §13).

Three layers, bottom-up:

* :mod:`repro_torch.persist.store` — atomic directory entries (tmp-dir write,
  manifest-last, rename commit, per-file sha256) shared with the
  training checkpointer in ``repro_torch.runtime.checkpoint``.
* :mod:`repro_torch.persist.codecs` — exact round-trip serialization of model
  snapshots, regressors, and workload records (signature-stable: a
  rehydrated registry reproduces the pre-restart task signatures).
* :mod:`repro_torch.persist.vault` — :class:`FrontierVault`, the store the
  service layer talks to: write-behind frontier/model snapshots keyed by
  task signature, tombstone ledger for drift invalidation, warm-restart
  reads.

``MOOService(vault=...)`` and ``ModelRegistry(vault=...)`` wire it in.
The on-disk layout is the reference's, byte for byte, so an entry one
package writes the other reads.
"""

from .store import (
    commit_dir,
    entry_id,
    read_entry,
    sha256_file,
    sweep_tmp,
    write_entry,
)
from .vault import FrontierVault

__all__ = [
    "FrontierVault",
    "commit_dir",
    "entry_id",
    "read_entry",
    "sha256_file",
    "sweep_tmp",
    "write_entry",
]
