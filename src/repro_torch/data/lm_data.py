"""Token data pipeline for the LM training path.

No real corpus ships with the repository, so the source is synthetic while
the pipeline is real (host iterator -> prefetch thread -> device copy): a
seeded order-1 Markov chain over a Zipf vocabulary, which gives a
learnable (non-uniform transition) distribution, so loss curves descend.
``MarkovCorpus`` draws from numpy exactly as the reference's does, so the
same seeds give the same tokens in both packages.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..distributed import distribute_whole


class MarkovCorpus:
    """Order-1 Markov chain with Zipf marginals and banded transitions."""

    def __init__(self, vocab: int, seed: int = 0, branch: int = 8):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.branch = branch
        # each token deterministically maps to `branch` successors
        self.successors = rng.integers(0, vocab, size=(vocab, branch))
        probs = 1.0 / np.arange(1, branch + 1) ** 1.2
        self.probs = probs / probs.sum()

    def sample(self, rng: np.random.Generator, batch: int,
               seq: int) -> np.ndarray:
        """``(batch, seq)`` int32 tokens drawn from ``rng``."""
        out = np.empty((batch, seq), np.int32)
        tok = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            out[:, t] = tok
            choice = rng.choice(self.branch, size=batch, p=self.probs)
            tok = self.successors[tok, choice]
        return out


class TokenLoader:
    """Prefetching host->device loader.

    A background thread keeps ``prefetch`` batches ready.  ``__next__``
    returns ``{"tokens": ...}``: an int32 tensor on ``device``, placed with
    one non-blocking copy from pinned host memory (pinned in the thread on
    a CUDA device), or the host's numpy array when ``device`` is None.
    Unlike the port's entry points, ``device=None`` here does not mean the
    card: it keeps host arrays, as the reference's ``sharding=None`` does.

    With ``sharding``, a ``(DeviceMesh, placements)`` pair (the
    counterpart of the reference's ``NamedSharding``), the tensor is a
    DTensor with those placements on the mesh's device (``device``, when
    given, must be that device): every rank draws the same batch from the
    same seed and keeps its own shard.
    """

    def __init__(self, corpus: MarkovCorpus, batch: int, seq: int,
                 sharding=None, device=None, prefetch: int = 2,
                 seed: int = 0):
        self.corpus, self.batch, self.seq = corpus, batch, seq
        self.sharding = sharding
        if sharding is not None and device is None:
            device = sharding[0].device_type
        self.device = None if device is None else torch.device(device)
        self._pin = self.device is not None and self.device.type == "cuda"
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._rng = np.random.default_rng(seed)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while not self._stop.is_set():
            arr = self.corpus.sample(self._rng, self.batch, self.seq)
            if self._pin:
                arr = torch.from_numpy(arr).pin_memory()
            try:
                self._q.put(arr, timeout=0.5)
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                arr = self._q.get(timeout=5.0)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise StopIteration
        if self.device is None:
            return {"tokens": arr}
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(arr)
        tokens = arr.to(self.device, non_blocking=True)
        if self.sharding is not None:
            mesh, pl = self.sharding
            tokens = distribute_whole(tokens, mesh, pl)
        return {"tokens": tokens}

    def close(self):
        """Stop the prefetch thread (it exits within its 0.5 s put)."""
        self._stop.set()
