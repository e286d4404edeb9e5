"""A small batched serving engine (continuous-batching lite).

Holds a fixed-size slot table; incoming requests are prefilled into free
slots, every ``step()`` decodes one token for all active slots, finished
requests free their slot — slot reuse, per-request positions, greedy or
temperature sampling, as the reference engine.

The engine casts the parameters to the compute dtype once, at
construction, and every prefill and decode step runs on that copy.  Each
slot has its own B=1 cache; attention caches are written in place by
decode, which touches only the slot's own tensors.  Temperature sampling
draws from a ``torch.Generator`` seeded with ``seed``, so its draws differ
from the reference's ``jax.random`` ones by design; greedy sampling is
``argmax``.

With ``rules`` the engine serves a sharded model: the parameters are
DTensors (``distributed.shard_tree``), the prefill and decode steps run
with the rules, each slot's cache and each prompt's tokens are laid out
by their logical axes (a slot's batch of one replicated where it cannot
split over the batch axes), and a token is sampled from the whole logits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..distributed import is_dtensor, shard_tree
from ..kernels.platform import resolve_device
from ..exec import tree_map
from ..nn import ArchConfig, cache_axes, cast_params, init_cache
from ..nn.model import tree_leaves
from .steps import make_decode_step, make_prefill_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int = 32
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Batched decoding over a slot table of size ``batch`` on ``device``
    (None = ``cuda``; the parameters must already live there, as DTensors
    on ``rules.mesh`` when ``rules`` is given)."""

    def __init__(self, params, cfg: ArchConfig, batch: int, max_seq: int,
                 rules=None, temperature: float = 0.0, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        for t in tree_leaves(params):
            if t.device != self.device:
                raise ValueError(f"ServeEngine on {self.device}: parameters "
                                 f"on {t.device}")
        self.params, self.cfg, self.rules = params, cfg, rules
        self.cparams = cast_params(params, cfg.cdtype(), rules)  # cast once
        self.batch, self.max_seq = batch, max_seq
        self.cache = init_cache(cfg, 1, max_seq, device=self.device)
        if rules is not None:  # the layout the rules' prefill returns
            self.cache = shard_tree(rules, self.cache,
                                    cache_axes(cfg, 1, max_seq))
        # one per-slot cache (B=1 each) so prefill/evict are per-slot
        self.slots: list = [None] * batch
        self.pending: list[Request] = []  # admitted, awaiting a slot
        self.slot_cache = [tree_map(torch.clone, self.cache)
                           for _ in range(batch)]
        self.slot_pos = np.zeros(batch, np.int32)
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._decode = make_decode_step(cfg, rules)
        self._prefill = make_prefill_step(cfg, rules, max_seq=max_seq)

    def _tokens(self, ids) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        if self.rules is not None:
            t = shard_tree(self.rules, t, ("batch", None))
        return t

    def _sample(self, logits: torch.Tensor) -> int:
        if is_dtensor(logits):
            logits = logits.full_tensor()
        if self.temperature <= 0:
            return int(torch.argmax(logits))
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.gen))

    def _place(self, req: Request, slot: int) -> None:
        logits, cache = self._prefill(
            self.cparams, {"tokens": self._tokens(req.prompt[None, :])})
        self.slot_cache[slot] = cache
        self.slot_pos[slot] = len(req.prompt)
        req.out.append(self._sample(logits[0]))
        self.slots[slot] = req

    def _drain_pending(self) -> None:
        """Prefill queued requests into free slots — called at the end
        of every ``step()`` so a request admitted while the table was
        full starts decoding the step a slot frees, not one step late."""
        for i in range(self.batch):
            if not self.pending:
                return
            if self.slots[i] is None:
                self._place(self.pending.pop(0), i)

    def submit(self, req: Request) -> bool:
        """Place into a free slot, else queue. Returns True when the
        request started prefill immediately (False — it is pending)."""
        for i in range(self.batch):
            if self.slots[i] is None:
                self._place(req, i)
                return True
        self.pending.append(req)
        return False  # queued; drained into the next freed slot

    def step(self) -> int:
        """Decode one token for every active slot, then drain pending
        requests into any slots this step freed. Returns #active."""
        active = 0
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            active += 1
            tok = self._tokens([[req.out[-1]]])
            logits, self.slot_cache[i] = self._decode(
                self.cparams, self.slot_cache[i], {"tokens": tok},
                int(self.slot_pos[i]))
            self.slot_pos[i] += 1
            req.out.append(self._sample(logits[0]))
            if (len(req.out) >= req.max_new
                    or self.slot_pos[i] >= self.max_seq - 1):
                req.done = True
                self.slots[i] = None
        self._drain_pending()
        return active

    def run(self, requests: list[Request]) -> list[Request]:
        for req in requests:
            self.submit(req)
        while self.pending or any(s is not None for s in self.slots):
            if not self.step() and self.pending:
                raise RuntimeError("engine stalled")
        return requests
