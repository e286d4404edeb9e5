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
That engine runs its steps eagerly.

Without ``rules``, on the card a slot's decode step runs as a CUDA graph
(``kernels.graphs``), the counterpart of the reference's
``jax.jit(decode_step)``: captured at the slot's first decode and
replayed at every decode of the slot, for every request it serves.  Its
static inputs are the token and the position (a ``(1, 1)`` and a 0-d
int64 tensor, filled before each replay); it reads and writes the slot's
own cache leaves in place, the new recurrent state (``S``, ``x_tm``,
``x_cm``, ``h``, ``conv``, ``moe_counts``) copied back into them, so the
leaves keep their addresses for the engine's life.  The warm-up before
the capture runs on clones of the slot's cache: the live state advances
once a step, at the replay.  A prefill runs eagerly (one call a request,
at a prompt length that rarely repeats exactly), and its cache, all
``max_seq`` positions, is copied into the slot's leaves (on the host
route too), so a reused slot holds what a fresh prefill gives.

The engine's decode graphs share one memory pool: they replay one at a
time on one stream, and a replay's logits are cloned before the next.
Routes count ``serve:decode:eager`` (a warm-up before a capture) and
``serve:decode:graph`` (a call answered by a replay); capture seconds go
to ``graphs.CAPTURE_S["serve"]`` and the kernels' launches to the
captures' tallies, which each replay adds, so the launch counts of a run
are the eager route's.  A step that syncs with the host cannot be
captured and raises; nothing falls back to eager on the card.  The route
is fixed at construction.  On the host the same step closure runs
eagerly, and the steps are ``self._prefill(params, batch)`` and
``self._decode(params, cache, batch, pos)`` on both routes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..distributed import is_dtensor, shard_tree
from ..exec import tree_map
from ..kernels import graphs
from ..kernels.platform import ROUTES, resolve_device
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


class _Graph:
    """A captured step and its static input buffers."""

    def __init__(self, captured: graphs.Captured, *inputs: torch.Tensor):
        self.captured = captured
        self.inputs = inputs


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` for a cache leaf; a step's leaf written in place
    (an attention cache) is ``dst`` itself."""
    if src is dst:
        return
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"a step's cache leaf is {tuple(src.shape)} "
                         f"{src.dtype}, the slot's {tuple(dst.shape)} "
                         f"{dst.dtype}")
    dst.copy_(src)


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
        # the graph route: the card, without rules
        self._graphs = rules is None and graphs.captures(self.device)
        self.decode_graphs: list[_Graph | None] = [None] * batch
        self._pool = None  # the memory pool the decode graphs share

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

    # -- the steps ----------------------------------------------------------

    def _decode_fn(self, cache, tok, pos):
        """The closure of one decode step of a slot over ``cache`` (its
        leaves updated in place): ``() -> (logits (1, vocab),)``."""
        def step():
            logits, new = self._decode(self.cparams, cache, {"tokens": tok},
                                       pos)
            tree_map(_copy_into, cache, new)
            return (logits,)

        return step

    def _decode_call(self, slot: int, token: int) -> torch.Tensor:
        """Decode ``token`` in ``slot`` at ``slot_pos[slot]``; the slot's
        cache is updated in place.  Returns the logits (1, vocab), the
        caller's own: a replay's are cloned out of the shared pool."""
        pos = int(self.slot_pos[slot])
        cache = self.slot_cache[slot]
        if not self._graphs:
            tok = self._tokens([[token]])
            if self.rules is not None:
                logits, self.slot_cache[slot] = self._decode(
                    self.cparams, cache, {"tokens": tok}, pos)
                return logits
            return self._decode_fn(cache, tok, pos)()[0]
        g = self.decode_graphs[slot]
        if g is None:
            tok = torch.full((1, 1), token, dtype=torch.int64,
                             device=self.device)
            pos_t = torch.full((), pos, dtype=torch.int64,
                               device=self.device)
            with graphs.building(self.device) as stream:
                # the warm-up runs on clones, made on the side stream: the
                # live state advances once, at the replay
                graphs.warm_up(stream, lambda: self._decode_fn(
                    tree_map(torch.clone, cache), tok, pos_t)())
                captured = graphs.capture(
                    self._decode_fn(cache, tok, pos_t), stream, self.device,
                    f"the decode step of slot {slot}", route="serve",
                    pool=self._pool)
            if self._pool is None:
                self._pool = captured.graph.pool()
            g = self.decode_graphs[slot] = _Graph(captured, tok, pos_t)
            ROUTES["serve:decode:eager"] += 1
        tok, pos_t = g.inputs
        tok.fill_(token)
        pos_t.fill_(pos)
        ROUTES["serve:decode:graph"] += 1
        return g.captured.replay()[0].clone()

    def graph_stats(self) -> dict:
        """The engine's decode graphs: how many, their nodes and capture
        seconds, and the bytes of their shared pool (read from the
        allocator)."""
        caps = [g.captured for g in self.decode_graphs if g is not None]
        return {"decode_graphs": len(caps),
                "decode_nodes": [c.nodes for c in caps],
                "decode_capture_s": [c.capture_s for c in caps],
                "pool_bytes": caps[0].pool_bytes if caps else 0}

    # -- the slot table -----------------------------------------------------

    def _place(self, req: Request, slot: int) -> None:
        tokens = self._tokens(req.prompt[None, :])
        logits, cache = self._prefill(self.cparams, {"tokens": tokens})
        if self.rules is not None:
            self.slot_cache[slot] = cache
        else:  # every position: a reused slot holds a fresh prefill's bits
            tree_map(_copy_into, self.slot_cache[slot], cache)
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
            logits = self._decode_call(i, req.out[-1])
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
