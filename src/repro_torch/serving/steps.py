"""Serving steps.

``prefill_step(params, batch)`` -> (last logits, cache)
``decode_step(params, cache, batch, pos)`` -> (logits, new cache)

With ``rules`` the steps run sharded: parameters and caches are DTensors
laid out by their logical axes (``distributed.shard_tree``), the
prompt's cache comes back in the decode cache's layout (the sequence dim
over ``seq_shard``), as the reference's ``out_shardings`` put it.
"""

from __future__ import annotations

from typing import Callable

from ..distributed import constrain_tree
from ..nn import ArchConfig, cache_axes
from ..nn import decode_step as _decode
from ..nn import prefill as _prefill


def make_prefill_step(cfg: ArchConfig, rules=None, max_seq=None) -> Callable:
    def prefill_step(params, batch):
        logits, cache = _prefill(params, cfg, batch, rules, max_seq=max_seq)
        if rules is not None and cache is not None:
            B, S = logits.shape[0], max_seq or _seq_len(batch)
            cache = constrain_tree(rules, cache, cache_axes(cfg, B, S))
        return logits, cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, rules=None) -> Callable:
    def decode_step(params, cache, batch, pos):
        return _decode(params, cfg, cache, batch, pos, rules)

    return decode_step


def _seq_len(batch: dict) -> int:
    x = batch["tokens"] if "tokens" in batch else batch["embeds"]
    return x.shape[1]
