"""Serving steps.

``prefill_step(params, batch)`` -> (last logits, cache)
``decode_step(params, cache, batch, pos)`` -> (logits, new cache)
"""

from __future__ import annotations

from typing import Callable

from ..nn import ArchConfig
from ..nn import decode_step as _decode
from ..nn import prefill as _prefill


def make_prefill_step(cfg: ArchConfig, max_seq=None) -> Callable:
    def prefill_step(params, batch):
        return _prefill(params, cfg, batch, max_seq=max_seq)

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    def decode_step(params, cache, batch, pos):
        return _decode(params, cfg, cache, batch, pos)

    return decode_step
