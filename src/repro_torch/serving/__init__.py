"""Serving substrate: prefill / decode step functions over the KV cache,
plus a batched request-scheduling loop."""

from .steps import make_decode_step, make_prefill_step
from .engine import ServeEngine, Request

__all__ = ["Request", "ServeEngine", "make_decode_step", "make_prefill_step"]
