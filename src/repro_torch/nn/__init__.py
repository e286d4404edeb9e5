"""Model substrate: GQA attention (RoPE, qk-norm), RWKV-6 (Finch), Mamba
(S6), MoE FFNs, norms, blocks over a loop of layers, and the LM assembly
with its training loss, its prefill and decode entry points, its
abstract (``meta``) trees and its logical-axes trees, for all ten
architectures.

Parameters are nested dicts of tensors; ``nn.convert`` carries the JAX
package's parameters and caches across.
"""

from .config import (
    SHAPES,
    ArchConfig,
    HybridConfig,
    MambaConfig,
    MoEConfig,
    RWKVConfig,
    ShapeSpec,
)
from .model import (
    abstract_cache,
    abstract_params,
    cache_axes,
    cache_max_seq,
    cast_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    param_axes,
    prefill,
)

__all__ = [
    "SHAPES", "ArchConfig", "HybridConfig", "MambaConfig", "MoEConfig",
    "RWKVConfig", "ShapeSpec", "abstract_cache", "abstract_params",
    "cache_axes", "cache_max_seq", "cast_params", "decode_step", "forward",
    "init_cache", "init_params", "loss_fn", "param_axes", "prefill",
]
