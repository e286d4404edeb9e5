"""Primitive layers + parameter init.

Parameters are nested dicts of tensors.  Each ``param`` call names its
logical sharding axes, as the reference's ``PV`` leaves carry them; the
axes are not stored beside the values but built as a tree of their own
(``nn.param_axes``, through :class:`AxesGen`).  Every random parameter is
drawn from an explicit ``torch.Generator`` on the device the parameters
live on, in the order the reference draws them; the draws differ from
``jax.random``'s by design, so parity tests carry the reference's weights
across (``nn.convert``).
"""

from __future__ import annotations

import math

import torch

from ..distributed import constrain


class MetaGen:
    """Stands in for a ``torch.Generator`` where parameters are only
    described (``nn.model.abstract_params``): it draws nothing."""

    device = torch.device("meta")


class AxesGen:
    """Stands in for a ``torch.Generator`` where only the parameters'
    logical axes are wanted (``nn.model.param_axes``): each ``param`` call
    gives its axes tuple."""


def param(gen: torch.Generator, shape: tuple, axes: tuple,
          dtype: torch.dtype, init: str = "normal",
          scale: float | None = None) -> torch.Tensor:
    """One parameter on ``gen``'s device: ``normal`` (std ``1/sqrt(fan_in)``
    unless ``scale``), ``uniform`` in ``[-scale, scale]`` (default 1),
    ``zeros`` or ``ones``; random draws are float32, then cast.  On the
    ``meta`` device (``gen`` a :class:`MetaGen`) every kind is an empty
    tensor of the shape and dtype, which allocates nothing.  ``axes`` names
    each dimension's logical axis; with ``gen`` an :class:`AxesGen` they
    are what is returned."""
    assert len(shape) == len(axes), (shape, axes)
    if isinstance(gen, AxesGen):
        return tuple(axes)
    dev = gen.device
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if init == "normal":
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        v = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev) * s
        return v.to(dtype)
    if init == "uniform":
        s = scale if scale is not None else 1.0
        v = torch.rand(shape, generator=gen, dtype=torch.float32, device=dev)
        return (v * (2 * s) - s).to(dtype)
    raise ValueError(init)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(gen: torch.Generator, dim: int, dtype) -> dict:
    return {"scale": param(gen, (dim,), (None,), dtype, init="ones")}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in float32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings (NeoX half-rotation)
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S).  Rotated in
    float32, cast back to ``x``'s dtype."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations, op by op as the reference writes them
# ---------------------------------------------------------------------------
#
# In bfloat16 the reference rounds after every elementwise op of
# ``jax.nn.sigmoid`` (1 / (1 + exp(-x))), ``silu`` (x * sigmoid(x)) and the
# tanh ``gelu``, with its constants rounded to the input dtype; torch's fused
# versions round once.  These spell out the reference's ops so the bf16
# paths round where the reference rounds (in float32 both agree to an ulp).


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation (``jax.nn.gelu``'s default)."""
    c = x.new_tensor(math.sqrt(2 / math.pi))
    cubic = x.new_tensor(0.044715) * (x * x * x)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + cubic))))


# ---------------------------------------------------------------------------
# Dense MLPs
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, f: int, activation: str,
             dtype) -> dict:
    w_axes = ("d_model", "d_ff")
    p = {"w1": param(gen, (d, f), w_axes, dtype)}
    if activation == "swiglu":
        p["w3"] = param(gen, (d, f), w_axes, dtype)
    p["w2"] = param(gen, (f, d), ("d_ff", "d_model_out"), dtype)
    return p


def mlp(p: dict, x: torch.Tensor, activation: str,
        rules=None) -> torch.Tensor:
    """SwiGLU or (tanh-approximated, as ``jax.nn.gelu``) GELU MLP."""
    if activation == "swiglu":
        h = silu(x @ p["w1"]) * (x @ p["w3"])
    elif activation == "gelu":
        h = gelu(x @ p["w1"])
    else:
        raise ValueError(activation)
    h = constrain(h, rules, "batch", None, "act_ff")
    return h @ p["w2"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> dict:
    return {"tok": param(gen, (vocab, d), ("vocab", "d_model"), dtype,
                         scale=0.02)}


def embed(p: dict, tokens: torch.Tensor, rules=None) -> torch.Tensor:
    """The rows of ``p["tok"]`` at ``tokens``.  A table sharded on the
    vocab is gathered whole on that dim first: DTensor's vocab-parallel
    gather leaves a masked partial sum whose backward it cannot take."""
    w = constrain(p["tok"], rules, None, "d_model")
    return torch.nn.functional.embedding(tokens, w)


def unembed_init(gen: torch.Generator, d: int, vocab: int, dtype) -> dict:
    return {"w": param(gen, (d, vocab), ("d_model", "vocab"), dtype)}


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]
