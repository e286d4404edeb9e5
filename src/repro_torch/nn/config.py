"""Architecture + shape configuration dataclasses for the model substrate.

An :class:`ArchConfig` fully determines parameter shapes and the forward
graph; ``repro_torch/configs/<arch>.py`` instantiate one per assigned
architecture (exact public-literature configs) plus a reduced ``smoke()``
variant for CPU tests.  :class:`ShapeSpec` describes one assigned
input-shape cell.  ``pdtype()``/``cdtype()`` give torch dtypes;
``param_count`` is the reference's formula, unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    shared_d_ff: int = 0          # qwen2-moe: 4 shared experts fused into one
    capacity_factor: float = 1.25
    router_dtype: str = "float32"  # router logits in fp32 (numerics)
    group_size: int = 4096         # GShard dispatch group (tokens)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    chunk: int = 256  # scan chunk (memory/recompute tradeoff knob)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64   # rank of the data-dependent decay LoRA (Finch)
    mix_lora: int = 32     # rank of the token-shift mixing LoRA
    chunk: int = 128       # recurrence chunk length (kernel + memory knob)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Jamba-style interleave: layers repeat with ``period``; the layer at
    ``attn_index`` (mod period) is attention, others Mamba; every
    ``moe_period``-th layer uses MoE as its FFN (offset ``moe_offset``)."""

    period: int = 8
    attn_index: int = 3
    moe_period: int = 2
    moe_offset: int = 1
    mamba: MambaConfig = MambaConfig()


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str          # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0    # 0 -> d_model // n_heads
    qk_norm: bool = False
    activation: str = "swiglu"   # swiglu | gelu (plain 2-matrix MLP)
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    rwkv: Optional[RWKVConfig] = None
    hybrid: Optional[HybridConfig] = None
    embed_input: bool = False    # vlm/audio stub: inputs are embeddings
    tie_embeddings: bool = False
    logit_softcap: float = 0.0   # grok-style tanh soft-capping
    # --- execution-plan knobs (defaults; the planner overrides these) ---
    scan_layers: bool = True
    remat: str = "dots"          # none | dots | full
    moe_impl: str = "einsum"     # einsum (GShard) | gather (scatter-route)
    attn_chunk: int = 1024       # flash-style chunking threshold/blocks
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    state_dtype: str = "float32"  # Adam moment dtype (memory knob)
    loss_chunk: int = 0           # 0 = unchunked vocab loss

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # -- rough parameter count (used by roofline MODEL_FLOPS = 6·N·D) -----
    def param_count(self, active_only: bool = False) -> int:
        D, H, Hk, dh = self.d_model, self.n_heads, self.n_kv_heads, self.hd
        n_mats = 3 if self.activation == "swiglu" else 2

        def attn_p():
            return D * H * dh + 2 * D * Hk * dh + H * dh * D

        def mlp_p(ff):
            return n_mats * D * ff

        def moe_p(m: MoEConfig, active: bool):
            e = m.top_k if active else m.num_experts
            p = e * n_mats * D * m.expert_d_ff + D * m.num_experts
            if m.shared_d_ff:
                p += n_mats * D * m.shared_d_ff + D  # shared expert (+gate)
            return p

        if self.family == "ssm":
            r = self.rwkv or RWKVConfig()
            per_layer = 5 * D * D + 2 * D * r.decay_lora  # r,k,v,g,o + lora
            per_layer += 2 * D * self.d_ff + D * D  # channel mix k,v,r
        elif self.family == "hybrid":
            h = self.hybrid or HybridConfig()
            m = h.mamba
            din = m.expand * D
            dtr = m.dt_rank or -(-D // 16)
            mamba_p = (D * 2 * din + m.d_conv * din
                       + din * (dtr + 2 * m.d_state) + dtr * din + din * D)
            per = []
            for i in range(h.period):
                mix = attn_p() if i % h.period == h.attn_index else mamba_p
                if self.moe and i % h.moe_period == h.moe_offset:
                    f = moe_p(self.moe, active_only)
                else:
                    f = mlp_p(self.d_ff)
                per.append(mix + f)
            per_layer = sum(per) / h.period
        elif self.moe is not None:
            per_layer = attn_p() + moe_p(self.moe, active_only)
        else:
            per_layer = attn_p() + mlp_p(self.d_ff)
        emb = self.vocab * D * (1 if self.tie_embeddings else 2)
        if self.embed_input:
            emb = self.vocab * D  # stub frontend: unembed only
        return int(self.n_layers * per_layer + emb)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
