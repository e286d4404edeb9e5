"""GQA attention: RoPE, optional qk-norm, causal training/prefill path and
KV-cache decode.

Train/prefill attention goes through ``kernels.ops.flash_attention``: on
the card the hand-written flash kernel (fp32 online softmax, grouped heads
mapped in the kernel, any length) takes both of the reference's branches
(dense up to ``cfg.attn_chunk``, chunked above it).  On the host the
reference's branch is kept, so each plain path is held to its counterpart:
up to ``cfg.attn_chunk`` the wrapper's plain version (the reference's
dense causal attention), above it ``_chunked_causal``.  Both plain paths
count ``platform.PLAIN_ON_CUDA`` if they ever see a CUDA tensor.

Decode attention stays plain torch (einsums over the cache), as the
reference computes it outside any Pallas kernel.  It writes the new key and
value into the cache tensors *in place* at ``pos`` and returns them: a
serving engine keeps one cache per slot, so a write touches only its own
slot.  ``pos`` is an ``int`` or a 0-d integer tensor on the cache's
device; a tensor position is never read back to the host (the rotary
positions, the write and the mask are computed on the device), so a
decode step over it can be captured once and replayed at every position.

Sharding (``rules``; DESIGN.md §5), as the reference constrains it:

* train/prefill — q/k/v projection weights sharded on the fused head dim;
  activations constrained with query *heads* on the ``model`` axis.  KV
  heads that cannot shard it fall back to replicated KV activations
  repeated to H and then sharded (Megatron GQA); KV heads that can keep
  their own sharding, and the kernel maps the groups of its local heads.
  The kernel runs on each rank's heads through ``local_map``.
* decode — the cache is sharded on the *sequence* dim over ``model``
  (flash-decode); the step's key and value are written into the rank
  that holds ``pos``.
"""

from __future__ import annotations

import functools

import torch

from ..distributed import (
    constrain,
    grad_placements,
    is_dtensor,
    logical_spec,
    placements,
    split_last,
)
from ..kernels import ops
from ..kernels.flash_attention import flash_attention_plain
from ..kernels.platform import PLAIN_ON_CUDA, use_kernel
from .config import ArchConfig
from .layers import param, rmsnorm, rmsnorm_init, rope


def attn_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D, H, Hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.pdtype()
    p = {
        "wq": param(gen, (D, H * dh), ("d_model", "heads"), dt),
        "wk": param(gen, (D, Hk * dh), ("d_model", "kv_fused"), dt),
        "wv": param(gen, (D, Hk * dh), ("d_model", "kv_fused"), dt),
        "wo": param(gen, (H * dh, D), ("heads", "d_model_out"), dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(gen, dh, dt)
        p["k_norm"] = rmsnorm_init(gen, dh, dt)
    return p


def _project_qkv(p, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """x: (B, S, D) -> q (B,S,H,dh), k/v (B,S,Hk,dh) with RoPE + qk-norm."""
    B, S, _ = x.shape
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = split_last(x @ p["wq"], H)
    k = split_last(x @ p["wk"], Hk)
    v = split_last(x @ p["wv"], Hk)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(..., Hk, dh) -> (..., Hk*groups, dh), each head repeated in place
    (an expand and a reshape: a DTensor takes both)."""
    if groups == 1:
        return k
    *lead, hk, dh = k.shape
    return k[..., None, :].expand(*lead, hk, groups, dh).reshape(
        *lead, hk * groups, dh)


# ---------------------------------------------------------------------------
# Train / prefill attention
# ---------------------------------------------------------------------------


def _count_plain(q: torch.Tensor) -> None:
    if q.device.type == "cuda":
        PLAIN_ON_CUDA["flash_attention"] += 1


def _chunked_causal(q, k, v, scale, chunk):
    """Flash-style blockwise causal attention in plain torch.

    Double loop over (query chunk, visible KV chunk) pairs with a running
    (max, denom, acc) in fp32, as the reference's oracle of its Pallas
    flash kernel.  Peak memory is O(chunk^2) per head."""
    _count_plain(q)
    B, S, H, dh = q.shape
    n = S // chunk
    qc = q.reshape(B, n, chunk, H, dh)
    kc = k.reshape(B, n, chunk, H, dh)
    vc = v.reshape(B, n, chunk, H, dh)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    outs = []
    for i in range(n):
        qi = qc[:, i]  # (B, c, H, dh)
        m = torch.full((B, H, chunk), float("-inf"), device=q.device)
        l = torch.zeros((B, H, chunk), device=q.device)  # noqa: E741
        acc = torch.zeros((B, H, chunk, dh), device=q.device)
        for j in range(i + 1):
            s = torch.einsum("bqhd,bkhd->bhqk", qi, kc[:, j]).float() * scale
            if j == i:
                s = s.masked_fill(~tri[None, None], float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)  # noqa: E741
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vc.dtype), vc[:, j]).float()
            m = m_new
        outs.append((acc / l[..., None]).transpose(1, 2))  # (B, c, H, dh)
    return torch.cat(outs, dim=1).to(q.dtype)


def _attend(cfg: ArchConfig, q, k, v):
    """Causal attention of local tensors: the flash wrapper (the kernel on
    the card; on the host up to ``cfg.attn_chunk`` its plain version),
    above ``cfg.attn_chunk`` on the host the chunked oracle.  On ``meta``
    tensors (the dry-run's shapes) the plain computations, whose products
    the dry-run counts."""
    if q.is_meta and q.shape[1] <= cfg.attn_chunk:
        return flash_attention_plain(q, k, v, causal=True)
    if not q.is_meta and (use_kernel(q) or q.shape[1] <= cfg.attn_chunk):
        return ops.flash_attention(q, k, v, causal=True)
    groups = q.shape[2] // k.shape[2]
    return _chunked_causal(q, _repeat_kv(k, groups), _repeat_kv(v, groups),
                           cfg.hd ** -0.5, cfg.attn_chunk)


def _attend_sharded(cfg: ArchConfig, rules, q, k, v):
    """:func:`_attend` on each rank's shard of the batch and heads.

    KV keeps its own head sharding where that matches the query heads'
    (each rank's query heads then read its own KV heads, the groups
    mapped in the kernel); otherwise KV is whole on the heads and each
    rank picks the KV head of each of its query heads (the reference's
    repeat to H, sharded as the query heads)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    q = constrain(q, rules, "attn_batch", None, "heads", None)
    k = constrain(k, rules, "attn_batch", None, "kv_heads", None)
    v = constrain(v, rules, "attn_batch", None, "kv_heads", None)
    mesh = q.device_mesh
    pl, kv_pl = list(q.placements), list(k.placements)
    if kv_pl == pl:
        return local_map(functools.partial(_attend, cfg), out_placements=pl,
                         in_placements=(pl, pl, pl),
                         device_mesh=mesh)(q, k, v)
    groups = cfg.n_heads // cfg.n_kv_heads
    heads = torch.arange(cfg.n_heads, device=q.to_local().device) // groups
    idx_pl = placements(mesh, (logical_spec(
        rules, ("attn_batch", None, "heads", None), tuple(q.shape))[2],))
    idx = DTensor.from_local(heads, mesh, [Replicate()] * mesh.ndim,
                             run_check=False).redistribute(mesh, idx_pl)

    def attend(q, k, v, idx):
        return _attend(cfg, q, k.index_select(2, idx),
                       v.index_select(2, idx))

    kv_grad = grad_placements(kv_pl, pl)
    return local_map(attend, out_placements=pl,
                     in_placements=(pl, kv_pl, kv_pl, idx_pl),
                     in_grad_placements=(pl, kv_grad, kv_grad, idx_pl),
                     device_mesh=mesh)(q, k, v, idx)


def _pad_seq(a: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, S, Hk, dh) zero-padded to S + pad on the sequence dim (on each
    rank's shard when ``a`` is a DTensor: the sequence dim is whole)."""
    f = lambda t: torch.nn.functional.pad(  # noqa: E731
        t, (0, 0, 0, 0, 0, pad))
    if not is_dtensor(a):
        return f(a)
    from torch.distributed.tensor.experimental import local_map

    pl = list(a.placements)
    return local_map(f, out_placements=pl, in_placements=(pl,),
                     device_mesh=a.device_mesh)(a)


def attention(p, cfg: ArchConfig, x: torch.Tensor, rules=None, *,
              return_kv: bool = False, max_seq: int | None = None):
    """Full-sequence causal attention (training / prefill).

    With ``return_kv`` also returns the (k, v) cache tensors padded to
    ``max_seq`` along the sequence dim (prefill path)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    if return_kv:
        pad = (max_seq or S) - S
        kv_cache = (_pad_seq(k.to(cfg.cdtype()), pad),
                    _pad_seq(v.to(cfg.cdtype()), pad))
    if rules is not None and is_dtensor(q):
        o = _attend_sharded(cfg, rules, q, k, v)
    else:
        o = _attend(cfg, q, k, v)
    out = o.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]
    if return_kv:
        return out, kv_cache
    return out


# ---------------------------------------------------------------------------
# Decode attention (KV cache)
# ---------------------------------------------------------------------------


def init_layer_cache(cfg: ArchConfig, batch: int, max_seq: int,
                     make) -> dict:
    """The layer's k/v cache, each leaf ``make(shape, dtype, axes)``."""
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    axes = ("batch", "seq_shard", None, None)
    dt = cfg.cdtype()
    return {"k": make(shape, dt, axes), "v": make(shape, dt, axes)}


def _write_pos(cache: torch.Tensor, pos, new: torch.Tensor) -> None:
    """``cache[:, pos] = new[:, 0]`` in place; a tensor ``pos`` is used on
    the device (``index_copy_``).  For a DTensor cache the rank whose
    sequence shard holds ``pos`` writes its rows of ``new`` (laid out as
    the cache's batch, whole on the sequence dim)."""
    if not is_dtensor(cache):
        if isinstance(pos, torch.Tensor):
            cache.index_copy_(1, pos.reshape(1).long(), new.to(cache.dtype))
        else:
            cache[:, pos] = new[:, 0].to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    pl = [Replicate() if p == Shard(1) else p for p in cache.placements]
    new = new.redistribute(cache.device_mesh, pl)
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    i = int(pos) - offset[1]
    if 0 <= i < shape[1]:
        cache.to_local()[:, i] = new.to_local()[:, 0].to(cache.dtype)


def decode_attention(p, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                     pos, rules=None):
    """One decode step. x: (B, 1, D); cache k/v: (B, Smax, Hk, dh) sharded
    on seq over ``model``, written in place at ``pos`` (an ``int`` or a
    0-d integer tensor on the cache's device). Returns (out (B,1,D), the
    cache)."""
    B = x.shape[0]
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if isinstance(pos, torch.Tensor):
        positions = pos.to(torch.int32).reshape(1, 1).expand(B, 1)
    else:
        positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                               device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    # Per-token activations are tiny: replicate them over the model axis
    # (which carries the cache *sequence* shards) so the attention einsums
    # contract locally (flash-decode).
    q = constrain(q, rules, "batch", None, None, None)
    k_new = constrain(k_new, rules, "batch", None, None, None)
    v_new = constrain(v_new, rules, "batch", None, None, None)
    ck, cv = cache["k"], cache["v"]
    _write_pos(ck, pos, k_new)
    _write_pos(cv, pos, v_new)
    ck = constrain(ck, rules, "batch", "seq_shard", None, None)
    cv = constrain(cv, rules, "batch", "seq_shard", None, None)
    Smax = ck.shape[1]
    # GQA without repeat: fold q heads into (Hk, G) so the contraction runs
    # directly against the Hk-headed cache (no cache-sized broadcast).
    G = H // Hk
    qg = q.reshape(B, Hk, G, dh)  # (B, Hk, G, dh) from (B, 1, H, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, ck.to(qg.dtype))
    scores = constrain(scores.float() * (dh ** -0.5), rules, "batch", None,
                       None, "seq_shard")
    valid = torch.arange(Smax, device=x.device)[None, None, None, :] <= pos
    scores = scores.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", probs.to(ck.dtype), cv)
    o = constrain(o, rules, "batch", None, None, None)
    out = o.reshape(B, 1, H * dh) @ p["wo"]
    return out, {"k": ck, "v": cv}
