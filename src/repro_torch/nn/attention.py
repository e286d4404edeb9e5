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
slot.
"""

from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.platform import PLAIN_ON_CUDA, use_kernel
from .config import ArchConfig
from .layers import param, rmsnorm, rmsnorm_init, rope


def attn_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D, H, Hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.pdtype()
    p = {
        "wq": param(gen, (D, H * dh), dt),
        "wk": param(gen, (D, Hk * dh), dt),
        "wv": param(gen, (D, Hk * dh), dt),
        "wo": param(gen, (H * dh, D), dt),
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
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, Hk, dh)
    v = (x @ p["wv"]).reshape(B, S, Hk, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(..., Hk, dh) -> (..., Hk*groups, dh)."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=-2)


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


def attention(p, cfg: ArchConfig, x: torch.Tensor, *, return_kv: bool = False,
              max_seq: int | None = None):
    """Full-sequence causal attention (training / prefill).

    With ``return_kv`` also returns the (k, v) cache tensors padded to
    ``max_seq`` along the sequence dim (prefill path)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    if return_kv:
        pad = (max_seq or S) - S
        kv_pad = lambda a: torch.nn.functional.pad(  # noqa: E731
            a.to(cfg.cdtype()), (0, 0, 0, 0, 0, pad))
        kv_cache = (kv_pad(k), kv_pad(v))
    if use_kernel(q) or S <= cfg.attn_chunk:
        o = ops.flash_attention(q, k, v, causal=True)
    else:
        groups = cfg.n_heads // cfg.n_kv_heads
        o = _chunked_causal(q, _repeat_kv(k, groups), _repeat_kv(v, groups),
                            cfg.hd ** -0.5, cfg.attn_chunk)
    out = o.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]
    if return_kv:
        return out, kv_cache
    return out


# ---------------------------------------------------------------------------
# Decode attention (KV cache)
# ---------------------------------------------------------------------------


def init_layer_cache(cfg: ArchConfig, batch: int, max_seq: int,
                     device) -> dict:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dt = cfg.cdtype()
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_attention(p, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                     pos: int):
    """One decode step. x: (B, 1, D); cache k/v: (B, Smax, Hk, dh), written
    in place at ``pos``. Returns (out (B,1,D), the cache)."""
    B = x.shape[0]
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    ck, cv = cache["k"], cache["v"]
    ck[:, pos] = k_new[:, 0].to(ck.dtype)
    cv[:, pos] = v_new[:, 0].to(cv.dtype)
    Smax = ck.shape[1]
    # GQA without repeat: fold q heads into (Hk, G) so the contraction runs
    # directly against the Hk-headed cache (no cache-sized broadcast).
    G = H // Hk
    qg = q.reshape(B, Hk, G, dh)  # (B, Hk, G, dh) from (B, 1, H, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, ck.to(qg.dtype))
    scores = scores.float() * (dh ** -0.5)
    valid = torch.arange(Smax, device=x.device)[None, None, None, :] <= pos
    scores = scores.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", probs.to(ck.dtype), cv)
    out = o.reshape(B, 1, H * dh) @ p["wo"]
    return out, {"k": ck, "v": cv}
