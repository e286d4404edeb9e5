"""Qwen3-4B [hf:Qwen/Qwen3-8B family]: qk-norm GQA dense transformer.

36L, d_model 2560, 32 q-heads (head_dim 128) / 8 kv-heads, d_ff 9728,
vocab 151936, RMS qk-norm on per-head q/k.
"""

from ..nn.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1e6,
    )


def smoke() -> ArchConfig:
    return full().replace(
        name="qwen3-4b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, attn_chunk=32,
    )
