"""MusicGen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens.

48L, d_model 1536, 24 heads / 24 kv-heads (MHA), d_ff 6144 (gelu MLP),
vocab 2048 (EnCodec codebook). The EnCodec frontend is a STUB:
``input_specs`` supplies precomputed frame embeddings; the decoder predicts
codebook tokens. 24 heads don't divide the 16-wide model axis => the fused
head dim shards instead (DESIGN.md §5 fallback).
"""

from ..nn.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab=2048, activation="gelu", embed_input=True,
        rope_theta=1e4,
    )


def smoke() -> ArchConfig:
    return full().replace(
        name="musicgen-medium-smoke", n_layers=2, d_model=48, n_heads=3,
        n_kv_heads=3, head_dim=16, d_ff=96, vocab=256, attn_chunk=32,
    )
