"""InternLM2-20B [arXiv:2403.17297]: GQA dense transformer.

48L, d_model 6144, 48 heads (head_dim 128) / 8 kv-heads, d_ff 16384,
vocab 92544.
"""

from ..nn.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=92544, rope_theta=1e6,
    )


def smoke() -> ArchConfig:
    return full().replace(
        name="internlm2-20b-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, head_dim=16, d_ff=192, vocab=512, attn_chunk=32,
    )
