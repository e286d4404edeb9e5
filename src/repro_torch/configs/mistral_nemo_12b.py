"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407]: 128k-ctx GQA.

40L, d_model 5120, 32 q-heads (head_dim 128) / 8 kv-heads, d_ff 14336,
vocab 131072 (Tekken), rope_theta 1e6 for the long context.
"""

from ..nn.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="mistral-nemo-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=131072, rope_theta=1e6,
    )


def smoke() -> ArchConfig:
    return full().replace(
        name="mistral-nemo-12b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, attn_chunk=32,
    )
