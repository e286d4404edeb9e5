"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: qwen1.5 arch, full MHA kv.

32L, d_model 4096, 32 heads / 32 kv-heads (kv == q), d_ff 13440,
vocab 92416.
"""

from ..nn.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="codeqwen1.5-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
        d_ff=13440, vocab=92416, rope_theta=1e6,
    )


def smoke() -> ArchConfig:
    return full().replace(
        name="codeqwen1.5-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, attn_chunk=32,
    )
