"""RWKV-6 (Finch) 3B [arXiv:2404.05892]: attention-free, data-dependent
decay.

32L, d_model 2560 (40 heads x 64), channel-mix d_ff 8960, vocab 65536.
State is O(1) in sequence length => the long_500k cell runs.
"""

from ..nn.config import ArchConfig, RWKVConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=8960, vocab=65536, rwkv=RWKVConfig(head_size=64),
    )


def smoke() -> ArchConfig:
    return full().replace(
        name="rwkv6-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=512,
        rwkv=RWKVConfig(head_size=16, decay_lora=8, chunk=16),
    )
