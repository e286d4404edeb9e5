"""Jamba-v0.1 52B [arXiv:2403.19887]: Mamba+attention 7:1 hybrid with MoE.

32L in 4 superblocks of 8 (attention at in-block index 3, Mamba elsewhere;
MoE every other layer), d_model 4096, 32 heads / 8 kv-heads, d_ff 14336,
16 experts top-2, vocab 65536. Hybrid => the long_500k cell runs (attention
layers use the seq-sharded KV cache; Mamba state is O(1)).
"""

from ..nn.config import ArchConfig, HybridConfig, MambaConfig, MoEConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=65536, rope_theta=1e6,
        moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=14336),
        hybrid=HybridConfig(period=8, attn_index=3, moe_period=2,
                            moe_offset=1,
                            mamba=MambaConfig(d_state=16, d_conv=4, expand=2)),
    )


def smoke() -> ArchConfig:
    return full().replace(
        name="jamba-v0.1-52b-smoke", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, attn_chunk=32,
        moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=128, group_size=64),
        hybrid=HybridConfig(period=8, attn_index=3, moe_period=2,
                            moe_offset=1,
                            mamba=MambaConfig(d_state=4, d_conv=4, expand=2,
                                              chunk=16)),
    )
