"""Grok-1 314B [hf:xai-org/grok-1]: 8-expert top-2 MoE.

64L, d_model 6144, 48 heads (head_dim 128) / 8 kv-heads, expert d_ff 32768,
vocab 131072, logit soft-capping 30. GLU experts give the published 314B
total / ~86B active. 8 experts don't divide the 16-wide model axis =>
TP-inside-expert fallback; parameters FSDP-shard on the data axis (the
memory-constraint showcase of the planner).
"""

from ..nn.config import ArchConfig, MoEConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=32768, vocab=131072, rope_theta=1e5, logit_softcap=30.0,
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=32768),
    )


def smoke() -> ArchConfig:
    return full().replace(
        name="grok-1-314b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, attn_chunk=32,
        moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=128, group_size=64),
    )
