"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model 2048, 16 heads / 16 kv-heads, 60 routed experts (d_ff 1408)
top-4 + 4 shared experts (fused 4x1408 = 5632 with sigmoid gate),
vocab 151936. 60 experts don't divide the 16-wide model axis => expert
weights fall back to TP-inside-expert (DESIGN.md §5).
"""

from ..nn.config import ArchConfig, MoEConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=151936, rope_theta=1e6,
        moe=MoEConfig(num_experts=60, top_k=4, expert_d_ff=1408,
                      shared_d_ff=5632),
    )


def smoke() -> ArchConfig:
    return full().replace(
        name="qwen2-moe-a2.7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=32, vocab=512, attn_chunk=32,
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=32, shared_d_ff=64,
                      group_size=64),
    )
