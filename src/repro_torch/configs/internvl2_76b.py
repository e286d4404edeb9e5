"""InternVL2-76B backbone (InternViT frontend stubbed) [arXiv:2404.16821].

80L transformer (InternLM2-based), d_model 8192, 64 q-heads / 8 kv-heads
(GQA), d_ff 28672, vocab 128256.  The modality frontend is a STUB:
``input_specs`` supplies precomputed patch/text embeddings (B, S, d_model).
"""

from ..nn.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="internvl2-76b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=28672, vocab=128256, embed_input=True, rope_theta=1e6,
    )


def smoke() -> ArchConfig:
    return full().replace(
        name="internvl2-76b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, attn_chunk=32,
    )
