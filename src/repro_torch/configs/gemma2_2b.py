"""Gemma2-2B [arXiv:2408.00118]: alternating local (4096-token sliding
window) and global attention, attention and final logit softcaps, GeGLU,
tied embeddings, embeddings scaled by sqrt(d_model)."""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    source="arXiv:2408.00118",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    layer_pattern=(
        LayerSpec(kind="attn", attn="sliding", window=4096),
        LayerSpec(kind="attn", attn="full"),
    ),
    attn_softcap=50.0,
    logit_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    sub_quadratic=True,
)
