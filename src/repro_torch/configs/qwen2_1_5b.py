"""Qwen2-1.5B [arXiv:2407.10671]: dense, GQA (12 query heads over 2 KV
heads), QKV bias, tied embeddings."""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    layer_pattern=(LayerSpec(kind="attn", attn="full"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
