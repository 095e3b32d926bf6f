"""Qwen2-72B [arXiv:2407.10671]: dense, GQA (64 query heads over 8 KV
heads), QKV bias, untied head."""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    vocab_size=152_064,
    layer_pattern=(LayerSpec(kind="attn", attn="full"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
