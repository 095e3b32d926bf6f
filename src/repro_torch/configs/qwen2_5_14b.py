"""Qwen2.5-14B [hf:Qwen/Qwen2.5-0.5B family]: dense, GQA (40 query heads
over 8 KV heads), QKV bias, untied head."""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13_824,
    vocab_size=152_064,
    layer_pattern=(LayerSpec(kind="attn", attn="full"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
