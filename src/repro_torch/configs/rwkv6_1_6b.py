"""RWKV6 'Finch' 1.6B [arXiv:2404.05892]: attention-free, data-dependent
per-channel decay (wkv6), token shift, squared-ReLU channel mix."""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=24,
    d_model=2048,
    num_heads=32,           # wkv heads = d_model / rwkv_head_dim
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65_536,
    layer_pattern=(LayerSpec(kind="rwkv", attn="none", mlp="none"),),
    rwkv_head_dim=64,
    norm="layernorm",
    sub_quadratic=True,     # O(1) recurrent state
)
