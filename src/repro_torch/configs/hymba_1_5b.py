"""Hymba-1.5B [arXiv:2411.13676]: hybrid heads, attention and a Mamba SSM
(state 16) in parallel in every layer; sliding-window attention in most
layers.  Pattern: 1 full : 15 sliding, 32 layers = 2 groups of 16."""

from repro_torch.configs.base import ArchConfig, LayerSpec

_PATTERN = (LayerSpec(kind="hymba", attn="full"),) + tuple(
    LayerSpec(kind="hymba", attn="sliding", window=1024) for _ in range(15))

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    layer_pattern=_PATTERN,
    ssm_state=16,
    sub_quadratic=True,
)
