"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 60 routed experts, top
4, plus 4 shared experts fused as one 5632-wide shared FFN; 16 query heads
over 16 KV heads; QKV bias.  The experts are padded to 64
(``moe_pad_experts``); the padded four are never routed."""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151_936,
    layer_pattern=(LayerSpec(kind="attn", attn="full", mlp="moe"),),
    qkv_bias=True,
    moe_experts=60,
    moe_topk=4,
    moe_shared_experts=4,
    moe_d_ff=1408,
    moe_shared_d_ff=5632,   # the 4 shared experts fused: 4 x 1408
    moe_pad_experts=True,   # 60 -> 64
)
