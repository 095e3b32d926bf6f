"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E
family]: 128 routed experts, top 1, plus one shared expert on alternating
layers (a dense 16,384-wide FFN on the others); attention in 8192-token
chunks on three layers of four and full on the fourth; the text backbone
of an early-fusion multimodal model.  About 400 B parameters, 17 B
active a token."""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16_384,            # the dense layers' FFN
    vocab_size=202_048,
    layer_pattern=(
        LayerSpec(kind="attn", attn="chunked", window=8192, mlp="moe"),
        LayerSpec(kind="attn", attn="chunked", window=8192, mlp="dense"),
        LayerSpec(kind="attn", attn="chunked", window=8192, mlp="moe"),
        LayerSpec(kind="attn", attn="full", mlp="dense"),
    ),
    moe_experts=128,
    moe_topk=1,
    moe_shared_experts=1,
    moe_d_ff=8192,          # each routed expert's hidden width
    moe_shared_d_ff=8192,
    sub_quadratic=True,     # chunked attention on three layers of four
    param_dtype_train="bfloat16",
)
