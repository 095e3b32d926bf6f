"""InternVL2-26B [arXiv:2404.16821]: the InternLM2-20B language backbone
(48 layers, 48 query heads over 8 KV heads).  The InternViT-6B vision
encoder is stubbed: 256 projected patch embeddings an image, (B, 256,
6144), are prepended to the text tokens' embeddings."""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=92_553,
    layer_pattern=(LayerSpec(kind="attn", attn="full"),),
    rope_theta=1_000_000.0,
    modality="vision_stub",
    num_prefix_embeddings=256,   # ViT patch embeddings, precomputed
)
