"""MusicGen-medium [arXiv:2306.05284]: a decoder-only LM over EnCodec
tokens in 4 parallel codebooks (the delay pattern is the data's).  The
EnCodec codec is stubbed: the model takes (B, 4, T) codebook token grids,
sums the 4 embeddings and emits (B, T, 4, 2048) logits.  MHA (24 heads
over 24 KV heads), LayerNorm, plain GELU MLP."""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    layer_pattern=(LayerSpec(kind="attn", attn="full"),),
    gated_mlp=False,
    act="gelu",
    norm="layernorm",
    modality="audio_stub",
    num_codebooks=4,
)
