"""Architecture and input-shape configuration (counterpart of
``repro/configs/base.py``, the same fields and defaults).

Every architecture is a frozen ``ArchConfig``; the generic decoder in
``repro_torch.models.transformer`` is assembled from it alone.  Layer
heterogeneity is a ``layer_pattern`` of ``LayerSpec``s; the model walks
``num_layers / len(pattern)`` groups of the pattern, and each pattern
position's parameters are stacked over those groups.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["LayerSpec", "ArchConfig", "InputShape", "INPUT_SHAPES"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position in the repeating layer pattern."""
    kind: str = "attn"        # attn | rwkv | hymba (parallel attn+ssm)
    attn: str = "full"        # full | sliding | chunked | none
    window: int = 0           # sliding window size / chunk size
    mlp: str = "dense"        # dense | moe | none (rwkv has its own channel-mix)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture: widths, depth, layer pattern and numerics."""
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    source: str               # citation
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: int = 0                      # 0 -> d_model // num_heads
    # attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    # mlp
    gated_mlp: bool = True
    act: str = "silu"                      # silu | gelu
    norm: str = "rmsnorm"                  # rmsnorm | layernorm
    tie_embeddings: bool = False
    # moe
    moe_experts: int = 0
    moe_topk: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_shared_d_ff: int = 0
    moe_pad_experts: bool = False
    router_aux_coef: float = 0.01
    # ssm / rwkv / hybrid
    ssm_state: int = 0                     # mamba N
    ssm_heads: int = 0                     # 0 -> num_heads
    rwkv_head_dim: int = 64
    # modality
    modality: str = "text"                 # text | vision_stub | audio_stub
    num_codebooks: int = 1
    num_prefix_embeddings: int = 0
    # capability flags
    sub_quadratic: bool = False
    # layer groups per remat checkpoint (training only)
    remat_span: int = 1
    # numerics
    param_dtype_train: str = "float32"
    param_dtype_serve: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.num_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not a multiple of "
                f"pattern length {len(self.layer_pattern)}")
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: heads not divisible by kv heads")

    @property
    def resolved_head_dim(self) -> int:
        """``head_dim``, or ``d_model // num_heads`` when it is 0."""
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_groups(self) -> int:
        """Repeats of the layer pattern."""
        return self.num_layers // len(self.layer_pattern)

    @property
    def padded_experts(self) -> int:
        """Expert count, padded to a multiple of 16 when asked."""
        if not self.moe_experts:
            return 0
        if self.moe_pad_experts:
            return -(-self.moe_experts // 16) * 16
        return self.moe_experts

    @property
    def uses_attention(self) -> bool:
        """Whether any layer of the pattern attends."""
        return any(s.kind in ("attn", "hymba") for s in self.layer_pattern)

    def reduced(self, num_layers: int = 0, d_model: int = 256,
                vocab: int = 512) -> "ArchConfig":
        """Smoke-test variant: same family and pattern, tiny widths (at most
        2 pattern repeats, d_model <= 512, <= 4 experts, windows <= 32)."""
        hd = 32
        n_heads = max(2, min(4, self.num_heads))
        n_kv = max(1, min(n_heads, self.num_kv_heads))
        while n_heads % n_kv:
            n_kv -= 1
        nl = num_layers or len(self.layer_pattern)
        if nl % len(self.layer_pattern):
            nl = len(self.layer_pattern)
        pattern = tuple(
            dataclasses.replace(s, window=min(s.window, 32) if s.window else 0)
            for s in self.layer_pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=nl,
            d_model=min(d_model, 512),
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=hd,
            d_ff=min(2 * d_model, 1024),
            vocab_size=min(self.vocab_size, vocab),
            layer_pattern=pattern,
            moe_experts=min(self.moe_experts, 4) if self.moe_experts else 0,
            moe_pad_experts=False,
            moe_topk=min(self.moe_topk, 2) if self.moe_topk else 0,
            moe_shared_experts=min(self.moe_shared_experts, 1),
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            moe_shared_d_ff=(min(self.moe_shared_d_ff, 128)
                             if self.moe_shared_d_ff else 0),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=0,
            rwkv_head_dim=hd,
            num_prefix_embeddings=min(self.num_prefix_embeddings, 8),
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """A named workload shape: sequence length, global batch and mode."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                 # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        """Whether the shape is a decode workload."""
        return self.mode == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
