"""Generic decoder (counterpart of ``repro/models/transformer.py``): every
architecture the port serves is this module driven by an ``ArchConfig``.

Structure
---------
* Parameters are the port's flat dict of tensors, named and ordered as the
  reference's pytree flattens (``repro_torch.bridge``): ``embed``,
  ``final_norm.*``, ``layers.<i>.*``, ``lm_head``.  ``layers.<i>`` is
  pattern position ``i``; its leaves carry a leading ``num_groups`` axis,
  and the model walks the groups in a Python loop (group-major, as the
  reference's scan does).
* ``forward``     -- train and prefill: tokens -> padded-vocab logits (B,
  T, V), or (B, T, K, V) for ``audio_stub``, differentiable.  Under grad
  mode with ``remat`` every ``remat_span`` groups run under
  ``torch.utils.checkpoint``, as the
  reference's ``jax.checkpoint(group_body)``: only the residual stream at
  the span boundaries is kept, and the spans are recomputed in the
  backward.  Attention keeps its output and log-sum-exp
  (``models/flash_vjp.py``).
* ``cross_entropy`` / ``lm_loss`` -- the reference's weighted-mean cross
  entropy (log-sum-exp in fp32, the max taken as a constant, weight-0
  positions masked rather than sliced) and the training loss.
* ``decode_step`` -- one token against a ``DecodeState`` (KV caches with
  ring buffers on windowed layers, wkv/ssm states on recurrent layers).
  The caches are updated in place; the state passed in is consumed.
* ``layer_view``  -- the flat dict split once into each (group, pattern
  position)'s layer dict.  ``forward`` and ``decode_step`` take either
  form; a decode loop passes the view so no step rebuilds it.  The split
  unbinds each stacked leaf once, so a backward gathers each leaf's
  gradient in one stack rather than one full-size buffer a group.

Layer kinds: ``rwkv`` (time mix + channel mix), ``hymba`` (attention and
an SSM in parallel, ``0.5 (y + s)``, then the MLP) and ``attn`` (the same
without the SSM).  The MLP is dense or, with ``mlp="moe"``, the
mixture of experts of ``models/moe.py``; its aux loss adds to the
forward's.  The forward and ``decode_step`` both pass the real expert
count, so padded experts are never routed (the reference's forward
omits it and routes them; ROADMAP Queue 3).  gemma2 archs scale the
embeddings by sqrt(d_model), as the reference does.

Modalities, as the reference's stubs:
* ``audio_stub`` (MusicGen, K codebooks of V tokens): tokens are (B, K, T)
  grids; codebook k's ids are offset by k V into one K V-row embedding,
  the K embeddings are summed, and the K V-wide head's logits come back
  as (B, T, K, V), without vocab padding.  The loss is the mean over
  codebooks too.
* ``vision_stub`` (InternVL2): (B, P, d) precomputed patch embeddings are
  prepended to the token embeddings in the compute dtype; their logits are
  returned too, and ``lm_loss`` gives those positions weight 0 (masked,
  not sliced).  A vision config without them raises ``ValueError``; a
  config of another modality given them raises too, where the reference
  drops them unread.

The wkv6 and ssm_scan recurrences are differentiable on both devices:
their ``torch.autograd.Function``s run the backward kernels on the card
and the plain backwards on the CPU, and a remat span runs their forward
again in the backward.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import flatten_tree, tree_map, unflatten_tree
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import hints as hints_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (dense_init, embed_init, init_device,
                                       init_norm, norm_apply, softcap)

__all__ = ["padded_vocab", "is_audio", "init_params", "param_count", "LayerView",
           "layer_view", "embed_tokens", "forward", "cross_entropy",
           "lm_loss", "DecodeState", "init_decode_state", "decode_step",
           "Decoder"]

Params = Dict[str, torch.Tensor]


def _dt(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def padded_vocab(cfg: ArchConfig) -> int:
    """Vocab padded to a multiple of 256, as in the reference (its logits
    keep the padded width; decode drops it)."""
    return -(-cfg.vocab_size // 256) * 256


def is_audio(cfg: ArchConfig) -> bool:
    """Whether the config takes (B, K, T) codebook grids."""
    return cfg.modality == "audio_stub" and cfg.num_codebooks > 1


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.modality not in ("text", "audio_stub", "vision_stub"):
        raise ValueError(f"unknown modality {cfg.modality!r}")
    for spec in cfg.layer_pattern:
        if spec.kind not in ("rwkv", "hymba", "attn"):
            raise ValueError(f"unknown layer kind {spec.kind!r}")


# ===========================================================================
# init
# ===========================================================================
def _init_mlp(generator, d_model: int, d_ff: int, gated: bool, dtype,
              stack, device) -> dict:
    p = {"wi": dense_init(generator, stack + (d_model, d_ff), dtype,
                          device=device),
         "wo": dense_init(generator, stack + (d_ff, d_model), dtype,
                          device=device)}
    if gated:
        p["wg"] = dense_init(generator, stack + (d_model, d_ff), dtype,
                             device=device)
    return p


def _init_layer(generator, cfg: ArchConfig, spec: LayerSpec, dtype,
                stack: Tuple[int, ...], device) -> dict:
    """One pattern position's parameters, stacked over ``stack``."""
    def norm():
        return tree_map(lambda t: t.expand(stack + t.shape).clone(),
                        init_norm(cfg.d_model, cfg.norm, dtype,
                                  device=init_device(generator, device)))

    p = {"norm1": norm()}
    if spec.kind == "rwkv":
        p["time_mix"] = rwkv_lib.init_rwkv_params(
            generator, cfg.d_model, cfg.rwkv_head_dim, cfg.d_ff, dtype,
            stack=stack, device=device)
        p["norm2"] = norm()
        return p
    p["attn"] = attn_lib.init_attn_params(
        generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
        cfg.resolved_head_dim, cfg.qkv_bias, dtype, stack=stack,
        device=device)
    if spec.kind == "hymba":
        p["ssm"] = ssm_lib.init_ssm_params(
            generator, cfg.d_model, cfg.d_model, cfg.ssm_state, dtype,
            stack=stack, device=device)
    if spec.mlp != "none":
        p["norm2"] = norm()
    if spec.mlp == "moe":
        p["moe"] = moe_lib.init_moe_params(
            generator, cfg.d_model, cfg.padded_experts,
            cfg.moe_d_ff or cfg.d_ff, cfg.moe_shared_d_ff, cfg.gated_mlp,
            dtype, stack=stack, device=device)
    elif spec.mlp != "none":
        p["mlp"] = _init_mlp(generator, cfg.d_model, cfg.d_ff,
                             cfg.gated_mlp, dtype, stack, device)
    return p


def init_params(generator: Optional[torch.Generator], cfg: ArchConfig,
                dtype_name: Optional[str] = None, *, device=None) -> Params:
    """Parameters with the reference's distributions (truncated normals
    scaled by fan-in, d^-0.5 embeddings, constant mixes, biases and norms),
    as the port's flat dict in the reference's leaf order, on ``device``
    (``cuda`` unless named).  A generator on a card draws there; by default
    a CPU generator seeded 0."""
    _check_supported(cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dtype = _dt(dtype_name or cfg.param_dtype_train)
    # audio: K codebooks of V rows and columns, unpadded
    pv = cfg.num_codebooks * cfg.vocab_size if is_audio(cfg) \
        else padded_vocab(cfg)
    stack = (cfg.num_groups,)
    tree: Dict[str, Any] = {
        "embed": embed_init(generator, pv, cfg.d_model, dtype, device=device)}
    tree["layers"] = tuple(
        _init_layer(generator, cfg, spec, dtype, stack, device)
        for spec in cfg.layer_pattern)
    tree["final_norm"] = init_norm(cfg.d_model, cfg.norm, dtype,
                                   device=init_device(generator, device))
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init(generator, (cfg.d_model, pv), dtype,
                                     device=device)
    return flatten_tree(tree)


def param_count(params: Params) -> int:
    """Number of parameters over all leaves."""
    return int(sum(leaf.numel() for leaf in params.values()))


class LayerView(NamedTuple):
    """A decoder's parameters split for the layer loop: the leaves outside
    ``layers`` (``embed``, ``final_norm``, ``lm_head``) and each layer's
    dict of views, indexed ``[group][pattern position]``."""
    top: dict
    layers: Tuple[Tuple[dict, ...], ...]


def layer_view(params, cfg: ArchConfig) -> LayerView:
    """``params`` (the flat dict, or a view, returned as it is) split into
    a :class:`LayerView`.  The layer dicts are views of the stacked
    leaves, not copies."""
    if isinstance(params, LayerView):
        return params
    tree = unflatten_tree(params)
    # lists, not tuples: tree_map walks into tuples
    groups = tuple(tree_map(lambda t: list(t.unbind(0)), layer)
                   for layer in tree["layers"])
    layers = tuple(
        tuple(tree_map(lambda parts: parts[gi], groups[p_idx])
              for p_idx in range(len(cfg.layer_pattern)))
        for gi in range(cfg.num_groups))
    top = {key: sub for key, sub in tree.items() if key != "layers"}
    return LayerView(top, layers)


# ===========================================================================
# layer application (train and prefill)
# ===========================================================================
def _mlp_apply(p: dict, x: torch.Tensor, act: str, gated: bool,
               cdt) -> torch.Tensor:
    xc = x.to(cdt)
    h = xc @ p["wi"].to(cdt)
    h = (torch.nn.functional.silu(h) if act == "silu"
         else torch.nn.functional.gelu(h, approximate="tanh"))
    if gated:
        h = h * (xc @ p["wg"].to(cdt))
    return h @ p["wo"].to(cdt)


def _ffn_apply(cfg: ArchConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
               cdt, hints=None):
    """The layer's MLP on ``x``: (y, aux loss); the dense MLP's aux is
    None."""
    h = _block_in(hints, x, p["norm2"], cfg)
    if spec.mlp == "moe":
        return moe_lib.moe_ffn(p["moe"], h.to(cdt), topk=cfg.moe_topk,
                               act=cfg.act, gated=cfg.gated_mlp,
                               real_experts=cfg.moe_experts, hints=hints)
    return _mlp_apply(p["mlp"], h, cfg.act, cfg.gated_mlp, cdt), None


def _block_in(hints, x: torch.Tensor, norm: dict,
              cfg: ArchConfig) -> torch.Tensor:
    """A block's normed input.  Under hints the sequence-sharded residual
    is gathered over "model" first (sequence parallelism's all-gather),
    so that the block's products see whole rows."""
    return norm_apply(hints_lib.apply_batch(hints, x), norm, cfg.norm)


def _residual(hints, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` in x's dtype; under hints y first takes the sequence-sharded
    residual layout (so a row-parallel product's partial sums reduce-scatter)
    and its gradient is rounded to bf16, as the reference's."""
    if hints is not None:
        y = hints_lib.apply_grad_bf16(hints, hints_lib.apply_seq(hints, y, 1))
    return x + y.to(x.dtype)


def _apply_layer(cfg: ArchConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, recur_state, cdt, hints=None):
    """Returns (x, new_recur_state, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = hints_lib.apply_seq(hints, x, 1)
    if spec.kind == "rwkv":
        h = _block_in(hints, x, p["norm1"], cfg)
        y, wkv_state, shift1 = rwkv_lib.rwkv_time_mix(
            p["time_mix"], h, cfg.rwkv_head_dim,
            recur_state["wkv"], recur_state["shift1"], hints=hints)
        x = _residual(hints, x, y)
        h = _block_in(hints, x, p["norm2"], cfg)
        y, shift2 = rwkv_lib.rwkv_channel_mix(
            p["time_mix"], h, recur_state["shift2"])
        x = _residual(hints, x, y)
        return x, {"wkv": wkv_state, "shift1": shift1, "shift2": shift2}, aux

    h = _block_in(hints, x, p["norm1"], cfg)
    q, k, v = attn_lib.project_qkv(
        p["attn"], h, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
        positions, cfg.rope_theta, cdt, hints)
    a = attn_lib.flash_attention(q, k, v, attn=spec.attn, window=spec.window,
                                 softcap_val=cfg.attn_softcap, hints=hints)
    y = attn_lib.out_proj(p["attn"], a, cdt, hints)

    new_state = recur_state
    if spec.kind == "hymba":
        xz = h.to(cdt) @ p["ssm"]["w_in"].to(cdt)
        s, hT = ssm_lib.ssm_forward(p["ssm"], xz, recur_state["ssm"],
                                    hints=hints)
        s = s.to(cdt) @ p["ssm"]["w_out"].to(cdt)
        y = 0.5 * (y + s)
        new_state = {"ssm": hT}
    x = _residual(hints, x, y)

    if spec.mlp != "none":
        y, moe_aux = _ffn_apply(cfg, spec, p, x, cdt, hints)
        if moe_aux is not None:
            aux = aux + moe_aux
        x = _residual(hints, x, y)
    return x, new_state, aux


def _init_recur_state(cfg: ArchConfig, spec: LayerSpec, batch: int,
                      stacked: bool = True, device=None, hints=None) -> dict:
    """Per-layer recurrent state (zeros, fp32); leading group axis if
    ``stacked``.  Under ``hints`` (unstacked) each rank makes only its
    batch rows (``hints.zeros``)."""
    g = (cfg.num_groups,) if stacked else ()
    f32 = torch.float32

    def zeros(*shape):
        if stacked:
            return torch.zeros(g + shape, dtype=f32, device=device)
        return hints_lib.zeros(hints, shape, f32, device)
    if spec.kind == "rwkv":
        H = cfg.d_model // cfg.rwkv_head_dim
        hd = cfg.rwkv_head_dim
        return {"wkv": zeros(batch, H, hd, hd),
                "shift1": zeros(batch, 1, cfg.d_model),
                "shift2": zeros(batch, 1, cfg.d_model)}
    if spec.kind == "hymba":
        return {"ssm": zeros(batch, cfg.d_model, cfg.ssm_state)}
    return {}


# ===========================================================================
# forward, loss
# ===========================================================================
def _rows(hints, x: torch.Tensor):
    """The placement of a DTensor's leading dim under hints: over the data
    axes where they split it, else None."""
    from torch.distributed.tensor import Shard
    return Shard(0) if hints.splits_batch(x.shape[0]) else None


def _lookup(embed: torch.Tensor, ids: torch.Tensor, hints) -> torch.Tensor:
    """Rows ``ids`` of ``embed``.  Under hints (a DTensor table, vocab over
    "model") each rank looks up the ids its vocab shard holds, through
    ``local_map``, and the partial rows sum over "model" (Megatron's
    vocab-parallel embedding; the reference's XLA path contracts a one-hot
    for the same layout).  The table's FSDP shards are gathered first."""
    if hints is None:
        return embed[ids]
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = hints.mesh
    # the table's own layout: its vocab over "model" even where that axis
    # has one rank, so that local_map moves nothing, and the gradient is
    # reduce-scattered to the table's FSDP shards, not all-reduced first
    split = embed.placements[mesh.mesh_dim_names.index(hints.model)] \
        == Shard(0)
    batch = _rows(hints, ids)
    rows = Shard(0) if split else None

    def local(table, idx):
        lo = mesh.get_local_rank(hints.model) * table.shape[0] if split \
            else 0
        at = idx - lo
        mine = (at >= 0) & (at < table.shape[0])
        got = table[torch.where(mine, at, 0)]
        return torch.where(mine[..., None], got, torch.zeros(
            (), dtype=got.dtype, device=got.device))

    out = local_map(local,
                    out_placements=hints.layout(batch,
                                                Partial() if split else None),
                    in_placements=(hints.layout(None, rows),
                                   hints.layout(batch)),
                    in_grad_placements=(hints.layout(
                        Partial() if batch is not None else None, rows),
                        hints.layout(batch)),
                    device_mesh=mesh, redistribute_inputs=True)(
        embed, hints_lib.replicated(hints, ids) if not
        isinstance(ids, DTensor) else ids)
    return hints_lib.apply_batch(hints, out)


def embed_tokens(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                 cdt, hints=None) -> torch.Tensor:
    """(B, T) int token ids -> (B, T, d) embeddings in ``cdt``; audio: (B,
    K, T) -> the K codebooks' embeddings summed in ``cdt``.  gemma2 archs
    (by name, as the reference keys it) scale them by sqrt(d_model), held
    in the compute dtype."""
    if is_audio(cfg):
        B, K, T = tokens.shape
        offsets = torch.arange(K, device=tokens.device) * cfg.vocab_size
        ids = (tokens.long() + offsets[None, :, None]).reshape(B, K * T)
        e = _lookup(params["embed"], ids, hints).to(cdt).reshape(
            B, K, T, -1).sum(1)
    else:
        e = _lookup(params["embed"], tokens.long(), hints).to(cdt)
    if cfg.name.startswith("gemma2"):
        e = e * torch.tensor(cfg.d_model ** 0.5, dtype=cdt, device=e.device)
    return e


def _logits(tree: dict, cfg: ArchConfig, x: torch.Tensor,
            cdt, hints=None) -> torch.Tensor:
    x = hints_lib.apply_batch(hints, x)   # T whole before the vocab head
    x = norm_apply(x, tree["final_norm"], cfg.norm)
    head = tree["embed"].T if cfg.tie_embeddings else tree["lm_head"]
    logits = hints_lib.apply_feature(hints, x.to(cdt) @ head.to(cdt), 2)
    if cfg.logit_softcap > 0:
        logits = softcap(logits, cfg.logit_softcap)
    if is_audio(cfg):
        # codebooks whole before the split (under hints)
        logits = hints_lib.batch_grad(hints, hints_lib.apply_batch(
            hints, logits)).reshape(logits.shape[:2] + (cfg.num_codebooks,
                                                        cfg.vocab_size))
    return logits


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            *, remat: bool = True,
            hints=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, T, padded vocab) in the compute dtype, or (B, T,
    K, V) for audio, and the aux loss).

    params: the flat dict or its :func:`layer_view`.  tokens: (B, T) int,
    or (B, K, T) for audio.  prefix_embeds: (B, P, d), required by
    ``vision_stub`` and refused otherwise; prepended, so T counts P + the
    tokens.  Every recurrent layer starts from a zero state.  With
    ``remat`` and grad mode on, each span of ``cfg.remat_span`` groups (1
    unless it divides the group count, as in the reference) is
    checkpointed.  ``hints`` (``models/hints.py``) anchor a sharded run's
    layouts (DTensor parameters and inputs), and each layer's weights and
    the embedding and head are gathered over the data axes where they are
    used (``hints.gathered``); None is the plain run."""
    _check_supported(cfg)
    cdt = _dt(cfg.compute_dtype)
    view = layer_view(params, cfg)
    top = hints_lib.gathered(hints, view.top, tokens.shape[0])
    x = embed_tokens(top, cfg, tokens, cdt, hints)
    if cfg.modality == "vision_stub":
        if prefix_embeds is None:
            raise ValueError(f"{cfg.name} requires prefix_embeds")
        x = torch.cat([prefix_embeds.to(cdt), x], dim=1)
    elif prefix_embeds is not None:
        raise ValueError(f"{cfg.name} ({cfg.modality}) takes no "
                         f"prefix_embeds")
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    span = cfg.remat_span if cfg.num_groups % max(cfg.remat_span, 1) == 0 \
        else 1
    span = max(span, 1)

    def body(groups, x, aux):
        for group in groups:
            for spec, lp in zip(cfg.layer_pattern, group):
                rc = _init_recur_state(cfg, spec, B, stacked=False,
                                       device=x.device, hints=hints)
                x, _, a = _apply_layer(cfg, spec,
                                       hints_lib.gathered(hints, lp, B), x,
                                       positions, rc, cdt, hints)
                aux = aux + a
        return x, aux

    x = hints_lib.apply_seq(hints, x, 1)
    for g0 in range(0, len(view.layers), span):
        groups = view.layers[g0:g0 + span]
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(body, groups, x, aux, use_reentrant=False)
        else:
            x, aux = body(groups, x, aux)
    return _logits(top, cfg, x, cdt, hints), aux


class _VocabParallelNll(torch.autograd.Function):
    """The per-position loss of :func:`cross_entropy` on one rank's vocab
    shard (b, t, V / m) of logits: the row max, the exp sum and the label's
    logit all-reduced over "model"; the backward is softmax minus the
    label's one-hot, with the two terms rounded to the logits' dtype and
    added as autograd adds them in the whole-vocab form."""

    @staticmethod
    def forward(ctx, logits, labels, offset: int, group):
        import torch.distributed._functional_collectives as funcol
        m = funcol.all_reduce(logits.amax(-1), "max", group)
        e = torch.exp((logits - m[..., None]).float())
        se = funcol.all_reduce(e.sum(-1), "sum", group)
        idx = labels.long() - offset
        mine = (idx >= 0) & (idx < logits.shape[-1])
        at = torch.where(mine, idx, 0)
        picked = logits.gather(-1, at[..., None])[..., 0]
        correct = funcol.all_reduce(torch.where(
            mine, picked, torch.zeros((), dtype=logits.dtype,
                                      device=logits.device)).float(),
            "sum", group)
        ctx.save_for_backward(e, se, at, mine)
        ctx.dtype = logits.dtype
        return m.float() + torch.log(se) - correct

    @staticmethod
    def backward(ctx, g):
        e, se, at, mine = ctx.saved_tensors
        grad = e.div_(se[..., None]).mul_(g[..., None]).to(ctx.dtype)
        hit = torch.where(mine, -g, torch.zeros_like(g)).to(ctx.dtype)
        grad.scatter_add_(-1, at[..., None], hit[..., None])
        return grad, None, None, None


def _vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                        hints) -> torch.Tensor:
    """Per-position loss of vocab-sharded DTensor logits (B, ..., V), the
    vocab over "model", through ``local_map``: no rank gathers the
    vocab."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = hints.mesh
    mi = mesh.mesh_dim_names.index(hints.model)
    batch = _rows(hints, logits)
    vocab = hints.layout(batch, Shard(logits.dim() - 1))

    def local(lg, lb):
        offset = mesh.get_local_rank(hints.model) * lg.shape[-1]
        return _VocabParallelNll.apply(lg, lb, offset, (mesh, mi))

    return local_map(local, out_placements=hints.layout(batch),
                     in_placements=(vocab, hints.layout(batch)),
                     in_grad_placements=(vocab, hints.layout(batch)),
                     device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position loss on whole-vocab logits, as the reference's: the
    row max is a constant (``stop_gradient``) subtracted in the logits'
    dtype, the log-sum-exp is summed in fp32, the correct-class logit is
    read in the logits' dtype and widened."""
    m = logits.detach().amax(-1)
    shifted = (logits - m[..., None]).float()
    lse = m.float() + torch.log(torch.exp(shifted).sum(-1))
    correct = logits.gather(-1, labels.long()[..., None])[..., 0]
    return lse - correct.float()


def _row_nll(logits: torch.Tensor, labels: torch.Tensor,
             hints) -> torch.Tensor:
    """:func:`_nll` on each rank's rows of DTensor logits whose vocab is
    whole (through ``local_map``), so that neither it nor its backward
    makes a tensor of the global batch."""
    from torch.distributed.tensor.experimental import local_map
    batch = hints.layout(_rows(hints, logits))
    return local_map(_nll, out_placements=batch,
                     in_placements=(batch, batch),
                     in_grad_placements=(batch, batch),
                     device_mesh=hints.mesh, redistribute_inputs=True)(
        logits, hints_lib.replicated(hints, labels) if not
        isinstance(labels, DTensor) else labels)


def _sharded_mean(nll: torch.Tensor, weights: Optional[torch.Tensor],
                  hints) -> torch.Tensor:
    """The (weighted) mean of the rows-sharded DTensor ``nll`` as the
    plain path takes it, each rank's rows reduced where they lie
    (``local_map``) and the partial sums then added over the data axes:
    the backward of a mean taken on the DTensor would spread the loss's
    gradient over the global batch on every rank first.  Unweighted, each
    rank's mean over its R-th of the rows divided by R (the rows split
    evenly), so that one rank (R = 1) takes exactly the plain mean."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    rows = _rows(hints, nll)
    batch = hints.layout(rows)
    part = hints.layout(Partial() if rows is not None else None)
    shards = hints._dp_size() if rows is not None else 1
    if weights is None:
        return local_map(torch.mean, out_placements=part,
                         in_placements=(batch,), in_grad_placements=(batch,),
                         device_mesh=hints.mesh, redistribute_inputs=True)(
            nll) / shards

    def local(n, w):
        w = w.float()
        return (n * w).sum(), w.sum()
    total, count = local_map(
        local, out_placements=(part, part), in_placements=(batch, batch),
        in_grad_placements=(batch, batch), device_mesh=hints.mesh,
        redistribute_inputs=True)(
        nll, hints_lib.replicated(hints, weights) if not
        isinstance(weights, DTensor) else weights)
    return total / torch.clamp(count, min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  hints=None) -> torch.Tensor:
    """Weighted mean cross entropy over the last axis, as the reference's
    (:func:`_nll`); weight-0 positions count for nothing (masked, never
    sliced).  Without weights: the plain mean.  Under hints the
    per-position loss and the mean run on each rank's rows, vocab parallel
    (:class:`_VocabParallelNll`) where the vocab is over "model"."""
    if hints is not None:
        nll = (_vocab_parallel_nll(logits, labels, hints)
               if hints._ok(logits.shape[-1]) else
               _row_nll(logits, labels, hints))
        return _sharded_mean(nll, weights, hints)
    nll = _nll(logits, labels)
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def lm_loss(params, cfg: ArchConfig, batch: dict, *,
            remat: bool = True, hints=None) -> torch.Tensor:
    """Training loss of a batch ``{"tokens": (B, T), "labels": (B, T)}``
    (audio: both (B, K, T); vision: also ``"prefix_embeds"`` (B, P, d)):
    the mean cross entropy over every token (and codebook), the prefix
    positions masked with label 0 and weight 0, plus
    ``cfg.router_aux_coef`` times the forward's aux loss.  The forward runs
    with ``remat`` on by default, as the reference's ``lm_loss``."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          batch.get("prefix_embeds"), remat=remat,
                          hints=hints)
    labels = batch["labels"]
    weights = None
    if cfg.modality == "vision_stub":
        B, P = batch["prefix_embeds"].shape[:2]
        labels = torch.cat([labels.new_zeros((B, P)), labels], dim=1)
        weights = torch.ones(labels.shape, device=labels.device)
        weights[:, :P] = 0.0
    if is_audio(cfg):                 # logits (B, T, K, V); labels (B, K, T)
        labels = labels.transpose(1, 2)
    return cross_entropy(logits, labels, weights, hints) + \
        cfg.router_aux_coef * aux


# ===========================================================================
# decode
# ===========================================================================
class DecodeState(NamedTuple):
    """Per pattern position, stacked over the groups: a ``KVCache`` (attn),
    a recurrent-state dict (rwkv) or both (hymba: ``{"ssm", "kv"}``)."""
    caches: Tuple[Any, ...]
    position: int                # the next token's position


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype_name: Optional[str] = None, *,
                      device=None) -> DecodeState:
    """Zero caches for ``batch`` sequences of up to ``max_seq`` tokens; KV
    caches in ``dtype_name`` (the serve dtype by default), recurrent states
    in fp32."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = _dt(dtype_name or cfg.param_dtype_serve)
    stack = (cfg.num_groups,)
    caches = []
    for spec in cfg.layer_pattern:
        kv = None
        if spec.kind != "rwkv":
            kv = attn_lib.init_kv_cache(
                batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim,
                dtype, attn=spec.attn, window=spec.window, stack=stack,
                device=dev)
        if spec.kind == "attn":
            caches.append(kv)
            continue
        st = _init_recur_state(cfg, spec, batch, device=dev)
        if spec.kind == "hymba":
            st = {"ssm": st["ssm"], "kv": kv}
        caches.append(st)
    return DecodeState(tuple(caches), 0)


def _decode_layer(cfg: ArchConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
                  cache, pos: int, cdt, hints=None):
    if spec.kind == "rwkv":
        # the shift buffers hold the previous token's normed layer inputs
        h1 = norm_apply(x, p["norm1"], cfg.norm)
        y, wkv, _ = rwkv_lib.rwkv_time_mix(
            p["time_mix"], h1, cfg.rwkv_head_dim, cache["wkv"],
            cache["shift1"], decode=True, hints=hints)
        x = x + y.to(x.dtype)
        h2 = norm_apply(x, p["norm2"], cfg.norm)
        y, _ = rwkv_lib.rwkv_channel_mix(
            p["time_mix"], h2, cache["shift2"], decode=True)
        x = x + y.to(x.dtype)
        return x, {"wkv": wkv, "shift1": h1.to(cache["shift1"].dtype),
                   "shift2": h2.to(cache["shift2"].dtype)}

    h = norm_apply(x, p["norm1"], cfg.norm)
    kv_cache = cache["kv"] if spec.kind == "hymba" else cache
    q, k, v = attn_lib.project_qkv(
        p["attn"], h, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
        torch.tensor([pos], device=x.device), cfg.rope_theta, cdt, hints)
    a, kv_cache = attn_lib.decode_attention(
        q, k, v, kv_cache, attn=spec.attn, window=spec.window,
        softcap_val=cfg.attn_softcap, hints=hints)
    y = attn_lib.out_proj(p["attn"], a, cdt, hints)

    if spec.kind == "hymba":
        xz = h.to(cdt) @ p["ssm"]["w_in"].to(cdt)
        s, hT = ssm_lib.ssm_step(p["ssm"], xz, cache["ssm"])
        s = s.to(cdt) @ p["ssm"]["w_out"].to(cdt)
        y = 0.5 * (y + s)
        new_cache = {"ssm": hT, "kv": kv_cache}
    else:
        new_cache = kv_cache
    x = x + y.to(x.dtype)

    if spec.mlp != "none":
        y, _ = _ffn_apply(cfg, spec, p, x, cdt, hints)
        x = x + y.to(x.dtype)
    return x, new_cache


def _group(cache, gi: int):
    """Group ``gi``'s slice of a stacked cache (views, not copies)."""
    if isinstance(cache, attn_lib.KVCache):
        return attn_lib.KVCache(cache.k[gi], cache.v[gi], cache.index)
    return {key: _group(sub, gi) for key, sub in cache.items()} \
        if isinstance(cache, dict) else cache[gi]


def _store(cache, gi: int, new) -> None:
    """Write group ``gi``'s new recurrent state into the stacked cache.
    KV caches were already written in place by ``decode_attention``."""
    if isinstance(cache, attn_lib.KVCache):
        return
    for key, sub in cache.items():
        if isinstance(sub, (dict, attn_lib.KVCache)):
            _store(sub, gi, new[key])
        elif isinstance(sub, DTensor):
            # the group axis is whole: write this rank's shard
            sub.to_local()[gi] = new[key].redistribute(
                sub.device_mesh, sub[gi].placements).to_local()
        else:
            sub[gi] = new[key]


def _advance(cache, position: int):
    if isinstance(cache, attn_lib.KVCache):
        return cache._replace(index=position)
    return {key: _advance(sub, position) if isinstance(
        sub, (dict, attn_lib.KVCache)) else sub for key, sub in cache.items()}


def decode_step(params, cfg: ArchConfig, state: DecodeState,
                tokens: torch.Tensor,
                hints=None) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step.  params: the flat dict or, in a loop, its
    :func:`layer_view`.  tokens: (B, 1) int, or (B, K, 1) for audio.
    Returns (logits (B, 1, vocab) fp32 without the vocab padding, or (B,
    1, K, V) for audio, the new state).  Under ``hints`` the caches are
    DTensors laid out as ``launch/shardings.decode_state_shardings``
    says, written shard by shard."""
    cdt = _dt(cfg.compute_dtype)
    view = layer_view(params, cfg)
    x = embed_tokens(view.top, cfg, tokens, cdt, hints)
    pos = state.position
    caches = state.caches
    # group-major, as the reference's unrolled loop
    for gi, group in enumerate(view.layers):
        for p_idx, (spec, p_g) in enumerate(zip(cfg.layer_pattern, group)):
            x, new = _decode_layer(cfg, spec, p_g, x,
                                   _group(caches[p_idx], gi), pos, cdt,
                                   hints)
            _store(caches[p_idx], gi, new)
    logits = _logits(view.top, cfg, x, cdt, hints)
    if not is_audio(cfg):
        logits = logits[..., :cfg.vocab_size]     # drop the vocab padding
    new_caches = tuple(_advance(c, pos + 1) for c in caches)
    return logits.float(), DecodeState(new_caches, pos + 1)


class Decoder(nn.Module):
    """``nn.Module`` over a decoder's flat parameter dict (from
    :func:`init_params` or the bridge): ``forward(tokens)`` is the prefill
    forward, ``decode_step(state, tokens)`` one decode step.  The
    parameters are registered as they are, without copies and without
    gradients (this slice serves; it does not train), and split into their
    :func:`layer_view` once."""

    def __init__(self, cfg: ArchConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self._names = list(params)
        self.leaves = nn.ParameterList(
            nn.Parameter(value, requires_grad=False)
            for value in params.values())
        self._view = layer_view(self.params(), cfg)

    def _apply(self, fn, *args, **kwargs):
        # ``.to()`` and friends may swap the leaves' storage: split again
        out = super()._apply(fn, *args, **kwargs)
        self._view = layer_view(self.params(), self.cfg)
        return out

    def params(self) -> Params:
        """The parameters as a flat dict in the reference's leaf order."""
        return dict(zip(self._names, self.leaves))

    def forward(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Padded-vocab logits (B, T, V) of a prompt batch ((B, T, K, V)
        for audio; a vision config takes its (B, P, d) prefix too)."""
        return forward(self._view, self.cfg, tokens, prefix_embeds,
                       remat=False)[0]

    def decode_step(self, state: DecodeState, tokens: torch.Tensor):
        """(logits (B, 1, vocab) fp32, new state) for one token."""
        return decode_step(self._view, self.cfg, state, tokens)
