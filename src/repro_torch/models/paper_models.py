"""The paper's client models (§5.1.3; counterpart of
``repro/models/paper_models.py``): LeNet (MNIST), VGG (CIFAR-10) and a GRU
language model with tied embeddings (WikiText-2).

Parameters keep the reference's names, shapes and layout: conv weights are
HWIO, batches are NHWC at the public functions, and the flatten before
``fc1`` runs in NHWC order, so the rows of ``fc1.w`` mean what they mean in
the reference.  A parameter set is a flat ``{"conv1.w": tensor, ...}`` dict
in the reference's leaf order (sorted keys; the GRU's keys have no dot).
``*_forward`` are the functional forms the federated round differentiates
(and vmaps over clients); :class:`LeNet`, :class:`VGG` and :class:`GRULM`
are their ``nn.Module`` forms.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.common import dense_init, truncated_normal

Params = Dict[str, torch.Tensor]

__all__ = ["init_lenet", "lenet_forward", "LeNet", "init_vgg", "vgg_forward",
           "VGG", "classifier_loss", "classifier_accuracy", "init_gru_lm",
           "gru_lm_forward", "gru_lm_loss", "perplexity", "GRULM"]


def _conv_init(generator, kh, kw, cin, cout, device):
    fan_in = kh * kw * cin
    w = fan_in ** -0.5 * truncated_normal(generator, (kh, kw, cin, cout),
                                          device)
    return {"b": torch.zeros((cout,), device=device), "w": w}


def init_lenet(generator: torch.Generator | None = None,
               image_size: int = 28, channels: int = 1,
               num_classes: int = 10, *, device=None) -> Params:
    """LeNet-5 parameters (two conv+pool stages, three dense layers) as a
    flat dict in the reference's leaf order, on ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    s = image_size // 4
    conv1 = _conv_init(generator, 5, 5, channels, 6, dev)
    conv2 = _conv_init(generator, 5, 5, 6, 16, dev)
    layers = {"conv1": conv1, "conv2": conv2}
    for name, fan in (("fc1", (s * s * 16, 120)), ("fc2", (120, 84)),
                      ("out", (84, num_classes))):
        layers[name] = {
            "b": torch.zeros((fan[1],), device=dev),
            "w": dense_init(generator, fan, torch.float32, device=dev)}
    return {f"{layer}.{p}": layers[layer][p]
            for layer in sorted(layers) for p in sorted(layers[layer])}


def _conv_same(params: Params, name: str, h: torch.Tensor) -> torch.Tensor:
    """NCHW activations, HWIO weight -> 'SAME' stride-1 conv plus bias."""
    w = params[f"{name}.w"]
    y = F.conv2d(h, w.permute(3, 2, 0, 1),
                 padding=(w.shape[0] // 2, w.shape[1] // 2))
    return y + params[f"{name}.b"][:, None, None]


def lenet_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits for an NHWC batch ``x``."""
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(F.relu(_conv_same(params, "conv1", h)), 2)
    h = F.max_pool2d(F.relu(_conv_same(params, "conv2", h)), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ params["fc1.w"] + params["fc1.b"])
    h = F.relu(h @ params["fc2.w"] + params["fc2.b"])
    return h @ params["out.w"] + params["out.b"]


class _ParamModule(nn.Module):
    """An ``nn.Module`` over a flat parameter dict: ``"layer.p"`` names
    become parameter ``p`` of submodule ``layer``, undotted names
    parameters of the module itself."""

    def __init__(self, params: Params):
        super().__init__()
        for name, value in params.items():
            param = nn.Parameter(value.clone())
            if "." not in name:
                self.register_parameter(name, param)
                continue
            layer, leaf = name.split(".")
            if not hasattr(self, layer):
                self.add_module(layer, nn.Module())
            getattr(self, layer).register_parameter(leaf, param)

    def params(self) -> Params:
        """The parameters as a flat dict in the reference's leaf order."""
        return dict(sorted(self.named_parameters()))


class LeNet(_ParamModule):
    """``nn.Module`` form of LeNet over the same named parameters (a dict
    from :func:`init_lenet` or the bridge)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits for an NHWC batch ``x``."""
        return lenet_forward(self.params(), x)


# ---------------------------------------------------------------------------
# VGG (paper §5.2.4, CIFAR-10), width-scalable.
# ---------------------------------------------------------------------------
def init_vgg(generator: torch.Generator | None = None, image_size: int = 32,
             channels: int = 3, num_classes: int = 10,
             widths: Sequence[int] = (32, 64, 128, 128), *,
             device=None) -> Params:
    """VGG parameters: per width two 3x3 convs (``conv{i}a``,
    ``conv{i}b``), then ``fc`` (256 wide) and ``out``, as a flat dict in
    the reference's leaf order on ``device``.  ``image_size`` is accepted
    for the reference's signature: the global average pool makes the
    parameters independent of it."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    layers = {}
    cin = channels
    for i, w in enumerate(widths):
        layers[f"conv{i}a"] = _conv_init(generator, 3, 3, cin, w, dev)
        layers[f"conv{i}b"] = _conv_init(generator, 3, 3, w, w, dev)
        cin = w
    for name, fan in (("fc", (cin, 256)), ("out", (256, num_classes))):
        layers[name] = {
            "b": torch.zeros((fan[1],), device=dev),
            "w": dense_init(generator, fan, torch.float32, device=dev)}
    return {f"{layer}.{p}": layers[layer][p]
            for layer in sorted(layers) for p in sorted(layers[layer])}


def vgg_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits for an NHWC batch ``x``: conv-relu-conv-relu stages, each
    followed by a 2x2 max pool while both spatial dims are >= 2, then a
    global average pool and two dense layers."""
    h = x.permute(0, 3, 1, 2)
    i = 0
    while f"conv{i}a.w" in params:
        h = F.relu(_conv_same(params, f"conv{i}a", h))
        h = F.relu(_conv_same(params, f"conv{i}b", h))
        if min(h.shape[2], h.shape[3]) >= 2:
            h = F.max_pool2d(h, 2)
        i += 1
    h = h.mean((2, 3))
    h = F.relu(h @ params["fc.w"] + params["fc.b"])
    return h @ params["out.w"] + params["out.b"]


class VGG(_ParamModule):
    """``nn.Module`` form of VGG over the named parameters of
    :func:`init_vgg` (or the bridge)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits for an NHWC batch ``x``."""
        return vgg_forward(self.params(), x)


def classifier_loss(forward_fn: Callable) -> Callable:
    """Mean softmax cross-entropy ``loss(params, (x, y))``."""
    def loss(params, batch):
        x, y = batch
        lp = torch.log_softmax(forward_fn(params, x), dim=-1)
        return -torch.mean(torch.gather(lp, 1, y[:, None].long()))
    return loss


def classifier_accuracy(forward_fn: Callable) -> Callable:
    """Top-1 accuracy ``acc(params, (x, y))``."""
    def acc(params, batch):
        x, y = batch
        pred = torch.argmax(forward_fn(params, x), -1)
        return torch.mean((pred == y.long()).to(torch.float32))
    return acc


# ---------------------------------------------------------------------------
# GRU language model, tied embeddings (paper §5.3)
# ---------------------------------------------------------------------------
def init_gru_lm(generator: torch.Generator | None = None, vocab: int = 512,
                d_embed: int = 128, d_hidden: int = 128, tied: bool = True,
                *, device=None) -> Params:
    """GRU-LM parameters: ``embed`` (V, d_embed), the gate weights ``wz``,
    ``wr``, ``wn`` ((d_embed + d_hidden, d_hidden)) and biases, ``proj``
    (d_hidden, d_embed), and ``head`` (d_embed, V) when not ``tied``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    d = d_hidden
    p = {"embed": (d_embed ** -0.5 * torch.randn(
        (vocab, d_embed), generator=generator)).to(dev)}
    for gate in ("wz", "wr", "wn"):
        p[gate] = dense_init(generator, (d_embed + d, d), torch.float32,
                             device=dev)
    for bias in ("bz", "br", "bn"):
        p[bias] = torch.zeros((d,), device=dev)
    p["proj"] = dense_init(generator, (d, d_embed), torch.float32, device=dev)
    if not tied:
        p["head"] = dense_init(generator, (d_embed, vocab), torch.float32,
                               device=dev)
    return dict(sorted(p.items()))


def gru_lm_forward(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, T) integer ids -> logits (B, T, V).

    The gates are written out as in the reference: ``z`` and ``r`` from
    ``[x, h]``, the candidate from ``[x, r * h]``, ``h = (1 - z) n + z h``
    (``nn.GRU`` places its gates and biases differently)."""
    B, T = tokens.shape
    embed = params["embed"]
    e = F.embedding(tokens.long(), embed)                # (B, T, d_embed)
    h = e.new_zeros((B, params["bz"].shape[0]))
    hs = []
    for t in range(T):
        xt = e[:, t]
        hx = torch.cat([xt, h], -1)
        z = torch.sigmoid(hx @ params["wz"] + params["bz"])
        r = torch.sigmoid(hx @ params["wr"] + params["br"])
        hxr = torch.cat([xt, r * h], -1)
        n = torch.tanh(hxr @ params["wn"] + params["bn"])
        h = (1 - z) * n + z * h
        hs.append(h)
    out = torch.stack(hs, 1) @ params["proj"]           # (B, T, d_embed)
    if "head" in params:
        return out @ params["head"]
    return out @ embed.T                                 # tied


def gru_lm_loss(params: Params, batch) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch = (inputs, targets)``."""
    x, y = batch
    lp = torch.log_softmax(gru_lm_forward(params, x), dim=-1)
    return -torch.mean(torch.gather(lp, -1, y[..., None].long()))


def perplexity(params: Params, batch) -> torch.Tensor:
    """``exp`` of :func:`gru_lm_loss`."""
    return torch.exp(gru_lm_loss(params, batch))


class GRULM(_ParamModule):
    """``nn.Module`` form of the GRU-LM over the named parameters of
    :func:`init_gru_lm` (or the bridge)."""

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits (B, T, V) for (B, T) token ids."""
        return gru_lm_forward(self.params(), tokens)
