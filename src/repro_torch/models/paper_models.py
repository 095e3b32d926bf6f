"""The paper's client models (§5.1.3; counterpart of
``repro/models/paper_models.py``).  This slice ports LeNet (MNIST); VGG and
the GRU language model wait for a later slice (ROADMAP Queue 1 item 3).

Parameters keep the reference's names, shapes and layout: conv weights are
HWIO, batches are NHWC at the public functions, and the flatten before
``fc1`` runs in NHWC order, so the rows of ``fc1.w`` mean what they mean in
the reference.  A parameter set is a flat ``{"conv1.w": tensor, ...}`` dict
in the reference's leaf order (sorted keys).  ``lenet_forward`` is the
functional form the federated round differentiates (and vmaps over
clients); :class:`LeNet` wraps it as an ``nn.Module``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.common import dense_init, truncated_normal

Params = Dict[str, torch.Tensor]

__all__ = ["init_lenet", "lenet_forward", "LeNet", "classifier_loss",
           "classifier_accuracy"]


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


class LeNet(nn.Module):
    """``nn.Module`` form of LeNet over the same named parameters."""

    def __init__(self, params: Params):
        """Wrap a parameter dict from :func:`init_lenet` (or the bridge)."""
        super().__init__()
        for layer in sorted({name.split(".")[0] for name in params}):
            module = nn.Module()
            for name, value in params.items():
                if name.startswith(layer + "."):
                    module.register_parameter(
                        name.split(".")[1], nn.Parameter(value.clone()))
            self.add_module(layer, module)

    def params(self) -> Params:
        """The parameters as a flat dict in the reference's leaf order."""
        return dict(sorted(self.named_parameters()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits for an NHWC batch ``x``."""
        return lenet_forward(self.params(), x)


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
