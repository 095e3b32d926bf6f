"""Selective-SSM scan (counterpart of ``repro/kernels/ssm_scan.py``).

Per batch row, channel c and state lane n:

    h_t[c, n] = a_t[c, n] h_{t-1}[c, n] + bx_t[c, n]
    y_t[c]    = sum_n C_t[n] h_t[c, n]

in the layout the model uses: a, bx (B, T, d, N), c (B, T, N), h0 (B, d, N)
-> y (B, T, d), hT (B, d, N).

``ssm_scan`` is the wrapper around the hand-written CUDA kernel
(``csrc/ssm_scan.cu``, any N that divides 32); ``ssm_scan_plain`` is the
same recurrence in plain PyTorch.  Its gradient is :class:`SsmScanFunction`,
whose backward is ``ssm_scan_backward``: a second hand-written kernel in the
same file, with ``ssm_scan_backward_plain`` beside it.  Under autograd the
forward kernel also writes h every ``CHECKPOINT`` steps, h_{16 k} (B,
ceil(T / 16), d, N), which the Function saves; the backward recomputes
each 16-step chunk's states from its checkpoint, so it reads a and bx once
and never divides by a.  ``_ssm_scan_checkpoint_plain`` and
``_ssm_scan_backward_from_checkpoints_plain`` mirror that split on the CPU
for the tests; the CPU path itself keeps no checkpoints.  With g the
running adjoint of h, per (b, c, n):

    g <- dhT
    for t = T-1 ... 0:
        g <- g + dy_t[c] C_t[n]
        dbx_t = g;  da_t = g h_{t-1};  dC_t[n] += dy_t[c] h_t[c, n]  (sum over c)
        g <- a_t g
    dh0 = g

Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.  Every launch adds one to
the wrapper's count (:func:`launch_counts`).

The forward (with and without checkpoints) and the backward are also
``torch.library`` custom ops (``repro_torch::ssm_scan_forward``,
``ssm_scan_forward_checkpoints``, ``ssm_scan_backward``), which
:func:`ssm_scan` and :class:`SsmScanFunction` call: their fake
implementations give the output shapes without running anything, so
``FakeTensorMode`` (the dry run) traces a step through them as one op
each.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.segmented import _launch, _library

__all__ = ["CHECKPOINT", "CUDA_STATE_DIMS", "ssm_scan", "ssm_scan_plain",
           "ssm_scan_backward", "ssm_scan_backward_plain", "SsmScanFunction",
           "backward_scratch_shapes",
           "launch_counts", "reset_launch_counts"]

CUDA_STATE_DIMS = (1, 2, 4, 8, 16, 32)
CHECKPOINT = 16                  # steps between the forward's checkpoints

_LAUNCHES: Dict[str, int] = {"ssm_scan": 0, "ssm_scan_backward": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches of each wrapper since the last reset (CUDA only)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set the launch counts to 0."""
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _check(a, bx, c, h0) -> None:
    if a.dim() != 4:
        raise ValueError(f"a must be (B, T, d, N), got {tuple(a.shape)}")
    B, T, d, N = a.shape
    want = {"a": (a, (B, T, d, N)), "bx": (bx, (B, T, d, N)),
            "c": (c, (B, T, N)), "h0": (h0, (B, d, N))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{x.dtype}")
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def _check_state_dim(N: int) -> None:
    if N not in CUDA_STATE_DIMS:
        raise ValueError(f"the CUDA ssm_scan kernels take state dims that "
                         f"divide 32 {CUDA_STATE_DIMS}, got {N}")


def ssm_scan_plain(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                   h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ssm_scan`: one step at a time."""
    B, T, d, _ = a.shape
    h = h0.float()
    y = torch.empty((B, T, d), dtype=torch.float32, device=a.device)
    for t in range(T):
        h = a[:, t] * h + bx[:, t]
        y[:, t] = torch.einsum("bdn,bn->bd", h, c[:, t])
    return y, h


def ssm_scan_backward_plain(a: torch.Tensor, bx: torch.Tensor,
                            c: torch.Tensor, h0: torch.Tensor,
                            dy: torch.Tensor, dhT: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`ssm_scan_backward`: the forward's states
    kept, then the adjoint one step at a time."""
    B, T, d, N = a.shape
    hs = torch.empty((B, T + 1, d, N), dtype=torch.float32, device=a.device)
    hs[:, 0] = h0
    for t in range(T):
        hs[:, t + 1] = a[:, t] * hs[:, t] + bx[:, t]
    g = dhT.float().clone()
    da, dbx = torch.empty_like(a), torch.empty_like(bx)
    dc = torch.empty_like(c)
    for t in range(T - 1, -1, -1):
        g = g + dy[:, t, :, None] * c[:, t, None, :]
        dbx[:, t] = g
        da[:, t] = g * hs[:, t]
        dc[:, t] = torch.einsum("bd,bdn->bn", dy[:, t], hs[:, t + 1])
        g = a[:, t] * g
    return da, dbx, dc, g


def _ssm_scan_checkpoint_plain(a: torch.Tensor, bx: torch.Tensor,
                               c: torch.Tensor, h0: torch.Tensor
                               ) -> Tuple[torch.Tensor, ...]:
    """The checkpointing forward in plain PyTorch: y, hT and h_{16 k} (B,
    ceil(T / 16), d, N), the state before step 16 k.  For the tests."""
    B, T, d, N = a.shape
    h = h0.float()
    y = torch.empty((B, T, d), dtype=torch.float32, device=a.device)
    hk = torch.empty((B, -(-T // CHECKPOINT), d, N), dtype=torch.float32,
                     device=a.device)
    for t in range(T):
        if t % CHECKPOINT == 0:
            hk[:, t // CHECKPOINT] = h
        h = a[:, t] * h + bx[:, t]
        y[:, t] = torch.einsum("bdn,bn->bd", h, c[:, t])
    return y, h, hk


def _ssm_scan_backward_from_checkpoints_plain(
        a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor, hk: torch.Tensor,
        dy: torch.Tensor, dhT: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's one sweep in plain PyTorch: chunk by chunk
    from the last, each chunk's states recomputed from its checkpoint,
    then walked backwards.  For the tests."""
    B, T, d, N = a.shape
    g = dhT.float().clone()
    da, dbx = torch.empty_like(a), torch.empty_like(bx)
    dc = torch.empty_like(c)
    for k in range(hk.shape[1] - 1, -1, -1):
        t0 = k * CHECKPOINT
        t1 = min(t0 + CHECKPOINT, T)
        hs = [hk[:, k]]
        for t in range(t0, t1):
            hs.append(a[:, t] * hs[-1] + bx[:, t])
        for t in range(t1 - 1, t0 - 1, -1):
            g = g + dy[:, t, :, None] * c[:, t, None, :]
            dbx[:, t] = g
            da[:, t] = g * hs[t - t0]
            dc[:, t] = torch.einsum("bd,bdn->bn", dy[:, t], hs[t - t0 + 1])
            g = a[:, t] * g
    return da, dbx, dc, g


def _forward(a, bx, c, h0, checkpoints: bool = False) -> tuple:
    """The forward on the tensors' device: the plain version on the CPU,
    the kernel on the card; with ``checkpoints`` (card only) also h_{16 k}
    (B, ceil(T / 16), d, N) as a third output."""
    if a.device.type == "cpu":
        return ssm_scan_plain(a, bx, c, h0)
    B, T, d, N = a.shape
    _check_state_dim(N)
    y = torch.empty((B, T, d), dtype=torch.float32, device=a.device)
    hT = torch.empty_like(h0)
    if not checkpoints:
        _launch("ssm_scan", _library().ssm_scan_launch, a.data_ptr(),
                bx.data_ptr(), c.data_ptr(), h0.data_ptr(), y.data_ptr(),
                hT.data_ptr(), B, T, d, N, counts=_LAUNCHES)
        return y, hT
    hk = torch.empty((B, -(-T // CHECKPOINT), d, N), dtype=torch.float32,
                     device=a.device)
    _launch("ssm_scan", _library().ssm_scan_checkpoint_launch, a.data_ptr(),
            bx.data_ptr(), c.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hT.data_ptr(), hk.data_ptr(), B, T, d, N, counts=_LAUNCHES)
    return y, hT, hk


def backward_scratch_shapes(B: int, T: int, d: int, N: int) -> tuple:
    """The CUDA backward's scratch buffer: the blocks' partials of dc (B,
    blocks, T, N)."""
    blocks = ctypes.c_int()
    err = _library().ssm_scan_backward_config(d, N, ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"ssm_scan_backward_config failed: {err}")
    return ((B, blocks.value, T, N),)


def ssm_scan_backward(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                      h0: torch.Tensor, dy: torch.Tensor, dhT: torch.Tensor,
                      hk: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssm_scan`: forward inputs as there, dy (B, T,
    d) and dhT (B, d, N) the outputs' adjoints.  Returns (da, dbx, dc, dh0),
    fp32, shaped as a, bx, c and h0.

    On the card the kernel recomputes h from the forward's checkpoints
    ``hk`` (h_{16 k}, (B, ceil(T / 16), d, N), as ``SsmScanFunction``
    saves them; when None the checkpointing forward runs first), the
    steps between them in registers, so it never divides by a; dc sums
    over channels in a fixed order (a partial a block, then a second
    pass), so two runs give the same bits."""
    _check(a, bx, c, h0)
    B, T, d, N = a.shape
    for name, x, shape in (("dy", dy, (B, T, d)), ("dhT", dhT, (B, d, N))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
    if a.device.type == "cpu":
        return ssm_scan_backward_plain(a, bx, c, h0, dy, dhT)
    _check_state_dim(N)
    if hk is None:
        hk = _forward(a, bx, c, h0, checkpoints=True)[2]
    elif (tuple(hk.shape) != (B, -(-T // CHECKPOINT), d, N)
          or hk.dtype != torch.float32 or not hk.is_contiguous()
          or hk.device != a.device):
        raise ValueError(f"hk must be contiguous float32 (B, ceil(T / "
                         f"{CHECKPOINT}), d, N) on {a.device}")
    lib = _library()
    da, dbx = torch.empty_like(a), torch.empty_like(bx)
    dc, dh0 = torch.empty_like(c), torch.empty_like(h0)
    dcp = torch.empty(backward_scratch_shapes(B, T, d, N)[0],
                      dtype=torch.float32, device=a.device)
    _launch("ssm_scan_backward", lib.ssm_scan_backward_launch, a.data_ptr(),
            bx.data_ptr(), c.data_ptr(), hk.data_ptr(), dy.data_ptr(),
            dhT.data_ptr(), da.data_ptr(), dbx.data_ptr(), dc.data_ptr(),
            dh0.data_ptr(), dcp.data_ptr(), B, T, d, N, counts=_LAUNCHES)
    return da, dbx, dc, dh0


@torch.library.custom_op("repro_torch::ssm_scan_forward", mutates_args=())
def _forward_op(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _forward(a, bx, c, h0)


@_forward_op.register_fake
def _(a, bx, c, h0):
    return a.new_empty(a.shape[:3]), torch.empty_like(h0)


@torch.library.custom_op("repro_torch::ssm_scan_forward_checkpoints",
                         mutates_args=())
def _forward_checkpoints_op(a: torch.Tensor, bx: torch.Tensor,
                            c: torch.Tensor, h0: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    return _forward(a, bx, c, h0, checkpoints=True)


@_forward_checkpoints_op.register_fake
def _(a, bx, c, h0):
    B, T, d, N = a.shape
    return (a.new_empty((B, T, d)), torch.empty_like(h0),
            a.new_empty((B, -(-T // CHECKPOINT), d, N)))


@torch.library.custom_op("repro_torch::ssm_scan_backward", mutates_args=())
def _backward_op(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                 h0: torch.Tensor, dy: torch.Tensor, dhT: torch.Tensor,
                 hk: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    return ssm_scan_backward(a, bx, c, h0, dy, dhT, hk=hk)


@_backward_op.register_fake
def _(a, bx, c, h0, dy, dhT, hk):
    return tuple(torch.empty_like(x) for x in (a, bx, c, h0))


class SsmScanFunction(torch.autograd.Function):
    """:func:`ssm_scan` with its gradient: the forward kernel (or plain
    version) forward, :func:`ssm_scan_backward` backward.  Keeps the
    inputs and, on the card, the forward's checkpoints h_{16 k}; the states
    between them are recomputed in the backward."""

    @staticmethod
    def forward(ctx, a, bx, c, h0):
        if a.device.type == "cpu":
            ctx.save_for_backward(a, bx, c, h0)
            return _forward_op(a, bx, c, h0)
        y, hT, hk = _forward_checkpoints_op(a, bx, c, h0)
        ctx.save_for_backward(a, bx, c, h0, hk)
        return y, hT

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dhT):
        a, bx, c, h0, *hk = ctx.saved_tensors
        dy = torch.zeros((*a.shape[:3],), dtype=torch.float32,
                         device=a.device) if dy is None else \
            dy.float().contiguous()
        dhT = torch.zeros_like(h0) if dhT is None else \
            dhT.float().contiguous()
        grads = _backward_op(a, bx, c, h0, dy, dhT, hk[0] if hk else None)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def ssm_scan(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, bx: (B, T, d, N) fp32; c: (B, T, N); h0: (B, d, N).  Returns
    (y (B, T, d), hT (B, d, N)), fp32.  Any T and d; on the card N must
    divide 32.

    Under grad mode with an input that requires a gradient this runs
    through :class:`SsmScanFunction`, whose backward is the backward
    kernel on the card and its plain version on the CPU."""
    _check(a, bx, c, h0)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (a, bx, c, h0)):
        return SsmScanFunction.apply(a, bx, c, h0)
    return _forward_op(a, bx, c, h0)
