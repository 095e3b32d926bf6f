"""CUDA graphs of a round's device work: the replay engine of the scan form
(:class:`~repro_torch.core.federated.CohortScan`), the port's counterpart of
the reference's ``lax.scan`` over rounds.

:class:`CapturedRound` captures one call of a round's ``compute`` part
(``federated.RoundParts``) into a ``torch.cuda.CUDAGraph`` and replays it.
The graph reads and writes only buffers it owns:

* the static inputs, copies of the first call's arguments: the global
  parameters, the per-client state the round carries (error-feedback
  residuals, FedDyn drift, the norm EMA), the stacked batches and sizes, the
  round's selection (cohort ids, participation, weights) and its draws
  (random-mask scores, attack noise).  The caller copies the server's state
  in with :meth:`CapturedRound.load`, each round's selection and draws with
  :meth:`CapturedRound.replay` and each round's new parameters with
  :meth:`CapturedRound.set_params`;
* the carried state, which the graph commits in place at its end, so one
  replay feeds the next;
* the outputs (payload, finite flags, weights, losses), valid until the
  next replay.

Before the capture the round runs once on a side stream, on the buffers'
copies of the state, so lazily built handles and workspaces exist before
the graph records them; the warm-up and the capture share the graph's own
store of device constants (``kernels.packing.keep_device_constants``: the
packed buffer's segment map and per-segment k, the adversary mask), built
by the warm-up and kept as long as the graph.  The warm-up's results are
thrown away, so it advances no state and consumes no draw.  Every warm-up
and capture on a device runs on one stream: cuBLAS keeps a workspace for
each (handle, stream) for the life of the process, so a stream of its own
for each graph would leave one behind for each.  The capture and
every replay run with ``torch.cuda.set_sync_debug_mode("error")``: a host
synchronisation left inside the captured part raises.

Launch counts: a kernel wrapper counts at its Python call, which runs only
at capture.  The capture's increments are taken back and kept as the
graph's tally, and every replay adds the tally, so the counts equal the
eager loop's.  The warm-up's launches are build work and are not counted.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.kernels.packing import keep_device_constants

__all__ = ["CapturedRound", "signature"]


def _counters() -> Tuple[Dict[str, int], ...]:
    """Every kernel wrapper's launch-count dict."""
    from repro_torch.kernels import segmented, ssm_scan, topk_mask, wkv6
    return tuple(m._LAUNCHES for m in (segmented, topk_mask, wkv6, ssm_scan))


def _snapshot(counts) -> List[Dict[str, int]]:
    return [dict(d) for d in counts]


def _restore(counts, saved) -> None:
    for d, s in zip(counts, saved):
        d.clear()
        d.update(s)


def _clone(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _copy_into(dst: Any, src: Any) -> None:
    """Copy ``src`` into the buffers of ``dst``, a tree of the same
    structure and shapes."""
    if isinstance(dst, torch.Tensor):
        if src is dst:
            return
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"a graph input of shape {tuple(dst.shape)} "
                             f"got {tuple(src.shape)}")
        dst.copy_(src)
    elif isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"graph input keys {sorted(dst)} got "
                             f"{sorted(src)}")
        for k, v in dst.items():
            _copy_into(v, src[k])
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError(f"{len(dst)} graph inputs got {len(src)}")
        for d, s in zip(dst, src):
            _copy_into(d, s)
    elif dst is not None or src is not None:
        raise ValueError("a graph input is None on one side only")


def signature(tree: Any) -> Any:
    """The structure, shapes, dtypes and devices of a tree of tensors: a
    graph captured for one signature replays only for its own."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(signature(v) for v in tree)
    return None


_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one side stream of ``device`` that warms up and captures every
    graph."""
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


@contextlib.contextmanager
def _sync_errors():
    """Within the block a host synchronisation on the card raises."""
    saved = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(saved)


class CapturedRound:
    """One round's ``compute(params, carried, client_batches, n_samples,
    inputs, mask_scores, attack_noise) -> (new_carried, outs)`` captured
    into a CUDA graph (see the module docstring).  ``args`` is the first
    round's arguments, whose copies become the graph's input buffers;
    ``pool`` a memory pool shared with other graphs
    (``torch.cuda.graph_pool_handle()``), or None for the graph's own."""

    def __init__(self, compute: Callable, args: tuple, pool=None):
        self.static = _clone(tuple(args))
        (self.params, self.carried, self.batches, self.n_samples,
         self.inputs, self.mask_scores, self.attack_noise) = self.static
        device = self.n_samples.device
        counts = _counters()
        saved = _snapshot(counts)
        self.constants: Dict[Any, torch.Tensor] = {}
        side = _capture_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with keep_device_constants(self.constants):
            with torch.cuda.stream(side):
                compute(*self.static)
            torch.cuda.current_stream(device).wait_stream(side)
            _restore(counts, saved)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool, stream=side):
                with _sync_errors():
                    new_carried, self.outs = compute(*self.static)
                    _copy_into({k: self.carried[k] for k in new_carried},
                               new_carried)
        after = _snapshot(counts)
        self.tally = [(d, name, a[name] - s.get(name, 0))
                      for d, s, a in zip(counts, saved, after)
                      for name in a if a[name] != s.get(name, 0)]
        _restore(counts, saved)

    def load(self, params, carried, client_batches, n_samples) -> None:
        """Copy the server's parameters, carried state, batches and sizes
        into the graph's buffers (at the start of a segment)."""
        _copy_into(self.params, params)
        _copy_into(self.carried, carried)
        _copy_into(self.batches, client_batches)
        _copy_into(self.n_samples, n_samples)

    def set_params(self, params) -> None:
        """Copy the next round's global parameters into the graph."""
        _copy_into(self.params, params)

    def replay(self, inputs, mask_scores=None, attack_noise=None
               ) -> Dict[str, Any]:
        """Copy one round's selection and draws in, replay the graph and
        add its launches to the kernels' counts; returns the graph's
        outputs (valid until the next replay)."""
        with _sync_errors():
            _copy_into(self.inputs, inputs)
            _copy_into(self.mask_scores, mask_scores)
            _copy_into(self.attack_noise, attack_noise)
            self.graph.replay()
        for counts, name, n in self.tally:
            counts[name] += n
        return self.outs
