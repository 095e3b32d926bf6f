"""Per-device operation counts of an eager step (counterpart of
``repro/launch/hlo.py``, which reads them from XLA's partitioned HLO).

:class:`OpStats` is a ``TorchDispatchMode``.  It lets DTensor desugar each
sharded op first (it returns ``NotImplemented`` for DTensor arguments), so
it sees what one rank runs: the products on its local shards and the
collectives DTensor issues.  Counting at the DTensor level would count the
global product instead.  Every count is PER DEVICE:

* ``flops`` -- matmuls, batched matmuls and convolutions on local shards
  (``torch.utils.flop_counter``'s formulas: 2 x output x contraction).
* ``collective_bytes`` -- per family, the reference's convention
  (``hlo.py``): all-gather counts its output bytes; reduce-scatter and
  all-to-all their operand bytes; all-reduce twice its operand bytes
  (ring = reduce-scatter + all-gather).  DTensor issues no permutes.
* ``kernel_bytes`` / ``kernel_flops`` -- the hand-written kernels
  (``repro_torch::wkv6_*``, ``repro_torch::ssm_scan_*`` custom ops), one op
  each, with the bytes and operations their bounds count (PERF.md §6):
  inputs read once, outputs written once.
* ``hbm_bytes`` -- an eager traffic model: every op that makes a new
  tensor reads its operands and writes its outputs once (views and
  in-place results are not new), an upper bound of what fusion moves.
* ``peak_bytes`` -- the most bytes of tensors made under the mode alive at
  once (views and in-place results not counted again).

Under ``FakeTensorMode`` on the fake process group (``launch/dryrun.py``)
nothing runs and nothing is allocated: shapes, dtypes and placements are
all the counts need.

DTensor's sharding propagation runs ops of its own to learn an output's
shape or placement: on fake stand-ins of the GLOBAL shapes (from the
dry run's own fake mode, so their mode does not tell them apart), or
through an op's decomposition on meta stand-ins (``softplus_backward``).
No rank computes them.  While the mode is on it wraps the propagator's
two entry points (``_PROPAGATION``) and counts nothing dispatched inside
them (``propagation_ops`` says how many it left out).
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["OpStats", "kernel_work"]

_GATHER = ("all_gather_into_tensor", "all_gather_into_tensor_coalesced",
           "allgather_", "_allgather_base_", "allgather_into_tensor_coalesced_")
_ALL_REDUCE = ("all_reduce", "all_reduce_coalesced", "allreduce_",
               "allreduce_coalesced_")
_SCATTER = ("reduce_scatter_tensor", "reduce_scatter_tensor_coalesced",
            "reduce_scatter_", "_reduce_scatter_base_")
_TO_ALL = ("all_to_all_single", "alltoall_base_", "alltoall_")
_FAMILY = {**{n: "all-gather" for n in _GATHER},
           **{n: "all-reduce" for n in _ALL_REDUCE},
           **{n: "reduce-scatter" for n in _SCATTER},
           **{n: "all-to-all" for n in _TO_ALL}}


def _tensors(x):
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# The two entry points through which DTensor's dispatcher runs sharding
# propagation (the cached one and the one it wraps); every path of it,
# fake tensors of the global shapes or a decomposition traced on meta
# stand-ins, runs inside one of them.
_PROPAGATION = ("propagate_op_sharding", "propagate_op_sharding_non_cached")


def _propagator():
    """DTensor's ``ShardingPropagator``, refused if it lacks either entry
    point: every op of its propagation would then be counted as a rank's."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    missing = [n for n in _PROPAGATION if not callable(getattr(prop, n, None))]
    if missing:
        raise ImportError(
            f"torch {torch.__version__}: ShardingPropagator lacks {missing}; "
            f"op_stats cannot tell DTensor's sharding propagation from the "
            f"ops a rank runs")
    return prop


def kernel_work(name: str, args) -> Dict[str, float]:
    """Bytes (inputs read once, outputs written once) and operations of
    one hand-written kernel call, as its bound counts them."""
    if name.startswith("wkv6"):
        B, T, H, D = args[0].shape
        if name == "wkv6_forward":
            return {"bytes": 4 * (5 * B * T * H * D + 2 * B * H * D * D
                                  + H * D),
                    "flops": B * H * T * (5 * D * D + 5 * D)}
        return {"bytes": 4 * (9 * B * T * H * D + 3 * B * H * D * D
                              + 2 * H * D),
                "flops": B * H * T * (14 * D * D + 12 * D)}
    B, T, d, N = args[0].shape
    if name == "ssm_scan_backward":
        return {"bytes": 4 * (4 * B * T * d * N + 2 * B * T * N
                              + 3 * B * d * N + B * T * d),
                "flops": 8 * B * T * d * N}
    extra = 4 * B * -(-T // 16) * d * N if name.endswith("checkpoints") \
        else 0
    return {"bytes": 4 * (2 * B * T * d * N + B * T * N + 2 * B * d * N
                          + B * T * d) + extra,
            "flops": 4 * B * T * d * N}


class OpStats(TorchDispatchMode):
    """Counts of the ops one rank runs while the mode is on (see the
    module docstring); read them from the attributes, or ``summary()``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.kernel_bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_calls: Dict[str, int] = defaultdict(int)
        self.per_collective: Dict[str, float] = defaultdict(float)
        self.collective_count: Dict[str, int] = defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.dot_flops: Dict[str, float] = defaultdict(float)
        # ops of DTensor's sharding propagation seen and left out
        self.propagation_ops = 0
        self._inside = 0            # depth of propagation calls running
        self._patched: Dict[str, object] = {}

    def __enter__(self):
        """Wrap the propagator's entry points (on the instance, restored
        on exit): an op dispatched while one of them runs is one of
        propagation's stand-ins, which no rank computes."""
        prop = _propagator()
        for name in _PROPAGATION:
            self._patched[name] = prop.__dict__.get(name)
            prop.__dict__[name] = self._guarded(getattr(prop, name))
        return super().__enter__()

    def __exit__(self, *exc):
        prop = _propagator()
        for name, saved in self._patched.items():
            if saved is None:
                del prop.__dict__[name]
            else:
                prop.__dict__[name] = saved
        self._patched = {}
        return super().__exit__(*exc)

    def _guarded(self, fn):
        def propagate(*args, **kwargs):
            self._inside += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._inside -= 1
        return propagate

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.per_collective.values()))

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _track(self, func, out) -> int:
        """Count ``func``'s new output tensors as live until freed."""
        made = 0
        schema = func._schema
        if func.is_view:
            return 0
        outs = _tensors(out)
        rets = schema.returns
        for i, t in enumerate(outs):
            if i < len(rets) and rets[i].alias_info is not None:
                continue
            n = t.numel() * t.element_size()
            made += n
            self.live_bytes += n
            weakref.finalize(t, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return made

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor desugar to local ops
        out = func(*args, **kwargs)
        if self._inside:
            self.propagation_ops += 1
            return out
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        if packet in self._flop_registry:
            f = self._flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            shapes = "x".join(str(tuple(t.shape)) for t in _tensors(args))
            self.dot_flops[f"{name} {shapes}"] += f
        if ns in ("_c10d_functional", "c10d_functional", "c10d") and \
                name in _FAMILY:
            family = _FAMILY[name]
            if family == "all-gather":
                moved = _nbytes(_tensors(out)) if ns != "c10d" else \
                    _nbytes(_tensors(args[0]))
            elif family == "all-reduce":
                moved = 2 * _nbytes(_tensors(args[0]))
            else:
                moved = _nbytes(_tensors(args[0]))
            self.per_collective[family] += moved
            self.collective_count[family] += 1
        elif ns == "repro_torch":
            work = kernel_work(name, args)
            self.kernel_bytes += work["bytes"]
            self.kernel_flops += work["flops"]
            self.kernel_calls[name] += 1
        made = self._track(func, out)
        if made and ns not in ("_c10d_functional", "c10d", "repro_torch"):
            self.hbm_bytes += made + _nbytes(_tensors(args))
        return out

    def summary(self) -> dict:
        """The counts as a JSON-ready dict; ``top_dots``: the eight op and
        shape groups with the most FLOPs."""
        top = sorted(self.dot_flops.items(), key=lambda kv: -kv[1])[:8]
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "per_collective": dict(self.per_collective),
                "collective_count": dict(self.collective_count),
                "kernel_bytes": self.kernel_bytes,
                "kernel_flops": self.kernel_flops,
                "kernel_calls": dict(self.kernel_calls),
                "peak_bytes": self.peak_bytes,
                "propagation_ops": self.propagation_ops,
                "top_dots": [[f, n] for n, f in top]}
