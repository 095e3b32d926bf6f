"""Production meshes (counterpart of ``repro/launch/mesh.py``) as
``torch.distributed`` ``DeviceMesh`` objects.

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").  Multi-pod: 2 x
16 x 16 = 512 ranks, axes ("pod", "data", "model"); the "pod" axis carries
only data parallelism, so one gradient or parameter reduction a step
crosses pods.

Every mesh here is built on the default process group, which the caller
initialises first: NCCL on cards, gloo on the CPU, or the fake backend
(``torch.testing._internal.distributed.fake_pg``) for the dry run
(``launch/dryrun.py``), which needs neither cards nor memory.

The roofline constants are the NVIDIA H100 SXM5 data sheet's, per card.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["PEAK_FLOPS_BF16", "HBM_BW", "HBM_BYTES", "NVLINK_BW",
           "mesh_device_type", "make_mesh", "make_production_mesh",
           "make_cohort_mesh", "data_axes", "num_chips", "axis_size"]

# H100 SXM5 data sheet, per card
PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12              # HBM3 bytes/s
HBM_BYTES = 80e9              # HBM3 capacity
NVLINK_BW = 450e9             # NVLink 4 bytes/s each way


def mesh_device_type() -> str:
    """"cuda" when the default process group runs NCCL, else "cpu" (gloo
    and the fake backend)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the default group's ranks, its
    dims named ``names``, with every set of two or more dims of more than
    one rank also flattened into one dim (``DeviceMesh._flatten``, named
    by joining the names with "_").  DTensor then reduces a sum partial
    over several dims in one collective over their flattened group (one
    all-reduce for (Partial, Partial) -> (Replicate, Replicate)) where it
    would otherwise issue one a dim, one after another.  Every rank makes
    the same groups in the same order, here, before any step runs."""
    mesh = init_device_mesh(device_type or mesh_device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))
    wide = [n for n, k in zip(names, shape) if k > 1]
    for r in range(2, len(wide) + 1):
        for dims in itertools.combinations(wide, r):
            mesh[dims]._flatten()
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``: the default group must have 256 or 512
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_cohort_mesh(num_devices: Optional[int] = None,
                     device_type: Optional[str] = None) -> DeviceMesh:
    """1-D mesh ("clients",) carrying the cohort engine's client axis, over
    the first ``num_devices`` ranks (all of them by default)."""
    n = num_devices or dist.get_world_size()
    return DeviceMesh(device_type or mesh_device_type(), torch.arange(n),
                      mesh_dim_names=("clients",))


def data_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The batch and FSDP axes: every axis but "model"."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def axis_size(mesh: DeviceMesh, axes) -> int:
    """The number of ranks along ``axes`` (a name, a tuple of names, or
    None for 1)."""
    if axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = mesh.mesh_dim_names
    size = 1
    for a in axes:
        size *= mesh.shape[names.index(a)]
    return size


def num_chips(mesh: DeviceMesh) -> int:
    """Ranks in the mesh."""
    return int(mesh.size())
