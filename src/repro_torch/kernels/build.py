"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together) and linked into one shared library with
a plain C interface, loaded through ``ctypes``.  The build happens at first
use, into ``build/repro_torch/`` at the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides it); the library's file name carries a
hash of every source and the flags, so an edited source builds anew.
Nothing is compiled or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "SIGNATURES", "SOURCES", "build_dir", "build_log",
           "library", "load"]

SOURCES = tuple(sorted(
    (Path(__file__).resolve().parent / "csrc").glob("*.cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    """Where the compiled library goes (listed in ``.gitignore``)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _lib_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"libkernels-{digest.hexdigest()[:16]}.so"


def build_log() -> Path:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) for the current library, all sources in turn."""
    return _lib_path().with_suffix(".log")


def _compile(lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs = [(src, proc.communicate()[0], proc.returncode)
                for src, proc in zip(SOURCES, procs)]
        build_log().write_text("".join(f"== {src.name}\n{out}"
                                       for src, out, _ in logs))
        for src, out, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}) on {src}:\n"
                                   f"{out[-4000:]}")
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_lib), *map(str, objs)],
            capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr[-4000:]}")
        os.replace(tmp_lib, lib)


# The C launchers of csrc/ and their arguments; each returns a cudaError.
_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "seg_histogram_launch": [_PTR, _PTR, _I32, _I32, _PTR, _PTR],
    "seg_count_launch": [_PTR, _PTR, _PTR, _I32, _I32, _I32, _PTR, _PTR],
    "seg_apply_launch": [_PTR, _PTR, _PTR, _I32, _I32, _PTR, _PTR, _PTR],
    "seg_stats_launch": [_PTR, _PTR, _I32, _I32, _PTR, _PTR, _PTR],
    "seg_encode_launch": [_PTR, _PTR, _PTR, _PTR, _I32, _I32, _PTR, _PTR,
                          _PTR, _PTR],
    "topk_histogram_launch": [_PTR, _I64, _PTR, _PTR],
    "topk_count_launch": [_PTR, _I64, _PTR, _PTR, _PTR],
    "topk_apply_launch": [_PTR, _I64, _PTR, _PTR, _PTR],
    "wkv6_launch": [_PTR] * 8 + [_I32] * 4 + [_PTR],
    "wkv6_config": [_I32, _PTR, _PTR, _PTR],
    "ssm_scan_launch": [_PTR] * 6 + [_I32] * 4 + [_PTR],
    "ssm_scan_checkpoint_launch": [_PTR] * 7 + [_I32] * 4 + [_PTR],
    "ssm_scan_backward_launch": [_PTR] * 11 + [_I32] * 4 + [_PTR],
    "ssm_scan_backward_config": [_I32] * 2 + [_PTR],
    "wkv6_backward_launch": [_PTR] * 18 + [_I32] * 4 + [_PTR],
    "wkv6_backward_config": [_I32] * 2 + [_PTR],
}


def load(path: Path, names=tuple(SIGNATURES)) -> ctypes.CDLL:
    """Load a library built from ``csrc/`` and declare its C launchers
    ``names`` (all of :data:`SIGNATURES` by default)."""
    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = _I32
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if it is not built yet."""
    lib_path = _lib_path()
    if not lib_path.exists():
        _compile(lib_path)
    return load(lib_path)
