"""Build and load the port's CUDA kernels.

``csrc/segmented.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded through ``ctypes``.  The build
happens at first use, into ``build/repro_torch/`` at the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides it); the library's file name carries a
hash of the source and flags, so an edited source builds anew.  Nothing is
compiled or imported when this module is imported.
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

__all__ = ["NVCC_FLAGS", "SOURCE", "build_dir", "build_log", "library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "segmented.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"libsegmented-{digest}.so"


def build_log() -> Path:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) for the current library."""
    return _lib_path().with_suffix(".log")


def _compile(lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, check=False)
        build_log().write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if it is not built yet."""
    lib_path = _lib_path()
    if not lib_path.exists():
        _compile(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "seg_histogram_launch": [ptr, ptr, i32, i32, ptr, ptr],
        "seg_count_launch": [ptr, ptr, ptr, i32, i32, i32, ptr, ptr],
        "seg_apply_launch": [ptr, ptr, ptr, i32, i32, ptr, ptr, ptr],
        "seg_stats_launch": [ptr, ptr, i32, i32, ptr, ptr, ptr],
        "seg_encode_launch": [ptr, ptr, ptr, ptr, i32, i32, ptr, ptr, ptr,
                              ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    return lib
