"""Build and load the port's CUDA kernels (``avsr_tpu_torch/csrc/*.cu``).

All sources compile, with ``nvcc`` for ``sm_90a``, into one shared library
with a plain C interface, which is loaded with ``ctypes``; no source includes
PyTorch's headers, so a build takes seconds. The library lands in
``build/avsr_tpu_torch/`` under the checkout at first use, named by a hash
of the sources and flags, so an edited source rebuilds and an unchanged one
is loaded as it is. The compiler's ``-Xptxas -v`` report (registers, shared
memory, spills per kernel) is kept beside the library as ``.log``.

Nothing is built when this module is imported: the CPU tests import every
module, and this machine class has no ``nvcc``. A build or load failure
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "avsr_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[name]


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libavsr_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> tuple[Path, float]:
    """Compile the library if it is missing. Returns (path, seconds spent)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sorted(CSRC_DIR.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out, seconds


@functools.cache
def library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.avsr_error_string.argtypes = [ctypes.c_int]
    lib.avsr_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def function(name: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """A launch function of the library with its C signature declared."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    if err != 0:
        msg = library().avsr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
