"""Build and load the port's CUDA kernels (``avsr_tpu_torch/csrc/*.cu``).

Every source compiles, with one ``nvcc`` for each, all started together,
for ``sm_90a``; the objects link into one shared library with a plain C
interface, which is loaded with ``ctypes``. No source includes PyTorch's
headers, so a build takes seconds. The library lands in
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[name]


def device_step(pos, device):
    """A decode step as the kernels read it: a (1,) int32 tensor on
    ``device``, which a kernel reads from device memory (as the TPU kernels
    read theirs from SMEM), so that a captured launch reads each replay's
    step. An int (the tools', the tests') becomes one; a tensor must hold
    one int32 or int64 on ``device`` and is not read on the host."""
    import torch

    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1 or pos.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"a step is one int32 or int64, got {pos.dtype} "
                             f"{tuple(pos.shape)}")
        if pos.device != torch.device(device):
            raise ValueError(f"step on {pos.device}, tensors on {device}")
        return pos.reshape(1).to(torch.int32)
    if int(pos) < 0:
        raise ValueError(f"pos must be >= 0, got {pos}")
    # a fill on the device: no copy from the host, which would wait
    return torch.full((1,), int(pos), dtype=torch.int32, device=device)


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
    stem = out.with_name(f"{out.stem}.{os.getpid()}")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = Path(f"{stem}.{src.stem}.o")
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report, failed = [], []
    for src, _, proc in jobs:
        text, _ = proc.communicate()
        report.append(f"==== {src.name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{text[-4000:]}")
    tmp = Path(f"{stem}.tmp.so")
    if not failed:
        proc = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)],
            capture_output=True, text=True)
        report.append(f"==== link (rc {proc.returncode})\n"
                      f"{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(f"link:\n{proc.stderr[-4000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text("\n".join(report))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
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
