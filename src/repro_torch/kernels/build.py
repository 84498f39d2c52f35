"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``; no
PyTorch headers are involved, so a build takes seconds. Builds happen at
first use, into ``_build/`` next to this file (listed in ``.gitignore``),
named by a hash of the source and flags so an edited source rebuilds.
``build()`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module on
machines with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = ("unq_encode", "topl_scan", "rerank_dist", "adc_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: dynamic shared memory a block may use on Hopper
MAX_SMEM_BYTES = 232_448
#: queries per block the table-holding kernels are built for, largest first
BLOCK_QS = (8, 4, 2, 1)


def largest_block_q(smem_of, what: str) -> int:
    """The largest of ``BLOCK_QS`` whose block shared memory
    ``smem_of(bq)`` fits in ``MAX_SMEM_BYTES``. Raises ValueError, naming
    the bytes ``what`` needs at one query per block, when none fits."""
    for bq in BLOCK_QS:
        if smem_of(bq) <= MAX_SMEM_BYTES:
            return bq
    raise ValueError(
        f"{what} needs {smem_of(1)} B of shared memory per block even at "
        f"one query per block, above the {MAX_SMEM_BYTES} B a Hopper "
        "block can use")


@dataclasses.dataclass
class BuildResult:
    name: str
    path: pathlib.Path
    seconds: float      # 0.0 when an up-to-date library was reused
    log: str            # nvcc's output (ptxas register / smem report)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [pathlib.Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(pathlib.Path(found))
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _lib_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, BuildResult]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all running at once. Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: dict[str, BuildResult] = {}
    running = {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            results[name] = BuildResult(name, path, 0.0, "")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        path = _lib_path(name)
        os.replace(tmp, path)
        results[name] = BuildResult(name, path, seconds, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return results


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    return ctypes.CDLL(str(build((name,))[name].path))


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launcher returned a nonzero ``cudaGetLastError()``."""
    if err:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} launch failed: cuda error {err} "
                           f"({fn(err).decode()})")


def check_cuda_tensor(t: torch.Tensor, name: str, dtype, shape,
                      device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and
    shape on ``device`` (the kernels take nothing else)."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
            f"(contiguous={t.is_contiguous()})")


def check_sm90(device: torch.device) -> None:
    """The libraries are compiled for sm_90a only."""
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(f"the CUDA kernels are built for sm_90a (Hopper); "
                           f"{torch.cuda.get_device_name(device)} is "
                           f"sm_{cap[0]}{cap[1]}")
