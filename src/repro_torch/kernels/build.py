"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, which the wrappers
load through ``ctypes``. Builds happen at first use, from the sources in
this checkout only, into ``build/`` at the repository root; a library's
file name carries a hash of its sources, so an edited kernel is rebuilt and
a stale one is never loaded. ``build_all`` starts one ``nvcc`` per source
at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = (
    "gmm_ragged", "gmm_fused_ffn", "flash_decode", "flash_decode_paged",
    "flash_attention",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels are built from source at first use"
        )
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together. Returns per source
    the build seconds (0.0 when already built) and nvcc's ``-Xptxas -v``
    report. Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    report: dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "ptxas": "", "path": str(out)}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
            Path(tmp).unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        report[name] = {
            "seconds": time.perf_counter() - t0, "ptxas": log, "path": str(out),
        }
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (built first if needed), loaded once per
    process."""
    path = lib_path(name)
    if not path.exists():
        build_all((name,))
    return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=None)
def entry(lib_name: str, fn_name: str, n_ptrs: int, n_ints: int):
    """A C entry point ``int fn(void* x n_ptrs, int x n_ints, void* stream)``
    with its ctypes signature declared (pointers as ``c_void_p`` so they
    are never cut to 32 bits)."""
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


# Per device, the zeroed int32 counters on which the blocks of a split
# launch count their arrivals (the split-KV decode attention per (request,
# KV head), the decode GMM per (group, column strip)); the last block of
# each resets its counter, so every launch leaves them zero for the next
# one on the stream. They live here, not with the caller, because the
# wrappers keep the JAX package's signatures; launches that share them run
# in order on one stream, so no call sees a value another call left.
_ARRIVED: dict = {}


def arrival_counters(device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed counters on ``device``, kept across calls (a
    larger set replaces them when a call needs more)."""
    buf = _ARRIVED.get(device)
    if buf is None or buf.numel() < n:
        buf = _ARRIVED[device] = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
    return buf
