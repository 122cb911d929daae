"""Build the CUDA C++ kernels of ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (the TMA + wgmma sources
share ``csrc/sm90.cuh``) and is compiled on first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared`` into ``build/kernels/`` at the
repository root (listed in ``.gitignore``). The library's file name carries
a hash of the source, the shared headers and the flags, so an edited source
or header is rebuilt and a stale library is never loaded. A build of one source
takes seconds, against minutes for an extension that includes PyTorch's
headers.

Wrapper rules (see the kernel modules): every pointer and the stream go
through ``ctypes.c_void_p``, the launch goes on
``torch.cuda.current_stream()``, and each C entry returns
``cudaGetLastError()``, which ``check`` turns into an exception.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LOGS: dict = {}  # name -> the compiler's output of its build in this process


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "host with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``: its name hashes the source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    parts = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: Path) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names) -> dict:
    """Compile every named source that has no current library, all nvcc
    processes at once. Returns {name: seconds its build took (0.0 when the
    library was already there)} and keeps each build's compiler output,
    ptxas's registers and memory of each kernel included, in ``LOGS``;
    raises with the compiler's output on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(_command(name, tmp),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (its cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
