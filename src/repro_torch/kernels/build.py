"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each kernel is a ``csrc/*.cu`` file with a plain C launch function, so
a build is one ``nvcc`` call (seconds, no PyTorch headers).  Sources are
compiled at first use into ``_build/`` next to this file (listed in
``.gitignore``), one shared library per source, named by a hash of the
source and the flags: an edited source never loads a stale library.
``build`` starts one ``nvcc`` per missing library, all at once.

Nothing here falls back: a missing ``nvcc``, a failed build or a
refused launch raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# compiler output (ptxas register / spill lines) of the builds made by
# this process, by source name
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    """The ``nvcc`` on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (not on PATH, not under CUDA_HOME or "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def library_path(source: str) -> Path:
    """Where the shared library of ``csrc/<source>`` lives once built."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):        # sources and headers
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build(sources: Sequence[str]) -> Dict[str, Path]:
    """Build every missing library of ``sources`` in parallel (one
    ``nvcc`` each, all started together); returns source -> library."""
    out = {s: library_path(s) for s in sources}
    todo = [s for s in dict.fromkeys(sources) if not out[s].exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for s in todo:
        tmp = out[s].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for s, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[s] = log
        if proc.returncode != 0:
            failed.append(f"{s} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[s])                  # atomic publish
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


class CudaKernel:
    """One hand-written kernel behind a plain C launch function.

    ``launch`` calls the C function on the given arguments and raises
    if it returns a nonzero ``cudaGetLastError()``; ``launches`` counts
    the launches that succeeded, and nothing else adds to it."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: List[type]):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib = None
        self._fn = None

    def load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build([self.source])[self.source]))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err_str = lib.repro_cuda_error_string
            err_str.argtypes = [ctypes.c_int]
            err_str.restype = ctypes.c_char_p
            self._lib, self._fn, self._err_str = lib, fn, err_str
        return self._fn

    def launch(self, *args) -> None:
        err = self.load()(*args)
        if err != 0:
            msg = self._err_str(err).decode()
            raise RuntimeError(f"{self.name}: launch failed with CUDA error "
                               f"{err} ({msg})")
        self.launches += 1


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index`` (queried once): what the persistent
    kernels' launch plans take, so that a C call queries nothing."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_SAME_DEVICE = contextlib.nullcontext()


def on_device(t: torch.Tensor):
    """A context in which ``t``'s device is the current one, for a launch:
    a shared no-op when it already is (the usual case: no device swap),
    ``torch.cuda.device`` (two device swaps) only when it is not."""
    idx = t.get_device()
    if idx == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(idx)


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a pointer:
    the raw handle, read without building a ``torch.cuda.Stream`` (the
    call Inductor's generated code makes; ``tests/test_torch_cuda.py``
    holds it to ``torch.cuda.current_stream().cuda_stream``, inside a
    ``torch.cuda.stream`` block too)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require_cuda(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """Check what a kernel takes: a contiguous CUDA tensor of one of
    ``dtypes`` with ``ndim`` dimensions."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def timed_build(kernels: Sequence[CudaKernel]) -> float:
    """Build and load ``kernels`` (all sources at once); returns the
    wall seconds it took."""
    t0 = time.perf_counter()
    build([k.source for k in kernels])
    for k in kernels:
        k.load()
    return time.perf_counter() - t0
