"""Build a CUDA source of the port with nvcc and load it with ctypes.

Each kernel file under csrc/ exposes a plain C interface: every entry
point launches on the stream it is given and returns a cudaError_t code,
0 when the launch went through. `CudaLibrary` compiles one file for
sm_90a into build/torch_ext/ (keyed by a hash of the source and the
flags, so a changed source builds anew), loads it, declares the entry
points' argument types and raises when a build or a launch fails.

The flags include -fmad=false: no contraction of a*b+c into a fused
multiply-add, so the kernels round like their plain PyTorch twins and
agree with them on every ray. Contraction is about 8 % faster per launch
of the bounce kernel on an H100 but moves a few rays per 2.88M off the
twin's path (PERF.md, Findings). A source with PyTorch's headers would
take minutes to build; these take seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_REPO = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = _REPO / "build" / "torch_ext"
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-fmad=false")
# ctypes argument types of the C interfaces
PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc", "/usr/local/cuda/bin/nvcc",
                 shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from csrc/ at first use "
                       "(set CUDA_HOME)")


def check_tensor(kernel: str, name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype`."""
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{kernel} kernel: {name} must be a contiguous CUDA {dtype} tensor, "
                         f"got {t.device} {t.dtype}")


class CudaLibrary:
    """csrc/<source> built into a shared library and loaded with ctypes.
    `entry_points` maps each C function to its argument types; `error_fn`
    names the function that turns an error code into a message."""

    def __init__(self, source: str, entry_points: dict[str, list], error_fn: str) -> None:
        src_path = CSRC / source
        tag = hashlib.sha1(src_path.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.path = BUILD_DIR / f"libgatling_{src_path.stem}_{tag}.so"
        self.build_seconds = 0.0
        self.ptxas_log = ""
        if not self.path.exists():
            t0 = time.perf_counter()
            tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run([_nvcc(), *FLAGS, "-o", str(tmp), str(src_path)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src_path}:\n{res.stderr}")
            os.replace(tmp, self.path)
            self.build_seconds = time.perf_counter() - t0
            self.ptxas_log = res.stderr
        lib = ctypes.CDLL(str(self.path))
        self._fns = {}
        for name, args in entry_points.items():
            fn = getattr(lib, name)
            fn.restype = I32
            fn.argtypes = args
            self._fns[name] = fn
        self._err = getattr(lib, error_fn)
        self._err.restype = ctypes.c_char_p
        self._err.argtypes = [I32]

    def call(self, name: str, *args) -> None:
        rc = self._fns[name](*args)
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed: {self._err(rc).decode()}")

    @staticmethod
    def stream(t: torch.Tensor) -> int:
        return torch.cuda.current_stream(t.device).cuda_stream
