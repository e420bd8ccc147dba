"""Build a CUDA source of the port with nvcc and load it with ctypes.

Each kernel file under csrc/ exposes a plain C interface: every entry
point launches on the stream it is given and returns a cudaError_t code,
0 when the launch went through. `CudaLibrary` compiles one file for
sm_90a into build/torch_ext/ (keyed by a hash of the source, the
headers of csrc/ and the flags, so a changed source builds anew), loads it, declares the entry
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
    names the function that turns an error code into a message. With
    `parts` > 1 the source is compiled that many times at once, each run
    with -DGATLING_PART=k defining a share of the entry points (and so of
    the template instances), and the objects are linked into one library:
    the build takes the longest part's time, not the sum."""

    def __init__(self, source: str, entry_points: dict[str, list], error_fn: str,
                 parts: int = 1) -> None:
        src_path = CSRC / source
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        tag = hashlib.sha1(src_path.read_bytes() + headers + " ".join(FLAGS).encode()
                           + str(parts).encode()).hexdigest()[:12]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.path = BUILD_DIR / f"libgatling_{src_path.stem}_{tag}.so"
        self.build_seconds = 0.0
        self.ptxas_log = ""
        if not self.path.exists():
            t0 = time.perf_counter()
            self.ptxas_log = self._build(src_path, parts)
            self.build_seconds = time.perf_counter() - t0
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

    def _build(self, src_path: Path, parts: int) -> str:
        """nvcc runs into a temporary file renamed onto self.path; returns
        their ptxas reports."""
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        if parts == 1:
            runs = [[_nvcc(), *FLAGS, "-o", str(tmp), str(src_path)]]
        else:
            objs = [self.path.with_suffix(f".{os.getpid()}.part{k}.o") for k in range(parts)]
            compile_flags = [f for f in FLAGS if f != "-shared"]
            runs = [[_nvcc(), *compile_flags, f"-DGATLING_PART={k}", "-c", "-o", str(obj),
                     str(src_path)] for k, obj in enumerate(objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for cmd in runs]
        # wait for every run before reporting a failure: none is left running
        logs = [proc.communicate()[1] for proc in procs]
        for proc, err in zip(procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src_path}:\n{err}")
        if parts > 1:
            res = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                                 capture_output=True, text=True)
            for obj in objs:
                obj.unlink(missing_ok=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed to link {src_path}:\n{res.stderr}")
        os.replace(tmp, self.path)
        return "".join(logs)

    def call(self, name: str, *args) -> None:
        rc = self._fns[name](*args)
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed: {self._err(rc).decode()}")

    @staticmethod
    def stream(t: torch.Tensor) -> int:
        """The raw handle of the current stream on t's card, from the getter
        PyTorch's own generated kernels call: torch.cuda.current_stream()
        builds a Stream object on every call, a large share of a small
        launch's host time (chip_smoke.py phase P times both)."""
        return torch._C._cuda_getCurrentRawStream(t.get_device())
