"""P2: the matrix-product precision probe (tools/mosaic_precision_probe.py
on the TPU).

A one-hot 128x128 product oh @ x must reproduce x. The JAX probe prints its
error at the TPU's DEFAULT and HIGHEST precisions. Here the kernels of
csrc/probes.cu compute it three ways: "DEFAULT (TF32)", TF32 mma.sync with
operands rounded by cvt.rna.tf32.f32 (to nearest, ties away from zero);
"HIGHEST (FP32)", FP32 fused multiply-adds outside the tensor cores; and
"3xTF32", the hi/lo split a_hi b_hi + a_hi b_lo + a_lo b_hi on the tensor
cores. With one-hot rows the TF32 product equals `tf32_round(x)` bit for
bit, the FP32 one x, and the 3xTF32 one tf32(x) + tf32(x - tf32(x)): the
twins below. `torch.matmul` with TF32 allowed and not is printed beside
them as the library's answer; the probe does not use it.

    python -m gatling_tpu_torch.tools.precision_probe            # on the card
    python -m gatling_tpu_torch.tools.precision_probe --device cpu  # the twins
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gatling_tpu_torch import tools

N = 128
MODES = (("DEFAULT (TF32)", 0), ("HIGHEST (FP32)", 1), ("3xTF32", 2))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: cvt.rna.tf32.f32 emulated on the bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    out = (bits & ~0x7FFFFFFF) | mag
    return out.to(torch.int32).view(torch.float32)


def product_twin(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    """The kernels' product on one-hot rows `a`, in plain torch: exact FP32
    sums (float64 products rounded once) of the operands each mode feeds
    the hardware."""
    def exact(p, q):
        return (p.double() @ q.double()).float()

    if mode == 1:
        return exact(a, b)
    ah, bh = tf32_round(a), tf32_round(b)
    if mode == 0:
        return exact(ah, bh)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return exact(al, bh) + exact(ah, bl) + exact(ah, bh)


def onehot_product(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    """a @ b (128 x 128 f32) in `mode` (0 TF32, 1 FP32, 2 3xTF32): the
    kernel on CUDA tensors, the twin on CPU ones."""
    if not a.is_cuda:
        return product_twin(a, b, mode)
    for t in (a, b):
        if t.shape != (N, N) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("precision probe: operands must be contiguous [128, 128] f32")
    out = torch.empty((N, N), dtype=torch.float32, device=a.device)
    lib = tools.kernel()
    lib.call("gatling_onehot_product", a.data_ptr(), b.data_ptr(), out.data_ptr(), mode,
             lib.stream(a))
    tools.launches["P2"] += 1
    return out


def probe_inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(one-hot rows, x) as the JAX probe makes them: x from seed 0."""
    x = (np.random.default_rng(0).standard_normal((N, N)) * 1.001).astype(np.float32)
    return (torch.eye(N, dtype=torch.float32, device=device),
            torch.tensor(x, device=device))


def error_line(name: str, got: torch.Tensor, x: torch.Tensor) -> tuple[float, float]:
    err = float((got - x).abs().max())
    rel = err / float(x.abs().max())
    print(f"one-hot matmul {name}: max abs err {err:.3e} (rel {rel:.3e})")
    return err, rel


def run(device) -> dict:
    """The three products against x and against their twins; on a card
    also torch.matmul with TF32 allowed and not. Returns {name: (abs err,
    rel err, equal to the twin bit for bit)}."""
    oh, x = probe_inputs(device)
    out = {}
    for name, mode in MODES:
        got = onehot_product(oh, x, mode)
        twin = product_twin(oh.cpu(), x.cpu(), mode).to(device)
        same = torch.equal(got.view(torch.int32), twin.view(torch.int32))
        out[name] = (*error_line(name, got, x), same)
        print(f"  {name}: {'equal' if same else 'NOT equal'} to its twin bit for bit")
    if device.type == "cuda":
        prev = torch.backends.cuda.matmul.allow_tf32
        try:
            for allow in (True, False):
                torch.backends.cuda.matmul.allow_tf32 = allow
                error_line(f"torch.matmul allow_tf32={allow} (library, not the port)",
                           torch.matmul(oh, x), x)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the twins)")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("precision probe: no CUDA device; pass --device cpu for the twins")
    results = run(torch.device(args.device))
    return 0 if all(same for *_e, same in results.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
