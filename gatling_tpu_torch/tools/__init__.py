"""Developer probes of the port (the JAX package's tools/mosaic_*_probe.py
counterparts): `cast_probe` (P1, layout moves of an (8, 128) tile) and
`precision_probe` (P2, a one-hot product at TF32, FP32 and 3xTF32). Their
CUDA code is csrc/probes.cu, built at first use; on a CPU tensor each probe
runs its plain PyTorch twin.

    python -m gatling_tpu_torch.tools.cast_probe [--device cpu]
    python -m gatling_tpu_torch.tools.precision_probe [--device cpu]
"""

from __future__ import annotations

from gatling_tpu_torch.ops.cuda_lib import I32, PTR, CudaLibrary

# kernel launches made on CUDA tensors (chip_smoke.py reads them)
launches = {"P1": 0, "P2": 0}
_kernel: CudaLibrary | None = None


def kernel() -> CudaLibrary:
    """csrc/probes.cu, built at first use."""
    global _kernel
    if _kernel is None:
        _kernel = CudaLibrary("probes.cu", {
            "gatling_cast_probe": [PTR, PTR, I32, I32, PTR],
            "gatling_onehot_product": [PTR, PTR, PTR, I32, PTR]},
            "gatling_probe_error_string")
    return _kernel
