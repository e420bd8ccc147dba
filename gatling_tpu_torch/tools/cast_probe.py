"""P1: the layout-move probe (tools/mosaic_cast_probe.py on the TPU).

The JAX probe asks which of six layout moves of an (8, 128) f32 tile
Mosaic legalizes inside a Pallas kernel. Here one launch runs the six
moves, a CUDA block each (csrc/probes.cu `cast_probe_kernel`): a block
stages the tile in shared memory with its rows STRIDE words apart, and
output element k reads the shared word its index map names. Every move is
legal in a hand-written kernel; the probe checks each result bit for bit
against its torch twin (`reshape`, `stack`, `cat`, `t()`) and reports the
bank-conflict degree of its shared reads, counted from the index map: the
most distinct words one warp's 32 reads take from one of the 32
four-byte banks (1: conflict-free; the padded rows make every move 1).

    python -m gatling_tpu_torch.tools.cast_probe            # on the card
    python -m gatling_tpu_torch.tools.cast_probe --device cpu  # the twins
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gatling_tpu_torch import tools

ROWS, COLS = 8, 128
STRIDE = COLS + 4  # the staged tile's row pitch in words (csrc/probes.cu CAST_STRIDE)
BANKS = 32
# (name as the JAX probe prints it, output shape)
MOVES = (
    ("reshape (8,128)->(1024,)", (1024,)),
    ("reshape (8,128)->(1024,1)", (1024, 1)),
    ("stack8 of (8,128)->flat", (1024, 8)),
    ("concat cols (1024,1)x8", (1024, 8)),
    ("transpose (8,128)->(128,8)", (128, 8)),
    ("concat transposes", (128, 8)),
)


def cast_twin(x: torch.Tensor, move: int) -> torch.Tensor:
    """Move `move` of the tile x [8, 128] in plain torch (the JAX probe's
    jnp expression for each)."""
    flat = x.reshape(ROWS * COLS)
    out = (flat,
           x.reshape(ROWS * COLS, 1),
           torch.stack([flat] * 8, dim=-1),
           torch.cat([x.reshape(ROWS * COLS, 1)] * 8, dim=1),
           x.t(),
           torch.cat([x[i:i + 1].reshape(COLS, 1) for i in range(ROWS)], dim=1))[move]
    return out.contiguous()


def source_index(move: int, k: np.ndarray) -> np.ndarray:
    """The tile word (row-major) output element k of a move reads: the
    kernel's index map (csrc/probes.cu cast_src)."""
    if move in (2, 3):
        return k // 8
    if move in (4, 5):
        return (k % ROWS) * COLS + k // ROWS
    return k


def bank_conflicts(move: int, stride: int = STRIDE) -> int:
    """Worst bank-conflict degree of the move's shared reads over its warps
    (32 consecutive output elements a warp, as the kernel assigns them),
    with the staged rows `stride` words apart."""
    n = int(np.prod(MOVES[move][1]))
    src = source_index(move, np.arange(n))
    src = (src // COLS) * stride + src % COLS
    worst = 1
    for w in range(0, n, 32):
        words = np.unique(src[w:w + 32])
        worst = max(worst, int(np.bincount(words % BANKS).max()))
    return worst


def cast_moves(x: torch.Tensor) -> list[torch.Tensor]:
    """The six moves of x [8, 128] f32: the kernel, one launch, on a CUDA
    tensor; the twins on a CPU one."""
    if not x.is_cuda:
        return [cast_twin(x, move) for move in range(len(MOVES))]
    if x.shape != (ROWS, COLS) or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("cast probe: x must be a contiguous [8, 128] f32 tensor")
    outs = [torch.empty(shape, dtype=torch.float32, device=x.device) for _n, shape in MOVES]
    lib = tools.kernel()
    lib.call("gatling_cast_probe", x.data_ptr(), *(o.data_ptr() for o in outs),
             *(o.numel() for o in outs), lib.stream(x))
    tools.launches["P1"] += 1
    return outs


def probe_input(device) -> torch.Tensor:
    """The tile: seeded normal values (every word distinct, so a wrong
    index map shows)."""
    x = np.random.default_rng(0).standard_normal((ROWS, COLS)).astype(np.float32)
    return torch.tensor(x, device=device)


def run(device) -> dict[str, tuple[bool, int]]:
    """Every move once; prints `name: OK` or `name: FAIL ...` as the JAX
    probe does, with the move's bank-conflict degree. Returns {name: (ok,
    degree)}."""
    x = probe_input(device)
    try:
        moved, err = cast_moves(x), None
    except RuntimeError as e:
        moved, err = None, "FAIL " + str(e).split("\n")[0][:100]
    out = {}
    for move, (name, _shape) in enumerate(MOVES):
        degree = bank_conflicts(move)
        ok, msg = False, err
        if moved is not None:
            got, ref = moved[move], cast_twin(x, move)
            ok = got.shape == ref.shape and torch.equal(got.view(torch.int32),
                                                        ref.view(torch.int32))
            msg = "OK" if ok else "FAIL not bit-equal to the torch twin"
        print(f"{name}: {msg} (shared-memory bank conflicts: {degree}-way)")
        out[name] = (ok, degree)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernel) or cpu (the twins)")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("cast probe: no CUDA device; pass --device cpu for the twins")
    results = run(torch.device(args.device))
    return 0 if all(ok for ok, _ in results.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
