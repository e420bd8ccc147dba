"""The validation layer of GATLING_VALIDATE=1 (gi.render).

The JAX package runs its kernels interpreted under it, arms debug-NaN and
asserts every AOV finite before the host copy (gatling_tpu/gi.py:451-474;
the reference's validation layer and debugPrintf, SURVEY section 5). The
port's counterpart: while `validating()` is active, each kernel wrapper
calls `after_launch` once its kernel is queued, which synchronises the
card, so that a fault surfaces at the launch that made it, and checks that
every value the launch wrote is finite, naming the launch when one is not.
gi.render asserts the AOVs itself. Nothing here changes a value.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable

import torch

enabled = False


@contextlib.contextmanager
def validating():
    """Turn the per-launch checks on for the body."""
    global enabled
    prev, enabled = enabled, True
    try:
        yield
    finally:
        enabled = prev


def after_launch(key: str, written: Callable[[], Iterable[torch.Tensor]]) -> None:
    """When validating: wait for the card, then check the tensors
    `written()` gives (the values launch `key` wrote; called only then)."""
    if not enabled:
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for k, out in enumerate(written()):
        if out.is_floating_point():
            bad = int((~torch.isfinite(out)).sum())
            if bad:
                raise FloatingPointError(
                    f"GATLING_VALIDATE: launch {key} wrote {bad} non-finite values "
                    f"(output {k}, shape {tuple(out.shape)})")


def state_rows(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows of a ray state that hold values: all but row 12, the
    RNG's bits stored in an f32 row."""
    return state[:12], state[13:]


def hit_rows(hit: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A hit buffer's rows a launch writes: the hit flag and t of every
    ray, the rest of the rays that hit (split_ref H_HIT, H_T)."""
    return hit[:2], hit[2:, hit[0] > 0.5]
