"""Frame times and the device-time breakdown of sphere_field on the card.

    python -m gatling_tpu_torch.frame_profile

On one CUDA card, for sphere_field at the JAX bench's settings (512x512,
4 spp, 6 bounces), NEE off and on: one warm-up frame through `gi.render`,
then five frames on the same scene (host clock around each, ending in the
image's copy to the host; the framebuffer is reset each time), then one
more under torch.profiler. Prints the frame times and Mray/s (traced
segments over frame time), the profiled frame's device time by group (K1,
K2, the coherence sort, other PyTorch kernels, copies) and its device
idle share: the part of the frame's wall time in which no kernel or copy
ran.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

from gatling_tpu_torch import gi
from gatling_tpu_torch.interface import AovId

RES, SPP, BOUNCES, FRAMES = 512, 4, 6, 5
GROUPS = (("K1 bounce_kernel", "bounce_kernel"), ("K2 walk_kernel", "walk_kernel"),
          ("sort", "sort"), ("copies", "memcpy"))


def _params(nee: bool):
    from gatling_tpu_torch.scene.examples import sphere_field

    desc = sphere_field()
    scene = gi.create_scene("cuda")
    for m in desc.meshes:
        scene.add_mesh(m)
    for m in desc.materials.values():
        scene.add_material(m)
    for light in desc.lights:
        scene.add_light(light)
    return gi.GiRenderParams(
        scene=scene, camera=desc.first_camera(),
        aov_bindings=[gi.GiAovBinding(AovId.COLOR, gi.GiRenderBuffer(RES, RES, 4))],
        render_settings=dict(spp=SPP, maxBounces=BOUNCES, nextEventEstimation=nee))


def _frame(params) -> float:
    params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gi.render(params)
    return time.perf_counter() - t0


def _busy_union(events) -> float:
    """Microseconds covered by the union of the device intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile(nee: bool) -> None:
    params = _params(nee)
    first = _frame(params)
    times = [_frame(params) for _ in range(FRAMES)]
    segs = params.scene.last_segments
    med = statistics.median(times)
    print(f"sphere_field {RES}^2 {SPP} spp {BOUNCES} bounces nee={nee}: first frame (scene "
          f"build included) {first:.4f} s; frames {[round(t, 5) for t in times]} s; median "
          f"{med:.5f} s; {segs:.0f} segments; {segs / med / 1e6:.1f} Mray/s; route "
          f"{params.scene._fused_static}")

    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        wall = _frame(params)
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.time_range.end - e.time_range.start for e in dev) / 1e3
    by = {name: 0.0 for name, _ in GROUPS}
    by["other PyTorch kernels"] = 0.0
    counts = dict.fromkeys(by, 0)
    for e in dev:
        key = next((g for g, pat in GROUPS if pat in e.name.lower()), "other PyTorch kernels")
        by[key] += (e.time_range.end - e.time_range.start) / 1e3
        counts[key] += 1
    busy = _busy_union(dev) / 1e3
    print(f"  profiled frame: wall {wall * 1e3:.2f} ms, device time {total:.2f} ms "
          f"(busy {busy:.2f} ms, idle share {1 - busy / (wall * 1e3):.3f})")
    for k, v in by.items():
        print(f"    {k}: {v:.3f} ms in {counts[k]} launches")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("frame_profile: no CUDA device; the port's timings come from the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    for nee in (False, True):
        profile(nee)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
