"""Frame times and the device-time breakdown of a bench scene on the card.

    python -m gatling_tpu_torch.frame_profile                        # sphere_field
    python -m gatling_tpu_torch.frame_profile --scene interior       # textured interior
    python -m gatling_tpu_torch.frame_profile --scene cornell_aovs   # the wavefront
    python -m gatling_tpu_torch.frame_profile --scene glass_coated   # the advanced lobes

On one CUDA card, at the JAX bench's settings for big scenes (512x512,
4 spp, 6 bounces): sphere_field with NEE off and on, or the textured
interior with NEE on; or cornell_aovs, the wavefront integrator's frame:
the Cornell box with the bench's rect light and every AOV bound, at the
Cornell bench settings (1200x1200, 16 spp, 8 bounces, NEE), its time
split into K5 (closest hits), K6 (shadow rays) and the PyTorch ops of
shading and AOVs. For each: one warm-up frame through `gi.render`,
then five frames on the same scene (host clock around each, ending in the
image's copy to the host; the framebuffer is reset each time), then one
more under torch.profiler. Prints the frame times and Mray/s (traced
segments over frame time), the profiled frame's device time by group (the
kernels K1-K4, the coherence sort, other PyTorch kernels, copies) and its
device idle share: the part of the frame's wall time in which no kernel
or copy ran; and the eight PyTorch kernels that took the most of the
rest. For the textured interior also the texture stage's time in
that frame: CUDA events around each call of render/fused.py
material_rows (its kernels and the gaps between them).

glass_coated is tests/graphical/Materials.GlassCoated at the JAX bench's
settings (1200x1200, 16 spp, 8 bounces, NEE off): K1 with the advanced
lobes (thick glass, clearcoat). It is profiled as above, then with the
lobes off (the glass thin-walled, the coat removed: the plain K1), and
then K1's two branches are timed on the same first wave (1200x1200 x 2
samples) and the same tables, the advanced one against the plain one
(the scene's flag cleared), in turns with CUDA events.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import tempfile
import time

import torch

from gatling_tpu_torch import gi
from gatling_tpu_torch.interface import AovId
from gatling_tpu_torch.render import fused

RES, SPP, BOUNCES, FRAMES = 512, 4, 6, 5
# kernel-name patterns, the split kernels first ("walk_kernel" ends their names too)
GROUPS = (("K3 trace", "trace_"), ("K4 shade", "shade_"), ("K1 bounce_kernel", "bounce_kernel"),
          ("K2 walk_kernel", "walk_kernel"), ("K5 closest hit", "closest_kernel"),
          ("K6 shadow rays", "occluded_kernel"), ("sort", "sort"), ("copies", "memcpy"))


def _cornell_aovs():
    """cornell_aovs: the Cornell box, the bench's rect light, every AOV."""
    import os

    import numpy as np

    from gatling_tpu_torch.cli import load_gi_scene
    from gatling_tpu_torch.interface import AOV_CHANNELS, AOV_IS_INT
    from gatling_tpu_torch.scene.stage import LightDesc

    res = 1200
    cornell = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "tests", "data", "cornell.usda")
    scene, desc, merged = load_gi_scene(cornell, "cuda", dict(spp=16, maxBounces=8,
                                                              nextEventEstimation=True))
    xf = np.eye(4)
    xf[3, :3] = [0.0, 0.0, 0.9]
    scene.add_light(LightDesc(
        path="/benchlight", light_type="rect", transform=xf,
        params=dict(intensity=4.0, exposure=0.0, color=np.array([1.0, 0.9, 0.8], np.float32),
                    normalize=False, diffuse=1.0, specular=1.0, enableColorTemperature=False,
                    colorTemperature=6500.0, width=0.8, height=0.6)))
    binds = [gi.GiAovBinding(a, gi.GiRenderBuffer(res, res, 1 if AOV_IS_INT[a] else
                                                  max(AOV_CHANNELS[a], 3), AOV_IS_INT[a]),
                             clear_value=-1 if AOV_IS_INT[a] else None) for a in AovId]
    return gi.GiRenderParams(scene=scene, camera=desc.first_camera(), aov_bindings=binds,
                             render_settings=merged)


GLASS_RES, GLASS_SPP, GLASS_BOUNCES = 1200, 16, 8  # the bench's glass_coated (bench.py:40-54)


def _glass_coated(lobes: bool):
    """Materials.GlassCoated at the bench's settings; without `lobes` the
    glass is thin-walled and the coat removed, which the plain K1 shades."""
    import os

    from gatling_tpu_torch.scene.stage import load_scene
    from gatling_tpu_torch.utils.config import default_settings

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
                        "graphical", "Materials.GlassCoated", "scene.usda")
    desc = load_scene(path)
    if not lobes:
        for m in desc.materials.values():
            inputs = m.nodes[m.surface_node].inputs
            inputs.pop("clearcoat", None)
            if "transmission_weight" in inputs:
                inputs["geometry_thin_walled"] = True
    scene = gi.create_scene("cuda")
    for m in desc.meshes:
        scene.add_mesh(m)
    for m in desc.materials.values():
        scene.add_material(m)
    for light in desc.lights:
        scene.add_light(light)
    settings = default_settings()
    settings.update(desc.render_settings)
    settings.update(spp=GLASS_SPP, maxBounces=GLASS_BOUNCES, nextEventEstimation=False)
    return gi.GiRenderParams(
        scene=scene, camera=desc.first_camera(),
        aov_bindings=[gi.GiAovBinding(AovId.COLOR, gi.GiRenderBuffer(GLASS_RES, GLASS_RES, 4))],
        render_settings=settings)


def _k1_branches(params) -> None:
    """K1's advanced and plain branches on the first wave of a rendered
    scene's frame and its tables, in turns (advanced, plain, plain,
    advanced), seven CUDA-event-timed launches each on fresh copies."""
    from gatling_tpu_torch.ops import sampling as smp
    from gatling_tpu_torch.ops.bounce import bounce_step, make_params, pack_state
    from gatling_tpu_torch.render.camera import camera_uniforms, generate_primary_rays
    from gatling_tpu_torch.render.integrator import RenderConfig, Uniforms

    fs = params.scene._fused
    res = params.aov_bindings[0].render_buffer.width
    pix = torch.arange(res * res, device="cuda").repeat(2)
    sidx = torch.arange(2, device="cuda").repeat_interleave(res * res)
    cam = camera_uniforms(params.camera, False, "cuda")
    o, d, rng = generate_primary_rays(cam, res, res, pix % res, pix // res,
                                      smp.rng_init(pix, sidx), True, True, False)
    wave = pack_state(o, d, rng, pix.numel())
    uni = Uniforms(cam, 0, 1.0, 10.0, 0.95, 1.0, 1.0, 7)
    p0 = make_params(RenderConfig(res, res), uni, 1, "cuda")[0].contiguous()
    times = {True: [], False: []}
    for adv in (True, False, False, True):
        tables = fs._replace(advanced=adv)
        for _ in range(8):
            s = wave.clone()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            bounce_step(p0, tables, s, False)
            b.record()
            torch.cuda.synchronize()
            times[adv].append(a.elapsed_time(b))
        times[adv].pop(-8)  # each turn's first launch warms up
    print(f"  K1 on the first wave ({wave.shape[1]} rays, {fs.tris.shape[0]} triangles): advanced "
          f"branch median {statistics.median(times[True]):.4f} ms, plain branch "
          f"{statistics.median(times[False]):.4f} ms (7 launches a turn, two turns each)")


def _params(scene_name: str, nee: bool, tex_dir: str):
    from gatling_tpu_torch.scene.examples import interior, sphere_field

    if scene_name == "cornell_aovs":
        return _cornell_aovs()
    if scene_name.startswith("glass_coated"):
        return _glass_coated(lobes=scene_name == "glass_coated")
    desc = interior(tex_dir=tex_dir) if scene_name == "interior" else sphere_field()
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


def _stage_ms(params) -> tuple[float, int]:
    """One frame with CUDA events around each texture-stage call: the
    stage's summed device time and its calls."""
    real = fused.material_rows
    spans = []

    def timed(*args):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(*args)
        b.record()
        spans.append((a, b))
        return out

    fused.material_rows = timed
    try:
        _frame(params)
    finally:
        fused.material_rows = real
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans), len(spans)


def profile(scene_name: str, nee: bool, tex_dir: str) -> None:
    params = _params(scene_name, nee, tex_dir)
    first = _frame(params)
    times = [_frame(params) for _ in range(FRAMES)]
    segs = params.scene.last_segments
    med = statistics.median(times)
    s = params.render_settings
    route = "wavefront, tracer " + params.scene._tracer if params.scene._accel is not None \
        else params.scene._fused_static
    rate = f"{segs:.0f} segments; {segs / med / 1e6:.1f} Mray/s" if segs else \
        "segments not counted"
    print(f"{scene_name} {params.aov_bindings[0].render_buffer.width}^2 {s['spp']} spp "
          f"{s['maxBounces']} bounces nee={s.get('nextEventEstimation', False)}: first frame "
          f"(scene build included) {first:.4f} s; frames {[round(t, 5) for t in times]} s; "
          f"median {med:.5f} s; {rate}; route {route}")

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
    other: dict[str, list] = {}
    for e in dev:
        if not any(pat in e.name.lower() for _, pat in GROUPS):
            o = other.setdefault(e.name[:90], [0.0, 0])
            o[0] += (e.time_range.end - e.time_range.start) / 1e3
            o[1] += 1
    print("    the largest other kernels:")
    for name, (ms, n) in sorted(other.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"      {ms:.3f} ms in {n}: {name}")
    if params.scene._accel is None and params.scene._fused_static.textured:
        ms, calls = _stage_ms(params)
        print(f"  texture stage (CUDA events around material_rows, one more frame): {ms:.3f} ms "
              f"in {calls} calls")
    if scene_name == "glass_coated":
        _k1_branches(params)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("sphere_field", "interior", "cornell_aovs",
                                        "glass_coated"), default="sphere_field")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("frame_profile: no CUDA device; the port's timings come from the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    with tempfile.TemporaryDirectory(prefix="frame_profile_tex_") as tex_dir:
        if args.scene == "glass_coated":
            for name in ("glass_coated", "glass_coated_lobes_off"):
                profile(name, False, tex_dir)
            return 0
        for nee in ((False, True) if args.scene == "sphere_field" else (True,)):
            profile(args.scene, nee, tex_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
