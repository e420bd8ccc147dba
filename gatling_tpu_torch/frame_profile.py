"""Frame times and the device-time breakdown of a bench scene on the card.

    python -m gatling_tpu_torch.frame_profile                        # sphere_field
    python -m gatling_tpu_torch.frame_profile --scene interior       # textured interior
    python -m gatling_tpu_torch.frame_profile --scene cornell_aovs   # the wavefront
    python -m gatling_tpu_torch.frame_profile --scene interior_aovs  # its small interior
    python -m gatling_tpu_torch.frame_profile --scene glass_coated   # the advanced lobes
    python -m gatling_tpu_torch.frame_profile --scene cornell_fog    # a scattering medium
    python -m gatling_tpu_torch.frame_profile --scene glass_tinted   # an absorbing medium
    python -m gatling_tpu_torch.frame_profile --scene cornell_first_hit   # the bounce-0 peel
    python -m gatling_tpu_torch.frame_profile --scene interior_first_hit
    python -m gatling_tpu_torch.frame_profile --scene interior_cutout     # the re-trace (K4r)
    python -m gatling_tpu_torch.frame_profile --scene sphere_field_dome   # the dome pass

On one CUDA card, at the JAX bench's settings for big scenes (512x512,
4 spp, 6 bounces): sphere_field with NEE off and on, or the textured
interior with NEE on; or cornell_aovs, the wavefront integrator's frame:
the Cornell box with the bench's rect light and every AOV bound, at the
Cornell bench settings (1200x1200, 16 spp, 8 bounces, NEE), its time
split into K5 (closest hits), K6 (shadow rays) and the PyTorch ops of
shading and AOVs; or interior_aovs, the same route on interior(detail=1)
(3,840 triangles, textured) at 512x512, 4 spp, 6 bounces, NEE; or
cornell_first_hit / interior_first_hit, the fused route's first-hit
frames: the Cornell box (as cornell_aovs) or the textured interior (512x512,
4 spp, 6 bounces, NEE) with COLOR, NORMAL, ALBEDO, DEPTH and TEXCOORDS
bound (bounce 0 of each sample peeled through K3, K4's taps alone and
K4); or interior_cutout, the textured interior with its bowls' opacity
a checker mask (scene/examples.py interior_cutout; 512x512, 4 spp, 6
bounces, NEE off and on), whose split bounces re-trace what the mask
rejects (three rounds of K4r and K3 each); or sphere_field_dome,
sphere_field (NEE on) under a 4096x2048
float32 EXR sky written at run time (scene/examples.py write_sky), rotated
30 degrees about the up axis with an emission multiplier (1.5, 1.4, 1.3):
after the profile, the dome pass (render/fused.py dome_pass, PyTorch ops
over the kernels' miss records) is timed alone on the profiled frame's
final state, as the device time of one pass (CUDA events around 8
passes queued behind a device sleep). For each: one warm-up frame through
`gi.render`,
then five frames on the same scene (host clock around each, ending in the
image's copy to the host; the framebuffer is reset each time), then one
more under torch.profiler. Prints the frame times and Mray/s (traced
segments over frame time), the profiled frame's device time by group (the
kernels K1-K4, the coherence sort, other PyTorch kernels, copies) and its
device idle share: the part of the frame's wall time in which no kernel
or copy ran; and the eight PyTorch kernels that took the most of the
rest. K4 taps the textures itself: the textured interior's frame has no
texture stage.

glass_coated is tests/graphical/Materials.GlassCoated at the JAX bench's
settings (1200x1200, 16 spp, 8 bounces, NEE off): K1 with the advanced
lobes (thick glass, clearcoat). It is profiled as above, then with the
lobes off (the glass thin-walled, the coat removed: the plain K1), and
then K1's two branches are timed on the same first wave (1200x1200 x 2
samples) and the same tables, the advanced one against the plain one
(the scene's flag cleared), in turns with CUDA events.

cornell_fog and glass_tinted are the Cornell box of scene/examples.py with
its tall block an MDL medium (a fog: mediumStackSize 1, K1's scatter
branch; OmniGlass tinted: mediumStackSize 0, K1's absorption branch),
under the bench's rect light at the Cornell bench settings (1200x1200, 16
spp, 8 bounces, NEE), loaded from the written .usda as the CLI loads it.
They are profiled as above, and then K1's volume branch is timed on the
frame's first wave against the branch without media on the same tables.
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
GROUPS = (("K4r re-trace round", "retrace_kernel"), ("K3 trace", "trace_"),
          ("K4 shade", "shade_"), ("K4t taps", "tap_kernel"),
          ("K1 bounce_kernel", "bounce_kernel"),
          ("K2 walk_kernel", "walk_kernel"), ("K5 closest hit", "intersect_tree_kernel"),
          ("K6 shadow rays", "occluded_tree_kernel"), ("sort", "sort"), ("copies", "memcpy"))


FIRST_HIT = (AovId.COLOR, AovId.NORMAL, AovId.ALBEDO, AovId.DEPTH, AovId.TEXCOORDS)


def _every_aov(res: int, aovs=tuple(AovId)):
    """One binding of each of `aovs` (every AOV), the ids in int32 buffers
    cleared to -1."""
    from gatling_tpu_torch.interface import AOV_CHANNELS, AOV_IS_INT

    return [gi.GiAovBinding(a, gi.GiRenderBuffer(res, res, 1 if AOV_IS_INT[a] else
                                                 max(AOV_CHANNELS[a], 3), AOV_IS_INT[a]),
                            clear_value=-1 if AOV_IS_INT[a] else None) for a in aovs]


def _cornell_aovs(aovs=tuple(AovId)):
    """cornell_aovs: the Cornell box, the bench's rect light, `aovs`."""
    import os

    import numpy as np

    from gatling_tpu_torch.cli import load_gi_scene
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
    return gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                             aov_bindings=_every_aov(res, aovs), render_settings=merged)


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


def _media(scene_name: str, tmp_dir: str):
    """cornell_fog or glass_tinted, loaded through the CLI's loader."""
    from gatling_tpu_torch.cli import load_gi_scene
    from gatling_tpu_torch.scene import examples

    path = getattr(examples, scene_name)(tmp_dir)
    stack = 1 if scene_name == "cornell_fog" else 0
    scene, desc, merged = load_gi_scene(path, "cuda", dict(
        spp=GLASS_SPP, maxBounces=GLASS_BOUNCES, nextEventEstimation=True,
        mediumStackSize=stack, maxVolumeWalkLength=7))
    return gi.GiRenderParams(
        scene=scene, camera=desc.first_camera(),
        aov_bindings=[gi.GiAovBinding(AovId.COLOR, gi.GiRenderBuffer(GLASS_RES, GLASS_RES, 4))],
        render_settings=merged)


def _k1_branches(params, field: str, values: tuple, nee: bool = False) -> None:
    """K1 with the scene's `field` (advanced, or the volume mode) at each of
    `values` on the first wave of a rendered scene's frame and its tables,
    in turns (a, b, b, a), seven CUDA-event-timed launches each on fresh
    copies."""
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
    times = {v: [] for v in values}
    for v in (*values, *values[::-1]):
        tables = fs._replace(**{field: v})
        for _ in range(8):
            s = wave.clone()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            bounce_step(p0, tables, s, nee)
            b.record()
            torch.cuda.synchronize()
            times[v].append(a.elapsed_time(b))
        times[v].pop(-8)  # each turn's first launch warms up
    print(f"  K1 on the first wave ({wave.shape[1]} rays, {fs.tris.shape[0]} triangles, "
          f"nee={nee}): " + ", ".join(f"{field}={v} median {statistics.median(t):.4f} ms"
                                      for v, t in times.items())
          + " (7 launches a turn, two turns each)")


def _params(scene_name: str, nee: bool, tex_dir: str):
    import math
    import os

    from gatling_tpu_torch.scene.examples import (interior, interior_cutout, sphere_field,
                                                  write_sky)

    if scene_name == "cornell_aovs":
        return _cornell_aovs()
    if scene_name == "cornell_first_hit":
        return _cornell_aovs(FIRST_HIT)
    if scene_name.startswith("glass_coated"):
        return _glass_coated(lobes=scene_name == "glass_coated")
    if scene_name in ("cornell_fog", "glass_tinted"):
        return _media(scene_name, tex_dir)
    desc = (interior(tex_dir=tex_dir) if scene_name in ("interior", "interior_first_hit")
            else interior(detail=1, tex_dir=tex_dir) if scene_name == "interior_aovs"
            else interior_cutout(tex_dir=tex_dir) if scene_name == "interior_cutout"
            else sphere_field())
    scene = gi.create_scene("cuda")
    for m in desc.meshes:
        scene.add_mesh(m)
    for m in desc.materials.values():
        scene.add_material(m)
    for light in desc.lights:
        scene.add_light(light)
    if scene_name == "sphere_field_dome":
        dome = gi.giCreateDomeLight(scene, write_sky(os.path.join(tex_dir, "sky_f32.exr"),
                                                     4096, 2048, half=False))
        gi.giSetDomeLightRotation(dome, (0.0, 0.0, math.sin(math.pi / 12),
                                         math.cos(math.pi / 12)))
        gi.giSetDomeLightBaseEmission(dome, (1.5, 1.4, 1.3))
    return gi.GiRenderParams(
        scene=scene, camera=desc.first_camera(),
        aov_bindings=(_every_aov(RES) if scene_name == "interior_aovs"
                      else _every_aov(RES, FIRST_HIT) if scene_name == "interior_first_hit"
                      else [gi.GiAovBinding(AovId.COLOR, gi.GiRenderBuffer(RES, RES, 4))]),
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
    passes = []
    real_pass = fused.dome_pass

    def recorded_pass(*args):  # keeps the first dome pass's inputs
        if not passes:
            passes.append(args)
        return real_pass(*args)

    fused.dome_pass = recorded_pass
    try:
        with torch.profiler.profile(activities=act) as prof:
            wall = _frame(params)
    finally:
        fused.dome_pass = real_pass
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
    print(f"  profiled frame: wall {wall * 1e3:.2f} ms, device time {total:.2f} ms in {len(dev)} "
          f"kernels and copies (busy {busy:.2f} ms, idle share {1 - busy / (wall * 1e3):.3f})")
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
    if passes:
        _dome_pass_time(passes[0])
    if scene_name == "glass_coated":
        _k1_branches(params, "advanced", (True, False))
    elif scene_name in ("cornell_fog", "glass_tinted"):
        _k1_branches(params, "volumes", (params.scene._fused.volumes, 0), nee=True)


def _dome_pass_time(args, passes: int = 8) -> None:
    """The device time of one dome pass on the frame's final state: CUDA
    events around `passes` passes queued behind a device sleep that
    outlasts their enqueue (about 60 PyTorch launches a pass: the passes
    must fit the device's queue of pending launches, about a thousand)."""
    def run():
        fused.dome_pass(*args)

    for _ in range(3):
        run()
    cycles = 20_000_000
    for _ in range(4):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(passes):
            run()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if enqueue_ms < 0.8 * ev[0].elapsed_time(ev[1]):
            break
        cycles *= 4
    else:
        raise AssertionError("dome pass timing: the enqueue outlasted the device sleep")
    radiance, state = args[0], args[1]
    print(f"  dome pass: {ev[1].elapsed_time(ev[2]) / passes:.4f} ms of device time a pass over "
          f"{radiance.shape[0]} rays ({int((state[14] > 0).sum())} missed), "
          f"{radiance.shape[0] // (RES * RES)} samples a pixel in the wave")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("sphere_field", "interior", "cornell_aovs",
                                        "interior_aovs", "glass_coated", "cornell_fog",
                                        "glass_tinted", "cornell_first_hit",
                                        "interior_first_hit", "interior_cutout",
                                        "sphere_field_dome"),
                    default="sphere_field")
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
        for nee in ((False, True) if args.scene in ("sphere_field", "interior_cutout")
                    else (True,)):
            profile(args.scene, nee, tex_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
