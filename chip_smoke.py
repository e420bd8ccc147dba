#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's main path (gatling_tpu_torch) the way a user does and
fails, with a non-zero exit, if any phase fails:

1. device: a CUDA card must be present (there is no CPU path);
2. build: the kernels K1 (resident bounce), K2 (two-level walk bounce),
   K3 (split trace) and K4 (split shade) are built from
   gatling_tpu_torch/csrc/bounce.cu (in five nvcc parts), K5-K8 (the
   brute-force trace) from csrc/trace.cu and the probes P1/P2 from
   csrc/probes.cu, every nvcc run at once; one line a kernel instance of
   ptxas' registers, stack and spills;
3. K1 against its plain twin (ops/bounce_ref.py) on the card, through
   the wrapper the main path calls (ops/bounce.py bounce_step), on the ray
   waves the main path builds: Cornell 1200x1200 x 2 samples (2.88M rays,
   NEE off and on) and Lights.Analytic 96x96 x 24 samples, at bounce 0 and
   at bounce 4 from a state the twin stepped; then both timed on the
   Cornell waves;
3b. K2 against its twin the same way, on the sphere_field wave (512x512 x
   4 samples, 1,048,576 rays, in 32x32 pixel tiles), NEE off and on,
   through the instanced tables (gi's route) and the flattened ones; and
   the Cornell box in clustered tables held against K1's resident step;
   then K2 and the twin timed on the wave as generated and after the
   coherence sort, and K2 at bounces 1-5 of the frame with and without
   the sort;
4. full-size renders through gatling_tpu_torch.gi, as the CLI renders:
   Cornell 1200x1200 at 16 spp and 8 bounces, the same with NEE and a rect
   light, and Lights.Analytic at its authored settings, each checked;
4b. sphere_field (294,916 triangles) at the JAX bench's settings, 512x512,
   4 spp, 6 bounces, NEE off and on, checked, and the same frame through
   the flattened tables, which must agree;
4c. a transform edit of one sphere group: the refit tables equal a fresh
   build;
4d. the textured interior (92,492 triangles, every material a UsdUVTexture)
   through gi.render at the JAX bench's settings, 512x512, 4 spp, 6
   bounces, NEE on: checked (finite, non-negative, per-material means
   against a frame of the texture means), the textureLodBounces=2 frame
   and a normal-mapped frame against it, first and warm frame times; and
   the textured Cornell box at 1200x1200, 16 spp, 8 bounces;
3c. then K3 and K4 against their twins (ops/split_ref.py), through the
   wrappers the main path calls (ops/bounce.py trace_step, shade_step),
   on the tables gi.render built for 4d's frames: the interior's first
   wave (512x512 x 4 samples, 1,048,576 rays), plain and normal-mapped,
   on gi's instanced tables and on the flattened tables of the same
   geometry, NEE off and on, at bounces 0 and 4, and the textured Cornell
   box's wave (1200x1200 x 2 samples, resident tables); then both, their
   twins and the texture stage timed;
5. progressive accumulation over one scene (sampleOffset 16 -> 32 -> 48);
4e. the wavefront integrator through gi.render, every AOV bound (the ids
   in int32 buffers): cornell_aovs (the Cornell box and the bench's rect
   light, 1200x1200, 16 spp, 8 bounces, NEE) and interior_aovs
   (interior(detail=1), 3,840 triangles, 512x512, 4 spp, 6 bounces, NEE,
   textured), a first and three warm frames each, COLOR's Cornell checks,
   ids in range, unit normals, K5 and K6 launched and K1-K4 not; then
   Mesh.PrimvarInterpolation and Render.AOVs on the card and through the
   twins on the CPU, the same samples: ids equal on 99.9 % of pixels,
   COLOR means within 1 %;
3d. then K5-K8 against their twins (ops/trace_ref.py), through the
   wrappers (ops/trace.py), on the waves 4e's frames handed the tracer
   (sample 0, bounces 0 and 2: the closest-hit waves, 1,440,000 and
   262,144 rays, and the NEE shadow waves) and the tables gi built: tri,
   t, u, v bit-equal and the occlusion flags equal on every ray, K7's
   triangle K5's on 99 % of rays; each kernel and twin timed;
4f. the advanced lobes and the cutout through gi.render, a first and a
   warm frame each with the kernels' launches: glass_coated
   (Materials.GlassCoated at the bench's 1200x1200, 16 spp, 8 bounces,
   NEE off and on: K1's advanced branch), cornell_cutout (the Cornell box
   and the bench's rect light, the tall block at opacity 0.5, the short
   one shut out by its opacityThreshold: K1's cutout on camera and shadow
   rays; its first wave's pass rate through the tall block 0.5 +- 0.01),
   sphere_field_lobes (a thick glass, a clearcoated and a half-open sphere
   material, 512x512, 4 spp, 6 bounces, NEE off and on: K2's two
   branches, instanced, and the NEE frame through the flattened tables),
   interior_lobes (an anisotropic open_pbr worktop over its marble, the
   instanced bowls at opacity 0.5: K3's cutout and K4's advanced branch
   with the mesh-tangent frame) and cornell_cutout_aovs (every AOV: the
   wavefront's cutout, K5 for the camera rays and, hop by hop, the shadow
   rays); and Materials.GlassCoated at its own settings against its
   committed reference;
3e. then each branch's kernel against its twin on the waves 4f's frames
   handed it (bounces 0 and 2, recorded by wrapping render/fused.py's
   bounce_step / shade_step) and the tables gi built, the cutout draws
   bit for bit; each timed at bounce 0;
P. the probes P1 (layout moves, tools/cast_probe.py) and P2 (the one-hot
   product at TF32, FP32 and 3xTF32, tools/precision_probe.py) through
   their entry points, against their twins, with torch.matmul's error and
   time beside P2.

Each kernel's launches are counted over one frame of its path through
gi.render (K1: the Cornell frame; K2: sphere_field's, NEE off; K3 and K4:
the interior's; K5 and K6: cornell_aovs'; the branches: 4f's frames;
P1/P2: the probes' run), the counts set to 0 just before it and read
just after. K7 and K8 are on no path (the JAX package's comparison point)
and count 0. The last lines are the card's name and power limit, one JSON
line with the kernels' launch counts, errors, times and bounds, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(HERE, "tests", "data", "cornell.usda")
ANALYTIC = os.path.join(HERE, "tests", "graphical", "Lights.Analytic", "scene.usda")
FULL_RES = 1200  # the bench's Cornell frame
ANALYTIC_RES, ANALYTIC_SPP = 96, 24  # Lights.Analytic's authored settings
RTOL, ATOL, MIN_AGREE = 1e-4, 1e-5, 0.999
SF_RES, SF_SPP, SF_BOUNCES = 512, 4, 6  # the JAX bench's sphere_field settings (bench.py:40-48)
# H100 SXM5 peaks: HBM3 bytes/s, f32 FLOP/s outside the tensor cores, TF32
# on the tensor cores (dense)
HBM_BPS, F32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12
TRI_TEST_FLOPS = 30  # one Baldwin-Weber triangle test, counted from the kernels' code
SLAB_FLOPS = 24  # one slab test: 6 subtractions, 6 multiplications, 12 min/max


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def bench_rect_light():
    """The NEE bench light: a rect under the Cornell ceiling, emitting down."""
    import numpy as np

    from gatling_tpu_torch.scene.stage import LightDesc

    xf = np.eye(4)
    xf[3, :3] = [0.0, 0.0, 0.9]
    return LightDesc(
        path="/benchlight", light_type="rect", transform=xf,
        params=dict(intensity=4.0, exposure=0.0,
                    color=np.array([1.0, 0.9, 0.8], np.float32),
                    normalize=False, diffuse=1.0, specular=1.0,
                    enableColorTemperature=False, colorTemperature=6500.0,
                    width=0.8, height=0.6))


def scene_tables(path, extra_lights, device, resident_max=4096):
    """Fused tables and camera of a scene file, built by the port."""
    from gatling_tpu_torch.ops.bounce import build_fused_scene
    from gatling_tpu_torch.ops.geometry import build_geometry
    from gatling_tpu_torch.render.lights import build_light_arrays
    from gatling_tpu_torch.render.material import build_material_table, lower_material
    from gatling_tpu_torch.scene.stage import load_scene

    desc = load_scene(path)
    mat_paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(mat_paths)}
    midx[None] = len(mat_paths)
    geom = build_geometry(desc.meshes, midx)
    rows = [lower_material(desc.materials.get(p) if p else None) for p in midx]
    lights = [l for l in desc.lights if l.light_type != "dome"] + list(extra_lights)
    fs, _static = build_fused_scene(geom, build_material_table(rows),
                                    build_light_arrays(lights), device, resident_max)
    return fs, desc.first_camera()


def wave_state(cam_desc, w, h, samples, device, tiled=False):
    """Packed state of the main path's first ray wave over a w x h frame:
    `samples` jittered camera samples of every pixel, with the pixel and
    sample indices render_pixels_fused gives them (pixels in 32x32 tiles
    when `tiled`, as it orders them for a clustered scene)."""
    import torch

    from gatling_tpu_torch.ops import sampling as smp
    from gatling_tpu_torch.ops.bounce import pack_state
    from gatling_tpu_torch.render.camera import camera_uniforms, generate_primary_rays
    from gatling_tpu_torch.render.fused import tile_order

    cam = camera_uniforms(cam_desc, False, device)
    pix = torch.arange(w * h, device=device)
    if tiled:
        pix = torch.as_tensor(tile_order(w, h), device=device)
    pix = pix.repeat(samples)
    sidx = torch.arange(samples, device=device).repeat_interleave(w * h)
    o, d, rng = generate_primary_rays(cam, w, h, pix % w, pix // w, smp.rng_init(pix, sidx),
                                      True, True, False)
    return pack_state(o, d, rng, pix.numel())


def params_row(bounce: int, device):
    import torch

    from gatling_tpu_torch.render.integrator import RenderConfig, Uniforms
    from gatling_tpu_torch.ops.bounce import make_params
    from gatling_tpu_torch.render.camera import CameraUniforms

    cam = CameraUniforms(None, None, None, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    uni = Uniforms(cam, 0, 1.0, 10.0, 0.95, 1.0, 1.0, 7)
    return make_params(RenderConfig(1, 1), uni, bounce + 1, device)[bounce].contiguous()


def compare(kernel_state, twin_state):
    """Mismatch counts of the kernel's state against the twin's: rows 12-15
    bit for bit, rows 0-11 at rtol/atol; returns (bad_bits, outside, n,
    max_abs_err over rows 0-11)."""
    import torch

    k, t = kernel_state, twin_state
    bad_bits = int((k[12:].view(torch.int32) != t[12:].view(torch.int32)).any(dim=0).sum())
    close = torch.isclose(k[:12], t[:12], rtol=RTOL, atol=ATOL).all(dim=0)
    outside = int((~close).sum())
    max_err = float((k[:12] - t[:12]).abs().max())
    return bad_bits, outside, k.shape[1], max_err


def k1_bound_ms(state, fs) -> float:
    """The least time of one K1 launch on `state`: its 16 state rows read
    and written once and the tables read once, at the HBM rate, against
    every alive ray's test of every triangle at the f32 rate."""
    alive = int((state[13] > 0.5).sum())
    nbytes = 2 * state.numel() * 4 + 4 * (fs.tris.numel() + fs.mats.numel() + fs.lights.numel())
    return _bound(nbytes, alive * fs.tris.shape[0] * TRI_TEST_FLOPS)


def _bound(nbytes: int, ops: int):
    """(least ms, what bounds it) for moving nbytes and doing ops f32 operations."""
    tb_, to = nbytes / HBM_BPS, ops / F32_FLOPS
    return max(tb_, to) * 1e3, "bytes" if tb_ >= to else "operations"


def k2_bound_ms(state, fs, work: tuple[int, int]):
    """The least time of one K2 launch: the state rows read and written
    and every table read once (HBM), against the f32 work the wave's
    closest hits need (bounce_ref.walk_work): the 16 cluster-box slab tests
    of each entry box a ray enters before its hit, and the 128 triangle
    tests of each cluster box it enters before its hit. The TLAS node
    tests and the instance transforms are left out: a floor."""
    n_entries, n_clusters = work
    nbytes = 2 * state.numel() * 4 + 4 * (fs.tris.numel() + fs.mats.numel()
                                          + fs.lights.numel() + sum(t.numel() for t in fs.walk))
    return _bound(nbytes, n_entries * 16 * SLAB_FLOPS + n_clusters * 128 * TRI_TEST_FLOPS)


def time_ms(fn, state, reps: int = 7) -> float:
    """Median of `reps` timed launches on fresh copies of `state` (CUDA
    events around the call alone)."""
    import torch

    times = []
    for _ in range(reps + 1):
        s = state.clone()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(s)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[1:])


def phase_kernel(device):
    """Phase 3: the kernel, through bounce_step, against its twin on the
    main path's ray waves; then both timed on the Cornell waves."""
    import torch

    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.bounce_ref import bounce_ref

    cases = [("cornell", CORNELL, (), False, FULL_RES, FULL_RES, 2),
             ("cornell_nee", CORNELL, (bench_rect_light(),), True, FULL_RES, FULL_RES, 2),
             ("analytic_nee", ANALYTIC, (), True, ANALYTIC_RES, ANALYTIC_RES, ANALYTIC_SPP)]
    max_err, times = 0.0, {}
    for label, path, extra, nee, w, h, samples in cases:
        fs, cam = scene_tables(path, extra, device)
        lt = tuple(fs.light_types.tolist())
        wave = state = wave_state(cam, w, h, samples, device)
        for b in range(5):
            params = params_row(b, device)
            twin = state.clone()
            bounce_ref(params, fs.tris, fs.mats, fs.lights, lt, twin, nee)
            if b in (0, 4):
                got = state.clone()
                tb.bounce_step(params, fs, got, nee)
                torch.cuda.synchronize()
                bad_bits, outside, n, err = compare(got, twin)
                log(f"parity {label} bounce {b}: {bad_bits} rays with rows 12-15 not "
                    f"bit-equal, {outside} of {n} rays outside rtol {RTOL}/atol {ATOL} "
                    f"on rows 0-11, max abs err {err:.3g}")
                max_err = max(max_err, err)
                assert bad_bits <= n * (1 - MIN_AGREE), (label, b, bad_bits)
                assert outside <= n * (1 - MIN_AGREE), (label, b, outside)
            state = twin
        if path == CORNELL:
            p0 = params_row(0, device)
            times[nee] = (time_ms(lambda s: tb.bounce_step(p0, fs, s, nee), wave),
                          time_ms(lambda s: bounce_ref(p0, fs.tris, fs.mats, fs.lights, lt, s, nee),
                                  wave, reps=3), k1_bound_ms(wave, fs))
            log(f"timing {label} bounce 0 at {wave.shape[1]} rays: kernel "
                f"{times[nee][0]:.3f} ms, plain twin {times[nee][1]:.3f} ms, bound "
                f"{times[nee][2][0]:.4f} ms ({times[nee][2][1]})")
    return max_err, times


def sphere_field_setup(device):
    """sphere_field's scene description, material index and table, and its
    instanced (gi's route) and flattened kernel tables, the key light in
    both."""
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.geometry import build_geometry
    from gatling_tpu_torch.render.lights import build_light_arrays
    from gatling_tpu_torch.render.material import build_material_table, lower_material
    from gatling_tpu_torch.scene.examples import sphere_field

    t0 = time.perf_counter()
    desc = sphere_field()
    mat_paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(mat_paths)}
    midx[None] = len(mat_paths)
    table = build_material_table([lower_material(desc.materials.get(p) if p else None)
                                  for p in midx])
    lights = build_light_arrays(desc.lights)
    inst, istatic = tb.build_fused_scene_instanced(desc.meshes, midx, table, lights, device)
    t1 = time.perf_counter()
    flat, fstatic = tb.build_fused_scene(build_geometry(desc.meshes, midx), table, lights, device)
    t2 = time.perf_counter()
    assert istatic.instanced and fstatic.clustered and not fstatic.instanced
    log(f"sphere_field: {fstatic.n_tris} triangles; instanced tables {istatic.n_l1} entries "
        f"over {istatic.n_clusters} unique clusters ({inst.tris.numel() * 4 / 1e6:.2f} MB, "
        f"built in {t1 - t0:.2f} s); flattened {fstatic.n_clusters} clusters in "
        f"{fstatic.n_l1} entries ({flat.tris.numel() * 4 / 1e6:.1f} MB, built in {t2 - t1:.2f} s)")
    return desc, midx, table, inst, flat


def phase_walk(device, sf):
    """Phase 3b: K2 against its twin on sphere_field's first wave and on the
    Cornell box's clustered tables against K1; then K2 and the twin timed,
    and K2 timed at bounces 1-5 with and without the coherence sort."""
    import torch

    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.bounce_ref import (P_TMIN, bounce_ref, walk_closest,
                                                  walk_hit_attrs, walk_work)
    from gatling_tpu_torch.render.fused import coherence_keys

    desc, _midx, _table, inst, flat = sf
    cam = desc.first_camera()
    wave = wave_state(cam, SF_RES, SF_RES, SF_SPP, device, tiled=True)
    max_err = 0.0
    for label, fs in (("instanced", inst), ("flattened", flat)):
        lt = tuple(fs.light_types.tolist())
        for nee in (False, True):
            state = wave
            for b in range(5):
                params = params_row(b, device)
                twin = state.clone()
                bounce_ref(params, fs.tris, fs.mats, fs.lights, lt, twin, nee, fs.walk)
                if b in (0, 4):
                    got = state.clone()
                    tb.bounce_step(params, fs, got, nee)
                    torch.cuda.synchronize()
                    bad_bits, outside, n, err = compare(got, twin)
                    log(f"parity sphere_field {label} nee={nee} bounce {b}: {bad_bits} rays "
                        f"with rows 12-15 not bit-equal, {outside} of {n} rays outside rtol "
                        f"{RTOL}/atol {ATOL} on rows 0-11, max abs err {err:.3g}")
                    max_err = max(max_err, err)
                    assert bad_bits <= n * (1 - MIN_AGREE), (label, nee, b, bad_bits)
                    assert outside <= n * (1 - MIN_AGREE), (label, nee, b, outside)
                state = twin

    # Cornell in clustered tables (one cluster) against K1's resident step;
    # not folded into max_err, which is the kernel against its twin: the two
    # branches compute t differently, so a ray on a triangle edge can flip
    for nee, extra in ((False, ()), (True, (bench_rect_light(),))):
        res, cam_c = scene_tables(CORNELL, extra, device)
        clu, _ = scene_tables(CORNELL, extra, device, resident_max=0)
        assert clu.walk is not None and res.walk is None
        state = wave_state(cam_c, FULL_RES, FULL_RES, 2, device)
        for b in range(5):
            params = params_row(b, device)
            ref = state.clone()
            tb.bounce_step(params, res, ref, nee)
            if b in (0, 4):
                got = state.clone()
                tb.bounce_step(params, clu, got, nee)
                torch.cuda.synchronize()
                bad_bits, outside, n, err = compare(got, ref)
                log(f"parity cornell clustered (K2) vs resident (K1) nee={nee} bounce {b}: "
                    f"{bad_bits} rays with rows 12-15 not bit-equal, {outside} of {n} outside "
                    f"tolerance, max abs err {err:.3g}")
                assert bad_bits <= n * (1 - MIN_AGREE) and outside <= n * (1 - MIN_AGREE)
            state = ref

    # timing at bounce 0: the wave as generated (tiled pixels) and sorted
    # by the coherence key as render_pixels_fused sorts after a bounce
    box = inst.walk.l1
    lo = box[:, 0:3].min(dim=0).values
    inv = 1.0 / torch.clamp(box[:, 3:6].max(dim=0).values - lo, min=1e-12)

    def sort(s):  # one bounce's sort in render_pixels_fused
        order = torch.argsort(coherence_keys(s, lo, inv), stable=True)
        return s[:, order], order

    waves = {"generated": wave, "sorted": sort(wave)[0]}
    p0 = params_row(0, device)
    times = {}
    for label, fs in (("instanced", inst), ("flattened", flat)):
        lt = tuple(fs.light_types.tolist())
        o, d, alive = wave[0:3].T.contiguous(), wave[3:6].T.contiguous(), wave[13] > 0.5
        tmin = float(p0[P_TMIN])
        win = walk_closest(fs.walk, fs.tris, o, d, alive, tmin)
        work = walk_work(fs.walk, o, d, alive, tmin, walk_hit_attrs(fs.walk, fs.tris, o, d, win)[0])
        hits = int((win >= 0).sum())
        for order, wv in waves.items():
            for nee in (False, True):
                k = time_ms(lambda s: tb.bounce_step(p0, fs, s, nee), wv)
                twin = time_ms(lambda s: bounce_ref(p0, fs.tris, fs.mats, fs.lights, lt, s, nee,
                                                    fs.walk), wv, reps=2)
                times[(label, order, nee)] = (k, twin, k2_bound_ms(wv, fs, work))
                log(f"timing K2 sphere_field {label} wave {order} nee={nee} bounce 0 at "
                    f"{wv.shape[1]} rays ({hits} hit; {work[0]} entry boxes and {work[1]} "
                    f"cluster boxes entered before the hit): kernel {k:.3f} ms, plain twin "
                    f"{twin:.1f} ms, bound {times[(label, order, nee)][2][0]:.4f} ms "
                    f"({times[(label, order, nee)][2][1]})")

    # bounces 1-5 of a frame: K2 on the state as the last bounce left it
    # (the ray order of a frame without the sort) and sorted by the
    # coherence key (the order render_pixels_fused gives it), and the sort
    sorted_ms = {}
    for label, fs in (("instanced", inst), ("flattened", flat)):
        for nee in (False, True):
            state = wave.clone()
            tb.bounce_step(p0, fs, state, nee)
            sums = [0.0, 0.0, 0.0]
            for b in range(1, SF_BOUNCES):
                params = params_row(b, device)
                alive = int((state[13] > 0.5).sum())
                k_as_is = time_ms(lambda s: tb.bounce_step(params, fs, s, nee), state)
                k_sorted = time_ms(lambda s: tb.bounce_step(params, fs, s, nee), sort(state)[0])
                t_sort = time_ms(sort, state)
                for i, v in enumerate((k_as_is, k_sorted, t_sort)):
                    sums[i] += v
                log(f"timing K2 sphere_field {label} nee={nee} bounce {b} ({alive} rays alive): "
                    f"unsorted {k_as_is:.3f} ms, sorted {k_sorted:.3f} ms, the sort {t_sort:.3f} ms")
                tb.bounce_step(params, fs, state, nee)
            sorted_ms[(label, nee)] = sums
            log(f"timing K2 sphere_field {label} nee={nee} bounces 1-5: unsorted {sums[0]:.3f} ms, "
                f"sorted {sums[1]:.3f} ms + the sorts {sums[2]:.3f} ms")
    return max_err, times, sorted_ms


def image_checks(img, label):
    """The Cornell image checks of tests/test_render_cornell.py."""
    import numpy as np

    h, w = img.shape[:2]
    assert np.isfinite(img).all(), label
    assert (img >= 0).all(), label
    lum = img[..., :3].mean(-1)
    iy, _ix = np.unravel_index(lum.argmax(), lum.shape)
    assert iy > h * 0.6 and lum.max() > 5.0, (label, iy, lum.max())
    mid = img[int(h * 0.4):int(h * 0.6)]
    left = mid[:, int(w * 0.07):int(w * 0.15), :3].mean(axis=(0, 1))
    right = mid[:, int(w * 0.85):int(w * 0.93), :3].mean(axis=(0, 1))
    assert left[0] > 2.0 * left[1] and left[0] > 2.0 * left[2], (label, left)
    assert right[1] > 2.0 * right[0] and right[1] > 2.0 * right[2], (label, right)


def counted_render(params, label):
    """One gi.render, timed to the end of the host copies, all eight
    kernels' launch counts set to 0 just before it and read just after;
    returns (COLOR buffer, seconds, Mray/s or None, launches)."""
    import torch

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops import trace as tt

    for counts in (tb.launches, tt.launches):
        for k in counts:
            counts[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gi.render(params)
    dt = time.perf_counter() - t0
    launches = {**tb.launches, **tt.launches}
    segs = params.scene.last_segments
    mrays = segs / dt / 1e6 if segs else None
    log(f"render {label}: {dt:.4f} s wall, {segs:.0f} traced segments, "
        f"{'-' if mrays is None else f'{mrays:.1f}'} Mray/s, kernel launches {launches}")
    return params.aov_bindings[0].render_buffer.data.copy(), dt, mrays, launches


def warm_render(params, label):
    """A first frame (scene build included), then the timed warm frame
    on the same scene and samples (counted_render's return)."""
    from gatling_tpu_torch import gi

    counted_render(params, label + " (first frame)")
    params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    return counted_render(params, label + " (warm)")


def cornell_params(device, settings, lights=()):
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.cli import load_gi_scene
    from gatling_tpu_torch.interface import AovId

    scene, desc, merged = load_gi_scene(CORNELL, device, settings)
    for light in lights:
        scene.add_light(light)
    buf = gi.GiRenderBuffer(FULL_RES, FULL_RES, 4)
    return gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                             aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                             render_settings=merged)


def sphere_field_params(device, sf, nee: bool):
    """gi render parameters of sphere_field at the bench's settings."""
    return desc_params(device, sf[0], SF_RES, dict(spp=SF_SPP, maxBounces=SF_BOUNCES,
                                                   nextEventEstimation=nee))


def sphere_field_classes(device, sf):
    """Per pixel of a 512x512 frame, from the ray through its centre: whether
    it first hits the ground or a sphere, and whether that point sees the
    key light's centre (a twin walk toward it) with its normal facing it."""
    import torch

    from gatling_tpu_torch.ops import sampling as smp
    from gatling_tpu_torch.ops.bounce_ref import walk_closest, walk_hit_attrs, walk_occluded
    from gatling_tpu_torch.render.camera import camera_uniforms, generate_primary_rays

    desc, _midx, _table, inst, _flat = sf
    n = SF_RES * SF_RES
    pix = torch.arange(n, device=device)
    o, d, _ = generate_primary_rays(camera_uniforms(desc.first_camera(), False, device), SF_RES,
                                    SF_RES, pix % SF_RES, pix // SF_RES, smp.rng_init(pix, 0),
                                    False, False, False)
    win = walk_closest(inst.walk, inst.tris, o, d, torch.ones(n, dtype=torch.bool, device=device),
                       0.0)
    t, _u, _v, gn, *_rest = walk_hit_attrs(inst.walk, inst.tris, o, d, win)
    obj = torch.where(win >= 0, inst.walk.inst[(win // 2048).clamp(min=0), 13], -1.0)
    hit = win >= 0
    pos = o + torch.where(hit, t, 0.0)[:, None] * d
    gnv = torch.stack(gn, 1)
    gnv = torch.where(((gnv * d).sum(1) > 0)[:, None], -gnv, gnv)  # facing the camera
    to_l = torch.as_tensor(desc.lights[0].transform[3, :3], dtype=torch.float32,
                           device=device) - pos
    dist = to_l.norm(dim=1)
    ldir = to_l / dist[:, None]
    cosl = (gnv * ldir).sum(1)
    faces = hit & (cosl > 0.2)
    origin = pos + gnv * 1e-3
    occ = torch.zeros(n, dtype=torch.bool, device=device)
    idx = faces.nonzero()[:, 0]
    occ[idx] = walk_occluded(inst.walk, inst.tris, origin[idx], ldir[idx], dist[idx] - 1.0)
    ground = obj == 8.0
    spheres = hit & (obj < 8.0)
    lit = faces & ~occ
    return {k: v.cpu().numpy().reshape(SF_RES, SF_RES) for k, v in dict(
        lit_ground=ground & lit, shadowed_ground=ground & ~lit,
        lit_spheres=spheres & lit, dark_spheres=spheres & (cosl < -0.2)).items()}


def phase_sphere_field(device, sf):
    """Phases 4b and 4c: sphere_field through gi.render, NEE off and on, the
    same frame through the flattened tables, and a transform edit."""
    import numpy as np
    import torch

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.geometry import build_geometry
    from gatling_tpu_torch.render.camera import camera_uniforms
    from gatling_tpu_torch.render.fused import render_pixels_fused
    from gatling_tpu_torch.render.integrator import RenderConfig, Uniforms

    out, imgs = {}, {}
    for nee in (False, True):
        params = sphere_field_params(device, sf, nee)
        label = f"sphere_field {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces nee={nee}"
        img, _dt, out[f"sphere_field{'_nee' if nee else ''}"], launches = counted_render(
            params, label)
        assert params.scene._fused_static.instanced
        assert launches["K1"] == 0 and launches["K2"] > 0, launches
        if not nee:
            k2_launches = launches["K2"]  # the main path's sphere_field frame
        assert np.isfinite(img).all() and (img >= 0).all(), label
        imgs[nee] = img[..., :3]
        if nee:
            _, _dt, warm, _ = counted_render(params, label + " (second frame, warm)")
    assert imgs[True].mean() > imgs[False].mean() * 1.02, "NEE must add light"

    # NEE's direct light lands where the key light is seen: the lit ground
    # and the spheres' lit sides gain more than the ground in the spheres'
    # shadows and the sides turned away from the light, which gain only
    # through later bounces (at 64x64 x 2 spp on the CPU twin: 2.8 and 2.7
    # times as much)
    cls = sphere_field_classes(device, sf)
    gain = (imgs[True] - imgs[False]).mean(-1)
    means = {k: float(gain[m].mean()) for k, m in cls.items()}
    log(f"NEE gain by first-hit class {means}, pixels "
        f"{ {k: int(m.sum()) for k, m in cls.items()} }")
    assert means["lit_ground"] > 1.5 * max(means["shadowed_ground"], 1e-3)
    assert means["lit_spheres"] > 1.5 * max(means["dark_spheres"], 1e-3)
    lum = imgs[True].mean(-1)
    assert lum[cls["lit_ground"]].mean() > lum[cls["shadowed_ground"]].mean()

    # the same frame through the flattened tables, render_pixels_fused direct
    desc, _midx, _table, inst, flat = sf
    params = sphere_field_params(device, sf, True)
    gi.render(params)
    inst_img = params.aov_bindings[0].render_buffer.data[..., :3].copy()
    s = params.render_settings
    cfg = RenderConfig(width=SF_RES, height=SF_RES, spp=SF_SPP, max_bounces=SF_BOUNCES,
                       nee=True)
    uni = Uniforms(camera=camera_uniforms(desc.first_camera(), False, device), sample_offset=0,
                   inv_total_sample_count=1.0 / SF_SPP, max_sample_value=10.0,
                   rr_inv_min_term_prob=0.95, light_intensity_multiplier=1.0,
                   meters_per_scene_unit=1.0, max_volume_walk_length=7)
    assert s["spp"] == SF_SPP
    t0 = time.perf_counter()
    flat_img = render_pixels_fused(cfg, uni, flat, torch.arange(SF_RES * SF_RES, device=device),
                                   SF_SPP, 0).cpu().numpy().reshape(SF_RES, SF_RES, 3)
    log(f"render sphere_field through the flattened tables (render_pixels_fused, nee): "
        f"{time.perf_counter() - t0:.3f} s")
    rel = abs(flat_img.mean() - inst_img.mean()) / inst_img.mean()
    close = (np.abs(flat_img - inst_img) <= 1e-3 * np.maximum(1.0, np.abs(inst_img))).all(-1).mean()
    log(f"sphere_field instanced vs flattened: mean rel diff {rel:.2e}, {close:.5f} of pixels "
        "within 1e-3")
    assert rel < 5e-3 and close >= 0.99

    # 4c: move one sphere group as its PointInstancer's next time sample
    # would, tell the scene, render; the refit rebuilds the instance tables
    # over the cached unique clusters and must equal a build from scratch
    scene = params.scene
    tris0 = scene._fused.tris
    group = scene.meshes[3]
    shift = np.eye(4)
    shift[3, :3] = [0.3, -0.2, 0.1]
    group.instance_transforms = group.instance_transforms @ shift
    t0 = time.perf_counter()
    scene.set_mesh_transform(group, group.transform)
    gi.render(params)
    log(f"transform edit + frame: {time.perf_counter() - t0:.3f} s")
    assert scene._fused.tris is tris0  # the unique cluster table stayed on the card
    fresh, _ = tb.build_fused_scene_instanced(scene.meshes, scene._material_index,
                                              scene._material_table, scene._light_arrays, device)
    refit = [scene._fused.tris, *scene._fused.walk]
    assert all(torch.equal(a, b) for a, b in zip(refit, [fresh.tris, *fresh.walk]))
    assert not torch.equal(scene._fused.walk.l1, inst.walk.l1)
    fresh_geom = build_geometry(scene.meshes, scene._material_index)
    assert all(np.array_equal(a, b) for a, b in zip(scene._geom, fresh_geom))
    edited = params.aov_bindings[0].render_buffer.data[..., :3]
    assert np.isfinite(edited).all() and abs(edited.mean() - inst_img.mean()) / inst_img.mean() < 0.05
    log("transform refit: instance tables equal a build from scratch and geometry a fresh "
        "geometry build, bit for bit")
    out["sphere_field_nee_warm"] = warm
    return out, k2_launches


def phase_renders(device):
    """Phases 4 and 5: the main path at full size, and progressive frames."""
    import numpy as np

    from gatling_tpu_torch.cli import render_scene_file

    settings = dict(spp=16, maxBounces=8)
    out = {}
    img, _dt, mr, launches = counted_render(cornell_params(device, settings),
                                     f"cornell {FULL_RES}^2 16spp 8 bounces")
    image_checks(img, "cornell")
    assert launches["K1"] > 0 and launches["K2"] == 0, launches
    k1_launches = launches["K1"]  # the main path's Cornell frame
    out["cornell"] = mr
    img_nee, _dt, mr, _ = counted_render(
        cornell_params(device, dict(settings, nextEventEstimation=True), [bench_rect_light()]),
        f"cornell + NEE rect light {FULL_RES}^2 16spp 8 bounces")
    image_checks(img_nee, "cornell_nee")
    assert img_nee[..., :3].mean() > img[..., :3].mean(), "NEE must add light"
    out["cornell_nee"] = mr

    # Lights.Analytic at its authored resolution and render settings; the
    # plain twin on the CPU renders the same samples as the reference
    t0 = time.perf_counter()
    gpu, scene = render_scene_file(ANALYTIC, 96, 96, {}, device=device)
    dt = time.perf_counter() - t0
    out["analytic"] = scene.last_segments / dt / 1e6
    log(f"render Lights.Analytic 96x96 24spp 2 bounces NEE: {dt:.3f} s wall "
        f"(scene build included), {out['analytic']:.1f} Mray/s")
    cpu, _ = render_scene_file(ANALYTIC, 96, 96, {}, device="cpu")
    assert np.isfinite(gpu).all() and (gpu >= 0).all() and gpu[..., :3].mean() > 0.01
    rel = abs(gpu[..., :3].mean() - cpu[..., :3].mean()) / cpu[..., :3].mean()
    close = np.isclose(gpu[..., :3], cpu[..., :3], rtol=1e-3, atol=1e-3).all(-1).mean()
    log(f"Lights.Analytic card vs CPU twin: mean rel diff {rel:.2e}, {close:.4f} of pixels "
        "within 1e-3")
    assert rel < 1e-2 and close >= 0.99

    # progressive accumulation: three requests on one scene
    params = cornell_params(device, dict(spp=16, maxBounces=8))
    imgs = []
    for expect in (16, 32, 48):
        img, _dt, mr, _ = counted_render(params, f"progressive frame -> sampleOffset {expect}")
        assert params.scene.sample_offset == expect, params.scene.sample_offset
        imgs.append(img[..., :3])
    means = [float(i.mean()) for i in imgs]
    grads = [float(np.abs(np.diff(i, axis=1)).mean()) for i in imgs]
    log(f"progressive means {means}, gradient noise {grads}")
    assert abs(means[2] - means[0]) / means[0] < 0.02
    assert grads[2] < grads[1] < grads[0]
    return out, k1_launches


def write_textures(tex_dir: str) -> dict[str, str]:
    """The bench's extra textures (bench.py:81-122): a leaning tangent-space
    normal map (2x2) and the 64x64 checker of cornell_textured."""
    import numpy as np

    from gatling_tpu_torch import imgio

    lean = np.zeros((2, 2, 4), np.uint8)
    lean[...] = (200, 128, 230, 255)
    c = (np.arange(64)[:, None] // 8 + np.arange(64)[None, :] // 8) % 2
    checker = np.stack([np.where(c, 230, 90), np.where(c, 200, 120), np.where(c, 90, 220),
                        np.full_like(c, 255)], -1).astype(np.uint8)
    out = {"lean": os.path.join(tex_dir, "lean.png"),
           "checker": os.path.join(tex_dir, "checker.png")}
    imgio.write_image_file(out["lean"], lean)
    imgio.write_image_file(out["checker"], checker)
    return out


def texture_every_material(materials: dict, surface_input: str, file: str) -> None:
    """Connect a raw UsdUVTexture of `file` to `surface_input` of every
    material (a normal input takes lower_material's default scale 2, bias
    -1, as the bench's normal map does)."""
    from gatling_tpu_torch.scene.stage import ShaderNode

    for m in materials.values():
        node = ShaderNode(path=f"{m.path}/{surface_input}_tex", shader_id="UsdUVTexture",
                          inputs={"file": file, "sourceColorSpace": "raw"},
                          input_connections={})
        m.nodes[node.path] = node
        m.nodes[m.surface_node].input_connections[surface_input] = (node.path, "rgb")


def split_tables(params, flattened: bool = False):
    """The split kernels' tables of a scene that gi.render rendered, as the
    frame used them: (fused scene, static, device material table, texture
    pool, textured parameters). With `flattened`, gi's flattened build of
    the same geometry and kernel material table replaces its own route."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.ops import bounce as tb

    scene = params.scene
    fs, static = scene._fused, scene._fused_static
    if flattened:
        fs, static, _order = tb.build_fused_scene_with_order(
            scene._geom, gi._fused_mat_table(scene), scene._light_arrays, scene.device)
        static = gi._with_split(scene, static)
    return fs, static, scene._material_dev, scene._texture_pool, static.textured_params


def compare_hits(kernel_hit, twin_hit):
    """The kernel's hit buffer against the twin's: (rays whose H_HIT or H_MAT
    rows are not bit-equal, rays outside rtol/atol on any row, n, max abs
    err over the twin's hit rays)."""
    import torch

    from gatling_tpu_torch.ops.split_ref import H_HIT, H_MAT

    k, t = kernel_hit, twin_hit
    rows = [H_HIT, H_MAT]
    bad_bits = int((k[rows].view(torch.int32) != t[rows].view(torch.int32)).any(dim=0).sum())
    outside = int((~torch.isclose(k, t, rtol=RTOL, atol=ATOL).all(dim=0)).sum())
    hit = t[H_HIT] > 0.5
    max_err = float((k[:, hit] - t[:, hit]).abs().max()) if bool(hit.any()) else 0.0
    return bad_bits, outside, k.shape[1], max_err


def k3_bound_ms(state, fs, hit_rows: int, work) -> tuple[float, str]:
    """The least time of one K3 launch: each ray's origin, direction and
    alive flag read and its hit rows written once, the tables read once
    (HBM), against the triangle and box tests the wave's closest hits need
    (resident: every alive ray against every triangle; walk: as K2's
    floor, bounce_ref.walk_work)."""
    r = state.shape[1]
    nbytes = 4 * r * (7 + hit_rows) + 4 * (fs.tris.numel() + sum(
        t.numel() for t in (fs.walk or ())))
    if fs.walk is None:
        return _bound(nbytes, int((state[13] > 0.5).sum()) * fs.tris.shape[0] * TRI_TEST_FLOPS)
    n_entries, n_clusters = work
    return _bound(nbytes, n_entries * 16 * SLAB_FLOPS + n_clusters * 128 * TRI_TEST_FLOPS)


def k4_bound_ms(state, fs, par_rows: int) -> tuple[float, str]:
    """The least time of one K4 launch, a floor: the state read and written,
    the hit rows it reads and the textured parameter rows read, the
    material and light tables read once (HBM); the shading arithmetic and
    the NEE shadow walk are left out. K4 reads 13 hit rows (csrc/bounce.cu
    read_hit): never H_T, the uv or the tangent rows."""
    from gatling_tpu_torch.ops.split_ref import H_DS, H_FRONT, H_GN, H_HIT, H_MAT, H_N, H_POS

    read = {H_HIT, H_MAT, H_FRONT, H_DS, *range(H_GN, H_GN + 3), *range(H_N, H_N + 3),
            *range(H_POS, H_POS + 3)}
    r = state.shape[1]
    return _bound(4 * r * (2 * 16 + len(read) + par_rows)
                  + 4 * (fs.mats.numel() + fs.lights.numel()), 0)


def phase_split(device, scenes: dict):
    """Phase 3c: K3 and K4 against their twins on the tables of the scenes
    that phase 4d rendered through gi: the interior's first wave (plain and
    normal-mapped, gi's instanced tables and the flattened ones, NEE off
    and on) and the textured Cornell box's (resident); then timed."""
    import torch

    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.bounce_ref import P_TMIN, walk_work
    from gatling_tpu_torch.ops.split_ref import H_T, par_row_starts, shade_ref, trace_ref
    from gatling_tpu_torch.render.fused import coherence_keys, material_rows

    cases = []
    for label in ("interior", "interior_normalmapped"):
        params = scenes[label]
        wave = wave_state(params.camera, SF_RES, SF_RES, SF_SPP, device, tiled=True)
        for flattened in (False, True):
            t0 = time.perf_counter()
            tables = split_tables(params, flattened)
            st = tables[1]
            name = label + ("_flattened" if flattened else "")
            log(f"{name}: {st.n_tris} triangles, {'flattened' if flattened else 'gi'} tables "
                f"({st.n_instances} placements over {st.n_clusters} clusters, tangent rows "
                f"{st.tangents}), textured {tables[4]}; in {time.perf_counter() - t0:.2f} s")
            assert st.clustered and st.textured and st.instanced != flattened
            assert st.tangents == (label == "interior_normalmapped")
            cases += [(name, tables, wave, nee) for nee in (False, True)]
    cparams = scenes["cornell_textured"]
    ctables = split_tables(cparams)
    assert not ctables[1].clustered and ctables[4] == ("base_color",)
    cwave = wave_state(cparams.camera, FULL_RES, FULL_RES, 2, device)
    cases.append(("cornell_textured", ctables, cwave, False))

    k3_err = k4_err = 0.0
    later = None  # the interior's state at bounce 2 (plain tables, NEE on)
    for label, (fs, static, mats, pool, active), wave, nee in cases:
        lt, prow = static.light_types, par_row_starts(active)
        state = wave
        for b in range(5):
            if b == 2 and label == "interior" and nee:
                later = state
            params = params_row(b, device)
            hit = trace_ref(params, fs.tris, state, fs.walk)
            parbuf, hit_n = material_rows(mats, pool, hit, active)
            twin = state.clone()
            shade_ref(params, fs.tris, fs.mats, fs.lights, lt, twin, hit_n, parbuf, prow, nee,
                      fs.walk)
            if b in (0, 4):
                got_hit = tb.trace_step(params, fs, state)
                got = state.clone()
                tb.shade_step(params, fs, got, hit_n, parbuf, active, nee)
                torch.cuda.synchronize()
                hb, ho, n, herr = compare_hits(got_hit, hit)
                sb, so, _n, serr = compare(got, twin)
                log(f"parity {label} nee={nee} bounce {b}: K3 {hb} rays with H_HIT/H_MAT not "
                    f"bit-equal, {ho} of {n} outside rtol {RTOL}/atol {ATOL}, max abs err "
                    f"{herr:.3g} (hit rays); K4 {sb} rays with rows 12-15 not bit-equal, {so} "
                    f"outside on rows 0-11, max abs err {serr:.3g}")
                k3_err, k4_err = max(k3_err, herr), max(k4_err, serr)
                assert hb == 0 and sb == 0, (label, nee, b, hb, sb)
                for v in (ho, so):
                    assert v <= n * (1 - MIN_AGREE), (label, nee, b, ho, so)
            state = twin

    # timing at bounce 0 on the interior's wave (gi's tables, NEE on, the
    # main path's; K4 also NEE off) and the textured Cornell box's
    times = {}
    p0 = params_row(0, device)
    by_case = {(c[0], c[3]): c for c in cases}
    for label, (fs, static, mats, pool, active), wave, nee in (
            by_case[("interior", True)], by_case[("cornell_textured", False)]):
        lt, prow = static.light_types, par_row_starts(active)
        hit = tb.trace_step(p0, fs, wave)
        parbuf, hit_n = material_rows(mats, pool, hit, active)
        alive = wave[13] > 0.5
        work = None
        if fs.walk is not None:
            o, d = wave[0:3].T.contiguous(), wave[3:6].T.contiguous()
            work = walk_work(fs.walk, o, d, alive, float(p0[P_TMIN]), hit[H_T])
        t = dict(
            k3=time_ms(lambda s: tb.trace_step(p0, fs, s), wave),
            k3_twin=time_ms(lambda s: trace_ref(p0, fs.tris, s, fs.walk), wave, reps=2),
            stage=time_ms(lambda h: material_rows(mats, pool, h, active), hit),
            k4=time_ms(lambda s: tb.shade_step(p0, fs, s, hit_n, parbuf, active, nee), wave),
            k4_nee_off=time_ms(lambda s: tb.shade_step(p0, fs, s, hit_n, parbuf, active, False),
                               wave),
            k4_twin=time_ms(lambda s: shade_ref(p0, fs.tris, fs.mats, fs.lights, lt, s, hit_n,
                                                parbuf, prow, nee, fs.walk), wave, reps=2),
            k3_bound=k3_bound_ms(wave, fs, hit.shape[0], work),
            k4_bound=k4_bound_ms(wave, fs, 3 * len(active)),
            work=work, rays=wave.shape[1], hits=int((hit[0] > 0.5).sum()))
        times[label] = t
        log(f"timing {label} nee={nee} bounce 0 at {t['rays']} rays ({t['hits']} hit; walk work "
            f"{work}): K3 {t['k3']:.3f} ms (twin {t['k3_twin']:.1f} ms, bound "
            f"{t['k3_bound'][0]:.4f} ms {t['k3_bound'][1]}), texture stage {t['stage']:.3f} ms, "
            f"K4 {t['k4']:.3f} ms (NEE off {t['k4_nee_off']:.3f} ms; twin {t['k4_twin']:.1f} ms, "
            f"bound {t['k4_bound'][0]:.4f} ms {t['k4_bound'][1]})")

    # K3 on a secondary wave: the interior at bounce 2 as the twin left it
    # and in the coherence order render_pixels_fused gives it, against its
    # floor
    fs = by_case[("interior", True)][1][0]
    p2 = params_row(2, device)
    box = fs.walk.l1
    lo = box[:, 0:3].min(dim=0).values
    inv = 1.0 / torch.clamp(box[:, 3:6].max(dim=0).values - lo, min=1e-12)
    ordered = later[:, torch.argsort(coherence_keys(later, lo, inv), stable=True)]
    hit = tb.trace_step(p2, fs, later)
    alive = later[13] > 0.5
    work = walk_work(fs.walk, later[0:3].T.contiguous(), later[3:6].T.contiguous(), alive,
                     float(p2[P_TMIN]), hit[H_T])
    k3_2 = [time_ms(lambda s: tb.trace_step(p2, fs, s), wv) for wv in (later, ordered)]
    bound = k3_bound_ms(later, fs, hit.shape[0], work)
    times["interior_bounce2"] = dict(k3_unsorted=k3_2[0], k3=k3_2[1], k3_bound=bound, work=work)
    log(f"timing interior K3 bounce 2 ({int(alive.sum())} rays alive; walk work {work}): "
        f"{k3_2[0]:.3f} ms as the twin left the wave, {k3_2[1]:.3f} ms in the coherence order, "
        f"bound {bound[0]:.4f} ms ({bound[1]})")
    return k3_err, k4_err, times


def interior_params(device, tex_dir: str, normal_map: str | None = None, means_of=None,
                    **settings):
    """gi render parameters of the textured interior at the bench's
    settings. With `normal_map`, the bench's normal map on every material;
    with `means_of` (a GiScene that rendered the interior), every base
    colour is a constant: its texture's mean in that scene."""
    from gatling_tpu_torch.render.material import substitute_texture_means
    from gatling_tpu_torch.scene.examples import _preview_material, interior

    desc = interior(tex_dir=tex_dir)
    if normal_map:
        texture_every_material(desc.materials, "normal", normal_map)
    if means_of is not None:
        pf = substitute_texture_means(means_of._material_table, means_of._texture_pool).packed_f
        for path, m in list(desc.materials.items()):
            inputs = dict(m.nodes[m.surface_node].inputs)
            inputs["diffuseColor"] = tuple(float(x) for x in pf[means_of._material_index[path], :3])
            desc.materials[path] = _preview_material(path, **inputs)
    return desc_params(device, desc, SF_RES, dict(spp=SF_SPP, maxBounces=SF_BOUNCES,
                                                  nextEventEstimation=True, **settings))


def phase_interior(device, tex_dir: str, extra: dict):
    """Phase 4d: the textured interior through gi.render (the main path's
    frame for K3 and K4), its checks and variants; the textured Cornell
    box at its bench settings."""
    import numpy as np
    import torch

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops import sampling as smp
    from gatling_tpu_torch.ops.split_ref import H_HIT, H_MAT
    from gatling_tpu_torch.render.camera import camera_uniforms, generate_primary_rays

    out = {}
    params = interior_params(device, tex_dir)
    label = f"interior {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces nee"
    img, _dt, out["interior_first_frame"], launches = counted_render(params,
                                                                     label + " (first frame)")
    scene = params.scene
    st = scene._fused_static
    log(f"interior route: {'instanced' if st.instanced else 'flattened'} ({st.n_instances} "
        f"placements over {st.n_clusters} unique clusters, {st.n_tris} triangles flattened), "
        f"textured {st.textured_params}")
    assert st.instanced and st.textured and launches["K3"] > 0 and launches["K4"] > 0
    assert launches["K1"] == 0 and launches["K2"] == 0, launches
    split_launches = {k: launches[k] for k in ("K3", "K4")}
    scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    img, _dt, out["interior"], launches = counted_render(params, label + " (warm)")
    assert launches == dict(split_launches, K1=0, K2=0, K5=0, K6=0, K7=0, K8=0), launches
    img = img[..., :3]
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0.01

    # per first-hit material (the centre ray of each pixel, K3), the frame's
    # mean against the mean of a frame whose base colours are the texture
    # means: diffuse and glossy responses are linear in the base colour
    n = SF_RES * SF_RES
    pix = torch.arange(n, device=device)
    o, d, _ = generate_primary_rays(camera_uniforms(params.camera, False, device), SF_RES,
                                    SF_RES, pix % SF_RES, pix // SF_RES, smp.rng_init(pix, 0),
                                    False, False, False)
    hit = tb.trace_step(params_row(0, device), scene._fused, tb.pack_state(o, d, pix, n))
    mat = torch.where(hit[H_HIT] > 0.5, hit[H_MAT], -1.0).cpu().numpy().reshape(SF_RES, SF_RES)
    mparams = interior_params(device, tex_dir, means_of=scene)
    mimg, _dt, _mr, _l = counted_render(mparams, label + " with the texture means as constants")
    assert not mparams.scene._fused_static.textured
    lum, mlum = img.mean(-1), mimg[..., :3].mean(-1)
    names = {i: p for p, i in scene._material_index.items()}
    ratios = {}
    for m in np.unique(mat[mat >= 0]).astype(int):
        sel = mat == m
        if sel.sum() >= 0.02 * n:
            ratios[names[m]] = float(lum[sel].mean() / max(mlum[sel].mean(), 1e-9))
    log(f"per-material mean over the means frame's {ratios}")
    # the two frames share their samples, so a ratio moves only with the
    # texture's variation about its mean: 1.0011-1.0057 on an H100 80GB
    # HBM3 (700 W); 0.02 is 3.5 times the largest deviation
    assert ratios and all(abs(r - 1.0) < 0.02 for r in ratios.values()), ratios

    # textureLodBounces=2: bounces 2-5 shade from the means (K1/K2 tables)
    lparams = interior_params(device, tex_dir, textureLodBounces=2)
    limg, _dt, out["interior_lod2"], llaunches = warm_render(lparams,
                                                             label + " textureLodBounces=2")
    limg = limg[..., :3]
    rel = abs(limg.mean() - img.mean()) / img.mean()
    log(f"interior lod2 vs all taps: mean rel diff {rel:.3e}; launches {llaunches}")
    assert llaunches["K2"] > 0 and llaunches["K3"] == llaunches["K4"] < split_launches["K3"]
    assert np.isfinite(limg).all() and rel < 0.05

    nparams = interior_params(device, tex_dir, normal_map=extra["lean"])
    nimg, _dt, out["interior_normalmapped"], _ = warm_render(nparams, label + " normal-mapped")
    nimg = nimg[..., :3]
    assert nparams.scene._fused_static.tangents and np.isfinite(nimg).all() and (nimg >= 0).all()
    nrel = abs(nimg.mean() - img.mean()) / img.mean()
    log(f"interior normal-mapped vs plain: mean rel diff {nrel:.3e}")
    # the leaning normal moves the frame's mean by 6.261e-2 on an H100 80GB
    # HBM3 (700 W); the gate is half to twice that
    assert 0.03 < nrel < 0.12, nrel

    # the textured Cornell box (resident K3 and K4) at its bench settings
    cparams = cornell_params(device, dict(spp=16, maxBounces=8))
    texture_every_material(cparams.scene.materials, "diffuseColor", extra["checker"])
    cimg, _dt, out["cornell_textured"], claunches = warm_render(cparams, "cornell_textured "
                                                           f"{FULL_RES}^2 16spp 8 bounces")
    assert claunches["K3"] > 0 and claunches["K1"] == 0
    assert np.isfinite(cimg).all() and (cimg >= 0).all() and cimg[..., :3].mean() > 0.01
    scenes = {"interior": params, "interior_normalmapped": nparams, "cornell_textured": cparams}
    return out, split_launches, scenes


AOVS_RES, AOVS_SPP, AOVS_BOUNCES = 1200, 16, 8  # cornell_aovs: the Cornell bench frame
INT_AOVS = ("OBJECT_ID", "FACE_ID", "INSTANCE_ID")
# operations a live ray spends on one triangle, counted from csrc/trace.cu
TRACE_OPS = {"K5": 58, "K6": 57, "K7": 54, "K8": 53}


def all_aov_bindings(w: int, h: int):
    """One binding of every AOV: the ids in int32 buffers cleared to -1,
    the others in float buffers of at least 3 channels."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.interface import AOV_CHANNELS, AOV_IS_INT, AovId

    return [gi.GiAovBinding(a, gi.GiRenderBuffer(w, h, 1 if AOV_IS_INT[a] else
                                                 max(AOV_CHANNELS[a], 3), AOV_IS_INT[a]),
                            clear_value=-1 if AOV_IS_INT[a] else None) for a in AovId]


def cornell_aovs_params(device):
    """cornell_aovs: the Cornell box with the bench's rect light, every AOV
    bound, 1200x1200, 16 spp, 8 bounces, NEE."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.cli import load_gi_scene

    scene, desc, merged = load_gi_scene(CORNELL, device, dict(
        spp=AOVS_SPP, maxBounces=AOVS_BOUNCES, nextEventEstimation=True))
    scene.add_light(bench_rect_light())
    return gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                             aov_bindings=all_aov_bindings(AOVS_RES, AOVS_RES),
                             render_settings=merged)


def interior_aovs_params(device, tex_dir: str):
    """interior_aovs: interior(detail=1), 3,840 triangles, every AOV bound,
    512x512, 4 spp, 6 bounces, NEE."""
    from gatling_tpu_torch.scene.examples import interior

    desc = interior(detail=1, tex_dir=tex_dir)
    return desc_params(device, desc, SF_RES, dict(spp=SF_SPP, maxBounces=SF_BOUNCES,
                                                  nextEventEstimation=True), every_aov=True)


def timed_aov_render(params, label):
    """One more gi.render of every bound AOV (the framebuffer reset), as
    counted_render times and counts it; returns ({AovId: buffer}, seconds,
    launches)."""
    from gatling_tpu_torch import gi

    params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    _img, dt, _mr, launches = counted_render(params, label)
    return {b.aov_id: b.render_buffer.data.copy() for b in params.aov_bindings}, dt, launches


def check_aovs(aovs, params, label):
    """Every AOV finite; ids within their ranges and present; the normals of
    hit pixels unit length."""
    import numpy as np

    from gatling_tpu_torch.interface import AovId

    scene = params.scene
    n_inst = sum(1 if m.instance_transforms is None else len(m.instance_transforms)
                 for m in scene.meshes)
    for aov, buf in aovs.items():
        assert np.isfinite(buf).all(), (label, aov)
    obj, face, inst = (aovs[AovId[k]][..., 0] for k in INT_AOVS)
    assert obj.min() >= -1 and obj.max() < len(scene.meshes) and (obj >= 0).mean() > 0.5, label
    assert inst.min() >= -1 and inst.max() < n_inst and face.min() >= -1, label
    assert ((obj >= 0) == (face >= 0)).all() and ((obj >= 0) == (inst >= 0)).all(), label
    nrm = aovs[AovId.NORMAL][..., :3][obj >= 0] * 2.0 - 1.0
    length = np.linalg.norm(nrm, axis=-1)
    log(f"{label}: {(obj >= 0).mean():.4f} of pixels hit, {len(np.unique(obj[obj >= 0]))} objects, "
        f"{len(np.unique(face[face >= 0]))} faces; normal lengths {length.min():.6f}-"
        f"{length.max():.6f}")
    assert np.abs(length - 1.0).max() < 1e-3, label


def record_waves(params, bounces=(0, 2)):
    """One more frame of `params` with the wavefront's trace calls
    recorded: for sample 0, the closest-hit waves and the NEE shadow
    waves of `bounces` (origins, directions, tmin, tmax), as gi.render
    hands them to K5 and K6."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.render import integrator

    calls = {"closest": [], "occluded": []}
    real = {"closest": integrator._trace_closest, "occluded": integrator._trace_occluded}

    def recorder(kind):
        def fn(config, accel, *rays):
            if len(calls[kind]) <= max(bounces):
                calls[kind].append(tuple(r.clone() for r in rays))
            return real[kind](config, accel, *rays)
        return fn

    integrator._trace_closest = recorder("closest")
    integrator._trace_occluded = recorder("occluded")
    try:
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        gi.render(params)
    finally:
        integrator._trace_closest = real["closest"]
        integrator._trace_occluded = real["occluded"]
    return {kind: {b: calls[kind][b] for b in bounces if b < len(calls[kind])}
            for kind in calls}


def graphical_card_vs_cpu(device, name):
    """A tests/graphical scene at its own settings (96x96) with COLOR,
    ALBEDO and the id AOVs, on the card and through the twins on the CPU,
    the same samples. (Mesh.PrimvarInterpolation's COLOR is black: its
    only light is a distant light and the scene renders without NEE; its
    vertex colours show in the albedo.)"""
    import numpy as np

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.cli import load_gi_scene
    from gatling_tpu_torch.interface import AovId

    path = os.path.join(HERE, "tests", "graphical", name, "scene.usda")
    out = {}
    for dev in (device, "cpu"):
        scene, desc, merged = load_gi_scene(path, dev)
        binds = [b for b in all_aov_bindings(96, 96)
                 if b.aov_id in (AovId.COLOR, AovId.ALBEDO, *(AovId[k] for k in INT_AOVS))]
        gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(), aov_bindings=binds,
                                    render_settings=merged))
        assert scene._accel is not None, name  # the wavefront route
        out[str(dev)] = {b.aov_id: b.render_buffer.data for b in binds}
    gpu, cpu = out[str(device)], out["cpu"]
    same = {k: float((gpu[AovId[k]] == cpu[AovId[k]]).mean()) for k in INT_AOVS}
    rel = {}
    for aov in (AovId.COLOR, AovId.ALBEDO):
        g, c = gpu[aov][..., :3], cpu[aov][..., :3]
        assert np.isfinite(g).all() and (g >= 0).all(), (name, aov)
        rel[aov.name] = float(abs(g.mean() - c.mean()) / max(float(c.mean()), 1e-12))
    log(f"{name} card vs CPU twins: ids equal on {same}; mean rel diff {rel}; COLOR means "
        f"{gpu[AovId.COLOR][..., :3].mean():.6f} / {cpu[AovId.COLOR][..., :3].mean():.6f}")
    assert all(v >= 0.999 for v in same.values()) and all(v < 0.01 for v in rel.values())
    return same, rel


def phase_wavefront(device, tex_dir: str):
    """Phase 4e: cornell_aovs and interior_aovs through gi.render's wavefront
    route (K5 closest hits, K6 shadow rays): a first and warm frames, the
    checks, the launch counts; the two graphical scenes on the card against
    the CPU twins. Returns (frame seconds, launches of the Cornell warm
    frame, recorded waves and tables per scene)."""
    import numpy as np

    from gatling_tpu_torch.interface import AovId

    out, waves = {}, {}
    for label, params, warm_frames in (
            ("cornell_aovs", cornell_aovs_params(device), 3),
            ("interior_aovs", interior_aovs_params(device, tex_dir), 3)):
        desc = (f"{label} {params.aov_bindings[0].render_buffer.width}^2 "
                f"{params.render_settings['spp']}spp {params.render_settings['maxBounces']} "
                "bounces nee, every AOV")
        _aovs, out[label + "_first_frame"], _ = timed_aov_render(params, desc + " (first frame)")
        warm = []
        for i in range(warm_frames):
            aovs, dt, launches = timed_aov_render(params, desc + f" (warm {i + 1})")
            warm.append(dt)
        out[label + "_warm"] = warm
        scene = params.scene
        assert scene._tracer == "matrix" and scene._fused is None
        assert launches["K5"] > 0 and launches["K6"] > 0, launches
        assert all(launches[k] == 0 for k in ("K1", "K2", "K3", "K4", "K7", "K8")), launches
        if label == "cornell_aovs":
            wavefront_launches = {k: launches[k] for k in ("K5", "K6", "K7", "K8")}
            image_checks(aovs[AovId.COLOR], label)
        color = aovs[AovId.COLOR][..., :3]
        assert (color >= 0).all() and color.mean() > 0.01, label
        check_aovs(aovs, params, label)
        log(f"{label}: warm frames {[round(t, 4) for t in warm]} s, median "
            f"{float(np.median(warm)):.4f} s")
        waves[label] = (record_waves(params), scene._accel.tables, scene._geom)
    for name in ("Mesh.PrimvarInterpolation", "Render.AOVs"):
        out[name] = graphical_card_vs_cpu(device, name)
    return out, wavefront_launches, waves


def event_ms(fn, reps: int = 7) -> float:
    """Median of `reps` CUDA-event-timed calls of fn() after one warm-up."""
    import torch

    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[1:])


def trace_bound_ms(kernel: str, rays, table, tested: int):
    """The least time of one launch: each ray's o, d, tmin, tmax read once,
    its result written once (t, tri, u, v: 16 B; a flag: 1 B), the table
    read once (HBM), against the `tested` ray-triangle tests at
    TRACE_OPS operations each (f32)."""
    n = rays[0].shape[0]
    out_bytes = 16 if kernel in ("K5", "K7") else 1
    return _bound(n * (32 + out_bytes) + 4 * table.numel(), tested * TRACE_OPS[kernel])


def phase_trace(device, waves: dict):
    """Phase 3d: K5-K8 against their twins on the waves 4e's frames handed
    the tracer, on the tables gi built: tri, t, u, v bit-equal on every ray,
    the occlusion flags equal on every ray; K7 against K5; each kernel and
    twin timed with CUDA events."""
    import torch

    from gatling_tpu_torch.ops import trace as tt
    from gatling_tpu_torch.ops import trace_ref as trf
    from gatling_tpu_torch.ops.bounce import real_triangles

    results = {}
    for label, (recorded, tables, geom) in waves.items():
        tiles = tt.build_tri_tiles(geom, device)
        n_real = real_triangles(geom)
        for bounce, rays in recorded["closest"].items():
            live = int((rays[3] > rays[2]).sum())
            got5, got7 = tt.intersect_matrix(*rays, tables), tt.intersect_tiles(*rays, tiles)
            ref5 = trf.intersect_matrix_ref(*rays, tables.coeffs)
            ref7 = trf.intersect_tiles_ref(*rays, tiles.tris)
            torch.cuda.synchronize()
            bad, err = {}, {}
            for k, got, ref in (("K5", got5, ref5), ("K7", got7, ref7)):
                bad[k] = sum(int((g.view(torch.int32) != r.view(torch.int32)).sum())
                             for g, r in zip(got, ref))
                hit = ref[1] >= 0
                err[k] = max(float((g[hit] - r[hit]).abs().max()) if bool(hit.any()) else 0.0
                             for g, r in ((got[0], ref[0]), (got[2], ref[2]), (got[3], ref[3])))
            agree = float((got5.tri == got7.tri).float().mean())
            log(f"parity {label} bounce {bounce} closest ({rays[0].shape[0]} rays, {live} live, "
                f"{int((ref5[1] >= 0).sum())} hits): K5 {bad['K5']} and K7 {bad['K7']} values "
                f"not bit-equal to their twins; K7 takes K5's triangle on {agree:.6f}")
            assert bad["K5"] == 0 and bad["K7"] == 0 and agree >= 0.99
            for k, fn, twin, table in (
                    ("K5", lambda r=rays: tt.intersect_matrix(*r, tables),
                     lambda r=rays: trf.intersect_matrix_ref(*r, tables.coeffs), tables.coeffs),
                    ("K7", lambda r=rays: tt.intersect_tiles(*r, tiles),
                     lambda r=rays: trf.intersect_tiles_ref(*r, tiles.tris), tiles.tris)):
                results[(k, label, bounce)] = dict(
                    ms=event_ms(fn), plain_ms=event_ms(twin, reps=2), rays=rays[0].shape[0],
                    live=live, bound=trace_bound_ms(k, rays, table, live * n_real), err=err[k])
        for bounce, rays in recorded["occluded"].items():
            live = int((rays[3] > rays[2]).sum())
            got6, got8 = tt.occluded_matrix(*rays, tables), tt.occluded_tiles(*rays, tiles)
            first6 = trf.occluded_matrix_ref(*rays, tables.coeffs, first=True)
            first8 = trf.occluded_tiles_ref(*rays, tiles.tris, first=True)
            torch.cuda.synchronize()
            bad6, bad8 = int((got6 != (first6 >= 0)).sum()), int((got8 != (first8 >= 0)).sum())
            log(f"parity {label} bounce {bounce} shadow rays ({rays[0].shape[0]} rays, {live} "
                f"traced, {int(got6.sum())} occluded): K6 {bad6}, K8 {bad8} flags off their twins")
            assert bad6 == 0 and bad8 == 0
            err = {"K6": float((got6 != (first6 >= 0)).float().max()),
                   "K8": float((got8 != (first8 >= 0)).float().max())}
            for k, fn, twin, table, first in (
                    ("K6", lambda r=rays: tt.occluded_matrix(*r, tables),
                     lambda r=rays: trf.occluded_matrix_ref(*r, tables.coeffs), tables.coeffs,
                     first6),
                    ("K8", lambda r=rays: tt.occluded_tiles(*r, tiles),
                     lambda r=rays: trf.occluded_tiles_ref(*r, tiles.tris), tiles.tris, first8)):
                # the tests the data needs: up to the first occluder, else all
                alive = rays[3] > rays[2]
                tested = int(torch.where(first >= 0, first + 1, n_real)[alive].sum())
                results[(k, label, bounce)] = dict(
                    ms=event_ms(fn), plain_ms=event_ms(twin, reps=2), rays=rays[0].shape[0],
                    live=live, bound=trace_bound_ms(k, rays, table, tested), err=err[k])
    for (k, label, bounce), r in sorted(results.items()):
        log(f"timing {k} {label} bounce {bounce} ({r['rays']} rays, {r['live']} live): kernel "
            f"{r['ms']:.4f} ms, plain twin {r['plain_ms']:.3f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]})")
    return results


TRACE_ENTRIES = {
    "K5": ("intersect_matrix (K5, closest hit, coefficient form)",
           "gatling_tpu/ops/pallas_trace.py:196 intersect_pallas -> _closest_hit_kernel :105"),
    "K6": ("occluded_matrix (K6, shadow rays, coefficient form)",
           "gatling_tpu/ops/pallas_trace.py:235 occluded_pallas -> _occlusion_kernel :157"),
    "K7": ("intersect_tiles (K7, closest hit, elementwise)",
           "gatling_tpu/ops/pallas_trace.py:365 intersect_pallas_vpu -> "
           "_closest_hit_kernel_vpu :312"),
    "K8": ("occluded_tiles (K8, shadow rays, elementwise)",
           "gatling_tpu/ops/pallas_trace.py:401 occluded_pallas_vpu -> _occlusion_kernel_vpu :349"),
}


def trace_entry(kernel: str, times: dict, launches: int) -> dict:
    """The kernels-line entry of K5-K8: the headline numbers on the Cornell
    frame's bounce-0 wave, the other waves by case. K7 and K8 are on no
    path of either package (the JAX package's comparison point): their
    main-path launches are 0, and they run on the main path's waves."""
    name, replaces = TRACE_ENTRIES[kernel]
    head = times[(kernel, "cornell_aovs", 0)]
    cases = {f"{label}/bounce {b}": r for (k, label, b), r in sorted(times.items()) if k == kernel}
    return {
        "name": name, "route": "cuda", "source": "gatling_tpu_torch/csrc/trace.cu",
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["err"] for r in cases.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
        "bound_by": head["bound"][1], "library_ms": None,
        "on_main_path": kernel in ("K5", "K6"),
        "ms_by_case": {c: r["ms"] for c, r in cases.items()},
        "plain_ms_by_case": {c: r["plain_ms"] for c, r in cases.items()},
        "bound_ms_by_case": {c: r["bound"][0] for c, r in cases.items()},
    }


# ---------------------------------------------------------------------------
# 4f, 3e and P: glass, clearcoat, anisotropy and cutout; the probes
# ---------------------------------------------------------------------------

GLASS = os.path.join(HERE, "tests", "graphical", "Materials.GlassCoated", "scene.usda")
# the bench's glass_coated frame (bench.py:40-54, :365-369) and the Cornell one
LOBES_RES, LOBES_SPP, LOBES_BOUNCES = FULL_RES, 16, 8
OPEN_PBR = "ND_open_pbr_surface_surfaceshader"


def merged_settings(desc, **overrides) -> dict:
    """The defaults, a scene file's render settings and `overrides`, as the
    CLI merges them."""
    from gatling_tpu_torch.utils.config import default_settings

    s = default_settings()
    s["metersPerSceneUnit"] = desc.meters_per_unit
    s.update(desc.render_settings)
    s.update(overrides)
    return s


def desc_params(device, desc, res: int, settings: dict, every_aov: bool = False):
    """gi render parameters of a scene description on a new GiScene: COLOR,
    or every AOV."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.interface import AovId

    scene = gi.create_scene(device)
    for m in desc.meshes:
        scene.add_mesh(m)
    for m in desc.materials.values():
        scene.add_material(m)
    for light in desc.lights:
        scene.add_light(light)
    binds = (all_aov_bindings(res, res) if every_aov
             else [gi.GiAovBinding(AovId.COLOR, gi.GiRenderBuffer(res, res, 4))])
    return gi.GiRenderParams(scene=scene, camera=desc.first_camera(), aov_bindings=binds,
                             render_settings=settings)


def surface_variant(mat, shader_id: str | None = None, **inputs):
    """A copy of a material whose surface node takes `shader_id` (default:
    its own) and `inputs` over its own; its connections (textures) stay."""
    import copy

    out = copy.deepcopy(mat)
    node = out.nodes[out.surface_node]
    if shader_id is not None:
        node.shader_id = shader_id
    node.inputs.update(inputs)
    return out


def glass_coated_params(device, nee: bool):
    """glass_coated: Materials.GlassCoated at the bench's settings, 1200²,
    16 spp, 8 bounces (NEE off as bench.py sets it; on as the scene asks)."""
    from gatling_tpu_torch.scene.stage import load_scene

    desc = load_scene(GLASS)
    return desc_params(device, desc, LOBES_RES, merged_settings(
        desc, spp=LOBES_SPP, maxBounces=LOBES_BOUNCES, nextEventEstimation=nee))


def cornell_cutout_desc():
    """The Cornell box with the bench's rect light; the tall block's new
    white material has opacity 0.5 (stochastic cutout), the short block's
    opacity 0.3 under opacityThreshold 0.5 (a binary cutout: it vanishes)."""
    from gatling_tpu_torch.scene.stage import load_scene

    desc = load_scene(CORNELL)
    white = desc.materials["/Cornell/Materials/White"]
    for block, extra in (("TallBlock", dict(opacity=0.5)),
                         ("ShortBlock", dict(opacity=0.3, opacityThreshold=0.5))):
        path = f"/Cornell/Materials/{block}Cutout"
        desc.materials[path] = surface_variant(white, **extra)
        desc.materials[path].path = path
        next(m for m in desc.meshes if m.path.endswith("/" + block)).material = path
    desc.lights.append(bench_rect_light())
    return desc


def cornell_cutout_params(device, every_aov: bool = False):
    desc = cornell_cutout_desc()
    return desc_params(device, desc, LOBES_RES, merged_settings(
        desc, spp=LOBES_SPP, maxBounces=LOBES_BOUNCES, nextEventEstimation=True), every_aov)


def sphere_field_lobes_desc():
    """sphere_field with /mat0 an open_pbr thick glass, /mat1 a clearcoated
    UsdPreviewSurface and /mat2 a UsdPreviewSurface of opacity 0.5."""
    from gatling_tpu_torch.scene.examples import sphere_field

    desc = sphere_field()
    m = desc.materials
    m["/mat0"] = surface_variant(m["/mat0"], OPEN_PBR, transmission_weight=1.0,
                                 specular_ior=1.5, specular_roughness=0.0,
                                 base_color=(1.0, 1.0, 1.0))
    m["/mat1"] = surface_variant(m["/mat1"], clearcoat=1.0)
    m["/mat2"] = surface_variant(m["/mat2"], opacity=0.5)
    return desc


def sphere_field_lobes_params(device, desc, nee: bool):
    return desc_params(device, desc, SF_RES, merged_settings(
        desc, spp=SF_SPP, maxBounces=SF_BOUNCES, nextEventEstimation=nee))


def interior_lobes_params(device, tex_dir: str):
    """interior_lobes: the interior at its bench settings with the worktop
    an open_pbr surface (its marble texture as base colour, specular
    roughness anisotropy 0.6) and the instanced bowls at opacity 0.5 over
    their fabric texture."""
    from gatling_tpu_torch.scene.examples import interior

    desc = interior(tex_dir=tex_dir)
    m = desc.materials
    work = m["/m_worktop"]
    node = work.nodes[work.surface_node]
    tex = node.input_connections.pop("diffuseColor")
    m["/m_worktop"] = surface_variant(work, OPEN_PBR, specular_roughness=0.25,
                                      specular_roughness_anisotropy=0.6)
    m["/m_worktop"].nodes[work.surface_node].input_connections["base_color"] = tex
    m["/m_bowl"] = surface_variant(m["/m_bowl"], opacity=0.5)
    return desc_params(device, desc, SF_RES, merged_settings(
        desc, spp=SF_SPP, maxBounces=SF_BOUNCES, nextEventEstimation=True))


def first_and_warm(params, label, want: set, warm_frames: int = 1):
    """A first frame (scene build included) and warm frames of the same
    samples; the launches of the last must be those of `want` only.
    Returns (image, {first, warm seconds, Mray/s}, launches)."""
    from gatling_tpu_torch import gi

    _img, first, _mr, _l = counted_render(params, label + " (first frame)")
    warm, rates = [], []
    for i in range(warm_frames):
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        img, dt, mr, launches = counted_render(params, label + f" (warm {i + 1})")
        warm.append(dt)
        rates.append(mr)
    assert all(launches[k] > 0 for k in want), (label, launches)
    assert all(v == 0 for k, v in launches.items() if k not in want), (label, launches)
    return img, dict(first_s=first, warm_s=warm, mrays=rates), launches


def record_fused_waves(run, bounces=(0, 2)):
    """Run one frame (`run()`) with the fused path's kernel calls recorded:
    for the first sample batch, the params row and the state going into
    each bounce of `bounces`, and for the split bounce the hit and
    parameter buffers K4 was handed. Returns ({bounce: (params row, state,
    None or (hit buffer, parameter buffer))}, what run returned)."""
    from gatling_tpu_torch.render import fused

    calls = []
    real = {k: getattr(fused, k) for k in ("bounce_step", "shade_step")}

    def bounce(p, scene, state, nee):
        if len(calls) <= max(bounces):
            calls.append((p.clone(), state.clone(), None))
        return real["bounce_step"](p, scene, state, nee)

    def shade(p, scene, state, hitbuf, parbuf, active, nee):
        if len(calls) <= max(bounces):
            calls.append((p.clone(), state.clone(), (hitbuf.clone(), parbuf.clone())))
        return real["shade_step"](p, scene, state, hitbuf, parbuf, active, nee)

    fused.bounce_step, fused.shade_step = bounce, shade
    try:
        result = run()
    finally:
        fused.bounce_step, fused.shade_step = real["bounce_step"], real["shade_step"]
    return {b: calls[b] for b in bounces if b < len(calls)}, result


def gi_frame(params):
    """A function that renders one more frame of `params` through gi."""
    from gatling_tpu_torch import gi

    def run():
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        gi.render(params)
    return run


def flattened_frame(params):
    """(flattened tables, static, a function rendering the frame of
    `params` through them with render_pixels_fused) for a scene that
    gi.render rendered on instance tables."""
    import torch

    from gatling_tpu_torch.render.camera import camera_uniforms
    from gatling_tpu_torch.render.fused import render_pixels_fused
    from gatling_tpu_torch.render.integrator import RenderConfig, Uniforms

    fs, static, *_rest = split_tables(params, flattened=True)
    assert static.clustered and not static.instanced
    s, device = params.render_settings, params.scene.device
    res = params.aov_bindings[0].render_buffer.width
    cfg = RenderConfig(width=res, height=res, spp=s["spp"], max_bounces=s["maxBounces"],
                       nee=bool(s["nextEventEstimation"]))
    uni = Uniforms(camera=camera_uniforms(params.camera, False, device), sample_offset=0,
                   inv_total_sample_count=1.0 / s["spp"], max_sample_value=10.0,
                   rr_inv_min_term_prob=0.95, light_intensity_multiplier=1.0,
                   meters_per_scene_unit=1.0, max_volume_walk_length=7)
    pix = torch.arange(res * res, device=device)
    return fs, static, lambda: render_pixels_fused(cfg, uni, fs, pix, s["spp"], 0).cpu().numpy()


def cutout_pass_rate(params):
    """On cornell_cutout's first wave (1200² x 2 samples): the share of the
    camera rays whose first surface is the tall block (opacity 0.5) that
    pass it, and the camera rays that hit the short block (opacity 0.3
    under threshold 0.5), from the kernels' tables through the twin's
    search with and without the cutout draws."""
    import torch

    from gatling_tpu_torch.ops.bounce_ref import (P_TMIN, TR_MAT, closest_hit, cutout_key)

    scene = params.scene
    fs = scene._fused
    wave = wave_state(params.camera, LOBES_RES, LOBES_RES, 2, scene.device)
    o, d = (wave[0], wave[1], wave[2]), (wave[3], wave[4], wave[5])
    tmin = float(params_row(0, scene.device)[P_TMIN])
    _t, _u, _v, win = closest_hit(fs.tris, o, d, tmin)
    t_cut, _u, _v, win_cut = closest_hit(fs.tris, o, d, tmin, cutout_key(wave))
    mat = lambda w: torch.where(w >= 0, fs.tris[w.clamp(min=0), TR_MAT], -1.0)
    idx = scene._material_index
    tall = mat(win) == idx["/Cornell/Materials/TallBlockCutout"]
    passed = tall & (win_cut != win)
    short_hits = int((mat(win_cut) == idx["/Cornell/Materials/ShortBlockCutout"]).sum())
    short_before = int((mat(win) == idx["/Cornell/Materials/ShortBlockCutout"]).sum())
    rate = float(passed.sum()) / max(int(tall.sum()), 1)
    log(f"cornell_cutout first wave: {int(tall.sum())} camera rays meet the tall block first, "
        f"{rate:.5f} of them pass it (opacity 0.5); the short block (0.3 < threshold 0.5) "
        f"stops {short_hits} rays ({short_before} without cutout)")
    return rate, short_hits, short_before


def golden_glass_coated(device):
    """Materials.GlassCoated at its own settings (96², 48 spp, 6 bounces,
    NEE) through gi on the card, against its committed reference. The
    reference is a wavefront image (the JAX package's harness renders it on
    the CPU): the frame with an OBJECT_ID binding beside COLOR takes the
    port's wavefront and must pass the scene's gtl:errorPixelThreshold and
    gtl:flipThreshold. The COLOR frame alone takes the fused K1 with the
    advanced lobes, whose samples are drawn in another order: it is held to
    the FLIP threshold and its mean to 2 % of the reference's, and its
    error components are reported."""
    import numpy as np

    from gatling_tpu_torch import gi, imgio
    from gatling_tpu_torch.interface import AovId
    from gatling_tpu_torch.scene.stage import load_scene
    from gatling_tpu_torch.utils.flip import encode_srgb_u8, golden_errors

    desc = load_scene(GLASS)
    s = merged_settings(desc)
    ref = imgio.load_image_file(os.path.join(os.path.dirname(GLASS), "ref_color.png"))
    out = {}
    for route in ("wavefront", "fused"):
        params = desc_params(device, desc, 96, s)
        if route == "wavefront":
            params.aov_bindings.append(gi.GiAovBinding(
                AovId.OBJECT_ID, gi.GiRenderBuffer(96, 96, 1, True), clear_value=-1))
        gi.render(params)
        scene = params.scene
        assert (scene._fused is None) == (route == "wavefront"), route
        color = params.aov_bindings[0].render_buffer.data
        errors, flip = golden_errors(color, ref)
        rel = abs(encode_srgb_u8(color)[..., :3].mean() / ref[..., :3].mean() - 1.0)
        log(f"Materials.GlassCoated on the card, {route}: {errors} error components (threshold "
            f"{s['errorPixelThreshold']}), mean FLIP {flip:.4f} (threshold {s['flipThreshold']}), "
            f"mean encoded value {rel:.4f} off the reference's")
        assert np.isfinite(color).all() and flip <= float(s["flipThreshold"]), route
        if route == "wavefront":
            assert errors <= int(s["errorPixelThreshold"])
        else:
            assert scene._fused_static.advanced and rel < 0.02
        out[route] = dict(errors=errors, flip=flip, mean_rel=rel)
    return out


def phase_lobes(device, tex_dir: str):
    """Phase 4f: configurations 1-5 of the advanced lobes and cutout through
    gi.render, each a first and a warm frame with its launch counts and
    checks; the GlassCoated golden; the cutout pass rate. Returns (frame
    numbers, launches a frame, {case: (fused scene, static, recorded
    waves, nee)} for 3e)."""
    import numpy as np

    from gatling_tpu_torch.interface import AovId

    out, launches, replay = {}, {}, {}
    for nee in (False, True):
        label = f"glass_coated{'_nee' if nee else ''}"
        params = glass_coated_params(device, nee)
        img, out[label], lc = first_and_warm(
            params, f"{label} {LOBES_RES}^2 {LOBES_SPP}spp {LOBES_BOUNCES} bounces", {"K1"})
        st = params.scene._fused_static
        assert st.advanced and not st.cutout and not st.clustered and not st.textured
        img = img[..., :3]
        assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0.01, label
        launches[label] = lc["K1"]
        replay[label] = (params.scene._fused, st, record_fused_waves(gi_frame(params))[0], nee)
    out["glass_coated_golden"] = golden_glass_coated(device)

    params = cornell_cutout_params(device)
    img, out["cornell_cutout"], lc = first_and_warm(
        params, f"cornell_cutout {LOBES_RES}^2 {LOBES_SPP}spp {LOBES_BOUNCES} bounces nee",
        {"K1"})
    st = params.scene._fused_static
    assert st.cutout and not st.advanced and not st.clustered
    image_checks(img, "cornell_cutout")
    launches["cornell_cutout"] = lc["K1"]
    rate, short_hits, short_before = cutout_pass_rate(params)
    assert abs(rate - 0.5) <= 0.01 and short_hits == 0 and short_before > 0
    out["cornell_cutout_pass_rate"] = rate
    replay["cornell_cutout"] = (params.scene._fused, st, record_fused_waves(gi_frame(params))[0],
                                True)

    desc = sphere_field_lobes_desc()
    imgs = {}
    for nee in (False, True):
        label = f"sphere_field_lobes{'_nee' if nee else ''}"
        params = sphere_field_lobes_params(device, desc, nee)
        img, out[label], lc = first_and_warm(
            params, f"{label} {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces", {"K2"})
        st = params.scene._fused_static
        assert st.instanced and st.advanced and st.cutout and not st.textured
        imgs[nee] = img[..., :3]
        assert np.isfinite(imgs[nee]).all() and (imgs[nee] >= 0).all(), label
        launches[label] = lc["K2"]
        replay[label] = (params.scene._fused, st, record_fused_waves(gi_frame(params))[0], nee)
    # the NEE frame through the flattened tables: other triangle ids, so
    # other cutout draws; the means agree
    flat, fstat, run = flattened_frame(params)
    waves, flat_img = record_fused_waves(run)
    replay["sphere_field_lobes_nee_flattened"] = (flat, fstat, waves, True)
    assert imgs[True].mean() > imgs[False].mean() * 1.02, "NEE must add light"
    rel = abs(flat_img.mean() - imgs[True].mean()) / imgs[True].mean()
    log(f"sphere_field_lobes instanced vs flattened (NEE): mean rel diff {rel:.3e}")
    assert np.isfinite(flat_img).all() and rel < 0.01, rel
    out["sphere_field_lobes_flattened_rel"] = rel

    params = interior_lobes_params(device, tex_dir)
    img, out["interior_lobes"], lc = first_and_warm(
        params, f"interior_lobes {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces nee", {"K3", "K4"})
    st = params.scene._fused_static
    assert st.instanced and st.textured and st.advanced and st.cutout and st.tangents
    img = img[..., :3]
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0.01
    launches["interior_lobes"] = {k: lc[k] for k in ("K3", "K4")}
    replay["interior_lobes"] = (params.scene._fused, st, record_fused_waves(gi_frame(params))[0],
                                True)

    # the wavefront: K5 traces the camera rays and, hop by hop, the shadow
    # rays through the cutout (render/integrator.py _trace_occluded_cutout,
    # as the JAX wavefront does), so K6 is not launched
    params = cornell_cutout_params(device, every_aov=True)
    aovs, out["cornell_cutout_aovs"], lc = first_and_warm(
        params, f"cornell_cutout_aovs {LOBES_RES}^2 {LOBES_SPP}spp {LOBES_BOUNCES} bounces nee, "
        "every AOV", {"K5"})
    assert params.scene._accel is not None and params.scene._fused is None
    full = {b.aov_id: b.render_buffer.data.copy() for b in params.aov_bindings}
    image_checks(full[AovId.COLOR], "cornell_cutout_aovs")
    check_aovs(full, params, "cornell_cutout_aovs")
    launches["cornell_cutout_aovs"] = {"K5": lc["K5"]}
    return out, launches, replay


def bounce_twin(p, fs, state, nee):
    """The twin of bounce_step on fused tables fs (resident or walk)."""
    from gatling_tpu_torch.ops.bounce_ref import bounce_ref

    bounce_ref(p, fs.tris, fs.mats, fs.lights, tuple(fs.light_types.tolist()), state, nee,
               fs.walk, fs.advanced, fs.cutout)


def check_parity(label, got, twin, errs):
    """compare() with the branches' criteria: rows 12-15 bit-equal and rows
    0-11 within rtol/atol, each on at least MIN_AGREE of the rays."""
    bad_bits, outside, n, err = compare(got, twin)
    log(f"parity {label}: {bad_bits} rays with rows 12-15 not bit-equal, {outside} of {n} "
        f"rays outside rtol {RTOL}/atol {ATOL} on rows 0-11, max abs err {err:.3g}")
    assert bad_bits <= n * (1 - MIN_AGREE) and outside <= n * (1 - MIN_AGREE), (label, bad_bits,
                                                                                 outside)
    errs.append(err)


def check_draws(label, wave, fs):
    """The kernels' cutout draws (ops/bounce.py cutout_draws) against the
    twin's cutout_xi, bit for bit, for every ray of a wave: its camera key
    against each of 64 triangle ids spread over the table, and its
    shadow key against the same ids."""
    import torch

    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.bounce_ref import SHADOW_SALT, cutout_key, cutout_xi

    key = cutout_key(wave)
    n_ids = fs.tris.shape[0]
    ids = torch.linspace(0, n_ids - 1, 64, device=wave.device).long()
    bad = 0
    for k in (key, key ^ SHADOW_SALT):
        kk = k[:, None].expand(-1, ids.numel()).reshape(-1)
        ii = ids[None, :].expand(k.numel(), -1).reshape(-1)
        i32 = lambda x: (x - ((x >> 31) << 32)).to(torch.int32)  # uint32 bits as int32
        got = tb.cutout_draws(i32(kk).contiguous(), i32(ii).contiguous())
        bad += int((got.view(torch.int32) != cutout_xi(kk, ii).view(torch.int32)).sum())
    log(f"cutout draws {label}: {bad} of {2 * key.numel() * ids.numel()} not bit-equal")
    assert bad == 0, label


def phase_branches(device, replay: dict):
    """Phase 3e: each branch's kernel against its twin on 4f's recorded
    waves (bounces 0 and 2) and the tables gi built; each timed at bounce
    0 with CUDA events. Returns {case: numbers}."""
    import torch

    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.bounce_ref import P_TMIN, cutout_key, walk_closest, \
        walk_hit_attrs, walk_work
    from gatling_tpu_torch.ops.split_ref import H_T, par_row_starts, shade_ref, trace_ref

    out = {}
    for label, (fs, static, waves, nee) in replay.items():
        errs, k3_errs = [], []
        if fs.cutout:
            check_draws(label, waves[0][1], fs)
        for b, (p, state, split) in sorted(waves.items()):
            if split is None:
                twin = state.clone()
                bounce_twin(p, fs, twin, nee)
                got = state.clone()
                tb.bounce_step(p, fs, got, nee)
                torch.cuda.synchronize()
                check_parity(f"{label} bounce {b}", got, twin, errs)
                continue
            hit_n, parbuf = split
            active = static.textured_params
            hit = trace_ref(p, fs.tris, state, fs.walk, fs.cutout)
            got_hit = tb.trace_step(p, fs, state)
            twin = state.clone()
            shade_ref(p, fs.tris, fs.mats, fs.lights, static.light_types, twin, hit_n, parbuf,
                      par_row_starts(active), nee, fs.walk, fs.advanced, fs.cutout)
            got = state.clone()
            tb.shade_step(p, fs, got, hit_n, parbuf, active, nee)
            torch.cuda.synchronize()
            hb, ho, n, herr = compare_hits(got_hit, hit)
            log(f"parity {label} bounce {b} K3: {hb} rays with H_HIT/H_MAT not bit-equal, {ho} "
                f"of {n} outside rtol {RTOL}/atol {ATOL}, max abs err {herr:.3g} (hit rays)")
            assert hb <= n * (1 - MIN_AGREE) and ho <= n * (1 - MIN_AGREE), (label, b, hb, ho)
            k3_errs.append(herr)
            check_parity(f"{label} bounce {b} K4", got, twin, errs)

        # bounce 0 timed: the kernel(s), the twin(s), the bound
        p, wave, split = waves[0]
        alive = wave[13] > 0.5
        r = dict(rays=wave.shape[1], alive=int(alive.sum()), err=max(errs),
                 k3_err=max(k3_errs) if k3_errs else None)
        if split is None:
            r["ms"] = time_ms(lambda s: tb.bounce_step(p, fs, s, nee), wave)
            r["plain_ms"] = time_ms(lambda s: bounce_twin(p, fs, s, nee), wave, reps=1)
            if fs.walk is None:
                r["bound"] = k1_bound_ms(wave, fs)
            else:
                o, d = wave[0:3].T.contiguous(), wave[3:6].T.contiguous()
                tmin = float(p[P_TMIN])
                key = cutout_key(wave) if fs.cutout else None
                win = walk_closest(fs.walk, fs.tris, o, d, alive, tmin, key)
                t_hit = walk_hit_attrs(fs.walk, fs.tris, o, d, win)[0]
                r["work"] = walk_work(fs.walk, o, d, alive, tmin, t_hit)
                r["bound"] = k2_bound_ms(wave, fs, r["work"])
        else:
            hit_n, parbuf = split
            active = static.textured_params
            prow = par_row_starts(active)
            hit = tb.trace_step(p, fs, wave)
            o, d = wave[0:3].T.contiguous(), wave[3:6].T.contiguous()
            r["work"] = (walk_work(fs.walk, o, d, alive, float(p[P_TMIN]), hit[H_T])
                         if fs.walk is not None else None)
            r["k3_ms"] = time_ms(lambda s: tb.trace_step(p, fs, s), wave)
            r["k3_plain_ms"] = time_ms(lambda s: trace_ref(p, fs.tris, s, fs.walk, fs.cutout),
                                       wave, reps=1)
            r["k3_bound"] = k3_bound_ms(wave, fs, hit.shape[0], r["work"])
            r["ms"] = time_ms(lambda s: tb.shade_step(p, fs, s, hit_n, parbuf, active, nee), wave)
            r["plain_ms"] = time_ms(lambda s: shade_ref(
                p, fs.tris, fs.mats, fs.lights, static.light_types, s, hit_n, parbuf, prow, nee,
                fs.walk, fs.advanced, fs.cutout), wave, reps=1)
            r["bound"] = k4_bound_ms(wave, fs, 3 * len(active))
        out[label] = r
        log(f"timing {label} bounce 0 ({r['rays']} rays, {r['alive']} alive): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()
            if k not in ("rays", "alive")))
    return out


def phase_probes(device):
    """Phase P: the probes P1 and P2 through their entry points (launches
    counted over that run), held against their twins; each timed with CUDA
    events beside its twin and the library call. Returns their numbers."""
    import torch

    from gatling_tpu_torch import tools
    from gatling_tpu_torch.tools import cast_probe, precision_probe

    for k in tools.launches:
        tools.launches[k] = 0
    cast = cast_probe.run(device)
    prec = precision_probe.run(device)
    launches = dict(tools.launches)
    log(f"probes: launches {launches}")
    assert all(ok for ok, _deg in cast.values()), cast
    assert prec["DEFAULT (TF32)"][2] and prec["HIGHEST (FP32)"][2] and prec["3xTF32"][2], prec

    # launches below compare and time; they do not count
    x = cast_probe.probe_input(device)
    moves = range(len(cast_probe.MOVES))
    p1 = dict(
        ms=event_ms(lambda: [cast_probe.cast_move(x, m) for m in moves]),
        plain_ms=event_ms(lambda: [cast_probe.cast_twin(x, m) for m in moves]),
        # bytes: the tile read and each move's output written once
        bound=_bound(sum(4 * (x.numel() + math.prod(shape)) for _n, shape in cast_probe.MOVES),
                     0),
        err=max(float((cast_probe.cast_move(x, m) - cast_probe.cast_twin(x, m)).abs().max())
                for m in moves),
        conflicts={n: deg for n, (_ok, deg) in cast.items()})
    p1["library_ms"] = p1["plain_ms"]  # the twin is the torch calls themselves
    oh, xm = precision_probe.probe_inputs(device)
    n = precision_probe.N
    flops = 2 * n ** 3
    nbytes = 3 * 4 * n * n
    p2 = {}
    for name, mode in precision_probe.MODES:
        peak = F32_FLOPS if mode == 1 else TF32_FLOPS
        t_ops = (3 if mode == 2 else 1) * flops / peak
        got = precision_probe.onehot_product(oh, xm, mode)
        p2[name] = dict(
            ms=event_ms(lambda m=mode: precision_probe.onehot_product(oh, xm, m)),
            plain_ms=event_ms(lambda m=mode: precision_probe.product_twin(oh, xm, m)),
            bound=(max(nbytes / HBM_BPS, t_ops) * 1e3,
                   "bytes" if nbytes / HBM_BPS >= t_ops else "operations"),
            err=float((got - precision_probe.product_twin(oh, xm, mode)).abs().max()),
            err_vs_x=prec[name][0])
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for allow in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = allow
            p2[f"library_tf32={allow}"] = event_ms(lambda: torch.matmul(oh, xm))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    log(f"timing P1 (six moves) {p1}; P2 {p2}")
    return launches, p1, p2


BRANCHES = (  # kernels-line entries of the branches: (name, 3e case, replaces)
    ("bounce_step (K1, advanced lobes)", "glass_coated",
     "gatling_tpu/ops/pallas_bounce.py:3192 bounce_step -> _bounce_kernel :2162, advanced "
     "branch of _shade_core :2381 (:2453-2762) and _resolve_material_rows :2190"),
    ("bounce_step (K1, cutout)", "cornell_cutout",
     "gatling_tpu/ops/pallas_bounce.py:3192 bounce_step -> _bounce_kernel :2162, cutout "
     "branch: _cutout_xi :1445, _cutout_xi8 :1459, resident searches :2874-2900"),
    ("bounce_step_walk (K2, advanced lobes + cutout)", "sphere_field_lobes",
     "gatling_tpu/ops/pallas_bounce.py:3192 bounce_step, clustered+instanced branch: "
     "_trace_clustered_matrix :1513 (cutout :1570, :1657-1668), _trace_clustered_occluded "
     ":2002 (:2058, :2127-2138), advanced _shade_core :2381"),
    ("trace_step (K3, cutout)", "interior_lobes",
     "gatling_tpu/ops/pallas_bounce.py:3663 trace_step -> _trace_kernel :3241, cutout "
     ":3276-3311"),
    ("shade_step (K4, advanced lobes)", "interior_lobes",
     "gatling_tpu/ops/pallas_bounce.py:3705 shade_step -> _shade_kernel :3370, advanced "
     "_shade_core :2381 in the mesh-tangent frame (:2453-2473)"),
)


def branch_entries(branch: dict, lobe_launches: dict) -> list[dict]:
    """The kernels-line entries of the branches from 3e's numbers (bounce 0
    of the case's first recorded wave); launches per frame of 4f."""
    out = []
    for name, case, replaces in BRANCHES:
        r = branch[case]
        k3 = name.startswith("trace_step")
        n = lobe_launches[case]
        if isinstance(n, dict):
            n = n["K3" if k3 else "K4"]
        ms, plain, bound = (("k3_ms", "k3_plain_ms", "k3_bound") if k3
                            else ("ms", "plain_ms", "bound"))
        entry = {"name": name, "route": "cuda", "source": "gatling_tpu_torch/csrc/bounce.cu",
                 "replaces": replaces, "launches": n,
                 "max_abs_err": max(v["k3_err" if k3 else "err"] for k, v in branch.items()
                                    if k.startswith(case)),
                 "ms": r[ms], "plain_ms": r[plain], "bound_ms": r[bound][0],
                 "bound_by": r[bound][1], "library_ms": None, "rays": r["rays"],
                 "alive": r["alive"]}
        others = {k: v for k, v in branch.items() if k.startswith(case) and k != case}
        if others:
            entry["ms_by_case"] = {k: v[ms] for k, v in others.items()}
            entry["plain_ms_by_case"] = {k: v[plain] for k, v in others.items()}
            entry["bound_ms_by_case"] = {k: v[bound][0] for k, v in others.items()}
        out.append(entry)
    return out


def probe_entries(launches: dict, p1: dict, p2: dict) -> list[dict]:
    """The kernels-line entries of P1 (the six moves together) and P2 (the
    TF32 product; FP32 and 3xTF32 beside it)."""
    tf32 = p2["DEFAULT (TF32)"]
    return [{
        "name": "cast_probe (P1, six layout moves of an (8, 128) f32 tile)",
        "route": "cuda", "source": "gatling_tpu_torch/csrc/probes.cu",
        "replaces": "tools/mosaic_cast_probe.py:12 probe", "launches": launches["P1"],
        "max_abs_err": p1["err"], "ms": p1["ms"], "plain_ms": p1["plain_ms"],
        "bound_ms": p1["bound"][0], "bound_by": p1["bound"][1], "library_ms": p1["library_ms"],
        "bank_conflicts": p1["conflicts"],
    }, {
        "name": "onehot_product (P2, one-hot 128x128 product, TF32 mma.sync)",
        "route": "cuda", "source": "gatling_tpu_torch/csrc/probes.cu",
        "replaces": "tools/mosaic_precision_probe.py:20 kern", "launches": launches["P2"],
        "max_abs_err": max(v["err"] for k, v in p2.items() if isinstance(v, dict)),
        "ms": tf32["ms"], "plain_ms": tf32["plain_ms"], "bound_ms": tf32["bound"][0],
        "bound_by": tf32["bound"][1], "library_ms": p2["library_tf32=True"],
        "library_ms_fp32": p2["library_tf32=False"],
        "by_mode": {k: dict(ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
                            bound_by=v["bound"][1], err_vs_x=v["err_vs_x"])
                    for k, v in p2.items() if isinstance(v, dict)},
    }]


# the __global__ functions of csrc/, the longest first (one name ends another)
KERNEL_NAMES = ("shade_walk_kernel", "trace_walk_kernel", "cutout_draws_kernel",
                "onehot_fp32_kernel", "onehot_tf32_kernel", "cast_probe_kernel", "occluded_kernel",
                "closest_kernel", "bounce_kernel", "shade_kernel", "trace_kernel", "walk_kernel")


def ptxas_summary(report: str) -> list[str]:
    """One line per compiled kernel of nvcc's -Xptxas -v report: its name
    with the template flags (1/0) and its registers, stack frame and spill
    bytes."""
    import re

    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\w*?(" + "|".join(KERNEL_NAMES)
                      + r")(I(?:Lb[01]E)+E)?", line)
        if m:
            flags = re.findall(r"Lb([01])E", m.group(2) or "")
            name = m.group(1) + (f"<{','.join(flags)}>" if flags else "")
            stack = spill = regs = None
        elif name and "stack frame" in line:
            stack, spill = re.findall(r"(\d+) bytes (?:stack frame|spill stores)", line)[:2]
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {stack} B stack frame, {spill} B spill "
                       "stores")
            name = None
    return out


def main() -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(HERE, "gatling_tpu_torch", "csrc", "bounce.cu")):
        print("chip_smoke: run from the root of a checkout (gatling_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")

    # 2. build
    from torch.utils.cpp_extension import is_ninja_available

    from concurrent.futures import ThreadPoolExecutor

    from gatling_tpu_torch import tools
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops import trace as tt

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # every nvcc run at once (bounce.cu in parts)
        builds = [pool.submit(mod.kernel) for mod in (tb, tt, tools)]
        libs = [b.result() for b in builds]
    log(f"built {', '.join(k.path.name for k in libs)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {', '.join(f'{k.build_seconds:.1f}' for k in libs)} s; ninja available: "
        f"{is_ninja_available()}, not needed: nvcc is called directly)")
    for k in libs:
        for line in ptxas_summary(k.ptxas_log):
            log(f"ptxas {k.path.name}: {line}")

    # 3. K1 against its twin; 3b. K2 against its twin
    t0 = time.perf_counter()
    max_err, times = phase_kernel(device)
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sf = sphere_field_setup(device)
    walk_err, walk_times, sorted_ms = phase_walk(device, sf)
    log(f"phase 3b: {time.perf_counter() - t0:.1f} s")

    # 4-5. main path; each kernel's launches are counted over one frame of
    # its path through gi.render: K1 the Cornell frame, K2 sphere_field's,
    # K3 and K4 the interior's
    t0 = time.perf_counter()
    rates, k1_launches = phase_renders(device)
    log(f"phases 4 and 5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sf_rates, k2_launches = phase_sphere_field(device, sf)
    rates.update(sf_rates)
    log(f"phases 4b and 4c: {time.perf_counter() - t0:.1f} s")
    tex_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tex_")
    extra = write_textures(tex_tmp.name)
    t0 = time.perf_counter()
    tex_rates, split_launches, scenes = phase_interior(device, tex_tmp.name, extra)
    rates.update(tex_rates)
    log(f"phase 4d: {time.perf_counter() - t0:.1f} s")

    # 3c. K3 and K4 against their twins on the tables gi built for 4d
    t0 = time.perf_counter()
    k3_err, k4_err, split_times = phase_split(device, scenes)
    log(f"phase 3c: {time.perf_counter() - t0:.1f} s")

    # 4e. the wavefront integrator (every AOV) through gi.render: K5, K6;
    # 3d. K5-K8 against their twins on the waves of 4e's frames
    t0 = time.perf_counter()
    wave_times, wavefront_launches, waves = phase_wavefront(device, tex_tmp.name)
    log(f"phase 4e: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trace_times = phase_trace(device, waves)
    del waves
    log(f"phase 3d: {time.perf_counter() - t0:.1f} s")

    # 4f. glass, clearcoat, anisotropy and cutout through gi.render; 3e. the
    # branches against their twins on 4f's waves; P. the probes
    t0 = time.perf_counter()
    lobe_frames, lobe_launches, replay = phase_lobes(device, tex_tmp.name)
    tex_tmp.cleanup()
    log(f"phase 4f: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    branch = phase_branches(device, replay)
    del replay
    log(f"phase 3e: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    probe_launches, p1, p2 = phase_probes(device)
    log(f"phase P: {time.perf_counter() - t0:.1f} s")
    launches = {"K1": k1_launches, "K2": k2_launches, **split_launches, **wavefront_launches}
    log(f"main path: kernel launches per frame {launches}; Mray/s {rates}; wavefront frame "
        f"seconds {wave_times}; advanced lobes and cutout: launches {lobe_launches}, frames "
        f"{lobe_frames}")

    k2 = walk_times[("instanced", "generated", False)]
    it, ct = split_times["interior"], split_times["cornell_textured"]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "bounce_step (K1, resident)",
        "route": "cuda",
        "source": "gatling_tpu_torch/csrc/bounce.cu",
        "replaces": "gatling_tpu/ops/pallas_bounce.py:3192 (resident branch)",
        "launches": launches["K1"],
        "max_abs_err": max_err,
        "ms": times[False][0],
        "plain_ms": times[False][1],
        "bound_ms": times[False][2][0],
        "bound_by": times[False][2][1],
        "library_ms": None,
        "ms_nee": times[True][0],
        "plain_ms_nee": times[True][1],
    }, {
        "name": "bounce_step_walk (K2, clustered + instanced)",
        "route": "cuda",
        "source": "gatling_tpu_torch/csrc/bounce.cu",
        "replaces": "gatling_tpu/ops/pallas_bounce.py:3192 (clustered+instanced branch: "
                    "_trace_clustered_matrix :1513, _trace_clustered_occluded :2002)",
        "launches": launches["K2"],
        "max_abs_err": walk_err,
        "ms": k2[0],
        "plain_ms": k2[1],
        "bound_ms": k2[2][0],
        "bound_by": k2[2][1],
        "library_ms": None,
        "ms_by_case": {f"{t}/{o}/nee={n}": v[0] for (t, o, n), v in walk_times.items()},
        "plain_ms_by_case": {f"{t}/{o}/nee={n}": v[1] for (t, o, n), v in walk_times.items()},
        "bounces_1_5_ms_unsorted_sorted_sort": {f"{t}/nee={n}": v
                                                for (t, n), v in sorted_ms.items()},
    }, {
        "name": "trace_step (K3, split trace)",
        "route": "cuda",
        "source": "gatling_tpu_torch/csrc/bounce.cu",
        "replaces": "gatling_tpu/ops/pallas_bounce.py:3663 trace_step -> _trace_kernel :3241 "
                    "(+ _finalize_hits :3504)",
        "launches": launches["K3"],
        "max_abs_err": k3_err,
        "ms": it["k3"],
        "plain_ms": it["k3_twin"],
        "bound_ms": it["k3_bound"][0],
        "bound_by": it["k3_bound"][1],
        "library_ms": None,
        "ms_cornell_textured": ct["k3"],
        "plain_ms_cornell_textured": ct["k3_twin"],
        "bound_ms_cornell_textured": ct["k3_bound"][0],
        "ms_bounce2_coherence_order": split_times["interior_bounce2"]["k3"],
        "ms_bounce2_unsorted": split_times["interior_bounce2"]["k3_unsorted"],
        "bound_ms_bounce2": split_times["interior_bounce2"]["k3_bound"][0],
        "texture_stage_ms": it["stage"],
        "texture_stage_ms_cornell_textured": ct["stage"],
    }, {
        "name": "shade_step (K4, split shade)",
        "route": "cuda",
        "source": "gatling_tpu_torch/csrc/bounce.cu",
        "replaces": "gatling_tpu/ops/pallas_bounce.py:3705 shade_step -> _shade_kernel :3370",
        "launches": launches["K4"],
        "max_abs_err": k4_err,
        "ms": it["k4"],
        "plain_ms": it["k4_twin"],
        "bound_ms": it["k4_bound"][0],
        "bound_by": it["k4_bound"][1],
        "library_ms": None,
        "ms_nee_off": it["k4_nee_off"],
        "ms_cornell_textured": ct["k4"],
        "plain_ms_cornell_textured": ct["k4_twin"],
        "bound_ms_cornell_textured": ct["k4_bound"][0],
    }, *(trace_entry(k, trace_times, launches[k]) for k in ("K5", "K6", "K7", "K8")),
        *branch_entries(branch, lobe_launches), *probe_entries(probe_launches, p1, p2)]}))
    # the run drives one card (cuda:0), whatever the host holds
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
