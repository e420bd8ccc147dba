"""Kernel and frame times of several checkouts of this repository, in turns
on one card.

    python gatling_tpu_torch/tools/plain_ab.py PARENT CHANGE CHANGE PARENT
    python gatling_tpu_torch/tools/plain_ab.py --only walk,frames PARENT CHANGE ...
    python gatling_tpu_torch/tools/plain_ab.py --only threaded PARENT CHANGE CHANGE PARENT
    python gatling_tpu_torch/tools/plain_ab.py --only taps PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout (for example a `git archive` of a
commit unpacked into a git-ignored directory); each runs in its own
process, which imports that checkout's package and builds its kernels.
The measuring code is the same for every checkout: this file and the
chip_smoke.py of the checkout it belongs to, whose helpers call only entry
points every checkout since the media slice has (gi.render, bounce_step,
trace_step, intersect_matrix, occluded_matrix, onehot_product). Run the
file by its path, not with -m.

Measured, with CUDA events on fresh copies of each wave (chip_smoke.py
time_ms / event_ms), at bounce 0 unless named, in groups (`--only`
picks some; all by default):
* resident: K1 on the Cornell box's first wave (1200x1200 x 2 samples, NEE off and
  on) and on glass_coated's (NEE off and on), each at bounces 0, 2 and 4
  (the twin steps the wave, as chip_smoke.py phase 3 does), and on
  cornell_cutout's and cornell_fog's first waves (NEE, gi's tables after
  one frame);
* resident: K3 on the textured Cornell box's wave (resident tables);
* wavefront: K5 and K7 on the closest-hit waves of cornell_aovs and
  interior_aovs (bounces 0 and 2 of the first sample, recorded from a
  frame) and on the shadow-hop waves of cornell_cutout_aovs (bounces 0 and
  2), K6 and K8 on the NEE shadow waves of cornell_aovs and interior_aovs
  (bounces 0 and 2); K7 and K8 also on chip_smoke.py streamed_wave's
  (8192 triangles of interior(detail=2): a camera wave, its shadow rays);
* probes: P2 in each mode and torch.matmul (TF32 allowed and not) on the probe's
  input, and P1's six moves (one launch, or a launch a move where the
  checkout's cast_probe has no cast_moves): the device time a call, one
  call with its host enqueue, and the enqueue alone (chip_smoke.py
  launch_times);
* walk: K2 on sphere_field's wave (512x512 x 4 samples, instanced and
  flattened, NEE off and on) at bounce 0 and at bounce 2 (the twin steps
  the wave; then in the coherence order render_pixels_fused gives it),
  and K3 and K4 (NEE on) on the textured interior's wave (gi's instanced
  tables) at bounces 0 and 2 likewise; warm frames of sphere_field,
  sphere_field_nee and the textured interior (NEE);
* frames: warm frames through gi.render (host clock to the image's
  copy): glass_coated (NEE off and on), cornell, cornell_nee; with the
  wavefront group also cornell_aovs, cornell_cutout_aovs and
  interior_aovs;
* k4: the split shade as the main path runs it between K3 and the next
  bounce: a checkout whose K4 takes the texture stage's parameter buffer
  (`shade_step(..., parbuf, ...)`) is timed as the stage
  (render/fused.py material_rows) and K4 together, and each alone; one
  whose K4 taps the textures itself as K4 alone. On the waves a frame
  hands K3 (recorded by wrapping render/fused.py trace_step; bounce 0 and
  2, NEE on unless named): the textured interior (gi's instanced tables;
  also NEE off, and with a 2048x2048 sRGB texture written from a seed on
  every base colour, whose taps read from HBM), its normal-mapped
  variant, interior_lobes (K4's advanced branch), interior_tinted (the
  absorption branch) and the textured Cornell box (resident, NEE off);
  warm frames of interior_nee_textured, _normalmapped, _lod2,
  cornell_textured, interior_lobes, interior_tinted and sphere_field
  (NEE off and on);
* threaded: B1 and B2, the wavefront's tracer above 8192 triangles, on
  the closest-hit and NEE shadow waves gi.render hands them (recorded
  from a frame): interior_aovs (the interior at full detail, every AOV,
  512x512, 4 spp, 6 bounces, NEE) at bounces 0 and 2, sphere_field_aovs
  at bounce 0, and interior_aovs_small's waves (interior(detail=1), which
  K5/K6 trace) over a threaded BVH of its soup, beside K5 and K6 on the
  same rays; ten warm frames each of interior_aovs and sphere_field_aovs,
  then one more under torch.profiler: the device time of its B1/B2
  launches and of all its kernels and copies, and its idle share;
* taps: the bounce-0 peel's K4t and the textured-cutout re-trace (K4r
  and the hit-buffer merge a round) on the waves gi.render hands them,
  and the warm and profiled frames of cornell_first_hit,
  interior_first_hit and interior_cutout (time_taps; a checkout with
  retrace_round and scene/examples.py interior_cutout);
* the ptxas registers, stack and spills of every kernel instance.
"""

import importlib.util
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _chip_smoke():
    """The chip_smoke.py beside this file, as a module (its helpers import
    gatling_tpu_torch when called: the checkout's on sys.path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


GROUPS = ("resident", "wavefront", "probes", "walk", "frames", "k4", "threaded", "taps")


def time_tree(tree: str, groups=GROUPS) -> None:
    """Print the kernel and frame times of one checkout."""
    from concurrent.futures import ThreadPoolExecutor

    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops import trace as tt
    from gatling_tpu_torch.scene import examples as ex
    from gatling_tpu_torch.scene.stage import load_scene
    from gatling_tpu_torch.tools import precision_probe as pp

    cs = _chip_smoke()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    mods = ((tt,) if set(groups) <= {"wavefront", "probes", "threaded"}
            else (tb, tt))  # what the groups run
    with ThreadPoolExecutor(2) as pool:
        libs = [f.result() for f in [pool.submit(m.kernel) for m in mods]]
    print(f"{tree}: built in {time.perf_counter() - t0:.1f} s", flush=True)
    p0 = cs.params_row(0, device)
    out = {}

    def k1(label, fs, wave, nee, p=p0):
        out[f"K1 {label}"] = cs.time_ms(lambda s: tb.bounce_step(p, fs, s, nee), wave, reps=15)

    def k1_bounces(label, fs, wave, nee):
        """K1 at bounces 0, 2 and 4 of a wave the twin steps (phase 3's states)."""
        state = wave
        for b in range(5):
            p = cs.params_row(b, device)
            if b in (0, 2, 4):
                k1(f"{label} bounce {b}", fs, state, nee, p)
            twin = state.clone()
            cs.bounce_twin(p, fs, twin, nee)
            state = twin

    tmp = tempfile.TemporaryDirectory(prefix="plain_ab_")
    res, spp, bnc = cs.LOBES_RES, cs.LOBES_SPP, cs.LOBES_BOUNCES
    if "resident" in groups:
        for nee, extra in ((False, ()), (True, (cs.bench_rect_light(),))):
            fs, cam = cs.scene_tables(cs.CORNELL, extra, device)
            k1_bounces(f"cornell nee={nee}", fs,
                       cs.wave_state(cam, cs.FULL_RES, cs.FULL_RES, 2, device), nee)
        gfs, gcam = cs.scene_tables(cs.GLASS, (), device)
        gwave = cs.wave_state(gcam, cs.FULL_RES, cs.FULL_RES, 2, device)
        for nee in (False, True):
            k1_bounces(f"glass_coated nee={nee}", gfs, gwave, nee)
        for label, params in (
                ("cornell_cutout nee=True", cs.cornell_cutout_params(device)),
                ("cornell_fog nee=True", cs.media_params(
                    device, load_scene(ex.cornell_fog(tmp.name)), res, spp, bnc, 1))):
            cs.counted_render(params, label)
            k1(label, params.scene._fused, cs.wave_state(params.camera, res, res, 2, device), True)

        checker = cs.write_textures(tmp.name)["checker"]
        cparams = cs.cornell_params(device, dict(spp=16, maxBounces=8))
        cs.texture_every_material(cparams.scene.materials, "diffuseColor", checker)
        cs.counted_render(cparams, "cornell_textured")
        cwave = cs.wave_state(cparams.camera, cs.FULL_RES, cs.FULL_RES, 2, device)
        out["K3 cornell_textured"] = cs.time_ms(
            lambda s: tb.trace_step(p0, cparams.scene._fused, s), cwave, reps=15)

    frames, waves = {}, {}
    if "walk" in groups:
        time_walk(cs, device, tmp.name, out, frames)
    if "k4" in groups:
        time_k4(cs, device, tmp.name, out, frames)
    if "threaded" in groups:
        time_threaded(cs, device, tmp.name, out, frames)
    if "taps" in groups:
        time_taps(cs, device, tmp.name, out, frames)
    settings = dict(spp=16, maxBounces=8)
    wavefront = "wavefront" in groups
    cases = []
    if "frames" in groups:
        cases += [
            ("glass_coated nee=False", lambda: cs.glass_coated_params(device, False), 3),
            ("glass_coated nee=True", lambda: cs.glass_coated_params(device, True), 3),
            ("cornell", lambda: cs.cornell_params(device, settings), 3),
            ("cornell_nee", lambda: cs.cornell_params(
                device, dict(settings, nextEventEstimation=True), [cs.bench_rect_light()]), 3)]
    if wavefront:
        cases += [("cornell_aovs", lambda: cs.cornell_aovs_params(device), 1),
                  ("cornell_cutout_aovs",
                   lambda: cs.cornell_cutout_params(device, every_aov=True), 1)]
    for label, make, n in cases:
        params = make()
        cs.counted_render(params, label + " (first frame)")
        for i in range(n):
            params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
            frames[f"{label} warm {i + 1}"] = cs.counted_render(params, label)[1]
        if label == "cornell_aovs":
            waves["cornell_aovs"] = (cs.record_waves(params), params.scene)
        if label == "cornell_cutout_aovs":
            waves["cornell_cutout_aovs hops"] = ({"closest": cs.record_hop_waves(params)},
                                                 params.scene)
    if wavefront:
        iparams = cs.interior_aovs_params(device, tmp.name)
        cs.counted_render(iparams, "interior_aovs (first frame)")
        for i in range(3):
            iparams.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
            frames[f"interior_aovs warm {i + 1}"] = cs.counted_render(iparams, "interior_aovs")[1]
        waves["interior_aovs"] = (cs.record_waves(iparams), iparams.scene)
        tiles, rays, shadow = cs.streamed_wave(device, tmp.name)
        label = f"interior{tiles.n_tris}"
        out[f"K7 {label} 0"] = cs.event_ms(lambda: tt.intersect_tiles(*rays, tiles), reps=15)
        out[f"K8 {label} 0"] = cs.event_ms(lambda: tt.occluded_tiles(*shadow, tiles), reps=15)
    for label, (recorded, scene) in waves.items():
        tables, tiles = scene._accel.tables, tt.build_tri_tiles(scene._geom, device)
        kernels = {
            "closest": (("K5", tt.intersect_matrix, tables), ("K7", tt.intersect_tiles, tiles)),
            "occluded": (("K6", tt.occluded_matrix, tables), ("K8", tt.occluded_tiles, tiles))}
        for kind, runs in kernels.items():
            for b, rays in sorted(recorded.get(kind, {}).items(), key=lambda kv: str(kv[0])):
                for key, fn, table in runs:
                    out[f"{key} {label} {b}"] = cs.event_ms(
                        lambda r=rays, f=fn, t=table: f(*r, t), reps=15)
    oh, x = pp.probe_inputs(device)
    calls = {f"P2 {name}": (lambda m=mode: pp.onehot_product(oh, x, m))
             for name, mode in pp.MODES}
    calls["torch.matmul"] = lambda: torch.matmul(oh, x)
    from gatling_tpu_torch.tools import cast_probe as cp

    tile = cp.probe_input(device)
    if hasattr(cp, "cast_moves"):  # one launch, a block a move
        calls["P1 six moves"] = lambda: cp.cast_moves(tile)
    else:  # a launch a move
        calls["P1 six moves"] = lambda: [cp.cast_move(tile, m) for m in range(len(cp.MOVES))]
    if "probes" not in groups:
        calls = {}
    for label, fn in calls.items():
        for allow in ((True, False) if label == "torch.matmul" else (False,)):
            torch.backends.cuda.matmul.allow_tf32 = allow
            name = label + (f" allow_tf32={allow}" if label == "torch.matmul" else "")
            # the parent's P1 makes six launches a call: 100 calls stay in the queue
            t = cs.launch_times(fn, 100 if label.startswith("P1") else 200)
            out[f"{name} device a launch"] = t["ms"]
            out[f"{name} one call with its enqueue"] = t["ms_one_call_with_enqueue"]
            out[f"{name} enqueue alone"] = t["enqueue_us"] / 1e3
    torch.backends.cuda.matmul.allow_tf32 = False

    for lib in libs:
        for line in cs.ptxas_summary(lib.ptxas_log):
            print(f"{tree}: ptxas {lib.path.name}: {line}")
    for k, v in out.items():
        print(f"{tree}: {k}: {v:.6f} ms", flush=True)
    for k, v in frames.items():
        print(f"{tree}: frame {k}: {v:.4f} s", flush=True)
    tmp.cleanup()


def time_walk(cs, device, tmp: str, out: dict, frames: dict) -> None:
    """The walk group: K2 on sphere_field's waves, K3 and K4 on the
    textured interior's, at bounces 0 and 2, and their warm frames."""
    import inspect

    import torch

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.split_ref import material_rows, par_row_starts, shade_ref, trace_ref
    from gatling_tpu_torch.render.fused import coherence_keys

    def coherent(state, fs):  # render_pixels_fused's order after a bounce
        box = fs.walk.l1
        lo = box[:, 0:3].min(dim=0).values
        inv = 1.0 / torch.clamp(box[:, 3:6].max(dim=0).values - lo, min=1e-12)
        return state[:, torch.argsort(coherence_keys(state, lo, inv), stable=True)]

    sf = cs.sphere_field_setup(device)
    desc, _m, _t, inst, flat = sf
    wave = cs.wave_state(desc.first_camera(), cs.SF_RES, cs.SF_RES, cs.SF_SPP, device, tiled=True)
    for label, fs in (("instanced", inst), ("flattened", flat)):
        for nee in (False, True):
            state = wave
            for b in range(3):
                p = cs.params_row(b, device)
                if b in (0, 2):
                    out[f"K2 {label} nee={nee} bounce {b}"] = cs.time_ms(
                        lambda s: tb.bounce_step(p, fs, s, nee), state, reps=15)
                state = state.clone()
                cs.bounce_twin(p, fs, state, nee)
                state = coherent(state, fs)
    for nee in (False, True):
        params = cs.sphere_field_params(device, sf, nee)
        cs.counted_render(params, f"sphere_field nee={nee} (first frame)")
        for i in range(3):
            params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
            frames[f"sphere_field nee={nee} warm {i + 1}"] = cs.counted_render(
                params, f"sphere_field nee={nee}")[1]

    params = cs.interior_params(device, tmp)
    cs.counted_render(params, "interior_nee_textured (first frame)")
    for i in range(3):
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        frames[f"interior_nee_textured warm {i + 1}"] = cs.counted_render(
            params, "interior_nee_textured")[1]
    fs, static, mats, pool, active = cs.split_tables(params)
    prow = par_row_starts(active)
    stage_first = "parbuf" in inspect.signature(tb.shade_step).parameters
    state = cs.wave_state(params.camera, cs.SF_RES, cs.SF_RES, cs.SF_SPP, device, tiled=True)
    for b in range(3):
        p = cs.params_row(b, device)
        hit = trace_ref(p, fs.tris, state, fs.walk)
        parbuf, hit_n = material_rows(mats, pool, hit, active)
        if b in (0, 2):
            out[f"K3 interior bounce {b}"] = cs.time_ms(lambda s: tb.trace_step(p, fs, s), state,
                                                        reps=15)
            # K4 alone: on the stage's buffers where it takes them
            k4_args = (hit_n, parbuf) if stage_first else (hit, mats, pool)
            out[f"K4 interior nee=True bounce {b}"] = cs.time_ms(
                lambda s: tb.shade_step(p, fs, s, *k4_args, active, True), state, reps=15)
        state = state.clone()
        shade_ref(p, fs.tris, fs.mats, fs.lights, static.light_types, state, hit_n, parbuf, prow,
                  True, fs.walk)
        state = coherent(state, fs)


def profiled_frame(params, label: str, patterns=("threaded_",), name: str = "B1/B2") -> None:
    """One more warm frame of `params` under torch.profiler: prints its
    wall time, the device time of its `name` launches (kernels whose names
    hold one of `patterns`: by default B1/B2, threaded_*, the parent's and
    this tree's), of all its kernels and copies and their count, the
    union of those (busy), and its idle share (1 - busy / wall)."""
    import torch

    from gatling_tpu_torch import gi

    params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        gi.render(params)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    span = [(e.time_range.start, e.time_range.end) for e in dev]
    mine = [b - a for (a, b), e in zip(span, dev) if any(p in e.name for p in patterns)]
    busy, end = 0.0, float("-inf")
    for a, b in sorted(span):
        if b > end:
            busy += b - max(a, end)
            end = b
    print(f"{os.getcwd()}: profiled frame {label}: wall {wall:.3f} ms, {name} "
          f"{sum(mine) / 1e3:.4f} ms in {len(mine)} launches, every kernel and copy "
          f"{sum(b - a for a, b in span) / 1e3:.3f} ms in {len(span)}, busy {busy / 1e3:.3f} ms, "
          f"idle share {1 - busy / 1e3 / wall:.4f}", flush=True)


def time_threaded(cs, device, tmp: str, out: dict, frames: dict) -> None:
    """The threaded group: B1 and B2 on interior_aovs' waves at bounces 0
    and 2 and sphere_field_aovs' at bounce 0, with ten warm frames of each
    and a profiled one; B1/B2 beside K5/K6 on interior_aovs_small's
    waves."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.ops import bvh as bvhm
    from gatling_tpu_torch.ops import trace as tt
    from gatling_tpu_torch.scene.examples import sphere_field

    runs = {"closest": (("B1", tt.intersect_threaded), ("K5", tt.intersect_matrix)),
            "occluded": (("B2", tt.occluded_threaded), ("K6", tt.occluded_matrix))}
    settings = dict(spp=cs.SF_SPP, maxBounces=cs.SF_BOUNCES, nextEventEstimation=True)
    for label, make, bounces in (
            ("interior_aovs", lambda: cs.interior_aovs_params(device, tmp, detail=5), (0, 2)),
            ("sphere_field_aovs", lambda: cs.desc_params(device, sphere_field(), cs.SF_RES,
                                                         settings, every_aov=True), (0,))):
        params = make()
        cs.counted_render(params, label + " (first frame)")
        for i in range(10):
            params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
            frames[f"{label} warm {i + 1}"] = cs.counted_render(params, label)[1]
        profiled_frame(params, label)
        recorded, bvh = cs.record_waves(params, bounces), params.scene._accel.bvh
        for kind, ((key, fn), _k) in runs.items():
            for b, rays in sorted(recorded[kind].items()):
                out[f"{key} {label} {b}"] = cs.event_ms(lambda r=rays, f=fn: f(*r, bvh), reps=15)
    params = cs.interior_aovs_params(device, tmp)
    cs.counted_render(params, "interior_aovs_small (first frame)")
    recorded, tables, geom = cs.record_waves(params), params.scene._accel.tables, params.scene._geom
    arrays, order = bvhm.build_bvh(geom.v0, geom.e1, geom.e2)
    bvh = bvhm.threaded_bvh(arrays, bvhm.reorder_geometry(geom, order), device)
    for kind, ((key, fn), (other, ofn)) in runs.items():
        for b, rays in sorted(recorded[kind].items()):
            out[f"{key} interior_aovs_small {b}"] = cs.event_ms(lambda r=rays, f=fn: f(*r, bvh),
                                                                reps=15)
            out[f"{other} interior_aovs_small {b}"] = cs.event_ms(
                lambda r=rays, f=ofn: f(*r, tables), reps=15)


def time_taps(cs, device, tmp: str, out: dict, frames: dict) -> None:
    """The taps group: the bounce-0 peel's K4t and the textured-cutout
    re-trace's rounds (K4r), as the main path runs them. Frames:
    cornell_first_hit (the Cornell box, the bench's rect light, 1200x1200,
    16 spp, 8 bounces, NEE, the first-hit AOVs), interior_first_hit
    (512x512, 4 spp, 6 bounces, NEE) and interior_cutout (NEE off;
    scene/examples.py), five warm frames each and one more profiled
    (profiled_frame: device time, its kernels and copies, K4t's or K4r's,
    idle share). Then, on the waves of one more frame of each: K4t as the
    peel calls it, the device time a launch (device_ms) and one call with
    its enqueue (event_ms); on interior_cutout's first wave, each round
    without its K3 (K4r and the hit-buffer merge) and the whole re-trace
    of a split bounce (three rounds with K3), device time a call."""
    import torch

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.render import fused
    from gatling_tpu_torch.scene.examples import interior, interior_cutout
    from gatling_tpu_torch.scene.stage import load_scene

    cornell = load_scene(cs.CORNELL)
    cases = (
        ("cornell_first_hit", lambda: cs.fh_params(
            device, cornell, cs.AOVS_RES, cs.merged_settings(
                cornell, spp=cs.AOVS_SPP, maxBounces=cs.AOVS_BOUNCES, nextEventEstimation=True),
            lights=(cs.bench_rect_light(),))),
        ("interior_first_hit", lambda: cs.fh_params(
            device, interior(tex_dir=tmp), cs.SF_RES, dict(
                spp=cs.SF_SPP, maxBounces=cs.SF_BOUNCES, nextEventEstimation=True))),
        ("interior_cutout", lambda: cs.desc_params(
            device, interior_cutout(tex_dir=tmp), cs.SF_RES, dict(
                spp=cs.SF_SPP, maxBounces=cs.SF_BOUNCES, nextEventEstimation=False))))
    for label, make in cases:
        params = make()
        cs.counted_render(params, label + " (first frame)")
        for i in range(5):
            params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
            frames[f"{label} warm {i + 1}"] = cs.counted_render(params, label)[1]
        profiled_frame(params, label, ("tap_kernel", "retrace_kernel"), "K4t/K4r")
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        with cs.KernelCalls(7, ("trace_step", "tap_rows", "retrace_round")) as calls:
            gi.render(params)
        if label != "interior_cutout":
            args = calls.of("tap_rows")[0]
            out[f"K4t {label} device"] = cs.device_ms(lambda: tb.tap_rows(*args))
            out[f"K4t {label} with enqueue"] = cs.event_ms(lambda: tb.tap_rows(*args), reps=15)
            continue
        p0, fs, state = calls.of("trace_step")[0]
        for rnd, (_st, _mk, hit, mats, pool, active, _r) in enumerate(calls.of("retrace_round")):
            st, mk = state.clone(), state.clone()

            def round_ops(hit=hit, rnd=rnd):
                tb.retrace_round(st, mk, hit, mats, pool, active, rnd)
                return torch.where(mk[13] > 0.5, hit, hit)

            out[f"round {rnd} without K3, device"] = cs.device_ms(round_ops, launches=10)
            out[f"round {rnd} without K3, with enqueue"] = cs.event_ms(round_ops, reps=15)
        hit0 = tb.trace_step(p0, fs, state)
        st = state.clone()
        out["re-trace of a split bounce (3 rounds with K3), device"] = cs.device_ms(
            lambda: fused.textured_cutout_retrace(p0, fs, st, hit0, mats, pool, active),
            launches=5)
        out["re-trace of a split bounce (3 rounds with K3), with enqueue"] = cs.event_ms(
            lambda: fused.textured_cutout_retrace(p0, fs, st, hit0, mats, pool, active), reps=15)


def big_texture_interior(cs, device, tmp: str, size: int = 2048):
    """The textured interior with every base colour one size x size sRGB
    RGBA texture of noise from a seed: a pool of 64 MB of 2x2 rows at 2048,
    which no cache holds, so each tap reads device memory."""
    import numpy as np

    from gatling_tpu_torch import imgio
    from gatling_tpu_torch.scene.examples import interior

    path = os.path.join(tmp, f"noise{size}.png")
    img = np.random.default_rng(5).integers(0, 256, (size, size, 4), dtype=np.uint8)
    img[..., 3] = 255
    imgio.write_image_file(path, img)
    desc = interior(tex_dir=tmp)
    for m in desc.materials.values():
        for node in m.nodes.values():
            if node.shader_id == "UsdUVTexture":
                node.inputs.update(file=path, sourceColorSpace="sRGB")
    return cs.desc_params(device, desc, cs.SF_RES, dict(spp=cs.SF_SPP, maxBounces=cs.SF_BOUNCES,
                                                        nextEventEstimation=True))


def time_k4(cs, device, tmp: str, out: dict, frames: dict) -> None:
    """The k4 group: the split shade between K3 and the next bounce, as the
    checkout's main path runs it (the texture stage and K4, or K4 alone),
    on the waves a frame hands K3, and the warm frames of the textured
    scenes and of sphere_field."""
    import inspect

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.render import fused
    from gatling_tpu_torch.scene import examples as ex

    stage_first = "parbuf" in inspect.signature(tb.shade_step).parameters
    print(f"K4 {'after the texture stage' if stage_first else 'with its own taps'}", flush=True)

    def record(params):
        """{bounce: (params row, tables, state)} going into K3 at bounces 0
        and 2 of the first sample batch of one more frame."""
        calls, real = [], fused.trace_step

        def trace(p, scene, state):
            if len(calls) < 3:
                calls.append((p.clone(), scene, state.clone()))
            return real(p, scene, state)

        fused.trace_step = trace
        try:
            params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
            gi.render(params)
        finally:
            fused.trace_step = real
        return {b: calls[b] for b in (0, 2) if b < len(calls)}

    def case(label, params, nees=(True,), bounces=(0, 2), warm=3):
        cs.counted_render(params, label + " (first frame)")
        for i in range(warm):
            params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
            frames[f"{label} warm {i + 1}"] = cs.counted_render(params, label)[1]
        scene = params.scene
        mats, pool = scene._material_dev, scene._texture_pool
        active = scene._fused_static.textured_params
        for b, (p, fs, state) in (record(params) if bounces else {}).items():
            if b not in bounces:
                continue
            hit = tb.trace_step(p, fs, state)
            for nee in nees:
                name = f"{label} nee={nee} bounce {b}"
                if stage_first:
                    parbuf, hit_n = fused.material_rows(mats, pool, hit, active)
                    out[f"stage {name}"] = cs.time_ms(
                        lambda h: fused.material_rows(mats, pool, h, active), hit, reps=15)
                    out[f"K4 alone {name}"] = cs.time_ms(
                        lambda s: tb.shade_step(p, fs, s, hit_n, parbuf, active, nee), state,
                        reps=15)

                    def split(s, p=p, fs=fs, nee=nee):
                        par, hn = fused.material_rows(mats, pool, hit, active)
                        tb.shade_step(p, fs, s, hn, par, active, nee)
                else:
                    def split(s, p=p, fs=fs, nee=nee):
                        tb.shade_step(p, fs, s, hit, mats, pool, active, nee)
                out[f"stage+K4 {name}"] = cs.time_ms(split, state, reps=15)

    extra = cs.write_textures(tmp)
    case("interior_nee_textured", cs.interior_params(device, tmp), nees=(True, False))
    case("interior_normalmapped", cs.interior_params(device, tmp, normal_map=extra["lean"]))
    lparams = cs.interior_params(device, tmp, textureLodBounces=2)
    case("interior_lod2", lparams, bounces=())
    case("interior_lobes", cs.interior_lobes_params(device, tmp), bounces=(0,))
    case("interior_tinted", cs.media_params(device, ex.interior_tinted(tex_dir=tmp), cs.SF_RES,
                                            cs.SF_SPP, cs.SF_BOUNCES, 0), bounces=(0,))
    cparams = cs.cornell_params(device, dict(spp=16, maxBounces=8))
    cs.texture_every_material(cparams.scene.materials, "diffuseColor", extra["checker"])
    case("cornell_textured", cparams, nees=(False,), bounces=(0,))
    case("interior_noise2048", big_texture_interior(cs, device, tmp), bounces=(0,), warm=1)
    sf = cs.sphere_field_setup(device)
    for nee in (False, True):
        case(f"sphere_field nee={nee}", cs.sphere_field_params(device, sf, nee), bounces=())


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        time_tree(os.path.abspath(argv[1]), tuple(argv[2].split(",")) if len(argv) > 2
                  else GROUPS)
        return 0
    groups = []
    if len(argv) >= 2 and argv[0] == "--only":
        groups, argv = [argv[1]], argv[2:]
    if not argv:
        raise SystemExit(__doc__)
    rc = 0
    for tree in argv:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree,
                              *groups], timeout=900).returncode
    return rc


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
