"""Plain-scene kernel times of several checkouts of this repository, in turns
on one card: K1 on the Cornell box's first wave (1200x1200 x 2 samples, NEE
off and on) and K2 on sphere_field's (512x512 x 4 samples, instanced and
flattened, NEE off and on), timed as chip_smoke.py phases 3 and 3b time
them (CUDA events, fresh copies of the wave); where the checkout has them,
also K2 on sphere_field_lobes' instanced tables and K1 on glass_coated's
wave, and the ptxas registers, stack and spills of every kernel instance
of bounce.cu.

    python gatling_tpu_torch/tools/plain_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout (for example a `git archive` of a
commit unpacked into a git-ignored directory); each runs in its own
process, which imports that checkout's chip_smoke.py and builds its
kernels. Run the file by its path, not with -m, so that the package each
process imports is its checkout's.
"""

import os
import subprocess
import sys


def time_tree(tree: str) -> None:
    """Print the kernel times of one checkout (imports its chip_smoke.py)."""
    import time

    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    import torch

    from gatling_tpu_torch.ops import bounce as tb

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    tb.kernel()
    print(f"{tree}: built in {time.perf_counter() - t0:.1f} s", flush=True)
    p0 = cs.params_row(0, device)
    out = {}
    for nee, extra in ((False, ()), (True, (cs.bench_rect_light(),))):
        fs, cam = cs.scene_tables(cs.CORNELL, extra, device)
        wave = cs.wave_state(cam, cs.FULL_RES, cs.FULL_RES, 2, device)
        out[f"K1 cornell nee={nee}"] = cs.time_ms(lambda s: tb.bounce_step(p0, fs, s, nee), wave,
                                                  reps=15)
    desc, _m, _t, inst, flat = cs.sphere_field_setup(device)
    wave = cs.wave_state(desc.first_camera(), cs.SF_RES, cs.SF_RES, cs.SF_SPP, device, tiled=True)
    for label, fs in (("instanced", inst), ("flattened", flat)):
        for nee in (False, True):
            out[f"K2 {label} nee={nee}"] = cs.time_ms(lambda s: tb.bounce_step(p0, fs, s, nee),
                                                      wave, reps=15)
    if hasattr(cs, "sphere_field_lobes_desc"):
        from gatling_tpu_torch.render.lights import build_light_arrays
        from gatling_tpu_torch.render.material import build_material_table, lower_material

        d2 = cs.sphere_field_lobes_desc()
        paths = sorted({m.material for m in d2.meshes if m.material})
        midx = {p: i for i, p in enumerate(paths)}
        midx[None] = len(paths)
        table = build_material_table([lower_material(d2.materials.get(p) if p else None)
                                      for p in midx])
        fs, _st = tb.build_fused_scene_instanced(d2.meshes, midx, table,
                                                 build_light_arrays(d2.lights), device)
        for nee in (False, True):
            out[f"K2 lobes instanced nee={nee}"] = cs.time_ms(
                lambda s: tb.bounce_step(p0, fs, s, nee), wave, reps=15)
        gfs, gcam = cs.scene_tables(cs.GLASS, (), device)
        gwave = cs.wave_state(gcam, cs.FULL_RES, cs.FULL_RES, 2, device)
        out["K1 glass_coated adv"] = cs.time_ms(lambda s: tb.bounce_step(p0, gfs, s, False),
                                                gwave, reps=15)
    if hasattr(cs, "ptxas_summary"):
        for line in cs.ptxas_summary(tb.kernel().ptxas_log):
            print(f"{tree}: ptxas {line}")
    for k, v in out.items():
        print(f"{tree}: {k}: {v:.4f} ms", flush=True)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        time_tree(os.path.abspath(argv[1]))
        return 0
    if not argv:
        raise SystemExit(__doc__)
    rc = 0
    for tree in argv:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             timeout=600).returncode
    return rc


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
