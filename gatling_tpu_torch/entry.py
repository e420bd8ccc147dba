"""Driver entry points of the port (the root __graft_entry__.py's, for
gatling_tpu_torch): `entry()`, one render step on the card, and
`dryrun_multidevice(n)`, one step over an n-device mesh.

    python -c "from gatling_tpu_torch import entry; entry.dryrun_multidevice(4)"

Both render the Cornell box of tests/data/cornell.usda, on CUDA unless
`device="cpu"` is passed.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

CORNELL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "tests", "data", "cornell.usda")


def _cornell_tables():
    """The Cornell box's scene description, soup and material table."""
    from gatling_tpu_torch.ops.geometry import build_geometry
    from gatling_tpu_torch.render.material import build_material_table, lower_material
    from gatling_tpu_torch.scene.stage import load_scene

    desc = load_scene(CORNELL)
    mat_paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(mat_paths)}
    midx[None] = len(mat_paths)
    rows = [lower_material(desc.materials.get(p) if p else None) for p in midx]
    return desc, build_geometry(desc.meshes, midx), build_material_table(rows)


def _build_cornell_state(width: int, height: int, spp: int, max_bounces: int, device):
    """The Cornell box's wavefront tables on `device`: (config, uniforms,
    packed geometry, material table, light tables, AOVs, texture pool,
    accel), K5/K6's trace tables the tracer."""
    from gatling_tpu_torch.interface import AovId, aov_bit
    from gatling_tpu_torch.ops.geometry import pack_geometry
    from gatling_tpu_torch.ops.trace import build_trace_tables
    from gatling_tpu_torch.render.camera import camera_uniforms
    from gatling_tpu_torch.render.integrator import Accel, RenderConfig, Uniforms
    from gatling_tpu_torch.render.lights import build_light_arrays, light_tensors
    from gatling_tpu_torch.render.texture import empty_pool

    desc, geom, table = _cornell_tables()
    config = RenderConfig(width=width, height=height, spp=spp, max_bounces=max_bounces, nee=True,
                          aov_mask=aov_bit(AovId.COLOR) | aov_bit(AovId.NORMAL)
                          | aov_bit(AovId.ALBEDO), tracer="matrix")
    uniforms = Uniforms(camera=camera_uniforms(desc.first_camera(), False, device),
                        sample_offset=0, inv_total_sample_count=1.0 / spp, max_sample_value=10.0,
                        rr_inv_min_term_prob=0.95, light_intensity_multiplier=1.0,
                        meters_per_scene_unit=1.0, max_volume_walk_length=7)
    n = width * height
    aovs = {k: torch.zeros((n, c), dtype=torch.float32, device=device)
            for k, c in (("color", 4), ("normal", 3), ("albedo", 3))}
    return (config, uniforms, pack_geometry(geom, device), table.to(device),
            light_tensors(build_light_arrays([]), device), aovs, empty_pool(device),
            Accel(tables=build_trace_tables(geom, device)))


def entry(device: str = "cuda"):
    """(fn, args): one render step of the Cornell box, 64x64, 1 spp, 3
    bounces, NEE, COLOR, NORMAL and ALBEDO through the wavefront integrator
    (trace on K5/K6, shade, accumulate); fn(*args) returns the AOVs."""
    from gatling_tpu_torch.render.integrator import render_frame

    config, *args = _build_cornell_state(64, 64, 1, 3, torch.device(device))

    def fn(uniforms, geom, materials, lights, aovs, textures, accel):
        return render_frame(config, uniforms, geom, materials, lights, aovs, textures, accel)

    return fn, tuple(args)


def _mesh_devices(n: int, device: str) -> list[torch.device]:
    """n device slots: the cards present in turn (cuda:0 again and again
    on a one-card host), or the CPU n times."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("dryrun_multidevice: no CUDA device; pass device='cpu'")
    return [torch.device("cuda", i % count) for i in range(n)]


def dryrun_multidevice(n_devices: int, device: str = "cuda") -> None:
    """One render step over an n-device mesh (parallel/sharding.py): the
    wavefront's render_frame_sharded, tiles x 2 sample shards when n is
    even, then the fused route's render_fused_sharded on a 2x2 sub-mesh
    (n x 1 below 4 devices); each checked finite and lit."""
    from gatling_tpu_torch.interface import AovId, aov_bit
    from gatling_tpu_torch.ops.bounce import build_fused_scene
    from gatling_tpu_torch.parallel.sharding import (
        make_mesh,
        render_frame_sharded,
        render_fused_sharded,
    )
    from gatling_tpu_torch.render.lights import build_light_arrays

    slots = _mesh_devices(n_devices, device)
    home = slots[0]
    n_spp = 2 if n_devices % 2 == 0 else 1
    n_tiles = n_devices // n_spp
    height = 8 * n_tiles
    config, uniforms, geom, table, lights, aovs, pool, accel = _build_cornell_state(
        16, height, 2 * n_spp, 2, home)
    out = render_frame_sharded(config, uniforms, geom, table, lights, aovs, pool, accel,
                               make_mesh(n_tiles, n_spp, slots))
    color = out["color"].cpu().numpy()
    assert color.shape == (16 * height, 4)
    assert np.isfinite(color).all(), "multi-device render produced non-finite values"
    assert color[:, :3].max() > 0.0, "multi-device render produced an empty image"

    n_fused = min(4, n_devices)
    n_spp = 2 if n_fused % 2 == 0 else 1
    config, uniforms, *_ = _build_cornell_state(32, 32, 2 * n_spp, 2, home)
    config = dataclasses.replace(config, aov_mask=aov_bit(AovId.COLOR), nee=False,
                                 rr_bounce_offset=100)
    _desc, geom, table = _cornell_tables()
    scene, static = build_fused_scene(geom, table, build_light_arrays([]), home)
    color, segs = render_fused_sharded(config, uniforms, scene, static, None,
                                       make_mesh(n_fused // n_spp, n_spp, slots[:n_fused]))
    color = color.cpu().numpy()
    assert color.shape == (32 * 32, 3)
    assert np.isfinite(color).all(), "fused multi-device render non-finite"
    assert color.max() > 0.0, "fused multi-device render produced an empty image"
    assert float(segs.min()) >= 1.0
