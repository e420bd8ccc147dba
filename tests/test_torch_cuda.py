"""On the card: the CUDA kernels (K1 resident, K2 the two-level walk, K3
and K4 the split trace and shade) against their plain twins.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine that has only torch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a CUDA device every test here skips. Rows 12-15 of the ray state
must be bit-equal; rows 0-11 agree to rtol 1e-4 / atol 1e-5 on at least
99.9 % of rays (the kernel and the twin round cos/sin through different
code paths of the same math library).
"""

import numpy as np
import pytest
import torch

from gatling_tpu_torch.ops import bounce as tb
from gatling_tpu_torch.ops import sampling as smp
from gatling_tpu_torch.ops.geometry import build_geometry
from gatling_tpu_torch.render.camera import camera_uniforms, generate_primary_rays
from gatling_tpu_torch.render.lights import build_light_arrays
from gatling_tpu_torch.render.material import build_material_table, lower_material
from gatling_tpu_torch.scene.stage import LightDesc, load_scene

RTOL, ATOL, MIN_AGREE = 1e-4, 1e-5, 0.999


def _rect_light() -> LightDesc:
    xf = np.eye(4)
    xf[3, :3] = [0.0, 0.0, 0.9]
    return LightDesc(
        path="/neelight", light_type="rect", transform=xf,
        params=dict(intensity=4.0, exposure=0.0, color=np.array([1.0, 0.9, 0.8], np.float32),
                    normalize=False, diffuse=1.0, specular=1.0,
                    enableColorTemperature=False, colorTemperature=6500.0,
                    width=0.8, height=0.6))


CASES = {
    "cornell": ("tests/data/cornell.usda", False, False),
    "cornell_nee": ("tests/data/cornell.usda", True, True),
    "analytic_nee": ("tests/graphical/Lights.Analytic/scene.usda", False, True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the bounce kernel runs only on the GPU")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("label", sorted(CASES))
def test_kernel_matches_twin(cuda, label):
    path, rect, nee = CASES[label]
    desc = load_scene(path)
    mat_paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(mat_paths)}
    midx[None] = len(mat_paths)
    rows = [lower_material(desc.materials.get(p) if p else None) for p in midx]
    lights = [l for l in desc.lights if l.light_type != "dome"] + ([_rect_light()] if rect else [])
    fs, static = tb.build_fused_scene(build_geometry(desc.meshes, midx),
                                      build_material_table(rows), build_light_arrays(lights), cuda)
    w, h = 128, 64
    cam = camera_uniforms(desc.first_camera(), False, cuda)
    pix = torch.arange(w * h, device=cuda)
    o, d, rng = generate_primary_rays(cam, w, h, pix % w, pix // w, smp.rng_init(pix, 1),
                                      True, True, False)
    state = tb.pack_state(o, d, rng, w * h)
    params = np.zeros((5, 11), np.float32)
    params[:, 3], params[:, 4], params[:, 5] = 0.95, 3, np.arange(5)
    params[:, 6] = params[:, 8] = params[:, 9] = 1.0
    for bounce in range(5):
        p = torch.tensor(params[bounce], device=cuda)
        twin = state.clone()
        tb.bounce_ref(p, fs.tris, fs.mats, fs.lights, static.light_types, twin, nee)
        kern = state.clone()
        before = tb.launches["K1"]
        tb.bounce_step(p, fs, kern, nee)
        torch.cuda.synchronize()
        assert tb.launches["K1"] == before + 1
        k, t = kern.cpu().numpy(), twin.cpu().numpy()
        np.testing.assert_array_equal(k[12:].view(np.int32), t[12:].view(np.int32))
        close = np.isclose(k[:12], t[:12], rtol=RTOL, atol=ATOL).all(axis=0)
        assert close.mean() >= MIN_AGREE, (label, bounce, int((~close).sum()))
        state = twin


def _sphere_field_tables(device, instanced: bool, nee: bool):
    from gatling_tpu_torch.scene.examples import sphere_field

    desc = sphere_field(n_side=6, sphere_res=12)
    mat_paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(mat_paths)}
    midx[None] = len(mat_paths)
    table = build_material_table([lower_material(desc.materials.get(p) if p else None)
                                  for p in midx])
    lights = build_light_arrays(desc.lights) if nee else None
    if instanced:
        fs, static = tb.build_fused_scene_instanced(desc.meshes, midx, table, lights, device)
    else:
        fs, static = tb.build_fused_scene(build_geometry(desc.meshes, midx), table, lights,
                                          device)
    return fs, static, desc.first_camera()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("instanced", [False, True])
@pytest.mark.parametrize("nee", [False, True])
def test_walk_kernel_matches_twin(cuda, instanced, nee):
    """K2 on a sphere_field of 36 spheres (10,372 triangles): instanced or
    flattened tables, bounces 0-4."""
    fs, static, cam_desc = _sphere_field_tables(cuda, instanced, nee)
    assert static.clustered and static.instanced == instanced
    w, h = 128, 64
    cam = camera_uniforms(cam_desc, False, cuda)
    pix = torch.arange(w * h, device=cuda)
    o, d, rng = generate_primary_rays(cam, w, h, pix % w, pix // w, smp.rng_init(pix, 1),
                                      True, True, False)
    state = tb.pack_state(o, d, rng, w * h)
    params = np.zeros((5, 11), np.float32)
    params[:, 3], params[:, 4], params[:, 5] = 0.95, 3, np.arange(5)
    params[:, 6] = params[:, 8] = params[:, 9] = 1.0
    for bounce in range(5):
        p = torch.tensor(params[bounce], device=cuda)
        twin = state.clone()
        tb.bounce_ref(p, fs.tris, fs.mats, fs.lights, static.light_types, twin, nee, fs.walk)
        kern = state.clone()
        before = tb.launches["K2"]
        tb.bounce_step(p, fs, kern, nee)
        torch.cuda.synchronize()
        assert tb.launches["K2"] == before + 1
        k, t = kern.cpu().numpy(), twin.cpu().numpy()
        bits = (k[12:].view(np.int32) != t[12:].view(np.int32)).any(axis=0)
        close = np.isclose(k[:12], t[:12], rtol=RTOL, atol=ATOL).all(axis=0)
        assert bits.mean() <= 1 - MIN_AGREE, (instanced, nee, bounce, int(bits.sum()))
        assert close.mean() >= MIN_AGREE, (instanced, nee, bounce, int((~close).sum()))
        state = twin


def _textured_tables(device, layout: str, nee: bool, normal_map: bool, tex_dir):
    """Tables of a small interior (3,840 triangles) for the split kernels:
    its base-colour textures and, with `normal_map`, a leaning
    tangent-space normal map on every material (a raw UsdUVTexture, which
    lower_material scales by 2 and biases by -1). gi.render of an 8x8 frame
    builds the materials, the texture pool and the kernel material table;
    its geometry and that table then go into resident, flattened or
    instanced tables."""
    from gatling_tpu_torch import gi, imgio
    from gatling_tpu_torch.interface import AovId
    from gatling_tpu_torch.scene.examples import interior
    from gatling_tpu_torch.scene.stage import ShaderNode

    desc = interior(detail=1, tex_dir=str(tex_dir))
    if normal_map:
        lean = np.zeros((2, 2, 4), np.uint8)
        lean[...] = (200, 128, 230, 255)
        path = str(tex_dir / "lean.png")
        imgio.write_image_file(path, lean)
        for m in desc.materials.values():
            node = ShaderNode(path=f"{m.path}/normal_tex", shader_id="UsdUVTexture",
                              inputs={"file": path, "sourceColorSpace": "raw"},
                              input_connections={})
            m.nodes[node.path] = node
            m.nodes[m.surface_node].input_connections["normal"] = (node.path, "rgb")
    scene = gi.create_scene(device)
    for m in desc.meshes:
        scene.add_mesh(m)
    for m in desc.materials.values():
        scene.add_material(m)
    for light in desc.lights:
        scene.add_light(light)
    gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                                aov_bindings=[gi.GiAovBinding(AovId.COLOR,
                                                              gi.GiRenderBuffer(8, 8, 4))],
                                render_settings=dict(spp=1, maxBounces=1)))
    table = gi._fused_mat_table(scene)
    lights = scene._light_arrays if nee else None
    if layout == "instanced":
        fs, static = tb.build_fused_scene_instanced(scene.meshes, scene._material_index, table,
                                                    lights, device, min_gain=1.5, min_flat=0)
    else:
        fs, static = tb.build_fused_scene(scene._geom, table, lights, device,
                                          resident_max=4096 if layout == "resident" else 0)
    static = gi._with_split(scene, static)
    assert static.textured and static.tangents == normal_map
    return (fs, static, scene._material_dev, scene._texture_pool, static.textured_params,
            desc.first_camera())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", ["resident", "flattened", "instanced"])
@pytest.mark.parametrize("nee,normal_map", [(False, False), (True, False), (True, True)])
def test_split_kernels_match_twins(cuda, tmp_path, layout, nee, normal_map):
    """K3 and K4 against their twins (ops/split_ref.py) on a textured
    interior wave, bounces 0-4: hit-buffer rows H_HIT and H_MAT and state
    rows 12-15 bit-equal, the other rows within tolerance; at bounce 1
    also K1 / K2 on the same tables (tangent rows included), as the
    textureLodBounces bounces run them."""
    from gatling_tpu_torch.ops.split_ref import H_HIT, H_MAT, shade_ref, trace_ref
    from gatling_tpu_torch.render.fused import material_rows

    fs, static, mats, pool, active, cam_desc = _textured_tables(cuda, layout, nee, normal_map,
                                                                tmp_path)
    assert static.clustered == (layout != "resident") and static.instanced == (
        layout == "instanced")
    w, h = 128, 64
    cam = camera_uniforms(cam_desc, False, cuda)
    pix = torch.arange(w * h, device=cuda)
    o, d, rng = generate_primary_rays(cam, w, h, pix % w, pix // w, smp.rng_init(pix, 1),
                                      True, True, False)
    state = tb.pack_state(o, d, rng, w * h)
    params = np.zeros((5, 11), np.float32)
    params[:, 3], params[:, 4], params[:, 5] = 0.95, 3, np.arange(5)
    params[:, 6] = params[:, 8] = params[:, 9] = 1.0
    lt = static.light_types
    for bounce in range(5):
        p = torch.tensor(params[bounce], device=cuda)
        hit_twin = trace_ref(p, fs.tris, state, fs.walk)
        before = dict(tb.launches)
        hit_k = tb.trace_step(p, fs, state)
        torch.cuda.synchronize()
        assert tb.launches["K3"] == before["K3"] + 1
        hk, ht = hit_k.cpu().numpy(), hit_twin.cpu().numpy()
        for row in (H_HIT, H_MAT):
            np.testing.assert_array_equal(hk[row].view(np.int32), ht[row].view(np.int32))
        close = np.isclose(hk, ht, rtol=RTOL, atol=ATOL).all(axis=0)
        assert close.mean() >= MIN_AGREE, (layout, bounce, int((~close).sum()))

        parbuf, hit_twin = material_rows(mats, pool, hit_twin, active)
        twin = state.clone()
        shade_ref(p, fs.tris, fs.mats, fs.lights, lt, twin, hit_twin, parbuf,
                  tb.par_row_starts(active), nee, fs.walk)
        kern = state.clone()
        tb.shade_step(p, fs, kern, hit_twin, parbuf, active, nee)
        torch.cuda.synchronize()
        assert tb.launches["K4"] == before["K4"] + 1
        k, t = kern.cpu().numpy(), twin.cpu().numpy()
        np.testing.assert_array_equal(k[12:].view(np.int32), t[12:].view(np.int32))
        close = np.isclose(k[:12], t[:12], rtol=RTOL, atol=ATOL).all(axis=0)
        assert close.mean() >= MIN_AGREE, (layout, bounce, int((~close).sum()))
        if bounce == 1:
            # textureLodBounces runs K1/K2 on these (means, tangent-row) tables
            plain = state.clone()
            tb.bounce_ref(p, fs.tris, fs.mats, fs.lights, lt, plain, nee, fs.walk)
            kern = state.clone()
            tb.bounce_step(p, fs, kern, nee)
            torch.cuda.synchronize()
            k, t = kern.cpu().numpy(), plain.cpu().numpy()
            bits = (k[12:].view(np.int32) != t[12:].view(np.int32)).any(axis=0)
            close = np.isclose(k[:12], t[:12], rtol=RTOL, atol=ATOL).all(axis=0)
            assert bits.mean() <= 1 - MIN_AGREE and close.mean() >= MIN_AGREE, layout
        state = twin
    assert int((state[13] > 0.5).sum()) > 0  # rays lived through bounce 4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("scene_name", ["cornell", "interior"])
def test_trace_kernels_match_twins(cuda, tmp_path, scene_name):
    """K5-K8 against their twins (ops/trace_ref.py) on a camera wave and its
    shadow rays toward random directions: tri, t, u, v and the occlusion
    flags bit-equal on every ray; K7 takes K5's triangle on 99 % of rays."""
    from gatling_tpu_torch.ops import trace as tt
    from gatling_tpu_torch.ops import trace_ref as trf
    from gatling_tpu_torch.scene.examples import interior

    desc = interior(detail=1, tex_dir=str(tmp_path)) if scene_name == "interior" \
        else load_scene("tests/data/cornell.usda")
    paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(paths)}
    midx[None] = len(paths)
    geom = build_geometry(desc.meshes, midx)
    tables, tiles = tt.build_trace_tables(geom, cuda), tt.build_tri_tiles(geom, cuda)
    w, h = 128, 96
    pix = torch.arange(w * h, device=cuda)
    o, d, _ = generate_primary_rays(camera_uniforms(desc.first_camera(), False, cuda), w, h,
                                    pix % w, pix // w, smp.rng_init(pix, 2), True, True, False)
    tmin = torch.zeros(w * h, device=cuda)
    tmax = torch.full((w * h,), 3.4e38, device=cuda)
    tmax[::11] = 0.0  # dead rays
    before = dict(tt.launches)
    k5 = tt.intersect_matrix(o, d, tmin, tmax, tables)
    k7 = tt.intersect_tiles(o, d, tmin, tmax, tiles)
    torch.cuda.synchronize()
    assert tt.launches["K5"] == before["K5"] + 1 and tt.launches["K7"] == before["K7"] + 1
    for got, ref in ((k5, trf.intersect_matrix_ref(o, d, tmin, tmax, tables.coeffs)),
                     (k7, trf.intersect_tiles_ref(o, d, tmin, tmax, tiles.tris))):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.cpu().numpy().view(np.int32),
                                          r.cpu().numpy().view(np.int32))
    assert (k5.tri >= 0).float().mean() > 0.5 and (k5.tri[::11] == -1).all()
    assert (k5.tri == k7.tri).float().mean() >= 0.99
    hit = k5.tri >= 0
    pos = (o + d * torch.where(hit, k5.t, 0.0)[:, None]).contiguous()
    g = torch.Generator().manual_seed(3)
    ld = torch.nn.functional.normalize(torch.randn(w * h, 3, generator=g), dim=1).to(cuda)
    lo, hi = torch.where(hit, 0.01, 0.0), torch.where(hit, 4.0, 0.0)
    k6 = tt.occluded_matrix(pos, ld, lo, hi, tables)
    k8 = tt.occluded_tiles(pos, ld, lo, hi, tiles)
    torch.cuda.synchronize()
    assert torch.equal(k6, trf.occluded_matrix_ref(pos, ld, lo, hi, tables.coeffs))
    assert torch.equal(k8, trf.occluded_tiles_ref(pos, ld, lo, hi, tiles.tris))
    assert 0 < int(k6.sum()) < int(hit.sum())


@pytest.mark.requires_cuda
def test_wavefront_frame_matches_cpu(cuda):
    """Every AOV of a Cornell frame through gi's wavefront route on the
    card (K5/K6) and on the CPU (their twins), the same samples: the ids
    equal on 99.9 % of pixels, COLOR's mean within 1 %."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.cli import load_gi_scene
    from gatling_tpu_torch.interface import AOV_CHANNELS, AOV_IS_INT, AovId
    from gatling_tpu_torch.ops import trace as tt

    out = {}
    for device in (cuda, "cpu"):
        scene, desc, merged = load_gi_scene("tests/data/cornell.usda", device,
                                            dict(spp=2, maxBounces=4, nextEventEstimation=True))
        scene.add_light(_rect_light())
        binds = [gi.GiAovBinding(a, gi.GiRenderBuffer(48, 48, 1 if AOV_IS_INT[a] else
                                                      max(AOV_CHANNELS[a], 3), AOV_IS_INT[a]),
                                 clear_value=-1 if AOV_IS_INT[a] else None) for a in AovId]
        before = dict(tt.launches)
        gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(), aov_bindings=binds,
                                    render_settings=merged))
        if device != "cpu":
            assert tt.launches["K5"] > before["K5"] and tt.launches["K6"] > before["K6"]
        out[str(device)] = {b.aov_id: b.render_buffer.data.copy() for b in binds}
    gpu, cpu = out[str(cuda)], out["cpu"]
    for a in (AovId.OBJECT_ID, AovId.FACE_ID, AovId.INSTANCE_ID):
        assert (gpu[a] == cpu[a]).mean() >= 0.999, a
    c_gpu, c_cpu = gpu[AovId.COLOR][..., :3], cpu[AovId.COLOR][..., :3]
    assert np.isfinite(c_gpu).all() and abs(c_gpu.mean() - c_cpu.mean()) < 0.01 * c_cpu.mean()


# ---------------------------------------------------------------------------
# the advanced lobes, the cutout, the probes
# ---------------------------------------------------------------------------

def _lobe_desc(name: str):
    """glass_coated (resident K1, advanced), cornell_cutout (resident K1,
    cutout: the tall block at opacity 0.5, the short one shut out by its
    threshold) or a small sphere_field with a glass, a clearcoated and a
    half-open material (K2, both branches)."""
    import copy

    from gatling_tpu_torch.scene.examples import sphere_field

    if name == "glass_coated":
        return load_scene("tests/graphical/Materials.GlassCoated/scene.usda")
    if name == "cornell_cutout":
        desc = load_scene("tests/data/cornell.usda")
        white = desc.materials["/Cornell/Materials/White"]
        for block, extra in (("TallBlock", dict(opacity=0.5)),
                             ("ShortBlock", dict(opacity=0.3, opacityThreshold=0.5))):
            m = copy.deepcopy(white)
            m.path = f"/{block}Cutout"
            m.nodes[m.surface_node].inputs.update(extra)
            desc.materials[m.path] = m
            next(x for x in desc.meshes if x.path.endswith("/" + block)).material = m.path
        desc.lights.append(_rect_light())
        return desc
    desc = sphere_field(n_side=6, sphere_res=12)
    node = desc.materials["/mat0"].nodes[desc.materials["/mat0"].surface_node]
    node.shader_id = "ND_open_pbr_surface_surfaceshader"
    node.inputs = dict(transmission_weight=1.0, specular_ior=1.5, specular_roughness=0.1)
    for path, extra in (("/mat1", dict(clearcoat=1.0)), ("/mat2", dict(opacity=0.5))):
        desc.materials[path].nodes[desc.materials[path].surface_node].inputs.update(extra)
    return desc


def _tables(desc, device, instanced: bool = False):
    mat_paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(mat_paths)}
    midx[None] = len(mat_paths)
    table = build_material_table([lower_material(desc.materials.get(p) if p else None)
                                  for p in midx])
    lights = build_light_arrays([l for l in desc.lights if l.light_type != "dome"])
    if instanced:
        return tb.build_fused_scene_instanced(desc.meshes, midx, table, lights, device)
    return tb.build_fused_scene(build_geometry(desc.meshes, midx), table, lights, device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name,instanced", [("glass_coated", False), ("cornell_cutout", False),
                                            ("sphere_field_lobes", False),
                                            ("sphere_field_lobes", True)])
@pytest.mark.parametrize("nee", [False, True])
def test_branch_kernels_match_twin(cuda, name, instanced, nee):
    """K1's and K2's advanced and cutout branches against the twin on a
    128x64 camera wave, bounces 0-4: rows 12-15 bit-equal, rows 0-11 at
    rtol 1e-4 / atol 1e-5 on 99.9 % of rays."""
    desc = _lobe_desc(name)
    fs, static = _tables(desc, cuda, instanced)
    assert static.instanced == instanced
    assert fs.advanced == (name != "cornell_cutout") and fs.cutout == (name != "glass_coated")
    w, h = 128, 64
    cam = camera_uniforms(desc.first_camera(), False, cuda)
    pix = torch.arange(w * h, device=cuda)
    o, d, rng = generate_primary_rays(cam, w, h, pix % w, pix // w, smp.rng_init(pix, 3),
                                      True, True, False)
    state = tb.pack_state(o, d, rng, w * h)
    params = np.zeros((5, 11), np.float32)
    params[:, 3], params[:, 4], params[:, 5] = 0.95, 3, np.arange(5)
    params[:, 6] = params[:, 8] = params[:, 9] = 1.0
    key = "K1" if fs.walk is None else "K2"
    for bounce in range(5):
        p = torch.tensor(params[bounce], device=cuda)
        twin = state.clone()
        tb.bounce_ref(p, fs.tris, fs.mats, fs.lights, static.light_types, twin, nee, fs.walk,
                      fs.advanced, fs.cutout)
        kern = state.clone()
        before = tb.launches[key]
        tb.bounce_step(p, fs, kern, nee)
        torch.cuda.synchronize()
        assert tb.launches[key] == before + 1
        k, t = kern.cpu().numpy(), twin.cpu().numpy()
        bits = (k[12:].view(np.int32) != t[12:].view(np.int32)).any(axis=0)
        close = np.isclose(k[:12], t[:12], rtol=RTOL, atol=ATOL).all(axis=0)
        assert bits.mean() <= 1 - MIN_AGREE and close.mean() >= MIN_AGREE, (
            name, bounce, int(bits.sum()), int((~close).sum()))
        state = twin


@pytest.mark.requires_cuda
def test_cutout_draws_match_twin(cuda):
    """The searches' draw function on the card, bit for bit."""
    from gatling_tpu_torch.ops.bounce_ref import cutout_xi

    rng = np.random.default_rng(4)
    keys = rng.integers(0, 1 << 32, size=1 << 20, dtype=np.uint64).astype(np.uint32)
    ids = rng.integers(0, 1 << 31, size=1 << 20, dtype=np.uint64).astype(np.uint32)
    got = tb.cutout_draws(torch.tensor(keys.view(np.int32), device=cuda),
                          torch.tensor(ids.view(np.int32), device=cuda)).cpu()
    ref = cutout_xi(torch.tensor(keys.astype(np.int64)), torch.tensor(ids.astype(np.int64)))
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.requires_cuda
def test_split_lobes_frame_matches_cpu(cuda):
    """An untextured anisotropic scene with a half-open material renders
    through the split kernels (K3 with the cutout draws, K4 with the
    advanced lobes) on the card and through their twins on the CPU, the
    same samples: the means within 1 %, 98 % of pixels within 1e-3."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.interface import AovId

    out = {}
    for device in (cuda, "cpu"):
        desc = _lobe_desc("sphere_field_lobes")
        node = desc.materials["/mat3"].nodes[desc.materials["/mat3"].surface_node]
        node.shader_id = "ND_open_pbr_surface_surfaceshader"
        node.inputs = dict(base_metalness=1.0, specular_roughness=0.3,
                           specular_roughness_anisotropy=0.7)
        scene = gi.create_scene(device)
        for m in desc.meshes:
            scene.add_mesh(m)
        for m in desc.materials.values():
            scene.add_material(m)
        for light in desc.lights:
            scene.add_light(light)
        buf = gi.GiRenderBuffer(48, 48, 4)
        before = dict(tb.launches)
        gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                                    aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                                    render_settings=dict(spp=2, maxBounces=4,
                                                         nextEventEstimation=True)))
        st = scene._fused_static
        assert st.textured and st.advanced and st.cutout and st.tangents
        if device != "cpu":
            assert tb.launches["K3"] > before["K3"] and tb.launches["K4"] > before["K4"]
        out[str(device)] = buf.data[..., :3].copy()
    g, c = out[str(cuda)], out["cpu"]
    assert np.isfinite(g).all() and abs(g.mean() - c.mean()) < 0.01 * c.mean()
    assert (np.abs(g - c) <= 1e-3 * np.maximum(1.0, np.abs(c))).all(-1).mean() >= 0.98


@pytest.mark.requires_cuda
def test_probes_match_twins(cuda):
    """P1's six moves bit-equal to their torch twins; P2's three products
    equal to their twins bit for bit (TF32: the emulated cvt.rna
    rounding)."""
    from gatling_tpu_torch.tools import cast_probe, precision_probe

    assert all(ok for ok, _deg in cast_probe.run(cuda).values())
    results = precision_probe.run(cuda)
    assert all(same for *_e, same in results.values())
    assert results["HIGHEST (FP32)"][0] == 0.0
