"""On the card: the CUDA kernels (K1 resident, K2 the two-level walk, K3
and K4 the split trace and shade, with their lobe, cutout and volume
branches, K4t K4's taps alone with its row sets, K4r the textured-cutout
re-trace round, K5-K8 the wavefront's trace, P1/P2 the probes) against their
plain twins; K1's, K5's and K6's BVH walks also on tests/test_torch_bvh.py's
adversarial rays, and K2's, K3's and K4's per-cluster trees on
tests/test_torch_cluster_bvh.py's adversarial placements; K4's FLT
instances also over a 16-bit grey PNG's float pool, and the image
fixtures of tests/data/imgio decoded on the card's host.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine that has only torch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a CUDA device every test here skips. Rows 12-15 of the ray state
must be bit-equal; rows 0-11 agree to rtol 1e-4 / atol 1e-5 on at least
99.9 % of rays (the kernel and the twin round cos/sin through different
code paths of the same math library).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from gatling_tpu_torch.ops import bounce as tb
from gatling_tpu_torch.ops import sampling as smp
from gatling_tpu_torch.ops.geometry import build_geometry
from gatling_tpu_torch.render.camera import camera_uniforms, generate_primary_rays
from gatling_tpu_torch.render.lights import build_light_arrays
from gatling_tpu_torch.render.material import build_material_table, lower_material
from gatling_tpu_torch.render.texture import empty_pool
from gatling_tpu_torch.scene.stage import LightDesc, load_scene

RTOL, ATOL, MIN_AGREE = 1e-4, 1e-5, 0.999
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "imgio")


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


def _chip_smoke():
    """chip_smoke.py at the repo's root, as a module (its helpers import
    gatling_tpu_torch when called)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _textured_tables(device, layout: str, nee: bool, normal_map: bool, tex_dir,
                     tinted: bool = False, taps: bool = False, hdr: bool = False,
                     grey16: bool = False):
    """Tables of a small interior (3,840 triangles) for the split kernels:
    its base-colour textures and, with `normal_map`, a leaning
    tangent-space normal map on every material (a raw UsdUVTexture, which
    lower_material scales by 2 and biases by -1). gi.render of an 8x8 frame
    builds the materials, the texture pool and the kernel material table;
    its geometry and that table then go into resident, flattened or
    instanced tables. `tinted`: the bowls in tinted glass
    (examples.interior_tinted); `taps`: chip_smoke.py tap_variants; `hdr`:
    the floor a 64x64 EXR (examples.hdr_floor), a float pool; `grey16`:
    every roughness the red channel of tests/data/imgio's 16-bit grey PNG,
    also a float pool."""
    from gatling_tpu_torch import gi, imgio
    from gatling_tpu_torch.interface import AovId
    from gatling_tpu_torch.scene.examples import hdr_floor, interior, interior_tinted
    from gatling_tpu_torch.scene.stage import ShaderNode

    desc = (interior_tinted if tinted else interior)(detail=1, tex_dir=str(tex_dir))
    if taps:
        _chip_smoke().tap_variants(desc)
    if hdr:
        hdr_floor(desc, str(tex_dir / "floor.exr"), size=64)
    if grey16:
        for m in desc.materials.values():
            node = ShaderNode(path=f"{m.path}/roughness_tex", shader_id="UsdUVTexture",
                              inputs={"file": os.path.join(FIXTURES, "png_grey16.png"),
                                      "sourceColorSpace": "raw"}, input_connections={})
            m.nodes[node.path] = node
            m.nodes[m.surface_node].input_connections["roughness"] = (node.path, "r")
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
    assert scene._texture_pool.packed != (hdr or grey16)
    return (fs, static, scene._material_dev, scene._texture_pool, static.textured_params,
            desc.first_camera())


def _check_split_waves(cuda, fs, static, mats, pool, active, cam_desc, nee: bool, label,
                       bounces: int = 5, bounce_lod: bool = True):
    """K3 and K4 against their twins on a 128x64 camera wave of the tables,
    bounces 0..bounces-1 (the twins step the wave): hit-buffer rows H_HIT
    and H_MAT and state rows 12-15 bit-equal on every ray, the other rows
    within tolerance on 99.9 %; K4 from the twin's hit buffer with its own
    taps, its twin the texture stage (material_rows) and shade_ref; with
    `bounce_lod`, at bounce 1 also K1 / K2 on the same tables (tangent rows
    included), as the textureLodBounces bounces run them. Some rays must
    live through the last bounce, so no bounce's comparison is empty."""
    from gatling_tpu_torch.ops.split_ref import (H_HIT, H_MAT, material_rows, shade_ref,
                                                 trace_ref)

    w, h = 128, 64
    cam = camera_uniforms(cam_desc, False, cuda)
    pix = torch.arange(w * h, device=cuda)
    o, d, rng = generate_primary_rays(cam, w, h, pix % w, pix // w, smp.rng_init(pix, 1),
                                      True, True, False)
    state = tb.pack_state(o, d, rng, w * h)
    params = np.zeros((bounces, 11), np.float32)
    params[:, 3], params[:, 4], params[:, 5] = 0.95, 3, np.arange(bounces)
    params[:, 6] = params[:, 8] = params[:, 9] = 1.0
    lt = static.light_types
    flags = (fs.walk, fs.advanced, fs.cutout, fs.volumes)
    k4 = "K4f" if pool.has_texels and not pool.packed else "K4"  # the FLT instances
    for bounce in range(bounces):
        p = torch.tensor(params[bounce], device=cuda)
        hit_twin = trace_ref(p, fs.tris, state, fs.walk, fs.cutout)
        before = dict(tb.launches)
        hit_k = tb.trace_step(p, fs, state)
        torch.cuda.synchronize()
        assert tb.launches["K3"] == before["K3"] + 1
        hk, ht = hit_k.cpu().numpy(), hit_twin.cpu().numpy()
        for row in (H_HIT, H_MAT):
            np.testing.assert_array_equal(hk[row].view(np.int32), ht[row].view(np.int32))
        close = np.isclose(hk, ht, rtol=RTOL, atol=ATOL).all(axis=0)
        assert close.mean() >= MIN_AGREE, (label, bounce, int((~close).sum()))

        parbuf, hit_n = material_rows(mats, pool, hit_twin, active)
        twin = state.clone()
        shade_ref(p, fs.tris, fs.mats, fs.lights, lt, twin, hit_n, parbuf,
                  tb.par_row_starts(active), nee, *flags)
        kern = state.clone()
        tb.shade_step(p, fs, kern, hit_twin, mats, pool, active, nee)
        torch.cuda.synchronize()
        assert tb.launches[k4] == before[k4] + 1
        k, t = kern.cpu().numpy(), twin.cpu().numpy()
        np.testing.assert_array_equal(k[12:].view(np.int32), t[12:].view(np.int32))
        close = np.isclose(k[:12], t[:12], rtol=RTOL, atol=ATOL).all(axis=0)
        assert close.mean() >= MIN_AGREE, (label, bounce, int((~close).sum()))
        if bounce == 1 and bounce_lod:
            # textureLodBounces runs K1/K2 on these (means, tangent-row) tables
            plain = state.clone()
            tb.bounce_ref(p, fs.tris, fs.mats, fs.lights, lt, plain, nee, *flags)
            kern = state.clone()
            tb.bounce_step(p, fs, kern, nee)
            torch.cuda.synchronize()
            k, t = kern.cpu().numpy(), plain.cpu().numpy()
            bits = (k[12:].view(np.int32) != t[12:].view(np.int32)).any(axis=0)
            close = np.isclose(k[:12], t[:12], rtol=RTOL, atol=ATOL).all(axis=0)
            assert bits.mean() <= 1 - MIN_AGREE and close.mean() >= MIN_AGREE, label
        state = twin
    assert int((state[13] > 0.5).sum()) > 0, label  # rays lived through the last bounce


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", ["resident", "flattened", "instanced"])
@pytest.mark.parametrize("nee,normal_map", [(False, False), (True, False), (True, True)])
def test_split_kernels_match_twins(cuda, tmp_path, layout, nee, normal_map):
    """K3 and K4 against their twins (ops/split_ref.py, K4's after the
    texture stage) on a textured interior wave, bounces 0-4
    (_check_split_waves)."""
    fs, static, mats, pool, active, cam_desc = _textured_tables(cuda, layout, nee, normal_map,
                                                                tmp_path)
    assert static.clustered == (layout != "resident") and static.instanced == (
        layout == "instanced")
    assert pool.bilinear_packed
    _check_split_waves(cuda, fs, static, mats, pool, active, cam_desc, nee, layout)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", ["resident", "flattened", "instanced"])
@pytest.mark.parametrize("nee,normal_map", [(False, False), (True, True)])
def test_split_kernels_match_twins_float_pool(cuda, tmp_path, layout, nee, normal_map):
    """K4's FLT instances (resident: K4, clustered and instanced: K4 walk)
    and K3 against their twins on the interior whose floor texture is an
    EXR (examples.hdr_floor): the whole pool float, every tap reading four f32x4
    texels; rows 12-15, H_HIT and H_MAT bit-equal on every ray
    (_check_split_waves)."""
    fs, static, mats, pool, active, cam_desc = _textured_tables(cuda, layout, nee, normal_map,
                                                                tmp_path, hdr=True)
    assert not pool.packed and pool.texels.shape[0] > 64 * 64
    assert tb.tap_mask(1, 16, pool) & tb.TAP_FLOAT
    _check_split_waves(cuda, fs, static, mats, pool, active, cam_desc, nee,
                       f"{layout} float pool")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", ["resident", "flattened", "instanced"])
def test_split_kernels_match_twins_grey16_pool(cuda, tmp_path, layout):
    """K3 and K4's FLT instances against their twins on the interior whose
    every roughness is a 16-bit grey PNG (decoded as Pillow's "I;16" over
    65535: a float pool), NEE on: rows 12-15, H_HIT and H_MAT bit-equal on
    every ray (_check_split_waves)."""
    fs, static, mats, pool, active, cam_desc = _textured_tables(cuda, layout, True, False,
                                                                tmp_path, grey16=True)
    assert not pool.packed and tb.tap_mask(1, 16, pool) & tb.TAP_FLOAT
    _check_split_waves(cuda, fs, static, mats, pool, active, cam_desc, True,
                       f"{layout} 16-bit grey pool")


@pytest.mark.requires_cuda
def test_fixture_decodes_on_the_card_host(cuda):
    """Every image fixture decodes on the card's host (no Pillow there)
    to the array Pillow gave where it was written (fixtures.npz)."""
    from gatling_tpu_torch import imgio

    ref = np.load(os.path.join(FIXTURES, "fixtures.npz"))
    cs = _chip_smoke()
    for name in ref.files:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert cs.same_image(imgio.load_image(f.read()), ref[name]), name


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", ["resident", "instanced"])
@pytest.mark.parametrize("normal_map", [False, True])
def test_split_taps_wrap_modes_and_channels(cuda, tmp_path, layout, normal_map):
    """K4's taps through the wrap modes (clamp, mirror, black: texels_u32
    and the floor-modulo wrap on the interior's uv outside [0, 1]), sRGB
    slots (the decode table) and metallic and roughness picked from the b
    and g channels, against the texture stage and shade_ref, NEE on."""
    fs, static, mats, pool, active, cam_desc = _textured_tables(cuda, layout, True, normal_map,
                                                                tmp_path, taps=True)
    assert not pool.bilinear_packed and {"metallic", "roughness"} <= set(active)
    assert bool((pool.is_srgb > 0).any()) and {0, 1, 3} <= set(pool.wrap_s.tolist())
    _check_split_waves(cuda, fs, static, mats, pool, active, cam_desc, True,
                       f"{layout} taps", bounce_lod=False)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("textured", [False, True])
def test_split_lobes_cutout_match_twins(cuda, tmp_path, textured):
    """K4's advanced (mesh-tangent frame) and cutout (the shadow walk's
    draws) branches: the small interior with an anisotropic open_pbr
    worktop over its texture and the bowls at opacity 0.5 (textured), or
    the sphere field with an anisotropic and a half-open material and the
    empty pool (untextured), through gi's tables (resident for the
    interior, instanced for the sphere field), NEE on."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.interface import AovId
    from gatling_tpu_torch.scene.examples import interior

    if textured:
        desc = interior(detail=1, tex_dir=str(tmp_path))
        work = desc.materials["/m_worktop"]
        node = work.nodes[work.surface_node]
        node.input_connections["base_color"] = node.input_connections.pop("diffuseColor")
        node.shader_id = "ND_open_pbr_surface_surfaceshader"
        node.inputs = dict(specular_roughness=0.25, specular_roughness_anisotropy=0.6)
        bowl = desc.materials["/m_bowl"]
        bowl.nodes[bowl.surface_node].inputs["opacity"] = 0.5
    else:
        desc = _lobe_desc("sphere_field_lobes")
        node = desc.materials["/mat3"].nodes[desc.materials["/mat3"].surface_node]
        node.shader_id = "ND_open_pbr_surface_surfaceshader"
        node.inputs = dict(base_metalness=1.0, specular_roughness=0.3,
                           specular_roughness_anisotropy=0.7)
    scene = gi.create_scene(cuda)
    for m in desc.meshes:
        scene.add_mesh(m)
    for m in desc.materials.values():
        scene.add_material(m)
    for light in desc.lights:
        scene.add_light(light)
    gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                                aov_bindings=[gi.GiAovBinding(AovId.COLOR,
                                                              gi.GiRenderBuffer(8, 8, 4))],
                                render_settings=dict(spp=1, maxBounces=1,
                                                     nextEventEstimation=True)))
    fs, st = scene._fused, scene._fused_static
    assert st.textured and st.advanced and st.cutout and st.tangents
    assert st.clustered != textured
    assert scene._texture_pool.packed == textured
    _check_split_waves(cuda, fs, st, scene._material_dev, scene._texture_pool,
                       st.textured_params, desc.first_camera(), True,
                       f"lobes textured={textured}", bounces=3, bounce_lod=False)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("taps,normal_map", [(False, False), (False, True), (True, False),
                                             (True, True)])
def test_taps_match_texture_stage(cuda, tmp_path, taps, normal_map):
    """K4's taps alone (ops/bounce.py tap_rows) against the texture stage on
    the card (tap_rows_ref: ops/split_ref.py material_rows) on 1,048,576
    random hit rows over the small interior's materials and pool (2x2 rows,
    or with `taps` the wrap modes, sRGB and channel picks of
    chip_smoke.py tap_variants): uv from -3 to 4, random unit normals, tangents and
    bitangent signs. Every tapped parameter and the normal-mapped shading
    normal bit-equal on every row: the normal map's cross product and norm
    in the rounding of PyTorch's CUDA kernels."""
    _fs, _static, mats, pool, active, _cam = _textured_tables(cuda, "resident", False,
                                                              normal_map, tmp_path, taps=taps)
    rng = np.random.default_rng(8)
    r = 1 << 20
    hit = np.zeros((24 if normal_map else 16, r), np.float32)
    hit[0] = 1.0
    hit[2:4] = rng.uniform(-3.0, 4.0, (2, r))
    hit[4] = rng.integers(0, mats.packed_f.shape[0], r)
    n = rng.standard_normal((3, r))
    n /= np.linalg.norm(n, axis=0)
    hit[8:11] = n
    if normal_map:
        t = rng.standard_normal((3, r))
        t -= n * (t * n).sum(0)
        hit[16:19] = t / np.linalg.norm(t, axis=0)
        hit[19] = np.where(rng.random(r) < 0.5, -1.0, 1.0)
    hit = torch.tensor(hit, device=cuda)
    got = tb.tap_rows(hit, mats, pool, active)
    want = tb.tap_rows_ref(hit, mats, pool, active)
    torch.cuda.synchronize()
    bad = (got.view(torch.int32) != want.view(torch.int32)).any(dim=0)
    assert int(bad.sum()) == 0, (int(bad.sum()), torch.nonzero(bad)[:5].tolist())
    assert bool((got[tb.TAP_N_ROW:tb.TAP_N_ROW + 3] != hit[8:11]).any()) == normal_map


@pytest.mark.requires_cuda
@pytest.mark.parametrize("taps,normal_map", [(False, True), (True, True)])
def test_float_taps_match_texture_stage(cuda, tmp_path, taps, normal_map):
    """tap_rows' FLT instance (K4t over a float pool: the floor an EXR,
    every slot's linear texels in `texels`, with `taps` the wrap modes and
    channel picks of tap_variants) bit-equal to tap_rows_ref on 1,048,576
    random hit rows, as test_taps_match_texture_stage holds the 8-bit one;
    one K4tf launch a call."""
    _fs, _static, mats, pool, active, _cam = _textured_tables(cuda, "resident", False,
                                                              normal_map, tmp_path, taps=taps,
                                                              hdr=True)
    rng = np.random.default_rng(9)
    r = 1 << 20
    hit = np.zeros((24, r), np.float32)
    hit[0] = 1.0
    hit[2:4] = rng.uniform(-3.0, 4.0, (2, r))
    hit[4] = rng.integers(0, mats.packed_f.shape[0], r)
    n = rng.standard_normal((3, r))
    n /= np.linalg.norm(n, axis=0)
    hit[8:11] = n
    t = rng.standard_normal((3, r))
    t -= n * (t * n).sum(0)
    hit[16:19] = t / np.linalg.norm(t, axis=0)
    hit[19] = np.where(rng.random(r) < 0.5, -1.0, 1.0)
    hit = torch.tensor(hit, device=cuda)
    before = dict(tb.launches)
    got = tb.tap_rows(hit, mats, pool, active)
    assert tb.launches["K4tf"] == before["K4tf"] + 1 and tb.launches["K4t"] == before["K4t"]
    want = tb.tap_rows_ref(hit, mats, pool, active)
    torch.cuda.synchronize()
    bad = (got.view(torch.int32) != want.view(torch.int32)).any(dim=0)
    assert int(bad.sum()) == 0, (int(bad.sum()), torch.nonzero(bad)[:5].tolist())
    assert float(got[0:3].max()) > 1.0  # the EXR's texels above 1 were tapped


@pytest.mark.requires_cuda
def test_textured_frame_runs_no_texture_stage(cuda, tmp_path):
    """A textured, normal-mapped frame through gi.render on the card: K3
    and K4 a bounce, and no call of the texture stage (K4 taps itself)."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.interface import AovId
    from gatling_tpu_torch.ops import split_ref
    from gatling_tpu_torch.scene.examples import interior

    desc = interior(detail=1, tex_dir=str(tmp_path))
    _chip_smoke().tap_variants(desc)
    scene = gi.create_scene(cuda)
    for m in desc.meshes:
        scene.add_mesh(m)
    for m in desc.materials.values():
        scene.add_material(m)
    for light in desc.lights:
        scene.add_light(light)
    before, split_ref.stage_calls = dict(tb.launches), 0
    buf = gi.GiRenderBuffer(32, 32, 4)
    gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                                aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                                render_settings=dict(spp=2, maxBounces=3,
                                                     nextEventEstimation=True)))
    assert scene._fused_static.textured
    assert tb.launches["K3"] - before["K3"] == tb.launches["K4"] - before["K4"] > 0
    assert split_ref.stage_calls == 0
    assert np.isfinite(buf.data).all() and buf.data[..., :3].mean() > 0.01


@pytest.mark.requires_cuda
@pytest.mark.parametrize("scene_name", ["cornell", "interior"])
def test_trace_kernels_match_twins(cuda, tmp_path, scene_name):
    """K5-K8 against their twins (ops/trace_ref.py) on a camera wave and its
    shadow rays toward random directions and toward points on the scene's
    lights (K6 walking the soup's BVH, K8 the tiles): tri, t, u, v and the
    occlusion flags bit-equal on every ray; K7 takes K5's triangle on 99 %
    of rays."""
    from test_torch_bvh import _light_targets

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
    to_light = _light_targets(desc, geom, w * h, np.random.default_rng(4)).to(cuda) - pos
    dist = to_light.norm(dim=1)
    for ld, hi in ((ld, hi), ((to_light / dist[:, None]).contiguous(),
                              torch.where(hit, dist, 0.0))):
        before = tt.launches["K6"]
        k6 = tt.occluded_matrix(pos, ld, lo, hi, tables)
        k8 = tt.occluded_tiles(pos, ld, lo, hi, tiles)
        torch.cuda.synchronize()
        assert tt.launches["K6"] == before + 1
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


def _threaded_soup(name: str, tmp_path):
    """(desc or None, soup): a random soup of 20,000 triangles, the
    adversarial lattice of tests/threaded_soups.py (12 cells a side,
    11,232 triangles) or the interior at full detail (92,492 triangles
    and the padding)."""
    from threaded_soups import lattice_soup

    from gatling_tpu_torch.ops.geometry import SceneGeometry
    from gatling_tpu_torch.scene.examples import interior

    if name == "lattice":
        return None, lattice_soup(LATTICE_CELLS)
    if name == "interior":
        desc = interior(tex_dir=str(tmp_path))
        paths = sorted({m.material for m in desc.meshes if m.material})
        midx = {p: i for i, p in enumerate(paths)}
        midx[None] = len(paths)
        return desc, build_geometry(desc.meshes, midx)
    rng = np.random.default_rng(21)
    n = 20000
    v0 = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e1, e2 = (rng.normal(0, 0.3, (n, 3)).astype(np.float32) for _ in range(2))
    z3, z2, zi = np.zeros((n, 3), np.float32), np.zeros((n, 2), np.float32), np.zeros(n, np.int32)
    return None, SceneGeometry(v0, e1, e2, z3, z3, z3, z3, z3, z3, z3, z2, z2, z2, z3, z3, z3,
                               zi, zi, zi, zi, zi)


LATTICE_CELLS = 12


@pytest.mark.requires_cuda
@pytest.mark.parametrize("soup", ["random20000", "interior", "lattice"])
def test_threaded_kernels_match_twins(cuda, tmp_path, soup):
    """B1 and B2 (the walks of the threaded BVH's wide rows, the
    wavefront's tracer above 8192 triangles) against their twins: on a
    random soup of 20,000 triangles (rays from random points in random
    directions, every 7th with tmin > 0, every 5th a finite tmax, every
    11th dead), on the interior's first wave at full detail (its camera's
    256x256 rays, shadow rays from their hits toward its lights) and on
    the adversarial lattice (tests/threaded_soups.py: ties at shared edges
    and vertices, directions with exact zeros from origins on box faces,
    segments that end inside a leaf; B2 on the same rays, and on shadow
    rays from B1's hits): t, tri, u, v and the flags bit-equal on every
    ray, one launch each; the wide walk's model (trace_ref.wide_work)
    gives the same answers and counts the rays that walked the node rows."""
    from test_torch_bvh import _light_targets
    from threaded_soups import lattice_rays

    from gatling_tpu_torch.ops import bvh as bvhm
    from gatling_tpu_torch.ops import trace as tt
    from gatling_tpu_torch.ops import trace_ref as trf

    desc, geom = _threaded_soup(soup, tmp_path)
    arrays, order = bvhm.build_bvh(geom.v0, geom.e1, geom.e2)
    reordered = bvhm.reorder_geometry(geom, order)
    bvh = bvhm.threaded_bvh(arrays, reordered, cuda)
    assert bvh.wide.shape[0] > 0
    n = 256 * 256
    if soup == "lattice":
        o, d, tmin, tmax = (torch.tensor(x, device=cuda) for x in lattice_rays(LATTICE_CELLS,
                                                                               n, 9))
        b2 = tt.occluded_threaded(o, d, tmin, tmax, bvh)
        flags, _rows, _slabs, _tests, binary = trf.wide_work(o, d, tmin, tmax, bvh, True)
        assert torch.equal(b2, trf.occluded_threaded_ref(o, d, tmin, tmax, bvh))
        assert torch.equal(b2, flags) and int(binary.sum()) > n // 8
    elif desc is None:
        rng = np.random.default_rng(5)
        o = torch.tensor(rng.uniform(-7, 7, (n, 3)), dtype=torch.float32, device=cuda)
        d = torch.nn.functional.normalize(torch.tensor(rng.normal(size=(n, 3)),
                                                       dtype=torch.float32, device=cuda), dim=1)
        tmin = torch.zeros(n, device=cuda)
        tmin[::7] = 0.5
        tmax = torch.full((n,), 3.4e38, device=cuda)
        tmax[::5] = 4.0
    else:
        pix = torch.arange(n, device=cuda)
        o, d, _ = generate_primary_rays(camera_uniforms(desc.first_camera(), False, cuda), 256,
                                        256, pix % 256, pix // 256, smp.rng_init(pix, 2), True,
                                        True, False)
        tmin = torch.zeros(n, device=cuda)
        tmax = torch.full((n,), 3.4e38, device=cuda)
    tmax[::11] = 0.0  # dead rays
    before = dict(tt.launches)
    b1 = tt.intersect_threaded(o, d, tmin, tmax, bvh)
    torch.cuda.synchronize()
    assert tt.launches["B1"] == before["B1"] + 1
    model = trf.wide_work(o, d, tmin, tmax, bvh)[0]
    for g, r, m in zip(b1, trf.intersect_threaded_ref(o, d, tmin, tmax, bvh), model):
        np.testing.assert_array_equal(g.cpu().numpy().view(np.int32),
                                      r.cpu().numpy().view(np.int32))
        assert torch.equal(m.view(torch.int32), r.view(torch.int32))
    hit = b1.tri >= 0
    assert hit.float().mean() > (0.5 if desc else 0.05) and (b1.tri[::11] == -1).all()
    pos = (o + d * torch.where(hit, b1.t, 0.0)[:, None]).contiguous()
    if soup == "lattice":
        to = torch.tensor(np.random.default_rng(6).integers(0, LATTICE_CELLS + 1, (n, 3)),
                          dtype=torch.float32, device=cuda) - pos
    elif desc is None:
        to = torch.tensor(np.random.default_rng(6).uniform(-7, 7, (n, 3)), dtype=torch.float32,
                          device=cuda) - pos
    else:
        to = _light_targets(desc, geom, n, np.random.default_rng(4)).to(cuda) - pos
    dist = to.norm(dim=1)
    ld = (to / dist[:, None]).contiguous()
    lo, hi = torch.where(hit, 1e-3, 0.0), torch.where(hit, dist, 0.0)
    b2 = tt.occluded_threaded(pos, ld, lo, hi, bvh)
    torch.cuda.synchronize()
    assert tt.launches["B2"] == before["B2"] + 1
    assert torch.equal(b2, trf.occluded_threaded_ref(pos, ld, lo, hi, bvh))
    assert 0 < int(b2.sum()) < int(hit.sum())


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


# ---------------------------------------------------------------------------
# the volume modes: absorption (VOL 1) and the depth-1 medium stack (VOL 2)
# ---------------------------------------------------------------------------

def _volume_desc(name: str, tmp_path):
    """cornell_fog (resident K1: the fog tall block; with it the tinted
    glass of glass_tinted on the short block) or a small sphere_field with
    a tinted-glass and a fog material (K2)."""
    from gatling_tpu_torch.scene import examples as ex

    if name == "cornell_fog":
        desc = load_scene(ex.cornell_fog(str(tmp_path)))
        desc.materials["/glass"] = ex.tinted_glass_material("/glass")
        next(m for m in desc.meshes if m.path.endswith("/ShortBlock")).material = "/glass"
        return desc
    return ex.sphere_field_volumes(str(tmp_path), n_side=6, sphere_res=12)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name,instanced", [("cornell_fog", False),
                                            ("sphere_field_volumes", False),
                                            ("sphere_field_volumes", True)])
@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("mode", [tb.VOL_ABSORB, tb.VOL_SCATTER])
def test_volume_kernels_match_twin(cuda, tmp_path, name, instanced, nee, mode):
    """K1's and K2's volume branches against the twin on a 128x64 camera
    wave, bounces 0-5 (rays inside media carry the encoded alive row):
    rows 12-15 bit-equal, rows 0-11 at rtol 1e-4 / atol 1e-5 on 99.9 % of
    rays."""
    desc = _volume_desc(name, tmp_path)
    fs, static = _tables(desc, cuda, instanced)
    fs, static = tb.with_volumes(fs, static, scatter=mode == tb.VOL_SCATTER)
    assert static.instanced == instanced and fs.volumes == mode and fs.advanced
    w, h = 128, 64
    cam = camera_uniforms(desc.first_camera(), False, cuda)
    pix = torch.arange(w * h, device=cuda)
    o, d, rng = generate_primary_rays(cam, w, h, pix % w, pix // w, smp.rng_init(pix, 3),
                                      True, True, False)
    state = tb.pack_state(o, d, rng, w * h)
    params = np.zeros((6, 11), np.float32)
    params[:, 3], params[:, 4], params[:, 5] = 0.95, 3, np.arange(6)
    params[:, 6] = params[:, 8] = params[:, 9] = 1.0
    params[:, 10] = 7.0  # maxVolumeWalkLength
    key = "K1" if fs.walk is None else "K2"
    inside = 0
    for bounce in range(6):
        p = torch.tensor(params[bounce], device=cuda)
        twin = state.clone()
        tb.bounce_ref(p, fs.tris, fs.mats, fs.lights, static.light_types, twin, nee, fs.walk,
                      fs.advanced, fs.cutout, fs.volumes)
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
        inside += int((t[13] > 1.5).sum())
        state = twin
    assert inside > 100  # rays travelled inside media


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", ["resident", "instanced"])
def test_volume_split_kernels_match_twins(cuda, tmp_path, layout):
    """K4's absorption branch (and K1 / K2's on the same tangent-row tables,
    as textureLodBounces runs them) on the textured interior with tinted
    glass bowls, bounces 0-4, against the twins."""
    from gatling_tpu_torch.ops.split_ref import material_rows, shade_ref, trace_ref

    fs, static, mats, pool, active, cam_desc = _textured_tables(cuda, layout, True, True,
                                                                tmp_path, tinted=True)
    fs, static = tb.with_volumes(fs, static, scatter=False)
    assert fs.volumes == tb.VOL_ABSORB and fs.advanced
    w, h = 128, 64
    cam = camera_uniforms(cam_desc, False, cuda)
    pix = torch.arange(w * h, device=cuda)
    o, d, rng = generate_primary_rays(cam, w, h, pix % w, pix // w, smp.rng_init(pix, 1),
                                      True, True, False)
    state = tb.pack_state(o, d, rng, w * h)
    params = np.zeros((5, 11), np.float32)
    params[:, 3], params[:, 4], params[:, 5] = 0.95, 3, np.arange(5)
    params[:, 6] = params[:, 8] = params[:, 9] = 1.0
    flags = (fs.walk, fs.advanced, fs.cutout, fs.volumes)
    for bounce in range(5):
        p = torch.tensor(params[bounce], device=cuda)
        hit = trace_ref(p, fs.tris, state, fs.walk)
        parbuf, hit_n = material_rows(mats, pool, hit, active)
        twin = state.clone()
        shade_ref(p, fs.tris, fs.mats, fs.lights, static.light_types, twin, hit_n, parbuf,
                  tb.par_row_starts(active), True, *flags)
        kern = state.clone()
        before = tb.launches["K4"]
        tb.shade_step(p, fs, kern, hit, mats, pool, active, True)
        torch.cuda.synchronize()
        assert tb.launches["K4"] == before + 1
        k, t = kern.cpu().numpy(), twin.cpu().numpy()
        np.testing.assert_array_equal(k[12:].view(np.int32), t[12:].view(np.int32))
        close = np.isclose(k[:12], t[:12], rtol=RTOL, atol=ATOL).all(axis=0)
        assert close.mean() >= MIN_AGREE, (layout, bounce, int((~close).sum()))
        if bounce == 1:
            plain = state.clone()
            tb.bounce_ref(p, fs.tris, fs.mats, fs.lights, static.light_types, plain, True,
                          *flags)
            kern = state.clone()
            tb.bounce_step(p, fs, kern, True)
            torch.cuda.synchronize()
            k, t = kern.cpu().numpy(), plain.cpu().numpy()
            bits = (k[12:].view(np.int32) != t[12:].view(np.int32)).any(axis=0)
            close = np.isclose(k[:12], t[:12], rtol=RTOL, atol=ATOL).all(axis=0)
            assert bits.mean() <= 1 - MIN_AGREE and close.mean() >= MIN_AGREE, layout
        state = twin


def _adversarial(device, cutout: bool):
    """tests/test_torch_bvh.py's adversarial soup (shared edges and
    vertices, duplicated triangles, a closed box) as a resident table with
    a diffuse material and the rect light, its rays (4,324: through edges
    and vertices, axis-parallel, from points on a surface, hits at t =
    tmin) and their tmin, on `device`. With `cutout`, every triangle
    passes half its camera draws and a quarter of its shadow draws."""
    from test_torch_bvh import _adversarial_rays, _soup

    geom = _soup()
    n = geom.v0.shape[0]
    probs = (np.full(n, 0.5, np.float32), np.full(n, 0.25, np.float32)) if cutout else (None,)
    rows = tb.tri_rows(geom, cutout_prob=probs[0], shadow_prob=probs[-1])
    table = build_material_table([lower_material(None)])
    lights, light_types = tb.build_fused_lights(build_light_arrays([_rect_light()]))
    fs = tb.from_jax_tables(rows.T, table.packed_f, lights, light_types, device, cutout=cutout)
    o, d, lo = _adversarial_rays(geom)
    return geom, fs, light_types, o.to(device), d.to(device), lo.to(device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cutout", [False, True])
@pytest.mark.parametrize("nee", [False, True])
def test_adversarial_resident_walk(cuda, cutout, nee):
    """K1 and the resident K3 walk the table's BVH: on the adversarial
    rays, grouped by their tmin, K1's rows 12-15 and K3's H_HIT, H_T and
    H_MAT are bit-equal to the brute-force twins' on every ray (the
    duplicated triangles' ties, the cutout draws and the NEE shadow rays
    included), K1's rows 0-11 within rtol/atol on 99.9 %."""
    from gatling_tpu_torch.ops.split_ref import H_HIT, H_MAT, H_T, trace_ref

    _geom, fs, light_types, o, d, lo = _adversarial(cuda, cutout)
    for tmin in sorted(set(lo.tolist())):
        sel = lo == tmin
        n = int(sel.sum())
        state = tb.pack_state(o[sel].contiguous(), d[sel].contiguous(),
                              smp.rng_init(torch.arange(n, device=cuda), 5), n)
        p = torch.tensor([0.0, 0.0, 0.0, 0.95, 3.0, 0.0, 1.0, tmin, 1.0, 1.0, 7.0],
                         dtype=torch.float32, device=cuda)
        twin = state.clone()
        tb.bounce_ref(p, fs.tris, fs.mats, fs.lights, light_types, twin, nee, cutout=cutout)
        kern = state.clone()
        tb.bounce_step(p, fs, kern, nee)
        hit_k = tb.trace_step(p, fs, state)
        torch.cuda.synchronize()
        hit_t = trace_ref(p, fs.tris, state, None, cutout)
        k, t = kern.cpu().numpy(), twin.cpu().numpy()
        np.testing.assert_array_equal(k[12:].view(np.int32), t[12:].view(np.int32))
        close = np.isclose(k[:12], t[:12], rtol=RTOL, atol=ATOL).all(axis=0)
        assert close.mean() >= MIN_AGREE, (tmin, int((~close).sum()))
        rows = [H_HIT, H_T, H_MAT]
        assert torch.equal(hit_k[rows].view(torch.int32), hit_t[rows].view(torch.int32)), tmin


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cutout", [False, True])
@pytest.mark.parametrize("nee", [False, True])
def test_adversarial_cluster_walk(cuda, cutout, nee):
    """K2, K3 and K4 walk each cluster's tree: on the adversarial soup's
    three placements (as built, scaled by 1e-3 seen from about 7e5 of its
    units away, scaled by 1e3; test_torch_cluster_bvh._placed_rays),
    grouped by tmin, K2's rows 12-15 (the NEE shadow flags included) and
    K3's H_HIT, H_T and H_MAT are bit-equal to the brute-force twins' on
    every ray, K2's rows 0-11 within rtol/atol on 99.9 %; and K4 (its NEE
    shadow ray through the any-hit walk) from the twin's hit buffer
    equals the twin's shade likewise."""
    from test_torch_cluster_bvh import _placed_rays, _placements, _soup_mesh, _with_cutout

    from gatling_tpu_torch.ops.split_ref import H_HIT, H_MAT, H_T, shade_ref, trace_ref
    from gatling_tpu_torch.scene.stage import MeshDesc

    mesh = MeshDesc(path="/soup", mesh=_soup_mesh(), transform=np.eye(4), material=None,
                    double_sided=True, object_id=0, instance_transforms=_placements())
    table = build_material_table([lower_material(None)])
    light = _rect_light()
    light.transform[3, :3] = [0.0, 2.0, 0.0]
    fs, static = tb.build_fused_scene_instanced([mesh], {None: 0}, table,
                                                build_light_arrays([light]), cuda,
                                                min_gain=1.5, min_flat=0)
    if cutout:
        fs = _with_cutout(fs)
    parbuf = torch.zeros((8, 1), device=cuda)
    untextured = table.to(cuda)
    for k, (o, d, lo) in enumerate(_placed_rays()):
        o, d, lo = o.to(cuda), d.to(cuda), lo.to(cuda)
        for tmin in sorted(set(lo.tolist())):
            sel = lo == tmin
            n = int(sel.sum())
            state = tb.pack_state(o[sel].contiguous(), d[sel].contiguous(),
                                  smp.rng_init(torch.arange(n, device=cuda), 5), n)
            p = torch.tensor([0.0, 0.0, 0.0, 0.95, 3.0, 0.0, 1.0, tmin, 1.0, 1.0, 7.0],
                             dtype=torch.float32, device=cuda)
            twin = state.clone()
            tb.bounce_ref(p, fs.tris, fs.mats, fs.lights, static.light_types, twin, nee,
                          fs.walk, cutout=cutout)
            kern = state.clone()
            tb.bounce_step(p, fs, kern, nee)
            hit_k = tb.trace_step(p, fs, state)
            torch.cuda.synchronize()
            hit_t = trace_ref(p, fs.tris, state, fs.walk, cutout)
            kt, tt_ = kern.cpu().numpy(), twin.cpu().numpy()
            np.testing.assert_array_equal(kt[12:].view(np.int32), tt_[12:].view(np.int32))
            close = np.isclose(kt[:12], tt_[:12], rtol=RTOL, atol=ATOL).all(axis=0)
            assert close.mean() >= MIN_AGREE, (k, tmin, int((~close).sum()))
            rows = [H_HIT, H_T, H_MAT]
            assert torch.equal(hit_k[rows].view(torch.int32), hit_t[rows].view(torch.int32)), \
                (k, tmin)
            shaded = state.clone()
            tb.shade_step(p, fs, shaded, hit_t, untextured, empty_pool(cuda), (), nee)
            torch.cuda.synchronize()
            want = state.clone()
            shade_ref(p, fs.tris, fs.mats, fs.lights, static.light_types, want, hit_t,
                      parbuf.expand(8, n).contiguous(), tb.par_row_starts(()), nee, fs.walk,
                      cutout=cutout)
            ks, ws = shaded.cpu().numpy(), want.cpu().numpy()
            np.testing.assert_array_equal(ks[12:].view(np.int32), ws[12:].view(np.int32))
            close = np.isclose(ks[:12], ws[:12], rtol=RTOL, atol=ATOL).all(axis=0)
            assert close.mean() >= MIN_AGREE, (k, tmin, int((~close).sum()))


@pytest.mark.requires_cuda
def test_adversarial_trace_walk(cuda):
    """K5 and K6 walk the soup's BVH: on the adversarial rays (tmin per ray,
    every 17th ray dead) K5's t, tri, u and v are bit-equal to
    intersect_matrix_ref's on every ray, and on their shadow segments
    (test_torch_bvh._shadow_segments: ending exactly at a hit's t, grazing
    edges, starting just past a surface) K6's flags equal
    occluded_matrix_ref's."""
    from test_torch_bvh import _shadow_segments

    from gatling_tpu_torch.ops import trace as tt
    from gatling_tpu_torch.ops import trace_ref as trf

    geom, _fs, _lt, o, d, lo = _adversarial(cuda, False)
    tables = tt.build_trace_tables(geom, cuda)
    tmax = torch.full_like(lo, 3.4e38)
    tmax[::17] = 0.0
    got = tt.intersect_matrix(o, d, lo, tmax, tables)
    torch.cuda.synchronize()
    ref = trf.intersect_matrix_ref(o, d, lo, tmax, tables.coeffs)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.cpu().numpy().view(np.int32),
                                      r.cpu().numpy().view(np.int32))
    assert (ref[1] >= 0).float().mean() > 0.5
    rays, (at, past) = _shadow_segments(o, d, lo, ref[:2])
    k6 = tt.occluded_matrix(*rays, tables)
    torch.cuda.synchronize()
    want = trf.occluded_matrix_ref(*rays, tables.coeffs)
    assert torch.equal(k6, want) and int(want[at].sum()) < int(want[past].sum())


def _tile_case(case: str):
    """(v0, e1, e2 [T, 3], o, d [R, 3], tmin, tmax [R]) as numpy f32 for
    the adversarial K7/K8 cases; T a multiple of 128, zero rows after the
    real triangles, R a multiple of no block, K7's rays a thread or K8's
    group."""
    rng = np.random.default_rng(17)
    n_rays = 5003
    if case == "det_edges":
        # triangle k: legs a_k and b_k along x and y, apart from the others
        # on the x axis, so det = a_k * b_k: a float apart on both sides of
        # the 1e-12 threshold (a = b), then from the subnormal (1e-40) to
        # 1e38; ray k straight down through (a/4, b/4) of it
        a = np.concatenate([1e-6 * (1 + np.arange(-48, 48) * 2.0 ** -22),
                            np.logspace(-20, 19, 160)])
        b = a * np.concatenate([np.ones(96), rng.uniform(0.5, 2.0, 160)])
        n_tris = a.size
        v0 = np.zeros((n_tris, 3))
        v0[1:, 0] = np.cumsum(8.0 + 2.0 * np.maximum(a, b))[:-1]
        e1 = np.zeros((n_tris, 3))
        e2 = np.zeros((n_tris, 3))
        e1[:, 0], e2[:, 1] = a, b
        k = rng.integers(0, n_tris, n_rays)
        o = np.stack([v0[k, 0] + a[k] / 4, b[k] / 4, np.ones(n_rays)], axis=1)
        d = np.tile([0.0, 0.0, -1.0], (n_rays, 1))
    else:
        n_tris = 8192 if case in ("streamed_ties", "last_streamed", "all_dead") else 384
        n_real = n_tris - 92
        v0 = rng.uniform(-2, 2, (n_tris, 3))
        e1 = rng.uniform(-1, 1, (n_tris, 3))
        e2 = rng.uniform(-1, 1, (n_tris, 3))
        o = rng.uniform(-4, 4, (n_rays, 3))
        d = rng.normal(size=(n_rays, 3))
        if case.startswith("last"):
            # every triangle far away but the last real one, a wide quad's
            # half across the rays' way: it alone occludes
            v0[:] = 50.0
            v0[n_real - 1], e1[n_real - 1], e2[n_real - 1] = ([-100, -100, 0], [300, 0, 0],
                                                              [0, 300, 0])
            o[:, 2] = rng.uniform(1, 3, n_rays)
            d[:, 2] = -np.abs(d[:, 2]) - 0.5
        if case == "streamed_ties":
            # one triangle at 2047 and 2048, either side of the first chunk
            # boundary, and at 4095 and 4096; a quarter of the rays aimed
            # at it, and rays i, i + 512, i + 1024, i + 1536 of each batch
            # of 2048 the same (one K7 thread's four rays)
            for j in (2047, 2048, 4095, 4096):
                v0[j], e1[j], e2[j] = [-1, -1, 5], [2, 0, 0], [0, 2, 0]
            aim = rng.uniform(size=n_rays) < 0.25
            o[aim] = np.stack([rng.uniform(-0.9, 0.9, aim.sum()),
                               rng.uniform(-0.9, 0.9, aim.sum()), np.full(aim.sum(), 9.0)], 1)
            d[aim] = [0.0, 0.0, -1.0]
            i = np.arange(n_rays)
            same = (i % 2048) >= 512
            src = i - 512 * ((i % 2048) // 512)
            o[same], d[same] = o[src[same]], d[src[same]]
        for k in (v0, e1, e2):
            k[n_real:] = 0.0
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(n_rays)
    tmax = np.full(n_rays, 3.4e38)
    tmax[::9] = 0.0
    if case == "all_dead":
        tmax[:] = tmin
    f32 = [np.asarray(x, np.float32) for x in (v0, e1, e2, o, d, tmin, tmax)]
    return f32[:3], f32[3:]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["streamed_ties", "last_streamed", "last_resident", "all_dead",
                                  "det_edges"])
def test_tile_kernels_adversarial(cuda, case):
    """K7 and K8 over the real rows against their twins over every lane:
    K7's t, tri, u, v bit-equal and K8's flags equal on every ray. The
    cases: 8192 triangles (two streamed chunks and more) with one triangle
    repeated either side of each chunk boundary, and one K7 thread's rays
    alike; only the last real triangle occluding, streamed and resident;
    every ray dead; det across the 1e-12 threshold, subnormal and huge."""
    from gatling_tpu_torch.ops import trace as tt
    from gatling_tpu_torch.ops import trace_ref as trf
    from gatling_tpu_torch.ops.geometry import SceneGeometry

    (v0, e1, e2), (o, d, tmin, tmax) = _tile_case(case)
    t = v0.shape[0]
    z3, z2, zi = np.zeros((t, 3), np.float32), np.zeros((t, 2), np.float32), np.zeros(t, np.int32)
    geom = SceneGeometry(v0=v0, e1=e1, e2=e2, n0=z3, n1=z3, n2=z3, t0=z3, t1=z3, t2=z3,
                         bsign=z3, uv0=z2, uv1=z2, uv2=z2, c0=z3, c1=z3, c2=z3, material_id=zi,
                         object_id=zi, face_id=zi, instance_id=zi, flags=zi)
    tiles = tt.build_tri_tiles(geom, cuda)
    layout = tt.kernel().layout()
    rays = [torch.tensor(x, device=cuda) for x in (o, d, tmin, tmax)]
    before = dict(tt.launches)
    k7 = tt.intersect_tiles(*rays, tiles)
    k8 = tt.occluded_tiles(*rays, tiles)
    torch.cuda.synchronize()
    assert tt.launches["K7"] == before["K7"] + 1 and tt.launches["K8"] == before["K8"] + 1
    ref7 = trf.intersect_tiles_ref(*rays, tiles.tris)
    ref8 = trf.occluded_tiles_ref(*rays, tiles.tris, first=True)
    for g, r in zip(k7, ref7):
        np.testing.assert_array_equal(g.cpu().numpy().view(np.int32),
                                      r.cpu().numpy().view(np.int32))
    assert torch.equal(k8, ref8 >= 0)
    live = rays[3] > rays[2]
    hits = int((ref7[1] >= 0).sum())
    if case == "all_dead":
        assert hits == 0 and not bool(k8.any())
    elif case == "streamed_ties":
        assert tiles.n_real > layout["resident_rows"]
        assert int((ref7[1] == 2047).sum()) > 500 and not bool((ref7[1] == 2048).any())
    elif case.startswith("last"):
        assert (tiles.n_real > layout["resident_rows"]) == (case == "last_streamed")
        assert bool((ref8[live] == tiles.n_real - 1).all()) and bool(k8[live].all())
    else:  # det_edges: valid and invalid on either side of the threshold
        det = e1[:, 0] * e2[:, 1]
        assert (det < 1e-38).any() and (det > 1e37).any()
        assert (det[:96] > 1e-12).any() and (det[:96] <= 1e-12).any()
        assert 0 < hits < int(live.sum())


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
def test_content_frame_matches_cpu(cuda, tmp_path):
    """A small USD content package (scene/examples.py write_content: six
    skinned figures of 8 x 12 quads and the ground, 1,154 triangles, a
    .usdz of the crate layer the port wrote; a checkerboard, a noise
    roughness and a two-texture multiply baked into the 8-bit pool, a
    frame-driven emission) through cli.render_scene_file at frame 12 on
    the card (K3 and K4) and through the twins on the CPU, the same
    samples: the means within 1 %, 98 % of pixels within 1e-3."""
    from gatling_tpu_torch import cli
    from gatling_tpu_torch.scene.examples import pack_usdz, write_content

    usdz = str(tmp_path / "content.usdz")
    pack_usdz(write_content(str(tmp_path), figures=6, rings=8, segments=12, joints=6,
                            tex_res=64), usdz)
    out = {}
    for device in (cuda, "cpu"):
        before = dict(tb.launches)
        img, scene = cli.render_scene_file(usdz, 48, 48, dict(spp=2, maxBounces=4, frame=12.0,
                                                              nextEventEstimation=True),
                                           device=str(device))
        assert scene._fused_static.textured and scene._texture_pool.packed
        if device != "cpu":
            assert tb.launches["K3"] > before["K3"] and tb.launches["K4"] > before["K4"]
        out[str(device)] = img[..., :3].copy()
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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows", ["identity", "permutation"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_onehot_product_matches_twin(cuda, mode, rows):
    """P2's kernels (TF32, FP32, 3xTF32) bit-equal to product_twin on one-hot
    rows: the probe's identity, and a permutation (each output row another
    row of x: the strips' staging, the padded strides and the fragments'
    indices show); one launch counted a call."""
    from gatling_tpu_torch import tools
    from gatling_tpu_torch.tools import precision_probe

    oh, x = precision_probe.probe_inputs(cuda)
    if rows == "permutation":
        oh = oh[torch.from_numpy(np.random.default_rng(mode).permutation(precision_probe.N))]
        oh = oh.to(cuda).contiguous()
    before = tools.launches["P2"]
    got = precision_probe.onehot_product(oh, x, mode)
    torch.cuda.synchronize()
    assert tools.launches["P2"] == before + 1
    twin = precision_probe.product_twin(oh.cpu(), x.cpu(), mode)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32), twin.numpy().view(np.int32))


@pytest.mark.requires_cuda
def test_onehot_product_rejects_bad_operands(cuda):
    """P2's wrapper raises before any launch on an operand on another
    device (the kernel would read a host pointer), a contiguous view that
    is not 16-byte aligned (its float4 reads) and a mode outside 0-2."""
    from gatling_tpu_torch import tools
    from gatling_tpu_torch.tools import precision_probe

    oh, x = precision_probe.probe_inputs(cuda)
    n = precision_probe.N
    shifted = torch.zeros(n * n + 1, device=cuda)[1:].view(n, n)
    before = tools.launches["P2"]
    for a, b, mode in ((oh, x.cpu(), 0), (oh, shifted, 1), (shifted, x, 2), (oh, x, 3)):
        with pytest.raises(ValueError):
            precision_probe.onehot_product(a, b, mode)
    assert tools.launches["P2"] == before


@pytest.mark.requires_cuda
@pytest.mark.parametrize("repeat", [False, True, "float"])
def test_opacity_tap_matches_twin(cuda, tmp_path, repeat):
    """retrace_kernel's opacity tap (TAP_OPACITY: the opacity slot and
    channel columns read from global memory) through one re-trace round on
    1,048,576 random rows, every ray alive: state rows 0-2 and the masked
    rows 0-2 and 13 bit-equal to retrace_round_ref's on every ray; every
    channel, every wrap mode (or all repeat: the 2x2 rows), thresholds on
    and off, one untextured material; one K4r launch. "float": the same
    over an EXR opacity texture (a float pool: the FLT instance, K4rf)."""
    from gatling_tpu_torch import imgio
    from gatling_tpu_torch.render import material as tmat
    from gatling_tpu_torch.render.texture import TextureRef

    rng = np.random.default_rng(23)
    png = str(tmp_path / "opacity.png")
    imgio.write_image_file(png, rng.integers(0, 256, (29, 17, 4)).astype(np.uint8))
    if repeat == "float":
        png = str(tmp_path / "opacity.exr")
        imgio.write_image_file(png, rng.uniform(0.0, 1.2, (29, 17, 4)).astype(np.float32))
    wraps = (["repeat"] * 4 if repeat is True else ["repeat", "clamp", "mirror", "black"])
    rows = []
    for k, ch in enumerate("rgba"):
        m = lower_material(None)
        m.textures["opacity"] = TextureRef(file_path=png, wrap_s=wraps[k],
                                           wrap_t=wraps[::-1][k], channel=ch,
                                           scale=(0.9, 1.1, 0.8, 1.2), bias=(0.05, -0.1, 0.1, 0.0))
        m.params.update(opacity_threshold=0.5 * (k % 2))
        rows.append(m)
    rows.append(lower_material(None))
    rows[-1].params.update(opacity=0.3)
    table, pool = tmat.build_materials(rows, device=cuda)
    mats = table.to(cuda)
    r = 1 << 20
    hit = np.zeros((16, r), np.float32)
    hit[0] = rng.random(r) < 0.9
    hit[2:4] = rng.uniform(-3.0, 4.0, (2, r))
    hit[4] = rng.integers(0, len(rows), r)
    hit[5:8] = rng.standard_normal((3, r))
    hit[13:16] = rng.normal(scale=30.0, size=(3, r))
    state = rng.normal(size=(16, r)).astype(np.float32)
    state[12] = rng.integers(0, 1 << 32, r, dtype=np.uint64).astype(np.uint32).view(np.float32)
    state[13] = 1.0
    hit, state = torch.tensor(hit, device=cuda), torch.tensor(state, device=cuda)
    key = "K4rf" if repeat == "float" else "K4r"
    assert pool.packed == (repeat != "float")
    got_s, got_m, want_s, want_m = (state.clone() for _ in range(4))
    before = tb.launches[key]
    tb.retrace_round(got_s, got_m, hit, mats, pool, ("opacity",), 0)
    assert tb.launches[key] == before + 1
    tb.retrace_round_ref(want_s, want_m, hit, mats, pool, ("opacity",), 0)
    torch.cuda.synchronize()
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))
    for k in (0, 1, 2, 13):
        assert torch.equal(got_m[k].view(torch.int32), want_m[k].view(torch.int32)), k
    # the tapped opacity decides: textured hits are rejected, the untextured never
    rejected = got_m[13] > 0.5
    assert 10000 < int(rejected.sum()) < int((hit[0] > 0.5).sum())
    assert not bool(rejected[hit[4] == len(rows) - 1].any())


def _opacity_tables(cuda, tmp_path, float_pool: bool):
    """test_opacity_tap_matches_twin's materials (every channel and wrap of
    an opacity texture, thresholds on and off, an untextured opacity of
    0.3), a base colour tapped on the odd ones; an EXR opacity texture with
    `float_pool`. Returns (device table, pool, textured parameters)."""
    from gatling_tpu_torch import imgio
    from gatling_tpu_torch.render import material as tmat
    from gatling_tpu_torch.render.texture import TextureRef

    rng = np.random.default_rng(29)
    png = str(tmp_path / "opacity.png")
    imgio.write_image_file(png, rng.integers(0, 256, (29, 17, 4)).astype(np.uint8))
    opac = png
    if float_pool:
        opac = str(tmp_path / "opacity.exr")
        imgio.write_image_file(opac, rng.uniform(0.0, 1.2, (29, 17, 4)).astype(np.float32))
    wraps = ["repeat", "clamp", "mirror", "black"]
    rows = []
    for k, ch in enumerate("rgba"):
        m = lower_material(None)
        m.textures["opacity"] = TextureRef(file_path=opac, wrap_s=wraps[k], wrap_t=wraps[::-1][k],
                                           channel=ch, scale=(0.9, 1.1, 0.8, 1.2),
                                           bias=(0.05, -0.1, 0.1, 0.0))
        if k % 2:
            m.textures["base_color"] = TextureRef(file_path=png, wrap_s=wraps[k])
        m.params.update(opacity_threshold=0.5 * (k % 2))
        rows.append(m)
    rows.append(lower_material(None))
    rows[-1].params.update(opacity=0.3)
    table, pool = tmat.build_materials(rows, device=cuda)
    assert pool.packed != float_pool
    return table.to(cuda), pool, ("base_color", "opacity")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rays", [1 << 20, (1 << 20) - 3])
@pytest.mark.parametrize("float_pool", [False, True])
def test_tap_rows_write_only_hit_rays(cuda, tmp_path, rays, float_pool):
    """tap_kernel into a buffer of sentinels: its 7 rows bit-equal to
    tap_rows_ref's on every hit ray, and every missed ray's values left as
    they were; R a multiple of the block's 128 rays and not."""
    mats, pool, active = _opacity_tables(cuda, tmp_path, float_pool)
    rng = np.random.default_rng(30)
    hit = np.zeros((16, rays), np.float32)
    hit[0] = rng.random(rays) < 0.8
    hit[2:4] = rng.uniform(-3.0, 4.0, (2, rays))
    hit[4] = rng.integers(0, mats.packed_f.shape[0], rays)
    hit[8:11] = rng.standard_normal((3, rays))
    hit = torch.tensor(hit, device=cuda)
    on = hit[0] > 0.5
    k = tb.kernel()
    mask = tb.tap_mask(tb.TAP_BITS["base_color"], hit.shape[0], pool)
    out = torch.full((tb.TAP_ROWS, rays), -7.0, device=cuda)
    k.call("gatling_tap_rows_flt" if float_pool else "gatling_tap_rows",
           mats.packed_f.data_ptr(), mats.packed_f.shape[0], hit.data_ptr(), rays,
           *k._tap_args(mats.packed_f, mats.packed_i, pool, mask), out.data_ptr(), k.stream(hit))
    want = tb.tap_rows_ref(hit, mats, pool, active)
    torch.cuda.synchronize()
    bad = (out.view(torch.int32) != want.view(torch.int32))[:, on]
    assert int(bad.sum()) == 0, int(bad.sum())
    assert bool((out[:, ~on] == -7.0).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rays", [1 << 20, (1 << 20) - 3])
@pytest.mark.parametrize("float_pool", [False, True])
def test_retrace_round_matches_twin(cuda, tmp_path, rays, float_pool):
    """retrace_round (K4r; K4rf over a float pool) against
    retrace_round_ref, three rounds on seeded state and hit rows: the
    state, masked rows 0-2 and 13 and the reject count bit-equal on every
    ray; one launch a round."""
    mats, pool, active = _opacity_tables(cuda, tmp_path, float_pool)
    rng = np.random.default_rng(31)
    hit = np.zeros((16, rays), np.float32)
    hit[0] = rng.random(rays) < 0.8
    hit[2:4] = rng.uniform(-3.0, 4.0, (2, rays))
    hit[4] = rng.integers(0, mats.packed_f.shape[0], rays)
    hit[5:8] = rng.standard_normal((3, rays))
    hit[13:16] = rng.normal(scale=30.0, size=(3, rays))
    state = rng.normal(size=(16, rays)).astype(np.float32)
    state[12] = rng.integers(0, 1 << 32, rays, dtype=np.uint64).astype(np.uint32).view(np.float32)
    state[13] = rng.choice(np.array([0.0, 1.0, 2.0, 0.25], np.float32), rays)
    hit, state = torch.tensor(hit, device=cuda), torch.tensor(state, device=cuda)
    key = "K4rf" if float_pool else "K4r"
    got_s, got_m = state.clone(), state.clone()
    want_s, want_m = state.clone(), state.clone()
    for rnd in range(3):
        before = tb.launches[key]
        tb.retrace_round(got_s, got_m, hit, mats, pool, active, rnd)
        assert tb.launches[key] == before + 1
        tb.retrace_round_ref(want_s, want_m, hit, mats, pool, active, rnd)
        torch.cuda.synchronize()
        assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32)), rnd
        for r in (0, 1, 2, 13):
            assert torch.equal(got_m[r].view(torch.int32), want_m[r].view(torch.int32)), (rnd, r)
        rejected = int((got_m[13] > 0.5).sum())
        assert rejected == int((want_m[13] > 0.5).sum()) and 10000 < rejected < rays // 2


@pytest.mark.requires_cuda
@pytest.mark.parametrize("what", ["first_hit", "clipping", "fog_first_hit"])
def test_peel_frames_match_twins(cuda, what, tmp_path):
    """The fused route's bounce-0 peel through gi.render on the card and
    through the twins on the CPU, the same samples (Cornell 48x48, 2 spp,
    3 bounces): K3, the taps and K4 at bounce 0, K1 after. fog_first_hit:
    the Cornell box with its fog block at mediumStackSize 1, whose peel
    shades in K4's absorption mode on the scatter mode's tables, K1 in the
    scatter mode after. First-hit AOVs equal within 1e-4 on 99 % of the
    pixels both hit; COLOR's mean within 1 %."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.cli import load_gi_scene
    from gatling_tpu_torch.interface import AovId
    from gatling_tpu_torch.scene import examples as ex

    first_hit = what != "clipping"
    aovs = ((AovId.COLOR, AovId.NORMAL, AovId.ALBEDO, AovId.DEPTH, AovId.TEXCOORDS)
            if first_hit else (AovId.COLOR,))
    settings = dict(spp=2, maxBounces=3, clippingPlanes=what == "clipping")
    path = CASES["cornell"][0]
    if what == "fog_first_hit":
        path = ex.cornell_fog(str(tmp_path))
        settings.update(mediumStackSize=1, nextEventEstimation=True)
    out = {}
    for dev in (cuda, "cpu"):
        scene, desc, merged = load_gi_scene(path, dev, settings)
        cam = desc.first_camera()
        if what == "clipping":
            cam.clip_start, cam.clip_end = 6.5, 100.0
        bufs = {a: gi.GiRenderBuffer(48, 48, 4) for a in aovs}
        before = dict(tb.launches)
        gi.render(gi.GiRenderParams(scene=scene, camera=cam, render_settings=merged,
                                    aov_bindings=[gi.GiAovBinding(a, b) for a, b in bufs.items()]))
        if dev == cuda:
            n = {k: tb.launches[k] - before[k] for k in tb.launches}
            peels = 2 if first_hit else 1  # one sample a wave, or the batch
            assert n["K3"] == n["K4"] == peels and n["K1"] > 0
            assert n["K4t"] == (peels if first_hit else 0), n
        assert scene._fused is not None
        if what == "fog_first_hit":
            assert scene._fused.volumes == tb.VOL_SCATTER, scene._fused.volumes
        out[str(dev)] = {a: b.data.copy() for a, b in bufs.items()}
    g, c = out[str(cuda)], out["cpu"]
    gc, cc = g[AovId.COLOR][..., :3], c[AovId.COLOR][..., :3]
    assert np.isfinite(gc).all() and abs(gc.mean() - cc.mean()) < 0.01 * cc.mean()
    for a in aovs[1:]:
        close = (np.abs(g[a] - c[a]) <= 1e-4 * np.maximum(1.0, np.abs(c[a]))).all(-1)
        assert close.mean() >= 0.99, (a, close.mean())
