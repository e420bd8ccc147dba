"""View-, normal- and primvar-dependent material inputs in the port against
the JAX package.

A shader graph with a `viewdirection`, `normal` or named primvar-reader
leaf lowers into an exact expression (render/shadergraph.py Expr,
`LoweredMaterial.dynamic`), which the wavefront integrator evaluates at
every hit (`eval_dynamic_expr`) in place of the material's constant.
Inputs are made with numpy from seeds and handed to both packages:

1. `eval_dynamic_expr` on every op (const, viewdir, normalvec, a primvar
   with and without its table, dot, multiply, divide by 0, add, subtract,
   mix, clamp, abs, power, extract) against the JAX evaluator on 4,096
   hits: within rtol 1e-6 / atol 1e-7 (XLA's and PyTorch's pow and sums
   may round the last bit apart);
2. `lower_material` on Materials.MtlxViewDirection's material (the golden's
   own scene through both stage loaders) and on the cases of
   tests/test_primvar_materials.py (displayColor and an instance-rate
   primvar read into the base colour; a bound material with its own
   colour): the same parameters bit for bit, the same `dynamic` keys, and
   expressions that evaluate equal, as in 1.;
3. a static composite lowers to the JAX package's baked slot request
   (abs and dot, which its baker does not evaluate, raise at the pool
   build in both); gi's route: a
   dynamic input takes the wavefront, one whose primvar no mesh carries
   stays static (the fused kernels), a displayColor read counts as vertex
   colours;
4. the furnace of tests/test_primvar_materials.py (displayColor read into
   the base colour) through the port's render_pixels and the JAX one, the
   same samples: tests/test_torch_wavefront.py's whole-frame tolerances
   (1e-3 on 98 % of pixels, the means within 1 %) and the primvar's colour
   within the JAX test's rtol 0.06;
5. an instance-rate primvar (tests/test_primvar_materials.py:111, two
   instances of one plane tinted by their own `myTint`) through the port's
   gi.render and gatling_tpu.gi.render, 16x16, 4 spp, 2 bounces, NEE with a
   rect light: the whole-frame tolerances, and each half its instance's
   tint.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatling_tpu import gi as jgi
from gatling_tpu.interface import AovId as JAovId
from gatling_tpu.render import material as jmat
from gatling_tpu.render import shadergraph as jsg
from gatling_tpu.scene import meshproc as jmeshproc
from gatling_tpu.scene import stage as jstage
from gatling_tpu.utils import config as jconfig

from gatling_tpu_torch import gi
from gatling_tpu_torch.interface import AovId, aov_bit
from gatling_tpu_torch.ops.geometry import build_instance_primvar_tables
from gatling_tpu_torch.render import material as tmat
from gatling_tpu_torch.render import shadergraph as tsg
from gatling_tpu_torch.scene import meshproc, stage
from gatling_tpu_torch.utils import config

from test_torch_backface import assert_frames_close, furnace_pair
from test_torch_bounce import rect_light
from test_torch_bvh import one_thread  # noqa: F401 (an autouse fixture)

N = 4096
VIEW_DIRECTION = Path(__file__).parent / "graphical" / "Materials.MtlxViewDirection" / "scene.usda"


def _to_jax(e: tsg.Expr) -> jsg.Expr:
    return jsg.Expr(op=e.op, const=e.const, tex=e.tex, args=tuple(_to_jax(a) for a in e.args),
                    channel=e.channel)


def _inputs(seed: int = 0):
    """View directions, normals (some components exactly 0, for the
    divide's zero case) and one primvar table's values, [N, 3] each."""
    rng = np.random.default_rng(seed)
    vd = rng.normal(size=(N, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    nrm = rng.normal(size=(N, 3)).astype(np.float32)
    nrm[::5, 1] = 0.0
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tint = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return vd, nrm, {"myTint": tint}


def _evaluate_both(expr: tsg.Expr, seed: int = 0):
    vd, nrm, pv = _inputs(seed)
    got = tsg.eval_dynamic_expr(expr, torch.as_tensor(vd), torch.as_tensor(nrm),
                                {k: torch.as_tensor(v) for k, v in pv.items()}).numpy()
    ref = np.asarray(jsg.eval_dynamic_expr(_to_jax(expr), jnp.asarray(vd), jnp.asarray(nrm),
                                           {k: jnp.asarray(v) for k, v in pv.items()}))
    return got, ref


E = tsg.Expr
VD, NRM = E(op="viewdir"), E(op="normalvec")
PV = E(op="primvar", channel="myTint", const=(0.5, 0.5, 0.5, 1.0))
PV_MISSING = E(op="primvar", channel="nowhere", const=(0.25, 0.5, 0.75, 1.0))
DOT = E(op="dot", args=(VD, NRM))
OPS = {
    "const": tsg._const_expr((0.1, -0.2, 0.3, 1.0)),
    "viewdir": VD,
    "normalvec": NRM,
    "primvar": PV,
    "primvar_without_table": PV_MISSING,
    "dot": DOT,
    "multiply": E(op="multiply", args=(VD, tsg._const_expr((2.0, 0.5, -1.0, 1.0)))),
    "divide_by_zero": E(op="divide", args=(VD, NRM)),
    "add": E(op="add", args=(VD, PV)),
    "subtract": E(op="subtract", args=(NRM, PV)),
    "mix": E(op="mix", args=(VD, PV, E(op="abs", args=(DOT,)))),
    "clamp": E(op="clamp", args=(DOT, tsg._const_expr(-0.2), tsg._const_expr(0.5))),
    "abs": E(op="abs", args=(VD,)),
    "power": E(op="power", args=(E(op="abs", args=(DOT,)), tsg._const_expr(3.0))),
    "power_of_negative": E(op="power", args=(DOT, tsg._const_expr(2.5))),
    "extract": E(op="extract", channel="g", args=(VD,)),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_eval_dynamic_expr_matches_jax(op):
    got, ref = _evaluate_both(OPS[op])
    assert got.shape == ref.shape == (N, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    if op == "divide_by_zero":
        assert (got[::5, 1] == 0).all()


def _material(pkg, path, nodes):
    """A MaterialDesc of `pkg`'s stage module from (name, shader id,
    inputs, {input: source name}) node specs, the first the surface."""
    def node(name, sid, inputs, links):
        return pkg.ShaderNode(path=f"{path}/{name}", shader_id=sid, inputs=dict(inputs),
                              input_connections={k: (f"{path}/{v}", "out")
                                                 for k, v in links.items()})

    built = [node(*spec) for spec in nodes]
    return pkg.MaterialDesc(path=path, surface_node=built[0].path,
                            nodes={n.path: n for n in built})


PRIMVAR_CASES = {
    "displayColor": [("s", "UsdPreviewSurface", {}, {"diffuseColor": "pv"}),
                     ("pv", "UsdPrimvarReader_float3",
                      {"varname": "displayColor", "fallback": (0.5, 0.5, 0.5)}, {})],
    "myTint": [("s", "UsdPreviewSurface", {}, {"diffuseColor": "pv"}),
               ("pv", "UsdPrimvarReader_float3",
                {"varname": "myTint", "fallback": (0.5, 0.5, 0.5)}, {})],
    "own_colour": [("s", "UsdPreviewSurface", {"diffuseColor": (0.6, 0.6, 0.6)}, {})],
}


def _lowered(case: str):
    if case == "MtlxViewDirection":
        jdesc, tdesc = jstage.load_scene(str(VIEW_DIRECTION)), stage.load_scene(str(VIEW_DIRECTION))
        (jm,), (tm,) = jdesc.materials.values(), tdesc.materials.values()
        return jmat.lower_material(jm), tmat.lower_material(tm)
    spec = PRIMVAR_CASES[case]
    return (jmat.lower_material(_material(jstage, "/m", spec)),
            tmat.lower_material(_material(stage, "/m", spec)))


@pytest.mark.parametrize("case", ["MtlxViewDirection", *PRIMVAR_CASES])
def test_lower_material_dynamic_matches_jax(case):
    jrow, trow = _lowered(case)
    assert set(trow.params) == set(jrow.params)
    for k, v in trow.params.items():
        assert np.array_equal(np.asarray(v, np.float64), np.asarray(jrow.params[k], np.float64)), k
    assert set(trow.dynamic) == set(jrow.dynamic) and set(trow.textures) == set(jrow.textures)
    expect = {"MtlxViewDirection": {"emissive"}, "own_colour": set()}.get(case, {"base_color"})
    assert set(trow.dynamic) == expect
    for k, expr in trow.dynamic.items():
        assert _to_jax(expr) == jrow.dynamic[k], k  # the same tree, leaf for leaf
        got, ref = _evaluate_both(expr, seed=3)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    jt, tt = jmat.build_material_table([jrow]), tmat.build_material_table([trow])
    np.testing.assert_array_equal(tt.packed_f.view(np.int32), np.asarray(jt.packed_f).view(np.int32))


def test_static_composites_still_raise():
    """What the JAX package bakes into a composite texture lowers as there:
    two textures in one multiply, abs over a texture and a dot of two
    constants become a baked slot's request; the multiply builds the JAX
    pool bit for bit, and abs and dot, which the JAX baker does not
    evaluate, raise its ValueError at the pool build in both packages.
    (The name dates from when these raised at lowering.)"""
    tex = ("tex", "UsdUVTexture", {"file": "a.png"}, {})
    tex2 = ("tex2", "UsdUVTexture", {"file": "b.png"}, {})
    for spec, param, op in (
            ([("s", "UsdPreviewSurface", {}, {"diffuseColor": "mul"}),
              ("mul", "ND_multiply_color3", {}, {"in1": "tex", "in2": "tex2"}), tex, tex2],
             "base_color", "multiply"),
            ([("s", "UsdPreviewSurface", {}, {"roughness": "abs"}),
              ("abs", "ND_absval_float", {}, {"in": "tex"}), tex], "roughness", "abs"),
            ([("s", "UsdPreviewSurface", {}, {"roughness": "dot"}),
              ("dot", "ND_dotproduct_vector3", {"in1": (1, 0, 0), "in2": (0, 1, 0)}, {})],
             "roughness", "dot")):
        jrow = jmat.lower_material(_material(jstage, "/m", spec))
        trow = tmat.lower_material(_material(stage, "/m", spec))
        ref, jref = trow.textures[param], jrow.textures[param]
        assert ref.bake.op == jref.bake.op == op and not trow.dynamic and not jrow.dynamic
        assert ref.file_path.startswith("baked://") and jref.file_path.startswith("baked://")
        if op == "multiply":
            jt, jp = jmat.build_materials([jrow])
            tt, tp = tmat.build_materials([trow])
            np.testing.assert_array_equal(tt.packed_f, np.asarray(jt.packed_f))
            np.testing.assert_array_equal(tp.texels_u32.numpy().view(np.uint32),
                                          np.asarray(jp.texels_u32))
            continue
        for lib in (jmat, tmat):
            with pytest.raises(ValueError, match=f"unbakeable shader expr op: {op}"):
                lib.build_materials([jrow if lib is jmat else trow])


def _quad_scene(material, colors=None):
    scene = gi.create_scene("cpu")
    pts = np.array([[-1, -1, 0], [1, -1, 0], [-1, 1, 0], [1, 1, 0]], np.float32)
    mesh = meshproc.build_triangulated_mesh(pts, np.array([4]), np.array([0, 1, 3, 2]),
                                            colors=colors)
    scene.add_mesh(stage.MeshDesc(path="/q", mesh=mesh, transform=np.eye(4), material="/m",
                                  double_sided=True, object_id=0))
    scene.add_material(material)
    scene.add_light(stage.LightDesc(**dataclasses.asdict(rect_light())))
    return scene


def _gi_color(scene):
    cam = stage.CameraDesc(position=np.array([0, 0, 3], np.float32),
                           forward=np.array([0, 0, -1], np.float32),
                           up=np.array([0, 1, 0], np.float32), vfov=0.8)
    buf = gi.GiRenderBuffer(8, 8, 4)
    params = gi.GiRenderParams(scene=scene, camera=cam, aov_bindings=[gi.GiAovBinding(
        AovId.COLOR, buf)], render_settings=dict(spp=1, maxBounces=2, nextEventEstimation=True))
    gi.render(params)
    assert np.isfinite(buf.data).all()
    return gi._build_config(params, 8, 8, aov_bit(AovId.COLOR))


def test_gi_routes_dynamic_inputs():
    """A view-dependent input takes the wavefront for COLOR alone; a primvar
    no mesh carries keeps its fallback and the fused route; a displayColor
    read over a mesh with colours takes the wavefront as vertex colours."""
    view = stage.load_scene(str(VIEW_DIRECTION))
    (mat,) = view.materials.values()
    scene = _quad_scene(dataclasses.replace(mat, path="/m"))
    config = _gi_color(scene)
    assert scene._accel is not None and scene._fused is None
    assert [(i, p) for i, p, _e in config.dynamic_params] == [(0, "emissive")]

    scene = _quad_scene(_material(stage, "/m", PRIMVAR_CASES["myTint"]))
    config = _gi_color(scene)
    assert config.dynamic_params == () and scene._fused is not None and scene._accel is None

    colors = np.array([[0.1, 0.8, 0.3]], np.float32)
    scene = _quad_scene(_material(stage, "/m", PRIMVAR_CASES["displayColor"]), colors=colors)
    assert gi._uses_vertex_colours(scene) is False  # nothing lowered yet
    config = _gi_color(scene)
    assert gi._uses_vertex_colours(scene) and scene._accel is not None
    assert [p for _i, p, _e in config.dynamic_params] == ["base_color"]


def _coloured_plane(pkg):
    """tests/test_primvar_materials.py's plane, its displayColor one
    uniform green."""
    stage_, meshproc_ = pkg
    pts = np.array([[-50, -50, 0], [50, -50, 0], [-50, 50, 0], [50, 50, 0]], np.float32)
    mesh = meshproc_.build_triangulated_mesh(
        pts, np.array([4]), np.array([0, 1, 3, 2]), colors=np.array([[0.1, 0.8, 0.3]], np.float32),
        colors_interp=meshproc_.Interpolation.UNIFORM)
    return [stage_.MeshDesc(path="/p", mesh=mesh, transform=np.eye(4), material="m",
                            double_sided=True, object_id=0)]


def test_displaycolor_furnace_matches_jax():
    jrow, trow = _lowered("displayColor")
    jrow.params["ior"] = trow.params["ior"] = 1.0  # no Fresnel lobe: a Lambert furnace
    (ref, got), = furnace_pair(
        jrow, trow, (([0, 0, 4.0], [0, 0, -1]),), mesh_pkgs=_coloured_plane,
        jax_config=dict(dynamic_params=((0, "base_color", jrow.dynamic["base_color"]),)),
        port_config=dict(dynamic_params=((0, "base_color", trow.dynamic["base_color"]),)))
    assert_frames_close(got, ref, "displayColor furnace")
    np.testing.assert_allclose(got.reshape(8, 8, 3)[2:6, 2:6].mean(axis=(0, 1)), (0.1, 0.8, 0.3),
                               rtol=0.06)


def _tinted_instances(pkg):
    """tests/test_primvar_materials.py:111: one plane, two instances (left
    and right of the view), each its own myTint."""
    gi_, stage_, meshproc_, config_, aov = pkg
    pts = np.array([[-50, -50, 0], [50, -50, 0], [-50, 50, 0], [50, 50, 0]], np.float32)
    mesh = meshproc_.build_triangulated_mesh(pts, np.array([4]), np.array([0, 1, 3, 2]))
    xf_l, xf_r = np.eye(4), np.eye(4)
    xf_l[0, 0] = xf_r[0, 0] = 0.02
    xf_l[3, 0], xf_r[3, 0] = -1.0, 1.0
    tints = np.array([[0.9, 0.1, 0.1], [0.1, 0.1, 0.9]], np.float32)
    scene = gi_.create_scene(**({} if gi_ is jgi else {"device": "cpu"}))
    scene.add_mesh(stage_.MeshDesc(path="/p", mesh=mesh, transform=np.eye(4), material="/m",
                                   double_sided=True, object_id=0,
                                   instance_transforms=np.stack([xf_l, xf_r]),
                                   instance_primvars={"myTint": tints}))
    mat = _material(stage_, "/m", PRIMVAR_CASES["myTint"])
    scene.add_material(mat)
    light = rect_light()
    xf = np.array(light.transform)
    xf[3, :3] = [0.0, 0.0, 2.0]
    scene.add_light(stage_.LightDesc(light.path, light.light_type, xf,
                                     dict(light.params, width=4.0, height=4.0)))
    cam = stage_.CameraDesc(position=np.array([0, 0, 4.0], np.float32),
                            forward=np.array([0, 0, -1], np.float32),
                            up=np.array([0, 1, 0], np.float32), vfov=0.5)
    buf = gi_.GiRenderBuffer(16, 16, 4)
    gi_.render(gi_.GiRenderParams(scene=scene, camera=cam, aov_bindings=[gi_.GiAovBinding(
        aov.COLOR, buf)], render_settings=dict(config_.default_settings(), spp=4, maxBounces=2,
                                               nextEventEstimation=True)))
    return buf.data[..., :3], scene


def test_instance_rate_primvar_matches_jax():
    ref, _ = _tinted_instances((jgi, jstage, jmeshproc, jconfig, JAovId))
    got, scene = _tinted_instances((gi, stage, meshproc, config, AovId))
    assert scene._accel is not None and scene._fused is None  # the dynamic input's route
    tables = build_instance_primvar_tables(scene.meshes)
    np.testing.assert_array_equal(tables["myTint"], np.float32([[0.9, 0.1, 0.1], [0.1, 0.1, 0.9]]))
    assert_frames_close(got.reshape(-1, 3), ref.reshape(-1, 3), "instance-rate myTint")
    left, right = got[4:12, 2:6].mean(axis=(0, 1)), got[4:12, 10:14].mean(axis=(0, 1))
    print(f"left {left}, right {right}")
    assert left[0] > 3 * left[2] and right[2] > 3 * right[0]
