"""Procedural generators and baked composites in the port against the JAX
package.

1. render/procedural.py: every generator (`eval_generator` on each op,
   and the noises, hashes and masks under it) against the JAX module's on
   a uv grid that reaches past [0, 1) and below 0: bit for bit (the same
   NumPy arithmetic; tolerance 0).
2. Bakes: the graphs of tests/test_shadergraph.py (a checkerboard, noise
   driving roughness, a ramp, cell noise, a multiply of two PNG textures)
   and the other generators lowered from MaterialX documents by both
   packages into the same baked slot requests; `TextureManager._eval_bake`
   and the stored texels equal JAX's bit for bit, and so do the pools and
   material tables `build_materials` makes of them (an LDR composite as
   sRGB-encoded 8-bit codes, an HDR one as a float pool).
3. The port's pool taps a baked two-texture product at its texel centres
   within the 8-bit sRGB quantization of its store (tests/test_shadergraph.py
   test_two_texture_multiply_bakes_exact_composite's 2.5/255).
"""

import numpy as np
import pytest
import torch

from gatling_tpu import imgio as jimgio
from gatling_tpu.render import material as jmat
from gatling_tpu.render import procedural as jproc
from gatling_tpu.render import texture as jtex
from gatling_tpu.render.mtlx import parse_mtlx as jparse_mtlx
from gatling_tpu.render.shadergraph import Expr as JExpr

from gatling_tpu_torch.render import material as tmat
from gatling_tpu_torch.render import procedural as proc
from gatling_tpu_torch.render import texture as ttex
from gatling_tpu_torch.render.mtlx import parse_mtlx
from gatling_tpu_torch.render.shadergraph import Expr

from test_torch_textures import _check_tables

GEN_OPS = ("texcoord", "checkerboard", "ramplr", "ramptb", "ramp4", "noise2d", "noise3d",
           "fractal3d", "cellnoise2d", "cellnoise3d", "worleynoise2d", "worleynoise3d")


def _grid(h=48, w=64):
    u = np.linspace(-1.3, 2.7, w)[None, :] * np.ones((h, 1))
    v = np.linspace(-0.6, 3.1, h)[:, None] * np.ones((1, w))
    return u, v


@pytest.mark.parametrize("op", GEN_OPS)
def test_eval_generator_matches_jax(op):
    rng = np.random.default_rng(5)
    u, v = _grid()
    args = [rng.uniform(-0.5, 1.5, (48, 64, 4)) for _ in range(4)]
    for const in (None, (3.0, 5.0, 0.25, -0.5), (2.0, 3.0, 0.6, 0.0)):
        got = proc.eval_generator(op, const, args, u, v)
        want = jproc.eval_generator(op, const, args, u, v)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_noise_primitives_match_jax():
    u, v = _grid()
    z = np.full_like(u, 0.37)
    for name, call in (("perlin2", lambda m: m.perlin2(u, v, seed=3)),
                       ("perlin3", lambda m: m.perlin3(u, v, z)),
                       ("fractal3", lambda m: m.fractal3(u, v, z, 5, 2.1, 0.45)),
                       ("cellnoise2", lambda m: m.cellnoise2(u * 7, v * 7)),
                       ("cellnoise3", lambda m: m.cellnoise3(u * 7, v * 7, z)),
                       ("worley2", lambda m: m.worley2(u * 3, v * 3, 0.7)),
                       ("worley3", lambda m: m.worley3(u * 3, v * 3, z, 0.7)),
                       ("checkerboard_mask",
                        lambda m: m.checkerboard_mask(u, v, 6.0, 4.0, 0.5, 0.25))):
        np.testing.assert_array_equal(call(proc), call(jproc), err_msg=name)
    coords = np.arange(-50, 50)
    np.testing.assert_array_equal(proc._hash_u32(coords, coords * 7),
                                  jproc._hash_u32(coords, coords * 7))
    assert proc.PROC_BAKE_RES == jproc.PROC_BAKE_RES


def _doc(node: str, param: str = "base_color", out_type: str = "color3") -> str:
    return f"""<?xml version="1.0"?>
<materialx version="1.38">
  {node}
  <standard_surface name="SR" type="surfaceshader">
    <input name="{param}" type="{out_type}" nodename="gen" />
  </standard_surface>
</materialx>"""


DOCS = {  # tests/test_shadergraph.py's generators and the rest of the set
    "checkerboard": _doc('''<checkerboard name="gen" type="color3">
    <input name="in1" type="color3" value="1.0, 0.0, 0.0" />
    <input name="in2" type="color3" value="0.0, 0.0, 1.0" />
    <input name="uvtiling" type="vector2" value="4, 4" />
  </checkerboard>'''),
    "noise_roughness": _doc('''<noise2d name="gen" type="float">
    <input name="amplitude" type="float" value="1.0" />
    <input name="pivot" type="float" value="0.0" />
  </noise2d>''', "specular_roughness", "float"),
    "noise_ldr": _doc('''<noise2d name="gen" type="float">
    <input name="amplitude" type="float" value="0.25" />
    <input name="pivot" type="float" value="0.45" />
  </noise2d>''', "specular_roughness", "float"),
    "ramp4": _doc('''<ramp4 name="gen" type="color3">
    <input name="valuetl" type="color3" value="1, 0, 0" />
    <input name="valuetr" type="color3" value="0, 1, 0" />
    <input name="valuebl" type="color3" value="0, 0, 1" />
    <input name="valuebr" type="color3" value="1, 1, 1" />
  </ramp4>'''),
    "fractal": _doc('''<fractal3d name="gen" type="float">
    <input name="amplitude" type="float" value="0.3" />
    <input name="octaves" type="integer" value="4" />
  </fractal3d>''', "specular_roughness", "float"),
    "worley": _doc('''<worleynoise2d name="gen" type="float">
    <input name="jitter" type="float" value="0.6" />
  </worleynoise2d>''', "metalness", "float"),
    "cellnoise3d": _doc('<cellnoise3d name="gen" type="float" />', "metalness", "float"),
    "texcoord_clamp": _doc('''<texcoord name="tc" type="vector2" />
  <clamp name="gen" type="color3">
    <input name="in" type="color3" nodename="tc" />
    <input name="low" type="color3" value="0.2, 0.3, 0.0" />
    <input name="high" type="color3" value="0.8, 0.6, 1.0" />
  </clamp>'''),
}
PARAM = {"noise_roughness": "roughness", "noise_ldr": "roughness", "fractal": "roughness",
         "worley": "metallic", "cellnoise3d": "metallic"}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_mtlx_generator_bakes_match_jax(name):
    jrow = jmat.lower_material(jparse_mtlx(DOCS[name], name="proc"))
    trow = tmat.lower_material(parse_mtlx(DOCS[name], name="proc"))
    param = PARAM.get(name, "base_color")
    ref, jref = trow.textures[param], jrow.textures[param]
    assert ref.file_path == jref.file_path and ref.file_path.startswith("baked://")
    assert (ref.is_srgb, ref.wrap_s, ref.wrap_t, ref.channel) == (
        jref.is_srgb, jref.wrap_s, jref.wrap_t, jref.channel)
    assert trow.params == jrow.params
    tm, jm = ttex.TextureManager(), jtex.TextureManager()
    np.testing.assert_array_equal(tm._eval_bake(ref.bake), jm._eval_bake(jref.bake))
    (img, hdr), (jimg, jhdr) = tm._load_raw(ref), jm._load_raw(jref)
    assert hdr == jhdr and hdr == (name in ("noise_roughness", "fractal"))  # values below 0
    np.testing.assert_array_equal(img, jimg)
    _check_tables(*jmat.build_materials([jrow]), *tmat.build_materials([trow]))


def test_ramp_and_cellnoise_bakes_match_jax():
    """tests/test_shadergraph.py test_ramp_and_cellnoise_bake's Exprs,
    built in each package, through baked_ref and the pool."""
    def exprs(E):
        ramp = E(op="ramplr", args=(E(op="const", const=(0.0, 0.0, 0.0, 1.0)),
                                    E(op="const", const=(1.0, 1.0, 1.0, 1.0))))
        return ramp, E(op="cellnoise2d")

    for e, je in zip(exprs(Expr), exprs(JExpr)):
        ref, jref = ttex.baked_ref(e), jtex.baked_ref(je)
        pool, jpool = ttex.TextureManager().build_pool([ref]), jtex.TextureManager().build_pool(
            [jref])
        assert pool.packed and jpool.packed
        np.testing.assert_array_equal(pool.texels_u32.numpy().view(np.uint32),
                                      np.asarray(jpool.texels_u32))
        np.testing.assert_array_equal(pool.mean.numpy(), np.asarray(jpool.mean))
    row = ttex.TextureManager()._load_raw(ttex.baked_ref(exprs(Expr)[0]))[0][0, :, 0]
    assert row[0] < 0.05 and row[-1] > 0.95 and np.all(np.diff(row) >= 0)


@pytest.fixture(scope="module")
def two_pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("bake")
    rng = np.random.default_rng(7)
    paths = []
    for i, shape in enumerate(((4, 4), (8, 6))):
        img = np.zeros(shape + (4,), np.uint8)
        img[..., :3] = rng.integers(0, 256, size=shape + (3,))
        img[..., 3] = 255
        paths.append(str(d / f"bake_{i}.png"))
        jimgio.write_image_file(paths[-1], img)
    return paths


def _multiply_material(stage, paths, out="out"):
    def node(path, sid, inputs=None, conns=None):
        return stage.ShaderNode(path=path, shader_id=sid, inputs=inputs or {},
                                input_connections=conns or {})

    nodes = [node("/s", "UsdPreviewSurface", {}, {"diffuseColor": ("/mul", out)}),
             node("/mul", "multiply", {}, {"in1": ("/t", "out"), "in2": ("/t2", "out")}),
             node("/t", "image", {"file": paths[0]}), node("/t2", "image", {"file": paths[1]})]
    return stage.MaterialDesc(path="/m", surface_node="/s", nodes={n.path: n for n in nodes})


def test_two_texture_multiply_bakes_as_jax(two_pngs):
    """Two PNGs of different sizes: the composite bakes at the larger (the
    bilinear _resize of the smaller), bit for bit as JAX's; the port's
    sample_pool at the texel centres equals the per-texel product within
    the 8-bit sRGB store."""
    from gatling_tpu.scene import stage as jstage
    from gatling_tpu_torch.scene import stage as tstage

    jrow = jmat.lower_material(_multiply_material(jstage, two_pngs))
    trow = tmat.lower_material(_multiply_material(tstage, two_pngs))
    ref = trow.textures["base_color"]
    assert ref.bake.op == "multiply" and ref.file_path == jrow.textures["base_color"].file_path
    tm = ttex.TextureManager()
    np.testing.assert_array_equal(tm._resize(tm._load(ref.bake.args[0].tex), 8, 6),
                                  jtex.TextureManager()._resize(
                                      jtex.TextureManager()._load(
                                          jrow.textures["base_color"].bake.args[0].tex), 8, 6))
    (tt, tp), (jt, jp) = tmat.build_materials([trow], tm), jmat.build_materials([jrow])
    _check_tables(jt, jp, tt, tp)
    assert tp.packed and (tp.width.tolist(), tp.height.tolist()) == ([6], [8])
    xs, ys = np.meshgrid(np.arange(6), np.arange(8))
    uv = np.stack([(xs.ravel() + 0.5) / 6, 1.0 - (ys.ravel() + 0.5) / 8], -1).astype(np.float32)
    got = ttex.sample_pool(tp, torch.zeros(48, dtype=torch.int32), torch.as_tensor(uv)).numpy()
    a = tm._resize(tm._load(ref.bake.args[0].tex), 8, 6)
    b = tm._load(ref.bake.args[1].tex)
    np.testing.assert_allclose(got[:, :3], (a * b).reshape(-1, 4)[:, :3], atol=2.5 / 255.0)
