"""UsdSkel skinning at load: the port's scene/skel.py against the JAX
package's, on the fixtures of tests/test_skel.py (rest pose, an animated
pose, a rigid constant binding, an unbound mesh, blend shapes, a skeleton
through a crate file) and on a small copy of chip_smoke.py's content
scene (4 influences a vertex, vertex normals, a blend shape). Skinning is
NumPy in both packages, so the points and normals the two loaders produce
are held bit for bit (tolerance 0), and the fixtures' absolute
expectations of tests/test_skel.py (atol 1e-4) hold for the port too."""

import numpy as np
import pytest

from gatling_tpu.scene import skel as jskel
from gatling_tpu.scene.stage import load_scene as jload_scene
from gatling_tpu.scene.usda import parse_usda as jparse_usda

from gatling_tpu_torch.scene import examples, skel
from gatling_tpu_torch.scene.crate import write_usdc
from gatling_tpu_torch.scene.stage import load_scene
from gatling_tpu_torch.scene.usda import parse_usda

from test_skel import SKEL_USDA

VERTEX = ('int[] primvars:skel:jointIndices = [0, 1, 1, 0] (\n'
          '            elementSize = 1\n'
          '            interpolation = "vertex"\n'
          '        )', 'float[] primvars:skel:jointWeights = [1, 1, 1, 1] (\n'
          '            elementSize = 1\n'
          '            interpolation = "vertex"\n'
          '        )')
RIGID = SKEL_USDA.replace(VERTEX[0], VERTEX[0].replace("[0, 1, 1, 0]", "[1]").replace(
    '"vertex"', '"constant"')).replace(VERTEX[1], VERTEX[1].replace(
        "[1, 1, 1, 1]", "[1]").replace('"vertex"', '"constant"'))
UNBOUND = SKEL_USDA.replace("rel skel:skeleton = </Root/Skel>\n", "")
BLEND = SKEL_USDA.replace(
    'rel skel:skeleton = </Root/Skel>',
    '''rel skel:skeleton = </Root/Skel>
        uniform token[] skel:blendShapes = ["puff"]
        rel skel:blendShapeTargets = [</Root/Strip/Puff>]
        def BlendShape "Puff"
        {
            uniform vector3f[] offsets = [(0, 0, 2)]
            uniform int[] pointIndices = [0]
        }''').replace(
    'half3[] scales.timeSamples = {',
    '''uniform token[] blendShapes = ["puff"]
            float[] blendShapeWeights.timeSamples = {
                1: [0],
                2: [0.5],
            }
            half3[] scales.timeSamples = {''')
# vertex and faceVarying normals on the strip: the inverse-transpose path
VNORMALS = SKEL_USDA.replace(
    "int[] faceVertexIndices = [0, 1, 2, 3]",
    'int[] faceVertexIndices = [0, 1, 2, 3]\n'
    '        normal3f[] normals = [(0, 0, 1), (0, 0.6, 0.8), (0.6, 0, 0.8), (0, 0, 1)] (\n'
    '            interpolation = "vertex"\n        )')
FVNORMALS = VNORMALS.replace('interpolation = "vertex"\n        )\n        int[] primvars',
                             'interpolation = "faceVarying"\n        )\n        int[] primvars', 1)
FIXTURES = {"skel": SKEL_USDA, "rigid": RIGID, "unbound": UNBOUND, "blend": BLEND,
            "vertex_normals": VNORMALS, "facevarying_normals": FVNORMALS}
EXPECT = {  # tests/test_skel.py's unique vertices at frames 1 and 2
    ("skel", 1.0): [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)],
    ("skel", 2.0): [(0, 0, 0), (0, 1, 0), (-1, 1, 0), (0, 1, 0)],
    ("rigid", 2.0): [(0, 0, 0), (0, 1, 0), (-1, 1, 0), (-1, 0, 0)],
    ("unbound", 2.0): [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)],
}


def _unique_vertices(desc):
    m = next(m for m in desc.meshes if m.path.endswith("Strip"))
    v = np.asarray(m.mesh.positions, np.float32).reshape(-1, 3)
    return np.unique(np.round(v, 4), axis=0)


def _same_meshes(port, ref):
    """Every mesh of the two scene descriptions: the per-corner positions,
    normals, tangents, uv and face ids equal bit for bit."""
    assert [m.path for m in port.meshes] == [m.path for m in ref.meshes]
    for a, b in zip(port.meshes, ref.meshes):
        for field in ("positions", "normals", "tangents", "uvs", "face_ids"):
            x, y = getattr(a.mesh, field), getattr(b.mesh, field)
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{a.path}.{field}")
        np.testing.assert_array_equal(np.asarray(a.transform), np.asarray(b.transform))


@pytest.mark.parametrize("frame", [1.0, 2.0])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_skinned_loads_match_jax(name, frame, tmp_path):
    f = tmp_path / f"{name}.usda"
    f.write_text(FIXTURES[name])
    port, ref = load_scene(str(f), frame=frame), jload_scene(str(f), frame=frame)
    _same_meshes(port, ref)
    if (name, frame) in EXPECT:
        expect = np.unique(np.round(np.asarray(EXPECT[name, frame], np.float32), 4), axis=0)
        np.testing.assert_allclose(_unique_vertices(port), expect, atol=1e-4)


def test_blend_shape_lifts_point_zero(tmp_path):
    """tests/test_skel.py test_blend_shape_offsets: zero weight at frame 1,
    point 0 lifted by 0.5 * 2 in z at frame 2."""
    f = tmp_path / "bs.usda"
    f.write_text(BLEND)
    assert (np.abs(_unique_vertices(load_scene(str(f), frame=1.0))[:, 2]) < 1e-4).all()
    v2 = _unique_vertices(load_scene(str(f), frame=2.0))
    lifted = v2[np.abs(v2[:, 2] - 1.0) < 1e-4]
    assert len(lifted) == 1
    np.testing.assert_allclose(lifted[0], [0, 0, 1], atol=1e-4)


@pytest.mark.parametrize("name", ["skel", "vertex_normals", "facevarying_normals", "blend"])
def test_maybe_skin_mesh_matches_jax(name):
    """maybe_skin_mesh on each package's own stage of the same text, at
    frame 2: points, normals and the skinned flag equal bit for bit."""
    from gatling_tpu.scene.usda import resolve_frame as jresolve
    from gatling_tpu_torch.scene.usda import resolve_frame

    text = FIXTURES[name]
    port, ref = parse_usda(text), jparse_usda(text)
    resolve_frame(port, 2.0)
    jresolve(ref, 2.0)
    prim, jprim = port.find("/Root/Strip"), ref.find("/Root/Strip")
    pts = np.asarray(prim.attrs["points"].value, np.float32)
    nattr = prim.attrs.get("normals")
    nrm = None if nattr is None else np.asarray(nattr.value, np.float32)
    fv = nattr is not None and nattr.meta.get("interpolation") == "faceVarying"
    assert (nattr is not None) == name.endswith("normals") and fv == name.startswith("face")
    corners = np.asarray(prim.attrs["faceVertexIndices"].value, np.int64) if fv else None
    got = skel.maybe_skin_mesh(port, prim, pts, nrm, corners)
    want = jskel.maybe_skin_mesh(ref, jprim, pts, nrm, corners)
    assert got[2] and want[2]
    np.testing.assert_array_equal(got[0], want[0])
    assert (want[1] is None) == (nrm is None)
    if want[1] is None:
        assert got[1] is None
    else:
        np.testing.assert_array_equal(got[1], want[1])


def test_skel_through_crate_matches_jax(tmp_path):
    """tests/test_skel.py test_skel_through_usdc_crate: the port's crate
    writer's file skins in both loaders as the text does."""
    p = tmp_path / "skel.usdc"
    p.write_bytes(write_usdc(parse_usda(SKEL_USDA, compose=False)))
    port, ref = load_scene(str(p), frame=2.0), jload_scene(str(p), frame=2.0)
    _same_meshes(port, ref)
    expect = np.unique(np.round(np.asarray(EXPECT["skel", 2.0], np.float32), 4), axis=0)
    np.testing.assert_allclose(_unique_vertices(port), expect, atol=1e-4)


@pytest.fixture(scope="module")
def small_content(tmp_path_factory):
    """chip_smoke.py's content scene cut to 4 figures of 8 x 12 quads and
    6 joints (4 influences a vertex, vertex normals, figure 0's blend
    shape), 64x64 textures; its .usda and .usdz paths."""
    d = tmp_path_factory.mktemp("content")
    usda = examples.write_content(str(d), figures=4, rings=8, segments=12, joints=6, tex_res=64)
    usdz = str(d / "content.usdz")
    examples.pack_usdz(usda, usdz)
    return usda, usdz


@pytest.mark.parametrize("frame", [1.0, 12.0])
@pytest.mark.parametrize("which", [0, 1])
def test_content_scene_skins_as_jax(small_content, which, frame):
    path = small_content[which]
    port, ref = load_scene(path, frame=frame), jload_scene(path, frame=frame)
    assert len(port.meshes) == 5 and sum(m.mesh.num_triangles for m in port.meshes) == 4 * 192 + 2
    _same_meshes(port, ref)
    rest = load_scene(small_content[0], frame=frame)
    if which == 1:  # the package's crate file skins as the text layer does
        for a, b in zip(port.meshes, rest.meshes):
            np.testing.assert_allclose(a.mesh.positions, b.mesh.positions, rtol=1e-6, atol=1e-6)
