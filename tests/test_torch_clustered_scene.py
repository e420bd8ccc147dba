"""The port's clustered and instanced scene tables against the JAX
package's builders, bit for bit.

Both packages get the same scenes, built on each side with its own scene
classes from the same NumPy arrays: the port's `clustered_arrays` /
`instanced_arrays` (ops/bounce.py) must give the JAX
`build_fused_scene_with_order` / `build_fused_scene_instanced` arrays:
the triangle order, the cluster table (compared in the JAX layout
[C, 40, 128]), the level-1 and level-2 boxes and the instance tables.
Also: the routing rule, a PointInstancer file reaching the instanced
route through the port's loader, the TLAS, and transform refits equal to
fresh builds.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import gatling_tpu.ops.geometry as jgeom
import gatling_tpu.ops.pallas_bounce as jpb
import gatling_tpu.render.lights as jlights
import gatling_tpu.render.material as jmat
import gatling_tpu.scene.examples as jex
import gatling_tpu.scene.meshproc as jmesh
import gatling_tpu.scene.stage as jstage

import gatling_tpu_torch.ops.geometry as tgeom
import gatling_tpu_torch.render.lights as tlights
import gatling_tpu_torch.render.material as tmat
import gatling_tpu_torch.scene.examples as tex
import gatling_tpu_torch.scene.meshproc as tmesh
import gatling_tpu_torch.scene.stage as tstage
from gatling_tpu_torch import gi
from gatling_tpu_torch.interface import AovId
from gatling_tpu_torch.ops import bounce as tb
from gatling_tpu_torch.ops.geometry import SceneGeometry

CORNELL = "tests/data/cornell.usda"
JAX = SimpleNamespace(mesh=jmesh, stage=jstage, ex=jex, geom=jgeom, mat=jmat, lights=jlights)
TORCH = SimpleNamespace(mesh=tmesh, stage=tstage, ex=tex, geom=tgeom, mat=tmat, lights=tlights)


def _sphere(lib, res: int):
    pts, counts, idx = jex._uv_sphere(res, res)
    return lib.mesh.build_triangulated_mesh(pts, counts, idx)


def _ground(lib, half: float = 6.0):
    gp = np.array([[-half, -half, 0], [half, -half, 0], [half, half, 0], [-half, half, 0]],
                  np.float32)
    return lib.mesh.build_triangulated_mesh(gp, np.array([4]), np.array([0, 1, 2, 3]))


def three_spheres(lib):
    """Three separate 128-triangle spheres in a row (tests/test_fused.py:217-225)."""
    sphere = _sphere(lib, 8)
    meshes = []
    for i, cx in enumerate((-3.0, 0.0, 3.0)):
        xf = np.eye(4)
        xf[3, :3] = [cx, 0.0, 0.0]
        meshes.append(lib.stage.MeshDesc(path=f"/s{i}", mesh=sphere, transform=xf,
                                         material=None, double_sided=False, object_id=i))
    return meshes, {}


def instanced_field(lib, stretch=(1.0, 0.7, 1.3)):
    """Four placements of one sphere under two materials, rotated and
    scaled (non-uniformly by default), over a double-sided ground (after
    tests/test_fused.py:682-732)."""
    sphere = _sphere(lib, 8)
    rng = np.random.default_rng(3)
    xfs = []
    for i in range(2):
        for j in range(2):
            s = rng.uniform(0.5, 1.2)
            th = rng.uniform(0, 2 * np.pi)
            rot = np.array([[np.cos(th), np.sin(th), 0], [-np.sin(th), np.cos(th), 0],
                            [0, 0, 1.0]])
            xf = np.eye(4)
            xf[:3, :3] = rot * (s * np.asarray(stretch))[:, None]
            xf[3, :3] = [i * 2.5 - 1.2, j * 2.5 - 1.2, s]
            xfs.append(xf)
    mats = {"/m0": dict(diffuseColor=(0.8, 0.2, 0.2), roughness=0.4),
            "/m1": dict(diffuseColor=(0.2, 0.4, 0.8), metallic=1.0, roughness=0.2),
            "/mg": dict(diffuseColor=(0.7, 0.7, 0.7), roughness=0.9)}
    meshes = [
        lib.stage.MeshDesc(path="/s0", mesh=sphere, transform=np.eye(4), material="/m0",
                           double_sided=False, object_id=0, instance_transforms=np.stack(xfs[:2])),
        lib.stage.MeshDesc(path="/s1", mesh=sphere, transform=np.eye(4), material="/m1",
                           double_sided=False, object_id=1, instance_transforms=np.stack(xfs[2:])),
        lib.stage.MeshDesc(path="/ground", mesh=_ground(lib), transform=np.eye(4),
                           material="/mg", double_sided=True, object_id=2),
    ]
    return meshes, mats


def big_mesh_pair(lib, stretch=True):
    """Two placements of a 4608-triangle sphere, squashed or stretched along
    z unless `stretch` is off: each placement spans three level-1 entries
    (pallas_bounce.py:954-955)."""
    sphere = _sphere(lib, 48)
    meshes = []
    for i, cx in enumerate((-1.5, 1.5)):
        xf = np.diag([1.0, 1.0, 0.8 + 0.3 * i if stretch else 1.0, 1.0])
        xf[3, :3] = [cx, 0.0, 1.0]
        meshes.append(lib.stage.MeshDesc(path=f"/b{i}", mesh=sphere, transform=xf,
                                         material="/m0", double_sided=False, object_id=i))
    return meshes, {"/m0": dict(diffuseColor=(0.6, 0.5, 0.4), roughness=0.5)}


SCENES = {"three_spheres": three_spheres, "instanced_field": instanced_field,
          "big_mesh_pair": big_mesh_pair}


def materials(lib, meshes, mats):
    """Material index and table of a scene (the gi layer's order)."""
    paths = sorted({m.material for m in meshes if m.material})
    midx = {p: i for i, p in enumerate(paths)}
    midx[None] = len(paths)
    rows = [None] * len(midx)
    for p, i in midx.items():
        desc = lib.ex._preview_material(p, **mats[p]) if p else None
        rows[i] = lib.mat.lower_material(desc)
    return midx, lib.mat.build_material_table(rows)


def scene_pair(name: str):
    """(JAX, port) meshes, material index and table of a named scene."""
    out = []
    for lib in (JAX, TORCH):
        if name == "cornell":
            desc = lib.stage.load_scene(CORNELL)
            meshes = desc.meshes
            paths = sorted({m.material for m in meshes if m.material})
            midx = {p: i for i, p in enumerate(paths)}
            midx[None] = len(paths)
            table = lib.mat.build_material_table(
                [lib.mat.lower_material(desc.materials.get(p) if p else None) for p in midx])
        else:
            meshes, mats = SCENES[name](lib)
            midx, table = materials(lib, meshes, mats)
        out.append((meshes, midx, table))
    return out


def port_flattened(geom, table):
    """The port's flattened clustered arrays and order of a geometry."""
    n_real = tb.real_triangles(geom)
    g = SceneGeometry(*[a[:n_real] for a in geom])
    order = tb.median_split_order(g, n_real)
    return tb.clustered_arrays(g, table, order), order


def assert_bits(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert got.dtype.itemsize == ref.dtype.itemsize, what
    np.testing.assert_array_equal(got.view(np.int32 if got.dtype.itemsize == 4 else got.dtype),
                                  ref.view(np.int32 if ref.dtype.itemsize == 4 else ref.dtype),
                                  err_msg=what)


def test_uv_sphere_and_sphere_field_match_jax():
    for res in (8, 24):
        for a, b in zip(tex._uv_sphere(res, res), jex._uv_sphere(res, res)):
            assert_bits(a, b, f"uv sphere {res}")
    t, j = tex.sphere_field(), jex.sphere_field()
    assert [m.path for m in t.meshes] == [m.path for m in j.meshes]
    for tm, jm in zip(t.meshes, j.meshes):
        assert_bits(tm.mesh.positions, jm.mesh.positions, tm.path)
        assert_bits(tm.mesh.normals, jm.mesh.normals, tm.path)
        if jm.instance_transforms is not None:
            np.testing.assert_array_equal(tm.instance_transforms, jm.instance_transforms)
    assert t.materials.keys() == j.materials.keys()
    for k in t.materials:
        tn = t.materials[k].nodes[t.materials[k].surface_node]
        jn = j.materials[k].nodes[j.materials[k].surface_node]
        assert tn.inputs == jn.inputs
    assert sum(m.mesh.num_triangles * len(m.instance_transforms)
               if m.instance_transforms is not None else m.mesh.num_triangles
               for m in t.meshes) == 294916


@pytest.mark.parametrize("name", ["cornell", "big_mesh_pair"])
def test_morton_order_matches_jax(name):
    """The Morton leaf order (the JAX package's alternative to the median
    split, which stays the default) gives JAX's permutation."""
    (jm, jidx, _jt), (tm, tidx, _tt) = scene_pair(name)
    jg = jgeom.build_geometry(jm, jidx)
    tg = tgeom.build_geometry(tm, tidx)
    n = tb.real_triangles(tg)
    np.testing.assert_array_equal(tb.morton_order(tg, n), jpb._morton_order(jg, n))


@pytest.mark.parametrize("name", ["cornell", "three_spheres", "instanced_field", "big_mesh_pair"])
def test_flattened_tables_match_jax(name):
    (jm, jidx, jtable), (tm, tidx, ttable) = scene_pair(name)
    jg = jgeom.build_geometry(jm, jidx)
    tg = tgeom.build_geometry(tm, tidx)
    ref, jstatic, jorder = jpb.build_fused_scene_with_order(jg, jtable, None, resident_max=0)
    got, order = port_flattened(tg, ttable)
    np.testing.assert_array_equal(order, jorder)
    assert_bits(got.tris, ref.tris, "tris")
    assert_bits(got.l1, ref.l1_aabbs, "l1")
    assert_bits(got.l2, ref.l2_aabbs, "l2")
    assert jstatic.n_l1 == got.l1.shape[1]
    # through the device tables: the JAX layout round-trips
    scene, static, order2 = tb.build_fused_scene_with_order(tg, ttable, None, "cpu",
                                                            resident_max=0)
    np.testing.assert_array_equal(order2, jorder)
    assert static.clustered and not static.instanced and static.n_l1 == jstatic.n_l1
    np.testing.assert_array_equal(
        scene.tris.numpy().reshape(-1, 128, 40).transpose(0, 2, 1), np.asarray(ref.tris))
    np.testing.assert_array_equal(scene.walk.l1.numpy().T, np.asarray(ref.l1_aabbs))


def _jax_instanced(meshes, midx, table, **kw):
    return jpb.build_fused_scene_instanced(meshes, midx, table, None, **kw)


@pytest.mark.parametrize("name", ["instanced_field", "big_mesh_pair"])
def test_instanced_tables_match_jax(name):
    (jm, jidx, jtable), (tm, tidx, ttable) = scene_pair(name)
    kw = dict(min_gain=1.5, min_flat=0)
    ref, jstatic = _jax_instanced(jm, jidx, jtable, **kw)
    got, counts = tb.instanced_arrays(tm, tidx, ttable, **kw)
    for field in ("tris", "inst_smem", "inst_map", "inst_attr"):
        assert_bits(getattr(got, field), getattr(ref, field), field)
    assert_bits(got.l1, ref.l1_aabbs, "l1")
    assert_bits(got.l2, ref.l2_aabbs, "l2")
    assert counts == dict(n_tris=jstatic.n_tris, n_clusters=jstatic.n_clusters,
                          n_l1=jstatic.n_l1, n_instances=jstatic.n_instances,
                          tangents=jstatic.tangents)
    if name == "big_mesh_pair":
        assert jstatic.n_l1 == 6  # 36 clusters a placement, 16 an entry


def test_sphere_field_instanced_tables_match_jax():
    """The full 294,916-triangle sphere_field, through both builders at their
    default routing: 256 placements + ground + sky -> 258 entries over 11
    unique clusters and the pad cluster."""
    results = []
    for lib in (JAX, TORCH):
        desc = lib.ex.sphere_field()
        mats = {p: {k: v for k, v in d.nodes[d.surface_node].inputs.items()}
                for p, d in desc.materials.items()}
        midx, table = materials(lib, desc.meshes, mats)
        results.append((desc.meshes, midx, table))
    (jm, jidx, jtable), (tm, tidx, ttable) = results
    ref, jstatic = _jax_instanced(jm, jidx, jtable)
    got, counts = tb.instanced_arrays(tm, tidx, ttable)
    assert counts == dict(n_tris=294916, n_clusters=11, n_l1=258, n_instances=258,
                          tangents=False)
    assert jstatic.n_clusters == 11 and jstatic.n_l1 == 258
    for field in ("tris", "inst_smem", "inst_map", "inst_attr"):
        assert_bits(getattr(got, field), getattr(ref, field), field)
    assert_bits(got.l1, ref.l1_aabbs, "l1")
    assert_bits(got.l2, ref.l2_aabbs, "l2")


def test_routing_rule_matches_jax():
    """The same scenes take the same route in both packages at the default
    thresholds: three spheres (384 triangles) stay flat; two placements of a
    4608-triangle mesh take the object walk; a single large mesh stays flat."""
    for name, expect in (("three_spheres", False), ("big_mesh_pair", True)):
        (jm, jidx, jtable), (tm, tidx, ttable) = scene_pair(name)
        assert (_jax_instanced(jm, jidx, jtable) is not None) == expect
        assert (tb.instanced_arrays(tm, tidx, ttable) is not None) == expect
    (jm, jidx, jtable), (tm, tidx, ttable) = scene_pair("big_mesh_pair")
    assert _jax_instanced(jm[:1], jidx, jtable) is None
    assert tb.instanced_arrays(tm[:1], tidx, ttable) is None


def test_tlas_covers_every_entry():
    """Every entry sits in exactly one leaf, every node box holds its
    children's, and the depth stays inside the kernel's stack."""
    rng = np.random.default_rng(11)
    lo = rng.uniform(-10, 10, size=(300, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2, size=(300, 3)).astype(np.float32)
    nodes, kids, leaf = tb.build_tlas(lo, hi)
    assert sorted(leaf.tolist()) == list(range(300))

    def visit(k, depth):
        if kids[k, 0] < 0:
            ent = leaf[-1 - kids[k, 0]:][:kids[k, 1]]
            assert 1 <= len(ent) <= tb.TLAS_LEAF
            assert (nodes[k, 0:3] <= lo[ent]).all() and (nodes[k, 3:6] >= hi[ent]).all()
            return depth
        d = 0
        for c in kids[k]:
            assert (nodes[k, 0:3] <= nodes[c, 0:3]).all() and (nodes[k, 3:6] >= nodes[c, 3:6]).all()
            d = max(d, visit(c, depth + 1))
        return d

    assert visit(0, 1) <= 11


def _grid_usda(path, n_inst: int, res: int) -> None:
    """A PointInstancer of `n_inst` copies of a res x res quad grid
    (2 res^2 triangles) in a .usda file (after tests/test_instancing.py:290-338)."""
    xs = np.linspace(-0.9, 0.9, res + 1)
    pts = ", ".join(f"({x:.4f}, {y:.4f}, 0)" for y in xs for x in xs)
    faces = []
    for j in range(res):
        for i in range(res):
            a = j * (res + 1) + i
            faces += [a, a + 1, a + res + 2, a + res + 1]
    pos = ", ".join(f"({i * 2.0}, 0, 0)" for i in range(n_inst))
    path.write_text(f"""#usda 1.0
def Xform "Root"
{{
    def PointInstancer "PI"
    {{
        point3f[] positions = [{pos}]
        int[] protoIndices = [{", ".join("0" for _ in range(n_inst))}]
        rel prototypes = [</Root/PI/Proto>]
        def Xform "Proto"
        {{
            def Mesh "Grid"
            {{
                int[] faceVertexCounts = [{", ".join("4" for _ in range(res * res))}]
                int[] faceVertexIndices = [{", ".join(str(f) for f in faces)}]
                point3f[] points = [{pts}]
            }}
        }}
    }}
}}
""")


def test_pointinstancer_file_takes_instanced_route(tmp_path):
    """6 placements of a 1152-triangle grid (6912 flattened triangles) load
    as one MeshDesc and render through the instance tables, as the JAX
    builder routes them."""
    path = tmp_path / "inst.usda"
    _grid_usda(path, 6, 24)
    desc = tstage.load_scene(path)
    assert len(desc.meshes) == 1 and desc.meshes[0].instance_transforms.shape[0] == 6
    jdesc = jstage.load_scene(path)
    assert _jax_instanced(jdesc.meshes, {None: 0},
                          jmat.build_material_table([jmat.lower_material(None)])) is not None

    scene = gi.create_scene("cpu")
    for m in desc.meshes:
        scene.add_mesh(m)
    cam = tstage.CameraDesc(position=np.array([5.0, -6.0, 6.0], np.float32),
                            forward=np.array([0.0, 0.7, -0.7], np.float32),
                            up=np.array([0.0, 0.7, 0.7], np.float32), vfov=0.9)
    buf = gi.GiRenderBuffer(8, 8, 4)
    gi.render(gi.GiRenderParams(scene=scene, camera=cam,
                                aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                                render_settings=dict(spp=1, maxBounces=2)))
    assert scene._fused_static.instanced and scene._fused_static.n_instances == 6
    assert scene._fused_static.n_clusters == 9  # 1152 / 128, and no padding
    assert np.isfinite(buf.data).all()


def _tables(fs):
    return [fs.tris, *fs.walk]


def _gi_params(scene):
    cam = tstage.CameraDesc(position=np.array([0.0, -9.0, 4.0], np.float32),
                            forward=np.array([0.0, 0.9, -0.4], np.float32),
                            up=np.array([0.0, 0.4, 0.9], np.float32), vfov=0.8)
    buf = gi.GiRenderBuffer(4, 4, 4)
    return gi.GiRenderParams(scene=scene, camera=cam,
                             aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                             render_settings=dict(spp=1, maxBounces=1))


@pytest.mark.parametrize("name", ["big_mesh_pair", "three_spheres"])
def test_transform_refit_equals_fresh_build(name, monkeypatch):
    """gi's transform-only refresh: moving one mesh refits the fused tables
    and the geometry, which equal fresh builds. Instanced: the instance
    tables are rebuilt over the cached unique clusters (no mesh is
    materialized again, the device cluster table is kept) and equal a
    build from scratch bit for bit. Flattened: the rows are refit under
    the cached order, and each triangle's row equals its row in a fresh
    build with its own order."""
    meshes, mats = SCENES[name](TORCH)
    scene = gi.create_scene("cpu")
    for m in meshes:
        scene.add_mesh(m)
    for p, kw in mats.items():
        scene.add_material(tex._preview_material(p, **kw))
    flat = name == "three_spheres"
    if flat:  # 384 triangles are resident at the default ceiling: force clusters
        orig = gi.build_fused_scene_with_order
        monkeypatch.setattr(gi, "build_fused_scene_with_order",
                            lambda *a, **k: orig(*a, **{**k, "resident_max": 0}))
    params = _gi_params(scene)
    gi.render(params)
    assert scene._fused_static.clustered and scene._fused_static.instanced != flat
    before = [t.clone() for t in _tables(scene._fused)]
    tris0, order0 = scene._fused.tris, scene._fused_order
    xf = np.array(scene.meshes[1].transform)
    xf[3, :3] += [0.4, -0.3, 0.2]
    scene.set_mesh_transform(scene.meshes[1], xf)
    assert scene.dirty & gi.DirtyFlags.TRANSFORMS
    if not flat:
        def no_materialize(mesh):
            raise AssertionError("a transform refit materialized a mesh")

        monkeypatch.setattr(tb, "materialize_mesh", no_materialize)
    gi.render(params)
    monkeypatch.undo()
    refit = scene._fused
    assert any(not torch.equal(a, b) for a, b in zip(before, _tables(refit)))
    fresh_geom = tgeom.build_geometry(scene.meshes, scene._material_index)
    for a, b in zip(scene._geom, fresh_geom):
        np.testing.assert_array_equal(a, b)
    if flat:
        np.testing.assert_array_equal(scene._fused_order, order0)
        fresh, _s, order = tb.build_fused_scene_with_order(
            fresh_geom, scene._material_table, scene._light_arrays, "cpu", resident_max=0)
        n = len(order)
        np.testing.assert_array_equal(refit.tris[:n][np.argsort(order0)].numpy(),
                                      fresh.tris[:n][np.argsort(order)].numpy())
    else:
        assert refit.tris is tris0
        fresh, _s = tb.build_fused_scene_instanced(
            scene.meshes, scene._material_index, scene._material_table,
            scene._light_arrays, "cpu")
        for a, b in zip(_tables(refit), _tables(fresh)):
            assert torch.equal(a, b)
