"""The wavefront's tracer above 8192 triangles against the JAX package's.

The port carries the JAX package's threaded BVH (gatling_tpu/ops/bvh.py)
as a NumPy copy (gatling_tpu_torch/ops/bvh.py build_bvh) and its walk
`traverse` as the twins of the kernels B1 and B2 (ops/trace_ref.py
intersect_threaded_ref, occluded_threaded_ref; the kernels are held
against them on the card, tests/test_torch_cuda.py and chip_smoke.py).
Inputs are made with numpy from seeds:

1. the build on a random soup of 3,000 triangles, the padded Cornell soup
   and an 8,450-triangle quad grid: every array and the triangle order
   equal to the JAX package's;
2. the twins against `traverse_closest` / `traverse_occluded` on 4,096
   random rays a soup (some with tmin > 0, a finite tmax, or dead): tri
   equal on at least 99.9 % of rays, t, u, v within rtol 1e-5 / atol 1e-6
   where it is, the flags equal on at least 99.9 % (they are equal on
   every ray; t, u, v differ by the last bits of XLA's arithmetic);
3. the twins against the port's brute-force Moller-Trumbore
   (ops/intersect.py) over the reordered soup: the same rule on every
   ray but the boxes' (unpadded, as the JAX package's), so tri and the
   flags equal on at least 99.9 %, t within rtol 1e-5 / atol 1e-6;
4. `gi.render` of the 8,450-triangle grid (16x16, 2 spp, 3 bounces, NEE,
   FACE_ID and COLOR) against `gatling_tpu.gi.render` on the CPU, which
   takes its BVH tracer above 2,048 triangles: both walk the same tree;
   the tolerances of test_torch_wavefront.py's whole frame: ids equal on
   99 % of pixels, COLOR within 1e-3 on 98 % and its mean within 1 %;
5. the wide rows B1 and B2 walk (ops/bvh.py wide_rows) on the three soups
   and on the adversarial lattice of tests/threaded_soups.py, against a
   collapse of the binary tree written out here: every child's box a
   binary node's, bit for bit, inside its parent's, the leaves in the
   binary preorder, each triangle once; no rows where the walk could not
   take them;
6. the model of the kernels' walk of the wide rows (trace_ref.wide_work)
   against `traverse_closest` / `traverse_occluded` and the twins on the
   same rays, and on the lattice's adversarial rays: t, tri, u, v and the
   flags bit-equal to the twins and to the JAX walk on every ray (a zero
   u or v's sign included).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatling_tpu import gi as jgi
from gatling_tpu.ops import bvh as jbvh
from gatling_tpu.ops.geometry import SceneGeometry as JSceneGeometry
from gatling_tpu.scene import meshproc as jmeshproc
from gatling_tpu.scene import stage as jstage
from gatling_tpu.utils import config as jconfig

from gatling_tpu_torch import gi
from gatling_tpu_torch.interface import FLOAT_MAX, AovId
from gatling_tpu_torch.ops import bvh as tbvh
from gatling_tpu_torch.ops import trace as tt
from gatling_tpu_torch.ops import trace_ref as trf
from gatling_tpu_torch.ops.geometry import SceneGeometry, build_geometry
from gatling_tpu_torch.ops.intersect import intersect_brute, occluded_brute
from gatling_tpu_torch.scene import meshproc, stage
from gatling_tpu_torch.scene.stage import load_scene
from gatling_tpu_torch.utils import config

from test_torch_bounce import CORNELL, rect_light
from test_torch_bvh import one_thread  # noqa: F401 (an autouse fixture)
from threaded_soups import lattice_rays, lattice_soup

N_RAYS = 4096


def _random_soup(n: int = 3000) -> SceneGeometry:
    rng = np.random.default_rng(11)
    v0 = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e1, e2 = (rng.normal(0, 0.5, (n, 3)).astype(np.float32) for _ in range(2))
    z3, z2, zi = np.zeros((n, 3), np.float32), np.zeros((n, 2), np.float32), np.zeros(n, np.int32)
    return SceneGeometry(v0, e1, e2, z3, z3, z3, z3, z3, z3, z3, z2, z2, z2, z3, z3, z3,
                         zi, zi, zi, zi, zi)


def _grid_mesh(pkg, n: int):
    """An n x n grid of quads (2 n^2 triangles) in the z=0 plane, as
    tests/test_torch_render.py _quad_grid_mesh, through `pkg`'s (stage,
    meshproc) modules."""
    stage_, meshproc_ = pkg
    xs = np.linspace(-1, 1, n + 1, dtype=np.float32)
    px, py = np.meshgrid(xs, xs, indexing="ij")
    pts = np.stack([px.ravel(), py.ravel(), np.zeros(px.size, np.float32)], axis=1)
    i = np.arange(n)
    a = (i[:, None] * (n + 1) + i[None, :]).ravel()
    idx = np.stack([a, a + n + 1, a + n + 2, a + 1], axis=1).ravel()
    return stage_.MeshDesc(path="/grid", mesh=meshproc_.build_triangulated_mesh(
        pts, np.full(n * n, 4), idx), transform=np.eye(4), material=None, double_sided=False,
        object_id=0)


def _soup(name: str) -> SceneGeometry:
    if name == "random3000":
        return _random_soup()
    if name == "lattice":
        return lattice_soup(LATTICE_CELLS)
    if name == "cornell":
        desc = load_scene(CORNELL)
        paths = sorted({m.material for m in desc.meshes if m.material})
        midx = {p: i for i, p in enumerate(paths)}
        midx[None] = len(paths)
        return build_geometry(desc.meshes, midx)
    return build_geometry([_grid_mesh((stage, meshproc), 65)], {None: 0})


SOUPS = ("random3000", "cornell", "grid8450")
LATTICE_CELLS = 8  # tests/threaded_soups.py lattice_soup: 3,456 triangles


def _rays(geom: SceneGeometry, seed: int):
    """N_RAYS rays from random points of the soup's box grown by a third,
    in random directions; every 7th with tmin > 0, every 5th a finite
    tmax, every 13th dead (tmax = 0)."""
    rng = np.random.default_rng(seed)
    lo = np.minimum(geom.v0, geom.v0 + geom.e1).min(axis=0)
    hi = np.maximum(geom.v0, geom.v0 + geom.e1).max(axis=0)
    span = np.maximum(hi - lo, 1e-3)
    o = rng.uniform(lo - span / 3, hi + span / 3, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(N_RAYS, np.float32)
    tmin[::7] = rng.uniform(0, 0.5, N_RAYS)[::7] * span.max()
    tmax = np.full(N_RAYS, FLOAT_MAX, np.float32)
    tmax[::5] = tmin[::5] + rng.uniform(0, 1, N_RAYS)[::5] * span.max()
    tmax[::13] = 0.0
    return o, d, tmin, tmax


def _built(name: str):
    geom = _soup(name)
    arrays, order = tbvh.build_bvh(geom.v0, geom.e1, geom.e2)
    reordered = tbvh.reorder_geometry(geom, order)
    return geom, arrays, order, reordered, tbvh.threaded_bvh(arrays, reordered, "cpu")


@pytest.mark.parametrize("name", SOUPS)
def test_build_bvh_matches_jax(name):
    geom, arrays, order, reordered, bvh = _built(name)
    jarrays, jorder = jbvh.build_bvh(geom.v0, geom.e1, geom.e2)
    np.testing.assert_array_equal(order, np.asarray(jorder))
    for field in tbvh.BvhArrays._fields:
        got, ref = getattr(arrays, field), np.asarray(getattr(jarrays, field))
        assert got.dtype == ref.dtype, field
        np.testing.assert_array_equal(got, ref, err_msg=field)
    if name != "random3000":  # the padding goes into the tree too
        assert (np.abs(geom.e1).sum(axis=1) == 0).any()
    # the device rows carry the arrays and the reordered soup bit for bit
    for field in tbvh.BvhArrays._fields:
        np.testing.assert_array_equal(getattr(bvh, field).numpy(), getattr(arrays, field))
    np.testing.assert_array_equal(bvh.tris[:, 3:6].numpy(), geom.e1[order])
    assert bvh.num_nodes == arrays.skip.shape[0] and (reordered.face_id == geom.face_id[order]).all()


def _jax_geom(reordered: SceneGeometry):
    n = reordered.num_triangles
    return JSceneGeometry(*(jnp.asarray(x) for x in reordered), packed_f=jnp.zeros((n, 1)),
                          packed_i=jnp.zeros((n, 1), jnp.int32))


@pytest.mark.parametrize("name", SOUPS)
def test_twins_match_traverse(name):
    _geom, arrays, _order, reordered, bvh = _built(name)
    rays = _rays(reordered, seed=len(name))
    got = trf.intersect_threaded_ref(*(torch.as_tensor(x) for x in rays), bvh)
    occl = trf.occluded_threaded_ref(*(torch.as_tensor(x) for x in rays), bvh).numpy()
    jarrays = jbvh.BvhArrays(*(jnp.asarray(x) for x in arrays))
    jrays = [jnp.asarray(x) for x in rays]
    ref = jbvh.traverse_closest(*jrays, jarrays, _jax_geom(reordered))
    jocc = np.asarray(jbvh.traverse_occluded(*jrays, jarrays, _jax_geom(reordered)))
    tri, rtri = got[1].numpy(), np.asarray(ref.tri)
    same = tri == rtri
    print(f"{name}: {int((tri >= 0).sum())} hits, tri equal on {same.mean():.6f}, flags on "
          f"{(occl == jocc).mean():.6f}; bit-equal t/u/v on "
          f"{[float((g.numpy()[same].view(np.int32) == np.asarray(r)[same].view(np.int32)).mean()) for g, r in ((got[0], ref.t), (got[2], ref.u), (got[3], ref.v))]}")
    assert same.mean() >= 0.999 and (occl == jocc).mean() >= 0.999
    assert (tri >= 0).mean() > 0.05 and occl.mean() > 0.05
    for g, r in ((got[0], ref.t), (got[2], ref.u), (got[3], ref.v)):
        np.testing.assert_allclose(g.numpy()[same], np.asarray(r)[same], rtol=1e-5, atol=1e-6)
    # the walks' counts: a dead ray walks nothing, a live one at least the root
    _hit, boxes, tests = trf.threaded_work(*(torch.as_tensor(x) for x in rays), bvh)
    live = rays[3] > rays[2]
    assert (boxes.numpy()[~live] == 0).all() and (boxes.numpy()[live] >= 1).all()
    assert (tests <= tbvh.LEAF_SIZE * boxes).all() and int(tests.sum()) > 0


@pytest.mark.parametrize("name", SOUPS)
def test_twins_match_brute_force(name):
    _geom, _arrays, _order, reordered, bvh = _built(name)
    rays = [torch.as_tensor(x) for x in _rays(reordered, seed=3 + len(name))]
    got = trf.intersect_threaded_ref(*rays, bvh)
    ref = intersect_brute(*rays, reordered)
    occl = trf.occluded_threaded_ref(*rays, bvh)
    bocc = occluded_brute(*rays, reordered)
    same = got[1] == ref.tri
    print(f"{name}: tri equal to brute force on {float(same.float().mean()):.6f}, flags on "
          f"{float((occl == bocc).float().mean()):.6f}")
    assert float(same.float().mean()) >= 0.999 and float((occl == bocc).float().mean()) >= 0.999
    np.testing.assert_allclose(got[0][same].numpy(), ref.t[same].numpy(), rtol=1e-5, atol=1e-6)


def test_entry_points_take_the_twins_on_the_cpu():
    """On a CPU tensor B1's and B2's entry points are their twins and
    count no launch."""
    _geom, _arrays, _order, reordered, bvh = _built("cornell")
    rays = [torch.as_tensor(x) for x in _rays(reordered, seed=5)]
    before = dict(tt.launches)
    hit = tt.intersect_threaded(*rays, bvh)
    flags = tt.occluded_threaded(*rays, bvh)
    assert tt.launches == before
    ref = trf.intersect_threaded_ref(*rays, bvh)
    assert all(torch.equal(a, b) for a, b in zip(hit, ref))
    assert torch.equal(flags, trf.occluded_threaded_ref(*rays, bvh))


def _grid_frame(pkg, **create):
    """FACE_ID and COLOR of the 8,450-triangle grid under the rect light,
    16x16, 2 spp, 3 bounces, NEE, through `pkg`'s gi."""
    gi_, stage_, meshproc_, config_, aov = pkg
    scene = gi_.create_scene(**create)
    scene.add_mesh(_grid_mesh((stage_, meshproc_), 65))
    light = rect_light()
    scene.add_light(stage_.LightDesc(light.path, light.light_type, light.transform,
                                     dict(light.params)))
    cam = stage_.CameraDesc(position=np.array([0.1, -0.15, 3], np.float32),
                            forward=np.array([0, 0, -1], np.float32),
                            up=np.array([0, 1, 0], np.float32), vfov=0.8)
    face = gi_.GiRenderBuffer(16, 16, 1, True)
    color = gi_.GiRenderBuffer(16, 16, 4)
    gi_.render(gi_.GiRenderParams(
        scene=scene, camera=cam,
        aov_bindings=[gi_.GiAovBinding(aov.FACE_ID, face, clear_value=-1),
                      gi_.GiAovBinding(aov.COLOR, color)],
        render_settings=dict(config_.default_settings(), spp=2, maxBounces=3,
                             nextEventEstimation=True)))
    return face.data[..., 0], color.data[..., :3], scene


def test_gi_render_above_8192_matches_jax():
    from gatling_tpu.interface import AovId as JAovId

    ref_face, ref_color, jscene = _grid_frame((jgi, jstage, jmeshproc, jconfig, JAovId))
    face, color, scene = _grid_frame((gi, stage, meshproc, config, AovId), device="cpu")
    assert jscene._tracer == "bvh" and scene._tracer == "bvh" and scene._fused is None
    same = (face == ref_face).mean()
    close = (np.abs(color - ref_color) <= 1e-3 + 1e-3 * np.abs(ref_color)).all(axis=-1).mean()
    rel = abs(color.mean() - ref_color.mean()) / ref_color.mean()
    print(f"face ids equal on {same:.4f} of pixels ({(face >= 0).mean():.4f} hit), COLOR within "
          f"1e-3 on {close:.4f}, mean rel diff {rel:.2e}")
    assert same >= 0.99 and (face >= 0).mean() > 0.5 and face.max() < 65 * 65
    assert close >= 0.98 and rel < 0.01 and color.mean() > 0.002  # lit, not black


def _round_f32(x) -> np.float32:
    """The f32 nearest the exact rational x, ties to an even mantissa."""
    from fractions import Fraction

    r = np.float32(float(x))  # within one f32 ulp of x
    cands = [r, np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(-np.inf))]
    dist = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(dist)
    ties = [c for c, dd in zip(cands, dist) if dd == best]
    return min(ties, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def test_fma_f32_rounds_once():
    """trace_ref.fma_f32, the twins' fused multiply-add (B1/B2 take
    __fmaf_rn), against a * b + c rounded once from the exact rational:
    on 5,000 random triples and on sums whose f64 rounding lands on the
    midpoint of two f32 values (where rounding twice is wrong), bit for
    bit."""
    from fractions import Fraction

    rng = np.random.default_rng(2)
    a = (rng.normal(size=5000) * 10.0 ** rng.integers(-8, 8, 5000)).astype(np.float32)
    b = (rng.normal(size=5000) * 10.0 ** rng.integers(-8, 8, 5000)).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * rng.choice([1.0, 1.0 + 2e-7, 0.5], 5000)).astype(np.float32)
    one = np.float32(1.0 + 2.0 ** -12)
    tiny = np.float32(2.0 ** -80)
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24: an f32 midpoint; +-tiny says which side
    a = np.concatenate([a, [one, one, -one]]).astype(np.float32)
    b = np.concatenate([b, [one, one, one]]).astype(np.float32)
    c = np.concatenate([c, [tiny, -tiny, -tiny]]).astype(np.float32)
    got = trf.fma_f32(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    ref = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                    for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive[-3:].view(np.int32) != ref[-3:].view(np.int32)).any()  # the case is real


def _collapse(arrays):
    """The wide tree of `arrays` by recursion: [(binary node, [its
    children's binary nodes])] in level order."""
    interior = arrays.leaf_count == 0

    def below(i, levels):
        if levels == 0 or not interior[i]:
            return [i]
        return below(i + 1, levels - 1) + below(int(arrays.skip[i + 1]), levels - 1)

    out, queue = [], [0]
    while queue:
        i = queue.pop(0)
        kids = below(i, 2)  # two binary levels a row
        out.append((i, kids))
        queue += [k for k in kids if interior[k]]
    return out


@pytest.mark.parametrize("name", SOUPS + ("lattice",))
def test_wide_rows_collapse_the_tree(name):
    _geom, arrays, _order, _reordered, bvh = _built(name)
    rows = bvh.wide.numpy()
    words = rows.view(np.int32)
    expect = _collapse(arrays)
    assert rows.shape == (len(expect), tbvh.WIDE_ROW)
    wide_of = {i: k for k, (i, _kids) in enumerate(expect)}
    w = tbvh.WIDE
    for k, (i, kids) in enumerate(expect):
        assert 2 <= len(kids) <= w and (words[k, 7 * w:] == 0).all()
        for j in range(w):
            box = rows[k, j::w][:6]  # lo x, y, z, hi x, y, z of slot j
            if j >= len(kids):
                assert np.isnan(box).all() and words[k, 6 * w + j] == 0
                continue
            c = kids[j]
            # the child's box is the binary node's, bit for bit
            np.testing.assert_array_equal(box.view(np.int32), np.concatenate(
                [arrays.bbox_min[c], arrays.bbox_max[c]]).astype(np.float32).view(np.int32))
            # ... inside its parent's (the box of binary node i)
            assert (box[:3] >= arrays.bbox_min[i]).all() and (box[3:] <= arrays.bbox_max[i]).all()
            if arrays.leaf_count[c] == 0:
                assert words[k, 6 * w + j] == -1 - wide_of[c]
            else:
                assert words[k, 6 * w + j] == (arrays.leaf_start[c] << tbvh.LEAF_BITS
                                               | arrays.leaf_count[c])
    # a depth-first walk of the wide rows in slot order meets the leaves
    # in the binary preorder, and they hold each triangle once
    order, stack = [], [-1]
    while stack:
        word = stack.pop()
        if word < 0:
            k = -1 - word
            stack += [int(x) for x in reversed(words[k, 6 * w:7 * w]) if x != 0]
        else:
            order.append(word)
    binary = [int(arrays.leaf_start[i]) << tbvh.LEAF_BITS | int(arrays.leaf_count[i])
              for i in range(arrays.skip.shape[0]) if arrays.leaf_count[i] > 0]
    assert order == binary
    covered = np.concatenate([np.arange(x >> tbvh.LEAF_BITS, (x >> tbvh.LEAF_BITS)
                                        + (x & ((1 << tbvh.LEAF_BITS) - 1))) for x in order])
    np.testing.assert_array_equal(covered, np.arange(bvh.tris.shape[0]))


def test_wide_rows_only_where_the_walk_holds():
    """No wide rows (the kernels then walk the node rows) for a tree whose
    root is a leaf or whose boxes hold a NaN (a parent's box then no
    longer holds its children's)."""
    soup = _random_soup(40)
    arrays, _order = tbvh.build_bvh(soup.v0, soup.e1, soup.e2)
    assert tbvh.wide_rows(arrays).shape == (5, tbvh.WIDE_ROW)  # 40 triangles: the root, 4 of 10
    lo = arrays.bbox_min.copy()
    lo[9, 1] = np.nan
    assert tbvh.wide_rows(arrays._replace(bbox_min=lo)).shape == (0, tbvh.WIDE_ROW)
    arrays, _order = tbvh.build_bvh(soup.v0[:3], soup.e1[:3], soup.e2[:3])
    assert arrays.leaf_count[0] == 3 and tbvh.wide_rows(arrays).shape == (0, tbvh.WIDE_ROW)


@pytest.mark.parametrize("name", SOUPS + ("lattice",))
def test_wide_walk_matches_traverse(name):
    _geom, arrays, _order, reordered, bvh = _built(name)
    rays = (lattice_rays(LATTICE_CELLS, N_RAYS, 1) if name == "lattice"
            else _rays(reordered, seed=len(name)))
    tr = [torch.as_tensor(x) for x in rays]
    got, rows, slabs, tests, binary = trf.wide_work(*tr, bvh)
    flags, orows, oslabs, otests, _binary = trf.wide_work(*tr, bvh, any_hit=True)
    twin = trf.intersect_threaded_ref(*tr, bvh)
    for g, r in zip(got, twin):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))
    assert torch.equal(flags, trf.occluded_threaded_ref(*tr, bvh))
    jarrays = jbvh.BvhArrays(*(jnp.asarray(x) for x in arrays))
    jrays = [jnp.asarray(x) for x in rays]
    ref = jbvh.traverse_closest(*jrays, jarrays, _jax_geom(reordered))
    jocc = np.asarray(jbvh.traverse_occluded(*jrays, jarrays, _jax_geom(reordered)))
    np.testing.assert_array_equal(flags.numpy(), jocc)
    for g, r in ((got[0], ref.t), (got[1], ref.tri), (got[2], ref.u), (got[3], ref.v)):
        np.testing.assert_array_equal(g.numpy().view(np.int32), np.asarray(r).view(np.int32))
    live = rays[3] > rays[2]
    hits = got[1].numpy() >= 0
    print(f"{name}: {hits.sum()} hits, {jocc.sum()} occluded; {int(binary.sum())} rays on the "
          f"node rows; a live ray: {rows.float()[live].mean():.2f} rows, "
          f"{slabs.float()[live].mean():.2f} boxes, {tests.float()[live].mean():.2f} "
          f"triangles (B2: {orows.float()[live].mean():.2f}, {oslabs.float()[live].mean():.2f}, "
          f"{otests.float()[live].mean():.2f})")
    assert hits.mean() > 0.05 and jocc.mean() > 0.05
    assert (rows[~live] == 0).all() and (rows[live] >= 1).all() and (slabs >= rows).all()
    # both test the triangles the JAX walk tests, in its order
    _hit, boxes, btests = trf.threaded_work(*tr, bvh)
    _flags, oboxes, obtests = trf.threaded_work(*tr, bvh, any_hit=True)
    assert torch.equal(tests, btests) and (rows <= boxes).all()
    assert torch.equal(otests, obtests) and (orows <= oboxes).all()
    assert bool(binary.any()) == (name == "lattice")
