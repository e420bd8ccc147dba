"""The port's brute-force trace (ops/trace.py, twins in ops/trace_ref.py)
against the JAX package's ops/pallas_trace.py and ops/intersect.py.

On the CPU the four entry points run their plain twins. Inputs are made
with numpy from seeds and handed to both sides:

1. `build_trace_tables` and `build_tri_tiles` against JAX's, within rtol
   1e-6 (both round the same f32 cross products; measured bit-equal);
2. the K5/K6 twins against `intersect_pallas` / `occluded_pallas` in
   Pallas interpret mode and against `intersect_features_jnp`; the K7/K8
   twins against the `_vpu` kernels in interpret mode. The triangle index
   must agree on 99.5 % of rays and t/u/v hold rtol 1e-4 / atol 1e-4 where
   it does: XLA sums the TPU kernel's feature product in its own order
   (the twin in a fixed one over the non-zero coefficients), which moves
   the last bits and can flip a ray that grazes an edge;
3. the selection rules, exactly: the lowest index wins a tie within and
   across tiles, K7 takes the same winner, dead rays (tmax = 0) miss;
4. the port's `intersect_brute` / `occluded_brute` against JAX's;
5. K7 against K5 on the same rays: the triangle on 99 % of rays (the JAX
   test's own criterion, tests/test_pallas_trace.py);
6. the padding skip of the K7/K8 kernels: `build_tri_tiles(...).n_real`
   is `real_triangles`, and the twins over the first n_real triangles
   only give the bits and flags they give over every lane;
7. `trace_ref.tiles_work`, the pairs K7's and K8's bounds count, against
   a numpy count of the same f32 operations: no valid pair is decided at
   det or at u.

The CUDA kernels are held against these twins on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3d).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gatling_tpu.interface import FLOAT_MAX
from gatling_tpu.ops import pallas_trace as jpt
from gatling_tpu.ops.geometry import SceneGeometry as JGeometry
from gatling_tpu.ops.geometry import build_geometry as jbuild_geometry
from gatling_tpu.ops.geometry import pack_geometry as jpack
from gatling_tpu.ops.intersect import intersect_brute as jintersect_brute
from gatling_tpu.ops.intersect import occluded_brute as joccluded_brute
from gatling_tpu.scene.stage import load_scene as jload_scene

from gatling_tpu_torch.ops import trace as tt
from gatling_tpu_torch.ops import trace_ref as trf
from gatling_tpu_torch.ops.geometry import SceneGeometry, build_geometry, real_triangles
from gatling_tpu_torch.ops.intersect import intersect_brute, occluded_brute
from gatling_tpu_torch.scene.stage import load_scene

from test_torch_bounce import CORNELL

MIN_AGREE = 0.995
RTOL = ATOL = 1e-4


def _soup(n_tris: int, seed: int):
    """v0, e1, e2 [n, 3] f32 of random triangles in a 4-unit box."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-2, 2, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    return v0, e1, e2


def _geoms(v0, e1, e2):
    """The same soup as the JAX package's and the port's SceneGeometry."""
    t = v0.shape[0]
    z3, z2, o3 = (np.zeros((t, 3), np.float32), np.zeros((t, 2), np.float32),
                  np.ones((t, 3), np.float32))
    zi = np.zeros(t, np.int32)
    cols = dict(v0=v0, e1=e1, e2=e2, n0=z3, n1=z3, n2=z3, t0=z3, t1=z3, t2=z3, bsign=z3,
                uv0=z2, uv1=z2, uv2=z2, c0=o3, c1=o3, c2=o3, material_id=zi, object_id=zi,
                face_id=zi, instance_id=zi, flags=zi)
    jg = jpack(JGeometry(**{k: jnp.asarray(v) for k, v in cols.items()},
                         packed_f=jnp.zeros((t, 45)), packed_i=jnp.zeros((t, 5), jnp.int32)))
    return jg, SceneGeometry(**cols)


def _rays(n: int, seed: int, dead_every: int = 0):
    """Origins, unit directions, tmin, tmax as numpy f32; every
    `dead_every`-th ray dead (tmax = 0)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, FLOAT_MAX, np.float32)
    if dead_every:
        tmax[::dead_every] = 0.0
    return o, d, tmin, tmax


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _agree_hits(got, ref, label):
    """tri on MIN_AGREE of the rays; t, u, v within tolerance where tri agrees."""
    gt, gtri, gu, gv = (np.asarray(x) for x in got)
    rt, rtri, ru, rv = (np.asarray(x) for x in ref)
    same = gtri == rtri
    print(f"{label}: {int((~same).sum())} of {same.size} rays with another triangle, "
          f"{int((rtri >= 0).sum())} hits")
    assert same.mean() >= MIN_AGREE, label
    both = same & (rtri >= 0)
    for a, b in ((gt, rt), (gu, ru), (gv, rv)):
        np.testing.assert_allclose(a[both], b[both], rtol=RTOL, atol=ATOL, err_msg=label)
    np.testing.assert_array_equal(gt[rtri < 0], np.float32(FLOAT_MAX))


@pytest.mark.parametrize("which", ["random", "cornell"])
def test_tables_match_jax(which):
    if which == "random":
        jg, tg = _geoms(*_soup(256, 3))
    else:
        desc, tdesc = jload_scene(CORNELL), load_scene(CORNELL)
        midx = {m.material: i for i, m in enumerate(desc.meshes)}
        jg, tg = jbuild_geometry(desc.meshes, midx), build_geometry(tdesc.meshes, midx)
    assert tg.num_triangles % 128 == 0  # the soup is padded to whole tiles
    got, ref = tt.build_trace_tables(tg, "cpu"), jpt.build_trace_tables(jg)
    assert got.n_tris == ref.n_tris and got.coeffs.shape == ref.coeffs.shape
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(ref.coeffs), rtol=1e-6, atol=0)
    tiles, jtiles = tt.build_tri_tiles(tg, "cpu"), jpt.build_tri_tiles(jg)
    np.testing.assert_allclose(tiles.tris.numpy(), np.asarray(jtiles.tris), rtol=1e-6, atol=0)


@pytest.mark.parametrize("kernel", ["K5", "K6", "K7", "K8"])
def test_twins_match_jax_interpret(kernel):
    """The twins against the TPU kernels in interpret mode (256 triangles,
    two tiles; 1024 rays, every 9th dead)."""
    jg, tg = _geoms(*_soup(256, 3))
    o, d, tmin, tmax = _rays(1024, 4, dead_every=9)
    matrix = kernel in ("K5", "K6")
    table = tt.build_trace_tables(tg, "cpu") if matrix else tt.build_tri_tiles(tg, "cpu")
    jtable = jpt.build_trace_tables(jg) if matrix else jpt.build_tri_tiles(jg)
    jfn = {"K5": jpt.intersect_pallas, "K6": jpt.occluded_pallas,
           "K7": jpt.intersect_pallas_vpu, "K8": jpt.occluded_pallas_vpu}[kernel]
    fn = {"K5": tt.intersect_matrix, "K6": tt.occluded_matrix,
          "K7": tt.intersect_tiles, "K8": tt.occluded_tiles}[kernel]
    with pltpu.force_tpu_interpret_mode():
        ref = jax.block_until_ready(jfn(*_j(o, d, tmin, tmax), jtable))
    got = fn(*_t(o, d, tmin, tmax), table)
    if kernel in ("K6", "K8"):
        agree = got.numpy() == np.asarray(ref)
        print(f"{kernel}: {int((~agree).sum())} of {agree.size} rays differ, "
              f"{int(got.sum())} occluded")
        assert agree.mean() >= MIN_AGREE and got.sum() > 100
        assert not got.numpy()[::9].any()  # dead rays
    else:
        _agree_hits(got, ref, kernel)
        assert (got.tri.numpy()[::9] == -1).all()
    if kernel == "K5":  # and the jnp reference of the feature form
        ref2 = jpt.intersect_features_jnp(*_j(o, d, tmin, tmax), jtable)
        _agree_hits(got, ref2, "K5 vs intersect_features_jnp")


def test_selection_rules_exact():
    """One triangle repeated at indices 5 and 7 of tile 0 and 2 of tile 1,
    a farther one at 3: every ray that hits takes index 5 (ties go to the
    lowest index, within and across tiles) in both forms; dead rays miss."""
    v0, e1, e2 = _soup(256, 7)
    v0[:] = 50.0  # everything else far away
    tri = (np.array([-1, -1, 0], np.float32), np.array([2, 0, 0], np.float32),
           np.array([0, 2, 0], np.float32))
    for i in (5, 7, 130):
        v0[i], e1[i], e2[i] = tri
    v0[3], e1[3], e2[3] = tri[0] - np.array([0, 0, 1], np.float32), tri[1], tri[2]
    _jg, tg = _geoms(v0, e1, e2)
    n = 64
    rng = np.random.default_rng(0)
    o = np.concatenate([rng.uniform(-0.9, -0.1, (n, 2)), np.full((n, 1), 3.0)], 1)
    o = o.astype(np.float32)
    d = np.tile(np.array([0, 0, -1], np.float32), (n, 1))
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, FLOAT_MAX, np.float32)
    tmax[::4] = 0.0
    for fn, table in ((tt.intersect_matrix, tt.build_trace_tables(tg, "cpu")),
                      (tt.intersect_tiles, tt.build_tri_tiles(tg, "cpu"))):
        hit = fn(*_t(o, d, tmin, tmax), table)
        live = tmax > 0
        assert (hit.tri.numpy()[live] == 5).all(), hit.tri
        assert (hit.tri.numpy()[~live] == -1).all()
        np.testing.assert_allclose(hit.t.numpy()[live], 3.0, rtol=1e-6)
        assert (hit.t.numpy()[~live] == np.float32(FLOAT_MAX)).all()
    # the occluders stop at the first: the twins report index 3 (the lowest)
    idx = tt.occluded_matrix_ref(*_t(o, d, tmin, tmax), tt.build_trace_tables(tg, "cpu").coeffs,
                                 first=True)
    assert (idx.numpy()[tmax > 0] == 3).all() and (idx.numpy()[tmax == 0] == -1).all()


@pytest.mark.parametrize("closest", [True, False])
def test_intersect_brute_matches_jax(closest):
    jg, tg = _geoms(*_soup(512, 11))  # whole blocks: JAX slices a ragged last block short
    o, d, tmin, tmax = _rays(512, 12, dead_every=5)
    if closest:
        got = intersect_brute(*_t(o, d, tmin, tmax), tg, tri_block=256)
        ref = jintersect_brute(*_j(o, d, tmin, tmax), jg, tri_block=256)
        _agree_hits(got, ref, "intersect_brute")
        assert (got.tri >= 0).sum() > 50
    else:
        got = occluded_brute(*_t(o, d, tmin, tmax), tg, tri_block=256).numpy()
        ref = np.asarray(joccluded_brute(*_j(o, d, tmin, tmax), jg, tri_block=256))
        assert (got == ref).mean() >= MIN_AGREE and got.sum() > 50


def test_tiles_agree_with_matrix():
    """K7 (elementwise MT) against K5 (the coefficient form) on the same
    rays: the same triangle on at least 99 % of rays."""
    _jg, tg = _geoms(*_soup(512, 21))
    rays = _t(*_rays(2048, 22))
    k5 = tt.intersect_matrix(*rays, tt.build_trace_tables(tg, "cpu"))
    k7 = tt.intersect_tiles(*rays, tt.build_tri_tiles(tg, "cpu"))
    same = (k5.tri == k7.tri).numpy()
    assert same.mean() >= 0.99 and (k5.tri >= 0).sum() > 300
    # the two forms round differently: t within 1e-3 where the triangle agrees
    np.testing.assert_allclose(k7.t.numpy()[same], k5.t.numpy()[same], rtol=1e-3, atol=1e-4)


def test_wrappers_take_the_twin_only_on_the_cpu():
    _jg, tg = _geoms(*_soup(128, 1))
    o, d, tmin, tmax = _t(*_rays(8, 2))
    tables = tt.build_trace_tables(tg, "cpu")
    before = dict(tt.launches)
    assert tt.intersect_matrix(o, d, tmin, tmax, tables).tri.shape == (8,)
    assert tt.launches == before  # the twin counts no launch
    meta = [x.to("meta") for x in (o, d, tmin, tmax)]
    with pytest.raises(NotImplementedError, match="CUDA or CPU"):
        tt.occluded_matrix(*meta, tables)


def _padded_soup(which: str):
    """The port's SceneGeometry of a soup padded with zero rows to whole
    tiles: the Cornell box (32 of 128), 300 random triangles in 384 lanes
    with a degenerate one (e2 = 2 e1) at 150, or the same whose last real
    triangle (299) is degenerate."""
    if which == "cornell":
        desc = load_scene(CORNELL)
        return build_geometry(desc.meshes, {m.material: i for i, m in enumerate(desc.meshes)})
    v0, e1, e2 = _soup(384, 31)
    for k in (v0, e1, e2):
        k[300:] = 0.0
    e2[150] = 2.0 * e1[150]
    if which == "degenerate_last":
        e2[299] = -e1[299]
    return _geoms(v0, e1, e2)[1]


class _RealLanes:
    """The twins' table cut at n_real: tile j keeps its lanes below n_real,
    so the twins test triangles 0 .. n_real - 1 in order and nothing after,
    as the kernels do."""

    def __init__(self, tiles):
        n = tiles.n_real
        self.tiles = [tiles.tris[j, :, :min(tt.TRI_TILE, n - j * tt.TRI_TILE)]
                      for j in range(-(-n // tt.TRI_TILE))]
        self.shape = (len(self.tiles),)

    def __getitem__(self, j):
        return self.tiles[j]


@pytest.mark.parametrize("which", ["cornell", "random", "degenerate_last"])
def test_n_real_is_real_triangles(which):
    geom = _padded_soup(which)
    tiles = tt.build_tri_tiles(geom, "cpu")
    assert tiles.n_real == real_triangles(geom) == {"cornell": 32}.get(which, 300)
    assert tiles.rows.shape == (tiles.n_real, 12)
    flat = tiles.tris.permute(0, 2, 1).reshape(-1, 9)
    assert torch.equal(tiles.rows[:, :9], flat[:tiles.n_real])
    assert not tiles.rows[:, 9:].any() and not flat[tiles.n_real:, 3:].any()


@pytest.mark.parametrize("which", ["cornell", "random", "degenerate_last"])
@pytest.mark.parametrize("kernel", ["K7", "K8"])
def test_padding_skip_is_exact(kernel, which):
    """The twins over the first n_real triangles against the twins over
    every lane, on 1024 seeded rays (every 7th dead): K7's t, tri, u, v
    and K8's flags and first occluders bit-equal."""
    tiles = tt.build_tri_tiles(_padded_soup(which), "cpu")
    o, d, tmin, tmax = _rays(1024, 32, dead_every=7)
    if which == "cornell":  # rays from inside the box
        o = (o * 0.2).astype(np.float32)
    rays = _t(o, d, tmin, tmax)
    cut = _RealLanes(tiles)
    if kernel == "K7":
        full = trf.intersect_tiles_ref(*rays, tiles.tris)
        got = trf.intersect_tiles_ref(*rays, cut)
        for g, f in zip(got, full):
            assert torch.equal(g.view(torch.int32), f.view(torch.int32))
        assert (full[1] >= 0).sum() > 100 and (full[1][::7] == -1).all()
    else:
        full = trf.occluded_tiles_ref(*rays, tiles.tris, first=True)
        got = trf.occluded_tiles_ref(*rays, cut, first=True)
        assert torch.equal(got, full)
        assert (full >= 0).sum() > 100 and (full[::7] == -1).all()


@pytest.mark.parametrize("which", ["cornell", "random", "degenerate_last"])
@pytest.mark.parametrize("kernel", ["K7", "K8"])
def test_tiles_work_counts_the_early_pairs(kernel, which):
    """tiles_work over every real triangle (K7) or up to each ray's first
    occluder (K8), on 512 seeded rays (every 7th dead), against numpy's
    count of the same f32 operations: the pairs decided at det (|det| <=
    1e-12) and at u (outside [-1e-6, 2]), and the pairs tested; no valid
    pair of the twin falls in either early class."""
    tiles = tt.build_tri_tiles(_padded_soup(which), "cpu")
    o, d, tmin, tmax = _rays(512, 33, dead_every=7)
    if which == "cornell":
        o = (o * 0.2).astype(np.float32)
    rays = _t(o, d, tmin, tmax)
    n = tiles.n_real
    first = trf.occluded_tiles_ref(*rays, tiles.tris, first=True)
    last = (torch.full_like(first, n - 1) if kernel == "K7"
            else torch.where(first >= 0, first, n - 1))
    at_det, at_u, pairs = trf.tiles_work(*rays, tiles.tris, last)

    v0, e1, e2 = (tiles.rows[:, k:k + 3].numpy()[None] for k in (0, 3, 6))
    ro, rd = o[:, None, :], d[:, None, :]
    p = np.stack([rd[..., 1] * e2[..., 2] - rd[..., 2] * e2[..., 1],
                  rd[..., 2] * e2[..., 0] - rd[..., 0] * e2[..., 2],
                  rd[..., 0] * e2[..., 1] - rd[..., 1] * e2[..., 0]], axis=-1)
    det = e1[..., 0] * p[..., 0] + e1[..., 1] * p[..., 1] + e1[..., 2] * p[..., 2]
    ok = np.abs(det) > np.float32(1e-12)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(ok, np.float32(1.0) / np.where(ok, det, np.float32(1.0)), np.float32(0))
        tv = ro - v0
        u = (tv[..., 0] * p[..., 0] + tv[..., 1] * p[..., 1] + tv[..., 2] * p[..., 2]) * inv
    early_u = ok & ~((u >= np.float32(-trf.BARY_EPS)) & (u <= np.float32(2.0)))
    tested = (np.arange(n)[None, :] <= last.numpy()[:, None]) & (tmax > tmin)[:, None]
    np.testing.assert_array_equal(at_det.numpy(), (tested & ~ok).sum(axis=1))
    np.testing.assert_array_equal(at_u.numpy(), (tested & early_u).sum(axis=1))
    np.testing.assert_array_equal(pairs.numpy(), tested.sum(axis=1))
    assert int(at_u.sum()) > 0 and int(pairs.sum()) > int(at_det.sum() + at_u.sum())

    valid = torch.cat([trf._mt_tile(rays[0], rays[1], tiles.tris[j], rays[2], rays[3])[3]
                       for j in range(tiles.tris.shape[0])], dim=1)[:, :n].numpy()
    assert valid.any() and not (valid & (~ok | early_u)).any()
