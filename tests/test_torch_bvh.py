"""The BVH walks of K1 (K3, K4), K5 and K6 against their brute-force twins,
on the CPU.

On the card K1, K3 and K4 search a resident table, and K5 and K6 the
wavefront's soup, by walking a BVH built once per scene (ops/bvh.py
TriBvh); their twins test every triangle. The plain walks
`bounce_ref.resident_work`, `trace_ref.matrix_work` and
`trace_ref.occluded_work` repeat the kernels' walk step for step, so here
they must return the brute-force twins' winner on every ray: the same t,
u and v bits and the same triangle index (the closest t, ties to the lower
index), or K6's occlusion flag. Cases, each with its ray count: the
Cornell box's camera wave (48x48 = 2,304 rays) and a bounce wave from its
hits, the NEE shadow rays of both; glass_coated's 580-triangle table
(48x48); interior(detail=1)'s 3,840-triangle soup (3,740 real; 32x32 =
1,024 rays, resident, K5 and K6); K6's shadow rays from the hits of the
Cornell camera and bounce waves and the interior's camera wave, toward
random directions and toward the lights; an adversarial soup built with
numpy from a seed (rays through shared edges and vertices, exact t ties
from duplicated triangles, axis-parallel directions, origins on a surface
at tmin, and a cutout table whose draws decide; for K6 segments ending
exactly at a triangle's t, rays grazing edges in a surface's plane, and
segments starting just past a surface). A structural check holds every
passing (ray, triangle) pair inside the padded box of each of the
triangle's ancestor nodes at a t no later than its own, and build_tlas is
deterministic and shallow at 4096 triangles.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gatling_tpu_torch.ops import bounce as tb
from gatling_tpu_torch.ops import bvh as bvhm
from gatling_tpu_torch.ops import sampling as smp
from gatling_tpu_torch.ops import trace as tt
from gatling_tpu_torch.ops import trace_ref as trf
from gatling_tpu_torch.ops.bounce_ref import (
    SHADOW_SALT,
    _safe_inv,
    _slab_t,
    _tri_test,
    closest_hit,
    cutout_xi,
    occluded,
    resident_work,
)
from gatling_tpu_torch.ops.geometry import SceneGeometry, build_geometry
from gatling_tpu_torch.render.camera import camera_uniforms, generate_primary_rays
from gatling_tpu_torch.scene.stage import load_scene

CORNELL = "tests/data/cornell.usda"
GLASS = "tests/graphical/Materials.GlassCoated/scene.usda"
TMIN = 1e-4
FMAX = float(np.finfo(np.float32).max)


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test. The walks' twins run thousands of small
    ops, and where test workers share the host each op's thread pool
    contends with theirs: test_resident_walk_interior took 785 s beside
    five other workers on the default pool, 10 s alone (9 s alone on one
    thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geometry(desc) -> SceneGeometry:
    paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(paths)}
    midx[None] = len(paths)
    return build_geometry(desc.meshes, midx)


def _resident(geom, cutout_prob=None, shadow_prob=None):
    """The resident table of a soup (its padding rows included: they have
    a zero plane normal and must go into no leaf) and its TriBvh."""
    rows = tb.tri_rows(geom, cutout_prob=cutout_prob, shadow_prob=shadow_prob)
    return tb.from_jax_tables(rows.T, np.zeros((1, 30), np.float32),
                              np.zeros((1, 20), np.float32), (), "cpu",
                              cutout=cutout_prob is not None)


def _camera_wave(desc, res: int):
    cam = camera_uniforms(desc.first_camera(), False, "cpu")
    pix = torch.arange(res * res)
    o, d, _rng = generate_primary_rays(cam, res, res, pix % res, pix // res,
                                       smp.rng_init(pix, 1), True, True, False)
    return o.contiguous(), d.contiguous()


def _bounce_wave(o, d, t, win, seed: int):
    """Rays leaving the hits of (o, d) in uniform random directions, from
    the hit points: origins on a surface, as every secondary wave has."""
    hit = win >= 0
    pos = (o + t[:, None] * d)[hit]
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(pos.shape[0], 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return pos.contiguous(), torch.from_numpy(dirs)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x.to(torch.int64)


def _assert_same(got, ref, what: str):
    for name, g, r in zip(("t", "u", "v", "index"), got, ref):
        bad = int((_bits(g) != _bits(r)).sum())
        assert bad == 0, f"{what}: {bad} of {g.numel()} rays differ in {name}"


def _check_resident(fs, o, d, key=None, what=""):
    """resident_work against closest_hit on every ray (2,304 at most), then
    the NEE shadow rays from the hits towards the box's upper corner
    against occluded; returns the work counts."""
    alive = torch.ones(o.shape[0], dtype=torch.bool)
    ref = closest_hit(fs.tris, tuple(o.T), tuple(d.T), TMIN, key)
    got = resident_work(fs.bvh, o, d, alive, TMIN, key)
    _assert_same(got[:4], ref, what + " closest")
    hit = ref[3] >= 0
    assert bool(hit.any()), what
    pos = (o + ref[0][:, None] * d)[hit]
    top = fs.bvh.nodes[0, 3:6] * 0.9 + fs.bvh.nodes[0, 0:3] * 0.1
    ld = top - pos
    dist = ld.norm(dim=1)
    ld = (ld / dist[:, None]).contiguous()
    skey = None if key is None else key[hit] ^ SHADOW_SALT
    occ = occluded(fs.tris, tuple(pos.T), tuple(ld.T), dist, skey)
    sh = resident_work(fs.bvh, pos, ld, torch.ones_like(dist, dtype=torch.bool), TMIN, skey,
                       dist=dist)
    assert torch.equal(sh[3] >= 0, occ), what + " shadow"
    return got[4], got[5]


@pytest.fixture(scope="module")
def cornell():
    desc = load_scene(CORNELL)
    geom = _geometry(desc)
    return desc, geom, _resident(geom)


@pytest.fixture(scope="module")
def interior(tmp_path_factory):
    from gatling_tpu_torch.scene.examples import interior as build

    desc = build(detail=1, tex_dir=str(tmp_path_factory.mktemp("tex")))
    geom = _geometry(desc)
    return desc, geom


@pytest.mark.parametrize("wave", ["camera", "bounce"])
def test_resident_walk_cornell(cornell, wave):
    """Cornell (32 triangles, padded to 128 rows: one leaf, at most
    bvh.ONE_LEAF_MAX), 2,304 camera rays or the bounce wave from their
    hits: winners and shadow flags equal the brute-force twin's."""
    desc, _geom, fs = cornell
    assert fs.bvh.kids.tolist() == [[-1, 32]]
    o, d = _camera_wave(desc, 48)
    if wave == "bounce":
        t, _u, _v, win = closest_hit(fs.tris, tuple(o.T), tuple(d.T), TMIN)
        o, d = _bounce_wave(o, d, t, win, seed=3)
    boxes, tests = _check_resident(fs, o, d, what=f"cornell {wave}")
    assert int(tests.max()) <= 32


def test_resident_walk_glass_coated():
    """glass_coated's 580-triangle table (48 of them degenerate pole
    triangles, in no leaf), 2,304 camera rays and their bounce wave; the
    walk tests a few tens of triangles a ray, not 580."""
    desc = load_scene(GLASS)
    geom = _geometry(desc)
    fs = _resident(geom)
    assert fs.bvh.rows.shape[0] < tb.real_triangles(geom)
    o, d = _camera_wave(desc, 48)
    _boxes, tests = _check_resident(fs, o, d, what="glass_coated camera")
    assert float(tests.float().mean()) < 60
    t, _u, _v, win = closest_hit(fs.tris, tuple(o.T), tuple(d.T), TMIN)
    o2, d2 = _bounce_wave(o, d, t, win, seed=5)
    _check_resident(fs, o2, d2, what="glass_coated bounce")


def test_resident_walk_interior(interior):
    """interior(detail=1): 3,840 triangles in one resident table, 1,024
    camera rays."""
    desc, geom = interior
    fs = _resident(geom)
    o, d = _camera_wave(desc, 32)
    _check_resident(fs, o, d, what="interior")


@pytest.mark.parametrize("scene", ["cornell", "interior"])
def test_matrix_walk_matches_brute(cornell, interior, scene):
    """K5's walk over the soup's TriBvh against intersect_matrix_ref: the
    Cornell camera wave (2,304 rays, 32 real triangles of 128 lanes: the
    padding lanes are in no leaf) and its bounce wave, interior(detail=1)'s
    soup (3,840 triangles, 1,024 camera rays)."""
    desc, geom = (cornell[0], cornell[1]) if scene == "cornell" else interior
    tables = tt.build_trace_tables(geom, "cpu")
    # the interior's degenerate triangles (sphere poles) join the padding
    n_leaf = tables.bvh.rows.shape[0]
    assert n_leaf == 32 if scene == "cornell" else 0.9 * 3740 < n_leaf < 3740
    o, d = _camera_wave(desc, 48 if scene == "cornell" else 32)
    waves = [(o, d)]
    if scene == "cornell":
        ref = trf.intersect_matrix_ref(o, d, torch.full((o.shape[0],), TMIN),
                                       torch.full((o.shape[0],), FMAX), tables.coeffs)
        waves.append(_bounce_wave(o, d, ref[0], ref[1], seed=7))
    for k, (o, d) in enumerate(waves):
        n = o.shape[0]
        tmin = torch.full((n,), TMIN)
        tmax = torch.full((n,), FMAX)
        tmax[::17] = 0.0  # dead rays (tmax <= tmin) do no tests
        ref = trf.intersect_matrix_ref(o, d, tmin, tmax, tables.coeffs)
        got = trf.matrix_work(tables.bvh, o, d, tmin, tmax)
        _assert_same((got[0], got[2], got[3], got[1]), (ref[0], ref[2], ref[3], ref[1]),
                     f"{scene} wave {k}")
        assert int(got[5][::17].sum()) == 0 and int(got[4][::17].sum()) == 0
        assert bool((ref[1] >= 0).any())


def _light_targets(desc, geom, n: int, rng) -> torch.Tensor:
    """n points on the scene's lights: random points of the Cornell box's
    emissive Light mesh, or the centres of the interior's lights jittered
    by a normal of 0.05 (about their size)."""
    light = [m.object_id for m in desc.meshes if m.path.endswith("/Light")]
    if light:
        k = rng.choice(np.nonzero(geom.object_id == light[0])[0], size=n)
        b = rng.uniform(size=(n, 2)).astype(np.float32)
        b = np.where(b.sum(axis=1, keepdims=True) > 1, 1 - b, b)
        pts = geom.v0[k] + b[:, :1] * geom.e1[k] + b[:, 1:] * geom.e2[k]
    else:
        centres = np.stack([np.asarray(lt.transform[3, :3]) for lt in desc.lights])
        pts = centres[rng.integers(0, len(centres), size=n)] + rng.normal(scale=0.05,
                                                                           size=(n, 3))
    return torch.from_numpy(pts.astype(np.float32))


@pytest.mark.parametrize("scene,wave,target", [
    ("cornell", "camera", "random"), ("cornell", "camera", "light"),
    ("cornell", "bounce", "random"), ("cornell", "bounce", "light"),
    ("interior", "camera", "random"), ("interior", "camera", "light")])
def test_occluded_walk_matches_brute(cornell, interior, scene, wave, target):
    """K6's any-hit walk over the soup's TriBvh (trace_ref.occluded_work)
    against occluded_matrix_ref: shadow rays from the hits of the Cornell
    camera wave (2,304 rays) or its bounce wave, and of interior(detail=1)'s
    (1,024 rays), toward random directions (segments of 0.5-8) or toward a
    point on a light (the segment ending there: on the Cornell box's Light
    mesh itself), tmin 0.01 as the wavefront's NEE sets it. The flags are
    equal on every ray; dead rays (tmax <= tmin) make no tests; Cornell's
    one leaf makes at most its 32 tests a ray, the interior's walk fewer
    than 100 on average where brute force makes 3,740."""
    desc, geom = (cornell[0], cornell[1]) if scene == "cornell" else interior
    tables = tt.build_trace_tables(geom, "cpu")
    o, d = _camera_wave(desc, 48 if scene == "cornell" else 32)
    full = lambda x, v: torch.full((x.shape[0],), v)
    ref = trf.intersect_matrix_ref(o, d, full(o, TMIN), full(o, FMAX), tables.coeffs)
    if wave == "bounce":
        o, d = _bounce_wave(o, d, ref[0], ref[1], seed=7)
        ref = trf.intersect_matrix_ref(o, d, full(o, TMIN), full(o, FMAX), tables.coeffs)
    hit = ref[1] >= 0
    pos = (o + ref[0][:, None] * d)[hit].contiguous()
    n = pos.shape[0]
    rng = np.random.default_rng(11)
    if target == "light":
        ld = _light_targets(desc, geom, n, rng) - pos
        tmax = ld.norm(dim=1)
        ld = ld / tmax[:, None]
    else:
        ld = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
        ld = ld / ld.norm(dim=1, keepdim=True)
        tmax = torch.from_numpy(rng.uniform(0.5, 8.0, size=n).astype(np.float32))
    ld = ld.contiguous()
    tmin = full(pos, 0.01)
    tmax[::13] = 0.0  # dead rays, and segments of length 0
    tmax[5::13] = 0.01
    dead = tmax <= tmin
    flag, boxes, tests = trf.occluded_work(tables.bvh, pos, ld, tmin, tmax)
    assert torch.equal(flag, trf.occluded_matrix_ref(pos, ld, tmin, tmax, tables.coeffs))
    assert int(tests[dead].sum()) == 0 and int(boxes[dead].sum()) == 0
    assert 0 < int(flag.sum()) < int((~dead).sum())  # both answers occur
    if scene == "cornell":
        assert int(tests.max()) <= 32
    else:
        assert float(tests[~dead].float().mean()) < 100 < tb.real_triangles(geom)


# ---------------------------------------------------------------------------
# adversarial soup
# ---------------------------------------------------------------------------

GRID = np.linspace(-3.0, 3.0, 7, dtype=np.float32)  # the floor's 6x6 quads


def _soup(seed: int = 0) -> SceneGeometry:
    """A tessellated floor (a 6x6 grid of quads: shared edges and vertices),
    a closed axis-aligned box on it, a tilted random triangle fan, and
    exact duplicates of some triangles at higher indices (equal t on every
    ray that hits them): 97 triangles, more than bvh.ONE_LEAF_MAX, so they
    get a tree; padded to 128 lanes."""
    rng = np.random.default_rng(seed)
    tris = []
    g = GRID
    for i in range(6):
        for j in range(6):
            a, b = [g[i], 0.0, g[j]], [g[i + 1], 0.0, g[j]]
            c, e = [g[i + 1], 0.0, g[j + 1]], [g[i], 0.0, g[j + 1]]
            tris += [[a, b, c], [a, c, e]]
    lo, hi = np.array([-0.5, 0.0, -0.5]), np.array([0.5, 1.0, 0.5])
    corner = lambda k: np.where([(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1], hi, lo)
    for f in ((0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4),
              (1, 5, 7, 3)):
        p = [corner(k) for k in f]
        tris += [[p[0], p[1], p[2]], [p[0], p[2], p[3]]]
    centre = np.array([1.0, 1.5, 1.0])
    ring = rng.normal(size=(9, 3)) * 0.6 + centre
    tris += [[centre, ring[k], ring[k + 1]] for k in range(8)]
    tris = np.asarray(tris, np.float32)
    tris = np.concatenate([tris, tris[[3, 17, 75, 76, 85]]])  # duplicates, higher indices
    n = tris.shape[0]
    pad = 128 - n
    v0 = np.concatenate([tris[:, 0], np.zeros((pad, 3), np.float32)])
    e1 = np.concatenate([tris[:, 1] - tris[:, 0], np.zeros((pad, 3), np.float32)])
    e2 = np.concatenate([tris[:, 2] - tris[:, 0], np.zeros((pad, 3), np.float32)])
    z3 = np.zeros((128, 3), np.float32)
    z2 = np.zeros((128, 2), np.float32)
    zi = np.zeros(128, np.int32)
    nrm = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (128, 1))
    return SceneGeometry(v0, e1, e2, nrm, nrm, nrm, z3, z3, z3, z3, z2, z2, z2, z3 + 1, z3 + 1,
                         z3 + 1, zi, zi, zi, zi, zi)


def _adversarial_rays(geom: SceneGeometry, seed: int = 1):
    """Rays (o, d, tmin) at the soup's hard cases, built in f32:
    through grid vertices and edge midpoints from random origins above;
    axis-parallel (two or one zero components) through the box's and the
    grid's vertices and edges; from points on the floor and the box
    (origins on a surface) with tmin; and rays whose hit on the floor is at
    t = tmin exactly or a few ulps either side."""
    rng = np.random.default_rng(seed)
    g = GRID
    verts = np.array([[x, 0.0, z] for x in g for z in g], np.float32)
    mids = np.array([[x + 0.5, 0.0, z] for x in g[:-1] for z in g] +
                    [[x, 0.0, z + 0.5] for x in g for z in g[:-1]] +
                    [[x + 0.5, 0.0, z + 0.5] for x in g[:-1] for z in g[:-1]], np.float32)
    box = np.array([[x, y, z] for x in (-0.5, 0.0, 0.5) for y in (0.0, 0.5, 1.0)
                    for z in (-0.5, 0.0, 0.5)], np.float32)
    targets = np.concatenate([verts, mids, box])
    o, d, lo = [], [], []
    src = rng.uniform([-3, 0.5, -3], [3, 4, 3], size=(targets.shape[0] * 4, 3)).astype(np.float32)
    tg = np.repeat(targets, 4, axis=0)
    dd = tg - src
    o.append(src)
    d.append(dd / np.linalg.norm(dd, axis=1, keepdims=True))
    for axis in range(3):  # axis-parallel, both ways, through every target
        for sign in (1.0, -1.0):
            dirs = np.zeros((targets.shape[0], 3), np.float32)
            dirs[:, axis] = sign
            o.append(targets - 3.0 * dirs)
            d.append(dirs)
    diag = np.array([[1.0, 1.0, 0.0], [0.0, 1.0, -1.0], [1.0, 0.0, 1.0]], np.float32)
    for v in diag:  # one zero component
        v = v / np.linalg.norm(v)
        o.append(targets + 2.0 * v)
        d.append(np.tile(-v, (targets.shape[0], 1)))
    n = sum(x.shape[0] for x in o)
    lo.append(np.full(n, TMIN, np.float32))
    # origins on a surface: random points of every real triangle, random
    # directions, tmin as a bounce has it
    real = np.abs(geom.e1).sum(axis=1) > 0
    v0, e1, e2 = geom.v0[real], geom.e1[real], geom.e2[real]
    b = rng.uniform(size=(v0.shape[0] * 8, 2)).astype(np.float32)
    b = np.where(b.sum(axis=1, keepdims=True) > 1, 1 - b, b)
    k = np.repeat(np.arange(v0.shape[0]), 8)
    pts = v0[k] + b[:, :1] * e1[k] + b[:, 1:] * e2[k]
    dirs = rng.normal(size=pts.shape).astype(np.float32)
    o.append(pts)
    d.append(dirs / np.linalg.norm(dirs, axis=1, keepdims=True))
    lo.append(np.full(pts.shape[0], TMIN, np.float32))
    # hits at t = tmin: origins tmin above the floor, straight down, tmin
    # nudged by 0 and +-1, +-2 ulps
    fl = rng.uniform(-1.9, 1.9, size=(200, 3)).astype(np.float32)
    fl[:, 1] = 0.0
    tm = np.float32(0.01)
    start = fl + np.array([0.0, tm, 0.0], np.float32)
    for ulps in (-2, -1, 0, 1, 2):
        o.append(start)
        d.append(np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (200, 1)))
        lo.append(np.full(200, tm, np.float32) + np.float32(ulps) * np.spacing(tm))
    o, d = np.concatenate(o).astype(np.float32), np.concatenate(d).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(np.concatenate(lo))


def test_adversarial_resident():
    """The adversarial soup through K1's walk (4,324 rays): every winner
    the twin's; duplicated triangles tie on t and the lower index wins."""
    geom = _soup()
    fs = _resident(geom)
    o, d, lo = _adversarial_rays(geom)
    alive = torch.ones(o.shape[0], dtype=torch.bool)
    for tmin in sorted(set(lo.tolist())):
        sel = lo == tmin
        ref = closest_hit(fs.tris, tuple(o[sel].T), tuple(d[sel].T), tmin)
        got = resident_work(fs.bvh, o[sel], d[sel], alive[sel], tmin)
        _assert_same(got[:4], ref, f"adversarial resident tmin {tmin}")
    # the duplicated triangles: a ray straight down onto triangle 3 ties
    # with its copy (index 92) and takes 3
    c = torch.from_numpy(geom.v0[3] + (geom.e1[3] + geom.e2[3]) / 3.0)
    got = resident_work(fs.bvh, (c + torch.tensor([0.0, 1.0, 0.0]))[None],
                        torch.tensor([[0.0, -1.0, 0.0]]), torch.ones(1, dtype=torch.bool), TMIN)
    assert int(got[3][0]) == 3


def _grazing_rays():
    """Rays in the plane of a surface along its edges: along the floor's
    grid lines at y = 0 and one ulp above it, and along the box's top and
    vertical edges (two faces meet there), both ways."""
    o, d = [], []
    for y in (0.0, float(np.spacing(np.float32(0.0))), 1e-7):
        for g in GRID:
            o += [[g, y, -4.0], [-4.0, y, g], [g, y, 4.0]]
            d += [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]]
    for x in (-0.5, 0.5):
        for z in (-0.5, 0.5):
            o += [[x, 1.0, -2.0], [-2.0, 1.0, z], [x, -1.0, z], [x, 3.0, z]]
            d += [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, -1.0, 0.0]]
    return (torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32))


def _shadow_segments(o, d, lo, closest):
    """K6's adversarial segments from the adversarial rays (o, d, tmin lo)
    and their closest hits (t, tri): the rays with tmax at FLOAT_MAX;
    the grazing rays; the hit rays with tmax exactly at the closest t and
    one ulp either side of it (the hit excluded, included, and the
    duplicates' equal t with it); the hit rays with tmin at that t and 1-2
    ulps either side (the segment starting just past the surface) and tmax
    past it; every 17th segment dead. Returns (o, d, tmin, tmax) and the
    slices of the segments ending at the closest t and one ulp past it."""
    hit = closest[1] >= 0
    oh, dh, th, loh = o[hit], d[hit], closest[0][hit], lo[hit]
    up, down = (torch.nextafter(th, torch.full_like(th, x)) for x in (FMAX, 0.0))
    go, gd = (x.to(o.device) for x in _grazing_rays())
    segments = [(o, d, lo, torch.full_like(lo, FMAX)),
                (go, gd, torch.full_like(go[:, 0], TMIN), torch.full_like(go[:, 0], 10.0))]
    for end in (th, up, down):
        segments.append((oh, dh, loh, end))
    for start in (th, up, down, torch.nextafter(up, torch.full_like(th, FMAX)),
                  torch.nextafter(down, torch.zeros_like(th))):
        segments.append((oh, dh, start, th * 2.0 + 1.0))
    o6, d6, lo6, hi6 = (torch.cat(x).contiguous() for x in zip(*segments))
    hi6[::17] = 0.0
    first, n = o.shape[0] + go.shape[0], oh.shape[0]
    return (o6, d6, lo6, hi6), (slice(first, first + n), slice(first + n, first + 2 * n))


def test_adversarial_matrix():
    """The adversarial soup through K5's walk (4,324 rays, tmin per ray):
    t, u, v and the index bit-equal to intersect_matrix_ref; and K6's
    any-hit walk against occluded_matrix_ref on _shadow_segments (a
    segment ending at a triangle's t, grazing rays along edges, segments
    starting just past a surface): the flags equal on every ray, dead
    segments untested."""
    geom = _soup()
    tables = tt.build_trace_tables(geom, "cpu")
    o, d, lo = _adversarial_rays(geom)
    tmax = torch.full_like(lo, FMAX)
    ref = trf.intersect_matrix_ref(o, d, lo, tmax, tables.coeffs)
    got = trf.matrix_work(tables.bvh, o, d, lo, tmax)
    _assert_same((got[0], got[2], got[3], got[1]), (ref[0], ref[2], ref[3], ref[1]),
                  "adversarial matrix")
    assert int((ref[1] >= 0).sum()) > o.shape[0] // 2

    rays, (at, past) = _shadow_segments(o, d, lo, ref[:2])
    want = trf.occluded_matrix_ref(*rays, tables.coeffs)
    flag, _boxes, tests = trf.occluded_work(tables.bvh, *rays)
    assert torch.equal(flag, want)
    assert int(tests[rays[3] <= rays[2]].sum()) == 0
    # the segment ending at the closest t excludes that hit, the one
    # ending one ulp past it includes it
    assert int(want[at].sum()) < int(want[past].sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_adversarial_cutout(seed):
    """A cutout table (every triangle passes half its camera draws and a
    quarter of its shadow draws): the walk's winners, and so the draws that
    decided them, equal the twin's on the adversarial rays (4,324) and
    their shadow rays; the duplicate pairs draw for their own indices."""
    geom = _soup()
    n = geom.v0.shape[0]
    fs = _resident(geom, np.full(n, 0.5, np.float32), np.full(n, 0.25, np.float32))
    assert fs.cutout and fs.tris.shape[1] == 36
    o, d, _lo = _adversarial_rays(geom)
    key = torch.from_numpy(np.random.default_rng(seed).integers(0, 2 ** 32, o.shape[0]))
    _check_resident(fs, o, d, key, what=f"cutout seed {seed}")
    ref = closest_hit(fs.tris, tuple(o.T), tuple(d.T), TMIN, key)
    won = ref[3] >= 0
    draws = cutout_xi(key[won], ref[3][won])
    assert bool((draws < 0.5).all())
    plain = closest_hit(fs.tris, tuple(o.T), tuple(d.T), TMIN)[3]
    assert bool((plain != ref[3]).any())  # the draws decide some rays


# ---------------------------------------------------------------------------
# the tree itself
# ---------------------------------------------------------------------------

def _ancestors(kids: np.ndarray) -> dict[int, list[int]]:
    """Leaf slot -> the nodes above it, root first."""
    out, stack = {}, [(0, [])]
    while stack:
        k, path = stack.pop()
        path = path + [k]
        if kids[k, 0] >= 0:
            stack += [(int(kids[k, 0]), path), (int(kids[k, 1]), path)]
        else:
            for s in range(-1 - kids[k, 0], -1 - kids[k, 0] + kids[k, 1]):
                out[s] = path
    return out


@pytest.mark.parametrize("scene", ["cornell", "glass_coated", "adversarial"])
def test_passing_pairs_inside_ancestor_boxes(cornell, scene):
    """Every (ray, triangle) pair that passes the exact test lies inside
    the padded box of every ancestor node of its leaf, entered at a t no
    later than its own (the slab test over [tmin less the margin, t]): no
    walk can skip it."""
    if scene == "cornell":
        desc, _g, fs = cornell
        o, d = _camera_wave(desc, 48)
        t, _u, _v, win = closest_hit(fs.tris, tuple(o.T), tuple(d.T), TMIN)
        o2, d2 = _bounce_wave(o, d, t, win, seed=9)
        o, d = torch.cat([o, o2]), torch.cat([d, d2])
    elif scene == "glass_coated":
        desc = load_scene(GLASS)
        fs = _resident(_geometry(desc))
        o, d = _camera_wave(desc, 32)
    else:
        geom = _soup()
        fs = _resident(geom)
        o, d, _lo = _adversarial_rays(geom)
    tt_, _u, _v, ok = _tri_test(fs.tris, tuple(o.T), tuple(d.T), TMIN)
    ray, tri = ok.nonzero(as_tuple=True)
    assert ray.numel() > o.shape[0] // 2
    t = tt_[ray, tri]
    slot_of = {int(i): s for s, i in enumerate(fs.bvh.rows[:, 12].long().tolist())}
    anc = _ancestors(fs.bvh.kids.numpy())
    paths = [anc[slot_of[int(i)]] for i in tri]
    iv = _safe_inv(d)
    tlo = torch.full_like(t, TMIN) - TMIN * (1.0 / 1024.0)
    for level in range(max(len(p) for p in paths)):
        has = torch.tensor([level < len(p) for p in paths])
        node = torch.tensor([p[level] if level < len(p) else 0 for p in paths])
        inside, enter = _slab_t(fs.bvh.nodes[node], o[ray], iv[ray], tlo, t)
        assert bool((inside | ~has).all()), (scene, level)
        assert bool(((enter <= t) | ~has).all()), (scene, level)


def test_build_tlas_deterministic_and_shallow():
    """build_tlas over 4096 triangle boxes (bvh.TRI_LEAF a leaf): the same
    tree twice, every triangle in exactly one leaf, every box inside its
    parent's, the depth within TLAS_MAX_DEPTH (median splits: 11)."""
    rng = np.random.default_rng(2)
    v = rng.uniform(-5, 5, size=(4096, 3, 3))
    v[:, 1:] = v[:, :1] + rng.normal(scale=0.2, size=(4096, 2, 3))
    lo, hi = bvhm.tri_boxes(v)
    a = bvhm.build_tlas(lo, hi, bvhm.TRI_LEAF)
    b = bvhm.build_tlas(lo, hi, bvhm.TRI_LEAF)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    nodes, kids, leaf = a
    assert sorted(leaf.tolist()) == list(range(4096))
    assert (lo <= v.min(axis=1)).all() and (hi >= v.max(axis=1)).all()
    anc = _ancestors(kids)
    depth = max(len(p) for p in anc.values())
    assert depth <= bvhm.TLAS_MAX_DEPTH and depth == 11
    for slot, path in anc.items():
        boxes = nodes[path]
        assert (boxes[:, 0:3] <= lo[leaf[slot]]).all() and (boxes[:, 3:6] >= hi[leaf[slot]]).all()


def test_empty_tree_misses():
    """A table with no triangle that can hit (all padding) has one empty
    leaf; every ray misses, as the twin says."""
    geom = _soup()
    empty = SceneGeometry(*(np.zeros_like(x) for x in geom))
    fs = _resident(empty)
    assert fs.bvh.rows.shape[0] == 0 and fs.bvh.kids.tolist() == [[-1, 0]]
    o, d, _lo = _adversarial_rays(geom)
    got = resident_work(fs.bvh, o, d, torch.ones(o.shape[0], dtype=torch.bool), TMIN)
    assert bool((got[3] == -1).all()) and bool((got[0] == FMAX).all())
    tables = tt.build_trace_tables(SimpleNamespace(v0=empty.v0, e1=empty.e1, e2=empty.e2), "cpu")
    hit = trf.matrix_work(tables.bvh, o, d, torch.full_like(o[:, 0], TMIN),
                          torch.full_like(o[:, 0], FMAX))
    assert bool((hit[1] == -1).all())
