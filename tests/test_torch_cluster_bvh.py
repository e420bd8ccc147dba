"""The two-level walk's per-cluster trees (K2, and K3 and K4 over
clustered and instanced tables) against the brute-force twins, on the CPU.

On the card the walk (csrc/bounce.cu walk) visits a TLAS over the level-1
entry boxes, the fan's cluster boxes nearest entry first, and in each
cluster that cluster's own BVH (ops/bvh.py ClusterBvh, in the cluster's
frame, its boxes grown at run time by padded_origin); the twins
(ops/bounce_ref.py walk_closest / walk_occluded) test all 128 lanes of
every cluster box a ray crosses. `bounce_ref.cluster_work` repeats the
kernels' walk step for step, so here it must return the twins' winner on
every ray (the same global triangle index: the smallest pass-1 t, ties to
the lower index) and their any-hit flag on every shadow ray.

Cases, each with its ray count: a reduced sphere_field (n_side=4: 16
spheres and the ground, 18,436 triangles), instanced and flattened, its
camera wave (48x48 = 2,304 rays) and a bounce wave from its hits, with
the cutout draws off and on; the Cornell box's clustered tables (one
cluster, 2,304 rays and their bounce wave); interior(detail=1) (3,840
triangles), gi's instanced tables and flattened ones (32x32 = 1,024
rays); and test_torch_bvh.py's adversarial soup (shared edges and
vertices, exact t ties from duplicated triangles, axis-parallel and
grazing rays, origins on a surface) in flattened tables and as three
placements: as built, scaled by 1e-3 about 700 units from the rays'
origins (which puts the origins about 7e5 local units away, where the
tests' rounding is thousands of times the trees' own padding), and scaled
by 1e3. The shadow rays include segments ending exactly at a closest hit
and one ulp either side of it. Structural checks: every lane that passes
the cluster test lies inside the padded box of each ancestor of its leaf,
entered no later than its t; each cluster's tree is build_tlas's; a
transform refit keeps the trees and equals a fresh build. About 25 s on
one worker (two threads).
"""

import functools

import numpy as np
import pytest
import torch

from gatling_tpu_torch.ops import bounce as tb
from gatling_tpu_torch.ops import bounce_ref as br
from gatling_tpu_torch.ops import bvh as bvhm
from gatling_tpu_torch.ops.geometry import build_geometry
from gatling_tpu_torch.render.material import build_material_table, lower_material
from gatling_tpu_torch.scene import examples as ex
from gatling_tpu_torch.scene import meshproc
from gatling_tpu_torch.scene.stage import MeshDesc, load_scene

from test_torch_bvh import CORNELL, FMAX, _adversarial_rays, _bounce_wave, _camera_wave, _soup

TMIN = 1e-4
FAR = np.array([400.0, 300.0, -500.0])  # the small placement's offset
BIG = np.array([0.0, 4000.0, 6000.0])    # the large placement's offset


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The plain walk runs thousands of small tensor operations; with
    torch's default of a thread a core, a worker sharing its cores with
    others spends its time waking threads. Two threads take the same time
    on an idle machine and a third of the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _material_index(meshes):
    paths = sorted({m.material for m in meshes if m.material})
    midx = {p: i for i, p in enumerate(paths)}
    midx[None] = len(paths)
    return midx


def _tables(meshes, materials, instanced: bool):
    """Instanced (the walk over unique local clusters) or flattened
    clustered tables of a scene's meshes."""
    midx = _material_index(meshes)
    table = build_material_table([lower_material(materials.get(p) if p else None)
                                  for p in midx])
    if instanced:
        fs, static = tb.build_fused_scene_instanced(meshes, midx, table, None, "cpu",
                                                    min_gain=1.5, min_flat=0)
        assert static.instanced
    else:
        fs, static = tb.build_fused_scene(build_geometry(meshes, midx), table, None, "cpu",
                                          resident_max=0)
        assert static.clustered and not static.instanced
    return fs


def _with_cutout(fs):
    """The same tables with every triangle passing half its camera draws
    and a quarter of its shadow draws: the placements' probabilities
    (instanced) or the rows' CLU_OPAC / CLU_OPAC_SH, which the trees'
    leaf rows copy (flattened)."""
    walk, tris = fs.walk, fs.tris.clone()
    if walk.instanced:
        inst = walk.inst.clone()
        inst[:, br.INST_PASS], inst[:, br.INST_PASS_SH] = 0.5, 0.25
        walk = walk._replace(inst=inst)
    else:
        real = (tris[:, 0:3] != 0).any(dim=1)
        tris[real, br.CLU_OPAC], tris[real, br.CLU_OPAC_SH] = 0.5, 0.25
        trees = tb.cluster_trees(tris.numpy(), "cpu")
        walk = walk._replace(cnodes=trees.nodes, ckids=trees.kids, crows=trees.rows,
                             croot=trees.root)
    return fs._replace(tris=tris, walk=walk, cutout=True)


@functools.lru_cache(maxsize=None)
def _sphere_field(instanced: bool, cutout: bool):
    desc = ex.sphere_field(n_side=4)
    fs = _tables(desc.meshes, desc.materials, instanced)
    return desc, (_with_cutout(fs) if cutout else fs)


def _soup_mesh():
    """test_torch_bvh.py's adversarial soup as one mesh (its 97 real
    triangles)."""
    g = _soup()
    n = tb.real_triangles(g)
    pts = np.stack([g.v0[:n], g.v0[:n] + g.e1[:n], g.v0[:n] + g.e2[:n]], axis=1).reshape(-1, 3)
    return meshproc.build_triangulated_mesh(pts.astype(np.float32), np.full(n, 3),
                                            np.arange(3 * n))


def _placements():
    """The soup as built, scaled by 1e-3 at FAR and scaled by 1e3 at BIG
    (row-vector transforms)."""
    xfs = []
    for s, at in ((1.0, np.zeros(3)), (1e-3, FAR), (1e3, BIG)):
        xf = np.eye(4)
        xf[:3, :3] *= s
        xf[3, :3] = at
        xfs.append(xf)
    return np.stack(xfs)


@functools.lru_cache(maxsize=None)
def _soup_tables(instanced: bool):
    if not instanced:
        g = _soup()
        table = build_material_table([lower_material(None)])
        fs, static = tb.build_fused_scene(g, table, None, "cpu", resident_max=0)
        assert static.clustered and fs.walk.croot.numel() == 16  # one cluster and 15 pad slots
        return fs
    mesh = MeshDesc(path="/soup", mesh=_soup_mesh(), transform=np.eye(4), material=None,
                    double_sided=True, object_id=0, instance_transforms=_placements())
    return _tables([mesh], {}, True)


def _placed_rays():
    """The adversarial rays (o, d, tmin) on each placement of the soup:
    as built; on the small copy from points near the world origin toward
    each ray's first target (its origin plus its direction) mapped into
    the copy, t and tmin scaled with it; and on the large copy mapped
    whole (o scaled and moved, d kept, tmin times 1e3)."""
    o, d, lo = _adversarial_rays(_soup())
    rng = np.random.default_rng(4)
    target = (o + d) * 1e-3 + torch.from_numpy(FAR.astype(np.float32))
    src = torch.from_numpy(rng.uniform(-1.0, 1.0, size=o.shape).astype(np.float32))
    ds = target - src
    ds = ds / ds.norm(dim=1, keepdim=True)
    ob = o * 1e3 + torch.from_numpy(BIG.astype(np.float32))
    return [(o, d, lo), (src, ds, lo * 1e-3), (ob, d, lo * 1e3)]


def _check_closest(fs, o, d, tmin, key=None, what=""):
    """cluster_work against walk_closest on every ray; returns its result."""
    alive = torch.ones(o.shape[0], dtype=torch.bool)
    ref = br.walk_closest(fs.walk, fs.tris, o, d, alive, tmin, key)
    got = br.cluster_work(fs.walk, o, d, alive, tmin, key)
    bad = int((got[1] != ref).sum())
    assert bad == 0, f"{what}: {bad} of {o.shape[0]} winners differ"
    return got


def _check_occluded(fs, o, d, dist, key=None, what=""):
    """cluster_work's any-hit walk against walk_occluded on every segment."""
    ref = br.walk_occluded(fs.walk, fs.tris, o, d, dist, key)
    got = br.cluster_work(fs.walk, o, d, torch.ones_like(ref), 0.0, key, dist=dist)
    bad = int(((got[1] >= 0) != ref).sum())
    assert bad == 0, f"{what}: {bad} of {o.shape[0]} shadow flags differ"
    return ref


def _shadow_rays(fs, o, d, got, seed: int):
    """Segments from the hits of (o, d) (the walk's result `got`): toward
    a point near the scene box's upper corner, and along the ray itself
    ending exactly at its closest t and one ulp either side (the hit
    excluded, included, excluded), where that t exceeds SHADOW_TMIN."""
    t, win = got[0], got[1]
    hit = win >= 0
    pos = (o + t[:, None] * d)[hit]
    gb = fs.walk.gbox
    top = gb[3:6] * 0.9 + gb[0:3] * 0.1
    ld = top - pos
    dist = ld.norm(dim=1)
    segs = [(pos, ld / dist[:, None], dist)]
    far = hit & (t > 2 * br.SHADOW_TMIN)
    tf = t[far]
    for end in (tf, torch.nextafter(tf, torch.full_like(tf, FMAX)),
                torch.nextafter(tf, torch.zeros_like(tf))):
        segs.append((o[far], d[far], end))
    so, sd, sdist = (torch.cat(x).contiguous() for x in zip(*segs))
    key = torch.from_numpy(np.random.default_rng(seed).integers(0, 2 ** 32, so.shape[0]))
    return so, sd, sdist, key ^ br.SHADOW_SALT


@pytest.mark.parametrize("instanced", [True, False], ids=["instanced", "flattened"])
@pytest.mark.parametrize("wave", ["camera", "bounce"])
@pytest.mark.parametrize("cutout", [False, True], ids=["plain", "cutout"])
def test_sphere_field_walk(instanced, wave, cutout):
    """sphere_field(n_side=4), 2,304 rays of the camera wave or the bounce
    wave from its hits: winners and shadow flags equal the twins', and the
    walk tests far fewer triangles than the 128 of every cluster box it
    enters."""
    desc, fs = _sphere_field(instanced, cutout)
    o, d = _camera_wave(desc, 48)
    key = None
    if cutout:
        key = torch.from_numpy(np.random.default_rng(1).integers(0, 2 ** 32, o.shape[0]))
    got = _check_closest(fs, o, d, TMIN, key, f"camera {instanced} {cutout}")
    if wave == "bounce":
        o, d = _bounce_wave(o, d, got[0], got[1], seed=2)
        key = key[:o.shape[0]] if cutout else None
        got = _check_closest(fs, o, d, TMIN, key, f"bounce {instanced} {cutout}")
    assert bool((got[1] >= 0).any())
    so, sd, dist, skey = _shadow_rays(fs, o, d, got, seed=5)
    occ = _check_occluded(fs, so, sd, dist, skey if cutout else None, "shadow")
    assert 0 < int(occ.sum()) < occ.numel()
    if cutout:  # the draws decide some winners
        plain = br.walk_closest(fs.walk, fs.tris, o, d, torch.ones(o.shape[0], dtype=torch.bool),
                                TMIN)
        assert bool((plain != got[1]).any())
    alive = torch.ones(o.shape[0], dtype=torch.bool)
    t_hit = br.walk_hit_attrs(fs.walk, fs.tris, o, d, got[1])[0]
    _entries, clusters = br.walk_work(fs.walk, o, d, alive, TMIN, t_hit)
    assert int(got[5].sum()) < clusters * br.CLUSTER_SIZE / 4


@pytest.mark.parametrize("wave", ["camera", "bounce"])
def test_cornell_clustered_walk(wave):
    """The Cornell box in clustered tables (32 triangles in one cluster of
    128 lanes: the padding lanes are in no leaf), 2,304 camera rays or
    their bounce wave."""
    desc = load_scene(CORNELL)
    fs = _tables(desc.meshes, desc.materials, False)
    assert fs.walk.crows.shape[0] == 32
    o, d = _camera_wave(desc, 48)
    got = _check_closest(fs, o, d, TMIN, what="cornell camera")
    if wave == "bounce":
        o, d = _bounce_wave(o, d, got[0], got[1], seed=3)
        got = _check_closest(fs, o, d, TMIN, what="cornell bounce")
    so, sd, dist, _key = _shadow_rays(fs, o, d, got, seed=6)
    _check_occluded(fs, so, sd, dist, what="cornell shadow")


@pytest.mark.parametrize("instanced", [True, False], ids=["instanced", "flattened"])
def test_interior_walk(tmp_path, instanced):
    """interior(detail=1): gi's instanced tables or flattened ones, 1,024
    camera rays and their shadow rays."""
    desc = ex.interior(detail=1, tex_dir=str(tmp_path))
    fs = _tables(desc.meshes, desc.materials, instanced)
    o, d = _camera_wave(desc, 32)
    got = _check_closest(fs, o, d, TMIN, what="interior")
    so, sd, dist, _key = _shadow_rays(fs, o, d, got, seed=7)
    _check_occluded(fs, so, sd, dist, what="interior shadow")


@pytest.mark.parametrize("instanced", [True, False], ids=["placements", "flattened"])
def test_adversarial_walk(instanced):
    """The adversarial soup: flattened (4,324 rays), or as three
    placements with the rays mapped onto each (12,972 rays): through
    shared edges and vertices, along axes, grazing, from surfaces, exact
    ties between duplicated triangles (the lower index wins), and on the
    small far copy from origins about 7e5 of its units away. Winners and
    the shadow flags of segments ending at each hit equal the twins'."""
    fs = _soup_tables(instanced)
    waves = _placed_rays() if instanced else [_adversarial_rays(_soup())]
    for k, (o, d, lo) in enumerate(waves):
        for tmin in sorted(set(lo.tolist())):
            sel = lo == tmin
            got = _check_closest(fs, o[sel], d[sel], tmin, what=f"wave {k} tmin {tmin}")
            if tmin == float(lo[0]):  # the rays through targets, and from surfaces
                assert int((got[1] >= 0).sum()) > int(sel.sum()) // 3
                so, sd, dist, _key = _shadow_rays(fs, o[sel], d[sel], got, seed=k)
                _check_occluded(fs, so, sd, dist, what=f"wave {k} shadow")


def test_adversarial_cutout():
    """The soup's placements with the cutout draws on: the walk's winners,
    and so the draws that decided them, equal the twin's on every ray."""
    fs = _with_cutout(_soup_tables(True))
    for k, (o, d, lo) in enumerate(_placed_rays()):
        key = torch.from_numpy(np.random.default_rng(k).integers(0, 2 ** 32, o.shape[0]))
        tmin = float(lo[0])
        sel = lo == tmin
        got = _check_closest(fs, o[sel], d[sel], tmin, key[sel], what=f"cutout wave {k}")
        so, sd, dist, skey = _shadow_rays(fs, o[sel], d[sel], got, seed=k)
        _check_occluded(fs, so, sd, dist, skey, what=f"cutout wave {k} shadow")


# ---------------------------------------------------------------------------
# the trees themselves
# ---------------------------------------------------------------------------

def _lane_paths(walk):
    """[C, 128, CLUSTER_STACK] the nodes above each lane's leaf (root
    first, -1 after the leaf; all -1 for a lane in no leaf)."""
    kids = walk.ckids.numpy()
    rows = walk.crows.numpy()
    paths = np.full((walk.croot.numel(), br.CLUSTER_SIZE, bvhm.CLUSTER_STACK), -1, np.int64)
    for c, root in enumerate(walk.croot.tolist()):
        stack = [(root, [])]
        while stack:
            k, path = stack.pop()
            path = path + [k]
            if kids[k, 0] >= 0:
                stack += [(int(kids[k, 0]), path), (int(kids[k, 1]), path)]
                continue
            for s in range(-1 - kids[k, 0], -1 - kids[k, 0] + kids[k, 1]):
                paths[c, int(rows[s, 12]), :len(path)] = path
    return torch.from_numpy(paths)


@pytest.mark.parametrize("case", ["sphere_field_instanced", "sphere_field_flattened",
                                  "soup_placements"])
def test_passing_lanes_inside_ancestor_boxes(case):
    """Every (ray, lane) pair that passes the cluster test, in every
    cluster box the ray crosses, lies inside the run-time padded box of
    each ancestor of the lane's leaf, entered at a t no later than its own
    (the slab test over [tmin less the margin, t]): no walk skips it. The
    rays: sphere_field's camera wave and bounce wave, or the soup's rays on
    its three placements."""
    if case == "soup_placements":
        fs = _soup_tables(True)
        waves = [(o, d) for o, d, _lo in _placed_rays()]
        tmin = 1e-7
    else:
        desc, fs = _sphere_field(case.endswith("instanced"), False)
        o, d = _camera_wave(desc, 48)
        got = _check_closest(fs, o, d, TMIN)
        waves = [(o, d), _bounce_wave(o, d, got[0], got[1], seed=2)]
        tmin = TMIN
    walk = fs.walk
    paths = _lane_paths(walk)
    rows = br._test_rows(fs.tris)
    checked = 0
    for o, d in waves:
        n = o.shape[0]
        iv = br._safe_inv(d)
        lo = torch.full((n,), tmin)
        cap = torch.full((n,), FMAX)
        for e0 in range(0, walk.l1.shape[0], br.WALK_ENTRIES):
            ray, slot, ent = br._candidates(walk, o, iv, torch.arange(n), e0,
                                            e0 + br.WALK_ENTRIES, lo, cap)
            if not ray.numel():
                continue
            tt, ok = br._pair_test(walk, rows, o, d, ray, slot, ent, lo, cap)
            pi, lane = ok.nonzero(as_tuple=True)
            t = tt[pi, lane]
            r, s, e = ray[pi], slot[pi], ent[pi]
            ol, dl = o[r], d[r]
            if walk.instanced:
                ol, dl = br._to_local(walk.inst[e], ol, dl)
            olo, ohi = br.padded_origin(ol)
            ivl = br._safe_inv(dl)
            tlo = lo[r] - lo[r] * (1.0 / 1024.0)
            path = paths[walk.cmap[s].long(), lane]
            assert bool((path[:, 0] >= 0).all()), case  # every passing lane is in a leaf
            for level in range(bvhm.CLUSTER_STACK):
                has = path[:, level] >= 0
                inside, enter = br.slab_padded(walk.cnodes[path[:, level].clamp(min=0)], olo,
                                               ohi, ivl, tlo, t)
                assert bool((inside | ~has).all()), (case, level)
                assert bool(((enter <= t) | ~has).all()), (case, level)
            checked += t.numel()
    assert checked > 1000


def test_trees_are_build_tlas_per_cluster():
    """The flattened sphere_field's forest: each cluster's tree is the one
    build_tlas makes (4 triangles a leaf) of its lanes that can hit, boxed
    by tri_boxes with the cluster's own scale; every such lane in exactly
    one leaf, the padding lanes in none; leaf rows hold the three test
    quads, the lane and the pass probabilities; nodes and rows contiguous
    by cluster; every depth within the kernels' stack; an all-padding
    cluster's root an empty leaf."""
    _desc, fs = _sphere_field(False, False)
    rows = fs.tris.numpy()
    walk = fs.walk
    kids, nodes, crows = walk.ckids.numpy(), walk.cnodes.numpy(), walk.crows.numpy()
    test = rows[:, list(br.CLU_TEST_COLS)]
    n_clusters = walk.croot.numel()
    node_end = np.append(walk.croot.numpy()[1:], nodes.shape[0])
    row0 = 0
    for c in range(n_clusters):
        lanes = np.nonzero((test[c * 128:(c + 1) * 128, 0:3] != 0).any(axis=1))[0]
        root = int(walk.croot[c])
        if not lanes.size:
            assert kids[root].tolist() == [-1 - row0, 0] and nodes[root, 0] > nodes[root, 3]
            continue
        corners = bvhm.plane_corners(test[c * 128 + lanes])
        scale = np.abs(corners[np.isfinite(corners).all(axis=(1, 2))]).max()
        lo, hi = bvhm.tri_boxes(corners, np.full(lanes.size, scale))
        want_nodes, want_kids, want_leaf = bvhm.build_tlas(lo, hi, bvhm.TRI_LEAF)
        # the same tree, numbered level by level from the root
        order, mine = [0], [root]
        k = 0
        while k < len(order):
            a, b = want_kids[order[k]], kids[mine[k]]
            np.testing.assert_array_equal(want_nodes[order[k]], nodes[mine[k]])
            if a[0] >= 0:
                assert b[0] >= 0
                order += [int(a[0]), int(a[1])]
                mine += [int(b[0]), int(b[1])]
            else:
                assert b[1] == a[1]
                got_lanes = crows[-1 - b[0]:-1 - b[0] + b[1], 12].astype(int)
                np.testing.assert_array_equal(got_lanes, lanes[want_leaf[-1 - a[0]:][:a[1]]])
            k += 1
        assert sorted(mine) == list(range(root, int(node_end[c])))
        assert len(order) == int(node_end[c]) - root
        block = crows[row0:row0 + lanes.size]
        assert sorted(block[:, 12].astype(int).tolist()) == lanes.tolist()
        src = c * 128 + block[:, 12].astype(int)
        np.testing.assert_array_equal(block[:, 0:12], test[src])
        np.testing.assert_array_equal(block[:, 13:15], rows[src][:, [br.CLU_OPAC, br.CLU_OPAC_SH]])
        assert (block[:, 15] == 0).all()
        row0 += lanes.size
    assert row0 == crows.shape[0]
    depth = int((_lane_paths(walk) >= 0).sum(dim=-1).max())
    assert depth <= bvhm.CLUSTER_STACK - 2  # 128 lanes, 4 a leaf: 6 levels


def test_refit_keeps_cluster_trees():
    """A transform edit of an instanced scene: refit_instanced keeps the
    unique clusters' trees (the same tensors) and its tables equal a
    fresh build's over the edited transforms."""
    mesh = _soup_mesh()
    grid = np.eye(4)[None].repeat(48, axis=0)  # enough placements for the instanced route
    grid[:, 3, 0], grid[:, 3, 2] = np.arange(48) % 8 * 8.0 - 30.0, np.arange(48) // 8 * 8.0 + 10.0

    def meshes(shift):
        xfs = np.concatenate([_placements(), grid])
        xfs[1, 3, :3] += shift
        return [MeshDesc(path="/soup", mesh=mesh, transform=np.eye(4), material=None,
                         double_sided=True, object_id=0, instance_transforms=xfs)]

    midx = _material_index(meshes(0.0))
    table = build_material_table([lower_material(None)])
    clusters = tb.UniqueClusters()
    scene, _static = tb.build_fused_scene_instanced(meshes(0.0), midx, table, None, "cpu",
                                                    min_gain=1.5, min_flat=0, clusters=clusters)
    edited = meshes(np.array([-900.0, 50.0, 2000.0]))
    refit = tb.refit_instanced(scene, clusters, edited, midx, table)
    fresh, _static = tb.build_fused_scene_instanced(edited, midx, table, None, "cpu",
                                                    min_gain=1.5, min_flat=0)
    for name in ("cnodes", "ckids", "crows", "croot"):
        assert getattr(refit.walk, name) is getattr(scene.walk, name)
    for name, a, b in zip(br.WalkTables._fields, refit.walk, fresh.walk):
        assert torch.equal(a, b), name
    o, d, lo = _placed_rays()[1]
    moved = o + torch.tensor([-900.0, 50.0, 2000.0])
    sel = lo == lo[0]
    _check_closest(refit, moved[sel], d[sel], float(lo[0]), what="refit")
