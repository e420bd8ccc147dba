"""Binary BVHs for the kernels' per-ray walks, built once per scene on the host.

Four walks take one:

* K2's TLAS over the level-1 entry boxes of clustered and instanced
  tables (ops/bounce.py walk_tables), TLAS_LEAF entries a leaf;
* below it, the triangle walk inside each 128-triangle cluster of those
  tables (`ClusterBvh`, one forest, TRI_LEAF triangles a leaf), which K2,
  and K3 and K4 over clustered tables, take;
* the triangle walks of K1, K3 and K4 over a resident table and of K5
  and K6 over the wavefront's soup (`TriBvh`), TRI_LEAF triangles a leaf
  (a table of at most ONE_LEAF_MAX is one leaf);
* the walks of B1 and B2, the wavefront's tracer above 8192 triangles
  (`ThreadedBvh`, at the end of this file): the JAX package's threaded
  BVH, Morton order and median splits, unpadded boxes, built as the JAX
  package builds it so that its walk is the JAX `traverse`, and beside it
  the same tree collapsed into WIDE-child rows (`wide_rows`), which the
  kernels walk with a short stack.

`build_tlas` makes them: a median split of the box centres along their
longest extent (`build_forest` the same, for every cluster at once). A
TriBvh or ClusterBvh keeps a compact copy of each triangle's test data
in leaf order, with its index in the table (its lane in the cluster), so
that a walk reads its leaves in order and ties go to the lower index as
in the brute-force loops.

What makes a walk equal the brute-force search bit for bit: it runs the
same test on each candidate, and it skips a node only when no triangle
under it can pass that test. So a triangle's box covers its barycentric
slack (the corners at u, v = -SLACK and 1 + 2 SLACK, SLACK ten times the
tests' 1e-6) and is padded by BOX_PAD times the largest coordinate of the
scene: the f32 rounding of a hit point, of u and v, and of the walk's
slab test, each a few ulps of the coordinates (one ulp is 6e-8 of them),
stay far inside it. That rounding also grows with the ray origin's
coordinates, which a cluster's tree cannot bound (an instanced cluster
is seen from its placements' frames, the camera may move): its boxes
are padded for the cluster's own coordinates, and the kernels add
BOX_PAD times the origin's largest coordinate at run time. The walks
prune a node only when its entry t is strictly above the best t, so a
tie in another leaf is still visited.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gatling_tpu_torch import native
from gatling_tpu_torch.interface import FLOAT_MAX

TLAS_LEAF = 2        # level-1 entries per TLAS leaf
TLAS_MAX_DEPTH = 48  # the kernels' traversal stacks hold 64 nodes
# a cluster tree's depth: the kernels' per-cluster stacks hold 8 nodes (a
# tree of 128 triangles, 4 a leaf, is 6 levels deep)
CLUSTER_STACK = 8
# Triangles a leaf of a TriBvh. A leaf reads its rows in one or two cache
# lines; halving it adds a level (two slab tests, 48 operations) to save
# about two triangle tests (60 operations in K1, 116 in K5).
TRI_LEAF = 4
# A table of at most this many triangles that can hit is one leaf: a warp
# then runs the whole table in step, where the rays of a walk diverge. On
# the Cornell box's secondary waves (32 triangles) that is 1.5x faster
# than its tree of 4-triangle leaves; on glass_coated's 532 the tree is
# 5-8x faster than a loop over the table (PERF.md, Findings).
ONE_LEAF_MAX = 64
SLACK = 1e-5
BOX_PAD = 1e-4


class TriBvh(NamedTuple):
    """A BVH over the triangles of a table that can hit. Node k is internal
    when kids[k, 0] >= 0 (children kids[k]) and a leaf otherwise, over
    rows[-1 - kids[k, 0]:][:kids[k, 1]]; node 0 is the root. The rows hold
    each triangle's test data, then its index in the table as a float
    (K1: 12 floats, the index and the camera and shadow pass
    probabilities, 0; K5: 25 coefficients, the index, 0, 0). The kernels'
    plain twins ignore it."""

    nodes: torch.Tensor  # [N, 8] f32 padded boxes (lo xyz, hi xyz, 0, 0)
    kids: torch.Tensor   # [N, 2] int32
    rows: torch.Tensor   # [n, 16] (K1) or [n, 28] (K5) f32, leaf order


def build_tlas(lo: np.ndarray, hi: np.ndarray, leaf: int = TLAS_LEAF):
    """Binary BVH over boxes lo, hi [n, 3] (f32): median split of the box
    centres along their longest extent, at most `leaf` boxes a leaf. Returns
    nodes [N, 8] f32 (lo xyz, hi xyz, 0, 0), kids [N, 2] int32 (children, or
    (-1 - first, count) for a leaf over leaf_entries) and leaf_entries [n]
    int32, node 0 the root."""
    cent = (lo.astype(np.float64) + hi.astype(np.float64)) * 0.5
    nodes: list[np.ndarray] = []
    kids: list[list[int]] = []
    leaf_entries: list[int] = []

    def build(idx: np.ndarray, depth: int) -> int:
        if depth > TLAS_MAX_DEPTH:
            raise ValueError("TLAS deeper than the kernel's traversal stack")
        k = len(kids)
        box = np.zeros(8, np.float32)
        box[0:3] = lo[idx].min(axis=0)
        box[3:6] = hi[idx].max(axis=0)
        nodes.append(box)
        kids.append([0, 0])
        if len(idx) <= leaf:
            kids[k] = [-1 - len(leaf_entries), len(idx)]
            leaf_entries.extend(int(i) for i in idx)
            return k
        c = cent[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        srt = idx[np.argsort(c[:, ax], kind="stable")]
        half = len(idx) // 2
        a = build(srt[:half], depth + 1)
        b = build(srt[half:], depth + 1)
        kids[k] = [a, b]
        return k

    build(np.arange(lo.shape[0]), 1)
    return (np.stack(nodes), np.asarray(kids, np.int32), np.asarray(leaf_entries, np.int32))


def tri_boxes(corners: np.ndarray, scale: np.ndarray | None = None
              ) -> tuple[np.ndarray, np.ndarray]:
    """Padded f32 boxes lo, hi [T, 3] of triangles corners [T, 3, 3]
    (float64 vertices; a row with a non-finite corner gets the box of the
    whole f32 range): the slack-widened triangle, BOX_PAD times the largest
    finite coordinate around it (or times `scale` [T], each triangle's
    own), rounded outward."""
    finite = np.isfinite(corners).all(axis=(1, 2))
    p0, p1, p2 = corners[:, 0], corners[:, 1], corners[:, 2]
    e1, e2 = p1 - p0, p2 - p0
    wide = np.stack([p0 - SLACK * (e1 + e2), p0 + (1 + 2 * SLACK) * e1 - SLACK * e2,
                     p0 - SLACK * e1 + (1 + 2 * SLACK) * e2], axis=1)
    if scale is None:
        scale = float(np.abs(corners[finite]).max()) if finite.any() else 0.0
    pad = BOX_PAD * (np.asarray(scale, np.float64)[:, None] if np.ndim(scale) else scale)
    with np.errstate(invalid="ignore"):
        lo = np.where(finite[:, None], wide.min(axis=1) - pad, -FLOAT_MAX)
        hi = np.where(finite[:, None], wide.max(axis=1) + pad, FLOAT_MAX)
    lo = np.nextafter(np.maximum(lo, -FLOAT_MAX).astype(np.float32), np.float32(-np.inf))
    hi = np.nextafter(np.minimum(hi, FLOAT_MAX).astype(np.float32), np.float32(np.inf))
    return lo, hi


def tri_bvh(corners: np.ndarray, can_hit: np.ndarray, rows: np.ndarray, device) -> TriBvh:
    """The TriBvh of a table: its triangles' corners [T, 3, 3] (float64),
    which of them can pass the test at all [T] (bool: the others go into
    no leaf) and their test rows [T, W] f32, whose column `index_col` (the
    first column after the test data, see TriBvh) receives each row's
    table index here."""
    keep = np.nonzero(can_hit)[0]
    width = rows.shape[1]
    if keep.size == 0:  # nothing can hit: one empty leaf
        nodes = np.array([[FLOAT_MAX] * 3 + [-FLOAT_MAX] * 3 + [0, 0]], np.float32)
        kids = np.array([[-1, 0]], np.int32)
        leaf_rows = np.zeros((0, width), np.float32)
    else:
        lo, hi = tri_boxes(corners[keep])
        leaf = keep.size if keep.size <= ONE_LEAF_MAX else TRI_LEAF
        nodes, kids, entries = build_tlas(lo, hi, leaf)
        leaf_rows = np.array(rows[keep[entries]], np.float32)
        leaf_rows[:, index_col(width)] = keep[entries]

    def t(a, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return TriBvh(nodes=t(nodes), kids=t(kids, torch.int32), rows=t(leaf_rows))


class ClusterBvh(NamedTuple):
    """One small BVH per cluster of a clustered triangle table (K2's and
    K3's bottom level), all in one forest: node k is internal when
    kids[k, 0] >= 0 (children kids[k]) and a leaf otherwise, over
    rows[-1 - kids[k, 0]:][:kids[k, 1]]; root[c] is cluster c's root. A
    cluster's nodes and rows are contiguous. The rows hold each lane's
    pass-1 test data (the CLU_N, CLU_R1 and CLU_R2 quads), its lane in
    the cluster as a float and the camera and shadow pass probabilities
    (CLU_OPAC, CLU_OPAC_SH), then 0: one 64-byte line."""

    nodes: torch.Tensor  # [N, 8] f32 padded boxes, in the cluster's frame
    kids: torch.Tensor   # [N, 2] int32
    rows: torch.Tensor   # [n, 16] f32, leaf order
    root: torch.Tensor   # [C] int32


def plane_corners(q: np.ndarray) -> np.ndarray:
    """The corners [T, 3, 3] (float64) of triangles given by their f32
    test rows q [T, 12] (n, d0 | r1, c1 | r2, c2: the TR_N..TR_R2 columns,
    the CLU_N, CLU_R1 and CLU_R2 quads): the points of each plane where
    the test's u, v are (0, 0), (1, 0) and (0, 1), so that a box holds the
    triangle the kernels test. NaN where the system is singular."""
    q = np.asarray(q, np.float64)
    a = np.stack([q[:, 4:7], q[:, 8:11], q[:, 0:3]], axis=1)
    uv = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])  # the corners' u, v
    b = np.stack([uv[None, :, 0] - q[:, 7, None], uv[None, :, 1] - q[:, 11, None],
                  np.repeat(-q[:, 3, None], 3, axis=1)], axis=1)  # [T, 3 eqs, 3 corners]
    corners = np.full((q.shape[0], 3, 3), np.nan)
    with np.errstate(all="ignore"):
        solvable = np.isfinite(a).all(axis=(1, 2)) & (np.abs(np.linalg.det(a)) > 0.0)
    if solvable.any():
        corners[solvable] = np.linalg.solve(a[solvable], b[solvable]).transpose(0, 2, 1)
    return corners


def _segment_boxes(lo: np.ndarray, hi: np.ndarray, start: np.ndarray, count: np.ndarray):
    """min(lo) and max(hi) [m, 3] over the rows start..start + count of
    lo, hi (every count > 0)."""
    idx = np.empty(2 * start.size, np.int64)
    idx[0::2], idx[1::2] = start, start + count
    pad = np.zeros((1, 3), lo.dtype)
    return (np.minimum.reduceat(np.concatenate([lo, pad]), idx)[0::2],
            np.maximum.reduceat(np.concatenate([hi, pad]), idx)[0::2])


def build_forest(lo: np.ndarray, hi: np.ndarray, group: np.ndarray, n_groups: int,
                 leaf: int = TRI_LEAF, max_depth: int = TLAS_MAX_DEPTH):
    """build_tlas over each group of boxes at once: boxes lo, hi [n, 3]
    (f32) sorted by their group [n] (0..n_groups - 1), split level by
    level with build_tlas's median rule, so that each group's tree is the
    one build_tlas makes of it. Returns nodes [N, 8], kids [N, 2] int32
    (leaves over leaf_entries), leaf_entries [n] int32 and root
    [n_groups] int32; an empty group's root is an empty leaf. A group's
    nodes are contiguous, level by level, and so are its leaf entries."""
    n = lo.shape[0]
    cent = (lo.astype(np.float64) + hi.astype(np.float64)) * 0.5
    perm = np.arange(n)
    count = np.bincount(group, minlength=n_groups).astype(np.int64)
    start = np.concatenate([[0], np.cumsum(count)[:-1]]).astype(np.int64)
    node = np.arange(n_groups, dtype=np.int64)  # nodes numbered as made
    seg_group = np.arange(n_groups, dtype=np.int64)
    made = n_groups
    boxes, links, owner, ids = [], [], [], []
    depth = 1
    while start.size:
        if depth > max_depth:
            raise ValueError("cluster tree deeper than the kernel's traversal stack")
        full = count > 0
        box = np.zeros((start.size, 8), np.float32)
        box[:, 0:3], box[:, 3:6] = FLOAT_MAX, -FLOAT_MAX
        if full.any():
            blo, bhi = _segment_boxes(lo[perm], hi[perm], start[full], count[full])
            box[full, 0:3], box[full, 3:6] = blo, bhi
        inner = count > leaf
        k = int(inner.sum())
        kid = np.stack([-1 - start, count], axis=1)
        kid[inner, 0] = made + 2 * np.arange(k)
        kid[inner, 1] = made + 2 * np.arange(k) + 1
        boxes.append(box)
        links.append(kid)
        owner.append(seg_group)
        ids.append(node)
        if not k:
            break
        ist, icn = start[inner], count[inner]
        cmin, cmax = _segment_boxes(cent[perm], cent[perm], ist, icn)
        ax = np.argmax(cmax - cmin, axis=1)
        seg = np.repeat(np.arange(k), icn)
        pos = np.repeat(ist - np.concatenate([[0], np.cumsum(icn)[:-1]]), icn) + np.arange(seg.size)
        key = cent[perm[pos], ax[seg]]
        perm[pos] = perm[pos[np.lexsort((key, seg))]]
        half = icn // 2
        start = np.stack([ist, ist + half], axis=1).reshape(-1)
        count = np.stack([half, icn - half], axis=1).reshape(-1)
        seg_group = np.repeat(seg_group[inner], 2)
        node = made + np.arange(2 * k)
        made += 2 * k
        depth += 1
    ids_all = np.concatenate(ids)
    nodes = np.zeros((made, 8), np.float32)
    kids = np.zeros((made, 2), np.int64)
    grp = np.zeros(made, np.int64)
    nodes[ids_all], kids[ids_all], grp[ids_all] = (np.concatenate(boxes), np.concatenate(links),
                                                   np.concatenate(owner))
    # renumber: each group's nodes together, in the order they were made
    order = np.argsort(grp, kind="stable")
    new_id = np.empty(made, np.int64)
    new_id[order] = np.arange(made)
    nodes, kids = nodes[order], kids[order]
    inner = kids[:, 0] >= 0
    kids[inner] = new_id[kids[inner]]
    return (nodes, kids.astype(np.int32), perm.astype(np.int32),
            new_id[:n_groups].astype(np.int32))


def cluster_bvh(test_rows: np.ndarray, opac: np.ndarray, lanes: int, device) -> ClusterBvh:
    """The ClusterBvh of a clustered table: its lanes' test rows
    [C * lanes, 12] f32 (the CLU_N, CLU_R1 and CLU_R2 quads) and pass
    probabilities opac [C * lanes, 2]. A lane whose plane normal is 0
    (padding) never passes the test and goes into no leaf. Each cluster's
    boxes are padded by BOX_PAD times the largest coordinate of its own
    corners, in its own frame; the kernels add BOX_PAD times the largest
    coordinate of the ray's origin in that frame at run time, so that a
    placement seen from far away, or scaled far down, keeps its margin
    (csrc/bounce.cu walk)."""
    test_rows = np.asarray(test_rows, np.float32)
    n_clusters = test_rows.shape[0] // lanes
    keep = np.nonzero((test_rows[:, 0:3] != 0.0).any(axis=1))[0]
    corners = plane_corners(test_rows[keep])
    group = keep // lanes
    finite = np.isfinite(corners).all(axis=(1, 2))
    size = np.where(finite, np.abs(np.where(finite[:, None, None], corners, 0.0)).max(axis=(1, 2)),
                    0.0)
    scale = np.zeros(n_clusters)
    np.maximum.at(scale, group, size)
    lo, hi = tri_boxes(corners, scale[group])
    nodes, kids, entries, root = build_forest(lo, hi, group, n_clusters, TRI_LEAF, CLUSTER_STACK)
    src = keep[entries]
    rows = np.zeros((src.size, 16), np.float32)
    rows[:, 0:12] = test_rows[src]
    rows[:, 12] = src % lanes
    rows[:, 13:15] = np.asarray(opac, np.float32)[src]

    def t(a, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return ClusterBvh(nodes=t(nodes), kids=t(kids, torch.int32), rows=t(rows),
                      root=t(root, torch.int32))


def index_col(width: int) -> int:
    """The table-index column of TriBvh rows of `width` floats."""
    return {16: 12, 28: 25}[width]


# ---------------------------------------------------------------------------
# The threaded BVH of the wavefront's `bvh` tracer (scenes above 8192
# triangles): a NumPy copy of the JAX package's ops/bvh.py build, walked by
# B1/B2 (csrc/trace.cu) and their twins (ops/trace_ref.py)
# ---------------------------------------------------------------------------

LEAF_SIZE = 4  # triangles a leaf of the threaded BVH (gatling_tpu/ops/bvh.py)
LEAF_BITS = 3  # a node row's leaf word: leaf_start << LEAF_BITS | leaf_count


class BvhArrays(NamedTuple):
    """The threaded BVH as the JAX package's build_bvh returns it (NumPy):
    nodes in depth-first preorder, skip links, and the leaves' ranges in
    the reordered soup."""

    bbox_min: np.ndarray    # [N, 3] f32
    bbox_max: np.ndarray    # [N, 3] f32
    skip: np.ndarray        # [N] int32: the node after this subtree
    leaf_start: np.ndarray  # [N] int32: first triangle of a leaf (reordered soup)
    leaf_count: np.ndarray  # [N] int32: its triangles (0: an interior node)


# B1/B2's wide rows (csrc/trace.cu): each collapses two levels of the
# binary tree into one 128-byte row of at most WIDE children
WIDE = 4
WIDE_ROW = 32       # floats a wide row
WIDE_STACK = 48     # entries of the kernels' traversal stack (trace.cu WIDE_STACK)


class ThreadedBvh(NamedTuple):
    """A threaded BVH on a device, in the rows B1, B2 and their twins read.
    nodes [N, 8] f32, one 32-byte row a node: bbox_min xyz, bbox_max xyz,
    then two int32 words stored bit for bit: skip, and leaf_start <<
    LEAF_BITS | leaf_count. tris [T, 12] f32: the reordered soup's v0, e1,
    e2 and three zeros a triangle (three 16-byte loads). wide [W, 32] f32:
    the same tree's wide rows (`wide_rows`), which the kernels walk; the
    twins walk the node rows."""

    nodes: torch.Tensor
    tris: torch.Tensor
    wide: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def bbox_min(self) -> torch.Tensor:
        return self.nodes[:, 0:3]

    @property
    def bbox_max(self) -> torch.Tensor:
        return self.nodes[:, 3:6]

    @property
    def skip(self) -> torch.Tensor:
        return self.nodes.view(torch.int32)[:, 6]

    @property
    def leaf_start(self) -> torch.Tensor:
        return self.nodes.view(torch.int32)[:, 7] >> LEAF_BITS

    @property
    def leaf_count(self) -> torch.Tensor:
        return self.nodes.view(torch.int32)[:, 7] & ((1 << LEAF_BITS) - 1)


def _morton3(x: np.ndarray) -> np.ndarray:
    """10 bits an axis interleaved into 30-bit Morton codes, x in [0, 1)^3
    (gatling_tpu/ops/bvh.py _morton3)."""
    q = np.clip((x * 1024.0).astype(np.uint64), 0, 1023)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2])


def _tri_boxes(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    v0 = np.asarray(v0, np.float32)
    p1 = v0 + np.asarray(e1, np.float32)
    p2 = v0 + np.asarray(e2, np.float32)
    return np.minimum(np.minimum(v0, p1), p2), np.maximum(np.maximum(v0, p1), p2)


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              leaf_size: int = LEAF_SIZE) -> tuple[BvhArrays, np.ndarray]:
    """The threaded BVH of a soup, built by the native library's
    gatling_build_bvh as gatling_tpu/ops/bvh.py build_bvh builds it:
    triangles sorted by the Morton code of their box centroids, median
    splits over that order down to `leaf_size` triangles a leaf, nodes in
    preorder with skip links. Returns (arrays, order): order reorders the
    soup so that every leaf is a contiguous range. Built over the padded
    soup (its degenerate triangles included), the arrays and the order
    equal the JAX package's and build_bvh_ref's."""
    bbox_min, bbox_max, skip, leaf_start, leaf_count, order = native.build_bvh(
        *_tri_boxes(v0, e1, e2), leaf_size)
    return BvhArrays(bbox_min=bbox_min, bbox_max=bbox_max, skip=skip, leaf_start=leaf_start,
                     leaf_count=leaf_count), order


def build_bvh_ref(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                  leaf_size: int = LEAF_SIZE) -> tuple[BvhArrays, np.ndarray]:
    """build_bvh's NumPy twin (gatling_tpu/ops/bvh.py build_bvh without the
    native library): the same arrays, array for array."""
    tri_min, tri_max = _tri_boxes(v0, e1, e2)
    t = len(tri_min)
    centroid = (tri_min + tri_max) * 0.5
    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    order = np.argsort(_morton3((centroid - lo) / extent), kind="stable").astype(np.int64)
    tri_min = tri_min[order]
    tri_max = tri_max[order]

    # pass 1: median splits in preorder (a node is appended before its
    # subtrees), each interior node's right child recorded
    bbox_min, bbox_max, leaf_start, leaf_count, right_child = [], [], [], [], []
    stack = [(0, t, -1)]  # (start, count, the parent's right_child slot to patch)
    while stack:
        start, count, patch_slot = stack.pop()
        idx = len(right_child)
        if patch_slot >= 0:
            right_child[patch_slot] = idx
        bbox_min.append(tri_min[start:start + count].min(axis=0))
        bbox_max.append(tri_max[start:start + count].max(axis=0))
        if count <= leaf_size:
            leaf_start.append(start)
            leaf_count.append(count)
            right_child.append(-1)
        else:
            leaf_start.append(0)
            leaf_count.append(0)
            right_child.append(0)
            half = count // 2
            stack.append((start + half, count - half, idx))  # the right after the left
            stack.append((start, half, -1))

    # pass 2: skip links; a left child (idx + 1) skips to its sibling, a
    # right child inherits its parent's
    n = len(right_child)
    skip = np.full(n, n, np.int32)
    frames = [(0, n)]
    while frames:
        i, s = frames.pop()
        skip[i] = s
        if leaf_count[i] == 0:
            rc = right_child[i]
            frames.append((i + 1, rc))
            frames.append((rc, s))
    arrays = BvhArrays(bbox_min=np.stack(bbox_min), bbox_max=np.stack(bbox_max), skip=skip,
                       leaf_start=np.array(leaf_start, np.int32),
                       leaf_count=np.array(leaf_count, np.int32))
    return arrays, order


def reorder_geometry(geom, order: np.ndarray):
    """The soup (ops/geometry.py SceneGeometry) in the BVH's triangle order
    (gatling_tpu/ops/bvh.py reorder_geometry): every per-triangle array,
    ids included, so the packed shading rows follow."""
    return type(geom)(*[np.asarray(a)[order] for a in geom])


def wide_rows(arrays: BvhArrays) -> np.ndarray:
    """The threaded BVH collapsed into wide rows [W, WIDE_ROW] f32 (B1's
    and B2's tree): wide node 0 is the binary root, and a wide node's
    children are the binary nodes two levels below it, or a leaf
    met on the way, in the binary preorder (the left child of interior
    node i is i + 1, its right child skip[i + 1]); each interior child is
    a wide node of its own. Rows in level order, one 128-byte row a node:
    the children's bbox_min x, y, z and bbox_max x, y, z, four floats
    each (SoA, copied unchanged from `arrays`; an empty slot NaN, so that
    no slab test passes it), then four int32 words, -1 - its wide row for
    an interior child and leaf_start << LEAF_BITS | leaf_count for a leaf
    (0 for an empty slot), then four unused zero words. A binary box
    holds its descendants' boxes exactly (each is the min/max over its
    triangles' boxes), which is what lets the kernels test the children
    and skip the levels between (csrc/trace.cu). No rows (the kernels
    then walk the node rows) when the root is a leaf, when a box holds a
    NaN (its parent's then does too, and no longer holds its sibling), or
    when the tree is too deep for the kernels' stack."""
    count = arrays.leaf_count
    n = count.shape[0]
    none = np.zeros((0, WIDE_ROW), np.float32)
    if n < 2 or count[0] > 0 or np.isnan(arrays.bbox_min).any() \
            or np.isnan(arrays.bbox_max).any():
        return none
    interior = count == 0
    skip = np.append(arrays.skip, n).astype(np.int64)  # skip[n]: read for a last leaf, unused
    levels, kids = [], []
    frontier = np.zeros(1, np.int64)
    while frontier.size:
        left = frontier + 1  # the frontier's nodes are interior
        right = skip[left]
        inner_l, inner_r = interior[left], interior[right]
        # each child's two children, or the child itself (a leaf) and an empty slot
        a, b = np.where(inner_l, left + 1, left), np.where(inner_l, skip[left + 1], -1)
        c, d = np.where(inner_r, right + 1, right), np.where(inner_r, skip[right + 1], -1)
        # the children first, in preorder; the empty slots after them
        cols = np.stack([a, np.where(inner_l, b, c), np.where(inner_l, c, d),
                         np.where(inner_l, d, -1)], axis=1)
        levels.append(frontier)
        kids.append(cols)
        frontier = cols[(cols >= 0) & interior[np.maximum(cols, 0)]]
    if (WIDE - 1) * len(levels) > WIDE_STACK:
        return none
    order = np.concatenate(levels)
    kid = np.concatenate(kids)
    wide_id = np.full(n, -1, np.int64)
    wide_id[order] = np.arange(order.size)
    slot = kid >= 0
    k = np.maximum(kid, 0)
    box = np.concatenate([arrays.bbox_min[k], arrays.bbox_max[k]], axis=2)  # [W, WIDE, 6]
    box[~slot] = np.nan
    rows = np.zeros((order.size, WIDE_ROW), np.float32)
    rows[:, :6 * WIDE] = box.transpose(0, 2, 1).reshape(order.size, 6 * WIDE)
    words = rows.view(np.int32)
    leaf = (arrays.leaf_start[k].astype(np.int64) << LEAF_BITS) | count[k]
    words[:, 6 * WIDE:7 * WIDE] = np.where(slot, np.where(interior[k], -1 - wide_id[k], leaf), 0)
    return rows


def threaded_bvh(arrays: BvhArrays, soup, device) -> ThreadedBvh:
    """The device rows of `arrays` over the reordered `soup`, and its wide
    rows."""
    n = arrays.skip.shape[0]
    if int(arrays.leaf_start.max(initial=0)) >= 1 << (31 - LEAF_BITS) \
            or int(arrays.leaf_count.max(initial=0)) >= 1 << LEAF_BITS:
        raise ValueError("threaded BVH: a leaf range does not fit its node row's leaf word")
    nodes = np.zeros((n, 8), np.float32)
    nodes[:, 0:3] = arrays.bbox_min
    nodes[:, 3:6] = arrays.bbox_max
    words = nodes.view(np.int32)
    words[:, 6] = arrays.skip
    words[:, 7] = (arrays.leaf_start << LEAF_BITS) | arrays.leaf_count
    tris = np.zeros((soup.v0.shape[0], 12), np.float32)
    tris[:, 0:3], tris[:, 3:6], tris[:, 6:9] = soup.v0, soup.e1, soup.e2
    return ThreadedBvh(nodes=torch.tensor(nodes, device=device),
                       tris=torch.tensor(tris, device=device),
                       wide=torch.tensor(wide_rows(arrays), device=device))
