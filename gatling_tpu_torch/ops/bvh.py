"""Binary BVHs for the kernels' per-ray walks, built once per scene on the host.

Two walks take one:

* K2's TLAS over the level-1 entry boxes of clustered and instanced
  tables (ops/bounce.py walk_tables), TLAS_LEAF entries a leaf;
* the triangle walks of K1, K3 and K4 over a resident table and of K5
  over the wavefront's soup (`TriBvh`), TRI_LEAF triangles a leaf (a
  table of at most ONE_LEAF_MAX is one leaf).

`build_tlas` makes both: a median split of the box centres along their
longest extent. A TriBvh keeps a compact copy of each triangle's test
data in leaf order, with its index in the table, so that a walk reads its
leaves in order and ties go to the lower index as in the brute-force
loops.

What makes a walk equal the brute-force search bit for bit: it runs the
same test on each candidate, and it skips a node only when no triangle
under it can pass that test. So a triangle's box covers its barycentric
slack (the corners at u, v = -SLACK and 1 + 2 SLACK, SLACK ten times the
tests' 1e-6) and is padded by BOX_PAD times the largest coordinate of the
scene: the f32 rounding of a hit point, of u and v, and of the walk's
slab test, each a few ulps of the coordinates (one ulp is 6e-8 of them),
stay far inside it. The walks prune a node only when its entry t is
strictly above the best t, so a tie in another leaf is still visited.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gatling_tpu_torch.interface import FLOAT_MAX

TLAS_LEAF = 2        # level-1 entries per TLAS leaf
TLAS_MAX_DEPTH = 48  # the kernels' traversal stacks hold 64 nodes
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


def tri_boxes(corners: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Padded f32 boxes lo, hi [T, 3] of triangles corners [T, 3, 3]
    (float64 vertices; a row with a non-finite corner gets the box of the
    whole f32 range): the slack-widened triangle, BOX_PAD times the largest
    finite coordinate around it, rounded outward."""
    finite = np.isfinite(corners).all(axis=(1, 2))
    p0, p1, p2 = corners[:, 0], corners[:, 1], corners[:, 2]
    e1, e2 = p1 - p0, p2 - p0
    wide = np.stack([p0 - SLACK * (e1 + e2), p0 + (1 + 2 * SLACK) * e1 - SLACK * e2,
                     p0 - SLACK * e1 + (1 + 2 * SLACK) * e2], axis=1)
    scale = float(np.abs(corners[finite]).max()) if finite.any() else 0.0
    pad = BOX_PAD * scale
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


def index_col(width: int) -> int:
    """The table-index column of TriBvh rows of `width` floats."""
    return {16: 12, 28: 25}[width]
