"""World-space triangle soup (host side, NumPy).

Every mesh instance is pre-transformed into one struct-of-arrays triangle
soup: positions baked to world space, per-triangle material, object, face
and instance ids. The bounce kernels' triangle tables (ops/bounce.py
`tri_rows`) and the wavefront's trace tables and packed rows
(ops/trace.py, `pack_geometry`) are built from it. Stands in for the
reference's BLAS/TLAS and per-mesh payload buffers (reference:
Gi.cpp:784-1204).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gatling_tpu_torch.interface import MESH_FLAG_DOUBLE_SIDED, MESH_FLAG_FLIP_FACING
from gatling_tpu_torch.scene.meshproc import materialize_mesh

PAD_MULTIPLE = 128  # padded triangles are degenerate and never hit


class SceneGeometry(NamedTuple):
    """World-space triangle soup, SoA, padded to a multiple of PAD_MULTIPLE."""

    v0: np.ndarray  # [T,3] f32 first vertex
    e1: np.ndarray  # [T,3] f32 v1 - v0
    e2: np.ndarray  # [T,3] f32 v2 - v0
    n0: np.ndarray  # [T,3] f32 shading normals per corner
    n1: np.ndarray
    n2: np.ndarray
    t0: np.ndarray  # [T,3] f32 tangents per corner
    t1: np.ndarray
    t2: np.ndarray
    bsign: np.ndarray  # [T,3] f32 bitangent signs per corner
    uv0: np.ndarray  # [T,2] f32
    uv1: np.ndarray
    uv2: np.ndarray
    c0: np.ndarray  # [T,3] f32 vertex colors per corner (all ones if none)
    c1: np.ndarray
    c2: np.ndarray
    material_id: np.ndarray  # [T] i32
    object_id: np.ndarray  # [T] i32
    face_id: np.ndarray  # [T] i32 source polygon index
    instance_id: np.ndarray  # [T] i32
    flags: np.ndarray  # [T] i32 MESH_FLAG_* bits

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]


def real_triangles(geom: SceneGeometry) -> int:
    """Triangles before the lane padding: up to the last row whose e1 or e2
    is not zero (a degenerate real triangle before it counts)."""
    real = (np.abs(geom.e1).sum(axis=1) > 0) | (np.abs(geom.e2).sum(axis=1) > 0)
    return int(np.max(np.nonzero(real)[0])) + 1 if real.any() else 0


# column offsets into PackedGeometry.packed_f
PF_V0, PF_E1, PF_E2 = 0, 3, 6
PF_N0, PF_N1, PF_N2 = 9, 12, 15
PF_T0, PF_T1, PF_T2 = 18, 21, 24
PF_BSIGN = 27
PF_UV0, PF_UV1, PF_UV2 = 30, 32, 34
PF_C0, PF_C1, PF_C2 = 36, 39, 42
PF_WIDTH = 45


class PackedGeometry(NamedTuple):
    """The soup's per-triangle rows on a device, read by the wavefront
    integrator's shading state with two row gathers a hit."""

    packed_f: torch.Tensor  # [T, 45] f32: v0 e1 e2 n0 n1 n2 t0 t1 t2 bsign uv0 uv1 uv2 c0 c1 c2
    packed_i: torch.Tensor  # [T, 5] int32: material object face instance flags


def pack_geometry(g: SceneGeometry, device) -> PackedGeometry:
    """The packed row mirrors of the soup (ops/geometry.py pack_geometry)."""
    packed_f = np.concatenate([g.v0, g.e1, g.e2, g.n0, g.n1, g.n2, g.t0, g.t1, g.t2, g.bsign,
                               g.uv0, g.uv1, g.uv2, g.c0, g.c1, g.c2], axis=1)
    packed_i = np.stack([g.material_id, g.object_id, g.face_id, g.instance_id, g.flags], axis=1)
    return PackedGeometry(torch.tensor(packed_f.astype(np.float32), device=device),
                          torch.tensor(packed_i.astype(np.int32), device=device))


def _instance_rows(tm, xform, mesh_desc, material_row: int, object_id: int,
                   instance_id: int) -> dict[str, np.ndarray]:
    """World-space component rows for one mesh instance."""
    m = np.asarray(xform, np.float64)
    lin = m[:3, :3]
    # normals transform by inverse-transpose of the linear part
    try:
        nrm_m = np.linalg.inv(lin).T
    except np.linalg.LinAlgError:
        nrm_m = lin
    det = np.linalg.det(lin)

    p = (tm.positions @ lin + m[3, :3]).reshape(-1, 3, 3)
    # row-vector normal transform: n' = n @ inv(lin)^T
    nrm = tm.normals @ nrm_m
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    tan = tm.tangents @ lin
    tan /= np.maximum(np.linalg.norm(tan, axis=1, keepdims=True), 1e-20)
    n = nrm.reshape(-1, 3, 3)
    t = tan.reshape(-1, 3, 3)
    uv = tm.uvs.reshape(-1, 3, 2)
    n_tris = tm.num_triangles
    if getattr(tm, "colors", None) is not None:
        col = tm.colors.reshape(-1, 3, 3)
    else:
        col = np.ones((n_tris, 3, 3), np.float32)

    flags = MESH_FLAG_DOUBLE_SIDED if mesh_desc.double_sided else 0
    # negative determinant flips facing (reference: isLeftHanded flag)
    if det < 0:
        flags |= MESH_FLAG_FLIP_FACING

    return {
        "p0": p[:, 0], "p1": p[:, 1], "p2": p[:, 2],
        "n0": n[:, 0], "n1": n[:, 1], "n2": n[:, 2],
        "t0": t[:, 0], "t1": t[:, 1], "t2": t[:, 2],
        "bs": tm.bitangent_signs.reshape(-1, 3),
        "uv0": uv[:, 0], "uv1": uv[:, 1], "uv2": uv[:, 2],
        "c0": col[:, 0], "c1": col[:, 1], "c2": col[:, 2],
        "mat": np.full(n_tris, material_row, np.int32),
        "obj": np.full(n_tris, object_id, np.int32),
        "face": tm.face_ids.astype(np.int32),
        "inst": np.full(n_tris, instance_id, np.int32),
        "flags": np.full(n_tris, flags, np.int32),
    }


_VEC3_KEYS = ("p0", "p1", "p2", "n0", "n1", "n2", "t0", "t1", "t2",
              "bs", "c0", "c1", "c2")
_CHUNK_KEYS = _VEC3_KEYS + ("uv0", "uv1", "uv2", "mat", "obj", "face",
                            "inst", "flags")


class GeomCache:
    """Host mirror of the soup for transform edits: the padded component
    arrays (world positions in float64) and, per placement, (mesh desc,
    index among its transforms, first triangle, triangle count). A
    transform edit re-transforms only that placement's slice (the
    reference's instance-array-only TLAS rebuild, Gi.cpp:1188-1202)."""

    def __init__(self, arrays: dict[str, np.ndarray],
                 instances: list[tuple[object, int, int, int]]) -> None:
        self.arrays = arrays
        self.instances = instances


def _geom_from_arrays(cat: dict[str, np.ndarray]) -> SceneGeometry:
    def f32(k):
        return cat[k].astype(np.float32)

    def i32(k):
        return cat[k].astype(np.int32)

    return SceneGeometry(
        v0=f32("p0"),
        e1=(cat["p1"] - cat["p0"]).astype(np.float32),
        e2=(cat["p2"] - cat["p0"]).astype(np.float32),
        n0=f32("n0"), n1=f32("n1"), n2=f32("n2"),
        t0=f32("t0"), t1=f32("t1"), t2=f32("t2"),
        bsign=f32("bs"),
        uv0=f32("uv0"), uv1=f32("uv1"), uv2=f32("uv2"),
        c0=f32("c0"), c1=f32("c1"), c2=f32("c2"),
        material_id=i32("mat"), object_id=i32("obj"),
        face_id=i32("face"), instance_id=i32("inst"), flags=i32("flags"),
    )


def build_geometry_cached(mesh_descs, material_index: dict[str | None, int]
                          ) -> tuple[SceneGeometry, GeomCache]:
    """build_geometry plus the cache that update_instance_transforms edits."""
    chunks: dict[str, list[np.ndarray]] = {k: [] for k in _CHUNK_KEYS}
    instances: list[tuple[object, int, int, int]] = []
    cursor = 0
    for mesh_desc in mesh_descs:
        tm = materialize_mesh(mesh_desc.mesh)
        transforms = mesh_desc.instance_transforms
        if transforms is None:
            transforms = mesh_desc.transform[None]
        for local_i, xform in enumerate(transforms):
            rows = _instance_rows(
                tm, xform, mesh_desc,
                material_index.get(mesh_desc.material, 0),
                mesh_desc.object_id, len(instances))
            for k in _CHUNK_KEYS:
                chunks[k].append(rows[k])
            instances.append((mesh_desc, local_i, cursor, tm.num_triangles))
            cursor += tm.num_triangles

    def empty(k):
        width = 3 if k in _VEC3_KEYS else (2 if k.startswith("uv") else None)
        return np.zeros((0, width) if width else (0,), np.float32)

    cat = {k: np.concatenate(v, axis=0) if v else empty(k)
           for k, v in chunks.items()}
    t_pad = max(PAD_MULTIPLE, -(-cursor // PAD_MULTIPLE) * PAD_MULTIPLE)

    def padded(arr: np.ndarray) -> np.ndarray:
        pad = np.zeros((t_pad - arr.shape[0],) + arr.shape[1:], arr.dtype)
        return np.concatenate([np.ascontiguousarray(arr), pad], axis=0)

    cat = {k: padded(v) for k, v in cat.items()}
    return _geom_from_arrays(cat), GeomCache(cat, instances)


def build_geometry(mesh_descs, material_index: dict[str | None, int]) -> SceneGeometry:
    """Flatten MeshDescs (scene.stage) into one world-space SceneGeometry.

    `material_index` maps material prim path (or None) -> material table row
    (the reference's SBT hitGroupIndex = matIdx * 2, Gi.cpp:1195).
    """
    return build_geometry_cached(mesh_descs, material_index)[0]


def update_instance_transforms(cache: GeomCache, mesh_descs,
                               material_index: dict[str | None, int]) -> SceneGeometry:
    """Re-transform only the placements of `mesh_descs` in the cached soup,
    from their current transforms, with no reordering; returns the
    refreshed SceneGeometry."""
    changed = {id(m) for m in mesh_descs}
    for mesh_desc, local_i, start, count in cache.instances:
        if id(mesh_desc) not in changed:
            continue
        transforms = mesh_desc.instance_transforms
        xform = mesh_desc.transform if transforms is None else transforms[local_i]
        rows = _instance_rows(materialize_mesh(mesh_desc.mesh), xform, mesh_desc,
                              material_index.get(mesh_desc.material, 0),
                              mesh_desc.object_id, int(cache.arrays["inst"][start]))
        for k in _CHUNK_KEYS:
            cache.arrays[k][start:start + count] = rows[k]
    return _geom_from_arrays(cache.arrays)


def build_instance_primvar_tables(mesh_descs) -> dict[str, np.ndarray]:
    """Per-instance primvar tables (gatling_tpu/ops/geometry.py
    build_instance_primvar_tables): {name: [num_instances, 3] f32}, indexed
    by the sequential instance id build_geometry_cached assigns (one a
    (mesh, transform) pair, in mesh_descs order), from each MeshDesc's
    instance_primvars ({name: [K, <= 3]} beside its instance_transforms;
    instancer.cpp:138-189). A mesh without a name holds zeros there; a
    scalar primvar fills x, with y = z = 0. Empty when no mesh has one."""
    names: set[str] = set()
    total = 0
    for md in mesh_descs:
        total += len(md.instance_transforms) if md.instance_transforms is not None else 1
        names.update(getattr(md, "instance_primvars", None) or {})
    if not names:
        return {}
    out = {n: np.zeros((max(total, 1), 3), np.float32) for n in sorted(names)}
    i = 0
    for md in mesh_descs:
        k = len(md.instance_transforms) if md.instance_transforms is not None else 1
        pv = getattr(md, "instance_primvars", None) or {}
        for n in names:
            if n in pv:
                v = np.asarray(pv[n], np.float32).reshape(k, -1)
                w = min(v.shape[1], 3)
                out[n][i:i + k, :w] = v[:, :w]
        i += k
    return out
