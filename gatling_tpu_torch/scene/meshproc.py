"""CPU-side mesh processing: triangulation, primvar interpolation,
normal/tangent generation.

Reimplements the mesh conditioning done by the reference's Hydra mesh adapter
(reference: src/hdGatling/mesh.cpp — HdMeshUtil triangulation :844-848,
face-varying primvar de-indexing :647-745, smooth-normal fallback :897-913,
Lengyel tangents :88-229 with a Duff ONB fallback :233-260) as vectorized
NumPy. Everything here runs on host at scene-build time; device arrays are
assembled afterwards by the geometry builder.
"""

from __future__ import annotations

import dataclasses
import enum
import zlib

import numpy as np

from gatling_tpu_torch import native


class Interpolation(enum.Enum):
    """Primvar interpolation (reference: Gi.h GiPrimvarInterpolation + USD)."""

    CONSTANT = "constant"
    UNIFORM = "uniform"  # per face
    VERTEX = "vertex"  # per point, indexed
    VARYING = "varying"  # == vertex for polygonal meshes
    FACE_VARYING = "faceVarying"  # per face-corner
    INSTANCE = "instance"


@dataclasses.dataclass
class TriangulatedMesh:
    """Triangulated, de-indexed mesh. All arrays are per-corner SoA:

    positions[T*3, 3], normals[T*3, 3], tangents[T*3, 3],
    bitangent_signs[T*3], uvs[T*3, 2], face_ids[T] (source polygon index),
    colors[T*3, 3] or None (displayColor primvar expanded per corner).

    The de-indexed ("triangle soup") layout is chosen deliberately: it makes
    every downstream device array a flat buffer the kernels read without
    an index indirection (vs. the reference's indexed
    FVertex + buffer_reference layout tuned for Vulkan, Gi.cpp:845-859).
    """

    positions: np.ndarray
    normals: np.ndarray
    tangents: np.ndarray
    bitangent_signs: np.ndarray
    uvs: np.ndarray
    face_ids: np.ndarray
    colors: np.ndarray | None = None

    @property
    def num_triangles(self) -> int:
        return len(self.face_ids)


_COMPRESS_MIN_BYTES = 1024  # reference: blosc only for buffers >= 1 KiB


@dataclasses.dataclass
class CompressedMesh:
    """A TriangulatedMesh with its buffers byteshuffle+deflate compressed —
    the giProcessMeshData analog (reference: MeshProcessing.cpp:56-78
    blosc level 3 BITSHUFFLE per buffer >= 1 KiB, decompressed lazily at
    BLAS build :214-236). Buffers below the threshold stay raw. The
    geometry builder materializes via decompress_mesh at build time.

    `colors` mirrors TriangulatedMesh.colors for `is not None` presence
    checks (gi.py vertex-color routing)."""

    blobs: dict  # field -> (payload: bytes|np.ndarray, shape, dtype, compressed)
    num_triangles: int
    colors: object = None  # non-None marker when the mesh has vertex colors


def compress_mesh(tm: TriangulatedMesh) -> CompressedMesh:
    """Compress every buffer of a triangulated mesh: byteshuffle + zlib
    level 3 in the native library (gatling_compress, as
    gatling_tpu/scene/meshproc.py compresses; twin `compress_ref`)."""
    blobs: dict = {}
    for f in dataclasses.fields(TriangulatedMesh):
        arr = getattr(tm, f.name)
        if arr is None:
            blobs[f.name] = None
            continue
        arr = np.ascontiguousarray(arr)
        if arr.nbytes < _COMPRESS_MIN_BYTES:
            blobs[f.name] = (arr, arr.shape, arr.dtype, False)
            continue
        blobs[f.name] = (native.compress(arr.view(np.uint8).reshape(-1), arr.dtype.itemsize),
                         arr.shape, arr.dtype, True)
    return CompressedMesh(blobs=blobs, num_triangles=tm.num_triangles,
                          colors=() if tm.colors is not None else None)


def compress_ref(raw: np.ndarray, elem_size: int) -> bytes:
    """native.compress's twin: the byte planes of `raw`, deflated by
    Python's zlib at level 3."""
    return zlib.compress(raw.reshape(-1, elem_size).T.tobytes(), 3)


def decompress_ref(blob: bytes, n: int, elem_size: int) -> np.ndarray:
    """native.decompress's twin: compress_ref's n raw bytes."""
    flat = np.frombuffer(zlib.decompress(blob), np.uint8)
    if flat.size != n:
        raise ValueError(f"a corrupt mesh stream ({n} bytes expected, {flat.size} found)")
    return flat.reshape(elem_size, -1).T.reshape(-1).copy()


def decompress_mesh(cm: CompressedMesh) -> TriangulatedMesh:
    """Inverse of compress_mesh (giDecompressMeshData analog): the native
    gatling_decompress (twin `decompress_ref`)."""
    out = {}
    for name, entry in cm.blobs.items():
        if entry is None:
            out[name] = None
            continue
        payload, shape, dtype, compressed = entry
        if not compressed:
            out[name] = payload
            continue
        raw = native.decompress(payload, int(np.prod(shape)) * dtype.itemsize, dtype.itemsize)
        out[name] = raw.view(dtype).reshape(shape)
    return TriangulatedMesh(**out)


def materialize_mesh(tm) -> TriangulatedMesh:
    """TriangulatedMesh passthrough / CompressedMesh decompression."""
    if isinstance(tm, CompressedMesh):
        return decompress_mesh(tm)
    return tm


def triangulate_counts(face_vertex_counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Fan-triangulate polygon faces.

    Returns (corner_selector[T, 3], face_ids[T]): corner_selector holds
    indices into the flattened faceVertexIndices array for each triangle
    corner (fan around each polygon's first vertex, matching HdMeshUtil's
    fan triangulation used by the reference at mesh.cpp:844-848).
    """
    counts = np.asarray(face_vertex_counts, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])[:-1]
    tri_per_face = np.maximum(counts - 2, 0)
    total = int(tri_per_face.sum())
    face_ids = np.repeat(np.arange(len(counts)), tri_per_face)
    # triangle k within its face: corners (0, k+1, k+2) of the polygon
    k = np.arange(total) - np.repeat(np.concatenate([[0], np.cumsum(tri_per_face)])[:-1], tri_per_face)
    base = offsets[face_ids]
    sel = np.stack([base, base + k + 1, base + k + 2], axis=1)
    return sel.astype(np.int64), face_ids.astype(np.int32)


def expand_primvar(
    data: np.ndarray,
    interpolation: Interpolation,
    corner_sel: np.ndarray,
    face_ids: np.ndarray,
    face_vertex_indices: np.ndarray,
) -> np.ndarray:
    """Expand a primvar to flat per-corner values [T*3, C].

    Handles the same four interpolation modes as the reference's primvar
    processing (mesh.cpp:647-745): constant broadcast, uniform (per-face),
    vertex (indexed by point), faceVarying (indexed by corner).
    """
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    t = len(face_ids)
    if interpolation == Interpolation.CONSTANT:
        return np.broadcast_to(data[0], (t * 3, data.shape[1])).copy()
    if interpolation == Interpolation.UNIFORM:
        return np.repeat(data[face_ids], 3, axis=0)
    if interpolation in (Interpolation.VERTEX, Interpolation.VARYING):
        point_idx = face_vertex_indices[corner_sel.reshape(-1)]
        return data[point_idx]
    if interpolation == Interpolation.FACE_VARYING:
        return data[corner_sel.reshape(-1)]
    raise ValueError(f"unsupported interpolation {interpolation}")


def compute_smooth_normals(points: np.ndarray, face_vertex_indices: np.ndarray,
                           corner_sel: np.ndarray) -> np.ndarray:
    """Area-weighted per-point smooth normals (fallback when the mesh has no
    authored normals, reference: mesh.cpp:897-913)."""
    tri_pts = face_vertex_indices[corner_sel]  # [T,3] point indices
    p0, p1, p2 = (points[tri_pts[:, i]] for i in range(3))
    fn = np.cross(p1 - p0, p2 - p0)  # area-weighted
    normals = np.zeros_like(points)
    for i in range(3):
        np.add.at(normals, tri_pts[:, i], fn)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(lens, 1e-20)


def compute_tangents(positions: np.ndarray, normals: np.ndarray, uvs: np.ndarray | None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Per-corner tangents + bitangent signs.

    With UVs: Lengyel's method per triangle (reference: mesh.cpp:88-229,
    DirectXMesh-style degenerate handling simplified to an ONB fallback).
    Without UVs: Duff orthonormal basis from the normal (mesh.cpp:233-260).
    Inputs are per-corner arrays of length T*3.
    """
    n = normals
    # Duff ONB fallback (matches ops.sampling.orthonormal_basis)
    nz = n[:, 2]
    nsign = np.where(nz >= 0.0, 1.0, -1.0).astype(np.float32)
    a = -1.0 / (nsign + nz)
    b = n[:, 0] * n[:, 1] * a
    fallback = np.stack(
        [1.0 + nsign * n[:, 0] * n[:, 0] * a, nsign * b, -nsign * n[:, 0]], axis=1
    ).astype(np.float32)
    signs = np.ones(len(n), dtype=np.float32)

    if uvs is None:
        return fallback, signs

    p = positions.reshape(-1, 3, 3)
    w = uvs.reshape(-1, 3, 2)
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    duv1 = w[:, 1] - w[:, 0]
    duv2 = w[:, 2] - w[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    ok = np.abs(det) > 1e-12
    inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    t = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv_det[:, None]
    bt = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv_det[:, None]

    t3 = np.repeat(t, 3, axis=0)
    bt3 = np.repeat(bt, 3, axis=0)
    # Gram-Schmidt against the shading normal
    t3 = t3 - n * (t3 * n).sum(axis=1, keepdims=True)
    tl = np.linalg.norm(t3, axis=1, keepdims=True)
    degenerate = (tl[:, 0] < 1e-10) | ~np.repeat(ok, 3)
    t3 = np.where(degenerate[:, None], fallback, t3 / np.maximum(tl, 1e-20))
    handed = (np.cross(n, t3) * bt3).sum(axis=1)
    signs = np.where(degenerate, 1.0, np.where(handed < 0.0, -1.0, 1.0)).astype(np.float32)
    return t3.astype(np.float32), signs


def build_triangulated_mesh(
    points: np.ndarray,
    face_vertex_counts: np.ndarray,
    face_vertex_indices: np.ndarray,
    normals: np.ndarray | None = None,
    normals_interp: Interpolation = Interpolation.FACE_VARYING,
    uvs: np.ndarray | None = None,
    uvs_interp: Interpolation = Interpolation.FACE_VARYING,
    left_handed: bool = False,
    colors: np.ndarray | None = None,
    colors_interp: Interpolation = Interpolation.CONSTANT,
) -> TriangulatedMesh:
    """Full mesh conditioning pipeline -> de-indexed triangle soup."""
    points = np.asarray(points, dtype=np.float32)
    fvi = np.asarray(face_vertex_indices, dtype=np.int64)
    corner_sel, face_ids = triangulate_counts(face_vertex_counts)

    if left_handed:
        # flip winding so geometric normals follow the right-hand rule
        corner_sel = corner_sel[:, ::-1]

    positions = points[fvi[corner_sel.reshape(-1)]]

    if normals is not None:
        nrm = expand_primvar(np.asarray(normals, np.float32), normals_interp,
                             corner_sel, face_ids, fvi)[:, :3]
        lens = np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = nrm / np.maximum(lens, 1e-20)
    else:
        smooth = compute_smooth_normals(points, fvi, corner_sel)
        nrm = smooth[fvi[corner_sel.reshape(-1)]]

    uv = None
    if uvs is not None:
        uv = expand_primvar(np.asarray(uvs, np.float32), uvs_interp,
                            corner_sel, face_ids, fvi)[:, :2]

    col = None
    if colors is not None:
        col = expand_primvar(np.asarray(colors, np.float32), colors_interp,
                             corner_sel, face_ids, fvi)[:, :3]

    tangents, signs = compute_tangents(positions, nrm.astype(np.float32), uv)

    return TriangulatedMesh(
        positions=positions.astype(np.float32),
        normals=nrm.astype(np.float32),
        tangents=tangents,
        bitangent_signs=signs,
        uvs=(uv if uv is not None else np.zeros((len(positions), 2), np.float32)),
        face_ids=face_ids,
        colors=col,
    )
