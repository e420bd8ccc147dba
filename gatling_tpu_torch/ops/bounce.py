"""Fused bounce: scene tables, ray state, and the dispatch to the kernels.

Host half of the JAX package's ops/pallas_bounce.py: the triangle,
material and light tables, the packed 16-row ray state and the per-bounce
parameter vector, plus `bounce_step`, which runs one bounce. Two table
layouts, as in the JAX package:

* resident (at most RESIDENT_MAX = 4096 triangles): every triangle in one
  [T, 32] table, walked by the kernel K1;
* clustered: 128-triangle clusters under two levels of boxes, walked by
  the kernel K2. Flattened (`build_fused_scene_with_order`: the world
  triangle soup ordered by a median split) or instanced
  (`build_fused_scene_instanced`: each unique mesh's clusters once, in
  its local frame, one level-1 entry per placement and 16 clusters). On
  the card a binary BVH over the level-1 entry boxes (the TLAS, built
  here) replaces the TPU's per-block walk plan.

Normal-mapped and anisotropic scenes add per-corner tangent rows to either
layout (`uses_tangents`). Two flags, set by the builders from the material
table as the JAX package's FusedStatic sets them, ride the FusedScene and
select the kernels' branches: `advanced` (a material needs the full lobe
set: thick refraction, clearcoat or anisotropy) and `cutout` (a triangle's
untextured opacity lets rays through: the resident table appends two
pass-probability columns, the clustered rows carry CLU_OPAC /
CLU_OPAC_SH, the instance rows INST_PASS / INST_PASS_SH). `bounce_step`
runs one bounce of an untextured scene;
a textured scene splits it into `trace_step` (the hit buffer) and
`shade_step`, with the texture stage between (render/fused.py). Each runs:

* on a CUDA tensor, the hand-written kernels of csrc/bounce.cu (K1
  resident and K2 walk bounce, K3 trace, K4 shade), built with nvcc at
  first use into build/torch_ext/ and loaded with ctypes (a plain C
  interface: a source that includes PyTorch's headers takes minutes to
  build, this one seconds). A failed build or launch raises;
* on a CPU tensor, the plain twins ops/bounce_ref.py and ops/split_ref.py.

They are registered as the operators `torch.ops.gatling.bounce_step` (K1),
`bounce_step_walk` (K2), `trace_step` (K3) and `shade_step` (K4).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from gatling_tpu_torch.interface import (
    FLOAT_MAX,
    LightArrays,
    MESH_FLAG_DOUBLE_SIDED,
    MESH_FLAG_FLIP_FACING,
    f32,
)
from gatling_tpu_torch.ops.bounce_ref import (
    CLU_OPAC,
    CLU_OPAC_SH,
    CLU_ROW_MAP,
    CLU_ROW_MAP_TAN,
    CLU_TRI_ROWS,
    CLU_TRI_ROWS_TAN,
    CLUSTER_SIZE,
    CUTOUT_PAD,
    INST_COLS,
    INST_PASS,
    INST_PASS_SH,
    L1_FAN,
    LIGHT_COLS,
    LT_DISK,
    LT_DISTANT,
    LT_RECT,
    LT_SPHERE,
    PARAMS_LEN,
    STATE_ROWS,
    TRI_ROWS,
    TR_D0,
    TR_DS,
    TR_GN,
    TR_MAT,
    TR_N,
    TR_N0,
    TR_N1,
    TR_N2,
    TR_R1,
    TR_R2,
    TR_BS,
    TR_T0,
    TR_T1,
    TR_T2,
    TR_UV,
    TRI_ROWS_TAN,
    WalkTables,
    bounce_ref,
    cutout_xi,
)
from gatling_tpu_torch.ops.cuda_lib import I32, I64, PTR, CudaLibrary, check_tensor
from gatling_tpu_torch.ops.geometry import SceneGeometry
from gatling_tpu_torch.ops.split_ref import (
    HIT_ROWS,
    HIT_ROWS_TAN,
    has_tangents,
    hit_row_count,
    par_row_starts,
    shade_ref,
    trace_ref,
)
from gatling_tpu_torch.ops.sampling import u32_to_f32_bits
from gatling_tpu_torch.render.material import (
    MF_ANISO,
    MF_COAT,
    MF_OPACITY,
    MF_OPACITY_THRESH,
    MF_THIN,
    MF_TRANS,
    MF_VOL_A,
    MF_VOL_S,
    MaterialTable,
)
from gatling_tpu_torch.scene.meshproc import materialize_mesh

RESIDENT_MAX = 4096  # the resident (single-table) branch's triangle ceiling
# The instanced builder's routing rule is the JAX package's, so a scene
# takes the same route in both: instance tables engage above MIN_FLAT
# flattened triangles when instancing saves MIN_GAIN times the triangles,
# or for any scene of several placements, as long as the unique clusters
# stay under CLU_VMEM_MAX_BYTES. All three were measured on a TPU v5e
# (where 56 MB is what its VMEM holds); on the card they are inherited.
MIN_GAIN = 4.0
MIN_FLAT = 4096
CLU_VMEM_MAX_BYTES = 56 * 1024 * 1024
# materials + lights staged in shared memory per block
SMEM_TABLE_MAX_BYTES = 48 * 1024
TLAS_LEAF = 2      # level-1 entries per TLAS leaf
TLAS_MAX_DEPTH = 48  # the kernel's traversal stack holds 64 nodes
BOUNCE_PARTS = 5  # csrc/bounce.cu compiles in this many nvcc runs at once (GATLING_PART)



# ---------------------------------------------------------------------------
# scene tables
# ---------------------------------------------------------------------------

class FusedScene(NamedTuple):
    """Device tables for the bounce kernels."""

    tris: torch.Tensor         # resident [T, 32]; clustered [C * 128, 40] f32
    mats: torch.Tensor         # [M, 30] f32 packed material rows
    lights: torch.Tensor       # [max(L,1), 20] f32, type-major slots
    light_types: torch.Tensor  # [L] int8 LT_* per slot
    walk: WalkTables | None = None  # clustered and instanced scenes
    advanced: bool = False     # the full lobe set in the shading
    cutout: bool = False       # stochastic cutout in the searches


@dataclasses.dataclass(frozen=True)
class FusedStatic:
    """Static scene shape info."""

    n_tris: int
    light_types: tuple[int, ...]
    n_clusters: int = 0   # 0: resident; instanced: unique local clusters
    n_l1: int = 1
    n_instances: int = 0  # > 0: instanced
    tangents: bool = False  # per-corner tangent rows in the tables (normal maps)
    # split-bounce mode (K3, the texture stage, K4): the scene has textures
    textured: bool = False
    textured_params: tuple[str, ...] = ()  # the parameters some material textures
    advanced: bool = False  # a material needs the full lobe set (FusedScene.advanced)
    cutout: bool = False    # some triangle's pass probability is below 1

    @property
    def clustered(self) -> bool:
        return self.n_clusters > 0

    @property
    def instanced(self) -> bool:
        return self.n_instances > 0


class ClusterArrays(NamedTuple):
    """Clustered tables as NumPy, in the JAX package's FusedScene layout
    (the tests compare them with the JAX builders')."""

    tris: np.ndarray                     # [C_pad, 40, 128] f32
    l1: np.ndarray                       # [8, n_l1] f32 (rows 0-5: lo xyz, hi xyz)
    l2: np.ndarray                       # [8, n_l1 * 16] f32
    inst_smem: np.ndarray | None = None  # [n_l1, 16] f32: A3, a_t, pass, fan, pass_sh
    inst_map: np.ndarray | None = None   # [n_l1 * 16] int32 -> unique cluster
    inst_attr: np.ndarray | None = None  # [lanes, 24] f32: A3, a_t, mat, obj, entry, ds


@dataclasses.dataclass
class UniqueClusters:
    """The unique meshes' local clusters, by identity of the mesh object,
    and their cluster table. Built once for a set of meshes and kept across
    transform edits of them, which rebuild only the instance tables."""

    meshes: dict[int, dict] = dataclasses.field(default_factory=dict)
    tris: np.ndarray | None = None  # [uc + 1, 40, 128] f32; the last cluster padding


def _duff_onb_np(n: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Duff et al. ONB, numpy mirror of ops.sampling.orthonormal_basis."""
    x, y, z = float(n[0]), float(n[1]), float(n[2])
    s = 1.0 if z >= 0.0 else -1.0
    a = -1.0 / (s + z)
    b = x * y * a
    b1 = np.array([1.0 + s * x * x * a, s * b, -s * x], np.float32)
    b2 = np.array([b, s + y * y * a, -y], np.float32)
    return b1, b2


def build_fused_lights(arrays: LightArrays) -> tuple[np.ndarray, tuple[int, ...]]:
    """Pack LightArrays into the kernel light table + type list.

    Slot order is type-major (spheres, distants, rects, disks): the pick
    arithmetic of the light sampler relies on it. Columns: emission 14-16,
    diffuse/specular 17-18; sphere: pos 0-2, radii 3-5, area 9. distant:
    -dir 0-2, onb_t1 3-5, onb_t2 6-8, angle 9, inv_pdf 10. rect: origin 0-2,
    t0 3-5, t1 6-8, size 9-10, normal 11-13. disk: origin 0-2, t0 3-5,
    t1 6-8, radii 9-10, normal 11-13.
    """
    rows: list[np.ndarray] = []
    types: list[int] = []

    def emit(t: int) -> np.ndarray:
        row = np.zeros(LIGHT_COLS, np.float32)
        rows.append(row)
        types.append(t)
        return row

    for i in range(int(arrays.sphere_count)):
        r = emit(LT_SPHERE)
        r[0:3] = arrays.sphere_pos[i]
        r[3:6] = arrays.sphere_radius[i]
        r[9] = float(arrays.sphere_area[i])
        r[14:17] = arrays.sphere_emission[i]
        r[17:19] = arrays.sphere_diff_spec[i]
    for i in range(int(arrays.distant_count)):
        r = emit(LT_DISTANT)
        dir0 = -np.asarray(arrays.distant_dir[i], np.float32)
        t1b, t2b = _duff_onb_np(dir0)
        r[0:3] = dir0
        r[3:6] = t1b
        r[6:9] = t2b
        r[9] = float(arrays.distant_angle[i])
        r[10] = float(arrays.distant_inv_pdf[i])
        r[14:17] = arrays.distant_emission[i]
        r[17:19] = arrays.distant_diff_spec[i]
    for i in range(int(arrays.rect_count)):
        r = emit(LT_RECT)
        t0 = np.asarray(arrays.rect_t0[i], np.float32)
        t1 = np.asarray(arrays.rect_t1[i], np.float32)
        r[0:3] = arrays.rect_origin[i]
        r[3:6] = t0
        r[6:9] = t1
        r[9:11] = arrays.rect_size[i]
        r[11:14] = np.cross(t1, t0)  # UsdLux forward is -Z
        r[14:17] = arrays.rect_emission[i]
        r[17:19] = arrays.rect_diff_spec[i]
    for i in range(int(arrays.disk_count)):
        r = emit(LT_DISK)
        t0 = np.asarray(arrays.disk_t0[i], np.float32)
        t1 = np.asarray(arrays.disk_t1[i], np.float32)
        r[0:3] = arrays.disk_origin[i]
        r[3:6] = t0
        r[6:9] = t1
        r[9:11] = arrays.disk_radius[i]
        r[11:14] = np.cross(t1, t0)
        r[14:17] = arrays.disk_emission[i]
        r[17:19] = arrays.disk_diff_spec[i]

    table = np.stack(rows) if rows else np.zeros((1, LIGHT_COLS), np.float32)
    return table.astype(np.float32), tuple(types)


def _light_table(light_arrays: LightArrays | None) -> tuple[np.ndarray, tuple[int, ...]]:
    if light_arrays is None:
        return np.zeros((1, LIGHT_COLS), np.float32), ()
    return build_fused_lights(light_arrays)


def tri_rows(geom, tangents: bool = False, cutout_prob: np.ndarray | None = None,
             shadow_prob: np.ndarray | None = None) -> np.ndarray:
    """Per-triangle kernel rows [T, 32] (Baldwin-Weber precompute), built in
    float64 and stored as f32; [T, 48] with the tangent rows TR_T0..TR_BS
    of normal-mapped scenes; plus the camera and shadow pass-probability
    columns of a cutout scene, [T, 34] or [T, 50] (pallas_bounce.py
    _tri_rows, the JAX layout; from_jax_tables pads them)."""
    v0 = np.asarray(geom.v0, np.float64)
    e1 = np.asarray(geom.e1, np.float64)
    e2 = np.asarray(geom.e2, np.float64)
    n = np.cross(e1, e2)
    nn = np.maximum((n * n).sum(axis=1, keepdims=True), 1e-30)
    d0 = -(n * v0).sum(axis=1)
    r1 = np.cross(e2, n) / nn
    c1 = -(r1 * v0).sum(axis=1)
    r2 = np.cross(n, e1) / nn
    c2 = -(r2 * v0).sum(axis=1)

    gn = n / np.sqrt(nn)
    flags = np.asarray(geom.flags)
    flip = (flags & MESH_FLAG_FLIP_FACING) != 0
    gn = np.where(flip[:, None], -gn, gn)

    # fully degenerate (padding) triangles must never hit: n == 0 => ndotd == 0
    degen = np.abs(n).sum(axis=1) == 0.0
    n = np.where(degen[:, None], 0.0, n)

    base = TRI_ROWS_TAN if tangents else TRI_ROWS
    rows = np.zeros((v0.shape[0], base + (2 if cutout_prob is not None else 0)), np.float32)
    rows[:, TR_N:TR_N + 3] = n
    rows[:, TR_D0] = d0
    rows[:, TR_R1:TR_R1 + 3] = r1
    rows[:, TR_R1 + 3] = c1
    rows[:, TR_R2:TR_R2 + 3] = r2
    rows[:, TR_R2 + 3] = c2
    rows[:, TR_GN:TR_GN + 3] = gn
    rows[:, TR_N0:TR_N0 + 3] = geom.n0
    rows[:, TR_N1:TR_N1 + 3] = geom.n1
    rows[:, TR_N2:TR_N2 + 3] = geom.n2
    rows[:, TR_MAT] = np.asarray(geom.material_id).astype(np.float32)
    rows[:, TR_DS] = ((flags & MESH_FLAG_DOUBLE_SIDED) != 0).astype(np.float32)
    rows[:, TR_UV:TR_UV + 2] = geom.uv0
    rows[:, TR_UV + 2:TR_UV + 4] = geom.uv1
    rows[:, TR_UV + 4:TR_UV + 6] = geom.uv2
    if tangents:
        rows[:, TR_T0:TR_T0 + 3] = geom.t0
        rows[:, TR_T1:TR_T1 + 3] = geom.t1
        rows[:, TR_T2:TR_T2 + 3] = geom.t2
        rows[:, TR_BS:TR_BS + 3] = geom.bsign
    if cutout_prob is not None:
        rows[:, base] = cutout_prob
        rows[:, base + 1] = cutout_prob if shadow_prob is None else shadow_prob
    return rows


def _material_pass(table: MaterialTable) -> np.ndarray:
    """[M] stochastic-cutout pass probability per material (1 = opaque);
    opacity-textured materials count as opaque here, as in the JAX
    package, where its re-trace stage resolves them."""
    pf = table.packed_f
    per_mat = np.where(pf[:, MF_OPACITY_THRESH] > 0.0,
                       (pf[:, MF_OPACITY] >= pf[:, MF_OPACITY_THRESH]).astype(np.float32),
                       pf[:, MF_OPACITY])
    return np.where(table.opacity_tex >= 0, 1.0, per_mat).astype(np.float32)


def advanced_from_table(table: MaterialTable) -> bool:
    """A material needs the full lobe set: thick refractive transmission,
    clearcoat or anisotropy (pallas_bounce.py _advanced_from_table)."""
    pf = np.asarray(table.packed_f)
    thick = (pf[:, MF_TRANS] > 0.0) & (pf[:, MF_THIN] < 0.5)
    return bool(thick.any() or (pf[:, MF_COAT] > 0.0).any() or aniso_from_table(table))


def aniso_from_table(table: MaterialTable) -> bool:
    return bool((np.asarray(table.packed_f)[:, MF_ANISO] != 0.0).any())


def uses_tangents(table: MaterialTable) -> bool:
    """Tangent rows ride the tables when a material binds a normal map or
    is anisotropic, whose frame is the mesh tangent (pallas_bounce.py
    :661-664)."""
    return bool((np.asarray(table.normal_tex) >= 0).any() or aniso_from_table(table))


def has_volumes(table: MaterialTable) -> bool:
    """Some material has absorption or scattering coefficients."""
    pf = np.asarray(table.packed_f)
    return bool((pf[:, MF_VOL_A:MF_VOL_A + 3] > 0.0).any()
                or (pf[:, MF_VOL_S:MF_VOL_S + 3] > 0.0).any())


def check_slice(table: MaterialTable) -> None:
    """Raise on scene content the ported kernels do not cover: volume
    coefficients, which only the MDL front end produces."""
    if has_volumes(table):
        raise NotImplementedError(
            "volume absorption and scattering are not ported yet (ROADMAP: 'USD content', "
            "with the MDL front end that produces them)")


def real_triangles(geom: SceneGeometry) -> int:
    """Triangles before the lane padding (degenerate rows at the end)."""
    real = (np.abs(geom.e1).sum(axis=1) > 0) | (np.abs(geom.e2).sum(axis=1) > 0)
    return int(np.max(np.nonzero(real)[0])) + 1 if real.any() else 0


def build_fused_scene(geom: SceneGeometry, table: MaterialTable,
                      light_arrays: LightArrays | None, device: torch.device | str,
                      resident_max: int = RESIDENT_MAX) -> tuple[FusedScene, FusedStatic]:
    """Kernel tables of a flattened scene: resident up to `resident_max`
    triangles, clustered above."""
    scene, static, _order = build_fused_scene_with_order(geom, table, light_arrays, device,
                                                         resident_max)
    return scene, static


def build_fused_scene_with_order(
    geom: SceneGeometry, table: MaterialTable, light_arrays: LightArrays | None,
    device: torch.device | str, resident_max: int = RESIDENT_MAX,
    reuse_order: np.ndarray | None = None,
) -> tuple[FusedScene, FusedStatic, np.ndarray | None]:
    """The JAX package's build_fused_scene_with_order: resident tables up
    to `resident_max` real triangles, else clustered tables in a median-
    split triangle order, which is returned so that a transform edit can
    refit the tables under the same order (`reuse_order`) instead of
    re-sorting."""
    n_real = real_triangles(geom)
    geom = SceneGeometry(*[arr[:n_real] for arr in geom])
    check_slice(table)
    light_table, light_types = _light_table(light_arrays)
    tangents = uses_tangents(table)
    advanced = advanced_from_table(table)
    mid = np.clip(np.asarray(geom.material_id), 0, table.packed_f.shape[0] - 1)
    pass_prob = _material_pass(table)[mid]
    cutout = bool((pass_prob < 1.0).any())
    if n_real <= resident_max:
        rows = tri_rows(geom, tangents, pass_prob if cutout else None)
        scene = from_jax_tables(rows.T, table.packed_f, light_table, light_types, device,
                                advanced=advanced, cutout=cutout)
        return scene, FusedStatic(n_tris=n_real, light_types=light_types, tangents=tangents,
                                  advanced=advanced, cutout=cutout), None

    order = reuse_order if reuse_order is not None else median_split_order(geom, n_real)
    arrays = clustered_arrays(geom, table, order)
    n_clusters = -(-n_real // CLUSTER_SIZE)
    scene = from_jax_tables(arrays.tris, table.packed_f, light_table, light_types, device,
                            l1=arrays.l1, l2=arrays.l2, advanced=advanced, cutout=cutout)
    static = FusedStatic(n_tris=n_real, light_types=light_types, n_clusters=n_clusters,
                         n_l1=arrays.l1.shape[1], tangents=tangents, advanced=advanced,
                         cutout=cutout)
    return scene, static, order


def median_split_order(geom, n_real: int, leaf: int = CLUSTER_SIZE) -> np.ndarray:
    """Recursive longest-axis median split of the triangle centroids into
    `leaf`-sized runs (pallas_bounce.py _median_split_order): every
    CLUSTER_SIZE-aligned run of the returned order is a spatially compact
    cluster, and groups of L1_FAN consecutive clusters one level up."""
    v0 = np.asarray(geom.v0[:n_real], np.float64)
    e1 = np.asarray(geom.e1[:n_real], np.float64)
    e2 = np.asarray(geom.e2[:n_real], np.float64)
    cent = v0 + (e1 + e2) / 3.0
    order = np.empty(n_real, np.int64)
    pos = 0
    stack = [np.arange(n_real)]
    while stack:
        idx = stack.pop()
        if len(idx) <= leaf:
            order[pos:pos + len(idx)] = idx
            pos += len(idx)
            continue
        c = cent[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        # split at the multiple of `leaf` nearest the median, so that every
        # leaf but the global tail holds exactly `leaf` triangles
        half = ((len(idx) // 2 + leaf - 1) // leaf) * leaf
        half = min(max(half, leaf), len(idx) - 1)
        part = np.argpartition(c[:, ax], half)
        stack.append(idx[part[half:]])  # right emitted after left (LIFO)
        stack.append(idx[part[:half]])
    return order


def _morton_codes(points: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points [N, 3] on a 1024^3 grid over their box."""
    lo = points.min(axis=0)
    span = np.maximum(points.max(axis=0) - lo, 1e-12)
    q = np.clip((points - lo) / span * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (spread(q[:, 2]) << np.uint64(2))


def morton_order(geom, n_real: int) -> np.ndarray:
    """Triangle order along the Morton curve of the centroids
    (pallas_bounce.py _morton_order)."""
    v0 = np.asarray(geom.v0[:n_real], np.float64)
    e1 = np.asarray(geom.e1[:n_real], np.float64)
    e2 = np.asarray(geom.e2[:n_real], np.float64)
    return np.argsort(_morton_codes(v0 + (e1 + e2) / 3.0), kind="stable")


def _cluster_rows(geom, n_clusters: int, tangents: bool = False) -> np.ndarray:
    """[n_clusters * 128, 40] CLU_* rows of `geom`'s triangles in order,
    padding rows zero; [.., 56] with the tangent rows CLU_T0..CLU_BS."""
    rows = tri_rows(geom, tangents)
    row_map = CLU_ROW_MAP_TAN if tangents else CLU_ROW_MAP
    out = np.zeros((n_clusters * CLUSTER_SIZE, CLU_TRI_ROWS_TAN if tangents else CLU_TRI_ROWS),
                   np.float32)
    out[:rows.shape[0], [dst for _, dst in row_map]] = rows[:, [src for src, _ in row_map]]
    return out


def _cluster_boxes(geom, n_clusters: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-cluster [n_clusters, 3] lo and hi corners (float64) of `geom`'s
    triangles in order; all-padding clusters get empty boxes."""
    nt = np.asarray(geom.v0).shape[0]
    v0 = np.asarray(geom.v0, np.float64)
    v1 = v0 + np.asarray(geom.e1, np.float64)
    v2 = v0 + np.asarray(geom.e2, np.float64)
    t_pad = n_clusters * CLUSTER_SIZE
    lo = np.full((t_pad, 3), FLOAT_MAX, np.float64)
    hi = np.full((t_pad, 3), -FLOAT_MAX, np.float64)
    lo[:nt] = np.minimum(np.minimum(v0, v1), v2)
    hi[:nt] = np.maximum(np.maximum(v0, v1), v2)
    return (lo.reshape(n_clusters, CLUSTER_SIZE, 3).min(axis=1),
            hi.reshape(n_clusters, CLUSTER_SIZE, 3).max(axis=1))


def clustered_arrays(geom: SceneGeometry, table: MaterialTable,
                     order: np.ndarray) -> ClusterArrays:
    """Flattened clustered tables of the real triangles of `geom`, in
    `order` (the clustered branch of build_fused_scene_with_order)."""
    n_real = len(order)
    mid = np.clip(np.asarray(geom.material_id), 0, table.packed_f.shape[0] - 1)
    pass_prob = _material_pass(table)[mid].astype(np.float32)[order]
    geom = SceneGeometry(*[np.asarray(arr)[order] for arr in geom])
    n_clusters = -(-n_real // CLUSTER_SIZE)
    n_l1 = -(-n_clusters // L1_FAN)
    c_pad = n_l1 * L1_FAN
    rows = _cluster_rows(geom, c_pad, uses_tangents(table))
    rows[:n_real, CLU_OPAC] = pass_prob
    rows[:n_real, CLU_OPAC_SH] = pass_prob
    tris = rows.reshape(c_pad, CLUSTER_SIZE, rows.shape[1]).transpose(0, 2, 1).copy()

    l2min, l2max = _cluster_boxes(geom, c_pad)
    l2 = np.zeros((8, c_pad), np.float32)
    l2[0:3] = l2min.T
    l2[3:6] = l2max.T
    l1 = np.zeros((8, n_l1), np.float32)
    l1[0:3] = l2min.reshape(n_l1, L1_FAN, 3).min(axis=1).T
    l1[3:6] = l2max.reshape(n_l1, L1_FAN, 3).max(axis=1).T
    return ClusterArrays(tris=tris, l1=l1, l2=l2)


def instanced_arrays(mesh_descs, material_index: dict, table: MaterialTable,
                     min_gain: float = MIN_GAIN, min_flat: int = MIN_FLAT,
                     clusters: UniqueClusters | None = None):
    """Two-level instanced tables (pallas_bounce.py
    build_fused_scene_instanced, without the TPU-only bf16 transform
    operand): each unique mesh (by identity of its mesh object) keeps its
    triangles once, as median-split clusters in its local frame; each
    placement adds level-1 entries of at most L1_FAN of its mesh's
    clusters, with world boxes and the world->local transform, in Morton
    order of the placements' translations. Per-placement material, object
    and double-sided flag ride the instance rows.

    `clusters`, when given, holds the unique clusters across calls on the
    same meshes: it is filled by the first call, and later calls only
    rebuild the instance tables over it (a transform edit's refit).

    Returns (ClusterArrays, FusedStatic fields) or None when the scene
    does not take this route (the JAX package's rule, see MIN_GAIN)."""
    mat_pass = _material_pass(table)
    tangents = uses_tangents(table)
    n_rows = CLU_TRI_ROWS_TAN if tangents else CLU_TRI_ROWS
    clusters = UniqueClusters() if clusters is None else clusters
    uniq = clusters.meshes
    insts: list[dict] = []
    flat_tris = 0
    for md in mesh_descs:
        key = id(md.mesh)
        if key not in uniq:
            tm = materialize_mesh(md.mesh)
            nt = tm.num_triangles
            p = tm.positions.reshape(-1, 3, 3)
            nrm = tm.normals.reshape(-1, 3, 3)
            uv = tm.uvs.reshape(-1, 3, 2)
            tan = tm.tangents.reshape(-1, 3, 3)
            g = dict(v0=p[:, 0], e1=p[:, 1] - p[:, 0], e2=p[:, 2] - p[:, 0],
                     n0=nrm[:, 0], n1=nrm[:, 1], n2=nrm[:, 2],
                     uv0=uv[:, 0], uv1=uv[:, 1], uv2=uv[:, 2],
                     t0=tan[:, 0], t1=tan[:, 1], t2=tan[:, 2],
                     bsign=tm.bitangent_signs.reshape(-1, 3),
                     material_id=np.zeros(nt, np.int32), flags=np.zeros(nt, np.int32))
            order = median_split_order(SimpleNamespace(**g), nt) if nt > CLUSTER_SIZE \
                else np.arange(nt)
            uniq[key] = {"geom": SimpleNamespace(**{k: np.asarray(v)[order] for k, v in g.items()}),
                         "n": nt, "n_clusters": -(-nt // CLUSTER_SIZE)}
        transforms = md.instance_transforms
        if transforms is None:
            transforms = np.asarray(md.transform)[None]
        mat_row = material_index.get(md.material, 0)
        mpass = float(mat_pass[min(mat_row, len(mat_pass) - 1)])
        for xf in np.asarray(transforms, np.float64):
            m3 = xf[:3, :3]
            if abs(np.linalg.det(m3)) < 1e-30:
                return None  # a placement that cannot be inverted
            a3 = np.linalg.inv(m3)
            insts.append({"key": key, "m3": m3, "m_t": xf[3, :3], "a3": a3,
                          "a_t": -xf[3, :3] @ a3, "mat": mat_row, "obj": md.object_id,
                          "ds": 1.0 if md.double_sided else 0.0, "pass": mpass})
        flat_tris += uniq[key]["n"] * len(transforms)

    unique_tris = sum(i["n"] for i in uniq.values())
    if flat_tris <= min_flat or unique_tris == 0:
        return None
    gain = flat_tris / max(unique_tris, 1)
    uniq_bytes = sum(i["n_clusters"] for i in uniq.values()) * CLUSTER_SIZE * n_rows * 4
    object_walk = len(insts) >= 2 and uniq_bytes <= CLU_VMEM_MAX_BYTES
    if gain < min_gain and not object_walk:
        return None
    if uniq_bytes > CLU_VMEM_MAX_BYTES:
        return None

    if clusters.tris is None:
        # unique local clusters, then one all-degenerate cluster for pad slots
        blocks: list[np.ndarray] = []
        for info in uniq.values():
            rows = _cluster_rows(info["geom"], info["n_clusters"], tangents)
            rows[:info["n"], CLU_OPAC] = 1.0
            info["cluster_base"] = len(blocks)
            blocks.extend(rows.reshape(-1, CLUSTER_SIZE, n_rows).transpose(0, 2, 1))
            info["c_lo"], info["c_hi"] = _cluster_boxes(info["geom"], info["n_clusters"])
        blocks.append(np.zeros((n_rows, CLUSTER_SIZE), np.float32))
        clusters.tris = np.stack(blocks)
    tris = clusters.tris
    uc = tris.shape[0] - 1
    if tris.nbytes > CLU_VMEM_MAX_BYTES:
        return None

    # level-1 entries: each covers at most L1_FAN clusters of one placement
    entries = [(inst, c0, min(L1_FAN, uniq[inst["key"]]["n_clusters"] - c0))
               for inst in insts for c0 in range(0, uniq[inst["key"]]["n_clusters"], L1_FAN)]
    code = _morton_codes(np.array([e[0]["m_t"] for e in entries], np.float64))
    entries = [entries[i] for i in np.argsort(code, kind="stable")]
    n_l1 = len(entries)
    c_pad = n_l1 * L1_FAN
    l1 = np.zeros((8, n_l1), np.float32)
    l2 = np.zeros((8, c_pad), np.float32)
    l2[0:3] = FLOAT_MAX
    l2[3:6] = -FLOAT_MAX
    inst_map = np.full((c_pad,), uc, np.int32)
    inst_smem = np.zeros((n_l1, 16), np.float32)
    inst_attr = np.zeros((max(128, -(-n_l1 // 128) * 128), 24), np.float32)
    corner_bits = np.array([[(b >> k) & 1 for k in range(3)] for b in range(8)], bool)
    for e, (inst, c0, nc) in enumerate(entries):
        info = uniq[inst["key"]]
        lo = info["c_lo"][c0:c0 + nc]
        hi = info["c_hi"][c0:c0 + nc]
        # world cluster boxes from the 8 transformed local corners
        wc = np.where(corner_bits[None], hi[:, None, :], lo[:, None, :]) @ inst["m3"] + inst["m_t"]
        empty = lo[:, 0] > hi[:, 0]
        wlo = np.where(empty[:, None], FLOAT_MAX, wc.min(axis=1))
        whi = np.where(empty[:, None], -FLOAT_MAX, wc.max(axis=1))
        l2[0:3, e * L1_FAN:e * L1_FAN + nc] = wlo.T
        l2[3:6, e * L1_FAN:e * L1_FAN + nc] = whi.T
        l1[0:3, e] = wlo.min(axis=0)
        l1[3:6, e] = whi.max(axis=0)
        inst_map[e * L1_FAN:e * L1_FAN + nc] = info["cluster_base"] + c0 + np.arange(nc)
        a3 = inst["a3"].astype(np.float32).reshape(-1)
        inst_smem[e, 0:9] = a3
        inst_smem[e, 9:12] = inst["a_t"]
        inst_smem[e, 12] = inst["pass"]
        inst_smem[e, 13] = float(nc)
        inst_smem[e, 14] = inst["pass"]
        inst_attr[e, 0:9] = a3
        inst_attr[e, 9:12] = inst["a_t"]
        inst_attr[e, 12] = float(inst["mat"])
        inst_attr[e, 13] = float(inst["obj"])
        inst_attr[e, 14] = float(e)
        inst_attr[e, 15] = inst["ds"]
    arrays = ClusterArrays(tris=tris, l1=l1, l2=l2, inst_smem=inst_smem, inst_map=inst_map,
                           inst_attr=inst_attr)
    cutout = bool((inst_smem[:, 12] < 1.0).any() or (inst_smem[:, 14] < 1.0).any())
    return arrays, dict(n_tris=flat_tris, n_clusters=uc, n_l1=n_l1, n_instances=len(insts),
                        tangents=tangents, advanced=advanced_from_table(table), cutout=cutout)


def build_fused_scene_instanced(mesh_descs, material_index: dict, table: MaterialTable,
                                light_arrays: LightArrays | None, device,
                                min_gain: float = MIN_GAIN, min_flat: int = MIN_FLAT,
                                clusters: UniqueClusters | None = None):
    """Instanced kernel tables (see instanced_arrays), or None when the
    scene takes the flattened route."""
    res = instanced_arrays(mesh_descs, material_index, table, min_gain, min_flat, clusters)
    if res is None:
        return None
    arrays, counts = res
    light_table, light_types = _light_table(light_arrays)
    scene = from_jax_tables(arrays.tris, table.packed_f, light_table, light_types, device,
                            l1=arrays.l1, l2=arrays.l2, inst_map=arrays.inst_map,
                            inst_attr=arrays.inst_attr, inst_smem=arrays.inst_smem,
                            advanced=counts["advanced"], cutout=counts["cutout"])
    return scene, FusedStatic(light_types=light_types, **counts)


def refit_instanced(scene: FusedScene, clusters: UniqueClusters, mesh_descs,
                    material_index: dict, table: MaterialTable) -> FusedScene | None:
    """Transform-only refresh of instanced tables built with `clusters`:
    the instance tables and the TLAS are rebuilt over the cached unique
    clusters, and the device cluster table is kept. None when the edit
    took the scene off the instanced route."""
    res = instanced_arrays(mesh_descs, material_index, table, clusters=clusters)
    if res is None:
        return None
    a, counts = res
    return scene._replace(walk=walk_tables(a.l1, a.l2, a.inst_map, a.inst_attr,
                                           scene.tris.device, a.inst_smem),
                          cutout=counts["cutout"])


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


def walk_tables(l1: np.ndarray, l2: np.ndarray, inst_map: np.ndarray | None,
                inst_attr: np.ndarray | None, device,
                inst_smem: np.ndarray | None = None) -> WalkTables:
    """WalkTables from the JAX layout's l1 [8, n_l1], l2 [8, n_l1 * 16] and,
    when instanced, inst_map [n_l1 * 16], inst_attr [lanes, 24] and the
    pass probabilities of inst_smem [n_l1, 16] (columns 12 and 14; 1 when
    not given)."""
    n_l1 = l1.shape[1]
    l1_rows = np.ascontiguousarray(np.asarray(l1, np.float32).T)
    valid_lo = np.where(l1_rows[:, 0:3] <= 1e30, l1_rows[:, 0:3], FLOAT_MAX)
    valid_hi = np.where(l1_rows[:, 3:6] >= -1e30, l1_rows[:, 3:6], -FLOAT_MAX)
    gbox = np.zeros(8, np.float32)
    gbox[0:3] = valid_lo.min(axis=0)
    gbox[3:6] = valid_hi.max(axis=0)
    nodes, kids, leaf_entries = build_tlas(l1_rows[:, 0:3], l1_rows[:, 3:6])
    if inst_attr is None:
        cmap = np.arange(n_l1 * L1_FAN, dtype=np.int32)
        inst = np.zeros((0, INST_COLS), np.float32)
    else:
        cmap = np.asarray(inst_map, np.int32)
        inst = np.zeros((n_l1, INST_COLS), np.float32)
        inst[:, :INST_PASS] = np.asarray(inst_attr, np.float32)[:n_l1, :INST_PASS]
        inst[:, INST_PASS:INST_PASS_SH + 1] = 1.0
        if inst_smem is not None:
            inst[:, INST_PASS] = np.asarray(inst_smem, np.float32)[:n_l1, 12]
            inst[:, INST_PASS_SH] = np.asarray(inst_smem, np.float32)[:n_l1, 14]

    def t(a, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return WalkTables(l1=t(l1_rows), l2=t(np.asarray(l2, np.float32).T), cmap=t(cmap, torch.int32),
                      inst=t(inst), nodes=t(nodes), kids=t(kids, torch.int32),
                      leaf_entries=t(leaf_entries, torch.int32), gbox=t(gbox))


def from_jax_tables(tris: np.ndarray, mats: np.ndarray, lights: np.ndarray,
                    light_types: tuple[int, ...], device, l1: np.ndarray | None = None,
                    l2: np.ndarray | None = None, inst_map: np.ndarray | None = None,
                    inst_attr: np.ndarray | None = None, inst_smem: np.ndarray | None = None,
                    advanced: bool = False, cutout: bool = False) -> FusedScene:
    """The JAX package's FusedScene arrays as NumPy -> the port's device
    tables: resident tris [32, T] ([34, T] or [50, T] with the cutout rows,
    padded here to a float4 multiple), or clustered tris [C_pad, 40, 128]
    with l1 and l2 and, when instanced, inst_map, inst_attr and inst_smem
    (its pass probabilities; the JAX inst_m24 is not needed). `advanced`
    and `cutout` are the JAX FusedStatic's flags."""
    tris = np.asarray(tris, np.float32)
    walk = None
    if l1 is None:
        rows = tris.T  # [T, 32]
        if cutout:
            rows = np.pad(rows, ((0, 0), (0, -rows.shape[1] % CUTOUT_PAD)))
    else:
        rows = tris.transpose(0, 2, 1).reshape(-1, tris.shape[1])  # [C * 128, 40]
        walk = walk_tables(l1, l2, inst_map, inst_attr, device, inst_smem)

    def t(a):
        return torch.tensor(np.ascontiguousarray(a, np.float32), device=device)

    return FusedScene(tris=t(rows), mats=t(mats), lights=t(lights),
                      light_types=torch.as_tensor(np.asarray(light_types, np.int8),
                                                  device=device),
                      walk=walk, advanced=bool(advanced), cutout=bool(cutout))


# ---------------------------------------------------------------------------
# ray state and parameters
# ---------------------------------------------------------------------------

def pack_state(origins: torch.Tensor, dirs: torch.Tensor, rng: torch.Tensor,
               r_pad: int) -> torch.Tensor:
    """[R,3] x2 + [R] uint32 (int64 carrier) -> [16, r_pad] kernel state;
    padding rays are dead."""
    r = origins.shape[0]
    state = torch.zeros((STATE_ROWS, r_pad), dtype=torch.float32, device=origins.device)
    state[0:3, :r] = origins.T
    state[3:6, :r] = dirs.T
    state[6:9, :r] = 1.0
    state[12, :r] = u32_to_f32_bits(rng)
    state[13, :r] = 1.0
    return state


def unpack_rows(state: torch.Tensor, first_row: int, n_rows: int, r: int) -> torch.Tensor:
    """[16, r_pad] -> [r, n_rows] slice of state rows."""
    return state[first_row:first_row + n_rows, :r].T


def unpack_radiance(state: torch.Tensor, r: int) -> torch.Tensor:
    return unpack_rows(state, 9, 3, r)


def state_from_numpy(state: np.ndarray, device) -> torch.Tensor:
    """A JAX ray state ([16, R/128, 128] or [16, R]) -> the port's [16, R]."""
    return torch.tensor(np.asarray(state, np.float32).reshape(STATE_ROWS, -1), device=device)


def state_to_numpy(state: torch.Tensor) -> np.ndarray:
    """The port's [16, R] state -> NumPy in the JAX layout [16, R/128, 128]
    (R a multiple of 128) or [16, R]."""
    a = state.detach().cpu().numpy()
    return a.reshape(STATE_ROWS, -1, 128) if a.shape[1] % 128 == 0 else a


def make_params(config, uniforms, bounces: int, device) -> torch.Tensor:
    """Per-bounce scalar parameters, one [11] f32 row per bounce
    ([bounces, 11]): the JAX package's make_params for bounce 0..n-1."""
    rows = np.zeros((bounces, PARAMS_LEN), np.float32)
    rows[:, 3] = uniforms.rr_inv_min_term_prob
    rows[:, 4] = config.rr_bounce_offset
    rows[:, 5] = np.arange(bounces)
    rows[:, 6] = f32(2.0 ** f32(uniforms.camera.sensor_exposure))
    rows[:, 8] = uniforms.light_intensity_multiplier
    rows[:, 9] = uniforms.meters_per_scene_unit
    rows[:, 10] = uniforms.max_volume_walk_length
    return torch.as_tensor(rows, device=device)


# ---------------------------------------------------------------------------
# the CUDA kernels: build, load, launch
# ---------------------------------------------------------------------------

def _check_bounce(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    check_tensor("bounce", name, t, dtype)


class BounceKernel(CudaLibrary):
    """csrc/bounce.cu built with nvcc and loaded with ctypes (ops/cuda_lib.py)."""

    def __init__(self) -> None:
        walk = [PTR] * 9 + [I32]  # tris l1 l2 cmap inst nodes kids leaf gbox, instanced
        shading = [PTR, I32, PTR, PTR, I32]  # mats n_mats lights light_types n_lights
        flags = [I32, I32]  # advanced, cutout
        hit = [PTR, PTR, I32, I32, I32, I32, I32]  # hit, parbuf, 4 parameter rows, hit tangents
        # the walk kernels take NEE as two entry points (..._nee), which
        # compile in separate parts
        bounce_walk = [PTR, *walk, I32, *shading, PTR, I64, *flags, PTR]
        shade_walk = [PTR, *walk, I32, *shading, PTR, I64, *hit, *flags, PTR]
        super().__init__("bounce.cu", {
            "gatling_bounce_step": [PTR, PTR, I32, I32, *shading, PTR, I64, I32, *flags, PTR],
            "gatling_bounce_walk": bounce_walk, "gatling_bounce_walk_nee": bounce_walk,
            "gatling_trace_resident": [PTR, PTR, I32, I32, PTR, I64, PTR, I32, PTR],
            "gatling_trace_walk": [PTR, *walk, I32, PTR, I64, PTR, I32, PTR],
            "gatling_shade_resident": [PTR, PTR, I32, I32, *shading, PTR, I64, *hit, I32,
                                       *flags, PTR],
            "gatling_shade_walk": shade_walk, "gatling_shade_walk_nee": shade_walk,
            "gatling_cutout_draws": [PTR, PTR, PTR, I64, PTR]},
            "gatling_error_string", parts=BOUNCE_PARTS)

    @staticmethod
    def _check_shading(mats, lights, light_types):
        for name, t, dt in (("mats", mats, torch.float32), ("lights", lights, torch.float32),
                            ("light_types", light_types, torch.int8)):
            _check_bounce(name, t, dt)
        if mats.shape[1] != 30 or lights.shape[1] != LIGHT_COLS \
                or light_types.numel() > lights.shape[0]:
            raise ValueError("bounce kernel: material or light table shape mismatch")
        table_bytes = 4 * (mats.numel() + lights.numel())
        if table_bytes > SMEM_TABLE_MAX_BYTES:
            raise ValueError(f"bounce kernel: materials + lights take {table_bytes} B, "
                             f"above the {SMEM_TABLE_MAX_BYTES} B shared-memory budget")
        return (mats.data_ptr(), mats.shape[0], lights.data_ptr(), light_types.data_ptr(),
                light_types.numel())

    @staticmethod
    def _check_state(params, state):
        _check_bounce("params", params, torch.float32)
        _check_bounce("state", state, torch.float32)
        if params.numel() != PARAMS_LEN or state.dim() != 2 or state.shape[0] != STATE_ROWS:
            raise ValueError("bounce kernel: params or state shape mismatch")

    @staticmethod
    def _resident_args(tris, cutout: bool):
        _check_bounce("tris", tris, torch.float32)
        rows = (TRI_ROWS, TRI_ROWS_TAN)
        if cutout:
            rows = tuple(r + CUTOUT_PAD for r in rows)
        if tris.dim() != 2 or tris.shape[1] not in rows:
            raise ValueError(f"bounce kernel: resident tris must be [T, {rows[0]}] or "
                             f"[T, {rows[1]}] (cutout={cutout})")
        return tris.data_ptr(), tris.shape[0], tris.shape[1]

    @staticmethod
    def _walk_args(tris, walk: WalkTables):
        for name, t in zip(WalkTables._fields, walk):
            _check_bounce(name, t, torch.int32 if name in ("cmap", "kids", "leaf_entries")
                   else torch.float32)
        _check_bounce("tris", tris, torch.float32)
        n_l1 = walk.l1.shape[0]
        if tris.dim() != 2 or tris.shape[1] not in (CLU_TRI_ROWS, CLU_TRI_ROWS_TAN) \
                or tris.shape[0] % CLUSTER_SIZE or walk.l2.shape[0] != n_l1 * L1_FAN \
                or walk.cmap.numel() != n_l1 * L1_FAN or walk.inst.shape[0] not in (0, n_l1) \
                or walk.inst.shape[1] != INST_COLS \
                or walk.gbox.numel() != 8 or walk.leaf_entries.numel() != n_l1:
            raise ValueError("bounce kernel: walk table shape mismatch")
        return (tris.data_ptr(), *(t.data_ptr() for t in walk), int(walk.instanced),
                tris.shape[1])

    @staticmethod
    def _check_split(state, hit, parbuf=None):
        _check_bounce("hit", hit, torch.float32)
        if hit.dim() != 2 or hit.shape[0] not in (HIT_ROWS, HIT_ROWS_TAN) \
                or hit.shape[1] != state.shape[1]:
            raise ValueError("split kernels: hit buffer must be [16 or 24, R]")
        if parbuf is not None:
            _check_bounce("parbuf", parbuf, torch.float32)
            if parbuf.dim() != 2 or parbuf.shape[0] < 8 or parbuf.shape[1] != state.shape[1]:
                raise ValueError("split kernels: parameter buffer must be [rows, R]")

    @staticmethod
    def _stream(state):
        return torch.cuda.current_stream(state.device).cuda_stream

    def launch(self, params, tris, mats, lights, light_types, state, nee: bool,
               advanced: bool = False, cutout: bool = False) -> None:
        """K1: one bounce over a resident table tris [T, 32 or 48; 36 or 52
        with the cutout columns]."""
        self._check_state(params, state)
        self.call("gatling_bounce_step", params.data_ptr(), *self._resident_args(tris, cutout),
                   *self._check_shading(mats, lights, light_types),
                   state.data_ptr(), state.shape[1], int(bool(nee)), int(bool(advanced)),
                   int(bool(cutout)), self.stream(state))

    def launch_walk(self, params, tris, mats, lights, light_types, walk: WalkTables, state,
                    nee: bool, advanced: bool = False, cutout: bool = False) -> None:
        """K2: one bounce over clustered tris [C * 128, 40 or 56] and their walk."""
        self._check_state(params, state)
        self.call("gatling_bounce_walk_nee" if nee else "gatling_bounce_walk", params.data_ptr(),
                   *self._walk_args(tris, walk), *self._check_shading(mats, lights, light_types),
                   state.data_ptr(), state.shape[1], int(bool(advanced)), int(bool(cutout)),
                   self.stream(state))

    def launch_trace(self, params, tris, walk: WalkTables | None, state,
                     hit: torch.Tensor, cutout: bool = False) -> None:
        """K3: the hit buffer of every ray of `state` into `hit`."""
        self._check_state(params, state)
        self._check_split(state, hit)
        if walk is None:
            self.call("gatling_trace_resident", params.data_ptr(),
                       *self._resident_args(tris, cutout), state.data_ptr(), state.shape[1],
                       hit.data_ptr(), int(bool(cutout)), self.stream(state))
        else:
            self.call("gatling_trace_walk", params.data_ptr(), *self._walk_args(tris, walk),
                       state.data_ptr(), state.shape[1], hit.data_ptr(), int(bool(cutout)),
                       self.stream(state))

    def launch_shade(self, params, tris, mats, lights, light_types, walk: WalkTables | None,
                     state, hit, parbuf, par_rows, nee: bool, advanced: bool = False,
                     cutout: bool = False) -> None:
        """K4: shade `state` in place from the hit and parameter buffers."""
        self._check_state(params, state)
        self._check_split(state, hit, parbuf)
        bufs = (state.data_ptr(), state.shape[1], hit.data_ptr(), parbuf.data_ptr(),
                *[int(r) for r in par_rows], int(hit.shape[0] == HIT_ROWS_TAN))
        flags = (int(bool(advanced)), int(bool(cutout)), self.stream(state))
        shading = self._check_shading(mats, lights, light_types)
        if walk is None:
            self.call("gatling_shade_resident", params.data_ptr(),
                       *self._resident_args(tris, cutout), *shading, *bufs, int(bool(nee)),
                       *flags)
        else:
            self.call("gatling_shade_walk_nee" if nee else "gatling_shade_walk",
                       params.data_ptr(), *self._walk_args(tris, walk), *shading, *bufs, *flags)


_kernel: BounceKernel | None = None
# kernel launches made on CUDA tensors, by kernel (chip_smoke.py reads
# them): K1 resident bounce, K2 the two-level walk, K3 trace, K4 shade
launches = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}


def kernel() -> BounceKernel:
    """The kernels' build, made at first use."""
    global _kernel
    if _kernel is None:
        _kernel = BounceKernel()
    return _kernel


def _walk(tensors) -> WalkTables | None:
    return WalkTables(*tensors) if tensors else None


def _bounce_cuda(params, tris, mats, lights, light_types, state, nee: bool, advanced: bool,
                 cutout: bool) -> None:
    kernel().launch(params, tris, mats, lights, light_types, state, nee, advanced, cutout)
    launches["K1"] += 1


def _bounce_cpu(params, tris, mats, lights, light_types, state, nee: bool, advanced: bool,
                cutout: bool) -> None:
    bounce_ref(params, tris, mats, lights, tuple(light_types.tolist()), state, nee,
               advanced=advanced, cutout=cutout)


def _walk_cuda(params, tris, mats, lights, light_types, l1, l2, cmap, inst, nodes, kids,
               leaf_entries, gbox, state, nee: bool, advanced: bool, cutout: bool) -> None:
    walk = WalkTables(l1, l2, cmap, inst, nodes, kids, leaf_entries, gbox)
    kernel().launch_walk(params, tris, mats, lights, light_types, walk, state, nee, advanced,
                         cutout)
    launches["K2"] += 1


def _walk_cpu(params, tris, mats, lights, light_types, l1, l2, cmap, inst, nodes, kids,
              leaf_entries, gbox, state, nee: bool, advanced: bool, cutout: bool) -> None:
    walk = WalkTables(l1, l2, cmap, inst, nodes, kids, leaf_entries, gbox)
    bounce_ref(params, tris, mats, lights, tuple(light_types.tolist()), state, nee, walk,
               advanced, cutout)


def _trace_cuda(params, tris, state, walk, cutout: bool) -> torch.Tensor:
    hit = torch.empty((hit_row_count(has_tangents(tris)), state.shape[1]), dtype=torch.float32,
                      device=state.device)
    kernel().launch_trace(params, tris, _walk(walk), state, hit, cutout)
    launches["K3"] += 1
    return hit


def _trace_cpu(params, tris, state, walk, cutout: bool) -> torch.Tensor:
    return trace_ref(params, tris, state, _walk(walk), cutout)


def _shade_cuda(params, tris, mats, lights, light_types, walk, hit, parbuf, par_rows, state,
                nee: bool, advanced: bool, cutout: bool) -> None:
    kernel().launch_shade(params, tris, mats, lights, light_types, _walk(walk), state, hit,
                          parbuf, par_rows, nee, advanced, cutout)
    launches["K4"] += 1


def _shade_cpu(params, tris, mats, lights, light_types, walk, hit, parbuf, par_rows, state,
               nee: bool, advanced: bool, cutout: bool) -> None:
    shade_ref(params, tris, mats, lights, tuple(light_types.tolist()), state, hit, parbuf,
              par_rows, nee, _walk(walk), advanced, cutout)


_lib = torch.library.Library("gatling", "DEF")
_lib.define("bounce_step(Tensor params, Tensor tris, Tensor mats, Tensor lights, "
            "Tensor light_types, Tensor(a!) state, bool nee, bool advanced, bool cutout) -> ()")
_lib.impl("bounce_step", _bounce_cuda, "CUDA")
_lib.impl("bounce_step", _bounce_cpu, "CPU")
_lib.define("bounce_step_walk(Tensor params, Tensor tris, Tensor mats, Tensor lights, "
            "Tensor light_types, Tensor l1, Tensor l2, Tensor cmap, Tensor inst, "
            "Tensor nodes, Tensor kids, Tensor leaf_entries, Tensor gbox, Tensor(a!) state, "
            "bool nee, bool advanced, bool cutout) -> ()")
_lib.impl("bounce_step_walk", _walk_cuda, "CUDA")
_lib.impl("bounce_step_walk", _walk_cpu, "CPU")
_lib.define("trace_step(Tensor params, Tensor tris, Tensor state, Tensor[] walk, "
            "bool cutout) -> Tensor")
_lib.impl("trace_step", _trace_cuda, "CUDA")
_lib.impl("trace_step", _trace_cpu, "CPU")
_lib.define("shade_step(Tensor params, Tensor tris, Tensor mats, Tensor lights, "
            "Tensor light_types, Tensor[] walk, Tensor hit, Tensor parbuf, int[] par_rows, "
            "Tensor(a!) state, bool nee, bool advanced, bool cutout) -> ()")
_lib.impl("shade_step", _shade_cuda, "CUDA")
_lib.impl("shade_step", _shade_cpu, "CPU")


def cutout_draws(keys: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The searches' cutout draws for (key, triangle id) pairs, int32
    tensors holding uint32 bits: the kernels' device function on CUDA
    tensors, the twin's cutout_xi on CPU ones. A check of the draws, on no
    render path (no launch count)."""
    if not keys.is_cuda:
        return cutout_xi(keys.long() & 0xFFFFFFFF, ids.long() & 0xFFFFFFFF)
    for name, t in (("keys", keys), ("ids", ids)):
        _check_bounce(name, t, torch.int32)
    if keys.shape != ids.shape or keys.dim() != 1:
        raise ValueError("cutout_draws: keys and ids must be equal 1-D tensors")
    out = torch.empty(keys.shape, dtype=torch.float32, device=keys.device)
    k = kernel()
    k.call("gatling_cutout_draws", keys.data_ptr(), ids.data_ptr(), out.data_ptr(), keys.numel(),
           k.stream(keys))
    return out


def bounce_step(params: torch.Tensor, scene: FusedScene, state: torch.Tensor,
                nee: bool) -> None:
    """One fused bounce over state [16, R], in place: K1 for a resident
    scene, K2 for a clustered or instanced one, on a CUDA state; the plain
    twin on a CPU state. The scene's flags pick the branches."""
    flags = (bool(nee), bool(scene.advanced), bool(scene.cutout))
    if scene.walk is None:
        torch.ops.gatling.bounce_step(params, scene.tris, scene.mats, scene.lights,
                                      scene.light_types, state, *flags)
    else:
        torch.ops.gatling.bounce_step_walk(params, scene.tris, scene.mats, scene.lights,
                                           scene.light_types, *scene.walk, state, *flags)


def trace_step(params: torch.Tensor, scene: FusedScene, state: torch.Tensor) -> torch.Tensor:
    """The split bounce's trace (K3 on a CUDA state, its twin on a CPU
    one): the hit buffer [16, R] ([24, R] with tangent rows) of state
    [16, R] (ops/split_ref.py H_* rows)."""
    return torch.ops.gatling.trace_step(params, scene.tris, state, list(scene.walk or ()),
                                        bool(scene.cutout))


def shade_step(params: torch.Tensor, scene: FusedScene, state: torch.Tensor,
               hitbuf: torch.Tensor, parbuf: torch.Tensor, textured_params, nee: bool) -> None:
    """The split bounce's shade (K4 on a CUDA state, its twin on a CPU
    one), in place: materials from scene.mats, the textured parameters
    from parbuf in the slim layout of `textured_params`."""
    torch.ops.gatling.shade_step(params, scene.tris, scene.mats, scene.lights,
                                 scene.light_types, list(scene.walk or ()), hitbuf, parbuf,
                                 par_row_starts(textured_params), state, bool(nee),
                                 bool(scene.advanced), bool(scene.cutout))
