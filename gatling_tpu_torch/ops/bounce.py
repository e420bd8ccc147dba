"""Fused bounce: scene tables, ray state, and the dispatch to the kernels.

Host half of the JAX package's ops/pallas_bounce.py: the triangle,
material and light tables, the packed 16-row ray state and the per-bounce
parameter vector, plus `bounce_step`, which runs one bounce. Two table
layouts, as in the JAX package:

* resident (at most RESIDENT_MAX = 4096 triangles): every triangle in one
  [T, 32] table, searched by the kernel K1 through a BVH over the table
  (`resident_bvh`, a TriBvh of ops/bvh.py) that from_jax_tables builds
  with it;
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
CLU_OPAC_SH, the instance rows INST_PASS / INST_PASS_SH). A third,
`volumes` (VOL_OFF, VOL_ABSORB or VOL_SCATTER: the JAX FusedStatic's
`volumes` and `scatter`), is set by gi from the material table and
mediumStackSize (`with_volumes`), as the JAX gi sets them. `bounce_step`
runs one bounce of an untextured scene;
a textured scene splits it into `trace_step` (the hit buffer) and
`shade_step`, which taps the textures itself. Each runs:

* on a CUDA tensor, the hand-written kernels of csrc/bounce.cu (K1
  resident and K2 walk bounce, K3 trace, K4 shade), built with nvcc at
  first use into build/torch_ext/ and loaded with ctypes (a plain C
  interface: a source that includes PyTorch's headers takes minutes to
  build, this one seconds). A failed build or launch raises;
* on a CPU tensor, the plain twins ops/bounce_ref.py and ops/split_ref.py
  (K4's after the texture stage, ops/split_ref.py material_rows).

They are registered as the operators `torch.ops.gatling.bounce_step` (K1),
`bounce_step_walk` (K2), `trace_step` (K3) and `shade_step` (K4). The fused
sample loop's bounce-0 peel and textured-cutout re-trace call two more
wrappers of the same kind directly: `tap_rows` (K4t, K4's taps alone, of
the rows the peel reads) and `retrace_round` (K4r, one round of the
re-trace), with their twins `tap_rows_ref` and `retrace_round_ref`.
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
    CLU_TEST_COLS,
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
    MAX_SCATTER_MATS,
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
    VOL_ABSORB,
    VOL_OFF,
    VOL_SCATTER,
    WalkTables,
    bounce_ref,
    cutout_xi,
)
from gatling_tpu_torch.ops.bvh import (  # noqa: F401 (TLAS_*: the TLAS builder's, re-exported)
    TLAS_LEAF,
    TLAS_MAX_DEPTH,
    ClusterBvh,
    TriBvh,
    build_tlas,
    cluster_bvh,
    plane_corners,
    tri_bvh,
)
from gatling_tpu_torch.ops import validate
from gatling_tpu_torch.ops.cuda_lib import I32, I64, PTR, CudaLibrary, check_tensor
from gatling_tpu_torch.ops.geometry import SceneGeometry, real_triangles
from gatling_tpu_torch.ops.split_ref import (
    H_GN,
    H_HIT,
    H_MAT,
    H_N,
    H_POS,
    H_UVX,
    H_UVY,
    HIT_ROWS,
    HIT_ROWS_TAN,
    PAR_ORDER,
    has_tangents,
    hit_row_count,
    material_rows,
    par_row_starts,
    shade_ref,
    slim_param_layout,
    trace_ref,
)
from gatling_tpu_torch.ops.sampling import f32_bits_to_u32, offset_ray_origin, u32_to_f32_bits
from gatling_tpu_torch.render.bsdf import cutout_opacity
from gatling_tpu_torch.render.material import (
    MF_ANISO,
    MF_BASE,
    MF_COAT,
    MF_METAL,
    MF_OPACITY,
    MF_OPACITY_THRESH,
    MF_THIN,
    MF_TRANS,
    MF_VOL_A,
    MF_VOL_S,
    MI_OPACITY_TEX,
    MaterialTable,
    apply_textures,
    gather_params,
)
from gatling_tpu_torch.render.texture import TexturePool, srgb_table
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
SMEM_MAX_BYTES = 227 * 1024  # the shared memory an H100 block can use
MI_COLS = 10  # the device material table's integer columns (render/material.py MI_*)
# K4's taps (csrc/bounce.cu TAP_*): a bit for each textured parameter it
# samples, and the normal map
TAP_BITS = {"base_color": 1, "emissive": 2, "metallic": 4, "roughness": 8}
TAP_NORMAL = 16
TAP_OPACITY = 32  # retrace_round's opacity tap: K4 and tap_rows never read opacity
# the pool is float (render/texture.py): the taps read `texels` through the
# FLT instances of K4, tap_rows and retrace_round (the ..._flt entry points)
TAP_FLOAT = 64
# tap_rows' rows, those the bounce-0 peel reads (render/fused.py
# FirstHit.add: the shading normal, and the base colour and metallic of
# bsdf.auxiliary): the first row of each (csrc/bounce.cu O_*)
TAP_ROWS = 7
TAP_BASE_ROW, TAP_METAL_ROW, TAP_N_ROW = 0, 3, 4
# the taps tap_rows makes, of those textured (the normal map besides)
TAP_PEEL = TAP_BITS["base_color"] | TAP_BITS["metallic"]
# K4's tap tables in shared memory, in 4-byte words (csrc/bounce.cu
# tap_smem_words): TAP_MI slot columns a material, SLOT_WORDS a texture
# slot (SLOT_I ints, SLOT_F floats), then the SRGB_LUT-entry decode table
TAP_MI, SLOT_WORDS, SRGB_LUT = 7, 6 + 8, 256
BOUNCE_PARTS = 15  # csrc/bounce.cu compiles in this many nvcc runs at once (GATLING_PART)



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
    bvh: TriBvh | None = None  # resident scenes: the walk of K1, K3 and K4
    advanced: bool = False     # the full lobe set in the shading
    cutout: bool = False       # stochastic cutout in the searches
    volumes: int = VOL_OFF     # the volume mode (VOL_*)


@dataclasses.dataclass(frozen=True)
class FusedStatic:
    """Static scene shape info."""

    n_tris: int
    light_types: tuple[int, ...]
    n_clusters: int = 0   # 0: resident; instanced: unique local clusters
    n_l1: int = 1
    n_instances: int = 0  # > 0: instanced
    tangents: bool = False  # per-corner tangent rows in the tables (normal maps)
    # split-bounce mode (K3, K4 with its texture taps): the scene has textures
    textured: bool = False
    textured_params: tuple[str, ...] = ()  # the parameters some material textures
    advanced: bool = False  # a material needs the full lobe set (FusedScene.advanced)
    cutout: bool = False    # some triangle's pass probability is below 1
    # absorption-only media (the alive row holds 2.0 inside one), and with
    # `scatter` the depth-1 medium stack (FusedScene.volumes)
    volumes: bool = False
    scatter: bool = False
    # some material binds an opacity texture: the split bounce re-traces
    # the rays its cutout rejects (render/fused.py textured_cutout_retrace)
    cutout_textured: bool = False

    @property
    def volume_mode(self) -> int:
        if not self.volumes:
            return VOL_OFF
        return VOL_SCATTER if self.scatter else VOL_ABSORB

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


def has_scattering(table: MaterialTable) -> bool:
    """Some material has scattering coefficients."""
    return bool((np.asarray(table.packed_f)[:, MF_VOL_S:MF_VOL_S + 3] > 0.0).any())


def with_volumes(scene: FusedScene, static: FusedStatic, scatter: bool
                 ) -> tuple[FusedScene, FusedStatic]:
    """The tables and static of a scene with volume coefficients: the
    absorption mode, or with `scatter` the depth-1 medium stack, whose
    alive-row encoding holds at most MAX_SCATTER_MATS material ids
    (gatling_tpu/gi.py:739-747; gi routes larger tables to the wavefront,
    the kernel wrapper refuses them)."""
    static = dataclasses.replace(static, volumes=True, scatter=bool(scatter))
    return scene._replace(volumes=static.volume_mode), static


def build_fused_scene(geom: SceneGeometry, table: MaterialTable,
                      light_arrays: LightArrays | None, device: torch.device | str,
                      resident_max: int = RESIDENT_MAX,
                      shadow_pass: np.ndarray | None = None) -> tuple[FusedScene, FusedStatic]:
    """Kernel tables of a flattened scene: resident up to `resident_max`
    triangles, clustered above."""
    scene, static, _order = build_fused_scene_with_order(geom, table, light_arrays, device,
                                                         resident_max, shadow_pass=shadow_pass)
    return scene, static


def _shadow_prob(pass_prob: np.ndarray, mid: np.ndarray,
                 shadow_pass: np.ndarray | None) -> np.ndarray:
    """Each triangle's shadow-walk pass probability: its material's entry
    of `shadow_pass` (gi.shadow_cutout_pass: an opacity texture's UV-mean
    pass rate), else the camera one (pallas_bounce.py :666-669)."""
    if shadow_pass is None:
        return pass_prob
    return np.asarray(shadow_pass, np.float32)[np.clip(mid, 0, len(shadow_pass) - 1)]


def build_fused_scene_with_order(
    geom: SceneGeometry, table: MaterialTable, light_arrays: LightArrays | None,
    device: torch.device | str, resident_max: int = RESIDENT_MAX,
    reuse_order: np.ndarray | None = None, shadow_pass: np.ndarray | None = None,
) -> tuple[FusedScene, FusedStatic, np.ndarray | None]:
    """The JAX package's build_fused_scene_with_order: resident tables up
    to `resident_max` real triangles, else clustered tables in a median-
    split triangle order, which is returned so that a transform edit can
    refit the tables under the same order (`reuse_order`) instead of
    re-sorting. `shadow_pass` [M] fills the shadow walk's pass-probability
    column per material (gi.shadow_cutout_pass)."""
    n_real = real_triangles(geom)
    geom = SceneGeometry(*[arr[:n_real] for arr in geom])
    light_table, light_types = _light_table(light_arrays)
    tangents = uses_tangents(table)
    advanced = advanced_from_table(table)
    mid = np.clip(np.asarray(geom.material_id), 0, table.packed_f.shape[0] - 1)
    pass_prob = _material_pass(table)[mid]
    shadow_prob = _shadow_prob(pass_prob, np.asarray(geom.material_id), shadow_pass)
    cutout = bool((pass_prob < 1.0).any() or (shadow_prob < 1.0).any())
    if n_real <= resident_max:
        rows = tri_rows(geom, tangents, pass_prob if cutout else None,
                        shadow_prob if cutout else None)
        scene = from_jax_tables(rows.T, table.packed_f, light_table, light_types, device,
                                advanced=advanced, cutout=cutout)
        return scene, FusedStatic(n_tris=n_real, light_types=light_types, tangents=tangents,
                                  advanced=advanced, cutout=cutout), None

    order = reuse_order if reuse_order is not None else median_split_order(geom, n_real)
    arrays = clustered_arrays(geom, table, order, shadow_pass)
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


def clustered_arrays(geom: SceneGeometry, table: MaterialTable, order: np.ndarray,
                     shadow_pass: np.ndarray | None = None) -> ClusterArrays:
    """Flattened clustered tables of the real triangles of `geom`, in
    `order` (the clustered branch of build_fused_scene_with_order)."""
    n_real = len(order)
    mid = np.clip(np.asarray(geom.material_id), 0, table.packed_f.shape[0] - 1)
    pass_all = _material_pass(table)[mid].astype(np.float32)
    pass_prob = pass_all[order]
    shadow_prob = _shadow_prob(pass_all, np.asarray(geom.material_id), shadow_pass)[order]
    geom = SceneGeometry(*[np.asarray(arr)[order] for arr in geom])
    n_clusters = -(-n_real // CLUSTER_SIZE)
    n_l1 = -(-n_clusters // L1_FAN)
    c_pad = n_l1 * L1_FAN
    rows = _cluster_rows(geom, c_pad, uses_tangents(table))
    rows[:n_real, CLU_OPAC] = pass_prob
    rows[:n_real, CLU_OPAC_SH] = shadow_prob
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
                     clusters: UniqueClusters | None = None,
                     shadow_pass: np.ndarray | None = None):
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
    `shadow_pass` [M]: the shadow walk's pass probability per material
    (gi.shadow_cutout_pass), else the camera one.

    Returns (ClusterArrays, FusedStatic fields) or None when the scene
    does not take this route (the JAX package's rule, see MIN_GAIN)."""
    mat_pass = _material_pass(table)
    mat_pass_sh = mat_pass if shadow_pass is None else np.asarray(shadow_pass, np.float32)
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
        mpass_sh = float(mat_pass_sh[min(mat_row, len(mat_pass_sh) - 1)])
        for xf in np.asarray(transforms, np.float64):
            m3 = xf[:3, :3]
            if abs(np.linalg.det(m3)) < 1e-30:
                return None  # a placement that cannot be inverted
            a3 = np.linalg.inv(m3)
            insts.append({"key": key, "m3": m3, "m_t": xf[3, :3], "a3": a3,
                          "a_t": -xf[3, :3] @ a3, "mat": mat_row, "obj": md.object_id,
                          "ds": 1.0 if md.double_sided else 0.0, "pass": mpass,
                          "pass_sh": mpass_sh})
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
        inst_smem[e, 14] = inst["pass_sh"]
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
                                clusters: UniqueClusters | None = None,
                                shadow_pass: np.ndarray | None = None):
    """Instanced kernel tables (see instanced_arrays), or None when the
    scene takes the flattened route."""
    res = instanced_arrays(mesh_descs, material_index, table, min_gain, min_flat, clusters,
                           shadow_pass)
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
                    material_index: dict, table: MaterialTable,
                    shadow_pass: np.ndarray | None = None) -> FusedScene | None:
    """Transform-only refresh of instanced tables built with `clusters`:
    the instance tables and the TLAS are rebuilt over the cached unique
    clusters, and the device cluster table is kept. None when the edit
    took the scene off the instanced route."""
    res = instanced_arrays(mesh_descs, material_index, table, clusters=clusters,
                           shadow_pass=shadow_pass)
    if res is None:
        return None
    a, counts = res
    w = scene.walk
    trees = ClusterBvh(w.cnodes, w.ckids, w.crows, w.croot)
    return scene._replace(walk=walk_tables(a.l1, a.l2, a.inst_map, a.inst_attr,
                                           scene.tris.device, a.inst_smem, trees=trees),
                          cutout=counts["cutout"])


def walk_tables(l1: np.ndarray, l2: np.ndarray, inst_map: np.ndarray | None,
                inst_attr: np.ndarray | None, device,
                inst_smem: np.ndarray | None = None, rows: np.ndarray | None = None,
                trees: ClusterBvh | None = None) -> WalkTables:
    """WalkTables from the JAX layout's l1 [8, n_l1], l2 [8, n_l1 * 16] and,
    when instanced, inst_map [n_l1 * 16], inst_attr [lanes, 24] and the
    pass probabilities of inst_smem [n_l1, 16] (columns 12 and 14; 1 when
    not given). The cluster trees are built from the triangle rows
    [C * 128, 40 or 56] (`cluster_trees`), or kept from `trees` (a refit:
    the clusters did not change); with neither they are empty, and the
    kernels refuse the tables."""
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

    if trees is None:
        trees = (cluster_trees(rows, device) if rows is not None else ClusterBvh(
            t(np.zeros((0, 8))), t(np.zeros((0, 2)), torch.int32), t(np.zeros((0, 16))),
            t(np.zeros(0), torch.int32)))
    return WalkTables(l1=t(l1_rows), l2=t(np.asarray(l2, np.float32).T), cmap=t(cmap, torch.int32),
                      inst=t(inst), nodes=t(nodes), kids=t(kids, torch.int32),
                      leaf_entries=t(leaf_entries, torch.int32), gbox=t(gbox),
                      cnodes=trees.nodes, ckids=trees.kids, crows=trees.rows, croot=trees.root)


def cluster_trees(rows: np.ndarray, device) -> ClusterBvh:
    """The per-cluster BVHs (ops/bvh.py cluster_bvh) of clustered triangle
    rows [C * 128, 40 or 56]: over each cluster's lanes that can hit, in
    the rows' frame (local for the unique clusters of instanced tables),
    with the CLU_OPAC and CLU_OPAC_SH probabilities in the leaf rows."""
    rows = np.asarray(rows, np.float32)
    return cluster_bvh(rows[:, list(CLU_TEST_COLS)], rows[:, [CLU_OPAC, CLU_OPAC_SH]],
                       CLUSTER_SIZE, device)


def from_jax_tables(tris: np.ndarray, mats: np.ndarray, lights: np.ndarray,
                    light_types: tuple[int, ...], device, l1: np.ndarray | None = None,
                    l2: np.ndarray | None = None, inst_map: np.ndarray | None = None,
                    inst_attr: np.ndarray | None = None, inst_smem: np.ndarray | None = None,
                    advanced: bool = False, cutout: bool = False,
                    volumes: int = VOL_OFF) -> FusedScene:
    """The JAX package's FusedScene arrays as NumPy -> the port's device
    tables: resident tris [32, T] ([34, T] or [50, T] with the cutout rows,
    padded here to a float4 multiple), or clustered tris [C_pad, 40, 128]
    with l1 and l2 and, when instanced, inst_map, inst_attr and inst_smem
    (its pass probabilities; the JAX inst_m24 is not needed). `advanced`
    and `cutout` are the JAX FusedStatic's flags, `volumes` its `volumes`
    and `scatter` as a VOL_* mode."""
    tris = np.asarray(tris, np.float32)
    walk = bvh = None
    if l1 is None:
        rows = tris.T  # [T, 32]
        if cutout:
            rows = np.pad(rows, ((0, 0), (0, -rows.shape[1] % CUTOUT_PAD)))
        bvh = resident_bvh(rows, cutout, device)
    else:
        rows = tris.transpose(0, 2, 1).reshape(-1, tris.shape[1])  # [C * 128, 40]
        walk = walk_tables(l1, l2, inst_map, inst_attr, device, inst_smem, rows)

    def t(a):
        return torch.tensor(np.ascontiguousarray(a, np.float32), device=device)

    return FusedScene(tris=t(rows), mats=t(mats), lights=t(lights),
                      light_types=torch.as_tensor(np.asarray(light_types, np.int8),
                                                  device=device),
                      walk=walk, bvh=bvh, advanced=bool(advanced), cutout=bool(cutout),
                      volumes=int(volumes))


def resident_bvh(rows: np.ndarray, cutout: bool, device) -> TriBvh:
    """The TriBvh of a resident table rows [T, 32+] f32. Each triangle's
    corners are solved in float64 from its f32 plane and barycentric rows
    (the points of its plane where the test's u, v are (0, 0), (1, 0) and
    (0, 1)), so the boxes hold the triangle the kernels test; a row whose
    plane normal is 0 never hits (ndotd = 0) and goes into no leaf. The
    leaf rows: TR_N..TR_R2 + 3, the index, the camera and shadow pass
    probabilities (1 without cutout), 0."""
    corners = plane_corners(rows[:, :12])
    leaf = np.zeros((rows.shape[0], 16), np.float32)
    leaf[:, :12] = rows[:, :12]
    leaf[:, 13:15] = 1.0
    if cutout:
        col = TRI_ROWS_TAN if rows.shape[1] >= TRI_ROWS_TAN else TRI_ROWS
        leaf[:, 13:15] = rows[:, col:col + 2]
    return tri_bvh(corners, (rows[:, TR_N:TR_N + 3] != 0.0).any(axis=1), leaf, device)


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
        # tris, the WalkTables fields (ops/bounce_ref.py), instanced
        walk = [PTR] * (1 + len(WalkTables._fields)) + [I32]
        shading = [PTR, I32, PTR, PTR, I32]  # mats n_mats lights light_types n_lights
        flags = [I32, I32, I32]  # advanced, cutout, the volume mode
        hit = [PTR, I32]  # the hit buffer, whether it has the tangent rows
        # K4's taps: the MI_* table, the pool's 8-bit texels, 2x2 rows, float
        # texels and eight slot columns, the sRGB table; the slot count and
        # the TAP_* mask
        taps = [PTR] * 13 + [I32, I32]
        # the walk bounce takes NEE and the volume modes as four entry points
        # (..._nee, ..._vol, ..._vol_nee), which compile in separate parts
        bounce_walk = [PTR, *walk, I32, *shading, PTR, I64, *flags, PTR]
        shade_walk = [PTR, *walk, I32, *shading, PTR, I64, *hit, *taps, *flags, PTR]
        resident = [PTR, I32, PTR, PTR, PTR]  # tris ld, the TriBvh's nodes kids rows
        super().__init__("bounce.cu", {
            "gatling_bounce_step": [PTR, *resident, *shading, PTR, I64, I32, *flags, PTR],
            **{_walk_entry("gatling_bounce_walk", nee, vol): bounce_walk
               for nee in (False, True) for vol in (VOL_OFF, VOL_ABSORB)},
            "gatling_trace_resident": [PTR, *resident, PTR, I64, PTR, I32, PTR],
            "gatling_trace_walk": [PTR, *walk, I32, PTR, I64, PTR, I32, PTR],
            **{_flt_entry("gatling_shade_resident", flt): [PTR, *resident, *shading, PTR, I64,
                                                           *hit, *taps, I32, *flags, PTR]
               for flt in (False, True)},
            **{_walk_entry("gatling_shade_walk", nee, vol, flt): shade_walk
               for nee in (False, True) for vol in (VOL_OFF, VOL_ABSORB)
               for flt in (False, True)},
            "gatling_cutout_draws": [PTR, PTR, PTR, I64, PTR],
            **{_flt_entry("gatling_tap_rows", flt): [PTR, I32, PTR, I64, *taps, PTR, PTR]
               for flt in (False, True)},
            **{_flt_entry("gatling_retrace_round", flt): [PTR, I32, PTR, I64, *taps, I32, PTR,
                                                          PTR, PTR]
               for flt in (False, True)}},
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
    def _resident_args(tris, bvh: TriBvh | None, cutout: bool):
        _check_bounce("tris", tris, torch.float32)
        rows = (TRI_ROWS, TRI_ROWS_TAN)
        if cutout:
            rows = tuple(r + CUTOUT_PAD for r in rows)
        if tris.dim() != 2 or tris.shape[1] not in rows:
            raise ValueError(f"bounce kernel: resident tris must be [T, {rows[0]}] or "
                             f"[T, {rows[1]}] (cutout={cutout})")
        if bvh is None:
            raise ValueError("bounce kernel: a resident table needs its TriBvh "
                             "(ops/bounce.py resident_bvh)")
        for name, t, dt in (("bvh nodes", bvh.nodes, torch.float32),
                            ("bvh kids", bvh.kids, torch.int32),
                            ("bvh rows", bvh.rows, torch.float32)):
            _check_bounce(name, t, dt)
        if bvh.nodes.dim() != 2 or bvh.nodes.shape[1] != 8 \
                or bvh.kids.shape != (bvh.nodes.shape[0], 2) or bvh.rows.dim() != 2 \
                or bvh.rows.shape[1] != 16 or bvh.rows.shape[0] > tris.shape[0]:
            raise ValueError("bounce kernel: resident TriBvh shape mismatch")
        return (tris.data_ptr(), tris.shape[1], bvh.nodes.data_ptr(), bvh.kids.data_ptr(),
                bvh.rows.data_ptr())

    @staticmethod
    def _walk_args(tris, walk: WalkTables):
        for name, t in zip(WalkTables._fields, walk):
            _check_bounce(name, t, torch.int32 if name in ("cmap", "kids", "leaf_entries", "ckids",
                                                           "croot") else torch.float32)
        _check_bounce("tris", tris, torch.float32)
        n_l1 = walk.l1.shape[0]
        if tris.dim() != 2 or tris.shape[1] not in (CLU_TRI_ROWS, CLU_TRI_ROWS_TAN) \
                or tris.shape[0] % CLUSTER_SIZE or walk.l2.shape[0] != n_l1 * L1_FAN \
                or walk.cmap.numel() != n_l1 * L1_FAN or walk.inst.shape[0] not in (0, n_l1) \
                or walk.inst.shape[1] != INST_COLS \
                or walk.gbox.numel() != 8 or walk.leaf_entries.numel() != n_l1:
            raise ValueError("bounce kernel: walk table shape mismatch")
        if walk.croot.numel() != tris.shape[0] // CLUSTER_SIZE or walk.cnodes.dim() != 2 \
                or walk.cnodes.shape[1] != 8 or walk.ckids.shape != (walk.cnodes.shape[0], 2) \
                or walk.crows.dim() != 2 or walk.crows.shape[1] != 16:
            raise ValueError("bounce kernel: the walk tables need a tree per cluster "
                             "(ops/bounce.py walk_tables with the triangle rows)")
        return (tris.data_ptr(), *(t.data_ptr() for t in walk), int(walk.instanced),
                tris.shape[1])

    @staticmethod
    def _check_split(state, hit):
        _check_bounce("hit", hit, torch.float32)
        if hit.dim() != 2 or hit.shape[0] not in (HIT_ROWS, HIT_ROWS_TAN) \
                or hit.shape[1] != state.shape[1]:
            raise ValueError("split kernels: hit buffer must be [16 or 24, R]")

    @staticmethod
    def _tap_args(mats, mat_i, pool: TexturePool, taps: int):
        """K4's tap arguments (csrc/bounce.cu TAP_ARGS) of the device
        material table's integer columns and texture pool; `taps` the
        TAP_* mask (TAP_FLOAT: the float pool's texels, [N, 4] f32)."""
        _check_bounce("mat_i", mat_i, torch.int32)
        if mat_i.shape != (mats.shape[0], MI_COLS):
            raise ValueError(f"shade kernel: the material slot columns must be "
                             f"[{mats.shape[0]}, {MI_COLS}], got {tuple(mat_i.shape)}")
        ints = ("texels_u32", "texels_q22", "offset", "width", "height", "wrap_s", "wrap_t",
                "is_srgb")
        for name in ints:
            _check_bounce(name, getattr(pool, name), torch.int32)
        for name in ("texels", "scale", "bias"):
            _check_bounce(name, getattr(pool, name), torch.float32)
        n = pool.offset.numel()
        if any(getattr(pool, f).shape != (n,) for f in ints[2:]) \
                or pool.scale.shape != (n, 4) or pool.bias.shape != (n, 4) \
                or pool.texels_q22.dim() != 2 or pool.texels_q22.shape[1] != 4 \
                or pool.texels.dim() != 2 or pool.texels.shape[1] != 4:
            raise ValueError("shade kernel: texture pool shape mismatch")
        flt = bool(taps & TAP_FLOAT)
        if taps and flt == pool.packed:
            raise ValueError("shade kernel: TAP_FLOAT must be set for a float pool alone")
        lut = srgb_lut(mats.device)
        return (mat_i.data_ptr(), pool.texels_u32.data_ptr(),
                pool.texels_q22.data_ptr() if pool.bilinear_packed and not flt else None,
                pool.texels.data_ptr(), *(getattr(pool, f).data_ptr() for f in ints[2:]),
                pool.scale.data_ptr(), pool.bias.data_ptr(), lut.data_ptr(), n, int(taps))

    @staticmethod
    def _stream(state):
        return torch.cuda.current_stream(state.device).cuda_stream

    @staticmethod
    def _check_volumes(mats, volumes: int, modes=(VOL_OFF, VOL_ABSORB, VOL_SCATTER)) -> int:
        if volumes not in modes:
            raise ValueError(f"bounce kernel: no volume mode {volumes} here (takes {modes})")
        if volumes == VOL_SCATTER and mats.shape[0] > MAX_SCATTER_MATS:
            raise ValueError(f"bounce kernel: the scatter mode encodes at most "
                             f"{MAX_SCATTER_MATS} materials, got {mats.shape[0]}")
        return int(volumes)

    def launch(self, params, tris, bvh: TriBvh, mats, lights, light_types, state, nee: bool,
               advanced: bool = False, cutout: bool = False, volumes: int = VOL_OFF) -> None:
        """K1: one bounce over a resident table tris [T, 32 or 48; 36 or 52
        with the cutout columns] through its TriBvh."""
        self._check_state(params, state)
        self.call("gatling_bounce_step", params.data_ptr(),
                   *self._resident_args(tris, bvh, cutout),
                   *self._check_shading(mats, lights, light_types),
                   state.data_ptr(), state.shape[1], int(bool(nee)), int(bool(advanced)),
                   int(bool(cutout)), self._check_volumes(mats, volumes), self.stream(state))

    def launch_walk(self, params, tris, mats, lights, light_types, walk: WalkTables, state,
                    nee: bool, advanced: bool = False, cutout: bool = False,
                    volumes: int = VOL_OFF) -> None:
        """K2: one bounce over clustered tris [C * 128, 40 or 56] and their walk."""
        self._check_state(params, state)
        vol = self._check_volumes(mats, volumes)
        if vol == VOL_SCATTER and tris.shape[1] == CLU_TRI_ROWS_TAN:
            raise ValueError("bounce kernel: the scatter mode has no tangent-row walk")
        self.call(_walk_entry("gatling_bounce_walk", nee, vol), params.data_ptr(),
                   *self._walk_args(tris, walk), *self._check_shading(mats, lights, light_types),
                   state.data_ptr(), state.shape[1], int(bool(advanced)), int(bool(cutout)),
                   vol, self.stream(state))

    def launch_trace(self, params, tris, walk: WalkTables | None, bvh: TriBvh | None, state,
                     hit: torch.Tensor, cutout: bool = False) -> None:
        """K3: the hit buffer of every ray of `state` into `hit`."""
        self._check_state(params, state)
        self._check_split(state, hit)
        if walk is None:
            self.call("gatling_trace_resident", params.data_ptr(),
                       *self._resident_args(tris, bvh, cutout), state.data_ptr(), state.shape[1],
                       hit.data_ptr(), int(bool(cutout)), self.stream(state))
        else:
            self.call("gatling_trace_walk", params.data_ptr(), *self._walk_args(tris, walk),
                       state.data_ptr(), state.shape[1], hit.data_ptr(), int(bool(cutout)),
                       self.stream(state))

    def launch_shade(self, params, tris, mats, lights, light_types, walk: WalkTables | None,
                     bvh: TriBvh | None, state, hit, mat_i, pool: TexturePool, taps: int,
                     nee: bool, advanced: bool = False, cutout: bool = False,
                     volumes: int = VOL_OFF) -> None:
        """K4: shade `state` in place from the hit buffer, tapping the
        pool for the parameters of the TAP_* mask `taps` where the
        material table's slot columns `mat_i` bind a texture (no scatter
        mode: the split bounce takes absorption only); with NEE the shadow
        ray walks the resident tree or the two-level walk in the same
        launch, after the path state is written."""
        self._check_state(params, state)
        self._check_split(state, hit)
        vol = self._check_volumes(mats, volumes, (VOL_OFF, VOL_ABSORB))
        shading = self._check_shading(mats, lights, light_types)
        tap_args = self._tap_args(mats, mat_i, pool, taps)
        smem = 4 * (mats.numel() + lights.numel() + light_types.numel()) + (
            4 * (mats.shape[0] * TAP_MI + tap_args[-2] * SLOT_WORDS + SRGB_LUT) if taps else 0)
        if smem > SMEM_MAX_BYTES:
            raise ValueError(f"shade kernel: its tables take {smem} B of shared memory, above "
                             f"the {SMEM_MAX_BYTES} B a block has")
        bufs = (state.data_ptr(), state.shape[1], hit.data_ptr(),
                int(hit.shape[0] == HIT_ROWS_TAN), *tap_args)
        flags = (int(bool(advanced)), int(bool(cutout)), vol, self.stream(state))
        flt = bool(taps & TAP_FLOAT)
        if walk is None:
            self.call(_flt_entry("gatling_shade_resident", flt), params.data_ptr(),
                       *self._resident_args(tris, bvh, cutout), *shading, *bufs, int(bool(nee)),
                       *flags)
        else:
            self.call(_walk_entry("gatling_shade_walk", nee, vol, flt), params.data_ptr(),
                       *self._walk_args(tris, walk), *shading, *bufs, *flags)


def _flt_entry(base: str, flt: bool) -> str:
    """The entry point of K4 or tap_rows over an 8-bit pool, or (..._flt) a
    float one."""
    return base + ("_flt" if flt else "")


def _walk_entry(base: str, nee: bool, volumes: int, flt: bool = False) -> str:
    """The walk kernels' entry point of a NEE flag and a volume mode (the
    plain ones take VOL_OFF, the ..._vol ones the volume modes), K4's over
    a float pool with `flt`."""
    return _flt_entry(base + ("_vol" if volumes != VOL_OFF else "") + ("_nee" if nee else ""),
                      flt)


_kernel: BounceKernel | None = None
# kernel launches made on CUDA tensors, by kernel (chip_smoke.py reads
# them): K1 resident bounce, K2 the two-level walk, K3 trace, K4 shade,
# K4t K4's taps alone (tap_rows), K4r a textured-cutout re-trace round
# (retrace_round); K4f, K4tf and K4rf their FLT instances, over a float pool
launches = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K4t": 0, "K4r": 0, "K4f": 0, "K4tf": 0,
            "K4rf": 0}


def kernel() -> BounceKernel:
    """The kernels' build, made at first use."""
    global _kernel
    if _kernel is None:
        _kernel = BounceKernel()
    return _kernel


def _walk(tensors) -> WalkTables | None:
    return WalkTables(*tensors) if tensors else None


def _bvh(tensors) -> TriBvh | None:
    return TriBvh(*tensors) if tensors else None


def _bounce_cuda(params, tris, bvh, mats, lights, light_types, state, nee: bool,
                 advanced: bool, cutout: bool, volumes: int) -> None:
    kernel().launch(params, tris, _bvh(bvh), mats, lights, light_types, state, nee, advanced,
                    cutout, volumes)
    launches["K1"] += 1
    validate.after_launch("K1", lambda: validate.state_rows(state))


def _bounce_cpu(params, tris, bvh, mats, lights, light_types, state, nee: bool,
                advanced: bool, cutout: bool, volumes: int) -> None:
    bounce_ref(params, tris, mats, lights, tuple(light_types.tolist()), state, nee,
               advanced=advanced, cutout=cutout, volumes=volumes)


def _walk_cuda(params, tris, mats, lights, light_types, walk, state, nee: bool,
               advanced: bool, cutout: bool, volumes: int) -> None:
    kernel().launch_walk(params, tris, mats, lights, light_types, _walk(walk), state, nee,
                         advanced, cutout, volumes)
    launches["K2"] += 1
    validate.after_launch("K2", lambda: validate.state_rows(state))


def _walk_cpu(params, tris, mats, lights, light_types, walk, state, nee: bool,
              advanced: bool, cutout: bool, volumes: int) -> None:
    bounce_ref(params, tris, mats, lights, tuple(light_types.tolist()), state, nee, _walk(walk),
               advanced, cutout, volumes)


def _trace_cuda(params, tris, state, walk, bvh, cutout: bool) -> torch.Tensor:
    hit = torch.empty((hit_row_count(has_tangents(tris)), state.shape[1]), dtype=torch.float32,
                      device=state.device)
    kernel().launch_trace(params, tris, _walk(walk), _bvh(bvh), state, hit, cutout)
    launches["K3"] += 1
    validate.after_launch("K3", lambda: validate.hit_rows(hit))
    return hit


def _trace_cpu(params, tris, state, walk, bvh, cutout: bool) -> torch.Tensor:
    return trace_ref(params, tris, state, _walk(walk), cutout)


_srgb_luts: dict[torch.device, torch.Tensor] = {}


def srgb_lut(device) -> torch.Tensor:
    """K4's sRGB decode table on `device` (render/texture.py srgb_table),
    built there once."""
    device = torch.device(device)
    if device not in _srgb_luts:
        _srgb_luts[device] = srgb_table(device)
    return _srgb_luts[device]


def tap_mask(textured: int, hit_rows: int, pool: TexturePool) -> int:
    """The TAP_* mask of a split shade: the TAP_BITS of the textured
    parameters it reads, the normal map when the hit buffer carries the
    tangent rows, and TAP_FLOAT for a float pool (sample_pool's float
    branch: every pool that is not 8-bit); 0 for a pool with no texture
    (an anisotropic scene's empty pool)."""
    if not (pool.count > 1 or pool.has_texels):
        return 0
    return (textured | (TAP_NORMAL if hit_rows == HIT_ROWS_TAN else 0)
            | (0 if pool.packed else TAP_FLOAT))


def _shade_cuda(params, tris, mats, lights, light_types, walk, bvh, hit, mat_f, mat_i, pool,
                textured: int, state, nee: bool, advanced: bool, cutout: bool,
                volumes: int) -> None:
    pool = TexturePool(*pool)
    mask = tap_mask(textured, hit.shape[0], pool)
    kernel().launch_shade(params, tris, mats, lights, light_types, _walk(walk), _bvh(bvh), state,
                          hit, mat_i, pool, mask, nee, advanced, cutout, volumes)
    launches["K4f" if mask & TAP_FLOAT else "K4"] += 1
    validate.after_launch("K4", lambda: validate.state_rows(state))


def _shade_cpu(params, tris, mats, lights, light_types, walk, bvh, hit, mat_f, mat_i, pool,
               textured: int, state, nee: bool, advanced: bool, cutout: bool,
               volumes: int) -> None:
    # the texture stage, then the shade twin
    active = tuple(name for name in PAR_ORDER if textured & TAP_BITS[name])
    parbuf, hit = material_rows(MaterialTable(mat_f, mat_i), TexturePool(*pool), hit, active)
    shade_ref(params, tris, mats, lights, tuple(light_types.tolist()), state, hit, parbuf,
              par_row_starts(active), nee, _walk(walk), advanced, cutout, volumes)


_lib = torch.library.Library("gatling", "DEF")
_lib.define("bounce_step(Tensor params, Tensor tris, Tensor[] bvh, Tensor mats, Tensor lights, "
            "Tensor light_types, Tensor(a!) state, bool nee, bool advanced, bool cutout, "
            "int volumes) -> ()")
_lib.impl("bounce_step", _bounce_cuda, "CUDA")
_lib.impl("bounce_step", _bounce_cpu, "CPU")
_lib.define("bounce_step_walk(Tensor params, Tensor tris, Tensor mats, Tensor lights, "
            "Tensor light_types, Tensor[] walk, Tensor(a!) state, bool nee, bool advanced, "
            "bool cutout, int volumes) -> ()")
_lib.impl("bounce_step_walk", _walk_cuda, "CUDA")
_lib.impl("bounce_step_walk", _walk_cpu, "CPU")
_lib.define("trace_step(Tensor params, Tensor tris, Tensor state, Tensor[] walk, "
            "Tensor[] bvh, bool cutout) -> Tensor")
_lib.impl("trace_step", _trace_cuda, "CUDA")
_lib.impl("trace_step", _trace_cpu, "CPU")
_lib.define("shade_step(Tensor params, Tensor tris, Tensor mats, Tensor lights, "
            "Tensor light_types, Tensor[] walk, Tensor[] bvh, Tensor hit, Tensor mat_f, "
            "Tensor mat_i, Tensor[] pool, int textured, Tensor(a!) state, bool nee, "
            "bool advanced, bool cutout, int volumes) -> ()")
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


def tap_rows_ref(hitbuf: torch.Tensor, materials: MaterialTable, textures: TexturePool,
                 textured_params) -> torch.Tensor:
    """tap_rows' twin, on the device of its tensors: the raw material
    table's base colour and metallic with the texture stage's taps laid
    over (ops/split_ref.py material_rows), and its shading normal
    (normal-mapped there when the hit buffer has tangent rows)."""
    active = tuple(name for name in PAR_ORDER if name in textured_params
                   and TAP_BITS.get(name, 0) & TAP_PEEL)
    parbuf, hit_n = material_rows(materials, textures, hitbuf, active)
    mat = torch.clamp(torch.round(hitbuf[H_MAT]).long(), 0, materials.packed_f.shape[0] - 1)
    table = materials.packed_f[mat]
    out = torch.empty((TAP_ROWS, hitbuf.shape[1]), dtype=torch.float32, device=hitbuf.device)
    out[TAP_BASE_ROW:TAP_BASE_ROW + 3] = table[:, MF_BASE:MF_BASE + 3].T
    out[TAP_METAL_ROW] = table[:, MF_METAL]
    layout = dict(slim_param_layout(active))
    if "base_color" in layout:
        out[TAP_BASE_ROW:TAP_BASE_ROW + 3] = parbuf[layout["base_color"]:layout["base_color"] + 3]
    if "metallic" in layout:
        out[TAP_METAL_ROW] = parbuf[layout["metallic"]]
    out[TAP_N_ROW:TAP_N_ROW + 3] = hit_n[H_N:H_N + 3]
    return out


def _check_hit(name: str, hitbuf: torch.Tensor) -> None:
    _check_bounce("hit", hitbuf, torch.float32)
    if hitbuf.dim() != 2 or hitbuf.shape[0] not in (HIT_ROWS, HIT_ROWS_TAN):
        raise ValueError(f"{name}: hit buffer must be [16 or 24, R]")


def tap_rows(hitbuf: torch.Tensor, materials: MaterialTable, textures: TexturePool,
             textured_params) -> torch.Tensor:
    """K4's taps alone, for the bounce-0 peel: [TAP_ROWS, R] of the base
    colour (rows TAP_BASE_ROW..+3), metallic (TAP_METAL_ROW) and shading
    normal (TAP_N_ROW..+3) each hit ray of K3's hit buffer shades with,
    from the raw material table `materials` and the texture pool, for the
    textured parameters `textured_params`: K4's device code (tap_kernel)
    on CUDA tensors, tap_rows_ref on CPU ones. Rows of missed rays are
    unspecified."""
    if not hitbuf.is_cuda:
        return tap_rows_ref(hitbuf, materials, textures, textured_params)
    k, mats = kernel(), materials.packed_f
    _check_bounce("mats", mats, torch.float32)
    _check_hit("tap_rows", hitbuf)
    out = torch.empty((TAP_ROWS, hitbuf.shape[1]), dtype=torch.float32, device=hitbuf.device)
    textured = sum(bit for name, bit in TAP_BITS.items() if name in textured_params)
    mask = tap_mask(textured & TAP_PEEL, hitbuf.shape[0], textures)
    taps = k._tap_args(mats, materials.packed_i, textures, mask)
    flt = bool(mask & TAP_FLOAT)
    k.call(_flt_entry("gatling_tap_rows", flt), mats.data_ptr(), mats.shape[0], hitbuf.data_ptr(),
           hitbuf.shape[1], *taps, out.data_ptr(), k.stream(hitbuf))
    launches["K4tf" if flt else "K4t"] += 1
    validate.after_launch("K4t", lambda: (out[:, hitbuf[0] > 0.5],))  # missed rays: unwritten
    return out


def retrace_draws(salt: torch.Tensor, rnd: int) -> torch.Tensor:
    """The textured-cutout re-trace's uniform draw of round `rnd`
    (gatling_tpu/render/fused.py:342-346): a hash of each ray's PCG word `salt` (uint32
    values in int64 carriers), salted by the round, in [0, 1)."""
    h = salt ^ ((0x9E3779B9 + 0x85EB * rnd) & 0xFFFFFFFF)
    h = ((h ^ (h >> 16)) * 0x21F0AAAD) & 0xFFFFFFFF
    h = ((h ^ (h >> 15)) * 0x735A2D97) & 0xFFFFFFFF
    return ((h ^ (h >> 15)) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def retrace_round_ref(state: torch.Tensor, masked: torch.Tensor, hitbuf: torch.Tensor,
                      materials: MaterialTable, textures: TexturePool, textured_params,
                      rnd: int) -> None:
    """retrace_round's twin, the JAX round (gatling_tpu/render/fused.py:337-358) in
    PyTorch ops on the device of its tensors: the draw against the opacity
    tapped at every alive ray's hit (apply_textures) where the material
    binds an opacity texture; a rejected ray's origin moved just past the
    surface in state rows 0-2; `masked` a copy of the state with row 13
    the rejected rays' alive row, 0 elsewhere."""
    mat = torch.clamp(torch.round(hitbuf[H_MAT]).long(), 0, materials.packed_f.shape[0] - 1)
    params = gather_params(materials, mat)
    if "opacity" in textured_params:
        uv = torch.stack([hitbuf[H_UVX], hitbuf[H_UVY]], dim=-1)
        params = apply_textures(materials, textures, params, mat, uv, ("opacity",))
    has_slot = materials.packed_i[:, MI_OPACITY_TEX] >= 0
    reject = ((state[13] > 0.5) & (hitbuf[H_HIT] > 0.5) & has_slot[mat]
              & (retrace_draws(f32_bits_to_u32(state[12]), rnd) >= cutout_opacity(params)))
    past = offset_ray_origin(hitbuf[H_POS:H_POS + 3].T, -hitbuf[H_GN:H_GN + 3].T)
    state[0:3] = torch.where(reject, past.T, state[0:3])
    masked.copy_(state)
    masked[13] = torch.where(reject, state[13], 0.0)


def retrace_round(state: torch.Tensor, masked: torch.Tensor, hitbuf: torch.Tensor,
                  materials: MaterialTable, textures: TexturePool, textured_params,
                  rnd: int) -> None:
    """Round `rnd` of the textured-cutout re-trace on K3's hit buffer, in
    place: each alive ray whose hit's material binds an opacity texture
    draws (retrace_draws) against the cutout opacity tapped at its hit; a
    rejected ray's origin moves just past the surface in state rows 0-2
    and in `masked` rows 0-2, and masked row 13, the alive row of the
    state K3 re-traces, becomes state row 13 where rejected, else 0.
    `masked` is a copy of the state made before the first round of a
    bounce. K4r (retrace_kernel; K4rf over a float pool) on CUDA tensors,
    retrace_round_ref on CPU ones."""
    if not hitbuf.is_cuda:
        retrace_round_ref(state, masked, hitbuf, materials, textures, textured_params, rnd)
        return
    k, mats = kernel(), materials.packed_f
    _check_bounce("mats", mats, torch.float32)
    _check_hit("retrace_round", hitbuf)
    for name, t in (("state", state), ("masked", masked)):
        _check_bounce(name, t, torch.float32)
        if t.shape != (STATE_ROWS, hitbuf.shape[1]):
            raise ValueError(f"retrace_round: {name} must be [16, {hitbuf.shape[1]}]")
    mask = tap_mask(TAP_OPACITY if "opacity" in textured_params else 0, HIT_ROWS, textures)
    taps = k._tap_args(mats, materials.packed_i, textures, mask)
    flt = bool(mask & TAP_FLOAT)
    k.call(_flt_entry("gatling_retrace_round", flt), mats.data_ptr(), mats.shape[0],
           hitbuf.data_ptr(), hitbuf.shape[1], *taps, int(rnd), state.data_ptr(),
           masked.data_ptr(), k.stream(hitbuf))
    launches["K4rf" if flt else "K4r"] += 1
    validate.after_launch("K4r", lambda: (state[0:3], masked[13]))


def bounce_step(params: torch.Tensor, scene: FusedScene, state: torch.Tensor,
                nee: bool) -> None:
    """One fused bounce over state [16, R], in place: K1 for a resident
    scene, K2 for a clustered or instanced one, on a CUDA state; the plain
    twin on a CPU state. The scene's flags pick the branches."""
    flags = (bool(nee), bool(scene.advanced), bool(scene.cutout), int(scene.volumes))
    if scene.walk is None:
        torch.ops.gatling.bounce_step(params, scene.tris, list(scene.bvh or ()), scene.mats,
                                      scene.lights, scene.light_types, state, *flags)
    else:
        torch.ops.gatling.bounce_step_walk(params, scene.tris, scene.mats, scene.lights,
                                           scene.light_types, list(scene.walk), state,
                                           *flags)


def trace_step(params: torch.Tensor, scene: FusedScene, state: torch.Tensor) -> torch.Tensor:
    """The split bounce's trace (K3 on a CUDA state, its twin on a CPU
    one): the hit buffer [16, R] ([24, R] with tangent rows) of state
    [16, R] (ops/split_ref.py H_* rows)."""
    return torch.ops.gatling.trace_step(params, scene.tris, state, list(scene.walk or ()),
                                        list(scene.bvh or ()), bool(scene.cutout))


def shade_step(params: torch.Tensor, scene: FusedScene, state: torch.Tensor,
               hitbuf: torch.Tensor, materials: MaterialTable, textures: TexturePool,
               textured_params, nee: bool) -> None:
    """The split bounce's shade, in place, from K3's hit buffer: the
    material rows of scene.mats, with the parameters `textured_params`
    tapped from `textures` where the device material table `materials`
    binds a slot, and the shading normal normal-mapped when the hit buffer
    carries the tangent rows. On a CUDA state K4, which taps the textures
    itself; on a CPU state the texture stage (render/fused.py
    material_rows), then K4's twin."""
    textured = sum(bit for name, bit in TAP_BITS.items() if name in textured_params)
    torch.ops.gatling.shade_step(params, scene.tris, scene.mats, scene.lights,
                                 scene.light_types, list(scene.walk or ()),
                                 list(scene.bvh or ()), hitbuf, materials.packed_f,
                                 materials.packed_i, list(textures), textured, state, bool(nee),
                                 bool(scene.advanced), bool(scene.cutout), int(scene.volumes))
