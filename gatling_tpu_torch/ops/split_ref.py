"""Plain PyTorch twins of the split-bounce kernels K3 (trace) and K4 (shade).

The JAX package splits a textured bounce in three (trace_step, the XLA
texture stage `_material_rows`, shade_step): K3 finds each ray's closest
hit and writes its shading state into a hit buffer; the texture stage
samples the textured parameters into a parameter buffer and, on
normal-mapped scenes, perturbs the shading normal; K4 shades from both.
The port's K4 taps the textures itself; its twin is the texture stage's
port, material_rows here, then shade_ref. Layouts shared with
csrc/bounce.cu:

* hit buffer [16, R] f32 (24 rows with tangents): the H_* rows below; a
  dead ray's rows are all 0;
* parameter buffer [rows, R] f32 in the slim layout: a row block for each
  parameter that some material textures (slim_param_layout), in the order
  base_color, emissive, metallic, roughness, padded to a multiple of 8.

K3 over clustered and instanced tables equals `_finalize_hits`
(pallas_bounce.py :3504): t recomputed in the division form, normals as
covectors, tangents through the exact inverse of the instance transform.
Both twins reuse the bounce twin's searches and shading core
(ops/bounce_ref.py), so K1/K2 and K3+K4 shade alike.
"""

from __future__ import annotations

import torch

from gatling_tpu_torch.ops.bounce_ref import (
    P_TMIN,
    TR_BS,
    TR_DS,
    TR_GN,
    TR_MAT,
    TR_N0,
    TR_N1,
    TR_N2,
    TR_T0,
    TR_T1,
    TR_T2,
    TR_UV,
    TRI_ROWS_TAN,
    VOL_ABSORB,
    VOL_OFF,
    WalkTables,
    _FMAX,
    _where,
    cutout_key,
    material_rows as table_rows,
    occluder,
    resident_hits,
    shade_core,
    surface_state,
    walk_closest,
    walk_hit_attrs,
)
from gatling_tpu_torch.interface import f32
from gatling_tpu_torch.render.material import (
    MaterialTable,
    apply_textures,
    gather_params,
    perturb_normal,
)
from gatling_tpu_torch.render.texture import TexturePool

# hit buffer rows (pallas_bounce.py :246-256)
H_HIT, H_T, H_UVX, H_UVY, H_MAT = 0, 1, 2, 3, 4
H_GN, H_N, H_FRONT, H_DS, H_POS = 5, 8, 11, 12, 13
HIT_ROWS = 16
# tangent extension: the orthonormalised shading tangent and the
# interpolated bitangent sign, for the texture stage's normal mapping
H_TAN, H_BS = 16, 19
HIT_ROWS_TAN = 24

# slim parameter buffer (pallas_bounce.py :258-285)
PR_WIDTHS = {"base_color": 3, "emissive": 3, "metallic": 1, "roughness": 1}
PAR_ORDER = ("base_color", "emissive", "metallic", "roughness")
# calls of material_rows, the texture stage (chip_smoke.py asserts that a
# textured frame on the card makes none)
stage_calls = 0


def has_tangents(tris: torch.Tensor) -> bool:
    """Whether a resident or clustered table carries the tangent rows
    (resident: 48 floats a row, 52 with the cutout rows)."""
    return tris.shape[1] >= TRI_ROWS_TAN


def hit_row_count(tangents: bool) -> int:
    return HIT_ROWS_TAN if tangents else HIT_ROWS


def slim_param_layout(textured_params) -> tuple[tuple[str, int], ...]:
    """(name, first row) of each textured parameter in the slim buffer."""
    layout, row = [], 0
    for name in PAR_ORDER:
        if name in textured_params:
            layout.append((name, row))
            row += PR_WIDTHS[name]
    return tuple(layout)


def slim_param_rows(textured_params) -> int:
    """Rows of the slim buffer, padded to a multiple of 8."""
    used = sum(PR_WIDTHS[n] for n, _ in slim_param_layout(textured_params))
    return max(8, -(-used // 8) * 8)


def par_row_starts(textured_params) -> list[int]:
    """First row of base_color, emissive, metallic and roughness in the
    slim buffer, -1 where untextured (the kernel's form of the layout)."""
    rows = dict(slim_param_layout(textured_params))
    return [rows.get(name, -1) for name in PAR_ORDER]


def material_rows(materials: MaterialTable, textures: TexturePool, hitbuf: torch.Tensor,
                  active: tuple[str, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """The texture stage of the JAX package's split bounce (render/fused.py
    _material_rows), the plain twin of K4's taps: (the slim parameter
    buffer of the textured parameters `active`, the hit buffer). When the
    hit buffer carries tangent rows, its H_N rows come back normal-mapped.
    `materials` is the raw material table on the device; missed and dead
    rays read row 0 harmlessly."""
    global stage_calls
    stage_calls += 1
    mat = torch.clamp(torch.round(hitbuf[H_MAT]).to(torch.int32), min=0)
    uv = torch.stack([hitbuf[H_UVX], hitbuf[H_UVY]], dim=-1)
    p = apply_textures(materials, textures, gather_params(materials, mat), mat, uv, active)
    rows: list[torch.Tensor] = []
    for name, _row in slim_param_layout(active):
        val = getattr(p, name)
        rows += list(val.T) if val.dim() == 2 else [val]
    rows += [torch.zeros_like(hitbuf[0])] * (slim_param_rows(active) - len(rows))
    if hitbuf.shape[0] > HIT_ROWS:
        n = hitbuf[H_N:H_N + 3].T
        t = hitbuf[H_TAN:H_TAN + 3].T
        b = torch.linalg.cross(n, t) * hitbuf[H_BS][:, None]
        hitbuf = hitbuf.clone()
        hitbuf[H_N:H_N + 3] = perturb_normal(materials, textures, mat, uv, n, t, b).T
    return torch.stack(rows), hitbuf


def trace_ref(params: torch.Tensor, tris: torch.Tensor, state: torch.Tensor,
              walk: WalkTables | None = None, cutout: bool = False) -> torch.Tensor:
    """K3's twin: the hit buffer [16 or 24, R] of the alive rays of state
    [16, R] over resident tris [T, 32 or 48; 36 or 52 with cutout rows] or,
    with `walk`, clustered tris [C * 128, 40 or 56]; `cutout` draws each
    candidate against its pass probability, as the bounce twin does."""
    tmin = f32(float(params[P_TMIN]))
    o, d = (state[0], state[1], state[2]), (state[3], state[4], state[5])
    alive = state[13] > 0.5
    tangents = has_tangents(tris)
    key = cutout_key(state) if cutout else None
    tan = tbs = None
    if walk is None:
        t, u, v, attrs = resident_hits(tris, o, d, tmin, key)
        hit = alive & (t < _FMAX)

        def col(c0, n=3):
            return tuple(attrs[:, c0 + k] for k in range(n))

        gn, n0, n1, n2 = col(TR_GN), col(TR_N0), col(TR_N1), col(TR_N2)
        mat_f, dsided = attrs[:, TR_MAT], attrs[:, TR_DS]
        w = 1.0 - u - v
        uv = tuple(w * attrs[:, TR_UV + k] + u * attrs[:, TR_UV + 2 + k]
                   + v * attrs[:, TR_UV + 4 + k] for k in range(2))
        if tangents:
            tan = tuple(w * attrs[:, TR_T0 + k] + u * attrs[:, TR_T1 + k]
                        + v * attrs[:, TR_T2 + k] for k in range(3))
            tbs = w * attrs[:, TR_BS] + u * attrs[:, TR_BS + 1] + v * attrs[:, TR_BS + 2]
    else:
        o3, d3 = torch.stack(o, 1), torch.stack(d, 1)
        win = walk_closest(walk, tris, o3, d3, alive, tmin, key)
        hit = alive & (win >= 0)
        (t, u, v, gn, n0, n1, n2, mat_f, dsided, uv, tan, tbs) = walk_hit_attrs(
            walk, tris, o3, d3, win, surface=True)
    pos, gnf, nf, front = surface_state(o, d, t, u, v, gn, n0, n1, n2)
    rows = [hit.to(torch.float32), t, uv[0], uv[1], mat_f, *gnf, *nf,
            front.to(torch.float32), dsided, *pos]
    if tangents:
        # the tangent orthonormalised against the facing shading normal;
        # the texture stage takes the bitangent as cross(n, t) * sign
        tdn = tan[0] * nf[0] + tan[1] * nf[1] + tan[2] * nf[2]
        tx, ty, tz = (tan[k] - nf[k] * tdn for k in range(3))
        tlen = 1.0 / torch.sqrt(torch.clamp(tx * tx + ty * ty + tz * tz, min=1e-20))
        zero = torch.zeros_like(t)
        rows += [tx * tlen, ty * tlen, tz * tlen, tbs, zero, zero, zero, zero]
    return _where(alive[None], torch.stack(rows), 0.0)


def shade_ref(params: torch.Tensor, tris: torch.Tensor, mats: torch.Tensor,
              lights: torch.Tensor, light_types: tuple[int, ...], state: torch.Tensor,
              hitbuf: torch.Tensor, parbuf: torch.Tensor, par_rows, nee: bool,
              walk: WalkTables | None = None, advanced: bool = False,
              cutout: bool = False, volumes: int = VOL_OFF) -> None:
    """K4's twin: shade state [16, R] in place from the hit buffer; the
    material rows come from `mats` (the kernels' table of texture means),
    the textured parameters from parbuf rows par_rows (par_row_starts).
    `advanced`: the full lobe set, in the mesh-tangent frame of the hit
    buffer's tangent rows when it has them; `cutout`: the shadow rays'
    cutout draws; `volumes`: VOL_ABSORB, the absorption-only media (the
    split bounce has no scatter mode: gi sends scattering with textures or
    anisotropy to the wavefront)."""
    if volumes not in (VOL_OFF, VOL_ABSORB):
        raise ValueError(f"the split shade has no volume mode {volumes}")
    p = [f32(x) for x in params.tolist()]
    hit = (state[13] > 0.5) & (hitbuf[H_HIT] > 0.5)
    mrow = table_rows(mats, hitbuf[H_MAT], advanced, volumes)
    base, em, met, rough = par_rows
    if base >= 0:
        mrow[0:3] = [parbuf[base + k] for k in range(3)]
    if em >= 0:
        mrow[6:9] = [parbuf[em + k] for k in range(3)]
    if met >= 0:
        mrow[3] = parbuf[met]
    if rough >= 0:
        mrow[4] = parbuf[rough]

    def vec(r0):
        return hitbuf[r0], hitbuf[r0 + 1], hitbuf[r0 + 2]

    tangent = None
    if hitbuf.shape[0] == HIT_ROWS_TAN:
        tangent = (vec(H_TAN), hitbuf[H_BS])
    shade_core(p, state, hit, vec(H_POS), vec(H_GN), vec(H_N), hitbuf[H_FRONT] > 0.5,
               hitbuf[H_DS], mrow, lights, light_types, nee, occluder(tris, walk, cutout),
               advanced, tangent, volumes=volumes)
