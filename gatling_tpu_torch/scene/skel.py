"""UsdSkel linear-blend skinning, evaluated at scene load.

The reference renders skinned meshes by taking Hydra's extComputation
points output (hdGatling mesh.cpp:852-890 — the UsdSkel skinning
computation runs host-side before the delegate sees points). This module
is the standalone-stack analog: when a Mesh carries SkelBindingAPI data
(`skel:skeleton` rel + `primvars:skel:jointIndices/jointWeights`), its
points are skinned with classic LBS at the resolved frame before
triangulation. Because `resolve_frame` has already collapsed every
timeSamples attribute (usda.py), the SkelAnimation's translations/
rotations/scales read here are the frame's values — no separate time
plumbing.

Scope (documented limits, logged via the lowering-diagnostics pattern):
classic linear skinning only (UsdSkel's default `skinningMethod`); blend
shapes apply as pre-LBS point offsets (in-betweens ignored); the mesh is
assumed to sit at the skeleton's frame
(identity mesh-local under the SkelRoot — the layout Blender/Maya/Houdini
exporters author), matching UsdSkelSkinningQuery's skel-space math when
geomBindTransform carries the mesh->skel bind map.

All math is in the row-vector convention the rest of scene/stage.py uses
(USD matrix4d rows ARE row-vector matrices: translation in row 3).
"""
from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger("gatling.skel")


def _attr_val(prim, name, default=None):
    a = prim.attrs.get(name)
    return a.value if a is not None and a.value is not None else default


def _quat_to_mat_row(q) -> np.ndarray:
    """USD text quat (w, x, y, z) -> 3x3 row-vector rotation (R_colᵀ)."""
    w, x, y, z = (float(c) for c in q)
    n = (w * w + x * x + y * y + z * z) or 1.0
    s = 2.0 / n
    R = np.array([
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
    ])
    return R.T


def _trs_row(t, q, s) -> np.ndarray:
    """UsdSkelMakeTransform (column T*R*S) as a row-vector 4x4:
    v' = v @ S_r @ R_r @ T_r."""
    m = np.eye(4)
    m[:3, :3] = np.diag([float(c) for c in s]) @ _quat_to_mat_row(q)
    m[3, :3] = [float(c) for c in t]
    return m


def _parent_indices(joints: list[str]) -> list[int]:
    index = {p: i for i, p in enumerate(joints)}
    out = []
    for p in joints:
        parent = -1
        parts = p.split("/")
        for k in range(len(parts) - 1, 0, -1):
            cand = "/".join(parts[:k])
            if cand in index:
                parent = index[cand]
                break
        out.append(parent)
    return out


def _find_binding(stage, prim, rel_name: str):
    """SkelBindingAPI rels inherit down namespace: check the prim, then
    every ancestor (the SkelRoot typically carries them)."""
    p = prim
    path = prim.path
    while p is not None:
        targets = p.rels.get(rel_name)
        if targets:
            return targets[0]
        path = path.rsplit("/", 1)[0]
        p = stage.find(path) if path else None
    return None


def _skel_space_transforms(stage, skel_prim) -> tuple[list[str], np.ndarray]:
    """(joint paths, [J,4,4] skel-space joint transforms at the resolved
    frame): per-joint local TRS from the bound SkelAnimation where
    authored, restTransforms elsewhere, composed down the joint
    hierarchy (row-vector: world_r = local_r @ parent_r)."""
    joints = [str(j) for j in _attr_val(skel_prim, "joints", [])]
    rest = _attr_val(skel_prim, "restTransforms")
    if rest is not None:
        # text layers parse to [J][4][4] tuples; the crate reader returns
        # flat float arrays — normalize both
        local = list(np.asarray(rest, np.float64).reshape(-1, 4, 4))
    else:
        local = [np.eye(4) for _ in joints]

    anim_path = _find_binding(stage, skel_prim, "skel:animationSource")
    if anim_path:
        anim = stage.find(str(anim_path))
        if anim is not None:
            aj = [str(j) for j in _attr_val(anim, "joints", [])]
            tr = _attr_val(anim, "translations")
            ro = _attr_val(anim, "rotations")
            sc = _attr_val(anim, "scales")
            if tr is not None:
                tr = np.asarray(tr, np.float64).reshape(-1, 3)
            if ro is not None:
                ro = np.asarray(ro, np.float64).reshape(-1, 4)
            if sc is not None:
                sc = np.asarray(sc, np.float64).reshape(-1, 3)
            index = {p: i for i, p in enumerate(joints)}
            for k, jp in enumerate(aj):
                i = index.get(jp)
                if i is None:
                    continue
                t = tr[k] if tr is not None else (0.0, 0.0, 0.0)
                q = ro[k] if ro is not None else (1.0, 0.0, 0.0, 0.0)
                s = sc[k] if sc is not None else (1.0, 1.0, 1.0)
                local[i] = _trs_row(t, q, s)

    world = [np.eye(4)] * len(joints)
    for i, parent in enumerate(_parent_indices(joints)):
        world[i] = local[i] @ world[parent] if parent >= 0 else local[i]
    return joints, (np.stack(world) if joints else np.zeros((0, 4, 4)))



def _apply_blend_shapes(stage, prim, skel_prim, pts):
    """UsdSkel blend shapes (pre-LBS point offsets): mesh skel:blendShapes
    tokens pair order-wise with skel:blendShapeTargets rels; weights come
    from the bound SkelAnimation's blendShapes/blendShapeWeights (already
    frame-resolved). In-between shapes are not supported (logged).
    Returns offset points, or None when no shapes apply."""
    names = _attr_val(prim, "skel:blendShapes")
    targets = prim.rels.get("skel:blendShapeTargets")
    if not names or not targets:
        return None
    anim_path = _find_binding(stage, prim, "skel:animationSource") or \
        _find_binding(stage, skel_prim, "skel:animationSource")
    anim = stage.find(str(anim_path)) if anim_path else None
    if anim is None:
        return None
    anames = [str(t) for t in _attr_val(anim, "blendShapes", [])]
    weights = _attr_val(anim, "blendShapeWeights")
    if weights is None:
        return None
    weights = np.asarray(weights, np.float64).ravel()
    wmap = {n: float(weights[i]) for i, n in enumerate(anames)
            if i < len(weights)}
    out = pts.copy()
    for name, tgt in zip([str(n) for n in names], targets):
        w = wmap.get(str(name), 0.0)
        if w == 0.0:
            continue
        shape = stage.find(str(tgt))
        if shape is None:
            log.warning("blend shape target %s not found", tgt)
            continue
        if _attr_val(shape, "inbetweens") is not None:
            log.info("in-between shapes on %s ignored", tgt)
        offs = _attr_val(shape, "offsets")
        if offs is None:
            continue
        offs = np.asarray(offs, np.float64).reshape(-1, 3)
        pi = _attr_val(shape, "pointIndices")
        if pi is not None:
            idx = np.asarray(pi, np.int64).ravel()
            ok = idx < len(out)
            out[idx[ok]] += w * offs[: len(idx)][ok]
        elif len(offs) == len(out):
            out += w * offs
        else:
            log.warning("blend shape %s offsets length mismatch", tgt)
    return out


def maybe_skin_mesh(stage, prim, points, normals, corner_point_indices=None):
    """Apply UsdSkel LBS to `points` (and `normals`) if `prim` is bound to
    a skeleton. Returns (points, normals, skinned: bool); unskinned input
    passes through unchanged.

    normals handling: vertex-interp normals ([n_points, 3]) and
    face-varying normals (with `corner_point_indices` mapping each corner
    to its point) transform by the blended matrix's inverse-transpose;
    anything else is dropped to the smooth-normal fallback (skinning
    invalidates rest-pose normals).
    """
    skel_path = _find_binding(stage, prim, "skel:skeleton")
    ji = prim.attrs.get("primvars:skel:jointIndices")
    jw = prim.attrs.get("primvars:skel:jointWeights")
    if skel_path is None or ji is None or jw is None:
        return points, normals, False
    skel = stage.find(str(skel_path))
    if skel is None:
        log.warning("skel:skeleton %s not found for %s", skel_path, prim.path)
        return points, normals, False
    pts_in = np.asarray(points, np.float64)
    bs_applied = _apply_blend_shapes(stage, prim, skel, pts_in)
    if bs_applied is not None:
        pts_in = bs_applied

    joints, world = _skel_space_transforms(stage, skel)
    bind = _attr_val(skel, "bindTransforms")
    if bind is None or not joints:
        return points, normals, False
    bind = np.asarray(bind, np.float64).reshape(-1, 4, 4)  # row-vector
    # M_r = inv(bind_r) @ world_r  (column: world @ inv(bind))
    skin = np.linalg.inv(bind) @ world  # [J, 4, 4]

    # optional joint-order override on the binding (SkelBindingAPI
    # skel:joints): indices refer to THIS list, remapped to skeleton order
    override = _attr_val(prim, "skel:joints")
    if override is None:
        o = stage.find(prim.path.rsplit("/", 1)[0])
        override = _attr_val(o, "skel:joints") if o is not None else None
    if override is not None:
        index = {p: i for i, p in enumerate(joints)}
        remap = np.asarray([index.get(str(p), 0) for p in override], np.int64)
        skin = skin[remap]

    k = int(ji.meta.get("elementSize", 1))
    idx = np.asarray(ji.value, np.int64).reshape(-1, k)
    w = np.asarray(jw.value, np.float64).reshape(-1, k)
    pts = pts_in
    n_pts = len(pts)
    if len(idx) == 1:  # constant interpolation: rigid whole-mesh binding
        idx = np.broadcast_to(idx, (n_pts, k))
        w = np.broadcast_to(w, (n_pts, k))
    if len(idx) != n_pts:
        log.warning("jointIndices length %d != %d points on %s — skipped",
                    len(idx), n_pts, prim.path)
        return points, normals, False

    gb = _attr_val(prim, "primvars:skel:geomBindTransform")
    if gb is not None:
        ph = np.concatenate([pts, np.ones((n_pts, 1))], axis=1)
        pts = (ph @ np.asarray(gb, np.float64).reshape(4, 4))[:, :3]

    # blended per-point matrix B = sum_k w_k * skin[idx_k]  [N, 4, 4]
    B = np.einsum("nk,nkij->nij", w, skin[idx])
    ph = np.concatenate([pts, np.ones((n_pts, 1))], axis=1)
    out = np.einsum("ni,nij->nj", ph, B)[:, :3].astype(np.float32)

    new_normals = None
    if normals is not None:
        nrm = np.asarray(normals, np.float64)
        inv3t = np.linalg.inv(B[:, :3, :3]).transpose(0, 2, 1)
        if len(nrm) == n_pts:
            new_normals = np.einsum(
                "ni,nij->nj", nrm, inv3t).astype(np.float32)
        elif corner_point_indices is not None and \
                len(nrm) == len(corner_point_indices):
            ci = np.asarray(corner_point_indices, np.int64)
            new_normals = np.einsum(
                "ni,nij->nj", nrm, inv3t[ci]).astype(np.float32)
        else:
            log.info("dropping rest-pose normals on skinned %s "
                     "(smooth fallback)", prim.path)
        if new_normals is not None:
            ln = np.linalg.norm(new_normals, axis=1, keepdims=True)
            new_normals = (new_normals / np.maximum(ln, 1e-20)).astype(
                np.float32)
    return out, new_normals, True
