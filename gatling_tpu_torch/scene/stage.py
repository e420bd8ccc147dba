"""Stage walker: parsed USDA prim tree -> renderable scene description.

Plays the role of UsdImagingDelegate::Populate + the hdGatling prim sync
(reference: src/gatling/main.cpp:145-151, src/hdGatling/{mesh,light,material,
instancer}.cpp): walks the prim hierarchy with accumulated transforms and
emits mesh / camera / light / material descriptions consumed by the gi layer.

Conventions: USD matrices are row-major with ROW-vector multiplication
(p' = p @ M); world = local @ parent_world.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import numpy as np

from gatling_tpu_torch.scene import meshproc
from gatling_tpu_torch.scene.usda import Attr, Prim, Stage, load_usd, load_usda
from gatling_tpu_torch.utils.log import get_logger

# UsdGeomCamera/GfCamera unit scale: apertures and focal length are authored
# in tenths of scene units (reference: renderPass.cpp:203-204 uses
# GfCamera::APERTURE_UNIT == FOCAL_LENGTH_UNIT == 0.1).
APERTURE_UNIT = 0.1
FOCAL_LENGTH_UNIT = 0.1


@dataclasses.dataclass
class CameraDesc:
    """Mirrors GiCameraDesc (reference: Gi.h)."""

    position: np.ndarray
    forward: np.ndarray
    up: np.ndarray
    vfov: float
    f_stop: float = 0.0
    focus_distance: float = 0.0
    focal_length: float = 0.05
    clip_start: float = 0.1
    clip_end: float = 100000.0
    exposure: float = 0.0


@dataclasses.dataclass
class ShaderNode:
    path: str
    shader_id: str  # info:id, e.g. UsdPreviewSurface / UsdUVTexture
    inputs: dict[str, Any]  # name -> constant value
    input_connections: dict[str, tuple[str, str]]  # name -> (node path, output name)


@dataclasses.dataclass
class MaterialDesc:
    path: str
    surface_node: str | None  # path of node driving outputs:surface
    nodes: dict[str, ShaderNode]
    base_dir: str = ""  # for resolving relative texture asset paths
    mdl_source: str | None = None  # .mdl module path (hot-reload watch)


@dataclasses.dataclass(eq=False)  # identity equality: scene objects hold
# numpy fields whose __eq__ is elementwise (list.remove would raise)
class MeshDesc:
    path: str
    mesh: meshproc.TriangulatedMesh
    transform: np.ndarray  # [4,4] USD row-vector world transform
    material: str | None  # material prim path
    double_sided: bool
    object_id: int
    instance_transforms: np.ndarray | None = None  # [N,4,4] or None
    # instance-rate primvars from a PointInstancer, aligned with
    # instance_transforms: {name: [N, <=3] float}. Materials reading them
    # through primvar leaves resolve per hit via the instance id
    # (reference: instancer.cpp:138-189 scene-data forwarding)
    instance_primvars: dict[str, np.ndarray] | None = None


@dataclasses.dataclass(eq=False)
class LightDesc:
    path: str
    light_type: str  # sphere / distant / rect / disk / dome
    transform: np.ndarray
    params: dict[str, Any]


@dataclasses.dataclass
class SceneDesc:
    meshes: list[MeshDesc]
    materials: dict[str, MaterialDesc]
    lights: list[LightDesc]
    cameras: dict[str, CameraDesc]
    meters_per_unit: float = 1.0
    render_settings: dict[str, Any] = dataclasses.field(default_factory=dict)

    def first_camera(self) -> CameraDesc | None:
        """First camera found, like the standalone CLI (main.cpp:57-82)."""
        return next(iter(self.cameras.values()), None)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _rot_x(deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.array([[1, 0, 0, 0], [0, c, s, 0], [0, -s, c, 0], [0, 0, 0, 1]], np.float64)


def _rot_y(deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], np.float64)


def _rot_z(deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.array([[c, s, 0, 0], [-s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)


def local_transform(prim: Prim) -> np.ndarray:
    """Evaluate xformOpOrder into a single row-vector matrix.

    Ops listed first in xformOpOrder are applied to geometry last, so with
    row vectors: M = reduce(matmul, reversed_ops_as_matrices)."""
    order_attr = prim.attrs.get("xformOpOrder")
    if order_attr is None or not order_attr.value:
        return np.eye(4)
    mats: list[np.ndarray] = []
    for op_name in order_attr.value:
        if op_name.startswith("!invert!"):
            base = op_name[len("!invert!"):]
            attr = prim.attrs.get(base)
            m = np.linalg.inv(_op_matrix(base, attr)) if attr else np.eye(4)
        else:
            attr = prim.attrs.get(op_name)
            m = _op_matrix(op_name, attr) if attr else np.eye(4)
        mats.append(m)
    out = np.eye(4)
    for m in reversed(mats):
        out = out @ m
    return out


def _op_matrix(op_name: str, attr: Attr) -> np.ndarray:
    val = attr.value
    kind = op_name.split(":")[1] if ":" in op_name else op_name
    kind = kind.split(":")[0]  # strip suffix like translate:pivot
    if kind == "transform":
        return np.array(val, dtype=np.float64).reshape(4, 4)
    if kind == "translate":
        m = np.eye(4)
        m[3, :3] = np.asarray(val, np.float64)
        return m
    if kind == "scale":
        m = np.eye(4)
        m[0, 0], m[1, 1], m[2, 2] = (float(v) for v in val)
        return m
    if kind in ("rotateX",):
        return _rot_x(float(val))
    if kind in ("rotateY",):
        return _rot_y(float(val))
    if kind in ("rotateZ",):
        return _rot_z(float(val))
    if kind in ("rotateXYZ", "rotateXZY", "rotateYXZ", "rotateYZX", "rotateZXY", "rotateZYX"):
        axes = {"X": _rot_x, "Y": _rot_y, "Z": _rot_z}
        rx, ry, rz = (float(v) for v in val)
        by_axis = {"X": rx, "Y": ry, "Z": rz}
        # rotation order D0 D1 D2 means D0 applied first => row vectors: M = D0 @ D1 @ D2
        order = kind[len("rotate"):]
        m = np.eye(4)
        for axis in order:
            m = m @ axes[axis](by_axis[axis])
        return m
    if kind == "orient":  # quaternion (w, x, y, z) in usda "quatf"
        w, x, y, z = (float(v) for v in val)
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (x * z - y * w)],
            [2 * (x * y - z * w), 1 - 2 * (x * x + z * z), 2 * (y * z + x * w)],
            [2 * (x * z + y * w), 2 * (y * z - x * w), 1 - 2 * (x * x + y * y)],
        ])
        m = np.eye(4)
        m[:3, :3] = r
        return m
    get_logger().warning("unsupported xform op %s", op_name)
    return np.eye(4)


def transform_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    return (np.append(np.asarray(p, np.float64), 1.0) @ m)[:3]


def transform_dir(m: np.ndarray, d: np.ndarray) -> np.ndarray:
    return np.asarray(d, np.float64) @ m[:3, :3]


# ---------------------------------------------------------------------------
# prim converters
# ---------------------------------------------------------------------------

def _attr_val(prim: Prim, name: str, default: Any = None) -> Any:
    a = prim.attrs.get(name)
    return a.value if a is not None and a.value is not None else default


def _build_camera(prim: Prim, world: np.ndarray) -> CameraDesc:
    """Reference: renderPass.cpp:191-228."""
    position = transform_point(world, [0.0, 0.0, 0.0])
    forward = transform_dir(world, [0.0, 0.0, -1.0])
    up = transform_dir(world, [0.0, 1.0, 0.0])
    forward /= np.linalg.norm(forward)
    up /= np.linalg.norm(up)

    aperture = float(_attr_val(prim, "verticalAperture", 20.955)) * APERTURE_UNIT
    focal = float(_attr_val(prim, "focalLength", 50.0)) * FOCAL_LENGTH_UNIT
    vfov = 2.0 * math.atan(aperture / (2.0 * focal))
    clip = _attr_val(prim, "clippingRange", (1.0, 1000000.0))
    return CameraDesc(
        position=position.astype(np.float32),
        forward=forward.astype(np.float32),
        up=up.astype(np.float32),
        vfov=float(vfov),
        f_stop=float(_attr_val(prim, "fStop", 0.0)),
        focus_distance=float(_attr_val(prim, "focusDistance", 0.0)),
        focal_length=focal,
        clip_start=float(clip[0]),
        clip_end=float(clip[1]),
        exposure=float(_attr_val(prim, "exposure", 0.0)),
    )


def _build_material(prim: Prim, base_dir: str) -> MaterialDesc:
    nodes: dict[str, ShaderNode] = {}
    for p in prim.walk():
        if p.type_name != "Shader":
            continue
        shader_id = str(_attr_val(p, "info:id", ""))
        inputs: dict[str, Any] = {}
        conns: dict[str, tuple[str, str]] = {}
        for name, attr in p.attrs.items():
            if not name.startswith("inputs:"):
                continue
            short = name[len("inputs:"):]
            if attr.connect:
                target = attr.connect
                if "." in target:
                    node_path, out_name = target.rsplit(".", 1)
                    out_name = out_name[len("outputs:"):] if out_name.startswith("outputs:") else out_name
                else:
                    node_path, out_name = target, "out"
                conns[short] = (node_path, out_name)
            elif attr.value is not None:
                inputs[short] = attr.value
        nodes[p.path] = ShaderNode(path=p.path, shader_id=shader_id, inputs=inputs, input_connections=conns)

    surface_node = None
    out = prim.attrs.get("outputs:surface")
    if out is not None and out.connect:
        surface_node = out.connect.rsplit(".", 1)[0]
    elif nodes:
        surface_node = next(iter(nodes))

    # MDL sourceAsset shaders (the reference's single-node MDL network route,
    # materialNetworkCompiler.cpp:635-665 _TryCompileMdlNetwork): load the
    # .mdl file through the MDL front end, with the shader prim's authored
    # inputs as typed parameter overrides
    for p in prim.walk():
        if p.type_name != "Shader" or p.path != surface_node:
            continue
        src_asset = _attr_val(p, "info:mdl:sourceAsset", None)
        if src_asset is None:
            continue
        from gatling_tpu_torch.render.mdl import load_mdl_material, resolve_mdl_path

        mdl_path = resolve_mdl_path(str(src_asset), base_dir)
        sub = _attr_val(p, "info:mdl:sourceAsset:subIdentifier", None)
        overrides = {k[len("inputs:"):]: a.value for k, a in p.attrs.items()
                     if k.startswith("inputs:") and a.value is not None}
        mdl_desc = load_mdl_material(
            mdl_path, str(sub) if sub else None, overrides,
            name=prim.path.strip("/").replace("/", "_"))
        return MaterialDesc(path=prim.path, surface_node=mdl_desc.surface_node,
                            nodes=mdl_desc.nodes, base_dir=mdl_desc.base_dir,
                            mdl_source=mdl_path)

    from gatling_tpu_torch.render.patcher import patch_preview_surface_network

    return patch_preview_surface_network(MaterialDesc(
        path=prim.path, surface_node=surface_node, nodes=nodes,
        base_dir=base_dir))


_LIGHT_TYPES = {
    "SphereLight": "sphere",
    "DistantLight": "distant",
    "RectLight": "rect",
    "DiskLight": "disk",
    "DomeLight": "dome",
    "DomeLight_1": "dome",
}


def _light_common_params(prim: Prim) -> dict[str, Any]:
    return {
        "intensity": float(_attr_val(prim, "inputs:intensity", 1.0)),
        "exposure": float(_attr_val(prim, "inputs:exposure", 0.0)),
        "color": np.asarray(_attr_val(prim, "inputs:color", (1.0, 1.0, 1.0)), np.float32),
        "normalize": bool(_attr_val(prim, "inputs:normalize", False)),
        "diffuse": float(_attr_val(prim, "inputs:diffuse", 1.0)),
        "specular": float(_attr_val(prim, "inputs:specular", 1.0)),
        "enableColorTemperature": bool(_attr_val(prim, "inputs:enableColorTemperature", False)),
        "colorTemperature": float(_attr_val(prim, "inputs:colorTemperature", 6500.0)),
    }


def _build_light(prim: Prim, world: np.ndarray, base_dir: str) -> LightDesc:
    lt = _LIGHT_TYPES[prim.type_name]
    params = _light_common_params(prim)
    if lt == "sphere":
        params["radius"] = float(_attr_val(prim, "inputs:radius", 0.5))
        params["treatAsPoint"] = bool(_attr_val(prim, "inputs:treatAsPoint", False))
    elif lt == "distant":
        params["angle"] = float(_attr_val(prim, "inputs:angle", 0.53))
    elif lt == "rect":
        params["width"] = float(_attr_val(prim, "inputs:width", 1.0))
        params["height"] = float(_attr_val(prim, "inputs:height", 1.0))
    elif lt == "disk":
        params["radius"] = float(_attr_val(prim, "inputs:radius", 0.5))
    elif lt == "dome":
        tex = _attr_val(prim, "inputs:texture:file")
        params["texture"] = os.path.join(base_dir, str(tex)) if tex else None
    return LightDesc(path=prim.path, light_type=lt, transform=world, params=params)


def _filter_triangles(tri: meshproc.TriangulatedMesh, keep: np.ndarray) -> meshproc.TriangulatedMesh:
    """Select triangles whose source polygon is in `keep` (bool per face id)."""
    mask = keep[tri.face_ids]
    corner = np.repeat(mask, 3)
    return meshproc.TriangulatedMesh(
        positions=tri.positions[corner], normals=tri.normals[corner],
        tangents=tri.tangents[corner], bitangent_signs=tri.bitangent_signs[corner],
        uvs=tri.uvs[corner], face_ids=tri.face_ids[mask],
        colors=(tri.colors[corner] if tri.colors is not None else None))


def _display_color_interp(prim: Prim, n_points: int, n_faces: int,
                          n_corners: int) -> meshproc.Interpolation | None:
    """Interpolation of the displayColor primvar: authored metadata, else
    inferred from the value count (USD primvar fallback rules)."""
    dc = prim.attrs.get("primvars:displayColor")
    if dc is None or dc.value is None:
        return None
    meta_interp = dc.meta.get("interpolation") if dc.meta else None
    if meta_interp:
        return meshproc.Interpolation(meta_interp)
    n = len(dc.value) if isinstance(dc.value, list) else 1
    if n <= 1:
        return meshproc.Interpolation.CONSTANT
    if n == n_points:
        return meshproc.Interpolation.VERTEX
    if n == n_faces:
        return meshproc.Interpolation.UNIFORM
    if n == n_corners:
        return meshproc.Interpolation.FACE_VARYING
    return meshproc.Interpolation.CONSTANT


def _display_color_material(prim: Prim, vertex_colors: bool = False
                            ) -> MaterialDesc | None:
    """Fallback material driven by displayColor, mirroring the reference's
    default displayColor MaterialX material (renderDelegate.cpp:64-78).
    When the primvar is non-constant its values ride the mesh as per-corner
    vertex colors (Mesh.PrimvarInterpolation parity) and the material's
    diffuse is white so base_color * vcolor reproduces the primvar."""
    dc = prim.attrs.get("primvars:displayColor")
    color = (0.5, 0.5, 0.5)
    if vertex_colors:
        color = (1.0, 1.0, 1.0)
    elif dc is not None and dc.value:
        v = dc.value[0] if isinstance(dc.value, list) else dc.value
        color = tuple(float(c) for c in v)[:3]
    path = prim.path + "/__displayColor"
    inputs: dict = {"diffuseColor": color}
    if vertex_colors:
        # only THIS material multiplies the interpolated vcolor rows in;
        # bound materials with their own base_color ignore them
        inputs["_vcolor_multiply"] = True
    node = ShaderNode(path=path + "/s", shader_id="UsdPreviewSurface",
                      inputs=inputs, input_connections={})
    return MaterialDesc(path=path, surface_node=node.path, nodes={node.path: node})


def _build_mesh(prim: Prim, world: np.ndarray, object_id: int,
                stage: "Stage | None" = None) -> MeshDesc | None:
    points = _attr_val(prim, "points")
    counts = _attr_val(prim, "faceVertexCounts")
    indices = _attr_val(prim, "faceVertexIndices")
    if points is None or counts is None or indices is None:
        return None
    normals_attr = prim.attrs.get("normals") or prim.attrs.get("primvars:normals")
    normals = normals_attr.value if normals_attr else None
    n_interp = meshproc.Interpolation.FACE_VARYING
    if normals_attr and normals_attr.meta.get("interpolation"):
        n_interp = meshproc.Interpolation(normals_attr.meta["interpolation"])
    elif normals_attr and not normals_attr.meta:
        # USD default interpolation for normals is vertex
        n_interp = meshproc.Interpolation.VERTEX

    if stage is not None:
        # UsdSkel LBS at the resolved frame (the extComputation-points
        # analog, hdGatling mesh.cpp:852-890; scene/skel.py)
        from gatling_tpu_torch.scene import skel as _skel

        corner_idx = (np.asarray(indices, np.int64)
                      if n_interp == meshproc.Interpolation.FACE_VARYING
                      else None)
        points, sk_normals, skinned = _skel.maybe_skin_mesh(
            stage, prim, points, normals, corner_idx)
        if skinned:
            normals = sk_normals
            if normals is None:
                n_interp = meshproc.Interpolation.FACE_VARYING

    uv_attr = None
    for uv_name in ("primvars:st", "primvars:uv", "primvars:UVMap", "primvars:st0"):
        if uv_name in prim.attrs:
            uv_attr = prim.attrs[uv_name]
            break
    uvs = uv_attr.value if uv_attr else None
    uv_interp = meshproc.Interpolation(uv_attr.meta.get("interpolation", "faceVarying")) if uv_attr else meshproc.Interpolation.FACE_VARYING
    uv_indices = prim.attrs.get(uv_attr and f"{uv_name}:indices" or "")
    if uv_attr is not None and uv_indices is not None and uv_indices.value is not None:
        uvs = np.asarray(uvs, np.float32)[np.asarray(uv_indices.value, np.int64)]

    orientation = str(_attr_val(prim, "orientation", "rightHanded"))

    material = None
    binding = prim.rels.get("material:binding")
    if binding:
        material = binding[0]

    # non-constant displayColor rides as per-corner vertex colors for BOTH
    # unbound meshes (feeding the white fallback material's vcolor multiply)
    # and bound ones (feeding geompropvalue/UsdPrimvarReader scene-data
    # reads, rp_main.h scene-data infos); bound materials that read no
    # primvar ignore the rows (the multiply is gated per material)
    colors = None
    colors_interp = meshproc.Interpolation.CONSTANT
    ci = _display_color_interp(prim, len(points), len(counts), len(indices))
    if ci is not None and ci != meshproc.Interpolation.CONSTANT:
        dc = prim.attrs.get("primvars:displayColor")
        colors = np.asarray([[float(c) for c in v][:3] for v in dc.value],
                            np.float32)
        colors_interp = ci

    tri = meshproc.build_triangulated_mesh(
        points=np.asarray(points, np.float32),
        face_vertex_counts=np.asarray(counts, np.int64),
        face_vertex_indices=np.asarray(indices, np.int64),
        normals=(np.asarray(normals, np.float32) if normals is not None else None),
        normals_interp=n_interp,
        uvs=(np.asarray(uvs, np.float32) if uvs is not None else None),
        uvs_interp=uv_interp,
        left_handed=(orientation == "leftHanded"),
        colors=colors,
        colors_interp=colors_interp,
    )
    return MeshDesc(
        path=prim.path,
        mesh=tri,
        transform=world,
        material=material,
        double_sided=bool(_attr_val(prim, "doubleSided", False)),
        object_id=object_id,
    )


def _instance_transforms(prim: Prim) -> np.ndarray:
    """PointInstancer per-instance matrices, row-vector convention:
    M_i = S_i @ R_i @ T_i (scale, then orient, then translate — the standard
    UsdGeomPointInstancer op order; reference: instancer.cpp:41-85)."""
    positions = np.asarray(_attr_val(prim, "positions", []), np.float64)
    n = len(positions)
    orientations = _attr_val(prim, "orientations")
    scales = _attr_val(prim, "scales")
    mats = np.tile(np.eye(4), (n, 1, 1))
    if scales is not None:
        s = np.asarray(scales, np.float64)
        for k in range(3):
            mats[:, k, k] = s[:, k]
    if orientations is not None:
        q = np.asarray(orientations, np.float64)  # (w, x, y, z) per usda
        w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        r = np.empty((n, 3, 3))
        r[:, 0, 0] = 1 - 2 * (y * y + z * z); r[:, 0, 1] = 2 * (x * y + z * w); r[:, 0, 2] = 2 * (x * z - y * w)
        r[:, 1, 0] = 2 * (x * y - z * w); r[:, 1, 1] = 1 - 2 * (x * x + z * z); r[:, 1, 2] = 2 * (y * z + x * w)
        r[:, 2, 0] = 2 * (x * z + y * w); r[:, 2, 1] = 2 * (y * z - x * w); r[:, 2, 2] = 1 - 2 * (x * x + y * y)
        rot = np.tile(np.eye(4), (n, 1, 1))
        rot[:, :3, :3] = r
        mats = mats @ rot
    trans = np.tile(np.eye(4), (n, 1, 1))
    trans[:, 3, :3] = positions
    return mats @ trans


def build_scene(stage: Stage) -> SceneDesc:
    """Walk the stage and produce the renderable scene description."""
    base_dir = os.path.dirname(os.path.abspath(stage.path)) if stage.path else ""
    scene = SceneDesc(meshes=[], materials={}, lights=[], cameras={},
                      meters_per_unit=float(stage.meta.get("metersPerUnit", 1.0)))

    def add_mesh_prim(prim: Prim, world: np.ndarray,
                      instance_transforms: np.ndarray | None = None,
                      instance_primvars: dict | None = None) -> None:
        mesh = _build_mesh(prim, world, object_id=len(scene.meshes),
                           stage=stage)
        if mesh is None:
            return
        mesh.instance_transforms = instance_transforms
        mesh.instance_primvars = instance_primvars
        # GeomSubsets: per-face material bindings -> one MeshDesc per subset
        # (reference: mesh.cpp:1036-1137)
        subsets = [c for c in prim.children.values() if c.type_name == "GeomSubset"
                   and c.rels.get("material:binding")]
        if subsets:
            n_faces = int(mesh.mesh.face_ids.max()) + 1 if mesh.mesh.num_triangles else 0
            assigned = np.zeros(n_faces, bool)
            for sub in subsets:
                idx = np.asarray(_attr_val(sub, "indices", []), np.int64)
                keep = np.zeros(n_faces, bool)
                keep[idx[idx < n_faces]] = True
                assigned |= keep
                sub_tri = _filter_triangles(mesh.mesh, keep)
                if sub_tri.num_triangles:
                    scene.meshes.append(MeshDesc(
                        path=sub.path, mesh=sub_tri, transform=world,
                        material=sub.rels["material:binding"][0],
                        double_sided=mesh.double_sided,
                        object_id=mesh.object_id,
                        instance_transforms=instance_transforms))
            rest = _filter_triangles(mesh.mesh, ~assigned)
            if rest.num_triangles:
                mesh.mesh = rest
                scene.meshes.append(mesh)
        else:
            scene.meshes.append(mesh)
        if mesh.material is None:
            fallback = _display_color_material(
                prim, vertex_colors=mesh.mesh.colors is not None)
            if fallback is not None:
                scene.materials[fallback.path] = fallback
                for m in scene.meshes:
                    if m.path == prim.path and m.material is None:
                        m.material = fallback.path

    def handle_instancer(prim: Prim, bases: np.ndarray) -> None:
        """Flatten a PointInstancer. `bases` [B,4,4] maps instancer-local
        space to world — one entry for a top-level instancer, the composed
        parent-instance matrices for a NESTED instancer inside another
        instancer's prototype (the recursive flattening of the reference's
        instancer.cpp:96-136 ComputeFlattenedTransforms chain)."""
        protos = prim.rels.get("prototypes", [])
        proto_idx = np.asarray(_attr_val(prim, "protoIndices", []), np.int64)
        inst_mats = _instance_transforms(prim)

        # per-instance displayColor (the instance-primvar subset of
        # instancer.cpp:138-189: per-instance data forwarded to prototypes)
        dc = prim.attrs.get("primvars:displayColor")
        inst_colors = None
        if dc is not None and isinstance(dc.value, list) and len(dc.value) == len(inst_mats):
            inst_colors = np.asarray([[float(c) for c in v][:3] for v in dc.value])

        # ARBITRARY instance-rate primvars (instancer.cpp:138-189: any
        # instancer primvar forwards into scene-data reads): numeric
        # arrays with one entry per instance ride MeshDesc.instance_
        # primvars; materials reading them through primvar leaves resolve
        # per hit via the instance id
        inst_pvars: dict[str, np.ndarray] = {}
        for aname, attr in prim.attrs.items():
            if not aname.startswith("primvars:") or aname.endswith(":indices"):
                continue
            pv_name = aname[len("primvars:"):]
            v = attr.value
            if not isinstance(v, list) or len(v) != len(inst_mats):
                continue
            try:
                arr = np.asarray([
                    [float(c) for c in e][:3] if isinstance(e, (tuple, list))
                    else [float(e), 0.0, 0.0] for e in v], np.float32)
            except (TypeError, ValueError):
                continue
            inst_pvars[pv_name] = arr

        for p_i, proto_path in enumerate(protos):
            proto = stage.find(proto_path)
            if proto is None:
                continue
            sel_mask = proto_idx == p_i
            sel = inst_mats[sel_mask]
            if len(sel) == 0:
                continue
            # instance-of-this-proto -> world, expanded over all parent bases
            mats = np.stack([m @ b for b in bases for m in sel])
            colors = None
            if inst_colors is not None:
                colors = np.tile(inst_colors[sel_mask], (len(bases), 1))
            sel_pvars = {n: np.tile(a[sel_mask], (len(bases), 1))
                         for n, a in inst_pvars.items()} or None

            def proto_walk(p: Prim, rel: np.ndarray) -> None:
                rel2 = local_transform(p) @ rel
                if p.type_name == "Mesh":
                    xforms = np.stack([rel2 @ mm for mm in mats])
                    if colors is None or p.rels.get("material:binding"):
                        add_mesh_prim(p, np.eye(4), instance_transforms=xforms,
                                      instance_primvars=sel_pvars)
                    else:
                        # unbound prototypes take per-instance displayColor:
                        # group instances by color into fallback materials
                        groups: dict[tuple, list[int]] = {}
                        for i, c in enumerate(colors):
                            groups.setdefault(tuple(np.round(c, 4)), []).append(i)
                        for gi, (ckey, idxs) in enumerate(sorted(groups.items())):
                            before = len(scene.meshes)
                            add_mesh_prim(p, np.eye(4),
                                          instance_transforms=xforms[idxs])
                            mpath = f"{prim.path}{p.path}/__instColor{gi}"
                            node = ShaderNode(
                                path=mpath + "/s", shader_id="UsdPreviewSurface",
                                inputs={"diffuseColor": ckey},
                                input_connections={})
                            scene.materials[mpath] = MaterialDesc(
                                path=mpath, surface_node=node.path,
                                nodes={node.path: node})
                            for m in scene.meshes[before:]:
                                # override the prototype-level displayColor
                                # fallback add_mesh_prim may have assigned
                                if m.material is None or m.material.endswith(
                                        "/__displayColor"):
                                    m.material = mpath
                elif p.type_name == "PointInstancer":
                    handle_instancer(p, np.stack([rel2 @ mm for mm in mats]))
                    return  # its prototypes are reached through recursion
                for c in p.children.values():
                    proto_walk(c, rel2)

            proto_walk(proto, np.eye(4))

    def walk(prim: Prim, parent_world: np.ndarray, parent_visible: bool) -> None:
        world = local_transform(prim) @ parent_world
        visible = parent_visible and str(_attr_val(prim, "visibility", "inherited")) != "invisible"
        purpose = str(_attr_val(prim, "purpose", "default"))
        if purpose in ("proxy", "guide"):
            return
        if prim.type_name == "Mesh" and visible:
            add_mesh_prim(prim, world)
        elif prim.type_name == "PointInstancer":
            if visible:
                handle_instancer(prim, world[None])
            return  # prototypes are referenced explicitly, not walked
        elif prim.type_name == "Camera":
            scene.cameras[prim.path] = _build_camera(prim, world)
        elif prim.type_name == "Material":
            scene.materials[prim.path] = _build_material(prim, base_dir)
            return  # shaders handled inside
        elif prim.type_name in _LIGHT_TYPES and visible:
            scene.lights.append(_build_light(prim, world, base_dir))
        for child in prim.children.values():
            walk(child, world, visible)

    for top in stage.root.children.values():
        walk(top, np.eye(4), True)

    # per-scene render settings (gtl: namespaced tokens, reference main.cpp:191-198)
    for prim in stage.walk():
        if prim.type_name == "RenderSettings":
            for name, attr in prim.attrs.items():
                if name.startswith("gtl:"):
                    scene.render_settings[name[4:]] = attr.value
    return scene


def load_scene(path: str | os.PathLike,
               frame: float | None = None) -> SceneDesc:
    """UsdStage::Open analog: text usda, binary usdc, or usdz packages
    (reference: src/gatling/main.cpp:132). Attributes authored as
    timeSamples resolve at `frame` (explicit arg > gtl:frame scene
    setting > layer startTimeCode > 0 — the renderPass.cpp:131-168
    frame plumbing analog)."""
    from gatling_tpu_torch.scene.usda import resolve_frame, stage_frame_default

    stage = load_usd(path)
    resolve_frame(stage, frame if frame is not None
                  else stage_frame_default(stage))
    return build_scene(stage)
