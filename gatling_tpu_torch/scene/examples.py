"""Procedural example scenes, generated from a seed.

The port's copies of the JAX package's scene/examples.py scenes, which
stand in for the reference's showcase scenes (README.md:4-65, not
redistributable):

* `sphere_field`: Junk-Shop-class triangle count built from many
  placements of one mesh, so it exercises both the flattened clustered
  tables (290k world triangles) and the instanced ones (one
  1152-triangle sphere under 256 placements);
* `interior`: an Evermotion-Kitchen-class textured room (about 92k
  triangles at detail 5), every material's base colour a UsdUVTexture
  over procedural 256x256 PNGs written from a seed, with a rect window
  light and two sphere lamps.

The media scenes bind MDL materials, as Omniverse assets do: the bundled
OmniGlass (thick glass whose glass_color becomes an absorption
coefficient) and a written fog module (`FOG_MDL`: a clear interface over
an absorbing and scattering `material_volume`). `glass_tinted` and
`cornell_fog` write the Cornell box of tests/data/cornell.usda with its
tall block so bound, under the benchmark's ceiling rect light, as a
.usda file; `sphere_field_volumes` and `interior_tinted` return the two
large scenes with some of their materials so replaced, `interior_dynamic`
the interior with a view-dependent emission and a two-sided MDL material.

The dome scenes light them by an HDR sky: `write_sky` writes an
equirectangular sky (a vertical gradient and a small, bright sun) as an
EXR, `cornell_dome` the Cornell box with a `DomeLight` prim that points at
it, and `hdr_floor` rewrites the interior's floor texture as an EXR whose
values reach 4 (one HDR slot makes the whole texture pool float).
"""

from __future__ import annotations

import numpy as np

import os
import re
import tempfile
from pathlib import Path

from gatling_tpu_torch import imgio
from gatling_tpu_torch.scene.meshproc import Interpolation, build_triangulated_mesh
from gatling_tpu_torch.scene.stage import (
    CameraDesc,
    LightDesc,
    MaterialDesc,
    MeshDesc,
    SceneDesc,
    ShaderNode,
)


def _uv_sphere(rows: int, cols: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unit UV sphere -> (points, face_counts, face_indices)."""
    theta = np.linspace(0.0, np.pi, rows + 1)
    phi = np.linspace(0.0, 2 * np.pi, cols, endpoint=False)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    pts = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)],
                   axis=-1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    a = i * cols + j
    b = i * cols + (j + 1) % cols
    faces = np.stack([a, b, b + cols, a + cols], axis=-1).reshape(-1, 4).astype(np.int64)
    return pts, np.full(len(faces), 4, np.int64), faces.reshape(-1)


def _preview_material(path: str, **inputs) -> MaterialDesc:
    node = ShaderNode(path=path + "/s", shader_id="UsdPreviewSurface",
                      inputs=inputs, input_connections={})
    return MaterialDesc(path=path, surface_node=node.path, nodes={node.path: node})


def sphere_field(n_side: int = 16, sphere_res: int = 24, seed: int = 0) -> SceneDesc:
    """A field of n_side^2 shaded spheres over a ground plane with an
    emissive sky panel and a sphere light: a Junk-Shop-class triangle count
    (n_side=16, res=24 -> 294,916 triangles) with NEE-able lighting."""
    rng = np.random.default_rng(seed)
    pts, counts, idx = _uv_sphere(sphere_res, sphere_res)
    sphere = build_triangulated_mesh(pts, counts, idx)

    materials: dict[str, MaterialDesc] = {}
    meshes: list[MeshDesc] = []
    n_mats = 8
    for m in range(n_mats):
        path = f"/mat{m}"
        materials[path] = _preview_material(
            path,
            diffuseColor=tuple(rng.uniform(0.2, 0.9, 3).round(3)),
            roughness=float(rng.uniform(0.1, 0.9)),
            metallic=float(m % 3 == 0),
        )

    spacing = 2.5
    half = n_side * spacing / 2
    xforms_by_mat: dict[int, list[np.ndarray]] = {m: [] for m in range(n_mats)}
    for i in range(n_side):
        for j in range(n_side):
            m = (i * n_side + j) % n_mats
            s = rng.uniform(0.5, 1.1)
            xf = np.diag([s, s, s, 1.0])
            xf[3, :3] = [i * spacing - half, j * spacing - half, s]
            xforms_by_mat[m].append(xf)
    for m, xfs in xforms_by_mat.items():
        if xfs:
            meshes.append(MeshDesc(
                path=f"/spheres{m}", mesh=sphere, transform=np.eye(4),
                material=f"/mat{m}", double_sided=False, object_id=m,
                instance_transforms=np.stack(xfs)))

    ground_pts = np.array([[-half - 5, -half - 5, 0], [half + 5, -half - 5, 0],
                           [-half - 5, half + 5, 0], [half + 5, half + 5, 0]], np.float32)
    ground = build_triangulated_mesh(ground_pts, np.array([4]), np.array([0, 1, 3, 2]))
    materials["/ground"] = _preview_material("/ground", diffuseColor=(0.4, 0.4, 0.45),
                                             roughness=0.9)
    meshes.append(MeshDesc(path="/ground", mesh=ground, transform=np.eye(4),
                           material="/ground", double_sided=True, object_id=n_mats))

    sky_pts = np.array([[-half, -half, 14], [half, -half, 14],
                        [-half, half, 14], [half, half, 14]], np.float32)
    sky = build_triangulated_mesh(sky_pts, np.array([4]), np.array([0, 2, 3, 1]))
    materials["/sky"] = _preview_material("/sky", emissiveColor=(2.0, 2.0, 2.2),
                                          diffuseColor=(0, 0, 0))
    meshes.append(MeshDesc(path="/sky", mesh=sky, transform=np.eye(4),
                           material="/sky", double_sided=True, object_id=n_mats + 1))

    light_xf = np.eye(4)
    light_xf[3, :3] = [half * 0.5, -half * 0.5, 10.0]
    lights = [LightDesc(path="/key", light_type="sphere", transform=light_xf,
                        params=dict(intensity=220.0, exposure=0.0,
                                    color=np.array([1.0, 0.95, 0.8], np.float32),
                                    normalize=False, diffuse=1.0, specular=1.0,
                                    enableColorTemperature=False,
                                    colorTemperature=6500.0, radius=1.0,
                                    treatAsPoint=False))]

    cam_pos = np.array([0.0, -half - 14.0, 9.0])
    fwd = np.array([0.0, 1.0, -0.28])
    fwd /= np.linalg.norm(fwd)
    up = np.cross(np.cross(fwd, [0, 0, 1.0]), fwd)
    up /= np.linalg.norm(up)
    camera = CameraDesc(position=cam_pos.astype(np.float32), forward=fwd.astype(np.float32),
                        up=up.astype(np.float32), vfov=0.6)
    return SceneDesc(meshes=meshes, materials=materials, lights=lights,
                     cameras={"/cam": camera})


# ---------------------------------------------------------------------------
# interior: Evermotion-Kitchen-class proxy (the JAX bench's ladder config 5)
# ---------------------------------------------------------------------------

def _procedural_textures(out_dir: str, seed: int = 7) -> dict[str, str]:
    """The interior's texture set (256x256 RGBA PNGs) in out_dir:
    deterministic stand-ins for wood, tiles, plaster, fabric, marble and
    brushed metal, written once and then read from the file."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    def save(name, rgb):
        path = os.path.join(out_dir, name + ".png")
        if not os.path.exists(path):
            rgba = np.concatenate(
                [np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8),
                 np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)
            imgio.write_image_file(path, rgba)
        return path

    n = 256
    yy, xx = np.mgrid[0:n, 0:n] / n

    # wood: banded rings with per-plank phase jitter
    plank = np.floor(yy * 8)
    phase = rng.uniform(0, 6.28, 9)[plank.astype(int)]
    grain = 0.5 + 0.5 * np.sin(xx * 95.0 + phase + 2.2 * np.sin(yy * 31.0))
    wood = np.stack([0.42 + 0.25 * grain, 0.26 + 0.14 * grain,
                     0.13 + 0.07 * grain], axis=-1)
    wood *= (1.0 - 0.25 * (np.abs(yy * 8 - plank - 0.5) > 0.47))[..., None]

    # tiles: grout grid + slight per-tile tint
    tx, ty = np.floor(xx * 6), np.floor(yy * 6)
    tint = rng.uniform(0.82, 1.0, (6, 6))[ty.astype(int), tx.astype(int)]
    grout = ((xx * 6 - tx < 0.04) | (yy * 6 - ty < 0.04))
    tiles = np.where(grout[..., None], 0.35,
                     np.stack([0.75 * tint, 0.78 * tint, 0.80 * tint], axis=-1))

    # plaster: low-frequency noise
    base = rng.standard_normal((8, 8))
    up = np.kron(base, np.ones((32, 32)))[:n, :n]
    plaster = (0.80 + 0.05 * np.tanh(up))[..., None] * np.array([1.0, 0.97, 0.92])

    # fabric: woven check
    weave = 0.5 + 0.25 * np.sin(xx * 240) * np.sin(yy * 240)
    fabric = np.stack([0.30 * weave + 0.25, 0.12 * weave + 0.10,
                       0.10 * weave + 0.08], axis=-1)

    # marble: veins
    v = np.sin(xx * 9 + 4.0 * np.abs(np.sin(yy * 5 + xx * 3)))
    marble = (0.78 + 0.18 * np.abs(v))[..., None] * np.array([1.0, 1.0, 0.98])

    # brushed metal: anisotropic streaks
    streak = rng.standard_normal((n, 1)) * np.ones((1, n))
    metal = (0.55 + 0.08 * np.tanh(streak))[..., None] * np.array([0.9, 0.92, 0.95])

    return {k: save(k, v) for k, v in dict(
        wood=wood, tiles=tiles, plaster=plaster, fabric=fabric,
        marble=marble, metal=metal).items()}


def _textured_material(path: str, tex_file: str, roughness=0.7, metallic=0.0) -> MaterialDesc:
    """UsdPreviewSurface whose diffuseColor is a UsdUVTexture (raw colour
    space, repeat wrap): the network shape hdGatling consumes
    (materialNetworkCompiler.cpp:295-505)."""
    tex = ShaderNode(path=path + "/tex", shader_id="UsdUVTexture",
                     inputs={"file": tex_file, "sourceColorSpace": "raw",
                             "wrapS": "repeat", "wrapT": "repeat"},
                     input_connections={})
    surf = ShaderNode(path=path + "/s", shader_id="UsdPreviewSurface",
                      inputs={"roughness": roughness, "metallic": metallic},
                      input_connections={"diffuseColor": (tex.path, "rgb")})
    return MaterialDesc(path=path, surface_node=surf.path,
                        nodes={surf.path: surf, tex.path: tex})


def _quad(p0, p1, p2, p3, uv_scale=1.0):
    """Two-triangle quad with planar UVs (vertex interpolation)."""
    pts = np.asarray([p0, p1, p2, p3], np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale
    return build_triangulated_mesh(pts, np.array([4]), np.array([0, 1, 2, 3]),
                                   uvs=uvs, uvs_interp=Interpolation.VERTEX)


def _box_mesh(size, uv_scale=1.0, subdiv: int = 1):
    """Axis-aligned box centred at the origin with per-face planar UVs;
    subdiv splits each face into subdiv^2 quads."""
    sx, sy, sz = np.asarray(size, np.float32) / 2
    pts_list, idx_list, uv_list, counts = [], [], [], []
    base = 0
    axes = [  # (fixed axis, sign, u axis, v axis)
        (0, +1, 1, 2), (0, -1, 1, 2), (1, +1, 0, 2),
        (1, -1, 0, 2), (2, +1, 0, 1), (2, -1, 0, 1)]
    half = np.array([sx, sy, sz], np.float32)
    for ax, sgn, ua, va in axes:
        g = np.linspace(-1, 1, subdiv + 1, dtype=np.float32)
        for i in range(subdiv):
            for j in range(subdiv):
                corners = []
                uvq = []
                order = ((i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1))
                if sgn < 0:
                    order = order[::-1]
                for (a, b) in order:
                    p = np.zeros(3, np.float32)
                    p[ax] = sgn * half[ax]
                    p[ua] = g[a] * half[ua]
                    p[va] = g[b] * half[va]
                    corners.append(p)
                    uvq.append([(g[a] * 0.5 + 0.5) * uv_scale,
                                (g[b] * 0.5 + 0.5) * uv_scale])
                pts_list.extend(corners)
                uv_list.extend(uvq)
                idx_list.extend(range(base, base + 4))
                counts.append(4)
                base += 4
    return build_triangulated_mesh(
        np.asarray(pts_list, np.float32), np.asarray(counts, np.int64),
        np.asarray(idx_list, np.int64),
        uvs=np.asarray(uv_list, np.float32), uvs_interp=Interpolation.VERTEX)


def _sphere_uv_mesh(rows: int, cols: int):
    pts, counts, idx = _uv_sphere(rows, cols)
    theta = np.arccos(np.clip(pts[:, 2], -1, 1)) / np.pi
    phi = (np.arctan2(pts[:, 1], pts[:, 0]) / (2 * np.pi)) % 1.0
    uvs = np.stack([phi, 1.0 - theta], axis=-1).astype(np.float32)
    return build_triangulated_mesh(pts, counts, idx, uvs=uvs, uvs_interp=Interpolation.VERTEX)


def interior(detail: int = 5, seed: int = 11, tex_dir: str | None = None) -> SceneDesc:
    """Enclosed textured interior, the Evermotion-Kitchen-class stand-in
    (the JAX package's scene/examples.py interior): room shell, counters,
    table, shelf clutter, every material's base colour a UsdUVTexture, a
    rect window light and two sphere lamps, an interior camera.
    detail=5 is about 92k triangles; detail scales the tessellation. The
    textures go to tex_dir (default: gatling_interior_tex in the temporary
    directory)."""
    rng = np.random.default_rng(seed)
    if tex_dir is None:
        tex_dir = os.path.join(tempfile.gettempdir(), "gatling_interior_tex")
    tex = _procedural_textures(tex_dir)

    W, D, H = 6.0, 8.0, 3.0  # room extents (x width, y depth, z height)
    materials: dict[str, MaterialDesc] = {}
    meshes: list[MeshDesc] = []
    oid = [0]

    def add(path, mesh, mat, xf=None, inst=None, double_sided=False):
        meshes.append(MeshDesc(
            path=path, mesh=mesh, transform=np.eye(4) if xf is None else xf,
            material=mat, double_sided=double_sided, object_id=oid[0],
            instance_transforms=inst))
        oid[0] += 1

    def mat(name, texname, roughness=0.7, metallic=0.0):
        p = f"/m_{name}"
        if p not in materials:
            materials[p] = _textured_material(p, tex[texname], roughness=roughness,
                                              metallic=metallic)
        return p

    def xf_at(x, y, z, s=1.0):
        m = np.diag([s, s, s, 1.0])
        m[3, :3] = [x, y, z]
        return m

    # room shell: floor/ceiling/4 walls, inward-facing, subdivided
    shell = detail * 4
    floor = _box_mesh((W, D, 0.02), uv_scale=4.0, subdiv=shell)
    add("/floor", floor, mat("floor", "tiles", 0.35), xf_at(0, 0, -0.01))
    ceil_m = _box_mesh((W, D, 0.02), uv_scale=3.0, subdiv=shell)
    add("/ceiling", ceil_m, mat("ceiling", "plaster", 0.9), xf_at(0, 0, H + 0.01))
    wall_y = _box_mesh((W, 0.02, H), uv_scale=3.0, subdiv=shell)
    add("/wall_back", wall_y, mat("wall", "plaster", 0.85), xf_at(0, D / 2 + 0.01, H / 2))
    add("/wall_front", wall_y, mat("wall", "plaster", 0.85), xf_at(0, -D / 2 - 0.01, H / 2))
    wall_x = _box_mesh((0.02, D, H), uv_scale=3.0, subdiv=shell)
    add("/wall_left", wall_x, mat("wall", "plaster", 0.85), xf_at(-W / 2 - 0.01, 0, H / 2))
    add("/wall_right", wall_x, mat("wall", "plaster", 0.85), xf_at(W / 2 + 0.01, 0, H / 2))

    # counter run along the left wall + marble worktop
    counter = _box_mesh((0.6, 1.0, 0.9), uv_scale=1.0, subdiv=detail)
    inst = np.stack([xf_at(-W / 2 + 0.35, -D / 2 + 0.6 + i * 1.05, 0.45) for i in range(6)])
    add("/counters", counter, mat("cabinet", "wood", 0.55), inst=inst)
    top = _box_mesh((0.7, 6.4, 0.06), uv_scale=2.0, subdiv=detail)
    add("/worktop", top, mat("worktop", "marble", 0.25), xf_at(-W / 2 + 0.35, -D / 2 + 3.2, 0.93))

    # table + 4 legs
    add("/table_top", _box_mesh((1.4, 2.0, 0.06), 1.5, subdiv=detail),
        mat("table", "wood", 0.5), xf_at(0.8, 0.0, 0.75))
    leg = _box_mesh((0.08, 0.08, 0.72), 0.5, subdiv=max(1, detail // 2))
    inst = np.stack([xf_at(0.8 + dx, dy, 0.36) for dx in (-0.6, 0.6) for dy in (-0.9, 0.9)])
    add("/table_legs", leg, mat("table", "wood", 0.5), inst=inst)

    # shelf clutter: bowls/pots (spheres) on the worktop and table, crates
    # (boxes) in the corner: most of the scene's triangles
    sph = _sphere_uv_mesh(8 * detail, 8 * detail)
    xfs = []
    for i in range(10):
        xfs.append(xf_at(-W / 2 + 0.35, -D / 2 + 0.7 + i * 0.62, 1.05, s=rng.uniform(0.07, 0.12)))
    for i in range(6):
        xfs.append(xf_at(0.8 + rng.uniform(-0.5, 0.5), rng.uniform(-0.8, 0.8), 0.86,
                         s=rng.uniform(0.06, 0.10)))
    add("/bowls", sph, mat("bowl", "fabric", 0.8), inst=np.stack(xfs))
    pot = _sphere_uv_mesh(6 * detail, 6 * detail)
    inst = np.stack([xf_at(W / 2 - 0.5, -D / 2 + 0.5 + i * 0.8, 0.25, s=0.22) for i in range(4)])
    add("/pots", pot, mat("pot", "metal", 0.3, metallic=1.0), inst=inst)
    crate = _box_mesh((0.45, 0.45, 0.45), 1.0, subdiv=detail)
    inst = np.stack([xf_at(W / 2 - 0.4, D / 2 - 0.4 - i * 0.5, 0.225 + (i % 2) * 0.46)
                     for i in range(5)])
    add("/crates", crate, mat("crate", "wood", 0.7), inst=inst)

    # rug under the table
    add("/rug", _box_mesh((2.4, 3.2, 0.01), 2.0, subdiv=detail * 2),
        mat("rug", "fabric", 0.95), xf_at(0.8, 0, 0.005))

    # lights: a rect 'window' in the right wall (local -z rotated to -x,
    # into the room) + two warm sphere lamps
    win = np.eye(4)
    win[:3, :3] = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float64).T
    win[3, :3] = [W / 2 - 0.05, 1.5, 1.7]
    lights = [
        LightDesc(path="/window", light_type="rect", transform=win,
                  params=dict(intensity=28.0, exposure=0.0,
                              color=np.array([1.0, 0.98, 0.92], np.float32),
                              normalize=False, diffuse=1.0, specular=1.0,
                              enableColorTemperature=False, colorTemperature=6500.0,
                              width=1.6, height=1.2)),
    ]
    for k, (lx, ly) in enumerate([(-1.2, -2.2), (0.5, 2.6)]):
        lamp = np.eye(4)
        lamp[3, :3] = [lx, ly, H - 0.35]
        lights.append(LightDesc(
            path=f"/lamp{k}", light_type="sphere", transform=lamp,
            params=dict(intensity=9.0, exposure=0.0,
                        color=np.array([1.0, 0.85, 0.6], np.float32),
                        normalize=False, diffuse=1.0, specular=1.0,
                        enableColorTemperature=False, colorTemperature=6500.0,
                        radius=0.08, treatAsPoint=False)))

    cam_pos = np.array([-W / 2 + 0.9, -D / 2 + 1.0, 1.6])
    target = np.array([0.9, 1.8, 0.9])
    fwd = target - cam_pos
    fwd /= np.linalg.norm(fwd)
    up = np.cross(np.cross(fwd, [0, 0, 1.0]), fwd)
    up /= np.linalg.norm(up)
    camera = CameraDesc(position=cam_pos.astype(np.float32), forward=fwd.astype(np.float32),
                        up=up.astype(np.float32), vfov=0.9)

    return SceneDesc(meshes=meshes, materials=materials, lights=lights, cameras={"/cam": camera})


# ---------------------------------------------------------------------------
# media: MDL-bound tinted glass and fog
# ---------------------------------------------------------------------------

# OmniGlass's tint of the media scenes (sigma_a = -ln(colour) per metre)
GLASS_TINT = (0.55, 0.8, 0.95)
# a clear, thick interface over a homogeneous fog: sigma_a 0.05 and sigma_s
# 1.5 per metre, isotropic
FOG_MDL = """mdl 1.6;
import ::df::*;

export material Fog(*)
 = material(
    surface: material_surface(
        scattering: df::specular_bsdf(mode: df::scatter_transmit)
    ),
    ior: color(1.0),
    volume: material_volume(
        absorption_coefficient: color(0.05),
        scattering_coefficient: color(1.5)
    )
);
"""
_CORNELL_USDA = Path(__file__).resolve().parents[2] / "tests" / "data" / "cornell.usda"
# the benchmark's ceiling rect light (the JAX bench.py:133-147)
_BENCH_RECT_LIGHT = """
    def RectLight "BenchLight"
    {
        matrix4d xformOp:transform = ( (1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0.9, 1) )
        uniform token[] xformOpOrder = ["xformOp:transform"]
        float inputs:intensity = 4
        color3f inputs:color = (1, 0.9, 0.8)
        float inputs:width = 0.8
        float inputs:height = 0.6
    }
"""


def write_fog_mdl(out_dir: str) -> str:
    """FOG_MDL as fog.mdl in out_dir; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "fog.mdl")
    with open(path, "w") as f:
        f.write(FOG_MDL)
    return path


def _mdl_material_prim(name: str, asset: str, sub: str, inputs: str = "") -> str:
    return f"""
        def Material "{name}"
        {{
            token outputs:surface.connect = </Cornell/Materials/{name}/Shader.outputs:surface>
            def Shader "Shader"
            {{
                uniform token info:implementationSource = "sourceAsset"
                uniform asset info:mdl:sourceAsset = @{asset}@
                uniform token info:mdl:sourceAsset:subIdentifier = "{sub}"{inputs}
                token outputs:surface
            }}
        }}
"""


def _cornell_with_tall_block(out_dir: str, name: str, material: str, prim: str) -> str:
    """tests/data/cornell.usda with its tall block bound to `material`
    (the prim text `prim` added to its materials) and the benchmark's rect
    light, written as out_dir/name.usda."""
    text = _CORNELL_USDA.read_text()
    tall = text.index('def Mesh "TallBlock"')
    head, tail = text[:tall], text[tall:]
    tail = tail.replace("</Cornell/Materials/White>", f"</Cornell/Materials/{material}>", 1)
    tail = re.sub(r'(def Scope "Materials"\s*\{)', lambda m: m.group(1) + prim, tail, count=1)
    text = head + _BENCH_RECT_LIGHT + tail
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.usda")
    with open(path, "w") as f:
        f.write(text)
    return path


def cornell_rect(out_dir: str) -> str:
    """tests/data/cornell.usda with the benchmark's rect light as a
    RectLight prim: out_dir/cornell_rect.usda (the scene of the front
    ends' frames: the CLI renders it, the gi calls build the same light)."""
    text = _CORNELL_USDA.read_text()
    tall = text.index('def Mesh "TallBlock"')
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "cornell_rect.usda")
    with open(path, "w") as f:
        f.write(text[:tall] + _BENCH_RECT_LIGHT + text[tall:])
    return path


def glass_tinted(out_dir: str) -> str:
    """The Cornell box with its tall block in OmniGlass tinted GLASS_TINT
    (info:mdl:sourceAsset = @OmniGlass.mdl@, resolved in the bundled
    modules), under the benchmark's rect light: out_dir/glass_tinted.usda."""
    tint = ", ".join(f"{c:g}" for c in GLASS_TINT)
    prim = _mdl_material_prim("TintedGlass", "OmniGlass.mdl", "OmniGlass",
                              f"\n                color3f inputs:glass_color = ({tint})")
    return _cornell_with_tall_block(out_dir, "glass_tinted", "TintedGlass", prim)


def cornell_fog(out_dir: str) -> str:
    """The Cornell box with its tall block a fog volume (FOG_MDL, written
    beside it as fog.mdl), under the benchmark's rect light:
    out_dir/cornell_fog.usda. Render it with mediumStackSize >= 1 for the
    scattering (at 0 the medium only absorbs)."""
    write_fog_mdl(out_dir)
    return _cornell_with_tall_block(out_dir, "cornell_fog", "Fog",
                                    _mdl_material_prim("Fog", "fog.mdl", "Fog"))


def _mdl_desc(path: str, module: str, sub: str, overrides: dict | None = None) -> MaterialDesc:
    from gatling_tpu_torch.render.mdl import load_mdl_material

    desc = load_mdl_material(module, sub, overrides or {}, name=path.strip("/"))
    return MaterialDesc(path=path, surface_node=desc.surface_node, nodes=desc.nodes,
                        base_dir=desc.base_dir, mdl_source=module)


def tinted_glass_material(path: str) -> MaterialDesc:
    """The bundled OmniGlass tinted GLASS_TINT."""
    return _mdl_desc(path, "OmniGlass.mdl", "OmniGlass", {"glass_color": GLASS_TINT})


def fog_material(path: str, out_dir: str) -> MaterialDesc:
    """FOG_MDL, written into out_dir."""
    return _mdl_desc(path, write_fog_mdl(out_dir), "Fog")


def sphere_field_volumes(out_dir: str, **kwargs) -> SceneDesc:
    """sphere_field(**kwargs) with its first sphere material tinted OmniGlass
    and its second the fog (fog.mdl written into out_dir)."""
    desc = sphere_field(**kwargs)
    desc.materials["/mat0"] = tinted_glass_material("/mat0")
    desc.materials["/mat1"] = fog_material("/mat1", out_dir)
    return desc


def interior_tinted(detail: int = 5, tex_dir: str | None = None) -> SceneDesc:
    """interior(detail) with its instanced bowls (closed UV spheres) in
    tinted OmniGlass: a textured scene with absorbing media."""
    desc = interior(detail=detail, tex_dir=tex_dir)
    for m in desc.meshes:
        if m.path == "/bowls":
            m.material = "/m_bowl_glass"
    desc.materials["/m_bowl_glass"] = tinted_glass_material("/m_bowl_glass")
    return desc


def interior_cutout(detail: int = 5, tex_dir: str | None = None) -> SceneDesc:
    """interior(detail) with its instanced bowls' opacity the alpha of a
    64x64 checker of alpha 0 and 255 in 4x4-texel squares (mask.png in
    tex_dir) at opacityThreshold 0.5, a leaf- or fence-like cutout that the
    fused route's split bounce re-traces. The bowls also emit (1, 1, 1):
    the interior's lights reach the camera only through NEE, so without
    NEE the frame is lit by the bowls alone, and what it shows depends on
    the mask."""
    import copy

    desc = interior(detail=detail, tex_dir=tex_dir)
    if tex_dir is None:
        tex_dir = os.path.join(tempfile.gettempdir(), "gatling_interior_tex")
    c = (np.arange(64)[:, None] // 4 + np.arange(64)[None, :] // 4) % 2
    img = np.full((64, 64, 4), 255, np.uint8)
    img[..., 3] = np.where(c, 255, 0)
    path = os.path.join(tex_dir, "mask.png")
    imgio.write_image_file(path, img)
    bowl = copy.deepcopy(desc.materials["/m_bowl"])
    bowl.nodes[bowl.surface_node].inputs.update(opacityThreshold=0.5,
                                                emissiveColor=(1.0, 1.0, 1.0))
    node = ShaderNode(path="/m_bowl/mask", shader_id="UsdUVTexture",
                      inputs={"file": path, "sourceColorSpace": "raw"}, input_connections={})
    bowl.nodes[node.path] = node
    bowl.nodes[bowl.surface_node].input_connections["opacity"] = (node.path, "a")
    desc.materials["/m_bowl"] = bowl
    return desc


# a two-sided MDL material: a red front and a blue `backface:` surface
TWO_SIDED_MDL = """mdl 1.6;
import ::df::*;
export material TwoSided()
 = material(
    surface: material_surface(
        scattering: df::diffuse_reflection_bsdf(tint: color(0.8, 0.2, 0.2))
    ),
    backface: material_surface(
        scattering: df::diffuse_reflection_bsdf(tint: color(0.1, 0.1, 0.9))
    )
);
"""


def two_sided_material(path: str, out_dir: str) -> MaterialDesc:
    """TWO_SIDED_MDL, written into out_dir as two_sided.mdl."""
    os.makedirs(out_dir, exist_ok=True)
    module = os.path.join(out_dir, "two_sided.mdl")
    with open(module, "w") as f:
        f.write(TWO_SIDED_MDL)
    return _mdl_desc(path, module, "TwoSided")


def view_direction_material(path: str) -> MaterialDesc:
    """The graph of tests/graphical/Materials.MtlxViewDirection: a black
    UsdPreviewSurface whose emission is mix(orange, blue, pow(|viewdirection
    . normal|, 3)), a view- and normal-dependent input."""
    def node(name, sid, inputs=None, **links):
        return ShaderNode(path=f"{path}/{name}", shader_id=sid, inputs=inputs or {},
                          input_connections={k: (f"{path}/{v}", "out") for k, v in links.items()})

    nodes = [
        node("s", "UsdPreviewSurface", {"diffuseColor": (0.0, 0.0, 0.0)}, emissiveColor="mix"),
        node("mix", "ND_mix_color3", {"fg": (0.9, 0.3, 0.05), "bg": (0.02, 0.1, 0.9)},
             mix="pow"),
        node("pow", "ND_power_float", {"in2": 3.0}, in1="abs"),
        node("abs", "ND_absval_float", {}, **{"in": "dot"}),
        node("dot", "ND_dotproduct_vector3", {}, in1="vd", in2="nrm"),
        node("vd", "ND_viewdirection_vector3"),
        node("nrm", "ND_normal_vector3", {"space": "world"}),
    ]
    return MaterialDesc(path=path, surface_node=f"{path}/s", nodes={n.path: n for n in nodes})


def interior_dynamic(detail: int = 5, tex_dir: str | None = None) -> SceneDesc:
    """interior(detail) with its pots' material replaced by the view-
    dependent emission of view_direction_material and its crates' by the
    two-sided MDL material (TWO_SIDED_MDL, written beside the textures in
    tex_dir, by default interior's): a scene only the wavefront renders
    (per-hit material inputs, a backface row)."""
    if tex_dir is None:
        tex_dir = os.path.join(tempfile.gettempdir(), "gatling_interior_tex")
    desc = interior(detail=detail, tex_dir=tex_dir)
    for m in desc.meshes:
        if m.material == "/m_pot":
            m.material = "/m_pot_view"
        elif m.material == "/m_crate":
            m.material = "/m_crate_two_sided"
    desc.materials["/m_pot_view"] = view_direction_material("/m_pot_view")
    desc.materials["/m_crate_two_sided"] = two_sided_material("/m_crate_two_sided", tex_dir)
    for p in ("/m_pot", "/m_crate"):
        del desc.materials[p]
    return desc


def uber_material(path: str, **params) -> MaterialDesc:
    """A material whose surface node is the MDL front end's pre-mapped
    uber-BSDF parameter set (`gatling_uber`, render/mdl.py), here with
    `params` given directly."""
    node = ShaderNode(path=path + "/s", shader_id="gatling_uber", inputs=params,
                      input_connections={})
    return MaterialDesc(path=path, surface_node=node.path, nodes={node.path: node})


def absorbing_slab(sigma_a=(0.5, 1.0, 2.0), sigma_s=(0.0, 0.0, 0.0), bias: float = 0.0
                   ) -> SceneDesc:
    """The JAX package's Beer-Lambert slab (tests/test_volumes.py
    _slab_scene): a clear (ior 1) double-sided slab between z = 1 and z = -1
    holding a medium of `sigma_a` / `sigma_s` (per metre) and HG `bias`,
    before an emissive wall (2, 2, 2) at z = -3, seen along -z from
    (0.37, 0.11, 5) through a narrow field of view: through the slab the
    centre pixel reads 2 exp(-2 sigma_a) without scattering."""

    def quad(z: float, flip: bool = False):
        size = 5.0
        pts = np.array([[-size, -size, z], [size, -size, z], [-size, size, z],
                        [size, size, z]], np.float32)
        order = np.array([2, 3, 1, 0]) if flip else np.array([0, 1, 3, 2])
        return build_triangulated_mesh(pts, np.array([4]), order)

    meshes = [
        MeshDesc(path="/slab_front", mesh=quad(1.0), transform=np.eye(4), material="/glass",
                 double_sided=True, object_id=0),
        # the back face winds the other way: a ray leaving the slab meets a back face
        MeshDesc(path="/slab_back", mesh=quad(-1.0, flip=True), transform=np.eye(4),
                 material="/glass", double_sided=True, object_id=1),
        MeshDesc(path="/wall", mesh=quad(-3.0), transform=np.eye(4), material="/wall",
                 double_sided=True, object_id=2),
    ]
    materials = {
        "/glass": uber_material("/glass", transmission=1.0, roughness=0.1, ior=1.0,
                                volume_absorption=tuple(sigma_a),
                                volume_scattering=tuple(sigma_s), volume_bias=bias),
        "/wall": uber_material("/wall", emissive=(2.0, 2.0, 2.0), base_color=(0.0, 0.0, 0.0)),
    }
    camera = CameraDesc(position=np.array([0.37, 0.11, 5.0], np.float32),
                        forward=np.array([0.0, 0.0, -1.0], np.float32),
                        up=np.array([0.0, 1.0, 0.0], np.float32), vfov=0.2,
                        clip_start=0.01, clip_end=100.0)
    return SceneDesc(meshes=meshes, materials=materials, lights=[], cameras={"/cam": camera})


# ---------------------------------------------------------------------------
# dome lights and HDR textures
# ---------------------------------------------------------------------------

SUN_RADIANCE = 5e3  # the sun of write_sky
SUN_TEXELS = 16     # its side in texels


def write_sky(path: str, width: int, height: int, half: bool = True) -> str:
    """An equirectangular sky of width x height texels at `path` (EXR: ZIP,
    half or float32): a vertical gradient from a blue zenith (texel row 0)
    through a white horizon to a brown ground, and a SUN_TEXELS-square sun
    of SUN_RADIANCE at u = 0.25, 65 % of the way down, where the
    reference's lookup puts directions with y = -0.45 (rays that leave the
    Cornell box through its opening see it). Returns the path."""
    v = (np.arange(height, dtype=np.float32) + 0.5) / height
    zenith, horizon, ground = (np.array(c, np.float32) for c in
                               ((0.35, 0.55, 1.2), (1.0, 0.95, 0.9), (0.3, 0.24, 0.18)))
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)[:, None]
    down = np.clip(2.0 * v - 1.0, 0.0, 1.0)[:, None]
    col = horizon + (zenith - horizon) * up + (ground - horizon) * down  # [height, 3]
    sky = np.broadcast_to(col[:, None, :], (height, width, 3)).copy()
    r0, c0 = int(0.65 * height) - SUN_TEXELS // 2, width // 4 - SUN_TEXELS // 2
    sky[r0:r0 + SUN_TEXELS, c0:c0 + SUN_TEXELS] = SUN_RADIANCE
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(imgio.encode_exr(sky, half=half))
    return path


def cornell_dome(out_dir: str, sky: str) -> str:
    """tests/data/cornell.usda (open towards -y) with a DomeLight prim whose
    inputs:texture:file is `sky` (written beside it or absolute), as
    out_dir/cornell_dome.usda; returns its path."""
    text = _CORNELL_USDA.read_text().rstrip()
    assert text.endswith("}")
    text = text[:-1] + (f'    def DomeLight "Sky"\n    {{\n'
                        f'        asset inputs:texture:file = @{sky}@\n    }}\n}}\n')
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "cornell_dome.usda")
    with open(path, "w") as f:
        f.write(text)
    return path


def hdr_floor(desc: SceneDesc, path: str, size: int = 2048, seed: int = 3) -> str:
    """The interior's floor texture rewritten, in place, as a size x size
    half EXR at `path`: 8 x 8 tiles of random tints whose values reach 4,
    between dark grout lines. Returns the path."""
    rng = np.random.default_rng(seed)
    n = 8
    tint = rng.uniform(0.25, 4.0, (n, n, 1)) * rng.uniform(0.7, 1.0, (n, n, 3))
    tint *= 4.0 / tint.max()
    cell = size // n
    img = np.repeat(np.repeat(tint, cell, axis=0), cell, axis=1).astype(np.float32)
    grout = (np.arange(size) % cell) < max(cell // 32, 1)
    img[grout] = 0.05
    img[:, grout] = 0.05
    rgba = np.concatenate([img, np.ones((size, size, 1), np.float32)], axis=-1)
    with open(path, "wb") as f:
        f.write(imgio.encode_exr(rgba))
    for node in desc.materials["/m_floor"].nodes.values():
        if node.shader_id == "UsdUVTexture":
            node.inputs["file"] = path
    return path


# ---------------------------------------------------------------------------
# USD content: skinned figures under MaterialX graphs, as a binary package
# ---------------------------------------------------------------------------

def _fmt(v) -> str:
    """A value as the f32 it is stored as, written out exactly: the text
    layer and a crate file of it hold the same numbers."""
    return repr(float(np.float32(v))).removesuffix(".0")


def _tuples(a: np.ndarray) -> str:
    """[N, k] -> "(a, b, c), ..." in USD text."""
    return ", ".join("(" + ", ".join(_fmt(x) for x in row) + ")" for row in np.asarray(a))


def _flat(a) -> str:
    return ", ".join(_fmt(x) if isinstance(x, (float, np.floating)) else str(int(x))
                     for x in np.asarray(a).ravel())


def _matrix(m: np.ndarray) -> str:
    return "(" + ", ".join("(" + ", ".join(_fmt(x) for x in row) + ")" for row in m) + ")"


def _quat_x(theta: float) -> tuple[float, float, float, float]:
    """(w, x, y, z) of a rotation by theta about the bend axis (x)."""
    return (float(np.cos(theta / 2)), float(np.sin(theta / 2)), 0.0, 0.0)


def _tube(rings: int, segments: int, height: float, radius: float):
    """An open tube along +z: (points [(rings+1)(segments+1), 3], vertex
    normals, st, face vertex indices of rings x segments quads, wound
    outwards). The seam column is doubled so that st runs 0 to 1 around
    it."""
    i, j = np.meshgrid(np.arange(rings + 1), np.arange(segments + 1), indexing="ij")
    a = 2.0 * np.pi * j / segments
    z = height * i / rings
    pts = np.stack([radius * np.cos(a), radius * np.sin(a), z], -1).reshape(-1, 3)
    nrm = np.stack([np.cos(a), np.sin(a), np.zeros_like(a)], -1).reshape(-1, 3)
    st = np.stack([j / segments, i / rings], -1).reshape(-1, 2)
    v = (np.arange(rings)[:, None] * (segments + 1) + np.arange(segments)[None, :]).ravel()
    faces = np.stack([v, v + 1, v + segments + 2, v + segments + 1], axis=1)
    return pts, nrm, st, faces


def _figure_weights(rings: int, segments: int, joints: int, k: int = 4):
    """Each vertex's k joint influences (indices, weights) along the
    chain: the joints about its height, a tent kernel, normalized."""
    s = np.repeat(np.arange(rings + 1) * (joints - 1) / rings, segments + 1)
    base = np.floor(s).astype(np.int64)[:, None] + np.arange(-1, k - 1)[None, :]
    idx = np.clip(base, 0, joints - 1)
    w = np.maximum(0.0, 1.5 - np.abs(s[:, None] - base))
    w = w / w.sum(axis=1, keepdims=True)
    return idx, w.astype(np.float32)


def _png(path: str, rgb: np.ndarray) -> str:
    rgba = np.concatenate([np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8),
                           np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    imgio.write_image_file(path, rgba)
    return os.path.basename(path)


def write_content(out_dir: str, figures: int = 16, rings: int = 48, segments: int = 64,
                  joints: int = 24, tex_res: int = 1024, seed: int = 5) -> str:
    """USD content of production shape as out_dir/content.usda, its PNG
    textures beside it; returns the path. `figures` skinned tubes (rings x
    segments quads each; 16 x 6,144 triangles at the defaults), each bound
    (SkelBindingAPI) to its own chain Skeleton of `joints` joints with 4
    influences a vertex (primvars:skel:jointIndices / jointWeights,
    elementSize 4) and driven by its own SkelAnimation (rotations quatf,
    translations float3, scales half3, sampled at frames 1-24); figure 0
    also carries a blend shape. Z is up: a ground plane under an 8-bit
    tex_res x tex_res PNG (UsdUVTexture), a rect light above it (its
    unrotated frame emits down) and a camera.
    Materials are USD-authored MaterialX nodes (info:id ND_*): an
    ND_checkerboard_color3 base colour with ND_noise2d_float roughness, an
    ND_multiply_color3 of two image textures (a baked composite), and an
    ND_frame_float x colour emission on figure 5. Scales are multiples of
    1/256 (exact in half)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    n = tex_res
    yy, xx = np.mgrid[0:n, 0:n] / n
    tile = rng.uniform(0.55, 0.9, (8, 8))[(yy * 8).astype(int), (xx * 8).astype(int)]
    grout = ((xx * 8) % 1 < 0.03) | ((yy * 8) % 1 < 0.03)
    ground = np.where(grout[..., None], 0.25, tile[..., None] * np.array([0.9, 0.85, 0.75]))
    ground_png = _png(os.path.join(out_dir, "ground.png"), ground)
    m = 256
    yy, xx = np.mgrid[0:m, 0:m] / m
    stripes = 0.5 + 0.5 * np.sin(xx * 40.0)[..., None] * np.array([0.8, 0.4, 0.1])
    grad = np.stack([0.3 + 0.7 * yy, 0.9 - 0.5 * xx, 0.5 + 0.3 * np.cos(yy * 9.0)], -1)
    a_png = _png(os.path.join(out_dir, "stripes.png"), stripes)
    b_png = _png(os.path.join(out_dir, "gradient.png"), grad)

    height, radius = 3.0, 0.3
    pts, nrm, st, faces = _tube(rings, segments, height, radius)
    idx, w = _figure_weights(rings, segments, joints)
    seg = height / (joints - 1)
    names, path = [], ""
    for k in range(joints):
        path = f"j{k}" if k == 0 else f"{path}/j{k}"
        names.append(path)
    joint_list = ", ".join(f'"{p}"' for p in names)
    bind = ", ".join(_matrix(np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0],
                                       [0, 0, k * seg, 1]], np.float64)) for k in range(joints))
    rest = ", ".join(_matrix(np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0],
                                       [0, 0, seg if k else 0.0, 1]], np.float64))
                     for k in range(joints))
    mesh_attrs = [
        f"int[] faceVertexCounts = [{', '.join(['4'] * len(faces))}]",
        f"int[] faceVertexIndices = [{_flat(faces)}]",
        f"point3f[] points = [{_tuples(pts)}]",
        f"normal3f[] normals = [{_tuples(nrm)}] (", '    interpolation = "vertex"', ")",
        f"texCoord2f[] primvars:st = [{_tuples(st)}] (", '    interpolation = "vertex"', ")",
        f"int[] primvars:skel:jointIndices = [{_flat(idx)}] (", "    elementSize = 4",
        '    interpolation = "vertex"', ")",
        f"float[] primvars:skel:jointWeights = [{_flat(w)}] (", "    elementSize = 4",
        '    interpolation = "vertex"', ")",
        "uniform bool doubleSided = 1"]

    def block(indent: int, head: str, body: list[str]) -> list[str]:
        pad = " " * indent
        return [pad + head, pad + "{", *(pad + "    " + b for b in body), pad + "}"]

    def samples(name: str, rows: list[str]) -> list[str]:
        return [f"{name}.timeSamples = {{", *(f"    {r}," for r in rows), "}"]

    side = int(np.ceil(np.sqrt(figures)))
    out = ['#usda 1.0', '(', '    defaultPrim = "World"', '    startTimeCode = 1',
           '    endTimeCode = 24', '    upAxis = "Z"', ')', '', 'def Xform "World"', '{']
    frames = np.arange(1, 25)
    for f in range(figures):
        x, y = (f % side - (side - 1) / 2) * 2.0, (f // side - (side - 1) / 2) * 2.0
        phase = rng.uniform(0.0, 2.0 * np.pi)
        material = "Glow" if f == 5 else ("Checker" if f % 2 == 0 else "Composite")
        tr = np.zeros((joints, 3))
        tr[1:, 2] = seg
        rot, trans, scale, weight = [], [], [], []
        for t in frames:
            ang = 0.06 * np.sin(2.0 * np.pi * t / 24.0 + phase + 0.35 * np.arange(joints))
            sx = 1.0 + np.round(0.08 * np.sin(2.0 * np.pi * t / 24.0 + np.arange(joints))
                                * 256.0) / 256.0
            rot.append(f"{t}: [{_tuples([_quat_x(a) for a in ang])}]")
            trans.append(f"{t}: [{_tuples(tr)}]")
            scale.append(f"{t}: [{_tuples(np.stack([sx, sx, np.ones(joints)], -1))}]")
            weight.append(f"{t}: [{_fmt(0.5 + 0.5 * np.sin(2.0 * np.pi * t / 24.0))}]")
        anim = [f"uniform token[] joints = [{joint_list}]",
                *samples("float3[] translations", trans), *samples("quatf[] rotations", rot),
                *samples("half3[] scales", scale)]
        mesh = [f"rel skel:skeleton = </World/Fig{f}/Skel>",
                f"rel material:binding = </World/Looks/{material}>", *mesh_attrs]
        if f == 0:  # a blend shape: a bulge about the middle third
            ring = np.repeat(np.arange(rings + 1), segments + 1)
            sel = np.nonzero(np.abs(ring - rings / 2) < rings / 6)[0]
            bump = np.cos((ring[sel] - rings / 2) / (rings / 6) * np.pi / 2)[:, None]
            anim += ['uniform token[] blendShapes = ["bulge"]',
                     *samples("float[] blendShapeWeights", weight)]
            mesh += ['uniform token[] skel:blendShapes = ["bulge"]',
                     f"rel skel:blendShapeTargets = [</World/Fig{f}/Tube/Bulge>]",
                     *block(0, 'def BlendShape "Bulge"', [
                         f"uniform vector3f[] offsets = [{_tuples(0.15 * bump * nrm[sel])}]",
                         f"uniform int[] pointIndices = [{_flat(sel)}]"])]
        skel = [f"uniform token[] joints = [{joint_list}]",
                f"uniform matrix4d[] bindTransforms = [{bind}]",
                f"uniform matrix4d[] restTransforms = [{rest}]",
                f"rel skel:animationSource = </World/Fig{f}/Skel/Anim>",
                *block(0, 'def SkelAnimation "Anim"', anim)]
        out += block(4, f'def SkelRoot "Fig{f}"', [
            f"double3 xformOp:translate = ({_fmt(x)}, {_fmt(y)}, 0)",
            'uniform token[] xformOpOrder = ["xformOp:translate"]',
            *block(0, 'def Skeleton "Skel" (\n            prepend apiSchemas = ["SkelBindingAPI"]'
                   '\n        )', skel),
            *block(0, 'def Mesh "Tube" (\n            prepend apiSchemas = ["SkelBindingAPI"]'
                   '\n        )', mesh)])
    out = ["\n".join(out) + "\n"]
    out.append(f'''    def Mesh "Ground"
    {{
        int[] faceVertexCounts = [4]
        int[] faceVertexIndices = [0, 1, 2, 3]
        point3f[] points = [(-7, -7, 0), (7, -7, 0), (7, 7, 0), (-7, 7, 0)]
        texCoord2f[] primvars:st = [(0, 0), (0, 4), (4, 4), (4, 0)] (
            interpolation = "vertex"
        )
        rel material:binding = </World/Looks/Ground>
    }}
    def RectLight "Key"
    {{
        double3 xformOp:translate = (0, 0, 7)
        uniform token[] xformOpOrder = ["xformOp:translate"]
        float inputs:width = 5
        float inputs:height = 5
        float inputs:intensity = 12
    }}
    def Xform "CamX"
    {{
        matrix4d xformOp:transform = ( (1, 0, 0, 0), (0, 0.1874, 0.9823, 0),
            (0, -0.9823, 0.1874, 0), (0, -11, 3.6, 1) )
        uniform token[] xformOpOrder = ["xformOp:transform"]
        def Camera "Cam"
        {{
            float focalLength = 30
            float verticalAperture = 20.955
            float horizontalAperture = 20.955
            float2 clippingRange = (0.5, 100)
        }}
    }}
    def Scope "Looks"
    {{
        def Material "Checker"
        {{
            token outputs:surface.connect = </World/Looks/Checker/s.outputs:surface>
            def Shader "s"
            {{
                uniform token info:id = "UsdPreviewSurface"
                color3f inputs:diffuseColor.connect = </World/Looks/Checker/checker.outputs:out>
                float inputs:roughness.connect = </World/Looks/Checker/noise.outputs:out>
                token outputs:surface
            }}
            def Shader "checker"
            {{
                uniform token info:id = "ND_checkerboard_color3"
                color3f inputs:in1 = (0.8, 0.25, 0.1)
                color3f inputs:in2 = (0.9, 0.85, 0.7)
                float2 inputs:uvtiling = (8, 6)
                color3f outputs:out
            }}
            def Shader "noise"
            {{
                uniform token info:id = "ND_noise2d_float"
                float inputs:amplitude = 0.25
                float inputs:pivot = 0.45
                float outputs:out
            }}
        }}
        def Material "Composite"
        {{
            token outputs:surface.connect = </World/Looks/Composite/s.outputs:surface>
            def Shader "s"
            {{
                uniform token info:id = "UsdPreviewSurface"
                color3f inputs:diffuseColor.connect = </World/Looks/Composite/mul.outputs:out>
                float inputs:roughness = 0.4
                token outputs:surface
            }}
            def Shader "mul"
            {{
                uniform token info:id = "ND_multiply_color3"
                color3f inputs:in1.connect = </World/Looks/Composite/a.outputs:out>
                color3f inputs:in2.connect = </World/Looks/Composite/b.outputs:out>
                color3f outputs:out
            }}
            def Shader "a"
            {{
                uniform token info:id = "ND_image_color3"
                asset inputs:file = @{a_png}@
                color3f outputs:out
            }}
            def Shader "b"
            {{
                uniform token info:id = "ND_image_color3"
                asset inputs:file = @{b_png}@
                color3f outputs:out
            }}
        }}
        def Material "Glow"
        {{
            token outputs:surface.connect = </World/Looks/Glow/s.outputs:surface>
            def Shader "s"
            {{
                uniform token info:id = "UsdPreviewSurface"
                color3f inputs:diffuseColor = (0.2, 0.2, 0.25)
                color3f inputs:emissiveColor.connect = </World/Looks/Glow/glow.outputs:out>
                token outputs:surface
            }}
            def Shader "glow"
            {{
                uniform token info:id = "ND_multiply_color3"
                float inputs:in1.connect = </World/Looks/Glow/frame.outputs:out>
                color3f inputs:in2 = (0.05, 0.04, 0.02)
                color3f outputs:out
            }}
            def Shader "frame"
            {{
                uniform token info:id = "ND_frame_float"
                float outputs:out
            }}
        }}
        def Material "Ground"
        {{
            token outputs:surface.connect = </World/Looks/Ground/s.outputs:surface>
            def Shader "s"
            {{
                uniform token info:id = "UsdPreviewSurface"
                color3f inputs:diffuseColor.connect = </World/Looks/Ground/tex.outputs:rgb>
                float inputs:roughness = 0.7
                token outputs:surface
            }}
            def Shader "tex"
            {{
                uniform token info:id = "UsdUVTexture"
                asset inputs:file = @{ground_png}@
                token inputs:wrapS = "repeat"
                token inputs:wrapT = "repeat"
                float3 outputs:rgb
            }}
        }}
    }}
}}
''')
    path = os.path.join(out_dir, "content.usda")
    with open(path, "w") as fh:
        fh.write("".join(out))
    return path


def pack_usdz(usda_path: str, usdz_path: str) -> dict:
    """The text layer as a binary package: parsed with load_usda, saved as
    a crate file with save_usdc beside it, zipped (stored, as USDZ wants)
    with the textures it names into usdz_path. Returns the host seconds of
    each step and the crate file's path and size."""
    import time
    import zipfile

    from gatling_tpu_torch.scene.crate import save_usdc
    from gatling_tpu_torch.scene.usda import load_usda

    t0 = time.perf_counter()
    stage = load_usda(usda_path)
    t1 = time.perf_counter()
    usdc = os.path.splitext(usda_path)[0] + ".usdc"
    save_usdc(stage, usdc)
    t2 = time.perf_counter()
    text = Path(usda_path).read_text()
    assets = sorted(set(re.findall(r"@([^@]+\.png)@", text)))
    with zipfile.ZipFile(usdz_path, "w", zipfile.ZIP_STORED) as zf:
        zf.write(usdc, os.path.basename(usdc))
        for a in assets:
            zf.write(os.path.join(os.path.dirname(usda_path), a), a)
    return dict(parse_s=t1 - t0, save_s=t2 - t1, zip_s=time.perf_counter() - t2, usdc=usdc,
                usdc_bytes=os.path.getsize(usdc), stage=stage)


def retexture(usda_path: str, formats: dict[str, str], tag: str) -> str:
    """A copy of a .usda whose PNG textures are written anew in other
    formats by the port's writers: formats maps a texture's file name
    (ground.png) to its new extension (.jpg, .tga, .tif). The copy is
    usda_path's name with `tag` appended; returns its path."""
    text = Path(usda_path).read_text()
    d = os.path.dirname(usda_path)
    for name, ext in formats.items():
        new = os.path.splitext(name)[0] + ext
        imgio.write_image_file(os.path.join(d, new),
                               imgio.load_image_file(os.path.join(d, name)))
        text = text.replace(f"@{name}@", f"@{new}@")
    out = os.path.splitext(usda_path)[0] + f"_{tag}.usda"
    Path(out).write_text(text)
    return out
