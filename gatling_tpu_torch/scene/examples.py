"""Procedural example scenes, generated from a seed.

The port's copy of the JAX package's scene/examples.py `sphere_field`: a
stand-in of Junk-Shop-class triangle count (the reference's showcase
scenes, README.md:4-65, are not redistributable) built from many
placements of one mesh, so it exercises both the flattened clustered
tables (290k world triangles) and the instanced ones (one 1152-triangle
sphere under 256 placements).
"""

from __future__ import annotations

import numpy as np

from gatling_tpu_torch.scene.meshproc import build_triangulated_mesh
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
