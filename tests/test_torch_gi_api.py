"""The port's C-style gi surface (gatling_tpu_torch/gi.py) against the JAX
package's (gatling_tpu/gi.py:911-1194) on the CPU: the analytic lights'
create/destroy/setter calls give the JAX light tables, giDestroyMesh keeps
the survivors' OBJECT_ID values (the handle store's slots) and matches the
JAX frame, material edits render what a fresh scene renders, meshes
sharing a source share one compressed payload, and GATLING_VALIDATE=1
changes no value while catching a non-finite AOV."""

import gc

import numpy as np
import pytest
import torch

import gatling_tpu.gi as jgi
from gatling_tpu.interface import AovId as JaxAovId
from gatling_tpu.render.lights import build_light_arrays as jax_light_arrays
from gatling_tpu.scene.stage import load_scene as jax_load_scene
from gatling_tpu_torch import gi
from gatling_tpu_torch.interface import AovId
from gatling_tpu_torch.render.lights import build_light_arrays
from gatling_tpu_torch.scene.meshproc import CompressedMesh
from gatling_tpu_torch.scene.stage import load_scene

CORNELL = "tests/data/cornell.usda"
RES = 16


def _light_calls(mod, kind: str, scene):
    """The same create and setter calls on the gi module `mod`."""
    if kind == "sphere":
        light = mod.giCreateSphereLight(scene)
        mod.giSetSphereLightPosition(light, (0.1, 0.2, 0.3))
        mod.giSetSphereLightRadius(light, 0.2, 0.3, 0.4)
        mod.giSetSphereLightBaseEmission(light, (1.0, 2.0, 3.0))
        mod.giSetSphereLightDiffuseSpecular(light, 0.5, 0.25)
    elif kind == "distant":
        light = mod.giCreateDistantLight(scene)
        mod.giSetDistantLightDirection(light, (0.3, -1.0, 0.2))
        mod.giSetDistantLightAngle(light, 0.1)
        mod.giSetDistantLightBaseEmission(light, (4.0, 3.0, 2.0))
        mod.giSetDistantLightDiffuseSpecular(light, 1.0, 0.5)
    elif kind == "rect":
        light = mod.giCreateRectLight(scene)
        mod.giSetRectLightOrigin(light, (0.0, 0.0, 0.9))
        mod.giSetRectLightTangents(light, (1.0, 0.0, 0.0), (0.0, 0.6, 0.8))
        mod.giSetRectLightDimensions(light, 0.8, 0.6)
        mod.giSetRectLightBaseEmission(light, np.float32([1.0, 0.9, 0.8]) * 4.0)
        mod.giSetRectLightDiffuseSpecular(light, 0.75, 1.0)
    else:
        light = mod.giCreateDiskLight(scene)
        mod.giSetDiskLightOrigin(light, (0.2, -0.1, 0.5))
        mod.giSetDiskLightTangents(light, (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
        mod.giSetDiskLightRadius(light, 0.3, 0.2)
        mod.giSetDiskLightBaseEmission(light, (2.0, 2.0, 2.0))
        mod.giSetDiskLightDiffuseSpecular(light, 0.5, 0.5)
    return light


@pytest.mark.parametrize("kind", ["sphere", "distant", "rect", "disk"])
def test_light_calls_match_jax(kind):
    """Two lights of a kind made by the same calls, the first destroyed:
    the light tables equal the JAX package's, column for column."""
    ours, theirs = gi.create_scene("cpu"), jgi.create_scene()
    doomed = [_light_calls(gi, kind, ours), _light_calls(jgi, kind, theirs)]
    _light_calls(gi, kind, ours)
    _light_calls(jgi, kind, theirs)
    getattr(gi, f"giDestroy{kind.capitalize()}Light")(ours, doomed[0])
    getattr(jgi, f"giDestroy{kind.capitalize()}Light")(theirs, doomed[1])
    assert len(ours.lights) == len(theirs.lights) == 1
    assert ours.dirty & gi.DirtyFlags.LIGHTS
    got, want = build_light_arrays(ours.lights), jax_light_arrays(theirs.lights)
    for name, value in want._asdict().items():
        np.testing.assert_array_equal(np.asarray(getattr(got, name)), np.asarray(value), name)


def _id_frame(mod, aov_id, scene, desc, device=None):
    buf = mod.GiRenderBuffer(RES, RES, 1, is_int=True)
    mod.render(mod.GiRenderParams(scene=scene, camera=desc.first_camera(),
                                  aov_bindings=[mod.GiAovBinding(aov_id, buf, clear_value=-1)],
                                  render_settings={"spp": 1, "maxBounces": 1}))
    return buf.data[..., 0].copy()


def _cornell_scene(device="cpu"):
    desc = load_scene(CORNELL)
    scene = gi.create_scene(device)
    meshes = [gi.giCreateMesh(scene, m) for m in desc.meshes]
    for mat in desc.materials.values():
        scene.add_material(mat)
    return scene, desc, meshes


def test_destroy_mesh_keeps_object_ids():
    """giDestroyMesh: the survivors keep their OBJECT_ID values (their
    handle slots, not list positions), the destroyed mesh's id is gone,
    and the frame equals the JAX package's after the same calls."""
    scene, desc, meshes = _cornell_scene()
    before = _id_frame(gi, AovId.OBJECT_ID, scene, desc)
    doomed = meshes[2]  # the back wall: the survivors behind it show through
    gi.giDestroyMesh(scene, doomed)
    with pytest.raises(KeyError):
        gi.giDestroyMesh(scene, doomed)
    after = _id_frame(gi, AovId.OBJECT_ID, scene, desc)
    assert doomed.object_id == 2 and not (after == 2).any()
    assert [m.object_id for m in scene.meshes] == [0, 1, 3, 4, 5, 6, 7]
    keep = (before != 2) & (after >= 0)
    assert keep.mean() > 0.5
    np.testing.assert_array_equal(after[keep], before[keep])

    jdesc = jax_load_scene(CORNELL)
    jscene = jgi.create_scene()
    jmeshes = [jgi.giCreateMesh(jscene, m) for m in jdesc.meshes]
    for mat in jdesc.materials.values():
        jscene.add_material(mat)
    jgi.giDestroyMesh(jscene, jmeshes[2])
    want = _id_frame(jgi, JaxAovId.OBJECT_ID, jscene, jdesc)
    assert [m.object_id for m in jscene.meshes] == [m.object_id for m in scene.meshes]
    assert (after == want).mean() >= 0.99


def _color_frame(scene, desc, spp=2):
    buf = gi.GiRenderBuffer(RES, RES, 4)
    gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                                aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                                render_settings={"spp": spp, "maxBounces": 3}))
    return buf.data.copy()


def test_set_mesh_material_renders_fresh_scene():
    """giSetMeshMaterial after a frame renders what a scene built with that
    binding renders, bit for bit."""
    scene, desc, meshes = _cornell_scene()
    _color_frame(scene, desc)
    red = next(m.material for m in desc.meshes if m.path.endswith("LeftWall"))
    tall = next(m for m in meshes if m.path.endswith("TallBlock"))
    assert tall.material != red
    gi.giSetMeshMaterial(scene, tall, red)
    assert scene.dirty & gi.DirtyFlags.MATERIALS
    got = _color_frame(scene, desc)

    fresh_desc = load_scene(CORNELL)
    for m in fresh_desc.meshes:
        if m.path.endswith("TallBlock"):
            m.material = red
    fresh = gi.create_scene("cpu")
    for m in fresh_desc.meshes:
        fresh.add_mesh(m)
    for mat in fresh_desc.materials.values():
        fresh.add_material(mat)
    np.testing.assert_array_equal(got, _color_frame(fresh, fresh_desc))


def test_destroy_material_renders_fresh_scene():
    """giDestroyMaterial: its meshes render with the default material, as
    in a scene that never had it."""
    scene, desc, _meshes = _cornell_scene()
    _color_frame(scene, desc)
    path = next(m.material for m in desc.meshes if m.path.endswith("RightWall"))
    gi.giDestroyMaterial(scene, desc.materials[path])
    got = _color_frame(scene, desc)

    fresh_desc = load_scene(CORNELL)
    fresh = gi.create_scene("cpu")
    for m in fresh_desc.meshes:
        fresh.add_mesh(m)
    for p, mat in fresh_desc.materials.items():
        if p != path:
            fresh.add_material(mat)
    np.testing.assert_array_equal(got, _color_frame(fresh, fresh_desc))


def test_mdl_material_call(tmp_path):
    """giCreateMaterialFromMdlFile registers the module's material, as the
    JAX call does."""
    from gatling_tpu_torch.scene.examples import cornell_fog

    usda = cornell_fog(str(tmp_path))
    mdl = str(tmp_path / "fog.mdl")
    scene = gi.create_scene("cpu")
    mat = gi.giCreateMaterialFromMdlFile(scene, "/fog", mdl)
    jmat = jgi.giCreateMaterialFromMdlFile(jgi.create_scene(), "/fog", mdl)
    assert usda and scene.materials[mat.path] is mat
    assert mat.path == jmat.path and mat.mdl_source == jmat.mdl_source
    assert {k: n.inputs for k, n in mat.nodes.items()}.keys() == \
        {k: n.inputs for k, n in jmat.nodes.items()}.keys()


def test_shared_sources_share_one_payload(monkeypatch):
    """Registration compresses each source once: descs sharing a mesh share
    one CompressedMesh (the instanced builder dedups on it), the payload
    goes when its source dies, the frame equals the uncompressed scene's,
    and GATLING_COMPRESS_MESHES=0 keeps the meshes raw."""
    from gatling_tpu_torch.scene.examples import sphere_field

    desc = sphere_field(n_side=3, sphere_res=6)
    held = [m.mesh for m in desc.meshes]  # the payloads are cached while a source lives
    sources = {id(m) for m in held}
    assert len(sources) < len(desc.meshes)
    scene = gi.create_scene("cpu")
    for m in desc.meshes:
        scene.add_mesh(m)
    for m in desc.materials.values():
        scene.add_material(m)
    assert all(isinstance(m.mesh, CompressedMesh) for m in scene.meshes)
    assert len({id(m.mesh) for m in scene.meshes}) == len(sources)
    assert len(scene._compress_cache) == len(sources)
    got = _color_frame(scene, desc, spp=1)

    monkeypatch.setenv("GATLING_COMPRESS_MESHES", "0")
    raw_desc = sphere_field(n_side=3, sphere_res=6)
    raw = gi.create_scene("cpu")
    for m in raw_desc.meshes:
        raw.add_mesh(m)
    for m in raw_desc.materials.values():
        raw.add_material(m)
    assert not any(isinstance(m.mesh, CompressedMesh) for m in raw.meshes)
    np.testing.assert_array_equal(got, _color_frame(raw, raw_desc, spp=1))

    monkeypatch.delenv("GATLING_COMPRESS_MESHES")
    from gatling_tpu_torch.scene.meshproc import build_triangulated_mesh
    from gatling_tpu_torch.scene.stage import MeshDesc

    src = build_triangulated_mesh(np.eye(3, dtype=np.float32), np.array([3]), np.arange(3))
    lone = gi.create_scene("cpu")
    lone.add_mesh(MeshDesc(path="/t", mesh=src, transform=np.eye(4), material=None,
                           double_sided=False, object_id=-1))
    assert len(lone._compress_cache) == 1
    del src
    gc.collect()
    assert not lone._compress_cache  # a recycled id() can never serve this payload


def test_validation_layer(monkeypatch):
    """GATLING_VALIDATE=1 renders the same bits, and a non-finite AOV
    raises naming it before the host copy."""
    scene, desc, _ = _cornell_scene()
    plain = _color_frame(scene, desc)
    monkeypatch.setenv("GATLING_VALIDATE", "1")
    scene2, desc2, _ = _cornell_scene()
    np.testing.assert_array_equal(_color_frame(scene2, desc2), plain)

    real_blend = gi.blend_aovs

    def nan_blend(*args):
        out = real_blend(*args)
        out["color"] = out["color"] * float("nan")
        return out

    monkeypatch.setattr(gi, "blend_aovs", nan_blend)
    scene3, desc3, _ = _cornell_scene()
    with pytest.raises(FloatingPointError, match="AOV 'color'"):
        _color_frame(scene3, desc3)


def test_after_launch_names_the_launch():
    """ops/validate.py: inside validating(), a launch's non-finite output
    raises naming the launch; outside it nothing is checked."""
    from gatling_tpu_torch.ops import validate

    bad = torch.tensor([[1.0, float("inf")]])
    validate.after_launch("K1", lambda: (bad,))
    with validate.validating():
        validate.after_launch("K1", lambda: (torch.ones(2),))
        with pytest.raises(FloatingPointError, match="launch K3"):
            validate.after_launch("K3", lambda: (bad,))
    assert not validate.enabled
    state = torch.zeros((16, 4))
    state[12] = float("nan")  # the RNG's bits may read as a NaN
    with validate.validating():
        validate.after_launch("K1", lambda: validate.state_rows(state))


def test_cuda_is_the_default_device():
    """giCreateScene keeps the port's rule: CUDA unless asked for the CPU,
    and never a silent CPU render."""
    if torch.cuda.is_available():
        assert gi.giCreateScene().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gi.giCreateScene()
    assert gi.giCreateScene("cpu").device.type == "cpu"
    buf = gi.giCreateRenderBuffer(4, 2, 1, is_int=True)
    assert buf.data.shape == (2, 4, 1) and buf.data.dtype == np.int32
