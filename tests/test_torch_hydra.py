"""The port's render delegate (gatling_tpu_torch/hydra) on the cases of
tests/test_hydra.py, on the CPU: capabilities, the render pass, interactive
accumulation, the debug-only lock, printLicenses, the material dump; the
AOV token map and each dumped JSON equal the JAX package's, and a delegate
frame equals the CLI's frame of the same scene bit for bit."""

import json

import numpy as np
import pytest
import torch

from gatling_tpu.hydra.delegate import AOV_TOKEN_MAP as JAX_TOKEN_MAP
from gatling_tpu_torch import cli
from gatling_tpu_torch.hydra import HdAovBinding, get_renderer_plugin
from gatling_tpu_torch.hydra.delegate import AOV_TOKEN_MAP
from gatling_tpu_torch.scene.stage import load_scene

CORNELL = "tests/data/cornell.usda"


def _cornell_delegate(**settings):
    delegate = get_renderer_plugin().create_render_delegate("cpu")
    desc = load_scene(CORNELL)
    for m in desc.meshes:
        delegate.sync_mesh(m)
    for mat in desc.materials.values():
        delegate.sync_material(mat)
    for light in desc.lights:
        delegate.sync_light(light)
    for k, v in settings.items():
        delegate.set_render_setting(k, v)
    return delegate, desc


def test_plugin_and_delegate_capabilities():
    plugin = get_renderer_plugin()
    assert plugin is get_renderer_plugin()
    assert plugin.is_supported() == torch.cuda.is_available()
    delegate = plugin.create_render_delegate("cpu")
    assert delegate.scene.device.type == "cpu"
    assert "Mesh" in delegate.supported_rprim_types()
    assert "DomeLight" in delegate.supported_sprim_types()
    assert "RenderBuffer" in delegate.supported_bprim_types()
    names = [d.name for d in delegate.render_setting_descriptors()]
    assert "spp" in names and "maxBounces" in names and "parallelDevices" in names
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            plugin.create_render_delegate()  # CUDA by default, never a silent CPU scene


def test_token_map_matches_jax():
    assert {k: v.name for k, v in AOV_TOKEN_MAP.items()} == \
        {k: v.name for k, v in JAX_TOKEN_MAP.items()}


def test_delegate_render_pass_cornell():
    delegate, desc = _cornell_delegate(spp=2, maxBounces=3)
    buf = delegate.create_render_buffer(24, 24, "Float32Vec4")
    rp = delegate.create_render_pass()
    rp.execute(desc.first_camera(), [HdAovBinding("color", buf)])
    img = buf.map()
    assert img.shape == (24, 24, 4)
    assert np.isfinite(img).all()
    assert img[..., :3].max() > 0.1
    assert buf.converged
    with pytest.raises(ValueError, match="unsupported AOV token"):
        rp.execute(desc.first_camera(), [HdAovBinding("beauty", buf)])


def test_delegate_frame_equals_cli_frame():
    """The delegate's frame (COLOR and the first-hit NORMAL) and the CLI's
    of the same file and settings: bit for bit."""
    settings = {"spp": 4, "maxBounces": 3, "nextEventEstimation": True}
    _scene, _desc, merged = cli.load_gi_scene(CORNELL, "cpu", dict(settings))
    delegate, desc = _cornell_delegate()
    for k, v in merged.items():
        delegate.set_render_setting(k, v)
    color = delegate.create_render_buffer(20, 20)
    normal = delegate.create_render_buffer(20, 20, "Float32Vec3")
    delegate.create_render_pass().execute(desc.first_camera(), [HdAovBinding("color", color)])
    want, _ = cli.render_scene_file(CORNELL, 20, 20, settings, device="cpu")
    np.testing.assert_array_equal(color.map(), want)

    from gatling_tpu_torch.interface import AovId

    delegate2, desc2 = _cornell_delegate()
    for k, v in merged.items():
        delegate2.set_render_setting(k, v)
    delegate2.create_render_pass().execute(desc2.first_camera(),
                                           [HdAovBinding("normal", normal)])
    want_n, _ = cli.render_scene_file(CORNELL, 20, 20, settings, AovId.NORMAL, device="cpu")
    np.testing.assert_array_equal(normal.map(), want_n)


def gi_bench_light(scene):
    """The benchmark's rect light through the gi calls (the USD prim of
    examples.cornell_rect: origin (0, 0, 0.9), 0.8 x 0.6, colour (1, 0.9,
    0.8) at intensity 4)."""
    from gatling_tpu_torch import gi

    light = gi.giCreateRectLight(scene)
    gi.giSetRectLightOrigin(light, (0.0, 0.0, 0.9))
    gi.giSetRectLightTangents(light, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    gi.giSetRectLightDimensions(light, 0.8, 0.6)
    gi.giSetRectLightBaseEmission(light, np.float32([1.0, 0.9, 0.8]) * 4.0)
    return light


def test_gi_rect_light_frame_equals_cli_frame(tmp_path):
    """The Cornell box with the benchmark's rect light made by
    giCreateRectLight and its setters, rendered through the delegate with
    NEE: bit-equal to the CLI's frame of the file with the RectLight prim."""
    from gatling_tpu_torch.scene.examples import cornell_rect

    usda = cornell_rect(str(tmp_path))
    settings = {"spp": 4, "maxBounces": 3, "nextEventEstimation": True}
    _scene, _desc, merged = cli.load_gi_scene(usda, "cpu", dict(settings))
    delegate, desc = _cornell_delegate()
    gi_bench_light(delegate.scene)
    for k, v in merged.items():
        delegate.set_render_setting(k, v)
    buf = delegate.create_render_buffer(20, 20)
    delegate.create_render_pass().execute(desc.first_camera(), [HdAovBinding("color", buf)])
    want, scene = cli.render_scene_file(usda, 20, 20, settings, device="cpu")
    assert len(scene.lights) == 1 and not scene.lights[0].params.get("explicit_frame")
    np.testing.assert_array_equal(buf.map(), want)
    plain, _ = cli.render_scene_file(CORNELL, 20, 20, settings, device="cpu")
    assert want[..., :3].mean() > plain[..., :3].mean()  # the light is in


def test_interactive_accumulates():
    delegate, desc = _cornell_delegate(spp=1, maxBounces=2)
    buf = delegate.create_render_buffer(16, 16)
    rp = delegate.create_render_pass()
    rp.execute(desc.first_camera(), [HdAovBinding("color", buf)], interactive=True)
    assert not buf.converged
    assert delegate.scene.sample_offset == 1
    rp.execute(desc.first_camera(), [HdAovBinding("color", buf)], interactive=True)
    assert delegate.scene.sample_offset == 2  # progressive accumulation
    delegate.set_render_setting("maxBounces", 3)  # a change restarts it
    rp.execute(desc.first_camera(), [HdAovBinding("color", buf)], interactive=True)
    assert delegate.scene.sample_offset == 1


def test_renderer_commands_and_debug_lock(monkeypatch, capsys):
    """renderDelegate.cpp:145-195: printLicenses names what the port uses
    (not JAX, not Pillow); debug-only settings are locked outside debug
    sessions."""
    monkeypatch.delenv("GATLING_DEBUG", raising=False)
    dl = get_renderer_plugin().create_render_delegate("cpu")
    names = [d["commandName"] for d in dl.get_renderer_command_descriptors()]
    assert "printLicenses" in names
    assert dl.invoke_renderer_command("printLicenses")
    out = capsys.readouterr().out
    for name in ("PyTorch", "NumPy", "CUDA", "zlib", "MaterialX", "MDL", "USD"):
        assert name in out, name
    assert "JAX" not in out and "Pillow" not in out
    assert not dl.invoke_renderer_command("definitelyNotACommand")
    before = dl.render_settings["progressiveAccumulation"]
    dl.set_render_setting("progressiveAccumulation", not before)
    assert dl.render_settings["progressiveAccumulation"] == before
    monkeypatch.setenv("GATLING_DEBUG", "1")
    dl.set_render_setting("progressiveAccumulation", not before)
    assert dl.render_settings["progressiveAccumulation"] != before


def test_sync_light_last_dome_wins():
    from gatling_tpu_torch.scene.stage import LightDesc

    dl = get_renderer_plugin().create_render_delegate("cpu")
    for tex in ("a.exr", "b.exr"):
        dl.sync_light(LightDesc(path="/dome", light_type="dome", transform=np.eye(4),
                                params={"texture": tex}))
    assert dl.scene.dome_light.file_path == "b.exr" and not dl.scene.lights


DUMP_SCENES = [CORNELL, "tests/graphical/MaterialX.ColorSpaces/scene.usda",
               "tests/graphical/Materials.MtlxViewDirection/scene.usda",
               "tests/graphical/Materials.GlassCoated/scene.usda"]


@pytest.mark.parametrize("path", DUMP_SCENES)
def test_material_dump_matches_jax(monkeypatch, tmp_path, path):
    """GATLING_DUMP_MATERIALS (the GTL_DUMP_MTLX/MDL analog): one JSON per
    lowered material, each equal to the JAX package's document."""
    from gatling_tpu.render.material import lower_material as jax_lower
    from gatling_tpu.scene.stage import load_scene as jax_load
    from gatling_tpu_torch.render.material import lower_material

    monkeypatch.setenv("GATLING_DUMP_MATERIALS", str(tmp_path / "port"))
    desc = load_scene(path)
    for m in desc.materials.values():
        lower_material(m)
    monkeypatch.setenv("GATLING_DUMP_MATERIALS", str(tmp_path / "jax"))
    for m in jax_load(path).materials.values():
        jax_lower(m)
    ours = sorted(p.name for p in (tmp_path / "port").glob("*.json"))
    theirs = sorted(p.name for p in (tmp_path / "jax").glob("*.json"))
    assert ours == theirs and len(ours) == len(desc.materials)
    for name in ours:
        doc = json.loads((tmp_path / "port" / name).read_text())
        assert {"params", "traits", "textures", "dynamic"} <= set(doc)
        assert doc == json.loads((tmp_path / "jax" / name).read_text()), name
