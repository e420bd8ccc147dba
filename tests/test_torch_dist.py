"""The port's DCC bridges (gatling_tpu_torch/dist/) on the cases of
tests/test_dist.py: the Blender add-on registers its engine, properties and
panels against a fake bpy and maps its settings onto flags the port's CLI
takes; the Houdini husk bridge maps husk arguments onto `python -m
gatling_tpu_torch.cli` and renders a PNG (on the CPU here, through
--gatling:device cpu). The bridges load by file path: dist/ is no package,
and the add-on imports bpy at its top."""

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST = os.path.join(REPO, "gatling_tpu_torch", "dist")


def _make_fake_bpy():
    bpy = types.ModuleType("bpy")

    class _PropertyGroup:
        pass

    class _RenderEngine:
        pass

    class _Panel:
        pass

    class _Scene:
        pass

    bpy.types = types.SimpleNamespace(PropertyGroup=_PropertyGroup, RenderEngine=_RenderEngine,
                                      Panel=_Panel, Scene=_Scene)

    def _prop(kind):
        def make(**kwargs):
            return (kind, kwargs)
        return make

    bpy.props = types.SimpleNamespace(
        IntProperty=_prop("int"), FloatProperty=_prop("float"), BoolProperty=_prop("bool"),
        StringProperty=_prop("str"), PointerProperty=_prop("pointer"))
    registered = []

    def register_class(cls):
        registered.append(cls)
        if hasattr(cls, "register"):
            cls.register()

    def unregister_class(cls):
        registered.remove(cls)
        if hasattr(cls, "unregister"):
            cls.unregister()

    def register_classes_factory(classes):
        def reg():
            for c in classes:
                register_class(c)

        def unreg():
            for c in reversed(classes):
                unregister_class(c)
        return reg, unreg

    bpy.utils = types.SimpleNamespace(register_class=register_class,
                                      unregister_class=unregister_class,
                                      register_classes_factory=register_classes_factory)
    bpy._registered = registered
    bpy.data = types.SimpleNamespace(images=types.SimpleNamespace())
    bpy.ops = types.SimpleNamespace(wm=types.SimpleNamespace())
    return bpy


def _make_fake_bl_ui():
    bl_ui = types.ModuleType("bl_ui")

    class RENDER_PT_color_management:
        COMPAT_ENGINES = {"BLENDER_RENDER", "CYCLES"}

    class RENDER_PT_format:
        COMPAT_ENGINES = {"BLENDER_RENDER"}

    bl_ui.properties_render = types.SimpleNamespace(
        RENDER_PT_color_management=RENDER_PT_color_management)
    bl_ui.properties_output = types.SimpleNamespace(RENDER_PT_format=RENDER_PT_format)
    return bl_ui


def _drop_addon_modules():
    for mod in list(sys.modules):
        if mod == "gatling_torch_blender" or mod.startswith("gatling_torch_blender."):
            del sys.modules[mod]


@pytest.fixture()
def blender_addon(monkeypatch):
    fake_bpy, fake_bl_ui = _make_fake_bpy(), _make_fake_bl_ui()
    monkeypatch.setitem(sys.modules, "bpy", fake_bpy)
    monkeypatch.setitem(sys.modules, "bl_ui", fake_bl_ui)
    _drop_addon_modules()
    path = os.path.join(DIST, "blender", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        "gatling_torch_blender", path, submodule_search_locations=[os.path.dirname(path)])
    addon = importlib.util.module_from_spec(spec)
    sys.modules["gatling_torch_blender"] = addon
    spec.loader.exec_module(addon)
    yield addon, fake_bpy, fake_bl_ui
    _drop_addon_modules()


def test_blender_addon_register_unregister(blender_addon):
    addon, bpy, bl_ui = blender_addon
    addon.register()
    names = [c.__name__ for c in bpy._registered]
    assert "GatlingTorchRenderEngine" in names
    assert "GatlingTorchRenderProperties" in names
    assert sum(n.startswith("GATLING_TORCH_PT_") for n in names) == 4
    assert hasattr(bpy.types.Scene, "gatling_torch")
    assert "GATLING_TORCH" in \
        bl_ui.properties_render.RENDER_PT_color_management.COMPAT_ENGINES
    addon.unregister()
    assert not bpy._registered
    assert not hasattr(bpy.types.Scene, "gatling_torch")
    assert "GATLING_TORCH" not in \
        bl_ui.properties_render.RENDER_PT_color_management.COMPAT_ENGINES


def test_blender_settings_to_cli_flags(blender_addon):
    addon, _bpy, _bl_ui = blender_addon
    s = types.SimpleNamespace(
        spp=32, max_bounces=5, rr_bounce_offset=3, rr_inv_min_term_prob=0.9,
        max_sample_value=8.0, medium_stack_size=0, max_volume_walk_length=7,
        next_event_estimation=True, jittered_sampling=True, filter_importance_sampling=False,
        depth_of_field=False, clipping_planes=False, progressive_accumulation=True,
        device="cpu")
    flags = addon.engine._settings_to_flags(s)
    assert ["--spp", "32"] == flags[0:2]
    assert "--next-event-estimation" in flags
    assert "--no-filter-importance-sampling" in flags
    from gatling_tpu_torch.cli import build_arg_parser

    args = build_arg_parser().parse_args(["scene.usda", "out.png", *flags])
    assert args.spp == 32 and args.nextEventEstimation is True and args.device == "cpu"
    # the same settings as the JAX package's add-on, plus the device
    from gatling_tpu.utils.config import SETTING_DESCRIPTORS

    parsed = vars(args)
    assert parsed["filterImportanceSampling"] is False and parsed["maxBounces"] == 5
    assert {d.name for d in SETTING_DESCRIPTORS} <= set(parsed)


def _load_husk_module():
    spec = importlib.util.spec_from_file_location(
        "husk_gatling_torch", os.path.join(DIST, "houdini", "husk_gatling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_husk_bridge_argument_mapping(monkeypatch):
    mod = _load_husk_module()
    captured = {}

    def fake_call(cmd, env=None):
        captured["cmd"], captured["env"] = cmd, env
        return 0

    monkeypatch.setattr(subprocess, "call", fake_call)
    rc = mod.main(["scene.usd", "-o", "out.png", "--res", "640", "480", "--pixel-samples", "16",
                   "--renderer", "GatlingCUDA", "--gatling:next-event-estimation",
                   "--gatling:max-bounces", "4", "--gatling:device", "cpu"])
    assert rc == 0
    cmd = captured["cmd"]
    assert cmd[1:3] == ["-m", "gatling_tpu_torch.cli"]
    assert "scene.usd" in cmd and "out.png" in cmd
    i = cmd.index("--image-width")
    assert cmd[i:i + 4] == ["--image-width", "640", "--image-height", "480"]
    assert cmd[cmd.index("--spp"):cmd.index("--spp") + 2] == ["--spp", "16"]
    assert "--next-event-estimation" in cmd
    assert cmd[cmd.index("--max-bounces"):cmd.index("--max-bounces") + 2] == ["--max-bounces",
                                                                            "4"]
    assert cmd[cmd.index("--device"):cmd.index("--device") + 2] == ["--device", "cpu"]
    assert captured["env"]["PYTHONPATH"].split(os.pathsep)[0] == REPO
    from gatling_tpu_torch.cli import build_arg_parser

    build_arg_parser().parse_args(cmd[3:])  # every flag is the CLI's


def test_houdini_registration_names_the_bridge():
    with open(os.path.join(DIST, "houdini", "UsdRenderers.json")) as f:
        reg = json.load(f)["renderers"]
    (entry,) = reg.values()
    assert entry["command"].endswith("gatling_tpu_torch/dist/houdini/husk_gatling.py")
    assert os.path.isfile(os.path.join(DIST, "houdini", entry["viewportds"]))


QUAD_USDA = """#usda 1.0
(
    defaultPrim = "Root"
)
def Xform "Root"
{
    def Xform "CamX"
    {
        matrix4d xformOp:transform = ( (1,0,0,0), (0,1,0,0), (0,0,1,0), (0,0,2,1) )
        uniform token[] xformOpOrder = ["xformOp:transform"]
        def Camera "Cam"
        {
            float focalLength = 35
            float verticalAperture = 20.955
            float horizontalAperture = 20.955
        }
    }
    def Mesh "Quad" (
        prepend apiSchemas = ["MaterialBindingAPI"]
    )
    {
        int[] faceVertexCounts = [4]
        int[] faceVertexIndices = [0, 1, 3, 2]
        rel material:binding = </Root/Mat>
        point3f[] points = [(-1,-1,0), (1,-1,0), (-1,1,0), (1,1,0)]
    }
    def Material "Mat"
    {
        token outputs:surface.connect = </Root/Mat/S.outputs:surface>
        def Shader "S"
        {
            uniform token info:id = "UsdPreviewSurface"
            color3f inputs:emissiveColor = (0.9, 0.5, 0.2)
            color3f inputs:diffuseColor = (0, 0, 0)
        }
    }
}
"""


def test_husk_bridge_renders(tmp_path):
    """End to end: the bridge runs the port's CLI, from any directory, and
    writes the image."""
    scene = tmp_path / "scene.usda"
    scene.write_text(QUAD_USDA)
    out = tmp_path / "husk_out.png"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, os.path.join(DIST, "houdini", "husk_gatling.py"), str(scene), "-o",
         str(out), "--res", "16", "16", "--pixel-samples", "2", "--gatling:max-bounces", "1",
         "--gatling:device", "cpu"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    from gatling_tpu_torch.imgio import load_image_file

    img = np.asarray(load_image_file(str(out)))
    assert img.shape[:2] == (16, 16)
    assert img.max() > 100  # the emissive quad is visible
