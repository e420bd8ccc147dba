"""The port's --watch (gatling_tpu_torch/cli.py): the material watch set
equals the JAX package's (gatling_tpu/cli.py watched_material_sources) on
the fixture of tests/test_utils.py and on a textured scene, the shader
watch set covers the port's shader code and kernel sources and turns off
with GATLING_WATCH_SHADERS=0, and a --watch process renders again when a
texture's mtime changes."""

import os
import subprocess
import sys
import threading
import time

from gatling_tpu.cli import watched_material_sources as jax_watched
from gatling_tpu_torch.cli import watched_material_sources, watched_shader_sources

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixture(tmp_path, stage):
    scene_file = tmp_path / "s.usda"
    scene_file.write_text("#usda 1.0\n")
    (tmp_path / "t.png").write_bytes(b"x")
    mdl = tmp_path / "m.mdl"
    mdl.write_text("mdl 1.7;")
    node = stage.ShaderNode(path="/m/tex", shader_id="UsdUVTexture", inputs={"file": "t.png"},
                            input_connections={})
    mats = {"/m": stage.MaterialDesc(path="/m", surface_node="/m/s", nodes={node.path: node},
                                     base_dir=str(tmp_path)),
            "/m2": stage.MaterialDesc(path="/m2", surface_node=None, nodes={},
                                      mdl_source=str(mdl))}
    return str(scene_file), type("FakeScene", (), {"materials": mats})()


def test_watched_material_sources_match_jax(tmp_path):
    from gatling_tpu.scene import stage as jax_stage
    from gatling_tpu_torch.scene import stage

    scene_file, ours = _fixture(tmp_path, stage)
    _, theirs = _fixture(tmp_path, jax_stage)
    watched = watched_material_sources(ours, scene_file)
    assert set(watched) == {scene_file, str(tmp_path / "t.png"), str(tmp_path / "m.mdl")}
    assert watched == jax_watched(theirs, scene_file)
    os.utime(tmp_path / "t.png", (1, 1))
    assert watched_material_sources(ours, scene_file) != watched


def test_watched_sources_of_a_textured_scene(tmp_path):
    """A loaded scene with textures: the same set as the JAX package's."""
    from gatling_tpu.scene.stage import load_scene as jax_load
    from gatling_tpu_torch.scene.examples import write_content

    usda = write_content(str(tmp_path), figures=2, rings=6, segments=8, joints=4, tex_res=8)
    from gatling_tpu_torch.cli import load_gi_scene

    scene, _desc, _ = load_gi_scene(usda, "cpu")
    theirs = type("S", (), {"materials": jax_load(usda).materials})()
    ours = watched_material_sources(scene, usda)
    assert len(ours) > 1 and ours == jax_watched(theirs, usda)


def test_watched_shader_sources(monkeypatch):
    monkeypatch.delenv("GATLING_WATCH_SHADERS", raising=False)
    watched = watched_shader_sources()
    names = {os.path.basename(p) for p in watched}
    assert {"integrator.py", "fused.py", "bounce.py", "bounce.cu", "trace.cu", "tree_walk.cuh",
            "gatling_native.cpp"} <= names
    assert all(p.startswith(os.path.join(REPO, "gatling_tpu_torch")) for p in watched)
    assert all(isinstance(t, float) for t in watched.values())
    monkeypatch.setenv("GATLING_WATCH_SHADERS", "0")
    assert watched_shader_sources() == {}


def test_watch_renders_again_on_texture_change(tmp_path):
    """`--watch` on the CPU: the first frame is written, a texture's new
    mtime brings a second one; then the process is stopped."""
    from gatling_tpu_torch.scene.examples import interior

    desc = interior(detail=1, tex_dir=str(tmp_path / "tex"))
    tex = sorted((tmp_path / "tex").glob("*.png"))[0]
    usda = tmp_path / "quad.usda"
    usda.write_text(f'''#usda 1.0
def Xform "Root"
{{
    def Xform "CamX"
    {{
        matrix4d xformOp:transform = ( (1,0,0,0), (0,1,0,0), (0,0,1,0), (0,0,2,1) )
        uniform token[] xformOpOrder = ["xformOp:transform"]
        def Camera "Cam"
        {{
            float focalLength = 35
            float verticalAperture = 20.955
            float horizontalAperture = 20.955
        }}
    }}
    def Mesh "Quad" (
        prepend apiSchemas = ["MaterialBindingAPI"]
    )
    {{
        int[] faceVertexCounts = [4]
        int[] faceVertexIndices = [0, 1, 3, 2]
        rel material:binding = </Root/Mat>
        point3f[] points = [(-1,-1,0), (1,-1,0), (-1,1,0), (1,1,0)]
        texCoord2f[] primvars:st = [(0,0), (1,0), (0,1), (1,1)] (interpolation = "vertex")
    }}
    def Material "Mat"
    {{
        token outputs:surface.connect = </Root/Mat/S.outputs:surface>
        def Shader "S"
        {{
            uniform token info:id = "UsdPreviewSurface"
            color3f inputs:emissiveColor.connect = </Root/Mat/T.outputs:rgb>
            color3f inputs:diffuseColor = (0, 0, 0)
        }}
        def Shader "T"
        {{
            uniform token info:id = "UsdUVTexture"
            asset inputs:file = @{tex}@
            float3 outputs:rgb
        }}
    }}
}}
''')
    assert desc.meshes
    out = tmp_path / "out.png"
    env = dict(os.environ, GATLING_WATCH_SHADERS="0", PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gatling_tpu_torch.cli", str(usda), str(out), "--watch",
         "--device", "cpu", "--image-width", "8", "--image-height", "8", "--spp", "1",
         "--max-bounces", "1"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()

    def wait_for_frames(k):
        deadline = time.monotonic() + 240
        while sum("wrote " in line for line in lines) < k:
            assert proc.poll() is None and time.monotonic() < deadline, "".join(lines)
            time.sleep(0.2)

    try:
        wait_for_frames(1)
        time.sleep(1.0)  # the watcher has taken its first snapshot
        later = time.time() + 5
        os.utime(tex, (later, later))
        wait_for_frames(2)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    assert out.exists()
