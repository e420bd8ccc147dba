"""Headless renderer CLI of the port.

`python -m gatling_tpu_torch.cli scene.usda out.png [options]` renders one
frame on the card (`--device cuda`, the default) or through the kernels'
plain twins on the CPU (`--device cpu`). The flags are the JAX package's
(reference: src/gatling/main.cpp:94-265, Argparse.cpp:30-318): image size,
camera path, AOV, gamma, and one flag per render setting. `--aov` takes
every AOV: colour and the first-hit normal, albedo, depth and texcoords
render through the fused kernels, the others through the wavefront
integrator (gi.py), the ids into int32 buffers. A `DomeLight` prim's
`inputs:texture:file` becomes the scene's dome light. `--checkpoint
file.npz` resumes the accumulation from the file when it exists and writes
it after the frame (gi.giSaveCheckpoint: the JAX package's format, so a
checkpoint crosses between the two CLIs). `--watch` renders again whenever
the scene or a material source it reads (a texture, an .mdl module)
changes, and re-executes itself when the port's shader code changes
(render/, ops/, csrc/; the kernels rebuild under their new source hash);
GATLING_WATCH_SHADERS=0 leaves the shader code unwatched.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

import numpy as np

from gatling_tpu_torch import gi, imgio
from gatling_tpu_torch.interface import AOV_CHANNELS, AOV_IS_INT, AovId
from gatling_tpu_torch.scene.stage import CameraDesc, load_scene
from gatling_tpu_torch.utils.config import SETTING_DESCRIPTORS, default_settings
from gatling_tpu_torch.utils.log import get_logger, init_logging


def _kebab(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "-", name).lower()


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gatling",
        description="USD path tracer, PyTorch + CUDA port (gatling_tpu_torch)")
    p.add_argument("scene", help="input USD scene (.usda / .usdc / .usdz)")
    p.add_argument("output", help="output image (.png; .exr or .hdr for linear values)")
    p.add_argument("--image-width", type=int, default=1200)
    p.add_argument("--image-height", type=int, default=1200)
    p.add_argument("--camera-path", type=str, default=None)
    p.add_argument("--aov", type=str, default="color",
                   choices=[a.name.lower() for a in AovId])
    p.add_argument("--gamma-correction", action=argparse.BooleanOptionalAction, default=True,
                   help="encode output as sRGB (main.cpp:84-92)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="progressive-accumulation checkpoint (.npz): resumed "
                        "if it exists, written after the render")
    p.add_argument("--watch", action="store_true",
                   help="re-render whenever the scene or a material source changes (the "
                        "shader hot-reload analog, Gi.cpp:261-285)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the bounce kernel) or cpu (its plain twin)")
    for d in SETTING_DESCRIPTORS:
        flag = "--" + _kebab(d.name)
        if d.type is bool:
            p.add_argument(flag, action=argparse.BooleanOptionalAction,
                           default=d.default, help=d.help, dest=d.name)
        else:
            p.add_argument(flag, type=d.type, default=d.default, help=d.help, dest=d.name)
    return p


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    """Reference: main.cpp:84-92."""
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * np.power(c, 1.0 / 2.4) - 0.055)


def load_gi_scene(scene_path: str, device: str, settings: dict | None = None):
    """Load a USD file into a GiScene. Returns (scene, description,
    settings): the settings merge the defaults, the file's render settings
    and `settings`."""
    log = get_logger()
    t0 = time.monotonic()
    settings = settings or {}
    desc = load_scene(scene_path, frame=settings.get("frame"))
    log.info("loaded %s: %d meshes, %d materials, %d lights (%.1f ms)",
             scene_path, len(desc.meshes), len(desc.materials), len(desc.lights),
             1e3 * (time.monotonic() - t0))
    scene = gi.create_scene(device)
    for m in desc.meshes:
        scene.add_mesh(m)
    for mat in desc.materials.values():
        scene.add_material(mat)
    for light in desc.lights:
        if light.light_type == "dome":
            scene.set_dome_light(gi.GiDomeLight(file_path=light.params.get("texture")))
        else:
            scene.add_light(light)
    merged = default_settings()
    merged.update(desc.render_settings)
    merged.update(settings)
    if "metersPerSceneUnit" not in settings:
        merged["metersPerSceneUnit"] = desc.meters_per_unit
    return scene, desc, merged


def render_scene_file(scene_path: str, width: int, height: int, settings: dict,
                      aov: AovId = AovId.COLOR, camera_path: str | None = None,
                      device: str = "cuda", checkpoint: str | None = None):
    """Load a USD scene and render one frame of `aov`; returns (image
    [H, W, C], scene): 4 channels for colour, at least 3 for the other
    float AOVs, 1 int32 channel for the ids. With `checkpoint`, the
    accumulation resumes from that file when it exists, and the file is
    written after the frame."""
    log = get_logger()
    scene, desc, merged = load_gi_scene(scene_path, device, settings)
    camera = desc.cameras.get(camera_path) if camera_path else None
    if camera_path and camera is None:
        log.error("camera %s not found", camera_path)
    camera = camera or desc.first_camera()
    if camera is None:
        log.warning("no camera in scene; using default")
        camera = CameraDesc(position=np.array([0, 0, 5], np.float32),
                            forward=np.array([0, 0, -1], np.float32),
                            up=np.array([0, 1, 0], np.float32), vfov=0.4)
    is_int = AOV_IS_INT[aov]
    buf = gi.GiRenderBuffer(width, height, 1 if is_int else max(AOV_CHANNELS[aov], 3), is_int)
    params = gi.GiRenderParams(scene=scene, camera=camera,
                               aov_bindings=[gi.GiAovBinding(aov_id=aov, render_buffer=buf)],
                               render_settings=merged)
    if checkpoint and os.path.exists(checkpoint):
        offset = gi.giLoadCheckpoint(scene, checkpoint)
        log.info("resumed checkpoint %s at sampleOffset %d", checkpoint, offset)
    t0 = time.monotonic()
    gi.render(params)
    log.info("rendered %dx%d @ %d spp on %s in %.2f s", width, height,
             merged.get("spp", 1), scene.device, time.monotonic() - t0)
    if checkpoint:
        gi.giSaveCheckpoint(scene, checkpoint)
        log.info("wrote checkpoint %s (sampleOffset %d)", checkpoint, scene.sample_offset)
    return buf.data, scene


# the paths the JAX CLI converts to sRGB RGB (a case-sensitive suffix test)
SRGB_SUFFIXES = (".png", ".jpg", ".jpeg", ".tga", ".tiff", ".tif")


def write_output(img: np.ndarray, path: str, gamma_correction: bool = True,
                 aov: AovId = AovId.COLOR) -> None:
    """Flip to image row order (main.cpp:224-249) and write as
    gatling_tpu/cli.py _write_output does: ids as grey levels over their
    maximum; a path ending, case-sensitively, in .png .jpg .jpeg .tga .tiff
    or .tif gets RGB (grey repeated), sRGB-encoded for colour when
    `gamma_correction`; every other path the buffer's own channels, linear
    (imgio.write_image_file picks the format by the extension, case aside,
    and raises where the JAX package's Pillow raises)."""
    out = img[::-1]
    if out.dtype == np.int32:  # NumPy's promotion of the int32 maximum, as there
        out = out.astype(np.float32) / max(1.0, out.max())
    if path.endswith(SRGB_SUFFIXES):
        rgb = out[:, :, :3] if out.shape[2] >= 3 else np.repeat(out, 3, axis=2)
        if gamma_correction and aov == AovId.COLOR:
            rgb = linear_to_srgb(rgb)
        imgio.write_image_file(path, np.clip(rgb, 0, 1).astype(np.float32))
    else:
        imgio.write_image_file(path, out.astype(np.float32))
    get_logger().info("wrote %s", path)


def _mtimes(paths) -> dict[str, float]:
    out = {}
    for p in paths:
        try:
            out[p] = os.path.getmtime(p)
        except OSError:
            pass
    return out


def watched_material_sources(scene, scene_path: str) -> dict[str, float]:
    """The watch set of --watch, path -> mtime: the scene file and every
    material source it reads, the `file` inputs of shader nodes (relative
    to the material's base_dir) and .mdl modules (gatling_tpu/cli.py:158-
    184; the reference's efsw watcher over its shader sources,
    Gi.cpp:261-285)."""
    paths = {scene_path}
    for mat in getattr(scene, "materials", {}).values():
        base = getattr(mat, "base_dir", "") or ""
        for node in mat.nodes.values():
            f = node.inputs.get("file")
            if isinstance(f, str) and f:
                paths.add(f if os.path.isabs(f) else os.path.join(base, f))
        mdl = getattr(mat, "mdl_source", None)
        if mdl:
            paths.add(mdl)
    return _mtimes(paths)


# the port's shader code: the render and ops modules and the kernels' sources
_SHADER_SOURCES = (("render", (".py",)), ("ops", (".py",)), ("csrc", (".cu", ".cuh", ".cpp")))


def watched_shader_sources() -> dict[str, float]:
    """The shader-code watch set, path -> mtime (gatling_tpu/cli.py:187-
    208): render/*.py, ops/*.py and csrc/*.{cu,cuh,cpp} of this package. A
    change re-executes the CLI, so the modules import anew and an edited
    kernel builds under its new source hash. GATLING_WATCH_SHADERS=0: none."""
    if os.environ.get("GATLING_WATCH_SHADERS", "1") == "0":
        return {}
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    paths = []
    for sub, exts in _SHADER_SOURCES:
        d = os.path.join(pkg_dir, sub)
        try:
            paths += [os.path.join(d, f) for f in os.listdir(d) if f.endswith(exts)]
        except OSError:
            continue
    return _mtimes(paths)


def _watch(args, settings: dict, aov: AovId, scene) -> int:
    """Render again on every change of the scene's material sources;
    re-execute on a change of the shader code (gatling_tpu/cli.py:210-258).
    Polls every half second until interrupted."""
    log = get_logger()
    last = watched_material_sources(scene, args.scene)
    last_shaders = watched_shader_sources()
    log.info("watching %d file(s) (scene + material sources) and %d shader source(s) for "
             "changes (ctrl-c to stop)", len(last), len(last_shaders))
    try:
        while True:
            time.sleep(0.5)
            if watched_shader_sources() != last_shaders:
                log.info("shader source changed; reloading")
                sys.stdout.flush()
                os.execv(sys.executable,
                         [sys.executable, "-m", "gatling_tpu_torch.cli"] + sys.argv[1:])
            if watched_material_sources(scene, args.scene) != last:
                img, scene = render_scene_file(args.scene, args.image_width,
                                               args.image_height, settings, aov,
                                               args.camera_path, device=args.device)
                write_output(img, args.output, args.gamma_correction, aov)
                last = watched_material_sources(scene, args.scene)
    except KeyboardInterrupt:
        return 0


def main(argv: list[str] | None = None) -> int:
    init_logging()
    args = build_arg_parser().parse_args(argv)
    settings = {d.name: getattr(args, d.name) for d in SETTING_DESCRIPTORS}
    aov = AovId[args.aov.upper()]
    img, scene = render_scene_file(args.scene, args.image_width, args.image_height,
                                   settings, aov, args.camera_path, device=args.device,
                                   checkpoint=args.checkpoint)
    write_output(img, args.output, args.gamma_correction, aov)
    if args.watch:
        return _watch(args, settings, aov, scene)
    return 0


if __name__ == "__main__":
    sys.exit(main())
