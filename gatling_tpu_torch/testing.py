"""Graphical test harness of the port.

Port of the JAX package's gatling_tpu/testing.py, after the reference's
hdGatling_test GraphicalTestContext (src/hdGatling/main.cpp:220-509): a
scene's UsdRenderSettings prim drives the resolution, camera, AOV render
products and namespaced `gtl:` settings (gtl:spp, gtl:errorPixelThreshold,
gtl:flipThreshold, gtl:jitteredSampling, gtl:clippingPlanes, gtl:frame,
gtl:maxBounces, gtl:nextEventEstimation); each product renders through
`gi.render` on the route the port picks by itself, is encoded to bytes
(sRGB for COLOR, utils/flip.py), and is diffed byte for byte against the
committed reference PNG (decoded by the port's imgio) with the scene's
error-component threshold and its mean-FLIP threshold; a diff image is
written beside the render on a mismatch.

    from gatling_tpu_torch.testing import run_graphical_test
    failures = run_graphical_test("tests/graphical/Render.AOVs/scene.usda", "out/", "cuda")
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from gatling_tpu_torch import gi, imgio
from gatling_tpu_torch.cli import load_gi_scene
from gatling_tpu_torch.interface import AOV_CHANNELS, AOV_IS_INT, AovId
from gatling_tpu_torch.scene.usda import Stage, load_usd
from gatling_tpu_torch.utils.config import default_settings
from gatling_tpu_torch.utils.flip import mean_flip, srgb_encode
from gatling_tpu_torch.utils.log import get_logger

# Hydra AOV token -> AovId (reference: renderPass.cpp:41-59)
AOV_TOKENS = {
    "color": AovId.COLOR,
    "normal": AovId.NORMAL,
    "albedo": AovId.ALBEDO,
    "depth": AovId.DEPTH,
    "objectId": AovId.OBJECT_ID,
    "primId": AovId.OBJECT_ID,
    "faceId": AovId.FACE_ID,
    "element": AovId.FACE_ID,
    "instanceId": AovId.INSTANCE_ID,
    "barycentrics": AovId.BARYCENTRICS,
    "texcoords": AovId.TEXCOORDS,
    "bounces": AovId.BOUNCES,
    "opacity": AovId.OPACITY,
    "tangents": AovId.TANGENTS,
    "bitangents": AovId.BITANGENTS,
    "thinWalled": AovId.THIN_WALLED,
    "doubleSided": AovId.DOUBLE_SIDED,
    "nee": AovId.NEE,
    "clockCycles": AovId.CLOCK_CYCLES,
}

# gtl: settings of the RenderSettings prim (main.cpp:288-330)
_SETTINGS = {
    "gtl:spp": ("spp", int),
    "gtl:errorPixelThreshold": ("errorPixelThreshold", int),
    "gtl:flipThreshold": ("flipThreshold", float),
    "gtl:frame": ("frame", float),
    "gtl:jitteredSampling": ("jitteredSampling", bool),
    "gtl:clippingPlanes": ("clippingPlanes", bool),
    "gtl:maxBounces": ("maxBounces", int),
    "gtl:nextEventEstimation": ("nextEventEstimation", bool),
}


@dataclasses.dataclass
class RenderProduct:
    name: str
    resolution: tuple[int, int]
    camera_path: str | None
    aovs: list[tuple[str, AovId]]  # (sourceName, id)


@dataclasses.dataclass
class RenderSpec:
    products: list[RenderProduct]
    settings: dict


def compute_render_spec(stage: Stage) -> RenderSpec:
    """UsdRenderComputeSpec analog: the RenderSettings prim, its products
    and their render vars, and the `gtl:` settings."""
    rs_prim = None
    rs_path = stage.meta.get("renderSettingsPrimPath")
    if rs_path:
        rs_prim = stage.find(str(rs_path))
    if rs_prim is None:
        rs_prim = next((p for p in stage.walk() if p.type_name == "RenderSettings"), None)
    if rs_prim is None:
        raise ValueError("no RenderSettings prim in stage")

    settings = {}
    for attr_name, (key, conv) in _SETTINGS.items():
        a = rs_prim.attrs.get(attr_name)
        if a is not None and a.value is not None:
            settings[key] = conv(a.value)

    def targets(prim, rel_name):
        return [t for t in (stage.find(p) for p in prim.rels.get(rel_name, [])) if t is not None]

    products = []
    for pp in targets(rs_prim, "products") or [rs_prim]:  # the settings prim can hold them
        res = pp.attrs.get("resolution")
        resolution = tuple(int(v) for v in res.value) if res and res.value else (64, 64)
        cam_rel = pp.rels.get("camera", [])
        aovs = []
        for vp in targets(pp, "orderedVars"):
            src = vp.attrs.get("sourceName")
            name = str(src.value) if src and src.value else "color"
            aov = AOV_TOKENS.get(name)
            if aov is None:
                get_logger().warning("unknown render var sourceName %r", name)
                continue
            aovs.append((name, aov))
        products.append(RenderProduct(name=pp.name, resolution=resolution,
                                      camera_path=cam_rel[0] if cam_rel else None,
                                      aovs=aovs or [("color", AovId.COLOR)]))
    return RenderSpec(products=products, settings=settings)


def encode_aov_u8(aov: AovId, data: np.ndarray) -> np.ndarray:
    """A render buffer in image row order [H, W, C] -> the RGBA8 bytes the
    harness diffs (main.cpp:332-376): COLOR sRGB-encoded, DEPTH as grey,
    the ids hashed to grey levels (-1 black), the other AOVs clipped."""
    h, w = data.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    if data.dtype == np.int32:
        v = data[:, :, 0].astype(np.float64)
        v = np.where(v < 0, 0.0, (v % 255) / 255.0 * 0.8 + 0.2)
        rgb = np.repeat(v[:, :, None], 3, axis=2)
    elif aov == AovId.COLOR:
        rgb = srgb_encode(data[:, :, :3])
    elif aov == AovId.DEPTH:
        rgb = np.repeat(np.clip(data[:, :, :1].astype(np.float64), 0, 1), 3, axis=2)
    else:
        rgb = np.clip(data[:, :, :3].astype(np.float64), 0.0, 1.0)
    out[:, :, :3] = (rgb * 255.0 + 0.5).astype(np.uint8)
    return out


def render_products(scene_path: str | Path, device: str = "cuda"
                    ) -> tuple[dict[str, np.ndarray], RenderSpec, gi.GiScene]:
    """Render every (product, AOV) of a test scene through gi.render on
    `device`; returns the byte images keyed by the AOV's source name (in
    image row order), the spec and the scene (its route: scene._fused or
    scene._accel)."""
    spec = compute_render_spec(load_usd(scene_path))
    # gtl:frame beats the layer's default frame (renderPass.cpp frame plumbing)
    frame = {"frame": spec.settings["frame"]} if "frame" in spec.settings else {}
    scene, desc, _cli_settings = load_gi_scene(str(scene_path), device, frame)
    # the settings the references were made with: the defaults and the
    # spec's gtl: settings (not every gtl: attribute, as the CLI takes them)
    merged = default_settings()
    merged["metersPerSceneUnit"] = desc.meters_per_unit
    merged.update({k: v for k, v in spec.settings.items() if k != "errorPixelThreshold"})
    images: dict[str, np.ndarray] = {}
    for product in spec.products:
        camera = desc.cameras.get(product.camera_path) if product.camera_path else None
        camera = camera or desc.first_camera()
        if camera is None:
            raise ValueError(f"no camera for product {product.name}")
        w, h = product.resolution
        bindings, buffers = [], {}
        for name, aov in product.aovs:
            is_int = AOV_IS_INT[aov]
            buf = gi.GiRenderBuffer(w, h, 1 if is_int else max(AOV_CHANNELS[aov], 3), is_int)
            bindings.append(gi.GiAovBinding(aov, buf, clear_value=-1 if is_int else None))
            buffers[name] = (aov, buf)
        scene.dirty |= gi.DirtyFlags.FRAMEBUFFER  # independent products
        gi.render(gi.GiRenderParams(scene=scene, camera=camera, aov_bindings=bindings,
                                    render_settings=dict(merged)))
        for name, (aov, buf) in buffers.items():
            images[name] = encode_aov_u8(aov, buf.data[::-1])
    return images, spec, scene


def compare_images(name: str, test_img: np.ndarray, ref_img: np.ndarray, threshold: int,
                   flip_threshold: float) -> tuple[int, float, list[str]]:
    """(error components, mean FLIP, failure messages) of a rendered image
    against its reference: every byte that differs counts; FLIP over RGB
    when the scene sets a FLIP threshold."""
    if ref_img.shape != test_img.shape:
        return -1, float("nan"), [f"{name}: resolution mismatch {ref_img.shape} vs "
                                  f"{test_img.shape}"]
    errors = int((ref_img != test_img).sum())
    failures = []
    if errors > threshold:
        failures.append(f"{name}: {errors} error components > threshold {threshold}")
    score = float("nan")
    if flip_threshold > 0.0 and test_img.shape[-1] >= 3:
        score = mean_flip(ref_img[..., :3], test_img[..., :3])
        if score > flip_threshold:
            failures.append(f"{name}: mean FLIP {score:.4f} > threshold {flip_threshold}")
    return errors, score, failures


def run_graphical_test(scene_path: str | Path, output_dir: str | Path,
                       device: str = "cuda") -> list[str]:
    """Render a test scene on `device` and diff it against its committed
    references. Returns the failure messages (empty: passed); writes
    test_<aov>.png always and diff_<aov>.png on a mismatch."""
    scene_path, output_dir = Path(scene_path), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    images, spec, _scene = render_products(scene_path, device)
    threshold = int(spec.settings.get("errorPixelThreshold", 0))
    flip_threshold = float(spec.settings.get("flipThreshold", 0.0))
    failures = []
    for name, test_img in images.items():
        imgio.write_image_file(output_dir / f"test_{name}.png", test_img)
        ref_path = scene_path.parent / f"ref_{name}.png"
        if not ref_path.exists():
            failures.append(f"{name}: missing reference image {ref_path}")
            continue
        ref_img = imgio.load_image_file(ref_path)
        errors, _score, msgs = compare_images(name, test_img, ref_img, threshold, flip_threshold)
        if errors > threshold:
            diff = np.abs(ref_img.astype(int) - test_img.astype(int))
            imgio.write_image_file(output_dir / f"diff_{name}.png", (255 - diff).astype(np.uint8))
        failures += msgs
    return failures


def generate_references(scene_path: str | Path, device: str = "cuda") -> None:
    """(Re)generate the reference images of a test scene from this
    package's renders."""
    scene_path = Path(scene_path)
    images, _spec, _scene = render_products(scene_path, device)
    for name, img in images.items():
        imgio.write_image_file(scene_path.parent / f"ref_{name}.png", img)
