"""The committed graphical scenes through the port's own harness.

Every tests/graphical/*/scene.usda, as tests/test_graphical.py holds the
JAX package: `gatling_tpu_torch.testing` renders each product through
`gi.render` on the route the port picks by itself (here on the CPU, the
kernels' plain twins), encodes it and diffs it against the committed
reference PNGs at the scene's own gtl:errorPixelThreshold and
gtl:flipThreshold. Each scene's expectation:

* the route it renders on: the fused kernels (Camera.ClippingPlanes
  through the bounce-0 peel, MaterialX.ColorSpaces, Render.Empty1x1,
  Materials.MtlxFrame's ND_frame_float-driven emission at frame 60,
  Mesh.Skinned's UsdSkel mesh at frame 2 with its ALBEDO through the
  peel) or the
  wavefront (an AOV outside the fused set: Lights.Analytic's NEE,
  Render.AOVs' ids; Mesh.PrimvarInterpolation's vertex colours;
  Materials.MtlxViewDirection's emission, a view- and normal-dependent
  input evaluated per hit), which must pass both thresholds;
* Materials.GlassCoated's 48 spp take minutes through the twins on the
  CPU, so it is held on the card only (`requires_cuda`; chip_smoke.py's
  goldens phase and golden_glass_coated): its reference is a wavefront
  image, the port's route for it the fused K1, whose samples are drawn in
  another order, so the card holds the harness's frame to the FLIP
  threshold and its mean, and the wavefront frame to both thresholds.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from gatling_tpu_torch import imgio, testing
from gatling_tpu_torch.interface import AovId

# one PyTorch thread a test: a harness frame on the CPU is thousands of
# small ops (the wavefront's shading), and beside five other workers
# Lights.Analytic took 296 s on the default pool (4 s alone, 9 s alone on
# one thread)
from test_torch_bvh import one_thread  # noqa: F401 (an autouse fixture)

GRAPHICAL = Path(__file__).parent / "graphical"
SCENES = sorted(p.parent.name for p in GRAPHICAL.glob("*/scene.usda"))
ROUTES = {
    "Camera.ClippingPlanes": "fused",
    "Lights.Analytic": "wavefront",
    "MaterialX.ColorSpaces": "fused",
    "Materials.GlassCoated": "card",
    "Materials.MtlxFrame": "fused",
    "Materials.MtlxViewDirection": "wavefront",
    "Mesh.PrimvarInterpolation": "wavefront",
    "Mesh.Skinned": "fused",
    "Render.AOVs": "wavefront",
    "Render.Empty1x1": "fused",
}


def test_every_golden_has_an_expectation():
    assert SCENES == sorted(ROUTES) and len(SCENES) == 10


def _check_goldens(name, device, tmp_path):
    """Render through the harness on `device`; returns (scene, results):
    (error components, mean FLIP, failures) by AOV."""
    scene_path = GRAPHICAL / name / "scene.usda"
    images, spec, scene = testing.render_products(scene_path, device)
    threshold = int(spec.settings["errorPixelThreshold"])
    flip_threshold = float(spec.settings["flipThreshold"])
    results = {}
    for var, img in images.items():
        ref = imgio.load_image_file(scene_path.parent / f"ref_{var}.png")
        results[var] = testing.compare_images(var, img, ref, threshold, flip_threshold)
        print(f"{name} {var}: {results[var][0]} error components (threshold {threshold}), "
              f"mean FLIP {results[var][1]:.4f} (threshold {flip_threshold})")
    return scene, results


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.requires_cuda) if ROUTES[n] == "card" else n
    for n in SCENES])
def test_graphical_scene_matches_reference(name, tmp_path):
    route = ROUTES[name]
    if route == "card":
        if not torch.cuda.is_available():
            pytest.skip("48 spp through the twins take minutes on the CPU: held on the card "
                        "(here and in chip_smoke.py's goldens phase)")
        scene, results = _check_goldens(name, "cuda", tmp_path)
        (errors, flip, failures), = results.values()
        assert scene._fused is not None and scene._fused_static.advanced
        # only the error components miss (the fused frame against a
        # wavefront image); the wavefront frame passes in chip_smoke.py
        assert np.isfinite(flip) and all("error components" in f for f in failures)
        return
    scene, results = _check_goldens(name, "cpu", tmp_path)
    assert (scene._fused is not None) == (route == "fused"), name
    assert (scene._accel is not None) == (route == "wavefront"), name
    for var, (_errors, _flip, failures) in results.items():
        assert not failures, failures
    if name == "Camera.ClippingPlanes":
        assert scene._fused_static is not None and not scene._fused_static.textured


def test_run_graphical_test_writes_its_images(tmp_path):
    """run_graphical_test: the render of every AOV beside the references,
    no failure on a passing scene; a mismatch writes its diff image and
    names the failing AOV."""
    scene = GRAPHICAL / "MaterialX.ColorSpaces" / "scene.usda"
    assert testing.run_graphical_test(scene, tmp_path, "cpu") == []
    written = imgio.load_image_file(tmp_path / "test_color.png")
    np.testing.assert_array_equal(written, imgio.load_image_file(scene.parent / "ref_color.png"))
    ref = written.copy()
    ref[:4, :4, 0] ^= 0xFF
    errors, _flip, failures = testing.compare_images("color", written, ref, 15, 0.0)
    assert errors == 16 and failures == ["color: 16 error components > threshold 15"]


def test_render_spec_of_render_aovs():
    """The spec the harness reads: Render.AOVs' twelve render vars and its
    gtl: settings, typed."""
    from gatling_tpu_torch.scene.usda import load_usd

    spec = testing.compute_render_spec(load_usd(GRAPHICAL / "Render.AOVs" / "scene.usda"))
    (product,) = spec.products
    assert len(product.aovs) == 12 and product.aovs[0] == ("color", AovId.COLOR)
    assert spec.settings["spp"] == 16 and spec.settings["errorPixelThreshold"] == 1200
    assert isinstance(spec.settings["flipThreshold"], float)
