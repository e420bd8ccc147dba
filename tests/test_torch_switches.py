"""The user-facing switches GATLING_FUSED and GATLING_TRACER
(docs/ENV_VARS.md), read by the port's gi as the JAX package's gi reads
them (gatling_tpu/gi.py:277-286, :649-651), on the CPU.

1. GATLING_FUSED=0 sends a COLOR frame to the wavefront integrator: the
   fused tables are never built, and the frame equals, bit for bit, the
   wavefront frame that an extra OBJECT_ID binding routes there; it agrees
   in distribution with the JAX package's frame under the same setting.
2. GATLING_TRACER forces the wavefront's tracer: "bvh" takes B1/B2 (their
   twins on the CPU, counted here) on the Cornell box, which the size rule
   gives K5/K6; "pallas" is the port's K5/K6 ("matrix"); "brute" the plain
   Moller-Trumbore of ops/intersect.py, which runs no kernel. Each frame
   agrees in distribution with the JAX package's frame under the same
   setting (the same RNG streams: COLOR within 1e-3 on 98 % of pixels,
   the mean within 1 %).
"""

import numpy as np
import pytest

from gatling_tpu.cli import render_scene_file as jrender_scene_file

from jax.experimental.pallas import tpu as pltpu

from gatling_tpu_torch import cli, gi
from gatling_tpu_torch.interface import AovId
from gatling_tpu_torch.ops import intersect
from gatling_tpu_torch.ops import trace as tt
from gatling_tpu_torch.scene.stage import load_scene

CORNELL = "tests/data/cornell.usda"
SETTINGS = dict(spp=2, maxBounces=3, nextEventEstimation=True)
RES = 16


def _agrees(color: np.ndarray, ref: np.ndarray) -> None:
    color, ref = color[..., :3], ref[..., :3]
    close = (np.abs(color - ref) <= 1e-3 + 1e-3 * np.abs(ref)).all(axis=-1).mean()
    rel = abs(color.mean() - ref.mean()) / ref.mean()
    print(f"COLOR within 1e-3 on {close:.4f} of pixels, mean rel diff {rel:.2e}")
    assert np.isfinite(color).all() and ref.mean() > 0.01
    assert close >= 0.98 and rel < 0.01


def _frames(monkeypatch, **env):
    """The port's and the JAX package's CLI frames under `env` (the JAX
    package's Pallas tracer in interpret mode, as its own tests run it)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    img, scene = cli.render_scene_file(CORNELL, RES, RES, dict(SETTINGS), device="cpu")
    with pltpu.force_tpu_interpret_mode():
        ref, jscene = jrender_scene_file(CORNELL, RES, RES, dict(SETTINGS))
    return img, scene, ref, jscene


def _gi_color(ids: bool) -> tuple[np.ndarray, object]:
    """The COLOR of the Cornell box through gi.render, with an extra
    OBJECT_ID binding (which routes the frame to the wavefront) or not."""
    desc = load_scene(CORNELL)
    scene = gi.create_scene("cpu")
    for m in desc.meshes:
        scene.add_mesh(m)
    for m in desc.materials.values():
        scene.add_material(m)
    for light in desc.lights:
        scene.add_light(light)
    color = gi.GiRenderBuffer(RES, RES, 4)
    bindings = [gi.GiAovBinding(AovId.COLOR, color)]
    if ids:
        bindings.append(gi.GiAovBinding(AovId.OBJECT_ID, gi.GiRenderBuffer(RES, RES, 1, True),
                                        clear_value=-1))
    gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                                aov_bindings=bindings, render_settings=dict(SETTINGS)))
    return color.data, scene


def test_fused_0_routes_every_frame_to_the_wavefront(monkeypatch):
    monkeypatch.delenv("GATLING_TRACER", raising=False)
    monkeypatch.delenv("GATLING_FUSED", raising=False)
    wave, wscene = _gi_color(ids=True)
    monkeypatch.setenv("GATLING_FUSED", "0")
    img, scene = _gi_color(ids=False)
    assert wscene._fused is None and scene._fused is None and scene._tracer == "matrix"
    np.testing.assert_array_equal(img, wave)
    cimg, cscene, ref, _ = _frames(monkeypatch, GATLING_FUSED="0")
    assert cscene._fused is None
    _agrees(cimg, ref)


def test_fused_default_takes_the_fused_route(monkeypatch):
    monkeypatch.delenv("GATLING_FUSED", raising=False)
    monkeypatch.delenv("GATLING_TRACER", raising=False)
    _img, scene = cli.render_scene_file(CORNELL, RES, RES, dict(SETTINGS), device="cpu")
    assert scene._fused is not None and scene._accel is None


def test_tracer_bvh_takes_b1_b2(monkeypatch):
    calls = {"closest": 0, "occluded": 0}
    closest, occluded = tt.intersect_threaded_ref, tt.occluded_threaded_ref

    def count_closest(*a, **k):
        calls["closest"] += 1
        return closest(*a, **k)

    def count_occluded(*a, **k):
        calls["occluded"] += 1
        return occluded(*a, **k)

    monkeypatch.setattr(tt, "intersect_threaded_ref", count_closest)
    monkeypatch.setattr(tt, "occluded_threaded_ref", count_occluded)
    img, scene, ref, jscene = _frames(monkeypatch, GATLING_FUSED="0", GATLING_TRACER="bvh")
    assert scene._tracer == "bvh" and jscene._tracer == "bvh"
    assert scene._accel.bvh is not None and calls["closest"] > 0 and calls["occluded"] > 0
    _agrees(img, ref)


@pytest.mark.parametrize("forced,port_name", [("pallas", "matrix"), ("brute", "brute")])
def test_tracer_forced(monkeypatch, forced, port_name):
    calls = {"brute": 0}
    real = intersect.intersect_brute

    def count(*a, **k):
        calls["brute"] += 1
        return real(*a, **k)

    monkeypatch.setattr(intersect, "intersect_brute", count)
    from gatling_tpu_torch.render import integrator

    monkeypatch.setattr(integrator, "intersect_brute", count)
    img, scene, ref, jscene = _frames(monkeypatch, GATLING_FUSED="0", GATLING_TRACER=forced)
    assert scene._tracer == port_name and jscene._tracer == forced
    assert (calls["brute"] > 0) == (forced == "brute")
    if forced == "brute":
        assert scene._accel.soup is not None and scene._accel.tables is None
    _agrees(img, ref)


def test_tracer_switch_ignores_unknown_values(monkeypatch):
    monkeypatch.setenv("GATLING_TRACER", "warp")
    assert gi._choose_tracer(type("G", (), {"num_triangles": 10})()) == "matrix"
    assert gi._choose_tracer(type("G", (), {"num_triangles": 9000})()) == "bvh"
