"""Multi-device rendering of the port (gatling_tpu_torch/parallel/
sharding.py) on CPU device slots: pixel tiles are bit-equal to one device
on the fused and the wavefront routes, sample shards agree within float
rounding, the shard merge applies the JAX package's rule to each field,
gi's parallelDevices clamps to the devices present, and the driver entry
points run (gatling_tpu_torch/entry.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from gatling_tpu_torch import cli, entry, gi
from gatling_tpu_torch.interface import AovId, aov_bit
from gatling_tpu_torch.parallel.sharding import (
    _merge_spp_axis,
    make_mesh,
    render_frame_sharded,
    render_fused_sharded,
    to_device,
)
from gatling_tpu_torch.render.fused import render_pixels_fused
from gatling_tpu_torch.render.integrator import SampleResult, empty_first_hit, render_frame

CORNELL = "tests/data/cornell.usda"


def _fused_frame(w, h, spp, settings=None):
    """A gi scene of the Cornell box with its fused tables built, and the
    config and uniforms of a COLOR frame."""
    settings = dict({"spp": spp, "maxBounces": 3, "nextEventEstimation": True}, **(settings or {}))
    scene, desc, merged = cli.load_gi_scene(CORNELL, "cpu", settings)
    params = gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                               aov_bindings=[gi.GiAovBinding(AovId.COLOR,
                                                             gi.GiRenderBuffer(w, h, 4))],
                               render_settings=merged)
    gi.render(params)
    config = gi._build_config(params, w, h, aov_bit(AovId.COLOR))
    scene.sample_offset = 0
    return scene, config, gi.frame_uniforms(params, config)


@pytest.mark.parametrize("n_tiles", [2, 4])
def test_fused_tiles_bit_equal(n_tiles):
    """Tiles on ['cpu'] * n: colour and segment counts bit-equal to the
    one-device frame, with the frame's own sample waves (a tile of a
    quarter of the pixels would batch more samples a wave)."""
    scene, config, uniforms = _fused_frame(32, 24, 4)
    one, segs = render_pixels_fused(config, uniforms, scene._fused, torch.arange(32 * 24), 4, 0,
                                    with_stats=True)
    mesh = make_mesh(n_tiles, 1, ["cpu"] * n_tiles)
    assert mesh.shape == {"tiles": n_tiles, "spp": 1}
    got, got_segs = render_fused_sharded(config, uniforms, scene._fused, scene._fused_static,
                                         None, mesh)
    assert torch.equal(got, one) and torch.equal(got_segs, segs)


def _desc_frame(desc, w, h, spp):
    scene = gi.create_scene("cpu")
    for m in desc.meshes:
        scene.add_mesh(m)
    for m in desc.materials.values():
        scene.add_material(m)
    for light in desc.lights:
        scene.add_light(light)
    params = gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                               aov_bindings=[gi.GiAovBinding(AovId.COLOR,
                                                             gi.GiRenderBuffer(w, h, 4))],
                               render_settings={"spp": spp, "maxBounces": 3,
                                                "nextEventEstimation": True})
    gi.render(params)
    img = params.aov_bindings[0].render_buffer.data.copy()
    params.render_settings = dict(params.render_settings, parallelDevices=2)
    return scene, params, img


@pytest.mark.parametrize("kind", ["walk", "split"])
def test_tiles_through_gi(monkeypatch, kind, tmp_path):
    """gi's sharded route on two CPU slots (parallelDevices clamped only by
    a patched device count): an instanced scene on the two-level walk, with
    the coherence sort, and the textured interior on the split bounce, each
    bit-equal to its one-device frame."""
    from gatling_tpu_torch.parallel import sharding
    from gatling_tpu_torch.scene.examples import interior, sphere_field

    desc = (sphere_field(n_side=6, sphere_res=8) if kind == "walk"
            else interior(detail=1, tex_dir=str(tmp_path)))
    scene, params, one = _desc_frame(desc, 16, 16, 2)
    assert (scene._fused.walk is not None) if kind == "walk" else scene._fused_static.textured
    calls = []
    real = sharding.render_fused_sharded

    def spy(*args):
        calls.append(args[5].shape)
        return real(*args)

    monkeypatch.setattr(gi, "_parallel_devices", lambda s, d: int(s.get("parallelDevices", 1)))
    monkeypatch.setattr(sharding, "make_mesh", lambda n_tiles: make_mesh(n_tiles, 1,
                                                                         ["cpu"] * n_tiles))
    monkeypatch.setattr(sharding, "render_fused_sharded", spy)
    scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    gi.render(params)
    assert calls == [{"tiles": 2, "spp": 1}]
    np.testing.assert_array_equal(params.aov_bindings[0].render_buffer.data, one)


def test_fused_spp_shards_close():
    """Two sample shards (disjoint sample windows, averaged) against the
    one-device frame: rtol 1e-4, atol 1e-5."""
    scene, config, uniforms = _fused_frame(24, 24, 4)
    one, segs = render_pixels_fused(config, uniforms, scene._fused, torch.arange(24 * 24), 4, 0,
                                    with_stats=True)
    for shape in ((1, 2), (2, 2)):
        got, got_segs = render_fused_sharded(
            config, uniforms, scene._fused, scene._fused_static, None,
            make_mesh(*shape, ["cpu"] * (shape[0] * shape[1])))
        np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_segs.numpy(), segs.numpy(), rtol=1e-4, atol=1e-5)


def test_wavefront_tiles_bit_equal():
    """render_frame_sharded takes render_frame's arguments: two tiles are
    bit-equal to it on every AOV, two sample shards within tolerance."""
    config, uniforms, geom, table, lights, aovs, pool, accel = entry._build_cornell_state(
        16, 16, 2, 3, torch.device("cpu"))
    config = dataclasses.replace(config, aov_mask=config.aov_mask | aov_bit(AovId.OBJECT_ID)
                                 | aov_bit(AovId.DEPTH))
    n = 16 * 16
    aovs = dict(aovs, object_id=torch.full((n,), -1, dtype=torch.int32),
                depth=torch.zeros((n,), dtype=torch.float32))
    one = render_frame(config, uniforms, geom, table, lights, aovs, pool, accel)
    tiles = render_frame_sharded(config, uniforms, geom, table, lights, aovs, pool, accel,
                                 make_mesh(2, 1, ["cpu", "cpu"]))
    assert set(tiles) == set(one)
    for k in one:
        assert torch.equal(tiles[k], one[k]), k
    shards = render_frame_sharded(config, uniforms, geom, table, lights, aovs, pool, accel,
                                  make_mesh(1, 2, ["cpu", "cpu"]))
    np.testing.assert_allclose(shards["color"].numpy(), one["color"].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_merge_rules_per_field():
    """The spp merge (gatling_tpu/parallel/sharding.py:56-88): mean for
    colour and the accumulating channels, min for depth and the ids, max
    for bounces, any for the hit flag."""
    n = 5
    rng = np.random.default_rng(3)
    results = []
    for _ in range(3):
        f = empty_first_hit(n, "cpu")
        f = f._replace(**{name: torch.as_tensor(rng.random((n, 3), dtype=np.float32))
                          for name in ("normal", "albedo", "barycentrics", "texcoords",
                                       "tangents", "bitangents", "thin_walled",
                                       "double_sided", "opacity", "nee")})
        f = f._replace(depth=torch.as_tensor(rng.random(n, dtype=np.float32)),
                       object_id=torch.as_tensor(rng.integers(-1, 9, n, dtype=np.int32)),
                       face_id=torch.as_tensor(rng.integers(-1, 9, n, dtype=np.int32)),
                       instance_id=torch.as_tensor(rng.integers(-1, 9, n, dtype=np.int32)),
                       hit=torch.as_tensor(rng.random(n) < 0.3))
        results.append(SampleResult(torch.as_tensor(rng.random((n, 3), dtype=np.float32)),
                                    torch.as_tensor(rng.integers(0, 9, n, dtype=np.int32)), f))
    merged = _merge_spp_axis(results)
    stack = {name: torch.stack([getattr(r.first, name) for r in results])
             for name in results[0].first._fields}
    for name, s in stack.items():
        got = getattr(merged.first, name)
        if name in ("depth", "object_id", "face_id", "instance_id"):
            want = s.min(0).values
        elif name == "hit":
            want = s.any(0)
        else:
            want = s.sum(0) / 3.0
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, err_msg=name)
            continue
        assert torch.equal(got, want), name
        assert got.dtype == results[0].first._asdict()[name].dtype, name
    np.testing.assert_allclose(merged.color.numpy(),
                               torch.stack([r.color for r in results]).mean(0).numpy(), rtol=1e-6)
    assert torch.equal(merged.bounces, torch.stack([r.bounces for r in results]).max(0).values)
    assert _merge_spp_axis(results[:1]) is results[0]


def test_parallel_devices_clamps_on_cpu(caplog):
    """parallelDevices 2 on the CPU (one device slot) renders the frame of
    parallelDevices 1, bit for bit, and says it clamped."""
    img1, _ = cli.render_scene_file(CORNELL, 16, 16, {"spp": 2, "maxBounces": 2}, device="cpu")
    img2, scene = cli.render_scene_file(CORNELL, 16, 16,
                                        {"spp": 2, "maxBounces": 2, "parallelDevices": 2},
                                        device="cpu")
    np.testing.assert_array_equal(img2, img1)
    assert gi._parallel_devices({"parallelDevices": 2}, torch.device("cpu")) == 1
    assert gi._parallel_devices({"parallelDevices": 1}, torch.device("cpu")) == 1
    ids2, _ = cli.render_scene_file(CORNELL, 8, 8, {"spp": 1, "maxBounces": 1,
                                                    "parallelDevices": 2},
                                    AovId.OBJECT_ID, device="cpu")
    ids1, _ = cli.render_scene_file(CORNELL, 8, 8, {"spp": 1, "maxBounces": 1},
                                    AovId.OBJECT_ID, device="cpu")
    np.testing.assert_array_equal(ids2, ids1)  # the wavefront stays on one device


def test_mesh_and_to_device():
    with pytest.raises(ValueError):
        make_mesh(3, 1, ["cpu", "cpu"])
    mesh = make_mesh(None, 2, ["cpu"] * 4)
    assert mesh.shape == {"tiles": 2, "spp": 2}
    t = torch.ones(2)
    moved = to_device({"a": (t, [t]), "b": 3}, torch.device("cpu"))
    assert moved["a"][0] is t and moved["b"] == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh(2)  # CUDA devices by default


def test_entry_points_on_cpu():
    """entry(): one Cornell wavefront step, finite, with NORMAL and
    ALBEDO; dryrun_multidevice over 4 CPU slots (tiles x spp, and the fused
    route on a 2x2 mesh)."""
    fn, args = entry.entry("cpu")
    out = fn(*args)
    assert set(out) == {"color", "normal", "albedo"}
    assert out["color"].shape == (64 * 64, 4) and bool(torch.isfinite(out["color"]).all())
    assert float(out["color"][:, :3].max()) > 0.0
    entry.dryrun_multidevice(4, "cpu")
