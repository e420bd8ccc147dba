"""Accumulation checkpoints of the port (gi.giSaveCheckpoint /
giLoadCheckpoint, cli --checkpoint) against the JAX package's format
(gatling_tpu/gi.py:1162-1194) on the CPU: a file either package writes
loads into the other, a resumed render is bit-equal to an uninterrupted
one, a size mismatch resets and logs, and the CLI run twice with a
checkpoint gives the two-frame accumulation."""


import jax.numpy as jnp
import numpy as np
import torch

import gatling_tpu.gi as jgi
from gatling_tpu_torch import cli, gi
from gatling_tpu_torch.interface import AovId
from gatling_tpu_torch.utils.log import get_logger

CORNELL = "tests/data/cornell.usda"
RES = 16
SETTINGS = {"spp": 8, "maxBounces": 3}


def _state(rng, n):
    return {"color": rng.random((n, 4), dtype=np.float32),
            "normal": rng.random((n, 3), dtype=np.float32),
            "depth": rng.random((n,), dtype=np.float32),
            "object_id": rng.integers(-1, 8, (n,), dtype=np.int32)}


def _check_loaded(aovs: dict, want: dict) -> None:
    assert set(aovs) == set(want)
    for k, v in want.items():
        got = np.asarray(aovs[k].cpu() if isinstance(aovs[k], torch.Tensor) else aovs[k])
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, k)


def test_checkpoints_cross_packages(tmp_path):
    """The JAX package's file loads into the port with equal arrays,
    dtypes and offset, on the scene's device; the port's file loads into
    the JAX package the same way."""
    rng = np.random.default_rng(17)
    want = _state(rng, 12 * 10)
    theirs = jgi.create_scene()
    theirs._aov_state = {k: jnp.asarray(v) for k, v in want.items()}
    theirs._fb_shape, theirs.sample_offset = (12, 10), 24
    jgi.giSaveCheckpoint(theirs, str(tmp_path / "jax.npz"))
    ours = gi.create_scene("cpu")
    assert gi.giLoadCheckpoint(ours, str(tmp_path / "jax.npz")) == 24
    assert ours._fb_shape == (12, 10) and ours.sample_offset == 24
    assert all(v.device == ours.device for v in ours._aov_state.values())
    _check_loaded(ours._aov_state, want)

    want = _state(rng, 9 * 7)
    ours = gi.create_scene("cpu")
    ours._aov_state = {k: torch.as_tensor(v) for k, v in want.items()}
    ours._fb_shape, ours.sample_offset = (9, 7), 40
    gi.giSaveCheckpoint(ours, str(tmp_path / "port.npz"))
    theirs = jgi.create_scene()
    assert jgi.giLoadCheckpoint(theirs, str(tmp_path / "port.npz")) == 40
    assert theirs._fb_shape == (9, 7)
    _check_loaded(theirs._aov_state, want)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert {k: a[k].dtype for k in ("__sample_offset__", "__fb_shape__")} == \
            {k: b[k].dtype for k in ("__sample_offset__", "__fb_shape__")}


def _params(scene, desc, bindings):
    return gi.GiRenderParams(scene=scene, camera=desc.first_camera(), aov_bindings=bindings,
                             render_settings=dict(SETTINGS))


def _bindings():
    return [gi.GiAovBinding(AovId.COLOR, gi.GiRenderBuffer(RES, RES, 4))]


def test_resume_is_bit_equal(tmp_path):
    """8 spp, save, load into a fresh scene, 8 more: the 8 + 8 frame of
    one scene, bit for bit."""
    scene, desc, _ = cli.load_gi_scene(CORNELL, "cpu")
    one = _bindings()
    gi.render(_params(scene, desc, one))
    gi.giSaveCheckpoint(scene, str(tmp_path / "c.npz"))
    gi.render(_params(scene, desc, one))
    assert scene.sample_offset == 16

    fresh, desc2, _ = cli.load_gi_scene(CORNELL, "cpu")
    assert gi.giLoadCheckpoint(fresh, str(tmp_path / "c.npz")) == 8
    two = _bindings()
    gi.render(_params(fresh, desc2, two))
    assert fresh.sample_offset == 16
    np.testing.assert_array_equal(two[0].render_buffer.data, one[0].render_buffer.data)


def test_size_mismatch_resets_and_logs(tmp_path, caplog):
    scene, desc, _ = cli.load_gi_scene(CORNELL, "cpu")
    gi.render(_params(scene, desc, _bindings()))
    gi.giSaveCheckpoint(scene, str(tmp_path / "c.npz"))
    fresh, desc2, _ = cli.load_gi_scene(CORNELL, "cpu")
    gi.giLoadCheckpoint(fresh, str(tmp_path / "c.npz"))
    other = [gi.GiAovBinding(AovId.COLOR, gi.GiRenderBuffer(RES, RES // 2, 4))]
    logger = get_logger()
    logger.addHandler(caplog.handler)
    try:
        gi.render(_params(fresh, desc2, other))
    finally:
        logger.removeHandler(caplog.handler)
    assert fresh.sample_offset == 8 and fresh._fb_shape == (RES, RES // 2)
    assert any("does not match the framebuffer" in r.getMessage() for r in caplog.records)
    assert not fresh._restored_checkpoint


def test_cli_checkpoint_twice(tmp_path):
    """`--checkpoint` twice: the second run resumes the first's file and
    gives the 8 + 8 frame; the file holds sampleOffset 16."""
    path = str(tmp_path / "cli.npz")
    out = str(tmp_path / "out.exr")
    argv = [CORNELL, out, "--device", "cpu", "--image-width", str(RES), "--image-height",
            str(RES), "--spp", "8", "--max-bounces", "3", "--checkpoint", path]
    assert cli.main(argv) == 0
    img, scene = cli.render_scene_file(CORNELL, RES, RES, SETTINGS, device="cpu",
                                       checkpoint=path)
    assert scene.sample_offset == 16
    with np.load(path) as data:
        assert int(data["__sample_offset__"]) == 16

    ref_scene, desc, _ = cli.load_gi_scene(CORNELL, "cpu", dict(SETTINGS))
    one = [gi.GiAovBinding(AovId.COLOR, gi.GiRenderBuffer(RES, RES, 4))]
    params = gi.GiRenderParams(scene=ref_scene, camera=desc.first_camera(), aov_bindings=one,
                               render_settings=cli.load_gi_scene(CORNELL, "cpu",
                                                                 dict(SETTINGS))[2])
    gi.render(params)
    gi.render(params)
    np.testing.assert_array_equal(img, one[0].render_buffer.data)
