"""The port's native host library (gatling_tpu_torch/native.py over
csrc/gatling_native.cpp, built into build/torch_ext/) against the JAX
package's (gatling_tpu/native.py over native/gatling_native.cpp) and
against the port's own NumPy twins:

1. `ops/bvh.py build_bvh` (gatling_build_bvh) against the JAX
   `build_bvh` and against `build_bvh_ref`, array for array, on random
   soups, a soup with degenerate triangles and a grid;
2. `scene/crate.py lz4_decompress_block` (gatling_lz4_decompress) against
   the JAX decoder and the pure-Python twin, byte for byte, on literal and
   match-bearing blocks; a malformed block raises the JAX reader's error;
3. `scene/meshproc.py compress_mesh` (gatling_compress) against the JAX
   `compress_mesh`, blob for blob, and the NumPy + zlib twin; the round
   trip through `decompress_mesh`;
4. a source that does not compile raises with the compiler's output.
"""

import random

import numpy as np
import pytest

from gatling_tpu.ops import bvh as jbvh
from gatling_tpu.scene import crate as jcrate
from gatling_tpu.scene import meshproc as jmesh

from gatling_tpu_torch import native
from gatling_tpu_torch.ops import bvh as tbvh
from gatling_tpu_torch.scene import crate as tcrate
from gatling_tpu_torch.scene import meshproc as tmesh


def _soup(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "grid":  # coincident centroids along rows: ties in the Morton sort
        g = np.stack(np.meshgrid(np.arange(40), np.arange(30)), -1).reshape(-1, 2)
        v0 = np.concatenate([g, np.zeros((len(g), 1))], 1).astype(np.float32)
        e1 = np.tile(np.float32([1, 0, 0]), (len(g), 1))
        e2 = np.tile(np.float32([0, 1, 0]), (len(g), 1))
        return v0, e1, e2
    n = {"small": 3, "random": 5000, "large": 40000, "degenerate": 700}[kind]
    v0 = rng.normal(size=(n, 3)).astype(np.float32) * 10
    e1 = rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    e2 = rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    if kind == "degenerate":  # zero-area padding triangles at the origin
        v0[::3] = e1[::3] = e2[::3] = 0.0
    return v0, e1, e2


@pytest.mark.parametrize("kind", ["small", "random", "large", "degenerate", "grid"])
@pytest.mark.parametrize("leaf", [1, 4])
def test_build_bvh_matches_jax_and_twin(kind, leaf):
    soup = _soup(kind, len(kind) + leaf)
    got, order = tbvh.build_bvh(*soup, leaf_size=leaf)
    twin, twin_order = tbvh.build_bvh_ref(*soup, leaf_size=leaf)
    jarrays, jorder = jbvh.build_bvh(*soup, leaf_size=leaf)
    np.testing.assert_array_equal(order, twin_order)
    np.testing.assert_array_equal(order, np.asarray(jorder))
    assert order.dtype == twin_order.dtype == np.int64
    for name in tbvh.BvhArrays._fields:
        a, b, c = getattr(got, name), getattr(twin, name), np.asarray(getattr(jarrays, name))
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape == c.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, c, err_msg=name)


def _blocks():
    rng = random.Random(11)
    for n in (1, 5, 15, 16, 300, 70_000):
        src = bytes(rng.choice(b"abcab\x00\x01") for _ in range(n))
        yield src, tcrate.lz4_compress_block_matches(src)
        yield src, tcrate.lz4_compress_block(src)


def test_lz4_matches_jax_and_twin():
    for src, block in _blocks():
        got = tcrate.lz4_decompress_block(block, len(src))
        assert got == src == tcrate.lz4_decompress_block_ref(block, len(src))
        assert got == jcrate.lz4_decompress_block(block, len(src))
        assert native.lz4_decompress(block, len(src)) == src
    assert tcrate.lz4_decompress_block(b"", 10) == b"" == jcrate.lz4_decompress_block(b"", 10)


@pytest.mark.parametrize("cut", [1, 2, 3, 7, 20])
def test_lz4_malformed_block_raises_as_jax(cut):
    """A block cut short, or asked for fewer bytes than it holds: the native
    decoder rejects it and the twin raises what the JAX reader raises."""
    src = bytes(range(50)) * 20
    block = tcrate.lz4_compress_block_matches(src)
    for data, size in ((block[:cut], len(src)), (block, len(src) // cut)):
        outcome = []
        for fn in (tcrate.lz4_decompress_block, jcrate.lz4_decompress_block):
            try:
                outcome.append(("ok", fn(data, size)))
            except Exception as e:  # noqa: BLE001 - compared between the packages
                outcome.append((type(e).__name__, str(e)))
        assert outcome[0] == outcome[1]


def _mesh(seed: int):
    rng = np.random.default_rng(seed)
    n = 400
    kw = dict(positions=rng.normal(size=(3 * n, 3)).astype(np.float32),
              normals=rng.normal(size=(3 * n, 3)).astype(np.float32),
              tangents=rng.normal(size=(3 * n, 3)).astype(np.float32),
              bitangent_signs=np.sign(rng.normal(size=3 * n)).astype(np.float32),
              uvs=rng.uniform(size=(3 * n, 2)).astype(np.float32),
              face_ids=np.arange(n, dtype=np.int32), colors=None)
    return tmesh.TriangulatedMesh(**kw), jmesh.TriangulatedMesh(**kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_mesh_matches_jax(seed):
    """compress_mesh's blobs equal the JAX package's and, buffer for
    buffer, the NumPy + zlib twin's; both decompressors invert them."""
    tm, jm = _mesh(seed)
    got, want = tmesh.compress_mesh(tm), jmesh.compress_mesh(jm)
    assert got.blobs.keys() == want.blobs.keys()
    for name, a in got.blobs.items():
        b = want.blobs[name]
        if a is None:
            assert b is None
            continue
        assert a[1:] == b[1:], name
        if not a[3]:
            np.testing.assert_array_equal(a[0], b[0])
            continue
        raw = np.ascontiguousarray(getattr(tm, name)).view(np.uint8).reshape(-1)
        elem = a[2].itemsize
        assert a[0] == bytes(b[0]) == tmesh.compress_ref(raw, elem), name
        np.testing.assert_array_equal(native.decompress(a[0], raw.size, elem), raw)
        np.testing.assert_array_equal(tmesh.decompress_ref(a[0], raw.size, elem), raw)
    back = tmesh.decompress_mesh(got)
    for name in ("positions", "normals", "uvs", "face_ids"):
        np.testing.assert_array_equal(getattr(back, name), getattr(tm, name))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int gatling_broken( { return 0; }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on .*broken.cpp"):
        native.library()
    assert not list((tmp_path / "build").glob("*.so"))
