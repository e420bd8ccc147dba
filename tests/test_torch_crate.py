"""Binary USD (crate) in the port: scene/crate.py against the JAX
package's, and the .usdc / .usdz entry points.

1. Reading: files written by the JAX writer (plain and adversarial:
   minimal-width delta codes, multi-chunk match-bearing lz4, compressed
   int and float arrays) read into the same prims, metadata, attrs, rels,
   connections and time samples through the port's reader as through
   JAX's, value for value (tolerance 0: the same NumPy decoding).
2. Writing: the port's writer emits the JAX writer's bytes, and its files
   read back through JAX's reader as through the port's.
3. The edge cases of tests/test_usdc.py: compressed ints, the float LUT,
   list-op flags, time samples, variants, a reference across a binary
   layer, a .usdz, garbage, and the truncation fuzz, where the port raises
   exactly where the JAX reader raises.
4. The pure-Python lz4 block decoder against the JAX one's (its own
   fallback) on match-bearing blocks, byte for byte.
5. chip_smoke.py's stage comparison (the .usdc read back against the
   parsed .usda within f32 rounding) finds a real difference.
"""

import os
import random
import struct
import zipfile

import numpy as np
import pytest

from gatling_tpu.scene import crate as J
from gatling_tpu.scene.usda import load_usd as jload_usd
from gatling_tpu.scene.usda import parse_usda as jparse_usda

from gatling_tpu_torch.scene import crate as C
from gatling_tpu_torch.scene.usda import load_usd, load_usda, parse_usda

from test_skel import SKEL_USDA
from test_torch_cuda import _chip_smoke
from test_usdc import ANIMATED, VARIANT_DOC

CORNELL = os.path.join(os.path.dirname(__file__), "data", "cornell.usda")
MTLX_FRAME = os.path.join(os.path.dirname(__file__), "graphical", "Materials.MtlxFrame",
                          "scene.usda")
TEXTS = {"cornell": open(CORNELL).read(), "skel": SKEL_USDA, "animated": ANIMATED,
         "variants": VARIANT_DOC, "mtlx_frame": open(MTLX_FRAME).read()}


def _canon(v):
    """A value as a comparable structure: arrays by dtype, shape and bytes,
    floats by repr, containers element by element."""
    if isinstance(v, np.ndarray):
        return ("nd", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [_canon(x) for x in v])
    if isinstance(v, dict):
        return ("dict", sorted((repr(k), _canon(x)) for k, x in v.items()))
    if isinstance(v, (float, np.floating)):
        return (type(v).__name__, repr(float(v)))
    return (type(v).__name__, repr(v))


def dump(stage) -> dict:
    """Every prim of a stage: type, metadata, rels and each attr's type,
    value, metadata, connection, uniform flag and time samples."""
    out = {"__meta__": _canon(stage.meta)}
    for p in stage.walk():
        out[p.path] = (p.type_name, _canon(p.meta), _canon(p.rels), sorted(p.children), {
            n: (a.type_name, _canon(a.value), _canon(a.meta), a.connect, a.uniform,
                _canon(a.time_samples)) for n, a in p.attrs.items()})
    return out


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_jax_written_files_read_the_same(name, adversarial):
    stage = jparse_usda(TEXTS[name], compose=False)
    data = J.write_usdc(stage, adversarial=adversarial)
    port, ref = C.read_usdc(data, path="mem"), J.read_usdc(data, path="mem")
    assert dump(port) == dump(ref)
    assert len(dump(port)) > 2


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_port_writer_matches_jax_writer(name, adversarial):
    """The port's writer on its own parse of the text: the JAX writer's
    bytes, and the JAX reader reads them as the port's reader does."""
    data = C.write_usdc(parse_usda(TEXTS[name], compose=False), adversarial=adversarial)
    assert data == J.write_usdc(jparse_usda(TEXTS[name], compose=False),
                                adversarial=adversarial)
    assert dump(C.read_usdc(data)) == dump(J.read_usdc(data))


def test_save_usdc_and_load_usd_compose(tmp_path):
    """save_usdc -> load_usd (composed) in both packages: the same stage,
    and the crate file's values are the text's within f32 rounding
    (tests/test_usdc.py test_crate_round_trip_structure)."""
    p = tmp_path / "cornell.usdc"
    C.save_usdc(load_usda(CORNELL), p)
    port = load_usd(str(p))
    assert dump(port) == dump(jload_usd(str(p)))
    diffs = _chip_smoke().stage_diffs(load_usda(CORNELL), port)
    assert diffs == [], diffs[:5]


def test_stage_diffs_finds_a_difference():
    cs = _chip_smoke()
    a, b = parse_usda(TEXTS["skel"]), parse_usda(TEXTS["skel"])
    assert cs.stage_diffs(a, b) == []
    b.find("/Root/Strip").attrs["points"].value[1] = (1.0 + 1e-5, 0.0, 0.0)
    b.find("/Root/Skel").rels["skel:animationSource"] = ["/Elsewhere"]
    del b.find("/Root/Strip").attrs["faceVertexCounts"].meta
    b.find("/Root/Strip").attrs["faceVertexCounts"].meta = {"elementSize": 2}
    diffs = cs.stage_diffs(a, b)
    assert len(diffs) == 3 and all("/Root/" in d for d in diffs), diffs


def test_usdz_package_and_reference_across_binary_layer(tmp_path):
    """A .usdz whose first layer is a .usdc, and a text layer referencing a
    binary one (tests/test_usdc.py test_usdz_package,
    test_reference_across_binary_layer)."""
    from gatling_tpu.scene.stage import load_scene as jload_scene
    from gatling_tpu_torch.scene.stage import load_scene

    inner = tmp_path / "cornell.usdc"
    C.save_usdc(load_usda(CORNELL), inner)
    z = tmp_path / "scene.usdz"
    with zipfile.ZipFile(z, "w", zipfile.ZIP_STORED) as zf:
        zf.write(inner, "cornell.usdc")
    desc = load_scene(str(z))
    assert len(desc.meshes) == len(jload_scene(str(z)).meshes) >= 5
    assert desc.first_camera() is not None
    lib = ('#usda 1.0\n(\n    defaultPrim = "Cube"\n)\ndef Mesh "Cube"\n{\n'
           "    point3f[] points = [(0,0,0), (1,0,0), (0,1,0)]\n"
           "    int[] faceVertexCounts = [3]\n    int[] faceVertexIndices = [0, 1, 2]\n}\n")
    C.save_usdc(parse_usda(lib, compose=False), tmp_path / "lib.usdc")
    (tmp_path / "main.usda").write_text('#usda 1.0\ndef "Instance" (\n'
                                        "    references = @./lib.usdc@\n)\n{\n}\n")
    sc = load_scene(tmp_path / "main.usda")
    assert len(sc.meshes) == 1 and sc.meshes[0].mesh.num_triangles == 1


def test_variants_in_crate(tmp_path):
    """The uncomposed variant document through the port's crate writer:
    load_usd composes the authored selection (red, radius 1)."""
    p = tmp_path / "var.usdc"
    C.save_usdc(parse_usda(VARIANT_DOC, compose=False), p)
    ball = load_usd(str(p)).find("/Root/Ball")
    np.testing.assert_allclose(np.asarray(ball.attrs["primvars:displayColor"].value,
                                          np.float64)[0], (1, 0, 0))
    assert float(ball.attrs["radius"].value) == 1.0
    assert dump(load_usd(str(p))) == dump(jload_usd(str(p)))


def test_compressed_int_array():
    """tests/test_usdc.py test_crate_compressed_int_arrays, through the
    port's writer pieces and reader."""
    w = C._CrateWriter()
    vals = list(range(100))
    enc = C._chunked_compress(C._encode_ints(np.asarray(vals, np.int64)))
    off = w._append(struct.pack("<Q", len(vals)) + struct.pack("<Q", len(enc)) + enc)
    rep = (C.T_INT << 48) | C._REP_ARRAY | C._REP_COMPRESSED | off
    w.spec("/", C.SPEC_PSEUDO_ROOT, {})
    w.spec("/P", C.SPEC_PRIM, {"typeName": w.rep("Mesh")})
    w.spec("/P.faceVertexIndices", C.SPEC_ATTRIBUTE,
           {"typeName": w.rep("int[]"), "default": rep})
    data = w.tobytes()
    assert C.read_usdc(data).find("/P").attrs["faceVertexIndices"].value == vals
    assert dump(C.read_usdc(data)) == dump(J.read_usdc(data))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("minimal", [False, True])
def test_integer_coding_matches_jax(wide, minimal):
    rng = np.random.default_rng(3)
    vals = np.cumsum(rng.integers(-300, 300, 777)) * (1 << 20 if wide else 1)
    enc = C._encode_ints(vals, wide=wide, minimal=minimal)
    assert enc == J._encode_ints(vals, wide=wide, minimal=minimal)
    np.testing.assert_array_equal(C._decode_ints(enc, len(vals), wide), vals)


def test_float_lut_and_integral():
    txt = ('#usda 1.0\ndef Mesh "M"\n{\n'
           "    float[] widths = [0.25, 0.5, 0.25, 0.5, 0.25, 0.5, 0.25, 0.25]\n"
           "    float[] counts = [1, 2, 3, 4, 5, 6, 7, 8]\n}\n")
    data = C.write_usdc(parse_usda(txt), adversarial=True)
    s = C.read_usdc(data)
    np.testing.assert_allclose(s.find("/M").attrs["widths"].value, [0.25, 0.5] * 3 + [0.25, 0.25])
    np.testing.assert_allclose(s.find("/M").attrs["counts"].value, [1, 2, 3, 4, 5, 6, 7, 8])
    assert dump(s) == dump(J.read_usdc(data))


def test_listop_deleted_ordered_flags():
    w = C._CrateWriter()
    payload = bytearray([2 | 32 | 64])
    payload += struct.pack("<Q", 2) + struct.pack("<I", w.token("a")) + struct.pack(
        "<I", w.token("b"))
    payload += struct.pack("<Q", 1) + struct.pack("<I", w.token("c"))
    payload += struct.pack("<Q", 1) + struct.pack("<I", w.token("a"))
    rep = (C.T_TOKEN_LISTOP << 48) | w._append(bytes(payload))
    w.spec("/", C.SPEC_PSEUDO_ROOT, {})
    w.spec("/P", C.SPEC_PRIM, {"typeName": w.rep("Scope"), "apiSchemas": rep})
    data = w.tobytes()
    assert C.read_usdc(data).find("/P").meta["apiSchemas"] == ["a", "b"]
    assert dump(C.read_usdc(data)) == dump(J.read_usdc(data))


def test_time_samples_resolve():
    from gatling_tpu_torch.scene.usda import resolve_frame

    s = C.read_usdc(C.write_usdc(parse_usda(ANIMATED), adversarial=True), path="adv-ts")
    a = s.find("/Root/Tri").attrs["points"]
    assert sorted(a.time_samples) == [1.0, 10.0]
    resolve_frame(s, 10)
    np.testing.assert_allclose(np.asarray(a.value, np.float64)[1], (2, 0, 0), atol=1e-6)


def _outcome(read, data):
    try:
        return ("ok", dump(read(data)))
    except Exception as e:  # noqa: BLE001 (the JAX reader's own exceptions)
        return ("raised", type(e).__name__, str(e))


def test_truncation_fuzz_raises_as_jax():
    """Every truncation of tests/test_usdc.py test_truncation_fuzz's file:
    the port raises the JAX reader's exception with its message, or reads
    the stage JAX reads."""
    s = parse_usda('#usda 1.0\ndef Mesh "M"\n{\n'
                   "    point3f[] points = [(0,0,0), (1,0,0), (0,1,0)]\n"
                   "    int[] faceVertexCounts = [3]\n    int[] faceVertexIndices = [0, 1, 2]\n}\n")
    data = C.write_usdc(s, adversarial=True)
    raised = 0
    for cut in list(range(0, 200, 7)) + list(range(200, len(data), max(1, len(data) // 40))):
        got, want = _outcome(C.read_usdc, data[:cut]), _outcome(J.read_usdc, data[:cut])
        assert got == want, cut
        raised += got[0] == "raised"
    assert raised > 10
    with pytest.raises(ValueError):
        C.read_usdc(b"NOT-USDC" + b"\0" * 100)


def test_lz4_block_decoder_matches_jax(monkeypatch):
    """Match-bearing and literal-only blocks through the port's decoder and
    the JAX package's pure-Python one (its native decoder disabled)."""
    import gatling_tpu.native as gn

    monkeypatch.setattr(gn, "native_lz4_decompress", lambda *a: None)
    rng = random.Random(11)
    for n in (0, 5, 15, 16, 300, 70_000):
        src = bytes(rng.choice(b"abcab\x00\x01") for _ in range(n))
        for comp in (C.lz4_compress_block, C.lz4_compress_block_matches):
            block = comp(src)
            assert block == (J.lz4_compress_block if comp is C.lz4_compress_block
                             else J.lz4_compress_block_matches)(src)
            assert C.lz4_decompress_block(block, n) == src == J.lz4_decompress_block(block, n)
    chunked = C._chunked_compress(bytes(range(256)) * 300, chunk_size=4096, matches=True)
    assert C._chunked_decompress(chunked, 256 * 300) == bytes(range(256)) * 300


def test_property_fuzz_port_writer_jax_reader():
    """tests/test_usdc.py test_crate_roundtrip_property_fuzz's random typed
    values through the port's writer: the JAX reader and the port's read
    the same stage (40 trials, plain and adversarial layouts)."""
    from gatling_tpu_torch.scene.usda import Attr, Prim, Stage

    rng = random.Random(7)

    def value():
        kind = rng.choice(["int", "float", "str", "bool", "vec3", "mat4", "int_arr",
                           "float_arr", "vec3_arr", "tok_arr"])
        n = rng.randint(1, 9)
        return {"int": lambda: rng.randint(-2 ** 30, 2 ** 30),
                "float": lambda: round(rng.uniform(-1e3, 1e3), 4),
                "str": lambda: "tok%d" % rng.randint(0, 99), "bool": lambda: rng.random() < 0.5,
                "vec3": lambda: tuple(round(rng.uniform(-9, 9), 3) for _ in range(3)),
                "mat4": lambda: tuple(tuple(round(rng.uniform(-9, 9), 3) for _ in range(4))
                                      for _ in range(4)),
                "int_arr": lambda: [rng.randint(-1000, 1000) for _ in range(n)],
                "float_arr": lambda: [round(rng.uniform(-99, 99), 3) for _ in range(n)],
                "vec3_arr": lambda: [tuple(round(rng.uniform(-9, 9), 3) for _ in range(3))
                                     for _ in range(n)],
                "tok_arr": lambda: ["t%d" % rng.randint(0, 50) for _ in range(n)]}[kind]()

    for trial in range(40):
        root = Prim(name="", type_name="", path="")
        stage = Stage(root=root, meta={})
        p = Prim(name="P", type_name="Xform", path="/P")
        root.children["P"] = p
        for i in range(rng.randint(1, 6)):
            a = Attr(type_name="float", value=value())
            if rng.random() < 0.3:
                a.time_samples = {1.0: a.value, 2.0: value()}
            p.attrs[f"a{i}"] = a
        if rng.random() < 0.5:
            p.rels["relx"] = ["/P"]
        data = C.write_usdc(stage, adversarial=trial % 2 == 1)
        assert dump(C.read_usdc(data)) == dump(J.read_usdc(data)), trial
