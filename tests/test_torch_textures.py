"""The port's textures against the JAX package's.

1. The PNG decoder (gatling_tpu_torch/imgio) against gatling_tpu.imgio.
   load_image, which decodes through Pillow: every 8-bit colour type
   (grey, grey + alpha, RGB, RGBA, palette with and without tRNS), every
   row filter, the interior's own files: pixel for pixel.
2. Material lowering and `build_materials` on the interior's materials and
   on UsdUVTexture networks with scale, bias, channels, wrap modes, colour
   spaces and the affine graph folds: packed_f, packed_i and every
   TexturePool array bit-equal to JAX's.
3. `sample_pool`, `perturb_normal`, `apply_textures` and
   `substitute_texture_means` against JAX's on the same pools: within
   1e-6 (XLA's and PyTorch's x ** 2.4 differ in the last bits, and the
   bilinear weights carry them); the means bit-equal.
"""

import io
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gatling_tpu import imgio as jimgio
from gatling_tpu.render import material as jmat
from gatling_tpu.render import texture as jtex
from gatling_tpu.scene import examples as jex
from gatling_tpu.scene import stage as jstage

from gatling_tpu_torch import imgio as timgio
from gatling_tpu_torch.render import material as tmat
from gatling_tpu_torch.render import texture as ttex
from gatling_tpu_torch.scene import examples as tex
from gatling_tpu_torch.scene import stage as tstage

ATOL = 1e-6


def _pil_png(arr: np.ndarray, mode: str, **save) -> bytes:
    buf = io.BytesIO()
    img = Image.fromarray(arr, mode)
    if mode == "P":
        img.putpalette(list(np.random.default_rng(1).integers(0, 256, 768)))
    img.save(buf, "PNG", **save)
    return buf.getvalue()


def _filtered_png(rgba: np.ndarray, filters) -> bytes:
    """An 8-bit RGBA PNG whose row r uses filter filters[r % len]: a test
    encoder, so that every filter type is exercised whatever Pillow picks."""
    h, w, _ = rgba.shape
    img = rgba.astype(np.int32)
    rows = []
    for r in range(h):
        x = img[r].reshape(-1)
        prior = img[r - 1].reshape(-1) if r else np.zeros_like(x)
        a = np.concatenate([np.zeros(4, np.int32), x[:-4]])
        c = np.concatenate([np.zeros(4, np.int32), prior[:-4]])
        ft = filters[r % len(filters)]
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (a + prior) >> 1
        else:
            pa, pb, pc = np.abs(prior - c), np.abs(a - c), np.abs(a + prior - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
        rows.append(bytes([ft]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode,save", [("L", {}), ("LA", {}), ("RGB", {}), ("RGBA", {}),
                                       ("RGB", {"transparency": (1, 2, 3)}), ("P", {}),
                                       ("P", {"transparency": bytes(range(0, 250, 3))})])
def test_png_decoder_matches_pillow(mode, save):
    rng = np.random.default_rng(len(mode) + len(save))
    shape = {"L": (23, 31), "P": (23, 31), "LA": (23, 31, 2), "RGB": (23, 31, 3),
             "RGBA": (23, 31, 4)}[mode]
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    arr[:8] = (np.arange(shape[1]) * 7 % 256).astype(np.uint8).reshape(
        (1, -1) + (1,) * (len(shape) - 2))  # smooth rows: Pillow filters them
    data = _pil_png(arr, mode, **save)
    assert data[24] == 8  # 8-bit
    ref = jimgio.load_image(data)
    got = timgio.load_image(data)
    np.testing.assert_array_equal(got, ref.data)
    np.testing.assert_array_equal(got.astype(np.float32) / 255.0, ref.as_float_rgba())


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
def test_png_decoder_row_filters(filters):
    rng = np.random.default_rng(sum(filters))
    rgba = rng.integers(0, 256, (17, 29, 4), dtype=np.uint8)
    data = _filtered_png(rgba, filters)
    np.testing.assert_array_equal(jimgio.load_image(data).data, rgba)  # the encoder is right
    np.testing.assert_array_equal(timgio.load_image(data), rgba)


def test_png_writer_rgba_and_unsupported_inputs(tmp_path):
    rgba = np.random.default_rng(5).integers(0, 256, (6, 9, 4), dtype=np.uint8)
    path = tmp_path / "a.png"
    timgio.write_image_file(path, rgba)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), rgba)
    np.testing.assert_array_equal(timgio.load_image_file(path), rgba)
    buf = io.BytesIO()
    Image.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4) * 5000).save(buf, "PNG")
    grey16 = buf.getvalue()
    assert grey16[24] == 16
    got = timgio.load_image(grey16)  # float code / 65535, as Pillow's "I;16" array over 65535
    assert got.dtype == np.float32 and timgio.is_hdr(got)
    np.testing.assert_array_equal(got, jimgio.load_image(grey16).data)
    with pytest.raises(ValueError):  # a Radiance HDR header without its resolution line
        timgio.load_image(b"#?RADIANCE\n")
    jpeg = io.BytesIO()
    Image.fromarray(rgba[..., :3]).save(jpeg, "JPEG")
    np.testing.assert_array_equal(timgio.load_image(jpeg.getvalue()),
                                  jimgio.load_image(jpeg.getvalue()).data)
    sgi = io.BytesIO()  # SGI, which the port has come to read
    Image.fromarray(rgba[..., :3]).save(sgi, "SGI")
    np.testing.assert_array_equal(timgio.load_image(sgi.getvalue()),
                                  jimgio.load_image(sgi.getvalue()).data)
    avif = io.BytesIO()  # a format of Pillow's that the port does not read
    Image.fromarray(rgba[..., :3]).save(avif, "AVIF")
    with pytest.raises(NotImplementedError, match="USD content"):
        timgio.load_image(avif.getvalue())
    for fmt in ("BMP", "WEBP"):  # read since the port ported BMP, then WebP
        buf = io.BytesIO()
        Image.fromarray(rgba[..., :3]).save(buf, fmt)
        np.testing.assert_array_equal(timgio.load_image(buf.getvalue()),
                                      jimgio.load_image(buf.getvalue()).data)


@pytest.fixture(scope="module")
def interior_pair(tmp_path_factory):
    """The interior of both packages, each writing its own texture files
    (the JAX package through Pillow, the port through its own writer)."""
    jdir, tdir = tmp_path_factory.mktemp("jax_tex"), tmp_path_factory.mktemp("port_tex")
    return jex.interior(detail=1, tex_dir=str(jdir)), tex.interior(detail=1, tex_dir=str(tdir))


def test_interior_matches_jax(interior_pair):
    """Same meshes from the same seeds, and the same texture pixels."""
    jdesc, tdesc = interior_pair
    assert [m.path for m in jdesc.meshes] == [m.path for m in tdesc.meshes]
    for jm, tm in zip(jdesc.meshes, tdesc.meshes):
        for field in ("positions", "normals", "uvs", "tangents", "bitangent_signs"):
            np.testing.assert_array_equal(getattr(tm.mesh, field), getattr(jm.mesh, field))
        for field in ("transform", "instance_transforms"):
            np.testing.assert_array_equal(getattr(tm, field), getattr(jm, field))
    for path, jmd in jdesc.materials.items():
        jfile = jmd.nodes[path + "/tex"].inputs["file"]
        tfile = tdesc.materials[path].nodes[path + "/tex"].inputs["file"]
        with open(jfile, "rb") as f:
            ref = jimgio.load_image(f.read()).data
        np.testing.assert_array_equal(timgio.load_image_file(tfile), ref)
        np.testing.assert_array_equal(timgio.load_image_file(jfile), ref)


def _lowered(lib_mat, desc, paths):
    return [lib_mat.lower_material(desc.materials.get(p) if p else None) for p in paths]


def _check_tables(jt, jp, tt, tp):
    """Port (table, pool) against JAX's, bit for bit."""
    np.testing.assert_array_equal(tt.packed_f, np.asarray(jt.packed_f))
    np.testing.assert_array_equal(tt.packed_i, np.asarray(jt.packed_i))
    assert tp.packed == jp.packed and tp.bilinear_packed == jp.bilinear_packed
    np.testing.assert_array_equal(tp.texels_u32.numpy().view(np.uint32),
                                  np.asarray(jp.texels_u32))
    np.testing.assert_array_equal(tp.texels_q22.numpy().view(np.uint32),
                                  np.asarray(jp.texels_q22))
    for name in ("is_srgb", "offset", "width", "height", "wrap_s", "wrap_t", "scale", "bias",
                 "mean"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)


def test_build_materials_interior_matches_jax(interior_pair):
    jdesc, tdesc = interior_pair
    paths = sorted(jdesc.materials) + [None]
    jt, jp = jmat.build_materials(_lowered(jmat, jdesc, paths))
    tt, tp = tmat.build_materials(_lowered(tmat, tdesc, paths))
    _check_tables(jt, jp, tt, tp)
    assert tp.count == 6 and tmat.textured_params(_lowered(tmat, tdesc, paths)) == (
        "base_color",)
    jm = jmat.substitute_texture_means(jt, jp)
    tm = tmat.substitute_texture_means(tt, tp)
    np.testing.assert_array_equal(tm.packed_f, np.asarray(jm.packed_f))


def _network(lib, path, inputs, connections, nodes):
    """A MaterialDesc of `lib` from a dict of extra nodes {name: (id, inputs,
    connections)} and the surface's inputs and connections."""
    built = {f"{path}/s": lib.ShaderNode(path=f"{path}/s", shader_id="UsdPreviewSurface",
                                         inputs=dict(inputs), input_connections={
                                             k: (f"{path}/{n}", o)
                                             for k, (n, o) in connections.items()})}
    for name, (sid, ins, conns) in nodes.items():
        built[f"{path}/{name}"] = lib.ShaderNode(
            path=f"{path}/{name}", shader_id=sid, inputs=dict(ins),
            input_connections={k: (f"{path}/{n}", o) for k, (n, o) in conns.items()})
    return lib.MaterialDesc(path=path, surface_node=f"{path}/s", nodes=built)


def _networks(files):
    """UsdUVTexture networks: colour spaces, wraps, scale and bias, the
    r/g/b/a outputs, and the affine folds over a texture."""
    a, b, n = files
    tx = lambda f, **kw: ("UsdUVTexture", dict(file=f, **kw), {})  # noqa: E731
    return {
        "/srgb_auto": ({}, {"diffuseColor": ("t", "rgb")}, {"t": tx(a)}),
        "/raw_clamp": ({}, {"diffuseColor": ("t", "rgb")},
                       {"t": tx(a, sourceColorSpace="raw", wrapS="clamp", wrapT="mirror")}),
        "/srgb_black": ({}, {"emissiveColor": ("t", "rgb")},
                        {"t": tx(b, sourceColorSpace="sRGB", wrapS="black",
                                 scale=(0.5, 0.6, 0.7, 1.0), bias=(0.1, 0.0, 0.2, 0.0))}),
        "/orm": ({}, {"metallic": ("t", "b"), "roughness": ("t", "g")},
                 {"t": tx(b, sourceColorSpace="raw")}),
        "/alpha_rough": ({}, {"roughness": ("t", "a")}, {"t": tx(a)}),
        "/folds": ({"metallic": 0.3}, {"diffuseColor": ("mix", "out"),
                                       "emissiveColor": ("sub", "out")},
                   {"t": tx(a, sourceColorSpace="raw"),
                    "mul": ("ND_multiply_color3", {"in2": (0.5, 0.8, 1.0)}, {"in1": ("t", "rgb")}),
                    "add": ("add", {"in2": (0.1, 0.1, 0.0)}, {"in1": ("mul", "out")}),
                    "mix": ("mix", {"bg": (0.2, 0.3, 0.4), "mix": 0.75}, {"fg": ("add", "out")}),
                    "cst": ("constant", {"value": (0.9, 0.8, 0.7)}, {}),
                    "div": ("divide", {"in2": 2.0}, {"in1": ("t", "rgb")}),
                    "sub": ("subtract", {}, {"in1": ("cst", "out"), "in2": ("div", "out")})}),
        "/swizzle": ({}, {"roughness": ("sw", "out"), "diffuseColor": ("cv", "out")},
                     {"t": tx(b), "sw": ("swizzle", {"channels": "r"}, {"in": ("t", "rgb")}),
                      "cv": ("convert", {}, {"in": ("t", "rgb")})}),
        "/normal_default": ({}, {"normal": ("t", "rgb"), "diffuseColor": ("t2", "rgb")},
                            {"t": tx(n, sourceColorSpace="raw"), "t2": tx(b)}),
        "/normalmap_node": ({}, {"normal": ("nm", "out")},
                            {"t": tx(n, sourceColorSpace="raw"),
                             "nm": ("normalmap", {}, {"in": ("t", "rgb")})}),
        "/clamp_const": ({}, {"roughness": ("cl", "out")},
                         {"cl": ("clamp", {"in": 1.7, "high": 0.9}, {})}),
        "/missing": ({}, {"diffuseColor": ("t", "rgb")}, {"t": tx("does_not_exist.png")}),
    }


@pytest.fixture(scope="module")
def texture_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tex")
    rng = np.random.default_rng(9)
    files = []
    for name, shape in (("a", (7, 5, 4)), ("b", (4, 6, 4)), ("n", (3, 3, 4))):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        files.append(str(d / f"{name}.png"))
        Image.fromarray(img, "RGBA").save(files[-1])
    return files


def test_build_materials_networks_match_jax(texture_files):
    nets = _networks(texture_files)
    jrows = [jmat.lower_material(_network(jstage, p, *spec)) for p, spec in nets.items()]
    trows = [tmat.lower_material(_network(tstage, p, *spec)) for p, spec in nets.items()]
    for jr, tr in zip(jrows, trows):
        assert set(tr.textures) == set(jr.textures)
        for k, ref in tr.textures.items():
            jref = jr.textures[k]
            assert (ref.file_path, ref.is_srgb, ref.wrap_s, ref.wrap_t, ref.scale, ref.bias,
                    ref.channel) == (jref.file_path, jref.is_srgb, jref.wrap_s, jref.wrap_t,
                                     jref.scale, jref.bias, jref.channel)
    jt, jp = jmat.build_materials(jrows)
    tt, tp = tmat.build_materials(trows)
    _check_tables(jt, jp, tt, tp)
    assert not tp.bilinear_packed  # clamp/mirror/black slots: the per-tap path
    assert tmat.textured_params(trows) == jmat.textured_params(jrows)


@pytest.mark.parametrize("what", ["two_textures", "viewdirection", "primvar", "noise"])
def test_graphs_beyond_one_affine_texture_raise(texture_files, what):
    a, b, _n = texture_files
    tx = lambda f: ("UsdUVTexture", dict(file=f), {})  # noqa: E731
    nodes = {
        "two_textures": {"ta": tx(a), "tb": tx(b),
                         "out": ("multiply", {}, {"in1": ("ta", "rgb"), "in2": ("tb", "rgb")})},
        "viewdirection": {"out": ("viewdirection", {}, {})},
        "primvar": {"out": ("UsdPrimvarReader_float3", {"varname": "displayColor"}, {})},
        "noise": {"out": ("noise2d", {}, {})},
    }[what]
    # (The name dates from when these raised; it is kept so that the
    # test's record runs on.)
    row = tmat.lower_material(_network(tstage, "/m", {}, {"diffuseColor": ("out", "out")},
                                       nodes))
    jrow = jmat.lower_material(_network(jstage, "/m", {}, {"diffuseColor": ("out", "out")},
                                        nodes))
    if what in ("viewdirection", "primvar"):
        # a view- or primvar-dependent input lowers to the per-hit
        # expression the wavefront evaluates, as the JAX package's does
        assert row.dynamic["base_color"].op == {"viewdirection": "viewdir"}.get(what, what)
        assert set(row.dynamic) == set(jrow.dynamic) == {"base_color"}
        return
    # a static composite (two textures in one node, a procedural generator)
    # bakes into a pool slot of its own, as the JAX package's does: the
    # tables and the pool bit for bit
    ref = row.textures["base_color"]
    assert ref.file_path.startswith("baked://") and ref.bake.op == {
        "two_textures": "multiply"}.get(what, "noise2d")
    assert not row.dynamic and not jrow.dynamic
    _check_tables(*jmat.build_materials([jrow]), *tmat.build_materials([row]))


def _pools(texture_files, wrap_s, wrap_t, srgb):
    ref = jtex.TextureRef(file_path=texture_files[0], is_srgb=srgb, wrap_s=wrap_s, wrap_t=wrap_t,
                          scale=(0.9, 1.1, 1.0, 0.5), bias=(0.05, 0.0, -0.1, 0.2))
    port_ref = ttex.TextureRef(file_path=ref.file_path, is_srgb=srgb, wrap_s=wrap_s,
                               wrap_t=wrap_t, scale=ref.scale, bias=ref.bias)
    other = [jtex.TextureRef(file_path=texture_files[1]),
             ttex.TextureRef(file_path=texture_files[1])]
    return (jtex.TextureManager().build_pool([other[0], ref]),
            ttex.TextureManager().build_pool([other[1], port_ref]))


@pytest.mark.parametrize("wrap,srgb", [("repeat", True), ("repeat", False), ("clamp", True),
                                       ("mirror", False), ("black", True)])
def test_sample_pool_matches_jax(texture_files, wrap, srgb):
    """Random uv over [-2.3, 3.1] (every wrap branch) on slot 1; the
    repeat pools take the 2x2-neighbourhood path, the others the per-tap
    path; negative slot ids read slot 0."""
    jp, tp = _pools(texture_files, wrap, "clamp" if wrap == "mirror" else wrap, srgb)
    assert tp.bilinear_packed == (wrap == "repeat")
    rng = np.random.default_rng(3)
    uv = rng.uniform(-2.3, 3.1, (4096, 2)).astype(np.float32)
    slot = np.where(rng.uniform(size=4096) < 0.8, 1, -1).astype(np.int32)
    ref = np.asarray(jtex.sample_pool(jp, jnp.asarray(slot), jnp.asarray(uv)))
    got = ttex.sample_pool(tp, torch.as_tensor(slot), torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    if not srgb:  # no x ** 2.4: the same float operations give the same bits
        np.testing.assert_array_equal(got, ref)


def test_perturb_normal_and_apply_textures_match_jax(interior_pair, texture_files):
    """The interior's materials plus a normal map on some of them: the
    texture stage's taps and the normal perturbation on random hits."""
    jdesc, tdesc = interior_pair
    paths = sorted(jdesc.materials) + [None]
    jrows, trows = _lowered(jmat, jdesc, paths), _lowered(tmat, tdesc, paths)
    for i in range(0, len(paths), 2):
        jrows[i].textures["normal"] = jtex.TextureRef(
            file_path=texture_files[2], scale=(2.0, 2.0, 2.0, 1.0), bias=(-1.0, -1.0, -1.0, 0.0))
        trows[i].textures["normal"] = ttex.TextureRef(
            file_path=texture_files[2], scale=(2.0, 2.0, 2.0, 1.0), bias=(-1.0, -1.0, -1.0, 0.0))
    jt, jp = jmat.build_materials(jrows)
    tt, tp = tmat.build_materials(trows)
    _check_tables(jt, jp, tt, tp)
    rng = np.random.default_rng(4)
    r = 2048
    mat = rng.integers(0, len(paths), r).astype(np.int32)
    uv = rng.uniform(-1.0, 2.0, (r, 2)).astype(np.float32)
    n = rng.normal(size=(r, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t = np.cross(n, rng.normal(size=(r, 3))).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    b = np.cross(n, t).astype(np.float32)
    ttd = tt.to("cpu")
    ref = np.asarray(jmat.perturb_normal(jt, jp, jnp.asarray(mat), jnp.asarray(uv),
                                         *map(jnp.asarray, (n, t, b))))
    got = tmat.perturb_normal(ttd, tp, torch.as_tensor(mat), torch.as_tensor(uv),
                              *map(torch.as_tensor, (n, t, b))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    active = ("base_color", "emissive", "metallic", "roughness")
    jpar = jmat.apply_textures(jt, jp, jmat.gather_params(jt, jnp.asarray(mat)),
                               jnp.asarray(mat), jnp.asarray(uv), active)
    tpar = tmat.apply_textures(ttd, tp, tmat.gather_params(ttd, torch.as_tensor(mat)),
                               torch.as_tensor(mat), torch.as_tensor(uv), active)
    for name in active:
        np.testing.assert_allclose(getattr(tpar, name).numpy(), np.asarray(getattr(jpar, name)),
                                   rtol=0, atol=ATOL, err_msg=name)


def test_texture_manager_fallback_and_cache(tmp_path, texture_files):
    """A missing file is the 1x1 black texture (logged, as the reference
    does); a file read once is cached by path."""
    tm = ttex.TextureManager()
    pool = tm.build_pool([ttex.TextureRef(file_path=str(tmp_path / "missing.png")),
                          ttex.TextureRef(file_path=texture_files[0], is_srgb=True)])
    assert pool.width.tolist() == [1, 5] and pool.height.tolist() == [1, 7]
    assert pool.texels_u32[0].item() == 0 and pool.mean[0].tolist() == [0.0, 0.0, 0.0, 0.0]
    assert tm._load_raw(ttex.TextureRef(file_path=texture_files[0])) is \
        tm._raw_cache[texture_files[0]]
