"""The port's TIFF codecs and layouts (imgio/tiff.py and the native
csrc/tiff_codecs.cpp) against the JAX package's imgio (Pillow 12.1 over its
libtiff 4.7.1): each file gives the same array in both packages, or
ValueError in both. The inputs are made from seeds.

1. CCITT: Pillow's Group 3 (T4Options 1D and 2D, fill bits, the
   uncompressed-mode bit), Group 4 (T6Options), Modified Huffman and RLEW
   files at several widths (runs past 2560), in bit fill order 1 and 2;
   damaged copies (cut short, bits flipped): a T.4 strip whose EOL search
   runs out of data is decoded again without EOLs, as libtiff does.
2. LZMA: xz streams made with Python's lzma (each check type, the delta and
   branch filters, two streams) in TIFFs, and Pillow's files with predictors
   2 and 3; streams framed here over stored chunks for every branch filter
   (ARM64 and RISC-V too), chains of them, blocks of declared sizes, and
   their damaged copies.
3. ZSTD: Pillow's files of varied data (raw, RLE and compressed blocks,
   Huffman literals of one and four streams, treeless literals, FSE tables
   in every mode; a Python walker of the frames shows they are there),
   damaged strips (libzstd's fast four-stream Huffman decoding reads on
   past a stream's start and checks no end: the port does the same), and
   frames made here (a content checksum right and wrong, single-segment
   frames, a dictionary, a skippable frame, a reserved bit, a window past
   libzstd's limit).
4. ThunderScan and old-style JPEG (both forms: JPEGInterchangeFormat, and
   tables in tags over strips of restart intervals), made by the writers of
   tests/data/imgio/make_fixtures.py.
5. Orientations 1-8 under none, LZW and ZSTD, and an XMP orientation.
6. YCbCr without JPEG (TIFFRGBAImage): subsamplings 1, 2 and 4 in each axis
   x YCbCrPositioning, strips and tiles, ReferenceBlackWhite and
   YCbCrCoefficients, planes.
7. Planar configuration 2 of every depth, uncompressed and compressed; JPEG
   strips of other layouts.
8. Compressions libtiff here refuses (WebP, SGILog on other photometrics).

Damage where Pillow's array cannot be reproduced: libtiff leaves the rows of
a T.6 strip past its early end unwritten (Pillow's buffer: uninitialized
memory); there the port raises ValueError (`ONE_SIDED`), never a different
array. LZMA data whose error liblzma reports with or after a strip's last
byte is kept, as libtiff keeps it (the native xz decoder writes what
liblzma writes before its error).
"""

import ctypes
import glob
import importlib.util
import io
import lzma
import os
import struct
import zlib

import numpy as np
import pytest
import PIL
from PIL import Image

from gatling_tpu import imgio as jimgio

from gatling_tpu_torch import imgio

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "make_fixtures", os.path.join(HERE, "data", "imgio", "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)

# the port's messages where Pillow keeps an array the port cannot reproduce
ONE_SIDED = ("ends before its last row",)


def contract(data: bytes, one_sided: bool = False) -> str:
    """'array' when both packages decode to the same array, 'rejected' when
    both raise ValueError, 'one-sided' where `one_sided` allows the port's
    ValueError of ONE_SIDED beside Pillow's array; anything else fails."""
    try:
        want = jimgio.load_image(data).data
    except ValueError:
        with pytest.raises(ValueError):
            imgio.load_image(data)
        return "rejected"
    try:
        got = imgio.load_image(data)
    except ValueError as e:
        if one_sided and any(m in str(e) for m in ONE_SIDED):
            return "one-sided"
        raise
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape,
                                                                  want.dtype, want.shape)
    assert np.array_equal(got, want) if got.dtype == bool else got.tobytes() == want.tobytes()
    return "array"


def saved(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def entries(data: bytes) -> dict:
    """The first IFD's entries {tag: position of its value field}."""
    (off,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, off)
    return {struct.unpack_from("<H", data, off + 2 + 12 * k)[0]: off + 2 + 12 * k + 8
            for k in range(n)}


def strip_span(data: bytes) -> tuple[int, int, int]:
    """(offset, byte count, where the count is stored) of a one-strip file."""
    e = entries(data)
    (off,) = struct.unpack_from("<I", data, e[273])
    (count,) = struct.unpack_from("<I", data, e[279])
    return off, count, e[279]


# ---------------------------------------------------------------------------
# 1. CCITT
# ---------------------------------------------------------------------------

CCITT_SHAPES = ((1, 1), (30, 40), (57, 3000), (64, 2561))
CCITT = {"g3_1d": ("group3", {}), "g3_2d": ("group3", {292: 1}),
         "g3_1d_fill": ("group3", {292: 4}), "g3_2d_fill": ("group3", {292: 5}),
         "g3_uncompressed_bit": ("group3", {292: 7}), "g4": ("group4", {}),
         "g4_t6_uncompressed_bit": ("group4", {293: 2}), "mh": ("tiff_ccitt", {}),
         "rlew": ("tiff_raw_16", {})}


@pytest.mark.parametrize("fill", (1, 2))
@pytest.mark.parametrize("name", sorted(CCITT))
def test_ccitt(name, fill):
    comp, info = CCITT[name]
    info = {**info, **({266: 2} if fill == 2 else {})}
    for k, (h, w) in enumerate(CCITT_SHAPES):
        data = saved(Image.fromarray(mf.bilevel(h, w, k)), compression=comp, tiffinfo=info)
        assert contract(data) == "array"


@pytest.mark.parametrize("name", ("g3_1d", "g3_2d", "g3_2d_fill", "g4", "mh", "rlew"))
def test_ccitt_damaged(name):
    """Cut short or bits flipped, 60 seeds: the same array or ValueError in
    both; a T.6 strip that ends early is one-sided."""
    comp, info = CCITT[name]
    data = saved(Image.fromarray(mf.bilevel(40, 300, 5)), compression=comp, tiffinfo=info)
    off, count, count_at = strip_span(data)
    seen = set()
    for seed in range(60):
        rng = np.random.default_rng(seed)
        b = bytearray(data)
        if seed % 2:
            struct.pack_into("<I", b, count_at, int(rng.integers(1, count + 1)))
        else:
            for _ in range(int(rng.integers(1, 3))):
                b[off + int(rng.integers(count))] ^= 1 << int(rng.integers(8))
        seen.add(contract(bytes(b), one_sided=comp == "group4"))
    assert "array" in seen


# ---------------------------------------------------------------------------
# 2. LZMA
# ---------------------------------------------------------------------------

XZ_CHECKS = {"none": lzma.CHECK_NONE, "crc32": lzma.CHECK_CRC32, "crc64": lzma.CHECK_CRC64,
             "sha256": lzma.CHECK_SHA256}
XZ_FILTERS = {"lzma2": [{"id": lzma.FILTER_LZMA2}],
              "delta": [{"id": lzma.FILTER_DELTA, "dist": 3}, {"id": lzma.FILTER_LZMA2}],
              **{name: [{"id": fid}, {"id": lzma.FILTER_LZMA2}] for name, fid in (
                  ("x86", lzma.FILTER_X86), ("powerpc", lzma.FILTER_POWERPC),
                  ("ia64", lzma.FILTER_IA64), ("arm", lzma.FILTER_ARM),
                  ("armthumb", lzma.FILTER_ARMTHUMB), ("sparc", lzma.FILTER_SPARC))}}


@pytest.mark.parametrize("chain", sorted(XZ_FILTERS))
@pytest.mark.parametrize("check", sorted(XZ_CHECKS))
def test_xz_streams(check, chain):
    """Strips of Python's xz streams (two strips, predictor 2 on the second
    file), and the same with a damaged check or a second stream after."""
    tex = mf.texture(24, 30, 3, 31)
    rows = [tex[:12].tobytes(), tex[12:].tobytes()]
    fields = {258: (3, [8] * 3), 259: (3, [34925]), 262: (3, [2]), 277: (3, [3])}

    def xz(raw: bytes) -> bytes:
        return lzma.compress(raw, lzma.FORMAT_XZ, check=XZ_CHECKS[check],
                             filters=XZ_FILTERS[chain])

    assert contract(mf.tiff_raw([xz(r) for r in rows], 30, 24, fields, rows_per_strip=12)) \
        == "array"
    diff = np.diff(tex.astype(np.int16), axis=1, prepend=0).astype(np.uint8)
    pred = [xz(diff[:12].tobytes()), xz(diff[12:].tobytes())]
    assert contract(mf.tiff_raw(pred, 30, 24, {**fields, 317: (3, [2])}, rows_per_strip=12)) \
        == "array"
    twice = [xz(r) + xz(r) for r in rows]
    assert contract(mf.tiff_raw(twice, 30, 24, fields, rows_per_strip=12)) == "array"
    if check != "none":  # the check's last byte flipped: liblzma's error after the data
        bad = [bytearray(xz(r)) for r in rows]
        for b in bad:
            b[-13] ^= 0x40
        contract(mf.tiff_raw([bytes(b) for b in bad], 30, 24, fields, rows_per_strip=12),
                 one_sided=True)


@pytest.mark.parametrize("chain", sorted(XZ_FILTERS))
def test_native_xz_decoder(chain):
    """The native xz / LZMA2 decoder (tiff.py `_lzma`) against Python's
    lzma (liblzma) on whole streams: every byte, over LZMA2 chunks of
    every kind (uncompressed, state and dictionary resets; several chunks
    for incompressible data), lc/lp/pb and dictionary sizes, and with room
    for fewer bytes than the stream holds (a branch filter's last
    instructions then filtered as liblzma's look-ahead filters them)."""
    rng = np.random.default_rng(sorted(XZ_FILTERS).index(chain))
    from gatling_tpu_torch.imgio import tiff

    for k in range(12):
        n = int(rng.integers(5, 150000))
        raw = [rng.integers(0, 256, n, np.uint8), np.repeat(rng.integers(0, 256, n // 9 + 1,
                                                                         np.uint8), 9)[:n],
               (np.arange(n) % int(rng.integers(2, 40))).astype(np.uint8)][k % 3]
        for op in (0xE8, 0x48, 0xEB, 0xF0, 0xF8, 0x40, 0x7F, 0x16):
            raw[rng.integers(0, n, n // 60)] = op
        lz = {"id": lzma.FILTER_LZMA2, "preset": int(rng.integers(0, 7)),
              "lc": int(rng.integers(0, 3)), "lp": int(rng.integers(0, 2)),
              "pb": int(rng.integers(0, 5)), "dict_size": 4096 << int(rng.integers(0, 12))}
        filters = XZ_FILTERS[chain][:-1] + [lz]
        blob = lzma.compress(raw.tobytes(), lzma.FORMAT_XZ, filters=filters)
        assert tiff._lzma(blob, n).tobytes() == raw.tobytes()
        short = max(1, n // 3)
        assert tiff._lzma(blob, short).tobytes() == raw[:short].tobytes()


def xz_vli(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    return bytes(out + bytes([v]))


def xz_framed(blocks, sizes: bool = False, chunk: int = 400) -> bytes:
    """An xz stream without checks whose blocks [(filters [(id, props)],
    data)] hold their data in stored LZMA2 chunks of `chunk` bytes: the
    branch filters then decode bytes chosen here (Python's lzma writes no
    ARM64 or RISC-V stream), and liblzma is the judge. `sizes`: the block
    headers declare their compressed and uncompressed sizes."""
    out = bytearray(b"\xfd7zXZ\0\0\0" + struct.pack("<I", zlib.crc32(b"\0\0")))
    records = []
    for filters, data in blocks:
        body = bytearray()
        for k in range(0, len(data), chunk):
            part = data[k:k + chunk]
            body += bytes([1 if k == 0 else 2]) + struct.pack(">H", len(part) - 1) + part
        body += b"\0"
        head = bytearray([len(filters) | (0xC0 if sizes else 0)])
        if sizes:
            head += xz_vli(len(body)) + xz_vli(len(data))
        for fid, props in filters + [(0x21, b"\x10")]:
            head += xz_vli(fid) + xz_vli(len(props)) + props
        size = (len(head) + 5 + 3) // 4 * 4
        head = bytes([size // 4 - 1]) + head + bytes(size - 5 - len(head))
        block = head + struct.pack("<I", zlib.crc32(head)) + body
        records.append((len(block), len(data)))
        out += block + bytes(-len(block) % 4)
    index = bytearray(b"\0" + xz_vli(len(records)))
    for unpadded, n in records:
        index += xz_vli(unpadded) + xz_vli(n)
    index += bytes(-len(index) % 4)
    index += struct.pack("<I", zlib.crc32(index))
    foot = struct.pack("<I", len(index) // 4 - 1) + b"\0\0"
    return bytes(out + index + struct.pack("<I", zlib.crc32(foot)) + foot + b"YZ")


# liblzma's branch filters: id, the start offsets' alignment
XZ_BRANCH = {"x86": (4, 1), "powerpc": (5, 4), "ia64": (6, 16), "arm": (7, 4),
             "armthumb": (8, 2), "sparc": (9, 4), "arm64": (10, 4), "riscv": (11, 2)}


def branch_code(rng, n: int) -> bytes:
    """n bytes dense in every architecture's branch and address opcodes."""
    b = rng.integers(0, 256, n).astype(np.uint8)
    for op in (0xE8, 0xE9, 0xEB, 0xEF, 0x17, 0x97, 0x94, 0x90, 0x48, 0x40, 0x7F, 0xF0, 0xF8):
        b[rng.integers(0, n, n // 40)] = op
    for _ in range(n // 48):
        at = int(rng.integers(0, n - 8))
        w = int(rng.integers(0, 1 << 32))
        w = [(w & ~0x7F) | 0x17, (w & ~0xFF) | 0xEF, (w & 0x03FFFFFF) | 0x94000000,
             (w & ~0x9F000000) | 0x90000000, (w & ~0xEFF) | 0x17][int(rng.integers(0, 5))]
        b[at:at + 4] = np.frombuffer(struct.pack("<I", w), np.uint8)
    return b.tobytes()


@pytest.mark.parametrize("name", sorted(XZ_BRANCH))
def test_xz_branch_filters(name):
    """Each branch filter liblzma decodes (x86, PowerPC, IA64, ARM,
    ARM-Thumb, SPARC, ARM64, RISC-V), over stored chunks of branch-dense
    bytes: alone, at a start offset of its alignment (one beside it
    refused), behind a delta filter, twice in one chain, in two blocks of
    declared sizes, in a stream longer than its strip; damaged (a bad chunk
    header, the stream cut short) through the plain path (ValueError in
    both) and libtiff's RGBA interface, where a filter that meets liblzma's
    error leaves what it was given unfiltered and a cut stream's unfiltered
    tail unwritten: Pillow's array."""
    fid, align = XZ_BRANCH[name]
    rng = np.random.default_rng(fid)
    w, h = 24, 16
    rgb = {258: (3, [8] * 3), 259: (3, [34925]), 262: (3, [2]), 277: (3, [3])}
    code = branch_code(rng, w * h * 3 + 500)
    n = w * h * 3
    start = struct.pack("<I", 4096 + 16 * align)
    other = XZ_BRANCH["arm64" if name != "arm64" else "riscv"][0]
    chains = [[(fid, b"")], [(fid, start)], [(3, b"\x02"), (fid, b"")],
              [(fid, b""), (other, b"")]]
    for chain in chains:
        assert contract(mf.tiff_raw([xz_framed([(chain, code[:n])])], w, h, rgb)) == "array"
    halves = [(chains[0], code[:n // 2]), (chains[1], code[n // 2:n])]
    assert contract(mf.tiff_raw([xz_framed(halves, sizes=True)], w, h, rgb)) == "array"
    assert contract(mf.tiff_raw([xz_framed([(chains[0], code)])], w, h, rgb)) == "array"
    if align > 1:
        skew = [(fid, struct.pack("<I", 4096 + align // 2))]
        assert contract(mf.tiff_raw([xz_framed([(skew, code[:n])])], w, h, rgb)) == "rejected"
    ycc = {**YCC_FIELDS, 259: (3, [34925])}
    wy, hy = 48, 32
    units = code[:wy * hy // 4 * 6]
    for chain in chains:
        blob = bytearray(xz_framed([(chain, units)]))
        first = blob.index(b"\x01\x01\x8f")  # the first chunk: stored, 400 bytes
        bad = bytearray(blob)
        bad[first + 3 + 400] = 0x05  # the second chunk's control byte: an error
        for damaged in (bytes(bad), bytes(blob[:first + 3 + 400 + 3 + int(rng.integers(1, 390))])):
            contract(mf.tiff_raw([damaged], w, h, rgb))
            assert contract(mf.tiff_raw([damaged], wy, hy, ycc)) == "array"


class _LzmaStream(ctypes.Structure):  # lzma.h lzma_stream
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t),
                ("total_in", ctypes.c_uint64), ("next_out", ctypes.c_void_p),
                ("avail_out", ctypes.c_size_t), ("total_out", ctypes.c_uint64),
                ("allocator", ctypes.c_void_p), ("internal", ctypes.c_void_p),
                ("reserved", ctypes.c_void_p * 4), ("seek_pos", ctypes.c_uint64),
                ("reserved_int", ctypes.c_uint64), ("reserved_sizes", ctypes.c_size_t * 2),
                ("reserved_enums", ctypes.c_int * 2)]


def libtiff_lzma(blob: bytes, n: int) -> bytes:
    """What tif_lzma.c LZMADecode leaves in a strip of n bytes: Pillow's own
    liblzma (the one its libtiff links) through ctypes, lzma_code called
    until the strip is full, the data ends or liblzma reports an error."""
    found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                   "liblzma*"))
    if not found:
        pytest.skip("this Pillow bundles no liblzma")
    lib = ctypes.CDLL(found[0])
    strm = _LzmaStream()
    assert lib.lzma_stream_decoder(ctypes.byref(strm), ctypes.c_uint64(2**64 - 1),
                                   ctypes.c_uint32(0)) == 0
    src = ctypes.create_string_buffer(blob, len(blob) + 1)
    dst = ctypes.create_string_buffer(n + 1)
    strm.next_in, strm.avail_in = ctypes.addressof(src), len(blob)
    strm.next_out, strm.avail_out = ctypes.addressof(dst), n
    while lib.lzma_code(ctypes.byref(strm), 0) == 0 and strm.avail_out > 0:
        pass
    got = n - strm.avail_out
    lib.lzma_end(ctypes.byref(strm))
    return dst.raw[:got]


@pytest.mark.parametrize("seed", range(4))
def test_xz_against_liblzma(seed):
    """The native xz decoder (tiff.py `_lzma`, the bytes it keeps) against
    Pillow's liblzma as LZMADecode drives it, byte for byte: streams framed
    here (one to three blocks, chains of up to three delta and branch
    filters, start offsets aligned or not, declared sizes or not) and
    Python's (each check, a branch filter behind a delta one or alone),
    each whole, into a strip shorter than its data, and damaged (bytes
    changed, cut short, bytes inserted)."""
    from gatling_tpu_torch.imgio import tiff

    rng = np.random.default_rng(seed)
    ids = sorted(v[0] for v in XZ_BRANCH.values())
    branch = [lzma.FILTER_X86, lzma.FILTER_POWERPC, lzma.FILTER_IA64, lzma.FILTER_ARM,
              lzma.FILTER_ARMTHUMB, lzma.FILTER_SPARC]
    for it in range(40):
        if it % 2:
            blocks = []
            for _ in range(int(rng.integers(1, 4))):
                chain = []
                for _ in range(int(rng.integers(0, 4))):
                    if rng.integers(0, 4) == 0:
                        chain.append((3, bytes([int(rng.integers(0, 256))])))
                    else:
                        start = int(rng.integers(0, 1 << 20)) & ~int(rng.choice([0, 1, 15]))
                        chain.append((int(rng.choice(ids)),
                                      struct.pack("<I", start) if rng.integers(0, 2) else b""))
                blocks.append((chain, branch_code(rng, int(rng.integers(16, 3000)))))
            blob, n = xz_framed(blocks, sizes=bool(rng.integers(0, 2))), sum(
                len(d) for _, d in blocks)
        else:
            n = int(rng.integers(16, 6000))
            chain = [{"id": int(rng.choice(branch))}] if it % 4 else []
            if rng.integers(0, 2):
                chain.insert(0, {"id": lzma.FILTER_DELTA, "dist": int(rng.integers(1, 20))})
            chain.append({"id": lzma.FILTER_LZMA2, "preset": int(rng.integers(0, 7))})
            blob = lzma.compress(branch_code(rng, n), lzma.FORMAT_XZ,
                                 check=[0, 1, 4, 10][it // 2 % 4], filters=chain)
        copies = [(blob, n), (blob, max(1, n // 2))]
        for k in range(6):
            b = bytearray(blob)
            if k % 3 == 0:
                for _ in range(int(rng.integers(1, 4))):
                    b[int(rng.integers(12, len(b)))] = int(rng.integers(0, 256))
            elif k % 3 == 1:
                b = b[:int(rng.integers(12, len(b)))]
            else:
                at = int(rng.integers(12, len(b)))
                b[at:at] = rng.integers(0, 256, int(rng.integers(1, 8)), np.uint8).tobytes()
            copies.append((bytes(b), n))
        for data, room in copies:
            assert tiff._lzma(data, room, partial=True).tobytes() == libtiff_lzma(data, room)


@pytest.mark.parametrize("comp", (34925, 8), ids=("lzma", "deflate"))
@pytest.mark.parametrize("bo", ("<", ">"), ids=("II", "MM"))
def test_predictors_byte_orders(bo, comp):
    """Predictor 2 over 16-bit grey and RGB and predictor 3 over floats in
    either byte order (libtiff undoes them in native order, then Pillow's
    unpackers read the file's), strips made here."""
    rng = np.random.default_rng(len(bo) + comp)
    h, w = 9, 11

    def enc(raw: bytes) -> bytes:
        return lzma.compress(raw, lzma.FORMAT_XZ) if comp == 34925 else zlib.compress(raw)

    for spp, photometric in ((1, 1), (3, 2)):
        v = rng.integers(0, 65536, (h, w, spp)).astype(np.int64)
        d = np.diff(v, axis=1, prepend=0).astype(np.uint16).astype(bo + "u2")
        fields = {258: (3, [16] * spp), 259: (3, [comp]), 262: (3, [photometric]),
                  277: (3, [spp]), 317: (3, [2])}
        assert contract(mf.tiff_raw([enc(d.tobytes())], w, h, fields, bo=bo)) == "array"
    floats = rng.uniform(-3, 3, (h, w)).astype(">f4")
    planes = floats.view(np.uint8).reshape(h, w, 4).transpose(0, 2, 1).reshape(h, -1)
    d = np.diff(planes.astype(np.int64), axis=1, prepend=0).astype(np.uint8)
    fields = {258: (3, [32]), 259: (3, [comp]), 262: (3, [1]), 317: (3, [3]), 339: (3, [3])}
    assert contract(mf.tiff_raw([enc(d.tobytes())], w, h, fields, bo=bo)) == "array"


MODES = ("RGB", "RGBA", "L", "F", "I;16")
# libtiff writes the floating-point predictor for float samples alone
PREDICTED = [(m, p) for m in MODES for p in (1, 2)] + [("F", 3)]


def pillow_image(mode: str, seed: int, h: int = 37, w: int = 53) -> Image.Image:
    tex = mf.texture(h, w, 4, seed)
    if mode == "F":
        return Image.fromarray(tex[..., 0].astype(np.float32) / 64.0 - 1.0, "F")
    if mode == "I;16":
        return Image.frombytes("I;16", (w, h), mf.texture(h, w, 1, seed, depth=16)[..., 0]
                               .astype("<u2").tobytes())
    return Image.fromarray(tex).convert(mode)


@pytest.mark.parametrize("mode,predictor", PREDICTED, ids=lambda v: str(v))
@pytest.mark.parametrize("comp", ("lzma", "zstd"))
def test_pillow_lzma_zstd(comp, mode, predictor):
    img = pillow_image(mode, MODES.index(mode) + 10 * predictor)
    for strip_size in (65536, 1500):
        data = saved(img, compression=comp, tiffinfo={317: predictor}, strip_size=strip_size)
        assert contract(data) == "array"


@pytest.mark.parametrize("comp", ("lzma", "zstd"))
def test_lzma_zstd_damaged(comp):
    """Strips cut short and bytes changed: the same array or ValueError in
    both (libzstd's fast Huffman path reads damaged literals on past their
    streams, as the port does), one-sided where libtiff keeps LZMA data
    liblzma reports damaged with or after its last byte."""
    data = saved(Image.fromarray(mf.texture(40, 56, 3, 3)), compression=comp)
    off, count, count_at = strip_span(data)
    seen = set()
    for seed in range(80):
        rng = np.random.default_rng(seed)
        b = bytearray(data)
        if seed % 2:
            struct.pack_into("<I", b, count_at, int(rng.integers(1, count + 1)))
            seen.add(contract(bytes(b)))
        else:
            for _ in range(int(rng.integers(1, 3))):
                b[off + int(rng.integers(count))] = int(rng.integers(256))
            seen.add(contract(bytes(b), one_sided=comp == "lzma"))
    assert "rejected" in seen


@pytest.mark.parametrize("comp", ("group3", "group4", "tiff_ccitt", "lzma", "zstd"))
def test_bigtiff_and_tiles(comp):
    """Each codec in BigTIFF and in tiles (square and not, clipped at the
    right and bottom edges)."""
    bilevel = comp in ("group3", "group4", "tiff_ccitt")
    img = Image.fromarray(mf.bilevel(70, 90, 3) if bilevel else mf.texture(70, 90, 3, 4))
    for big in (False, True):
        for tile in (None, (16, 16), (32, 48)):
            info = {322: tile[0], 323: tile[1]} if tile else {}
            data = saved(img, compression=comp, big_tiff=big, tiffinfo=info)
            assert contract(data) == "array"


# ---------------------------------------------------------------------------
# 3. ZSTD frames
# ---------------------------------------------------------------------------

def zstd_walk(frame: bytes) -> set:
    """What a zstd frame holds: its block types, and for compressed blocks
    their literals type and stream count and sequence table modes."""
    seen = set()
    fhd = frame[4]
    pos = 5 + (0 if fhd & 0x20 else 1) + [0, 1, 2, 4][fhd & 3] \
        + [int(bool(fhd & 0x20)), 2, 4, 8][fhd >> 6]
    while True:
        (bh,) = struct.unpack("<I", frame[pos:pos + 3] + b"\0")
        last, typ, size = bh & 1, (bh >> 1) & 3, bh >> 3
        seen.add(("block", ("raw", "rle", "compressed")[typ]))
        body = frame[pos + 3:pos + 3 + (1 if typ == 1 else size)]
        if typ == 2:
            lt, sf = body[0] & 3, (body[0] >> 2) & 3
            if lt < 2:
                hdr, lsize = {0: 1, 2: 1, 1: 2, 3: 3}[sf], None
                lsize = (body[0] >> 3) if sf in (0, 2) else (body[0] >> 4) + (body[1] << 4) \
                    if sf == 1 else (body[0] >> 4) + (body[1] << 4) + (body[2] << 12)
                used = hdr + (lsize if lt == 0 else 1)
            else:
                hdr = 3 if sf < 2 else 4 if sf == 2 else 5
                v = int.from_bytes(body[:hdr], "little")
                bits = 10 if sf < 2 else 14 if sf == 2 else 18
                used = hdr + ((v >> (4 + bits)) & ((1 << bits) - 1))
                seen.add(("literals_streams", 1 if sf == 0 else 4))
            seen.add(("literals", ("raw", "rle", "huffman", "treeless")[lt]))
            seq = body[used:]
            if seq and seq[0]:
                n = 1 if seq[0] < 128 else 2 if seq[0] < 255 else 3
                modes = seq[n]
                for k, name in ((6, "ll"), (4, "of"), (2, "ml")):
                    seen.add((name, ("predefined", "rle", "fse", "repeat")[(modes >> k) & 3]))
        pos += 3 + (1 if typ == 1 else size)
        if last:
            return seen


def zstd_strips(data: bytes) -> list:
    """The strips' bytes of a little-endian TIFF."""
    e = entries(data)

    def values(tag):
        typ, n = struct.unpack_from("<HI", data, e[tag] - 6)
        code = "H" if typ == 3 else "I"
        at = e[tag] if n * struct.calcsize(code) <= 4 else struct.unpack_from("<I", data, e[tag])[0]
        return struct.unpack_from("<" + code * n, data, at)

    return [data[o:o + c] for o, c in zip(values(273), values(279))]


def varied(h: int, w: int) -> np.ndarray:
    """Rows of noise (raw blocks), of one value (RLE blocks) and of texture
    (compressed blocks)."""
    img = mf.smooth_texture(max(h, w), 3, 77)[:h, :w].copy()
    rng = np.random.default_rng(78)
    img[h // 5:2 * h // 5] = rng.integers(0, 256, (2 * h // 5 - h // 5, w, 3))
    img[2 * h // 5:4 * h // 5] = 91  # more than a 128 KiB block of one byte
    return img


def test_zstd_block_and_table_kinds():
    """Pillow's ZSTD strips of varied data hold every block type, Huffman
    literals of one and four streams, treeless literals and each FSE mode;
    each file decodes to Pillow's array."""
    seen = set()
    checker = ((np.indices((256, 256)).sum(0) // 8) % 2 * 200).astype(np.uint8)
    images = ((varied(512, 512), 1, 1 << 20), (varied(256, 384), 2, 65536),
              (varied(384, 512), 2, 1 << 22), (varied(64, 96), 1, 2000),
              (mf.smooth_texture(1024, 3, 98), 2, 1 << 22),
              (checker[..., None].repeat(3, -1), 1, 1 << 20))
    for img, pred, strip_size in images:
        data = saved(Image.fromarray(img), compression="zstd", tiffinfo={317: pred},
                     strip_size=strip_size)
        assert contract(data) == "array"
        for s in zstd_strips(data):
            seen |= zstd_walk(s)
    want = {("block", k) for k in ("raw", "rle", "compressed")} | {
        ("literals", k) for k in ("raw", "huffman", "treeless")} | {
        ("literals_streams", 1), ("literals_streams", 4), ("ll", "rle")} | {
        (t, m) for t in ("ll", "of", "ml") for m in ("predefined", "fse", "repeat")}
    assert want <= seen, want - seen


def _frame(content: bytes, checksum: bool, single: bool, blocks: str = "raw",
           fhd_extra: int = 0, window: int = 0x60, dict_id: int = 0) -> bytes:
    """A zstd frame of raw or RLE blocks made here."""
    fhd = (0x20 if single else 0) | (4 if checksum else 0) | fhd_extra
    fcs = b""
    if single:
        fhd |= 0x80  # a 4-byte content size
        fcs = struct.pack("<I", len(content))
    head = b"\x28\xb5\x2f\xfd" + bytes([fhd | (1 if dict_id else 0)])
    head += b"" if single else bytes([window])
    head += bytes([dict_id]) if dict_id else b""
    head += fcs
    body = b""
    chunks = [content[i:i + 1000] for i in range(0, len(content), 1000)]
    for k, c in enumerate(chunks):
        last = k == len(chunks) - 1
        rle = blocks == "rle" and len(set(c)) == 1
        bh = (len(c) << 3) | ((1 if rle else 0) << 1) | int(last)
        body += struct.pack("<I", bh)[:3] + (c[:1] if rle else c)
    tail = struct.pack("<I", mf_xxh64(content) & 0xFFFFFFFF) if checksum else b""
    return head + body + tail


def mf_xxh64(data: bytes) -> int:
    """XXH64 with seed 0."""
    m = (1 << 64) - 1
    p1, p2, p3, p4, p5 = (11400714785074694791, 14029467366897019727, 1609587929392839161,
                          9650029242287828579, 2870177450012600261)

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    def rnd(acc, v):
        return rotl((acc + v * p2) & m, 31) * p1 & m

    n, i = len(data), 0
    if n >= 32:
        v = [(p1 + p2) & m, p2, 0, (-p1) & m]
        while i + 32 <= n:
            for k in range(4):
                v[k] = rnd(v[k], int.from_bytes(data[i + 8 * k:i + 8 * k + 8], "little"))
            i += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & m
        for x in v:
            h = ((h ^ rnd(0, x)) * p1 + p4) & m
    else:
        h = p5
    h = (h + n) & m
    while i + 8 <= n:
        h = (rotl(h ^ rnd(0, int.from_bytes(data[i:i + 8], "little")), 27) * p1 + p4) & m
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ (int.from_bytes(data[i:i + 4], "little") * p1 & m), 23) * p2 + p3) & m
        i += 4
    while i < n:
        h = rotl(h ^ (data[i] * p5 & m), 11) * p1 & m
        i += 1
    h ^= h >> 33
    h = h * p2 & m
    h ^= h >> 29
    h = h * p3 & m
    return h ^ (h >> 32)


ZSTD_FRAMES = {
    "raw_checksum": lambda c: _frame(c, True, False),
    "rle_checksum_single": lambda c: _frame(c, True, True, "rle"),
    "bad_checksum": lambda c: _frame(c, True, False)[:-1] + bytes([_frame(c, True, False)[-1] ^ 1]),
    "cut_checksum": lambda c: _frame(c, True, False)[:-2],
    "dictionary": lambda c: _frame(c, False, False, dict_id=7),
    "reserved_bit": lambda c: _frame(c, False, False, fhd_extra=8),
    "window_too_large": lambda c: _frame(c, False, False, window=0x88),
    "skippable_first": lambda c: b"\x50\x2a\x4d\x18" + struct.pack("<I", 3) + b"abc"
    + _frame(c, False, False),
    "content_size_wrong": lambda c: _frame(c, False, True)[:5] + struct.pack("<I", len(c) + 5)
    + _frame(c, False, True)[9:],
    "trailing_frame": lambda c: _frame(c, True, False) + _frame(c[::-1], False, False),
}


@pytest.mark.parametrize("name", sorted(ZSTD_FRAMES))
def test_zstd_frames_made_here(name):
    """One-strip grey TIFFs of frames made here: raw and RLE blocks, the
    content checksum right, wrong or cut off, a single-segment frame, a
    dictionary (libzstd refuses it), a reserved bit, a window past
    libzstd's 2^27 + 1 limit, a skippable frame first (libzstd's stream ends
    there), a second frame after the first."""
    img = np.zeros((20, 160), np.uint8)
    img[:10] = mf.texture(10, 160, 1, 21)[..., 0]
    img[10:] = 200
    data = mf.tiff_raw([ZSTD_FRAMES[name](img.tobytes())], 160, 20,
                       {258: (3, [8]), 259: (3, [50000]), 262: (3, [1])})
    assert contract(data) in ("array", "rejected")


# ---------------------------------------------------------------------------
# 4. ThunderScan and old-style JPEG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("photometric", (0, 1))
@pytest.mark.parametrize("shape", ((10, 13), (7, 64), (1, 1), (30, 301)),
                         ids=lambda s: "x".join(map(str, s)))
def test_thunderscan(shape, photometric):
    h, w = shape
    rng = np.random.default_rng(h * w)
    img = (np.cumsum(rng.integers(-1, 2, (h, w)), 1) % 16).astype(np.uint8)
    img[:, w // 3:w // 2] = 5
    for rps in (h, 3):
        strips = [mf.thunder_encode(img[r:r + rps], r) for r in range(0, h, rps)]
        fields = {258: (3, [4]), 259: (3, [32809]), 262: (3, [photometric])}
        data = mf.tiff_raw(strips, w, h, fields, rows_per_strip=rps)
        assert contract(data) == "array"
        for seed in range(10):  # a strip cut short, a byte changed
            r = np.random.default_rng(seed)
            cut = [s[:int(r.integers(len(s)))] if k == 0 else s for k, s in enumerate(strips)]
            contract(mf.tiff_raw(cut, w, h, fields, rows_per_strip=rps))
            b = bytearray(data)
            b[8 + int(r.integers(len(strips[0])))] = int(r.integers(256))
            contract(bytes(b))


def jpeg_of(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


SAMPLINGS = {"420": {}, "422": {"subsampling": 1}, "444": {"subsampling": 0}}


@pytest.mark.parametrize("photometric", (6, 2))
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("shape", ((16, 16), (20, 24), (17, 20), (8, 8)),
                         ids=lambda s: "x".join(map(str, s)))
def test_old_jpeg_interchange_format(shape, sampling, photometric):
    """A whole JPEG at JPEGInterchangeFormat, the strip its entropy-coded data
    or the whole stream (libtiff reads an RGB photometric as YCbCr), and the
    YCbCrSubsampling tag absent, agreeing or not (the JPEG's sampling
    rules)."""
    h, w = shape
    jpg = jpeg_of(mf.texture(h, w, 3, 5), **SAMPLINGS[sampling])
    for at_scan in (True, False):
        data = mf.ojpeg_jif(jpg, w, h, photometric=photometric, strip_at_scan=at_scan)
        assert contract(data) == "array"
        for sub in ((1, 1), (2, 2)):
            e = entries(data)
            assert 530 not in e
            fixed = mf.tiff_raw([jpg], w, h, {258: (3, [8] * 3), 259: (3, [6]),
                                              262: (3, [photometric]), 277: (3, [3]),
                                              513: (4, [8]), 514: (4, [len(jpg)]),
                                              530: (3, list(sub))})
            assert contract(fixed) == "array"
    grey = mf.ojpeg_jif(jpeg_of(mf.texture(h, w, 1, 6)[..., 0]), w, h, photometric=1, spp=1)
    assert contract(grey) == "array"


@pytest.mark.parametrize("tiles", (False, True), ids=("strips", "tiles"))
@pytest.mark.parametrize("rows", (1, 2))
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("shape", ((32, 48), (48, 40), (16, 16), (40, 33)),
                         ids=lambda s: "x".join(map(str, s)))
def test_old_jpeg_tables(shape, sampling, rows, tiles):
    """Tables in JPEGQTables, JPEGDCTables and JPEGACTables over strips (or
    one column of tiles) of restart intervals (libtiff's RST markers between
    striles, its restart interval one strile's MCUs)."""
    h, w = shape
    mcu = {"420": (16, (2, 2)), "422": (8, (2, 1)), "444": (8, (1, 1))}[sampling]
    jpg = jpeg_of(mf.texture(h, w, 3, 7), restart_marker_rows=rows, **SAMPLINGS[sampling])
    assert contract(mf.ojpeg_tables(jpg, w, h, mcu[0] * rows, sampling=mcu[1],
                                    tiles=tiles)) == "array"
    grey = jpeg_of(mf.texture(h, w, 1, 8)[..., 0], restart_marker_rows=rows)
    assert contract(mf.ojpeg_tables(grey, w, h, 8 * rows, spp=1, photometric=1, sampling=None,
                                    tiles=tiles)) == "array"


# ---------------------------------------------------------------------------
# 5. orientations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("comp", ("raw", "tiff_lzw", "zstd"))
@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientations(orientation, comp):
    """ImageOps.exif_transpose after the load (TiffImageFile.load_end), one
    strip and several."""
    img = Image.fromarray(mf.texture(12, 20, 3, orientation))
    exif = img.getexif()
    exif[274] = orientation
    for strip_size in (65536, 200):
        data = saved(img, exif=exif, strip_size=strip_size,
                     **({} if comp == "raw" else {"compression": comp}))
        assert contract(data) == "array"


def test_xmp_orientation():
    """Without an Orientation tag, Pillow reads tiff:Orientation in the XMP
    packet (tag 700)."""
    tex = mf.texture(10, 14, 3, 40)
    for value in (3, 6, 8):
        xmp = f'<x:xmpmeta><rdf:Description tiff:Orientation="{value}"/></x:xmpmeta>'.encode()
        data = mf.tiff_raw([tex.tobytes()], 14, 10, {258: (3, [8] * 3), 259: (3, [1]),
                                                     262: (3, [2]), 277: (3, [3]),
                                                     700: (1, xmp)})
        assert contract(data) == "array"


# ---------------------------------------------------------------------------
# 6. YCbCr through libtiff's RGBA interface
# ---------------------------------------------------------------------------

YCC = {"258": (3, [8] * 3), "259": (3, [8]), "262": (3, [6]), "277": (3, [3])}
YCC_FIELDS = {int(k): v for k, v in YCC.items()}


@pytest.mark.parametrize("positioning", (None, 1, 2))
@pytest.mark.parametrize("vs", (1, 2, 4))
@pytest.mark.parametrize("hs", (1, 2, 4))
def test_ycbcr_subsampling(hs, vs, positioning):
    """Deflate strips of data units; subsamplings libtiff's RGBA interface
    lacks (1x4, 2x4) fail in both."""
    rng = np.random.default_rng(hs * 10 + vs)
    for w, h in ((13, 9), (32, 16), (7, 5)):
        y, cb, cr = (rng.integers(0, 256, (h, w)) for _ in range(3))
        units = mf.ycbcr_units(y, cb, cr, hs, vs)
        fields = {**YCC_FIELDS, 530: (3, [hs, vs])}
        if positioning:
            fields[531] = (3, [positioning])
        for rps in (h, 4 * vs):
            per = -(-rps // vs)
            strips = [zlib.compress(units[r:r + per].tobytes())
                      for r in range(0, len(units), per)]
            contract(mf.tiff_raw(strips, w, h, fields, rows_per_strip=rps))


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("sampling", ((2, 2), (4, 4), (1, 2), (2, 1)))
def test_ycbcr_tiles_and_orientation(sampling, orientation):
    """Tiles clipped at the right edge (putcontig8bitYCbCr44tile's skip of
    10 bytes for 4 columns) and strips, under each orientation."""
    hs, vs = sampling
    rng = np.random.default_rng(hs * 7 + vs + orientation)
    w, h, tw, tl = 37, 21, 16, 16
    y, cb, cr = (rng.integers(0, 256, (h, w)) for _ in range(3))
    tiles = []
    for ty in range(0, h, tl):
        for tx in range(0, w, tw):
            def cut(p):
                return np.pad(p, ((0, max(0, ty + tl - h)), (0, max(0, tx + tw - w))))[
                    ty:ty + tl, tx:tx + tw]
            tiles.append(zlib.compress(mf.ycbcr_units(cut(y), cut(cb)[::vs, ::hs],
                                                      cut(cr)[::vs, ::hs], hs, vs).tobytes()))
    fields = {**YCC_FIELDS, 530: (3, [hs, vs]), 274: (3, [orientation])}
    assert contract(mf.tiff_raw(tiles, w, h, fields, tile=(tw, tl))) == "array"
    units = mf.ycbcr_units(y, cb[::vs, ::hs], cr[::vs, ::hs], hs, vs)
    strips = [zlib.compress(units[r:r + 2].tobytes()) for r in range(0, len(units), 2)]
    assert contract(mf.tiff_raw(strips, w, h, fields, rows_per_strip=2 * vs)) == "array"


BLACK_WHITE = ([(0, 1), (255, 1), (128, 1), (255, 1), (128, 1), (255, 1)],
               [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)],
               [(15, 2), (471, 2), (100, 1), (300, 1), (50, 1), (250, 1)])
COEFFICIENTS = (None, [(299, 1000), (587, 1000), (114, 1000)],
                [(2126, 10000), (7152, 10000), (722, 10000)], [(1, 3), (0, 1), (1, 3)])


@pytest.mark.parametrize("coefficients", range(len(COEFFICIENTS)))
@pytest.mark.parametrize("black_white", range(len(BLACK_WHITE)))
def test_ycbcr_conversion(black_white, coefficients):
    """TIFFYCbCrToRGBInit's float32 tables from ReferenceBlackWhite and
    YCbCrCoefficients (a zero green coefficient fails in both)."""
    rng = np.random.default_rng(black_white * 4 + coefficients)
    w, h = 9, 8
    y, cb, cr = (rng.integers(0, 256, (h, w)) for _ in range(3))
    units = mf.ycbcr_units(y, cb[::2, ::2], cr[::2, ::2], 2, 2)
    fields = {**YCC_FIELDS, 530: (3, [2, 2]), 532: (5, BLACK_WHITE[black_white])}
    if COEFFICIENTS[coefficients]:
        fields[529] = (5, COEFFICIENTS[coefficients])
    contract(mf.tiff_raw([zlib.compress(units.tobytes())], w, h, fields))


@pytest.mark.parametrize("comp", ("tiff_lzw", "tiff_adobe_deflate", "packbits", "zstd", "lzma",
                                  "jpeg"))
def test_ycbcr_pillow(comp):
    data = saved(Image.fromarray(mf.texture(20, 24, 3, 50)).convert("YCbCr"), compression=comp)
    assert contract(data) == "array"


def test_ycbcr_planes_and_damage():
    """Planar YCbCr (1x1 alone) and strips short of their data units
    (libtiff keeps what its codec wrote; a strip it cannot read fails)."""
    rng = np.random.default_rng(60)
    w, h = 10, 6
    planes = [rng.integers(0, 256, (h, w)).astype(np.uint8) for _ in range(3)]
    for sub in ((1, 1), (2, 2)):
        data = mf.tiff_raw([zlib.compress(p.tobytes()) for p in planes], w, h,
                           {**YCC_FIELDS, 284: (3, [2]), 530: (3, [sub[0], sub[1]])})
        contract(data)
    y, cb, cr = (rng.integers(0, 256, (8, 12)) for _ in range(3))
    units = mf.ycbcr_units(y, cb[::2, ::2], cr[::2, ::2], 2, 2)
    short = [zlib.compress(units[:2].tobytes())]  # four unit rows wanted
    assert contract(mf.tiff_raw(short, 12, 8, {**YCC_FIELDS, 530: (3, [2, 2])},
                                rows_per_strip=8)) == "array"
    assert contract(mf.tiff_raw(short, 12, 8, {**YCC_FIELDS, 530: (3, [2, 2])},
                                rows_per_strip=2)) == "rejected"


@pytest.mark.parametrize("comp", ("tiff_lzw", "zstd", "lzma"))
def test_ycbcr_damaged_strips(comp):
    """Damaged LZW, ZSTD and LZMA strips through libtiff's RGBA interface:
    libtiff keeps what each codec wrote before its error (LZWDecode zeroes
    the rest of the strip, libzstd hands over the blocks before the one at
    fault, liblzma every byte it decoded), bytes changed and byte counts
    cut, 24 seeds each: Pillow's array every time. The image's 144,000
    bytes take two ZSTD blocks."""
    data = saved(Image.fromarray(mf.texture(200, 240, 3, 61)).convert("YCbCr"),
                 compression=comp, strip_size=1 << 20)
    off, count, count_at = strip_span(data)
    for seed in range(24):
        rng = np.random.default_rng(seed)
        b = bytearray(data)
        if seed % 3 == 2:
            struct.pack_into("<I", b, count_at, int(rng.integers(1, count)))
        else:
            for _ in range(int(rng.integers(1, 3))):
                b[off + int(rng.integers(count))] = int(rng.integers(256))
        assert contract(bytes(b)) == "array", seed
    if comp == "zstd":  # the second block's type made reserved: libzstd's error after the first
        blob = data[off:off + count]
        assert blob[4] == 0  # no content size, no checksum, a window byte
        (head,) = struct.unpack("<I", blob[6:9] + b"\0")
        b = bytearray(data)
        b[off + 6 + 3 + (head >> 3)] |= 6
        assert contract(bytes(b)) == "array"
        # tiles: gtTileContig reuses one buffer across a row of tiles, and
        # ZSTDDecode zeroes it from 0 when a tile fails
        tex = mf.texture(32, 48, 3, 62)
        tiles = []
        for ty in range(0, 32, 16):
            for tx in range(0, 48, 16):
                one = saved(Image.fromarray(tex[ty:ty + 16, tx:tx + 16]).convert("YCbCr"),
                            compression=comp)
                o, c, _ = strip_span(one)
                tiles.append(one[o:o + c])
        tiles[4] = tiles[4][:6] + bytes([tiles[4][6] | 6]) + tiles[4][7:]
        fields = {**YCC_FIELDS, 259: (3, [50000]), 530: (3, [1, 1])}
        assert contract(mf.tiff_raw(tiles, 48, 32, fields, tile=(16, 16))) == "array"


# ---------------------------------------------------------------------------
# 7. planes; JPEG strips of other layouts
# ---------------------------------------------------------------------------

PLANAR = {"bits1": (1, 1, 1, 1, None), "bits4": (4, 1, 1, 1, None), "grey8": (8, 1, 0, 1, None),
          "grey16": (16, 1, 1, 1, None), "int16": (16, 1, 1, 2, None),
          "uint32": (32, 1, 1, 1, None), "int32": (32, 1, 1, 2, None),
          "float32": (32, 1, 1, 3, None), "rgb8": (8, 3, 2, 1, None),
          "rgb16": (16, 3, 2, 1, None), "rgba8": (8, 4, 2, 1, 2), "rgba16": (16, 4, 2, 1, 2),
          "rgba_assoc": (8, 4, 2, 1, 1), "rgbx": (8, 4, 2, 1, 0), "la8": (8, 2, 1, 1, 2),
          "cmyk8": (8, 4, 5, 1, None), "cmyk16": (16, 4, 5, 1, None), "lab8": (8, 3, 8, 1, None),
          "rgb_float": (32, 3, 2, 3, None), "rgb4": (4, 3, 2, 1, None)}


@pytest.mark.parametrize("comp", (1, 8, 32773))
@pytest.mark.parametrize("layout", sorted(PLANAR))
def test_planar(layout, comp):
    """Planar configuration 2: Pillow's raw decoder takes each plane by its
    raw mode's character (uncompressed), libtiff's planes go through
    Pillow's per-plane unpackers (8 and 16 bits; an LA image's alpha left
    0, CIE Lab's a and b read unsigned)."""
    bits, spp, photo, fmt, extra = PLANAR[layout]
    rng = np.random.default_rng(sorted(PLANAR).index(layout) * 3 + comp % 7)
    h, w = 9, 13

    def plane() -> bytes:
        if bits < 8:
            v = rng.integers(0, 1 << bits, (h, w))
            return np.packbits(((v[..., None] >> np.arange(bits - 1, -1, -1)) & 1)
                               .reshape(h, -1).astype(np.uint8), axis=1).tobytes()
        if fmt == 3:
            return rng.uniform(-2, 2, (h, w)).astype("<f4").tobytes()
        kind = "i" if fmt == 2 else "u"
        return rng.integers(0, 1 << min(bits, 31), (h, w)).astype(f"<{kind}{bits // 8}").tobytes()

    def packbits(raw: bytes) -> bytes:
        return b"".join(bytes([min(127, len(raw) - i - 1)]) + raw[i:i + 128]
                        for i in range(0, len(raw), 128))

    for rps in (h, 4):
        strips = []
        for _ in range(spp):
            p = plane()
            row = len(p) // h
            for r in range(0, h, rps):
                chunk = p[r * row:(r + rps) * row]
                strips.append({1: chunk, 8: zlib.compress(chunk), 32773: packbits(chunk)}[comp])
        fields = {258: (3, [bits] * spp), 259: (3, [comp]), 262: (3, [photo]),
                  277: (3, [spp]), 284: (3, [2]), 339: (3, [fmt] * spp)}
        if extra is not None:
            fields[338] = (3, [extra])
        contract(mf.tiff_raw(strips, w, h, fields, rows_per_strip=rps))


def test_jpeg_layouts():
    """JPEG strips of other layouts: four components under RGB with an extra
    sample (alpha, associated alpha, unspecified), grey with alpha (two
    components), planes of grey JPEGs (RGB, and YCbCr whose RGBA interface
    takes 1x1 alone), a 4:4:4 stream under RGB, a 4:2:0 one (RGB refuses its
    sampling; YCbCr without the tag takes it from the stream), a grey
    stream where three samples are wanted."""
    h, w = 16, 24
    tex = mf.texture(h, w, 4, 9)
    cmyk = io.BytesIO()
    Image.fromarray(tex).convert("CMYK").save(cmyk, "JPEG")
    four = cmyk.getvalue()
    planes = [jpeg_of(np.ascontiguousarray(tex[..., c])) for c in range(3)]
    rgb444, rgb420 = jpeg_of(tex[..., :3], subsampling=0), jpeg_of(tex[..., :3])
    three = {258: (3, [8] * 3), 259: (3, [7]), 277: (3, [3])}
    cases = {
        "rgba_extra": ([four], {258: (3, [8] * 4), 259: (3, [7]), 262: (3, [2]), 277: (3, [4]),
                                338: (3, [2])}, "array"),
        "rgb_extra0": ([four], {258: (3, [8] * 4), 259: (3, [7]), 262: (3, [2]), 277: (3, [4]),
                                338: (3, [0])}, "array"),
        "planar_rgb": (planes, {**three, 262: (3, [2]), 284: (3, [2])}, "array"),
        "planar_ycc11": (planes, {**three, 262: (3, [6]), 284: (3, [2]), 530: (3, [1, 1])},
                         "array"),
        "planar_ycc22": (planes, {**three, 262: (3, [6]), 284: (3, [2])}, "rejected"),
        "rgb_444": ([rgb444], {**three, 262: (3, [2])}, "array"),
        "rgb_420": ([rgb420], {**three, 262: (3, [2])}, "rejected"),
        "ycc_420_no_tag": ([rgb420], {**three, 262: (3, [6])}, "array"),
        "ycc_444_tag22": ([rgb444], {**three, 262: (3, [6]), 530: (3, [2, 2])}, "rejected"),
        "grey_as_rgb": ([jpeg_of(tex[..., 0])], {**three, 262: (3, [2])}, "rejected"),
    }
    two = {258: (3, [8, 8]), 259: (3, [7]), 262: (3, [1]), 277: (3, [2])}
    la = mf.jpeg_sampled(tex, [(1, 1), (1, 1)], 5)  # grey and alpha: two components
    rgba = mf.jpeg_sampled(tex, [(1, 1)] * 4, 6)  # four components, no Adobe marker
    four = {258: (3, [8] * 4), 259: (3, [7]), 262: (3, [2]), 277: (3, [4])}
    cases.update({
        "grey_alpha": ([la], {**two, 338: (3, [2])}, "array"),
        "grey_extra0": ([la], {**two, 338: (3, [0])}, "rejected"),
        "grey_alpha_sub21": ([mf.jpeg_sampled(tex, [(2, 1), (1, 1)], 7)], {**two, 338: (3, [2])},
                             "rejected"),
        "rgba_four": ([rgba], {**four, 338: (3, [2])}, "array"),
        "rgba_associated": ([rgba], {**four, 338: (3, [1])}, "array"),
    })
    for name, (strips, fields, want) in cases.items():
        assert contract(mf.tiff_raw(strips, w, h, fields)) == want, name


# ---------------------------------------------------------------------------
# 8. what libtiff here refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("photometric", (1, 2, 32844))
@pytest.mark.parametrize("compression", (50001, 34676, 34677))
def test_refused_compressions(compression, photometric):
    """WebP is not configured in this libtiff; SGILog refuses any
    photometric but LogL and LogLuv (which Pillow has no mode for)."""
    spp = 3 if photometric == 2 else 1
    data = mf.tiff_raw([bytes(64 * spp)], 8, 8, {258: (3, [8] * spp), 259: (3, [compression]),
                                                 262: (3, [photometric]), 277: (3, [spp])})
    assert contract(data) == "rejected"
