"""Write the JPEG 2000 codestreams of tests/test_torch_jpeg2000.py that
Pillow's saver cannot: OpenJPEG's own encoder (the system's libopenjp2 2.5,
driven through ctypes: Pillow exposes none of these options) with every
code-block style (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM and mixes),
progression order changes (POC), SOP and EPH markers, precincts, RGN
region-of-interest shifts and several tile-parts a tile; and, from a file
with SOP and EPH markers, the same packets with their headers moved into
PPT markers (each tile-part's) or a PPM marker (the main header's).

The files are committed; the test holds each one to the JAX package's
decode (Pillow over OpenJPEG 2.5.4). Run from the repository root on a
machine with libopenjp2.so.7:

    python tests/data/jpeg2000/make_openjpeg_files.py
"""

from __future__ import annotations

import ctypes
import os
import struct
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
LIB = "libopenjp2.so.7"

# opj_cparameters_t (openjpeg.h, 2.5) byte offsets of the fields set here;
# opj_poc_t is 148 bytes, OPJ_PATH_LEN 4096
OFF = {"tile_size_on": 0, "cp_tx0": 4, "cp_ty0": 8, "cp_tdx": 12, "cp_tdy": 16,
       "cp_disto_alloc": 20, "csty": 48, "prog_order": 52, "poc": 56, "numpocs": 4792,
       "tcp_numlayers": 4796, "tcp_rates": 4800, "numresolution": 5600, "cblockw_init": 5604,
       "cblockh_init": 5608, "mode": 5612, "irreversible": 5616, "roi_compno": 5620,
       "roi_shift": 5624, "res_spec": 5628, "prcw_init": 5632, "prch_init": 5764,
       "decod_format": 18204, "tp_on": 18696}
POC_SIZE = 148


class Params:
    """An opj_cparameters_t from opj_set_default_encoder_parameters."""

    def __init__(self, lib) -> None:
        self.buf = (ctypes.c_char * 65536)()
        lib.opj_set_default_encoder_parameters(self.buf)
        # the layout check: the defaults OpenJPEG documents
        assert (self.get("numresolution"), self.get("cblockw_init"), self.get("roi_compno"),
                self.get("decod_format")) == (6, 64, -1, -1), "opj_cparameters_t layout"
        self.set("numresolution", 4)  # the image is 30x37
        self.rates(20.0, 0.0)
        self.set("cp_disto_alloc", 1)

    def get(self, name: str, i: int = 0) -> int:
        return struct.unpack_from("<i", self.buf, OFF[name] + 4 * i)[0]

    def set(self, name: str, value: int, i: int = 0) -> None:
        struct.pack_into("<i", self.buf, OFF[name] + 4 * i, value)

    def rates(self, *rates: float) -> None:
        self.set("tcp_numlayers", len(rates))
        for i, r in enumerate(rates):
            struct.pack_into("<f", self.buf, OFF["tcp_rates"] + 4 * i, r)

    def poc(self, i: int, resno0: int, compno0: int, layno1: int, resno1: int, compno1: int,
            prg: int) -> None:
        off = OFF["poc"] + POC_SIZE * i
        struct.pack_into("<IIIII", self.buf, off, resno0, compno0, layno1, resno1, compno1)
        struct.pack_into("<i", self.buf, off + 36, prg)
        self.set("numpocs", i + 1)

    def tile_parts(self, flag: str) -> None:
        struct.pack_into("<bb", self.buf, OFF["tp_on"], 1, ord(flag))


def encode(lib, img: np.ndarray, setup) -> bytes:
    """[h, w, c] 8-bit samples -> a raw codestream; setup(Params) sets the
    options."""
    h, w, c = img.shape
    cparm = (ctypes.c_uint32 * (9 * c))()
    for k in range(c):
        cparm[9 * k:9 * k + 9] = [1, 1, w, h, 0, 0, 8, 8, 0]
    image = lib.opj_image_create(c, cparm, 1 if c >= 3 else 2)
    words = ctypes.cast(image, ctypes.POINTER(ctypes.c_uint32))
    words[0], words[1], words[2], words[3] = 0, 0, w, h
    comps = ctypes.cast(image + 24, ctypes.POINTER(ctypes.c_void_p))[0]
    for k in range(c):  # opj_image_comp_t is 64 bytes, its data pointer at 48
        data = ctypes.cast(comps + 64 * k + 48, ctypes.POINTER(ctypes.c_void_p))[0]
        plane = np.ctypeslib.as_array(ctypes.cast(data, ctypes.POINTER(ctypes.c_int32)),
                                      (h * w,))
        plane[:] = img[..., k].reshape(-1)
    params = Params(lib)
    setup(params)
    codec = lib.opj_create_compress(0)  # OPJ_CODEC_J2K
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    try:
        if not lib.opj_setup_encoder(codec, params.buf, image):
            raise RuntimeError("opj_setup_encoder failed")
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = (lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream)
              and lib.opj_end_compress(codec, stream))
        lib.opj_stream_destroy(stream)
        if not ok:
            raise RuntimeError("OpenJPEG failed to encode")
        with open(path, "rb") as f:
            return f.read()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)
        os.unlink(path)


def _segments(cs: bytes) -> tuple[list, list]:
    """The main header's marker segments and the tile-parts (SOT payload,
    their other header segments, the packets split at SOP markers: (SOP,
    header with its EPH, body))."""
    pos, main = 2, []
    while cs[pos:pos + 2] != b"\xff\x90":
        length = struct.unpack_from(">H", cs, pos + 2)[0]
        main.append(cs[pos:pos + 2 + length])
        pos += 2 + length
    parts = []
    while cs[pos:pos + 2] == b"\xff\x90":
        psot = struct.unpack_from(">I", cs, pos + 6)[0]
        end = pos + psot
        sot, pos = cs[pos + 4:pos + 12], pos + 12
        others = []
        while cs[pos:pos + 2] != b"\xff\x93":
            length = struct.unpack_from(">H", cs, pos + 2)[0]
            others.append(cs[pos:pos + 2 + length])
            pos += 2 + length
        body, packets = cs[pos + 2:end], []
        starts = [i for i in range(len(body) - 1) if body[i:i + 2] == b"\xff\x91"]
        for a, b in zip(starts, starts[1:] + [len(body)]):
            eph = body.index(b"\xff\x92", a + 6) + 2
            packets.append((body[a:a + 6], body[a + 6:eph], body[eph:b]))
        parts.append((sot, others, packets))
        pos = end
    return main, parts


def _tile_part(sot: bytes, others: list, data: bytes) -> bytes:
    head = b"".join(others)
    psot = 12 + len(head) + 2 + len(data)
    return b"\xff\x90\x00\x0a" + sot[:2] + struct.pack(">I", psot) + sot[6:] + head \
        + b"\xff\x93" + data


def with_ppt(cs: bytes) -> bytes:
    """The packet headers moved into each tile-part's PPT marker."""
    main, parts = _segments(cs)
    out = [b"\xff\x4f", *main]
    for sot, others, packets in parts:
        headers = b"".join(h for _, h, _ in packets)
        ppt = b"\xff\x61" + struct.pack(">HB", len(headers) + 3, 0) + headers
        out.append(_tile_part(sot, [*others, ppt], b"".join(s + b for s, _, b in packets)))
    return b"".join(out) + b"\xff\xd9"


def with_ppm(cs: bytes) -> bytes:
    """The packet headers moved into the main header's PPM marker (Nppm
    bytes before each tile-part's)."""
    main, parts = _segments(cs)
    ppm = b"".join(struct.pack(">I", len(h)) + h for h in
                   (b"".join(h for _, h, _ in packets) for _, _, packets in parts))
    out = [b"\xff\x4f", *main, b"\xff\x60" + struct.pack(">HB", len(ppm) + 3, 0) + ppm]
    for sot, others, packets in parts:
        out.append(_tile_part(sot, others, b"".join(s + b for s, _, b in packets)))
    return b"".join(out) + b"\xff\xd9"


def files() -> dict[str, bytes]:
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "imgio"))
    import make_fixtures as mf

    lib = ctypes.CDLL(LIB)
    lib.opj_image_create.restype = ctypes.c_void_p
    lib.opj_image_create.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int]
    lib.opj_create_compress.restype = ctypes.c_void_p
    lib.opj_stream_create_default_file_stream.restype = ctypes.c_void_p
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, ctypes.c_int]
    for name in ("opj_setup_encoder", "opj_start_compress"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 3
    for name in ("opj_encode", "opj_end_compress"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 2
    for name in ("opj_stream_destroy", "opj_destroy_codec", "opj_image_destroy",
                 "opj_set_default_encoder_parameters"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    img = mf.texture(30, 37, 3, 21).astype(np.int32)
    out = {}
    styles = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "pterm": 16, "segsym": 32,
              "all": 63, "bypass_termall": 5, "bypass_pterm": 17, "vsc_segsym": 40,
              "reset_vsc": 10}
    for name, mode in styles.items():
        for irr in (0, 1):
            def setup(p, mode=mode, irr=irr):
                p.set("mode", mode)
                p.set("irreversible", irr)
                p.rates(40.0, 10.0, 0.0)
            out[f"style_{name}_{'97' if irr else '53'}.j2k"] = encode(lib, img, setup)

    def sop_eph(p):
        p.set("csty", 1 | 2 | 4)
        p.set("res_spec", 2)
        for i, size in enumerate((32, 16)):
            p.set("prcw_init", size, i)
            p.set("prch_init", size, i)
        p.set("cblockw_init", 16)
        p.set("cblockh_init", 16)
        p.set("prog_order", 2)
        p.set("tile_size_on", 1)
        p.set("cp_tdx", 24)
        p.set("cp_tdy", 20)
        p.set("numresolution", 3)
    base = encode(lib, img, sop_eph)
    out["sop_eph_precincts.j2k"] = base
    out["ppt.j2k"] = with_ppt(base)
    out["ppm.j2k"] = with_ppm(base)

    def poc(p):
        p.poc(0, 0, 0, 2, 3, 3, 1)
        p.poc(1, 3, 0, 2, 6, 3, 4)
    out["poc.j2k"] = encode(lib, img, poc)

    def poc_layers(p):
        p.poc(0, 0, 0, 1, 6, 3, 0)
        p.poc(1, 0, 0, 2, 6, 2, 2)
        p.poc(2, 0, 2, 2, 6, 3, 3)
    out["poc_layers.j2k"] = encode(lib, img, poc_layers)
    for comp, shift, irr in ((0, 7, 0), (2, 12, 0), (1, 5, 1)):
        def rgn(p, comp=comp, shift=shift, irr=irr):
            p.set("roi_compno", comp)
            p.set("roi_shift", shift)
            p.set("irreversible", irr)
        out[f"rgn_c{comp}_s{shift}.j2k"] = encode(lib, img, rgn)
    for flag in "RLC":
        def parts(p, flag=flag):
            p.set("tile_size_on", 1)
            p.set("cp_tdx", 24)
            p.set("cp_tdy", 20)
            p.set("numresolution", 3)
            p.tile_parts(flag)
        out[f"tile_parts_{flag}.j2k"] = encode(lib, img, parts)
    return out


def main() -> int:
    for name, data in files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        print(f"{name}: {len(data)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
