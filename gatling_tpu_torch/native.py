"""The port's native host library (csrc/gatling_native.cpp,
csrc/jpeg2000.cpp, csrc/tiff_codecs.cpp and csrc/legacy_codecs.cpp)
through ctypes.

The JAX package keeps its host-side loops in a small C++ library
(gatling_tpu/native.py over native/gatling_native.cpp): Morton ordering
and the threaded-BVH build, the byteshuffle + deflate mesh codec and the
crate reader's LZ4 block decoder. The port carries a copy of that source
in csrc/, with the image codecs' loops beside it: the JPEG entropy
decoders (Huffman, arithmetic, lossless) and encoder and libjpeg's
integer transforms (imgio/jpeg.py), the TIFF LZW and PackBits decoders
(imgio/tiff.py), the GIF LZW decoder (imgio/gif.py), the BC1-BC7 block
decoders (imgio/dds.py) and libwebp's VP8 and VP8L decoders with the
stages after them (imgio/vp8.py, vp8l.py, webp.py); a second source,
csrc/jpeg2000.cpp, OpenJPEG's tile decoding (imgio/jpeg2000.py); and a
third, csrc/tiff_codecs.cpp, libtiff's CCITT and ThunderScan decoders, a
Zstandard frame decoder and an xz / LZMA2 decoder (imgio/tiff.py); and a
fourth, csrc/legacy_codecs.cpp, the run-length loops of Pillow's SGI, PCX,
Sun raster, ICNS and FLI decoders (imgio/sgi.py, pcx.py, sun.py, icns.py,
fli.py).

`library()` builds the sources with g++ into one library in
build/torch_ext/ (keyed by a hash of the sources and the flags, as
ops/cuda_lib.py keys the kernels) and loads it. Unlike the JAX package's bridge, a failed build or load
raises with the compiler's output: nothing falls back to NumPy. The
NumPy versions stay as the twins the tests hold the library against
(ops/bvh.py build_bvh_ref, scene/crate.py lz4_decompress_block_ref,
scene/meshproc.py compress_mesh_ref / decompress_mesh_ref, imgio/dds.py
bcn_decode_ref, imgio/vp8.py transform_ref and yuv_to_rgba_ref, imgio/vp8l.py
inverse_transform_ref, imgio/webp.py unfilter_ref, imgio/jpeg2000.py
idwt53_ref, idwt97_ref and mct_ref).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from gatling_tpu_torch.ops.cuda_lib import BUILD_DIR, CSRC

# the library's sources: every one is compiled into it, and the build is
# keyed on all of them
SOURCE = CSRC / "gatling_native.cpp"
MORE_SOURCES = (CSRC / "jpeg2000.cpp", CSRC / "tiff_codecs.cpp", CSRC / "legacy_codecs.cpp",
                CSRC / "image_writers.cpp")
# no contraction into fused multiply-adds: the float code rounds as the
# x86-64 builds of the libraries it reproduces (OpenJPEG's 9/7 wavelet)
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off", "-pthread")
LIBS = ("-lz",)

_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I16 = ctypes.POINTER(ctypes.c_int16)
_U16 = ctypes.POINTER(ctypes.c_uint16)
_U32 = ctypes.POINTER(ctypes.c_uint32)
_PP = ctypes.POINTER(ctypes.c_void_p)
_I64 = ctypes.c_int64
_INT = ctypes.c_int32

# restype and argtypes of every entry point
_ENTRY_POINTS = {
    "gatling_morton_order": (None, [_F32, _F32, _I64, _I32]),
    "gatling_build_bvh": (_I64, [_F32, _F32, _I64, _INT, _F32, _F32, _I32, _I32, _I32, _I32,
                                 _I64]),
    "gatling_dedup": (_I64, [_F32, _I64, _I64, _I32]),
    "gatling_compress": (_I64, [_U8, _I64, _I64, _U8, _I64]),
    "gatling_decompress": (_I64, [_U8, _I64, _I64, _U8, _I64]),
    "gatling_lz4_decompress": (_I64, [_U8, _I64, _U8, _I64]),
    "gatling_jpeg_decode_scan": (_I64, [_U8, _I64, _I64, _INT, _I32, _PP, _INT, _INT, _U8, _I32,
                                        _INT, _INT, _INT, _INT, _INT, _INT, _I32]),
    "gatling_jpeg_decode_arith_scan": (_I64, [_U8, _I64, _I64, _INT, _I32, _PP, _INT, _INT, _I32,
                                              _INT, _INT, _INT, _INT, _INT, _INT, _I32]),
    "gatling_jpeg_decode_lossless": (_I64, [_U8, _I64, _I64, _INT, _I32, _PP, _INT, _INT, _U8, _I32,
                                            _INT, _INT, _INT, _INT]),
    "gatling_jpeg_idct_islow": (None, [_I16, _I64, _U16, _U8]),
    "gatling_jpeg_fdct_islow": (None, [_U8, _I64, _U16, _I16]),
    "gatling_jpeg_encode_scan": (_I64, [_INT, _I32, _PP, _INT, _INT, _U8, _U8, _I64]),
    "gatling_tiff_lzw_decode": (_I64, [_U8, _I64, _U8, _I64]),
    "gatling_tiff_packbits_decode": (_I64, [_U8, _I64, _U8, _I64]),
    "gatling_tiff_lzw_compat_decode": (_I64, [_U8, _I64, _U8, _I64]),
    "gatling_tiff_fax_decode": (_I64, [_U8, _I64, _U8, _I64, _I64, _INT, _INT, _INT, _INT, _I64]),
    "gatling_tiff_thunder_decode": (_I64, [_U8, _I64, _U8, _I64, _I64, _I64]),
    "gatling_tiff_zstd_decode": (_I64, [_U8, _I64, _U8, _I64]),
    "gatling_tiff_xz_decode": (_I64, [_U8, _I64, _U8, _I64, _I32]),
    "gatling_sgi_rle_decode": (_I64, [_U8, _I64, _INT, _INT, _INT, _INT, _U8]),
    "gatling_pcx_decode": (_I64, [_U8, _I64, _INT, _INT, _INT, _U8]),
    "gatling_sun_rle_decode": (_I64, [_U8, _I64, _INT, _INT, _U8]),
    "gatling_fli_decode": (_I64, [_U8, _I64, _INT, _INT, _U8]),
    "gatling_icns_rle_channel": (_I64, [_U8, _I64, ctypes.POINTER(ctypes.c_int64), _I64, _U8,
                                        ctypes.POINTER(ctypes.c_int64)]),
    "gatling_gif_lzw_decode": (_I64, [_U8, _I64, _INT, _INT, _INT, _INT, _U8]),
    "gatling_bcn_decode": (_I64, [_U8, _I64, _INT, _INT, _INT, _INT, _U8]),
    "gatling_vp8_decode": (_I64, [_U8, _I64, _U8, _I64, _INT, _INT, _U8, _U8, _U8, _I32]),
    "gatling_vp8_transform": (None, [_I16, _I64, _INT, _U8]),
    "gatling_webp_yuv_to_rgba": (None, [_U8, _U8, _U8, _INT, _INT, _INT, _INT, _U8]),
    "gatling_webp_unfilter": (None, [_U8, _INT, _INT, _INT, _U8]),
    "gatling_vp8l_decode": (_I64, [_U8, _I64, _INT, _INT, _INT, _U32, _I32]),
    "gatling_vp8l_inverse_transform": (None, [_INT, _INT, _INT, _INT, _U32, _U32, _U32]),
    "gatling_j2k_decode_tile": (_I64, [_I32, _U8, _I64, _U8, _I64, ctypes.POINTER(ctypes.c_int64),
                                       _I32, _PP, _I32]),
    "gatling_j2k_idwt": (None, [ctypes.c_void_p, _I32, _INT, _INT, _INT]),
    "gatling_j2k_mct": (None, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, _I64, _INT]),
    "gatling_j2k_fdwt53": (None, [_I32, _INT, _INT, _INT]),
    "gatling_j2k_encode_cblk": (_I64, [_I32, _I64, _INT, _INT, _INT, _U8, _I64, _I32]),
    "gatling_j2k_encode_tile": (_I64, [_PP, _INT, _INT, _INT, _INT, _I32, _U8, _I64]),
    "gatling_resample": (None, [_U8, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _U8]),
    "gatling_quantize_mediancut": (_INT, [_U8, _I64, _INT, _U8, _U8]),
    "gatling_quantize_octree": (_INT, [_U8, _I64, _INT, _U8, _U8]),
    "gatling_gif_lzw_encode": (_I64, [_U8, _INT, _INT, _INT, _U8, _I64]),
    "gatling_pcx_encode": (_I64, [_U8, _INT, _INT, _INT, _INT, _U8, _I64]),
    "gatling_qoi_encode": (_I64, [_U8, _I64, _INT, _U8, _I64]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> tuple:
    return (SOURCE, *MORE_SOURCES)


def _build(path) -> None:
    """g++ into a temporary file renamed onto `path`; raises with the
    compiler's output."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's native library is built from "
                           f"{', '.join(map(str, _sources()))} at first use")
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([gxx, *FLAGS, "-o", str(tmp), *map(str, _sources()), *LIBS],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {', '.join(map(str, _sources()))}:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, path)


def library() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            tag = hashlib.sha1(b"".join(src.read_bytes() for src in _sources())
                               + " ".join(FLAGS + LIBS).encode()).hexdigest()[:12]
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            path = BUILD_DIR / f"libgatling_native_{tag}.so"
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def ptr(a: np.ndarray, ctype):
    """A pointer to the data of contiguous array `a`."""
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pointers(arrays: list[np.ndarray]):
    """A C array of the arrays' data pointers (void **)."""
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int):
    """gatling_build_bvh over triangle boxes [T, 3]: (bbox_min, bbox_max,
    skip, leaf_start, leaf_count, order), the arrays of ops/bvh.py
    build_bvh_ref (gatling_tpu/native.py native_build_bvh)."""
    lib = library()
    t = len(tri_min)
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    max_nodes = 2 * t + 8
    bbox_min = np.empty((max_nodes, 3), np.float32)
    bbox_max = np.empty((max_nodes, 3), np.float32)
    skip, leaf_start, leaf_count = (np.empty(max_nodes, np.int32) for _ in range(3))
    order = np.empty(t, np.int32)
    n = lib.gatling_build_bvh(ptr(tri_min, ctypes.c_float), ptr(tri_max, ctypes.c_float), t,
                              leaf_size, ptr(bbox_min, ctypes.c_float),
                              ptr(bbox_max, ctypes.c_float), ptr(skip, ctypes.c_int32),
                              ptr(leaf_start, ctypes.c_int32), ptr(leaf_count, ctypes.c_int32),
                              ptr(order, ctypes.c_int32), max_nodes)
    if n <= 0:
        raise ValueError(f"gatling_build_bvh: no tree over {t} triangles")
    return (bbox_min[:n], bbox_max[:n], skip[:n], leaf_start[:n], leaf_count[:n],
            order.astype(np.int64))


def _bytes(blob) -> np.ndarray:
    return np.ascontiguousarray(np.frombuffer(blob, np.uint8))


def lz4_decompress(blob: bytes, max_out: int) -> bytes | None:
    """gatling_lz4_decompress of one LZ4 block; None when the decoder
    rejects it (malformed, or longer than max_out)."""
    src = _bytes(blob)
    dst = np.empty(max(max_out, 1), np.uint8)
    got = library().gatling_lz4_decompress(ptr(src, ctypes.c_uint8), src.size,
                                           ptr(dst, ctypes.c_uint8), max_out)
    return None if got < 0 else dst[:got].tobytes()


def compress(raw: np.ndarray, elem_size: int) -> bytes:
    """gatling_compress: byteshuffle + deflate (level 3) of raw bytes."""
    src = np.ascontiguousarray(raw, np.uint8).reshape(-1)
    cap = src.size + src.size // 8 + 256
    dst = np.empty(cap, np.uint8)
    got = library().gatling_compress(ptr(src, ctypes.c_uint8), src.size, elem_size,
                                     ptr(dst, ctypes.c_uint8), cap)
    if got <= 0:
        raise ValueError(f"gatling_compress failed on {src.size} bytes of {elem_size}-byte "
                         "elements")
    return dst[:got].tobytes()


def decompress(blob: bytes, n: int, elem_size: int) -> np.ndarray:
    """gatling_decompress: the n raw bytes of a `compress` stream."""
    src = _bytes(blob)
    dst = np.empty(n, np.uint8)
    got = library().gatling_decompress(ptr(src, ctypes.c_uint8), src.size, elem_size,
                                       ptr(dst, ctypes.c_uint8), n)
    if got != n:
        raise ValueError(f"gatling_decompress: a corrupt stream ({n} bytes expected)")
    return dst
