"""Binary USD (Crate / .usdc) reader and writer: the port of the JAX
package's scene/crate.py, function for function.

The reference opens any USD through pxr's UsdStage::Open
(src/gatling/main.cpp:132); its own hdGatling test scenes are binary
(src/hdGatling/testenv/*/scene.usd). Without pxr, this module implements
the Crate container from the publicly documented format
(pxr/usd/usd/crateFile.{h,cpp}, integerCoding.cpp): bootstrap header, TOC
sections, lz4-compressed token / field / fieldset / spec tables, the
delta-coded compressed-integer arrays, the jump-encoded compressed path
table, and the ValueRep value encodings. The decoded spec set builds the
same Prim/Stage tree the text parser (scene/usda.py) produces, so
everything downstream (scene/stage.py) is format-agnostic.

Reader coverage: crate versions 0.4.0 - 0.10.x (pre-0.4 uncompressed files
are rejected with a clear error). Value types: scalars, vectors, matrices,
arrays (raw and compressed int/float), tokens, strings, asset paths, list
ops (token/string/path/reference/payload), specifier, variant selection
maps, dictionaries, and TimeSamples ({time: value}, resolved to the
nearest sample at the `frame` render setting by scene/usda.py
resolve_frame; value clips are out of scope). The lz4 blocks decode in
the port's native library (`lz4_decompress_block`, gatling_lz4_decompress,
as the JAX reader decodes them); `lz4_decompress_block_ref`, the JAX
reader's own pure-Python fallback, is its twin, bit for bit.

The writer emits version 0.8.0 files (literals-only lz4 blocks, always-
explicit widths): enough to round-trip the reader's subset for fixtures
and for `save_usdc` users; it is not a general Sdf serializer.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Any

import numpy as np

from gatling_tpu_torch import native
from gatling_tpu_torch.scene.usda import Attr, Prim, Stage
from gatling_tpu_torch.utils.log import get_logger

_MAGIC = b"PXR-USDC"

# SdfSpecType values (pxr/sdf/types.h)
SPEC_ATTRIBUTE = 1
SPEC_CONNECTION = 2
SPEC_PRIM = 6
SPEC_PSEUDO_ROOT = 7
SPEC_RELATIONSHIP = 8
SPEC_REL_TARGET = 9
SPEC_VARIANT = 10
SPEC_VARIANT_SET = 11

_SPECIFIERS = {0: "def", 1: "over", 2: "class"}

# Crate value types (pxr/usd/usd/crateDataTypes.h order)
T_BOOL, T_UCHAR, T_INT, T_UINT, T_INT64, T_UINT64 = 1, 2, 3, 4, 5, 6
T_HALF, T_FLOAT, T_DOUBLE = 7, 8, 9
T_STRING, T_TOKEN, T_ASSETPATH = 10, 11, 12
T_QUATD, T_QUATF, T_QUATH = 13, 14, 15
T_VEC2D, T_VEC2F, T_VEC2H, T_VEC2I = 16, 17, 18, 19
T_VEC3D, T_VEC3F, T_VEC3H, T_VEC3I = 20, 21, 22, 23
T_VEC4D, T_VEC4F, T_VEC4H, T_VEC4I = 24, 25, 26, 27
T_MATRIX2D, T_MATRIX3D, T_MATRIX4D = 28, 29, 30
T_DICTIONARY = 31
T_TOKEN_LISTOP, T_STRING_LISTOP, T_PATH_LISTOP = 32, 33, 34
T_REFERENCE_LISTOP, T_INT_LISTOP, T_INT64_LISTOP = 35, 36, 37
T_UINT_LISTOP, T_UINT64_LISTOP = 38, 39
T_PATH_VECTOR, T_TOKEN_VECTOR = 40, 41
T_SPECIFIER, T_PERMISSION, T_VARIABILITY = 42, 43, 44
T_VARIANT_SELECTION_MAP, T_TIME_SAMPLES, T_PAYLOAD = 45, 46, 47
T_DOUBLE_VECTOR, T_LAYER_OFFSET_VECTOR, T_STRING_VECTOR = 48, 49, 50
T_VALUE_BLOCK, T_VALUE, T_UNREGISTERED_VALUE = 51, 52, 53
T_UNREGISTERED_VALUE_LISTOP, T_PAYLOAD_LISTOP = 54, 55
T_TIMECODE = 56

# ValueRep bit layout (crateFile.h)
_REP_ARRAY = 1 << 63
_REP_INLINED = 1 << 62
_REP_COMPRESSED = 1 << 61
_REP_PAYLOAD_MASK = (1 << 48) - 1

# fixed-size POD layouts: type -> (struct fmt per element, tuple arity)
_POD = {
    T_HALF: ("e", 1), T_FLOAT: ("f", 1), T_DOUBLE: ("d", 1),
    T_INT: ("i", 1), T_UINT: ("I", 1), T_INT64: ("q", 1), T_UINT64: ("Q", 1),
    T_UCHAR: ("B", 1), T_BOOL: ("?", 1),
    T_VEC2F: ("f", 2), T_VEC3F: ("f", 3), T_VEC4F: ("f", 4),
    T_VEC2D: ("d", 2), T_VEC3D: ("d", 3), T_VEC4D: ("d", 4),
    T_VEC2H: ("e", 2), T_VEC3H: ("e", 3), T_VEC4H: ("e", 4),
    T_VEC2I: ("i", 2), T_VEC3I: ("i", 3), T_VEC4I: ("i", 4),
    T_QUATF: ("f", 4), T_QUATD: ("d", 4), T_QUATH: ("e", 4),
    T_MATRIX2D: ("d", 4), T_MATRIX3D: ("d", 9), T_MATRIX4D: ("d", 16),
    T_TIMECODE: ("d", 1),
}


# ---------------------------------------------------------------------------
# LZ4 block codec (pure python; the chunked wrapper is pxr TfFastCompression)
# ---------------------------------------------------------------------------

def lz4_decompress_block(src: bytes, max_out: int) -> bytes:
    """Decode one raw LZ4 block (lz4 block format spec) in the native
    library (gatling_tpu/scene/crate.py lz4_decompress_block). A block it
    rejects goes through the twin, as in the JAX reader: the twin raises
    the error the JAX reader raises for it."""
    out = native.lz4_decompress(src, max_out) if src else None
    return out if out is not None else lz4_decompress_block_ref(src, max_out)


def lz4_decompress_block_ref(src: bytes, max_out: int) -> bytes:
    """lz4_decompress_block's pure-Python twin. Literal runs copy as
    slices; an overlapping match copies byte by byte."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i:i + lit]
        i += lit
        if i >= n:
            break  # last sequence: literals only
        off = src[i] | (src[i + 1] << 8)
        i += 2
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - off
        if off >= mlen:
            out += out[start:start + mlen]
        else:  # overlapping match: byte-by-byte semantics
            for k in range(mlen):
                out.append(out[start + k])
        if len(out) > max_out:
            raise ValueError("lz4: output overrun")
    return bytes(out)


def lz4_compress_block(src: bytes) -> bytes:
    """Literals-only LZ4 block (valid per spec: one final sequence)."""
    n = len(src)
    out = bytearray()
    lit = n
    if lit < 15:
        out.append(lit << 4)
    else:
        out.append(0xF0)
        rem = lit - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += src
    return bytes(out)


def lz4_compress_block_matches(src: bytes) -> bytes:
    """Greedy hash-match LZ4 block compressor (real exporters emit
    match-bearing blocks; the literals-only writer never exercises the
    decoders' match-copy paths). Spec end conditions respected: the last
    5 bytes are literals and no match starts within 12 bytes of the end."""
    n = len(src)
    if n < 16:
        return lz4_compress_block(src)
    out = bytearray()
    table: dict[bytes, int] = {}
    anchor = 0
    i = 0
    limit = n - 12  # no match may start at/after here

    def emit(lit_start: int, lit_end: int, off: int = 0, mlen: int = 0):
        lit = lit_end - lit_start
        ml = mlen - 4 if mlen else 0
        token = (min(lit, 15) << 4) | (min(ml, 15) if mlen else 0)
        out.append(token)
        if lit >= 15:
            rem = lit - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out.extend(src[lit_start:lit_end])
        if mlen:
            out.append(off & 0xFF)
            out.append((off >> 8) & 0xFF)
            if ml >= 15:
                rem = ml - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)

    while i < limit:
        key = src[i:i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is None or i - cand > 0xFFFF or src[cand:cand + 4] != key:
            i += 1
            continue
        # extend the match (stop 5 bytes before the end: last-literals rule)
        mlen = 4
        max_len = n - 5 - i
        while mlen < max_len and src[cand + mlen] == src[i + mlen]:
            mlen += 1
        emit(anchor, i, i - cand, mlen)
        i += mlen
        anchor = i
    # final literals-only sequence
    emit(anchor, n)
    return bytes(out)


def _chunked_decompress(src: bytes, uncompressed_size: int) -> bytes:
    """pxr TfFastCompression wrapper: leading chunk-count byte (0 = one
    bare block), else per-chunk int32 sizes."""
    if not src:
        return b""
    n_chunks = src[0]
    if n_chunks == 0:
        return lz4_decompress_block(src[1:], uncompressed_size)
    out = bytearray()
    i = 1
    for _ in range(n_chunks):
        (csize,) = struct.unpack_from("<i", src, i)
        i += 4
        out += lz4_decompress_block(src[i:i + csize], uncompressed_size)
        i += csize
    return bytes(out)


def _chunked_compress(src: bytes, chunk_size: int | None = None,
                      matches: bool = False) -> bytes:
    """TfFastCompression wrapper. Default: one bare literals-only block
    (leading 0 byte). chunk_size splits into the multi-chunk layout real
    exporters write for large sections (count byte + per-chunk int32
    sizes); matches=True uses the hash-match block compressor."""
    comp = lz4_compress_block_matches if matches else lz4_compress_block
    if chunk_size and len(src) > chunk_size:
        chunks = [src[i:i + chunk_size]
                  for i in range(0, len(src), chunk_size)]
        if len(chunks) > 255:
            raise ValueError("too many lz4 chunks")
        out = bytearray([len(chunks)])
        for c in chunks:
            enc = comp(c)
            out += struct.pack("<i", len(enc))
            out += enc
        return bytes(out)
    return b"\x00" + comp(src)


# ---------------------------------------------------------------------------
# compressed integers (pxr integerCoding.cpp: common-delta 2-bit codes)
# ---------------------------------------------------------------------------

def _decode_ints(buf: bytes, n: int, wide: bool = False) -> np.ndarray:
    """Decode n delta-coded ints from a decompressed integerCoding buffer."""
    if n == 0:
        return np.zeros(0, np.int64)
    csz = 8 if wide else 4
    common = int.from_bytes(buf[:csz], "little", signed=True)
    ncb = (n * 2 + 7) // 8
    code_bytes = np.frombuffer(buf[csz:csz + ncb], np.uint8)
    codes = np.zeros(ncb * 4, np.uint8)
    codes[0::4] = code_bytes & 3
    codes[1::4] = (code_bytes >> 2) & 3
    codes[2::4] = (code_bytes >> 4) & 3
    codes[3::4] = (code_bytes >> 6) & 3
    codes = codes[:n]
    data = np.frombuffer(buf, np.uint8, offset=csz + ncb)
    sizes = (np.array([0, 2, 4, 8]) if wide
             else np.array([0, 1, 2, 4]))[codes]
    offs = np.zeros(n, np.int64)
    np.cumsum(sizes[:-1], out=offs[1:])
    deltas = np.where(codes == 0, np.int64(common), np.int64(0))
    widths = ((2, np.int16), (4, np.int32), (8, np.int64)) if wide else \
             ((1, np.int8), (2, np.int16), (4, np.int32))
    for ci, (w, dt) in enumerate(widths, start=1):
        sel = np.nonzero(codes == ci)[0]
        if sel.size:
            b = data[offs[sel][:, None] + np.arange(w)]
            deltas[sel] = b.view(dt).reshape(-1).astype(np.int64)
    return np.cumsum(deltas)


def _encode_ints(vals: np.ndarray, wide: bool = False,
                 minimal: bool = False) -> bytes:
    """Delta-code encoder. Default emits always-widest codes (valid, not
    minimal — the historical fixture writer). minimal=True emits what
    pxr's integerCoding does: the most frequent delta becomes the common
    value (code 0) and every other delta takes the smallest width that
    holds it — exercising the reader's 1/2(/4)-byte code branches the way
    real exporter files do."""
    n = len(vals)
    vals = np.asarray(vals, np.int64)
    deltas = np.diff(vals, prepend=np.int64(0))
    if minimal and n:
        if not wide:
            # the narrow stream carries int32 deltas; 0xFFFFFFFF fieldset
            # terminators wrap through int32 exactly like the widest-code
            # encoder (the reader masks back with & 0xFFFFFFFF)
            deltas = ((deltas + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int64)
        uniq, counts = np.unique(deltas, return_counts=True)
        lim = 2 ** 63 if wide else 2 ** 31
        ok = (uniq >= -lim) & (uniq < lim)
        cand = uniq[ok]
        common = int(cand[np.argmax(counts[ok])]) if cand.size else 0
        out = bytearray()
        out += int(common).to_bytes(8 if wide else 4, "little", signed=True)
        widths = (2, 4, 8) if wide else (1, 2, 4)
        codes = np.zeros(n, np.uint8)
        data = bytearray()
        for i, d in enumerate(deltas.tolist()):
            if d == common:
                continue
            for ci, w in enumerate(widths, start=1):
                lo, hi = -(1 << (8 * w - 1)), 1 << (8 * w - 1)
                if lo <= d < hi:
                    codes[i] = ci
                    data += int(d).to_bytes(w, "little", signed=True)
                    break
            else:
                raise ValueError(f"delta {d} out of range")
        ncb = (n * 2 + 7) // 8
        cb = np.zeros(ncb * 4, np.uint8)
        cb[:n] = codes
        packed = (cb[0::4] | (cb[1::4] << 2) | (cb[2::4] << 4)
                  | (cb[3::4] << 6))
        out += packed.tobytes()
        out += bytes(data)
        return bytes(out)
    out = bytearray()
    out += (0).to_bytes(8 if wide else 4, "little", signed=True)
    ncb = (n * 2 + 7) // 8
    codes = np.full(ncb * 4, 0, np.uint8)
    codes[:n] = 3
    packed = (codes[0::4] | (codes[1::4] << 2) | (codes[2::4] << 4)
              | (codes[3::4] << 6)).astype(np.uint8)
    out += packed.tobytes()
    out += deltas.astype(np.int64 if wide else np.int32).tobytes()
    return bytes(out)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Section:
    start: int
    size: int


class CrateReader:
    def __init__(self, data: bytes, path: str = ""):
        self.data = data
        self.path = path
        if data[:8] != _MAGIC:
            raise ValueError("not a usdc (crate) file")
        self.version = tuple(data[8:11])
        if self.version < (0, 4, 0):
            raise ValueError(
                f"crate version {self.version} predates section compression "
                "(0.4.0); re-export with a modern USD")
        (toc_off,) = struct.unpack_from("<q", data, 16)
        self.sections: dict[str, _Section] = {}
        (count,) = struct.unpack_from("<Q", data, toc_off)
        p = toc_off + 8
        for _ in range(count):
            name = data[p:p + 16].split(b"\0")[0].decode()
            start, size = struct.unpack_from("<qq", data, p + 16)
            self.sections[name] = _Section(start, size)
            p += 32
        self._pos = 0
        self.tokens: list[str] = []
        self.strings: np.ndarray | None = None  # string idx -> token idx
        self.fields: list[tuple[int, int]] = []  # (tokenIdx, rep)
        self.fieldsets: np.ndarray | None = None
        self.paths: list[str] = []
        self.specs: list[tuple[int, int, int]] = []
        self._warned: set[str] = set()
        self._read_tokens()
        self._read_strings()
        self._read_fields()
        self._read_fieldsets()
        self._read_paths()
        self._read_specs()

    # -- primitive reads ----------------------------------------------------
    def _seek(self, pos: int) -> None:
        self._pos = pos

    def _read(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.data, self._pos)
        self._pos += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def _read_bytes(self, n: int) -> bytes:
        b = self.data[self._pos:self._pos + n]
        self._pos += n
        return b

    def _read_compressed_ints(self, n: int, wide: bool = False) -> np.ndarray:
        comp_size = self._read("Q")
        buf = _chunked_decompress(self._read_bytes(comp_size),
                                  (8 if wide else 4) * (n + 4) + n)
        return _decode_ints(buf, n, wide)

    # -- sections -----------------------------------------------------------
    def _read_tokens(self) -> None:
        s = self.sections["TOKENS"]
        self._seek(s.start)
        n = self._read("Q")
        uncompressed = self._read("Q")
        comp_size = self._read("Q")
        chars = _chunked_decompress(self._read_bytes(comp_size), uncompressed)
        self.tokens = chars.decode("utf-8", errors="replace").split("\0")[:n]

    def _read_strings(self) -> None:
        s = self.sections["STRINGS"]
        self._seek(s.start)
        n = self._read("Q")
        self.strings = np.frombuffer(self.data, np.uint32, count=n,
                                     offset=self._pos)

    def _read_fields(self) -> None:
        s = self.sections["FIELDS"]
        self._seek(s.start)
        n = self._read("Q")
        token_idx = self._read_compressed_ints(n)
        reps_size = self._read("Q")
        reps = np.frombuffer(
            _chunked_decompress(self._read_bytes(reps_size), 8 * n),
            np.uint64, count=n)
        self.fields = list(zip(token_idx.tolist(), reps.tolist()))

    def _read_fieldsets(self) -> None:
        s = self.sections["FIELDSETS"]
        self._seek(s.start)
        n = self._read("Q")
        # delta coding wraps the 0xFFFFFFFF set terminators through int32;
        # consume as uint32 (pxr reads these back as uint32 the same way)
        self.fieldsets = self._read_compressed_ints(n) & 0xFFFFFFFF

    def _read_paths(self) -> None:
        s = self.sections["PATHS"]
        self._seek(s.start)
        total = self._read("Q")
        self.paths = [""] * total
        n = self._read("Q")  # encoded path count
        path_idx = self._read_compressed_ints(n)
        elem_tok = self._read_compressed_ints(n)
        jumps = self._read_compressed_ints(n)
        # jump-encoded DFS (crateFile _BuildDecompressedPathsImpl):
        # jump > 0: child next, sibling at +jump; -1: child only;
        # 0: sibling next, no child; -2: leaf
        stack = [(0, None)]  # (index, parent path string or None=root)
        while stack:
            cur, parent = stack.pop()
            while True:
                j = int(jumps[cur])
                if parent is None:
                    self.paths[path_idx[cur]] = "/"
                    this_path = ""
                else:
                    tok = self.tokens[abs(int(elem_tok[cur]))]
                    if int(elem_tok[cur]) < 0:
                        this_path = f"{parent}.{tok}"
                    else:
                        this_path = f"{parent}/{tok}"
                    self.paths[path_idx[cur]] = this_path
                has_child = j > 0 or j == -1
                has_sibling = j >= 0
                if has_child and has_sibling:
                    stack.append((cur + j, parent))
                if has_child:
                    parent = this_path if parent is not None else ""
                    cur += 1
                elif has_sibling:
                    cur += 1
                else:
                    break

    def _read_specs(self) -> None:
        s = self.sections["SPECS"]
        self._seek(s.start)
        n = self._read("Q")
        path_idx = self._read_compressed_ints(n)
        fset_idx = self._read_compressed_ints(n)
        spec_types = self._read_compressed_ints(n)
        self.specs = list(zip(path_idx.tolist(), fset_idx.tolist(),
                              spec_types.tolist()))

    # -- values ---------------------------------------------------------
    def _token(self, i: int) -> str:
        return self.tokens[i]

    def _string(self, i: int) -> str:
        return self.tokens[int(self.strings[i])]

    def _warn_once(self, what: str) -> None:
        if what not in self._warned:
            self._warned.add(what)
            get_logger().info("usdc %s: %s not decoded", self.path, what)

    def value(self, rep: int) -> Any:
        ty = (rep >> 48) & 0xFF
        payload = rep & _REP_PAYLOAD_MASK
        is_array = bool(rep & _REP_ARRAY)
        inlined = bool(rep & _REP_INLINED)
        compressed = bool(rep & _REP_COMPRESSED)
        try:
            return self._value(ty, payload, is_array, inlined, compressed)
        except Exception as e:  # noqa: BLE001 — unknown layouts must not kill the load
            self._warn_once(f"value type {ty} ({e.__class__.__name__}: {e})")
            return None

    def _elem_count(self) -> int:
        if self.version >= (0, 7, 0):
            return self._read("Q")
        return self._read("I")

    def _value(self, ty: int, payload: int, is_array: bool, inlined: bool,
               compressed: bool) -> Any:
        if is_array:
            return self._array_value(ty, payload, compressed)
        if ty in (T_TOKEN, T_ASSETPATH):
            if inlined:
                return self._token(payload)
            self._seek(payload)
            return self._token(self._read("I"))
        if ty == T_STRING:
            return self._string(payload)
        if ty == T_SPECIFIER:
            return _SPECIFIERS.get(payload, "def")
        if ty in (T_PERMISSION, T_VARIABILITY):
            return payload
        if ty == T_BOOL:
            return bool(payload & 1)
        if ty in (T_INT, T_UINT, T_INT64, T_UINT64, T_UCHAR):
            if inlined:
                v = payload & 0xFFFFFFFF
                if ty == T_INT and v >= 0x80000000:
                    v -= 0x100000000
                return int(v)
            self._seek(payload)
            return int(self._read(_POD[ty][0]))
        if ty in (T_HALF, T_FLOAT, T_DOUBLE):
            if inlined:
                # doubles/halves inline as a float bit pattern
                return float(np.frombuffer(
                    struct.pack("<I", payload & 0xFFFFFFFF), np.float32)[0])
            self._seek(payload)
            return float(self._read(_POD[ty][0]))
        if ty in _POD:  # vectors / quats / matrices
            fmt, arity = _POD[ty]
            dim = {T_MATRIX2D: 2, T_MATRIX3D: 3, T_MATRIX4D: 4}.get(ty)
            if inlined:
                # inlined as packed int8 components (diagonal for matrices)
                b = struct.pack("<q", payload)
                comps = np.frombuffer(b, np.int8)
                if dim is not None:
                    m = np.zeros((dim, dim))
                    np.fill_diagonal(m, comps[:dim])
                    return tuple(tuple(row) for row in m.tolist())
                k = arity
                return tuple(float(c) for c in comps[:k])
            self._seek(payload)
            vals = self._read(fmt * arity)
            if dim is not None:
                # nested row tuples (the text parser's matrix convention)
                return tuple(tuple(vals[r * dim:(r + 1) * dim])
                             for r in range(dim))
            return tuple(vals) if arity > 1 else vals
        if ty == T_DICTIONARY:
            if inlined:
                return {}
            self._seek(payload)
            return self._read_dict()
        if ty in (T_TOKEN_VECTOR, T_PATH_VECTOR, T_STRING_VECTOR,
                  T_DOUBLE_VECTOR):
            if inlined:
                return []
            self._seek(payload)
            n = self._elem_count()
            if ty == T_DOUBLE_VECTOR:
                return list(self._read("d" * n)) if n else []
            idx = [self._read("I") for _ in range(n)]
            if ty == T_TOKEN_VECTOR:
                return [self._token(i) for i in idx]
            if ty == T_STRING_VECTOR:
                return [self._string(i) for i in idx]
            return [self.paths[i] for i in idx]
        if ty in (T_TOKEN_LISTOP, T_STRING_LISTOP, T_PATH_LISTOP,
                  T_INT_LISTOP, T_INT64_LISTOP, T_UINT_LISTOP,
                  T_UINT64_LISTOP, T_REFERENCE_LISTOP, T_PAYLOAD_LISTOP):
            if inlined:
                return []
            self._seek(payload)
            return self._read_listop(ty)
        if ty == T_VARIANT_SELECTION_MAP:
            if inlined:
                return {}
            self._seek(payload)
            n = self._read("Q")
            out = {}
            for _ in range(n):
                k = self._string(self._read("I"))
                v = self._string(self._read("I"))
                out[k] = v
            return out
        if ty == T_VALUE_BLOCK:
            return None
        if ty == T_VALUE:
            self._seek(payload)
            return self.value(self._read("Q"))
        if ty == T_TIME_SAMPLES:
            # RecursiveRead layout (crateFile.cpp): at payload, an int64
            # offset relative to its own start locates the times ValueRep
            # (8 bytes); immediately after THAT rep, a second relative
            # int64 locates [uint64 count][count x ValueRep] for the
            # per-sample values. Returns {time: value}.
            self._seek(payload)
            off1 = self._read("q")
            self._seek(payload + off1)
            times_rep = self._read("Q")
            pos = self._pos  # right after the times rep
            times = self.value(times_rep)
            self._seek(pos)
            off2 = self._read("q")
            self._seek(pos + off2)
            n = self._read("Q")
            reps = [self._read("Q") for _ in range(n)]
            vals = [self.value(rp) for rp in reps]
            if not isinstance(times, (list, tuple)):
                times = []
            return {float(t): v for t, v in zip(times, vals)}
        self._warn_once(f"value type {ty}")
        return None

    def _array_value(self, ty: int, payload: int, compressed: bool) -> Any:
        self._seek(payload)
        n = self._elem_count()
        if n == 0:
            return []
        if compressed and ty in (T_INT, T_UINT, T_INT64, T_UINT64):
            wide = ty in (T_INT64, T_UINT64)
            return self._read_compressed_ints(n, wide).tolist()
        if compressed and ty in (T_FLOAT, T_DOUBLE, T_HALF):
            code = self._read_bytes(1)
            if code == b"i":  # integral floats stored as compressed ints
                return self._read_compressed_ints(n).astype(
                    np.float64).tolist()
            if code == b"t":  # lookup table + compressed indexes
                lut_n = self._read("I")
                dt = {T_FLOAT: np.float32, T_DOUBLE: np.float64,
                      T_HALF: np.float16}[ty]
                lut = np.frombuffer(self.data, dt, count=lut_n,
                                    offset=self._pos)
                self._pos += lut_n * dt().itemsize
                idx = self._read_compressed_ints(n)
                return lut[idx].astype(np.float64).tolist()
            raise ValueError(f"unknown float compression code {code!r}")
        if ty in (T_TOKEN, T_ASSETPATH, T_STRING):
            idx = np.frombuffer(self.data, np.uint32, count=n,
                                offset=self._pos)
            if ty == T_STRING:
                return [self._string(int(i)) for i in idx]
            return [self._token(int(i)) for i in idx]
        fmt, arity = _POD[ty]
        dt = {"f": np.float32, "d": np.float64, "e": np.float16,
              "i": np.int32, "I": np.uint32, "q": np.int64, "Q": np.uint64,
              "B": np.uint8, "?": np.uint8}[fmt]
        a = np.frombuffer(self.data, dt, count=n * arity, offset=self._pos)
        if arity > 1:
            return [tuple(r) for r in a.reshape(n, arity).tolist()]
        return a.tolist()

    def _read_dict(self) -> dict:
        n = self._read("Q")
        out = {}
        for _ in range(n):
            key = self._string(self._read("I"))
            # recursive value: 8-byte rep whose payload references data
            # written before it
            rep = self._read("Q")
            pos = self._pos
            out[key] = self.value(rep)
            self._pos = pos
        return out

    def _read_listop(self, ty: int) -> list:
        h = self._read("B")
        # flags (sdf listOp serialization): 1 explicit, 2 explicit items,
        # 4 added, 8 prepended, 16 appended, 32 deleted, 64 ordered
        items: list = []

        def read_items():
            n = self._read("Q")
            vals = []
            for _ in range(n):
                if ty in (T_TOKEN_LISTOP,):
                    vals.append(self._token(self._read("I")))
                elif ty == T_STRING_LISTOP:
                    vals.append(self._string(self._read("I")))
                elif ty == T_PATH_LISTOP:
                    vals.append(self.paths[self._read("I")])
                elif ty in (T_INT_LISTOP, T_UINT_LISTOP):
                    vals.append(self._read("i"))
                elif ty in (T_INT64_LISTOP, T_UINT64_LISTOP):
                    vals.append(self._read("q"))
                elif ty in (T_REFERENCE_LISTOP, T_PAYLOAD_LISTOP):
                    # SdfReference/SdfPayload: asset (string), prim path,
                    # layer offset (2 doubles); references also carry a
                    # custom-data dict
                    asset = self._string(self._read("I"))
                    prim_path = self.paths[self._read("I")]
                    self._read("dd")
                    if ty == T_REFERENCE_LISTOP:
                        self._read_dict()
                    vals.append((asset, f"<{prim_path}>" if prim_path != "/"
                                 and prim_path else None))
            return vals

        for bit in (2, 4, 8, 16, 32, 64):
            if h & bit:
                got = read_items()
                if bit in (2, 4, 8, 16):  # explicit/added/prepended/appended
                    items.extend(got)
        return items


def _set_attr_meta(attr: Attr, name: str, value: Any) -> None:
    if name == "interpolation":
        attr.meta["interpolation"] = value
    elif name == "colorSpace":
        attr.meta["colorSpace"] = value
    elif name not in ("default", "typeName", "variability", "custom",
                      "timeSamples", "targetPaths", "targetChildren",
                      "connectionPaths", "connectionChildren"):
        attr.meta[name] = value


def read_usdc(data: bytes, path: str = "") -> Stage:
    """Decode crate bytes into the scene/usda.py Stage tree."""
    r = CrateReader(data, path=path)
    root = Prim(name="", type_name="", path="/")
    stage_meta: dict[str, Any] = {}

    def fieldset(idx: int) -> dict[str, Any]:
        out = {}
        i = idx
        fs = r.fieldsets
        while i < len(fs) and fs[i] != 0xFFFFFFFF:
            tok_i, rep = r.fields[int(fs[i])]
            out[r.tokens[tok_i]] = r.value(rep)
            i += 1
        return out

    def ensure_prim(p: str) -> Prim:
        if p == "/" or p == "":
            return root
        parts = [s for s in p.split("/") if s]
        prim = root
        for part in parts:
            nxt = prim.children.get(part)
            if nxt is None:
                nxt = Prim(name=part, type_name="",
                           path=(prim.path.rstrip("/") + "/" + part))
                prim.children[part] = nxt
            prim = nxt
        return prim

    # prims first so properties find their parents regardless of spec order
    ordered = sorted(r.specs, key=lambda s: 0 if s[2] in (
        SPEC_PSEUDO_ROOT, SPEC_PRIM, SPEC_VARIANT, SPEC_VARIANT_SET) else 1)
    for path_i, fset_i, spec_ty in ordered:
        spath = r.paths[int(path_i)]
        fields = fieldset(int(fset_i))
        if spec_ty == SPEC_PSEUDO_ROOT:
            stage_meta.update({k: v for k, v in fields.items()
                               if k not in ("primChildren",)})
        elif spec_ty in (SPEC_PRIM, SPEC_VARIANT, SPEC_VARIANT_SET):
            if spec_ty == SPEC_VARIANT_SET:
                continue  # organizational; variants attach via their paths
            prim = ensure_prim(spath)
            tn = fields.get("typeName")
            if isinstance(tn, str):
                prim.type_name = tn
            for k, v in fields.items():
                if k in ("typeName", "primChildren", "properties"):
                    continue
                if k == "specifier":
                    prim.meta["specifier"] = v
                elif k == "variantSelection":
                    prim.meta["variants"] = v
                elif k == "variantSetNames":
                    prim.meta["variantSets"] = v
                elif k == "references":
                    prim.meta["references"] = v
                elif k == "payload":
                    prim.meta["payload"] = v
                else:
                    prim.meta[k] = v
        elif spec_ty in (SPEC_ATTRIBUTE, SPEC_CONNECTION):
            prim_path, _, attr_name = spath.rpartition(".")
            prim = ensure_prim(prim_path)
            attr = prim.attrs.get(attr_name)
            if attr is None:
                attr = Attr(type_name="", value=None)
                prim.attrs[attr_name] = attr
            tn = fields.get("typeName")
            if isinstance(tn, str):
                attr.type_name = tn
            if "default" in fields:
                attr.value = fields["default"]
            ts = fields.get("timeSamples")
            if isinstance(ts, dict) and ts:
                attr.time_samples = {float(k): v for k, v in ts.items()}
                if attr.value is None:
                    attr.value = attr.time_samples[min(attr.time_samples)]
            conns = fields.get("connectionPaths")
            if conns:
                attr.connect = conns[0]
            for k, v in fields.items():
                _set_attr_meta(attr, k, v)
        elif spec_ty == SPEC_RELATIONSHIP:
            prim_path, _, rel_name = spath.rpartition(".")
            prim = ensure_prim(prim_path)
            targets = fields.get("targetPaths") or fields.get(
                "targetChildren") or []
            prim.rels[rel_name] = [f"{t}" for t in targets]

    return Stage(root=root, meta=stage_meta, path=path)


# ---------------------------------------------------------------------------
# writer (fixture-grade, version 0.8.0)
# ---------------------------------------------------------------------------

class _CrateWriter:
    def __init__(self, adversarial: bool = False,
                 chunk_size: int = 1024) -> None:
        # adversarial mode emits the layouts REAL exporters write that the
        # easy fixture subset never exercises: minimal-width delta codes,
        # multi-chunk TfFastCompression, match-bearing lz4 blocks,
        # compressed int arrays, and float arrays through the 'i'
        # (integral) / 't' (lookup-table) compression codes
        self.adversarial = adversarial
        self.chunk_size = chunk_size if adversarial else None
        self.tokens: list[str] = []
        self._token_idx: dict[str, int] = {}
        self.string_idx: list[int] = []
        self._string_map: dict[str, int] = {}
        self.fields: list[tuple[int, int]] = []
        self._field_map: dict[tuple[int, int], int] = {}
        self.fieldsets: list[int] = []
        self.paths: dict[str, int] = {}
        self.specs: list[tuple[int, int, int]] = []
        self.body = bytearray(b"\0" * 88)  # bootstrap placeholder

    def token(self, t: str) -> int:
        i = self._token_idx.get(t)
        if i is None:
            i = len(self.tokens)
            self.tokens.append(t)
            self._token_idx[t] = i
        return i

    def string(self, s: str) -> int:
        i = self._string_map.get(s)
        if i is None:
            i = len(self.string_idx)
            self.string_idx.append(self.token(s))
            self._string_map[s] = i
        return i

    def path_index(self, p: str) -> int:
        if p not in self.paths:
            self.paths[p] = len(self.paths)
        return self.paths[p]

    def _append(self, b: bytes) -> int:
        off = len(self.body)
        self.body += b
        return off

    def rep(self, value: Any, type_name: str = "") -> int:
        """Encode a python value as a ValueRep (+ out-of-line data)."""
        if isinstance(value, bool):
            return (T_BOOL << 48) | _REP_INLINED | int(value)
        if isinstance(value, int):
            return (T_INT << 48) | _REP_INLINED | (value & 0xFFFFFFFF)
        if isinstance(value, float):
            (bits,) = struct.unpack("<I", struct.pack("<f", value))
            return (T_FLOAT << 48) | _REP_INLINED | bits
        if isinstance(value, str):
            return (T_TOKEN << 48) | _REP_INLINED | self.token(value)
        if isinstance(value, tuple) and all(
                isinstance(x, (int, float)) for x in value):
            ty = {2: T_VEC2F, 3: T_VEC3F, 4: T_VEC4F,
                  16: T_MATRIX4D}.get(len(value))
            if ty is None:
                raise ValueError(f"unsupported tuple arity {len(value)}")
            fmt, arity = _POD[ty]
            off = self._append(struct.pack("<" + fmt * arity, *value))
            return (ty << 48) | off
        if isinstance(value, dict):
            payload = bytearray(struct.pack("<Q", len(value)))
            for k, v in value.items():
                payload += struct.pack("<I", self.string(str(k)))
                payload += struct.pack("<Q", self.rep(v))
            off = self._append(bytes(payload))
            return (T_DICTIONARY << 48) | off
        if isinstance(value, tuple) and value and all(
                isinstance(x, tuple) for x in value):
            flat = tuple(c for row in value for c in row)
            if len(flat) in (4, 9, 16) and len(value) in (2, 3, 4):
                return self.rep(flat)  # matrix rows
            return self._array_rep(list(value), type_name)
        if isinstance(value, (list, np.ndarray)):
            return self._array_rep(value, type_name)
        raise ValueError(f"unsupported crate value {type(value)}")

    def _array_rep(self, value, type_name: str) -> int:
        arr = value
        if len(arr) and isinstance(arr[0], str):
            if type_name.startswith("string"):
                idx = [self.string(t) for t in arr]
                payload = struct.pack("<Q", len(arr)) + struct.pack(
                    "<" + "I" * len(arr), *idx)
                off = self._append(payload)
                return (T_STRING_VECTOR << 48) | off
            idx = [self.token(t) for t in arr]
            payload = struct.pack("<Q", len(arr)) + struct.pack(
                "<" + "I" * len(arr), *idx)
            off = self._append(payload)
            return (T_TOKEN_VECTOR << 48) | off
        a = np.asarray(arr)
        if a.ndim == 3 and a.shape[1] == a.shape[2] and a.shape[1] in (2, 3, 4):
            # matrixNd[] (e.g. UsdSkel bind/restTransforms): each matrix is
            # a flat row-major d-run; the reader's POD-array branch hands
            # back 16-tuples (pxr: CrateFile array-of-Matrix4d)
            ty = {2: T_MATRIX2D, 3: T_MATRIX3D, 4: T_MATRIX4D}[a.shape[1]]
            a = a.astype(np.float64).reshape(len(a), -1)
            off = self._append(struct.pack("<Q", len(a)) + a.tobytes())
            return (ty << 48) | _REP_ARRAY | off
        if a.ndim == 2:
            ty = {2: T_VEC2F, 3: T_VEC3F, 4: T_VEC4F}[a.shape[1]]
            a = a.astype(np.float32)
        elif np.issubdtype(a.dtype, np.integer):
            ty = T_INT
            a = a.astype(np.int32)
            if self.adversarial and len(a):
                comp = self._comp_ints_blob(a)
                off = self._append(struct.pack("<Q", len(a)) + comp)
                return (ty << 48) | _REP_ARRAY | _REP_COMPRESSED | off
        else:
            ty = T_FLOAT if "float" in (type_name or "float") else T_DOUBLE
            dt = np.float32 if ty == T_FLOAT else np.float64
            a = a.astype(dt)
            if self.adversarial and len(a):
                integral = np.all(a == np.floor(a)) and np.all(
                    np.abs(a) < 2 ** 30)
                uniq = np.unique(a)
                if integral:
                    # 'i': integral floats stored as compressed ints
                    comp = self._comp_ints_blob(a.astype(np.int64))
                    off = self._append(
                        struct.pack("<Q", len(a)) + b"i" + comp)
                    return (ty << 48) | _REP_ARRAY | _REP_COMPRESSED | off
                if uniq.size <= min(1024, len(a)):
                    # 't': lookup table + compressed indexes
                    idx = np.searchsorted(uniq, a)
                    comp = self._comp_ints_blob(idx.astype(np.int64))
                    off = self._append(
                        struct.pack("<Q", len(a)) + b"t"
                        + struct.pack("<I", uniq.size)
                        + uniq.astype(dt).tobytes() + comp)
                    return (ty << 48) | _REP_ARRAY | _REP_COMPRESSED | off
        off = self._append(struct.pack("<Q", len(a)) + a.tobytes())
        return (ty << 48) | _REP_ARRAY | off

    def _comp_ints_blob(self, vals: np.ndarray) -> bytes:
        """[Q compSize][chunked lz4] of a delta-coded int stream — the
        layout _read_compressed_ints consumes."""
        enc = _chunked_compress(
            _encode_ints(np.asarray(vals, np.int64),
                         minimal=self.adversarial),
            chunk_size=self.chunk_size, matches=self.adversarial)
        return struct.pack("<Q", len(enc)) + enc

    def field(self, name: str, rep: int) -> int:
        key = (self.token(name), rep)
        i = self._field_map.get(key)
        if i is None:
            i = len(self.fields)
            self.fields.append(key)
            self._field_map[key] = i
        return i

    def fieldset(self, field_indices: list[int]) -> int:
        start = len(self.fieldsets)
        self.fieldsets.extend(field_indices)
        self.fieldsets.append(0xFFFFFFFF)
        return start

    def spec(self, path: str, spec_type: int,
             fields: dict[str, int]) -> None:
        fidx = [self.field(k, rep) for k, rep in fields.items()]
        self.specs.append((self.path_index(path), self.fieldset(fidx),
                           spec_type))

    # -- path table encoding (inverse of _read_paths) -----------------------
    def _encode_paths(self):
        # organize paths into the prim/property tree; "/" must exist
        self.path_index("/")
        children: dict[str, list[str]] = {}
        all_paths = sorted(self.paths, key=lambda p: (p.count("/") +
                                                      p.count("."), p))
        for p in all_paths:
            if p == "/":
                continue
            if "." in p:
                parent = p.rpartition(".")[0]
            else:
                parent = p.rpartition("/")[0] or "/"
            self.path_index(parent)  # ensure interior nodes exist
        for p in sorted(self.paths):
            if p == "/":
                continue
            parent = (p.rpartition(".")[0] if "." in p
                      else (p.rpartition("/")[0] or "/"))
            children.setdefault(parent, []).append(p)

        path_idx: list[int] = []
        elem_tok: list[int] = []
        jumps: list[int] = []

        def emit2(p: str, has_sibling: bool) -> int:
            """Emit subtree rooted at p; returns its start slot."""
            slot = len(path_idx)
            path_idx.append(self.paths[p])
            if p == "/":
                elem_tok.append(0)
            elif "." in p:
                elem_tok.append(-self.token(p.rpartition(".")[2]))
            else:
                elem_tok.append(self.token(p.rpartition("/")[2]))
            jumps.append(0)
            kids = children.get(p, [])
            has_child = bool(kids)
            if has_child:
                for i, k in enumerate(kids):
                    emit2(k, has_sibling=(i < len(kids) - 1))
            if has_child and has_sibling:
                # sibling follows the whole subtree
                jumps[slot] = len(path_idx) - slot
            elif has_child:
                jumps[slot] = -1
            elif has_sibling:
                jumps[slot] = 0
            else:
                jumps[slot] = -2
            return slot

        emit2("/", has_sibling=False)
        return (np.asarray(path_idx, np.int64),
                np.asarray(elem_tok, np.int64),
                np.asarray(jumps, np.int64))

    def tobytes(self) -> bytes:
        sections = []

        def comp_ints(vals, wide=False) -> bytes:
            enc = _chunked_compress(
                _encode_ints(np.asarray(vals, np.int64), wide,
                             minimal=self.adversarial),
                chunk_size=self.chunk_size, matches=self.adversarial)
            return struct.pack("<Q", len(enc)) + enc

        # paths first: encoding mints the path-element tokens, which must
        # exist before the TOKENS section serializes
        pi, et, jm = self._encode_paths()
        # TOKENS
        blob = ("\0".join(self.tokens)).encode() + b"\0"
        comp = _chunked_compress(blob, chunk_size=self.chunk_size,
                                 matches=self.adversarial)
        sections.append(("TOKENS", struct.pack(
            "<QQQ", len(self.tokens), len(blob), len(comp)) + comp))
        # STRINGS
        sections.append(("STRINGS", struct.pack(
            "<Q" + "I" * len(self.string_idx), len(self.string_idx),
            *self.string_idx)))
        # FIELDS
        reps_blob = _chunked_compress(
            np.asarray([rep for _, rep in self.fields], np.uint64).tobytes(),
            chunk_size=self.chunk_size, matches=self.adversarial)
        sections.append(("FIELDS", struct.pack("<Q", len(self.fields))
                         + comp_ints([t for t, _ in self.fields])
                         + struct.pack("<Q", len(reps_blob)) + reps_blob))
        # FIELDSETS
        sections.append(("FIELDSETS", struct.pack("<Q", len(self.fieldsets))
                         + comp_ints(self.fieldsets)))
        # PATHS
        sections.append(("PATHS", struct.pack("<QQ", len(self.paths), len(pi))
                         + comp_ints(pi) + comp_ints(et) + comp_ints(jm)))
        # SPECS
        sections.append(("SPECS", struct.pack("<Q", len(self.specs))
                         + comp_ints([s[0] for s in self.specs])
                         + comp_ints([s[1] for s in self.specs])
                         + comp_ints([s[2] for s in self.specs])))

        toc_entries = []
        for name, payload in sections:
            start = self._append(payload)
            toc_entries.append((name, start, len(payload)))
        toc_off = len(self.body)
        self.body += struct.pack("<Q", len(toc_entries))
        for name, start, size in toc_entries:
            self.body += name.encode().ljust(16, b"\0")
            self.body += struct.pack("<qq", start, size)
        header = _MAGIC + bytes([0, 8, 0]) + b"\0" * 5 + struct.pack(
            "<q", toc_off)
        self.body[:len(header)] = header
        return bytes(self.body)


def write_usdc(stage: Stage, adversarial: bool = False) -> bytes:
    """Serialize a Stage tree to crate bytes. adversarial=True emits the
    hard layouts real exporters produce (minimal-width delta codes,
    multi-chunk + match-bearing lz4, 'i'/'t' float compression,
    compressed int arrays) so reader tests cover those decode paths."""
    w = _CrateWriter(adversarial=adversarial)
    root_fields = {k: w.rep(v) for k, v in stage.meta.items()}
    w.spec("/", SPEC_PSEUDO_ROOT, root_fields)

    def visit(prim: Prim) -> None:
        fields: dict[str, int] = {"specifier": (T_SPECIFIER << 48)
                                  | _REP_INLINED | 0}
        if prim.type_name:
            fields["typeName"] = w.rep(prim.type_name)
        for k, v in prim.meta.items():
            if k == "specifier":
                continue
            if k == "variants" and isinstance(v, dict):
                payload = bytearray(struct.pack("<Q", len(v)))
                for vk, vv in v.items():
                    payload += struct.pack("<I", w.string(str(vk)))
                    payload += struct.pack("<I", w.string(str(vv)))
                off = w._append(bytes(payload))
                fields["variantSelection"] = (
                    T_VARIANT_SELECTION_MAP << 48) | off
            elif k == "variantSets":
                names = v if isinstance(v, list) else [v]
                # StringListOp with explicit items
                payload = bytearray([2])
                payload += struct.pack("<Q", len(names))
                for nm in names:
                    payload += struct.pack("<I", w.string(str(nm)))
                off = w._append(bytes(payload))
                fields["variantSetNames"] = (T_STRING_LISTOP << 48) | off
            else:
                try:
                    fields[k] = w.rep(v)
                except ValueError:
                    pass
        is_variant = prim.name.startswith("{")
        w.spec(prim.path, SPEC_VARIANT if is_variant else SPEC_PRIM, fields)
        for aname, attr in prim.attrs.items():
            afields: dict[str, int] = {}
            if attr.type_name:
                afields["typeName"] = w.rep(attr.type_name)
            if attr.value is not None:
                afields["default"] = w.rep(attr.value, attr.type_name)
            if attr.time_samples:
                # RecursiveRead layout mirrored by the reader's
                # T_TIME_SAMPLES branch: [i64 +8][times rep][i64 +8]
                # [u64 count][count x rep]. Pack child reps FIRST — they
                # append out-of-line data to the body.
                times = sorted(attr.time_samples)
                times_rep = w.rep([float(t) for t in times], "double[]")
                val_reps = [w.rep(attr.time_samples[t], attr.type_name)
                            for t in times]
                payload = struct.pack("<qQqQ", 8, times_rep, 8, len(times))
                payload += struct.pack("<" + "Q" * len(val_reps), *val_reps)
                off = w._append(payload)
                afields["timeSamples"] = (T_TIME_SAMPLES << 48) | off
            for mk, mv in attr.meta.items():
                try:
                    afields[mk] = w.rep(mv)
                except ValueError:
                    pass
            if attr.connect:
                # PathListOp, explicit items
                payload = bytearray([2]) + struct.pack("<Q", 1)
                payload += struct.pack("<I", w.path_index(str(attr.connect)))
                off = w._append(bytes(payload))
                afields["connectionPaths"] = (T_PATH_LISTOP << 48) | off
            w.spec(f"{prim.path}.{aname}", SPEC_ATTRIBUTE, afields)
        for rname, targets in prim.rels.items():
            payload = bytearray([2]) + struct.pack("<Q", len(targets))
            for t in targets:
                payload += struct.pack("<I", w.path_index(str(t)))
            off = w._append(bytes(payload))
            w.spec(f"{prim.path}.{rname}", SPEC_RELATIONSHIP,
                   {"targetPaths": (T_PATH_LISTOP << 48) | off})
        for child in prim.children.values():
            visit(child)

    for child in stage.root.children.values():
        visit(child)
    return w.tobytes()


def save_usdc(stage: Stage, path: str | os.PathLike) -> None:
    with open(path, "wb") as f:
        f.write(write_usdc(stage))
