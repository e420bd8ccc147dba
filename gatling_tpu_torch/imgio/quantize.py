"""Pillow 12.1's adaptive palette, for the GIF writer (gif.py):
Image.convert("P", palette=ADAPTIVE) of an RGB image is the C quantize with
method 0, Quant.c's median cut; of an RGBA image it is Image.quantize, whose
default for RGBA is method 2, QuantOctree.c's fast octree. Both give 256
colours at most; the palette is in the order Pillow gives it, and so are
the indices.

`adaptive` runs the native library's gatling_quantize_mediancut and
gatling_quantize_octree; `mediancut_ref` and `octree_ref` are their NumPy
twins, which the card's path never takes.
"""

from __future__ import annotations

import ctypes

import numpy as np

from gatling_tpu_torch import native

COLORS = 256
MAX_HASH_ENTRIES = 65536
_U8 = ctypes.c_uint8


def _rgbx(img: np.ndarray) -> np.ndarray:
    """[N, 4] pixels as Pillow stores an RGB image (a padding byte of 255)."""
    px = np.full((img.shape[0] * img.shape[1], 4), 255, np.uint8)
    px[:, :3] = img.reshape(-1, 3)
    return px


def transparent_prepared(img: np.ndarray) -> np.ndarray:
    """[N, 4] RGBA pixels with every fully transparent pixel given the
    colour of the first one, as ImagingQuantize prepares an RGBA image."""
    px = np.ascontiguousarray(img.reshape(-1, 4)).copy()
    clear = np.flatnonzero(px[:, 3] == 0)
    if clear.size:
        px[clear, :3] = px[clear[0], :3]
    return px


def adaptive(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """img [H, W, 3] or [H, W, 4] uint8 -> (palette, indices [H, W]): an RGB
    image's palette [n, 3] of the median cut, an RGBA image's [256, 4] of
    the octree."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    idx = np.empty(h * w, np.uint8)
    lib = native.library()
    if c == 3:
        px = _rgbx(img)
        pal = np.zeros(COLORS * 3, np.uint8)
        n = lib.gatling_quantize_mediancut(native.ptr(px, _U8), h * w, COLORS,
                                           native.ptr(pal, _U8), native.ptr(idx, _U8))
        return pal[:3 * n].reshape(n, 3), idx.reshape(h, w)
    px = transparent_prepared(img)
    pal = np.zeros(COLORS * 4, np.uint8)
    lib.gatling_quantize_octree(native.ptr(px, _U8), h * w, COLORS, native.ptr(pal, _U8),
                                native.ptr(idx, _U8))
    return pal.reshape(COLORS, 4), idx.reshape(h, w)


# ---------------------------------------------------------------------------
# the NumPy twins
# ---------------------------------------------------------------------------

def _hash(r, g, b):
    r, g, b = (np.asarray(v, np.uint64) for v in (r, g, b))
    m = np.uint64(0xFFFFFFFF)
    return (((r * np.uint64(463)) & m) ^ (((g << np.uint64(8)) * np.uint64(10069)) & m)
            ^ (((b << np.uint64(16)) * np.uint64(64997)) & m))


class _Heap:
    """QuantHeap.c's 1-based max-heap of boxes by pixel count."""

    def __init__(self) -> None:
        self.h: list = [None]

    def add(self, box) -> None:
        self.h.append(None)
        k = len(self.h) - 1
        while k != 1 and box["count"] - self.h[k // 2]["count"] > 0:
            self.h[k] = self.h[k // 2]
            k >>= 1
        self.h[k] = box

    def remove(self):
        n = len(self.h) - 1
        if not n:
            return None
        top, v = self.h[1], self.h.pop()
        n -= 1
        k = 1
        while k * 2 <= n:
            j = k * 2
            if j < n and self.h[j]["count"] - self.h[j + 1]["count"] < 0:
                j += 1
            if v["count"] - self.h[j]["count"] > 0:
                break
            self.h[k] = self.h[j]
            k = j
        if n:
            self.h[k] = v
        return top


def mediancut_ref(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The NumPy twin of `adaptive` on an RGB image."""
    img = np.asarray(img, np.uint8)
    h, w, _ = img.shape
    px = img.reshape(-1, 3).astype(np.int64)
    # the distinct colours by hash, the first of each kept, the scale grown
    # while there are more than MAX_HASH_ENTRIES
    scale = 0
    first: dict[int, int] = {}
    counts: dict[int, int] = {}
    for i, (r, g, b) in enumerate(px.tolist()):
        key = int(_hash(r >> scale, g >> scale, b >> scale))
        if key in counts:
            counts[key] += 1
            continue
        first[key], counts[key] = i, 1
        while len(counts) > MAX_HASH_ENTRIES:
            scale += 1
            f2: dict[int, int] = {}
            c2: dict[int, int] = {}
            for key, j in first.items():
                r2, g2, b2 = (px[j] >> scale).tolist()
                k2 = int(_hash(r2, g2, b2))
                if k2 in c2:
                    c2[k2] += counts[key]
                else:
                    f2[k2], c2[k2] = j, counts[key]
            first, counts = f2, c2
    keys = list(first)
    vals = px[[first[k] for k in keys]] >> scale
    cnts = np.array([counts[k] for k in keys], np.int64)
    root = {"items": np.arange(len(keys)), "count": h * w, "l": None, "r": None}
    heap = _Heap()
    heap.add(root)
    for _ in range(COLORS - 1):
        while True:
            box = heap.remove()
            if box is None:
                break
            v = vals[box["items"]]
            if np.prod(v.max(0) - v.min(0) + 1) != 1:
                break
        if box is None:
            break
        v = vals[box["items"]]
        f = (v.max(0) - v.min(0)) * np.array([77, 150, 29])
        axis = int(np.argmax(f))  # the first of the largest
        col = v[:, axis]
        levels = np.unique(col)[::-1]
        per = np.array([cnts[box["items"]][col == lv].sum() for lv in levels])
        cum = np.cumsum(per)
        cut = int(np.argmax(cum * 2 > box["count"]))
        if cut == len(levels) - 1:
            cut -= 1
        left_mask = col >= levels[cut]
        lb = {"items": box["items"][left_mask], "count": int(cnts[box["items"][left_mask]].sum()),
              "l": None, "r": None}
        rb = {"items": box["items"][~left_mask], "count": box["count"] - lb["count"],
              "l": None, "r": None}
        box["l"], box["r"] = lb, rb
        heap.add(lb)
        heap.add(rb)
    entry = {}
    leaves = []

    def walk(b) -> None:
        if b["l"] is not None:
            walk(b["l"])
            walk(b["r"])
        else:
            for it in b["items"].tolist():
                entry[keys[it]] = len(leaves)
            leaves.append(b)

    walk(root)
    n = len(leaves)
    box_of = np.array([entry[int(k)] for k in _hash(px[:, 0] >> scale, px[:, 1] >> scale,
                                                   px[:, 2] >> scale).tolist()], np.int64)
    pal = np.zeros((n, 3), np.uint8)
    for e in range(n):
        sel = px[box_of == e]
        pal[e] = [int(0.5 + s / len(sel)) for s in sel.sum(0).tolist()]
    p64 = pal.astype(np.int64)
    dist = ((p64[:, None, :] - p64[None, :, :]) ** 2).sum(-1)
    order = np.argsort(dist, axis=1, kind="stable")
    idx = np.empty(h * w, np.uint8)
    memo: dict[tuple, int] = {}
    for i, p in enumerate(px.tolist()):
        t = tuple(p)
        if t in memo:
            idx[i] = memo[t]
            continue
        own = int(box_of[i])
        best = int(((p64[own] - p) ** 2).sum())
        match, bound = own, best << 2
        for j in order[own].tolist():
            if dist[own, j] > bound:
                break
            d = int(((p64[j] - p) ** 2).sum())
            if d < best:
                best, match = d, j
        idx[i] = memo[t] = match
    return pal, idx.reshape(h, w)


_FINE, _COARSE = (3, 4, 3, 3), (2, 2, 2, 2)


def _bucket(px: np.ndarray, bits) -> np.ndarray:
    off = (bits[1] + bits[2] + bits[3], bits[2] + bits[3], bits[3], 0)
    out = np.zeros(len(px), np.int64)
    for c in range(4):
        out |= (px[:, c].astype(np.int64) >> (8 - bits[c])) << off[c]
    return out


def _avg(sums: np.ndarray, count: np.ndarray) -> np.ndarray:
    """avg_color_from_color_bucket: float32 sums over a float32 count."""
    c = count.astype(np.float32)
    safe = np.where(c != 0, c, np.float32(1))
    q = (sums.astype(np.float32) / safe[:, None]).astype(np.int64)
    return np.where(c[:, None] != 0, np.clip(q, 0, 255), 0).astype(np.uint8)


def octree_ref(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The NumPy twin of `adaptive` on an RGBA image."""
    img = np.asarray(img, np.uint8)
    h, w, _ = img.shape
    px = transparent_prepared(img)
    nf, nc = 1 << sum(_FINE), 1 << sum(_COARSE)
    fb = _bucket(px, _FINE)
    f_cnt = np.bincount(fb, minlength=nf).astype(np.int64)
    f_sum = np.stack([np.bincount(fb, px[:, c].astype(np.int64), minlength=nf)
                      for c in range(4)], 1).astype(np.int64)
    # the coarse cube: each fine bucket's index with its low bits dropped
    fine_ids = np.arange(nf)
    parts = []
    shift = 0
    for c in (3, 2, 1, 0):
        parts.append(((fine_ids >> shift) & ((1 << _FINE[c]) - 1)) >> (_FINE[c] - _COARSE[c]))
        shift += _FINE[c]
    a_, b_, g_, r_ = parts
    to_coarse = (r_ << 6) | (g_ << 4) | (b_ << 2) | a_
    c_cnt = np.bincount(to_coarse, f_cnt, minlength=nc).astype(np.int64)
    c_sum = np.stack([np.bincount(to_coarse, f_sum[:, c], minlength=nc) for c in range(4)],
                     1).astype(np.int64)
    n_coarse = min(int((c_cnt > 0).sum()), COLORS)
    n_fine = COLORS - n_coarse
    order = np.argsort(-f_cnt, kind="stable")
    fs_cnt, fs_sum = f_cnt[order], f_sum[order]

    def subtract(lo: int, hi: int) -> None:
        for i in range(lo, hi):
            if fs_cnt[i] == 0:
                continue
            p = _avg(fs_sum[i:i + 1], fs_cnt[i:i + 1])
            k = int(_bucket(p, _COARSE)[0])
            c_cnt[k] -= fs_cnt[i]
            c_sum[k] -= fs_sum[i]

    subtract(0, n_fine)
    while n_coarse > int((c_cnt > 0).sum()):
        done = n_fine
        n_coarse = int((c_cnt > 0).sum())
        n_fine = COLORS - n_coarse
        subtract(done, n_fine)
    corder = np.argsort(-c_cnt, kind="stable")
    p_cnt = np.concatenate([c_cnt[corder][:n_coarse], fs_cnt[:n_fine]])
    p_sum = np.concatenate([c_sum[corder][:n_coarse], fs_sum[:n_fine]])
    pal = _avg(p_sum, p_cnt)
    lookup_coarse = np.zeros(nc, np.int64)
    for i in range(n_coarse - 1, -1, -1):
        lookup_coarse[_bucket(pal[i:i + 1], _COARSE)[0]] = i
    lookup = lookup_coarse[to_coarse]
    for i in range(n_coarse + n_fine - 1, n_coarse - 1, -1):
        lookup[_bucket(pal[i:i + 1], _FINE)[0]] = i
    return pal, lookup[fb].astype(np.uint8).reshape(h, w)
