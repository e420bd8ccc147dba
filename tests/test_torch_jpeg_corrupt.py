"""libjpeg-turbo's recovery from corrupt data, in the port's JPEG decoder
(imgio/jpeg.py and the native gatling_jpeg_decode_scan and islow IDCT),
against the JAX package's imgio (Pillow 12.1 over libjpeg-turbo).

1. Seeded scan corruption: a 48x64 gradient with seeded noise, saved by
   Pillow as baseline, progressive and with restart markers; for each
   seed, two bytes changed at positions drawn from [SOS + 20, len - 2).
   Each file meets the contract: the same array, or ValueError in both
   packages. What this holds the port to: a Huffman code no table has is
   read to 17 bits and decodes as 0; reading past a marker leaves every
   later MCU of the restart interval as it is and its DC prediction
   where it was (insufficient_data); restart markers resynchronise as
   jpeg_resync_to_restart does; the data ending inside a scan is a
   truncated file; the IDCT wraps and saturates as libjpeg-turbo's SIMD
   code does on coefficients that overflow 16 bits.
2. Markers after a scan, as libjpeg's read_markers meets them: unknown
   markers, a second SOI, SOF or (in a one-scan file) SOS, DAC segments,
   APPn and COM lengths below 2, frame types libjpeg refuses.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from gatling_tpu import imgio as jimgio

from gatling_tpu_torch import imgio

KINDS = {"baseline": {}, "progressive": {"progressive": True},
         "restart": {"restart_marker_blocks": 2}}
SEEDS_PER_CASE = 15


def gradient_with_noise() -> np.ndarray:
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:48, 0:64]
    base = np.stack([xx * 3, yy * 4, (xx + yy) * 2], -1).astype(float)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def pillow_jpeg(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def scan_start(data: bytes) -> int:
    """The offset just past the first SOS segment."""
    i = data.find(b"\xff\xda")
    return i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]


def corrupted(data: bytes, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    b = bytearray(data)
    lo = scan_start(data) + 20
    for _ in range(2):
        b[int(rng.integers(lo, len(b) - 2))] = int(rng.integers(0, 256))
    return bytes(b)


def contract(data: bytes) -> str:
    try:
        want = jimgio.load_image(data).data
    except ValueError:
        with pytest.raises(ValueError):
            imgio.load_image(data)
        return "rejected"
    got = imgio.load_image(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got != want).any(-1)
    assert not diff.any(), (int(diff.sum()), np.argwhere(diff)[:3].tolist())
    return "array"


@pytest.mark.parametrize("group", range(4))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_corrupt_scans_meet_the_contract(kind, group):
    """Seeds 0-59 of each kind, fifteen a case (seeds 12 and 38 of the
    baseline file were the fault's first witnesses)."""
    data = pillow_jpeg(gradient_with_noise(), **KINDS[kind])
    for seed in range(group * SEEDS_PER_CASE, (group + 1) * SEEDS_PER_CASE):
        contract(corrupted(data, seed))


def _after_scan() -> dict[str, bytes]:
    base = pillow_jpeg(gradient_with_noise())
    sof, sos, eoi = base.find(b"\xff\xc0"), base.find(b"\xff\xda"), base.rfind(b"\xff\xd9")

    def before_eoi(extra: bytes) -> bytes:
        return base[:eoi] + extra + base[eoi:]

    def before_sos(extra: bytes) -> bytes:
        return base[:sos] + extra + base[sos:]

    out = {"unknown_0x05": before_eoi(b"\xff\x05\x00\x02"),
           "dhp": before_eoi(b"\xff\xde\x00\x02"), "jpg0": before_eoi(b"\xff\xf0\x00\x02"),
           "jpg": before_eoi(b"\xff\xc8\x00\x02"),
           "second_sof": before_eoi(b"\xff\xc0" + base[sof + 2:sof + 19]),
           "second_sos": before_eoi(b"\xff\xda" + base[sos + 2:sos + 14]),
           "second_soi": before_eoi(b"\xff\xd8"), "dac_empty": before_eoi(b"\xff\xcc\x00\x02"),
           "dac_ok": before_sos(b"\xff\xcc\x00\x04\x00\x10"),
           "dac_bad_index": before_sos(b"\xff\xcc\x00\x04\x20\x11"),
           "dac_odd_length": before_sos(b"\xff\xcc\x00\x05\x00\x11\x00"),
           "app1_length_0": before_eoi(b"\xff\xe1\x00\x00"),
           "com_length_1": before_eoi(b"\xff\xfe\x00\x01"),
           "app14_past_the_end": base[:eoi] + b"\xff\xee\x7f\xff",
           "sos_long": base[:sos + 3] + bytes([base[sos + 3] + 1]) + base[sos + 4:]}
    for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        b = bytearray(base)
        b[sof + 1] = m
        out[f"sof{m - 0xC0}"] = bytes(b)
    return out


AFTER_SCAN = _after_scan()


@pytest.mark.parametrize("name", sorted(AFTER_SCAN))
def test_markers_as_read_markers_meets_them(name):
    contract(AFTER_SCAN[name])
