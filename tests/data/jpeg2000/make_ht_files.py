"""Write the high-throughput JPEG 2000 files (HTJ2K, JPEG 2000 Part 15,
ITU-T T.814) and the Part 2 marker files of tests/test_torch_htj2k.py.

No encoder on hand writes an HT code-block (Pillow's saver and OpenJPEG's
own write MQ blocks), so this module holds one: the HT cleanup pass (the
MEL, VLC and MagSgn streams of T.814 clause 7), and for 3-pass blocks the
SigProp and MagRef passes, over the port's forward 5/3
(gatling_tpu_torch.imgio.jpeg2000.fdwt53) or a forward 9/7 of its own,
with tier 2 (tag trees, packet headers with HT segment lengths, precincts,
tiles and layers) and the codestream's markers (Rsiz's HT bit, CAP, CPF)
in raw codestreams, JP2 and JPH boxes. The Part 2 files splice MCT, MCC,
MCO and CBD markers (and CAP and CPF) into codestreams of this encoder.

Its first check is a round trip through Pillow (`round_trip`): each
reversible file decodes to the image the encoder meant, the input itself
for cleanup-only blocks, and for 3-pass blocks the input with the
coefficients that SigProp cannot reach dropped (`HtFile.expect`).

The files are committed, with ht_fixtures.npz: Pillow's array of each (the
1024^2 ground as its digest) for the card's host, which has no Pillow. Run
from the repository root:

    python tests/data/jpeg2000/make_ht_files.py
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))

# T.814's CxtVLC tables in OpenJPEG's packed decoder form (t1_ht_luts.h):
# 1024 entries a table, indexed by context << 7 | the next 7 VLC bits;
# bits 0-2 the codeword's length, 3 u_off, 4-7 rho, 8-11 e_1, 12-15 e_k.
# Table 0 is the first row of quads', table 1 the others'.
_VLC_HEX = (
    "002300a5004300660083a8ee0014d8df002310be0043f5ff0083207e0055515f002300350043444e0083c4ce0014cccf"
    "0023e2fe004399ff0083009600c5313f002300a50043445e0083c8ce001411df0023f4fe0043fcff0083009e00550077"
    "002300350043f1ff008388ae001400b70023f8fe0043e4ef0083888e00c5111f002300a5004300660083a8ee001454df"
    "002310be004322ef0083207e0055227f002300350043444e0083c4ce001411bf0023e2fe004300f70083009600c5223f"
    "002300a50043445e0083c8ce001400d70023f4fe0043baff0083009e0055006f002300350043e6ff008388ae0014a2af"
    "0023f8fe004300e70083888e00c5222f000200c50084207e0002c4ce002400f70002a2fe004400560002009e001400d7"
    "000210be00840066000288ae002411df0002a8ee004400360002888e0014111f000200c50084006e000288ce002488ff"
    "0002b8fe0044444e00020096001400b70002e4fe0084445e000200a6002400e7000254de0044222e0002003e00140077"
    "000200c50084207e0002c4ce0024f1ff0002a2fe004400560002009e001411bf000210be00840066000288ae002422ef"
    "0002a8ee004400360002888e0014227f000200c50084006e000288ce0024e4ef0002b8fe0044444e000200960014a2af"
    "0002e4fe0084445e000200a60024d8df000254de0044222e0002003e0014515f0002005500840066000288de002432ff"
    "000211fe0044444e000200ae001400b70002317e0084515e000200c6002400d7000220ee0044111e0002009e00140077"
    "000200550084545e000244ce002400e70002f1fe00440036000200a60014555f000274fe0084113e000220be0024747f"
    "0002c4de0044f8ff000200960014222f0002005500840066000288de002400f7000211fe0044444e000200ae0014888f"
    "0002317e0084515e000200c60024c8cf000220ee0044111e0002009e0014006f000200550084545e000244ce0024d1df"
    "0002f1fe00440036000200a60014227f000274fe0084113e000220be002422bf0002c4de004422ef000200960014323f"
    "0003d4def4fdfcff0014113e0055888f000332be008500e70025515eaafe727f000344cef8fd44ef0014647e0045a2af"
    "000300a6555d99dff1fd0036f5fe626f0003d1def4fde6ff0014717e0055b1bf000388ae0085d5df0025444ef2fe667f"
    "000300c6f8fde2ef0014545e0045119f00030096555dc8cff1fd111ec8ee00670003d4def4fdf3ff0014113e005511bf"
    "000332be0085d8df0025515eaafe222f000344cef8fd00f70014647e0045989f000300a6555d00d7f1fd0036f5fe446f"
    "0003d1def4fdb9ff0014717e005500b7000388ae0085dcdf0025444ef2fe0077000300c6f8fde4ef0014545e0045737f"
    "00030096555db8bff1fd111ec8ee323f000200a50084407e000210de002411df000272fe004400560002a8ae0014b2bf"
    "0002009600840066000200c6002400e70002c8ee0044222e0002888e00140077000200a50084006e000288ce002400f7"
    "000291fe004400360002a2ae0014aaaf0002b8fe0084005e000200be0024c4cf000244ee0044f4ff0002223e0014111f"
    "000200a50084407e000210de002499ff000272fe004400560002a8ae001400b70002009600840066000200c6002400d7"
    "0002c8ee0044222e0002888e0014444f000200a50084006e000288ce0024e2ef000291fe004400360002a2ae0014447f"
    "0002b8fe0084005e000200be0024009f000244ee004476ff0002223e0014313f000300c60085d9fff2fd647ef1fe99bf"
    "0003a2ae002566eff4fd0056e2ee737f000398be004500f7f8fd006676fe889f0003888e0015d5df00a5222e98de444f"
    "0003b2be0085fcfff2fd226e009600b70003aaae0025d1dff4fd0036d4de646f0003a8ae0045eaeff8fd445ee8ee717f"
    "0003323e0015c4cf00a5faff88ce313f000300c6008577fff2fd647ef1feb3bf0003a2ae002500e7f4fd0056e2ee0077"
    "000398be0045e4eff8fd006676fe667f0003888e001500d700a5222e98de333f0003b2be008575fff2fd226e0096919f"
    "0003aaae002599dff4fd0036d4de515f0003a8ae0045eceff8fd445ee8ee727f0003323e0015b1bf00a5f3ff88ce111f"
    "000354def2fd111e0014647ef8fecccf000391be004522ef0025222ef3fe888f000300c6008500f70014115efcfea8af"
    "000300a60035c8dff1fd313e66fe646f0003c8cef2fdf5ff00140066f4febabf000322ae004500e70025323eeafe737f"
    "0003b2be008555df00140056717e119f000300960035c4cff1fd333ee8ee444f000354def2fd111e0014647ef8fe99bf"
    "000391be0045e2ef0025222ef3fe667f000300c60085e4ef0014115efcfe989f000300a6003500d7f1fd313e66fe226f"
    "0003c8cef2fdb9ff00140066f4fe00b7000322ae0045d1df0025323eeafe00770003b2be0085ecef00140056717e727f"
    "000300960035b8bff1fd333ee8ee545ff1fcd1defafd00d7f8fc0016fffd747ff4fc717ef3fdb3bff2fceaefe8ee444f"
    "f1fc22ae0005b8bff8fc00f7fcfe0077f4fc115ef5fd757ff2fcd8dfe2ee333ff1fcb2befafd88cff8fcfbfffffd737f"
    "f4fc006ef3fd00b7f2fc66eff9fe313ff1fc009e0005babff8fcfdfff6fe0067f4fc0026f5fd888ff2fcdcdfd4de222f"
    "f1fcd1defafdc4cff8fc0016fffd727ff4fc717ef3fd99bff2fcecefe8ee0047f1fc22ae000500a7f8fcf7fffcfe0057"
    "f4fc115ef5fd0097f2fcd5dfe2ee0037f1fcb2befafd00c7f8fcfefffffd667ff4fc006ef3fda8aff2fc00e7f9fe323f"
    "f1fc009e0005b1bff8fce4eff6fe545ff4fc0026f5fd0087f2fc99dfd4de111f00130065004300de0083888d0023444e"
    "001300a5004388ae00830035002300d7001300c50043009e008300550023222e001300950043007e008310fe00230077"
    "00130065004388ce0083888d0023111e001300a50043005e00830035002300e7001300c5004300be00830055002311ff"
    "001300950043003e008340ee0023a2af00130065004300de0083888d0023444e001300a5004388ae00830035002344ef"
    "001300c50043009e008300550023222e001300950043007e008310fe002300b700130065004388ce0083888d0023111e"
    "001300a50043005e008300350023c4cf001300c5004300be00830055002300f7001300950043003e008340ee0023006f"
    "000100840001005600010014000100d70001002400010096000100450001007700010084000100c6000100140001888f"
    "00010024000100f7000100350001222f00010084000140fe00010014000100b700010024000100bf0001004500010067"
    "00010084000100a6000100140001444f00010024000100e7000100350001113f000100840001005600010014000100cf"
    "0001002400010096000100450001006f00010084000100c6000100140001009f00010024000100ef000100350001323f"
    "00010084000140fe00010014000100af00010024000144ff000100450001005f00010084000100a6000100140001007f"
    "00010024000100df000100350001111f000100240001005600010085000100bf00010014000100f7000100c600010077"
    "000100240001f8ff000100450001007f00010014000100df000100a60001313f000100240001222e00010085000100b7"
    "00010014000144ef0001a2ae0001006700010024000151ff000100450001009700010014000100cf000100360001223f"
    "0001002400010056000100850001b2bf00010014000140ef000100c60001006f00010024000172ff000100450001009f"
    "00010014000100d7000100a60001444f000100240001222e000100850001a8af00010014000100e70001a2ae0001005f"
    "00010024000144ff000100450001888f000100140001aaaf000100360001111f0002f8fe00240056000200b6008566ff"
    "000200ce0014111e000200960035a8af000200f60024313e000200a60045b3bf0002b2be0014f5ff00020066517e545f"
    "0002f2fe0024222e000222ae008544ef000200c60014f4ff000200760035447f000240de0024323e0002009e004500d7"
    "000288be0014faff0002115ef1fe444f0002f8fe00240056000200b60085c8ef000200ce0014111e000200960035888f"
    "000200f60024313e000200a6004544df0002b2be0014a8ff00020066517e006f0002f2fe0024222e000222ae008500e7"
    "000200c60014e2ef000200760035727f000240de0024323e0002009e0045b1bf000288be001473ff0002115ef1fe333f"
    "00010084000120ee000100c50001c4cf00010044000132ff000100150001888f000100840001006600010025000100af"
    "00010044000122ef000100a60001005f000100840001444e000100c50001cccf00010044000100f7000100150001006f"
    "0001008400010056000100250001009f00010044000100df000130fe0001222f00010084000120ee000100c50001c8cf"
    "00010044000111ff00010015000100770001008400010066000100250001007f00010044000100e7000100a600010037"
    "000100840001444e000100c5000100b700010044000100bf000100150001003f00010084000100560001002500010097"
    "00010044000100d7000130fe0001111f0002a8ee0044888e000200d600c5f3ff0002fcfe0025003e000200b60055d8df"
    "0002f8fe004400660002207e008599ff000200e600f50036000200a60015009f0002f2fe00440076000244ce00c576ff"
    "0002f1fe0025444e000200ae0055c8cf0002f4fe0044445e000210be0085e4ef000254de00f5111e000200960015222f"
    "0002a8ee0044888e000200d600c5faff0002fcfe0025003e000200b6005511bf0002f8fe004400660002207e008522ef"
    "000200e600f50036000200a60015227f0002f2fe00440076000244ce00c5d5ff0002f1fe0025444e000200ae0055006f"
    "0002f4fe0044445e000210be008511df000254de00f5111e000200960015515f000300f60014111e0044888e00a5d4df"
    "0003a2ae005576ff0024223e00b6aaaf000300e60014f5ff004400660085cccf0003009e00c544ef00240036f8fe317f"
    "0003e8ee0014f1ff0044007600a5c4cf0003227e0055d1df0024444ef4fe515f000300d60014e2ef0044445e008522bf"
    "0003009600c5c8df0024222ef2fe226f000300f60014111e0044888e00a5b1bf0003a2ae005533ff0024223e00b6a8af"
    "000300e60014b9ff004400660085a8bf0003009e00c5e4ef00240036f8fe646f0003e8ee0014fcff0044007600a5c8cf"
    "0003227e0055eaef0024444ef4fe747f000300d60014faff0044445e0085b2bf0003009600c544df0024222ef2fe313f"
    "00f3fafef1fd0036000432be007511df00f354def2fde4ef00d5717efcfe737f00f3f3fef8fd111e000400960055b1bf"
    "00f300ce00b5d8dff4fd0066b9fe545f00f376fef1fd0026000400a60075009f00f300aef2fdf7ff00d50046f5fe747f"
    "00f300e6f8fd0016000400860055888f00f300c600b5e2eff4fd115ea8ee113f00f3fafef1fd0036000432be0075d1df"
    "00f354def2fdfbff00d5717efcfe447f00f3f3fef8fd111e000400960055727f00f300ce00b522eff4fd0066b9fe444f"
    "00f376fef1fd0026000400a6007511bf00f300aef2fdffff00d50046f5fe323f00f300e6f8fd0016000400860055006f"
    "00f300c600b5b8bff4fd115ea8ee222f"
)


def _vlc_encoders() -> tuple[dict, dict]:
    """For each table, (context, rho, u_off) -> [(e_k, e_1, codeword,
    length)], shortest first."""
    words = np.frombuffer(bytes.fromhex("".join(_VLC_HEX)), ">u2")
    out = []
    for t in range(2):
        enc: dict = {}
        seen = set()
        for i in range(1024):
            v = int(words[t * 1024 + i])
            ln = v & 7
            cq, cwd = i >> 7, (i & 0x7F) & ((1 << ln) - 1)
            key = (cq, (v >> 4) & 15, (v >> 3) & 1, v >> 12, (v >> 8) & 15, cwd, ln)
            if key not in seen:
                seen.add(key)
                enc.setdefault(key[:3], []).append(key[3:])
        for k in enc:
            enc[k].sort(key=lambda e: e[3])
        out.append(enc)
    return out[0], out[1]


VLC0, VLC1 = _vlc_encoders()
MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)


# ---------------------------------------------------------------------------
# the cleanup pass's three streams, SigProp's and MagRef's
# ---------------------------------------------------------------------------

class _Mel:
    """The MEL stream: MSB first, 7 bits after a 0xFF byte."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self.rem, self.tmp, self.run, self.k, self.threshold = 8, 0, 0, 0, 1

    def bit(self, v: int) -> None:
        self.tmp = (self.tmp << 1) | v
        self.rem -= 1
        if self.rem == 0:
            self.buf.append(self.tmp)
            self.rem = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def event(self, one: bool) -> None:
        if not one:
            self.run += 1
            if self.run >= self.threshold:
                self.bit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
                self.threshold = 1 << MEL_EXP[self.k]
        else:
            self.bit(0)
            t = MEL_EXP[self.k]
            while t > 0:
                t -= 1
                self.bit((self.run >> t) & 1)
            self.run = 0
            self.k = max(0, self.k - 1)
            self.threshold = 1 << MEL_EXP[self.k]

    def terminate(self) -> bytes:
        if self.run > 0:
            self.bit(1)
        if self.rem < 8:
            self.buf.append((self.tmp << self.rem) & 0xFF)
        return bytes(self.buf)


class _Backward:
    """A stream the decoder reads from its end: bits from the LSB of each
    byte, and after a byte above 0x8F a byte whose 7 LSBs are all set holds
    a stuffed 0 in its MSB. The VLC stream starts in the upper nibble of
    the byte before the segment's last (their low bits hold Scup)."""

    def __init__(self, vlc: bool) -> None:
        self.buf = bytearray()  # in the order the decoder reads them
        if vlc:
            self.tmp, self.used, self.gt8f = 0xF, 4, True
        else:
            self.tmp, self.used, self.gt8f = 0, 0, True

    def put(self, cwd: int, n: int) -> None:
        while n > 0:
            avail = 8 - self.gt8f - self.used
            t = min(avail, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            avail -= t
            n -= t
            cwd >>= t
            if avail == 0:
                if self.gt8f and self.tmp != 0x7F:
                    self.gt8f = False
                    continue  # one more bit fits
                self.buf.append(self.tmp)
                self.gt8f = self.tmp > 0x8F
                self.tmp = 0
                self.used = 0

    def terminate(self) -> bytes:
        if self.used:
            self.buf.append(self.tmp)
        return bytes(self.buf)


class _Forward:
    """A stream read from its start: bits from the LSB of each byte, 7 after
    a 0xFF byte. MagSgn pads with ones and drops a last 0xFF (the decoder
    reads 0xFF past its end); SigProp pads with zeros."""

    def __init__(self, pad_ones: bool) -> None:
        self.buf = bytearray()
        self.tmp, self.used, self.max, self.ones = 0, 0, 8, pad_ones

    def put(self, cwd: int, n: int) -> None:
        while n > 0:
            t = min(self.max - self.used, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            cwd >>= t
            n -= t
            if self.used >= self.max:
                self.buf.append(self.tmp)
                self.max = 7 if self.tmp == 0xFF else 8
                self.tmp = 0
                self.used = 0

    def terminate(self) -> bytes:
        if self.used:
            if self.ones:
                self.tmp |= (0xFF & ((1 << (self.max - self.used)) - 1)) << self.used
                if self.tmp != 0xFF:
                    self.buf.append(self.tmp)
            else:
                self.buf.append(self.tmp)
        elif self.ones and self.max == 7:
            self.buf.pop()
        return bytes(self.buf)


def _u_code(u: int) -> tuple[int, int, int, int]:
    """u's prefix and suffix (T.814 Table 3): (prefix, length, suffix,
    length), read from the LSB."""
    if u == 0:
        return 0, 0, 0, 0
    if u == 1:
        return 1, 1, 0, 0
    if u == 2:
        return 2, 2, 0, 0
    if u <= 4:
        return 4, 3, u - 3, 1
    if u <= 36:
        return 0, 3, u - 5, 5
    raise ValueError(f"u_q {u} needs T.814's extension bits")


def _exponent(mu: np.ndarray) -> np.ndarray:
    """E = the bit length of 2 (mu - 1) + 1 for mu >= 1, else 0."""
    v = np.where(mu > 0, 2 * mu.astype(np.int64) - 1, 0)
    out = np.zeros(v.shape, np.int64)
    while (v > 0).any():
        out += v > 0
        v >>= 1
    return out


def cleanup_segment(mu: np.ndarray, neg: np.ndarray) -> bytes:
    """The cleanup pass of a block [h, w] of magnitudes mu (at the pass's
    bit-plane) and signs: MagSgn, then MEL, then VLC backwards, Scup in the
    last 12 bits."""
    h, w = mu.shape
    H2, W2 = (h + 1) // 2 * 2, (w + 1) // 2 * 2 + 4
    M = np.zeros((H2, W2), np.int64)
    S = np.zeros((H2, W2), np.int64)
    M[:h, :w] = mu
    S[:h, :w] = neg
    E = _exponent(M)
    mel, vlc, ms = _Mel(), _Backward(True), _Forward(True)
    nqx = (w + 1) // 2
    # per quad: rho (samples 0 (x, y), 1 (x, y+1), 2 (x+1, y), 3 (x+1, y+1))
    ls_sig = np.zeros(nqx + 3, bool)  # the row above's line state, entry k: cols 2k-1, 2k
    ls_e = np.zeros(nqx + 3, np.int64)
    for qy in range(0, (h + 1) // 2):
        y = 2 * qy
        m4 = [M[y, 0::2], M[y + 1, 0::2], M[y, 1::2], M[y + 1, 1::2]]
        e4 = [E[y, 0::2], E[y + 1, 0::2], E[y, 1::2], E[y + 1, 1::2]]
        s4 = [S[y, 0::2], S[y + 1, 0::2], S[y, 1::2], S[y + 1, 1::2]]
        rho = ((m4[0] > 0) * 1 + (m4[1] > 0) * 2 + (m4[2] > 0) * 4 + (m4[3] > 0) * 8).tolist()
        emax = np.maximum(np.maximum(e4[0], e4[1]), np.maximum(e4[2], e4[3])).tolist()
        ev = [e.tolist() for e in e4]
        mv = [m.tolist() for m in m4]
        sv = [s.tolist() for s in s4]
        lsg, lse = ls_sig.tolist(), ls_e.tolist()
        table = VLC0 if qy == 0 else VLC1
        c_prev = 0
        for qx in range(0, nqx, 2):
            pair = [qx] + ([qx + 1] if qx + 1 < nqx else [])
            U, uq = {}, {}
            for q in pair:
                r = rho[q]
                if qy == 0:
                    ctx = c_prev
                    kappa = 1
                else:
                    ctx = c_prev | int(lsg[q]) | (4 * int(lsg[q + 1]))
                    enb = max(lse[q], lse[q + 1])
                    kappa = max(enb - 1, 1) if bin(r).count("1") > 1 else 1
                u = max(emax[q] - kappa, 0) if r else 0
                uq[q], U[q] = u, u + kappa
                if ctx == 0:
                    mel.event(r != 0)
                if ctx != 0 or r != 0:
                    emb = sum(1 << n for n in range(4) if (r >> n) & 1 and ev[n][q] == U[q])
                    for ek, e1, cwd, ln in table[(ctx, r, int(u > 0))]:
                        if ek & emb == e1 and (ek & r) == ek:
                            vlc.put(cwd, ln)
                            break
                    else:
                        raise AssertionError(("no codeword", qy, ctx, r, u, emb))
                    for n in range(4):
                        if (ek >> n) & 1:
                            assert ((e1 >> n) & 1) == (ev[n][q] == U[q])
                    q_ek = ek
                else:
                    q_ek = 0
                if qy == 0:
                    c_prev = int(bool(r & 3)) | (2 * ((r >> 2) & 1)) | (4 * ((r >> 3) & 1))
                else:
                    c_prev = 2 * int(bool(r & 12))
                uq[("ek", q)] = q_ek
            u0 = uq[qx]
            u1 = uq[qx + 1] if len(pair) > 1 else 0
            if qy == 0 and u0 > 0 and u1 > 0:
                big = min(u0, u1) > 2
                mel.event(big)
                if big:
                    codes = [_u_code(u0 - 2), _u_code(u1 - 2)]
                    vlc.put(codes[0][0], codes[0][1])
                    vlc.put(codes[1][0], codes[1][1])
                    vlc.put(codes[0][2], codes[0][3])
                    vlc.put(codes[1][2], codes[1][3])
                elif u0 > 2:
                    c0 = _u_code(u0)
                    vlc.put(c0[0], c0[1])
                    vlc.put(u1 - 1, 1)
                    vlc.put(c0[2], c0[3])
                else:
                    c0, c1 = _u_code(u0), _u_code(u1)
                    vlc.put(c0[0], c0[1])
                    vlc.put(c1[0], c1[1])
                    vlc.put(c0[2], c0[3])
                    vlc.put(c1[2], c1[3])
            else:
                c0, c1 = _u_code(u0), _u_code(u1)
                vlc.put(c0[0], c0[1])
                vlc.put(c1[0], c1[1])
                vlc.put(c0[2], c0[3])
                vlc.put(c1[2], c1[3])
            for q in pair:
                ek = uq[("ek", q)]
                for n in range(4):
                    if (rho[q] >> n) & 1:
                        m_n = U[q] - ((ek >> n) & 1)
                        v = 2 * (mv[n][q] - 1) + sv[n][q]
                        assert v < (1 << U[q]), "a magnitude above U_q"
                        ms.put(v & ((1 << m_n) - 1), m_n)
        # the line state for the next row: bottom samples 1 and 3
        bs = (M[y + 1] > 0)
        be = E[y + 1]
        ls_sig[:] = False
        ls_e[:] = 0
        ls_sig[:nqx + 1] = bs[0:2 * nqx + 1:2] | np.concatenate([[False], bs[1:2 * nqx:2]])
        ls_e[:nqx + 1] = np.maximum(be[0:2 * nqx + 1:2], np.concatenate([[0], be[1:2 * nqx:2]]))
    msb = ms.terminate()
    melb = mel.terminate()
    vlcb = vlc.terminate()
    scup = len(melb) + len(vlcb) + 1
    if scup > 4079:
        raise ValueError("Scup above 4079")
    seg = bytearray(msb + melb + bytes(reversed(vlcb)) + b"\0")
    seg[-1] = scup >> 4
    seg[-2] = (seg[-2] & 0xF0) | (scup & 0xF)
    return bytes(seg)


def refinement_segment(q: np.ndarray, p: int, vsc: bool,
                       magref: bool = True) -> tuple[bytes, np.ndarray]:
    """SigProp (forwards) and, with `magref`, MagRef (backwards from the
    end) at bit-plane p - 2 of a block whose cleanup coded |q| >> (p - 1);
    returns the segment and the decoder's x2 reconstruction (with the
    half-bin)."""
    h, w = q.shape
    mag = np.abs(q).astype(np.int64)
    mu = mag >> (p - 1)
    sig = mu > 0
    if magref:
        rec = np.where(sig, (mu << p) | (((mag >> (p - 2)) & 1) << (p - 1)) | (1 << (p - 2)), 0)
    else:
        rec = np.where(sig, (2 * mu + 1) << (p - 1), 0)
    spp, mrp = _Forward(False), _Backward(False)
    # MagRef: stripes of 4 rows, column by column
    for y0 in range(0, h, 4) if magref else ():
        for x in range(w):
            for y in range(y0, min(y0 + 4, h)):
                if sig[y, x]:
                    mrp.put(int((mag[y, x] >> (p - 2)) & 1), 1)
    # SigProp: a sample is visited where a neighbour is significant (the
    # stripe below only by its cleanup, not at all in vertically causal mode)
    state = sig.copy()
    for y0 in range(0, h, 4):
        y1 = min(y0 + 4, h)
        for g in range(0, w, 4):
            new = []
            for x in range(g, min(g + 4, w)):
                for y in range(y0, y1):
                    if state[y, x]:
                        continue
                    ylo, yhi = max(y - 1, 0), min(y + 2, h if not vsc else y1)
                    if not state[ylo:yhi, max(x - 1, 0):x + 2].any():
                        continue
                    bit = int((mag[y, x] >> (p - 2)) & 1)
                    spp.put(bit, 1)
                    if bit:
                        state[y, x] = True
                        new.append((y, x))
            for y, x in sorted(new, key=lambda t: (t[1], t[0])):
                spp.put(int(q[y, x] < 0), 1)
                rec[y, x] = 3 << (p - 2)
    return spp.terminate() + bytes(reversed(mrp.terminate())), rec


def encode_block(q: np.ndarray, p: int, passes: int, vsc: bool) -> tuple:
    """One HT code-block of quantised coefficients q [h, w] whose cleanup
    pass sits at bit-plane p - 1 (p 1: every bit in the cleanup). Returns
    (segments, passes, the decoder's x2 reconstruction, its sign applied),
    or None for a block with nothing significant."""
    mag = np.abs(q).astype(np.int64)
    mu = mag >> (p - 1)
    if passes > 1 and (p < 2 or not mu.any()):
        passes = 1
    if not mu.any():
        return None
    segs = [cleanup_segment(mu, q < 0)]
    if passes > 1:
        seg2, rec = refinement_segment(q, p, vsc, passes == 3)
        segs.append(seg2)
    else:
        rec = np.where(mu > 0, ((2 * mu + 1) << (p - 1)), 0)
    return segs, passes, np.where(q < 0, -rec, rec)


# ---------------------------------------------------------------------------
# tier 2 (tgt.c, bio.c, the decoder's geometry of tcd.c)
# ---------------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _cdivp2(a: int, e: int) -> int:
    return -(-a >> e)


class _Bio:
    """bio.c's writer: MSB first, 7 bits in the byte after a 0xFF."""

    def __init__(self) -> None:
        self.out = bytearray()
        self.buf, self.ct = 0, 8

    def _byteout(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def put(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            if self.ct == 0:
                self._byteout()
            self.ct -= 1
            self.buf |= ((v >> i) & 1) << self.ct

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class _TagTree:
    """tgt.c's tag tree over a grid of leaves, encoding."""

    def __init__(self, w: int, h: int, values: list) -> None:
        self.levels = []
        lw, lh = w, h
        vals = np.array(values, np.int64).reshape(h, w) if w * h else np.zeros((h, w), np.int64)
        while True:
            self.levels.append({"w": lw, "h": lh, "value": vals, "low": np.zeros_like(vals),
                                "known": np.zeros(vals.shape, bool)})
            if lw * lh <= 1:
                break
            nw, nh = _cdiv(lw, 2), _cdiv(lh, 2)
            nv = np.full((nh, nw), 1 << 30, np.int64)
            for j in range(lh):
                for i in range(lw):
                    nv[j // 2, i // 2] = min(nv[j // 2, i // 2], vals[j, i])
            vals, lw, lh = nv, nw, nh

    def encode(self, bio: _Bio, leaf: int, threshold: int) -> None:
        lw = self.levels[0]["w"]
        path = []
        x, y = leaf % lw, leaf // lw
        for lev in self.levels:
            path.append((lev, y, x))
            x, y = x // 2, y // 2
        low = 0
        for lev, y, x in reversed(path):
            if low > lev["low"][y, x]:
                lev["low"][y, x] = low
            else:
                low = int(lev["low"][y, x])
            while low < threshold:
                if low >= lev["value"][y, x]:
                    if not lev["known"][y, x]:
                        bio.put(1, 1)
                        lev["known"][y, x] = True
                    break
                bio.put(0, 1)
                low += 1
            lev["low"][y, x] = low


def _floorlog2(v: int) -> int:
    return v.bit_length() - 1


def _numpasses(bio: _Bio, n: int) -> None:
    if n == 1:
        bio.put(0, 1)
    elif n == 2:
        bio.put(2, 2)
    elif n <= 5:
        bio.put(0xC | (n - 3), 4)
    elif n <= 36:
        bio.put(0x1E0 | (n - 6), 9)
    else:
        bio.put(0xFF80 | (n - 37), 16)


class _Cblk:
    def __init__(self, x0: int, y0: int, x1: int, y1: int) -> None:
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.segs: list = []  # bytes of each segment
        self.passes = 0
        self.zbp = 0
        self.layer_of = []  # the layer of each segment
        self.numlenbits = 3
        self.included = False


def tile_geometry(tc: tuple, numres: int, cblk: tuple, prec: list) -> list:
    """opj_tcd_init_tile's resolutions, bands, precincts and code-blocks of
    a tile-component (x0, y0, x1, y1): per resolution (x0, y0, x1, y1, pw,
    ph, [bands: (bandno, x0, y0, x1, y1, [precincts: (cw, ch, [cblks])])])."""
    x0, y0, x1, y1 = tc
    out = []
    for resno in range(numres):
        level = numres - 1 - resno
        rx0, ry0, rx1, ry1 = (_cdivp2(x0, level), _cdivp2(y0, level), _cdivp2(x1, level),
                              _cdivp2(y1, level))
        pdx, pdy = prec[resno]
        tlpx, tlpy = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
        brpx, brpy = _cdivp2(rx1, pdx) << pdx, _cdivp2(ry1, pdy) << pdy
        pw = 0 if rx0 == rx1 else (brpx - tlpx) >> pdx
        ph = 0 if ry0 == ry1 else (brpy - tlpy) >> pdy
        if resno == 0:
            tcbx, tcby, cbgw, cbgh, bandnos = tlpx, tlpy, pdx, pdy, [0]
        else:
            tcbx, tcby, cbgw, cbgh, bandnos = (_cdivp2(tlpx, 1), _cdivp2(tlpy, 1), pdx - 1,
                                               pdy - 1, [1, 2, 3])
        cw_e, ch_e = min(cblk[0], cbgw), min(cblk[1], cbgh)
        bands = []
        for bandno in bandnos:
            if resno == 0:
                bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
            else:
                ox, oy = bandno & 1, bandno >> 1
                bx0 = _cdivp2(x0 - (ox << level), level + 1)
                by0 = _cdivp2(y0 - (oy << level), level + 1)
                bx1 = _cdivp2(x1 - (ox << level), level + 1)
                by1 = _cdivp2(y1 - (oy << level), level + 1)
            precs = []
            for precno in range(pw * ph):
                cx = tcbx + (precno % pw) * (1 << cbgw)
                cy = tcby + (precno // pw) * (1 << cbgh)
                px0, py0 = max(cx, bx0), max(cy, by0)
                px1, py1 = min(cx + (1 << cbgw), bx1), min(cy + (1 << cbgh), by1)
                tlcx, tlcy = (px0 >> cw_e) << cw_e, (py0 >> ch_e) << ch_e
                brcx, brcy = _cdivp2(px1, cw_e) << cw_e, _cdivp2(py1, ch_e) << ch_e
                ncw, nch = (brcx - tlcx) >> cw_e, (brcy - tlcy) >> ch_e
                cbs = []
                for k in range(ncw * nch):
                    ax = tlcx + (k % ncw) * (1 << cw_e)
                    ay = tlcy + (k // ncw) * (1 << ch_e)
                    cbs.append(_Cblk(max(ax, px0), max(ay, py0), min(ax + (1 << cw_e), px1),
                                     min(ay + (1 << ch_e), py1)))
                precs.append((ncw, nch, cbs))
            bands.append((bandno, bx0, by0, bx1, by1, precs))
        out.append((rx0, ry0, rx1, ry1, pw, ph, bands))
    return out


# ---------------------------------------------------------------------------
# the wavelets and colour transforms
# ---------------------------------------------------------------------------

# dwt.c's 9/7 lifting constants (the inverse scales the high band by the
# historic 2/K of BUG_WEIRD_TWO_INVK)
_ALPHA, _BETA, _GAMMA, _DELTA = -1.586134342059924, -0.052980118572961, 0.882911075530934, \
    0.443506852043971
_K, _TWO_INVK = 1.230174104914001, 1.625732422


def fdwt97(data: np.ndarray, levels: int) -> np.ndarray:
    """A forward 9/7 of data [h, w] (float64) over `levels` levels, each
    level's columns then its rows, low-pass first: the inverse of dwt.c's
    lifting, scalings included, for a tile whose origin is even at every
    level."""
    out = np.asarray(data, np.float64).copy()
    rh, rw = out.shape
    for _ in range(levels):
        for axis, n in ((0, rh), (1, rw)):
            region = out[:rh, :rw] if axis == 1 else out[:rh, :rw].T
            if n < 2:
                continue
            a = region.copy()
            s, d = a[:, 0::2].copy(), a[:, 1::2].copy()
            sn, dn = s.shape[1], d.shape[1]

            # symmetric extension: d[i] lifts from s[i], s[i + 1]; s[i] from
            # d[i - 1], d[i]
            def sr(arr):  # s[i + 1], the last repeated
                return np.concatenate([arr[:, 1:], arr[:, -1:]], axis=1)[:, :dn]

            def dl(arr):  # d[i - 1], the first repeated
                return np.concatenate([arr[:, :1], arr], axis=1)[:, :sn]

            def dr(arr):  # d[i], the last repeated
                return np.concatenate([arr, arr[:, -1:]], axis=1)[:, :sn]
            d += _ALPHA * (s[:, :dn] + sr(s))
            s += _BETA * (dl(d) + dr(d))
            d += _GAMMA * (s[:, :dn] + sr(s))
            s += _DELTA * (dl(d) + dr(d))
            s /= _K
            d /= _TWO_INVK
            region[:, :sn], region[:, sn:] = s, d
        rh, rw = (rh + 1) // 2, (rw + 1) // 2
    return out


def rct(rgb: np.ndarray) -> np.ndarray:
    """The forward reversible colour transform on int64 [3, h, w]."""
    r, g, b = rgb
    return np.stack([(r + 2 * g + b) >> 2, b - g, r - g])


def ict(rgb: np.ndarray) -> np.ndarray:
    """The forward irreversible colour transform on float64 [3, h, w]."""
    r, g, b = rgb
    return np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                     -0.16875 * r - 0.331260 * g + 0.5 * b,
                     0.5 * r - 0.41869 * g - 0.08131 * b])


# ---------------------------------------------------------------------------
# the codestream and its boxes
# ---------------------------------------------------------------------------

def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">HH", code, len(body) + 2) + body


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body) + 8) + kind + body


CAP = _marker(0xFF50, struct.pack(">IH", 0x00020000, 0x0000))  # Pcap: Part 15; Ccap15
CPF = _marker(0xFF59, struct.pack(">H", 0x0004))

_GAIN = (0, 1, 1, 2)  # log2 of the 5/3's band gains (LL, HL, LH, HH)


class HtFile:
    """An encoded file: its bytes and, for a reversible one, the image the
    encoder meant (`expect`, [h, w] or [h, w, c]) and whether that is the
    input itself (`lossless`)."""

    def __init__(self, data: bytes, expect, lossless: bool, prec: int = 8,
                 signed: bool = False) -> None:
        self.data, self.expect, self.lossless = data, expect, lossless
        self.prec, self.signed = prec, signed

    def pillow_expect(self) -> np.ndarray:
        """`expect` as Pillow gives it: one deeper component shifted to 16
        bits (I;16), a signed one offset by half its range."""
        ex = self.expect.astype(np.int64)
        if self.signed:
            ex = ex + (1 << (self.prec - 1))
        if ex.ndim == 2 and self.prec > 8:
            ex = ex << (16 - self.prec)
        return ex


def encode_ht(img: np.ndarray, *, irreversible: bool = False, levels: int = 5,
              cblk: tuple = (6, 6), passes: int = 1, p: int = 1, layers: int = 1,
              split: str = "blocks", precincts: list | None = None, tile: tuple | None = None,
              mct: bool = False, prec: int = 8, signed: bool = False, vsc: bool = False,
              step: float = 1.0, box: str = "j2c", cap: bool = True, cpf: bool = False,
              extra_main: bytes = b"") -> HtFile:
    """img [h, w] or [h, w, c] of `prec`-bit samples (`signed`: two's
    complement values) -> an HT codestream, or JP2 / JPH boxes round it.

    The 5/3 (p 1) is lossless; 2 or 3 passes code the cleanup at p - 1
    and SigProp (and MagRef) below it; the 9/7 quantises every band by `step`.
    `cblk` is log2 of the code-block's width and height, `precincts` log2 of
    each resolution's (PPx, PPy), `tile` the tile's size (a multiple of
    2^levels), `split` how `layers` share the blocks: "blocks" puts each
    block whole in one layer, round robin, "passes" the cleanup in the
    first layer and the refinement in the second. `extra_main` goes into
    the main header after QCD."""
    from gatling_tpu_torch.imgio import jpeg2000 as j2k

    img = np.asarray(img)
    planes = (img[None] if img.ndim == 2 else img.transpose(2, 0, 1)).astype(np.int64)
    nc, h, w = planes.shape
    if not signed:
        planes = planes - (1 << (prec - 1))
    if mct:
        planes = planes.copy()
        if irreversible:
            planes = planes.astype(np.float64)
            planes[:3] = ict(planes[:3])
        else:
            planes[:3] = rct(planes[:3])
    tdx, tdy = tile or (w, h)
    tw, th = _cdiv(w, tdx), _cdiv(h, tdy)
    numres = levels + 1
    prec_sizes = precincts or [(15, 15)] * numres
    # the step of each band: 2^(prec - expn) (1 + mant / 2048)
    nbands = 1 + 3 * levels
    if irreversible:
        e = int(np.floor(np.log2(step)))
        mant = int(round((step / 2.0 ** e - 1) * 2048))
        expn = [prec - e] * nbands
        mants = [mant] * nbands
    else:
        expn = [prec + _GAIN[0]] + [prec + g for _ in range(levels) for g in _GAIN[1:]]
        mants = [0] * nbands
    tiles = []
    need = 0  # the bit-planes each band must hold, above expn + guard - 1
    for t in range(tw * th):
        tx0, ty0 = (t % tw) * tdx, (t // tw) * tdy
        tx1, ty1 = min(tx0 + tdx, w), min(ty0 + tdy, h)
        comps = []
        for c in range(nc):
            region = planes[c, ty0:ty1, tx0:tx1]
            if irreversible:
                co = fdwt97(region, levels)
            else:
                co = j2k.fdwt53(region.astype(np.int32), levels).astype(np.int64)
            geo = tile_geometry((tx0, ty0, tx1, ty1), numres, cblk, prec_sizes)
            qarr = np.zeros(co.shape, np.int64)
            for resno, (_rx0, _ry0, _rx1, _ry1, _pw, _ph, bands) in enumerate(geo):
                for bandno, bx0, by0, bx1, by1, _precs in bands:
                    xo = (geo[resno - 1][2] - geo[resno - 1][0]) if bandno & 1 else 0
                    yo = (geo[resno - 1][3] - geo[resno - 1][1]) if bandno & 2 else 0
                    sl = (slice(yo, yo + by1 - by0), slice(xo, xo + bx1 - bx0))
                    if irreversible:
                        qarr[sl] = np.trunc(co[sl] / step).astype(np.int64)
                    else:
                        qarr[sl] = co[sl]
                    band_index = 0 if resno == 0 else 1 + 3 * (resno - 1) + bandno - 1
                    mx = int(np.abs(qarr[sl]).max()) if qarr[sl].size else 0
                    mu = mx >> (p - 1)
                    e_max = (2 * mu - 1).bit_length() if mu else 0
                    need = max(need, e_max + p - 2 - (expn[band_index] - 1))
            comps.append((co, qarr, geo))
        tiles.append(((tx0, ty0, tx1, ty1), comps))
    guard = max(1, need)
    if guard > 7:
        raise ValueError("too many bit-planes for the guard bits")
    mb = [e + guard - 1 for e in expn]

    # tier 1, and the decoder's reconstruction for the reversible round trip
    expect_planes = np.zeros((nc, h, w), np.int64)
    lossless = not irreversible
    tile_bytes = []
    for t, ((tx0, ty0, tx1, ty1), comps) in enumerate(tiles):
        blocks = []  # per comp, per res, per band, per precinct: cblks
        for c, (co, qarr, geo) in enumerate(comps):
            rec = np.zeros(qarr.shape, np.int64)
            for resno, (_rx0, _ry0, _rx1, _ry1, _pw, _ph, bands) in enumerate(geo):
                for bandno, bx0, by0, _bx1, _by1, precs in bands:
                    band_index = 0 if resno == 0 else 1 + 3 * (resno - 1) + bandno - 1
                    xo = (geo[resno - 1][2] - geo[resno - 1][0]) if bandno & 1 else 0
                    yo = (geo[resno - 1][3] - geo[resno - 1][1]) if bandno & 2 else 0
                    for _cw, _ch, cbs in precs:
                        for cb in cbs:
                            ys = slice(cb.y0 - by0 + yo, cb.y1 - by0 + yo)
                            xs = slice(cb.x0 - bx0 + xo, cb.x1 - bx0 + xo)
                            q = qarr[ys, xs]
                            if q.size == 0:
                                continue
                            got = encode_block(q, p, passes, vsc)
                            if got is None:
                                continue
                            cb.segs, cb.passes, r = got
                            cb.zbp = mb[band_index] - p  # OpenJPEG: p = Mb - zbp
                            rec[ys, xs] = np.where(r < 0, -((-r) >> 1), r >> 1)
                            if not np.array_equal(rec[ys, xs], q):
                                lossless = False
            if not irreversible:
                rects = np.array([g[:4] for g in geo], np.int32)
                expect_planes[c, ty0:ty1, tx0:tx1] = j2k.idwt(rec.astype(np.int32), rects, True)
        tile_bytes.append(_tile_packets(comps, layers, split))
    # the markers
    rsiz = 0x4000
    siz = struct.pack(">HIIIIIIIIH", rsiz, w, h, 0, 0, tdx, tdy, 0, 0, nc)
    siz += b"".join(bytes([(prec - 1) | (0x80 if signed else 0), 1, 1]) for _ in range(nc))
    scod = 1 if precincts else 0
    style = 0x40 | (0x08 if vsc else 0)
    cod = struct.pack(">BBHB", scod, 0, layers, 1 if mct else 0)
    cod += bytes([levels, cblk[0] - 2, cblk[1] - 2, style, 0 if irreversible else 1])
    if precincts:
        cod += bytes(ppx | (ppy << 4) for ppx, ppy in prec_sizes)
    if irreversible:
        qcd = bytes([(guard << 5) | 2]) + b"".join(struct.pack(">H", (e << 11) | m)
                                                     for e, m in zip(expn, mants))
    else:
        qcd = bytes([guard << 5]) + bytes(e << 3 for e in expn)
    head = b"\xff\x4f" + _marker(0xFF51, siz) + (CAP if cap else b"") + _marker(0xFF52, cod)
    head += _marker(0xFF5C, qcd) + (CPF if cpf else b"") + extra_main
    body = b""
    for t, data in enumerate(tile_bytes):
        body += _marker(0xFF90, struct.pack(">HIBB", t, 14 + len(data), 0, 1)) + b"\xff\x93" + data
    stream = head + body + b"\xff\xd9"
    expect = None
    if not irreversible:
        ex = expect_planes.copy()
        if mct:
            g = ex[0] - ((ex[1] + ex[2]) >> 2)
            ex[:3] = np.stack([ex[2] + g, g, ex[1] + g])
        if not signed:
            ex = ex + (1 << (prec - 1))
            ex = np.clip(ex, 0, (1 << prec) - 1)
        else:
            ex = np.clip(ex, -(1 << (prec - 1)), (1 << (prec - 1)) - 1)
        expect = ex[0] if img.ndim == 2 else ex.transpose(1, 2, 0)
    out = HtFile(_wrap(stream, box, w, h, nc, prec, signed), expect, lossless, prec, signed)
    out.source = img
    return out


def _tile_packets(comps: list, layers: int, split: str) -> bytes:
    """A tile's packets in LRCP order."""
    # each block's contribution a layer: [(segment indices)]
    order = 0
    for _co, _q, geo in comps:
        for res in geo:
            for band in res[6]:
                for _cw, _ch, cbs in band[5]:
                    for cb in cbs:
                        cb.layer_segs = [[] for _ in range(layers)]
                        if not cb.segs:
                            continue
                        if split == "passes" and layers > 1:
                            cb.layer_segs[0].append(0)
                            if len(cb.segs) > 1:
                                cb.layer_segs[1].append(1)
                        else:
                            cb.layer_segs[order % layers] = list(range(len(cb.segs)))
                            order += 1
    trees = {}
    out = bytearray()
    numres = len(comps[0][2])
    for layer in range(layers):
        for resno in range(numres):
            for c, (_co, _q, geo) in enumerate(comps):
                res = geo[resno]
                for precno in range(res[4] * res[5]):
                    out += _packet(res, precno, layer, trees, (c, resno))
    return bytes(out)


def _packet(res: tuple, precno: int, layer: int, trees: dict, key: tuple) -> bytes:
    bands = [b for b in res[6] if b[3] > b[1] and b[4] > b[2]]
    present = any(cb.layer_segs[layer] for b in bands for cb in b[5][precno][2])
    bio = _Bio()
    bio.put(int(present), 1)
    bodies = b""
    if present:
        for b in bands:
            cw, ch, cbs = b[5][precno]
            tk = key + (b[0], precno)
            if tk not in trees:
                first = [next((i for i, s in enumerate(cb.layer_segs) if s), 1 << 20)
                         for cb in cbs]
                trees[tk] = (_TagTree(cw, ch, first), _TagTree(cw, ch, [cb.zbp for cb in cbs]))
            incl, imsb = trees[tk]
            for k, cb in enumerate(cbs):
                segs = cb.layer_segs[layer]
                if not cb.included:
                    incl.encode(bio, k, layer + 1)
                else:
                    bio.put(int(bool(segs)), 1)
                if not segs:
                    continue
                if not cb.included:
                    imsb.encode(bio, k, 999)
                npass = [1 if s == 0 else cb.passes - 1 for s in segs]
                _numpasses(bio, sum(npass))
                need = max(len(cb.segs[s]).bit_length() - _floorlog2(n)
                           for s, n in zip(segs, npass))
                inc = max(0, need - cb.numlenbits)
                bio.put((1 << (inc + 1)) - 2, inc + 1)
                cb.numlenbits += inc
                for s, n in zip(segs, npass):
                    bio.put(len(cb.segs[s]), cb.numlenbits + _floorlog2(n))
                    bodies += cb.segs[s]
                cb.included = True
    return bio.flush() + bodies


def _wrap(stream: bytes, box: str, w: int, h: int, nc: int, prec: int, signed: bool) -> bytes:
    if box == "j2c":
        return stream
    brand = b"jph " if box == "jph" else b"jp2 "
    bpc = (prec - 1) | (0x80 if signed else 0)
    head = _box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    head += _box(b"colr", struct.pack(">BBBI", 1, 0, 0, 17 if nc < 3 else 16))
    if nc == 4:
        head += _box(b"cdef", struct.pack(">H", 4) + struct.pack(">12H", 0, 0, 1, 1, 0, 2, 2, 0,
                                                                 3, 3, 1, 0))
    return (_box(b"jP  ", b"\r\n\x87\n") + _box(b"ftyp", brand + struct.pack(">I", 0) + brand)
            + _box(b"jp2h", head) + _box(b"jp2c", stream))


def block_file(segs: list, passes: int, w: int, h: int, zbp: int, expn: int = 8, guard: int = 2,
               style: int = 0x40, roishift: int = 0) -> bytes:
    """A one-block codestream: an 8-bit grey w x h image, no wavelet levels,
    one code-block over it, whose packet carries
    `segs` (any bytes: the random cleanup segments of the tests) as the
    block's `passes` passes with zbp zero bit-planes in the tag tree; the
    band has expn + guard - 1 bit-planes."""
    cw, ch = max(2, (w - 1).bit_length()), max(2, (h - 1).bit_length())
    siz = struct.pack(">HIIIIIIIIH", 0x4000, w, h, 0, 0, w, h, 0, 0, 1) + b"\x07\x01\x01"
    cod = struct.pack(">BBHB", 0, 0, 1, 0) + bytes([0, cw - 2, ch - 2, style, 1])
    qcd = bytes([guard << 5, expn << 3])
    rgn = _marker(0xFF5E, bytes([0, 0, roishift])) if roishift else b""
    bio = _Bio()
    bio.put(1, 1)
    _TagTree(1, 1, [0]).encode(bio, 0, 1)
    _TagTree(1, 1, [zbp]).encode(bio, 0, 999)
    _numpasses(bio, passes)
    npass = [1, passes - 1][:len(segs)]
    need = max(len(s).bit_length() - _floorlog2(max(n, 1)) for s, n in zip(segs, npass))
    inc = max(0, need - 3)
    bio.put((1 << (inc + 1)) - 2, inc + 1)
    for s, n in zip(segs, npass):
        bio.put(len(s), 3 + inc + _floorlog2(max(n, 1)))
    data = bio.flush() + b"".join(segs)
    return (b"\xff\x4f" + _marker(0xFF51, siz) + CAP + _marker(0xFF52, cod) + _marker(0xFF5C, qcd)
            + rgn + _marker(0xFF90, struct.pack(">HIBB", 0, 14 + len(data), 0, 1)) + b"\xff\x93"
            + data + b"\xff\xd9")


BLOCK_SIZES = ((4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (16, 64), (64, 16), (1024, 4),
               (4, 1024), (8, 2), (2, 8), (128, 32), (13, 7), (1, 9), (9, 1), (6, 5), (63, 17),
               (3, 1000), (1000, 3), (30, 30))


def random_block(rng: np.random.Generator) -> bytes:
    """A block_file of random segments: one of BLOCK_SIZES, 1 to 3 passes
    (now and then 4), a cleanup length with Scup mostly inside
    2..min(Lcup, 4079) and now and then a stuffed byte at the MEL's start,
    random bytes throughout; bands of 8 to 26 bit-planes, the zero
    bit-planes mostly near them (the bound on U_q), now and then too many."""
    w, h = BLOCK_SIZES[int(rng.integers(0, len(BLOCK_SIZES)))]
    passes = int(rng.choice([1, 1, 2, 3, 3, 3, 4]))
    lcup = int(rng.integers(2, 300))
    seg1 = bytearray(rng.integers(0, 256, lcup, dtype=np.uint8).tobytes())
    if rng.random() < 0.9:
        scup = int(rng.integers(2, min(lcup, 4079) + 1))
        seg1[-1] = scup >> 4
        seg1[-2] = (seg1[-2] & 0xF0) | (scup & 0xF)
        if rng.random() < 0.15 and scup > 3:
            at = lcup - scup + int(rng.integers(0, min(3, scup - 2)))
            seg1[at] = 0xFF
            seg1[at + 1] = int(rng.integers(0x80, 0x100))
    segs = [bytes(seg1)]
    if passes > 1:
        segs.append(rng.integers(0, 256, int(rng.integers(0, 80)), dtype=np.uint8).tobytes())
    expn, guard = int(rng.integers(8, 21)), int(rng.integers(1, 8))
    mb = expn + guard - 1
    zbp = mb - int(rng.integers(0, 4)) if rng.random() < 0.95 else mb + 1
    return block_file(segs, passes, w, h, max(zbp, 0), expn, guard)


# ---------------------------------------------------------------------------
# the Part 2 markers (MCT, MCC, MCO, CBD), spliced into codestreams
# ---------------------------------------------------------------------------

def splice(stream: bytes, main: bytes = b"", tile: bytes = b"") -> bytes:
    """`main` after the main header's last marker segment, `tile` after
    the first tile-part's SOT (its Psot grown to match)."""
    sot = stream.find(b"\xff\x90")
    out = stream[:sot] + main
    psot = struct.unpack_from(">I", stream, sot + 6)[0]
    seg = bytearray(stream[sot:sot + 12])
    if psot:
        struct.pack_into(">I", seg, 6, psot + len(tile))
    return out + bytes(seg) + tile + stream[sot + 12:]


def mct(index: int, element: int, values, array_type: int = 2, zmct: int = 0,
        ymct: int = 0) -> bytes:
    """An MCT marker: Zmct, Imct (index, array type, element type), Ymct,
    then the values as int16, int32, float32 or float64."""
    fmt = (">h", ">i", ">f", ">d")[element]
    body = struct.pack(">HHH", zmct, index | (array_type << 8) | (element << 10), ymct)
    return _marker(0xFF74, body + b"".join(struct.pack(fmt, v) for v in values))


def mcc(index: int, ncomp: int, deco: int, offset: int, reversible: bool = True,
        order=None, qmcc: int = 1, xmcc: int = 1, tail: bytes = b"") -> bytes:
    """An MCC marker with one array-based decorrelation collection over
    components 0..ncomp-1 (or `order`) naming its MCT records."""
    comps = order if order is not None else range(ncomp)
    body = struct.pack(">HBHH", 0, index, 0, qmcc)
    if qmcc:
        body += bytes([xmcc]) + struct.pack(">H", ncomp) + bytes(comps)
        body += struct.pack(">H", ncomp) + bytes(range(ncomp))
        body += (((1 << 16) if reversible else 0) | (offset << 8) | deco).to_bytes(3, "big")
    return _marker(0xFF75, body + tail)


def mco(*stages: int) -> bytes:
    return _marker(0xFF77, bytes([len(stages), *stages]))


def cbd(*depths: int, count: int | None = None) -> bytes:
    """A CBD marker: Ncbd, then each component's depth byte."""
    n = len(depths) if count is None else count
    return _marker(0xFF78, struct.pack(">H", n) + bytes(depths))


# ---------------------------------------------------------------------------
# the committed files
# ---------------------------------------------------------------------------

def _make_fixtures():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(ROOT, "tests", "data", "imgio", "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pillow_j2k(img: np.ndarray, **kw) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG2000", no_jp2=True, **kw)
    return buf.getvalue()


# the 8-bit HT files chip_smoke.py's phase 4v puts on the interior's
# materials, the 16-bit grey one its roughness, the 1024^2 ground kept in
# ht_fixtures.npz as its digest
HT_8BIT = ("ht_cleanup_53_grey.j2c", "ht_3pass_rct.jp2", "ht_p3_lossy.j2c", "ht_vsc_16x64.j2c",
           "ht_1024x4.j2c", "ht_tiles_precincts_layers.j2c", "ht_97_ict.jp2", "ht_rgba.jp2",
           "ht_rgb.jph", "ht_ground_1024.jph")
HT_GREY16 = "ht_grey16.j2c"
HT_1024 = "ht_ground_1024.jph"
# what OpenJPEG 2.5.4 refuses: a later layer's passes join the cleanup's
# segment (its tier 2 gives an HT block's first segment room for 109; a
# lone SigProp pass leaves the second segment empty), the mixed code-block
# style, ROI with HT
HT_REFUSED = ("ht_layer_refinement.j2c", "ht_layer_sigprop.j2c", "ht_mixed_style.j2c",
              "ht_roi.j2c")


def ht_files() -> dict[str, HtFile]:
    """The HT files: cleanup-only, 2-pass and 3-pass blocks, cleanup bit-planes
    above 0, 64x64, 32x32, 16x64 and 1024x4 code-blocks, odd edges, tiles,
    precincts, layers, RCT with the 5/3 and ICT with the 9/7, RGB, RGBA,
    12- and 16-bit and signed grey, raw, JP2 and JPH; and what OpenJPEG
    refuses: a refinement in a later layer than its cleanup, the mixed
    style, ROI."""
    mf = _make_fixtures()
    tex = mf.texture
    grey = tex(47, 61, 1, 201)[..., 0]
    return {
        "ht_cleanup_53_grey.j2c": encode_ht(grey, levels=4),
        "ht_3pass_rct.jp2": encode_ht(tex(43, 57, 3, 202), levels=3, cblk=(5, 5), passes=3, p=2,
                                      mct=True, box="jp2"),
        "ht_p3_lossy.j2c": encode_ht(tex(39, 50, 3, 203), levels=3, p=3, mct=True),
        "ht_p4_3pass.j2c": encode_ht(tex(33, 35, 3, 204), levels=2, passes=3, p=4, mct=True,
                                     cblk=(4, 4)),
        "ht_vsc_16x64.j2c": encode_ht(tex(70, 45, 3, 205), levels=2, cblk=(4, 6), passes=3, p=2,
                                      vsc=True, mct=True),
        "ht_1024x4.j2c": encode_ht(tex(37, 300, 3, 206), levels=1, cblk=(10, 2), mct=True),
        "ht_tiles_precincts_layers.j2c": encode_ht(
            tex(61, 83, 3, 207), levels=3, tile=(32, 32), layers=3, cblk=(4, 4), passes=3, p=2,
            precincts=[(3, 3), (3, 3), (4, 4), (4, 4)], mct=True),
        "ht_97_ict.jp2": encode_ht(tex(45, 52, 3, 208), irreversible=True, levels=4, mct=True,
                                   step=0.75, box="jp2"),
        "ht_97_3pass.j2c": encode_ht(tex(40, 41, 3, 209), irreversible=True, levels=3, mct=True,
                                     passes=3, p=2, step=0.5, cblk=(5, 4)),
        "ht_rgba.jp2": encode_ht(tex(36, 49, 4, 210), levels=3, mct=True, cblk=(5, 5), box="jp2"),
        "ht_grey12.j2c": encode_ht(tex(29, 38, 1, 211, depth=16)[..., 0] >> 4, prec=12, levels=3,
                                   passes=3, p=2),
        "ht_grey16.j2c": encode_ht(tex(64, 64, 1, 212, depth=16)[..., 0], prec=16, levels=4),
        "ht_signed.j2c": encode_ht(tex(31, 27, 1, 213)[..., 0].astype(np.int16) - 128,
                                   signed=True, levels=2),
        "ht_rgb.jph": encode_ht(tex(48, 40, 3, 214), levels=3, mct=True, box="jph", cpf=True),
        "ht_ground_1024.jph": encode_ht(mf.smooth_texture(1024, 3, 78), irreversible=True,
                                        levels=5, mct=True, step=1.5, box="jph"),
        "ht_2pass.j2c": encode_ht(tex(37, 42, 3, 216), levels=2, passes=2, p=2, mct=True,
                                  cblk=(5, 3)),
        "ht_layer_refinement.j2c": encode_ht(tex(24, 24, 1, 215)[..., 0], levels=1, layers=2,
                                             split="passes", passes=3, p=2, cblk=(3, 3)),
        "ht_layer_sigprop.j2c": encode_ht(tex(24, 24, 1, 217)[..., 0], levels=1, layers=2,
                                          split="passes", passes=2, p=2, cblk=(3, 3)),
        "ht_mixed_style.j2c": _restyle(encode_ht(grey, levels=2), 0xC0),
        "ht_roi.j2c": encode_ht(grey, levels=2, extra_main=_marker(0xFF5E, bytes([0, 0, 3]))),
    }


def _restyle(f: HtFile, style: int) -> HtFile:
    data = bytearray(f.data)
    cod = data.find(b"\xff\x52")
    data[cod + 12] = style
    return HtFile(bytes(data), None, False)


def part2_files() -> dict[str, bytes]:
    """MCT, MCC, MCO and CBD (and CAP, CPF) spliced into a Pillow-saved
    lossless RGB codestream, in the main header or a tile-part's; an
    offset array over an MCO on an HT codestream."""
    mf = _make_fixtures()
    base = _pillow_j2k(mf.texture(24, 20, 3, 220))
    ident = [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]
    offsets = mct(2, 0, [100, 128, 150])
    main = {
        "p2_mco_offset.j2c": mct(1, 2, ident, 1) + offsets + mcc(1, 3, 1, 2) + mco(1),
        "p2_mco_int32.j2c": mct(2, 1, [-20, 300, 64]) + mcc(1, 3, 0, 2) + mco(1),
        "p2_mco_float64.j2c": mct(2, 3, [10.7, -3.9, 1e12]) + mcc(1, 3, 0, 2) + mco(1),
        "p2_mco_no_mcc.j2c": mco(5),
        "p2_mco_second_mcc.j2c": offsets + mcc(1, 3, 0, 0) + mcc(3, 3, 0, 2) + mco(3),
        "p2_mct_replaced.j2c": mct(2, 0, [1, 2, 3]) + mcc(1, 3, 0, 2) + mct(2, 0, [200, 10, 90])
        + mco(1),
        "p2_mco_two_stages.j2c": offsets + mcc(1, 3, 0, 2) + _marker(0xFF77, bytes([2, 1, 1])),
        "p2_mcc_shuffle.j2c": offsets + mcc(1, 3, 0, 2, order=[1, 0, 2]) + mco(1),
        "p2_mcc_two_comps.j2c": mct(2, 0, [1, 2]) + mcc(1, 2, 0, 2) + mco(1),
        "p2_mcc_missing_mct.j2c": mcc(1, 3, 0, 7) + mco(1),
        "p2_mcc_trailing.j2c": offsets + mcc(1, 3, 0, 2, tail=b"\0") + mco(1),
        "p2_mct_zmct.j2c": mct(2, 0, [1, 2, 3], zmct=1) + mcc(1, 3, 0, 2) + mco(1),
        "p2_mct_ymct.j2c": mct(2, 0, [1, 2, 3], ymct=1) + mcc(1, 3, 0, 2) + mco(1),
        "p2_mct_short.j2c": mct(2, 0, [1, 2]) + mcc(1, 3, 0, 2) + mco(1),
        "p2_mco_bad_size.j2c": _marker(0xFF77, bytes([1])),
        "p2_cbd_signed.j2c": cbd(0x87, 0x87, 0x87),
        "p2_cbd_prec4.j2c": cbd(3, 7, 7),
        "p2_cbd_prec12.j2c": cbd(11, 11, 11),
        "p2_cbd_count.j2c": cbd(7, 7, 7, count=2),
        "p2_cap_cpf.j2c": CAP + CPF,
    }
    out = {name: splice(base, main=m) for name, m in main.items()}
    out["p2_tph_mco.j2c"] = splice(base, tile=offsets + mcc(1, 3, 0, 2) + mco(1))
    out["p2_tph_mco_main_records.j2c"] = splice(base, main=offsets + mcc(1, 3, 0, 2), tile=mco(1))
    out["p2_tph_cap.j2c"] = splice(base, tile=CAP)
    out["p2_tph_cbd.j2c"] = splice(base, tile=cbd(7, 7, 7))
    cod = bytearray(base)
    cod[cod.find(b"\xff\x52") + 8] = 2
    out["p2_cod_mct2.j2c"] = bytes(cod)
    ht = encode_ht(mf.texture(26, 30, 3, 221), levels=2).data
    out["p2_ht_mco_offset.j2c"] = splice(ht, main=offsets + mcc(1, 3, 0, 2) + mco(1))
    return out


def round_trip(files: dict[str, HtFile]) -> None:
    """Each reversible file decodes in Pillow to the image its encoder
    meant; cleanup-only files to their input."""
    import io

    from PIL import Image

    for name, f in files.items():
        if name in HT_REFUSED:
            try:
                Image.open(io.BytesIO(f.data)).load()
            except OSError:
                continue
            raise AssertionError(f"{name}: Pillow decodes it")
        if f.expect is None:
            continue
        got = np.asarray(Image.open(io.BytesIO(f.data))).astype(np.int64)
        assert np.array_equal(got, f.pillow_expect()), name
        if f.lossless:
            assert np.array_equal(f.expect, f.source), name


def digest(arr: np.ndarray) -> np.ndarray:
    """make_fixtures.py's digest: SHA-256 of dtype, shape and bytes."""
    h = hashlib.sha256(f"{arr.dtype.str}{arr.shape}".encode() + np.ascontiguousarray(arr)
                       .tobytes())
    return np.frombuffer(h.digest(), np.uint8).copy()


def files() -> dict[str, bytes]:
    """Every committed file's name and bytes."""
    return {**{k: v.data for k, v in ht_files().items()}, **part2_files()}


def main() -> int:
    sys.path.insert(0, ROOT)
    from gatling_tpu import imgio

    ht = ht_files()
    round_trip(ht)
    arrays, rejected = {}, []
    for name, data in {**{k: v.data for k, v in ht.items()}, **part2_files()}.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        try:
            arr = imgio.load_image(data).data
        except ValueError:
            rejected.append(name)
            print(f"{name}: {len(data)} bytes, refused")
            continue
        arrays[name] = digest(arr) if name == HT_1024 else arr
        print(f"{name}: {len(data)} bytes, {arr.dtype} {arr.shape}")
    np.savez_compressed(os.path.join(HERE, "ht_fixtures.npz"), refused=np.array(sorted(rejected)),
                        **arrays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
