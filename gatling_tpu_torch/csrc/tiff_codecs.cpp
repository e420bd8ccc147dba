// TIFF codecs of the port's host library (imgio/tiff.py), decoded as the
// libtiff 4.7 that Pillow 12.1 loads decodes them:
//
// - CCITT (tif_fax3.c): Modified Huffman (compression 2, rows byte-aligned),
//   RLEW (32771, rows word-aligned), T.4 (3: 1D, or 2D under T4Options
//   bit 0) and T.6 (4). The code tables are built as mkg3states.c builds
//   tif_fax3sm.c's (a state, a code width and a run for every 7-, 12- or
//   13-bit lookahead, LSB first), and the row loops are tif_fax3.c's macros:
//   a bad code word ends its row (the runs cleaned up to the row's width),
//   a T.4 row is found by its EOL, and where the EOL search runs out of
//   data the strip is decoded again from its start without EOLs, from the
//   row at hand (libtiff's "decode fax Group 3 data without EOL"); a
//   premature end of data fails the strip, and a T.6 strip whose data ends
//   after its first row keeps the rows it decoded.
// - ThunderScan (tif_thunder.c): 4-bit grey runs and deltas (a run that
//   ends a row written, where libtiff leaves it unwritten).
// - Zstandard (RFC 8878; libtiff's tif_zstd.c over libzstd 1.5.7's
//   ZSTD_decompressStream): the first frame of a strip, raw, RLE and
//   compressed blocks, Huffman literals (one and four streams, treeless),
//   FSE sequences (predefined, RLE, compressed and repeat modes) with
//   repeat offsets, the window size, the XXH64 content checksum; damaged
//   four-stream literals as libzstd's fast Huffman path reads them. A
//   frame that needs a dictionary is refused, as libzstd refuses it.
// - LZMA (tif_lzma.c over liblzma's lzma_stream_decoder): an xz stream's
//   blocks, their LZMA2 chunks behind up to three delta or branch (x86,
//   PowerPC, IA64, ARM, ARM-Thumb, SPARC, ARM64, RISC-V) filters, written
//   as liblzma writes them in the one
//   lzma_code call of LZMADecode: every byte decoded before liblzma meets
//   an error is in the caller's buffer, and an error met once the buffer
//   is full is never seen.

#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// CCITT Group 3 and 4 (tif_fax3.c, tif_fax3.h, mkg3states.c)
// ---------------------------------------------------------------------------

enum { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW,
       S_MakeUpB, S_MakeUp, S_EOL };

struct FaxEnt {
    uint8_t State;
    uint8_t Width;
    uint32_t Param;
};

struct Proto {
    const char* code;  // MSB first, as T.4 prints it
    uint32_t run;
};

// T.4 tables 1-3
const Proto kTermW[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4}, {"1100", 5},
    {"1110", 6}, {"1111", 7}, {"10011", 8}, {"10100", 9}, {"00111", 10}, {"01000", 11},
    {"001000", 12}, {"000011", 13}, {"110100", 14}, {"110101", 15}, {"101010", 16},
    {"101011", 17}, {"0100111", 18}, {"0001100", 19}, {"0001000", 20}, {"0010111", 21},
    {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25}, {"0010011", 26},
    {"0100100", 27}, {"0011000", 28}, {"00000010", 29}, {"00000011", 30}, {"00011010", 31},
    {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35}, {"00010101", 36},
    {"00010110", 37}, {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45}, {"00000101", 46},
    {"00001010", 47}, {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51},
    {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55}, {"01011001", 56},
    {"01011010", 57}, {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61},
    {"00110011", 62}, {"00110100", 63}, {nullptr, 0}};
const Proto kMakeUpW[] = {
    {"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256}, {"00110110", 320},
    {"00110111", 384}, {"01100100", 448}, {"01100101", 512}, {"01101000", 576},
    {"01100111", 640}, {"011001100", 704}, {"011001101", 768}, {"011010010", 832},
    {"011010011", 896}, {"011010100", 960}, {"011010101", 1024}, {"011010110", 1088},
    {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
    {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
    {"011000", 1664}, {"010011011", 1728}, {nullptr, 0}};
const Proto kTermB[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4}, {"0011", 5}, {"0010", 6},
    {"00011", 7}, {"000101", 8}, {"000100", 9}, {"0000100", 10}, {"0000101", 11},
    {"0000111", 12}, {"00000100", 13}, {"00000111", 14}, {"000011000", 15},
    {"0000010111", 16}, {"0000011000", 17}, {"0000001000", 18}, {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23},
    {"00000010111", 24}, {"00000011000", 25}, {"000011001010", 26}, {"000011001011", 27},
    {"000011001100", 28}, {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31},
    {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35},
    {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39},
    {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47},
    {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50}, {"000001010011", 51},
    {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55},
    {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63},
    {nullptr, 0}};
const Proto kMakeUpB[] = {
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256},
    {"000000110011", 320}, {"000000110100", 384}, {"000000110101", 448},
    {"0000001101100", 512}, {"0000001101101", 576}, {"0000001001010", 640},
    {"0000001001011", 704}, {"0000001001100", 768}, {"0000001001101", 832},
    {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344}, {"0000001010100", 1408},
    {"0000001010101", 1472}, {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}, {nullptr, 0}};
const Proto kMakeUp[] = {  // the extended make-up codes of either colour
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}, {nullptr, 0}};
// T.4 table 4 (the 2D modes); the extension's seven bits, and EOL's
// zeros as libtiff's tables take them (7 in the mode table, 11 in the
// run tables)
const Proto kPass[] = {{"0001", 0}, {nullptr, 0}};
const Proto kHoriz[] = {{"001", 0}, {nullptr, 0}};
const Proto kV0[] = {{"1", 0}, {nullptr, 0}};
const Proto kVR[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}, {nullptr, 0}};
const Proto kVL[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}, {nullptr, 0}};
const Proto kExt[] = {{"0000001", 0}, {nullptr, 0}};
const Proto kEOLV[] = {{"0000000", 0}, {nullptr, 0}};
const Proto kEOLH[] = {{"00000000000", 0}, {nullptr, 0}};

struct FaxTables {
    FaxEnt main[128], white[4096], black[8192];

    static void fill(FaxEnt* t, int size, const Proto* p, int state) {
        int limit = 1 << size;
        for (; p->code; ++p) {
            int width = (int)strlen(p->code);
            int code = 0;
            for (int k = 0; k < width; ++k)  // LSB first: the first bit lowest
                code |= (p->code[k] == '1') << k;
            for (int c = code; c < limit; c += 1 << width) {
                t[c].State = (uint8_t)state;
                t[c].Width = (uint8_t)width;
                t[c].Param = p->run;
            }
        }
    }

    FaxTables() {
        memset(main, 0, sizeof(main));
        memset(white, 0, sizeof(white));
        memset(black, 0, sizeof(black));
        fill(main, 7, kPass, S_Pass);
        fill(main, 7, kHoriz, S_Horiz);
        fill(main, 7, kV0, S_V0);
        fill(main, 7, kVR, S_VR);
        fill(main, 7, kVL, S_VL);
        fill(main, 7, kExt, S_Ext);
        fill(main, 7, kEOLV, S_EOL);
        fill(white, 12, kMakeUpW, S_MakeUpW);
        fill(white, 12, kMakeUp, S_MakeUp);
        fill(white, 12, kTermW, S_TermW);
        fill(white, 12, kEOLH, S_EOL);
        fill(black, 13, kMakeUpB, S_MakeUpB);
        fill(black, 13, kMakeUp, S_MakeUp);
        fill(black, 13, kTermB, S_TermB);
        fill(black, 13, kEOLH, S_EOL);
    }
};

const FaxTables& fax_tables() {
    static const FaxTables t;
    return t;
}

uint8_t bit_reverse(uint8_t b) {
    b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
    b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
    return (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

// _TIFFFax3fillruns: white runs clear bits, black runs set them
void fax_fill(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
    static const uint8_t masks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0, 0xf8, 0xfc, 0xfe, 0xff};
    if ((erun - runs) & 1) *erun++ = 0;
    uint32_t x = 0;
    for (; runs < erun; runs += 2) {
        for (int black = 0; black < 2; ++black) {
            uint32_t run = runs[black];
            if (x + run > lastx || run > lastx) run = runs[black] = lastx - x;
            if (!run) continue;
            uint8_t* cp = buf + (x >> 3);
            uint32_t bx = x & 7;
            if (run > 8 - bx) {
                if (bx) {
                    if (black) *cp++ |= (uint8_t)(0xff >> bx);
                    else *cp++ &= (uint8_t)(0xff << (8 - bx));
                    run -= 8 - bx;
                }
                uint32_t n = run >> 3;
                memset(cp, black ? 0xff : 0, n);
                cp += n;
                run &= 7;
                if (run) {
                    if (black) *cp |= masks[run];
                    else *cp &= (uint8_t)(0xff >> run);
                }
            } else if (black) {
                cp[0] |= (uint8_t)(masks[run] >> bx);
            } else {
                cp[0] &= (uint8_t)~(masks[run] >> bx);
            }
            x += runs[black];
        }
    }
}

enum { FAX_RLE, FAX_RLEW, FAX_1D, FAX_2D, FAX_G4 };

// One strip or tile: `rows` rows of `rowbytes` bytes, `rowpixels` pixels
// each. Returns 1, or -1 where TIFFReadEncodedStrip fails.
int fax_decode(const uint8_t* src, int64_t n, uint8_t* buf, int64_t rows, int64_t rowbytes,
               int32_t rowpixels, int kind, bool msb_first, int64_t src_offset) {
    const FaxTables& T = fax_tables();
    uint8_t bitmap[256];
    for (int b = 0; b < 256; ++b) bitmap[b] = msb_first ? bit_reverse((uint8_t)b) : (uint8_t)b;
    bool refline = kind == FAX_2D || kind == FAX_G4;
    uint32_t nruns = (uint32_t)((rowpixels + 1 + 31) / 32 * 32);
    if (refline) nruns *= 2;
    std::vector<uint32_t> runs_store(2 * (size_t)nruns, 0);
    uint32_t* runs = runs_store.data();
    uint32_t* curruns = runs;
    uint32_t* refruns = refline ? runs + nruns : nullptr;
    if (refruns) {
        refruns[0] = (uint32_t)rowpixels;
        refruns[1] = 0;
    }
    const uint8_t* cp = src;
    const uint8_t* ep = src + n;
    uint32_t BitAcc = 0;
    int BitsAvail = 0;
    int EOLcnt = 0;
    int lastx = rowpixels;
    int a0 = 0, RunLength = 0, b1 = 0;
    uint32_t *pa = nullptr, *thisrun = nullptr, *pb = nullptr;
    const FaxEnt* TabEnt = nullptr;
    int64_t line = 0;
    int64_t occ = rows * rowbytes;
    int is1D = 0;
    bool noeol = false;

#define EndOfData() (cp >= ep)
#define NeedBits8(nb, eoflab)                                                   \
    do {                                                                       \
        if (BitsAvail < (nb)) {                                                \
            if (EndOfData()) {                                                 \
                if (BitsAvail == 0) goto eoflab;                               \
                BitsAvail = (nb);                                              \
            } else {                                                           \
                BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail;              \
                BitsAvail += 8;                                                \
            }                                                                  \
        }                                                                      \
    } while (0)
#define NeedBits16(nb, eoflab)                                                  \
    do {                                                                       \
        if (BitsAvail < (nb)) {                                                \
            if (EndOfData()) {                                                 \
                if (BitsAvail == 0) goto eoflab;                               \
                BitsAvail = (nb);                                              \
            } else {                                                           \
                BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail;              \
                if ((BitsAvail += 8) < (nb)) {                                 \
                    if (EndOfData()) {                                         \
                        BitsAvail = (nb);                                      \
                    } else {                                                   \
                        BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail;      \
                        BitsAvail += 8;                                        \
                    }                                                          \
                }                                                              \
            }                                                                  \
        }                                                                      \
    } while (0)
#define GetBits(nb) (BitAcc & ((1u << (nb)) - 1))
#define ClrBits(nb)                                                             \
    do {                                                                       \
        BitsAvail -= (nb);                                                     \
        BitAcc >>= (nb);                                                       \
    } while (0)
#define LOOKUP8(wid, tab, eoflab)                                               \
    do {                                                                       \
        NeedBits8(wid, eoflab);                                                \
        TabEnt = tab + GetBits(wid);                                           \
        ClrBits(TabEnt->Width);                                                \
    } while (0)
#define LOOKUP16(wid, tab, eoflab)                                              \
    do {                                                                       \
        NeedBits16(wid, eoflab);                                               \
        TabEnt = tab + GetBits(wid);                                           \
        ClrBits(TabEnt->Width);                                                \
    } while (0)
#define SETVALUE(x)                                                             \
    do {                                                                       \
        if (pa >= thisrun + nruns) return -1;                                  \
        *pa++ = (uint32_t)(RunLength + (x));                                   \
        a0 += (x);                                                             \
        RunLength = 0;                                                         \
    } while (0)
#define SYNC_EOL(eoflab)                                                        \
    do {                                                                       \
        if (!noeol) {                                                          \
            if (EOLcnt == 0) {                                                 \
                for (;;) {                                                     \
                    NeedBits16(11, noEOLFound);                                \
                    if (GetBits(11) == 0) break;                               \
                    ClrBits(1);                                                \
                }                                                              \
            }                                                                  \
            for (;;) {                                                         \
                NeedBits8(8, noEOLFound);                                      \
                if (GetBits(8)) break;                                         \
                ClrBits(8);                                                    \
            }                                                                  \
            while (GetBits(1) == 0) ClrBits(1);                                \
            ClrBits(1);                                                        \
            EOLcnt = 0;                                                        \
        }                                                                      \
    } while (0)
#define CLEANUP_RUNS()                                                          \
    do {                                                                       \
        if (RunLength) SETVALUE(0);                                            \
        if (a0 != lastx) {                                                     \
            while (a0 > lastx && pa > thisrun) a0 -= (int)*--pa;               \
            if (a0 < lastx) {                                                  \
                if (a0 < 0) a0 = 0;                                            \
                if ((pa - thisrun) & 1) SETVALUE(0);                           \
                SETVALUE(lastx - a0);                                          \
            } else if (a0 > lastx) {                                           \
                SETVALUE(lastx);                                               \
                SETVALUE(0);                                                   \
            }                                                                  \
        }                                                                      \
    } while (0)
#define EXPAND1D(eoflab, tag)                                                        \
    do {                                                                       \
        for (;;) {                                                             \
            for (;;) {                                                         \
                LOOKUP16(12, T.white, eof1d##tag);                                  \
                switch (TabEnt->State) {                                       \
                    case S_EOL: EOLcnt = 1; goto done1d##tag;                       \
                    case S_TermW: SETVALUE((int)TabEnt->Param); goto doneWhite1d##tag; \
                    case S_MakeUpW:                                            \
                    case S_MakeUp:                                             \
                        a0 += (int)TabEnt->Param;                              \
                        RunLength += (int)TabEnt->Param;                       \
                        break;                                                 \
                    default: goto done1d##tag;                                      \
                }                                                              \
            }                                                                  \
        doneWhite1d##tag:                                                           \
            if (a0 >= lastx) goto done1d##tag;                                      \
            for (;;) {                                                         \
                LOOKUP16(13, T.black, eof1d##tag);                                  \
                switch (TabEnt->State) {                                       \
                    case S_EOL: EOLcnt = 1; goto done1d##tag;                       \
                    case S_TermB: SETVALUE((int)TabEnt->Param); goto doneBlack1d##tag; \
                    case S_MakeUpB:                                            \
                    case S_MakeUp:                                             \
                        a0 += (int)TabEnt->Param;                              \
                        RunLength += (int)TabEnt->Param;                       \
                        break;                                                 \
                    default: goto done1d##tag;                                      \
                }                                                              \
            }                                                                  \
        doneBlack1d##tag:                                                           \
            if (a0 >= lastx) goto done1d##tag;                                      \
            if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;                     \
        }                                                                      \
    eof1d##tag:                                                                     \
        CLEANUP_RUNS();                                                        \
        goto eoflab;                                                           \
    done1d##tag:                                                                    \
        CLEANUP_RUNS();                                                        \
    } while (0)
#define CHECK_b1                                                                \
    do {                                                                       \
        if (pa != thisrun)                                                     \
            while (b1 <= a0 && b1 < lastx) {                                   \
                if (pb + 1 >= refruns + nruns) return -1;                      \
                b1 += (int)(pb[0] + pb[1]);                                    \
                pb += 2;                                                       \
            }                                                                  \
    } while (0)
#define EXPAND2D(eoflab, tag)                                                        \
    do {                                                                       \
        while (a0 < lastx) {                                                   \
            if (pa >= thisrun + nruns) return -1;                              \
            LOOKUP8(7, T.main, eof2d##tag);                                         \
            switch (TabEnt->State) {                                           \
                case S_Pass:                                                   \
                    CHECK_b1;                                                  \
                    if (pb + 1 >= refruns + nruns) return -1;                  \
                    b1 += (int)*pb++;                                          \
                    RunLength += b1 - a0;                                      \
                    a0 = b1;                                                   \
                    b1 += (int)*pb++;                                          \
                    break;                                                     \
                case S_Horiz:                                                  \
                    if ((pa - thisrun) & 1) {                                  \
                        for (;;) {                                             \
                            LOOKUP16(13, T.black, eof2d##tag);                      \
                            switch (TabEnt->State) {                           \
                                case S_TermB: SETVALUE((int)TabEnt->Param); goto doneWhite2da##tag; \
                                case S_MakeUpB:                                \
                                case S_MakeUp:                                 \
                                    a0 += (int)TabEnt->Param;                  \
                                    RunLength += (int)TabEnt->Param;           \
                                    break;                                     \
                                default: goto badBlack2d##tag;                      \
                            }                                                  \
                        }                                                      \
                    doneWhite2da##tag:;                                             \
                        for (;;) {                                             \
                            LOOKUP16(12, T.white, eof2d##tag);                      \
                            switch (TabEnt->State) {                           \
                                case S_TermW: SETVALUE((int)TabEnt->Param); goto doneBlack2da##tag; \
                                case S_MakeUpW:                                \
                                case S_MakeUp:                                 \
                                    a0 += (int)TabEnt->Param;                  \
                                    RunLength += (int)TabEnt->Param;           \
                                    break;                                     \
                                default: goto badWhite2d##tag;                      \
                            }                                                  \
                        }                                                      \
                    doneBlack2da##tag:;                                             \
                    } else {                                                   \
                        for (;;) {                                             \
                            LOOKUP16(12, T.white, eof2d##tag);                      \
                            switch (TabEnt->State) {                           \
                                case S_TermW: SETVALUE((int)TabEnt->Param); goto doneWhite2db##tag; \
                                case S_MakeUpW:                                \
                                case S_MakeUp:                                 \
                                    a0 += (int)TabEnt->Param;                  \
                                    RunLength += (int)TabEnt->Param;           \
                                    break;                                     \
                                default: goto badWhite2d##tag;                      \
                            }                                                  \
                        }                                                      \
                    doneWhite2db##tag:;                                             \
                        for (;;) {                                             \
                            LOOKUP16(13, T.black, eof2d##tag);                      \
                            switch (TabEnt->State) {                           \
                                case S_TermB: SETVALUE((int)TabEnt->Param); goto doneBlack2db##tag; \
                                case S_MakeUpB:                                \
                                case S_MakeUp:                                 \
                                    a0 += (int)TabEnt->Param;                  \
                                    RunLength += (int)TabEnt->Param;           \
                                    break;                                     \
                                default: goto badBlack2d##tag;                      \
                            }                                                  \
                        }                                                      \
                    doneBlack2db##tag:;                                             \
                    }                                                          \
                    CHECK_b1;                                                  \
                    break;                                                     \
                case S_V0:                                                     \
                    CHECK_b1;                                                  \
                    SETVALUE(b1 - a0);                                         \
                    if (pb >= refruns + nruns) return -1;                      \
                    b1 += (int)*pb++;                                          \
                    break;                                                     \
                case S_VR:                                                     \
                    CHECK_b1;                                                  \
                    SETVALUE(b1 - a0 + (int)TabEnt->Param);                    \
                    if (pb >= refruns + nruns) return -1;                      \
                    b1 += (int)*pb++;                                          \
                    break;                                                     \
                case S_VL:                                                     \
                    CHECK_b1;                                                  \
                    if (b1 < (int)(a0 + TabEnt->Param)) goto eol2d##tag;            \
                    SETVALUE(b1 - a0 - (int)TabEnt->Param);                    \
                    b1 -= (int)*--pb;                                          \
                    break;                                                     \
                case S_Ext:                                                    \
                    *pa++ = (uint32_t)(lastx - a0);                            \
                    goto eol2d##tag;                                                \
                case S_EOL:                                                    \
                    *pa++ = (uint32_t)(lastx - a0);                            \
                    NeedBits8(4, eof2d##tag);                                       \
                    ClrBits(4);                                                \
                    EOLcnt = 1;                                                \
                    goto eol2d##tag;                                                \
                default:                                                       \
                badMain2d##tag:                                                     \
                    goto eol2d##tag;                                                \
                badBlack2d##tag:                                                    \
                    goto eol2d##tag;                                                \
                badWhite2d##tag:                                                    \
                    goto eol2d##tag;                                                \
                eof2d##tag:                                                         \
                    CLEANUP_RUNS();                                            \
                    goto eoflab;                                               \
            }                                                                  \
        }                                                                      \
        if (RunLength) {                                                       \
            if (RunLength + a0 < lastx) {                                      \
                NeedBits8(1, eof2d##tag);                                           \
                if (!GetBits(1)) goto badMain2d##tag;                               \
                ClrBits(1);                                                    \
            }                                                                  \
            SETVALUE(0);                                                       \
        }                                                                      \
    eol2d##tag:                                                                     \
        CLEANUP_RUNS();                                                        \
    } while (0)

    if (occ % rowbytes) return -1;  // "Fractional scanlines cannot be read"
    if (kind == FAX_RLE || kind == FAX_RLEW) {
        thisrun = curruns;
        while (occ > 0) {
            a0 = 0;
            RunLength = 0;
            pa = thisrun;
            EXPAND1D(EOFRLE, _rle);
            fax_fill(buf, thisrun, pa, (uint32_t)lastx);
            if (kind == FAX_RLE) {
                int k = BitsAvail - (BitsAvail & ~7);
                ClrBits(k);
            } else {
                int k = BitsAvail - (BitsAvail & ~15);
                ClrBits(k);
                // isAligned(cp, uint16_t) on the memory-mapped file
                if (BitsAvail == 0 && ((src_offset + (cp - src)) & 1)) cp++;
            }
            buf += rowbytes;
            occ -= rowbytes;
            line++;
            continue;
        EOFRLE:
            fax_fill(buf, thisrun, pa, (uint32_t)lastx);
            return -1;
        }
        return 1;
    }
    if (kind == FAX_1D) {
        thisrun = curruns;
        if (false) {
        noEOLFound1D:
            if (noeol) goto EOF1D;
            noeol = true;  // no EOL where one should be: decode again without EOLs
            cp = src;
            BitAcc = 0;
            BitsAvail = 0;
            EOLcnt = 0;
        }
        while (occ > 0) {
            a0 = 0;
            RunLength = 0;
            pa = thisrun;
#define noEOLFound noEOLFound1D
            SYNC_EOL(EOF1D);
#undef noEOLFound
            EXPAND1D(EOF1Da, _1d);
            fax_fill(buf, thisrun, pa, (uint32_t)lastx);
            buf += rowbytes;
            occ -= rowbytes;
            line++;
            continue;
        EOF1D:
            CLEANUP_RUNS();
        EOF1Da:
            fax_fill(buf, thisrun, pa, (uint32_t)lastx);
            return -1;
        }
        return 1;
    }
    if (kind == FAX_2D) {
        if (false) {
        noEOLFound2D:
            if (noeol) goto EOF2D;
            noeol = true;
            cp = src;
            BitAcc = 0;
            BitsAvail = 0;
            EOLcnt = 0;
        }
        while (occ > 0) {
            a0 = 0;
            RunLength = 0;
            pa = thisrun = curruns;
#define noEOLFound noEOLFound2D
            SYNC_EOL(EOF2D);
#undef noEOLFound
            NeedBits8(1, EOF2D);
            is1D = (int)GetBits(1);
            ClrBits(1);
            pb = refruns;
            b1 = (int)*pb++;
            if (is1D) EXPAND1D(EOF2Da, _2d);
            else EXPAND2D(EOF2Da, _2d);
            fax_fill(buf, thisrun, pa, (uint32_t)lastx);
            if (pa < thisrun + nruns) SETVALUE(0);
            {
                uint32_t* t = curruns;
                curruns = refruns;
                refruns = t;
            }
            buf += rowbytes;
            occ -= rowbytes;
            line++;
            continue;
        EOF2D:
            CLEANUP_RUNS();
        EOF2Da:
            fax_fill(buf, thisrun, pa, (uint32_t)lastx);
            return -1;
        }
        return 1;
    }
    // T.6
    while (occ > 0) {
        a0 = 0;
        RunLength = 0;
        pa = thisrun = curruns;
        pb = refruns;
        b1 = (int)*pb++;
        EXPAND2D(EOFG4, _g4);
        if (EOLcnt) goto EOFG4;
        if (((lastx + 7) >> 3) > occ) return -1;
        fax_fill(buf, thisrun, pa, (uint32_t)lastx);
        SETVALUE(0);
        {
            uint32_t* t = curruns;
            curruns = refruns;
            refruns = t;
        }
        buf += rowbytes;
        occ -= rowbytes;
        line++;
        continue;
    EOFG4:
        NeedBits16(13, BADG4);
    BADG4:
        ClrBits(13);
        if (((lastx + 7) >> 3) > occ) return -1;
        fax_fill(buf, thisrun, pa, (uint32_t)lastx);
        // libtiff keeps a strip that ends after its first row ("don't error
        // on badly-terminated strips") but leaves the rows after the end
        // unwritten: 0 tells the caller
        return line != 0 ? 0 : -1;
    }
    return 1;
#undef EndOfData
#undef NeedBits8
#undef NeedBits16
#undef GetBits
#undef ClrBits
#undef LOOKUP8
#undef LOOKUP16
#undef SETVALUE
#undef SYNC_EOL
#undef CLEANUP_RUNS
#undef EXPAND1D
#undef CHECK_b1
#undef EXPAND2D
}

// ---------------------------------------------------------------------------
// ThunderScan (tif_thunder.c)
// ---------------------------------------------------------------------------

// ThunderDecode of one row of `maxpixels` 4-bit pixels at op0 (within the
// strip buffer [lo, hi)); *bp and *cc advance over the input. 1, or 0.
int thunder_row(const uint8_t** bpp, int64_t* ccp, uint8_t* op0, int64_t maxpixels,
                uint8_t* lo, uint8_t* hi) {
    static const int twobitdeltas[4] = {0, 1, 0, -1};
    static const int threebitdeltas[8] = {0, 1, 2, 3, 0, -3, -2, -1};
    const uint8_t* bp = *bpp;
    int64_t cc = *ccp;
    unsigned lastpixel = 0;
    int64_t npixels = 0;
    uint8_t* op = op0;
    auto put = [&](uint8_t* p, uint8_t v) {
        if (p >= lo && p < hi) *p = v;
    };
    auto get = [&](uint8_t* p) -> uint8_t { return (p >= lo && p < hi) ? *p : 0; };
    auto setpixel = [&](unsigned v) {
        lastpixel = v & 0xf;
        if (npixels < maxpixels) {
            if (npixels++ & 1) {
                put(op, (uint8_t)(get(op) | lastpixel));
                op++;
            } else {
                put(op, (uint8_t)(lastpixel << 4));
            }
        }
    };
    while (cc > 0 && npixels < maxpixels) {
        int n = *bp++;
        int delta;
        cc--;
        switch (n & 0xc0) {
            case 0x00:  // a run of the last pixel, n times
                if (npixels & 1) {
                    put(op, (uint8_t)(get(op) | lastpixel));
                    lastpixel = get(op);
                    op++;
                    npixels++;
                    n--;
                } else {
                    lastpixel |= lastpixel << 4;
                }
                npixels += n;
                // libtiff writes nothing for a run that ends exactly at the
                // row's end (npixels < maxpixels), leaving those pixels as
                // its caller's buffer held them (in Pillow, memory never
                // written): the port writes the run
                if (npixels <= maxpixels) {
                    for (; n > 0; n -= 2) put(op++, (uint8_t)lastpixel);
                }
                if (n == -1) {
                    --op;
                    put(op, (uint8_t)(get(op) & 0xf0));
                }
                lastpixel &= 0xf;
                break;
            case 0x40:  // three 2-bit deltas
                if ((delta = (n >> 4) & 3) != 2) setpixel((unsigned)((int)lastpixel + twobitdeltas[delta]));
                if ((delta = (n >> 2) & 3) != 2) setpixel((unsigned)((int)lastpixel + twobitdeltas[delta]));
                if ((delta = n & 3) != 2) setpixel((unsigned)((int)lastpixel + twobitdeltas[delta]));
                break;
            case 0x80:  // two 3-bit deltas
                if ((delta = (n >> 3) & 7) != 4) setpixel((unsigned)((int)lastpixel + threebitdeltas[delta]));
                if ((delta = n & 7) != 4) setpixel((unsigned)((int)lastpixel + threebitdeltas[delta]));
                break;
            default:  // raw
                setpixel((unsigned)n);
                break;
        }
    }
    *bpp = bp;
    *ccp = cc;
    if (npixels != maxpixels) {
        uint8_t* op_end = op0 + (maxpixels + 1) / 2;
        for (uint8_t* p = op; p < op_end; ++p) put(p, 0);
        return 0;
    }
    return 1;
}

// ---------------------------------------------------------------------------
// Zstandard (RFC 8878)
// ---------------------------------------------------------------------------

struct ZError {};

uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t xxh64(const uint8_t* p, size_t len) {
    const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
    auto rd64 = [](const uint8_t* q) {
        uint64_t v;
        memcpy(&v, q, 8);
        return v;
    };
    auto rd32 = [](const uint8_t* q) {
        uint32_t v;
        memcpy(&v, q, 4);
        return v;
    };
    auto round = [&](uint64_t acc, uint64_t in) { return rotl64(acc + in * P2, 31) * P1; };
    const uint8_t* end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
        const uint8_t* limit = end - 32;
        do {
            v1 = round(v1, rd64(p));
            v2 = round(v2, rd64(p + 8));
            v3 = round(v3, rd64(p + 16));
            v4 = round(v4, rd64(p + 24));
            p += 32;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ round(0, v)) * P1 + P4;
    } else {
        h = P5;
    }
    h += (uint64_t)len;
    while (p + 8 <= end) {
        h ^= round(0, rd64(p));
        h = rotl64(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= (uint64_t)rd32(p) * P1;
        h = rotl64(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (*p) * P5;
        h = rotl64(h, 11) * P1;
        p++;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// A backward bit stream (FSE and Huffman): bits read from the end, the
// last byte's highest set bit the start marker. `consumed` counts bits
// read; reading past the start gives zeros and makes overflowed() true.
struct BackBits {
    const uint8_t* p;
    int64_t total;  // bits in the stream past the marker
    int64_t pos;    // bits left, counting down
    BackBits(const uint8_t* src, size_t n) : p(src) {
        if (n == 0 || src[n - 1] == 0) throw ZError();
        total = (int64_t)(n - 1) * 8 + highbit(src[n - 1]);
        pos = total;
    }
    uint64_t read(int nb) {
        uint64_t v = 0;
        for (int k = 0; k < nb; ++k) {
            --pos;
            int bit = pos >= 0 ? (p[pos >> 3] >> (pos & 7)) & 1 : 0;
            v = (v << 1) | (uint64_t)bit;
        }
        return v;
    }
    uint64_t peek(int nb) const {
        uint64_t v = 0;
        int64_t q = pos;
        for (int k = 0; k < nb; ++k) {
            --q;
            int bit = q >= 0 ? (p[q >> 3] >> (q & 7)) & 1 : 0;
            v = (v << 1) | (uint64_t)bit;
        }
        return v;
    }
    bool overflowed() const { return pos < 0; }
    bool finished() const { return pos == 0; }
};

struct FseEntry {
    uint16_t symbol;
    uint8_t nbBits;
    uint16_t base;
};

struct FseTable {
    int log = 0;
    std::vector<FseEntry> t;
};

// FSE_readNCount: the normalized counts; returns the bytes read.
size_t read_ncount(const uint8_t* src, size_t n, int max_log, int max_symbol,
                   std::vector<int16_t>& norm, int& log) {
    if (n < 1) throw ZError();
    int64_t bitpos = 0;
    auto bit = [&](int64_t k) -> uint32_t {
        return (k >> 3) < (int64_t)n ? (src[k >> 3] >> (k & 7)) & 1 : 0;
    };
    auto peek = [&](int nb) -> uint32_t {
        uint32_t v = 0;
        for (int k = 0; k < nb; ++k) v |= bit(bitpos + k) << k;
        return v;
    };
    log = (int)(peek(4)) + 5;
    bitpos += 4;
    if (log > max_log) throw ZError();
    int remaining = (1 << log) + 1;
    int threshold = 1 << log;
    int nbBits = log + 1;
    int symbol = 0;
    bool previous0 = false;
    norm.assign(max_symbol + 1, 0);
    while (remaining > 1 && symbol <= max_symbol) {
        if (previous0) {
            for (;;) {
                uint32_t r = peek(2);
                bitpos += 2;
                symbol += (int)r;
                if (r != 3) break;
            }
            if (symbol > max_symbol) throw ZError();
            if (bitpos > (int64_t)n * 8) throw ZError();
        }
        int maxv = (2 * threshold - 1) - remaining;
        int count;
        uint32_t low = peek(nbBits - 1);
        if ((int)low < maxv) {
            count = (int)low;
            bitpos += nbBits - 1;
        } else {
            count = (int)peek(nbBits);
            if (count >= threshold) count -= maxv;
            bitpos += nbBits;
        }
        count--;
        remaining -= count < 0 ? -count : count;
        norm[symbol++] = (int16_t)count;
        previous0 = count == 0;
        if (remaining < 1) throw ZError();
        while (remaining < threshold) {
            nbBits--;
            threshold >>= 1;
        }
        if (bitpos > (int64_t)n * 8) throw ZError();
    }
    if (remaining != 1 || symbol > max_symbol + 1) throw ZError();
    norm.resize(symbol);
    return (size_t)((bitpos + 7) >> 3);
}

void build_fse(const std::vector<int16_t>& norm, int log, FseTable& out) {
    int size = 1 << log;
    out.log = log;
    out.t.assign(size, FseEntry{0, 0, 0});
    std::vector<uint32_t> next(norm.size());
    int high = size - 1;
    for (size_t s = 0; s < norm.size(); ++s) {
        if (norm[s] == -1) {
            out.t[high--].symbol = (uint16_t)s;
            next[s] = 1;
        } else {
            next[s] = (uint32_t)norm[s];
        }
    }
    int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
    for (size_t s = 0; s < norm.size(); ++s) {
        for (int i = 0; i < norm[s]; ++i) {
            out.t[pos].symbol = (uint16_t)s;
            do pos = (pos + step) & mask;
            while (pos > high);
        }
    }
    if (pos != 0) throw ZError();
    for (int u = 0; u < size; ++u) {
        uint32_t s = out.t[u].symbol;
        uint32_t ns = next[s]++;
        int nb = log - highbit(ns);
        out.t[u].nbBits = (uint8_t)nb;
        out.t[u].base = (uint16_t)((ns << nb) - size);
    }
}

void rle_fse(int symbol, FseTable& out) {
    out.log = 0;
    out.t.assign(1, FseEntry{(uint16_t)symbol, 0, 0});
}

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Huffman {
    int maxBits = 0;
    std::vector<uint8_t> sym, nb;  // 1 << maxBits entries
};

struct ZFrame {
    std::vector<uint8_t> out;
    FseTable ll, of, ml;
    bool ll_set = false, of_set = false, ml_set = false;  // a table to repeat
    bool fse_entropy = false, lit_entropy = false;
    Huffman huf;
    uint32_t rep[3] = {1, 4, 8};
    uint64_t window = 0, block_max = 0;
};

// HUF_readStats and the decoding table; returns the bytes read
size_t read_huffman(const uint8_t* src, size_t n, Huffman& h) {
    if (n < 1) throw ZError();
    uint8_t weights[256];
    int nw = 0;
    size_t used;
    int head = src[0];
    if (head >= 128) {
        nw = head - 127;
        used = 1 + (size_t)((nw + 1) / 2);
        if (used > n) throw ZError();
        for (int k = 0; k < nw; ++k) {
            uint8_t b = src[1 + k / 2];
            weights[k] = (uint8_t)((k & 1) ? b & 15 : b >> 4);
        }
    } else {
        used = 1 + (size_t)head;
        if (used > n || head == 0) throw ZError();
        std::vector<int16_t> norm;
        int log;
        size_t hdr = read_ncount(src + 1, (size_t)head, 6, 255, norm, log);
        if (hdr > (size_t)head) throw ZError();
        FseTable t;
        build_fse(norm, log, t);
        BackBits bits(src + 1 + hdr, (size_t)head - hdr);
        uint32_t s1 = (uint32_t)bits.read(log), s2 = (uint32_t)bits.read(log);
        for (;;) {
            if (nw > 253) throw ZError();
            weights[nw++] = (uint8_t)t.t[s1].symbol;
            s1 = t.t[s1].base + (uint32_t)bits.read(t.t[s1].nbBits);
            if (bits.overflowed()) {
                weights[nw++] = (uint8_t)t.t[s2].symbol;
                break;
            }
            if (nw > 253) throw ZError();
            weights[nw++] = (uint8_t)t.t[s2].symbol;
            s2 = t.t[s2].base + (uint32_t)bits.read(t.t[s2].nbBits);
            if (bits.overflowed()) {
                weights[nw++] = (uint8_t)t.t[s1].symbol;
                break;
            }
        }
    }
    uint32_t total = 0;
    int rank[16] = {0};
    for (int k = 0; k < nw; ++k) {
        if (weights[k] > 12) throw ZError();
        rank[weights[k]]++;
        if (weights[k]) total += 1u << (weights[k] - 1);
    }
    if (total == 0) throw ZError();
    int maxBits = highbit(total) + 1;
    if (maxBits > 12) throw ZError();
    uint32_t rest = (1u << maxBits) - total;
    if (rest & (rest - 1)) throw ZError();
    int last = highbit(rest) + 1;
    weights[nw++] = (uint8_t)last;
    rank[last]++;
    if (rank[1] < 2 || (rank[1] & 1)) throw ZError();
    h.maxBits = maxBits;
    h.sym.assign((size_t)1 << maxBits, 0);
    h.nb.assign((size_t)1 << maxBits, 0);
    uint32_t start[16];
    uint32_t next = 0;
    for (int w = 1; w <= maxBits; ++w) {
        start[w] = next;
        next += (uint32_t)rank[w] << (w - 1);
    }
    for (int s = 0; s < nw; ++s) {
        int w = weights[s];
        if (!w) continue;
        uint32_t len = 1u << (w - 1);
        for (uint32_t i = start[w]; i < start[w] + len; ++i) {
            h.sym[i] = (uint8_t)s;
            h.nb[i] = (uint8_t)(maxBits + 1 - w);
        }
        start[w] += len;
    }
    return used;
}

void huffman_stream(const Huffman& h, const uint8_t* src, size_t n, uint8_t* dst, size_t count) {
    BackBits bits(src, n);
    for (size_t k = 0; k < count; ++k) {
        uint32_t idx = (uint32_t)bits.peek(h.maxBits);
        dst[k] = h.sym[idx];
        bits.read(h.nb[idx]);
    }
    if (!bits.finished()) throw ZError();
}

uint64_t le64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
}

// libzstd 1.5.7's fast four-stream Huffman decoding
// (HUF_decompress4X1_usingDTable_internal_fast and its loop, then
// HUF_initRemainingDStream and HUF_decodeStreamX1 for each stream's rest),
// which it takes when the table is of 11 bits or fewer (rescaled to 11),
// each stream is of 8 bytes or more and the last segment starts before the
// output's end. It reads a stream on below its own start (into the streams
// before it, down to the jump table) and checks no stream's end, so damaged
// literals decode to what these reads give. `src`: the jump table and the
// streams. false: libzstd takes the checked path instead.
bool huffman_streams_fast(const Huffman& h, const uint8_t* src, size_t n, uint8_t* dst,
                          size_t size) {
    if (h.maxBits > 11) return false;
    size_t l1 = src[0] | (size_t)src[1] << 8, l2 = src[2] | (size_t)src[3] << 8,
           l3 = src[4] | (size_t)src[5] << 8;
    size_t l4 = n - (l1 + l2 + l3 + 6);  // wraps when the lengths overrun
    if (l1 < 8 || l2 < 8 || l3 < 8 || l4 < 8) return false;
    if (l4 > n) throw ZError();
    int64_t iend[4] = {6, (int64_t)(6 + l1), (int64_t)(6 + l1 + l2), (int64_t)(6 + l1 + l2 + l3)};
    int64_t ip[4] = {iend[1] - 8, iend[2] - 8, iend[3] - 8, (int64_t)n - 8};
    size_t seg = (size + 3) / 4;
    size_t op[4] = {0, seg, 2 * seg, 3 * seg};
    if (op[3] >= size) return false;
    int shift = 11 - h.maxBits;
    uint64_t bits[4];
    for (int k = 0; k < 4; ++k) {  // HUF_initFastDStream
        uint8_t last = src[ip[k] + 7];
        bits[k] = (le64(src + ip[k]) | 1) << (last ? 8 - highbit(last) : 0);
    }
    for (;;) {  // HUF_decompress4X1_usingDTable_internal_fast_c_loop
        size_t iters = (size - op[3]) / 5;
        if ((size_t)ip[0] / 7 < iters) iters = (size_t)ip[0] / 7;
        size_t olimit = op[3] + iters * 5;
        if (op[3] == olimit) break;
        if (ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
        do {
            for (int j = 0; j < 5; ++j)
                for (int k = 0; k < 4; ++k) {
                    uint32_t idx = (uint32_t)(bits[k] >> 53) >> shift;
                    bits[k] <<= h.nb[idx];
                    dst[op[k] + j] = h.sym[idx];
                }
            for (int k = 0; k < 4; ++k) {
                int ctz = __builtin_ctzll(bits[k]);
                op[k] += 5;
                ip[k] -= ctz >> 3;
                bits[k] = (le64(src + ip[k]) | 1) << (ctz & 7);
            }
        } while (op[3] < olimit);
    }
    for (int k = 0; k < 4; ++k) {
        size_t end = (size_t)(k + 1) * seg < size ? (size_t)(k + 1) * seg : size;
        if (op[k] > end || ip[k] < iend[k] - 8) throw ZError();
        // BIT_DStream_t from ilowest (the jump table) to the stream's position
        int64_t ptr = ip[k];
        uint64_t container = le64(src + ptr);
        unsigned consumed = (unsigned)__builtin_ctzll(bits[k]);
        auto reload = [&]() -> bool {  // BIT_reloadDStream == BIT_DStream_unfinished
            if (consumed > 64) return false;
            if (ptr >= 8) {
                ptr -= consumed >> 3;
                consumed &= 7;
                container = le64(src + ptr);
                return true;
            }
            if (ptr == 0) return false;
            int64_t nbytes = consumed >> 3;
            bool unfinished = true;
            if (ptr - nbytes < 0) {
                nbytes = ptr;
                unfinished = false;
            }
            ptr -= nbytes;
            consumed -= (unsigned)nbytes * 8;
            container = le64(src + ptr);
            return unfinished;
        };
        auto symbol = [&]() -> uint8_t {  // BIT_lookBitsFast wraps past 64 bits
            uint32_t idx = (uint32_t)((container << (consumed & 63)) >> 53) >> shift;
            consumed += h.nb[idx];
            return h.sym[idx];
        };
        size_t p = op[k];
        if (end - p > 3) {
            for (;;) {
                bool more = reload();  // always called, as `&` evaluates both sides
                if (!(more && p < end - 3)) break;
                for (int j = 0; j < 4; ++j) dst[p++] = symbol();
            }
        } else {
            reload();
        }
        while (p < end) dst[p++] = symbol();
    }
    return true;
}

// Literals_Section; returns the bytes read, the literals in `lit`
size_t read_literals(ZFrame& f, const uint8_t* src, size_t n, std::vector<uint8_t>& lit) {
    if (n < 1) throw ZError();
    int type = src[0] & 3, sf = (src[0] >> 2) & 3;
    size_t regen, comp = 0, hdr;
    if (type < 2) {
        if (sf == 0 || sf == 2) {
            regen = src[0] >> 3;
            hdr = 1;
        } else if (sf == 1) {
            if (n < 2) throw ZError();
            regen = (src[0] >> 4) + ((size_t)src[1] << 4);
            hdr = 2;
        } else {
            if (n < 3) throw ZError();
            regen = (src[0] >> 4) + ((size_t)src[1] << 4) + ((size_t)src[2] << 12);
            hdr = 3;
        }
        if (regen > f.block_max) throw ZError();
        lit.resize(regen);
        if (type == 0) {
            if (hdr + regen > n) throw ZError();
            memcpy(lit.data(), src + hdr, regen);
            return hdr + regen;
        }
        if (hdr + 1 > n) throw ZError();
        memset(lit.data(), src[hdr], regen);
        return hdr + 1;
    }
    int streams = sf == 0 ? 1 : 4;
    hdr = sf < 2 ? 3 : sf == 2 ? 4 : 5;
    if (n < hdr) throw ZError();
    uint64_t v = 0;
    for (size_t k = 0; k < hdr; ++k) v |= (uint64_t)src[k] << (8 * k);
    int bits = sf < 2 ? 10 : sf == 2 ? 14 : 18;
    regen = (size_t)((v >> 4) & ((1u << bits) - 1));
    comp = (size_t)((v >> (4 + bits)) & ((1u << bits) - 1));
    if (regen > f.block_max) throw ZError();
    if (streams == 4 && regen < 6) throw ZError();
    if (hdr + comp > n) throw ZError();
    const uint8_t* p = src + hdr;
    size_t left = comp;
    if (type == 2) {
        size_t used = read_huffman(p, left, f.huf);
        p += used;
        left -= used;
        f.lit_entropy = true;
    } else if (!f.lit_entropy) {
        throw ZError();
    }
    lit.resize(regen);
    if (streams == 1) {
        huffman_stream(f.huf, p, left, lit.data(), regen);
    } else {
        if (left < 10) throw ZError();
        if (huffman_streams_fast(f.huf, p, left, lit.data(), regen)) return hdr + comp;
        size_t s1 = p[0] | (size_t)p[1] << 8, s2 = p[2] | (size_t)p[3] << 8,
               s3 = p[4] | (size_t)p[5] << 8;
        if (6 + s1 + s2 + s3 > left) throw ZError();
        size_t s4 = left - 6 - s1 - s2 - s3;
        size_t seg = (regen + 3) / 4;
        if (3 * seg > regen) throw ZError();
        const uint8_t* q = p + 6;
        huffman_stream(f.huf, q, s1, lit.data(), seg);
        huffman_stream(f.huf, q + s1, s2, lit.data() + seg, seg);
        huffman_stream(f.huf, q + s1 + s2, s3, lit.data() + 2 * seg, seg);
        huffman_stream(f.huf, q + s1 + s2 + s3, s4, lit.data() + 3 * seg, regen - 3 * seg);
    }
    return hdr + comp;
}

size_t seq_table(int mode, const uint8_t* src, size_t n, int max_symbol, int max_log,
                 const int16_t* def, int def_count, int def_log, FseTable& t, bool& set,
                 bool entropy) {
    if (mode == 0) {
        build_fse(std::vector<int16_t>(def, def + def_count), def_log, t);
        set = true;
        return 0;
    }
    if (mode == 1) {
        if (n < 1 || src[0] > max_symbol) throw ZError();
        rle_fse(src[0], t);
        set = true;
        return 1;
    }
    if (mode == 2) {
        std::vector<int16_t> norm;
        int log;
        size_t used = read_ncount(src, n, max_log, max_symbol, norm, log);
        if (used > n) throw ZError();
        build_fse(norm, log, t);
        set = true;
        return used;
    }
    if (!entropy || !set) throw ZError();
    return 0;
}

void compressed_block(ZFrame& f, const uint8_t* src, size_t n) {
    if (n > f.block_max) throw ZError();
    std::vector<uint8_t> lit;
    size_t used = read_literals(f, src, n, lit);
    src += used;
    n -= used;
    if (n < 1) throw ZError();
    size_t nseq = src[0];
    size_t pos = 1;
    if (nseq > 0x7F) {
        if (nseq == 0xFF) {
            if (n < 3) throw ZError();
            nseq = (src[1] | (size_t)src[2] << 8) + 0x7F00;
            pos = 3;
        } else {
            if (n < 2) throw ZError();
            nseq = ((nseq - 0x80) << 8) + src[1];
            pos = 2;
        }
    }
    size_t start = f.out.size();
    if (nseq == 0) {
        if (pos != n) throw ZError();
        f.out.insert(f.out.end(), lit.begin(), lit.end());
    } else {
        if (pos + 1 > n) throw ZError();
        uint8_t modes = src[pos++];
        if (modes & 3) throw ZError();
        pos += seq_table(modes >> 6, src + pos, n - pos, 35, 9, kLLDefault, 36, 6, f.ll, f.ll_set,
                         f.fse_entropy);
        pos += seq_table((modes >> 4) & 3, src + pos, n - pos, 31, 8, kOFDefault, 29, 5, f.of,
                         f.of_set, f.fse_entropy);
        pos += seq_table((modes >> 2) & 3, src + pos, n - pos, 52, 9, kMLDefault, 53, 6, f.ml,
                         f.ml_set, f.fse_entropy);
        if (pos > n) throw ZError();
        f.fse_entropy = true;
        BackBits bits(src + pos, n - pos);
        uint32_t sll = (uint32_t)bits.read(f.ll.log), sof = (uint32_t)bits.read(f.of.log),
                 sml = (uint32_t)bits.read(f.ml.log);
        size_t litpos = 0;
        for (size_t k = 0; k < nseq; ++k) {
            uint32_t ofc = f.of.t[sof].symbol, mlc = f.ml.t[sml].symbol, llc = f.ll.t[sll].symbol;
            if (ofc > 31) throw ZError();
            uint64_t ofv = ((uint64_t)1 << ofc) + bits.read((int)ofc);
            uint64_t ml = kMLBase[mlc] + bits.read(kMLBits[mlc]);
            uint64_t ll = kLLBase[llc] + bits.read(kLLBits[llc]);
            uint64_t offset;
            if (ofv > 3) {
                offset = ofv - 3;
                f.rep[2] = f.rep[1];
                f.rep[1] = f.rep[0];
                f.rep[0] = (uint32_t)offset;
            } else {
                int idx = (int)ofv - (ll == 0 ? 0 : 1);
                if (idx == 0) {
                    offset = f.rep[0];
                } else {
                    offset = idx == 3 ? (uint64_t)f.rep[0] - 1 : f.rep[idx];
                    if (idx != 1) f.rep[2] = f.rep[1];
                    f.rep[1] = f.rep[0];
                    f.rep[0] = (uint32_t)offset;
                }
            }
            if (k + 1 < nseq) {
                sll = f.ll.t[sll].base + (uint32_t)bits.read(f.ll.t[sll].nbBits);
                sml = f.ml.t[sml].base + (uint32_t)bits.read(f.ml.t[sml].nbBits);
                sof = f.of.t[sof].base + (uint32_t)bits.read(f.of.t[sof].nbBits);
            }
            if (ll > lit.size() - litpos) throw ZError();
            f.out.insert(f.out.end(), lit.begin() + (long)litpos, lit.begin() + (long)(litpos + ll));
            litpos += ll;
            if (offset == 0 || offset > f.out.size()) throw ZError();
            if (f.out.size() - start + ml > f.block_max) throw ZError();
            size_t from = f.out.size() - (size_t)offset;
            for (uint64_t i = 0; i < ml; ++i) {
                uint8_t b = f.out[from + i];  // read before push_back may reallocate
                f.out.push_back(b);
            }
        }
        if (!bits.finished()) throw ZError();
        f.out.insert(f.out.end(), lit.begin() + (long)litpos, lit.end());
    }
    if (f.out.size() - start > f.block_max) throw ZError();
}

// The first frame of src as ZSTD_decompressStream hands it to libtiff's
// ZSTDDecode with `cap` bytes of room: the bytes decoded (at most cap; the
// caller wants cap), or -2 where libzstd reports an error (its call then
// leaves the output position at 0, whatever it flushed, and ZSTDDecode
// zeroes the strip from there).
int64_t zstd_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
    ZFrame f;
    size_t pos = 0;
    auto done = [&]() -> int64_t {
        size_t k = f.out.size() < cap ? f.out.size() : cap;
        if (k) memcpy(dst, f.out.data(), k);
        return (int64_t)k;
    };
    try {
        if (n < 4) return done();
        uint32_t magic = src[0] | src[1] << 8 | src[2] << 16 | (uint32_t)src[3] << 24;
        if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) return done();  // the stream ends after it
        if (magic != 0xFD2FB528u) throw ZError();
        pos = 4;
        if (pos >= n) return done();
        uint8_t fhd = src[pos];
        int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
            dict_flag = fhd & 3;
        if (fhd & 8) throw ZError();  // reserved bit
        size_t need = 1 + (single ? 0 : 1) + (size_t)(dict_flag == 3 ? 4 : dict_flag) +
                      (size_t)(fcs_flag == 0 ? single : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8);
        if (n - pos < need) return done();
        size_t q = pos + 1;
        uint64_t window = 0;
        if (!single) {
            uint8_t wd = src[q++];
            int wlog = 10 + (wd >> 3);
            uint64_t base = (uint64_t)1 << wlog;
            window = base + (base / 8) * (wd & 7);
        }
        uint32_t dict = 0;
        int dbytes = dict_flag == 3 ? 4 : dict_flag;
        for (int k = 0; k < dbytes; ++k) dict |= (uint32_t)src[q++] << (8 * k);
        uint64_t fcs = UINT64_MAX;
        int fbytes = fcs_flag == 0 ? single : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
        if (fbytes) {
            fcs = 0;
            for (int k = 0; k < fbytes; ++k) fcs |= (uint64_t)src[q++] << (8 * k);
            if (fbytes == 2) fcs += 256;
        }
        if (single) window = fcs;
        if (dict != 0) throw ZError();  // no dictionary is loaded
        if (window > ((uint64_t)1 << 27) + 1) throw ZError();  // ZSTD_WINDOWLOG_LIMIT_DEFAULT
        f.window = window < 1024 ? 1024 : window;
        f.block_max = f.window < (1u << 17) ? f.window : (1u << 17);
        pos = q;
        // ZSTD_decompressStream stops when its output is full, but not
        // before it has read the next block (or the checksum) when a
        // block ends exactly at the output's end
        bool full_at_boundary = false;
        for (;;) {
            if (n - pos < 3) return done();
            uint32_t bh = src[pos] | src[pos + 1] << 8 | (uint32_t)src[pos + 2] << 16;
            int last = bh & 1, type = (bh >> 1) & 3;
            size_t size = bh >> 3;
            if (type == 3 || size > f.block_max) throw ZError();
            size_t csize = type == 1 ? 1 : size;
            pos += 3;
            if (type == 0 && n - pos < size) {  // a raw block streams what it has
                f.out.insert(f.out.end(), src + pos, src + n);
                return done();
            }
            if (n - pos < csize) return done();
            if (type == 0) {
                f.out.insert(f.out.end(), src + pos, src + pos + size);
            } else if (type == 1) {
                f.out.insert(f.out.end(), size, src[pos]);
            } else {
                compressed_block(f, src + pos, size);
            }
            pos += csize;
            if (fcs != UINT64_MAX && (f.out.size() > fcs || (last && f.out.size() != fcs)))
                throw ZError();
            if (full_at_boundary || f.out.size() > cap) return done();
            if (last) break;
            full_at_boundary = f.out.size() == cap;
        }
        if (fcs != UINT64_MAX && f.out.size() != fcs) throw ZError();
        if (checksum) {
            if (n - pos < 4) return done();
            uint32_t want = src[pos] | src[pos + 1] << 8 | src[pos + 2] << 16 |
                            (uint32_t)src[pos + 3] << 24;
            if ((uint32_t)xxh64(f.out.data(), f.out.size()) != want) throw ZError();
        }
        return done();
    } catch (ZError&) {
    } catch (std::bad_alloc&) {
    }
    return -2;
}


// ---------------------------------------------------------------------------
// xz / LZMA2 (liblzma 5: stream_decoder.c, block_header_decoder.c,
// lzma2_decoder.c, lzma_decoder.c, delta_decoder.c)
// ---------------------------------------------------------------------------

enum { XZ_OK = 0, XZ_ERROR = 1 };

struct XzRange {  // rc_read_init, rc_normalize, rc_bit, rc_direct
    const uint8_t* in;
    size_t n, pos;
    uint32_t range = 0xFFFFFFFFu, code = 0;
    bool short_input = false;
    bool init() {  // false on a first byte other than 0 (LZMA_DATA_ERROR)
        range = 0xFFFFFFFFu;
        code = 0;
        for (int k = 0; k < 5; ++k) {
            if (pos >= n) {
                short_input = true;
                return true;
            }
            if (k == 0 && in[pos] != 0) return false;
            code = (code << 8) | in[pos++];
        }
        return true;
    }
    void normalize() {
        if (range < (1u << 24)) {
            if (pos >= n) {
                short_input = true;
                return;
            }
            range <<= 8;
            code = (code << 8) | in[pos++];
        }
    }
    int bit(uint16_t& p) {
        normalize();
        const uint32_t bound = (range >> 11) * p;
        if (code < bound) {
            range = bound;
            p = (uint16_t)(p + ((2048 - p) >> 5));
            return 0;
        }
        range -= bound;
        code -= bound;
        p = (uint16_t)(p - (p >> 5));
        return 1;
    }
    uint32_t tree(uint16_t* probs, int bits) {
        uint32_t m = 1;
        for (int k = 0; k < bits; ++k) m = (m << 1) | (uint32_t)bit(probs[m]);
        return m - (1u << bits);
    }
    uint32_t reverse(uint16_t* probs, int bits) {
        uint32_t m = 1, sym = 0;
        for (int k = 0; k < bits; ++k) {
            const uint32_t b = (uint32_t)bit(probs[m]);
            m = (m << 1) | b;
            sym |= b << k;
        }
        return sym;
    }
    uint32_t direct(int bits) {
        uint32_t v = 0;
        for (int k = 0; k < bits; ++k) {
            normalize();
            range >>= 1;
            uint32_t b = 0;
            if (code >= range) {
                code -= range;
                b = 1;
            }
            v = (v << 1) | b;
        }
        return v;
    }
};

struct XzLen {
    uint16_t choice, choice2, low[16][8], mid[16][8], high[256];
};

struct XzLzma {
    int lc = 0, lp = 0, pb = 0;
    uint32_t state = 0, rep[4] = {0, 0, 0, 0};
    uint16_t is_match[12][16], is_rep[12], is_rep0[12], is_rep1[12], is_rep2[12],
        is_rep0_long[12][16], slot[4][64], spec[115], align[16];
    XzLen len_dec, rep_len_dec;
    std::vector<uint16_t> literal;
    void reset() {  // lzma_decoder_reset
        state = 0;
        rep[0] = rep[1] = rep[2] = rep[3] = 0;
        literal.assign((size_t)0x300 << (lc + lp), 1024);
        for (auto* arr : {&is_match[0][0], &is_rep0_long[0][0]})
            for (int k = 0; k < 12 * 16; ++k) arr[k] = 1024;
        for (int k = 0; k < 12; ++k) is_rep[k] = is_rep0[k] = is_rep1[k] = is_rep2[k] = 1024;
        for (int k = 0; k < 4 * 64; ++k) (&slot[0][0])[k] = 1024;
        for (int k = 0; k < 115; ++k) spec[k] = 1024;
        for (int k = 0; k < 16; ++k) align[k] = 1024;
        for (XzLen* l : {&len_dec, &rep_len_dec}) {
            l->choice = l->choice2 = 1024;
            for (int k = 0; k < 16 * 8; ++k) (&l->low[0][0])[k] = (&l->mid[0][0])[k] = 1024;
            for (int k = 0; k < 256; ++k) l->high[k] = 1024;
        }
    }
    uint32_t length(XzRange& rc, XzLen& l, uint32_t pos_state) {
        if (!rc.bit(l.choice)) return 2 + rc.tree(l.low[pos_state], 3);
        if (!rc.bit(l.choice2)) return 10 + rc.tree(l.mid[pos_state], 3);
        return 18 + rc.tree(l.high, 8);
    }
};

// The LZMA2 data of one block into out[0, cap): *written the bytes out
// holds (decoded before an error, or all cap of them). XZ_OK when the
// output filled or the data ended (control byte 0), XZ_ERROR where
// liblzma reports an error before the output is full; input that runs out
// leaves XZ_OK with fewer bytes (liblzma waits for more, libtiff gives up).
int xz_lzma2(const uint8_t* in, size_t n, size_t& pos, uint8_t* out, size_t cap,
             uint64_t dict_size, size_t* written, bool* block_end, bool* at_room,
             size_t* overrun_at, bool* overrun_reset) {
    XzLzma lz;
    XzRange rc{in, n, pos};
    size_t o = 0, reset_at = 0;  // reset_at: where the dictionary was last reset
    bool need_dict_reset = true, need_props = true;
    *block_end = false;
    *at_room = false;
    *overrun_at = ~(size_t)0;
    *overrun_reset = false;
    auto done = [&](int status) {
        *written = o;
        pos = rc.pos;
        return status;
    };
    // *at_room: the error is met even by a call whose room ends where the
    // output stops. lzma_decoder.c decodes the symbol at a full room before
    // it finds no room to write it, and lzma2_decoder.c finishes a chunk
    // and reads the next control byte after the room fills (and unless
    // that byte resets the dictionary, ending the call, the chunk's header
    // and its range coder's first bytes)
    size_t reset_o = ~(size_t)0;  // where the last dictionary-reset control byte was read
    auto room_error = [&]() {
        *at_room = reset_o != o;
        return done(XZ_ERROR);
    };
    for (;;) {
        if (o >= cap) {
            // lzma2_decoder.c reads the control byte after a chunk that
            // filled the room: the end of the data ends the block
            if (rc.pos < n && in[rc.pos] == 0) {
                ++rc.pos;
                *block_end = true;
            }
            return done(XZ_OK);
        }
        if (rc.pos >= n) return done(XZ_OK);
        const uint32_t control = in[rc.pos++];
        if (control == 0) {
            *block_end = true;
            return done(XZ_OK);
        }
        if (control >= 0xE0 || control == 1) {
            reset_o = o;
            need_props = true;
            need_dict_reset = true;
        } else if (need_dict_reset) {
            return room_error();
        }
        if (control < 0x80 && control > 2) return room_error();
        // an LZMA chunk without new properties needs them set (checked on
        // the control byte, before the chunk's header is read)
        if (control >= 0x80 && control < 0xC0 && need_props) return room_error();
        if (need_dict_reset) {
            need_dict_reset = false;
            reset_at = o;
        }
        if (control < 0x80) {  // an uncompressed chunk
            if (n - rc.pos < 2) return done(XZ_OK);
            size_t size = ((size_t)in[rc.pos] << 8 | in[rc.pos + 1]) + 1;
            rc.pos += 2;
            while (size > 0 && o < cap) {
                if (rc.pos >= n) return done(XZ_OK);
                out[o++] = in[rc.pos++];
                --size;
            }
            if (size > 0) return done(XZ_OK);
            continue;
        }
        if (n - rc.pos < 4) return done(XZ_OK);
        uint64_t usize = ((uint64_t)(control & 0x1F) << 16 | (uint64_t)in[rc.pos] << 8 |
                          in[rc.pos + 1]) + 1;
        const size_t csize = ((size_t)in[rc.pos + 2] << 8 | in[rc.pos + 3]) + 1;
        rc.pos += 4;
        if (control >= 0xC0) {
            if (rc.pos >= n) return done(XZ_OK);
            uint32_t b = in[rc.pos++];  // lzma_lzma_lclppb_decode
            if (b > (4 * 5 + 4) * 9 + 8) return room_error();
            lz.pb = (int)(b / 45);
            b -= (uint32_t)lz.pb * 45;
            lz.lp = (int)(b / 9);
            lz.lc = (int)(b - (uint32_t)lz.lp * 9);
            if (lz.lc + lz.lp > 4) return room_error();
            need_props = false;
            lz.reset();
        } else if (control >= 0xA0) {
            lz.reset();
        }
        const size_t chunk_start = rc.pos;
        // lzma2_decoder.c checks the chunk's compressed size whenever the
        // LZMA decoder returns: when a call's room fills, the symbol at its
        // end decoded (*overrun_at: where the first symbol to read past the
        // size starts; *overrun_reset: a dictionary reset there, which ends
        // a call whose room ends there first), or when the input runs out
        auto overran = [&]() { return rc.pos - chunk_start > csize; };
        auto mark = [&]() {
            if (*overrun_at == ~(size_t)0 && overran()) {
                *overrun_at = o;
                *overrun_reset = reset_o == o;  // a call whose room ends here ends at the reset
            }
        };
        auto starved = [&]() { return overran() ? room_error() : done(XZ_OK); };
        if (!rc.init()) return room_error();
        if (rc.short_input) return starved();
        const uint32_t pb_mask = (1u << lz.pb) - 1, lp_mask = (1u << lz.lp) - 1;
        const uint64_t dict_cap = dict_size < 4096 ? 4096 : (dict_size + 15) & ~(uint64_t)15;
        auto full = [&]() -> uint64_t {
            const uint64_t f = o - reset_at;
            return f < dict_cap ? f : dict_cap;
        };
        while (usize > 0) {
            const size_t p = o - reset_at;
            const uint32_t pos_state = (uint32_t)p & pb_mask;
            uint32_t& st = lz.state;
            const int is_match = rc.bit(lz.is_match[st][pos_state]);
            if (rc.short_input) return starved();
            if (!is_match) {
                const uint32_t prev = p > 0 ? out[o - 1] : 0;
                uint16_t* probs = &lz.literal[0x300 * ((((uint32_t)p & lp_mask) << lz.lc) +
                                                     (prev >> (8 - lz.lc)))];
                uint32_t sym = 1;
                if (st >= 7) {
                    uint32_t match = out[o - lz.rep[0] - 1];
                    do {
                        const uint32_t mbit = (match >> 7) & 1;
                        match <<= 1;
                        const uint32_t b = (uint32_t)rc.bit(probs[((1 + mbit) << 8) + sym]);
                        sym = (sym << 1) | b;
                        if (mbit != b) break;
                    } while (sym < 0x100);
                }
                while (sym < 0x100) sym = (sym << 1) | (uint32_t)rc.bit(probs[sym]);
                if (rc.short_input) return starved();
                st = st < 4 ? 0 : st < 10 ? st - 3 : st - 6;
                mark();
                out[o++] = (uint8_t)sym;
                --usize;
                if (o >= cap && usize > 0) return done(XZ_OK);
                continue;
            }
            uint32_t len;
            if (!rc.bit(lz.is_rep[st])) {
                len = lz.length(rc, lz.len_dec, pos_state);
                const uint32_t ls = len - 2 < 3 ? len - 2 : 3;
                const uint32_t slot = rc.tree(lz.slot[ls], 6);
                uint32_t dist;
                if (slot < 4) {
                    dist = slot;
                } else {
                    const int nd = (int)(slot >> 1) - 1;
                    dist = (2 | (slot & 1)) << nd;
                    if (slot < 14) {
                        dist += rc.reverse(lz.spec + dist - slot, nd);
                    } else {
                        dist += rc.direct(nd - 4) << 4;
                        dist += rc.reverse(lz.align, 4);
                    }
                }
                if (rc.short_input) return starved();
                lz.rep[3] = lz.rep[2];
                lz.rep[2] = lz.rep[1];
                lz.rep[1] = lz.rep[0];
                lz.rep[0] = dist;
                st = st < 7 ? 7 : 10;
                if ((uint64_t)dist >= full()) return room_error();  // the end marker too
            } else {
                if (full() == 0) return room_error();
                if (!rc.bit(lz.is_rep0[st])) {
                    if (!rc.bit(lz.is_rep0_long[st][pos_state])) {  // a short rep
                        if (rc.short_input) return starved();
                        st = st < 7 ? 9 : 11;
                        mark();
                        out[o] = out[o - lz.rep[0] - 1];
                        ++o;
                        --usize;
                        if (o >= cap && usize > 0) return done(XZ_OK);
                        continue;
                    }
                } else {
                    uint32_t dist;
                    if (!rc.bit(lz.is_rep1[st])) {
                        dist = lz.rep[1];
                    } else {
                        if (!rc.bit(lz.is_rep2[st])) {
                            dist = lz.rep[2];
                        } else {
                            dist = lz.rep[3];
                            lz.rep[3] = lz.rep[2];
                        }
                        lz.rep[2] = lz.rep[1];
                    }
                    lz.rep[1] = lz.rep[0];
                    lz.rep[0] = dist;
                }
                len = lz.length(rc, lz.rep_len_dec, pos_state);
                if (rc.short_input) return starved();
                st = st < 7 ? 8 : 11;
            }
            // dict_repeat: as much of the match as the chunk and the output hold
            const uint64_t take = len < usize ? len : usize;
            mark();
            for (uint64_t k = 0; k < take; ++k) {
                out[o] = out[o - lz.rep[0] - 1];
                ++o;
                // the room full: stop, unless the chunk ends with this match
                if (o >= cap && (k + 1 < take || take < usize || take < len)) return done(XZ_OK);
            }
            usize -= take;
            if (take < len) return room_error();  // a match past the chunk's end, met at its end
        }
        rc.normalize();  // the chunk's end: the range coder finished on its last byte
        if (rc.short_input) return starved();
        if (rc.code != 0 || rc.pos - chunk_start != csize) return room_error();
    }
}


// liblzma's branch filters (simple/*.c), decoding: each turns the branch
// targets in buf[0, size) back from absolute to relative, now_pos the
// position of buf[0] in the block's data plus the filter's start offset,
// and returns how many bytes it filtered (the rest wait for more data, or
// stay as they are at the data's end).

// simple/x86.c x86_code, its state carried from call to call
struct X86State {
    uint32_t prev_mask = 0, prev_pos = (uint32_t)-5;
};

size_t bcj_x86(uint8_t* buf, size_t size, uint32_t now_pos, X86State& st) {
    static const bool allowed[8] = {true, true, true, false, true, false, false, false};
    static const uint32_t bit_number[8] = {0, 1, 2, 2, 3, 3, 3, 3};
    auto ms = [](uint8_t b) { return b == 0 || b == 0xFF; };
    if (size < 5) return 0;
    uint32_t prev_mask = st.prev_mask, prev_pos = st.prev_pos;
    if (now_pos - prev_pos > 5) prev_pos = now_pos - 5;
    const size_t limit = size - 5;
    size_t i = 0;
    while (i <= limit) {
        uint8_t b = buf[i];
        if (b != 0xE8 && b != 0xE9) {
            ++i;
            continue;
        }
        const uint32_t offset = now_pos + (uint32_t)i - prev_pos;
        prev_pos = now_pos + (uint32_t)i;
        if (offset > 5) {
            prev_mask = 0;
        } else {
            for (uint32_t k = 0; k < offset; ++k) {
                prev_mask &= 0x77;
                prev_mask <<= 1;
            }
        }
        b = buf[i + 4];
        if (ms(b) && allowed[(prev_mask >> 1) & 7] && (prev_mask >> 1) < 0x10) {
            uint32_t src = (uint32_t)b << 24 | (uint32_t)buf[i + 3] << 16 |
                           (uint32_t)buf[i + 2] << 8 | buf[i + 1];
            uint32_t dest;
            for (;;) {
                dest = src - (now_pos + (uint32_t)i + 5);
                if (prev_mask == 0) break;
                const uint32_t k = bit_number[prev_mask >> 1];
                b = (uint8_t)(dest >> (24 - k * 8));
                if (!ms(b)) break;
                src = dest ^ ((1u << (32 - k * 8)) - 1);
            }
            buf[i + 4] = (uint8_t)(~(((dest >> 24) & 1) - 1));
            buf[i + 3] = (uint8_t)(dest >> 16);
            buf[i + 2] = (uint8_t)(dest >> 8);
            buf[i + 1] = (uint8_t)dest;
            i += 5;
            prev_mask = 0;
        } else {
            ++i;
            prev_mask |= 1;
            if (ms(b)) prev_mask |= 0x10;
        }
    }
    st.prev_mask = prev_mask;
    st.prev_pos = prev_pos;
    return i;
}

// simple/powerpc.c
size_t bcj_powerpc(uint8_t* buf, size_t size, uint32_t now_pos) {
    size_t i = 0;
    for (i = 0; i + 4 <= size; i += 4) {
        if ((buf[i] >> 2) != 0x12 || (buf[i + 3] & 3) != 1) continue;
        const uint32_t src = ((uint32_t)(buf[i] & 3) << 24) | (uint32_t)buf[i + 1] << 16 |
                             (uint32_t)buf[i + 2] << 8 | (uint32_t)(buf[i + 3] & ~3u);
        const uint32_t dest = src - (now_pos + (uint32_t)i);
        buf[i] = (uint8_t)(0x48 | ((dest >> 24) & 0x03));
        buf[i + 1] = (uint8_t)(dest >> 16);
        buf[i + 2] = (uint8_t)(dest >> 8);
        buf[i + 3] = (uint8_t)((buf[i + 3] & 0x03) | (dest & 0xFF));
    }
    return i;
}

// simple/ia64.c
size_t bcj_ia64(uint8_t* buf, size_t size, uint32_t now_pos) {
    static const uint32_t branch_table[32] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                              4, 4, 6, 6, 0, 0, 7, 7, 4, 4, 0, 0, 4, 4, 0, 0};
    size_t i = 0;
    for (i = 0; i + 16 <= size; i += 16) {
        const uint32_t mask = branch_table[buf[i] & 0x1F];
        uint32_t bit_pos = 5;
        for (int slot = 0; slot < 3; ++slot, bit_pos += 41) {
            if (((mask >> slot) & 1) == 0) continue;
            const size_t byte_pos = bit_pos >> 3;
            const uint32_t bit_res = bit_pos & 7;
            uint64_t instruction = 0;
            for (int j = 0; j < 6; ++j) instruction |= (uint64_t)buf[i + j + byte_pos] << (8 * j);
            uint64_t norm = instruction >> bit_res;
            if (((norm >> 37) & 0xF) != 0x5 || ((norm >> 9) & 0x7) != 0) continue;
            uint32_t src = (uint32_t)((norm >> 13) & 0xFFFFF);
            src |= (uint32_t)((norm >> 36) & 1) << 20;
            src <<= 4;
            uint32_t dest = src - (now_pos + (uint32_t)i);
            dest >>= 4;
            norm &= ~((uint64_t)0x8FFFFF << 13);
            norm |= (uint64_t)(dest & 0xFFFFF) << 13;
            norm |= (uint64_t)(dest & 0x100000) << (36 - 20);
            instruction &= ((uint64_t)1 << bit_res) - 1;
            instruction |= norm << bit_res;
            for (int j = 0; j < 6; ++j) buf[i + j + byte_pos] = (uint8_t)(instruction >> (8 * j));
        }
    }
    return i;
}

// simple/arm.c
size_t bcj_arm(uint8_t* buf, size_t size, uint32_t now_pos) {
    size_t i = 0;
    for (i = 0; i + 4 <= size; i += 4) {
        if (buf[i + 3] != 0xEB) continue;
        uint32_t src = (uint32_t)buf[i + 2] << 16 | (uint32_t)buf[i + 1] << 8 | buf[i];
        src <<= 2;
        const uint32_t dest = (src - (now_pos + (uint32_t)i + 8)) >> 2;
        buf[i + 2] = (uint8_t)(dest >> 16);
        buf[i + 1] = (uint8_t)(dest >> 8);
        buf[i] = (uint8_t)dest;
    }
    return i;
}

// simple/armthumb.c
size_t bcj_armthumb(uint8_t* buf, size_t size, uint32_t now_pos) {
    size_t i = 0;
    for (i = 0; i + 4 <= size; i += 2) {
        if ((buf[i + 1] & 0xF8) != 0xF0 || (buf[i + 3] & 0xF8) != 0xF8) continue;
        uint32_t src = ((uint32_t)(buf[i + 1] & 7) << 19) | (uint32_t)buf[i] << 11 |
                       ((uint32_t)(buf[i + 3] & 7) << 8) | buf[i + 2];
        src <<= 1;
        const uint32_t dest = (src - (now_pos + (uint32_t)i + 4)) >> 1;
        buf[i + 1] = (uint8_t)(0xF0 | ((dest >> 19) & 0x7));
        buf[i] = (uint8_t)(dest >> 11);
        buf[i + 3] = (uint8_t)(0xF8 | ((dest >> 8) & 0x7));
        buf[i + 2] = (uint8_t)dest;
        i += 2;
    }
    return i;
}

// simple/sparc.c
size_t bcj_sparc(uint8_t* buf, size_t size, uint32_t now_pos) {
    size_t i = 0;
    for (i = 0; i + 4 <= size; i += 4) {
        if (!((buf[i] == 0x40 && (buf[i + 1] & 0xC0) == 0x00) ||
              (buf[i] == 0x7F && (buf[i + 1] & 0xC0) == 0xC0)))
            continue;
        uint32_t src = (uint32_t)buf[i] << 24 | (uint32_t)buf[i + 1] << 16 |
                       (uint32_t)buf[i + 2] << 8 | buf[i + 3];
        src <<= 2;
        uint32_t dest = (src - (now_pos + (uint32_t)i)) >> 2;
        dest = (((0u - ((dest >> 22) & 1)) << 22) & 0x3FFFFFFF) | (dest & 0x3FFFFF) | 0x40000000;
        buf[i] = (uint8_t)(dest >> 24);
        buf[i + 1] = (uint8_t)(dest >> 16);
        buf[i + 2] = (uint8_t)(dest >> 8);
        buf[i + 3] = (uint8_t)dest;
    }
    return i;
}

uint32_t rd32le(const uint8_t* p) {
    return p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24;
}

void wr32le(uint8_t* p, uint32_t v) {
    for (int k = 0; k < 4; ++k) p[k] = (uint8_t)(v >> (8 * k));
}

// simple/arm64.c
size_t bcj_arm64(uint8_t* buf, size_t size, uint32_t now_pos) {
    size_t i = 0;
    for (i = 0; i + 4 <= size; i += 4) {
        uint32_t pc = now_pos + (uint32_t)i;
        uint32_t instr = rd32le(buf + i);
        if ((instr >> 26) == 0x25) {  // BL
            const uint32_t src = instr;
            pc >>= 2;
            wr32le(buf + i, 0x94000000u | ((src - pc) & 0x03FFFFFF));
        } else if ((instr & 0x9F000000u) == 0x90000000u) {  // ADRP
            const uint32_t src = ((instr >> 29) & 3) | ((instr >> 3) & 0x001FFFFC);
            if ((src + 0x00020000) & 0x001C0000) continue;
            instr &= 0x9000001Fu;
            pc >>= 12;
            const uint32_t dest = src - pc;
            instr |= (dest & 3) << 29;
            instr |= (dest & 0x0003FFFC) << 3;
            instr |= (0u - (dest & 0x00020000)) & 0x00E00000;
            wr32le(buf + i, instr);
        }
    }
    return i;
}

// simple/riscv.c riscv_decode
size_t bcj_riscv(uint8_t* buf, size_t size, uint32_t now_pos) {
    if (size < 8) return 0;
    const size_t last = size - 8;
    size_t i = 0;
    for (i = 0; i <= last; i += 2) {
        uint32_t inst = buf[i];
        if (inst == 0xEF) {  // JAL
            const uint32_t b1 = buf[i + 1];
            if ((b1 & 0x0D) != 0) continue;
            const uint32_t b2 = buf[i + 2], b3 = buf[i + 3];
            uint32_t addr = ((b1 & 0xF0) << 13) | (b2 << 9) | (b3 << 1);
            addr -= now_pos + (uint32_t)i;
            buf[i + 1] = (uint8_t)((b1 & 0x0F) | ((addr >> 8) & 0xF0));
            buf[i + 2] = (uint8_t)(((addr >> 16) & 0x0F) | ((addr >> 7) & 0x10) |
                                   ((addr << 4) & 0xE0));
            buf[i + 3] = (uint8_t)(((addr >> 4) & 0x7F) | ((addr >> 13) & 0x80));
            i += 4 - 2;
        } else if ((inst & 0x7F) == 0x17) {  // AUIPC
            inst |= (uint32_t)buf[i + 1] << 8 | (uint32_t)buf[i + 2] << 16 |
                    (uint32_t)buf[i + 3] << 24;
            uint32_t inst2;
            if (inst & 0xE80) {  // rd neither x0 nor x2: a "fake" pair or nothing
                inst2 = rd32le(buf + i + 4);
                if (((inst << 8) ^ (inst2 - 3)) & 0xF8003) {
                    i += 6 - 2;
                    continue;
                }
                uint32_t addr = inst & 0xFFFFF000u;
                addr += inst2 >> 20;
                inst = 0x17 | (2 << 7) | (inst2 << 12);
                inst2 = addr;
            } else {  // rd x0 or x2: the real pair, its address big-endian
                const uint32_t inst2_rs1 = inst >> 27;
                if (((inst - 0x3117) << 18) >= (inst2_rs1 & 0x1D)) {
                    i += 4 - 2;
                    continue;
                }
                uint32_t addr = (uint32_t)buf[i + 4] << 24 | (uint32_t)buf[i + 5] << 16 |
                                (uint32_t)buf[i + 6] << 8 | buf[i + 7];
                addr -= now_pos + (uint32_t)i;
                inst2 = (inst >> 12) | (addr << 20);
                inst = 0x17 | (inst2_rs1 << 7) | ((addr + 0x800) & 0xFFFFF000u);
            }
            wr32le(buf + i, inst);
            wr32le(buf + i + 4, inst2);
            i += 8 - 2;
        }
    }
    return i;
}

// The branch filter of filter id `id` (0x04-0x0B) over buf[0, size): the
// bytes it filtered.
size_t bcj_decode(uint64_t id, uint8_t* buf, size_t size, uint32_t now_pos, X86State& st) {
    switch (id) {
        case 0x04: return bcj_x86(buf, size, now_pos, st);
        case 0x05: return bcj_powerpc(buf, size, now_pos);
        case 0x06: return bcj_ia64(buf, size, now_pos);
        case 0x07: return bcj_arm(buf, size, now_pos);
        case 0x08: return bcj_armthumb(buf, size, now_pos);
        case 0x09: return bcj_sparc(buf, size, now_pos);
        case 0x0A: return bcj_arm64(buf, size, now_pos);
        default: return bcj_riscv(buf, size, now_pos);
    }
}

// lzma_simple_coder_init's unfiltered_max and alignment of each filter
size_t bcj_unfiltered_max(uint64_t id) {
    return id == 0x04 ? 5 : id == 0x06 ? 16 : id == 0x0B ? 8 : 4;
}

uint32_t bcj_alignment(uint64_t id) {
    return id == 0x04 ? 1 : id == 0x06 ? 16 : (id == 0x08 || id == 0x0B) ? 2 : 4;
}

// liblzma's decoder chain of one block, call by call (lzma_code as
// LZMADecode calls it): LZMA2 decoded ahead into `data` (t bytes, then its
// end, error or want of input), the delta and branch filters in front.
enum { XC_OK, XC_END, XC_ERROR };

struct XzNode {
    virtual ~XzNode() = default;
    virtual int code(uint8_t* out, size_t& out_pos, size_t out_size) = 0;
};

// The LZMA2 decoder: a call writes what its room holds of the data; at
// the data's end it reports the block's end, or an error once asked for
// more (or, for an error met between chunks, in the call whose room ends
// there).
struct XzSource : XzNode {
    const uint8_t* data;
    size_t t, p = 0, overrun_at;
    bool end, error, at_limit, overrun_reset;
    int code(uint8_t* out, size_t& out_pos, size_t out_size) override {
        const size_t room = out_size - out_pos, n = room < t - p ? room : t - p;
        memcpy(out + out_pos, data + p, n);
        p += n;
        out_pos += n;
        // a chunk read past its size
        if (n > 0 && n == room && (p > overrun_at || (p == overrun_at && !overrun_reset)))
            return XC_ERROR;
        if (p < t) return XC_OK;
        if (end) return XC_END;
        if (error && (n < room || at_limit)) return XC_ERROR;
        return XC_OK;
    }
};

// delta_decoder.c: what its inner decoder wrote, error or not
struct XzDelta : XzNode {
    XzNode* next;
    size_t dist;
    uint8_t history[256] = {};
    uint8_t pos = 0;
    int code(uint8_t* out, size_t& out_pos, size_t out_size) override {
        const size_t start = out_pos;
        const int ret = next->code(out, out_pos, out_size);
        for (size_t k = start; k < out_pos; ++k) {
            out[k] = (uint8_t)(out[k] + history[(dist + pos) & 0xFF]);
            history[pos--] = out[k];
        }
        return ret;
    }
};

// simple_coder.c simple_code: the first step fills the room, filters it
// and keeps its unfiltered tail; the second decodes up to 2 *
// unfiltered_max bytes into the coder's buffer and filters them. An error
// returns before the filter runs.
struct XzSimple : XzNode {
    XzNode* next;
    uint64_t id;
    uint32_t now_pos;
    X86State st;
    std::vector<uint8_t> buffer;
    size_t pos = 0, filtered = 0, size = 0;
    bool end_was_reached = false;
    int copy_or_code(uint8_t* out, size_t& out_pos, size_t out_size) {
        const int ret = next->code(out, out_pos, out_size);
        if (ret == XC_END) {
            end_was_reached = true;
            return XC_OK;
        }
        return ret;
    }
    size_t call_filter(uint8_t* b, size_t n) {
        const size_t f = bcj_decode(id, b, n, now_pos, st);
        now_pos += (uint32_t)f;
        return f;
    }
    void flush(uint8_t* out, size_t& out_pos, size_t out_size) {  // lzma_bufcpy
        const size_t n = filtered - pos < out_size - out_pos ? filtered - pos : out_size - out_pos;
        memcpy(out + out_pos, buffer.data() + pos, n);
        pos += n;
        out_pos += n;
    }
    int code(uint8_t* out, size_t& out_pos, size_t out_size) override {
        if (pos < filtered) {
            flush(out, out_pos, out_size);
            if (pos < filtered) return XC_OK;
            if (end_was_reached) return XC_END;
        }
        filtered = 0;
        const size_t out_avail = out_size - out_pos, buf_avail = size - pos;
        if (out_avail > buf_avail || buf_avail == 0) {
            const size_t out_start = out_pos;
            memcpy(out + out_pos, buffer.data() + pos, buf_avail);
            out_pos += buf_avail;
            const int ret = copy_or_code(out, out_pos, out_size);
            if (ret != XC_OK) return ret;
            const size_t n = out_pos - out_start;
            const size_t unfiltered = n - (n ? call_filter(out + out_start, n) : 0);
            pos = 0;
            size = end_was_reached ? 0 : unfiltered;
            if (size) {
                out_pos -= unfiltered;
                memcpy(buffer.data(), out + out_pos, unfiltered);
            }
        } else if (pos > 0) {
            memmove(buffer.data(), buffer.data() + pos, buf_avail);
            size -= pos;
            pos = 0;
        }
        if (size > 0) {
            const int ret = copy_or_code(buffer.data(), size, buffer.size());
            if (ret != XC_OK) return ret;
            filtered = call_filter(buffer.data(), size);
            if (end_was_reached) filtered = size;
            flush(out, out_pos, out_size);
        }
        return end_was_reached && pos == size ? XC_END : XC_OK;
    }
};

// check.c's CRC64 (ECMA-182, reflected) and SHA-256 (FIPS 180-4), the
// block checks liblzma verifies besides CRC32
uint64_t crc64(const uint8_t* p, size_t n) {
    static uint64_t table[256];
    static bool ready = false;
    if (!ready) {
        for (uint32_t k = 0; k < 256; ++k) {
            uint64_t c = k;
            for (int b = 0; b < 8; ++b) c = (c & 1) ? (c >> 1) ^ 0xC96C5795D7870F42ull : c >> 1;
            table[k] = c;
        }
        ready = true;
    }
    uint64_t c = ~0ull;
    for (size_t k = 0; k < n; ++k) c = table[(c ^ p[k]) & 0xFF] ^ (c >> 8);
    return ~c;
}

void sha256(const uint8_t* p, size_t n, uint8_t digest[32]) {
    static const uint32_t kk[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4,
        0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe,
        0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc, 0x2de92c6f,
        0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
        0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
        0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
        0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116,
        0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
        0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7,
        0xc67178f2};
    uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                     0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    auto rotr = [](uint32_t x, int r) { return (x >> r) | (x << (32 - r)); };
    std::vector<uint8_t> msg(p, p + n);
    msg.push_back(0x80);
    while (msg.size() % 64 != 56) msg.push_back(0);
    const uint64_t bits = (uint64_t)n * 8;
    for (int k = 7; k >= 0; --k) msg.push_back((uint8_t)(bits >> (8 * k)));
    for (size_t blk = 0; blk < msg.size(); blk += 64) {
        uint32_t w[64];
        for (int t = 0; t < 16; ++t)
            w[t] = (uint32_t)msg[blk + 4 * t] << 24 | (uint32_t)msg[blk + 4 * t + 1] << 16 |
                   (uint32_t)msg[blk + 4 * t + 2] << 8 | msg[blk + 4 * t + 3];
        for (int t = 16; t < 64; ++t) {
            const uint32_t s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3);
            const uint32_t s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10);
            w[t] = w[t - 16] + s0 + w[t - 7] + s1;
        }
        uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
        for (int t = 0; t < 64; ++t) {
            const uint32_t t1 = hh + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) +
                                ((e & f) ^ (~e & g)) + kk[t] + w[t];
            const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) +
                                ((a & b) ^ (a & c) ^ (b & c));
            hh = g;
            g = f;
            f = e;
            e = d + t1;
            d = c;
            c = b;
            b = a;
            a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }
    for (int k = 0; k < 8; ++k)
        for (int j = 0; j < 4; ++j) digest[4 * k + j] = (uint8_t)(h[k] >> (24 - 8 * j));
}

uint64_t xz_vli(const uint8_t* p, size_t n, size_t& at, bool& ok) {
    uint64_t v = 0;
    for (int k = 0; k < 9; ++k) {
        if (at >= n) break;
        const uint8_t b = p[at++];
        if (b == 0 && k > 0) break;
        v |= (uint64_t)(b & 0x7F) << (7 * k);
        if (!(b & 0x80)) return v;
    }
    ok = false;
    return 0;
}

// An xz stream as LZMADecode gets it from liblzma with cap bytes of room:
// the bytes written (*written), XZ_OK (the output full, or the data
// ended) or XZ_ERROR (an error before the output is full). Its blocks in
// turn, each one's filter chain (up to three delta or branch filters
// before LZMA2), declared sizes and check (CRC32, CRC64, SHA-256; other
// check types skipped unread, as liblzma skips them without
// LZMA_TELL_UNSUPPORTED_CHECK). LZMA2 is decoded ahead as far as the
// branch filters may read past the room, then the chain runs call by call
// (XzSource, XzDelta, XzSimple): where an error falls relative to each
// call's room decides what is filtered and what is written.
int xz_decode(const uint8_t* in, size_t n, uint8_t* out, size_t cap, size_t* written) {
    *written = 0;
    if (cap == 0) return XZ_OK;
    if (n < 12) return XZ_OK;  // liblzma waits for the rest of the header
    static const uint8_t magic[6] = {0xFD, '7', 'z', 'X', 'Z', 0};
    if (memcmp(in, magic, 6) != 0) return XZ_ERROR;
    const uint32_t crc = rd32le(in + 8);
    if (crc32(0, in + 6, 2) != crc || in[6] != 0 || (in[7] & 0xF0)) return XZ_ERROR;
    static const int check_size[16] = {0, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64};
    const int check = in[7] & 15;
    size_t pos = 12, w = 0;
    for (;;) {
        if (pos >= n) return XZ_OK;
        if (in[pos] == 0) return XZ_OK;  // the index: no more blocks, no more data
        const size_t block_at = pos;
        const size_t hsize = ((size_t)in[pos] + 1) * 4;
        if (n - pos < hsize) return XZ_OK;
        const uint8_t* h = in + pos;
        if (crc32(0, h, (uInt)(hsize - 4)) != rd32le(h + hsize - 4)) return XZ_ERROR;
        const uint8_t flags = h[1];
        if (flags & 0x3C) return XZ_ERROR;
        size_t at = 2;
        bool ok = true;
        const uint64_t none = ~0ull;
        uint64_t csize = none, usize = none;
        if (flags & 0x40) {
            csize = xz_vli(h, hsize - 4, at, ok);
            // lzma_block_unpadded_size: not zero, the block's size a VLI
            if (ok && (csize == 0 || csize > (1ull << 63) - 1 - hsize - check_size[check]))
                return XZ_ERROR;
        }
        if (flags & 0x80) usize = xz_vli(h, hsize - 4, at, ok);
        const int nfilters = (flags & 3) + 1;
        uint64_t ids[4], props[4];
        uint32_t starts[4];
        for (int f = 0; f < nfilters && ok; ++f) {
            ids[f] = xz_vli(h, hsize - 4, at, ok);
            const uint64_t psize = xz_vli(h, hsize - 4, at, ok);
            if (!ok || psize > hsize - 4 - at) {
                ok = false;
                break;
            }
            // lzma_properties_decode; validate_chain: LZMA2 last and only
            // there, the delta and branch filters before it
            const bool last = f == nfilters - 1;
            if (ids[f] >= 0x04 && ids[f] <= 0x0B && !last) {
                if (psize != 0 && psize != 4) ok = false;
            } else if ((ids[f] == 0x03 && !last) || (ids[f] == 0x21 && last)) {
                if (psize != 1) ok = false;
            } else {
                ok = false;
            }
            props[f] = psize ? h[at] : 0;
            starts[f] = psize == 4 ? rd32le(h + at) : 0;
            at += (size_t)psize;
        }
        if (!ok) return XZ_ERROR;
        for (size_t k = at; k < hsize - 4; ++k)
            if (h[k]) return XZ_ERROR;
        size_t extra = 0;  // the branch filters' look-ahead past the room
        for (int f = 0; f < nfilters - 1; ++f) {
            if (ids[f] == 0x03) continue;
            if (starts[f] & (bcj_alignment(ids[f]) - 1)) return XZ_ERROR;
            extra += 2 * bcj_unfiltered_max(ids[f]);
        }
        const uint64_t lp = props[nfilters - 1];
        if (lp > 40) return XZ_ERROR;
        const uint64_t dict = lp == 40 ? 0xFFFFFFFFull : (uint64_t)(2 | (lp & 1)) << (lp / 2 + 11);
        pos += hsize;
        const size_t data_at = pos;
        // block_decoder.c: the input and output the block may take
        const size_t in_stop = csize != none && csize < n - pos ? pos + (size_t)csize : n;
        const size_t room = usize != none && usize < cap - w ? (size_t)usize : cap - w;
        if (room == 0) return XZ_OK;
        std::vector<uint8_t> buf(room + extra);
        size_t t = 0;
        bool block_end = false, at_room = false;
        size_t overrun_at = 0;
        bool overrun_reset = false;
        const int status = xz_lzma2(in, in_stop, pos, buf.data(), buf.size(), dict, &t,
                                    &block_end, &at_room, &overrun_at, &overrun_reset);
        XzSource src;
        src.data = buf.data();
        src.t = t;
        src.end = status == XZ_OK && block_end;
        src.error = status != XZ_OK;
        src.at_limit = at_room;
        src.overrun_at = overrun_at;
        src.overrun_reset = overrun_reset;
        std::vector<XzDelta> deltas(nfilters);
        std::vector<XzSimple> simples(nfilters);
        XzNode* chain = &src;
        for (int f = nfilters - 2; f >= 0; --f) {  // the innermost filter first
            if (ids[f] == 0x03) {
                deltas[f].next = chain;
                deltas[f].dist = (size_t)props[f] + 1;
                chain = &deltas[f];
            } else {
                simples[f].next = chain;
                simples[f].id = ids[f];
                simples[f].now_pos = starts[f];
                simples[f].buffer.resize(2 * bcj_unfiltered_max(ids[f]));
                chain = &simples[f];
            }
        }
        // LZMADecode's loop: lzma_code until the room is full, the block
        // ends, an error, or two calls in a row that move nothing
        size_t got = 0;
        int ret = XC_OK;
        for (int idle = 0; idle < 2;) {
            const size_t before = got, src_before = src.p;
            ret = chain->code(out + w, got, room);
            if (ret != XC_OK || got >= room) break;
            idle = got == before && src.p == src_before ? idle + 1 : 0;
        }
        const uint8_t* block_out = out + w;
        w += got;
        *written = w;
        if (ret == XC_ERROR) return XZ_ERROR;
        if (ret != XC_END) {
            // the room full, or the input or a declared size used up
            if (w >= cap || pos >= n) return XZ_OK;
            return XZ_ERROR;
        }
        if ((csize != none && pos - data_at != csize) || (usize != none && got != usize))
            return XZ_ERROR;
        while ((pos - block_at) & 3) {  // block padding
            if (pos >= n) return XZ_OK;
            if (in[pos++] != 0) return XZ_ERROR;
        }
        const size_t cs = (size_t)check_size[check];
        if (n - pos < cs) return XZ_OK;
        if (check == 1 && crc32(0, block_out, (uInt)got) != rd32le(in + pos)) return XZ_ERROR;
        if (check == 4) {
            const uint64_t c = crc64(block_out, got);
            for (int k = 0; k < 8; ++k)
                if (in[pos + k] != (uint8_t)(c >> (8 * k))) return XZ_ERROR;
        }
        if (check == 10) {
            uint8_t d[32];
            sha256(block_out, got, d);
            if (memcmp(d, in + pos, 32) != 0) return XZ_ERROR;
        }
        pos += cs;
        if (w >= cap) return XZ_OK;
    }
}

}  // namespace

extern "C" {

// One CCITT strip or tile of `rows` rows (compression 2, 3, 4 or 32771;
// t4_2d: T4Options bit 0 of a compression 3 file; msb_first: FillOrder 1;
// src_offset: the strip's offset in the file, for RLEW's word alignment).
// 1; 0 where libtiff keeps a T.6 strip whose data ends before its last
// row, the rows after the end unwritten; -1 where libtiff's
// TIFFReadEncodedStrip fails.
int64_t gatling_tiff_fax_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t rows,
                                int64_t rowbytes, int32_t rowpixels, int32_t compression,
                                int32_t t4_2d, int32_t msb_first, int64_t src_offset) {
    int kind = compression == 2 ? FAX_RLE : compression == 32771 ? FAX_RLEW
             : compression == 4 ? FAX_G4 : t4_2d ? FAX_2D : FAX_1D;
    if (rowbytes <= 0 || rowpixels < 0) return -1;
    return fax_decode(src, n, dst, rows, rowbytes, rowpixels, kind, msb_first != 0, src_offset);
}

// One ThunderScan strip: `rows` rows of `width` 4-bit pixels, `scanline`
// bytes apart. 1, or 0 where libtiff's ThunderDecodeRow fails.
int64_t gatling_tiff_thunder_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t rows,
                                    int64_t width, int64_t scanline) {
    const uint8_t* bp = src;
    int64_t cc = n;
    uint8_t* hi = dst + rows * scanline;
    for (int64_t r = 0; r < rows; ++r) {
        if (!thunder_row(&bp, &cc, dst + r * scanline, width, dst, hi)) return 0;
    }
    return 1;
}

// One Zstandard strip: see zstd_decode.
int64_t gatling_tiff_zstd_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    return zstd_decode(src, (size_t)n, dst, (size_t)cap);
}

// One LZMA strip (an xz stream) with `cap` bytes of room: the bytes
// written; *status 0 (the output full, or the data ended) or 1 (liblzma's
// error before the output was full).
int64_t gatling_tiff_xz_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                               int32_t* status) {
    size_t written = 0;
    *status = xz_decode(src, (size_t)n, dst, (size_t)cap, &written);
    return (int64_t)written;
}

}  // extern "C"
