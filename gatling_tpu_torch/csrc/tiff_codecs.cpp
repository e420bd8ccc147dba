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

#include <cstdint>
#include <cstring>
#include <vector>

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
// caller wants cap), or -1 where libzstd reports an error first.
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
        return -1;
    } catch (std::bad_alloc&) {
        return -1;
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

}  // extern "C"
