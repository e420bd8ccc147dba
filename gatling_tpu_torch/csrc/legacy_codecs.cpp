// The run-length loops of Pillow's legacy image plugins (imgio/sgi.py,
// pcx.py, sun.py, icns.py), as Pillow 12.1's C decoders run them:
//
// - SgiRleDecode.c: each row of each channel a list of chunks, a copy or a
//   run of 1- or 2-byte atoms; the row buffer kept from row to row, a row
//   whose list ends early keeps the last row's samples.
// - PcxDecode.c: runs (0xC0 | n, byte) and literal bytes into rows of the
//   header's stride, the planes moved together where the stride is padded.
// - SunRleDecode.c: 0x80 escapes (a literal 0x80, or a run of n + 1), rows
//   without the 16-bit padding of raw files.
// - IcnsImagePlugin.read_32: one channel of a packbits-like icon.
// - FliDecode.c: the first frame of an FLI/FLC animation, its SS2, LC,
//   BLACK, BRUN and COPY chunks (COLOR chunks are Python's, in
//   FliImagePlugin), each bounds check where FliDecode.c makes it.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// expandrow / expandrow2 over buf[at...] (last: the buffer's last index;
// indices stand for C's pointers): 0 (the row ended), 1 (the chunk list
// ended on something other than its terminator: Pillow stops decoding),
// -1 (an overrun).
int sgi_row(uint8_t* dest, const uint8_t* buf, int64_t at, int64_t last, int32_t n, int z,
            int xsize, int bpc) {
    int x = 0;
    for (; n > 0; n--) {
        uint8_t pixel;
        if (bpc == 1) {
            if (at > last) return -1;
            pixel = buf[at++];
        } else {
            if (at + 1 > last) return -1;
            pixel = buf[at + 1];
            at += 2;
        }
        if (n == 1 && pixel != 0) return 1;
        int count = pixel & 0x7F;
        if (!count) return 0;
        if (x + count > xsize) return -1;
        x += count;
        if (pixel & 0x80) {
            if (at + (int64_t)bpc * count > last) return -1;
            while (count--) {
                memcpy(dest, buf + at, (size_t)bpc);
                at += bpc;
                dest += z * bpc;
            }
        } else {
            if (at + (bpc == 1 ? 0 : 2) > last) return -1;
            const int64_t v = at;
            while (count--) {
                memcpy(dest, buf + v, (size_t)bpc);
                dest += z * bpc;
            }
            at += bpc;
        }
    }
    return 0;
}

}  // namespace

extern "C" {

// ImagingSgiRleDecode over buf (the file past its 512-byte header, bufsize
// bytes): the rows in file order (bottom first) into out [ysize][xsize *
// bands * bpc], interleaved as the decoder's row buffer. Returns the rows
// stored, or -1 (IMAGING_CODEC_OVERRUN).
int64_t gatling_sgi_rle_decode(const uint8_t* buf, int64_t bufsize, int32_t xsize,
                               int32_t ysize, int32_t bands, int32_t bpc, uint8_t* out) {
    if (xsize <= 0 || ysize <= 0 || bands <= 0 || (bpc != 1 && bpc != 2)) return -1;
    const int64_t tablen = (int64_t)bands * ysize;
    if (bufsize < 8 * tablen) return -1;
    auto be32 = [&](int64_t at) -> uint32_t {
        return (uint32_t)buf[at] << 24 | (uint32_t)buf[at + 1] << 16 | (uint32_t)buf[at + 2] << 8 |
               buf[at + 3];
    };
    const int64_t row_bytes = (int64_t)xsize * bands * bpc;
    std::vector<uint8_t> row((size_t)row_bytes, 0);
    for (int64_t r = 0; r < ysize; ++r) {
        for (int c = 0; c < bands; ++c) {
            uint32_t offset = be32(4 * (r + (int64_t)c * ysize));
            const uint32_t length = be32(4 * tablen + 4 * (r + (int64_t)c * ysize));
            if (offset < 512) return -1;
            offset -= 512;
            // the length is a count of chunks (an int), bounded by the
            // buffer's end alone
            const int s = sgi_row(row.data() + (size_t)c * bpc, buf, offset, bufsize - 1,
                                  (int32_t)length, bands, xsize, bpc);
            if (s == -1) return -1;
            if (s == 1) return r;
        }
        memcpy(out + r * row_bytes, row.data(), (size_t)row_bytes);
    }
    return ysize;
}

// ImagingPcxDecode: ysize rows of `bytes` bytes into out. 0, -1 where a run
// overran a row (Pillow's error once the image is done), -2 where the data
// ends first (Pillow's "image file is truncated").
int64_t gatling_pcx_decode(const uint8_t* src, int64_t n, int32_t xsize, int32_t bytes,
                           int32_t ysize, uint8_t* out) {
    if (xsize <= 0 || bytes <= 0) return -1;
    std::vector<uint8_t> row((size_t)bytes, 0);
    int64_t x = 0, y = 0, i = 0;
    bool overrun = false;
    while (y < ysize) {
        if (i >= n) return -2;
        if ((src[i] & 0xC0) == 0xC0) {
            if (n - i < 2) return -2;
            int k = src[i] & 0x3F;
            while (k > 0) {
                if (x >= bytes) {
                    overrun = true;
                    break;
                }
                row[(size_t)x++] = src[i + 1];
                k--;
            }
            i += 2;
        } else {
            row[(size_t)x++] = src[i++];
        }
        if (x >= bytes) {
            if (bytes % xsize && bytes > xsize) {
                const int b = bytes / xsize, stride = bytes / b;
                for (int k = 1; k < b; ++k)
                    memmove(&row[(size_t)k * xsize], &row[(size_t)k * stride], (size_t)xsize);
            }
            memcpy(out + y * (int64_t)bytes, row.data(), (size_t)bytes);
            x = 0;
            ++y;
        }
    }
    return overrun ? -1 : 0;
}

// ImagingSunRleDecode: ysize rows of `bytes` bytes into out. 0, or -2 where
// the data ends first.
int64_t gatling_sun_rle_decode(const uint8_t* src, int64_t n, int32_t bytes, int32_t ysize,
                               uint8_t* out) {
    if (bytes <= 0 || ysize <= 0) return -2;
    std::vector<uint8_t> row((size_t)bytes, 0);
    int64_t x = 0, y = 0, i = 0;
    while (true) {
        if (i >= n) return -2;
        int64_t k;
        int64_t extra = 0;
        uint8_t extra_data = 0;
        if (src[i] == 0x80) {
            if (n - i < 2) return -2;
            k = src[i + 1];
            if (k == 0) {
                k = 1;
                row[(size_t)x] = 0x80;
                i += 2;
            } else {
                if (n - i < 3) return -2;
                k += 1;
                if (x + k > bytes) {
                    extra = k;
                    k = bytes - x;
                    extra -= k;
                    extra_data = src[i + 2];
                }
                memset(row.data() + x, src[i + 2], (size_t)k);
                i += 3;
            }
        } else {
            k = 1;
            row[(size_t)x] = src[i++];
        }
        for (;;) {
            x += k;
            if (x >= bytes) {
                memcpy(out + y * (int64_t)bytes, row.data(), (size_t)bytes);
                x = 0;
                if (++y >= ysize) return 0;
            }
            if (extra == 0 || x > 0) break;
            k = extra >= bytes ? bytes : extra;
            memset(row.data() + x, extra_data, (size_t)k);
            extra -= k;
        }
    }
}

// IcnsImagePlugin.read_32's loop over one channel from src[*pos]: size
// samples into out. Returns what is left to fill (0 when the runs met
// the channel's size exactly; negative where the last run overshot);
// *pos moves past what the loop read, *written the samples it wrote.
int64_t gatling_icns_rle_channel(const uint8_t* src, int64_t n, int64_t* pos, int64_t size,
                                 uint8_t* out, int64_t* written) {
    int64_t left = size, i = *pos, o = 0;
    while (left > 0) {
        if (i >= n) break;
        const int b = src[i++];
        int64_t k;
        if (b & 0x80) {
            k = b - 125;
            if (i < n) {
                for (int64_t j = 0; j < k && o < size; ++j) out[o++] = src[i];
                i += 1;
            }
        } else {
            k = b + 1;
            const int64_t got = i + k <= n ? k : n - i;
            for (int64_t j = 0; j < got && o < size; ++j) out[o++] = src[i + j];
            i += got;
        }
        left -= k;
        if (left <= 0) break;
    }
    *pos = i;
    *written = o;
    return left;
}


// ImagingFliDecode over one frame (buf: the frame from its size word,
// bytes of it) into the zeroed image im [ysize][xsize]. 1 when the frame
// was decoded, 0 when the buffer holds less than the frame (Pillow reads
// on: "image file is truncated" at the end of the file), -1 on an error.
int64_t gatling_fli_decode(const uint8_t* buf, int64_t bytes, int32_t xsize, int32_t ysize,
                           uint8_t* im) {
    auto i16 = [](const uint8_t* p) { return (int)p[0] + ((int)p[1] << 8); };
    auto i32 = [](const uint8_t* p) {
        return (int32_t)((uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
                         (uint32_t)p[3] << 24);
    };
    if (xsize <= 0 || ysize <= 0) return -1;
    if (bytes < 4) return 0;
    const uint8_t* ptr = buf;
    const int32_t framesize = i32(ptr);
    if (bytes + (bytes % 2) < framesize) return 0;
    if (bytes < 8) return -1;
    if (i16(ptr + 4) != 0xF1FA) return -1;
    const int chunks = i16(ptr + 6);
    ptr += 16;
    bytes -= 16;
    auto row = [&](int y) { return im + (int64_t)y * xsize; };
    for (int c = 0; c < chunks; c++) {
        if (bytes < 10) return -1;
        const uint8_t* data = ptr + 6;
#define OOB(off) if ((data + (off)) > ptr + bytes) return -1
        int x = 0, y, i, l, lines, ymax;
        switch (i16(ptr + 4)) {
            case 4:
            case 11:
                break;
            case 7: {
                lines = i16(data);
                data += 2;
                for (l = y = 0; l < lines && y < ysize; l++, y++) {
                    uint8_t* local = row(y);
                    int p, packets;
                    OOB(2);
                    packets = i16(data);
                    data += 2;
                    while (packets & 0x8000) {
                        if (packets & 0x4000) {
                            y += 65536 - packets;
                            if (y >= ysize) return -1;
                            local = row(y);
                        } else {
                            local[xsize - 1] = (uint8_t)packets;
                        }
                        OOB(2);
                        packets = i16(data);
                        data += 2;
                    }
                    for (p = x = 0; p < packets; p++) {
                        OOB(2);
                        x += data[0];
                        if (data[1] >= 128) {
                            OOB(4);
                            i = 256 - data[1];
                            if (x + i + i > xsize) break;
                            for (int j = 0; j < i; j++) {
                                local[x++] = data[2];
                                local[x++] = data[3];
                            }
                            data += 4;
                        } else {
                            i = 2 * (int)data[1];
                            if (x + i > xsize) break;
                            OOB(2 + i);
                            memcpy(local + x, data + 2, (size_t)i);
                            data += 2 + i;
                            x += i;
                        }
                    }
                    if (p < packets) break;
                }
                if (l < lines) return -1;
                break;
            }
            case 12: {
                y = i16(data);
                ymax = y + i16(data + 2);
                data += 4;
                for (; y < ymax && y < ysize; y++) {
                    uint8_t* out = row(y);
                    OOB(1);
                    int p, packets = *data++;
                    for (p = x = 0; p < packets; p++, x += i) {
                        OOB(2);
                        x += data[0];
                        if (data[1] & 0x80) {
                            i = 256 - data[1];
                            if (x + i > xsize) break;
                            OOB(3);
                            memset(out + x, data[2], (size_t)i);
                            data += 3;
                        } else {
                            i = data[1];
                            if (x + i > xsize) break;
                            OOB(2 + i);
                            memcpy(out + x, data + 2, (size_t)i);
                            data += i + 2;
                        }
                    }
                    if (p < packets) break;
                }
                if (y < ymax) return -1;
                break;
            }
            case 13:
                memset(im, 0, (size_t)xsize * ysize);
                break;
            case 15: {
                for (y = 0; y < ysize; y++) {
                    uint8_t* out = row(y);
                    data += 1;
                    for (x = 0; x < xsize; x += i) {
                        OOB(2);
                        if (data[0] & 0x80) {
                            i = 256 - data[0];
                            if (x + i > xsize) break;
                            OOB(i + 1);
                            memcpy(out + x, data + 1, (size_t)i);
                            data += i + 1;
                        } else {
                            i = data[0];
                            if (x + i > xsize) break;
                            memset(out + x, data[1], (size_t)i);
                            data += 2;
                        }
                    }
                    if (x != xsize) return -1;
                }
                break;
            }
            case 16: {
                if (INT32_MAX / xsize < ysize) return -1;
                // too little data: FliDecode.c hands back what it used and waits for
                // more, which a frame read whole never gets (refused here)
                if (data + (int64_t)xsize * ysize > ptr + bytes) return -1;
                for (y = 0; y < ysize; y++) {
                    memcpy(row(y), data, (size_t)xsize);
                    data += xsize;
                }
                break;
            }
            case 18:
                break;
            default:
                return -1;
        }
#undef OOB
        const int32_t advance = i32(ptr);
        if (advance == 0) return -1;
        if (advance < 0 || advance > bytes) return -1;
        ptr += advance;
        bytes -= advance;
    }
    return 1;
}

}  // extern "C"
