// Developer probes for NVIDIA Hopper (sm_90a): the H100 counterparts of the
// JAX package's two Mosaic probes.
//
// P1 `cast_probe_kernel` <- tools/mosaic_cast_probe.py `probe` (its
//    pl.pallas_call of one VMEM block): six layout moves of an (8, 128)
//    f32 tile. The TPU question was which reshapes, stacks, concatenations
//    and transposes Mosaic legalizes inside a kernel. Here one launch runs
//    all six, a block a move: each block stages the tile in shared memory
//    once, its rows CAST_STRIDE = 132 words apart, and writes each output
//    element from the shared word its index map names. Every move is legal;
//    what differs between them is the index map's shared-memory bank
//    pattern, which the host counts statically (tools/cast_probe.py): with
//    the rows 4 banks apart a transpose's warp (8 rows of 4 columns) reads
//    32 distinct banks, and the flat moves a run of 32 consecutive words, so
//    no move's reads conflict. What bounds it: the launch; its 4 KB read
//    (once a block) and 80 KB written take 25 ns at 3.35 TB/s.
// P2 `onehot_tf32_kernel` / `onehot_fp32_kernel` <-
//    tools/mosaic_precision_probe.py `kern`: the one-hot 128x128 product
//    oh @ x, which must reproduce x, at the TPU's DEFAULT and HIGHEST
//    precisions. Here DEFAULT is the tensor cores' TF32 mma.sync
//    (m16n8k8, operands rounded by cvt.rna.tf32.f32: to nearest, ties away
//    from zero), HIGHEST is FP32 FMA outside the tensor cores, and SPLIT3
//    is the 3xTF32 product a_hi b_hi + a_hi b_lo + a_lo b_hi (hi = tf32(a),
//    lo = tf32(a - hi)), the HIGHEST analogue that stays on the tensor
//    cores. What bounds it: not its 2 * 128^3 operations (4.2 MFLOP, at
//    495 TFLOP/s TF32 or 67 TFLOP/s FP32 a few nanoseconds) nor its 192 KB
//    (57 ns at 3.35 TB/s), but latency: the launch, one round trip to
//    memory for the operands, and a chain of 16 dependent mma.sync (48 for
//    3xTF32) or 128 dependent FMAs, then the store.
//
// P2's design. 16 blocks of 128 threads, each a 32x32 tile of the product:
// the block stages its A strip (32 rows, all k) and B strip (all k, 32
// columns) in shared memory once, every thread issuing its eight 16-byte
// reads of each operand (coalesced, float4) before it stores any. The
// tensor-core kernel converts each element to TF32 while staging (and its
// remainder, lo = tf32(x - hi), for 3xTF32), so no warp converts again;
// the conversion needs the value in a register, which is why the copies
// are plain 16-byte loads and not cp.async or TMA. Rows are padded so the
// m16n8k8 fragment reads hit 32 distinct banks: A (row-major, a = A[g][t])
// at a stride of 132 words (4g + t), B (k-major, b = B[t][g]) at 40 (8t +
// g). Each warp computes a 16x16 tile, two 16x8 mma tiles sharing one A
// fragment from registers, over ascending k, 3xTF32 in the order lo*hi,
// hi*lo, hi*hi at each k step. 3xTF32's hi and lo copies of both strips
// take 74,752 bytes, dynamic shared memory above the 48 KB static limit
// (cudaFuncSetAttribute, once). The FP32 kernel stages the same strips
// unconverted (37,376 bytes, static) and gives each thread a 2x4
// micro-tile, summed over ascending k with fmaf. wgmma would need 64-row
// warpgroup tiles in a swizzled layout, so four blocks at most for this
// product; its gain is tensor-core throughput, which at 128^3 is not what
// bounds the kernel, so mma.sync from padded shared memory serves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_ROWS = 8, TILE_COLS = 128, TILE_N = TILE_ROWS * TILE_COLS;
constexpr int CAST_MOVES = 6;
constexpr int CAST_STRIDE = TILE_COLS + 4;  // staged rows 4 banks apart
constexpr int CAST_THREADS = 256;
constexpr int N = 128;  // the product's side

// P1: the tile element (row-major) that output element k of move `move`
// reads; moves: 0 reshape (1024,), 1 reshape (1024, 1), 2 stack of 8
// (1024, 8), 3 concatenation of 8 columns (1024, 8), 4 transpose (128, 8),
// 5 concatenation of the 8 rows' transposes (128, 8).
__device__ __forceinline__ int cast_src(int move, int k) {
  switch (move) {
    case 2:
    case 3:
      return k / 8;
    case 4:
    case 5:
      return (k % TILE_ROWS) * TILE_COLS + k / TILE_ROWS;
    default:
      return k;
  }
}

// The six moves' outputs, and each one's length.
struct CastOut {
  float* out[CAST_MOVES];
  int n[CAST_MOVES];
};

// Block b runs move b over its staged copy of the tile, element e at
// shared word (e / 128) * CAST_STRIDE + e % 128.
__global__ void __launch_bounds__(CAST_THREADS)
cast_probe_kernel(const float* __restrict__ x, CastOut o) {
  __shared__ float s[TILE_ROWS * CAST_STRIDE];
  for (int e = threadIdx.x; e < TILE_N; e += CAST_THREADS)
    s[(e / TILE_COLS) * CAST_STRIDE + e % TILE_COLS] = __ldg(x + e);
  __syncthreads();
  // the block's output by selects: an index into the parameter struct
  // would copy it to the stack
  const int move = blockIdx.x;
  float* __restrict__ out = o.out[0];
  int n_out = o.n[0];
#pragma unroll
  for (int m = 1; m < CAST_MOVES; ++m) {
    if (move == m) {
      out = o.out[m];
      n_out = o.n[m];
    }
  }
  for (int k = threadIdx.x; k < n_out; k += CAST_THREADS) {
    const int e = cast_src(move, k);
    out[k] = s[(e / TILE_COLS) * CAST_STRIDE + e % TILE_COLS];
  }
}

// f32 -> TF32 (round to nearest, ties away from zero), as an f32 bit
// pattern whose 13 low mantissa bits are 0.
__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r & 0xFFFFE000u;
}

// D += A B on one 16x8x8 tile, TF32 operands (PTX mma.sync m16n8k8 layouts).
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// P2: 32x32 output tiles of a 4x4 grid of blocks, 128 threads each
constexpr int P2_TILE = 32, P2_THREADS = 128;
constexpr int A_STRIDE = N + 4;        // 132 words: A fragment rows 4 banks apart
constexpr int B_STRIDE = P2_TILE + 8;  // 40 words: B fragment rows 8 banks apart
constexpr int A_WORDS = P2_TILE * A_STRIDE, B_WORDS = N * B_STRIDE;
constexpr int P2_LOADS = P2_TILE * N / 4 / P2_THREADS;  // float4 a thread, each strip: 8

// The block's strips in registers: load j of this thread is A row
// (idx / 32, float4 idx % 32) and B row (idx / 8, float4 idx % 8) of the
// strips, idx = threadIdx.x + 128 j; a_word / b_word are their shared offsets.
__device__ __forceinline__ void load_strips(const float* __restrict__ a,
                                            const float* __restrict__ b, float4 ra[P2_LOADS],
                                            float4 rb[P2_LOADS]) {
  const int m0 = blockIdx.y * P2_TILE, n0 = blockIdx.x * P2_TILE;
  #pragma unroll
  for (int j = 0; j < P2_LOADS; ++j) {
    const int idx = threadIdx.x + P2_THREADS * j;
    ra[j] = __ldg(reinterpret_cast<const float4*>(a + (m0 + idx / 32) * N) + idx % 32);
    rb[j] = __ldg(reinterpret_cast<const float4*>(b + (idx / 8) * N + n0) + idx % 8);
  }
}

__device__ __forceinline__ int a_word(int j) {
  const int idx = threadIdx.x + P2_THREADS * j;
  return (idx / 32) * A_STRIDE + 4 * (idx % 32);
}

__device__ __forceinline__ int b_word(int j) {
  const int idx = threadIdx.x + P2_THREADS * j;
  return (idx / 8) * B_STRIDE + 4 * (idx % 8);
}

__device__ __forceinline__ uint4 tf32x4(float4 x) {
  return make_uint4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z), to_tf32(x.w));
}

__device__ __forceinline__ uint4 tf32_lo(float4 x, uint4 hi) {
  return make_uint4(to_tf32(x.x - __uint_as_float(hi.x)), to_tf32(x.y - __uint_as_float(hi.y)),
                    to_tf32(x.z - __uint_as_float(hi.z)), to_tf32(x.w - __uint_as_float(hi.w)));
}

// P2 on the tensor cores: out = A @ B (N x N, row-major); SPLIT3: the
// 3xTF32 product, else one TF32 product. Shared: A hi, B hi (and A lo,
// B lo) as TF32 bit patterns.
template <bool SPLIT3>
__global__ void __launch_bounds__(P2_THREADS)
    onehot_tf32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ out) {
  extern __shared__ uint4 p2_smem[];
  uint32_t* s_ahi = reinterpret_cast<uint32_t*>(p2_smem);
  uint32_t* s_bhi = s_ahi + A_WORDS;
  uint32_t* s_alo = s_bhi + B_WORDS;
  uint32_t* s_blo = s_alo + A_WORDS;
  {
    float4 ra[P2_LOADS], rb[P2_LOADS];
    load_strips(a, b, ra, rb);
    #pragma unroll
    for (int j = 0; j < P2_LOADS; ++j) {
      const uint4 ah = tf32x4(ra[j]), bh = tf32x4(rb[j]);
      *reinterpret_cast<uint4*>(s_ahi + a_word(j)) = ah;
      *reinterpret_cast<uint4*>(s_bhi + b_word(j)) = bh;
      if (SPLIT3) {
        *reinterpret_cast<uint4*>(s_alo + a_word(j)) = tf32_lo(ra[j], ah);
        *reinterpret_cast<uint4*>(s_blo + b_word(j)) = tf32_lo(rb[j], bh);
      }
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // groupID, threadID_in_group
  const int wm = (warp / 2) * 16, wn = (warp % 2) * 16;  // the warp's 16x16 in the tile
  float d[2][4] = {};
  for (int k0 = 0; k0 < N; k0 += 8) {
    // A fragment: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
    // B fragment: (t, g), (t + 4, g)
    const int a0 = (wm + g) * A_STRIDE + k0 + t;
    const int ai[4] = {a0, a0 + 8 * A_STRIDE, a0 + 4, a0 + 8 * A_STRIDE + 4};
    uint32_t ahi[4], alo[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      ahi[i] = s_ahi[ai[i]];
      if (SPLIT3) alo[i] = s_alo[ai[i]];
    }
    #pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int b0 = (k0 + t) * B_STRIDE + wn + 8 * nt + g;
      const uint32_t bhi[2] = {s_bhi[b0], s_bhi[b0 + 4 * B_STRIDE]};
      if (SPLIT3) {
        const uint32_t blo[2] = {s_blo[b0], s_blo[b0 + 4 * B_STRIDE]};
        mma_tf32(d[nt], alo, bhi);  // the small terms first
        mma_tf32(d[nt], ahi, blo);
      }
      mma_tf32(d[nt], ahi, bhi);
    }
  }
  // D fragment: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
  const int m0 = blockIdx.y * P2_TILE + wm, n0 = blockIdx.x * P2_TILE + wn;
  #pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    float* o = out + (m0 + g) * N + n0 + 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(o) = make_float2(d[nt][0], d[nt][1]);
    *reinterpret_cast<float2*>(o + 8 * N) = make_float2(d[nt][2], d[nt][3]);
  }
}

// P2 in FP32 outside the tensor cores: the same staged strips, each thread
// a 2x4 micro-tile (rows 2 ty, 2 ty + 1, columns 4 tx..4 tx + 3), the sum
// over k in ascending order with fused multiply-adds.
__global__ void __launch_bounds__(P2_THREADS)
    onehot_fp32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ out) {
  __shared__ __align__(16) float s_a[A_WORDS];
  __shared__ __align__(16) float s_b[B_WORDS];
  {
    float4 ra[P2_LOADS], rb[P2_LOADS];
    load_strips(a, b, ra, rb);
    #pragma unroll
    for (int j = 0; j < P2_LOADS; ++j) {
      *reinterpret_cast<float4*>(s_a + a_word(j)) = ra[j];
      *reinterpret_cast<float4*>(s_b + b_word(j)) = rb[j];
    }
  }
  __syncthreads();
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  float acc[2][4] = {};
  for (int k = 0; k < N; ++k) {
    const float a0 = s_a[(2 * ty) * A_STRIDE + k], a1 = s_a[(2 * ty + 1) * A_STRIDE + k];
    const float4 bk = *reinterpret_cast<const float4*>(s_b + k * B_STRIDE + 4 * tx);
    const float bj[4] = {bk.x, bk.y, bk.z, bk.w};
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[0][j] = fmaf(a0, bj[j], acc[0][j]);
      acc[1][j] = fmaf(a1, bj[j], acc[1][j]);
    }
  }
  const int m0 = blockIdx.y * P2_TILE + 2 * ty, n0 = blockIdx.x * P2_TILE + 4 * tx;
  #pragma unroll
  for (int i = 0; i < 2; ++i)
    *reinterpret_cast<float4*>(out + (m0 + i) * N + n0) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

}  // namespace

extern "C" {

const char* gatling_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// P1: the six moves of the (8, 128) tile x in one launch, move m into
// out_m (n_m floats).
int gatling_cast_probe(const float* x, float* out0, float* out1, float* out2, float* out3,
                       float* out4, float* out5, int n0, int n1, int n2, int n3, int n4, int n5,
                       void* stream) {
  const CastOut o = {{out0, out1, out2, out3, out4, out5}, {n0, n1, n2, n3, n4, n5}};
  cast_probe_kernel<<<CAST_MOVES, CAST_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, o);
  return (int)cudaGetLastError();
}

// P2: out = a @ b (128 x 128, 16-byte aligned) in mode 0 TF32, 1 FP32, 2
// 3xTF32.
int gatling_onehot_product(const float* a, const float* b, float* out, int mode,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / P2_TILE, N / P2_TILE);
  constexpr int hi_bytes = (A_WORDS + B_WORDS) * 4;  // 37,376
  if (mode == 1) {
    onehot_fp32_kernel<<<grid, P2_THREADS, 0, s>>>(a, b, out);
  } else if (mode == 0) {
    onehot_tf32_kernel<false><<<grid, P2_THREADS, hi_bytes, s>>>(a, b, out);
  } else {
    static int opted_in = 0;  // above 48 KB a kernel must opt in, once a process
    if (!opted_in) {
      const cudaError_t e = cudaFuncSetAttribute(
          onehot_tf32_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * hi_bytes);
      if (e != cudaSuccess) return (int)e;
      opted_in = 1;
    }
    onehot_tf32_kernel<true><<<grid, P2_THREADS, 2 * hi_bytes, s>>>(a, b, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
