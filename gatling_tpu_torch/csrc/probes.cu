// Developer probes for NVIDIA Hopper (sm_90a): the H100 counterparts of the
// JAX package's two Mosaic probes.
//
// P1 `cast_probe_kernel` <- tools/mosaic_cast_probe.py `probe` (its
//    pl.pallas_call of one VMEM block): six layout moves of an (8, 128)
//    f32 tile. The TPU question was which reshapes, stacks, concatenations
//    and transposes Mosaic legalizes inside a kernel. Here one block stages
//    the tile in shared memory, row-major, and writes each output element
//    from the shared word its index map names: every move is legal, and
//    what differs between them is the index map's shared-memory bank
//    pattern, which the host counts statically (tools/cast_probe.py). What
//    bounds it: the 4 KB read and the 4 or 32 KB written, and the launch.
// P2 `onehot_tf32_kernel` / `onehot_fp32_kernel` <-
//    tools/mosaic_precision_probe.py `kern`: the one-hot 128x128 product
//    oh @ x, which must reproduce x, at the TPU's DEFAULT and HIGHEST
//    precisions. Here DEFAULT is the tensor cores' TF32 mma.sync
//    (m16n8k8, operands rounded by cvt.rna.tf32.f32: to nearest, ties away
//    from zero), HIGHEST is FP32 FMA outside the tensor cores, and SPLIT3
//    is the 3xTF32 product a_hi b_hi + a_hi b_lo + a_lo b_hi (hi = tf32(a),
//    lo = tf32(a - hi)), the HIGHEST analogue that stays on the tensor
//    cores. What bounds it: 2 * 128^3 operations (4.2 MFLOP, at 495 TFLOP/s
//    TF32 or 67 TFLOP/s FP32 a few nanoseconds), so the launch.
//
// One warp computes one 16x8 tile of the product; A and B are read from
// global memory fragment by fragment (the matrices are 64 KB each).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_ROWS = 8, TILE_COLS = 128, TILE_N = TILE_ROWS * TILE_COLS;
constexpr int N = 128;  // the product's side

// P1: the shared-memory word that output element k of move `move` reads;
// moves: 0 reshape (1024,), 1 reshape (1024, 1), 2 stack of 8 (1024, 8),
// 3 concatenation of 8 columns (1024, 8), 4 transpose (128, 8), 5
// concatenation of the 8 rows' transposes (128, 8).
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

__global__ void cast_probe_kernel(const float* __restrict__ x, float* __restrict__ out, int move,
                                  int n_out) {
  __shared__ float s[TILE_N];
  for (int k = threadIdx.x; k < TILE_N; k += blockDim.x) s[k] = x[k];
  __syncthreads();
  for (int k = threadIdx.x; k < n_out; k += blockDim.x) out[k] = s[cast_src(move, k)];
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

// P2 on the tensor cores: out = A @ B (N x N, row-major), one warp a 16x8
// tile; split3: the 3xTF32 product, else one TF32 product.
__global__ void onehot_tf32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                   float* __restrict__ out, int split3) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const int tiles_n = N / 8;
  if (warp >= (N / 16) * tiles_n) return;
  const int m0 = (warp / tiles_n) * 16, n0 = (warp % tiles_n) * 8;
  const int g = lane >> 2, t = lane & 3;  // groupID, threadID_in_group
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < N; k0 += 8) {
    // A fragment: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
    // B fragment: (t, g), (t + 4, g)
    const float af[4] = {a[(m0 + g) * N + k0 + t], a[(m0 + g + 8) * N + k0 + t],
                         a[(m0 + g) * N + k0 + t + 4], a[(m0 + g + 8) * N + k0 + t + 4]};
    const float bf[2] = {b[(k0 + t) * N + n0 + g], b[(k0 + t + 4) * N + n0 + g]};
    uint32_t ahi[4], bhi[2];
    for (int i = 0; i < 4; ++i) ahi[i] = to_tf32(af[i]);
    for (int i = 0; i < 2; ++i) bhi[i] = to_tf32(bf[i]);
    if (split3) {
      uint32_t alo[4], blo[2];
      for (int i = 0; i < 4; ++i) alo[i] = to_tf32(af[i] - __uint_as_float(ahi[i]));
      for (int i = 0; i < 2; ++i) blo[i] = to_tf32(bf[i] - __uint_as_float(bhi[i]));
      mma_tf32(d, alo, bhi);  // the small terms first
      mma_tf32(d, ahi, blo);
    }
    mma_tf32(d, ahi, bhi);
  }
  // D fragment: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
  out[(m0 + g) * N + n0 + 2 * t] = d[0];
  out[(m0 + g) * N + n0 + 2 * t + 1] = d[1];
  out[(m0 + g + 8) * N + n0 + 2 * t] = d[2];
  out[(m0 + g + 8) * N + n0 + 2 * t + 1] = d[3];
}

// P2 in FP32 outside the tensor cores: one thread an output element, the
// sum over k in ascending order with fused multiply-adds.
__global__ void onehot_fp32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                   float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N * N) return;
  const int i = idx / N, j = idx % N;
  float acc = 0.0f;
  for (int k = 0; k < N; ++k) acc = fmaf(a[i * N + k], b[k * N + j], acc);
  out[idx] = acc;
}

}  // namespace

extern "C" {

const char* gatling_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// P1: move `move` of the (8, 128) tile x into out (n_out floats).
int gatling_cast_probe(const float* x, float* out, int move, int n_out, void* stream) {
  cast_probe_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, out, move, n_out);
  return (int)cudaGetLastError();
}

// P2: out = a @ b (128 x 128) in mode 0 TF32, 1 FP32, 2 3xTF32.
int gatling_onehot_product(const float* a, const float* b, float* out, int mode,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1) {
    onehot_fp32_kernel<<<N * N / 256, 256, 0, s>>>(a, b, out);
  } else {
    const int warps = (N / 16) * (N / 8);
    onehot_tf32_kernel<<<warps / 4, 128, 0, s>>>(a, b, out, mode == 2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
