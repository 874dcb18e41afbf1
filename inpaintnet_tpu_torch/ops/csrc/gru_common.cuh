// Shared device pieces of the hand-written GRU kernels: the block-level
// "gates at once" products of the first port's kernels (arnn_decode.cu's
// first kernel is the last of them), and the [r, z, n] gate math, the int8
// (de)quantization and the dtype traits, which the Hopper kernels use too.
//
// Thread layout every kernel here uses: 256 threads = 8 warps. A block owns
// MT m-tiles of 16 batch rows (TILE_M = 16 * MT rows) and walks the hidden
// units in chunks of 64 (8 warps x one 8-wide n-tile each). For one chunk a
// warp accumulates the r, z and n gate columns of the SAME 8 hidden units,
// so the gate math runs in registers and no (rows, 3H) f32 slab exists.
//
// Accumulator element (m, i) of a warp's n-tile sits at the mma.sync C
// fragment position: row 16*m + g + 8*(i >> 1), column 2*q + (i & 1),
// where g = lane / 4 and q = lane % 4. The f32 route computes the same
// elements with scalar FMAs, so the gate epilogue is shared.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace inpaint {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8 * kWarps;  // hidden units per chunk

template <typename T> struct Traits;

template <> struct Traits<float> {
  static constexpr int MT = 1;     // 16 rows: f32 tiles are twice the bytes
  static constexpr int kPad = 4;   // smem row padding, elements
  __device__ static float to_f(float v) { return v; }
  __device__ static float from_f(float v) { return v; }
};

template <> struct Traits<__nv_bfloat16> {
  static constexpr int MT = 2;     // 32 rows
  static constexpr int kPad = 8;   // 16 bytes: rows land on distinct banks
  __device__ static float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// h' = (1 - z) * n + z * h with r = sigmoid(xr + hr), z = sigmoid(xz + hz),
// n = tanh(xn + r * hn): torch's GRU, every input already in f32 and every
// bias already added (kernel_common.gru_gates_f32). Every multiply and add
// is rounded on its own (__fmul_rn / __fadd_rn are never contracted into an
// FMA), in the order of the plain versions' separate tensor ops, so a
// kernel and its plain version differ only by their sums' order and the
// exp/tanh ulps.
__device__ __forceinline__ float gru_gate(float xr, float hr, float xz, float hz,
                                          float xn, float hn, float h) {
  const float r = sigmoid_f(__fadd_rn(xr, hr));
  const float z = sigmoid_f(__fadd_rn(xz, hz));
  const float n = tanhf(__fadd_rn(xn, __fmul_rn(r, hn)));
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), n), __fmul_rn(z, h));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename A, int NG, int MT>
__device__ __forceinline__ void zero_acc(A (&acc)[NG][MT][4]) {
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][m][i] = A(0);
}

// acc[G] += A (TILE_M x K, smem, row stride lda) @ W[:, 8-column tile nt[G]]
// for NG column tiles at once (the r, z, n tiles of one chunk, or one tile
// of the decode head). K is a multiple of 16.
//
// bf16: W is "fragment-packed" by the host (kernel_common.pack_mma_b): for
// n-tile nt and k-tile kt the 32 lanes' B fragments are 256 contiguous
// bytes, so each lane loads its fragment with one 8-byte load and a warp
// reads one fully used 256-byte segment.
// f32: W is the plain (K, N) row-major matrix and the products are scalar
// FMAs (exact f32, no TF32).
template <typename T, int MT, int NG> struct Gemm;

template <int MT, int NG> struct Gemm<__nv_bfloat16, MT, NG> {
  __device__ __forceinline__ static void run(float (&acc)[NG][MT][4],
                                             const __nv_bfloat16* A, int lda, int K,
                                             const void* W, int N, const int (&nt)[NG]) {
    (void)N;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int KT = K / 16;
    const uint2* P = reinterpret_cast<const uint2*>(W);
    const uint2* p[NG];
#pragma unroll
    for (int G = 0; G < NG; ++G) p[G] = P + (size_t)nt[G] * KT * 32 + lane;
    for (int kt = 0; kt < KT; ++kt) {
      uint2 b[NG];
#pragma unroll
      for (int G = 0; G < NG; ++G) b[G] = __ldg(p[G] + kt * 32);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const __nv_bfloat16* base = A + (16 * m + g) * lda + kt * 16 + 2 * q;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(base);
        a[1] = *reinterpret_cast<const uint32_t*>(base + 8 * lda);
        a[2] = *reinterpret_cast<const uint32_t*>(base + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(base + 8 * lda + 8);
#pragma unroll
        for (int G = 0; G < NG; ++G) mma_bf16(acc[G][m], a, b[G].x, b[G].y);
      }
    }
  }
};

template <int NG> struct Gemm<float, 1, NG> {
  __device__ __forceinline__ static void run(float (&acc)[NG][1][4], const float* A,
                                             int lda, int K, const void* W, int N,
                                             const int (&nt)[NG]) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const float* Wf = reinterpret_cast<const float*>(W);
    const float* a0p = A + g * lda;
    const float* a1p = A + (g + 8) * lda;
    for (int k = 0; k < K; ++k) {
      const float a0 = a0p[k], a1 = a1p[k];
#pragma unroll
      for (int G = 0; G < NG; ++G) {
        const float2 w = __ldg(reinterpret_cast<const float2*>(
            Wf + (size_t)k * N + nt[G] * 8 + 2 * q));
        acc[G][0][0] = fmaf(a0, w.x, acc[G][0][0]);
        acc[G][0][1] = fmaf(a0, w.y, acc[G][0][1]);
        acc[G][0][2] = fmaf(a1, w.x, acc[G][0][2]);
        acc[G][0][3] = fmaf(a1, w.y, acc[G][0][3]);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// int8 pieces (encoder_hopper.cuh, decode_hopper.cuh)
// ---------------------------------------------------------------------------

// (acc * s) [* dq] + b, each step rounded as gru_gate's: the dequantization
// of an int32 product (ops/quantize.py)
__device__ __forceinline__ float dequant(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn((float)acc, s), b);
}
__device__ __forceinline__ float dequant(int acc, float s, float dq, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn((float)acc, s), dq), b);
}

// clip(round_half_even(h * qscale), -127, 127)
__device__ __forceinline__ int8_t quant_h(float h, float qscale) {
  const int v = __float2int_rn(__fmul_rn(h, qscale));
  return (int8_t)min(max(v, -127), 127);
}

// Row and column (within the warp's 8-wide n-tile) of accumulator element
// (m, i), see the layout note at the top.
__device__ __forceinline__ int acc_row(int m, int i) {
  return 16 * m + ((threadIdx.x & 31) >> 2) + 8 * (i >> 1);
}
__device__ __forceinline__ int acc_col(int i) { return 2 * (threadIdx.x & 3) + (i & 1); }

// Copy rows [row0, row0 + TILE_M) of a (rows_total, width) row-major global
// matrix into smem (row stride lds), zero-filling rows past rows_total.
// width * sizeof(T) must be a multiple of 16 (the hosts check H % 64 == 0).
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int lds, const T* src, int width,
                                          int row0, int tile_m, int rows_total) {
  const int vec = 16 / sizeof(T);
  const int per_row = width / vec;
  for (int idx = threadIdx.x; idx < tile_m * per_row; idx += blockDim.x) {
    const int r = idx / per_row, c = (idx % per_row) * vec;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows_total)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * width + c);
    *reinterpret_cast<uint4*>(dst + r * lds + c) = v;
  }
}

}  // namespace inpaint
