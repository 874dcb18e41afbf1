// K8: one direction of a GRU layer over a precomputed input projection
// xw = x @ W_ih + b_ih, with an optional hold mask: the generic layer that
// serves every GRU without a kernel of its own (the LatentRNN's context and
// generation GRUs, the decoder's beat GRU) under the "pallas" GRU route.
//
// Replaces the TPU kernel inpaintnet_tpu/ops/gru_pallas.py
// gru_layer_pallas_stream (_gru_stream_kernel), and with it
// gru_layer_pallas (K9) and gru_layer_pallas_dma (K10), which compute the
// same function. Same numerics as K8: the carry h is held in the parameter
// dtype and rounded to it after every step (unlike K5, whose carry is f32);
// hw = h @ W_hh takes h in the parameter dtype and accumulates in f32 (bf16:
// mma.sync; f32: scalar FMAs, no TF32); b_hh, xw and the gates run in f32,
// every multiply and add rounded on its own (gru_common.cuh gru_gate); a
// step whose mask is 0 keeps h and emits the held h, so an all-zero row
// returns h0; reverse runs t = steps-1 .. 0 and the outputs stay in time
// order.
//
// What bounds it on an H100: each step multiplies every row by the whole
// (H, 3H) W_hh. At the context GRUs' shape (2,048 rows, 16 steps, H 512)
// that is 51.5 GFLOP, at the generation GRU's (2,048 rows, 6 steps, H 1024)
// 77.3 GFLOP: 0.05-0.08 ms on bf16 tensor cores, 0.8-1.2 ms at the f32
// peak; the bytes (xw once, ys once) take less in bf16. W_hh is 1.5 MB
// (H 512) or 6 MB (H 1024) in bf16, far over a block's 227 KB of shared
// memory, so every block streams all of it from the 50 MB L2 on every step,
// and the L2 bytes per row fall as the row tile grows.
//
// Design (K5's and K7's, not the TPU's grid over time): rows are
// independent, so one block owns a tile of rows and loops over all steps
// itself; no grid-wide sync. Rows past B are held and never stored.
// - bf16: 16 or 32 rows a block (one or two 16-row mma tiles; the wrapper
//   picks, gru_kernel.bf16_tile_rows): the h tile is double-buffered in
//   shared memory in bf16, which IS the carry. The gates run in 64-unit
//   chunks holding r, z and n of the same units (the warp's accumulators),
//   reading xw, b_hh and the mask straight from memory in the accumulator
//   layout. 16-row tiles use twice the SMs where 32-row ones leave some
//   idle, at twice the L2 bytes of W_hh a step; a step mostly waits on each
//   product's dependent k-step fragment loads from L2 (Gemm::run). Up to
//   132 KB of shared memory at H 1024 (the 227 KB opt-in).
// - f32: 16 rows a block, K5's f32 route: each thread owns whole units j
//   (j = thread + 256 c, up to four at H 1024) for all 16 rows and keeps
//   their carry in registers; the carry of all units sits k-major in shared
//   memory, (H, 20), double-buffered, as the product's operand (160 KB at
//   H 1024).
// A mask-held row computes its products but not its gates.
#include "gru_common.cuh"

namespace inpaint {

template <typename T>
struct LayerArgs {
  const T* xw;            // (B, steps, 3H)
  const void* whh;        // (H, 3H); fragment-packed for bf16 (kernel_common.pack_mma_b)
  const T* bhh;           // (3H,)
  const T* h0;            // (B, H)
  const uint8_t* keep;    // (B, steps): 0 holds h at that step; null: every step runs
  T* ys;                  // (B, steps, H) outputs, or null (h_n only)
  T* hn;                  // (B, H)
  int B, steps, H, reverse;
};

constexpr int kLayerMaxHidden = 1024;
constexpr int kF32Rows = 16;
constexpr int kLdT = kF32Rows + 4;  // k-major f32 carry: 16 rows + 4 floats (16-byte rows)

__device__ __forceinline__ bool runs_step(const uint8_t* keep, int row, int steps, int t) {
  return keep == nullptr || keep[(size_t)row * steps + t] != 0;
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
gru_layer_bf16_kernel(const LayerArgs<__nv_bfloat16> p) {
  using T = __nv_bfloat16;
  using Tr = Traits<T>;
  constexpr int TM = 16 * MT;
  const int row0 = blockIdx.x * TM;
  const int H = p.H, H3 = 3 * H, B = p.B;
  const int ldh = H + Tr::kPad;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h_cur = reinterpret_cast<T*>(smem_raw);
  T* h_nxt = h_cur + TM * ldh;

  load_rows(h_cur, ldh, p.h0, H, row0, TM, B);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  for (int s = 0; s < p.steps; ++s) {
    const int t = p.reverse ? p.steps - 1 - s : s;
    for (int c = 0; c < H / kChunk; ++c) {
      const int j0 = c * kChunk + warp * 8;
      const int nt[3] = {j0 / 8, (H + j0) / 8, (2 * H + j0) / 8};
      float acc[3][MT][4];
      zero_acc(acc);
      Gemm<T, MT, 3>::run(acc, h_cur, ldh, H, p.whh, H3, nt);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = acc_row(m, i);
          const int j = j0 + acc_col(i);
          const int row = row0 + r;
          T h = h_cur[r * ldh + j];
          if (row < B && runs_step(p.keep, row, p.steps, t)) {
            const T* x = p.xw + ((size_t)row * p.steps + t) * H3;
            const float hr = __fadd_rn(acc[0][m][i], Tr::to_f(p.bhh[j]));
            const float hz = __fadd_rn(acc[1][m][i], Tr::to_f(p.bhh[H + j]));
            const float hn = __fadd_rn(acc[2][m][i], Tr::to_f(p.bhh[2 * H + j]));
            h = Tr::from_f(gru_gate(Tr::to_f(x[j]), hr, Tr::to_f(x[H + j]), hz,
                                    Tr::to_f(x[2 * H + j]), hn, Tr::to_f(h)));
          }
          h_nxt[r * ldh + j] = h;
          if (row < B && p.ys != nullptr) p.ys[((size_t)row * p.steps + t) * H + j] = h;
        }
      }
    }
    __syncthreads();
    T* tmp = h_cur;
    h_cur = h_nxt;
    h_nxt = tmp;
  }

  for (int idx = threadIdx.x; idx < TM * H; idx += blockDim.x) {
    const int r = idx / H, j = idx % H;
    if (row0 + r < B) p.hn[(size_t)(row0 + r) * H + j] = h_cur[r * ldh + j];
  }
}

// f32: one thread per unit, all 16 rows, the carry in registers (see the
// design note). NCOL: units per thread, ceil(H / kThreads).
template <int NCOL>
__global__ void __launch_bounds__(kThreads) gru_layer_f32_kernel(const LayerArgs<float> p) {
  const int row0 = blockIdx.x * kF32Rows;
  const int H = p.H, H3 = 3 * H, B = p.B;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cur = reinterpret_cast<float*>(smem_raw);  // (H, kLdT): the carry, k-major
  float* nxt = cur + H * kLdT;

  float h[NCOL][kF32Rows];
#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    const int j = threadIdx.x + c * kThreads;
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      h[c][r] = j < H && row0 + r < B ? p.h0[(size_t)(row0 + r) * H + j] : 0.0f;
      if (j < H) cur[j * kLdT + r] = h[c][r];
    }
  }
  __syncthreads();

  const float* W = static_cast<const float*>(p.whh);
  for (int s = 0; s < p.steps; ++s) {
    const int t = p.reverse ? p.steps - 1 - s : s;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int j = threadIdx.x + c * kThreads;
      if (j >= H) continue;
      float acc[3][kF32Rows];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) acc[g][r] = 0.0f;
      const float* w = W + j;
#pragma unroll 2
      for (int k = 0; k < H; ++k) {
        const float wr = __ldg(w + (size_t)k * H3);
        const float wz = __ldg(w + (size_t)k * H3 + H);
        const float wn = __ldg(w + (size_t)k * H3 + 2 * H);
        const float4* a = reinterpret_cast<const float4*>(cur + k * kLdT);
#pragma unroll
        for (int q = 0; q < kF32Rows / 4; ++q) {
          const float4 v = a[q];
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[0][4 * q + e] = fmaf(vs[e], wr, acc[0][4 * q + e]);
            acc[1][4 * q + e] = fmaf(vs[e], wz, acc[1][4 * q + e]);
            acc[2][4 * q + e] = fmaf(vs[e], wn, acc[2][4 * q + e]);
          }
        }
      }
      const float br = p.bhh[j], bz = p.bhh[H + j], bn = p.bhh[2 * H + j];
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        const int row = row0 + r;
        if (row < B && runs_step(p.keep, row, p.steps, t)) {
          const float* x = p.xw + ((size_t)row * p.steps + t) * H3;
          h[c][r] = gru_gate(x[j], __fadd_rn(acc[0][r], br), x[H + j], __fadd_rn(acc[1][r], bz),
                             x[2 * H + j], __fadd_rn(acc[2][r], bn), h[c][r]);
        }
        nxt[j * kLdT + r] = h[c][r];
        if (row < B && p.ys != nullptr) p.ys[((size_t)row * p.steps + t) * H + j] = h[c][r];
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    const int j = threadIdx.x + c * kThreads;
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r)
      if (j < H && row0 + r < B) p.hn[(size_t)(row0 + r) * H + j] = h[c][r];
  }
}

template <int MT>
static cudaError_t launch_bf16(const LayerArgs<__nv_bfloat16>& a, cudaStream_t stream) {
  constexpr int TM = 16 * MT;
  const size_t smem = 2ull * TM * (a.H + Traits<__nv_bfloat16>::kPad) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(gru_layer_bf16_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gru_layer_bf16_kernel<MT><<<(a.B + TM - 1) / TM, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

static cudaError_t launch(const LayerArgs<__nv_bfloat16>& a, int tile_rows, cudaStream_t stream) {
  if (tile_rows == 16) return launch_bf16<1>(a, stream);
  if (tile_rows == 32) return launch_bf16<2>(a, stream);
  return cudaErrorInvalidValue;
}

template <int NCOL>
static cudaError_t launch_f32(const LayerArgs<float>& a, cudaStream_t stream) {
  const size_t smem = 2ull * a.H * kLdT * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gru_layer_f32_kernel<NCOL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gru_layer_f32_kernel<NCOL><<<(a.B + kF32Rows - 1) / kF32Rows, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

static cudaError_t launch(const LayerArgs<float>& a, int tile_rows, cudaStream_t stream) {
  if (tile_rows != kF32Rows) return cudaErrorInvalidValue;
  switch ((a.H + kThreads - 1) / kThreads) {
    case 1: return launch_f32<1>(a, stream);
    case 2: return launch_f32<2>(a, stream);
    case 3: return launch_f32<3>(a, stream);
    default: return launch_f32<4>(a, stream);
  }
}

template <typename T>
static cudaError_t run_layer(const void* xw, const void* whh, const void* bhh, const void* h0,
                             const void* keep, void* ys, void* hn, int B, int steps, int H,
                             int reverse, int tile_rows, cudaStream_t stream) {
  LayerArgs<T> a{};
  a.xw = static_cast<const T*>(xw);
  a.whh = whh;
  a.bhh = static_cast<const T*>(bhh);
  a.h0 = static_cast<const T*>(h0);
  a.keep = static_cast<const uint8_t*>(keep);
  a.ys = static_cast<T*>(ys);
  a.hn = static_cast<T*>(hn);
  a.B = B;
  a.steps = steps;
  a.H = H;
  a.reverse = reverse;
  return launch(a, tile_rows, stream);
}

}  // namespace inpaint

// dtype: 0 = float32, 1 = bfloat16. Tensors as documented on LayerArgs (keep
// and ys may be null); H a multiple of 64 up to 1024, B and steps at least 1;
// reverse != 0 runs t = steps-1 .. 0; tile_rows: rows a block owns, 16 or 32
// in bf16, 16 in f32. Returns the cudaError_t of the launch (0 on success);
// launches on `stream` and does not synchronise.
extern "C" int inpaint_gru_layer(int dtype, const void* xw, const void* whh, const void* bhh,
                                 const void* h0, const void* keep, void* ys, void* hn, int B,
                                 int steps, int H, int reverse, int tile_rows, void* stream) {
  if (H % inpaint::kChunk != 0 || H > inpaint::kLayerMaxHidden || B < 1 || steps < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return inpaint::run_layer<float>(xw, whh, bhh, h0, keep, ys, hn, B, steps, H, reverse,
                                     tile_rows, s);
  if (dtype == 1)
    return inpaint::run_layer<__nv_bfloat16>(xw, whh, bhh, h0, keep, ys, hn, B, steps, H,
                                             reverse, tile_rows, s);
  return (int)cudaErrorInvalidValue;
}
