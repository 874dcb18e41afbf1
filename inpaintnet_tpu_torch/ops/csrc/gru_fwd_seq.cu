// K5: the forward of one GRU layer direction in training, over a
// precomputed input projection xw = x @ W_ih + b_ih. Besides the outputs
// ys it emits the gates the hand-written backward (K6, gru_bwd_seq.cu)
// consumes: r, z, n and hn = h @ W_hh + b_hh, all (steps, B, H) in original
// time order.
//
// Replaces the TPU kernel inpaintnet_tpu/ops/gru_bwd_pallas.py
// gru_fwd_seq_pallas (_fwd_seq_kernel). Same function, same numerics: the
// carry is f32; the recurrent product takes h rounded to the parameter
// dtype (bf16: mma.sync with f32 accumulation; f32: scalar FMAs, no TF32);
// biases and gates run in f32, every multiply and add rounded on its own in
// the plain version's order (gru_train_kernel.gru_fwd_seq_reference); the
// five outputs are stored in the parameter dtype.
//
// What bounds it on an H100: each step multiplies a tile of rows by the
// whole (H, 3H) W_hh. At the VAE encoder's shape (steps 24, B 4,096, H 512)
// that is 2 * 24 * 4,096 * 512 * 1,536 = 155 GFLOP per call: 2.3 ms at the
// card's 67 TFLOP/s in f32, 0.16 ms on bf16 tensor cores. It moves the xw
// slab once and writes five (steps, B, H) outputs: 1.6 GB in f32 (0.5 ms
// at 3.35 TB/s), 0.8 GB in bf16 (0.24 ms). So f32 is bound by operations,
// bf16 by bytes. W_hh (3 MB f32) does not fit a block's shared memory and
// streams from L2 every step, as in K1.
//
// Design: rows are independent, so one block owns a tile of rows and
// loops over all steps itself (the TPU's sequential grid axis becomes that
// loop; no grid-wide sync). Rows past B are computed on zeros and never
// stored (the TPU kernel pads the batch instead).
// - bf16: 32 rows a block. The product operand h_t sits in shared memory,
//   double-buffered, beside the f32 carry, which each thread reads and
//   writes only at its own (row, unit). The gates run in 64-unit chunks
//   holding r, z and n of the same units (gru_common.cuh mma.sync), reading
//   xw straight from device memory in the accumulator layout.
// - f32: 16 rows a block; each thread owns whole units j (j = thread,
//   thread + 256) for all 16 rows and keeps their carry in registers. The
//   carry of all units sits k-major in shared memory, (H, 16),
//   double-buffered, as the product's operand: per k a warp reads 32
//   consecutive floats of each of W_hh's three gate columns (coalesced)
//   and the 16 carries of that k as four broadcast float4 loads, for 48
//   FMAs per 7 loads, and the gates of its units run in registers. 80 KB
//   of shared memory at H 512: two blocks per SM.
#include "gru_common.cuh"

namespace inpaint {

template <typename T>
struct FwdSeqArgs {
  const T* xw;      // (B, steps, 3H)
  const void* whh;  // (H, 3H); fragment-packed for bf16 (kernel_common.pack_mma_b)
  const T* bhh;     // (3H,)
  const T* h0;      // (B, H)
  T* out;           // (5, steps, B, H): ys, r, z, n, hn
  int B, steps, H, reverse;
};

constexpr int kCarryPad = 4;  // f32 carry row padding, elements
constexpr int kF32Rows = 16;
constexpr int kLdT = kF32Rows + 4;  // k-major f32 carry: 16 rows + 4 floats (16-byte rows)

// bf16: mma.sync products in the accumulator layout (see the design note)
__global__ void __launch_bounds__(kThreads)
gru_fwd_seq_bf16_kernel(const FwdSeqArgs<__nv_bfloat16> p) {
  using T = __nv_bfloat16;
  using Tr = Traits<T>;
  constexpr int MT = Tr::MT, TM = 16 * MT;
  const int row0 = blockIdx.x * TM;
  const int H = p.H, H3 = 3 * H, B = p.B;
  const int ldh = H + Tr::kPad, ldc = H + kCarryPad;
  const size_t plane = (size_t)p.steps * B * H;  // one of the five outputs

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h_cur = reinterpret_cast<T*>(smem_raw);
  T* h_nxt = h_cur + TM * ldh;
  float* carry = reinterpret_cast<float*>(h_nxt + TM * ldh);

  for (int idx = threadIdx.x; idx < TM * H; idx += blockDim.x) {
    const int r = idx / H, j = idx % H;
    const float v = row0 + r < B ? Tr::to_f(p.h0[(size_t)(row0 + r) * H + j]) : 0.0f;
    h_cur[r * ldh + j] = Tr::from_f(v);
    carry[r * ldc + j] = v;
  }
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
          const bool valid = row < B;
          float xr = 0.0f, xz = 0.0f, xn = 0.0f;
          if (valid) {
            const T* x = p.xw + ((size_t)row * p.steps + t) * H3;
            xr = Tr::to_f(x[j]);
            xz = Tr::to_f(x[H + j]);
            xn = Tr::to_f(x[2 * H + j]);
          }
          const float hr = __fadd_rn(acc[0][m][i], Tr::to_f(p.bhh[j]));
          const float hz = __fadd_rn(acc[1][m][i], Tr::to_f(p.bhh[H + j]));
          const float hn = __fadd_rn(acc[2][m][i], Tr::to_f(p.bhh[2 * H + j]));
          const float h = carry[r * ldc + j];
          const float rg = sigmoid_f(__fadd_rn(xr, hr));
          const float zg = sigmoid_f(__fadd_rn(xz, hz));
          const float ng = tanhf(__fadd_rn(xn, __fmul_rn(rg, hn)));
          const float h_new = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, zg), ng), __fmul_rn(zg, h));
          h_nxt[r * ldh + j] = Tr::from_f(h_new);
          carry[r * ldc + j] = h_new;
          if (valid) {
            T* o = p.out + ((size_t)t * B + row) * H + j;
            o[0] = Tr::from_f(h_new);
            o[plane] = Tr::from_f(rg);
            o[2 * plane] = Tr::from_f(zg);
            o[3 * plane] = Tr::from_f(ng);
            o[4 * plane] = Tr::from_f(hn);
          }
        }
      }
    }
    __syncthreads();
    T* tmp = h_cur;
    h_cur = h_nxt;
    h_nxt = tmp;
  }
}

// f32: one thread per unit, all 16 rows, the carry in registers (see the
// design note). NCOL: units per thread, ceil(H / kThreads).
template <int NCOL>
__global__ void __launch_bounds__(kThreads) gru_fwd_seq_f32_kernel(const FwdSeqArgs<float> p) {
  const int row0 = blockIdx.x * kF32Rows;
  const int H = p.H, H3 = 3 * H, B = p.B;
  const size_t plane = (size_t)p.steps * B * H;

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
        const bool valid = row < B;
        float xr = 0.0f, xz = 0.0f, xn = 0.0f;
        if (valid) {
          const float* x = p.xw + ((size_t)row * p.steps + t) * H3;
          xr = x[j];
          xz = x[H + j];
          xn = x[2 * H + j];
        }
        const float hn = __fadd_rn(acc[2][r], bn);
        const float rg = sigmoid_f(__fadd_rn(xr, __fadd_rn(acc[0][r], br)));
        const float zg = sigmoid_f(__fadd_rn(xz, __fadd_rn(acc[1][r], bz)));
        const float ng = tanhf(__fadd_rn(xn, __fmul_rn(rg, hn)));
        const float h_new =
            __fadd_rn(__fmul_rn(__fsub_rn(1.0f, zg), ng), __fmul_rn(zg, h[c][r]));
        h[c][r] = h_new;
        nxt[j * kLdT + r] = h_new;
        if (valid) {
          float* o = p.out + ((size_t)t * B + row) * H + j;
          o[0] = h_new;
          o[plane] = rg;
          o[2 * plane] = zg;
          o[3 * plane] = ng;
          o[4 * plane] = hn;
        }
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

static cudaError_t launch(const FwdSeqArgs<__nv_bfloat16>& a, cudaStream_t stream) {
  constexpr int TM = 16 * Traits<__nv_bfloat16>::MT;
  const size_t smem = 2ull * TM * (a.H + Traits<__nv_bfloat16>::kPad) * sizeof(__nv_bfloat16) +
                      (size_t)TM * (a.H + kCarryPad) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gru_fwd_seq_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gru_fwd_seq_bf16_kernel<<<(a.B + TM - 1) / TM, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NCOL>
static cudaError_t launch_f32(const FwdSeqArgs<float>& a, cudaStream_t stream) {
  const size_t smem = 2ull * a.H * kLdT * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gru_fwd_seq_f32_kernel<NCOL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gru_fwd_seq_f32_kernel<NCOL><<<(a.B + kF32Rows - 1) / kF32Rows, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

static cudaError_t launch(const FwdSeqArgs<float>& a, cudaStream_t stream) {
  return a.H <= kThreads ? launch_f32<1>(a, stream) : launch_f32<2>(a, stream);
}

template <typename T>
static cudaError_t run_fwd(const void* xw, const void* whh, const void* bhh, const void* h0,
                           void* out, int B, int steps, int H, int reverse,
                           cudaStream_t stream) {
  FwdSeqArgs<T> a{};
  a.xw = static_cast<const T*>(xw);
  a.whh = whh;
  a.bhh = static_cast<const T*>(bhh);
  a.h0 = static_cast<const T*>(h0);
  a.out = static_cast<T*>(out);
  a.B = B;
  a.steps = steps;
  a.H = H;
  a.reverse = reverse;
  return launch(a, stream);
}

}  // namespace inpaint

// dtype: 0 = float32, 1 = bfloat16. Tensors as documented on FwdSeqArgs;
// reverse != 0 runs t = steps-1 .. 0. Returns the cudaError_t of the launch
// (0 on success); launches on `stream` and does not synchronise.
extern "C" int inpaint_gru_fwd_seq(int dtype, const void* xw, const void* whh, const void* bhh,
                                   const void* h0, void* out, int B, int steps, int H,
                                   int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return inpaint::run_fwd<float>(xw, whh, bhh, h0, out, B, steps, H, reverse, s);
  if (dtype == 1)
    return inpaint::run_fwd<__nv_bfloat16>(xw, whh, bhh, h0, out, B, steps, H, reverse, s);
  return (int)cudaErrorInvalidValue;
}
