// K6: the sequential part of one GRU layer direction's backward, from the
// gates K5 stored: per step the cotangents da of x @ W_ih + b_ih and dhw of
// h @ W_hh + b_hh, (steps, B, 3H) in original time order, and the carried
// dh, whose value after the last processed step is dh0 (B, H). The weight
// and input gradients are batched matrix products outside
// (ops/gru_trainfast.py).
//
// Replaces the TPU kernel inpaintnet_tpu/ops/gru_bwd_pallas.py
// gru_bwd_seq_pallas (_bwd_seq_kernel). Same function, same numerics: the
// gate-derivative chain runs in f32, every multiply and add rounded on its
// own in the plain version's order (gru_train_kernel.gru_bwd_seq_reference);
// the recurrent product dhw @ W_hh^T takes dhw UNROUNDED in f32 and W_hh^T
// upcast to f32, with f32 accumulation, whatever the parameter dtype (a
// bf16 or TF32 tensor-core product would be another function); da, dhw and
// dh0 are stored in the parameter dtype. A forward-direction layer is
// processed t = steps-1 .. 0, a reverse one t = 0 .. steps-1.
//
// What bounds it on an H100: the f32 product, 2 * steps * B * 3H * H
// operations: at the VAE encoder's shape (24, 4,096, H 512) 155 GFLOP, 2.3 ms
// at 67 TFLOP/s. It reads six (steps, B, H) inputs and writes two
// (steps, B, 3H) outputs, 2.4 GB in f32 (0.72 ms at 3.35 TB/s), 1.2 GB in
// bf16. So it is bound by f32 operations in both dtypes.
//
// Design: one block owns 16 rows and loops over the steps; each thread
// owns whole units j (j = thread, thread + 256) for all 16 rows, and keeps
// their carried dh in registers. Each step has two phases. (1) Elementwise:
// per row, the threads of a warp read 32 consecutive units of each input
// (coalesced), compute the gate derivatives, store da and dhw, put dhw in
// f32 into a shared (3H, 16) tile (k-major, so one float4 holds four rows
// of one k), and keep g * z. (2) The product, after one barrier: a warp
// reads 32 consecutive floats of a W_hh^T row (coalesced) and the 16 dhw
// values of that k as four broadcast float4 loads, for 16 FMAs per load of
// W; W_hh^T (3H, H) f32 streams from L2 once per block and step. Each dh
// element sums its 3H products in k order with FMAs; dh = g * z + product.
// The tile is unpadded, 96 KB at H 512, so two blocks share an SM (the
// phase-1 stores to it conflict 16 ways; they are few). Rows past B stay
// zero and are never stored.
#include "gru_common.cuh"

namespace inpaint {

constexpr int kBwdRows = 16;
constexpr int kLdT = kBwdRows;  // k-major dhw tile, unpadded: two blocks fit an SM

template <typename T>
struct BwdSeqArgs {
  const T* dys;     // (steps, B, H) output cotangents
  const T* r;       // (steps, B, H) stored gates
  const T* z;
  const T* n;
  const T* hn;
  const T* hprev;   // (steps, B, H) h_{t-1} per step (h0 at the first processed step)
  const float* whh_t;  // (3H, H) f32: W_hh transposed, upcast
  T* da;            // (steps, B, 3H)
  T* dhw;           // (steps, B, 3H)
  T* dh0;           // (B, H)
  int B, steps, H, reverse;
};

// NCOL: units per thread, ceil(H / kThreads)
template <typename T, int NCOL>
__global__ void __launch_bounds__(kThreads) gru_bwd_seq_kernel(const BwdSeqArgs<T> p) {
  using Tr = Traits<T>;
  const int row0 = blockIdx.x * kBwdRows;
  const int H = p.H, H3 = 3 * H, B = p.B;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dhw_s = reinterpret_cast<float*>(smem_raw);  // (3H, kLdT): dhw in f32, k-major

  float dh[NCOL][kBwdRows];  // carried dh of this thread's units, then g * z
#pragma unroll
  for (int c = 0; c < NCOL; ++c)
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) dh[c][r] = 0.0f;

  for (int s = 0; s < p.steps; ++s) {
    const int t = p.reverse ? s : p.steps - 1 - s;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int j = threadIdx.x + c * kThreads;
      if (j >= H) continue;
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) {
        const int row = row0 + r;
        float dar = 0.0f, daz = 0.0f, dan = 0.0f, dhn = 0.0f, gz = 0.0f;
        if (row < B) {
          const size_t o = ((size_t)t * B + row) * H + j;
          const float g = __fadd_rn(Tr::to_f(p.dys[o]), dh[c][r]);
          const float rg = Tr::to_f(p.r[o]), zg = Tr::to_f(p.z[o]), ng = Tr::to_f(p.n[o]);
          const float hn = Tr::to_f(p.hn[o]), hp = Tr::to_f(p.hprev[o]);
          const float dn = __fmul_rn(g, __fsub_rn(1.0f, zg));
          const float dz = __fmul_rn(g, __fsub_rn(hp, ng));
          dan = __fmul_rn(dn, __fsub_rn(1.0f, __fmul_rn(ng, ng)));
          const float dr = __fmul_rn(dan, hn);
          dar = __fmul_rn(__fmul_rn(dr, rg), __fsub_rn(1.0f, rg));
          daz = __fmul_rn(__fmul_rn(dz, zg), __fsub_rn(1.0f, zg));
          dhn = __fmul_rn(dan, rg);
          gz = __fmul_rn(g, zg);
          const size_t o3 = ((size_t)t * B + row) * H3 + j;
          p.da[o3] = Tr::from_f(dar);
          p.da[o3 + H] = Tr::from_f(daz);
          p.da[o3 + 2 * H] = Tr::from_f(dan);
          p.dhw[o3] = Tr::from_f(dar);
          p.dhw[o3 + H] = Tr::from_f(daz);
          p.dhw[o3 + 2 * H] = Tr::from_f(dhn);
        }
        dhw_s[j * kLdT + r] = dar;
        dhw_s[(H + j) * kLdT + r] = daz;
        dhw_s[(2 * H + j) * kLdT + r] = dhn;
        dh[c][r] = gz;
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int j = threadIdx.x + c * kThreads;
      if (j >= H) continue;
      float acc[kBwdRows];
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) acc[r] = 0.0f;
      const float* w = p.whh_t + j;
#pragma unroll 8
      for (int k = 0; k < H3; ++k) {
        const float wk = __ldg(w + (size_t)k * H);
        const float4* a = reinterpret_cast<const float4*>(dhw_s + k * kLdT);
#pragma unroll
        for (int q = 0; q < kBwdRows / 4; ++q) {
          const float4 v = a[q];
          acc[4 * q] = fmaf(v.x, wk, acc[4 * q]);
          acc[4 * q + 1] = fmaf(v.y, wk, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, wk, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, wk, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) dh[c][r] = __fadd_rn(dh[c][r], acc[r]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    const int j = threadIdx.x + c * kThreads;
    if (j >= H) continue;
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r)
      if (row0 + r < B) p.dh0[(size_t)(row0 + r) * H + j] = Tr::from_f(dh[c][r]);
  }
}

template <typename T, int NCOL>
static cudaError_t launch_bwd(const BwdSeqArgs<T>& a, cudaStream_t stream) {
  const size_t smem = (size_t)3 * a.H * kLdT * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gru_bwd_seq_kernel<T, NCOL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gru_bwd_seq_kernel<T, NCOL><<<(a.B + kBwdRows - 1) / kBwdRows, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t run_bwd(const void* dys, const void* r, const void* z, const void* n,
                           const void* hn, const void* hprev, const void* whh_t, void* da,
                           void* dhw, void* dh0, int B, int steps, int H, int reverse,
                           cudaStream_t stream) {
  BwdSeqArgs<T> a{};
  a.dys = static_cast<const T*>(dys);
  a.r = static_cast<const T*>(r);
  a.z = static_cast<const T*>(z);
  a.n = static_cast<const T*>(n);
  a.hn = static_cast<const T*>(hn);
  a.hprev = static_cast<const T*>(hprev);
  a.whh_t = static_cast<const float*>(whh_t);
  a.da = static_cast<T*>(da);
  a.dhw = static_cast<T*>(dhw);
  a.dh0 = static_cast<T*>(dh0);
  a.B = B;
  a.steps = steps;
  a.H = H;
  a.reverse = reverse;
  return H <= kThreads ? launch_bwd<T, 1>(a, stream) : launch_bwd<T, 2>(a, stream);
}

}  // namespace inpaint

// dtype: 0 = float32, 1 = bfloat16 (of every tensor but whh_t, which is
// f32). Tensors as documented on BwdSeqArgs; reverse is the layer's
// direction. Returns the cudaError_t of the launch (0 on success); launches
// on `stream` and does not synchronise.
extern "C" int inpaint_gru_bwd_seq(int dtype, const void* dys, const void* r, const void* z,
                                   const void* n, const void* hn, const void* hprev,
                                   const void* whh_t, void* da, void* dhw, void* dh0, int B,
                                   int steps, int H, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return inpaint::run_bwd<float>(dys, r, z, n, hn, hprev, whh_t, da, dhw, dh0, B, steps, H,
                                   reverse, s);
  if (dtype == 1)
    return inpaint::run_bwd<__nv_bfloat16>(dys, r, z, n, hn, hprev, whh_t, da, dhw, dh0, B,
                                           steps, H, reverse, s);
  return (int)cudaErrorInvalidValue;
}
