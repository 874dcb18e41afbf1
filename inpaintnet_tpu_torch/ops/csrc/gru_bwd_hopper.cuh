// The Hopper design of K6 (gru_bwd_seq.cu), both dtypes: the sequential
// part of one GRU layer direction's backward, from the gates K5 stored.
// It replaces the TPU kernel inpaintnet_tpu/ops/gru_bwd_pallas.py
// gru_bwd_seq_pallas (_bwd_seq_kernel).
//
// Function (gru_train_kernel.gru_bwd_seq_reference): per processed step,
// g = dy + dh, the f32 gate-derivative chain, da and dhw stored in the
// parameter dtype, and dh = g * z + dhw @ W_hh^T, where the product takes
// dhw UNROUNDED in f32 and W_hh in f32, whatever the parameter dtype; dh is
// carried in f32 and dh0 stored in the parameter dtype.
//
// What bounds it on an H100: the product, 2 * steps * B * 3H * H operations
// (155 GFLOP at the VAE encoder's 24 steps x 4,096 rows x H 512), which on
// the f32 FMA units alone is 2.31 ms. The first kernel (one block of 16 rows
// streaming the whole f32 W_hh^T from L2 every step) took 12.2 ms.
//
// Design:
// - The f32 product on the tensor cores, split exactly: dhw = hi + mid + lo,
//   three bf16 pieces (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
//   mid): 24 bits). In bf16 W_hh is one exact piece: three bf16 wgmma passes
//   accumulated in f32 (0.47 ms of tensor-core time at the encoder's
//   shape). In f32 W_hh is split the same way and the passes keep the cross
//   terms down to 2^-24 (lh, hl, mm, mh, hm, hh: six, smallest first).
// - A cluster of C CTAs shares a 64-row tile; CTA rank p owns the U = H / C
//   units [pU, pU + U) (at most 128, so H 1024 takes 8 CTAs of 128, whose
//   product is 3H = 3,072 deep: 48 k-slabs streamed as at every width,
//   nothing of the tile resident): their elementwise chain, their 3U
//   columns of da and dhw, and their U output columns of the product (two
//   consumer warpgroups each take half of them). dh stays in shared memory,
//   f32: the elementwise phase walks it by rows, each warp's loads and
//   stores of a row whole 128-byte runs (stores of 8 rows x 16 bytes a warp
//   instruction, the accumulator's layout, took two thirds of the time), and
//   the product's epilogue adds its fragments in place.
// - The product's k-operand is the whole (64, 3H) dhw tile, 576 KB in three
//   bf16 pieces at H 512: more than a CTA's shared memory. So each CTA
//   writes its dhw pieces into an L2-resident scratch (tile, step parity,
//   piece, row, k); a release/acquire arrival on every peer's `ready`
//   mbarrier follows; and a producer warp then streams each 64-wide k-slab
//   of the three pieces (one 24 KB TMA box) beside the CTA's W_hh k-slab
//   (one box of its U rows x 64 of K in each W piece) through a ring into
//   wgmma. The cluster only moves data, so every cluster size gives
//   bit-equal outputs. The scratch alternates between two buffers by step
//   parity: a CTA writes step s + 2's pieces only after its own product of
//   step s + 1, which waited for every peer's arrival of step s + 1, made
//   after each peer had consumed all of step s's slabs.
// - The packed W pieces (gru_train_kernel.pack_bwd_weights, cached per
//   weight tensor) are (3H / 64 k-slabs, pieces, H rows, 64): a CTA's units
//   are contiguous rows of each k-slab's piece.
// - Rows past B compute on zeros and are never stored.
// - Above 1024 units (and wherever a check forces it) a tile's CTAs, 128
//   units each, form a tile group instead of a cluster, as K5's
//   (gru_fwd_hopper.cuh): a monotonic release/acquire counter a tile in
//   global memory instead of the `ready` mbarrier, in a persistent,
//   cooperative launch of as many groups as the card holds (kSyncGroup);
//   or, for a group the card cannot hold, steps + 1 launches, launch j the
//   product of step j - 1 and the elementwise phase of step j, g * z
//   carried between them in an f32 (B, H) buffer (kSyncStep). Bit-equal to
//   the cluster route.
#pragma once

#include "hopper_common.cuh"

namespace inpaint {
namespace bwd90 {

using namespace sm90;

constexpr int kRows = 64;                    // rows of a tile: one wgmma m64
constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kPieces = 3;                   // bf16 pieces of dhw
constexpr int kASlabBytes = kPieces * kRows * 128;  // a 64-wide k-slab of every piece: 24 KB
constexpr int kMaxStages = 6;
constexpr int kMaxUnits = 128;               // units a CTA owns
constexpr int kDhPad = 8;                    // f32 padding of dh's rows in shared memory
constexpr int kMaxCluster = 8;
constexpr int kBar = 1;                      // named barrier of the consumers
constexpr int kSmemBudget = 232448 - 2048;

template <typename T> struct Io;
template <> struct Io<float> {
  static constexpr int kWPieces = 3;
  __device__ static void load2(const float* p, float (&v)[2]) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <> struct Io<__nv_bfloat16> {
  static constexpr int kWPieces = 1;
  __device__ static void load2(const __nv_bfloat16* p, float (&v)[2]) {
    const uint32_t x = __ldg(reinterpret_cast<const unsigned int*>(p));
    v[0] = __uint_as_float(x << 16);
    v[1] = __uint_as_float(x & 0xFFFF0000u);
  }
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// one k16 step of a 64 x N product (N = 32 or 64 by the fragment)
__device__ __forceinline__ void wgmma_k16(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  wgmma_bf16_n32(d, a, b, acc);
}
__device__ __forceinline__ void wgmma_k16(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  wgmma_bf16_n64(d, a, b, acc);
}

struct BwdArgs {
  const void* dys;    // (steps, B, H) T, output cotangents
  const void* r;      // (steps, B, H) T, stored gates
  const void* z;
  const void* n;
  const void* hn;
  const void* hprev;  // (steps, B, H) T, h_{t-1} per step
  void* da;           // (steps, B, 3H) T
  void* dhw;          // (steps, B, 3H) T
  void* dh0;          // (B, H) T
  __nv_bfloat16* scratch;  // (tiles, 2, 3, 64, 3H): dhw's pieces by step parity
  int B, steps, H, reverse, stages;
  // tile groups (kSyncGroup, kSyncStep)
  unsigned int* counters;  // kSyncGroup: (tiles,) zeros, each tile's arrivals
  float* carry;            // kSyncStep: (B, H) f32, g * z of the last elementwise phase
  int group;               // CTAs a tile (the cluster's size under kSyncCluster)
  int s_begin, s_end;      // kSyncStep: the processed steps [s_begin, s_end) of this launch,
  int skip_first, skip_last;  // without the elementwise phase of the first, the product of
                              // the last
  int fault;               // GroupFault: a planted fault of the group's exchange
};

// bytes of one ring stage: a k-slab of the three dhw pieces and of the
// CTA's U rows of every W piece
__host__ __device__ __forceinline__ int stage_bytes(int U, int wpieces) {
  return kASlabBytes + wpieces * U * 128;
}

// NW: units of a consumer warpgroup (U / 2): 32 or 64. kSync (TileSync):
// how the CTAs of a tile meet at each step, as K5's (gru_fwd_hopper.cuh).
// Under kSyncStep a step's elementwise phase and its product run in two
// launches (the exchange between them is the launch boundary): launch j
// runs the product of step j - 1 and the elementwise phase of step j.
template <typename T, int NW, int kSync = kSyncCluster>
__global__ void __launch_bounds__(kThreads, 1)
    gru_bwd_kernel(const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap a_map, const __grid_constant__ BwdArgs p) {
  constexpr int P = Io<T>::kWPieces;
  constexpr int NA = NW / 2;  // accumulator registers: 64 x NW f32 over 128 threads
  constexpr bool kClustered = kSync == kSyncCluster;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kMaxStages];
  __shared__ __align__(8) uint64_t ready;  // every CTA's dhw pieces of a step are written
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int H = p.H, H3 = 3 * H, B = p.B, steps = p.steps, KB = H3 / 64;
  const int C = kClustered ? (int)cluster_nctarank() : p.group;
  const uint32_t rank = kClustered ? cluster_ctarank() : blockIdx.x % (uint32_t)p.group;
  const int U = H / C, u0 = (int)rank * U;
  const int tiles = kClustered ? (int)(gridDim.x / C) : (B + kRows - 1) / kRows;
  const int tile_stride = (int)(gridDim.x / C);
  const int s_begin = kSync == kSyncStep ? p.s_begin : 0;
  const int s_end = kSync == kSyncStep ? p.s_end : steps;
  const int fault = kClustered ? kFaultNone : p.fault;
  // kSyncStep: the halves of the launch's steps that this launch runs
  const auto runs_elementwise = [&](int s) {
    return kSync != kSyncStep || !(s == s_begin && p.skip_first);
  };
  const auto runs_product = [&](int s) {
    return kSync != kSyncStep || !(s == s_end - 1 && p.skip_last);
  };
  const int sbytes = stage_bytes(U, P);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    mbar_init(&ready, C);
    fence_barrier_init();
  }
  __syncthreads();
  if constexpr (kClustered) cluster_sync();  // every CTA's barriers are set before any peer arrives

  if (wg == kConsumers) {  // the producer warp
    if ((threadIdx.x & 31) == 0) {
      int stage = 0;
      uint32_t phase = 0;
      const auto produce = [&](int tile) {
        for (int s = s_begin; s < s_end; ++s) {
          if (!runs_product(s)) continue;
          const int plane = (tile * 2 + ((s + (fault == kFaultOtherParity)) & 1)) * kPieces;
          for (int k = 0; k < KB; ++k) {
            unsigned char* st = ring + stage * sbytes;
            mbar_wait_bounded<false>(&empty_bar[stage], phase ^ 1);
            mbar_expect_tx(&full_bar[stage], (uint32_t)sbytes);
            tma_load_3d(st + kASlabBytes, &w_map, &full_bar[stage], 0, u0, k * P);
            if (k == 0) {  // this step's pieces, from every CTA of the tile (under
                           // kSyncStep the launch before this one wrote them)
              if constexpr (kClustered) {
                mbar_wait_bounded<true>(&ready, s & 1);
                fence_proxy_async_global();
              } else if constexpr (kSync == kSyncGroup) {
                group_wait_bounded(p.counters + tile,
                                   (unsigned)(C * (s + 1) - (fault == kFaultCountShort)));
                fence_proxy_async_global();
              }
            }
            tma_load_3d(st, &a_map, &full_bar[stage], k * 64, 0, plane);
            if (++stage == p.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      };
      if constexpr (kClustered)  // one tile: no loop, whose live values spilled
        produce((int)(blockIdx.x / C));
      else
        for (int tile = (int)(blockIdx.x / C); tile < tiles; tile += tile_stride) produce(tile);
    }
    if constexpr (kClustered) cluster_sync();
    return;
  }

  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            q = lane & 3;
  const int ew = tid >> 5;  // the consumer warp (0..7): the elementwise phase's rows
  const T* dys = static_cast<const T*>(p.dys);
  const T* rg = static_cast<const T*>(p.r);
  const T* zg = static_cast<const T*>(p.z);
  const T* ng = static_cast<const T*>(p.n);
  const T* hng = static_cast<const T*>(p.hn);
  const T* hpg = static_cast<const T*>(p.hprev);
  T* da = static_cast<T*>(p.da);
  T* dhw_out = static_cast<T*>(p.dhw);
  // dh of the CTA's 64 rows x U units in f32 (then g * z until the product
  // is added), rows of U + kDhPad: the elementwise phase walks it by rows,
  // the product's epilogue by the accumulator's fragments
  const int ld = U + kDhPad;
  float* dh_s = reinterpret_cast<float*>(ring + p.stages * sbytes);
  int stage = 0;
  uint32_t phase = 0;

  // The elementwise phase's mapping: warp ew takes rows ew, ew + 8, ...,
  // ew + 56, lane l the unit pairs 64 pp + 2l, pp < U / 64, so a warp's
  // loads and stores of a row are whole 128-byte runs of bf16 (256 of f32).
  constexpr int PP = NW / 32;       // unit pairs of a lane in a row
  constexpr int RG = 4 / PP;        // rows whose loads are in flight at once
  const auto input = [&](int v) {
    return v == 0 ? dys : v == 1 ? rg : v == 2 ? zg : v == 3 ? ng : v == 4 ? hng : hpg;
  };

  const auto consume = [&](int tile) {
    const int tile0 = tile * kRows;
    // dh starts at 0 (kSyncStep, a launch that starts with a product: g * z
    // of that step, which the previous launch kept in `carry`)
    const bool resume = kSync == kSyncStep && p.skip_first;
    for (int i = tid; i < kRows * ld; i += kConsumerThreads) {
      const int r = i / ld, c = i % ld, row = tile0 + r;
      dh_s[i] = resume && c < U && row < B ? p.carry[(size_t)row * H + u0 + c] : 0.0f;
    }
    // into L2, a step's six inputs of the warp's rows and the CTA's units,
    // while the step before it runs its product (13% of K6's time in bf16)
    const auto prefetch_step = [&](int t) {
      constexpr int kLines = (2 * NW * (int)sizeof(T) + 127) / 128;
      for (int c = lane; c < 8 * 6 * kLines; c += 32) {
        const int ri = c / (6 * kLines), v = (c / kLines) % 6, line = c % kLines;
        const int row = tile0 + ew + 8 * ri;
        if (row < B)
          prefetch_l2(reinterpret_cast<const unsigned char*>(input(v) + ((size_t)t * B + row) * H +
                                                             u0) + 128 * line);
      }
    };
    named_barrier(kBar, kConsumerThreads);
    if (runs_elementwise(s_begin) && s_begin < s_end)
      prefetch_step(p.reverse ? s_begin : steps - 1 - s_begin);

    for (int s = s_begin; s < s_end; ++s) {
      const int t = p.reverse ? s : steps - 1 - s;
      __nv_bfloat16* pieces = p.scratch + (size_t)(tile * 2 + (s & 1)) * kPieces * kRows * H3;
      if (runs_elementwise(s)) {
        if (fault == kFaultCountShort && rank == (uint32_t)(C - 1)) late_rank_pause();
#pragma unroll
        for (int r0 = 0; r0 < 8; r0 += RG) {
          // the six inputs of RG rows, loaded before any is used
          float in[RG][PP][6][2];
#pragma unroll
          for (int ri = 0; ri < RG; ++ri) {
            const int row = tile0 + ew + 8 * (r0 + ri);
            const size_t o = ((size_t)t * B + (row < B ? row : 0)) * H + u0 + 2 * lane;
#pragma unroll
            for (int pp = 0; pp < PP; ++pp)
#pragma unroll
              for (int v = 0; v < 6; ++v) {
                in[ri][pp][v][0] = in[ri][pp][v][1] = 0.0f;
                if (row < B) Io<T>::load2(input(v) + o + 64 * pp, in[ri][pp][v]);
              }
          }
#pragma unroll
          for (int ri = 0; ri < RG; ++ri) {
            const int r = ew + 8 * (r0 + ri), row = tile0 + r;
            const bool valid = row < B;
            const size_t o3 = ((size_t)t * B + (valid ? row : 0)) * H3 + u0;
#pragma unroll
            for (int pp = 0; pp < PP; ++pp) {
              const int jl = 64 * pp + 2 * lane;  // the pair's first unit among the CTA's
              const float(&dy)[2] = in[ri][pp][0];
              const float(&rv)[2] = in[ri][pp][1];
              const float(&zv)[2] = in[ri][pp][2];
              const float(&nv)[2] = in[ri][pp][3];
              const float(&hnv)[2] = in[ri][pp][4];
              const float(&hp)[2] = in[ri][pp][5];
              float2* dhp = reinterpret_cast<float2*>(dh_s + r * ld + jl);
              const float2 dh = *dhp;
              float dar[2], daz[2], dan[2], dhn[2], gz[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                // the plain version's order, each operation rounded on its own
                const float gg = valid ? __fadd_rn(dy[e], e ? dh.y : dh.x) : 0.0f;
                const float dn = __fmul_rn(gg, __fsub_rn(1.0f, zv[e]));
                const float dz = __fmul_rn(gg, __fsub_rn(hp[e], nv[e]));
                dan[e] = __fmul_rn(dn, __fsub_rn(1.0f, __fmul_rn(nv[e], nv[e])));
                const float dr = __fmul_rn(dan[e], hnv[e]);
                dar[e] = __fmul_rn(__fmul_rn(dr, rv[e]), __fsub_rn(1.0f, rv[e]));
                daz[e] = __fmul_rn(__fmul_rn(dz, zv[e]), __fsub_rn(1.0f, zv[e]));
                dhn[e] = __fmul_rn(dan[e], rv[e]);
                gz[e] = __fmul_rn(gg, zv[e]);  // g * z, until the product is added
              }
              *dhp = make_float2(gz[0], gz[1]);
              if (valid) {
                Io<T>::store2(da + o3 + jl, dar[0], dar[1]);
                Io<T>::store2(da + o3 + H + jl, daz[0], daz[1]);
                Io<T>::store2(da + o3 + 2 * H + jl, dan[0], dan[1]);
                Io<T>::store2(dhw_out + o3 + jl, dar[0], dar[1]);
                Io<T>::store2(dhw_out + o3 + H + jl, daz[0], daz[1]);
                Io<T>::store2(dhw_out + o3 + 2 * H + jl, dhn[0], dhn[1]);
              }
              // dhw's pieces into the scratch: row r, columns gate * H + u0 + jl
              const auto put = [&](int gate, float v0, float v1) {
                __nv_bfloat16 pc[2][kPieces];
                split3(v0, pc[0]);
                split3(v1, pc[1]);
#pragma unroll
                for (int pi = 0; pi < kPieces; ++pi)
                  *reinterpret_cast<__nv_bfloat162*>(
                      pieces + ((size_t)pi * kRows + r) * H3 + gate * H + u0 + jl) =
                      __halves2bfloat162(pc[0][pi], pc[1][pi]);
              };
              put(0, dar[0], dar[1]);
              put(1, daz[0], daz[1]);
              put(2, dhn[0], dhn[1]);
            }
          }
        }
        // the pieces are written: make them visible to the peers' TMA loads
        // (async proxy), then tell every CTA of the tile: under kSyncCluster
        // thread c arrives on CTA c's `ready`, under kSyncGroup thread 0 adds
        // 1 to the tile's counter (under kSyncStep the launch ends first)
        __threadfence();
        fence_proxy_async_global();
        named_barrier(kBar, kConsumerThreads);
        if constexpr (kClustered) {
          if (tid < C) mbar_arrive_cluster(mapa(smem_u32(&ready), tid));
        } else if constexpr (kSync == kSyncGroup) {
          if (tid == 0) group_arrive(p.counters + tile);
        }
        if (s + 1 < s_end && runs_elementwise(s + 1))
          prefetch_step(p.reverse ? s + 1 : steps - 2 - s);
      }
      if (!runs_product(s)) continue;

      // the product: every k-slab of the three pieces against this
      // warpgroup's NW units of each W piece. A slab's passes accumulate in
      // the tensor cores (pa or pb, in turns, so that one slab's products run
      // while the last one's are added), and the slabs' partial sums add up
      // in acc with rounded f32 adds: the tensor cores' own f32 sums are not
      // rounded to nearest, and over all 3H of K (6 passes each, in f32) their
      // error would grow past the f32 bounds.
      float acc[NA], pa[NA], pb[NA];
      const uint32_t wrow = (uint32_t)(wg * NW * 128);
      const int wplane = U * 128;
      const auto issue = [&](float(&part)[NA]) {
        unsigned char* st = ring + stage * sbytes;
        mbar_wait_bounded<false>(&full_bar[stage], phase);
        wgmma_fence();
#pragma unroll
        for (int pass = 0; pass < (P == 1 ? 3 : 6); ++pass) {
          // (dhw piece, W piece), smallest terms first
          // bf16: lo, mid, hi against W; f32: lh, hl, mm, mh, hm, hh
          const int ap = P == 1 ? 2 - pass : (0x001102 >> (4 * pass)) & 0xF;
          const int wp = P == 1 ? 0 : (0x010120 >> (4 * pass)) & 0xF;
          const uint64_t da_ = desc_sw128(st + ap * kRows * 128);
          const uint64_t db_ = desc_sw128(st + kASlabBytes + wp * wplane + wrow);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_k16(part, da_ + 2 * kk, db_ + 2 * kk, (pass > 0 || kk > 0) ? 1 : 0);
        }
        wgmma_commit();
      };
      int prev = 0;
      // the slab before the one just issued is done: add it, free its stage
      const auto retire = [&](float(&part)[NA], bool first) {
        fence_operands(part);
#pragma unroll
        for (int a = 0; a < NA; ++a) acc[a] = first ? part[a] : __fadd_rn(acc[a], part[a]);
        if (lane == 0) mbar_arrive(&empty_bar[prev]);
      };
      const auto advance = [&]() {
        prev = stage;
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      };
      for (int k = 0; k < KB; k += 2) {
        issue(pa);
        if (k > 0) {
          wgmma_wait<1>();
          retire(pb, false);
        }
        advance();
        if (k + 1 < KB) {
          issue(pb);
          wgmma_wait<1>();
          retire(pa, k == 0);
          advance();
        }
      }
      wgmma_wait<0>();
      if (KB % 2)
        retire(pa, KB == 1);
      else
        retire(pb, false);
      // dh = g * z + the product; acc[4 i + 2 half + e] is row 16 warp + g +
      // 8 half, unit wg NW + 8 i + 2q + e among the CTA's
#pragma unroll
      for (int i = 0; i < NW / 8; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2* dhp = reinterpret_cast<float2*>(dh_s + (16 * warp + g + 8 * half) * ld +
                                                  wg * NW + 8 * i + 2 * q);
          const float2 gzv = *dhp;
          *dhp = make_float2(__fadd_rn(gzv.x, acc[4 * i + 2 * half]),
                             __fadd_rn(gzv.y, acc[4 * i + 2 * half + 1]));
        }
      named_barrier(kBar, kConsumerThreads);
    }

    // dh0 after the last step; under kSyncStep before it, g * z of the step
    // whose product the next launch adds (each thread its elementwise pairs)
    const bool done = kSync != kSyncStep || (s_end == steps && !p.skip_last);
    T* dh0 = static_cast<T*>(p.dh0);
#pragma unroll
    for (int ri = 0; ri < 8; ++ri) {
      const int r = ew + 8 * ri, row = tile0 + r;
      if (row >= B) continue;
#pragma unroll
      for (int pp = 0; pp < PP; ++pp) {
        const float2 v = *reinterpret_cast<const float2*>(dh_s + r * ld + 64 * pp + 2 * lane);
        if (done)
          Io<T>::store2(dh0 + (size_t)row * H + u0 + 64 * pp + 2 * lane, v.x, v.y);
        else
          *reinterpret_cast<float2*>(p.carry + (size_t)row * H + u0 + 64 * pp + 2 * lane) = v;
      }
    }
    // the next tile's dh is written after every thread has read this one's
    if constexpr (kSync == kSyncGroup) named_barrier(kBar, kConsumerThreads);
  };
  if constexpr (kClustered)  // one tile: no loop, whose live values spilled
    consume((int)(blockIdx.x / C));
  else
    for (int tile = (int)(blockIdx.x / C); tile < tiles; tile += tile_stride) consume(tile);
  if constexpr (kClustered) cluster_sync();
}

// dynamic shared memory of a K6 block: the ring, dh (64 rows of U +
// kDhPad f32) and 1 KB of alignment
inline size_t smem_bytes(int U, int wpieces, int stages) {
  return (size_t)stages * stage_bytes(U, wpieces) + (size_t)kRows * (U + kDhPad) * 4 + 1024;
}

// the launch's checks: C CTAs owning whole 64-unit blocks of at most
// kMaxUnits units each, a ring of 2..kMaxStages stages that fits
inline bool plan_fits(int H, int C, int wpieces, int stages) {
  if (H % 64 != 0 || H <= 0 || C < 1 || C > kMaxCluster || (H / 64) % C != 0) return false;
  const int U = H / C;
  if (U > kMaxUnits || stages < 2 || stages > kMaxStages) return false;
  return smem_bytes(U, wpieces, stages) <= (size_t)kSmemBudget;
}

// `clusters` tiles (or tile groups) of C CTAs under `sync`: clusters of C
// CTAs, a cooperative launch of tile groups, or one step's launch
// (set_tile_launch)
template <typename Kernel>
inline cudaError_t launch_k6(Kernel kernel, int clusters, int C, size_t smem, cudaStream_t stream,
                             const CUtensorMap& w_map, const CUtensorMap& a_map,
                             const BwdArgs& args, int sync = kSyncCluster) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  set_tile_launch(attr[0], sync, C);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, w_map, a_map, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the W map over the packed pieces (3H / 64 k-slabs x P pieces of (H, 64)),
// a box of one k-slab's U rows of every piece
inline cudaError_t make_w_map(CUtensorMap* map, const void* packed, int H, int wpieces, int U) {
  const uint64_t dims[3] = {64, (uint64_t)H, (uint64_t)(3 * H / 64) * wpieces};
  const uint64_t strides[2] = {128, (uint64_t)H * 128};
  const uint32_t box[3] = {64, (uint32_t)U, (uint32_t)wpieces};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, packed, dims, strides, box);
}

// the A map over the scratch: planes of (64 rows, 3H), a box of one
// 64-wide k-slab of the three pieces
inline cudaError_t make_a_map(CUtensorMap* map, const void* scratch, int H, int tiles) {
  const uint64_t dims[3] = {(uint64_t)(3 * H), (uint64_t)kRows, (uint64_t)tiles * 2 * kPieces};
  const uint64_t strides[2] = {(uint64_t)(3 * H) * 2, (uint64_t)kRows * 3 * H * 2};
  const uint32_t box[3] = {64, (uint32_t)kRows, (uint32_t)kPieces};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, scratch, dims, strides, box);
}

template <typename T, int NW>
inline cudaError_t run_k6(const CUtensorMap& w_map, const BwdArgs& a, int C, cudaStream_t stream) {
  constexpr int P = Io<T>::kWPieces;
  const int U = a.H / C, tiles = (a.B + kRows - 1) / kRows;
  CUtensorMap a_map;
  cudaError_t err = make_a_map(&a_map, a.scratch, a.H, tiles);
  if (err != cudaSuccess) return err;
  return launch_k6(gru_bwd_kernel<T, NW>, tiles, C, smem_bytes(U, P, a.stages), stream, w_map,
                   a_map, a);
}

template <typename T>
inline cudaError_t launch_gru_bwd(const CUtensorMap& w_map, const BwdArgs& a, int C,
                                  cudaStream_t stream) {
  constexpr int P = Io<T>::kWPieces;
  if (!plan_fits(a.H, C, P, a.stages) || a.B < 1 || a.steps < 1 || a.scratch == nullptr)
    return cudaErrorInvalidValue;
  switch (a.H / C / 2) {
    case 32: return run_k6<T, 32>(w_map, a, C, stream);
    case 64: return run_k6<T, 64>(w_map, a, C, stream);
    default: return cudaErrorInvalidValue;
  }
}

// K6 on the CTAs of a tile beyond one cluster (above 1,024 units, or where a
// check forces it): a.group CTAs of 128 units a tile; `sync` kSyncGroup
// (`groups` persistent tile groups; a.counters (tiles,) zeros) or kSyncStep
// (steps + 1 launches, launch j the product of step j - 1 and the
// elementwise phase of step j; a.carry (B, H) f32)
template <typename T>
inline cudaError_t run_k6_tiles(const CUtensorMap& w_map, BwdArgs a, int sync, int groups,
                                cudaStream_t stream) {
  constexpr int P = Io<T>::kWPieces;
  const int G = a.group;
  if (G < 1 || a.H % G != 0 || a.H / G != kMaxUnits || a.B < 1 || a.steps < 1 ||
      a.scratch == nullptr || a.stages < 2 || a.stages > kMaxStages ||
      smem_bytes(kMaxUnits, P, a.stages) > (size_t)kSmemBudget)
    return cudaErrorInvalidValue;
  const int tiles = (a.B + kRows - 1) / kRows;
  CUtensorMap a_map;
  cudaError_t err = make_a_map(&a_map, a.scratch, a.H, tiles);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(kMaxUnits, P, a.stages);
  if (sync == kSyncGroup) {
    if (a.counters == nullptr || groups < 1 || groups > tiles)
      return cudaErrorInvalidConfiguration;
    return launch_k6(gru_bwd_kernel<T, kMaxUnits / 2, kSyncGroup>, groups, G, smem, stream, w_map,
                     a_map, a, kSyncGroup);
  }
  if (sync != kSyncStep || a.carry == nullptr) return cudaErrorInvalidValue;
  for (int j = 0; j <= a.steps; ++j) {
    a.s_begin = j > 0 ? j - 1 : 0;
    a.s_end = j < a.steps ? j + 1 : a.steps;
    a.skip_first = j > 0;
    a.skip_last = j < a.steps;
    err = launch_k6(gru_bwd_kernel<T, kMaxUnits / 2, kSyncStep>, tiles, G, smem, stream, w_map,
                    a_map, a, kSyncStep);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace bwd90
}  // namespace inpaint
