// Hopper (sm_90a) building blocks of the wgmma kernels (encoder_hopper.cuh,
// gru_layer_hopper.cuh, decode_hopper.cuh, gru_fwd_hopper.cuh,
// gru_bwd_hopper.cuh): mbarriers, TMA tile loads, the shared-memory matrix
// descriptors of the 128- and 64-byte swizzles, the warpgroup products
// (wgmma) of 64 x 256, 64 x 96 and 64 x 48 tiles in bf16 -> f32 and
// s8 -> s32 and of 64 x 128, 64 x 64 and 64 x 32 tiles in bf16 -> f32, the
// thread-block cluster pieces (rank, mapa, the cluster barrier, remote
// mbarrier arrivals, bulk copies into a peer's shared memory), and the
// host's tensor-map encoder.
//
// Every operand a wgmma reads from shared memory here is K-major and
// swizzled. With the 128-byte swizzle: rows of 128 bytes (64 bf16 or 128
// int8 values of the reduction dimension), 8-row groups of 1,024 bytes, the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8). With the 64-byte
// swizzle (K4's int8 tiles, so that a 64-unit block of int8 h is one row of
// 64 bytes, as a bf16 one is one row of 128): rows of 64 bytes, 8-row
// groups of 512 bytes, chunk c of row r at chunk c ^ ((r / 2) % 4). A TMA
// load with CU_TENSOR_MAP_SWIZZLE_128B / _64B writes those layouts; code
// that stores into them by hand uses sw128_offset / sw64_offset. Tiles
// start on 1,024-byte boundaries.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing links against libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace inpaint {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy writes to shared memory become visible to the async proxy
// (wgmma operand reads) of the threads that synchronise after this fence
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// generic-proxy writes to global memory (K5's and K6's L2 scratch) become
// visible to later TMA loads (async proxy)
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// the three bf16 pieces of x: x == hi + mid + lo to within 2^-24 of |x|
// (each difference is exact in f32): K5's and K6's split f32 products
__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(p[0]));
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(p[1])));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// named barrier over `count` threads (id 0 is __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// ---------------------------------------------------------------------------
// thread-block clusters
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// the shared::cluster address of shared::cta address `addr` in CTA `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(d) : "r"(addr), "r"(rank));
  return d;
}

// every thread of every CTA of the cluster: arrive (release), then wait
// (acquire). Threads may diverge (not .aligned).
// Hand registers between warpgroups (every warp of the warpgroup runs it;
// the paths must not meet again): a producer gives up to N, a consumer
// takes up to N.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// arrive on the mbarrier at shared::cluster address `bar` (this CTA's or a
// peer's), releasing this thread's prior memory operations at cluster scope
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// mbar_wait for the cluster recurrences (gru_layer_hopper.cuh): acquire at
// cluster scope (for phases that peers complete) or CTA scope, and a
// watchdog: a wait that has not ended after ~2^34 cycles (seconds; no
// legitimate wait comes near) traps, so a broken protocol fails the launch
// instead of hanging the card.
template <bool kCluster>
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  for (int spins = 0;; ++spins) {
    if constexpr (kCluster) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    } else {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    }
    if (done) return;
    if (spins == 0) {
      start = clock64();
    } else if ((spins & 1023) == 0 && clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// ---------------------------------------------------------------------------
// tile groups: the CTAs of a row tile beyond one cluster (K5, K6 and K8 above
// 1,024 units, gru_fwd_hopper.cuh / gru_bwd_hopper.cuh kSyncGroup)
// ---------------------------------------------------------------------------
// How a recurrence's CTAs that share a 64-row tile meet at each step:
// kSyncCluster, a cluster-scope mbarrier (the CTAs form one cluster);
// kSyncGroup, a monotonic release/acquire counter a tile in global memory
// (any CTAs that the card holds at once: the launch is persistent and never
// asks for more); kSyncStep, no meeting inside a launch (one step a launch:
// the launch boundary is the barrier, for groups the card cannot hold at
// once).
enum TileSync { kSyncCluster = 0, kSyncGroup = 1, kSyncStep = 2 };

// add 1 to a tile's counter, releasing this thread's prior memory operations
// (and, through the barrier before it, its CTA's) at GPU scope
__device__ __forceinline__ void group_arrive(unsigned int* counter) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
}

__device__ __forceinline__ unsigned int ld_acquire_gpu(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// wait (acquire) until a tile's counter reaches `target`; as
// mbar_wait_bounded, a wait that has not ended after ~2^34 cycles traps
__device__ __forceinline__ void group_wait_bounded(const unsigned int* counter,
                                                   unsigned int target) {
  long long start = 0;
  for (int spins = 0;; ++spins) {
    if (ld_acquire_gpu(counter) >= target) return;
    if (spins == 0) {
      start = clock64();
    } else if ((spins & 1023) == 0 && clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// the planted fault "the last CTA of a group is late" (kFaultCountShort):
// ~80 us before that CTA writes a step's pieces, so that a consumer counting
// one arrival short reads its pieces of two steps before
__device__ __forceinline__ void late_rank_pause() {
  for (int i = 0; i < 8; ++i) __nanosleep(10000);
}

// the planted faults of a tile group's exchange (the wrappers pass
// kernel_common.group_fault()): the other parity buffer's pieces, or a wait
// for one arrival fewer than the group's CTAs (the last CTA paused)
enum GroupFault { kFaultNone = 0, kFaultOtherParity = 1, kFaultCountShort = 2 };

// CTAs of `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) that the card holds at once when it has the whole card: the
// planner's input for a tile group's persistent launch (the launch itself is
// cooperative, set_tile_launch)
template <typename Kernel>
inline int resident_ctas(Kernel kernel, size_t smem, int threads) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return -1;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return -1;
  return sms * per_sm;
}

// the launch attribute of a recurrence's launch under `sync`: kSyncCluster,
// clusters of `cluster` CTAs; kSyncGroup, a cooperative launch. A group's
// CTAs spin on each other's counters, so they must all be resident at once.
// An occupancy count cannot promise that when the kernel shares the card
// (under MPS, in a green context, beside another kernel on a second
// stream): a cooperative launch makes the runtime promise it, or refuse the
// grid (cudaErrorCooperativeLaunchTooLarge) instead of leaving a producer
// to trap in group_wait_bounded. kSyncStep, neither (no CTA waits on
// another inside a launch).
inline void set_tile_launch(cudaLaunchAttribute& attr, int sync, int cluster) {
  if (sync == kSyncGroup) {
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    return;
  }
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = sync == kSyncCluster ? cluster : 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
}

// copy `bytes` (a multiple of 16) of this CTA's shared memory at `src` to
// shared::cluster address `dst` (a peer's), completing `bytes` transactions
// on the mbarrier at shared::cluster address `bar` in the same CTA as `dst`.
// The source must have been written before a fence_proxy_async.
__device__ __forceinline__ void bulk_copy_to_cluster(uint32_t dst, const void* src,
                                                     uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Byte offset of byte `kbyte` of row `r` in a K-major 128-byte-swizzled
// tile of `rows` rows: the tile is split into k-blocks of 128 bytes, each
// rows x 128 bytes.
__device__ __forceinline__ int sw128_offset(int r, int kbyte, int rows) {
  return (kbyte >> 7) * rows * 128 + r * 128 + ((((kbyte >> 4) & 7) ^ (r & 7)) << 4) +
         (kbyte & 15);
}

// Byte offset of byte `kbyte` of row `r` in a K-major 64-byte-swizzled tile
// of `rows` rows: k-blocks of 64 bytes, each rows x 64 bytes.
__device__ __forceinline__ int sw64_offset(int r, int kbyte, int rows) {
  return (kbyte >> 6) * rows * 64 + r * 64 + ((((kbyte >> 4) & 3) ^ ((r >> 1) & 3)) << 4) +
         (kbyte & 15);
}

// wgmma shared-memory descriptor of a K-major 128-byte-swizzled tile:
// start address >> 4, leading offset 16 bytes (unused by this layout),
// stride 1,024 bytes between 8-row groups, layout 1 = 128-byte swizzle.
// Advancing 32 bytes along K (one k16 bf16 or k32 s8 step) adds 2.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
// ... and of a K-major 64-byte-swizzled one: stride 512 bytes between
// 8-row groups, layout 2 = 64-byte swizzle. A k32 s8 step (32 bytes) adds 2.
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define INPAINT_D128                                                                      \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22," \
  "%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43," \
  "%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64," \
  "%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85," \
  "%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105," \
  "%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122," \
  "%123,%124,%125,%126,%127}"
#define INPAINT_D64                                                                          \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"  \
  "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45," \
  "%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}"
#define INPAINT_D48                                                                          \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"  \
  "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45," \
  "%46,%47}"
#define INPAINT_D32                                                                          \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"  \
  "%24,%25,%26,%27,%28,%29,%30,%31}"
#define INPAINT_D24                                                                         \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23}"
#define INPAINT_D16 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}"
#define INPAINT_OPS8(C, i)                                                                   \
  C(d[(i)]), C(d[(i) + 1]), C(d[(i) + 2]), C(d[(i) + 3]), C(d[(i) + 4]), C(d[(i) + 5]),      \
      C(d[(i) + 6]), C(d[(i) + 7])
#define INPAINT_OPS96(C)                                                                     \
  INPAINT_OPS8(C, 0), INPAINT_OPS8(C, 8), INPAINT_OPS8(C, 16), INPAINT_OPS8(C, 24),          \
      INPAINT_OPS8(C, 32), INPAINT_OPS8(C, 40), INPAINT_OPS8(C, 48), INPAINT_OPS8(C, 56),    \
      INPAINT_OPS8(C, 64), INPAINT_OPS8(C, 72), INPAINT_OPS8(C, 80), INPAINT_OPS8(C, 88)
#define INPAINT_OPS48(C)                                                                     \
  INPAINT_OPS8(C, 0), INPAINT_OPS8(C, 8), INPAINT_OPS8(C, 16), INPAINT_OPS8(C, 24),          \
      INPAINT_OPS8(C, 32), INPAINT_OPS8(C, 40)
#define INPAINT_OPS64(C)                                                                     \
  INPAINT_OPS48(C), INPAINT_OPS8(C, 48), INPAINT_OPS8(C, 56)
#define INPAINT_OPS32(C) \
  INPAINT_OPS8(C, 0), INPAINT_OPS8(C, 8), INPAINT_OPS8(C, 16), INPAINT_OPS8(C, 24)
#define INPAINT_OPS16(C) INPAINT_OPS8(C, 0), INPAINT_OPS8(C, 8)
#define INPAINT_OPS24(C) INPAINT_OPS16(C), INPAINT_OPS8(C, 16)
#define INPAINT_OPS128(C)                                                                    \
  INPAINT_OPS96(C), INPAINT_OPS8(C, 96), INPAINT_OPS8(C, 104), INPAINT_OPS8(C, 112),         \
      INPAINT_OPS8(C, 120)
#define INPAINT_F(x) "+f"(x)
#define INPAINT_R(x) "+r"(x)

// d (64 x 256, f32) = A (64 x 16, bf16) @ B (16 x 256, bf16) [+ d] and its
// s8 twin d (64 x 256, s32) = A (64 x 32, s8) @ B (32 x 256, s8) [+ d]: A
// and B K-major in shared memory (descriptors above), d in the accumulator
// fragment: d[i] holds row 16 * warp + lane / 4 + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the warpgroup's tile.
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " INPAINT_D128
      ", %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : INPAINT_OPS128(INPAINT_F)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " INPAINT_D128
      ", %128, %129, p;\n"
      "}\n"
      : INPAINT_OPS128(INPAINT_R)
      : "l"(da), "l"(db), "r"(accumulate));
}

// the 64 x 96 tiles of both: d[i] as above, 48 registers
__device__ __forceinline__ void wgmma_bf16_n96(float (&d)[48], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " INPAINT_D48
      ", %48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : INPAINT_OPS48(INPAINT_F)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_s8_n96(int (&d)[48], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 " INPAINT_D48
      ", %48, %49, p;\n"
      "}\n"
      : INPAINT_OPS48(INPAINT_R)
      : "l"(da), "l"(db), "r"(accumulate));
}

// the 64 x 48 tiles (K2's and K4's head): d[i] as above, 24 registers
__device__ __forceinline__ void wgmma_bf16_n48(float (&d)[24], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 " INPAINT_D24
      ", %24, %25, p, 1, 1, 0, 0;\n"
      "}\n"
      : INPAINT_OPS24(INPAINT_F)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_s8_n48(int (&d)[24], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 " INPAINT_D24
      ", %24, %25, p;\n"
      "}\n"
      : INPAINT_OPS24(INPAINT_R)
      : "l"(da), "l"(db), "r"(accumulate));
}

// the 64 x 128, 64 x 64 and 64 x 32 bf16 tiles: d[i] as above, 64, 32 and
// 16 registers
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " INPAINT_D64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : INPAINT_OPS64(INPAINT_F)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " INPAINT_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : INPAINT_OPS32(INPAINT_F)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[16], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " INPAINT_D16
      ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : INPAINT_OPS16(INPAINT_F)
      : "l"(da), "l"(db), "r"(accumulate));
}

// One 128-byte k-slab of the product: four wgmma steps of 32 bytes.
__device__ __forceinline__ void mma_slab(float (&d)[128], uint64_t da, uint64_t db,
                                         bool accumulate) {
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_bf16_n256(d, da + 2 * s, db + 2 * s, (accumulate || s) ? 1 : 0);
}
__device__ __forceinline__ void mma_slab(int (&d)[128], uint64_t da, uint64_t db,
                                         bool accumulate) {
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_s8_n256(d, da + 2 * s, db + 2 * s, (accumulate || s) ? 1 : 0);
}

__device__ __forceinline__ void mma_slab(float (&d)[48], uint64_t da, uint64_t db,
                                         bool accumulate) {
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_bf16_n96(d, da + 2 * s, db + 2 * s, (accumulate || s) ? 1 : 0);
}
__device__ __forceinline__ void mma_slab(int (&d)[48], uint64_t da, uint64_t db,
                                         bool accumulate) {
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_s8_n96(d, da + 2 * s, db + 2 * s, (accumulate || s) ? 1 : 0);
}

// One 64-byte k-slab of an s8 product on 64-byte-swizzled operands (K4's):
// two wgmma steps of 32 bytes.
__device__ __forceinline__ void mma_slab64(int (&d)[48], uint64_t da, uint64_t db,
                                           bool accumulate) {
#pragma unroll
  for (int s = 0; s < 2; ++s) wgmma_s8_n96(d, da + 2 * s, db + 2 * s, (accumulate || s) ? 1 : 0);
}
__device__ __forceinline__ void mma_slab64(int (&d)[24], uint64_t da, uint64_t db,
                                           bool accumulate) {
#pragma unroll
  for (int s = 0; s < 2; ++s) wgmma_s8_n48(d, da + 2 * s, db + 2 * s, (accumulate || s) ? 1 : 0);
}
__device__ __forceinline__ void mma_slab(float (&d)[24], uint64_t da, uint64_t db,
                                         bool accumulate) {
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_bf16_n48(d, da + 2 * s, db + 2 * s, (accumulate || s) ? 1 : 0);
}

__device__ __forceinline__ void mma_slab(float (&d)[64], uint64_t da, uint64_t db,
                                         bool accumulate) {
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_bf16_n128(d, da + 2 * s, db + 2 * s, (accumulate || s) ? 1 : 0);
}
__device__ __forceinline__ void mma_slab(float (&d)[32], uint64_t da, uint64_t db,
                                         bool accumulate) {
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_bf16_n64(d, da + 2 * s, db + 2 * s, (accumulate || s) ? 1 : 0);
}
__device__ __forceinline__ void mma_slab(float (&d)[16], uint64_t da, uint64_t db,
                                         bool accumulate) {
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_bf16_n32(d, da + 2 * s, db + 2 * s, (accumulate || s) ? 1 : 0);
}

#undef INPAINT_F
#undef INPAINT_R
#undef INPAINT_OPS48
#undef INPAINT_OPS128
#undef INPAINT_D128
#undef INPAINT_OPS96
#undef INPAINT_OPS8
#undef INPAINT_D48
#undef INPAINT_D32
#undef INPAINT_D16
#undef INPAINT_OPS32
#undef INPAINT_OPS64
#undef INPAINT_D64
#undef INPAINT_OPS16
#undef INPAINT_OPS24
#undef INPAINT_D24

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (so the
// library needs no link against libcuda)
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a row-major array of `rank` (at most 5) dims (dims
// innermost first, strides in bytes of dims 1..rank-1), loading boxes of
// `box` with the 128-byte swizzle (box[0] * element size must be 128) or
// the one given (64 bytes: 64), and zero fill past the edges.
static inline cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                                   const void* ptr, const uint64_t* dims,
                                   const uint64_t* strides, const uint32_t* box,
                                   CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || rank < 1 || rank > 5) return cudaErrorNotSupported;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5] = {1, 1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
  }
  for (int i = 0; i + 1 < rank; ++i) s[i] = strides[i];
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(ptr), d, s, b, e,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace inpaint
