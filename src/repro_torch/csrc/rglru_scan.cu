// RG-LRU linear-recurrence scan for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rglru_scan.py::rglru_scan_kernel (rglru_scan.py:46):
//
//   h[b, t, w] = a[b, t, w] * h[b, t-1, w] + u[b, t, w],   h[b, -1, w] = h0[b, w]
//
//   a, u  (B, T, W)  float32 (the gates of src/repro/models/recurrent.py)
//   h0    (B, W)     float32, or null for a zero state
//   h     (B, T, W)  float32
//
// The TPU kernel tiles T into VMEM chunks along a sequential grid and
// carries h in VMEM scratch between grid steps.  Hopper blocks run in no
// order, so nothing carries between them: a lane owns one channel (b, w)
// for the whole of T and carries its state in a register.
//
// Numerics.  Each step is rounded twice, the product and then the sum
// (__fmul_rn / __fadd_rn, which nvcc never fuses into an FMA), in the
// sequential order of the plain version
// (src/repro_torch/kernels/ref.py::rglru_scan_ref), so the two agree bit
// for bit.  h0 enters as the state before step 0: round(a0 * h0) + u0 is
// the reference's fold u0 += a0 * h0 (src/repro/kernels/ref.py:86-87).
// No part of the design changes that order: T is never split.
//
// What bounds it on an H100: bytes.  a and u are read once and h written
// once, 12 * B * T * W bytes for 2 flops per element (18.8 us at
// (4, 512, 2560) at 3.35 TB/s).  The recurrence is a dependent chain per
// channel, and there are only B * W channels (10,240 at B = 4, 2,560 at
// B = 1), so the card's bandwidth has to come from loads issued far ahead
// of the step that uses them: at ~0.7 us of DRAM latency, 3.35 TB/s needs
// ~2.3 MB in flight at every moment.  The first port issued 16 steps of
// loads, then ran them, then issued the next 16: loads and arithmetic
// alternated, and at most 1.3 MB was ever in flight (29 % of the bound).
//
// The design:
//   * a warp owns 32 neighbouring channels of one batch row, so each step
//     of a, u and h is one 128-byte line for the warp;
//   * each warp has its own ring of `stages` tiles in shared memory, a
//     tile being STEPS steps x 32 channels of a and of u, and keeps
//     stages - 1 tiles in flight while its lanes run the recurrence out of
//     the oldest: the arithmetic of tile k overlaps the loads of tiles
//     k+1 .. k+stages-1.  The wrapper's plan
//     (kernels/rglru_scan.py::scan_plan) sizes STEPS, stages and warps a
//     block from the shape and the SM count, so that the grid's rings hold
//     several MB in flight within the SMs' shared memory;
//   * where W * 4 and the bases of a, u and h are 16-byte aligned (every
//     model width), the tiles move by TMA: lane 0 loads a tile of a and
//     one of u with two tensor copies (cp.async.bulk.tensor, a tensor map
//     {W, T, B} of (32, STEPS, 1) boxes) that complete on the stage's
//     mbarrier, and stores each tile of h, written to shared memory by the
//     lanes, with one more.  The tensor unit zero-fills a box past T or W
//     and leaves that part out of the store, so a ragged last tile and a
//     ragged last strip need no guards.  The warp waits on the barrier and
//     a __syncwarp: no block barrier anywhere, so the warps of a block
//     never wait on one another (as the Q4_0 decode kernel's k-group warps
//     in q4_gemm.cu);
//   * why TMA and not 16-byte cp.async copies: with one warp an SM, as at
//     B = 1, every instruction of the warp lies on the recurrence's
//     critical path.  A cp.async ring spent ~16 copy instructions a tile
//     with their addresses, and a store a step, and its chain ran at ~27
//     cycles a step (clock stamps on an H100) against ~9 for the bare
//     chain; TMA takes 3 instructions a tile for the loads and one for
//     the store.  Stages of 64 steps halve the per-tile cost again where
//     T allows (B = 1);
//   * the tile is read into registers before the chain (its reads and the
//     writes of h share no address, but the compiler cannot tell), and
//     lane j reads and writes channel j of a step: no bank conflicts;
//   * otherwise (W % 4 != 0, or an unaligned base) the same ring is filled
//     with 4-byte cp.async copies, one channel a lane, released with
//     cp.async.wait_group and __syncwarp, and each lane stores its own
//     results: a slower path for widths no model has.
//
// The tensor maps are encoded on the host at each launch, through
// cuTensorMapEncodeTiled taken from the driver by the runtime
// (cudaGetDriverEntryPoint), so nothing links against libcuda and the
// build flags are the other kernels'.  A launch can be captured in a CUDA
// graph: the maps travel as kernel parameters (__grid_constant__).
//
// The reverse mode (the gradient).  The JAX package has no backward kernel:
// it differentiates jax.lax.associative_scan.  The backward of the
// recurrence is the same recurrence run backwards in T with the gates
// shifted one step,
//
//   c[b, t, w] = a[b, t+1, w] * c[b, t+1, w] + g[b, t, w],   c[b, T, w] = 0
//
// (g = dL/dh, c = dL/du; dL/da and dL/dh0 are products of c with h and a,
// one elementwise pass in the wrapper).  The same kernels run it with
// REVERSE = true: the tiles are taken last first, each tile's steps last
// first, and a lane carries a[t+1] from the step it just ran, so no
// flipped or shifted copy of a or g is ever made and the mode moves the
// forward's 12 * B * T * W bytes.  A tile past T is zero-filled, so its
// steps leave the state at 0 until step T - 1 starts the chain with
// round(0 * 0) + g = g.  Each step is rounded as the forward's are,
// __fmul_rn then __fadd_rn, in the order of the plain version
// (src/repro_torch/kernels/ref.py::rglru_scan_reverse_ref): bit for bit.
//
// Plain C interface, bound with ctypes by src/repro_torch/kernels/rglru_scan.py.

#include <cuda.h>  // CUtensorMap and its enums (types only: not linked)
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxWarps = 4;    // warps a block (the plan's limit)
constexpr int kMaxStages = 16;  // ring stages (the plan's limit)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- the TMA path: tensor-map tiles, mbarriers, bulk groups ------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the initialised barriers visible to the tensor copies (the async proxy)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}

// box (32 channels, STEPS steps, one row) at (w0, t0, b) into shared memory,
// completing `bytes` on the barrier; the box past W or T is zero-filled
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         uint64_t* bar, int w0, int t0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(w0),
      "r"(t0), "r"(b)
      : "memory");
}

// the box from shared memory to (w0, t0, b); the part past W or T is not
// written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const float* src, int w0, int t0,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(w0), "r"(t0), "r"(b)
      : "memory");
}

// this thread's shared-memory writes visible to the tensor copies
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// every bulk group of this thread but the newest N has read its source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Bytes of one warp's shared memory: the ring (stages x [a | u] tiles),
// two h tiles on their way out and a barrier a stage, in 128-byte units
// (a tensor copy's shared address is 128-byte aligned).
__host__ __device__ constexpr size_t warp_smem(int steps, int stages) {
  return ((static_cast<size_t>(2 * stages + 2) * steps * kLanes *
               sizeof(float) +
           stages * sizeof(uint64_t) + 127) /
          128) *
         128;
}

// One warp per (batch row, strip of 32 channels); `strips` = ceil(W / 32).
// Lane 0 issues the tensor copies, every lane waits on the stage's barrier
// and runs its channel.  A last tile past T, and lanes past W, compute on
// zeros that the store leaves out.  REVERSE runs the gradient's recurrence
// (see the header): tile k of the loop is tile tiles - 1 - k of T.
template <int STEPS, bool REVERSE>
__global__ void __launch_bounds__(kMaxWarps * kLanes)
rglru_scan_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_u,
                      const __grid_constant__ CUtensorMap map_h,
                      const float* __restrict__ h0, int B, int T, int W,
                      int strips, int stages) {
  constexpr int kTile = STEPS * kLanes;  // floats of one a, u or h tile
  constexpr unsigned kTileBytes = kTile * sizeof(float);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const long long g =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kLanes) + warp;
  if (g >= static_cast<long long>(B) * strips) return;  // the whole warp
  const int b = static_cast<int>(g / strips);
  const int w0 = static_cast<int>(g % strips) * kLanes;
  const int w = w0 + lane;
  unsigned char* base =
      smem_raw + ((128 - smem_addr(smem_raw) % 128) % 128) +
      static_cast<size_t>(warp) * warp_smem(STEPS, stages);
  float* ring = reinterpret_cast<float*>(base);  // [stages][a | u][kTile]
  float* hout = ring + 2 * stages * kTile;       // [2][kTile]
  uint64_t* bars = reinterpret_cast<uint64_t*>(hout + 2 * kTile);
  const int tiles = (T + STEPS - 1) / STEPS;
  // the first step of the loop's k-th tile
  auto t0_of = [&](int k) { return (REVERSE ? tiles - 1 - k : k) * STEPS; };

  if (lane == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
    mbar_init_fence();
  }
  __syncwarp();
  // tile k into ring slot `at` (k % stages), lane 0 only
  auto issue = [&](int k, int at) {
    if (k < tiles) {
      mbar_expect_tx(&bars[at], 2 * kTileBytes);
      tma_load(ring + at * 2 * kTile, &map_a, &bars[at], w0, t0_of(k), b);
      tma_load(ring + (at * 2 + 1) * kTile, &map_u, &bars[at], w0, t0_of(k),
               b);
    }
  };

  float state = (h0 != nullptr && w < W) ? h0[static_cast<size_t>(b) * W + w]
                                         : 0.f;
  float a_next = 0.f;  // REVERSE: a of the step after the one being run
  if (lane == 0)
    for (int k = 0; k < stages - 1; ++k) issue(k, k);
  // slots of tile k and of tile k + stages - 1, and the parity of tile k's
  // barrier phase, kept as counters (a division per tile is a latency
  // chain of its own)
  int use = 0, fill = stages - 1;
  unsigned parity = 0;
  for (int k = 0; k < tiles; ++k) {
    mbar_wait(&bars[use], parity);  // tile k has landed
    __syncwarp();  // every lane is done with tile k - 1: refill its slot
    if (lane == 0) {
      issue(k + stages - 1, fill);
      bulk_wait_read<1>();  // the store of tile k - 2 has read its h tile
    }
    __syncwarp();
    const float* ta = ring + use * 2 * kTile + lane;
    const float* tu = ta + kTile;
    float* to = hout + (k & 1) * kTile;
    // the tile into registers first: the compiler cannot tell these reads
    // from the writes of h below, and would leave each behind the last
    float ra[STEPS], ru[STEPS];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      ra[i] = ta[i * kLanes];
      ru[i] = tu[i * kLanes];
    }
    if (REVERSE) {
#pragma unroll
      for (int i = STEPS - 1; i >= 0; --i) {
        state = __fadd_rn(__fmul_rn(a_next, state), ru[i]);
        to[i * kLanes + lane] = state;
        a_next = ra[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        state = __fadd_rn(__fmul_rn(ra[i], state), ru[i]);
        to[i * kLanes + lane] = state;
      }
    }
    proxy_fence();  // this lane's h writes, visible to the tensor store
    __syncwarp();
    if (lane == 0) {
      tma_store(&map_h, to, w0, t0_of(k), b);
      bulk_commit();
    }
    if (++use == stages) {
      use = 0;
      parity ^= 1;
    }
    if (++fill == stages) fill = 0;
  }
  if (lane == 0) bulk_wait_all();
}

// ---- the cp.async path: any W and alignment ----------------------------

// cp.async of 4 bytes; src-size 0 zero-fills the destination and reads
// nothing.  No memory clobber: volatile keeps it in order with the commit
// and the wait, and the wait (which has one) keeps the reads of a tile
// after it has landed
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n of this thread's groups are pending; n is the
// launch's stages - 2, uniform over the grid, and wait_group takes only an
// immediate
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    case 12: cp_async_wait<12>(); break;
    case 13: cp_async_wait<13>(); break;
    case 14: cp_async_wait<14>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// One warp per (batch row, strip of 32 channels), as the TMA kernel, with
// the ring in the same place; each lane copies its own channel's steps
// and stores its own results.  REVERSE as in the TMA kernel.
template <int STEPS, bool REVERSE>
__global__ void __launch_bounds__(kMaxWarps * kLanes)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ u,
                  const float* __restrict__ h0, float* __restrict__ h, int B,
                  int T, int W, int strips, int stages) {
  constexpr int kTile = STEPS * kLanes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const long long g =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kLanes) + warp;
  if (g >= static_cast<long long>(B) * strips) return;  // the whole warp
  const int b = static_cast<int>(g / strips);
  const int w = static_cast<int>(g % strips) * kLanes + lane;
  const bool live = w < W;
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((128 - smem_addr(smem_raw) % 128) % 128) +
      static_cast<size_t>(warp) * warp_smem(STEPS, stages));
  const size_t row0 = static_cast<size_t>(b) * T * W;  // (b, 0, 0)
  const int tiles = (T + STEPS - 1) / STEPS;
  auto t0_of = [&](int k) { return (REVERSE ? tiles - 1 - k : k) * STEPS; };

  // tile k into ring slot `at` (k % stages); one commit group per call,
  // empty past the last tile, so that every thread always has stages - 1
  // groups after the prologue
  auto issue = [&](int k, int at) {
    if (k < tiles) {
      float* slot = ring + at * 2 * kTile;
      const int t0 = t0_of(k);
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        const bool ok = live && t0 + i < T;
        const size_t off = ok ? row0 + static_cast<size_t>(t0 + i) * W + w
                              : 0;
        cp_async4(slot + i * kLanes + lane, a + off, ok);
        cp_async4(slot + kTile + i * kLanes + lane, u + off, ok);
      }
    }
    cp_async_commit();
  };

  float state = (h0 != nullptr && live) ? h0[static_cast<size_t>(b) * W + w]
                                        : 0.f;
  float a_next = 0.f;  // REVERSE: a of the step after the one being run
  for (int k = 0; k < stages - 1; ++k) issue(k, k);
  const size_t step = static_cast<size_t>(W);
  int use = 0, fill = stages - 1;
  for (int k = 0; k < tiles; ++k) {
    cp_async_wait_pending(stages - 2);  // this lane's copies of tile k
    __syncwarp();  // every lane is done with tile k - 1: refill its slot
    issue(k + stages - 1, fill);
    const float* ta = ring + use * 2 * kTile + lane;
    const float* tu = ta + kTile;
    const int t0 = t0_of(k);
    const int n = min(STEPS, T - t0);
    float* out = h + row0 + static_cast<size_t>(t0) * step + w;
    if (REVERSE) {
      for (int i = n - 1; i >= 0; --i) {
        state = __fadd_rn(__fmul_rn(a_next, state), tu[i * kLanes]);
        if (live) out[i * step] = state;
        a_next = ta[i * kLanes];
      }
    } else {
      for (int i = 0; i < n; ++i) {
        state = __fadd_rn(__fmul_rn(ta[i * kLanes], state), tu[i * kLanes]);
        if (live) out[i * step] = state;
      }
    }
    if (++use == stages) use = 0;
    if (++fill == stages) fill = 0;
  }
  cp_async_wait<0>();  // no copy outlives the block (all are empty here)
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so that
// nothing links against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// (B, T, W) float32, row-major, as a 3-d map {W, T, B} of (32, steps, 1)
// boxes; needs a 16-byte aligned base and W % 4 == 0
cudaError_t make_map(EncodeTiled encode, CUtensorMap* map, const float* p,
                     int B, int T, int W, int steps) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * sizeof(float),
                                 static_cast<cuuint64_t>(T) * W *
                                     sizeof(float)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kLanes),
                             static_cast<cuuint32_t>(steps), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int STEPS, bool REVERSE>
cudaError_t launch(const float* a, const float* u, const float* h0, float* h,
                   int B, int T, int W, int warps_per_block, int stages,
                   bool tma, cudaStream_t s) {
  const int strips = (W + kLanes - 1) / kLanes;
  const long long warps = static_cast<long long>(B) * strips;
  const unsigned blocks =
      static_cast<unsigned>((warps + warps_per_block - 1) / warps_per_block);
  const size_t smem = 128 + warps_per_block * warp_smem(STEPS, stages);
  const dim3 threads(warps_per_block * kLanes);
  cudaError_t err = cudaSuccess;
  if (tma) {
    EncodeTiled encode;
    CUtensorMap ma, mu, mh;
    err = encoder(&encode);
    if (err == cudaSuccess) err = make_map(encode, &ma, a, B, T, W, STEPS);
    if (err == cudaSuccess) err = make_map(encode, &mu, u, B, T, W, STEPS);
    if (err == cudaSuccess) err = make_map(encode, &mh, h, B, T, W, STEPS);
    auto* kernel = rglru_scan_tma_kernel<STEPS, REVERSE>;
    // above 48 KB a kernel must opt in (a host call, not a stream
    // operation)
    if (err == cudaSuccess && smem > 48 * 1024)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<blocks, threads, smem, s>>>(ma, mu, mh, h0, B, T, W, strips,
                                         stages);
  } else {
    auto* kernel = rglru_scan_kernel<STEPS, REVERSE>;
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<blocks, threads, smem, s>>>(a, u, h0, h, B, T, W, strips,
                                         stages);
  }
  return cudaGetLastError();
}

template <int STEPS>
cudaError_t launch_mode(const float* a, const float* u, const float* h0,
                        float* h, int B, int T, int W, int warps_per_block,
                        int stages, bool reverse, bool tma, cudaStream_t s) {
  return reverse ? launch<STEPS, true>(a, u, h0, h, B, T, W, warps_per_block,
                                       stages, tma, s)
                 : launch<STEPS, false>(a, u, h0, h, B, T, W,
                                        warps_per_block, stages, tma, s);
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 = launched).  Shapes and
// pointers are checked by the Python wrapper; the caller owns every
// buffer.  h0 may be null (zero initial state).  warps_per_block (1-4),
// steps (8, 16, 32 or 64 steps a ring stage) and stages (2-16) are the
// wrapper's plan; anything else is refused with cudaErrorInvalidValue.
// reverse != 0 runs the gradient's recurrence over (a, u = g) into h = c
// (see the header), with h0 null.
int rglru_scan(const void* a, const void* u, const void* h0, void* h, int B,
               int T, int W, int warps_per_block, int steps, int stages,
               int reverse, int device, void* stream) {
  if (warps_per_block < 1 || warps_per_block > kMaxWarps || stages < 2 ||
      stages > kMaxStages || (reverse && h0 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the tensor maps need 16-byte aligned bases and rows
  const bool tma = W % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(u) |
                     reinterpret_cast<uintptr_t>(h)) % 16) == 0;
  const auto* fa = static_cast<const float*>(a);
  const auto* fu = static_cast<const float*>(u);
  const auto* fh0 = static_cast<const float*>(h0);
  auto* fh = static_cast<float*>(h);
  auto s = static_cast<cudaStream_t>(stream);
  const bool rev = reverse != 0;
  switch (steps) {
    case 8:
      err = launch_mode<8>(fa, fu, fh0, fh, B, T, W, warps_per_block, stages,
                           rev, tma, s);
      break;
    case 16:
      err = launch_mode<16>(fa, fu, fh0, fh, B, T, W, warps_per_block,
                            stages, rev, tma, s);
      break;
    case 32:
      err = launch_mode<32>(fa, fu, fh0, fh, B, T, W, warps_per_block,
                            stages, rev, tma, s);
      break;
    case 64:
      err = launch_mode<64>(fa, fu, fh0, fh, B, T, W, warps_per_block,
                            stages, rev, tma, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* rglru_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
