// Q4_0 dequantize + matrix product for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/q4_gemm.py::q4_gemm
// (q4_gemm.py:62):
//
//   out (M, N) = x (M, K) @ W,   W[k, n] = (code[k, n] - 8) * scales[k / 32, n]
//
//   x       (M, K)     float32 or bfloat16
//   packed  (K/2, N)   uint8, two 4-bit codes per byte: low nibble = even k
//   scales  (K/32, N)  float32 (fp16-representable, see quant/q4_0.py)
//   out     (M, N)     same type as x
//
// Products are exact and sums are float32; the float32 result is rounded to
// out's type (round to nearest even) on store, so the model's bf16 path
// needs no conversion launches around the kernel.  Each weight equals the
// reference's dequantized value; only the summation order differs.
//
// What bounds it on an H100.  At decode (M = 8) it is bytes: the packed
// codes and scales, read once, are 0.5625 B/weight and dwarf x and out;
// 2*M flops per weight against 0.5625 bytes is ~28 flops/byte, far below
// the ~295 the card needs before its arithmetic is the limit.  At the
// 128-row prefill chunks the ratio is ~455 flops/byte and the bound moves
// to operations: 2*128*2048*6144 = 3.2 GFLOP for w_gate is 3.26 us at the
// bf16 tensor-core peak, but 48 us at the 67 TFLOP/s of the CUDA cores, so
// only the tensor cores can come near it.  Two paths:
//
// bf16 x (what --quant q4 serves): on the tensor cores, q4_decode_kernel
// at M <= 8 and q4_mma_kernel above.
//   * (code - 8) is an integer in [-8, 7], exact in bf16, and so is every
//     product with a bf16 x.  A byte of `packed` holds the codes of k and
//     k + 1 of one column, which is exactly one bf16x2 register of an
//     mma.sync.m16n8k16 A fragment; it becomes two bf16 (code - 8) with a
//     byte permute, one logic op (the nibbles under the bf16 exponent of
//     128) and one bf16x2 fma (- 136).  Operands are swapped so that N
//     fills the MMA's 16 rows and M its 8 columns: out^T = W^T x^T, the
//     decode step's M = 8 one MMA column tile.
//   * per-block scaling stays exact and per block: the two k16 MMAs of a
//     32-k Q4_0 block sum into a zeroed f32 fragment, which is multiplied
//     by the block's column scales and added to the running f32 total;
//   * K streams in stages of 64 k (2 Q4_0 blocks) through 4-deep rings of
//     16-byte cp.async copies (4-byte ones when N is not a multiple of
//     16): codes, scales and the x tile, x rows padded to 144 bytes so
//     that the fragment loads hit 32 banks; a stage past K is zero-filled;
//   * split-K fills the card: the wrapper (kernels/q4_gemm.py::q4_plan)
//     cuts K into n_split <= 16 slices, enough for about Q4_BLOCKS_PER_SM
//     blocks an SM, none shorter than the stages that pay for its partial
//     tile.  The n_split blocks of one output tile form a thread-block
//     cluster: each leaves its f32 partial in its shared memory, and after
//     a cluster barrier each sums a run of the tile over the cluster in
//     rank order through distributed shared memory and rounds it to bf16.
//     One launch, no scratch in device memory, no float atomics: two calls
//     give the same bits;
//   * M > 8 (prefill chunks): a block (4 warps) takes 128 columns x 8*WM
//     rows of x (WM = 2, 4 or 8: up to 64 rows), each warp 32 columns, one
//     ring for the block (code rows padded to 160 bytes); the weight tile
//     is dequantized once a stage for all 8*WM rows, so it is read once
//     per 64 rows.  w_gate at M = 128 runs at ~9x its operation bound;
//   * M <= 8 (decode): bytes do not bound it on the card, latency does.  A
//     call is the first touch of the weights (address translation and
//     DRAM before any data lands), a chain of dependent steps per stage
//     and the barriers.  So a block takes only 32 columns and its 4
//     warps are k-groups over them (warp kg takes the slice's stages kg,
//     kg + 4, ...), each with its own ring, so the loop has a __syncwarp
//     and no block barrier; the warps' partials are summed in warp order
//     in shared memory before the cluster reduce.  w_k / w_v (N = 1024)
//     run as 32 x 8 = 256 blocks, where the CUDA-core kernel ran 32;
//   * mma.sync, not wgmma: the A operand is made in registers by the
//     dequantization, which mma.sync takes as it is; wgmma would need the
//     dequantized tile written back to shared memory in its swizzled
//     layout (or a register A of a 64-row warpgroup tile) and a warpgroup
//     per 64 columns, a larger design left for later; at decode the MMA
//     rate does not matter.
//
// f32 x: q4_gemm_kernel, on the CUDA cores, exact in f32 (rounding x to
// bf16 would break the f32 tolerance).  A block takes 32 columns and 8 rows
// of x over the whole of K with 256 threads: 8 along N (4 columns each) by
// 32 along K, each owning one Q4_0 block of a 1024-k chunk (16 independent
// 32-bit loads of packed rows issued before the x chunk is staged), x
// staged through shared memory widened to f32, and the 32 K-threads'
// partial sums meeting in shared memory at the end.
//
// Plain C interface, bound with ctypes by src/repro_torch/kernels/q4_gemm.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- f32 x: the CUDA-core kernel ------------------------------------------

constexpr int kThreads = 256;
constexpr int kLX = 8;                 // threads along N, 4 columns each
constexpr int kKY = kThreads / kLX;    // threads along K, one block each
constexpr int kCols = 4 * kLX;         // columns per block
constexpr int kMT = 8;                 // rows of x per block
constexpr int kBlock = 32;             // Q4_0 block: k rows per scale
constexpr int kKC = kKY * kBlock;      // k per chunk
constexpr int kPad = 2;                // floats of padding per 32 k of x
constexpr int kRow = kKC + kKC / kBlock * kPad;  // padded x row in smem
constexpr int kSmem = kMT * kRow > kKY * kMT * kCols ? kMT * kRow
                                                     : kKY * kMT * kCols;
static_assert(kMT * kCols == kThreads, "one output per thread at the end");

// 16 bytes of x: 4 floats
__device__ __forceinline__ void load_x(const float* p, float* out) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x;
  out[1] = r.y;
  out[2] = r.z;
  out[3] = r.w;
}

__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }

template <typename TX>
__global__ void __launch_bounds__(kThreads)
q4_gemm_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ packed,
               const float* __restrict__ scales, TX* __restrict__ out, int M,
               int K, int N) {
  constexpr int XV = 16 / sizeof(TX);  // elements of x per 16-byte load
  // the x chunk (kMT padded rows) while the products run, then the
  // partial sums (kKY x kMT x kCols)
  __shared__ __align__(16) float smem[kSmem];
  const int tid = threadIdx.x;
  const int lx = tid % kLX, ky = tid / kLX;
  const int n0 = blockIdx.x * kCols + lx * 4;
  const int m0 = blockIdx.y * kMT;
  const bool cols_ok = n0 < N;  // N % 4 == 0: all four columns or none

  float acc[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kc = min(kKC, K - k0);  // a multiple of 32
    const bool mine = cols_ok && ky < kc / kBlock;
    // this thread's Q4_0 block: 4 scales and 16 packed rows of 4 columns
    const int blk = k0 / kBlock + ky;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    uint32_t w[kBlock / 2];
    if (mine) {
      s = *reinterpret_cast<const float4*>(
          scales + static_cast<size_t>(blk) * N + n0);
      const uint8_t* prow =
          packed + static_cast<size_t>(blk) * (kBlock / 2) * N + n0;
#pragma unroll
      for (int j = 0; j < kBlock / 2; ++j)
        w[j] = *reinterpret_cast<const uint32_t*>(
            prow + static_cast<size_t>(j) * N);
    }
    __syncthreads();  // the last chunk's readers of smem are done
    const int row_vecs = kc / XV;
#pragma unroll 4
    for (int i = tid; i < kMT * row_vecs; i += kThreads) {
      const int m = i / row_vecs, k = (i - m * row_vecs) * XV;
      float v[XV];
      if (m0 + m < M) {
        load_x(x + static_cast<size_t>(m0 + m) * K + k0 + k, v);
      } else {
#pragma unroll
        for (int e = 0; e < XV; ++e) v[e] = 0.f;
      }
      float* dst = smem + m * kRow + k + k / kBlock * kPad;
#pragma unroll
      for (int e = 0; e < XV; e += 2)
        *reinterpret_cast<float2*>(dst + e) = make_float2(v[e], v[e + 1]);
    }
    __syncthreads();
    if (mine) {
      const float sc[4] = {s.x, s.y, s.z, s.w};
      const float* xb = smem + ky * (kBlock + kPad);  // row 0, this block
#pragma unroll
      for (int j = 0; j < kBlock / 2; ++j) {  // k pair 2j, 2j + 1
        float wl[4], wh[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t b = (w[j] >> (8 * c)) & 0xffu;  // column n0 + c
          wl[c] = static_cast<float>(static_cast<int>(b & 15u) - 8) * sc[c];
          wh[c] = static_cast<float>(static_cast<int>(b >> 4) - 8) * sc[c];
        }
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          const float2 xv =
              *reinterpret_cast<const float2*>(xb + m * kRow + 2 * j);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[m][c] = fmaf(xv.y, wh[c], fmaf(xv.x, wl[c], acc[m][c]));
        }
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      smem[(ky * kMT + m) * kCols + lx * 4 + c] = acc[m][c];
  __syncthreads();
  const int m = tid / kCols, col = tid % kCols;
  float sum = 0.f;
#pragma unroll 8
  for (int y = 0; y < kKY; ++y) sum += smem[(y * kMT + m) * kCols + col];
  const int n = blockIdx.x * kCols + col;
  if (m0 + m < M && n < N)
    store_one(out + static_cast<size_t>(m0 + m) * N + n, sum);
}

// ---- bf16 x: the tensor-core kernel ---------------------------------------

constexpr int kMmaThreads = 128;             // 4 warps along N
constexpr int kMmaCols = 128;                // columns per block, 32 a warp
constexpr int kStageK = 64;                  // k per ring stage: 2 Q4_0 blocks
constexpr int kMaxCluster = 16;              // K slices of one output tile

constexpr int kRing = 4;                     // ring depth (stages)
constexpr int kCodeRow = 160;                // bytes per padded code row
constexpr int kCodeBytes = kStageK / 2 * kCodeRow;       // 32 code rows
constexpr int kScaleBytes = kStageK / kBlock * kMmaCols * 4;
constexpr int kXRow = kStageK * 2 + 16;      // bytes per padded x row

__host__ __device__ constexpr int stage_bytes(int bm) {
  return kCodeBytes + kScaleBytes + bm * kXRow;
}

// cp.async of 16 or 4 bytes (L2 only for 16); src-size 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte b of w (codes of k and k + 1 of one column) -> bf16x2 (code_lo - 8,
// code_hi - 8): the two nibbles go under the bf16 bits of 128.0 (0x4300,
// whose 7 mantissa bits count units), and one exact bf16x2 fma subtracts
// 136 = 128 + 8
__device__ __forceinline__ uint32_t dequant_pair(uint32_t w, uint32_t w4,
                                                 int b) {
  // bytes: [w_b, -, (w >> 4)_b, -]: low nibble at bits 0-3, high at 16-19
  const uint32_t t = __byte_perm(w, w4, b | ((4 + b) << 8));
  const uint32_t r = (t & 0x000F000Fu) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));  // r * 1 - 136
  return d;
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b, const float* c) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// out[m][n .. n + 3] = v rounded to bf16, where the output has them (N % 4
// == 0: all four columns or none)
__device__ __forceinline__ void store_bf16x4(uint16_t* out, int M, int N,
                                             int m, int n, float4 v) {
  if (m >= M || n >= N) return;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 pk;
  pk.x = *reinterpret_cast<const uint32_t*>(&lo);
  pk.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out + static_cast<size_t>(m) * N + n) = pk;
}

// The K slices of one output tile are the blocks of a cluster (gridDim.z of
// them, rank blockIdx.z), each with its f32 partial tile (bm x cols, at the
// output's rows m0.. and columns n0..) in its shared memory at `tile`.  After
// a cluster barrier block z takes the z-th of n_split equal runs of the
// tile's groups of 4 outputs; a thread reads a group from 4 tiles at a time
// through distributed shared memory (the 4 reads in flight together), sums
// the tiles in rank order and writes the group; a second barrier keeps
// every tile alive until all are read.
__device__ void cluster_reduce(const float* tile, uint16_t* out, int M,
                               int N, int m0, int n0, int bm, int cols,
                               int threads) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partial is in its shared memory
  const int n_split = gridDim.z, rank = blockIdx.z;
  const int groups = bm * cols / 4;
  const int run = (groups + n_split - 1) / n_split;
  const int end = min(groups, (rank + 1) * run);
  for (int q4 = rank * run + static_cast<int>(threadIdx.x); q4 < end;
       q4 += threads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = 0; r0 < n_split; r0 += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)  // clamped: always a tile of the cluster
        p[i] = reinterpret_cast<const float4*>(cluster.map_shared_rank(
            tile, static_cast<unsigned>(min(r0 + i, n_split - 1))))[q4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool on = r0 + i < n_split;
        v.x += on ? p[i].x : 0.f;
        v.y += on ? p[i].y : 0.f;
        v.z += on ? p[i].z : 0.f;
        v.w += on ? p[i].w : 0.f;
      }
    }
    store_bf16x4(out, M, N, m0 + q4 * 4 / cols, n0 + q4 * 4 % cols, v);
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// Block (nb, mb, z): columns [nb * 128, +128), rows [mb * 8WM, +8WM), the
// stages [z * sps, (z + 1) * sps) of K.  Warp w owns columns 32w .. 32w + 31
// of the block: thread (g = lane / 4, t = lane % 4) holds columns 4g .. 4g + 3
// of them, as rows g and g + 8 of two m16 MMA tiles (tile j, row g <-> column
// 4g + 2j, row g + 8 <-> 4g + 2j + 1), so that its A fragment is one 32-bit
// word per code row; x's k order is untouched.  With n_split > 1 the
// blocks (nb, mb, 0 .. n_split - 1) form one thread-block cluster: each
// leaves its f32 partial tile in its own shared memory, and after a
// cluster barrier block z sums its share of the tile over the cluster's
// blocks in block order, through distributed shared memory, and writes it.
template <int WM>
__global__ void __launch_bounds__(kMmaThreads)
q4_mma_kernel(const uint16_t* __restrict__ x,
              const uint8_t* __restrict__ packed,
              const float* __restrict__ scales, uint16_t* __restrict__ out,
              int M, int K, int N, int sps, int vec16) {
  constexpr int BM = 8 * WM;
  constexpr int SB = stage_bytes(BM);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kMmaCols, m0 = blockIdx.y * BM;
  const int n_stages = (K + kStageK - 1) / kStageK;
  const int st0 = blockIdx.z * sps;
  const int n_it = min(sps, n_stages - st0);
  auto issue = [&](int it, int slot) {
    unsigned char* sm = smem_raw + slot * SB;
    const int k0 = (st0 + it) * kStageK;
    // codes: 32 rows x 128 bytes, 16-byte chunks (4-byte ones when N is
    // not a multiple of 16, whose rows are then not 16-byte aligned)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kMmaThreads;
      const int r = c >> 3, cc = (c & 7) * 16;
      const int kp = k0 / 2 + r, n = n0 + cc;
      const uint8_t* src = packed + static_cast<size_t>(kp) * N + n;
      unsigned char* dst = sm + r * kCodeRow + cc;
      const bool row_ok = kp < K / 2;
      if (vec16) {
        cp_async16(dst, row_ok && n < N ? src : packed, row_ok && n < N);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = row_ok && n + 4 * q < N;
          cp_async4(dst + 4 * q, ok ? src + 4 * q : packed, ok);
        }
      }
    }
    // scales: 2 rows x 128 floats
    if (tid < kStageK / kBlock * kMmaCols / 4) {
      const int r = tid >> 5, n = n0 + (tid & 31) * 4;
      const int kb = k0 / kBlock + r;
      const bool ok = kb < K / kBlock && n < N;
      cp_async16(sm + kCodeBytes + r * kMmaCols * 4 + (tid & 31) * 16,
                 ok ? scales + static_cast<size_t>(kb) * N + n : scales, ok);
    }
    // x: BM rows x 64 k (8 chunks a row)
#pragma unroll
    for (int c = tid; c < BM * 8; c += kMmaThreads) {
      const int r = c >> 3, kc = k0 + (c & 7) * 8;
      const bool ok = m0 + r < M && kc < K;
      cp_async16(sm + kCodeBytes + kScaleBytes + r * kXRow + (c & 7) * 16,
                 ok ? x + static_cast<size_t>(m0 + r) * K + kc : x, ok);
    }
  };

  float acc[WM][2][4];
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < n_it) issue(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // stage it landed for all; stage it - 1 is consumed
    if (it + kRing - 1 < n_it) issue(it + kRing - 1, (it + kRing - 1) % kRing);
    cp_async_commit();
    const unsigned char* sm = smem_raw + (it % kRing) * SB;
    const int k0 = (st0 + it) * kStageK;
#pragma unroll
    for (int qb = 0; qb < kStageK / kBlock; ++qb) {
      // A fragments: code rows 16 qb + t + 4i, i = 0..3 (i / 2 = the k16
      // step, i % 2 = k pair t or t + 4 of it); byte b of a word is column
      // 4g + b
      uint32_t a[2][2][4];  // [tile j][step s][register]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            sm + (16 * qb + t + 4 * i) * kCodeRow + warp * 32 + 4 * g);
        const uint32_t w4 = w >> 4;
        const int s = i >> 1, hi = (i & 1) * 2;  // a0/a1 or a2/a3
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          a[j][s][hi] = dequant_pair(w, w4, 2 * j);          // row g
          a[j][s][hi + 1] = dequant_pair(w, w4, 2 * j + 1);  // row g + 8
        }
      }
      const float4 sc = *reinterpret_cast<const float4*>(
          sm + kCodeBytes + qb * kMmaCols * 4 + (warp * 32 + 4 * g) * 4);
      const float scl[2][2] = {{sc.x, sc.y}, {sc.z, sc.w}};  // [j][row]
      const unsigned char* xs = sm + kCodeBytes + kScaleBytes;
#pragma unroll
      for (int mt = 0; mt < WM; ++mt) {
        uint32_t bx[2][2];  // [step s][register]: x[m][k], k = 2t (+8)
        const unsigned char* xr = xs + (mt * 8 + g) * kXRow + qb * 64;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          bx[s][0] = *reinterpret_cast<const uint32_t*>(xr + s * 32 + 4 * t);
          bx[s][1] =
              *reinterpret_cast<const uint32_t*>(xr + s * 32 + 16 + 4 * t);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // the Q4_0 block's sum, exact products in f32, then its scales
          const float zero[4] = {0.f, 0.f, 0.f, 0.f};
          float blk[4];
          mma_bf16(blk, a[j][0], bx[0], zero);
          mma_bf16(blk, a[j][1], bx[1], blk);
          acc[mt][j][0] = fmaf(blk[0], scl[j][0], acc[mt][j][0]);
          acc[mt][j][1] = fmaf(blk[1], scl[j][0], acc[mt][j][1]);
          acc[mt][j][2] = fmaf(blk[2], scl[j][1], acc[mt][j][2]);
          acc[mt][j][3] = fmaf(blk[3], scl[j][1], acc[mt][j][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // thread (g, t) holds rows m = 8mt + 2t + {0, 1} of columns 4g .. 4g + 3
  // of its warp's 32
  const int nl = warp * 32 + 4 * g;  // column within the block
  if (gridDim.z == 1) {
#pragma unroll
    for (int mt = 0; mt < WM; ++mt)
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
        store_bf16x4(out, M, N, m0 + mt * 8 + 2 * t + mm, n0 + nl,
                     make_float4(acc[mt][0][mm], acc[mt][0][2 + mm],
                                 acc[mt][1][mm], acc[mt][1][2 + mm]));
    return;
  }
  // the partial tile (BM x 128 f32) into this block's ring bytes
  __syncthreads();  // every warp is done with the ring
  float* tile = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
      *reinterpret_cast<float4*>(tile + (mt * 8 + 2 * t + mm) * kMmaCols +
                                 nl) =
          make_float4(acc[mt][0][mm], acc[mt][0][2 + mm], acc[mt][1][mm],
                      acc[mt][1][2 + mm]);
  cluster_reduce(tile, out, M, N, m0, n0, BM, kMmaCols, kMmaThreads);
}

// ---- bf16 x, M <= 8: the decode kernel -------------------------------------
//
// At M = 8 a stage's MMAs are few and the time goes to latency: the first
// touch of a weight, then a chain of dependent steps per stage, then the
// block and cluster barriers.  So a block takes only 32 columns, its 4 warps
// are k-groups over them (warp kg takes stages kg, kg + 4, ... of the
// block's slice), and each warp walks its stages through its own 4-deep
// cp.async ring (its codes in 32-byte rows, its 2 x 32 scales, its 8-row x
// tile): the loop needs a __syncwarp, no block barrier.  The 4 partials are
// summed in warp order in shared memory, then the cluster reduces the
// slices.  A warp's fragments are those of q4_mma_kernel with one 32-column
// warp tile.

constexpr int kDecCols = 32;                             // columns a block
constexpr int kDecWarps = 4;                             // k-groups a block
constexpr int kDecRing = 4;                              // stages a warp
constexpr int kDecScale = kStageK / 2 * kDecCols;        // 1024: codes
constexpr int kDecX = kDecScale + kStageK / kBlock * kDecCols * 4;  // 1280
constexpr int kDecStage = kDecX + 8 * kXRow;             // 2432 bytes

__global__ void __launch_bounds__(32 * kDecWarps)
q4_decode_kernel(const uint16_t* __restrict__ x,
                 const uint8_t* __restrict__ packed,
                 const float* __restrict__ scales, uint16_t* __restrict__ out,
                 int M, int K, int N, int sps, int vec16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, kg = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kDecCols;
  const int n_stages = (K + kStageK - 1) / kStageK;
  const int st0 = blockIdx.z * sps;
  const int n_it = min(sps, n_stages - st0);
  const int n_mine = n_it > kg ? (n_it - kg + kDecWarps - 1) / kDecWarps : 0;
  unsigned char* ring = smem_raw + kg * kDecRing * kDecStage;

  // this warp's i-th stage (st0 + kg + 4 i) into its ring slot `slot`
  auto issue = [&](int i, int slot) {
    unsigned char* sm = ring + slot * kDecStage;
    const int k0 = (st0 + kg + kDecWarps * i) * kStageK;
#pragma unroll
    for (int c = lane; c < 64; c += 32) {  // codes: 32 rows x 32 bytes
      const int r = c >> 1, n = n0 + (c & 1) * 16;
      const int kp = k0 / 2 + r;
      const uint8_t* src = packed + static_cast<size_t>(kp) * N + n;
      unsigned char* dst = sm + r * kDecCols + (c & 1) * 16;
      const bool row_ok = kp < K / 2;
      if (vec16) {
        cp_async16(dst, row_ok && n < N ? src : packed, row_ok && n < N);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = row_ok && n + 4 * q < N;
          cp_async4(dst + 4 * q, ok ? src + 4 * q : packed, ok);
        }
      }
    }
    if (lane < 16) {  // scales: 2 rows x 32 floats
      const int r = lane >> 3, n = n0 + (lane & 7) * 4;
      const int kb = k0 / kBlock + r;
      const bool ok = kb < K / kBlock && n < N;
      cp_async16(sm + kDecScale + r * kDecCols * 4 + (lane & 7) * 16,
                 ok ? scales + static_cast<size_t>(kb) * N + n : scales, ok);
    }
#pragma unroll
    for (int c = lane; c < 64; c += 32) {  // x: 8 rows x 64 k
      const int m = c >> 3, kc = k0 + (c & 7) * 8;
      const bool ok = m < M && kc < K;
      cp_async16(sm + kDecX + m * kXRow + (c & 7) * 16,
                 ok ? x + static_cast<size_t>(m) * K + kc : x, ok);
    }
  };

  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kDecRing - 1; ++s) {
    if (s < n_mine) issue(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<kDecRing - 2>();
    __syncwarp();  // stage i landed for the warp; stage i - 1 is consumed
    if (i + kDecRing - 1 < n_mine)
      issue(i + kDecRing - 1, (i + kDecRing - 1) % kDecRing);
    cp_async_commit();
    const unsigned char* sm = ring + (i % kDecRing) * kDecStage;
#pragma unroll
    for (int qb = 0; qb < kStageK / kBlock; ++qb) {
      uint32_t a[2][2][4];  // [tile j][step s][register], as q4_mma_kernel
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            sm + (16 * qb + t + 4 * q) * kDecCols + 4 * g);
        const uint32_t w4 = w >> 4;
        const int st = q >> 1, hi = (q & 1) * 2;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          a[j][st][hi] = dequant_pair(w, w4, 2 * j);
          a[j][st][hi + 1] = dequant_pair(w, w4, 2 * j + 1);
        }
      }
      const float4 sc = *reinterpret_cast<const float4*>(
          sm + kDecScale + qb * kDecCols * 4 + 16 * g);
      const float scl[2][2] = {{sc.x, sc.y}, {sc.z, sc.w}};
      const unsigned char* xr = sm + kDecX + g * kXRow + qb * 64;
      uint32_t bx[2][2];
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        bx[st][0] = *reinterpret_cast<const uint32_t*>(xr + st * 32 + 4 * t);
        bx[st][1] =
            *reinterpret_cast<const uint32_t*>(xr + st * 32 + 16 + 4 * t);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float zero[4] = {0.f, 0.f, 0.f, 0.f};
        float blk[4];
        mma_bf16(blk, a[j][0], bx[0], zero);
        mma_bf16(blk, a[j][1], bx[1], blk);
        acc[j][0] = fmaf(blk[0], scl[j][0], acc[j][0]);
        acc[j][1] = fmaf(blk[1], scl[j][0], acc[j][1]);
        acc[j][2] = fmaf(blk[2], scl[j][1], acc[j][2]);
        acc[j][3] = fmaf(blk[3], scl[j][1], acc[j][3]);
      }
    }
  }
  cp_async_wait<0>();

  // the 4 warps' partials, summed in warp order: part [4][8][32], then the
  // block's tile [8][32]
  __syncthreads();  // every warp is done with its ring
  float* part = reinterpret_cast<float*>(smem_raw);
  float* tile = part + kDecWarps * 8 * kDecCols;
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
    *reinterpret_cast<float4*>(part + (kg * 8 + 2 * t + mm) * kDecCols +
                               4 * g) =
        make_float4(acc[0][mm], acc[0][2 + mm], acc[1][mm], acc[1][2 + mm]);
  __syncthreads();
  const int q4 = tid;  // 8 x 32 / 4 = 64 groups of 4 outputs
  if (q4 < 8 * kDecCols / 4) {
    float4 v = reinterpret_cast<const float4*>(part)[q4];
#pragma unroll
    for (int r = 1; r < kDecWarps; ++r) {
      const float4 p =
          reinterpret_cast<const float4*>(part)[r * (8 * kDecCols / 4) + q4];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    if (gridDim.z == 1)
      store_bf16x4(out, M, N, q4 * 4 / kDecCols, n0 + q4 * 4 % kDecCols, v);
    else
      reinterpret_cast<float4*>(tile)[q4] = v;
  }
  if (gridDim.z == 1) return;
  cluster_reduce(tile, out, M, N, 0, n0, 8, kDecCols, 32 * kDecWarps);
}

// Launch `kernel` over (N / cols, M / bm, n_split) blocks of `threads`, the
// n_split blocks of one output tile as a cluster.
template <typename Kernel>
cudaError_t launch_cluster(Kernel kernel, int threads, size_t smem, int bm,
                           int cols, const void* x, const void* packed,
                           const void* scales, void* out, int M, int K, int N,
                           int n_split, int sps, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  // above 48 KB of shared memory a kernel must opt in, and a cluster above
  // 8 blocks too (host calls, not stream operations)
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess && n_split > 8)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + cols - 1) / cols, (M + bm - 1) / bm, n_split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n_split;  // the K slices of one output tile
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int vec16 =
      N % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint16_t*>(x),
                           static_cast<const uint8_t*>(packed),
                           static_cast<const float*>(scales),
                           static_cast<uint16_t*>(out), M, K, N, sps, vec16);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int WM>
cudaError_t launch_mma(const void* x, const void* packed, const void* scales,
                       void* out, int M, int K, int N, int n_split, int sps,
                       cudaStream_t s) {
  constexpr int BM = 8 * WM;
  static_assert(BM * kMmaCols * 4 <= kRing * stage_bytes(BM),
                "the partial tile fits in the ring's bytes");
  return launch_cluster(q4_mma_kernel<WM>, kMmaThreads,
                        static_cast<size_t>(kRing) * stage_bytes(BM), BM,
                        kMmaCols, x, packed, scales, out, M, K, N, n_split,
                        sps, s);
}

cudaError_t launch_decode(const void* x, const void* packed,
                          const void* scales, void* out, int M, int K, int N,
                          int n_split, int sps, cudaStream_t s) {
  constexpr size_t smem =
      static_cast<size_t>(kDecWarps) * kDecRing * kDecStage;
  static_assert((kDecWarps + 1) * 8 * kDecCols * 4 <= smem,
                "the partials fit in the rings' bytes");
  return launch_cluster(q4_decode_kernel, 32 * kDecWarps, smem, 8, kDecCols,
                        x, packed, scales, out, M, K, N, n_split, sps, s);
}

}  // namespace

extern "C" {

// x_dtype (x and out): 0 = float32 (the CUDA-core kernel; rows_per_tile,
// n_split and sps are ignored), 1 = bfloat16 (the tensor-core kernels:
// rows_per_tile 8 selects the decode kernel, 32 columns a block, and 16,
// 32 or 64 the prefill kernel, 128 columns a block; K cut into n_split <=
// 16 slices of sps 64-k stages, one cluster of n_split blocks per output
// tile).  K % 32 == 0 and N % 4 == 0; x and scales 16-byte and packed
// 4-byte aligned (the Python wrapper checks).  Returns the CUDA error code
// of the launch (0 = launched).
int q4_gemm(const void* x, const void* packed, const void* scales, void* out,
            int x_dtype, int M, int K, int N, int rows_per_tile, int n_split,
            int sps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (x_dtype < 0 || x_dtype > 1 || K % kBlock || N % 4 || M < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    if ((M + kMT - 1) / kMT > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + kCols - 1) / kCols, (M + kMT - 1) / kMT);
    q4_gemm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(packed),
        static_cast<const float*>(scales), static_cast<float*>(out), M, K,
        N);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_stages = (K + kStageK - 1) / kStageK;
  if (n_split < 1 || n_split > kMaxCluster || sps < 1 ||
      (n_split - 1) * sps >= n_stages || n_split * sps < n_stages ||
      (M + rows_per_tile - 1) / rows_per_tile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (rows_per_tile) {
    case 8:
      err = launch_decode(x, packed, scales, out, M, K, N, n_split, sps, s);
      break;
    case 16:
      err = launch_mma<2>(x, packed, scales, out, M, K, N, n_split, sps, s);
      break;
    case 32:
      err = launch_mma<4>(x, packed, scales, out, M, K, N, n_split, sps, s);
      break;
    case 64:
      err = launch_mma<8>(x, packed, scales, out, M, K, N, n_split, sps, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* q4_gemm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
