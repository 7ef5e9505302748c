// Q4_0 dequantize + matrix product for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/q4_gemm.py::q4_gemm:
//
//   out (M, N) = x (M, K) @ W,   W[k, n] = (code[k, n] - 8) * scales[k / 32, n]
//
//   x       (M, K)     float32 or bfloat16
//   packed  (K/2, N)   uint8, two 4-bit codes per byte: low nibble = even k
//   scales  (K/32, N)  float32 (fp16-representable, see quant/q4_0.py)
//   out     (M, N)     same type as x
//
// Products accumulate in float32; the float32 sum is rounded to out's type
// (round to nearest even) on store, so the model's bf16 path needs no
// conversion launches around the kernel.  (code - 8) * scale is exact in
// float32 (a 4-bit integer times an 11-bit mantissa), so each weight equals
// the reference's dequantized value; only the summation order differs.
//
// What bounds it on an H100.  At decode (M = 8) it is bytes: the packed
// codes and scales, read once, are 0.5625 B/weight and dwarf x and out;
// 2*M flops per weight against 0.5625 bytes is ~28 flops/byte, far below
// the ~295 the card needs before its arithmetic is the limit.  At the
// 128-row prefill chunks the ratio is ~455 flops/byte and the bound moves
// to operations.  The design serves the byte bound only so far:
//   * the weight streams in its packed form.  A block takes 32 columns and
//     8 rows of x over the whole of K with 256 threads: 8 along N (4
//     columns each) by 32 along K.  In each 1024-k chunk a thread owns one
//     Q4_0 block (32 k) of its 4 columns: one 16-byte load of the 4 scales
//     and 16 independent 32-bit loads of packed rows, all issued before
//     the x tile is staged, so their latency overlaps the staging.  A
//     warp's packed loads are 32-byte segments of consecutive bytes;
//   * x is staged through shared memory in 1024-k chunks with 16-byte
//     loads, widened to f32 and padded by 2 floats per 32 k so the four
//     K-threads of a warp read different banks; it serves all 32 columns;
//   * the 32 K-threads' partial sums meet in shared memory at the end: no
//     second launch and no atomics, and 32..192 blocks at the full-width
//     shapes; rows of x are taken 8 at a time (grid.y), so any M works, and
//     at M > 8 the weight is read again per 8 rows, from L2 where it fits.
// What it does not do yet (later work): tensor cores (bf16 wgmma on the
// dequantized tile, with the per-block scale applied to the f32 sums), TMA
// or cp.async pipelining across chunks, more rows per block at prefill
// (where it runs on the CUDA cores far from the op bound), and more than
// one block's worth of parallelism along K at small N.
//
// Plain C interface, bound with ctypes by src/repro_torch/kernels/q4_gemm.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// 16 bytes of x widened to f32: 4 floats or 8 bfloat16
__device__ __forceinline__ void load_x(const float* p, float* out) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x;
  out[1] = r.y;
  out[2] = r.z;
  out[3] = r.w;
}

__device__ __forceinline__ void load_x(const uint16_t* p, float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little endian: element 2i is the low half
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }

__device__ __forceinline__ void store_one(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

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

template <typename TX>
cudaError_t launch(const void* x, const void* packed, const void* scales,
                   void* out, int M, int K, int N, cudaStream_t s) {
  const dim3 grid((N + kCols - 1) / kCols, (M + kMT - 1) / kMT);
  q4_gemm_kernel<TX><<<grid, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<TX*>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_dtype (x and out): 0 = float32, 1 = bfloat16.  K % 32 == 0 and
// N % 4 == 0; x and scales 16-byte and packed 4-byte aligned (the Python
// wrapper checks).  Returns the CUDA error code of the launch (0 = launched).
int q4_gemm(const void* x, const void* packed, const void* scales, void* out,
            int x_dtype, int M, int K, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (x_dtype < 0 || x_dtype > 1 || K % kBlock || N % 4 || M < 1 || N < 1 ||
      (M + kMT - 1) / kMT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = x_dtype == 0 ? launch<float>(x, packed, scales, out, M, K, N, s)
                     : launch<uint16_t>(x, packed, scales, out, M, K, N, s);
  return static_cast<int>(err);
}

const char* q4_gemm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
