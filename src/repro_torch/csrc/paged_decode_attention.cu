// Paged flash-decoding attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::paged_decode_attention: one query
// token per sequence attends over that sequence's KV cache, which lives in
// a shared pool of fixed-size pages read through a per-sequence block
// table.  It computes the same function, not the same blocks: the TPU
// kernel walks a (B, H, max_pages) grid in order and keeps the online
// softmax state in VMEM scratch between grid steps; here one thread block
// per (kv head h, sequence b) walks the sequence's pages in a loop and
// keeps the state (m, l, acc) for the G query heads of the group in shared
// memory, in float32.
//
// Shapes (the caller folds GQA: query head h*G+g reads kv head h):
//   q            (B, H, G, D)     float32 or bfloat16
//   k_pool       (rows, H, D)     float32, bfloat16 or int8, rows = n_pages * ps
//   v_pool       (rows, H, D)     same type as k_pool
//   k_scale      (rows, H)        float32, int8 pages only (else null)
//   v_scale      (rows, H)        float32, int8 pages only (else null)
//   block_tables (B, max_pages)   int32, physical page of logical page p
//   kv_lens      (B,)             int32
//   out          (B, H, G, D)     same type as q
// q is widened to float32 on load and the float32 result is rounded to
// out's type (round to nearest even) on store, so the model's bf16 path
// needs no conversion launches around the kernel.
// Int8 pages (--kv-dtype int8, src/repro/quant/kv_int8.py) hold codes with
// one f32 scale per (row, kv head): K[j] = code * k_scale[j].  The scales
// are gathered through the same block table, one per token of the tile,
// and multiply in the tile: the K.q dot of a token is scaled once, and the
// softmax probability of a token is multiplied by its V scale before P.V
// (the softmax sum l uses the unscaled probability).  The Pallas kernel
// never runs this format (src/repro/kernels/ops.py routes int8 to its jnp
// oracle), so its yardstick is src/repro_torch/kernels/ref.py.
// Position j of sequence b is valid when j < kv_len[b] and, for window > 0,
// j > kv_len[b] - 1 - window.  Scores are (q.k) * scale, then
// tanh(s / softcap) * softcap when softcap > 0.  The output is
// acc / (l > 0 ? l : 1), so a kv_len = 0 lane (an idle engine slot) comes
// out as zeros: finite.
//
// What bounds it on an H100: bytes.  Each step reads every valid K and V
// row once: B * kv_len * H * D * 2 * itemsize bytes (itemsize 1 plus 4
// scale bytes per row and head for int8 pages), plus q and out.  Per
// token and kv head it does 4 * G * D flops against 4 * D bytes (bf16): G
// flops per byte, far below the ~295 flop/byte the card needs before its
// arithmetic is the limit.  The design serves that bound only so far:
//   * the loop stops at the last valid page (ceil(kv_len / ps)), and with a
//     window it starts at the tile holding kv_len - window, so masked pages
//     are never read (the TPU kernel walks all max_pages);
//   * K rows are read with 16-byte loads by groups of lanes, one row per
//     group (16 int8 codes, 8 bf16 or 4 f32 values per lane); the G query
//     rows stay in shared memory, so each K/V byte is read once for the
//     whole GQA group;
//   * the softmax state never leaves the chip.
// What it does not do yet (later work): split the pages of one sequence
// over several blocks (B * H blocks leave most of the 132 SMs idle at small
// batch), overlap the page loads with the arithmetic (cp.async / TMA), and
// read V rows with vector loads (P.V reads one element per thread).
//
// Plain C interface, bound with ctypes by
// src/repro_torch/kernels/decode_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // tokens per online-softmax step
// the reference's finite -inf: -0.7 * FLT_MAX (see the module note on
// fully-masked rows in src/repro/models/attention.py)
constexpr float kNegInf = -0.7f * 3.40282346638528859812e+38f;

template <typename T>
struct VecWidth;
template <>
struct VecWidth<float> {
  static constexpr int N = 4;  // 16 bytes
};
template <>
struct VecWidth<uint16_t> {  // bfloat16 bits
  static constexpr int N = 8;
};
template <>
struct VecWidth<int8_t> {
  static constexpr int N = 16;
};

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x;
  out[1] = r.y;
  out[2] = r.z;
  out[3] = r.w;
}

__device__ __forceinline__ void load_vec(const uint16_t* p, float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little endian: element 2i is the low half
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load_vec(const int8_t* p, float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)  // little endian: byte b of word i is 4i + b
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[4 * i + b] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * b)));
}

__device__ __forceinline__ float load_one(const float* p) { return *p; }

__device__ __forceinline__ float load_one(const int8_t* p) {
  return static_cast<float>(*p);
}

__device__ __forceinline__ float load_one(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(*p) << 16);
}

__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }

__device__ __forceinline__ void store_one(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename TQ, typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_attn_kernel(const TQ* __restrict__ q,
                         const T* __restrict__ k_pool,
                         const T* __restrict__ v_pool,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ kv_lens,
                         TQ* __restrict__ out, int H, int G, int D,
                         int page_size, int max_pages, int window,
                         float softcap, float scale, int group_lanes) {
  constexpr int VN = VecWidth<T>::N;
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row_s = reinterpret_cast<long long*>(smem_raw);  // kTile
  float* ks_s = reinterpret_cast<float*>(row_s + kTile);      // kTile
  float* vs_s = ks_s + kTile;                                 // kTile
  float* q_s = vs_s + kTile;                                  // G*D
  const int GD = G * D;
  float* acc_s = q_s + GD;        // G*D
  float* p_s = acc_s + GD;        // G*kTile: scores, then probabilities
  float* m_s = p_s + G * kTile;   // G
  float* l_s = m_s + G;           // G
  float* alpha_s = l_s + G;       // G

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kv_len = kv_lens[b];
  const TQ* qb = q + (static_cast<size_t>(b) * H + h) * GD;
  for (int i = tid; i < GD; i += kThreads) {
    q_s[i] = load_one(qb + i);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  // first position any query of this sequence can see
  const int j0 = window > 0 ? max(kv_len - window, 0) : 0;
  const int tile0 = (j0 / kTile) * kTile;
  const int* bt = block_tables + static_cast<size_t>(b) * max_pages;
  const long long row_stride = static_cast<long long>(H) * D;
  const int n_vec = D / VN;              // 16-byte vectors per K row
  const int TG = group_lanes;            // lanes per token, power of two
  const int tok_per_warp = 32 / TG;
  const int sub = lane / TG, gl = lane % TG;
  __syncthreads();

  for (int t0 = tile0; t0 < kv_len; t0 += kTile) {
    const int n_t = min(kTile, kv_len - t0);
    for (int t = tid; t < n_t; t += kThreads) {
      const int j = t0 + t;
      const long long page = bt[min(j / page_size, max_pages - 1)];
      const long long row = page * page_size + j % page_size;
      row_s[t] = row * row_stride + static_cast<long long>(h) * D;
      if constexpr (kInt8) {
        ks_s[t] = k_scale[row * H + h];
        vs_s[t] = v_scale[row * H + h];
      }
    }
    __syncthreads();

    // scores: a group of TG lanes per token, 16-byte loads of its K row
    for (int tb = warp * tok_per_warp; tb < kTile;
         tb += kWarps * tok_per_warp) {
      const int t = tb + sub;
      const bool live = t < n_t;
      float kf[2 * VN];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int vi = gl + c * TG;
        if (live && vi < n_vec) {
          load_vec(k_pool + row_s[t] + vi * VN, kf + c * VN);
        } else {
#pragma unroll
          for (int i = 0; i < VN; ++i) kf[c * VN + i] = 0.f;
        }
      }
      for (int g = 0; g < G; ++g) {
        const float* qg = q_s + g * D;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int vi = gl + c * TG;
          if (vi < n_vec) {
#pragma unroll
            for (int i = 0; i < VN; ++i) dot += qg[vi * VN + i] * kf[c * VN + i];
          }
        }
        for (int off = TG / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (live && gl == 0) {
          if constexpr (kInt8) dot *= ks_s[t];
          float s = dot * scale;
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
          const int j = t0 + t;  // j < kv_len holds for live tokens
          const bool ok = window <= 0 || j > kv_len - 1 - window;
          p_s[g * kTile + t] = ok ? s : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax update, one warp per query head of the group
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * kTile;
      float mx = kNegInf;
      for (int t = lane; t < n_t; t += 32) mx = fmaxf(mx, pg[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < n_t; t += 32) {
        const float p = expf(pg[t] - m_new);
        sum += p;
        if constexpr (kInt8)
          pg[t] = p * vs_s[t];  // V's scale rides on the probability
        else
          pg[t] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V; neighbouring threads read neighbouring d
    for (int e = tid; e < GD; e += kThreads) {
      const int g = e / D, d = e - g * D;
      const float* pg = p_s + g * kTile;
      float a = acc_s[e] * alpha_s[g];
#pragma unroll 8
      for (int t = 0; t < n_t; ++t) a += pg[t] * load_one(v_pool + row_s[t] + d);
      acc_s[e] = a;
    }
    __syncthreads();
  }

  TQ* ob = out + (static_cast<size_t>(b) * H + h) * GD;
  for (int e = tid; e < GD; e += kThreads) {
    const float l = l_s[e / D];
    store_one(ob + e, acc_s[e] / (l > 0.f ? l : 1.f));
  }
}

template <typename TQ, typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* block_tables, const void* kv_lens, void* out,
                   int B, int H, int G, int D, int page_size, int max_pages,
                   int window, float softcap, float scale, cudaStream_t s) {
  const int n_vec = D * static_cast<int>(sizeof(T)) / 16;
  int tg = 1;
  while (tg * 2 <= n_vec && tg < 32) tg *= 2;
  const size_t smem = kTile * sizeof(long long) +
                      (2 * kTile + 2 * G * D + G * kTile + 3 * G) *
                          sizeof(float);
  paged_decode_attn_kernel<TQ, T><<<dim3(H, B), kThreads, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(block_tables),
      static_cast<const int*>(kv_lens), static_cast<TQ*>(out), H, G, D,
      page_size, max_pages, window, softcap, scale, tg);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q_dtype (q and out): 0 = float32, 1 = bfloat16.  kv_dtype (pages):
// 0 = float32, 1 = bfloat16, 2 = int8 (then k_scale / v_scale are the
// (rows, H) float32 scales; otherwise they are ignored and may be null).
// Returns the CUDA error code of the launch (0 = launched).  Shapes and
// pointers are checked by the Python wrapper; the caller owns every buffer.
int paged_decode_attention(const void* q, const void* k_pool,
                           const void* v_pool, const void* k_scale,
                           const void* v_scale, const void* block_tables,
                           const void* kv_lens, void* out, int q_dtype,
                           int kv_dtype, int B, int H, int G, int D,
                           int page_size, int max_pages, int window,
                           float softcap, float scale, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 2 ||
      (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  using Launch = cudaError_t (*)(const void*, const void*, const void*,
                                 const void*, const void*, const void*,
                                 const void*, void*, int, int, int, int, int,
                                 int, int, float, float, cudaStream_t);
  static const Launch kLaunch[2][3] = {
      {launch<float, float>, launch<float, uint16_t>, launch<float, int8_t>},
      {launch<uint16_t, float>, launch<uint16_t, uint16_t>,
       launch<uint16_t, int8_t>}};
  err = kLaunch[q_dtype][kv_dtype](q, k_pool, v_pool, k_scale, v_scale,
                                   block_tables, kv_lens,
                                   out, B, H, G, D, page_size, max_pages,
                                   window, softcap, scale,
                                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
