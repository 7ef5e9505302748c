// Contiguous-cache flash-decoding attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention: one query token
// per sequence attends over that sequence's contiguous KV cache.  It
// computes the same function, not the same blocks: the TPU kernel walks a
// (B, H, S / block_s) grid in order and keeps the online softmax state in
// VMEM scratch between grid steps.  Hopper blocks run in no order, so here
// the slots of each (sequence b, kv head h) are cut into n_split splits
// (flash-decoding's split-K): block (h, b, z) walks its split in tiles of
// 64 slots, keeps the online softmax state (m, l, acc) of the G query
// heads of the group in shared memory, in float32, and writes it
// unnormalised to scratch; a second launch, one block per (h, b), merges
// the splits.
//
// Shapes (the caller folds GQA: query head h*G+g reads kv head h):
//   q       (B, H, G, D)   float32 or bfloat16
//   k, v    (B, S, H, D)   float32 or bfloat16 (one type for both)
//   kv_pos  (S,)           int32 or null
//   out     (B, H, G, D)   same type as q
// q is widened to float32 on load and the float32 result is rounded to
// out's type (round to nearest even) on store.
//
// Which slots a query sees.  Slot s has position p_s = kv_pos[s] when the
// caller passes the ring cache's position array (-1 marks an empty slot),
// else p_s = s.  It is valid when 0 <= p_s <= q_pos and, for window > 0,
// p_s > q_pos - window.  Without kv_pos the caller sets q_pos = kv_len - 1,
// so this is the TPU kernel's `s < kv_len` (plus an optional window); with
// kv_pos it is src/repro/models/attention.py::flash_attention's mask over
// the ring (causal, window, kv_positions >= 0), which the ring decode step
// of src/repro/models/transformer.py:362-365 computes.  Scores are
// (q.k) * scale, then tanh(s / softcap) * softcap when softcap > 0.
// Masked slots are skipped: their weight exp(NEG_INF - m) is exactly 0 in
// the reference once any slot is valid.  When no slot is valid the
// reference's finite NEG_INF (-0.7 * FLT_MAX) gives every slot the same
// weight, so the output is the mean of V over all S slots; the kernel
// computes that mean too, so it matches the TPU kernel on a kv_len = 0
// launch as well (finite output; the l > 0 guard keeps the divide safe).
//
// What bounds it on an H100: bytes.  Each call reads every valid K and V
// row once: B * n_valid * H * D * 2 * itemsize bytes, plus q, out and the
// position array.  Per slot and kv head it does 4 * G * D flops against
// 4 * D bytes (bf16): G flops per byte, far below the ~295 flop/byte the
// card needs before its arithmetic is the limit.  The design serves that
// bound only so far:
//   * the splits give the card enough blocks: an MQA model at small batch
//     has B * H = 4-8 (sequence, kv head) pairs for 132 SMs; the wrapper
//     picks n_split so there are up to four blocks per SM, each of at
//     least 8 slots, so a block's latency is hidden by the others'.  The
//     merge reads n_split * (G * D + 2 * G) floats per pair;
//   * without kv_pos the splits cover [max(kv_len - window, 0), kv_len),
//     so masked slots are never read; with kv_pos they cover all S
//     positions (4 bytes a slot), and a tile with no valid slot is skipped
//     without reading its K or V;
//   * K rows are read with 16-byte loads by groups of lanes, one row per
//     group (8 bf16 or 4 f32 values per lane); the G query rows stay in
//     shared memory, so each K/V byte is read once for the whole group;
//   * in P.V a thread owns one column d for all G heads: it reads each V
//     element once, issues 8 slots' loads before their multiply-adds, and
//     keeps the G sums in registers (G = 10 for RecurrentGemma);
//   * the softmax state of a split never leaves the chip until its end.
// What it does not do yet (later work): overlap the loads with the
// arithmetic across tiles (cp.async / TMA), read V rows with vector loads
// (P.V reads one 2- or 4-byte element per thread), and, in the ring form,
// stop at the last filled slot of a ring that has not wrapped.
//
// Plain C interface, bound with ctypes by
// src/repro_torch/kernels/decode_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // slots per online-softmax step (<= kThreads)
constexpr int kMaxG = 32;  // query heads per kv head (the wrapper checks)
constexpr int kUnroll = 8;  // V loads issued together in P.V
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

__device__ __forceinline__ float load_one(const float* p) { return *p; }

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

// Phase 1: block (h, b, z) runs the online softmax over split z of the
// slot range, [lo + z * chunk, lo + (z + 1) * chunk) within [lo, hi), and
// writes its unnormalised state: acc (G, D), then m and l (G each), and
// its count of valid slots.
template <typename TQ, typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_split_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ kv_pos,
                         float* __restrict__ part_acc,
                         float* __restrict__ part_ml,
                         int* __restrict__ part_n, int S, int H, int G, int D,
                         int lo, int hi, int chunk, int q_pos, int window,
                         float softcap, float scale, int group_lanes) {
  constexpr int VN = VecWidth<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* ok_s = reinterpret_cast<int*>(smem_raw);         // kTile
  float* q_s = reinterpret_cast<float*>(ok_s + kTile);  // G*D
  const int GD = G * D;
  float* acc_s = q_s + GD;        // G*D
  float* p_s = acc_s + GD;        // G*kTile: scores, then probabilities
  float* m_s = p_s + G * kTile;   // G
  float* l_s = m_s + G;           // G
  float* alpha_s = l_s + G;       // G

  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const TQ* qb = q + (static_cast<size_t>(b) * H + h) * GD;
#pragma unroll 8
  for (int i = tid; i < GD; i += kThreads) {
    q_s[i] = load_one(qb + i);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  // slot s of this (b, h) starts at kb + s * row_stride
  const long long row_stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * row_stride +
                         static_cast<long long>(h) * D;
  const T* kb = k + base;
  const T* vb = v + base;
  const int n_vec = D / VN;              // 16-byte vectors per K row
  const int TG = group_lanes;            // lanes per slot, power of two
  const int tok_per_warp = 32 / TG;
  const int sub = lane / TG, gl = lane % TG;
  const int s0 = lo + z * chunk, s1 = min(hi, s0 + chunk);
  int n_valid = 0;                       // block-uniform
  __syncthreads();

  for (int t0 = s0; t0 < s1; t0 += kTile) {
    const int n_t = min(kTile, s1 - t0);
    bool ok = false;
    if (tid < n_t) {
      const int s = t0 + tid;
      const int p = kv_pos != nullptr ? kv_pos[s] : s;
      ok = p >= 0 && p <= q_pos && (window <= 0 || p > q_pos - window);
    }
    if (tid < kTile) ok_s[tid] = ok;
    const int n_ok = __syncthreads_count(ok);
    if (n_ok == 0) continue;             // a tile with nothing valid
    n_valid += n_ok;

    // scores: a group of TG lanes per slot, 16-byte loads of its K row
    for (int tb = warp * tok_per_warp; tb < n_t;
         tb += kWarps * tok_per_warp) {
      const int t = tb + sub;
      const bool live = t < n_t && ok_s[t];
      float kf[2 * VN];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int vi = gl + c * TG;
        if (live && vi < n_vec) {
          load_vec(kb + (t0 + t) * row_stride + vi * VN, kf + c * VN);
        } else {
#pragma unroll
          for (int i = 0; i < VN; ++i) kf[c * VN + i] = 0.f;
        }
      }
      // unrolled so that the shuffle chains of 4 heads interleave
#pragma unroll 4
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
        if (t < n_t && gl == 0) {
          float s = dot * scale;
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
          p_s[g * kTile + t] = live ? s : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax update over the valid slots, one warp per query
    // head; every one of the kTile probabilities is written (0 for a
    // masked slot or past the tile's end), so P.V below needs no mask
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * kTile;
      float mx = kNegInf;
      for (int t = lane; t < n_t; t += 32)
        if (ok_s[t]) mx = fmaxf(mx, pg[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = (t < n_t && ok_s[t]) ? expf(pg[t] - m_new) : 0.f;
        sum += p;
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

    // acc = acc * alpha + P V: a thread owns one column d for all G query
    // heads, so each V element is read once (neighbouring threads read
    // neighbouring d) and the G sums stay in registers; the loads of
    // kUnroll slots are issued before their multiply-adds, and the
    // probabilities are shared-memory broadcasts.  A masked slot's V is
    // read and weighted by its probability 0, as in the reference.
    for (int d = tid; d < D; d += kThreads) {
      float a[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) a[g] = acc_s[g * D + d] * alpha_s[g];
      for (int t = 0; t < n_t; t += kUnroll) {
        float vt[kUnroll];
#pragma unroll
        for (int i = 0; i < kUnroll; ++i)
          vt[i] = t + i < n_t
                      ? load_one(vb + (t0 + t + i) * row_stride + d)
                      : 0.f;
#pragma unroll
        for (int i = 0; i < kUnroll; ++i)
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) a[g] += p_s[g * kTile + t + i] * vt[i];
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc_s[g * D + d] = a[g];
    }
    __syncthreads();
  }

  const size_t part = (static_cast<size_t>(b) * H + h) * gridDim.z + z;
  float* pa = part_acc + part * GD;
  for (int e = tid; e < GD; e += kThreads) pa[e] = acc_s[e];
  float* pml = part_ml + part * 2 * G;
  for (int g = tid; g < G; g += kThreads) {
    pml[g] = m_s[g];
    pml[G + g] = l_s[g];
  }
  if (tid == 0) part_n[part] = n_valid;
}

// Phase 2: blocks (h, b, c) merge the n_split partial states of (b, h),
// each block for kThreads of its G * D outputs.  First one warp per query
// head g finds the common maximum m over the splits and the weights
// w[g][z] = exp(m_z - m) / sum_z(l_z * exp(m_z - m)) (in shared memory);
// then a thread sums its output over the splits, loads issued kUnroll at
// a time.  With no valid slot in any split, every slot has the same finite
// NEG_INF score in the reference, so its softmax weights are uniform: the
// output is the mean of V over all S slots.
template <typename TQ, typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_combine_kernel(const float* __restrict__ part_acc,
                           const float* __restrict__ part_ml,
                           const int* __restrict__ part_n,
                           const T* __restrict__ v, TQ* __restrict__ out,
                           int S, int H, int G, int D, int n_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w_s = reinterpret_cast<float*>(smem_raw);  // G * n_split
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GD = G * D;
  const int e = blockIdx.z * kThreads + tid;    // this thread's output
  const size_t first = (static_cast<size_t>(b) * H + h) * n_split;
  TQ* ob = out + (static_cast<size_t>(b) * H + h) * GD;
  bool any = false;
  for (int z = tid; z < n_split; z += kThreads) any |= part_n[first + z] > 0;
  if (!__syncthreads_or(any)) {
    if (e < GD) {
      const long long row_stride = static_cast<long long>(H) * D;
      const T* vb = v + static_cast<long long>(b) * S * row_stride +
                    static_cast<long long>(h) * D + e % D;
      float a = 0.f;
      for (int s = 0; s < S; ++s) a += load_one(vb + s * row_stride);
      store_one(ob + e, a / S);
    }
    return;
  }
  for (int g = warp; g < G; g += kWarps) {
    const float* ml = part_ml + first * 2 * G;  // split z: ml + z * 2G
    float m = kNegInf;
    for (int z = lane; z < n_split; z += 32) m = fmaxf(m, ml[z * 2 * G + g]);
    m = warp_max(m);
    float den = 0.f;
    for (int z = lane; z < n_split; z += 32) {
      const float w = expf(ml[z * 2 * G + g] - m);
      w_s[g * n_split + z] = w;
      den += ml[z * 2 * G + G + g] * w;
    }
    den = warp_sum(den);
    const float inv = 1.f / (den > 0.f ? den : 1.f);
    __syncwarp();
    for (int z = lane; z < n_split; z += 32) w_s[g * n_split + z] *= inv;
  }
  __syncthreads();
  if (e >= GD) return;
  const float* wg = w_s + (e / D) * n_split;
  const float* pa = part_acc + first * GD + e;  // split z: pa + z * GD
  float num = 0.f;
#pragma unroll 8
  for (int z = 0; z < n_split; ++z) num += pa[static_cast<size_t>(z) * GD] * wg[z];
  store_one(ob + e, num);
}

template <typename TQ, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_pos, void* part_acc, void* part_ml,
                   void* part_n, void* out, int B, int S, int H, int G,
                   int D, int lo, int hi, int n_split, int chunk, int q_pos,
                   int window, float softcap, float scale, cudaStream_t s) {
  const int n_vec = D * static_cast<int>(sizeof(T)) / 16;
  int tg = 1;
  while (tg * 2 <= n_vec && tg < 32) tg *= 2;
  const size_t smem = kTile * sizeof(int) +
                      (2 * G * D + G * kTile + 3 * G) * sizeof(float);
  decode_attn_split_kernel<TQ, T><<<dim3(H, B, n_split), kThreads, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_pos),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(part_n), S, H, G, D, lo, hi, chunk, q_pos, window,
      softcap, scale, tg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 merge(H, B, (G * D + kThreads - 1) / kThreads);
  decode_attn_combine_kernel<TQ, T>
      <<<merge, kThreads, G * n_split * sizeof(float), s>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(part_n), static_cast<const T*>(v),
      static_cast<TQ*>(out), S, H, G, D, n_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q_dtype (q and out) and kv_dtype (k and v): 0 = float32, 1 = bfloat16.
// kv_pos null selects the TPU kernel's form (slots [lo, hi), q_pos =
// kv_len - 1); otherwise the ring form over [0, S).  The slot range is
// cut into n_split splits of chunk slots; part_acc (B*H*n_split*G*D f32),
// part_ml (B*H*n_split*2*G f32) and part_n (B*H*n_split int32) are the
// caller's scratch.  Returns the CUDA error code of the launches (0 =
// launched).  Shapes and pointers are checked by the Python wrapper; the
// caller owns every buffer.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* kv_pos, void* part_acc, void* part_ml,
                     void* part_n, void* out, int q_dtype, int kv_dtype,
                     int B, int S, int H, int G, int D, int lo, int hi,
                     int n_split, int chunk, int q_pos, int window,
                     float softcap, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 1 ||
      n_split < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  using Launch = cudaError_t (*)(const void*, const void*, const void*,
                                 const void*, void*, void*, void*, void*, int,
                                 int, int, int, int, int, int, int, int, int,
                                 int, float, float, cudaStream_t);
  static const Launch kLaunch[2][2] = {
      {launch<float, float>, launch<float, uint16_t>},
      {launch<uint16_t, float>, launch<uint16_t, uint16_t>}};
  err = kLaunch[q_dtype][kv_dtype](q, k, v, kv_pos, part_acc, part_ml, part_n,
                                   out, B, S, H, G, D, lo, hi, n_split, chunk,
                                   q_pos, window, softcap, scale,
                                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

const char* decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
