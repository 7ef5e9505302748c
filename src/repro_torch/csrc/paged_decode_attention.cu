// Paged flash-decoding attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::paged_decode_attention
// (decode_attention.py:160): one query token per sequence attends over that
// sequence's KV cache, which lives in a shared pool of fixed-size pages read
// through a per-sequence block table.  It computes the same function, not
// the same blocks: the TPU kernel walks a (B, H, max_pages) grid in order
// and keeps the online softmax state in VMEM scratch between grid steps.
// Hopper blocks run in parallel and in no order, so here the pages of each
// (sequence b, kv head h) are cut into n_split splits of `chunk` whole pages
// (flash-decoding's split-K): block (h, b, z) runs the online softmax over
// the valid tokens of split z and writes its unnormalised state, and a
// second launch merges the splits of each (b, h).
//
// Shapes (the caller folds GQA: query head h*G+g reads kv head h):
//   q            (B, H, G, D)     float32 or bfloat16
//   k_pool       (rows, H, D)     float32, bfloat16 or int8, rows = n_pages * ps
//   v_pool       (rows, H, D)     same type as k_pool
//   k_scale      (rows, H)        float32, int8 pages only (else null)
//   v_scale      (rows, H)        float32, int8 pages only (else null)
//   block_tables (B, max_pages)   int32, physical page of logical page p
//   kv_lens      (B,)             int32, read on the device only
//   part_acc     (B, H, n_split, G, D) float32 scratch
//   part_ml      (B, H, n_split, 2, G) float32 scratch: m (log2 units),
//                                  then l
//   out          (B, H, G, D)     same type as q
// q is widened to float32 on load and the float32 result is rounded to
// out's type (round to nearest even) on store, so the model's bf16 path
// needs no conversion launches around the kernel.
// Int8 pages (--kv-dtype int8, src/repro/quant/kv_int8.py) hold codes with
// one f32 scale per (row, kv head): K[j] = code * k_scale[j].  The K.q dot
// of a token is scaled once, and V's scale rides on the probability before
// P.V (the softmax sum l uses the unscaled probability).  The Pallas kernel
// never runs this format (src/repro/kernels/ops.py routes int8 to its jnp
// oracle), so its yardstick is src/repro_torch/kernels/ref.py.
// Position j of sequence b is valid when j < kv_len[b] and, for window > 0,
// j > kv_len[b] - 1 - window.  Scores are (q.k) * scale, then
// tanh(s / softcap) * softcap when softcap > 0.  A kv_len = 0 lane (an idle
// engine slot) has only empty splits and comes out as zeros: finite.
//
// What bounds it on an H100: bytes.  A call reads every valid K and V row
// once: B * kv_len * H * D * 2 * itemsize bytes (itemsize 1 plus 4 scale
// bytes per row and head for int8 pages), plus q, out and the tables.  Per
// token and kv head it does 4 * G * D flops against 4 * D bytes (bf16): G
// flops per byte, 2 for Qwen3, far below the ~295 the card needs before its
// arithmetic is the limit.  So it runs on the CUDA cores in float32 and the
// design is about keeping enough bytes in flight:
//   * split-K with a grid the host fixes.  The wrapper sizes the splits
//     from max_pages and the SM count (about eight blocks per SM over
//     max_pages, at least 64 tokens' pages a split) and never reads
//     kv_lens, so a call makes no host synchronisation and can be captured
//     in a CUDA graph.  A block reads kv_lens[b] itself (together with its
//     split's block-table entries and q, so the three loads wait once),
//     clips its split to the valid tokens ([kv_len - window, kv_len)) and,
//     when nothing is left, marks the split empty (l = 0) and exits:
//     masked pages are never read, nor masked tokens of a partly valid
//     page;
//   * pages staged asynchronously.  A block loads its split's block-table
//     entries into shared memory once.  A ring of three stages of 8 KB (a
//     stage is 16 bytes x 2 tokens x 2 (K, V) per thread; two such chunks
//     a row per thread for f32 pages, so 16 KB) is filled with 16-byte
//     cp.async copies (the int8 scales with 4-byte ones), two tiles ahead
//     of the one being computed, with commit_group / wait_group.  Sized in
//     bytes, not tokens: the 24 KB ring leaves room for several blocks an
//     SM, which measured faster than a 48 KB ring (4 tokens a stream) on
//     the card.  cp.async, not TMA: tokens are gathered row by row
//     through the block table, a split starts at any token (the window),
//     pages may be 4 rows, and every thread copies exactly the 16-byte
//     chunks it will itself read, so the loop needs no block barrier at
//     all (a __syncwarp for the int8 scales), where TMA would need an
//     mbarrier wait shared by the block.  Rows past the split's end are
//     zero-filled (src-size 0), so no stale value meets a zero weight;
//   * every warp busy whatever G.  A token's row is read by TG lanes, TG =
//     the row's 16-byte chunks (over two a lane for f32 rows) rounded up to
//     a power of two (16 for bf16 at D = 128): a warp holds 32 / TG token
//     streams, each with its own
//     running (m, l, acc) for all the block's query heads in registers; a
//     stream takes 2 tokens a tile, computes their scores for all heads
//     (q in registers, shuffle sums over the TG lanes), updates its softmax
//     once per tile and accumulates P.V.  The streams combine once, at the
//     end of the split (shuffles within a warp, shared memory across
//     warps);
//   * wide P.V from shared memory.  A thread owns the same 16-byte chunk of
//     the row in K and V: 8 consecutive d (bf16), 16 (int8) or 4 (f32), for
//     all heads, its sums in registers;
//   * no tensor cores: at G flops per byte they would wait on memory too.
//     Register arrays are sized by a compile-time head count NG (1, 2, 4 or
//     8; 4 at most for int8 pages, whose 16 d a thread cost twice the
//     registers); a group of G > NG heads is cut into ceil(G / NG) head
//     chunks, one block each, launched next to each other so that the
//     chunks' K/V reads meet in L2.
// Scores are kept in log2 units (q carries scale * log2 e), so each
// exponential is one exp2f.  The merge launch (one block per (h, b) and
// 128 outputs) weights each non-empty split by 2^(m_z - max m), divides by
// the weighted sum of l and skips empty splits without reading their acc.
// A one-launch form, the last block of a pair merging (found with an
// atomic counter), measured slower on the card: every block then pays a
// fence and an atomic, and the merges wait at the tail.
// What it does not do yet (later work): a multi-query form for speculative
// verify; a split plan that adapts to lengths it cannot read on the host
// (fewer, longer splits measured faster where every split is live, slower
// at the serving state, where most are empty); and more blocks an SM for
// int8 pages.  A thread's 16 d per head cost about 127 registers at G = 2,
// so four int8 blocks fit an SM where eight bf16 blocks do, and int8
// pages, which halve the bytes, gain far less than 2x over bf16 (q read
// from shared memory, or two chunks a lane, measured slower).
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
constexpr int kStages = 3;  // ring depth: two tiles in flight, one computed
constexpr int kR = 2;       // tokens per token stream per tile
// the reference's finite -inf: -0.7 * FLT_MAX (see the module note on
// fully-masked rows in src/repro/models/attention.py)
constexpr float kNegInf = -0.7f * 3.40282346638528859812e+38f;
constexpr float kLog2e = 1.44269504088896340736f;

// VN page elements per 16-byte chunk; CH chunks of a row per thread (f32
// rows reach 64 chunks at D = 256, two per lane of a warp)
template <typename T>
struct Page;
template <>
struct Page<float> {
  static constexpr int VN = 4, CH = 2;
};
template <>
struct Page<uint16_t> {  // bfloat16 bits
  static constexpr int VN = 8, CH = 1;
};
template <>
struct Page<int8_t> {
  static constexpr int VN = 16, CH = 1;
};

__device__ __forceinline__ void unpack(const uint4& r, float* out, float) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float* out, uint16_t) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little endian: element 2i is the low half
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// int8 codes without the quarter-rate I2F: code ^ 0x80 = code + 128 goes
// into the low byte of 2^23 (0x4B000000, one byte permute), and one exact
// subtraction of 2^23 + 128 leaves the code
__device__ __forceinline__ void unpack(const uint4& r, float* out, int8_t) {
  const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u,
                         r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)  // little endian: byte b of word i is 4i + b
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[4 * i + b] =
          __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540u | b)) -
          8388736.f;
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

// cp.async: 16 bytes (L2 only) or 4 bytes; src-size 0 zero-fills the
// destination and reads nothing
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

// Bytes of the ring: kStages x kR tokens x (K, V) x CH chunks x kThreads
// threads x 16 bytes.  After the loop the same bytes hold the cross-warp
// reduction, kWarps x NG x (D + 2) floats, so the region is the larger of
// the two.
template <typename T, int NG>
__host__ __device__ size_t ring_bytes(int D) {
  const size_t ring =
      static_cast<size_t>(kStages) * kR * 2 * Page<T>::CH * kThreads * 16;
  const size_t red = static_cast<size_t>(kWarps) * NG * (D + 2) * 4;
  return ring > red ? ring : (red + 15) / 16 * 16;
}

// Phase 1: block (h * n_gc + gc, b, z) runs the online softmax of heads
// [gc * NG, gc * NG + NG) of kv head h over the valid tokens of split z,
// logical pages [z * chunk, (z + 1) * chunk), and writes its unnormalised
// state: acc to part_acc, m and l to part_ml (l = 0 marks an empty split).
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const void* __restrict__ q, int q_bf16,
                   const T* __restrict__ k_pool, const T* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ kv_lens,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int H, int G, int D, int page_size, int max_pages,
                   int ps_shift, int chunk, int window, float softcap,
                   float scale, int tg_log2) {
  constexpr int VN = Page<T>::VN, CH = Page<T>::CH, E = VN * CH;
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  const int n_gc = (G + NG - 1) / NG;
  const int h = blockIdx.x / n_gc, g0 = (blockIdx.x % n_gc) * NG;
  const int b = blockIdx.y, z = blockIdx.z, n_split = gridDim.z;
  const int ng = min(NG, G - g0);  // live heads of this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t part = (static_cast<size_t>(b) * H + h) * n_split + z;
  float* pml = part_ml + part * 2 * G;

  const int TG = 1 << tg_log2;            // lanes per token row
  const int SUBS = 32 >> tg_log2;         // token streams per warp
  const int NS = kWarps * SUBS;           // token streams per block
  const int sid = warp * SUBS + (lane >> tg_log2);
  const int gl = lane & (TG - 1);
  const int T_tile = NS * kR;             // tokens per tile
  const int n_vec = D / VN;               // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);
  float* sc_s = reinterpret_cast<float*>(smem_raw + ring_bytes<T, NG>(D));
  float* q_s = sc_s + (kInt8 ? kStages * kR * 2 * NS : 0);  // NG * D
  int* bt_s = reinterpret_cast<int*>(q_s + NG * D);         // chunk

  // kv_len, the split's block-table entries and q (heads past G are
  // zeros) are loaded together: none of these loads waits on another
  const int kv_len = kv_lens[b];
  const int pz = z * chunk;  // the split's first logical page
  const int* bt = block_tables + static_cast<size_t>(b) * max_pages + pz;
  for (int i = tid; i < min(chunk, max_pages - pz); i += kThreads)
    bt_s[i] = bt[i];
#pragma unroll 4
  for (int i = tid; i < NG * D; i += kThreads) {
    const int g = i / D;
    float x = 0.f;
    if (g < ng) {
      const size_t off =
          ((static_cast<size_t>(b) * H + h) * G + g0 + g) * D + (i - g * D);
      x = q_bf16 ? __uint_as_float(static_cast<uint32_t>(
                       static_cast<const uint16_t*>(q)[off]) << 16)
                 : static_cast<const float*>(q)[off];
    }
    q_s[i] = x;
  }

  // this split's valid tokens: [tok_lo, tok_hi)
  const int j0 = window > 0 ? max(kv_len - window, 0) : 0;
  const int tok_lo = max(pz * page_size, j0);
  const int tok_hi = min(min(pz + chunk, max_pages) * page_size, kv_len);
  if (tok_lo >= tok_hi) {  // nothing valid here: an empty split
    for (int g = tid; g < ng; g += kThreads) {
      pml[g0 + g] = kNegInf;
      pml[G + g0 + g] = 0.f;
    }
    return;
  }
  __syncthreads();

  // scores are kept in log2 units (times log2 e), so that every
  // exponential is one exp2f; q carries the scale (and 1 / softcap)
  const float q_scale = softcap > 0.f ? scale / softcap : scale * kLog2e;
  const float cap = softcap * kLog2e;
  float qr[NG][E];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int vi = gl + c * TG;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VN; ++e)
        qr[g][c * VN + e] =
            vi < n_vec ? q_s[g * D + vi * VN + e] * q_scale : 0.f;
  }

  const long long row_stride = static_cast<long long>(H) * D;
  const T* kh = k_pool + static_cast<long long>(h) * D;
  const T* vh = v_pool + static_cast<long long>(h) * D;
  // ring slot of (stage, token i, K or V, chunk c) for this thread
  auto slot = [&](int st, int i, int kv, int c) {
    return ring + (((st * kR + i) * 2 + kv) * CH + c) * kThreads + tid;
  };
  auto sc_slot = [&](int st, int i, int kv) {
    return sc_s + ((st * kR + i) * 2 + kv) * NS + sid;
  };
  // issue the copies of tile `it` into stage `st`: this thread's chunks of
  // its kR tokens' K and V rows (zero-filled past the split's end)
  auto issue = [&](int it, int st) {
    const int base = tok_lo + it * T_tile + sid;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int j = base + i * NS;
      const bool ok = j < tok_hi;
      long long row = 0;
      if (ok) {
        const int lp = ps_shift >= 0 ? j >> ps_shift : j / page_size;
        row = static_cast<long long>(bt_s[lp - pz]) * page_size +
              (j - lp * page_size);
      }
      const long long off = row * row_stride;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int vi = gl + c * TG;
        if (vi < n_vec) {
          cp_async16(slot(st, i, 0, c), kh + off + vi * VN, ok);
          cp_async16(slot(st, i, 1, c), vh + off + vi * VN, ok);
        }
      }
      if constexpr (kInt8) {
        if (gl == 0) {
          cp_async4(sc_slot(st, i, 0), k_scale + row * H + h, ok);
          cp_async4(sc_slot(st, i, 1), v_scale + row * H + h, ok);
        }
      }
    }
  };

  const int n_tiles = (tok_hi - tok_lo + T_tile - 1) / T_tile;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) issue(s, s);
    cp_async_commit();
  }

  float m[NG], l[NG], acc[NG][E];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // tile it has landed (this thread's part)
    if constexpr (kInt8) __syncwarp();  // ... and its stream's scales
    if (it + kStages - 1 < n_tiles)
      issue(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const int st = it % kStages;
    const int base = tok_lo + it * T_tile + sid;

    // scores of this stream's kR tokens for every head
    float s[kR][NG];
    bool ok[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      ok[i] = base + i * NS < tok_hi;
      float kf[E];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (gl + c * TG < n_vec) {
          unpack(*slot(st, i, 0, c), kf + c * VN, T());
        } else {
#pragma unroll
          for (int e = 0; e < VN; ++e) kf[c * VN + e] = 0.f;
        }
      }
      const float ks = kInt8 ? *sc_slot(st, i, 0) : 1.f;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot += qr[g][e] * kf[e];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          if (off < TG) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        float x = dot * ks;
        if (softcap > 0.f) x = tanhf(x) * cap;
        s[i][g] = ok[i] ? x : kNegInf;
      }
    }
    // one online-softmax update per tile; s becomes the P.V weight
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float mt = m[g];
#pragma unroll
      for (int i = 0; i < kR; ++i) mt = fmaxf(mt, s[i][g]);
      const float a = exp2f(m[g] - mt);
      m[g] = mt;
      l[g] *= a;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= a;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const float p = ok[i] ? exp2f(s[i][g] - mt) : 0.f;
        l[g] += p;
        s[i][g] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float vf[E];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (gl + c * TG < n_vec) {
          unpack(*slot(st, i, 1, c), vf + c * VN, T());
        } else {
#pragma unroll
          for (int e = 0; e < VN; ++e) vf[c * VN + e] = 0.f;
        }
      }
      const float vs = kInt8 ? *sc_slot(st, i, 1) : 1.f;  // rides on p
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float p = s[i][g] * vs;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += p * vf[e];
      }
    }
  }
  cp_async_wait<0>();

  // combine the token streams of a warp: lanes of one chunk, xor over the
  // stream bits of the lane index
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off < TG) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - mn), bo = exp2f(mo - mn);
      m[g] = mn;
      l[g] = l[g] * a + lo * bo;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * a +
                    __shfl_xor_sync(0xffffffffu, acc[g][e], off) * bo;
    }
  }
  // then the warps, through shared memory (the ring's bytes, now free)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);  // [kWarps][NG][D + 2]
  if ((lane >> tg_log2) == 0) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float* rg = red + (warp * NG + g) * (D + 2);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int vi = gl + c * TG;
        if (vi < n_vec) {
#pragma unroll
          for (int e = 0; e < VN; ++e) rg[vi * VN + e] = acc[g][c * VN + e];
        }
      }
      if (gl == 0) {
        rg[D] = m[g];
        rg[D + 1] = l[g];
      }
    }
  }
  __syncthreads();
  float* pa = part_acc + (part * G + g0) * D;
  for (int e = tid; e < ng * D; e += kThreads) {
    const int g = e / D, d = e - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, red[(w * NG + g) * (D + 2) + D]);
    float sum_l = 0.f, sum_a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* rg = red + (w * NG + g) * (D + 2);
      const float wt = exp2f(rg[D] - mx);
      sum_l += rg[D + 1] * wt;
      sum_a += rg[d] * wt;
    }
    pa[e] = sum_a;
    if (d == 0) {
      pml[g0 + g] = mx;
      pml[G + g0 + g] = sum_l;
    }
  }
}

// Phase 2: blocks (h, b, c) merge the n_split partial states of (b, h),
// each block for kThreads of its G * D outputs.  One warp per query head g
// first finds the largest m over the non-empty splits (l > 0) and the
// weights w[g][z] = 2^(m_z - m) / sum_z(l_z * 2^(m_z - m)) (0 for an
// empty split), in shared memory; then a thread sums its output over the
// splits of non-zero weight, reading no acc of an empty split.  A lane
// whose splits are all empty (kv_len = 0) gets zeros.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml, TQ* __restrict__ out,
                   int H, int G, int D, int n_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w_s = reinterpret_cast<float*>(smem_raw);  // G * n_split
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GD = G * D;
  const size_t first = (static_cast<size_t>(b) * H + h) * n_split;
  const float* ml = part_ml + first * 2 * G;  // split z: ml + z * 2G
  for (int g = warp; g < G; g += kWarps) {
    float mx = kNegInf;
    for (int z = lane; z < n_split; z += 32)
      if (ml[z * 2 * G + G + g] > 0.f) mx = fmaxf(mx, ml[z * 2 * G + g]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int z = lane; z < n_split; z += 32) {
      const float lz = ml[z * 2 * G + G + g];
      const float w = lz > 0.f ? exp2f(ml[z * 2 * G + g] - mx) : 0.f;
      w_s[g * n_split + z] = w;
      den += lz * w;
    }
    den = warp_sum(den);
    const float inv = den > 0.f ? 1.f / den : 0.f;
    __syncwarp();
    for (int z = lane; z < n_split; z += 32) w_s[g * n_split + z] *= inv;
  }
  __syncthreads();
  const int e = blockIdx.z * kThreads + tid;  // this thread's output
  if (e >= GD) return;
  const float* wg = w_s + (e / D) * n_split;
  const float* pa = part_acc + first * GD + e;  // split z: pa + z * GD
  float num = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float w = wg[z];
    if (w != 0.f) num += pa[static_cast<size_t>(z) * GD] * w;
  }
  store_one(out + (static_cast<size_t>(b) * H + h) * GD + e, num);
}

template <typename T, int NG>
cudaError_t launch_split(const void* q, int q_bf16, const void* k_pool,
                         const void* v_pool, const void* k_scale,
                         const void* v_scale, const void* block_tables,
                         const void* kv_lens, void* part_acc, void* part_ml,
                         int B, int H, int G, int D, int page_size,
                         int max_pages, int n_split, int chunk, int window,
                         float softcap, float scale, cudaStream_t s) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  const int n_vec = D * static_cast<int>(sizeof(T)) / 16;
  // lanes per row: its chunks over CH a lane, rounded up to a power of two
  const int lanes = (n_vec + Page<T>::CH - 1) / Page<T>::CH;
  int tg_log2 = 0;
  while ((1 << tg_log2) < lanes && tg_log2 < 5) ++tg_log2;
  const int NS = kWarps * (32 >> tg_log2);
  int ps_shift = 0;  // log2(page_size) for a power of two, else -1
  while ((1 << ps_shift) < page_size) ++ps_shift;
  if ((1 << ps_shift) != page_size) ps_shift = -1;
  const size_t smem = ring_bytes<T, NG>(D) +
                      (kInt8 ? kStages * kR * 2 * NS : 0) * sizeof(float) +
                      NG * D * sizeof(float) + chunk * sizeof(int);
  // above 48 KB a kernel must opt in (a host call, not a stream operation)
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<T, NG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int n_gc = (G + NG - 1) / NG;
  paged_split_kernel<T, NG><<<dim3(H * n_gc, B, n_split), kThreads, smem, s>>>(
      q, q_bf16, static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables), static_cast<const int*>(kv_lens),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, G, D,
      page_size, max_pages, ps_shift, chunk, window, softcap, scale, tg_log2);
  return cudaGetLastError();
}

using SplitLaunch = cudaError_t (*)(const void*, int, const void*,
                                    const void*, const void*, const void*,
                                    const void*, const void*, void*, void*,
                                    int, int, int, int, int, int, int, int,
                                    int, float, float, cudaStream_t);

// heads per block: 1, 2, 4 or 8 (index 0..3); int8 pages stop at 4
SplitLaunch split_launch(int kv_dtype, int ng) {
  static const SplitLaunch kTable[3][4] = {
      {launch_split<float, 1>, launch_split<float, 2>,
       launch_split<float, 4>, launch_split<float, 8>},
      {launch_split<uint16_t, 1>, launch_split<uint16_t, 2>,
       launch_split<uint16_t, 4>, launch_split<uint16_t, 8>},
      {launch_split<int8_t, 1>, launch_split<int8_t, 2>,
       launch_split<int8_t, 4>, nullptr}};
  const int idx = ng == 1 ? 0 : ng == 2 ? 1 : ng == 4 ? 2 : ng == 8 ? 3 : -1;
  if (kv_dtype < 0 || kv_dtype > 2 || idx < 0) return nullptr;
  return kTable[kv_dtype][idx];
}

}  // namespace

extern "C" {

// q_dtype (q and out): 0 = float32, 1 = bfloat16.  kv_dtype (pages):
// 0 = float32, 1 = bfloat16, 2 = int8 (then k_scale / v_scale are the
// (rows, H) float32 scales; otherwise they are ignored and may be null).
// The logical pages of each (b, h) are cut into n_split splits of chunk
// pages; heads_per_block (1, 2, 4 or 8; at most 4 for int8 pages) sets the
// query heads a block computes.  part_acc (B*H*n_split*G*D f32) and
// part_ml (B*H*n_split*2*G f32) are the caller's scratch.  Returns the
// CUDA error code of the two launches (0 = launched).  Shapes and pointers
// are checked by the Python wrapper; the caller owns every buffer.
int paged_decode_attention(const void* q, const void* k_pool,
                           const void* v_pool, const void* k_scale,
                           const void* v_scale, const void* block_tables,
                           const void* kv_lens, void* part_acc, void* part_ml,
                           void* out, int q_dtype, int kv_dtype, int B, int H,
                           int G, int D, int page_size, int max_pages,
                           int n_split, int chunk, int heads_per_block,
                           int window, float softcap, float scale, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const SplitLaunch split = split_launch(kv_dtype, heads_per_block);
  if (q_dtype < 0 || q_dtype > 1 || split == nullptr || n_split < 1 ||
      chunk < 1 ||
      (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = split(q, q_dtype, k_pool, v_pool, k_scale, v_scale, block_tables,
              kv_lens, part_acc, part_ml, B, H, G, D, page_size, max_pages,
              n_split, chunk, window, softcap, scale, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 merge(H, B, (G * D + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(G) * n_split * sizeof(float);
  const float* pa = static_cast<const float*>(part_acc);
  const float* pml = static_cast<const float*>(part_ml);
  if (q_dtype == 0)
    paged_merge_kernel<float><<<merge, kThreads, smem, s>>>(
        pa, pml, static_cast<float*>(out), H, G, D, n_split);
  else
    paged_merge_kernel<uint16_t><<<merge, kThreads, smem, s>>>(
        pa, pml, static_cast<uint16_t*>(out), H, G, D, n_split);
  return static_cast<int>(cudaGetLastError());
}

const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
