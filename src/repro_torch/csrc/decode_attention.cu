// Contiguous-cache flash-decoding attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention
// (decode_attention.py:71): one query token per sequence attends over that
// sequence's contiguous KV cache.  It computes the same function, not the
// same blocks: the TPU kernel walks a (B, H, S / block_s) grid in order and
// keeps the online softmax state in VMEM scratch between grid steps.
// Hopper blocks run in no order, so here the slots of each (sequence b, kv
// head h) are cut into n_split splits (flash-decoding's split-K): block
// (h * n_gc + gc, b, z) runs the online softmax of query heads
// [gc * NG, gc * NG + NG) over the valid slots of split z, and the n_split
// blocks of one (gc, b, h) form a thread-block cluster that merges their
// states through distributed shared memory.  One launch, no scratch.
//
// Shapes (the caller folds GQA: query head h*G+g reads kv head h):
//   q         (B, H, G, D)           float32 or bfloat16
//   k, v      (B, S, H, D)           float32 or bfloat16 (one type for both)
//   kv_pos    (S,)                   int32 or null
//   out       (B, H, G, D)           same type as q
// q is widened to float32 on load and the float32 result is rounded to
// out's type (round to nearest even) on store.
//
// Which slots a query sees.  Slot s has position p_s = kv_pos[s] when the
// caller passes the ring cache's position array (-1 marks an empty slot),
// else p_s = s.  It is valid when 0 <= p_s <= q_pos and, for window > 0,
// p_s > q_pos - window.  Without kv_pos the caller sets q_pos = kv_len - 1
// and the slot range [lo, hi) = [max(kv_len - window, 0), kv_len), so this
// is the TPU kernel's `s < kv_len` (plus an optional window); with kv_pos
// it is src/repro/models/attention.py::flash_attention's mask over the ring
// (causal, window, kv_positions >= 0), which the ring decode step of
// src/repro/models/transformer.py:362-365 computes.  Scores are
// (q.k) * scale, then tanh(s / softcap) * softcap when softcap > 0.
// Masked slots are skipped: their weight exp(NEG_INF - m) is exactly 0 in
// the reference once any slot is valid.  When no slot is valid the
// reference's finite NEG_INF (-0.7 * FLT_MAX) gives every slot the same
// weight, so the output is the mean of V over all S slots; the merge
// computes that mean too, so the kernel matches the TPU kernel on a
// kv_len = 0 launch as well.
//
// What bounds it on an H100: bytes.  Each call reads every valid K and V
// row once: B * n_valid * H * D * 2 * itemsize bytes, plus q, out and the
// position array.  Per slot and kv head it does 4 * G * D flops against
// 4 * D bytes (bf16): G flops per byte (10 for RecurrentGemma), far below
// the ~295 the card needs before its arithmetic is the limit.  At the
// serving state (B = 4, 544 valid slots, MQA with G = 10, D = 256) that is
// 2.2 MB, 0.68 us at 3.35 TB/s: the time goes to latency, to launches and
// to the split/merge round trip, so the design is about those:
//   * one launch, the merge in the cluster.  A split's state (acc, m, l)
//     stays in its block's shared memory; after a cluster barrier each
//     block merges a share of the outputs over the cluster's splits in
//     split order, reading its peers' states through distributed shared
//     memory.  The two-launch form (splits, then a merge launch over a
//     device-memory scratch) spent more on the second launch and the
//     scratch round trip than on the attention: 5-7 us of a 21 us call at
//     the serving state (PERF.md, tools/kernel_ab.py);
//   * a split plan that pays for its merge.  A split costs its K/V bytes,
//     2 * D * itemsize a valid slot (1 KB at D = 256 bf16), plus a state of
//     (G * D + 2 * G) * 4 bytes that the merge reads back (10.3 KB at
//     G = 10).  The wrapper (kernels/decode_attention.py::
//     contiguous_split_plan) gives every split at least as many slots as
//     that state's round trip costs in K/V bytes (21 slots at G = 10,
//     D = 256 bf16), at most kMaxCluster = 16 splits (a cluster), and
//     otherwise as many as give about CONTIGUOUS_BLOCKS_PER_SM blocks an SM
//     over all (sequence, kv head, head chunk) triples: 16 splits of 35
//     slots at the serving state, where the old fixed 8-slot minimum gave
//     70 splits of 8, 2.9 MB of partials and a 70-deep merge.  The grid
//     depends on S and the SM count only, never on q_pos or the valid
//     count, so a later CUDA graph can capture the call;
//   * only valid slots are read.  A block first lists its split's valid
//     slots in shared memory (a ballot and prefix count over the position
//     array, in slot order; without kv_pos every slot of [lo, hi) is
//     valid), at most kList at a time.  A split with none marks its state
//     l = 0; the merge drops it without reading its acc.  The half-empty
//     ring of a short bucket costs the position array, not its K/V;
//   * K/V staged asynchronously.  A ring of kStages stages of 16 KB (32 KB
//     for f32 rows) is filled with 16-byte cp.async copies, kStages - 1
//     tiles ahead of the one being computed; every thread copies exactly
//     the 16-byte chunks of K and V it will itself read, so the loop needs
//     no block barrier, and rows past the list's end are zero-filled
//     (src-size 0).  cp.async, not TMA: the valid slots of a ring are
//     gathered from a list, one row each.  q is loaded once the first
//     copies fly, so its latency hides under theirs;
//   * every warp busy.  A slot's row is read by TG lanes (TG = its 16-byte
//     chunks, over two a lane for f32 rows, rounded up to a power of two:
//     32 at D = 256 bf16, 16 at D = 128): a warp holds 32 / TG token
//     streams, each with its own running (m, l, acc) for the block's NG
//     query heads in registers.  A stream takes kR slots a tile, computes
//     their scores (q in registers; shuffle sums over the TG lanes),
//     updates its softmax once per tile and accumulates P.V from the same
//     16-byte chunk of V (8 consecutive d a lane for bf16).  The streams
//     combine once per split: shuffles within a warp, shared memory across
//     warps;
//   * scores in log2 units (q carries scale * log2 e), so every
//     exponential is one exp2f;
//   * registers.  A lane that owns 8 d of a D = 256 row holds 8 d x NG
//     heads of acc and of q: NG = 10 would pass 128 registers a thread and
//     halve the blocks an SM.  So a block takes at most 8 heads, the group
//     split evenly (kernels/decode_attention.py::contiguous_heads_per_block:
//     G = 10 runs as two blocks of NG = 5, launched next to each other so
//     that their K/V reads meet in L2);
//   * no float atomics: every sum runs in a fixed order, so two calls on
//     the same input give the same bits.
// What it does not do yet (later work): the score sums cost 5 shuffles a
// head and slot at D = 256, a large share of the split's time at G = 10
// (a transposed reduction, or tensor cores for Q.K^T and P.V at large
// groups, would cut it); and reading q_pos from device memory for
// CUDA-graph capture of the ring decode step.
//
// Plain C interface, bound with ctypes by
// src/repro_torch/kernels/decode_attention.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;   // ring depth: three tiles in flight, one computed
constexpr int kR = 4;        // slots per token stream per tile
constexpr int kList = 512;   // valid-slot list entries per pass
constexpr int kMergeBatch = 8;  // splits whose reads the merge issues together
constexpr int kMaxCluster = 16;  // splits of one (head chunk, b, h): a cluster
// the reference's finite -inf: -0.7 * FLT_MAX (see the module note on
// fully-masked rows in src/repro/models/attention.py)
constexpr float kNegInf = -0.7f * 3.40282346638528859812e+38f;
constexpr float kLog2e = 1.44269504088896340736f;

// VN cache elements per 16-byte chunk; CH chunks of a row per thread (f32
// rows reach 64 chunks at D = 256, two per lane of a warp)
template <typename T>
struct Row;
template <>
struct Row<float> {
  static constexpr int VN = 4, CH = 2;
};
template <>
struct Row<uint16_t> {  // bfloat16 bits
  static constexpr int VN = 8, CH = 1;
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

// VN consecutive elements as floats, with 8- or 16-byte loads (p aligned
// to VN elements)
template <int VN>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < VN; i += 4)
    unpack(*reinterpret_cast<const uint4*>(p + i), out + i, float());
}

template <int VN>
__device__ __forceinline__ void load_vec(const uint16_t* p, float* out) {
  if constexpr (VN == 8) {
    unpack(*reinterpret_cast<const uint4*>(p), out, uint16_t());
  } else {
    static_assert(VN == 4, "4 or 8 bfloat16");
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(r.x << 16);
    out[1] = __uint_as_float(r.x & 0xffff0000u);
    out[2] = __uint_as_float(r.y << 16);
    out[3] = __uint_as_float(r.y & 0xffff0000u);
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

// cp.async of 16 bytes (L2 only); src-size 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes of the ring: kStages x kR slots x (K, V) x CH chunks x kThreads
// threads x 16 bytes.  After the loop the same bytes hold the cross-warp
// reduction, kWarps x NG x (D + 2) floats, so the region is the larger.
template <typename T, int NG>
__host__ __device__ size_t ring_bytes(int D) {
  const size_t ring =
      static_cast<size_t>(kStages) * kR * 2 * Row<T>::CH * kThreads * 16;
  const size_t red = static_cast<size_t>(kWarps) * NG * (D + 2) * 4;
  return ring > red ? ring : (red + 15) / 16 * 16;
}

// Block (h * n_gc + gc, b, z) runs the online softmax of heads
// [gc * NG, gc * NG + NG) of kv head h over the valid slots of split z,
// slots [lo + z * chunk, lo + (z + 1) * chunk) within [lo, hi), and leaves
// its unnormalised state in its shared memory (l = 0 marks a split with no
// valid slot; its acc is not written).  The n_split blocks of (gc, b, h)
// form one cluster; after a cluster barrier block z merges its share of
// the outputs over the cluster's states, read through distributed shared
// memory in split order, and writes them.
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const void* __restrict__ q, int q_bf16,
                   const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ kv_pos, void* __restrict__ out,
                   int S, int H, int G, int D, int lo, int hi, int chunk,
                   int q_pos, int window, float softcap, float scale,
                   int tg_log2) {
  constexpr int VN = Row<T>::VN, CH = Row<T>::CH, E = VN * CH;
  const int n_gc = (G + NG - 1) / NG;
  const int h = blockIdx.x / n_gc, g0 = (blockIdx.x % n_gc) * NG;
  const int b = blockIdx.y, z = blockIdx.z, n_split = gridDim.z;
  const int ng = min(NG, G - g0);  // live heads of this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int TG = 1 << tg_log2;            // lanes per slot row
  const int SUBS = 32 >> tg_log2;         // token streams per warp
  const int NS = kWarps * SUBS;           // token streams per block
  const int sid = warp * SUBS + (lane >> tg_log2);
  const int gl = lane & (TG - 1);
  const int T_tile = NS * kR;             // slots per tile
  const int n_vec = D / VN;               // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);
  int* list_s = reinterpret_cast<int*>(smem_raw + ring_bytes<T, NG>(D));
  int* cnt_s = list_s + kList;            // kWarps valid counts
  // this split's state: acc (NG x D), then m (NG) and l (NG)
  float* state = reinterpret_cast<float*>(cnt_s + kWarps);
  float* m_s = state + NG * D;
  float* l_s = m_s + NG;

  const int s0 = lo + z * chunk, s1 = min(hi, s0 + chunk);
  const long long row_stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * row_stride +
                         static_cast<long long>(h) * D;
  if (tid == 0 && s0 < s1) {
    // the first touch of K, V and q pays an address translation: start it
    // while the position array is read
    prefetch_l2(k + base + s0 * row_stride);
    prefetch_l2(v + base + s0 * row_stride);
    prefetch_l2(static_cast<const char*>(q) +
                ((static_cast<size_t>(b) * H + h) * G + g0) * D *
                    (q_bf16 ? 2 : 4));
  }

  // q of this lane's chunks for the block's heads (0 past G), loaded from
  // global once, after the first K/V copies are issued; scores are kept
  // in log2 units (times log2 e), so that every exponential is one exp2f,
  // and q carries the scale (and 1 / softcap)
  const float q_scale = softcap > 0.f ? scale / softcap : scale * kLog2e;
  const float cap = softcap * kLog2e;
  float qr[NG][E];
  const size_t qb = (static_cast<size_t>(b) * H + h) * G * D;
  auto load_q = [&](auto tag) {
    using TQ = decltype(tag);
    const TQ* qp = static_cast<const TQ*>(q) + qb;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int gg = g0 + (g < ng ? g : 0);  // a head past G reads a live one
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int vi = gl + c * TG;
        float f[VN];
        load_vec<VN>(qp + gg * D + min(vi, n_vec - 1) * VN, f);
        const bool live = g < ng && vi < n_vec;
#pragma unroll
        for (int e = 0; e < VN; ++e)
          qr[g][c * VN + e] = live ? f[e] * q_scale : 0.f;
      }
    }
  };
  bool have_q = false;  // q is loaded once the first K/V copies fly

  const T* kb = k + base;
  const T* vb = v + base;
  auto slot = [&](int st, int i, int kv, int c) {
    return ring + (((st * kR + i) * 2 + kv) * CH + c) * kThreads + tid;
  };

  float m[NG], l[NG], acc[NG][E];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  int n_valid = 0;  // block-uniform
  for (int r0 = s0; r0 < s1; r0 += kList) {
    const int r1 = min(s1, r0 + kList);
    // the valid slots of [r0, r1), in slot order
    int n_list = r1 - r0;
    if (kv_pos != nullptr) {
      __syncthreads();  // the last pass's readers of list_s are done
      n_list = 0;
      for (int i0 = r0; i0 < r1; i0 += kThreads) {
        const int s = i0 + tid;
        bool ok = false;
        if (s < r1) {
          const int p = kv_pos[s];
          ok = p >= 0 && p <= q_pos && (window <= 0 || p > q_pos - window);
        }
        const unsigned bal = __ballot_sync(0xffffffffu, ok);
        if (lane == 0) cnt_s[warp] = __popc(bal);
        __syncthreads();
        int off = n_list, total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          off += w < warp ? cnt_s[w] : 0;
          total += cnt_s[w];
        }
        if (ok) list_s[off + __popc(bal & ((1u << lane) - 1u))] = s;
        n_list += total;
        __syncthreads();
      }
    }
    n_valid += n_list;
    if (n_list == 0) continue;
    auto slot_of = [&](int j) {
      return kv_pos != nullptr ? list_s[j] : r0 + j;
    };
    // issue the copies of tile `it` into stage `st`: this thread's chunks
    // of its kR slots' K and V rows (zero-filled past the list's end)
    auto issue = [&](int it, int st) {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int j = it * T_tile + i * NS + sid;
        const bool ok = j < n_list;
        const long long off = ok ? slot_of(j) * row_stride : 0;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int vi = gl + c * TG;
          if (vi < n_vec) {
            cp_async16(slot(st, i, 0, c), kb + off + vi * VN, ok);
            cp_async16(slot(st, i, 1, c), vb + off + vi * VN, ok);
          }
        }
      }
    };
    const int n_tiles = (n_list + T_tile - 1) / T_tile;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_tiles) issue(s, s);
      cp_async_commit();
    }
    if (!have_q) {
      if (q_bf16)
        load_q(uint16_t());
      else
        load_q(float());
      have_q = true;
    }
    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait<kStages - 2>();  // tile it has landed (this thread's)
      if (it + kStages - 1 < n_tiles)
        issue(it + kStages - 1, (it + kStages - 1) % kStages);
      cp_async_commit();
      const int st = it % kStages;
      const int jb = it * T_tile + sid;

      // scores of this stream's kR slots for every head: each lane's
      // partial dot over its chunk, then summed over the TG lanes
      float dot[kR * NG];
      bool ok[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        ok[i] = jb + i * NS < n_list;
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
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) d += qr[g][e] * kf[e];
          dot[i * NG + g] = d;
        }
      }
      // every level shuffles and a select drops the levels past TG, so no
      // branch splits the sums, whose shuffle chains then overlap
#pragma unroll
      for (int v = 0; v < kR * NG; ++v)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float o = __shfl_xor_sync(0xffffffffu, dot[v], off);
          dot[v] += off < TG ? o : 0.f;
        }
      float s[kR][NG];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float x = dot[i * NG + g];
          s[i][g] = ok[i] ? (softcap > 0.f ? tanhf(x) * cap : x) : kNegInf;
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
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += s[i][g] * vf[e];
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every thread's reads of the ring are done
  }

  if (n_valid == 0) {  // nothing valid here: an empty split
    for (int g = tid; g < NG; g += kThreads) {
      m_s[g] = kNegInf;
      l_s[g] = 0.f;
    }
  } else {
    // combine the token streams of a warp: lanes of one chunk, xor over
    // the stream bits of the lane index
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      if (off < TG) continue;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mn = fmaxf(m[g], mo);
        const float a = exp2f(m[g] - mn), bo = exp2f(mo - mn);
        m[g] = mn;
        l[g] = l[g] * a + lo_ * bo;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = acc[g][e] * a +
                      __shfl_xor_sync(0xffffffffu, acc[g][e], off) * bo;
      }
    }
    // then the warps, through shared memory (the ring's bytes, now free)
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
            for (int e = 0; e < VN; ++e)
              rg[vi * VN + e] = acc[g][c * VN + e];
          }
        }
        if (gl == 0) {
          rg[D] = m[g];
          rg[D + 1] = l[g];
        }
      }
    }
    __syncthreads();
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
      state[e] = sum_a;
      if (d == 0) {
        m_s[g] = mx;
        l_s[g] = sum_l;
      }
    }
  }

  // merge across the cluster: block z takes outputs z * kThreads + tid,
  // stepping by n_split * kThreads, and walks the splits once in split
  // order with a running maximum of the non-empty ones (l > 0): num and den
  // are rescaled by 2^(m_old - m) as it grows, and each split is added with
  // weight 2^(m_z - m); the output is num / den.  The reads of kMergeBatch
  // splits are issued together, whatever the splits hold (an empty split's
  // acc, never written, is dropped by a select, not a branch).  With no
  // valid slot in any split, every slot has the same finite NEG_INF score
  // in the reference, so its softmax weights are uniform: the output is
  // the mean of V over all S slots.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's state is in its block's shared memory
  const size_t ob = ((static_cast<size_t>(b) * H + h) * G + g0) * D;
  for (int e = z * kThreads + tid; e < ng * D; e += n_split * kThreads) {
    const int g = e / D;
    float mx = kNegInf, den = 0.f, num = 0.f;
    for (int z0 = 0; z0 < n_split; z0 += kMergeBatch) {
      float mz[kMergeBatch], lz[kMergeBatch], az[kMergeBatch];
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        const float* st = cluster.map_shared_rank(
            state, static_cast<unsigned>(min(z0 + i, n_split - 1)));
        mz[i] = st[NG * D + g];
        lz[i] = st[NG * D + NG + g];
        az[i] = st[e];
      }
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        const bool live = z0 + i < n_split && lz[i] > 0.f;
        const float mn = live ? fmaxf(mx, mz[i]) : mx;
        const float a = exp2f(mx - mn);
        const float w = live ? exp2f(mz[i] - mn) : 0.f;
        den = den * a + (live ? lz[i] * w : 0.f);
        num = num * a + (live ? az[i] * w : 0.f);
        mx = mn;
      }
    }
    float o;
    if (den > 0.f) {
      o = num / den;
    } else {  // nothing valid: the mean of V over all S slots
      const T* vd = v + base + (e - g * D);
      float sum = 0.f;
      for (int s = 0; s < S; ++s) sum += load_one(vd + s * row_stride);
      o = sum / S;
    }
    if (q_bf16)
      store_one(static_cast<uint16_t*>(out) + ob + e, o);
    else
      store_one(static_cast<float*>(out) + ob + e, o);
  }
  cluster.sync();  // no block leaves while another reads its state
}

template <typename T, int NG>
cudaError_t launch(const void* q, int q_bf16, const void* k, const void* v,
                   const void* kv_pos, void* out, int B, int S, int H, int G,
                   int D, int lo, int hi, int n_split, int chunk, int q_pos,
                   int window, float softcap, float scale, cudaStream_t s) {
  const int n_vec = D * static_cast<int>(sizeof(T)) / 16;
  // lanes per row: its chunks over CH a lane, rounded up to a power of two
  const int lanes = (n_vec + Row<T>::CH - 1) / Row<T>::CH;
  int tg_log2 = 0;
  while ((1 << tg_log2) < lanes && tg_log2 < 5) ++tg_log2;
  const size_t smem = ring_bytes<T, NG>(D) + (kList + kWarps) * sizeof(int) +
                      static_cast<size_t>(NG) * (D + 2) * sizeof(float);
  // above 48 KB a kernel must opt in, and a cluster above 8 blocks too
  // (host calls, not stream operations)
  auto* kernel = decode_attn_kernel<T, NG>;
  cudaError_t err = cudaSuccess;
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
  cfg.gridDim = dim3(H * ((G + NG - 1) / NG), B, n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n_split;  // the splits of one (gc, b, h)
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q, q_bf16,
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           static_cast<const int*>(kv_pos), out, S, H, G, D,
                           lo, hi, chunk, q_pos, window, softcap, scale,
                           tg_log2);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, int, const void*, const void*,
                               const void*, void*, int, int, int, int, int,
                               int, int, int, int, int, int, float, float,
                               cudaStream_t);

// heads per block: 1, 2, 4, 5 or 8 (index 0..4)
Launch launch_for(int kv_dtype, int ng) {
  static const Launch kTable[2][5] = {
      {launch<float, 1>, launch<float, 2>, launch<float, 4>,
       launch<float, 5>, launch<float, 8>},
      {launch<uint16_t, 1>, launch<uint16_t, 2>, launch<uint16_t, 4>,
       launch<uint16_t, 5>, launch<uint16_t, 8>}};
  const int idx = ng == 1   ? 0
                  : ng == 2 ? 1
                  : ng == 4 ? 2
                  : ng == 5 ? 3
                  : ng == 8 ? 4
                            : -1;
  if (kv_dtype < 0 || kv_dtype > 1 || idx < 0) return nullptr;
  return kTable[kv_dtype][idx];
}

}  // namespace

extern "C" {

// q_dtype (q and out) and kv_dtype (k and v): 0 = float32, 1 = bfloat16.
// kv_pos null selects the TPU kernel's form (slots [lo, hi), q_pos =
// kv_len - 1); otherwise the ring form over [0, S).  The slot range is cut
// into n_split (<= 16) splits of chunk slots, one cluster of n_split blocks
// per (head chunk, b, h); heads_per_block (1, 2, 4, 5 or 8) sets the query
// heads a block computes.  Returns the CUDA error code of the launch (0 =
// launched).  Shapes and pointers are checked by the Python wrapper; the
// caller owns every buffer.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* kv_pos, void* out, int q_dtype, int kv_dtype,
                     int B, int S, int H, int G, int D, int lo, int hi,
                     int n_split, int chunk, int heads_per_block, int q_pos,
                     int window, float softcap, float scale, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Launch fn = launch_for(kv_dtype, heads_per_block);
  if (q_dtype < 0 || q_dtype > 1 || fn == nullptr || n_split < 1 ||
      n_split > kMaxCluster || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  err = fn(q, q_dtype, k, v, kv_pos, out, B, S, H, G, D, lo, hi, n_split,
           chunk, q_pos, window, softcap, scale,
           static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

const char* decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
