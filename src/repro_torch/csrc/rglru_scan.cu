// RG-LRU linear-recurrence scan for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rglru_scan.py::rglru_scan_kernel:
//
//   h[b, t, w] = a[b, t, w] * h[b, t-1, w] + u[b, t, w],   h[b, -1, w] = h0[b, w]
//
//   a, u  (B, T, W)  float32 (the gates of src/repro/models/recurrent.py)
//   h0    (B, W)     float32, or null for a zero state
//   h     (B, T, W)  float32
//
// The TPU kernel tiles T into VMEM chunks along a sequential grid and
// carries h in VMEM scratch between grid steps.  Hopper blocks run in no
// order, so nothing can carry between them: here one thread owns one
// channel (b, w) for the whole of T and carries its state in a register.
// The B * W channels are independent (10,240 at B = 4, W = 2560), and
// neighbouring threads own neighbouring w, so every load and store of a
// warp is one 128-byte line.
//
// Numerics.  Each step is rounded twice, the product and then the sum
// (__fmul_rn / __fadd_rn, which nvcc never fuses into an FMA), in the
// sequential order of the plain version
// (src/repro_torch/kernels/ref.py::rglru_scan_ref), so the two agree bit
// for bit.  h0 enters as the state before step 0: round(a0 * h0) + u0 is
// the reference's fold u0 += a0 * h0 (src/repro/kernels/ref.py:86-87).
//
// What bounds it on an H100: bytes.  a and u are read once and h written
// once, 12 * B * T * W bytes for 2 flops per element.  A plain dependent
// loop would wait a full memory latency per step, so the loads run ahead:
// a thread issues the loads of 16 steps of a and u before the chunk's 16
// multiply-adds, which puts 32 loads per thread in flight.  What it does
// not do yet (later work): keep more bytes in flight than 16 steps per
// thread give (a chunked parallel scan over T, or cp.async into shared
// memory), which at B * W = 10,240 threads leaves it short of the
// bandwidth the card's latency calls for.
//
// Plain C interface, bound with ctypes by src/repro_torch/kernels/rglru_scan.py.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 64;
constexpr int kChunk = 16;  // steps whose loads are issued together

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ u,
                  const float* __restrict__ h0, float* __restrict__ h, int B,
                  int T, int W) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (c >= static_cast<long long>(B) * W) return;
  const long long b = c / W, w = c - b * W;
  const size_t step = static_cast<size_t>(W);
  size_t off = static_cast<size_t>(b) * T * W + w;
  float state = h0 != nullptr ? h0[c] : 0.f;
  int t = 0;
  for (; t + kChunk <= T; t += kChunk) {
    float ra[kChunk], ru[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      ra[i] = a[off + i * step];
      ru[i] = u[off + i * step];
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      state = __fadd_rn(__fmul_rn(ra[i], state), ru[i]);
      h[off + i * step] = state;
    }
    off += kChunk * step;
  }
  for (; t < T; ++t) {
    state = __fadd_rn(__fmul_rn(a[off], state), u[off]);
    h[off] = state;
    off += step;
  }
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 = launched).  Shapes and
// pointers are checked by the Python wrapper; the caller owns every
// buffer.  h0 may be null (zero initial state).
int rglru_scan(const void* a, const void* u, const void* h0, void* h, int B,
               int T, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long channels = static_cast<long long>(B) * W;
  const unsigned blocks =
      static_cast<unsigned>((channels + kThreads - 1) / kThreads);
  rglru_scan_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(u),
      static_cast<const float*>(h0), static_cast<float*>(h), B, T, W);
  return static_cast<int>(cudaGetLastError());
}

const char* rglru_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
