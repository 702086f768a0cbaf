// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t.
//
// Replaces the TPU kernel `rglru_scan_kernel` in
// src/repro/kernels/rglru_scan.py (its `pl.pallas_call` body `_kernel`).
// Same contract: a, b [B, S, W] f32; h0 [B, W] f32 (null: zeros) ->
// y [B, S, W] f32 holding every h_t, h_last [B, W] f32.  `reverse` runs the
// recurrence from t = S - 1 down to 0 (the adjoint scan of the backward
// pass, with no flipped copies).  The TPU kernel pads time to its block with
// identity steps; a loop over t needs no padding.
//
// What bounds it on the H100: memory, in principle.  It reads a and b and
// writes y once (12 bytes per element) and does 2 operations per element,
// far below the card's operations per byte.  In practice latency: every
// step depends on the one before, so a channel is a chain of S dependent
// multiply-adds, and B * W channels give few threads (20 480 at the main
// path's 8 x 2560: 160 blocks of 128, under 8% of the 132 SMs' 270 336
// resident-thread slots), too few to hide each step's load latency.
//
// What the design does about it:
//  - one thread per (b, w) channel, h kept in a register across the whole
//    time loop; consecutive threads take consecutive w of one (b, t) row,
//    so each warp's loads and stores are coalesced 128-byte lines;
//  - the loads of a and b do not depend on h: `__restrict__` lets the
//    compiler issue the loads of an unrolled group of steps ahead of their
//    multiply-adds, hiding part of the memory latency;
//  - every operation is rounded on its own (`__fmul_rn`, then `__fadd_rn`,
//    never contracted into an FMA), so the kernel equals its plain PyTorch
//    version bit for bit.
// Known limits: one thread per channel leaves most of the card idle at
// small B * W; a chunked scan across threads (carry prefixes) would use it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ h_last, int B, int S, int W,
                  int reverse) {
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= (int64_t)B * W) return;
  const int64_t bi = c / W;
  const int64_t w = c - bi * W;
  // element (bi, t, w) sits at base + t * W
  const int64_t base = bi * S * W + w;
  const int64_t step = reverse ? -(int64_t)W : (int64_t)W;
  int64_t off = base + (reverse ? (int64_t)(S - 1) * W : 0);
  float h = h0 ? h0[c] : 0.f;
  int s = 0;
  for (; s + kUnroll <= S; s += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      av[i] = a[off + i * step];
      bv[i] = b[off + i * step];
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      h = __fadd_rn(__fmul_rn(av[i], h), bv[i]);
      y[off + i * step] = h;
    }
    off += kUnroll * step;
  }
  for (; s < S; ++s) {
    h = __fadd_rn(__fmul_rn(a[off], h), b[off]);
    y[off] = h;
    off += step;
  }
  h_last[c] = h;
}

}  // namespace

// Returns 0 on success, -1 for arguments the kernel does not take, else the
// cudaError_t of the launch.  h0 may be null (zeros).  Runs on `stream`,
// allocates nothing.
extern "C" int rglru_scan_launch(const float* a, const float* b,
                                 const float* h0, float* y, float* h_last,
                                 int B, int S, int W, int reverse,
                                 void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return -1;
  const int64_t channels = (int64_t)B * W;
  const int64_t blocks = (channels + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return -1;
  rglru_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, y, h_last, B, S, W, reverse);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
