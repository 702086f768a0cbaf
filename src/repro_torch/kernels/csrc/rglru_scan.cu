// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t,
// as a chunked scan across threads, and its reversed adjoint with the
// backward's elementwise passes taken in.
//
// Replaces the TPU kernel `rglru_scan_kernel` in
// src/repro/kernels/rglru_scan.py (its `pl.pallas_call` body `_kernel`) and,
// in `rglru_scan_bwd_launch`, the reversed call of it in JAX's `_rg_bwd`
// (src/repro/kernels/ops.py) together with the XLA passes around it.
//
// The function (kernels/rglru_scan.py states it and its plain version
// computes it the same way): time is cut into chunks of L steps (the
// module's SCAN_CHUNK), counted from the scan's first step.  For chunk k,
// P_k is the product of its a's and H_k its scan from a -0 state; the
// carries are c_0 = h0, c_{k+1} = P_k * c_k + H_k; each chunk is then run
// again from c_k, writing y.  Every multiply and every add is rounded on
// its own (`__fmul_rn`, `__fadd_rn`, never an FMA), so the kernels equal
// their plain versions bit for bit.  At S <= L this is the sequential scan.
//
//  - rglru_scan_launch: a, b [B, S, W] f32; h0 [B, W] f32 (null: zeros) ->
//    y [B, S, W] (every h_t), h_last [B, W].
//  - rglru_scan_bwd_launch: the VJP of the forward scan.  From a, the
//    forward's y, h0, dy and dh_last it runs, from t = S - 1 down to 0,
//    lam_t = a_{t+1} * lam_{t+1} + dy_t (a_S = 0; dy_{S-1} + dh_last
//    rounded once at the start), and writes db = lam, da = lam * y_{t-1}
//    (h0 at t = 0) and, when asked for, dh0 = lam_0 * a_0.  It moves 20
//    bytes an element where the reversed scan (12) and the four passes
//    around it (a shifted copy of a, a copy of dy, a shifted copy of y,
//    the product: 36) moved 48.
//
// What bounds it on the H100: memory.  The forward reads a and b and
// writes y once (12 bytes an element), the backward 20; two or three
// operations an element are far below the card's operations per byte.
// A sequential scan is latency-bound instead: one thread per (b, w)
// channel carries an S-step dependent chain, and the main path's
// [8, 256, 2560] gives 20 480 such threads, under 8% of the card's
// resident-thread slots.
//
// What the design does about it:
//  - a block covers 32 consecutive w of one batch row (so a warp's load
//    or store of one step is one 128-byte line) and 8 chunks, one warp
//    each: 256 threads, and B * ceil(W / 32) blocks (640 at the main
//    path, 163 840 threads);
//  - phase 1: a lane issues every load of its chunk (they do not depend
//    on h) into registers, then computes (P, H); phase 2: warp 0 carries
//    across the block's 8 chunks in order through shared memory; phase
//    3: each lane runs its chunk again from c_k out of its registers and
//    stores.  The dependent chain is 2L + 8 steps a group of 8 chunks,
//    not S; DRAM traffic stays one read and one write an element;
//  - past 8 chunks (S > 8L) the block loops over groups of 8 chunks,
//    the carry kept in shared memory between them;
//  - a ragged last chunk is padded with identity steps (a = 1, b = -0),
//    which leave every h bit for bit; lanes past W load identities and
//    store nothing.
// L is fixed at compile time (kChunk = 16, the module's SCAN_CHUNK; the
// entries reject any other chunk length).  At the main path's
// [8, 256, 2560], 32 measured as fast as 16 or slower and 64 slower
// (PERF.md, section 6); at 16 the kernels take 62 (forward) and 80
// (backward) registers, 4 and 3 blocks an SM.  Keeping a chunk's inputs
// in registers measured faster than reading them again from L2 in phase 3
// under a register cap for more blocks an SM; streaming (evict-first)
// loads and stores measured no faster beyond the noise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;               // w per block
constexpr int kChunks = 8;               // chunks per group, one warp each
constexpr int kChunk = 16;               // L: steps per chunk (SCAN_CHUNK)
constexpr int kThreads = kLanes * kChunks;

struct Args {
  const float* a;        // [B, S, W]
  const float* b;        // forward: b; backward: dy
  const float* y;        // backward: the forward's y
  const float* h0;       // [B, W] or null (zeros)
  const float* dh_last;  // backward: [B, W]
  float* out;            // forward: y; backward: db = lam
  float* da;             // backward: lam * y_{t-1}
  float* h_out;          // forward: h_last; backward: dh0 or null
  int B, S, W;
};

template <bool kBwd>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const Args args) {
  constexpr int L = kChunk;
  __shared__ float sP[kChunks][kLanes];
  __shared__ float sH[kChunks][kLanes];
  __shared__ float sC[kChunks][kLanes];
  __shared__ float sCarry[kLanes];
  const int S = args.S, W = args.W;
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const int tiles = (W + kLanes - 1) / kLanes;
  const int64_t bi = blockIdx.x / tiles;
  const int w = (blockIdx.x - (int)(bi * tiles)) * kLanes + lane;
  const bool in_w = w < W;
  const int64_t bw = bi * W + w;         // element (bi, w) of [B, W]
  const int64_t base = bi * S * W + w;   // element (bi, t, w) at base + t W
  const int n = (S + L - 1) / L;
  // c_0: h0 going forward; the adjoint scan starts from zero
  if (warp == 0) {
    sCarry[lane] = (!kBwd && args.h0 && in_w) ? args.h0[bw] : 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kChunks) {
    const int k = k0 + warp;
    float av[L], bv[L], yv[kBwd ? L : 1];
    // phase 1: every load of the chunk (none depends on h), into
    // registers: forward a_t and b_t; backward, from t = S - 1 down,
    // a_{t+1} (0 at the first step), dy_t (+ dh_last at the first step)
    // and y_{t-1}.  Identity steps (a = 1, b = -0) past S or W.
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int s = k * L + i;
      const bool ok = in_w && s < S;
      const int t = kBwd ? S - 1 - s : s;
      av[i] = 1.f;
      bv[i] = -0.f;
      if (ok) {
        if constexpr (kBwd) {
          av[i] = s == 0 ? 0.f : args.a[base + (int64_t)(t + 1) * W];
          bv[i] = args.b[base + (int64_t)t * W];
          if (s == 0) bv[i] = __fadd_rn(bv[i], args.dh_last[bw]);
          yv[i] = t > 0 ? args.y[base + (int64_t)(t - 1) * W]
                        : (args.h0 ? args.h0[bw] : 0.f);
        } else {
          av[i] = args.a[base + (int64_t)t * W];
          bv[i] = args.b[base + (int64_t)t * W];
        }
      }
    }
    // (P, H); H from -0, so that a run of -0 states stays -0 across
    // chunks as in the sequential scan
    float P = 1.f, H = -0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      P = __fmul_rn(av[i], P);
      H = __fadd_rn(__fmul_rn(av[i], H), bv[i]);
    }
    sP[warp][lane] = P;
    sH[warp][lane] = H;
    __syncthreads();
    // phase 2: the carries of this group's chunks, in order
    if (warp == 0) {
      float c = sCarry[lane];
      const int m = min(kChunks, n - k0);
      for (int j = 0; j < m; ++j) {
        sC[j][lane] = c;
        c = __fadd_rn(__fmul_rn(sP[j][lane], c), sH[j][lane]);
      }
      sCarry[lane] = c;
    }
    __syncthreads();
    // phase 3: the chunk again from its carry
    if (k < n && in_w) {
      float h = sC[warp][lane];
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int s = k * L + i;
        if (s < S) {
          const int t = kBwd ? S - 1 - s : s;
          h = __fadd_rn(__fmul_rn(av[i], h), bv[i]);
          args.out[base + (int64_t)t * W] = h;
          if constexpr (kBwd) {
            args.da[base + (int64_t)t * W] = __fmul_rn(h, yv[i]);
            if (s == S - 1 && args.h_out) {
              args.h_out[bw] = __fmul_rn(h, args.a[base]);   // dh0
            }
          } else if (s == S - 1) {
            args.h_out[bw] = h;                              // h_last
          }
        }
      }
    }
  }
}

template <bool kBwd>
int launch(const Args& args, int chunk, void* stream) {
  if (chunk != kChunk || args.B <= 0 || args.S <= 0 || args.W <= 0) {
    return -1;
  }
  const int64_t blocks =
      (int64_t)args.B * ((args.W + kLanes - 1) / kLanes);
  if (blocks > 2147483647LL) return -1;
  rglru_scan_kernel<kBwd><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries return 0 on success, -1 for arguments the kernel does not
// take (chunk must be 16), else the cudaError_t of the launch.
// They run on `stream` and allocate nothing.  h0 may be null (zeros).
extern "C" int rglru_scan_launch(const float* a, const float* b,
                                 const float* h0, float* y, float* h_last,
                                 int B, int S, int W, int chunk,
                                 void* stream) {
  const Args args{a, b, nullptr, h0, nullptr, y, nullptr, h_last, B, S, W};
  return launch<false>(args, chunk, stream);
}

// dh0 may be null (not asked for).
extern "C" int rglru_scan_bwd_launch(const float* a, const float* y,
                                     const float* h0, const float* dy,
                                     const float* dh_last, float* da,
                                     float* db, float* dh0, int B, int S,
                                     int W, int chunk, void* stream) {
  const Args args{a, dy, y, h0, dh_last, db, da, dh0, B, S, W};
  return launch<true>(args, chunk, stream);
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
