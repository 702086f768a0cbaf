// Flash attention forward for Hopper (sm_90a): blockwise online-softmax
// attention with causal and sliding-window masks and GQA.  Two kernels: bf16
// q, k and v run on the tensor cores (`flash_attention_mma_kernel`), f32 on
// the CUDA cores (`flash_attention_kernel`).
//
// Replaces the TPU kernel `flash_attention_fwd` in
// src/repro/kernels/flash_attention.py (its `pl.pallas_call` body
// `_kernel`).  Same contract: q [B, Sq, H, hd]; k/v [B, Sk, KV, hd]; q, k
// and v of one dtype (bf16 or f32); o [B, Sq, H, hd] in q's dtype.  Query
// head h reads kv head h / (H / KV); the repeated kv heads are never
// materialized.  Row qp sees key kp when qp < Sq, kp < Sk, qp >= kp (causal)
// and qp - kp < window (window > 0).  Scores are (q . k) * scale, masked to
// -inf; the online softmax keeps (m, l, acc) in f32 with the TPU kernel's
// guards: m_safe = max(m, -1e30), corr = exp(max(m_prev, -1e30) - m_safe),
// o = acc / max(l, 1e-30).  As the TPU kernel casts q, k and v to f32 and
// keeps p in f32 for P.V, so do both kernels: no TF32, and p is never
// rounded to one bf16 value (that would be `attention_chunked`'s function).
//
// What bounds it on the H100: operations.  At the `internlm2-1.8b` shape (B
// 2, S 4096, H 16, KV 8, hd 128, causal) the visible pairs need
// 4 * B * H * hd * pairs = 137 GFLOP against about 100 MB of q, k, v and o:
// 0.139 ms at 989 TFLOP/s (bf16 dense tensor cores) against 0.030 ms of
// memory traffic.
//
// The bf16 kernel (FlashAttention-2's warp layout on `mma.sync`):
//  - one block of 4 warps per (head, batch, 64-row q-tile); each warp owns
//    16 query rows.  q-tiles are walked last first (blockIdx.z reversed), so
//    the longest causal tiles start in the first wave;
//  - Q.K^T: bf16 `mma.sync` m16n8k16 with f32 accumulators; the product of
//    two bf16 values is exact in f32, so only the order of the sums differs
//    from the TPU kernel's f32 product.  Then scale, then the mask;
//  - the online softmax runs on the score fragments in registers: a row's
//    max reduces over the 4 lanes of a quad (2 shuffles), its sum stays a
//    per-lane partial until the end, and the accumulator's rescale is
//    skipped when the warp's every corr is 1 (a multiply by 1 is exact);
//  - P.V keeps p's f32 value: p is split exactly into three bf16 pieces
//    (bf16x3_mma.cuh), packed straight from the score fragments into A
//    fragments, and three `mma`s per V fragment add p1.v, p2.v and p3.v,
//    each exact, into one f32 accumulator, four output tiles at a time so
//    that no two dependent products are adjacent;
//  - K and V tiles (64 keys; 32 at hd 256) come in through 16-byte
//    `cp.async` copies into a 2-stage ring of XOR-swizzled tiles read with
//    `ldmatrix`: tile j + 1 is in flight while tile j is computed, and K
//    and V wait on separate groups, so V's copy also overlaps Q.K^T.  Rows
//    past Sq or Sk are zero-filled by the copy;
//  - k-blocks wholly masked for the tile are never visited (the TPU
//    kernel's causal and window tests); a warp skips a k-block wholly masked
//    for its 16 rows; the element mask runs only on blocks that cross the
//    diagonal, the window's edge or the ragged tail;
//  - Q fragments stay in registers at hd <= 128 (loaded once); at hd 256 the
//    f32 accumulator alone is 128 registers a lane, so they are re-read from
//    shared memory with `ldmatrix`, and Q.K^T runs in two passes of 8
//    unrolled k-steps (a full unroll spills); each lane addresses a tile
//    with two registers an operand (`LdsmRow`).
// The design issues 4 units of tensor work per (pair, head dim) where the
// function needs 2 (Q.K^T once, P.V three times), so its floor is twice the
// bound; `mma.sync` runs below `wgmma`'s rate, which is later work.
//
// The f32 kernel runs both products as f32 FMAs on the CUDA cores (67
// TFLOP/s peak; a tensor-core version would need TF32, which would change
// the function, or nine bf16 products): one thread block per (q-tile, head,
// batch), BQ query rows (64; 32 at hd 256) against BK = 32 keys at a time,
// 256 threads as 16 x 16, q/k/v tiles widened to f32 in padded shared rows,
// the probabilities through a small shared tile to the P.V loop; k-blocks
// wholly masked are skipped as above.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "bf16x3_mma.cuh"

namespace {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kBK = 32;            // keys per k-block
constexpr float kNegBig = -1e30f;

// Query rows of a tile per head dim: 64, or 32 at hd 256 (registers and
// shared memory, see the note above).
template <int HD> struct QTile { static constexpr int BQ = HD == 256 ? 32 : 64; };

template <int HD, int BQ>
constexpr int smem_floats() {
  return BQ * (HD + 4) + kBK * (HD + 4) + kBK * HD + BQ * (kBK + 1);
}

// Rows [start, start + ROWS) of a [*, row_stride] f32 tensor (HD contiguous
// elements a row) into dst[ROWS][STRIDE]; rows at or past `limit` are
// zero-filled.
template <int HD, int ROWS, int STRIDE>
__device__ __forceinline__ void load_tile(const float* __restrict__ base,
                                          int64_t row_stride, int start,
                                          int limit, float* dst) {
  constexpr int kPerRow = HD / 4;                 // 16-byte loads a row
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx - r * kPerRow) * 4;
    float4* d = reinterpret_cast<float4*>(dst + r * STRIDE + c);
    const int row = start + r;
    *d = row < limit ? __ldg(reinterpret_cast<const float4*>(
                           base + (int64_t)row * row_stride + c))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int HD, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Sq, int Sk, int H, int KV, int causal, int window,
                       float scale) {
  constexpr int BK = kBK;
  constexpr int RPT = BQ / 16;   // query rows a thread
  constexpr int CPT = BK / 16;   // score columns a thread (keys tx + 16 j)
  constexpr int DPT = HD / 16;   // output columns a thread (d = tx + 16 j)
  constexpr int QS = HD + 4;     // padded row stride of the q and k tiles
  constexpr int PS = BK + 1;     // padded row stride of the p tile
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][QS]
  float* Ks = Qs + BQ * QS;                      // [BK][QS]
  float* Vs = Ks + BK * QS;                      // [BK][HD]
  float* Ps = Vs + BK * HD;                      // [BQ][PS]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int64_t q_stride = (int64_t)H * HD, k_stride = (int64_t)KV * HD;
  const float* qb = q + ((int64_t)b * Sq * H + h) * HD;
  const float* kb = k + ((int64_t)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((int64_t)b * Sk * KV + kvh) * HD;

  load_tile<HD, BQ, QS>(qb, q_stride, q_start, Sq, Qs);

  float acc[RPT][DPT], m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const int nk = (Sk + BK - 1) / BK;
  // causal: blocks past the tile's last row are wholly masked
  const int kb_end = causal ? min(nk, (q_start + BQ - 1) / BK + 1) : nk;
  for (int kbi = 0; kbi < kb_end; ++kbi) {
    const int k_start = kbi * BK;
    // window: blocks wholly before every row's window (the TPU test)
    if (window && !(q_start - (k_start + BK - 1) < window)) continue;
    __syncthreads();   // the last block's readers of Ks, Vs, Ps are done
    load_tile<HD, BK, QS>(kb, k_stride, k_start, Sk, Ks);
    load_tile<HD, BK, HD>(vb, k_stride, k_start, Sk, Vs);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * RPT + i) * QS + d);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q_start + ty * RPT + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = k_start + tx + 16 * j;
        bool ok = qp < Sq && kp < Sk;
        if (causal) ok = ok && qp >= kp;
        if (window) ok = ok && qp - kp < window;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = fmaxf(m_new, kNegBig);     // fully-masked rows
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = expf(s[i][j] - m_safe);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(fmaxf(m[i], kNegBig) - m_safe);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        Ps[(ty * RPT + i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty * RPT + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q_start + ty * RPT + i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + ((int64_t)b * Sq + qp) * q_stride + (int64_t)h * HD;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[tx + 16 * j] = acc[i][j] / den;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int KV, int causal, int window,
               float scale, cudaStream_t stream) {
  constexpr int BQ = QTile<HD>::BQ;
  constexpr size_t bytes = smem_floats<HD, BQ>() * sizeof(float);
  auto kern = flash_attention_kernel<HD, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KV,
      causal, window, scale);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Sk, int H, int KV, int hd, int causal,
                 int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_f32<32>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                   window, scale, stream);
    case 64: return launch_f32<64>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                   window, scale, stream);
    case 128: return launch_f32<128>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                     window, scale, stream);
    case 256: return launch_f32<256>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                     window, scale, stream);
    default: return -1;
  }
}

// ------------------------------------------------------------------------
// bf16 q, k, v: the tensor-core kernel (see the note at the top)
// ------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;   // q rows a block, 16 a warp

template <int HD> struct MmaTile {
  static constexpr int BK = HD == 256 ? 32 : 64;     // keys a k-block
  static constexpr bool kQRegs = HD <= 128;          // Q fragments held
  static constexpr int kSmemBytes =
      (kMmaBQ + 2 * 2 * BK) * HD * (int)sizeof(bf16);  // Q, 2 x (K, V)
};

// ROWS rows from `start` of a [*, row_stride] bf16 tensor (HD contiguous
// elements a row) into a swizzled [ROWS][HD] tile, by 16-byte `cp.async`
// copies; rows at or past `limit` are zero-filled.
template <int ROWS, int HD>
__device__ __forceinline__ void async_tile(const bf16* __restrict__ base,
                                           int64_t row_stride, int start,
                                           int limit, bf16* tile) {
  constexpr int CPR = HD / 8;
  static_assert(ROWS * CPR % kMmaThreads == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / kMmaThreads; ++i) {
    const int idx = threadIdx.x + i * kMmaThreads;
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = start + r < limit;
    const bf16* src = ok ? base + (int64_t)(start + r) * row_stride + c * 8
                         : base;
    bf16x3::cp_async16(tile + bf16x3::swz<CPR>(r, c) * 8, src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           int Sq, int Sk, int H, int KV, int causal,
                           int window, float scale) {
  using T = MmaTile<HD>;
  constexpr int BK = T::BK;
  constexpr int CPR = HD / 8;     // 16-byte chunks a row
  constexpr int KT = HD / 16;     // k-steps of Q.K^T
  constexpr int NT = BK / 8;      // 8-key score tiles
  constexpr int OT = HD / 8;      // 8-column output tiles
  extern __shared__ uint4 smem_mma[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_mma);      // [BQ][HD]
  bf16* Ks = Qs + kMmaBQ * HD;                       // [2][BK][HD]
  bf16* Vs = Ks + 2 * BK * HD;                       // [2][BK][HD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kMmaBQ;  // longest first
  const int w0 = q0 + 16 * warp;                         // the warp's rows
  const int kvh = h / (H / KV);
  const int64_t q_stride = (int64_t)H * HD, k_stride = (int64_t)KV * HD;
  const bf16* qb = q + ((int64_t)b * Sq * H + h) * HD;
  const bf16* kb = k + ((int64_t)b * Sk * KV + kvh) * HD;
  const bf16* vb = v + ((int64_t)b * Sk * KV + kvh) * HD;

  // the TPU kernel's block skips: causal blocks past the tile's last row,
  // windowed blocks before every row's window
  const int nk = (Sk + BK - 1) / BK;
  const int kb_end = causal ? min(nk, (q0 + kMmaBQ - 1) / BK + 1) : nk;
  const int kb_lo = window ? max(0, q0 - window + 1) / BK : 0;
  const int n_it = kb_end - kb_lo;

  // groups in flight, in order: Q, then K_j and V_j for each k-block
  async_tile<kMmaBQ, HD>(qb, q_stride, q0, Sq, Qs);
  bf16x3::cp_async_commit();
  if (n_it > 0) {
    async_tile<BK, HD>(kb, k_stride, kb_lo * BK, Sk, Ks);
    bf16x3::cp_async_commit();
    async_tile<BK, HD>(vb, k_stride, kb_lo * BK, Sk, Vs);
    bf16x3::cp_async_commit();
  }

  uint32_t qf[T::kQRegs ? KT : 1][4];
  float acc[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // each lane's ldmatrix row: Q (A), K (B), V (B, transposed)
  const bf16x3::LdsmRow<CPR> qrow(16 * warp + (lane & 15), lane >> 4);
  const bf16x3::LdsmRow<CPR> krow((lane & 7) + ((lane >> 4) << 3),
                                  (lane >> 3) & 1);
  const bf16x3::LdsmRow<CPR> vrow((lane & 7) + (((lane >> 3) & 1) << 3),
                                  lane >> 4);

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int k_start = (kb_lo + it) * BK;
    bf16x3::cp_async_wait<1>();      // Q and K_it have landed
    __syncthreads();                 // ... for every thread; stage st ^ 1 free
    if (it + 1 < n_it) {
      async_tile<BK, HD>(kb, k_stride, k_start + BK, Sk,
                         Ks + (st ^ 1) * BK * HD);
      bf16x3::cp_async_commit();
      async_tile<BK, HD>(vb, k_stride, k_start + BK, Sk,
                         Vs + (st ^ 1) * BK * HD);
      bf16x3::cp_async_commit();
    } else {
      bf16x3::cp_async_commit();     // empty groups keep the count uniform
      bf16x3::cp_async_commit();
    }
    if constexpr (T::kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          bf16x3::ldsm_x4(qf[kk], Qs + qrow.at(kk));
      }
    }
    const bf16* Kt = Ks + st * BK * HD;
    const bf16* Vt = Vs + st * BK * HD;
    // this warp's rows: none past Sq, not all masked in this k-block
    bool live = w0 < Sq;
    if (causal) live = live && k_start <= w0 + 15;
    if (window) live = live && w0 - (k_start + BK - 1) < window;

    float s[NT][4];
    if (live) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
      // at hd 256 a full unroll hoists enough fragment loads to spill;
      // two passes of 8 k-steps do not (ptxas, H100 runs)
#pragma unroll(T::kQRegs ? KT : 8)
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[4];
        if constexpr (T::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          bf16x3::ldsm_x4(a, Qs + qrow.at(kk));
        }
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          uint32_t bk[4];
          bf16x3::ldsm_x4(bk, Kt + 16 * n2 * HD + krow.at(kk));
          bf16x3::mma(s[2 * n2], a, bk[0], bk[1]);
          bf16x3::mma(s[2 * n2 + 1], a, bk[2], bk[3]);
        }
      }
      // scale, then the mask where the block crosses the diagonal, the
      // window's edge or the ragged tail
      const bool masked = k_start + BK > Sk ||
                          (causal && k_start + BK - 1 > w0) ||
                          (window && w0 + 15 - k_start >= window);
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[t][e] * scale;
          if (masked) {
            const int qp = w0 + gid + (e >> 1) * 8;
            const int kp = k_start + 8 * t + 2 * tig + (e & 1);
            bool ok = kp < Sk;
            if (causal) ok = ok && qp >= kp;
            if (window) ok = ok && qp - kp < window;
            x = ok ? x : -INFINITY;
          }
          s[t][e] = x;
        }
      // online softmax, rows gid (r = 0) and gid + 8 (r = 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int t = 0; t < NT; ++t)
          mx = fmaxf(mx, fmaxf(s[t][2 * r], s[t][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float m_safe = fmaxf(m_new, kNegBig);   // fully-masked rows
        const float corr = expf(fmaxf(m[r], kNegBig) - m_safe);
        float rs = 0.f;
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[t][e] = expf(s[t][e] - m_safe);
            rs += s[t][e];
          }
        l[r] = l[r] * corr + rs;                      // this lane's columns
        m[r] = m_new;
        if (__any_sync(0xffffffffu, corr != 1.f)) {   // x 1 is exact
#pragma unroll
          for (int t = 0; t < OT; ++t) {
            acc[t][2 * r] *= corr;
            acc[t][2 * r + 1] *= corr;
          }
        }
      }
    }
    bf16x3::cp_async_wait<2>();      // V_it has landed
    __syncthreads();
    if (live) {
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        // p over keys 16 ks .. 16 ks + 15 as three exact bf16 A fragments
        uint32_t p1[4], p2[4], p3[4];
        bf16x3::split3_pack(s[2 * ks][0], s[2 * ks][1], p1[0], p2[0], p3[0]);
        bf16x3::split3_pack(s[2 * ks][2], s[2 * ks][3], p1[1], p2[1], p3[1]);
        bf16x3::split3_pack(s[2 * ks + 1][0], s[2 * ks + 1][1], p1[2], p2[2],
                            p3[2]);
        bf16x3::split3_pack(s[2 * ks + 1][2], s[2 * ks + 1][3], p1[3], p2[3],
                            p3[3]);
        bf16x3::pv_bf16x3<HD>(acc, p1, p2, p3, Vt + 16 * ks * HD, vrow);
      }
    }
  }
  bf16x3::cp_async_wait<0>();        // nothing in flight past the end

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qp = w0 + gid + 8 * r;
    if (qp >= Sq) continue;
    const float den = fmaxf(lr, 1e-30f);
    bf16* orow = o + ((int64_t)b * Sq + qp) * q_stride + (int64_t)h * HD +
                 2 * tig;
#pragma unroll
    for (int t = 0; t < OT; ++t)
      *reinterpret_cast<uint32_t*>(orow + 8 * t) =
          bf16x3::pack(acc[t][2 * r] / den, acc[t][2 * r + 1] / den);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int KV, int causal, int window,
               float scale, cudaStream_t stream) {
  constexpr int bytes = MmaTile<HD>::kSmemBytes;
  const int nq = (Sq + kMmaBQ - 1) / kMmaBQ;
  if (nq > 65535) return -1;
  auto kern = flash_attention_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(H, B, nq), kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, H, KV,
      causal, window, scale);
  return (int)cudaGetLastError();
}

int dispatch_mma(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Sk, int H, int KV, int hd, int causal,
                 int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_mma<32>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                   window, scale, stream);
    case 64: return launch_mma<64>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                   window, scale, stream);
    case 128: return launch_mma<128>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                     window, scale, stream);
    case 256: return launch_mma<256>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                     window, scale, stream);
    default: return -1;
  }
}

}  // namespace

// Returns 0 on success, -1 for a shape the kernel does not take, else the
// cudaError_t of the launch.  Allocates nothing; runs on `stream`.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int KV, int hd,
                                      int is_bf16, int causal, int window,
                                      float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV || B > 65535 ||
      H > 65535 || window < 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)   // the tensor-core kernel
    return dispatch_mma(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, window,
                        scale, s);
  return dispatch_f32(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, window,
                      scale, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
