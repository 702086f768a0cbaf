// Flash attention forward for Hopper (sm_90a): blockwise online-softmax
// attention with causal and sliding-window masks and GQA.
//
// Replaces the TPU kernel `flash_attention_fwd` in
// src/repro/kernels/flash_attention.py (its `pl.pallas_call` body
// `_kernel`).  Same contract: q [B, Sq, H, hd]; k/v [B, Sk, KV, hd]; q, k
// and v of one dtype (bf16 or f32); o [B, Sq, H, hd] in q's dtype.  Query
// head h reads kv head h / (H / KV); the repeated kv heads are never
// materialized.  Row qp sees key kp when qp < Sq, kp < Sk, qp >= kp (causal)
// and qp - kp < window (window > 0).  Scores are (q . k) * scale; the online
// softmax keeps (m, l, acc) in f32 with the TPU kernel's guards:
// m_safe = max(m, -1e30), corr = exp(max(m_prev, -1e30) - m_safe),
// o = acc / max(l, 1e-30).  As the TPU kernel casts q, k and v to f32 and
// keeps p in f32 for P.V, so does this kernel: every product is an f32
// multiply-add on the CUDA cores (bf16 inputs are widened exactly; no TF32,
// and p is never rounded to bf16, which would be `attention_chunked`'s
// function, not this one).
//
// What bounds it on the H100: operations.  At the main shape (B 2, S 4096,
// H 16, KV 8, hd 128, causal) the visible pairs need 2 * B * H * S^2 * hd =
// 137 GFLOP against about 100 MB of q, k, v and o: 0.139 ms at 989 TFLOP/s
// (bf16 dense tensor cores) against 0.030 ms of memory traffic.  This
// kernel runs its products on the f32 CUDA cores (67 TFLOP/s peak), so it
// cannot come within 15x of that bound; a tensor-core version (bf16 Q.K^T
// with mma/wgmma, and P.V with p split exactly into bf16 pieces) is later
// work.
//
// What the design does about it:
//  - the TPU grid's k sweep becomes a loop inside one thread block per
//    (q-tile, head, batch): BQ query rows (64; 32 at hd 256, which keeps
//    the f32 accumulator at 32 registers a thread and the shared tiles at
//    103 KB, two blocks an SM) against BK = 32 keys at a time;
//  - k-blocks wholly masked are skipped with the TPU kernel's tests:
//    causal blocks past the diagonal are never visited, windowed blocks
//    before the window are skipped before they are loaded;
//  - q, k and v tiles are loaded with 16-byte coalesced loads, widened to
//    f32 once, into shared memory rows padded by 4 floats so that the
//    float4 reads of the score loop hit distinct banks;
//  - 256 threads as 16 x 16: a thread holds BQ/16 query rows x 2 score
//    columns (keys tx and tx + 16) and the same rows x hd/16 output columns
//    (d = tx + 16 j); a row's max and sum are reduced with 4 shuffles
//    inside its half-warp, so the row statistics stay in registers;
//  - the probabilities pass through a small shared tile to the P.V loop;
//    rows past Sq and keys past Sk are masked in the kernel (ragged tails,
//    which the TPU kernel gets from pl.cdiv), their tile rows zero-filled.
// Known limits: no tensor cores, no prefetch of the next K/V tile (loads
// and arithmetic alternate between barriers), one block per (q-tile, head)
// re-reads K and V for every q-tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kBK = 32;            // keys per k-block
constexpr float kNegBig = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) { return __float2bfloat16(x); }

// Query rows of a tile per head dim: 64, or 32 at hd 256 (registers and
// shared memory, see the note above).
template <int HD> struct QTile { static constexpr int BQ = HD == 256 ? 32 : 64; };

template <int HD, int BQ>
constexpr int smem_floats() {
  return BQ * (HD + 4) + kBK * (HD + 4) + kBK * HD + BQ * (kBK + 1);
}

// Rows [start, start + ROWS) of a [*, row_stride] tensor (HD contiguous
// elements a row) into dst[ROWS][STRIDE] as f32; rows at or past `limit`
// are zero-filled.
template <typename T, int HD, int ROWS, int STRIDE>
__device__ __forceinline__ void load_tile(const T* __restrict__ base,
                                          int64_t row_stride, int start,
                                          int limit, float* dst) {
  constexpr int kVec = 16 / sizeof(T);            // elements a 16-byte load
  constexpr int kPerRow = HD / kVec;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx - r * kPerRow) * kVec;
    float4* d = reinterpret_cast<float4*>(dst + r * STRIDE + c);
    const int row = start + r;
    if (row < limit) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(
          base + (int64_t)row * row_stride + c));
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int t = 0; t < kVec / 4; ++t)
        d[t] = make_float4(to_f(e[4 * t]), to_f(e[4 * t + 1]),
                           to_f(e[4 * t + 2]), to_f(e[4 * t + 3]));
    } else {
#pragma unroll
      for (int t = 0; t < kVec / 4; ++t) d[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <typename T, int HD, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int H, int KV, int causal, int window,
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
  const T* qb = q + ((int64_t)b * Sq * H + h) * HD;
  const T* kb = k + ((int64_t)b * Sk * KV + kvh) * HD;
  const T* vb = v + ((int64_t)b * Sk * KV + kvh) * HD;

  load_tile<T, HD, BQ, QS>(qb, q_stride, q_start, Sq, Qs);

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
    load_tile<T, HD, BK, QS>(kb, k_stride, k_start, Sk, Ks);
    load_tile<T, HD, BK, HD>(vb, k_stride, k_start, Sk, Vs);
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
    T* orow = o + ((int64_t)b * Sq + qp) * q_stride + (int64_t)h * HD;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int BQ = QTile<HD>::BQ;
  constexpr size_t bytes = smem_floats<HD, BQ>() * sizeof(float);
  auto kern = flash_attention_kernel<T, HD, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Sk, int H, int KV, int hd, int causal, int window,
                float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                  window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                  window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                    window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, KV, causal,
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
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, hd,
                                      causal, window, scale, s);
  return dispatch_hd<float>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, window,
                            scale, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
