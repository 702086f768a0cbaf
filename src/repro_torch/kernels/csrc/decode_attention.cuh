// Decode attention for Hopper (sm_90a): one query token per slot against its
// KV rows, GQA, online softmax in f32.  The body shared by the dense kernel
// (decode_attention.cu) and the fused paged write+attend kernel
// (paged_decode_attention.cu): the two differ only in how a slot's logical
// row r maps to a row of the K/V storage, a template parameter here.
//
//  - dense: the slot-batched cache [B, C, KV, hd]; row r of slot b is
//    storage row b * C + r;
//  - paged: pools [P, ps, KV, hd] through a page table [B, NP]; row r of
//    slot b is storage row tbl[b, r / ps] * ps + r % ps (64-bit offsets).
//    Each block reads its own slice of the page table.  The new token's
//    K/V row (already cast to the pool dtype) is spliced in from registers
//    at r == pos for active slots, and the block whose range holds pos
//    writes it to its page; scores never depend on that store landing.
//
// With equal block_k the two compute the same arithmetic in the same order,
// so the paged kernel equals the dense kernel bit for bit on the gathered
// view, whatever the page size.
//
// What bounds it on the H100: memory.  Each (slot, kv head) must read its K
// and V rows from lo * block_k up to pos once; a decode step does almost no
// arithmetic per byte (2 * G multiply-adds per cache element), far below the
// ~295 operations per byte where the tensor cores would become the limit.
//
// What the design does about it:
//  - the TPU kernel's grid (slot, kv head, k-block) runs in parallel here:
//    one thread block per (kv head, slot, k-block of block_k rows).  Each
//    block computes its slot's [lo, hi] k-block range from pos exactly as
//    `block_bounds` does and exits at once outside it, so the bytes read
//    scale with the slot's context, not with C, and a long slot is spread
//    over many SMs instead of serializing on one;
//  - the G query heads of the group share every K/V row that is loaded
//    (repeated kv heads are never materialized);
//  - 8 warps split a block's rows; each warp keeps KEYS rows in flight at
//    once, each lane loading a contiguous EPL-element slice of a row with
//    one vector load, and keeps its running max, denominator and
//    accumulator in f32 registers (the -1e30 guards of the TPU kernel);
//    rows past pos (or outside the window) are never loaded, so unmapped
//    pages are never touched;
//  - a block merges its warps and writes one partial (max, denominator,
//    accumulator) per query head to a workspace the wrapper allocates; a
//    second kernel merges the partials of each (slot, kv head) in k-block
//    order — the TPU kernel's sequential k sweep — so the result does not
//    vary from run to run.
// Known limits: each warp still waits for its rows' latency once per KEYS
// rows (no prefetch across iterations), and the scores are reduced with
// warp shuffles rather than tensor-core products.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace decode_attn {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegBig = -1e30f;

// Everything one launch needs.  Dense fills the first block of fields; the
// paged kernel also the second (k/v are then the pools, C = NP * ps).
struct Args {
  const void* q;            // [B, 1, H, hd]
  const void* k;            // dense cache [B, C, KV, hd] or pool [P, ps, KV, hd]
  const void* v;
  const int32_t* pos;       // [B], index of the new token
  void* o;                  // [B, 1, H, hd], q's dtype
  float* ws;                // B * KV * nk * G * (hd + 2) floats
  int B, C, KV, window, ring;
  float softcap, scale;
  int block_k;
  // paged only
  const int32_t* tbl;       // [B, NP] physical page per logical page
  const uint8_t* active;    // [B] slots that write their new row
  const void* new_k;        // [B, KV, hd], pool dtype
  const void* new_v;
  int NP, ps;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) { return __float2bfloat16(x); }

// Load EPL contiguous elements at p (aligned to EPL * sizeof(T)) as floats,
// in 16-, 8- or 4-byte vector loads.
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[EPL]) {
  constexpr int kBytes = sizeof(T) * EPL;
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      uint4 w = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[i * kPer + j] = to_f(e[j]);
    }
  } else if constexpr (kBytes == 8) {
    uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int j = 0; j < EPL; ++j) out[j] = to_f(e[j]);
  } else if constexpr (kBytes == 4) {
    uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p));
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int j = 0; j < EPL; ++j) out[j] = to_f(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < EPL; ++j) out[j] = to_f(p[j]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Is cache row idx visible to the query at absolute position p?  The same
// mask as the TPU kernel and `decode_attention_ref`.
__device__ __forceinline__ bool visible(int idx, int p, int C, int window,
                                        int ring) {
  if (ring) {
    int age = (p - idx) % C;
    if (age < 0) age += C;
    return age < (window ? window : C) && p >= age;
  }
  return idx <= p && (!window || idx > p - window);
}

// Per-slot [lo, hi] k-block range, as `block_bounds`.
__device__ __forceinline__ void bounds(int p, int C, int window, int ring,
                                       int bk, int* lo, int* hi) {
  *hi = (p < C - 1 ? p : C - 1) / bk;
  *lo = (window && !ring) ? (p - window + 1 > 0 ? p - window + 1 : 0) / bk : 0;
}

// Offset, in rows, of a slot's logical row r from the slot's base: dense,
// r (the base is the slot's first cache row); paged, the pool row through
// the slot's page-table row `tbl_row` (the base is the pool's start).
template <bool PAGED>
__device__ __forceinline__ int64_t row_of(const int32_t* tbl_row, int ps,
                                          int r) {
  if constexpr (PAGED) {
    return (int64_t)__ldg(tbl_row + r / ps) * ps + r % ps;
  } else {
    return r;
  }
}

// One block per (kv head h, slot b, k-block j); EPL = hd / 32 elements per
// lane, G query heads per kv head.  Writes the partials of (b, h, j) — G
// maxima, G denominators, G * HD accumulators — at
// ws + ((b * KV + h) * nk + j) * G * (HD + 2).
template <typename TQ, typename TKV, int EPL, int G, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Args a) {
  // fewer registers per key at the widest heads keep the block unspilled
  constexpr int KEYS = (EPL * G >= 32) ? 2 : 4;
  constexpr int HD = 32 * EPL;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int C = a.C;

  __shared__ float s_m[kWarps][G];
  __shared__ float s_l[kWarps][G];
  __shared__ float s_acc[G][HD];

  const int p = a.pos[b];
  const int bk = a.block_k < C ? a.block_k : C;
  int lo, hi;
  bounds(p, C, a.window, a.ring, bk, &lo, &hi);
  if (j < lo || j > hi) return;       // outside this slot's range: no reads
  const int row_begin = j * bk;
  const int row_end = (j + 1) * bk < C ? (j + 1) * bk : C;

  const int64_t row_stride = (int64_t)a.KV * HD;  // between storage rows
  const int32_t* tbl_row = PAGED ? a.tbl + (int64_t)b * a.NP : nullptr;
  const int ps = a.ps;
  // dense: the slot's first row; paged: the pool's first row
  const int64_t base = PAGED ? (int64_t)h * HD + lane * EPL
                             : (int64_t)b * C * row_stride + (int64_t)h * HD +
                                   lane * EPL;
  const TKV* kbase = static_cast<const TKV*>(a.k) + base;
  const TKV* vbase = static_cast<const TKV*>(a.v) + base;

  // paged: an active slot's new row comes from registers at r == p, and
  // the block whose range holds p stores it to the slot's write page (no
  // other block reads that row; other kv heads write other columns)
  const bool splice = PAGED && a.active[b] != 0;
  const int64_t new_off = ((int64_t)b * a.KV + h) * HD;
  if (splice && p >= row_begin && p < row_end) {
    const int64_t dst =
        row_of<PAGED>(tbl_row, ps, p) * row_stride + (int64_t)h * HD;
    const TKV* nk = static_cast<const TKV*>(a.new_k) + new_off;
    const TKV* nv = static_cast<const TKV*>(a.new_v) + new_off;
    TKV* kw = const_cast<TKV*>(static_cast<const TKV*>(a.k));
    TKV* vw = const_cast<TKV*>(static_cast<const TKV*>(a.v));
    for (int t = threadIdx.x; t < HD; t += kThreads) {
      kw[dst + t] = nk[t];
      vw[dst + t] = nv[t];
    }
  }

  const int64_t H = (int64_t)a.KV * G;
  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const TQ* qp = static_cast<const TQ*>(a.q) +
                   ((int64_t)b * H + (int64_t)h * G + g) * HD + lane * EPL;
    load_row<TQ, EPL>(qp, qr[g]);
  }

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int r0 = row_begin + warp * KEYS; r0 < row_end; r0 += kWarps * KEYS) {
    float kr[KEYS][EPL], vr[KEYS][EPL];
    bool ok[KEYS];
#pragma unroll
    for (int i = 0; i < KEYS; ++i) {
      const int r = r0 + i;
      ok[i] = r < row_end && visible(r, p, C, a.window, a.ring);
      if (ok[i]) {
        if (splice && r == p) {
          load_row<TKV, EPL>(static_cast<const TKV*>(a.new_k) + new_off +
                                 lane * EPL, kr[i]);
          load_row<TKV, EPL>(static_cast<const TKV*>(a.new_v) + new_off +
                                 lane * EPL, vr[i]);
        } else {
          const int64_t off = row_of<PAGED>(tbl_row, ps, r) * row_stride;
          load_row<TKV, EPL>(kbase + off, kr[i]);
          load_row<TKV, EPL>(vbase + off, vr[i]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[i][e] = vr[i][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[KEYS];
      float smax = -INFINITY;
#pragma unroll
      for (int i = 0; i < KEYS; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kr[i][e], d);
        d = warp_sum(d) * a.scale;
        if (a.softcap != 0.f) d = tanhf(d / a.softcap) * a.softcap;
        s[i] = ok[i] ? d : -INFINITY;
        smax = fmaxf(smax, s[i]);
      }
      const float m_new = fmaxf(m[g], smax);
      const float m_safe = fmaxf(m_new, kNegBig);  // fully-masked guard
      const float corr = expf(fmaxf(m[g], kNegBig) - m_safe);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int i = 0; i < KEYS; ++i) {
        const float pi = expf(s[i] - m_safe);
        psum += pi;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pi, vr[i][e], acc[g][e]);
      }
      l[g] = l[g] * corr + psum;
      m[g] = m_new;
    }
  }

  // merge the warps: block max, then rescale and add warp by warp
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
  }
  for (int t = threadIdx.x; t < G * HD; t += kThreads) s_acc[t / HD][t % HD] = 0.f;
  __syncthreads();
  const int nk = gridDim.z;
  float* part = a.ws + (((int64_t)b * a.KV + h) * nk + j) * G * (HD + 2);
  float wscale[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    const float m_safe = fmaxf(mx, kNegBig);
    wscale[g] = expf(fmaxf(m[g], kNegBig) - m_safe);
    if (threadIdx.x == 0) {
      float den = 0.f;
      for (int w = 0; w < kWarps; ++w)
        den += s_l[w][g] * expf(fmaxf(s_m[w][g], kNegBig) - m_safe);
      part[g] = mx;
      part[G + g] = den;
    }
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          s_acc[g][lane * EPL + e] += acc[g][e] * wscale[g];
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < G * HD; t += kThreads)
    part[2 * G + t] = s_acc[t / HD][t % HD];
}

// Merge the k-block partials of one (kv head, slot) in k-block order and
// write o = acc / max(denominator, 1e-30) in q's dtype.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
decode_attention_merge(const Args a, int G, int HD, int nk) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int C = a.C;
  const int bk = a.block_k < C ? a.block_k : C;
  int lo, hi;
  bounds(a.pos[b], C, a.window, a.ring, bk, &lo, &hi);
  const int64_t stride = (int64_t)G * (HD + 2);
  const float* base = a.ws + ((int64_t)b * a.KV + h) * nk * stride;
  TQ* o = static_cast<TQ*>(a.o);
  for (int t = threadIdx.x; t < G * HD; t += blockDim.x) {
    const int g = t / HD;
    float mx = -INFINITY;
    for (int j = lo; j <= hi; ++j) mx = fmaxf(mx, base[j * stride + g]);
    const float m_safe = fmaxf(mx, kNegBig);
    float den = 0.f, acc = 0.f;
    for (int j = lo; j <= hi; ++j) {
      const float* part = base + j * stride;
      const float c = expf(fmaxf(part[g], kNegBig) - m_safe);
      den += part[G + g] * c;
      acc += part[2 * G + t] * c;
    }
    o[((int64_t)b * a.KV * G + (int64_t)h * G) * HD + t] =
        from_f<TQ>(acc / fmaxf(den, 1e-30f));
  }
}

template <typename TQ, typename TKV, int EPL, int G, bool PAGED>
void launch(const Args& a, cudaStream_t stream) {
  const int bk = a.block_k < a.C ? a.block_k : a.C;
  const int nk = (a.C + bk - 1) / bk;
  decode_attention_kernel<TQ, TKV, EPL, G, PAGED>
      <<<dim3(a.KV, a.B, nk), kThreads, 0, stream>>>(a);
  decode_attention_merge<TQ><<<dim3(a.KV, a.B), kThreads, 0, stream>>>(
      a, G, 32 * EPL, nk);
}

template <typename TQ, typename TKV, int EPL, bool PAGED>
int dispatch_g(int G, const Args& a, cudaStream_t s) {
  switch (G) {
    case 1: launch<TQ, TKV, EPL, 1, PAGED>(a, s); return 0;
    case 2: launch<TQ, TKV, EPL, 2, PAGED>(a, s); return 0;
    case 4: launch<TQ, TKV, EPL, 4, PAGED>(a, s); return 0;
    case 8: launch<TQ, TKV, EPL, 8, PAGED>(a, s); return 0;
  }
  return -1;
}

template <typename TQ, typename TKV, bool PAGED>
int dispatch_hd(int hd, int G, const Args& a, cudaStream_t s) {
  switch (hd) {
    case 32: return dispatch_g<TQ, TKV, 1, PAGED>(G, a, s);
    case 64: return dispatch_g<TQ, TKV, 2, PAGED>(G, a, s);
    case 128: return dispatch_g<TQ, TKV, 4, PAGED>(G, a, s);
    case 256: return dispatch_g<TQ, TKV, 8, PAGED>(G, a, s);
  }
  return -1;
}

// Returns 0 on success, -1 for a shape the kernel does not take, else the
// cudaError_t of the launches.
template <bool PAGED>
int dispatch(const Args& a, int G, int hd, int q_bf16, int kv_bf16,
             cudaStream_t s) {
  int rc;
  if (q_bf16 && kv_bf16)
    rc = dispatch_hd<__nv_bfloat16, __nv_bfloat16, PAGED>(hd, G, a, s);
  else if (q_bf16)
    rc = dispatch_hd<__nv_bfloat16, float, PAGED>(hd, G, a, s);
  else if (kv_bf16)
    rc = dispatch_hd<float, __nv_bfloat16, PAGED>(hd, G, a, s);
  else
    rc = dispatch_hd<float, float, PAGED>(hd, G, a, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode_attn
