// Decode attention for Hopper (sm_90a): one query token per slot against its
// KV rows, GQA, online softmax in f32.  The body shared by the dense kernel
// (decode_attention.cu) and the fused paged write+attend kernel
// (paged_decode_attention.cu), which replace the TPU kernels
// `decode_attention_fwd` and `paged_decode_attention_fwd` of
// src/repro/kernels/decode_attention.py.  The two differ only in how a
// slot's logical row r maps to a row of the K/V storage, a template
// parameter here:
//
//  - dense: the slot-batched cache [B, C, KV, hd]; row r of slot b is
//    storage row b * C + r;
//  - paged: pools [P, ps, KV, hd] through a page table [B, NP]; row r of
//    slot b is storage row tbl[b, r / ps] * ps + r % ps (64-bit offsets).
//    Each block reads the table entries of its k-block once, into shared
//    memory, alongside pos and before any K/V copy.  The new token's K/V
//    row (already cast to the pool dtype) is copied into the block's tile
//    from new_k / new_v at r == pos for active slots, never from the pool
//    row that the same block writes; scores never depend on that store.
//
// Both fill shared memory with the same values in the same layout and run
// the same arithmetic in the same order, so with equal block_k the paged
// kernel equals the dense kernel bit for bit on the gathered view, whatever
// the page size.
//
// What bounds it on the H100: memory.  Each (slot, kv head) must read its K
// and V rows from lo * block_k up to pos once; a decode step does almost no
// arithmetic per byte (2 * G multiply-adds per cache element), far below the
// ~295 operations per byte where the tensor cores would become the limit.
// Per block, though, the arithmetic sits after the copies it waits for, so
// its instruction count shows in the time as much as the bytes do.
//
// What the design does about it:
//  - the TPU kernel's grid (slot, kv head, k-block) runs in parallel here:
//    one thread block per (kv head, slot, k-block of block_k rows), kv
//    heads fastest.  Each block computes its slot's [lo, hi] k-block range
//    from pos exactly as `block_bounds` does and exits at once outside it,
//    so the bytes read scale with the slot's context, not with C, and a
//    long slot is spread over many SMs instead of serializing on one;
//  - every row of the block is in flight at once: before it stages q, the
//    block writes each row's storage offset into a row table in shared
//    memory (the page table read once a block, beside pos), then issues
//    all its K and V rows as 16-byte `cp.async` copies, consecutive threads
//    on consecutive chunks (64 KiB at hd 128 in bf16).  A k-block larger
//    than the tile (kTileBytes: f32 rows at hd 256, or a large block_k)
//    streams through a ring of kStages stages.  Rows outside the mask
//    (`visible`) are never read from memory (zero-filled where a
//    tensor-core step covers them), so unmapped pages are never touched;
//  - the G query heads of the group share every K/V row that is loaded
//    (repeated kv heads are never materialized).  Over a bf16 cache
//    (G <= 8) each warp takes 16-row steps on the tensor cores (`mma.sync`
//    m16n8k16, f32 accumulators, bf16x3_mma.cuh): S^T = K . q^T with the 16
//    keys as M and the heads as N, so nothing pads G to 16 rows (G < 8,
//    as G = 3, fills G of N's 8 columns; the rest hold zero heads whose
//    results are never written), and q's
//    bf16 pieces read from shared memory (three exact pieces for f32 q);
//    then O^T = V^T . P^T with P, through a small per-warp buffer, as three
//    exact bf16 pieces (the products are exact, so P keeps its f32 value,
//    as the TPU kernel's f32 P.V does).  An f32 cache (and G = 10) runs on
//    the CUDA cores: kLPR lanes a row read 16-byte chunks from shared
//    memory, and the scores reduce over log2(kLPR) shuffles;
//  - each warp keeps its running max, denominator and accumulator in f32
//    registers (the -1e30 guards of the TPU kernel); the warps merge
//    through shared memory behind one barrier, combined in warp order;
//  - one launch per call: a block whose slot spans one k-block writes o
//    itself; otherwise it writes its partial (max, denominator,
//    accumulator per query head) to the workspace and, after a fence,
//    increments the (slot, kv head) arrival counter.  The block that
//    arrives last merges the slot's partials in k-block order lo..hi (the
//    TPU kernel's sequential k sweep; the arithmetic of
//    `decode_attention_merge`), reading them past L1, writes o and resets
//    the counter to 0, so the result does not depend on arrival order and
//    the next launch (or graph replay) finds the counters zeroed.
// Known limits: the grid has a block for every k-block of C, and blocks
// past a slot's pos take SM slots until they have read pos, so at short
// contexts in a large C the late k-blocks of a long slot start late; the
// blocks on an SM copy at the same time and then compute at the same time,
// so the arithmetic does not hide under the copies; the last block of a
// slot adds a fence, an atomic and the partials' round trip; the tensor
// cores compute 8 heads where G < 8 are used; launches that share a
// counter buffer must be ordered on one stream.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "bf16x3_mma.cuh"

namespace decode_attn {

using bf16x3::cp_async16;      // 16 bytes through L2, zero-filled when !ok
using bf16x3::cp_async_commit;
using bf16x3::cp_async_wait;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegBig = -1e30f;
constexpr int kTileBytes = 128 * 1024;  // K + V rows a block holds at once
constexpr int kStages = 4;              // commit groups / ring stages
constexpr int kMaxDynSmem = 227 * 1024 - 8192;   // H100 block limit - static

// Everything one launch needs.  Dense fills the first block of fields; the
// paged kernel also the second (k/v are then the pools, C = NP * ps).
struct Args {
  const void* q;            // [B, 1, H, hd]
  const void* k;            // dense cache [B, C, KV, hd] or pool [P, ps, KV, hd]
  const void* v;
  const int32_t* pos;       // [B], index of the new token
  void* o;                  // [B, 1, H, hd], q's dtype
  float* ws;                // B * KV * nk * partial_floats(G, hd) floats
  int B, C, KV, window, ring;
  float softcap, scale;
  int block_k;
  // paged only
  const int32_t* tbl;       // [B, NP] physical page per logical page
  const uint8_t* active;    // [B] slots that write their new row
  const void* new_k;        // [B, KV, hd], pool dtype
  const void* new_v;
  int NP, ps;
  // the shared body's launch (set by `launch`; the G = 10 kernel and its
  // merge do not read them)
  int32_t* counters;        // [>= B * KV] arrival counts, 0 between launches
  int nk;                   // k-blocks of C
  int smem_region;          // bytes of shared memory before the page table
  int smem_q;               // offset of q's bf16 pieces (tensor-core path)
  int smem_rows;            // offset of the stages' row tables
};

// Floats of one k-block partial: G * hd accumulators, then G maxima and G
// denominators, padded to 16 bytes (at G = 10 exactly the G * (hd + 2) of
// the per-head layout that decode_attention_merge reads).
__host__ __device__ constexpr int partial_floats(int G, int hd) {
  return G * hd + (2 * G + 3) / 4 * 4;
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) { return __float2bfloat16(x); }

// The 16 / sizeof(T) elements of a 16-byte chunk as floats.
template <typename T>
__device__ __forceinline__ void chunk_to_f(const uint4& w, float* out) {
  if constexpr (sizeof(T) == 4) {
    out[0] = __uint_as_float(w.x); out[1] = __uint_as_float(w.y);
    out[2] = __uint_as_float(w.z); out[3] = __uint_as_float(w.w);
  } else {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(u[i] << 16);
      out[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

// N contiguous elements at p (aligned to their size) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float* out) {
  constexpr int kBytes = N * sizeof(T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      chunk_to_f<T>(__ldg(reinterpret_cast<const uint4*>(p) + i),
                    out + i * (16 / sizeof(T)));
  } else {
    static_assert(kBytes == 8, "4 bf16 values");
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    const uint4 w4 = make_uint4(w.x, w.y, 0u, 0u);
    float tmp[8];
    chunk_to_f<T>(w4, tmp);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = tmp[i];
  }
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

// How a K/V row of HD elements of T is cut: 16-byte chunks, kLPR lanes a
// row (kCPL chunks, kEPL elements each), kRPW rows a warp at once (the
// CUDA-core path), and the rows a kTileBytes tile holds (K and V).
template <typename T, int HD>
struct Row {
  static constexpr int kEPC = 16 / sizeof(T);
  static constexpr int kCPR = HD / kEPC;
  static constexpr int kLPR = kCPR < 32 ? kCPR : 32;
  static constexpr int kCPL = kCPR / kLPR;
  static constexpr int kEPL = kCPL * kEPC;
  static constexpr int kRPW = 32 / kLPR;
  static constexpr int kBytes = HD * (int)sizeof(T);
  static constexpr int kCap = kTileBytes / (2 * kBytes);
};

// Rows of one stage: the whole k-block when it fits the tile (every row in
// flight at once), else a quarter of the tile (a ring of kStages).  A
// stage's slot holds its rows rounded up to 16 (one tensor-core step).
__host__ __device__ inline int stage_rows(int bk, int cap) {
  return bk <= cap ? bk : cap / kStages;
}
__host__ __device__ inline int slot_rows(int bk, int cap) {
  return (stage_rows(bk, cap) + 15) / 16 * 16;
}

// Shared memory of one launch before the page table: the larger of the K/V
// tile, the warps' merge and the last block's merge (the maxima,
// denominators and scales of up to nk partials, then one partial's
// accumulators at least).
__host__ __device__ inline int smem_region_bytes(int bk, int nk, int cap,
                                                 int row_bytes, int G,
                                                 int HD) {
  const int slots = bk <= cap ? 1 : kStages;
  const int tile = slots * slot_rows(bk, cap) * 2 * row_bytes;
  const int warps = kWarps * G * HD * 4;
  const int merge = ((3 * G * nk + 3) / 4 * 4 + G * HD) * 4;
  int r = tile > warps ? tile : warps;
  r = r > merge ? r : merge;
  return (r + 15) / 16 * 16;
}

// The products run on the tensor cores over a bf16 cache with <= 8 heads
// a group (the N side of one m16n8k16 tile), else on the CUDA cores.
template <typename TKV, int G>
__host__ __device__ constexpr bool tensor_cores() {
  return sizeof(TKV) == 2 && G <= 8;
}

// Blocks an SM should hold at once, which caps the registers: three on
// the tensor-core path at hd <= 128 with bf16 q and G <= 2 (64 KiB of
// shared memory a block at block_k 128), one fewer with f32 q (three q
// pieces) or G > 2 (more accumulators in the merge), one elsewhere (a
// 128 KiB tile at hd 256, or the CUDA-core path's registers).
template <typename TQ, typename TKV, int HD, int G>
__host__ __device__ constexpr int min_blocks() {
  if (!tensor_cores<TKV, G>() || HD > 128) return 1;
  return (sizeof(TQ) == 2 ? 3 : 2) - (G > 2 ? 1 : 0);
}

// One block per (kv head h, slot b, k-block j), h fastest and the last
// k-block first; blocks outside the slot's [lo, hi] exit after reading
// pos.  G query heads per kv head.  A bf16 cache runs the products on the
// tensor cores (G <= 8), an f32 cache (and G = 10) on the CUDA cores.
template <typename TQ, typename TKV, int HD, int G, bool PAGED>
__global__ void __launch_bounds__(kThreads, (min_blocks<TQ, TKV, HD, G>()))
decode_attention_kernel(const Args a) {
  using R = Row<TKV, HD>;
  constexpr bool kMma = tensor_cores<TKV, G>();
  constexpr int PF = partial_floats(G, HD);
  extern __shared__ uint4 smem[];
  __shared__ float s_m[kWarps][G];
  __shared__ float s_l[kWarps][G];
  __shared__ float s_c[kWarps][G];
  __shared__ float s_ms[G], s_den[G];
  __shared__ float s_p[kMma ? kWarps : 1][16][9];   // a step's P, per warp
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int C = a.C;
  const int bk = a.block_k < C ? a.block_k : C;

  // the last k-blocks first: only long slots have them, so their blocks
  // start at once, and the blocks of the many k-blocks past the short
  // slots' pos (which exit at once) clear out ahead of the rest
  const int h = blockIdx.x % a.KV;
  const int b = (blockIdx.x / a.KV) % a.B;
  const int j = a.nk - 1 - blockIdx.x / (a.KV * a.B);
  const int row_begin = j * bk;
  const int row_end = (j + 1) * bk < C ? (j + 1) * bk : C;

  // the page table entries of this k-block, read once, beside pos (neither
  // depends on the other)
  int32_t* s_tbl = reinterpret_cast<int32_t*>(
      reinterpret_cast<char*>(smem) + a.smem_region);
  const int p = __ldg(a.pos + b);
  int pg0 = 0;
  if constexpr (PAGED) {
    pg0 = row_begin / a.ps;
    const int npg = (row_end - 1) / a.ps - pg0 + 1;
    for (int t = tid; t < npg; t += kThreads)
      s_tbl[t] = __ldg(a.tbl + (int64_t)b * a.NP + pg0 + t);
  }
  int lo, hi;
  bounds(p, C, a.window, a.ring, bk, &lo, &hi);
  if (j < lo || j > hi) return;       // outside this slot's range
  if constexpr (PAGED) __syncthreads();
  const bool splice = PAGED && a.active[b] != 0;

  // rows past pos are never visible outside a ring: the stages stop there
  const int row_stop = a.ring ? row_end : min(row_end, p + 1);
  const int SR = stage_rows(bk, R::kCap);
  const int SR16 = slot_rows(bk, R::kCap);
  const int nst = (row_stop - row_begin + SR - 1) / SR;
  const int64_t row_stride = (int64_t)a.KV * HD;   // between storage rows
  const TKV* kg = static_cast<const TKV*>(a.k) + (int64_t)h * HD;
  const TKV* vg = static_cast<const TKV*>(a.v) + (int64_t)h * HD;
  const int64_t slot_row = PAGED ? 0 : (int64_t)b * C;
  const int64_t new_off = ((int64_t)b * a.KV + h) * HD;
  const TKV* nkg = PAGED ? static_cast<const TKV*>(a.new_k) + new_off : kg;
  const TKV* nvg = PAGED ? static_cast<const TKV*>(a.new_v) + new_off : vg;
  auto row_ok = [&](int local, int r) {
    return local < SR && r < row_stop && visible(r, p, C, a.window, a.ring);
  };
  // rows of stage s that are read: up to row_stop, in whole 16-row steps
  // on the tensor-core path (whose masked rows must then be zeros)
  auto rows_used = [&](int s) {
    const int n = row_stop - (row_begin + s * SR);
    const int m = kMma ? (n + 15) / 16 * 16 : n;
    return m < SR16 ? m : SR16;
  };

  // stage s (rows row_begin + s * SR ..) into slot s % kStages: first
  // each row's storage offset into the slot's row table (-1 outside the
  // mask, -2 for the new row), then K rows and V rows as 16-byte chunks,
  // consecutive threads on consecutive chunks (XOR-swizzled for `ldmatrix`
  // on the tensor-core path); rows outside the mask are zero-filled where a
  // step reads them, never read from memory
  int64_t* s_rows = reinterpret_cast<int64_t*>(
      reinterpret_cast<char*>(smem) + a.smem_rows);
  auto issue = [&](int s) {
    if (s >= nst) return;
    uint4* tk = smem + (s % kStages) * 2 * SR16 * R::kCPR;
    uint4* tv = tk + SR16 * R::kCPR;
    int64_t* rows = s_rows + (s % kStages) * SR16;
    const int r0 = row_begin + s * SR;
    const int used = rows_used(s);
    for (int rr = tid; rr < used; rr += kThreads) {
      const int r = r0 + rr;
      int64_t off = -1;
      if (row_ok(rr, r)) {
        if (splice && r == p) {
          off = -2;                    // the new row, not its pool row
        } else {
          int64_t row;
          if constexpr (PAGED)
            row = (int64_t)s_tbl[r / a.ps - pg0] * a.ps + r % a.ps;
          else
            row = slot_row + r;
          off = row * row_stride;
        }
      }
      rows[rr] = off;
    }
    __syncthreads();
#pragma unroll 1
    for (int idx = tid; idx < used * R::kCPR; idx += kThreads) {
      const int rr = idx / R::kCPR;
      const int c = idx % R::kCPR;
      const int64_t off = rows[rr];
      if (!kMma && off == -1) continue;    // never read: no zeros needed
      const bool ok = off != -1;
      const TKV* ks = off == -2 ? nkg : kg + (ok ? off : 0);
      const TKV* vs = off == -2 ? nvg : vg + (ok ? off : 0);
      const int dst = kMma ? bf16x3::swz<R::kCPR>(rr, c) : idx;
      cp_async16(tk + dst, ks + (ok ? c * R::kEPC : 0), ok);
      cp_async16(tv + dst, vs + (ok ? c * R::kEPC : 0), ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    issue(s);
    cp_async_commit();
  }

  // paged: the block holding pos stores the new row to the slot's write
  // page (no block reads that pool row; other kv heads write other columns)
  if (splice && p >= row_begin && p < row_end) {
    const int64_t dst =
        ((int64_t)s_tbl[p / a.ps - pg0] * a.ps + p % a.ps) * row_stride;
    TKV* kw = const_cast<TKV*>(kg) + dst;
    TKV* vw = const_cast<TKV*>(vg) + dst;
    for (int c = tid; c < R::kCPR; c += kThreads) {
      reinterpret_cast<uint4*>(kw)[c] =
          __ldg(reinterpret_cast<const uint4*>(nkg) + c);
      reinterpret_cast<uint4*>(vw)[c] =
          __ldg(reinterpret_cast<const uint4*>(nvg) + c);
    }
  }

  const int64_t H = (int64_t)a.KV * G;
  const TQ* qb = static_cast<const TQ*>(a.q) + ((int64_t)b * H + (int64_t)h * G) * HD;
  float* s_acc = reinterpret_cast<float*>(smem);   // [kWarps][G][HD]
  if constexpr (kMma) {
    // S^T = K . q^T and O^T = V^T . P^T on the tensor cores: the 16 keys
    // of a warp step are the M side, the (<= 8) heads the N side, so no
    // product pads the heads to 16 rows.
    using bf16 = __nv_bfloat16;
    constexpr int KT = HD / 16;                   // k-steps, then dim tiles
    constexpr int NQ = sizeof(TQ) == 2 ? 1 : 3;   // bf16 pieces of q
    constexpr int QS = HD / 2 + 4;                // words a row of s_q
    const int gid = lane >> 2, tig = lane & 3;
    // q as bf16 pairs in shared memory, [piece][head (zero past G)][dim
    // pair], while the copies are in flight; f32 q as three exact pieces
    uint32_t* s_q = reinterpret_cast<uint32_t*>(
        reinterpret_cast<char*>(smem) + a.smem_q);
    for (int e = tid; e < 8 * HD / 2; e += kThreads) {
      const int g = e / (HD / 2), d = 2 * (e % (HD / 2));
      const float x0 = g < G ? to_f(qb[g * HD + d]) : 0.f;
      const float x1 = g < G ? to_f(qb[g * HD + d + 1]) : 0.f;
      if constexpr (NQ == 1) {
        s_q[g * QS + d / 2] = bf16x3::pack(x0, x1);
      } else {
        bf16x3::split3_pack(x0, x1, s_q[g * QS + d / 2],
                            s_q[(8 + g) * QS + d / 2],
                            s_q[(16 + g) * QS + d / 2]);
      }
    }
    float acc[KT][4];          // O^T: dims 16 dt + gid (+8), heads 2 tig (+1)
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const bf16x3::LdsmRow<R::kCPR> krow(lane & 15, lane >> 4);
    const bf16x3::LdsmRow<R::kCPR> vrow((lane & 7) + ((lane >> 4) << 3),
                                        (lane >> 3) & 1);
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<kStages - 1>();    // stage s has landed
      __syncthreads();
      const bf16* Kt = reinterpret_cast<const bf16*>(
          smem + (s % kStages) * 2 * SR16 * R::kCPR);
      const bf16* Vt = Kt + SR16 * HD;
      const int used = rows_used(s);
      const int64_t* rows = s_rows + (s % kStages) * SR16;
#pragma unroll 1
      for (int base = 16 * warp; base < used; base += 16 * kWarps) {
        float sa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t ka[4];
          bf16x3::ldsm_x4(ka, Kt + base * HD + krow.at(kk));
          // q^T as B fragments: head gid, dims 16 kk + 2 tig (+1) and + 8
#pragma unroll
          for (int pc = 0; pc < NQ; ++pc)
            bf16x3::mma(sa, ka,
                        s_q[(8 * pc + gid) * QS + 8 * kk + tig],
                        s_q[(8 * pc + gid) * QS + 8 * kk + 4 + tig]);
        }
        // scores: keys gid (e < 2) and gid + 8, heads 2 tig + (e & 1)
        float sv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int local = base + gid + 8 * (e >> 1);
          float d = sa[e] * a.scale;
          if (a.softcap != 0.f) d = tanhf(d / a.softcap) * a.softcap;
          sv[e] = rows[local] != -1 ? d : -INFINITY;
        }
        float pv[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = fmaxf(sv[hh], sv[2 + hh]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float m_new = fmaxf(m[hh], mx);
          const float m_safe = fmaxf(m_new, kNegBig);   // fully-masked guard
          const float corr = expf(fmaxf(m[hh], kNegBig) - m_safe);
          pv[hh] = expf(sv[hh] - m_safe);
          pv[2 + hh] = expf(sv[2 + hh] - m_safe);
          l[hh] = l[hh] * corr + (pv[hh] + pv[2 + hh]);   // this lane's keys
          m[hh] = m_new;
          if (m[hh] != -INFINITY) {      // else acc is zero: nothing to scale
#pragma unroll
            for (int t = 0; t < KT; ++t) {
              acc[t][hh] *= corr;
              acc[t][2 + hh] *= corr;
            }
          }
        }
        // P^T as B fragments (keys 2 tig (+1), + 8; head gid), through the
        // warp's buffer; p as three exact bf16 pieces
        float(*sp)[9] = s_p[kMma ? warp : 0];
        sp[gid][2 * tig] = pv[0];
        sp[gid][2 * tig + 1] = pv[1];
        sp[gid + 8][2 * tig] = pv[2];
        sp[gid + 8][2 * tig + 1] = pv[3];
        __syncwarp();
        uint32_t pf[3][2];
        bf16x3::split3_pack(sp[2 * tig][gid], sp[2 * tig + 1][gid],
                            pf[0][0], pf[1][0], pf[2][0]);
        bf16x3::split3_pack(sp[2 * tig + 8][gid], sp[2 * tig + 9][gid],
                            pf[0][1], pf[1][1], pf[2][1]);
        __syncwarp();
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          uint32_t va[4];
          bf16x3::ldsm_x4_t(va, Vt + base * HD + vrow.at(t));
#pragma unroll
          for (int pc = 0; pc < 3; ++pc)
            bf16x3::mma(acc[t], va, pf[pc][0], pf[pc][1]);
        }
      }
      __syncthreads();                 // slot s % kStages is free again
      issue(s + kStages);
      cp_async_commit();
    }
    // the warp's (max, sum, accumulator) per head into shared memory
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 4);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 8);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 16);
      const int g = 2 * tig + hh;
      if (gid == 0 && g < G) {
        s_m[warp][g] = m[hh];
        s_l[warp][g] = l[hh];
      }
    }
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = 2 * tig + (e & 1);
        if (g < G)
          s_acc[(warp * G + g) * HD + 16 * t + gid + 8 * (e >> 1)] = acc[t][e];
      }
  } else {
    // CUDA cores: lane group `sub` of kLPR lanes takes a row, lane `li` its
    // chunks li, li + kLPR, ...; dot products reduce over the group
    constexpr int NB = G * R::kEPL <= 32 ? 2 : 1;  // rows a lane per batch
    constexpr int kStep = kWarps * R::kRPW;        // rows a block step
    const int sub = lane / R::kLPR;
    const int li = lane % R::kLPR;
    float qr[G][R::kEPL];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < R::kCPL; ++c)
        load_f<TQ, R::kEPC>(qb + g * HD + (c * R::kLPR + li) * R::kEPC,
                            qr[g] + c * R::kEPC);
    float m[G], l[G], acc[G][R::kEPL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < R::kEPL; ++e) acc[g][e] = 0.f;
    }
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<kStages - 1>();    // stage s has landed
      __syncthreads();
      const uint4* tk = smem + (s % kStages) * 2 * SR16 * R::kCPR;
      const uint4* tv = tk + SR16 * R::kCPR;
      const int used = rows_used(s);
      const int64_t* rows = s_rows + (s % kStages) * SR16;
      for (int base = warp * R::kRPW; base < used; base += NB * kStep) {
        float sc[NB][G];
        bool ok[NB];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int local = base + nb * kStep + sub;
          ok[nb] = local < used && rows[local] != -1;
#pragma unroll
          for (int g = 0; g < G; ++g) sc[nb][g] = 0.f;
          if (ok[nb]) {
#pragma unroll
            for (int c = 0; c < R::kCPL; ++c) {
              float kf[R::kEPC];
              chunk_to_f<TKV>(tk[local * R::kCPR + c * R::kLPR + li], kf);
#pragma unroll
              for (int g = 0; g < G; ++g)
#pragma unroll
                for (int e = 0; e < R::kEPC; ++e)
                  sc[nb][g] = fmaf(qr[g][c * R::kEPC + e], kf[e], sc[nb][g]);
            }
          }
        }
        // the row's dot products: a butterfly over its kLPR lanes (every
        // lane of the group ends with the same sum)
#pragma unroll
        for (int o = R::kLPR / 2; o > 0; o >>= 1)
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int g = 0; g < G; ++g)
              sc[nb][g] += __shfl_xor_sync(0xffffffffu, sc[nb][g], o);
        float pr[NB][G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float smax = -INFINITY;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            float d = sc[nb][g] * a.scale;
            if (a.softcap != 0.f) d = tanhf(d / a.softcap) * a.softcap;
            sc[nb][g] = ok[nb] ? d : -INFINITY;
            smax = fmaxf(smax, sc[nb][g]);
          }
          const float m_new = fmaxf(m[g], smax);
          const float m_safe = fmaxf(m_new, kNegBig);  // fully-masked guard
          const float corr = expf(fmaxf(m[g], kNegBig) - m_safe);
          float psum = 0.f;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            pr[nb][g] = expf(sc[nb][g] - m_safe);
            psum += pr[nb][g];
          }
#pragma unroll
          for (int e = 0; e < R::kEPL; ++e) acc[g][e] *= corr;
          l[g] = l[g] * corr + psum;
          m[g] = m_new;
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if (!ok[nb]) continue;
          const int local = base + nb * kStep + sub;
#pragma unroll
          for (int c = 0; c < R::kCPL; ++c) {
            float vf[R::kEPC];
            chunk_to_f<TKV>(tv[local * R::kCPR + c * R::kLPR + li], vf);
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
              for (int e = 0; e < R::kEPC; ++e)
                acc[g][c * R::kEPC + e] =
                    fmaf(pr[nb][g], vf[e], acc[g][c * R::kEPC + e]);
          }
        }
      }
      __syncthreads();                 // slot s % kStages is free again
      issue(s + kStages);
      cp_async_commit();
    }
    // merge the lane groups of a warp: symmetric products and sums, so
    // both partners compute the same bits
#pragma unroll
    for (int o = R::kLPR; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mx = fmaxf(m[g], mo);
        const float ms = fmaxf(mx, kNegBig);
        const float c1 = expf(fmaxf(m[g], kNegBig) - ms);
        const float c2 = expf(fmaxf(mo, kNegBig) - ms);
        l[g] = __fadd_rn(__fmul_rn(l[g], c1), __fmul_rn(lo_, c2));
#pragma unroll
        for (int e = 0; e < R::kEPL; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
          acc[g][e] = __fadd_rn(__fmul_rn(acc[g][e], c1), __fmul_rn(ao, c2));
        }
        m[g] = mx;
      }
    }
    if (sub == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < R::kCPL; ++c)
#pragma unroll
          for (int e = 0; e < R::kEPC; e += 4)
            *reinterpret_cast<float4*>(
                s_acc + (warp * G + g) * HD + (c * R::kLPR + li) * R::kEPC +
                e) = make_float4(acc[g][c * R::kEPC + e],
                                 acc[g][c * R::kEPC + e + 1],
                                 acc[g][c * R::kEPC + e + 2],
                                 acc[g][c * R::kEPC + e + 3]);
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  // the block's partial: the warps merged in warp order, each warp's
  // scale computed once a head
  if (tid < kWarps * G) {
    const int w = tid / G, g = tid % G;
    float mx = -INFINITY;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, s_m[v][g]);
    s_c[w][g] = expf(fmaxf(s_m[w][g], kNegBig) - fmaxf(mx, kNegBig));
  }
  __syncthreads();
  constexpr int kPer = (G * HD + kThreads - 1) / kThreads;
  float bm[kPer], bden[kPer], bacc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int t = tid + i * kThreads;
    if (t >= G * HD) break;
    const int g = t / HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float den = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      den = fmaf(s_l[w][g], s_c[w][g], den);
      sum = fmaf(s_acc[(w * G) * HD + t], s_c[w][g], sum);
    }
    bm[i] = mx;
    bden[i] = den;
    bacc[i] = sum;
  }

  TQ* out = static_cast<TQ*>(a.o) + ((int64_t)b * H + (int64_t)h * G) * HD;
  if (lo == hi) {
    // the slot's only k-block: the merge of one partial, written directly
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = tid + i * kThreads;
      if (t >= G * HD) break;
      const float ms = fmaxf(bm[i], kNegBig);
      const float c = expf(fmaxf(bm[i], kNegBig) - ms);
      const float den = fmaf(bden[i], c, 0.f);
      const float sum = fmaf(bacc[i], c, 0.f);
      out[t] = from_f<TQ>(sum / fmaxf(den, 1e-30f));
    }
    return;
  }

  // write this k-block's partial, then count the arrival
  const int nk = a.nk;
  float* slot_ws = a.ws + ((int64_t)b * a.KV + h) * nk * PF;
  float* part = slot_ws + (int64_t)j * PF;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int t = tid + i * kThreads;
    if (t >= G * HD) break;
    part[t] = bacc[i];
    if (t % HD == 0) {
      part[G * HD + t / HD] = bm[i];
      part[G * HD + G + t / HD] = bden[i];
    }
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();                   // the block's partial, then arrive
    s_last = atomicAdd(a.counters + b * a.KV + h, 1) == hi - lo;
    __threadfence();
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: merge partials lo..hi in k-block order, reading them
  // through L2 (`ld.cg`, `cp.async.cg`)
  const int np = hi - lo + 1;
  float* s_ml = reinterpret_cast<float*>(smem);          // [np][2G]
  float* s_cj = s_ml + 2 * G * np;                       // [np][G]
  float* s_pa = reinterpret_cast<float*>(smem) + (3 * G * np + 3) / 4 * 4;
  const int per_chunk = (a.smem_region / 4 - (3 * G * np + 3) / 4 * 4) /
                        (G * HD);
  auto issue_acc = [&](int j0) {
    const int n = min(per_chunk, np - j0);
    for (int idx = tid; idx < n * (G * HD / 4); idx += kThreads) {
      const int jj = idx / (G * HD / 4), c = idx % (G * HD / 4);
      cp_async16(s_pa + jj * G * HD + 4 * c,
                 slot_ws + (int64_t)(lo + j0 + jj) * PF + 4 * c, true);
    }
    cp_async_commit();
  };
  issue_acc(0);
  for (int t = tid; t < 2 * G * np; t += kThreads)
    s_ml[t] = __ldcg(slot_ws + (int64_t)(lo + t / (2 * G)) * PF + G * HD +
                     t % (2 * G));
  __syncthreads();
  if (tid < G) {
    float mx = -INFINITY;
    for (int jj = 0; jj < np; ++jj) mx = fmaxf(mx, s_ml[jj * 2 * G + tid]);
    s_ms[tid] = fmaxf(mx, kNegBig);
  }
  __syncthreads();
  for (int t = tid; t < G * np; t += kThreads) {
    const int jj = t / G, g = t % G;
    s_cj[t] = expf(fmaxf(s_ml[jj * 2 * G + g], kNegBig) - s_ms[g]);
  }
  __syncthreads();
  if (tid < G) {
    float den = 0.f;
    for (int jj = 0; jj < np; ++jj)
      den = fmaf(s_ml[jj * 2 * G + G + tid], s_cj[jj * G + tid], den);
    s_den[tid] = den;
  }
  float msum[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) msum[i] = 0.f;
  for (int j0 = 0; j0 < np; j0 += per_chunk) {
    cp_async_wait<0>();
    __syncthreads();
    const int n = min(per_chunk, np - j0);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = tid + i * kThreads;
      if (t >= G * HD) break;
      const int g = t / HD;
      for (int jj = 0; jj < n; ++jj)
        msum[i] = fmaf(s_pa[jj * G * HD + t], s_cj[(j0 + jj) * G + g],
                       msum[i]);
    }
    __syncthreads();
    if (j0 + per_chunk < np) issue_acc(j0 + per_chunk);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int t = tid + i * kThreads;
    if (t >= G * HD) break;
    out[t] = from_f<TQ>(msum[i] / fmaxf(s_den[t / HD], 1e-30f));
  }
  if (tid == 0) a.counters[b * a.KV + h] = 0;   // every block has arrived
}

// Merge the k-block partials of one (kv head, slot) in k-block order and
// write o = acc / max(denominator, 1e-30) in q's dtype.  The second launch
// of the G = 10 tensor-core kernel (decode_attention_mma.cuh), whose
// partials use the per-head layout: G maxima, G denominators, G * HD sums.
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

// One launch.  Returns 0, -1 for a shape whose shared memory does not fit,
// or the cudaError_t of setting the kernel's shared-memory limit.
template <typename TQ, typename TKV, int HD, int G, bool PAGED>
int launch(Args a, cudaStream_t stream) {
  using R = Row<TKV, HD>;
  const int bk = a.block_k < a.C ? a.block_k : a.C;
  const int nk = (a.C + bk - 1) / bk;
  const int64_t region =
      smem_region_bytes(bk, nk, R::kCap, R::kBytes, G, HD);
  const int64_t tbl =
      PAGED ? ((int64_t)(bk + a.ps - 1) / a.ps + 1 + 3) / 4 * 16 : 0;
  constexpr bool kMma = tensor_cores<TKV, G>();
  const int64_t qp = kMma ? (int64_t)(sizeof(TQ) == 2 ? 1 : 3) * 8 *
                                (HD / 2 + 4) * 4
                          : 0;
  const int64_t rows = (int64_t)(bk <= R::kCap ? 1 : kStages) *
                      slot_rows(bk, R::kCap) * 8;
  const int64_t smem = region + tbl + qp + rows;
  if (smem > kMaxDynSmem) return -1;
  a.nk = nk;
  a.smem_region = (int)region;
  a.smem_q = (int)(region + tbl);
  a.smem_rows = (int)(region + tbl + qp);
  auto kern = decode_attention_kernel<TQ, TKV, HD, G, PAGED>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t grid = (int64_t)a.KV * a.B * nk;
  if (grid > 0x7fffffff) return -1;
  kern<<<(unsigned)grid, kThreads, (size_t)smem, stream>>>(a);
  return 0;
}

template <typename TQ, typename TKV, int HD, bool PAGED>
int dispatch_g(int G, const Args& a, cudaStream_t s) {
  switch (G) {
    case 1: return launch<TQ, TKV, HD, 1, PAGED>(a, s);
    case 2: return launch<TQ, TKV, HD, 2, PAGED>(a, s);
    case 4: return launch<TQ, TKV, HD, 4, PAGED>(a, s);
    case 8: return launch<TQ, TKV, HD, 8, PAGED>(a, s);
    case 3:  // GQA 24 / 8 (granite-moe-3b-a800m), at its head_dim 64 only
      if constexpr (HD == 64) return launch<TQ, TKV, HD, 3, PAGED>(a, s);
      break;
    case 10:  // MQA with 10 query heads (recurrentgemma-2b), dense only
      if constexpr (!PAGED) return launch<TQ, TKV, HD, 10, PAGED>(a, s);
      break;
  }
  return -1;
}

template <typename TQ, typename TKV, bool PAGED>
int dispatch_hd(int hd, int G, const Args& a, cudaStream_t s) {
  switch (hd) {
    case 32: return dispatch_g<TQ, TKV, 32, PAGED>(G, a, s);
    case 64: return dispatch_g<TQ, TKV, 64, PAGED>(G, a, s);
    case 128: return dispatch_g<TQ, TKV, 128, PAGED>(G, a, s);
    case 256: return dispatch_g<TQ, TKV, 256, PAGED>(G, a, s);
  }
  return -1;
}

// Returns 0 on success, -1 for a shape the kernel does not take, else the
// cudaError_t of the launch.
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
