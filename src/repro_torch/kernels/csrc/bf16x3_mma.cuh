// Tensor-core helpers shared by the bf16 flash-attention kernel
// (flash_attention.cu) and the G = 10 decode kernel (decode_attention_mma.cuh):
// the bf16 `mma.sync` m16n8k16 product with f32 accumulators, `ldmatrix`
// loads from XOR-swizzled shared memory, `cp.async` copies with zero-fill,
// and the exact split of an f32 value into three bf16 pieces.
//
// Why three pieces.  The TPU kernels keep the probabilities p in f32 for
// P.V; rounding p to one bf16 value would compute another function (that is
// `attention_chunked`'s).  The split
//     p1 = bf16(p), p2 = bf16(p - p1), p3 = bf16(p - p1 - p2)
// takes p's 24 significant bits 8 at a time: each subtraction is exact in
// f32 (the difference of a value and its nearest bf16 has at most 16, then
// 8, significant bits), so p1 + p2 + p3 == p bit for bit for every
// p >= 2^-100 (below that the last piece can fall under bf16's normal range
// and the error stays under 2^-120).  Two pieces keep only 16 of the 24
// bits.  A product of two bf16 values is exact in f32, so three `mma`s of
// p1, p2 and p3 against the same bf16 V fragment into one f32 accumulator
// give p.v with p's f32 value: only the order of the sums changes.  The
// plain twin of the split is `flash_attention.split_bf16x3`.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 * gid + tig.
//   A (16 x 16, row):  a0 (gid, 2tig..+1), a1 (gid + 8, 2tig..+1),
//                      a2 (gid, 2tig + 8..+9), a3 (gid + 8, 2tig + 8..+9)
//   B (16 x 8, col):   b0 (k 2tig..+1, n gid), b1 (k 2tig + 8..+9, n gid)
//   C (16 x 8, f32):   c0, c1 (gid, 2tig..+1), c2, c3 (gid + 8, 2tig..+1)
// so the C fragments of two neighbouring 8-column score tiles are, packed
// two by two, the A fragment of P over those 16 keys, with no trip through
// shared memory.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16x3 {

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// The three bf16 pieces of x (see the note above), as floats' bf16 values.
__device__ __forceinline__ void split3(float x, __nv_bfloat16& x1,
                                       __nv_bfloat16& x2, __nv_bfloat16& x3) {
  x1 = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(x1);
  x2 = __float2bfloat16_rn(r1);
  x3 = __float2bfloat16_rn(r1 - __bfloat162float(x2));
}

// The pieces of the pair (lo, hi), packed as three A-fragment registers.
__device__ __forceinline__ void split3_pack(float lo, float hi, uint32_t& w1,
                                            uint32_t& w2, uint32_t& w3) {
  __nv_bfloat16 l1, l2, l3, h1, h2, h3;
  split3(lo, l1, l2, l3);
  split3(hi, h1, h2, h3);
  w1 = pack(l1, h1);
  w2 = pack(l2, h2);
  w3 = pack(l3, h3);
}

// d += a . b on the tensor cores: bf16 inputs, f32 accumulators.  Not
// volatile: a pure function of its operands, which the compiler may
// schedule.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, which lands in r[i].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same, each matrix transposed (a row-major [key][d] tile read as the
// column-major B operand of P.V).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok (nothing
// is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Index, in 16-byte chunks, of chunk c of row r of a tile with CPR chunks a
// row.  The XOR swizzle puts the same chunk of 8 consecutive rows in 8
// different bank groups, so `ldmatrix` (8 rows, one chunk each) and the
// row-wise `cp.async` stores are free of bank conflicts.
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(CPR == 4 || CPR % 8 == 0, "rows of 64 bytes or 128k bytes");
  if constexpr (CPR >= 8) {
    return r * CPR + (c ^ (r & 7));
  } else {
    return r * CPR + (c ^ ((r >> 1) & 3));
  }
}

// Where one lane's `ldmatrix` row lies in a swizzled tile: the offset of
// chunk 2 kk + cc of row r (cc, 0 or 1, picks the lane's 8-column half of a
// 16-column k-step).  The swizzle XORs only a chunk index's low 3 bits
// (2 at 4 chunks a row) with a key of the row, and rows 16 apart share the
// key, so an operand needs two registers: the row's base and the key
// folded with cc.  Chunk 2 kk + cc of row r + 16 i is then
// at(kk) + 16 i * HD elements.
template <int CPR>
struct LdsmRow {
  int base;   // r * CPR * 8: the row's first element
  int key;    // cc ^ the row's swizzle key
  __device__ __forceinline__ LdsmRow(int r, int cc) {
    static_assert(CPR == 4 || CPR % 8 == 0, "rows of 64 bytes or 128k");
    base = r * CPR * 8;
    key = cc ^ (CPR >= 8 ? (r & 7) : ((r >> 1) & 3));
  }
  // elements from the tile's start to the lane's 8 columns of k-step kk
  __device__ __forceinline__ int at(int kk) const {
    constexpr int kLow = CPR >= 8 ? 3 : 1;   // k-steps a swizzle period
    return base + ((((kk & kLow) * 2) ^ key) + 8 * (kk / (kLow + 1))) * 8;
  }
};

// Four products of one A fragment into four 8-column accumulators.
__device__ __forceinline__ void mma_x4(float (&d0)[4], float (&d1)[4],
                                       float (&d2)[4], float (&d3)[4],
                                       const uint32_t (&a)[4],
                                       const uint32_t (&b01)[4],
                                       const uint32_t (&b23)[4]) {
  mma(d0, a, b01[0], b01[1]);
  mma(d1, a, b01[2], b01[3]);
  mma(d2, a, b23[0], b23[1]);
  mma(d3, a, b23[2], b23[3]);
}

// acc += p . V over 16 keys, p given as its three bf16 pieces (A
// fragments), V the 16 rows of a swizzled [*][HD] bf16 tile from `vrows`
// (16-row aligned), `vrow` the lane's row for the transposed load.
// Four 8-column output tiles at a time, piece by piece, so that four
// independent accumulators sit between two products into the same one.
template <int HD>
__device__ __forceinline__ void pv_bf16x3(float (&acc)[HD / 8][4],
                                          const uint32_t (&p1)[4],
                                          const uint32_t (&p2)[4],
                                          const uint32_t (&p3)[4],
                                          const __nv_bfloat16* vrows,
                                          const LdsmRow<HD / 8>& vrow) {
#pragma unroll
  for (int n4 = 0; n4 < HD / 32; ++n4) {
    uint32_t v01[4], v23[4];   // output tiles 4 n4, +1 and 4 n4 + 2, +3
    ldsm_x4_t(v01, vrows + vrow.at(2 * n4));
    ldsm_x4_t(v23, vrows + vrow.at(2 * n4 + 1));
    mma_x4(acc[4 * n4], acc[4 * n4 + 1], acc[4 * n4 + 2], acc[4 * n4 + 3],
           p1, v01, v23);
    mma_x4(acc[4 * n4], acc[4 * n4 + 1], acc[4 * n4 + 2], acc[4 * n4 + 3],
           p2, v01, v23);
    mma_x4(acc[4 * n4], acc[4 * n4 + 1], acc[4 * n4 + 2], acc[4 * n4 + 3],
           p3, v01, v23);
  }
}

}  // namespace bf16x3
