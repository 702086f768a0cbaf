// Decode attention at G = 10 query heads per kv head, head_dim 256, bf16
// cache, on the tensor cores: `recurrentgemma-2b`'s local layers (MQA, 10
// heads, a ring over the 2048-token window).  The dense wrapper's other
// cases run the shared CUDA-core body in decode_attention.cuh.
//
// Replaces, for this case, the TPU kernel `decode_attention_fwd` in
// src/repro/kernels/decode_attention.py (its `pl.pallas_call` body
// `_kernel`); the contract is decode_attention.cu's.
//
// What bounds it on the H100: memory.  Each slot reads its K and V rows once
// (2 x 2048 rows x 512 bytes = 2 MiB a slot after the ring wraps): 16.8 MB at
// B 8, 0.0050 ms at 3.35 TB/s.  With 10 heads the arithmetic is 10 flops a
// byte, which the CUDA-core body could not keep up with (the 10 heads' q and
// accumulators filled its registers: 244-249 a thread, 2 warps a scheduler,
// two keys in flight a warp).
//
// What the design does about it:
//  - the grid and the partials are the CUDA-core body's: one block per (kv
//    head, slot, k-block of block_k rows), blocks outside the slot's
//    `bounds` exit at once, rows outside the mask (`visible`) are never
//    read;
//  - the 10 heads, padded to the 16 rows of an m16n8k16 A tile (rows 10-15
//    zero and never stored), are the M side of both products.  q is split
//    once a block into bf16 pieces in shared memory: one for bf16 q, three
//    exact pieces for f32 q, whose products with bf16 K are then exact;
//  - each of 8 warps streams its own 16-row steps (rows 16 w + 128 i of
//    the block) through a private 16 KiB stage (K and V) by 16-byte
//    `cp.async` copies, issued before q is staged: at block_k 128 the 8
//    stages hold the whole block, so every row is in flight from the
//    start, 128 KiB a block (a 2-stage ring for 4 warps measured slower:
//    its warps ran their two steps one after the other);
//  - scale, softcap (tanh), then the ring or window mask, and the online
//    softmax with the -1e30 guards on the score fragments in registers;
//  - P.V with p split exactly into three bf16 pieces (bf16x3_mma.cuh);
//  - the 8 warps' (max, sum, accumulator) merge in warp order through shared
//    memory, and the block writes one partial per query head: the
//    workspace is read as the CUDA-core body's layout at G = 1 with KV * G
//    kv heads (same size), so `decode_attention_merge` runs unchanged, one
//    block per (query head, slot), merging the k-blocks in order: at B 8
//    80 blocks where the grouped layout gives 8 (chip_smoke.py phase 15
//    profiles both).
// A warp's 16 x 256 f32 accumulator is 128 registers a lane (251 in all);
// at B 8 the grid is 128 blocks for 132 SMs, one block an SM.
#pragma once

#include "bf16x3_mma.cuh"
#include "decode_attention.cuh"

namespace decode_attn_mma {

using bf16 = __nv_bfloat16;
using decode_attn::Args;
constexpr int kG = 10;
constexpr int kHD = 256;
constexpr int kCPR = kHD / 8;             // 16-byte chunks a row
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStepRows = 16;             // keys a warp step (one A tile)
constexpr int kAccStride = kHD + 8;       // f32 row stride of the merge
// shared memory: q pieces [3][16][HD] bf16, then per warp one stage of K
// and V [16][HD] bf16 each
constexpr int kQBytes = 3 * 16 * kHD * 2;
constexpr int kStageElems = 2 * kStepRows * kHD;   // K then V
constexpr int kWarpBytes = kStageElems * 2;
constexpr int kSmemBytes = kQBytes + kWarps * kWarpBytes;
static_assert(kG * kAccStride * 4 <= kWarpBytes, "merge fits a stage");

// bf16 pieces of q: one for bf16 q, three for f32 q
template <typename TQ>
constexpr int kPieces = sizeof(TQ) == 2 ? 1 : 3;

template <typename TQ>
__device__ __forceinline__ void store_q_pieces(TQ x, bf16* qs, int off) {
  if constexpr (kPieces<TQ> == 1) {
    qs[off] = x;
  } else {
    bf16 x1, x2, x3;
    bf16x3::split3(x, x1, x2, x3);
    qs[off] = x1;
    qs[16 * kHD + off] = x2;
    qs[2 * 16 * kHD + off] = x3;
  }
}

// One warp's 16-row step from `r0` into its stage: K and V rows outside
// [r0, row_end) or the mask are zero-filled and never read.
__device__ __forceinline__ void load_step(const bf16* kbase,
                                          const bf16* vbase,
                                          int64_t row_stride, int r0,
                                          int row_end, int p, const Args& a,
                                          bf16* stage, int lane) {
  constexpr int kCopies = kStepRows * kCPR / 32;   // a lane, per tensor
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / kCPR, c = idx % kCPR;
    const int row = r0 + r;
    const bool ok = row < row_end &&
                    decode_attn::visible(row, p, a.C, a.window, a.ring);
    const int64_t off = ok ? (int64_t)row * row_stride + c * 8 : 0;
    const int dst = bf16x3::swz<kCPR>(r, c) * 8;
    bf16x3::cp_async16(stage + dst, kbase + off, ok);
    bf16x3::cp_async16(stage + kStepRows * kHD + dst, vbase + off, ok);
  }
}

template <typename TQ>
__global__ void __launch_bounds__(kThreads)
decode_attention_g10_mma_kernel(const Args a) {
  constexpr int NP = kPieces<TQ>;
  constexpr float kNegBig = decode_attn::kNegBig;
  extern __shared__ uint4 smem_g10[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_g10);                   // pieces
  __shared__ float s_m[kWarps][16];
  __shared__ float s_l[kWarps][16];
  __shared__ float s_c[kWarps][16];   // each warp's rescale, per head

  const int h = blockIdx.x, b = blockIdx.y, j = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int C = a.C;
  const int p = a.pos[b];
  const int bk = a.block_k < C ? a.block_k : C;
  int lo, hi;
  decode_attn::bounds(p, C, a.window, a.ring, bk, &lo, &hi);
  if (j < lo || j > hi) return;       // outside this slot's range: no reads
  const int row_begin = j * bk;
  const int row_end = (j + 1) * bk < C ? (j + 1) * bk : C;

  const int64_t row_stride = (int64_t)a.KV * kHD;
  const int64_t base = (int64_t)b * C * row_stride + (int64_t)h * kHD;
  const bf16* kbase = static_cast<const bf16*>(a.k) + base;
  const bf16* vbase = static_cast<const bf16*>(a.v) + base;
  bf16* stage = reinterpret_cast<bf16*>(
      reinterpret_cast<char*>(smem_g10) + kQBytes + warp * kWarpBytes);

  // this warp's steps start at rows row_begin + 16 (warp + kWarps i); the
  // first is in flight before q is staged
  const int first = row_begin + kStepRows * warp;
  const int n_steps = first < row_end
      ? (row_end - first + kWarps * kStepRows - 1) / (kWarps * kStepRows)
      : 0;
  if (n_steps > 0)
    load_step(kbase, vbase, row_stride, first, row_end, p, a, stage, lane);
  bf16x3::cp_async_commit();

  // q of the group's heads h * G .. h * G + 9, as bf16 pieces in swizzled
  // [16][HD] tiles; rows 10-15 zero
  const TQ* qg = static_cast<const TQ*>(a.q) +
                 ((int64_t)b * a.KV * kG + (int64_t)h * kG) * kHD;
  for (int e = threadIdx.x; e < 16 * kHD; e += kThreads) {
    const int g = e / kHD, d = e % kHD;
    const TQ x = g < kG ? qg[e] : decode_attn::from_f<TQ>(0.f);
    store_q_pieces<TQ>(x, Qs, bf16x3::swz<kCPR>(g, d / 8) * 8 + d % 8);
  }
  __syncthreads();

  float acc[kHD / 8][4];
#pragma unroll
  for (int t = 0; t < kHD / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // each lane's ldmatrix row: Q (A), K (B), V (B, transposed)
  const bf16x3::LdsmRow<kCPR> qrow(lane & 15, lane >> 4);
  const bf16x3::LdsmRow<kCPR> krow((lane & 7) + ((lane >> 4) << 3),
                                   (lane >> 3) & 1);
  const bf16x3::LdsmRow<kCPR> vrow((lane & 7) + (((lane >> 3) & 1) << 3),
                                   lane >> 4);

  for (int i = 0; i < n_steps; ++i) {
    const int r0 = first + i * kWarps * kStepRows;
    const bf16* Kt = stage;
    const bf16* Vt = stage + kStepRows * kHD;
    bf16x3::cp_async_wait<0>();      // step i has landed
    __syncwarp();

    // Q.K^T over the 16 keys: two k-steps at a time into two sets of
    // accumulators, four independent chains, added at the end
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kHD / 16; kk += 2) {
      uint32_t k0[4], k1[4];
      bf16x3::ldsm_x4(k0, Kt + krow.at(kk));
      bf16x3::ldsm_x4(k1, Kt + krow.at(kk + 1));
#pragma unroll
      for (int pc = 0; pc < NP; ++pc) {
        uint32_t q0[4], q1[4];
        const bf16* qp = Qs + pc * 16 * kHD;
        bf16x3::ldsm_x4(q0, qp + qrow.at(kk));
        bf16x3::ldsm_x4(q1, qp + qrow.at(kk + 1));
        bf16x3::mma(s[0], q0, k0[0], k0[1]);
        bf16x3::mma(s[1], q0, k0[2], k0[3]);
        bf16x3::mma(s2[0], q1, k1[0], k1[1]);
        bf16x3::mma(s2[1], q1, k1[2], k1[3]);
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] += s2[t][e];
    // scale, softcap, then the mask (as the CUDA-core body)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * t + 2 * tig + (e & 1);
        float d = s[t][e] * a.scale;
        if (a.softcap != 0.f) d = tanhf(d / a.softcap) * a.softcap;
        const bool ok = r < row_end &&
                        decode_attn::visible(r, p, C, a.window, a.ring);
        s[t][e] = ok ? d : -INFINITY;
      }
    // online softmax: head gid (rr = 0) and head gid + 8 (rr = 1)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = fmaxf(fmaxf(s[0][2 * rr], s[0][2 * rr + 1]),
                       fmaxf(s[1][2 * rr], s[1][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float m_safe = fmaxf(m_new, kNegBig);   // fully-masked guard
      const float corr = expf(fmaxf(m[rr], kNegBig) - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          s[t][e] = expf(s[t][e] - m_safe);
          rs += s[t][e];
        }
      l[rr] = l[rr] * corr + rs;                    // this lane's keys
      m[rr] = m_new;
#pragma unroll
      for (int t = 0; t < kHD / 8; ++t) {
        acc[t][2 * rr] *= corr;
        acc[t][2 * rr + 1] *= corr;
      }
    }
    // P.V with p as three exact bf16 pieces
    uint32_t p1[4], p2[4], p3[4];
    bf16x3::split3_pack(s[0][0], s[0][1], p1[0], p2[0], p3[0]);
    bf16x3::split3_pack(s[0][2], s[0][3], p1[1], p2[1], p3[1]);
    bf16x3::split3_pack(s[1][0], s[1][1], p1[2], p2[2], p3[2]);
    bf16x3::split3_pack(s[1][2], s[1][3], p1[3], p2[3], p3[3]);
    bf16x3::pv_bf16x3<kHD>(acc, p1, p2, p3, Vt, vrow);
    __syncwarp();                    // every lane is done with this stage
    if (i + 1 < n_steps) {
      load_step(kbase, vbase, row_stride, r0 + kWarps * kStepRows, row_end,
                p, a, stage, lane);
      bf16x3::cp_async_commit();
    }
  }

  // merge the warps in warp order: each writes (max, sum, accumulator) of
  // its 10 heads, the accumulator into its own (now idle) stage
  __syncwarp();
  float* wacc = reinterpret_cast<float*>(stage);     // [G][kAccStride]
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lr = l[rr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int g = gid + 8 * rr;
    if (g >= kG) continue;
    if (tig == 0) {
      s_m[warp][g] = m[rr];
      s_l[warp][g] = lr;
    }
#pragma unroll
    for (int t = 0; t < kHD / 8; ++t)
      *reinterpret_cast<float2*>(wacc + g * kAccStride + 8 * t + 2 * tig) =
          make_float2(acc[t][2 * rr], acc[t][2 * rr + 1]);
  }
  __syncthreads();
  const int nk = gridDim.z;
  // the partial of query head h * G + g at k-block j, in the G = 1 layout
  float* part = a.ws + (((int64_t)b * a.KV * kG + (int64_t)h * kG) * nk + j) *
                           (kHD + 2);
  const int64_t head_stride = (int64_t)nk * (kHD + 2);
  if (threadIdx.x < kG) {
    const int g = threadIdx.x;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    const float m_safe = fmaxf(mx, kNegBig);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(fmaxf(s_m[w][g], kNegBig) - m_safe);
      s_c[w][g] = c;
      den += s_l[w][g] * c;
    }
    part[g * head_stride] = mx;
    part[g * head_stride + 1] = den;
  }
  __syncthreads();
  const float* accs = reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(smem_g10) + kQBytes);
  for (int e = threadIdx.x; e < kG * kHD; e += kThreads) {
    const int g = e / kHD, d = e % kHD;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      sum += accs[w * (kWarpBytes / 4) + g * kAccStride + d] * s_c[w][g];
    part[g * head_stride + 2 + d] = sum;
  }
}

// The G = 10, hd 256, bf16-cache case of decode_attention_launch: the
// tensor-core kernel, then the CUDA-core body's ordered merge over KV * G
// single-head groups.  Returns 0 or a cudaError_t.
template <typename TQ>
int launch_g10(const Args& a, cudaStream_t stream) {
  const int bk = a.block_k < a.C ? a.block_k : a.C;
  const int nk = (a.C + bk - 1) / bk;
  auto kern = decode_attention_g10_mma_kernel<TQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.KV, a.B, nk), kThreads, kSmemBytes, stream>>>(a);
  Args heads = a;
  heads.KV = a.KV * kG;
  decode_attn::decode_attention_merge<TQ>
      <<<dim3(heads.KV, a.B), decode_attn::kThreads, 0, stream>>>(heads, 1,
                                                                  kHD, nk);
  return (int)cudaGetLastError();
}

}  // namespace decode_attn_mma
