// Masked Adam for Hopper (sm_90a): the BlockLLM optimizer step, f32 and Q8.
//
// Replaces the TPU kernels `masked_adam_2d` and `masked_adam_q8_2d` in
// src/repro/kernels/masked_adam.py (their `pl.pallas_call` bodies `_kernel`
// and `_q8_kernel`).  Same arithmetic, in place on flat contiguous leaves:
//
//   m' = b1*m + (1-b1)*g;  v' = b2*v + ((1-b2)*g)*g
//   u  = (m'/bc1) / (sqrt(v'/bc2) + eps)
//   gate = use_tau ? |u| >= tau : mask          (a null mask means gate 1)
//   p' = p - lr*(u*gate + wd*p)                 (p' in p's dtype, m', v' f32)
//
// The Q8 kernel keeps both moments as int8 codes [NB, 256] with one f32
// scale per 256-element block (the runtime/compression.py codec): it
// dequantizes (code * scale), runs the same update and requantizes with
//   scale' = max(max|x| / 127, 1e-12);  code' = clip(rint(x / scale'), +-127)
// Elements of the last block past the leaf's end take p = g = 0 and gate 0,
// exactly as the TPU wrapper's zero padding, so the block maxima match.
//
// Numerics (the places a port goes wrong):
// - `1 - b1` and `1 - b2` are computed here from the f32 scalars, as the TPU
//   kernel does (1 - f32(0.9) = 0.100000024), not from the double.
// - No FMA contraction: every multiply and add is its own IEEE operation
//   (__fmul_rn / __fadd_rn), division and sqrt are the IEEE ones, so the
//   result equals the plain PyTorch version (separate elementwise ops) bit
//   for bit, and the Q8 codes and scales do too.  Never --use_fast_math.
// - Rounding to the int8 grid is rintf (half to even, as jnp.round and
//   torch.round), never roundf (half away from zero).
//
// What bounds it on the H100: memory.  The f32 step reads p, g, m, v and
// the mask (17 bytes per element) and writes p, m, v (12 bytes): about 10
// flops per 29 bytes, far below the 20 flops/byte where f32 compute would
// bind.  The Q8 step moves about 17 bytes per element.
//
// What the design does about it: one pass over each leaf, no padded copy
// (the ragged tail is masked here), a grid-stride loop sized to fill the
// card, 16-byte loads and stores where the pointers allow (4 elements per
// thread and iteration).  The Q8 kernel gives one warp to each 256-element
// block: each lane holds 8 elements (two groups of 4, so every load of the
// warp is one contiguous 512-byte or 128-byte segment) and the block max
// is a 5-step butterfly of warp shuffles, so no shared memory is used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 256;  // codec block (runtime/compression.py BLOCK)

struct Scalars {
  float lr, b1, b2, eps, wd, bc1, bc2, tau;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 4 consecutive elements of p's dtype <-> floats (16 bytes f32, 8 bf16)
__device__ __forceinline__ void load4(const float* a, float* o) {
  const float4 t = *reinterpret_cast<const float4*>(a);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* a, float* o) {
  const uint2 t = *reinterpret_cast<const uint2*>(a);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  o[0] = __low2float(lo); o[1] = __high2float(lo);
  o[2] = __low2float(hi); o[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(float* a, const float* o) {
  *reinterpret_cast<float4*>(a) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* a, const float* o) {
  __nv_bfloat162 lo, hi;
  lo.x = __float2bfloat16_rn(o[0]); lo.y = __float2bfloat16_rn(o[1]);
  hi.x = __float2bfloat16_rn(o[2]); hi.y = __float2bfloat16_rn(o[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&lo);
  t.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(a) = t;
}

// The update of one element, op for op as the TPU kernel (see the header).
__device__ __forceinline__ float adam_step(float p32, float g, float m,
                                           float v, float mask_gate,
                                           bool use_tau, const Scalars& s,
                                           float omb1, float omb2,
                                           float* m2, float* v2) {
  *m2 = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(omb1, g));
  *v2 = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(omb2, g), g));
  const float u = __fdiv_rn(__fdiv_rn(*m2, s.bc1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(*v2, s.bc2)),
                                      s.eps));
  const float gate = use_tau ? (fabsf(u) >= s.tau ? 1.0f : 0.0f) : mask_gate;
  const float upd = __fadd_rn(__fmul_rn(u, gate), __fmul_rn(s.wd, p32));
  return __fsub_rn(p32, __fmul_rn(s.lr, upd));
}

template <typename T, bool kTau, bool kMask>
__global__ void __launch_bounds__(kThreads)
masked_adam_kernel(T* __restrict__ p, const T* __restrict__ g,
                   float* __restrict__ m, float* __restrict__ v,
                   const uint8_t* __restrict__ mask, int64_t n, Scalars s,
                   bool vec) {
  const float omb1 = __fsub_rn(1.0f, s.b1);
  const float omb2 = __fsub_rn(1.0f, s.b2);
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t gi = (int64_t)blockIdx.x * kThreads + threadIdx.x; gi < groups;
       gi += stride) {
    const int64_t i0 = gi * 4;
    const int cnt = (int)((n - i0) < 4 ? (n - i0) : 4);
    float pf[4], gf[4], mf[4], vf[4], mk[4] = {1.f, 1.f, 1.f, 1.f};
    const bool wide = vec && cnt == 4;
    if (wide) {
      load4(p + i0, pf);
      load4(g + i0, gf);
      load4(m + i0, mf);
      load4(v + i0, vf);
      if (kMask) {
        const uchar4 t = *reinterpret_cast<const uchar4*>(mask + i0);
        mk[0] = t.x; mk[1] = t.y; mk[2] = t.z; mk[3] = t.w;
      }
    } else {
      for (int k = 0; k < cnt; ++k) {
        pf[k] = to_f(p[i0 + k]);
        gf[k] = to_f(g[i0 + k]);
        mf[k] = m[i0 + k];
        vf[k] = v[i0 + k];
        if (kMask) mk[k] = mask[i0 + k];
      }
    }
    float po[4], mo[4], vo[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < cnt)
        po[k] = adam_step(pf[k], gf[k], mf[k], vf[k], mk[k] != 0.f ? 1.f : 0.f,
                          kTau, s, omb1, omb2, &mo[k], &vo[k]);
    }
    if (wide) {
      store4(p + i0, po);
      store4(m + i0, mo);
      store4(v + i0, vo);
    } else {
      for (int k = 0; k < cnt; ++k) {
        p[i0 + k] = from_f<T>(po[k]);
        m[i0 + k] = mo[k];
        v[i0 + k] = vo[k];
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// requantize 8 values held by this lane against the block's max |x|
__device__ __forceinline__ float requant(const float* x, int8_t* q) {
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(x[k]));
  amax = warp_max(amax);
  const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float c = rintf(__fdiv_rn(x[k], scale));
    c = fminf(fmaxf(c, -127.f), 127.f);
    q[k] = (int8_t)(int)c;
  }
  return scale;
}

template <typename T, bool kTau, bool kMask>
__global__ void __launch_bounds__(kThreads)
masked_adam_q8_kernel(T* __restrict__ p, const T* __restrict__ g,
                      int8_t* __restrict__ mq, float* __restrict__ ms,
                      int8_t* __restrict__ vq, float* __restrict__ vs,
                      const uint8_t* __restrict__ mask, int64_t n, Scalars s,
                      bool vec) {
  const float omb1 = __fsub_rn(1.0f, s.b1);
  const float omb2 = __fsub_rn(1.0f, s.b2);
  const int lane = threadIdx.x & 31;
  const int64_t nb_total = (n + kBlock - 1) / kBlock;
  const int64_t wstride = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t nb = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       nb < nb_total; nb += wstride) {
    const int64_t base = nb * kBlock;
    const bool wide = vec && base + kBlock <= n;
    float pf[8], gf[8], mf[8], vf[8], mk[8];
    const float m_scale = ms[nb], v_scale = vs[nb];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e0 = h * 128 + lane * 4;  // element offset in the block
      const char4 cm = *reinterpret_cast<const char4*>(mq + base + e0);
      const char4 cv = *reinterpret_cast<const char4*>(vq + base + e0);
      mf[h * 4 + 0] = __fmul_rn((float)cm.x, m_scale);
      mf[h * 4 + 1] = __fmul_rn((float)cm.y, m_scale);
      mf[h * 4 + 2] = __fmul_rn((float)cm.z, m_scale);
      mf[h * 4 + 3] = __fmul_rn((float)cm.w, m_scale);
      vf[h * 4 + 0] = __fmul_rn((float)cv.x, v_scale);
      vf[h * 4 + 1] = __fmul_rn((float)cv.y, v_scale);
      vf[h * 4 + 2] = __fmul_rn((float)cv.z, v_scale);
      vf[h * 4 + 3] = __fmul_rn((float)cv.w, v_scale);
      if (wide) {
        load4(p + base + e0, pf + h * 4);
        load4(g + base + e0, gf + h * 4);
        if (kMask) {
          const uchar4 t = *reinterpret_cast<const uchar4*>(mask + base + e0);
          mk[h * 4 + 0] = t.x; mk[h * 4 + 1] = t.y;
          mk[h * 4 + 2] = t.z; mk[h * 4 + 3] = t.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) mk[h * 4 + k] = 1.f;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int64_t i = base + e0 + k;
          const bool in = i < n;  // past the end: zero padding, gate 0
          pf[h * 4 + k] = in ? to_f(p[i]) : 0.f;
          gf[h * 4 + k] = in ? to_f(g[i]) : 0.f;
          mk[h * 4 + k] = in ? (kMask ? (float)mask[i] : 1.f) : 0.f;
        }
      }
    }
    float po[8], mo[8], vo[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      po[k] = adam_step(pf[k], gf[k], mf[k], vf[k], mk[k] != 0.f ? 1.f : 0.f,
                        kTau, s, omb1, omb2, &mo[k], &vo[k]);
    int8_t qm[8], qv[8];
    const float m_scale2 = requant(mo, qm);
    const float v_scale2 = requant(vo, qv);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e0 = h * 128 + lane * 4;
      *reinterpret_cast<char4*>(mq + base + e0) =
          make_char4(qm[h * 4], qm[h * 4 + 1], qm[h * 4 + 2], qm[h * 4 + 3]);
      *reinterpret_cast<char4*>(vq + base + e0) =
          make_char4(qv[h * 4], qv[h * 4 + 1], qv[h * 4 + 2], qv[h * 4 + 3]);
      if (wide) {
        store4(p + base + e0, po + h * 4);
      } else {
        for (int k = 0; k < 4; ++k)
          if (base + e0 + k < n) p[base + e0 + k] = from_f<T>(po[h * 4 + k]);
      }
    }
    if (lane == 0) {
      ms[nb] = m_scale2;
      vs[nb] = v_scale2;
    }
  }
}

int grid_for(int64_t work_items, int per_block) {
  int64_t b = (work_items + per_block - 1) / per_block;
  // enough blocks to fill 132 SMs several times over; the rest loop
  if (b > 132 * 16) b = 132 * 16;
  if (b < 1) b = 1;
  return (int)b;
}

template <typename T, bool kTau, bool kMask>
void launch_f32(void* p, const void* g, float* m, float* v,
                const uint8_t* mask, int64_t n, Scalars s, bool vec,
                cudaStream_t st) {
  masked_adam_kernel<T, kTau, kMask>
      <<<grid_for((n + 3) / 4, kThreads), kThreads, 0, st>>>(
          static_cast<T*>(p), static_cast<const T*>(g), m, v, mask, n, s,
          vec);
}

template <typename T, bool kTau, bool kMask>
void launch_q8(void* p, const void* g, int8_t* mq, float* ms, int8_t* vq,
               float* vs, const uint8_t* mask, int64_t n, Scalars s, bool vec,
               cudaStream_t st) {
  masked_adam_q8_kernel<T, kTau, kMask>
      <<<grid_for((n + kBlock - 1) / kBlock, kThreads / 32), kThreads, 0,
         st>>>(static_cast<T*>(p), static_cast<const T*>(g), mq, ms, vq, vs,
               mask, n, s, vec);
}

template <typename T>
void dispatch_f32(bool tau, bool has_mask, void* p, const void* g, float* m,
                  float* v, const uint8_t* mask, int64_t n, Scalars s,
                  bool vec, cudaStream_t st) {
  if (tau) launch_f32<T, true, false>(p, g, m, v, mask, n, s, vec, st);
  else if (has_mask) launch_f32<T, false, true>(p, g, m, v, mask, n, s, vec, st);
  else launch_f32<T, false, false>(p, g, m, v, mask, n, s, vec, st);
}

template <typename T>
void dispatch_q8(bool tau, bool has_mask, void* p, const void* g, int8_t* mq,
                 float* ms, int8_t* vq, float* vs, const uint8_t* mask,
                 int64_t n, Scalars s, bool vec, cudaStream_t st) {
  if (tau)
    launch_q8<T, true, false>(p, g, mq, ms, vq, vs, mask, n, s, vec, st);
  else if (has_mask)
    launch_q8<T, false, true>(p, g, mq, ms, vq, vs, mask, n, s, vec, st);
  else
    launch_q8<T, false, false>(p, g, mq, ms, vq, vs, mask, n, s, vec, st);
}

}  // namespace

// Both return 0 on success, -1 for arguments the kernel does not take, else
// the cudaError_t of the launch.  `mask` may be null (gate 1); with
// use_tau it is ignored.  `vec` = every pointer is aligned for the 16-byte
// (f32; 8-byte bf16, 4-byte mask) loads; the wrapper checks it.
extern "C" int masked_adam_launch(void* p, const void* g, float* m, float* v,
                                  const uint8_t* mask, long long n,
                                  int p_bf16, int use_tau, float lr, float b1,
                                  float b2, float eps, float wd, float bc1,
                                  float bc2, float tau, int vec,
                                  void* stream) {
  if (n <= 0 || !p || !g || !m || !v) return -1;
  const Scalars s{lr, b1, b2, eps, wd, bc1, bc2, tau};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_bf16)
    dispatch_f32<__nv_bfloat16>(use_tau, mask != nullptr, p, g, m, v, mask,
                                n, s, vec, st);
  else
    dispatch_f32<float>(use_tau, mask != nullptr, p, g, m, v, mask, n, s,
                        vec, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int masked_adam_q8_launch(void* p, const void* g, int8_t* mq,
                                     float* ms, int8_t* vq, float* vs,
                                     const uint8_t* mask, long long n,
                                     int p_bf16, int use_tau, float lr,
                                     float b1, float b2, float eps, float wd,
                                     float bc1, float bc2, float tau, int vec,
                                     void* stream) {
  if (n <= 0 || !p || !g || !mq || !ms || !vq || !vs) return -1;
  const Scalars s{lr, b1, b2, eps, wd, bc1, bc2, tau};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_bf16)
    dispatch_q8<__nv_bfloat16>(use_tau, mask != nullptr, p, g, mq, ms, vq, vs,
                               mask, n, s, vec, st);
  else
    dispatch_q8<float>(use_tau, mask != nullptr, p, g, mq, ms, vq, vs, mask,
                       n, s, vec, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* masked_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
