// Decode attention for Hopper (sm_90a): one query token per slot against a
// slot-batched KV cache, GQA, online softmax in f32.
//
// Replaces the TPU kernel `decode_attention_fwd` in
// src/repro/kernels/decode_attention.py (its `pl.pallas_call` body `_kernel`).
// Same contract: q [B, 1, H, hd]; k/v cache [B, C, KV, hd]; pos [B] int32 (the
// index of the token just written); o [B, 1, H, hd] in q's dtype.  Query head
// h = kv * G + g belongs to kv head kv (G = H / KV).  Variants: sliding
// `window`, `ring` (cache slot i holds absolute position p with p % C == i),
// `softcap` (tanh capping of the scores), explicit `scale`.
//
// The kernel body, what bounds it and what its design does about it are in
// decode_attention.cuh, shared with the fused paged kernel
// (paged_decode_attention.cu); this file instantiates its dense row map.
#include "decode_attention.cuh"

// Returns 0 on success, -1 for a shape the kernel does not take, else the
// cudaError_t of the launches.  Allocates nothing: `ws` is an f32 workspace
// of B * KV * ceil(C / min(block_k, C)) * G * (hd + 2) floats.  Runs on
// `stream`.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int32_t* pos, void* o,
    float* ws, int B, int C, int KV, int G, int hd, int q_bf16, int kv_bf16,
    int window, int ring, float softcap, float scale, int block_k,
    void* stream) {
  decode_attn::Args a{};
  a.q = q; a.k = k; a.v = v; a.pos = pos; a.o = o; a.ws = ws;
  a.B = B; a.C = C; a.KV = KV; a.window = window; a.ring = ring;
  a.softcap = softcap; a.scale = scale; a.block_k = block_k;
  return decode_attn::dispatch<false>(a, G, hd, q_bf16, kv_bf16,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
