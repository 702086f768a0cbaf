// Fused paged write+attend decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention_fwd` in
// src/repro/kernels/decode_attention.py (its `pl.pallas_call` body
// `_paged_kernel`).  Same contract: q [B, 1, H, hd]; new_k / new_v
// [B, KV, hd], the new token's rows already cast to the pool dtype; k/v
// pools [P, ps, KV, hd] updated in place; pos [B] int32; page_table [B, NP]
// int32; active [B] (bool bytes); o [B, 1, H, hd] in q's dtype.  Each active
// slot's new row lands at pool[tbl[b, pos / ps], pos % ps]; attention runs
// over the slot's logical rows [lo, pos] through the table, with the masks
// in logical positions (`window`, `softcap`, explicit `scale`).
//
// Differences from the TPU kernel, both by design:
//  - the k-block (block_k rows, one thread block each) is independent of
//    the page size: every row is addressed through the table, so with
//    equal block_k this kernel is bitwise the dense one on the gathered
//    view and paged serving streams equal dense ones at any page size;
//  - inactive slots write nothing (the TPU kernel flushes their boundary
//    page to the null page 0; here several slots writing page 0 at once
//    would race and buy nothing).
// No other block reads the write page's new row: copy-on-write gives the
// write page refcount 1, and only the k-block holding pos covers it.
//
// What bounds it (memory: the pages from lo to pos, read once), what the
// design does about it and its known limits are in decode_attention.cuh;
// this file instantiates its paged row map.  Paged-specific: each block
// loads its k-block's page-table entries once, into shared memory, beside
// pos, so no K/V copy waits on a table read; the new row enters the tile
// from new_k / new_v, and the block holding pos stores it to the pool.
#include "decode_attention.cuh"

// Returns 0 on success, -1 for a shape the kernel does not take, else the
// cudaError_t of the launch.  Allocates nothing: `ws` is an f32 workspace
// of B * KV * ceil(NP * ps / min(block_k, NP * ps)) * partial_floats(G, hd)
// floats; `counters` holds at least B * KV int32 arrival counts, zero before
// the launch and zero after it.  Runs on `stream`.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* new_k, const void* new_v, void* k_pool,
    void* v_pool, const int32_t* pos, const int32_t* page_table,
    const uint8_t* active, void* o, float* ws, int32_t* counters, int B,
    int NP, int ps, int KV, int G, int hd, int q_bf16, int kv_bf16,
    int window, float softcap, float scale, int block_k, void* stream) {
  decode_attn::Args a{};
  a.q = q; a.k = k_pool; a.v = v_pool; a.pos = pos; a.o = o; a.ws = ws;
  a.counters = counters;
  a.B = B; a.C = NP * ps; a.KV = KV; a.window = window; a.ring = 0;
  a.softcap = softcap; a.scale = scale; a.block_k = block_k;
  a.tbl = page_table; a.active = active; a.new_k = new_k; a.new_v = new_v;
  a.NP = NP; a.ps = ps;
  a.offset = 0; a.Ct = NP * ps; a.lse = nullptr;
  return decode_attn::dispatch<true>(a, G, hd, q_bf16, kv_bf16,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
