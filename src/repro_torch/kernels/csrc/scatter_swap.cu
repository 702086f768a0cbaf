// Row scatter-swap for Hopper (sm_90a): the adapter hot-swap kernel.
//
// Replaces the TPU kernel `scatter_swap_2d` in
// src/repro/kernels/scatter_apply.py (its `pl.pallas_call` body `_kernel`).
// Same contract, in place: for every k < K,
//     displaced[k] = full[idx[k]];  full[idx[k]] = rows[k]
// on a [G, row_bytes] view of a parameter stack.  The swap is bitwise (raw
// words are moved, never converted) and an involution: swapping `displaced`
// back restores `full` bit-exactly.  idx must be unique and in range; the
// wrapper checks that on the host before the launch.
//
// What bounds it on the H100: memory.  It moves 2 row reads and 2 row
// writes per delta row and does no arithmetic.
//
// What the design does about it: the grid covers only the K delta rows
// (grid.y = K) times chunks of each row (grid.x), so untouched rows of the
// stack are never read; each thread moves 16-byte words (the widest load a
// thread issues), neighbouring threads on neighbouring words, and reads the
// displaced word before it writes the new one.  Rows whose length is not a
// multiple of 16 bytes fall back to the widest word that divides it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kThreads)
scatter_swap_kernel(W* __restrict__ full, const int32_t* __restrict__ idx,
                    const W* __restrict__ rows, W* __restrict__ displaced,
                    int64_t row_words) {
  const int k = blockIdx.y;
  const int64_t r = idx[k];
  W* dst = full + r * row_words;
  const W* src = rows + (int64_t)k * row_words;
  W* sav = displaced + (int64_t)k * row_words;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t w = (int64_t)blockIdx.x * kThreads + threadIdx.x; w < row_words;
       w += stride) {
    const W old = dst[w];
    const W neu = src[w];
    sav[w] = old;
    dst[w] = neu;
  }
}

template <typename W>
void launch(void* full, const int32_t* idx, const void* rows, void* displaced,
            int K, int64_t row_bytes, cudaStream_t stream) {
  const int64_t words = row_bytes / (int64_t)sizeof(W);
  int64_t bx = (words + kThreads - 1) / kThreads;
  // enough blocks to fill the card at K = 1, each looping over its words
  if (bx > 1024) bx = 1024;
  dim3 grid(static_cast<unsigned>(bx), K);
  scatter_swap_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<W*>(full), idx, static_cast<const W*>(rows),
      static_cast<W*>(displaced), words);
}

}  // namespace

// Returns 0 on success, -1 for arguments the kernel does not take, else the
// cudaError_t of the launch.  Pointers must be aligned to the word size the
// row length allows (the wrapper passes whole-tensor base pointers).
extern "C" int scatter_swap_launch(void* full, const int32_t* idx,
                                   const void* rows, void* displaced, int K,
                                   long long row_bytes, void* stream) {
  if (K <= 0 || K > 65535 || row_bytes <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0)
    launch<uint4>(full, idx, rows, displaced, K, row_bytes, s);
  else if (row_bytes % 8 == 0)
    launch<uint2>(full, idx, rows, displaced, K, row_bytes, s);
  else if (row_bytes % 4 == 0)
    launch<uint32_t>(full, idx, rows, displaced, K, row_bytes, s);
  else if (row_bytes % 2 == 0)
    launch<uint16_t>(full, idx, rows, displaced, K, row_bytes, s);
  else
    launch<uint8_t>(full, idx, rows, displaced, K, row_bytes, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* scatter_swap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
