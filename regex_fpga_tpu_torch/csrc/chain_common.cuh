// Shared pieces of the chain-pass kernels (dfa_chain.cu, kgram_chain.cu).
//
// A chain pass runs NB independent lanes over a (lanes x steps) grid of class
// ids. Lane n steps through its own row; its element (n, t) sits at
// src[n * lane_stride + t * step_stride], so one kernel serves both the
// time-major (B, NB) columns of the public chain-pass functions and the
// block-major (NB, B) rows of a stream cut into blocks, without a transpose.
//
// One thread carries one lane. Each CTA takes LANES consecutive lanes and
// stages WIN steps of their class ids in shared memory, loaded so that
// neighbouring threads read neighbouring addresses whichever stride is 1.
// The per-step outputs are staged the same way and stored coalesced.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace chain {

constexpr int LANES = 128;       // chain lanes (threads) per CTA
constexpr int WIN = 32;          // steps staged per window
constexpr int PITCH = WIN + 1;   // int32 row pitch of a staged tile: odd, so the
                                 // 32 lanes of a warp reading one column hit
                                 // 32 different banks
constexpr int BPITCH = WIN + 4;  // byte row pitch: 9 words, odd for the same reason

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Copy the (LANES x n) window of class ids that starts at step w0 into
// tile[i * PITCH + j], widened to int32.
template <typename CT>
__device__ __forceinline__ void load_window(int* tile, const CT* __restrict__ src,
                                            long long ls, long long ss, int lane0,
                                            int nb, int w0, int n) {
  const bool steps_fast = (ss == 1);
  for (int e = threadIdx.x; e < LANES * WIN; e += LANES) {
    const int i = steps_fast ? e / WIN : e % LANES;
    const int j = steps_fast ? e % WIN : e / LANES;
    const int lane = lane0 + i;
    if (lane < nb && j < n)
      tile[i * PITCH + j] = (int)src[(long long)lane * ls + (long long)(w0 + j) * ss];
  }
}

// Store the (LANES x n) window tile[i * P + j] to dst, the mirror of load_window.
template <typename T, int P>
__device__ __forceinline__ void store_window(T* __restrict__ dst, const T* tile,
                                             long long ls, long long ss, int lane0,
                                             int nb, int w0, int n) {
  const bool steps_fast = (ss == 1);
  for (int e = threadIdx.x; e < LANES * WIN; e += LANES) {
    const int i = steps_fast ? e / WIN : e % LANES;
    const int j = steps_fast ? e % WIN : e / LANES;
    const int lane = lane0 + i;
    if (lane < nb && j < n)
      dst[(long long)lane * ls + (long long)(w0 + j) * ss] = tile[i * P + j];
  }
}

// A table entry from shared memory (SMEM) or through the read-only cache.
template <bool SMEM, typename T>
__device__ __forceinline__ T table_load(const T* p, int k) {
  if (SMEM) return p[k];
  return __ldg(p + k);
}

inline int smem_optin_bytes() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 48 * 1024;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 48 * 1024;
  return v;
}

// Launch `kernel` over ceil(nb / LANES) CTAs with `smem` bytes of dynamic
// shared memory; returns the CUDA error code (0 on success).
template <typename K, typename A>
inline int launch_chain(K kernel, const A& args, int nb, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (nb + LANES - 1) / LANES;
  if (grid > 0) kernel<<<grid, LANES, smem, st>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace chain
