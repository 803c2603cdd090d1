// A measuring kernel, not a port of anything: the latency of a dependent
// shared-memory load on this card, which is the floor under every chain
// pass (dfa_chain.cu, kgram_chain.cu): a lane's steps cannot go faster than
// steps x this latency, however few bytes it moves.
//
// One CTA of one warp; every lane follows a cycle of uint16 or uint32
// entries through shared memory, each load's address taken from the load
// before it: idx <- table[idx]. With `spread` the 32 lanes walk neighbouring
// entries and never share a bank (the latency of the load alone); without
// it they stay 64 entries apart, all in one bank, which is the worst a warp
// of chain lanes can do (32 passes through the bank for one load). Time two step counts with CUDA events and
// divide the difference by the difference in steps; the launch and the
// fill then cancel.
//
// sync_chase times the step of a kernel that crosses a CTA barrier on every
// byte (nfa_tp_scan.cu): each of the CTA's threads follows the same kind of
// cycle, one dependent shared-memory load and one __syncthreads() a step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ENTRIES = 8192;

template <typename ET>
__global__ void __launch_bounds__(32) smem_chase_kernel(int steps, int spread, int* out) {
  __shared__ ET table[ENTRIES];
  // a single cycle through all entries: idx -> idx + 4097 (odd, so coprime
  // with 8192), stored as a byte offset like the chain kernels' entries
  for (int k = threadIdx.x; k < ENTRIES; k += 32)
    table[k] = (ET)(((k + 4097) & (ENTRIES - 1)) * sizeof(ET));
  __syncwarp();
  unsigned off = threadIdx.x * (spread ? 1 : 64) * sizeof(ET);
  const unsigned char* base = reinterpret_cast<const unsigned char*>(table);
#pragma unroll 32
  for (int t = 0; t < steps; ++t) off = *reinterpret_cast<const ET*>(base + off);
  out[threadIdx.x] = (int)off;
}

__global__ void __launch_bounds__(1024) sync_chase_kernel(int steps, int* out) {
  __shared__ uint32_t table[ENTRIES];
  for (int k = threadIdx.x; k < ENTRIES; k += blockDim.x)
    table[k] = (uint32_t)((k + 4097) & (ENTRIES - 1));
  __syncthreads();
  unsigned idx = threadIdx.x;
  for (int t = 0; t < steps; ++t) {
    idx = table[idx];
    __syncthreads();
  }
  out[threadIdx.x] = (int)idx;
}

}  // namespace

// threads: 32 to 1024, a multiple of 32. out: `threads` int32.
extern "C" int sync_chase(int threads, int steps, int* out, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32) return (int)cudaErrorInvalidValue;
  sync_chase_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(steps, out);
  return (int)cudaGetLastError();
}

// entry_bytes: 2 or 4. out: 32 int32 (the lanes' last offsets, so that the
// loads cannot be dropped).
extern "C" int smem_chase(int entry_bytes, int steps, int spread, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (entry_bytes == 2)
    smem_chase_kernel<uint16_t><<<1, 32, 0, st>>>(steps, spread, out);
  else if (entry_bytes == 4)
    smem_chase_kernel<uint32_t><<<1, 32, 0, st>>>(steps, spread, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
