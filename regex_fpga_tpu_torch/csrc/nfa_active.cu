// K4: the bounded active-set NFA scan, written by hand for Hopper (sm_90a).
//
// Replaces the XLA loop regex_fpga_tpu/ops/nfa_engine.py::nfa_scan_jax (the
// lax.scan over _nfa_step, vmapped over streams by nfa_scan_batch). The JAX
// package had no Pallas kernel for it.
//
// What it computes, per stream n and per byte of that stream, on the list
// of active NFA states (A slots, sentinel S as padding):
//   1. every active state that accepts adds one to counts[n, s] (the set
//      active *before* the byte; the sentinel slot never counts);
//   2. the successors of every active state on the byte's class are
//      gathered from a per-class CSR (offsets (C, S+2), targets);
//   3. they are deduplicated, and the A smallest distinct states, ascending,
//      become the next list; overflow is flagged iff an (A+1)-th distinct
//      state exists. This is jnp.unique(cand, size=A+1, fill_value=S)
//      bit for bit, the truncated list on overflow included.
// The list given for the first byte is taken as it is (any order, sentinels
// anywhere, duplicates counted per slot), as the JAX step takes it.
//
// Layout: one warp (one 32-thread CTA) per stream, the whole byte loop
// inside the kernel. The list lives in shared memory. Dedupe is a shared
// bitmap over the S states plus a summary bitmap (one bit per 32-state
// word): the successors set bits with shared atomics, then the warp walks
// the summary in ascending order, compacts the set bits of each touched
// word with a warp prefix sum (ascending order falls out directly), and
// clears exactly the words it read. Bytes are read 32 at a time, coalesced,
// mapped to classes through a shared copy of class_of and broadcast by
// shuffle.
//
// What bounds it on this card: per stream the scan is serial, as in JAX:
// each byte is a dependent chain of global CSR loads, shared atomics, a
// warp scan and warp barriers, so with few streams the kernel is bound by
// latency, not by bytes or operations. Streams run in parallel on separate
// SMs; the card is full only from about 132 x 32 streams on.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;

struct NfaArgs {
  const uint8_t* data;
  const long long* starts;
  const long long* lengths;
  const int* class_of;
  const int* offsets;   // (C, S+2)
  const int* targets;   // (E,)
  const uint8_t* accept;  // (S+1,)
  int S;
  int A;
  int* active;          // (N, A) in: start lists, out: final lists
  int* counts;          // (N, S+1) accumulated in place
  uint8_t* overflow;    // (N,) out
};

size_t smem_bytes(int S, int A) {
  const size_t w = S > 0 ? (S + 31) / 32 : 1, ns = (w + 31) / 32;
  return 256 * sizeof(int) + 2 * (size_t)A * sizeof(int) + (w + ns) * sizeof(unsigned);
}

__global__ void __launch_bounds__(WARP) nfa_active_kernel(NfaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, A = a.A;
  const int W = S > 0 ? (S + 31) / 32 : 1;
  const int NS = (W + 31) / 32;
  int* lut = reinterpret_cast<int*>(smem);
  int* act = lut + 256;
  int* nxt = act + A;
  unsigned* bm = reinterpret_cast<unsigned*>(nxt + A);
  unsigned* sm = bm + W;
  const int lane = threadIdx.x;
  const long long n = blockIdx.x;

  for (int i = lane; i < 256; i += WARP) lut[i] = a.class_of[i];
  for (int i = lane; i < W; i += WARP) bm[i] = 0u;
  for (int i = lane; i < NS; i += WARP) sm[i] = 0u;
  int* row_act = a.active + n * A;
  int* row_cnt = a.counts + n * (S + 1);
  for (int i = lane; i < A; i += WARP) act[i] = row_act[i];
  __syncwarp();

  int n_act = A;  // the first byte reads every given slot
  bool overflow = false;
  const uint8_t* data = a.data + a.starts[n];
  const long long len = a.lengths[n];
  for (long long p0 = 0; p0 < len; p0 += WARP) {
    const int mycls = p0 + lane < len ? lut[data[p0 + lane]] : 0;
    const int m = (int)(len - p0 < WARP ? len - p0 : WARP);
    for (int j = 0; j < m; ++j) {
      const int c = __shfl_sync(FULL, mycls, j);
      const int* off = a.offsets + (long long)c * (S + 2);
      // accepts of the list before this byte, and its successors
      for (int i = lane; i < n_act; i += WARP) {
        const int s = act[i];
        if (s >= S) continue;  // sentinel slot
        if (__ldg(a.accept + s)) atomicAdd(row_cnt + s, 1);
        const int e = __ldg(off + s + 1);
        for (int k = __ldg(off + s); k < e; ++k) {
          const int t = __ldg(a.targets + k);
          atomicOr(bm + (t >> 5), 1u << (t & 31));
          atomicOr(sm + (t >> 10), 1u << ((t >> 5) & 31));
        }
      }
      __syncwarp();
      // ascending compaction of the set bits into the next list
      int total = 0;
      for (int k = 0; k < NS; ++k) {
        const unsigned sw = sm[k];  // the same word for every lane
        if (sw == 0u) continue;
        const int w = (k << 5) + lane;
        unsigned word = 0u;
        if ((sw >> lane) & 1u) {
          word = bm[w];
          bm[w] = 0u;
        }
        const int cnt = __popc(word);
        int inc = cnt;
        for (int d = 1; d < WARP; d <<= 1) {
          const int y = __shfl_up_sync(FULL, inc, d);
          if (lane >= d) inc += y;
        }
        int pos = total + inc - cnt;
        while (word) {
          const int bit = __ffs(word) - 1;
          word &= word - 1u;
          if (pos < A) nxt[pos] = (w << 5) + bit;
          ++pos;
        }
        total += __shfl_sync(FULL, inc, WARP - 1);
        __syncwarp();
        if (lane == 0) sm[k] = 0u;
      }
      overflow |= total > A;
      n_act = total < A ? total : A;
      int* t = act;
      act = nxt;
      nxt = t;
      __syncwarp();
    }
  }
  for (int i = lane; i < A; i += WARP) row_act[i] = i < n_act ? act[i] : S;
  if (lane == 0) a.overflow[n] = overflow ? 1 : 0;
}

int smem_optin_bytes() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 48 * 1024;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 48 * 1024;
  return v;
}

}  // namespace

// data: flat uint8 bytes, stream n is data[starts[n] : starts[n] + lengths[n]];
// class_of (256,) int32; offsets (C, S+2) and targets (E,) int32; accept
// (S+1,) uint8; active (N, A) int32 in/out; counts (N, S+1) int32 in/out;
// overflow (N,) uint8 out. Returns the CUDA error code (0 on success);
// cudaErrorInvalidValue when the list and the bitmaps of S states exceed the
// card's shared memory (about 1.7 million states at A = 128).
extern "C" int nfa_active_scan(const uint8_t* data, const long long* starts,
                               const long long* lengths, int n_streams, const int* class_of,
                               const int* offsets, const int* targets, const uint8_t* accept,
                               int S, int A, int* active, int* counts, uint8_t* overflow,
                               void* stream) {
  if (n_streams < 0 || S < 0 || A < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S, A);
  if (smem > (size_t)smem_optin_bytes()) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(nfa_active_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  NfaArgs a = {data, starts, lengths, class_of, offsets, targets, accept,
               S, A, active, counts, overflow};
  if (n_streams > 0)
    nfa_active_kernel<<<n_streams, WARP, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
