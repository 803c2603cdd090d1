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
// What bounds it on this card: per stream the scan is serial, as in JAX.
// Each byte is a chain of dependent steps (read the active set, read each
// state's CSR row, set the successors' bits, gather the bits into the next
// set), so the kernel is bound by the latency of that chain, not by bytes or
// operations: the bytes it must move (the streams once, the CSR once) take
// about 0.02 ms for 64 streams of 1 MiB at 3.35 TB/s.
//
// What the design does about it: every load on the per-byte chain is served
// from shared memory.
//   - The CTA's warps share one copy of the CSR in shared memory when it fits
//     narrowed to 16 bits (E < 65,536 and S < 65,535: offsets and targets as
//     uint16, filled from the int32 tensors), with the accept flags as bits
//     and the byte -> class map as bytes. The l7-corpus NFA (S = 722, C = 62)
//     takes about 96 KB. A CSR that does not fit is read from global memory
//     through the read-only cache (the 35,259-state Snort-corpus NFA).
//   - Each stream's counts are an (S+1) int32 row in shared memory, added to
//     the output row once at the end; global atomics only when it does not
//     fit.
//   - One warp per stream. A CTA holds several warps (streams) that share the
//     CSR; the launcher picks ceil(N / SMs) of them, so 64 streams take 64
//     SMs and thousands of streams fill every SM with many warps.
//   - Dedupe is a shared bitmap over the S states; ascending order, and so
//     "the A smallest", falls out of the bitmap order.
//   - For S <= 1,024 (W <= 32 words) the active set never becomes a list
//     between bytes: lane l keeps word l of it in a register, scatters its
//     own states' successors into one of two alternating shared bitmaps, and
//     takes its word back after one warp barrier. A warp-wide popcount says
//     whether the set exceeds A; only then are the A smallest kept. The list
//     is written once, at the end. On the l7 traffic a byte has 1.35 active
//     states on average, so a per-byte list compaction would be most of the
//     chain.
//   - Above 1,024 states a list of up to A states lives in shared memory; a
//     summary bitmap (one bit per 32-state word) lists the words a byte
//     touched, and the list positions come from a warp prefix sum of their
//     popcounts taken with six independent ballots (one per bit of the
//     count) instead of a chain of five shuffles.
//   - The next 32 bytes of the stream are loaded while the current 32 run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int MAX_WARPS = 16;  // streams per CTA

struct NfaArgs {
  const uint8_t* data;
  const long long* starts;
  const long long* lengths;
  int n_streams;
  const int* class_of;    // (256,)
  const int* offsets;     // (C, S+2)
  const int* targets;     // (E,)
  const uint8_t* accept;  // (S+1,)
  int C, S, E, A;
  int* active;            // (N, A) in: start lists, out: final lists
  int* counts;            // (N, S+1) accumulated in place
  uint8_t* overflow;      // (N,) out
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ inline int words_of(int S) { return S > 0 ? (S + 31) / 32 : 1; }

// Byte offsets into dynamic shared memory: the part the CTA's warps share,
// then one block of per_warp bytes for each warp (offsets act..cnt are
// relative to that block).
struct Layout {
  size_t accept, offsets, targets, warp0;
  size_t act, nxt, bm, sm, cnt, per_warp, total;
};

__host__ __device__ inline Layout layout(int C, int S, int E, int A, bool csr_smem,
                                         bool cnt_smem, int warps) {
  Layout L;
  const size_t W = words_of(S), NS = (W + 31) / 32;
  size_t off = 256;  // the class of each byte, uint8
  L.accept = off;
  off += align16(((size_t)S + 32) / 32 * sizeof(unsigned));
  L.offsets = off;
  if (csr_smem) off += align16((size_t)C * (S + 2) * sizeof(uint16_t));
  L.targets = off;
  if (csr_smem) off += align16((size_t)E * sizeof(uint16_t));
  L.warp0 = off;
  size_t w = 0;
  L.act = w;
  w += (size_t)A * sizeof(int);
  L.nxt = w;
  w += (size_t)A * sizeof(int);
  L.bm = w;  // W words; two alternating sets of 32 when W <= 32
  w += (W <= 32 ? 64 : W) * sizeof(unsigned);
  L.sm = w;
  w += NS * sizeof(unsigned);
  L.cnt = w;
  if (cnt_smem) w += ((size_t)S + 1) * sizeof(int);
  L.per_warp = align16(w);
  L.total = L.warp0 + (size_t)warps * L.per_warp;
  return L;
}

int device_attr(cudaDeviceAttr attr, int fallback) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return fallback;
  if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) return fallback;
  return v;
}

struct Plan {
  bool csr_smem, cnt_smem;
  int warps;  // 0: nothing fits
  size_t smem;
};

// The CSR in shared memory first (every warp's per-byte chain reads it),
// then the counts row; as many warps per CTA as spread N streams over the
// SMs, up to MAX_WARPS and what shared memory holds.
Plan plan(int C, int S, int E, int A, int n_streams) {
  const size_t limit = (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 48 * 1024);
  const int sms = device_attr(cudaDevAttrMultiProcessorCount, 1);
  int want = (n_streams + sms - 1) / sms;
  want = want < 1 ? 1 : (want > MAX_WARPS ? MAX_WARPS : want);
  const bool narrow = E < 65536 && S < 65535;
  for (int csr = narrow ? 1 : 0; csr >= 0; --csr) {
    for (int cnt = 1; cnt >= 0; --cnt) {
      const Layout L = layout(C, S, E, A, csr, cnt, 0);
      if (L.warp0 + L.per_warp > limit) continue;
      int warps = (int)((limit - L.warp0) / L.per_warp);
      warps = warps < want ? warps : want;
      return Plan{csr == 1, cnt == 1, warps, L.warp0 + (size_t)warps * L.per_warp};
    }
  }
  return Plan{false, false, 0, 0};
}

// The exclusive prefix sum of cnt (0..32) over the warp's lanes; *total
// gets the sum over all lanes. One ballot per bit of the count, so the six
// ballots do not wait on each other.
__device__ __forceinline__ int sum_below(int cnt, unsigned lanes_below, int* total) {
  int below = 0, sum = 0;
#pragma unroll
  for (int b = 0; b < 6; ++b) {
    const unsigned v = __ballot_sync(FULL, (cnt >> b) & 1);
    below += __popc(v & lanes_below) << b;
    sum += __popc(v) << b;
  }
  *total = sum;
  return below;
}

// The set bits of `word` (bitmap word w), ascending, at out[pos..A).
__device__ __forceinline__ void write_bits(unsigned word, int w, int pos, int* out, int A) {
  while (word && pos < A) {
    const int bit = __ffs(word) - 1;
    word &= word - 1u;
    out[pos++] = (w << 5) + bit;
  }
}

// The CSR offsets row of class c: uint16 in shared memory or int32 in
// global memory.
template <bool CSR_SMEM>
__device__ __forceinline__ const void* offsets_row(int c, const NfaArgs& a,
                                                   const uint16_t* off16) {
  if (CSR_SMEM) return off16 + c * (a.S + 2);
  return a.offsets + (long long)c * (a.S + 2);
}

// Set the bits of the successors of state s (on the class of `orow`) in bm
// and, with a summary, the bits of their words in sm.
template <bool CSR_SMEM, bool SUMMARY>
__device__ __forceinline__ void scatter(int s, const void* orow, const NfaArgs& a,
                                        const uint16_t* tgt16, unsigned* bm, unsigned* sm) {
  int k, e;
  if (CSR_SMEM) {
    const uint16_t* o = static_cast<const uint16_t*>(orow) + s;
    k = o[0];
    e = o[1];
  } else {
    const int* o = static_cast<const int*>(orow) + s;
    k = __ldg(o);
    e = __ldg(o + 1);
  }
#pragma unroll 1
  for (; k < e; ++k) {  // most lists hold one or two states
    const int t = CSR_SMEM ? (int)tgt16[k] : __ldg(a.targets + k);
    atomicOr(bm + (t >> 5), 1u << (t & 31));
    if (SUMMARY) atomicOr(sm + (t >> 10), 1u << ((t >> 5) & 31));
  }
}

// The list given for the first byte, as the JAX step takes it: every slot
// (sentinels skipped, duplicates counted per slot) counts its accept and
// scatters its successors.
template <bool CSR_SMEM, bool SUMMARY>
__device__ __forceinline__ void step_list(const int* list, int n, const void* orow,
                                          const NfaArgs& a, const unsigned* acc_bits,
                                          const uint16_t* tgt16, int* cnt, unsigned* bm,
                                          unsigned* sm) {
  for (int i = threadIdx.x % WARP; i < n; i += WARP) {
    const int s = list[i];
    if (s >= a.S) continue;  // sentinel slot
    if ((acc_bits[s >> 5] >> (s & 31)) & 1u) atomicAdd(cnt + s, 1);
    scatter<CSR_SMEM, SUMMARY>(s, orow, a, tgt16, bm, sm);
  }
}

// Bitmap route: after the successors of a byte are scattered, each lane
// that owns a word takes it back from `mine` (and clears it for the byte
// after next); when the set holds more than A states only the A smallest
// stay.
__device__ __forceinline__ unsigned take_word(unsigned* mine, bool owns, int A,
                                              unsigned lanes_below, bool& overflow) {
  __syncwarp();
  unsigned cur = 0u;
  if (owns) {
    cur = *mine;
    if (cur) *mine = 0u;
  }
  // more than A states needs more than A / 32 words: a ballot rules the
  // common case out before the warp-wide sum
  if (32 * __popc(__ballot_sync(FULL, cur != 0u)) > A &&
      __reduce_add_sync(FULL, __popc(cur)) > A) {
    overflow = true;
    int total;
    const int keep = A - sum_below(__popc(cur), lanes_below, &total);
    unsigned rest = cur;
    for (int i = 0; i < keep && rest; ++i) rest &= rest - 1u;
    cur = keep > 0 ? cur ^ rest : 0u;
  }
  return cur;
}

template <bool CSR_SMEM, bool CNT_SMEM, bool SMALL>
__global__ void __launch_bounds__(MAX_WARPS* WARP) nfa_active_kernel(NfaArgs a, int warps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, A = a.A, C = a.C;
  const int W = words_of(S);
  const int NS = (W + 31) / 32;
  const Layout L = layout(C, S, a.E, A, CSR_SMEM, CNT_SMEM, warps);
  uint8_t* lut = smem;
  unsigned* acc_bits = reinterpret_cast<unsigned*>(smem + L.accept);
  uint16_t* off16 = reinterpret_cast<uint16_t*>(smem + L.offsets);
  uint16_t* tgt16 = reinterpret_cast<uint16_t*>(smem + L.targets);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / WARP, lane = tid % WARP;

  // what the CTA's warps share: class map, accept bits, the narrowed CSR
  for (int i = tid; i < 256; i += nthr) lut[i] = (uint8_t)a.class_of[i];
  for (int i = warp; i < (S + 32) / 32; i += warps) {
    const int s = i * 32 + lane;
    const unsigned bits = __ballot_sync(FULL, s <= S && a.accept[s]);
    if (lane == 0) acc_bits[i] = bits;
  }
  if (CSR_SMEM) {
    const int n_off = C * (S + 2);
#pragma unroll 8
    for (int i = tid; i < n_off; i += nthr) off16[i] = (uint16_t)__ldg(a.offsets + i);
#pragma unroll 8
    for (int i = tid; i < a.E; i += nthr) tgt16[i] = (uint16_t)__ldg(a.targets + i);
  }
  __syncthreads();  // the only CTA-wide barrier; each warp runs alone from here

  const long long n = (long long)blockIdx.x * warps + warp;
  if (n >= a.n_streams) return;
  unsigned char* ws = smem + L.warp0 + (size_t)warp * L.per_warp;
  int* act = reinterpret_cast<int*>(ws + L.act);
  int* nxt = reinterpret_cast<int*>(ws + L.nxt);
  unsigned* bm = reinterpret_cast<unsigned*>(ws + L.bm);
  unsigned* sm = reinterpret_cast<unsigned*>(ws + L.sm);
  int* out_cnt = a.counts + n * (S + 1);
  int* cnt = CNT_SMEM ? reinterpret_cast<int*>(ws + L.cnt) : out_cnt;
  for (int i = lane; i < (SMALL ? 64 : W); i += WARP) bm[i] = 0u;
  for (int i = lane; i < NS; i += WARP) sm[i] = 0u;
  if (CNT_SMEM)
    for (int i = lane; i <= S; i += WARP) cnt[i] = 0;
  int* row_act = a.active + n * A;
  for (int i = lane; i < A; i += WARP) act[i] = row_act[i];
  __syncwarp();

  const unsigned lanes_below = (1u << lane) - 1u;
  bool overflow = false;
  const uint8_t* data = a.data + a.starts[n];
  const long long len = a.lengths[n];
  int byte = lane < len ? data[lane] : 0;

  if (SMALL) {
    // W <= 32: lane l holds word l of the active set (states 32l..32l+31)
    // in a register, and the set is never written out as a list until the
    // end. A byte scatters the successors of the lane's states into one of
    // two alternating shared bitmaps, and each lane takes back its word:
    // one warp barrier per byte, and a list only when the set exceeds A.
    const bool owns = lane < W;
    const unsigned accw = owns ? acc_bits[lane] : 0u;
    unsigned* const set1 = bm + 32;  // the other set is bm
    unsigned* const mine0 = bm + lane;
    unsigned* const mine1 = set1 + lane;
    unsigned cur = 0u;
    int buf = 0;
    for (long long p0 = 0; p0 < len; p0 += WARP) {
      const int mycls = lut[byte];
      const int m = (int)(len - p0 < WARP ? len - p0 : WARP);
      if (p0 + WARP + lane < len) byte = data[p0 + WARP + lane];  // in flight meanwhile
      int c = __shfl_sync(FULL, mycls, 0);
      int j = 0;
      if (p0 == 0) {  // the first byte steps from the given list
        step_list<CSR_SMEM, false>(act, A, offsets_row<CSR_SMEM>(c, a, off16), a, acc_bits,
                                   tgt16, cnt, bm, sm);
        cur = take_word(mine0, owns, A, lanes_below, overflow);
        buf = 1;
        c = __shfl_sync(FULL, mycls, 1);
        j = 1;
      }
      for (; j < m; ++j) {
        const void* orow = offsets_row<CSR_SMEM>(c, a, off16);
        c = __shfl_sync(FULL, mycls, j + 1);  // the next byte's class, off the chain
        // the lane's states are its own: no other lane counts them
        for (unsigned h = cur & accw; h; h &= h - 1u) cnt[(lane << 5) + __ffs(h) - 1] += 1;
        for (unsigned x = cur; x; x &= x - 1u)
          scatter<CSR_SMEM, false>((lane << 5) + __ffs(x) - 1, orow, a, tgt16,
                                   buf ? set1 : bm, sm);
        cur = take_word(buf ? mine1 : mine0, owns, A, lanes_below, overflow);
        buf ^= 1;
      }
    }
    if (len > 0) {  // an empty stream keeps its given list as it is
      int total;
      const int below = sum_below(__popc(cur), lanes_below, &total);
      write_bits(cur, lane, below, row_act, A);
      for (int i = total + lane; i < A; i += WARP) row_act[i] = S;
    }
  } else {
    // a list of up to A states in shared memory; the successors' bitmap and
    // its summary give the next list in ascending order
    int n_act = A;  // the first byte reads every given slot
    for (long long p0 = 0; p0 < len; p0 += WARP) {
      const int mycls = lut[byte];
      const int m = (int)(len - p0 < WARP ? len - p0 : WARP);
      if (p0 + WARP + lane < len) byte = data[p0 + WARP + lane];  // in flight meanwhile
      for (int j = 0; j < m; ++j) {
        const int c = __shfl_sync(FULL, mycls, j);
        step_list<CSR_SMEM, true>(act, n_act, offsets_row<CSR_SMEM>(c, a, off16), a,
                                  acc_bits, tgt16, cnt, bm, sm);
        __syncwarp();
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
          int sum;
          write_bits(word, w, total + sum_below(__popc(word), lanes_below, &sum), nxt, A);
          total += sum;
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
  }
  if (lane == 0) a.overflow[n] = overflow ? 1 : 0;
  if (CNT_SMEM) {
    __syncwarp();
    for (int i = lane; i <= S; i += WARP) {
      const int v = cnt[i];
      if (v) out_cnt[i] += v;  // the row is this warp's alone
    }
  }
}

template <bool CSR_SMEM, bool CNT_SMEM>
int launch(const NfaArgs& a, const Plan& p, cudaStream_t st) {
  auto kernel = words_of(a.S) <= 32 ? nfa_active_kernel<CSR_SMEM, CNT_SMEM, true>
                                    : nfa_active_kernel<CSR_SMEM, CNT_SMEM, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (a.n_streams + p.warps - 1) / p.warps;
  kernel<<<grid, p.warps * WARP, p.smem, st>>>(a, p.warps);
  return (int)cudaGetLastError();
}

}  // namespace

// data: flat uint8 bytes, stream n is data[starts[n] : starts[n] + lengths[n]];
// class_of (256,) int32; offsets (C, S+2) and targets (E,) int32; accept
// (S+1,) uint8; active (N, A) int32 in/out; counts (N, S+1) int32 in/out;
// overflow (N,) uint8 out. Returns the CUDA error code (0 on success);
// cudaErrorInvalidValue when one stream's list and bitmaps exceed the card's
// shared memory (about 1.7 million states at A = 128).
extern "C" int nfa_active_scan(const uint8_t* data, const long long* starts,
                               const long long* lengths, int n_streams, const int* class_of,
                               const int* offsets, const int* targets, const uint8_t* accept,
                               int C, int S, int E, int A, int* active, int* counts,
                               uint8_t* overflow, void* stream) {
  if (n_streams < 0 || S < 0 || A < 1 || C < 0 || E < 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(C, S, E, A, n_streams);
  if (p.warps == 0) return (int)cudaErrorInvalidValue;
  if (n_streams == 0) return 0;
  NfaArgs a = {data, starts, lengths, n_streams, class_of, offsets, targets, accept,
               C, S, E, A, active, counts, overflow};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.csr_smem)
    return p.cnt_smem ? launch<true, true>(a, p, st) : launch<true, false>(a, p, st);
  return p.cnt_smem ? launch<false, true>(a, p, st) : launch<false, false>(a, p, st);
}

// Where a launch keeps its data: bit 0 = CSR in shared memory (16-bit), bit 1
// = counts rows in shared memory, bits 8 and up = streams (warps) per CTA;
// -1 when nothing fits.
extern "C" int nfa_active_route(int C, int S, int E, int A, int n_streams) {
  const Plan p = plan(C, S, E, A, n_streams);
  if (p.warps == 0) return -1;
  return (p.csr_smem ? 1 : 0) | (p.cnt_smem ? 2 : 0) | (p.warps << 8);
}
