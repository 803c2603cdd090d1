// K5: the exact NFA scan over a bitmap of active states, written by hand for
// Hopper (sm_90a).
//
// Replaces the XLA loop regex_fpga_tpu/parallel/tp_scan.py::nfa_scan_tp (the
// lax.scan of its step, vmapped over streams, with the model axis of size
// one). The JAX package had no Pallas kernel for it.
//
// What it computes, per stream n and per byte of that stream, on a bitmap
// of active NFA states (no bound on how many are active):
//   1. every active state s < S that accepts adds one to counts[n, s] (the
//      set active *before* the byte);
//   2. the next bitmap is the union of the successors of the active states
//      on the byte's class, read from the per-class CSR of NfaCsr (offsets
//      (C, S+2), targets). States >= S (the sentinel and padding) have no
//      successors and never count, so they are clear after the first byte.
// A stream of length 0 leaves its bitmap as it was given.
//
// What bounds it on this card: per stream the scan is serial. A byte is a
// chain of dependent steps (read the active words, read each active
// state's CSR row, set its successors' bits, wait until every bit is set),
// so the kernel is bound by that chain's latency, not by bytes or
// operations: the streams, the CSR and the outputs take about 0.02 ms at
// 3.35 TB/s for 64 streams of 1 MiB of the l7-corpus NFA.
//
// The design, simple first:
//   - One CTA per stream; the byte loop runs inside the kernel. The current
//     and the next bitmap live in shared memory (23 words for the l7-corpus
//     NFA, 1,102 for the 35,259-state Snort-corpus NFA). Thread t owns words
//     t, t + T, ...: it reads and clears them, counts their accepting states
//     and expands their states' successors with atomicOr into the next
//     bitmap. One CTA barrier a byte, a second one only on a byte that
//     queued wide rows (below), and the bitmaps swap.
//   - Counters only for accepting states, through a compact index (the
//     popcount of the accept bits below a state): 44 counters for l7, 2,142
//     for Snort. A state's word always belongs to one thread, so a counter
//     needs no atomic. Added into the output row once, at the end; in global
//     memory, straight into the row, when they do not fit.
//   - The CSR as K4 stages it: narrowed to uint16 in shared memory when it
//     fits there (E < 65,536 and S < 65,535; about 96 KB for l7), else read
//     from global memory through the read-only cache.
//   - Wide rows: a state whose row holds more than WIDE successors (state 0
//     of the Snort corpus holds up to 1,266) is queued; after the first
//     barrier all T threads of the CTA set the queued rows' bits together.
//   - The classes of the next T bytes are staged in shared memory once per
//     T bytes.
//
// nfa_tp_step is the same scan with the states sharded over the ranks of a
// model axis (tp_scan.py's step with more than one rank): one launch a byte,
// because the next bitmap needs a sum over the ranks between two bytes. A
// rank owns the states lo..lo+n-1; the launch reads their activity from the
// previous byte's summed (B, s_pad) int32 successor flags (> 0 is active;
// the start bitmap as int32 before the first byte), counts the accepting
// ones, and writes a 1 at every successor of an active state into a fresh
// (B, s_pad) vector, which the caller sums over the ranks before the next
// launch. One CTA of 256 threads a stream and 256 states; warp w's lanes
// test 32 consecutive states, then the warp walks each active lane's CSR row
// together, a lane an edge, so a wide row costs ceil(K / 32) warp steps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int WIDE = 16;      // a row longer than this is shared by the CTA
constexpr int QUEUE = 1024;   // wide rows queued per byte; more run alone

struct TpArgs {
  const uint8_t* streams;  // (B, L) contiguous
  long long L;
  int B;
  const int* class_of;     // (256,)
  const int* offsets;      // (C, S+2)
  const int* targets;      // (E,)
  const uint8_t* accept;   // (S+1,)
  int C, S, E, n_acc;
  unsigned* bitmap;        // (B, W) in/out, W = ceil(N / 32)
  int* counts;             // (B, N) in/out
  int N, W;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ inline int words_of(int S) { return S > 0 ? (S + 31) / 32 : 1; }

struct Layout {
  size_t accw, accpre, cur, nxt, cnt, queue, qn, win, offsets, targets, total;
};

__host__ __device__ inline Layout layout(int C, int S, int E, int n_acc, bool csr_smem,
                                         bool cnt_smem, int threads) {
  Layout L;
  const size_t Ws = words_of(S);
  size_t off = 256;  // the class of each byte, uint8
  L.accw = off;
  off += align16(Ws * sizeof(unsigned));
  L.accpre = off;
  off += align16(Ws * sizeof(int));
  L.cur = off;
  off += align16(Ws * sizeof(unsigned));
  L.nxt = off;
  off += align16(Ws * sizeof(unsigned));
  L.cnt = off;
  if (cnt_smem) off += align16((size_t)n_acc * sizeof(int));
  L.queue = off;
  off += (size_t)QUEUE * sizeof(int2);
  L.qn = off;  // three counters
  off += 16;
  L.win = off;
  off += align16((size_t)threads);
  L.offsets = off;
  if (csr_smem) off += align16((size_t)C * (S + 1) * sizeof(uint16_t));
  L.targets = off;
  if (csr_smem) off += align16((size_t)E * sizeof(uint16_t));
  L.total = off;
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
  int threads;  // 0: nothing fits
  size_t smem;
};

// A warp for every 32 words of the bitmap, up to MAX_THREADS; the CSR in
// shared memory first, then the counters.
Plan plan(int C, int S, int E, int n_acc) {
  const size_t limit = (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 48 * 1024);
  int threads = (words_of(S) + 31) / 32 * 32;
  threads = threads > MAX_THREADS ? MAX_THREADS : threads;
  const bool narrow = E < 65536 && S < 65535;
  for (int csr = narrow ? 1 : 0; csr >= 0; --csr) {
    for (int cnt = 1; cnt >= 0; --cnt) {
      const Layout L = layout(C, S, E, n_acc, csr, cnt, threads);
      if (L.total <= limit) return Plan{csr == 1, cnt == 1, threads, L.total};
    }
  }
  return Plan{false, false, 0, 0};
}

template <bool CSR_SMEM>
__device__ __forceinline__ int2 row_of(int c, int s, const TpArgs& a, const uint16_t* off16) {
  if (CSR_SMEM) {
    const uint16_t* o = off16 + c * (a.S + 1) + s;
    return make_int2(o[0], o[1]);
  }
  const int* o = a.offsets + (long long)c * (a.S + 2) + s;
  return make_int2(__ldg(o), __ldg(o + 1));
}

template <bool CSR_SMEM>
__device__ __forceinline__ void set_bit(int k, const TpArgs& a, const uint16_t* tgt16,
                                        unsigned* nxt) {
  const int t = CSR_SMEM ? (int)tgt16[k] : __ldg(a.targets + k);
  atomicOr(nxt + (t >> 5), 1u << (t & 31));
}

template <bool CSR_SMEM, bool CNT_SMEM>
__global__ void __launch_bounds__(MAX_THREADS) nfa_tp_kernel(TpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, T = blockDim.x, tid = threadIdx.x;
  const int Ws = words_of(S);
  const Layout L = layout(a.C, S, a.E, a.n_acc, CSR_SMEM, CNT_SMEM, T);
  uint8_t* lut = smem;
  unsigned* accw = reinterpret_cast<unsigned*>(smem + L.accw);
  int* accpre = reinterpret_cast<int*>(smem + L.accpre);
  unsigned* cur = reinterpret_cast<unsigned*>(smem + L.cur);
  unsigned* nxt = reinterpret_cast<unsigned*>(smem + L.nxt);
  int2* queue = reinterpret_cast<int2*>(smem + L.queue);
  int* qn = reinterpret_cast<int*>(smem + L.qn);
  uint8_t* win = smem + L.win;
  uint16_t* off16 = reinterpret_cast<uint16_t*>(smem + L.offsets);
  uint16_t* tgt16 = reinterpret_cast<uint16_t*>(smem + L.targets);

  const long long n = blockIdx.x;
  unsigned* row_bm = a.bitmap + n * a.W;
  int* row_cnt = a.counts + n * a.N;
  int* cnt = CNT_SMEM ? reinterpret_cast<int*>(smem + L.cnt) : row_cnt;

  for (int i = tid; i < 256; i += T) lut[i] = (uint8_t)a.class_of[i];
  for (int w = tid; w < Ws; w += T) {
    unsigned bits = 0u, real = 0u;
    for (int i = 0; i < 32; ++i) {
      const int s = (w << 5) + i;
      if (s < S) {
        real |= 1u << i;
        if (a.accept[s]) bits |= 1u << i;
      }
    }
    accw[w] = bits;
    cur[w] = row_bm[w] & real;  // states >= S have no successors
    nxt[w] = 0u;
  }
  if (CNT_SMEM)
    for (int i = tid; i < a.n_acc; i += T) cnt[i] = 0;
  if (CSR_SMEM) {
    const int cols = S + 1;
    for (int i = tid; i < a.C * cols; i += T) {
      const int c = i / cols, s = i - c * cols;
      off16[i] = (uint16_t)__ldg(a.offsets + (long long)c * (S + 2) + s);
    }
    for (int i = tid; i < a.E; i += T) tgt16[i] = (uint16_t)__ldg(a.targets + i);
  }
  if (tid == 0) qn[0] = qn[1] = qn[2] = 0;
  __syncthreads();
  if (tid == 0) {  // the counter index of each word's first accepting state
    int run = 0;
    for (int w = 0; w < Ws; ++w) {
      accpre[w] = run;
      run += __popc(accw[w]);
    }
  }
  __syncthreads();

  const uint8_t* data = a.streams + n * a.L;
  int q = 0;  // the byte's index mod 3
  for (long long p0 = 0; p0 < a.L; p0 += T) {
    __syncthreads();  // the previous window is consumed
    if (p0 + tid < a.L) win[tid] = lut[data[p0 + tid]];
    __syncthreads();
    const int m = (int)(a.L - p0 < T ? a.L - p0 : T);
    for (int j = 0; j < m; ++j) {
      const int c = win[j];
      // byte t counts its wide rows in qn[t % 3] and clears byte t+1's
      // counter, whose last readers (byte t-2) all passed byte t-1's first
      // barrier before any thread began byte t
      const int q1 = q == 2 ? 0 : q + 1;
      if (tid == 0) qn[q1] = 0;
      for (int w = tid; w < Ws; w += T) {
        const unsigned x = cur[w];
        if (!x) continue;
        cur[w] = 0u;  // this buffer is the next byte's next bitmap
        const unsigned acc = accw[w];
        if (unsigned h = x & acc) {
          int* cw = CNT_SMEM ? cnt + accpre[w] : cnt + (w << 5);
          for (; h; h &= h - 1u) {
            const int bit = __ffs(h) - 1;
            cw[CNT_SMEM ? __popc(acc & ((1u << bit) - 1u)) : bit] += 1;
          }
        }
        for (unsigned y = x; y; y &= y - 1u) {
          const int s = (w << 5) + __ffs(y) - 1;
          const int2 r = row_of<CSR_SMEM>(c, s, a, off16);
          if (r.y - r.x > WIDE) {
            const int slot = atomicAdd(qn + q, 1);
            if (slot < QUEUE) {
              queue[slot] = r;
              continue;
            }
          }
          for (int k = r.x; k < r.y; ++k) set_bit<CSR_SMEM>(k, a, tgt16, nxt);
        }
      }
      __syncthreads();
      const int nq = qn[q] < QUEUE ? qn[q] : QUEUE;  // the same for every thread
      if (nq) {
        for (int i = 0; i < nq; ++i) {
          const int2 r = queue[i];
          for (int k = r.x + tid; k < r.y; k += T) set_bit<CSR_SMEM>(k, a, tgt16, nxt);
        }
        __syncthreads();  // the wide rows' bits are set; the queue is free
      }
      unsigned* t = cur;
      cur = nxt;
      nxt = t;
      q = q1;
    }
  }
  if (a.L > 0) {
    for (int w = tid; w < a.W; w += T) row_bm[w] = w < Ws ? cur[w] : 0u;
  }
  if (CNT_SMEM) {
    for (int w = tid; w < Ws; w += T) {
      int i = accpre[w];
      for (unsigned h = accw[w]; h; h &= h - 1u) {
        const int v = cnt[i++];
        if (v) row_cnt[(w << 5) + __ffs(h) - 1] += v;
      }
    }
  }
}

template <bool CSR_SMEM, bool CNT_SMEM>
int launch(const TpArgs& a, const Plan& p, cudaStream_t st) {
  auto kernel = nfa_tp_kernel<CSR_SMEM, CNT_SMEM>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<a.B, p.threads, p.smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// streams (B, L) uint8 contiguous; class_of (256,) int32; offsets (C, S+2)
// and targets (E,) int32; accept (S+1,) uint8; n_acc the accepting states
// below S; bitmap (B, W) uint32 words in/out, W = ceil(N / 32); counts
// (B, N) int32 in/out, N >= S + 1. Returns the CUDA error code (0 on
// success); cudaErrorInvalidValue when the bitmaps exceed shared memory.
extern "C" int nfa_tp_scan(const uint8_t* streams, long long L, int B, const int* class_of,
                           const int* offsets, const int* targets, const uint8_t* accept,
                           int C, int S, int E, int n_acc, unsigned* bitmap, int* counts,
                           int N, void* stream) {
  if (B < 0 || L < 0 || S < 0 || C < 0 || E < 0 || n_acc < 0 || N < S + 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(C, S, E, n_acc);
  if (p.threads == 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  TpArgs a = {streams, L, B, class_of, offsets, targets, accept, C, S, E, n_acc,
              bitmap, counts, N, (N + 31) / 32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.csr_smem)
    return p.cnt_smem ? launch<true, true>(a, p, st) : launch<true, false>(a, p, st);
  return p.cnt_smem ? launch<false, true>(a, p, st) : launch<false, false>(a, p, st);
}

namespace {

constexpr int STEP_THREADS = 256;

struct StepArgs {
  const uint8_t* streams;  // (B, L) contiguous
  long long L, t;          // the byte t of every stream
  const int* class_of;     // (256,)
  const int* offsets;      // (C, S+2)
  const int* targets;      // (E,), all < S
  const uint8_t* accept;   // (S+1,)
  int S, lo, n, s_pad;
  const int* act;          // row b at act + b * act_stride, n entries
  long long act_stride;
  int* counts;             // (B, n) in/out
  int* partial;            // (B, s_pad) out, zeroed before the launch
};

__global__ void __launch_bounds__(STEP_THREADS) nfa_tp_step_kernel(StepArgs a) {
  const long long b = blockIdx.y;
  const int i = blockIdx.x * STEP_THREADS + threadIdx.x;  // local state
  const int lane = threadIdx.x & 31;
  const int s = a.lo + i;
  // states >= S (the sentinel, padding) are inert: cleared, never counted
  const bool on = i < a.n && s < a.S && a.act[b * a.act_stride + i] > 0;
  if (on && a.accept[s]) a.counts[b * a.n + i] += 1;
  const int c = __ldg(a.class_of + a.streams[b * a.L + a.t]);
  const int* off = a.offsets + (long long)c * (a.S + 2);
  int* out = a.partial + b * a.s_pad;
  for (unsigned m = __ballot_sync(0xffffffffu, on); m; m &= m - 1u) {
    const int src = s - lane + __ffs(m) - 1;
    const int lo = __ldg(off + src), hi = __ldg(off + src + 1);
    for (int k = lo + lane; k < hi; k += 32) out[__ldg(a.targets + k)] = 1;
  }
}

}  // namespace

// One byte of the sharded scan (tp_scan.py's step on one rank of the model
// axis): streams (B, L) uint8 contiguous, t the byte; class_of (256,),
// offsets (C, S+2) and targets (E,) int32 (targets < S); accept (S+1,)
// uint8; the rank's states are lo..lo+n-1 of s_pad; act row b at
// act + b * act_stride (n int32, > 0 = active); counts (B, n) int32 in/out;
// partial (B, s_pad) int32 out: 1 at every successor of an active state,
// 0 elsewhere. Returns the CUDA error code (0 on success).
extern "C" int nfa_tp_step(const uint8_t* streams, long long L, long long t, int B,
                           const int* class_of, const int* offsets, const int* targets,
                           const uint8_t* accept, int S, int lo, const int* act,
                           long long act_stride, int* counts, int* partial, int n,
                           int s_pad, void* stream) {
  if (B < 0 || B > 65535 || t < 0 || t >= L || S < 0 || lo < 0 || n < 0 || lo + n > s_pad ||
      s_pad < S + 1 || act_stride < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(partial, 0, (size_t)B * s_pad * sizeof(int), st);
  if (e != cudaSuccess || B == 0 || n == 0) return (int)e;
  StepArgs a = {streams, L, t, class_of, offsets, targets, accept, S, lo, n, s_pad,
                act, act_stride, counts, partial};
  const dim3 grid((n + STEP_THREADS - 1) / STEP_THREADS, B);
  nfa_tp_step_kernel<<<grid, STEP_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Where a launch keeps its data: bit 0 = CSR in shared memory (16-bit), bit 1
// = counters in shared memory, bits 8 and up = threads per CTA; -1 when the
// bitmaps do not fit.
extern "C" int nfa_tp_route(int C, int S, int E, int n_acc) {
  const Plan p = plan(C, S, E, n_acc);
  if (p.threads == 0) return -1;
  return (p.csr_smem ? 1 : 0) | (p.cnt_smem ? 2 : 0) | (p.threads << 8);
}
