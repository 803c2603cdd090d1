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
// What the design does about it: a byte's chain crosses no CTA barrier, and
// its work follows the active set, not the bitmap's width.
//   - One warp a stream, several streams a CTA (ceil(B / SMs) of them, up to
//     16), which share one copy of the class map, the accept bits and the
//     edges; the byte loop synchronises the warp only (__syncwarp).
//   - The edges of the states but the start state, the first of these that
//     fits in shared memory: K4's CSR narrowed to uint16 (E < 65,536 and
//     S < 65,535; about 96 KB for l7); else, when no such state has more
//     than WIDE edges over all classes, each state's edges in D slots,
//     packed as class << 24 | target (the Snort-corpus NFA: a state has at
//     most one edge, 141 KB, where its per-class offsets take 11.7 MB); else
//     the CSR in global memory through the read-only cache.
//   - The start state (state 0, active on every byte of an unanchored
//     search) has its successors on each class precomputed by the wrapper,
//     once per CSR, as (word, mask) pairs and a self-loop flag (Snort's
//     state 0 has up to 1,266 successors a class in up to 820 words).
//   - Any other row longer than WIDE is walked by the whole warp, a lane an
//     edge; the warp looks for such rows only when the CSR has one.
//   - S <= 1,024 (W <= 32 words; the l7-corpus NFA has 23): lane l keeps
//     word l of the active set in a register, as K4's route does. Each lane
//     sets its states' successors in one of two alternating per-warp shared
//     bitmaps of 32 words and takes its word back after __syncwarp, clearing
//     the slot it read. The start state's successors are a dense table of 32
//     words a class in shared memory: when the start state is active, each
//     lane ORs in its own word of the byte's class, with no atomics.
//   - S > 1,024 (the Snort-corpus NFA, W = 1,102): two alternating per-warp
//     bitmaps in shared memory, each with the list of its non-zero words.
//     The lane whose atomicOr turns a word from 0 to non-zero appends it to
//     the next byte's list. The start state's pairs, a lane a word, append
//     nothing: the next byte takes their words from the lanes that set them,
//     and a word found both ways is read once, by atomicExch. A byte reads
//     and clears only those words, a word a lane (about 30 active states in
//     17 words a byte on the Snort traffic), and when a word holds several
//     active states (the start state's successors are often neighbours)
//     spreads the round's states over the lanes (a prefix sum of popcounts
//     in six ballots). A list never holds more than W words, so there is no
//     bound and no overflow. The start state is kept out of the bitmap: its
//     bit is the top bit of the list's count, which every lane reads anyway,
//     or its self-loop flag. Each lane looks up the pairs of its own byte of
//     the window once per 32 bytes; a byte takes its class's with shuffles.
//   - Two-step route (listed bitmaps, when no state but the start state
//     reaches a start successor, as in the Snort-corpus NFA's literal
//     chains): the start state's successors never enter the bitmap. The
//     byte after counts the accepting ones from the pairs (a per-class flag
//     says whether there are any) and sets their own successors from a
//     table per pair of classes, built once per CSR by the wrapper (1,133
//     pairs for the Snort-corpus NFA). Most of them die on that byte, and
//     none is listed; the last byte's join the bitmap at the end.
//   - Counters for accepting states only, through a compact index (the
//     popcount of the accept bits below a state; 44 for l7, 2,142 for
//     Snort), per warp in shared memory and added into the output row once
//     at the end; straight into the row when they do not fit.
//   - The next 32 bytes of the stream are loaded, a byte a lane, while the
//     current 32 run; a byte's class comes from a shuffle.
//
// nfa_tp_step is the same scan with the states sharded over the ranks of a
// model axis (tp_scan.py's step with more than one rank): one launch a byte,
// because the next bitmap needs a sum over the ranks between two bytes. A
// rank owns the states lo..lo+n-1. The flags rotate through three (B, s_pad)
// uint8 buffers: launch t reads byte t's activity from buffer t mod 3 (the
// flags summed over the ranks, > 0 is active; the start bitmap before byte
// 0), counts the accepting ones, writes a 1 at every successor of an active
// state into buffer (t+1) mod 3, which launch t-1 cleared, and clears buffer
// (t+2) mod 3, which launch t-1 read: one launch a byte and no memset. One
// CTA of 256 threads a stream and 256 states; warp w's lanes test 32
// consecutive states, then the warp walks each active lane's CSR row
// together, a lane an edge, so a wide row costs ceil(K / 32) warp steps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int MAX_WARPS = 16;                // streams per CTA
constexpr int WIDE = 8;                      // a longer row is walked by the warp
constexpr unsigned START_ON = 0x80000000u;   // the start state's bit in a list count
constexpr unsigned COUNT = 0x7fffffffu;
constexpr int START_LOOPS = static_cast<int>(0x80000000u);  // start_off[c]: the start state loops on c
constexpr int START_ACCEPTS = 1 << 30;      // start_off[c]: a successor on c accepts
constexpr int START_AT = (1 << 30) - 1;     // start_off[c]: the offset
constexpr unsigned NO_EDGE = 0xffffffffu;    // an empty edge slot

// Where a launch reads the edges of the states but the start state, the
// plan's first choice that fits: the per-class CSR narrowed to uint16 in
// shared memory; D slots a state in shared memory, each edge packed as
// class << 24 | target (when no state but the start state has more than
// WIDE edges over all classes); the per-class CSR in global memory through
// the read-only cache.
enum Edges { CSR_GLOBAL = 0, CSR_SHARED = 1, SLOTS_SHARED = 2 };

struct TpArgs {
  const uint8_t* streams;  // (B, L) contiguous
  long long L;
  int B;
  const int* class_of;     // (256,)
  const int* offsets;      // (C, S+2)
  const int* targets;      // (E,), all < S
  const uint8_t* accept;   // (S+1,)
  int C, S, E, n_acc;
  const int* start_off;    // (C+1,): class c's pairs are start_rows[start_off[c] & START_AT ..],
                           // with the START_LOOPS and START_ACCEPTS flags
  const int2* start_rows;  // (n_start,): (word, mask) of the start state's other successors
  int n_start;
  const int* two_off;      // (C*C+1,) or null: pairs (c1, c2) of the start successors
  const int2* two_rows;    //   stepped once more, as two_rows[two_off[c1 * C + c2] ..]
  const unsigned* slots;   // (S, D): each state's edges, class << 24 | target
  int D;                   // 0: no slots
  int wide;                // a state other than the start state has a row > WIDE
  unsigned* bitmap;        // (B, W) in/out, W = ceil(N / 32)
  int* counts;             // (B, N) in/out
  int N, W;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ inline int words_of(int S) { return S > 0 ? (S + 31) / 32 : 1; }

// Byte offsets into dynamic shared memory: the part the CTA's warps share,
// then one block of per_warp bytes for each warp (bm..cnt relative to it).
struct Layout {
  size_t accw, accpre, start_words, start_off, start_rows, edges, targets, warp0;
  size_t bm, list, num, states, cnt, per_warp;
};

__host__ __device__ inline Layout layout(int C, int S, int E, int n_acc, int n_start, int D,
                                         int edges, bool cnt_smem) {
  Layout L;
  const size_t W = words_of(S);
  const bool small = W <= 32, csr = edges == CSR_SHARED;
  const bool pairs = !small && edges != CSR_GLOBAL;  // the start pairs in shared memory
  size_t off = 256;  // the class of each byte, uint8
  L.accw = off;
  off += align16(W * sizeof(unsigned));
  L.accpre = off;
  if (cnt_smem) off += align16(W * sizeof(int));
  L.start_words = off;  // register route: the start state's successors, a word a lane
  if (small) off += (size_t)C * 32 * sizeof(unsigned);
  L.start_off = off;
  if (pairs) off += align16(((size_t)C + 1) * sizeof(int));
  L.start_rows = off;
  if (pairs) off += align16((size_t)n_start * sizeof(int2));
  L.edges = off;  // the CSR's offsets, or the slots
  if (csr) off += align16((size_t)C * (S + 2) * sizeof(uint16_t));
  if (edges == SLOTS_SHARED) off += align16((size_t)S * D * sizeof(unsigned));
  L.targets = off;
  if (csr) off += align16((size_t)E * sizeof(uint16_t));
  L.warp0 = off;
  size_t w = 0;
  L.bm = w;  // two alternating bitmaps: 32 words each, or W
  w += (small ? 64 : 2 * W) * sizeof(unsigned);
  L.list = w;  // their lists of non-zero words
  if (!small) w += 2 * W * sizeof(uint16_t);
  w = align16(w);
  L.num = w;  // three rotating list counts
  if (!small) w += 16;
  L.states = w;  // the active states of up to 32 words, spread over the lanes
  if (!small) w += 32 * 32 * sizeof(int);
  L.cnt = w;
  if (cnt_smem) w += (size_t)n_acc * sizeof(int);
  L.per_warp = align16(w);
  return L;
}

int device_attr(cudaDeviceAttr attr, int fallback) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return fallback;
  if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) return fallback;
  return v;
}

struct Plan {
  int edges;
  bool cnt_smem;
  int warps;  // 0: nothing fits
  size_t smem;
};

// The edges in shared memory first (every byte's chain reads them), then the
// counters; as many warps a CTA as spread B streams over the SMs, up to
// MAX_WARPS and what shared memory holds.
Plan plan(int C, int S, int E, int n_acc, int n_start, int D, int B) {
  const size_t limit = (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 48 * 1024);
  const int sms = device_attr(cudaDevAttrMultiProcessorCount, 1);
  int want = (B + sms - 1) / sms;
  want = want < 1 ? 1 : (want > MAX_WARPS ? MAX_WARPS : want);
  const bool narrow = E < 65536 && S < 65535;
  const bool slots = D > 0 && D <= WIDE && S < (1 << 24) - 1;
  const int order[3] = {CSR_SHARED, SLOTS_SHARED, CSR_GLOBAL};
  for (int edges : order) {
    if ((edges == CSR_SHARED && !narrow) || (edges == SLOTS_SHARED && !slots)) continue;
    for (int cnt = 1; cnt >= 0; --cnt) {
      const Layout L = layout(C, S, E, n_acc, n_start, D, edges, cnt);
      if (L.warp0 + L.per_warp > limit) continue;
      int warps = (int)((limit - L.warp0) / L.per_warp);
      warps = warps < want ? warps : want;
      return Plan{edges, cnt == 1, warps, L.warp0 + (size_t)warps * L.per_warp};
    }
  }
  return Plan{CSR_GLOBAL, false, 0, 0};
}

// The real states of bitmap word w (states >= S are inert).
__device__ __forceinline__ unsigned real_bits(int w, int S) {
  const int lo = w << 5;
  return S - lo >= 32 ? FULL : (S > lo ? (1u << (S - lo)) - 1u : 0u);
}

// What a warp reads the edges from: shared copies where the plan put them.
struct Tables {
  const uint16_t* off16;
  const uint16_t* tgt16;
  const unsigned* slots;
  const int* so;   // start pairs' offsets
  const int2* sr;  // start pairs
};

template <int EDGES>
__device__ __forceinline__ int2 row_of(int c, int s, const TpArgs& a, const Tables& tb) {
  if (EDGES == CSR_SHARED) {
    const uint16_t* o = tb.off16 + c * (a.S + 2) + s;
    return make_int2(o[0], o[1]);
  }
  const int* o = a.offsets + (long long)c * (a.S + 2) + s;
  return make_int2(__ldg(o), __ldg(o + 1));
}

template <int EDGES>
__device__ __forceinline__ int target_of(int k, const TpArgs& a, const Tables& tb) {
  return EDGES == CSR_SHARED ? (int)tb.tgt16[k] : __ldg(a.targets + k);
}

template <int EDGES>
__device__ __forceinline__ int start_at(int c, const TpArgs& a, const Tables& tb) {
  return EDGES != CSR_GLOBAL ? tb.so[c] : __ldg(a.start_off + c);
}

template <int EDGES>
__device__ __forceinline__ int2 start_pair(int k, const TpArgs& a, const Tables& tb) {
  return EDGES != CSR_GLOBAL ? tb.sr[k] : __ldg(a.start_rows + k);
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

// set(t) for every successor t of state s on class c; returns true instead
// when the row is wide (longer than WIDE), for the warp to walk.
template <int EDGES, class Set>
__device__ __forceinline__ bool scatter(int c, int s, const TpArgs& a, const Tables& tb,
                                        Set set) {
  if (EDGES == SLOTS_SHARED) {
    const unsigned* e = tb.slots + s * a.D;
#pragma unroll 1
    for (int d = 0; d < a.D; ++d) {
      const unsigned x = e[d];
      if (x == NO_EDGE) break;
      if ((int)(x >> 24) == c) set((int)(x & 0xffffffu));
    }
    return false;
  }
  const int2 r = row_of<EDGES>(c, s, a, tb);
  if (r.y - r.x > WIDE) return true;
#pragma unroll 1
  for (int k = r.x; k < r.y; ++k) set(target_of<EDGES>(k, a, tb));
  return false;
}

// The warp sets the successors of state s on class c together, a lane an
// edge.
template <int EDGES, class Set>
__device__ __forceinline__ void walk(int c, int s, int lane, const TpArgs& a, const Tables& tb,
                                     Set set) {
  const int2 r = row_of<EDGES>(c, s, a, tb);
  for (int k = r.x + lane; k < r.y; k += WARP) set(target_of<EDGES>(k, a, tb));
}

// Listed route: set `mask` in word w of the next bitmap; the lane that makes
// the word non-zero appends it to the next list. The start state's bit goes
// to the list count's top bit instead.
__device__ __forceinline__ void set_listed(int w, unsigned mask, unsigned* bm, uint16_t* list,
                                           unsigned* num) {
  if (w == 0) {
    if (mask & 1u) atomicOr(num, START_ON);
    mask &= ~1u;
  }
  if (mask && atomicOr(bm + w, mask) == 0u) list[atomicAdd(num, 1u) & COUNT] = (uint16_t)w;
}

template <int EDGES, bool CNT_SMEM, bool SMALL>
__global__ void __launch_bounds__(MAX_WARPS* WARP) nfa_tp_kernel(TpArgs a, int warps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, C = a.C;
  const int Ws = words_of(S);
  const Layout L = layout(C, S, a.E, a.n_acc, a.n_start, a.D, EDGES, CNT_SMEM);
  uint8_t* lut = smem;
  unsigned* accw = reinterpret_cast<unsigned*>(smem + L.accw);
  int* accpre = reinterpret_cast<int*>(smem + L.accpre);
  unsigned* start_words = reinterpret_cast<unsigned*>(smem + L.start_words);
  int* so16 = reinterpret_cast<int*>(smem + L.start_off);
  int2* sr16 = reinterpret_cast<int2*>(smem + L.start_rows);
  uint16_t* off16 = reinterpret_cast<uint16_t*>(smem + L.edges);
  unsigned* slots = reinterpret_cast<unsigned*>(smem + L.edges);
  uint16_t* tgt16 = reinterpret_cast<uint16_t*>(smem + L.targets);
  const Tables tb = {off16, tgt16, slots, so16, sr16};
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / WARP, lane = tid % WARP;

  // what the CTA's warps share: class map, accept bits, edges, start pairs
  for (int i = tid; i < 256; i += nthr) lut[i] = (uint8_t)a.class_of[i];
  for (int i = warp; i < Ws; i += warps) {
    const int s = i * 32 + lane;
    const unsigned bits = __ballot_sync(FULL, s < S && a.accept[s]);
    if (lane == 0) accw[i] = bits;
  }
  if (EDGES == CSR_SHARED) {
    const int n_off = C * (S + 2);
#pragma unroll 8
    for (int i = tid; i < n_off; i += nthr) off16[i] = (uint16_t)__ldg(a.offsets + i);
#pragma unroll 8
    for (int i = tid; i < a.E; i += nthr) tgt16[i] = (uint16_t)__ldg(a.targets + i);
  }
  if (EDGES == SLOTS_SHARED) {
    const int n_slots = S * a.D;
#pragma unroll 8
    for (int i = tid; i < n_slots; i += nthr) slots[i] = __ldg(a.slots + i);
  }
  if (SMALL) {  // the start state's successors as 32 words a class, a thread a class
    for (int c = tid; c < C; c += nthr) {
      unsigned* row = start_words + c * 32;
      for (int w = 0; w < 32; ++w) row[w] = 0u;
      const int so = a.start_off[c];
      for (int k = so & START_AT; k < (a.start_off[c + 1] & START_AT); ++k) {
        const int2 e = a.start_rows[k];
        row[e.x] = (unsigned)e.y;
      }
      if (so & START_LOOPS) row[0] |= 1u;  // the self-loop
    }
  } else if (EDGES != CSR_GLOBAL) {
    for (int i = tid; i <= C; i += nthr) so16[i] = a.start_off[i];
    for (int i = tid; i < a.n_start; i += nthr) sr16[i] = a.start_rows[i];
  }
  __syncthreads();
  if (CNT_SMEM && warp == 0) {  // each word's first counter: a prefix sum of popcounts
    int run = 0;
    for (int base = 0; base < Ws; base += WARP) {
      const int w = base + lane;
      const int v = w < Ws ? __popc(accw[w]) : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < WARP; d <<= 1) {
        const int u = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += u;
      }
      if (w < Ws) accpre[w] = run + incl - v;
      run += __shfl_sync(FULL, incl, WARP - 1);
    }
  }
  __syncthreads();  // the last CTA-wide barrier; each warp runs alone from here

  const long long n = (long long)blockIdx.x * warps + warp;
  if (n >= a.B) return;
  unsigned char* ws = smem + L.warp0 + (size_t)warp * L.per_warp;
  unsigned* bm = reinterpret_cast<unsigned*>(ws + L.bm);
  unsigned* row_bm = a.bitmap + n * a.W;
  int* out_cnt = a.counts + n * a.N;
  int* cnt = CNT_SMEM ? reinterpret_cast<int*>(ws + L.cnt) : out_cnt;
  if (CNT_SMEM)
    for (int i = lane; i < a.n_acc; i += WARP) cnt[i] = 0;
  const uint8_t* data = a.streams + n * a.L;
  const long long len = a.L;
  const bool warp_walks = EDGES != SLOTS_SHARED && a.wide;

  if (SMALL) {
    // W <= 32: lane l holds word l of the active set (states 32l..32l+31)
    const bool owns = lane < Ws;
    const unsigned acc = owns ? accw[lane] : 0u;
    const int acc_base = CNT_SMEM && owns ? accpre[lane] : 0;
    unsigned* const set0 = bm;
    unsigned* const set1 = bm + 32;
    set0[lane] = 0u;
    set1[lane] = 0u;
    unsigned cur = owns ? row_bm[lane] & real_bits(lane, S) : 0u;
    const unsigned own_mask = lane == 0 ? ~1u : FULL;  // the start state is the warp's
    __syncwarp();
    int buf = 0;
    int byte = lane < len ? data[lane] : 0;
    for (long long p0 = 0; p0 < len; p0 += WARP) {
      const int mycls = lut[byte];
      const int m = (int)(len - p0 < WARP ? len - p0 : WARP);
      if (p0 + WARP + lane < len) byte = data[p0 + WARP + lane];  // in flight meanwhile
      for (int j = 0; j < m; ++j) {
        const int c = __shfl_sync(FULL, mycls, j);
        const unsigned from_start = start_words[c * 32 + lane];  // off the chain
        const bool start_on = __shfl_sync(FULL, cur, 0) & 1u;
        unsigned* const nxt = buf ? set1 : set0;
        const auto set = [nxt](int t) { atomicOr(nxt + (t >> 5), 1u << (t & 31)); };
        // the lane's own states but the start state; wide rows wait for the warp
        unsigned wide = 0u;
        for (unsigned x = cur & own_mask; x; x &= x - 1u) {
          const int bit = __ffs(x) - 1;
          if (scatter<EDGES>(c, (lane << 5) + bit, a, tb, set)) wide |= 1u << bit;
        }
        if (warp_walks) {
          for (unsigned v = __ballot_sync(FULL, wide != 0u); v;
               v = __ballot_sync(FULL, wide != 0u)) {
            const int src = __ffs(v) - 1;
            const unsigned bits = __shfl_sync(FULL, wide, src);
            walk<EDGES>(c, (src << 5) + __ffs(bits) - 1, lane, a, tb, set);
            if (lane == src) wide &= wide - 1u;
          }
        }
        // the set before the byte counts; the lane's word is its own
        for (unsigned h = cur & acc; h; h &= h - 1u) {
          const int bit = __ffs(h) - 1;
          if (CNT_SMEM)
            cnt[acc_base + __popc(acc & ((1u << bit) - 1u))] += 1;
          else
            cnt[(lane << 5) + bit] += 1;
        }
        __syncwarp();
        const unsigned got = nxt[lane];  // words >= W are never set
        if (got) nxt[lane] = 0u;  // free for the byte after next
        // the start state's successors are the lane's own word of its pairs
        cur = start_on ? got | from_start : got;
        buf ^= 1;
      }
    }
    if (len > 0) {  // an empty stream keeps its bitmap as given
      for (int w = lane; w < a.W; w += WARP) row_bm[w] = w == lane ? cur : 0u;
    }
  } else {
    // W > 32: per-warp bitmaps in shared memory. A bitmap's non-zero words
    // are the words of the previous byte's start pairs (when the start state
    // was active; the lanes hold them) and the words of its list; a word in
    // both is read once, by atomicExch. The start state's bit is the top bit
    // of a list count.
    unsigned* const bmA = bm;
    unsigned* const bmB = bm + Ws;
    uint16_t* const listA = reinterpret_cast<uint16_t*>(ws + L.list);
    uint16_t* const listB = listA + Ws;
    unsigned* const num = reinterpret_cast<unsigned*>(ws + L.num);
    int* const sl = reinterpret_cast<int*>(ws + L.states);
    const unsigned lanes_below = (1u << lane) - 1u;
    for (int i = lane; i < 2 * Ws; i += WARP) bm[i] = 0u;
    if (lane < 3) num[lane] = 0u;
    __syncwarp();
    for (int w = lane; w < Ws; w += WARP) set_listed(w, row_bm[w] & real_bits(w, S), bmA, listA, num);
    __syncwarp();
    const bool acc0 = accw[0] & 1u;
    int q = 0, buf = 0;  // the byte's index mod 3 and mod 2
    int prev_so = 0, prev_ns = 0, prev_w = 0;  // the previous byte's start pairs
    int prev_c = 0, prev_flags = 0;
    bool looped = false;  // the start state looped to itself on the previous byte
    // two-step route: the start state's successors never enter the bitmap;
    // the byte after takes their counts and their own successors from the
    // pairs and the two-step table (no other state reaches them)
    const bool two_step = a.two_off != nullptr;
    int byte = lane < len ? data[lane] : 0;
    for (long long p0 = 0; p0 < len; p0 += WARP) {
      const int mycls = lut[byte];
      const int my_so = start_at<EDGES>(mycls, a, tb);  // with the flags
      const int my_ns = (start_at<EDGES>(mycls + 1, a, tb) & START_AT) - (my_so & START_AT);
      const int m = (int)(len - p0 < WARP ? len - p0 : WARP);
      if (p0 + WARP + lane < len) byte = data[p0 + WARP + lane];  // in flight meanwhile
      for (int j = 0; j < m; ++j) {
        const int c = __shfl_sync(FULL, mycls, j);
        const int so_loop = __shfl_sync(FULL, my_so, j);
        const int so = so_loop & START_AT;
        const int ns = __shfl_sync(FULL, my_ns, j);
        const int2 e = !two_step && lane < ns ? start_pair<EDGES>(so + lane, a, tb)
                                               : make_int2(0, 0);
        unsigned* const cur_bm = buf ? bmB : bmA;
        unsigned* const nxt_bm = buf ? bmA : bmB;
        const uint16_t* const cur_list = buf ? listB : listA;
        uint16_t* const nxt_list = buf ? listA : listB;
        // byte t reads count t % 3, appends to (t+1) % 3 and clears (t+2) % 3,
        // whose readers (byte t-1) all passed byte t-1's __syncwarp
        const int q1 = q == 2 ? 0 : q + 1;
        const int q2 = q1 == 2 ? 0 : q1 + 1;
        unsigned* const num_n = num + q1;
        const auto set = [nxt_bm, nxt_list, num_n](int t) {
          set_listed(t >> 5, 1u << (t & 31), nxt_bm, nxt_list, num_n);
        };
        const unsigned v = num[q];
        const bool start_on = looped || (v & START_ON);
        if (start_on && lane == 0 && acc0) cnt[0] += 1;  // state 0's counter is the first
        if (two_step) {
          if (prev_ns > 0) {  // the previous byte's start successors are active
            if (prev_flags & START_ACCEPTS) {
              for (int k = prev_so + lane; k < prev_so + prev_ns; k += WARP) {
                const int2 f = start_pair<EDGES>(k, a, tb);
                const unsigned acc = accw[f.x];
                for (unsigned h = (unsigned)f.y & acc; h; h &= h - 1u) {
                  const int bit = __ffs(h) - 1;
                  if (CNT_SMEM)
                    cnt[accpre[f.x] + __popc(acc & ((1u << bit) - 1u))] += 1;
                  else
                    cnt[(f.x << 5) + bit] += 1;
                }
              }
            }
            const int* to = a.two_off + prev_c * C + c;
            const int t1 = __ldg(to + 1);
            for (int k = __ldg(to) + lane; k < t1; k += WARP) {
              const int2 f = __ldg(a.two_rows + k);
              set_listed(f.x, (unsigned)f.y, nxt_bm, nxt_list, num_n);
            }
          }
        } else if (start_on) {  // the start state's successors, a word a lane, no list
          if (e.y) atomicOr(nxt_bm + e.x, (unsigned)e.y);
          for (int k = so + WARP + lane; k < so + ns; k += WARP) {
            const int2 f = start_pair<EDGES>(k, a, tb);
            atomicOr(nxt_bm + f.x, (unsigned)f.y);
          }
        }
        const auto visit = [&](int st) {  // state st's successors, or none for -1
          const bool wide = st >= 0 && scatter<EDGES>(c, st, a, tb, set);
          if (warp_walks) {  // the warp walks each wide row, a lane an edge
            for (unsigned u = __ballot_sync(FULL, wide); u; u &= u - 1u)
              walk<EDGES>(c, __shfl_sync(FULL, st, __ffs(u) - 1), lane, a, tb, set);
          }
        };
        const int n_pairs = two_step ? 0 : prev_ns;
        const int n_words = n_pairs + (int)(v & COUNT);
        for (int base = 0; base < n_words; base += WARP) {  // a word a lane
          const int i = base + lane;
          int w = -1;
          if (i < n_pairs)
            w = i < WARP ? prev_w : start_pair<EDGES>(prev_so + i, a, tb).x;
          else if (i < n_words)
            w = cur_list[i - n_pairs];
          const unsigned x = w >= 0 ? atomicExch(cur_bm + w, 0u) : 0u;
          if (x) {  // the set before the byte counts
            const unsigned acc = accw[w];
            if (unsigned h = x & acc) {
              int* cw = CNT_SMEM ? cnt + accpre[w] : cnt + (w << 5);
              for (; h; h &= h - 1u) {
                const int bit = __ffs(h) - 1;
                cw[CNT_SMEM ? __popc(acc & ((1u << bit) - 1u)) : bit] += 1;
              }
            }
          }
          if (__any_sync(FULL, x & (x - 1u))) {
            // a word holds several active states (the start state's
            // successors are often neighbours): spread them over the lanes
            int n_states;
            int at = sum_below(__popc(x), lanes_below, &n_states);
            for (unsigned y = x; y; y &= y - 1u) sl[at++] = (w << 5) + __ffs(y) - 1;
            __syncwarp();
            for (int k0 = 0; k0 < n_states; k0 += WARP)
              visit(k0 + lane < n_states ? sl[k0 + lane] : -1);
            __syncwarp();  // the round's states are read
          } else {
            visit(x ? (w << 5) + __ffs(x) - 1 : -1);
          }
        }
        if (lane == 0) num[q2] = 0u;
        __syncwarp();
        prev_ns = start_on ? ns : 0;
        prev_so = so;
        prev_w = e.x;
        prev_c = c;
        prev_flags = so_loop;
        looped = start_on && so_loop < 0;
        q = q1;
        buf ^= 1;
      }
    }
    if (len > 0) {
      unsigned* cur_bm = buf ? bmB : bmA;
      if (two_step) {  // the last byte's start successors join the bitmap
        for (int k = prev_so + lane; k < prev_so + prev_ns; k += WARP) {
          const int2 f = start_pair<EDGES>(k, a, tb);
          atomicOr(cur_bm + f.x, (unsigned)f.y);
        }
        __syncwarp();
      }
      const unsigned start = looped || (num[q] & START_ON) ? 1u : 0u;
      for (int w = lane; w < a.W; w += WARP)
        row_bm[w] = w < Ws ? cur_bm[w] | (w == 0 ? start : 0u) : 0u;
    }
  }
  if (CNT_SMEM) {
    __syncwarp();
    for (int w = lane; w < Ws; w += WARP) {
      int i = accpre[w];
      for (unsigned h = accw[w]; h; h &= h - 1u) {
        const int v = cnt[i++];
        if (v) out_cnt[(w << 5) + __ffs(h) - 1] += v;  // the row is this warp's alone
      }
    }
  }
}

template <int EDGES, bool CNT_SMEM>
int launch(const TpArgs& a, const Plan& p, cudaStream_t st) {
  auto kernel = words_of(a.S) <= 32 ? nfa_tp_kernel<EDGES, CNT_SMEM, true>
                                    : nfa_tp_kernel<EDGES, CNT_SMEM, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (a.B + p.warps - 1) / p.warps;
  kernel<<<grid, p.warps * WARP, p.smem, st>>>(a, p.warps);
  return (int)cudaGetLastError();
}

template <int EDGES>
int launch_edges(const TpArgs& a, const Plan& p, cudaStream_t st) {
  return p.cnt_smem ? launch<EDGES, true>(a, p, st) : launch<EDGES, false>(a, p, st);
}

}  // namespace

// streams (B, L) uint8 contiguous; class_of (256,) int32; offsets (C, S+2)
// and targets (E,) int32 (targets < S); accept (S+1,) uint8; n_acc the
// accepting states below S; start_off (C+1,) int32 and start_rows (n_start,
// 2) int32: the start state's successors on class c but itself as (word,
// mask) pairs start_rows[start_off[c] .. start_off[c+1]), one pair a word,
// bit 31 of start_off[c] set when the start state loops to itself on c and
// bit 30 when one of the successors accepts; two_off (C*C+1,) and two_rows
// int32, or null: the successors on c2 of those on c1, as pairs
// two_rows[two_off[c1 * C + c2] ..), when no other state reaches a start
// successor (then a listed route keeps them out of its bitmap); slots (S, D)
// uint32: each state's edges over all classes, class << 24 | target, then
// 0xffffffff (the start state's slots empty), or D = 0 without them;
// max_row the longest row of any state but the start state; bitmap (B, W)
// uint32 words in/out, W = ceil(N / 32); counts (B, N) int32 in/out,
// N >= S + 1. Returns the CUDA error code (0 on success);
// cudaErrorInvalidValue when one stream's bitmaps exceed shared memory.
extern "C" int nfa_tp_scan(const uint8_t* streams, long long L, int B, const int* class_of,
                           const int* offsets, const int* targets, const uint8_t* accept,
                           int C, int S, int E, int n_acc, const int* start_off,
                           const int* start_rows, int n_start, const int* two_off,
                           const int* two_rows, const unsigned* slots, int D, int max_row,
                           unsigned* bitmap, int* counts, int N, void* stream) {
  if (B < 0 || L < 0 || S < 0 || C < 0 || E < 0 || n_acc < 0 || n_start < 0 || D < 0 ||
      N < S + 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(C, S, E, n_acc, n_start, D, B);
  if (p.warps == 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  TpArgs a = {streams, L, B, class_of, offsets, targets, accept, C, S, E, n_acc,
              start_off, reinterpret_cast<const int2*>(start_rows), n_start, two_off,
              reinterpret_cast<const int2*>(two_rows), slots, D,
              max_row > WIDE ? 1 : 0, bitmap, counts, N, (N + 31) / 32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.edges == CSR_SHARED) return launch_edges<CSR_SHARED>(a, p, st);
  if (p.edges == SLOTS_SHARED) return launch_edges<SLOTS_SHARED>(a, p, st);
  return launch_edges<CSR_GLOBAL>(a, p, st);
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
  uint8_t* flags;          // three (B, s_pad) buffers, buffer k at flags + k * stride
  long long stride;        // a multiple of 16
  int* counts;             // (B, n) in/out
};

__global__ void __launch_bounds__(STEP_THREADS) nfa_tp_step_kernel(StepArgs a) {
  const long long b = blockIdx.y;
  const int r = (int)(a.t % 3);
  const uint8_t* act = a.flags + r * a.stride + b * a.s_pad + a.lo;
  uint8_t* out = a.flags + (r == 2 ? 0 : r + 1) * a.stride + b * a.s_pad;
  // the buffer launch t+1 writes into: launch t-1 read it, stream order has
  // finished that
  uint4* clear = reinterpret_cast<uint4*>(a.flags + (r == 0 ? 2 : r - 1) * a.stride);
  const long long cta = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const long long all = (long long)gridDim.x * gridDim.y * STEP_THREADS;
  for (long long k = cta * STEP_THREADS + threadIdx.x; k < a.stride / 16; k += all)
    clear[k] = make_uint4(0u, 0u, 0u, 0u);
  const int i = blockIdx.x * STEP_THREADS + threadIdx.x;  // local state
  const int lane = threadIdx.x & 31;
  const int s = a.lo + i;
  // states >= S (the sentinel, padding) are inert: cleared, never counted
  const bool on = i < a.n && s < a.S && act[i] != 0;
  if (on && a.accept[s]) a.counts[b * a.n + i] += 1;
  const int c = __ldg(a.class_of + a.streams[b * a.L + a.t]);
  const int* off = a.offsets + (long long)c * (a.S + 2);
  for (unsigned m = __ballot_sync(FULL, on); m; m &= m - 1u) {
    const int src = s - lane + __ffs(m) - 1;
    const int lo = __ldg(off + src), hi = __ldg(off + src + 1);
    for (int k = lo + lane; k < hi; k += 32) out[__ldg(a.targets + k)] = 1;
  }
}

}  // namespace

// One byte of the sharded scan (tp_scan.py's step on one rank of the model
// axis): streams (B, L) uint8 contiguous, t the byte; class_of (256,),
// offsets (C, S+2) and targets (E,) int32 (targets < S); accept (S+1,)
// uint8; the rank's states are lo..lo+n-1 of s_pad; flags: three (B, s_pad)
// uint8 buffers at flags + k * stride (16-byte aligned, stride a multiple
// of 16 and >= B * s_pad): reads buffer t % 3 (> 0 = active), writes a 1 at
// every successor of an active state into buffer (t+1) % 3 (clear before
// the launch) and clears buffer (t+2) % 3, its padding included; counts
// (B, n) int32 in/out. Returns the CUDA error code (0 on success).
extern "C" int nfa_tp_step(const uint8_t* streams, long long L, long long t, int B,
                           const int* class_of, const int* offsets, const int* targets,
                           const uint8_t* accept, int S, int lo, int n, int s_pad,
                           uint8_t* flags, long long stride, int* counts, void* stream) {
  if (B < 0 || B > 65535 || t < 0 || t >= L || S < 0 || lo < 0 || n < 0 || lo + n > s_pad ||
      s_pad < S + 1 || stride % 16 || stride < (long long)B * s_pad ||
      reinterpret_cast<uintptr_t>(flags) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  StepArgs a = {streams, L, t, class_of, offsets, targets, accept, S, lo, n, s_pad,
                flags, stride, counts};
  const int blocks = n > 0 ? (n + STEP_THREADS - 1) / STEP_THREADS : 1;
  nfa_tp_step_kernel<<<dim3(blocks, B), STEP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Where a launch over B streams keeps its data: bits 0-1 = the edges (0 the
// per-class CSR in global memory, 1 the CSR narrowed to uint16 in shared
// memory with the start pairs, 2 the edge slots in shared memory), bit 2 =
// counters in shared memory, bit 3 = listed bitmaps (W > 32 words; else a
// word a lane in registers), bits 8 and up = streams (warps) per CTA; -1
// when one stream's bitmaps do not fit.
extern "C" int nfa_tp_route(int C, int S, int E, int n_acc, int n_start, int D, int B) {
  const Plan p = plan(C, S, E, n_acc, n_start, D, B);
  if (p.warps == 0) return -1;
  return p.edges | (p.cnt_smem ? 4 : 0) | (words_of(S) > 32 ? 8 : 0) | (p.warps << 8);
}
