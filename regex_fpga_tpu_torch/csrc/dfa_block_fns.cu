// K6, the exact DFA fallback on Hopper (sm_90a): pass 1, the transition
// function of every block (dfa_block_fns), and the combine that turns the
// block functions into every block's entry state (dfa_fn_combine).
//
// Replaces the XLA region regex_fpga_tpu/ops/dfa_engine.py::
// block_transition_functions (lax.scan over the block's bytes, all S start
// states as one vector) and ::block_entry_states (associative_scan of the
// composed functions), which the JAX package never wrote in Pallas.
//
// ---------------------------------------------------------------- pass 1
//
// What it computes: for block n of the (NB, B) class ids and every start
// state s, f[n, s] = the state after the block's B bytes when it is entered
// in s. A class outside [0, C) steps to state 0, as in dfa_chain.cu; the
// wrapper has checked that every table entry lies in [0, S).
//
// What bounds it: walked naively it is NB * S chains of B dependent table
// loads (56e9 loads for a 64 MiB chunk at S = 836), far more than the bytes
// (the class ids once, the functions once) or any arithmetic rate. But a DFA
// is deterministic: two chains in the same state at the same byte stay equal
// to the end of the block. On an Aho-Corasick automaton every chain meets
// every other within the longest keyword, on random bytes within a few
// bytes, and then one chain carries the block. What is left is one chain of
// B dependent loads a block, and the loads of the chains before they meet.
//
// Two routes (plan()):
//
//   - S <= 32, a block a thread. A thread carries all S chains of one block
//     in registers (CH of them, S rounded up to a few sizes), 128 blocks a
//     CTA, so at S = 2 a CTA walks 128 blocks and the card tens of thousands
//     at once, every lane busy. The class ids stream through the ring of
//     windows that K1 uses (chain_common.cuh, cp.async, a thread copies its
//     own row, so no barrier between windows), one class load a byte serves
//     the S chains, and the table is uint32 in shared memory (at most 33 KB
//     for S <= 32). The chains of a thread are not merged: registers cannot
//     be compacted, so a merged chain would cost its load all the same.
//     (A function packed in nibbles, one table load and S extractions a
//     byte, is the other way to carry a block in a thread; untried.)
//
//   - S > 32, a block a warp, chains that meet merge. The warp takes a
//     block's start states, chains i = lane + 32 u, up to 32 a lane (a pass
//     of 1,024 start states; larger S takes several passes). All lanes read
//     the same class id, one broadcast load a byte, from a ring of windows
//     of the block's row (cp.async, 256 bytes a window). After 8 bytes and
//     again after 16, 32, ... the live chains deduplicate on their state:
//     each writes its index into owner[state] (S slots a warp in shared
//     memory), __syncwarp, reads the slot back; a chain that finds another
//     chain's index there records that chain's name as its leader in rec[]
//     and stops. The slots need no clearing and no check-number tag: a chain
//     only ever reads the slot it has itself written in the same check, so
//     what it reads was written in that check by a chain in the same state.
//     The survivors are compacted onto the first lanes (a ballot and a
//     popcount per row of chains), and the walk goes on with ceil(L / 32)
//     chains a lane. At the end of the block the survivors write their
//     final state into rec[], and every start state follows its leaders
//     (at most one hop a check) and stores the result: out[n, p0 + s] for s
//     = lane, lane + 32, ..., so the stores are coalesced.
//
//     Freed lanes: the survivors of several blocks pack into one warp. A
//     warp takes a team of 32 blocks and walks each one's start states
//     alone up to the first check (8 bytes); a block left with at most 4
//     chains joins the pack (each start state's survivor goes to 2 bits of
//     the block's map, or none is kept when one chain is left), and the
//     others walk on alone with their checks. Then lane g carries the
//     chains of the team's block g to the end of the block, its class ids
//     streamed by its own cp.async ring, so that a warp walks 32 blocks'
//     chains a byte instead of one; the final states go out through the
//     maps, coalesced. Taking the next block into the freed lanes instead
//     leaves a warp's byte one dependent load of one chain: on an H100, the
//     Aho-Corasick automaton (36, 836) over 64 MiB took 1.40 ms that way
//     against 0.87 ms packed at 16 bytes (PERF.md section 6).
//
//     Checks at growing intervals cost about log2(B) rounds of two shared
//     loads a chain where nothing merges (a permutation automaton). The
//     owner, name and rec tables need S * 2 + 8 * min(S, 1,024) bytes a
//     warp, and packing (S <= 1,024) the team's maps and states 2 KB more
//     and S / 4 bytes a block; where the tables do not fit beside the table
//     the route walks without checks. The table is uint16 in shared memory where S < 65,536 and it
//     fits, else it is read from global memory through the read-only cache.
//
// ---------------------------------------------------------------- combine
//
// What it computes: entry[n], the state in which block n is entered when
// the stream starts in `start`, and the state after the last block: an
// exclusive scan of function composition, but of one start value. Bound:
// reading the functions once (NB * S * 4 bytes).
//
// Design: one cooperative launch, one CTA an SM at most, 16 warps a CTA, a
// grid barrier in the middle. The blocks are cut into U units of R
// consecutive functions, one unit a warp. Each warp composes its unit from
// the identity (the lanes carry the start states, 32 a lane a pass; a step
// is one gather f[n, h] per start), so every function is read about once;
// each CTA then composes its 16 units into one aggregate. After the
// barrier each CTA finds its own entry from the aggregates of the CTAs
// before it (one scalar lookup each, from the last constant aggregate on:
// after pass 1 merges, a block function is mostly constant, and a constant
// function sets its successor's entry whatever came before), its units'
// entries from its unit aggregates, and each warp walks its R functions
// from its unit's entry, one scalar lookup a block. The longest chain of
// dependent loads is about R + 16 + (CTAs) lookups instead of log2(NB)
// passes over all of the functions. Contract (hopper_dfa.dfa_fn_combine):
// every entry of the functions and the start lie in [0, S). Pass 1 never
// writes another; dfa_engine.block_entry_states checks functions built
// elsewhere before it launches this, on the card as on the CPU. The kernel
// does not check (it reads such an entry as state 0).
#include "chain_common.cuh"

namespace {

using chain::align16;
using chain::cp_async16;
using chain::cp_async_commit;
using chain::cp_async_wait;

enum Table { GLOBAL = 0, SMEM32 = 1, SMEM16 = 2 };
enum Kind { BLOCK_A_THREAD = 0, BLOCK_A_WARP = 1 };

constexpr int THREAD_MAX_STATES = 32;
constexpr int THREAD_CTAS_PER_SM = 8;  // 128 threads, at most 64 registers a thread
constexpr int MAX_CHAINS = 32;         // chains a lane on the warp route
constexpr int PASS = 32 * MAX_CHAINS;  // start states a pass of the warp route walks
constexpr int FIRST_CHECK = 8;         // bytes before the first merge check
constexpr int WWIN = 256;              // class ids a warp window
constexpr int WBUF = WWIN + 16;        // its buffer: the 16-byte chunks that cover it
constexpr int WRING = 4;               // windows a warp keeps in flight
constexpr int MAX_WARPS = 16;          // warps (blocks at once) a CTA on the warp route
constexpr int MIN_MERGE_WARPS = 4;     // fewer and the route walks without checks
constexpr unsigned FINAL = 0x80000000u;  // rec[]: a final state, not a leader's name
constexpr int PACK_AT = 8;      // bytes a block walks alone before its survivors may pack
constexpr int PACK_CHAINS = 4;  // survivors a block may take into a pack
constexpr int TEAM = 32;        // blocks a warp packs, one a lane
constexpr int PWIN = 32;        // class ids a lane's window in the packed walk
constexpr int PBUF = 48;        // its buffer: the 16-byte chunks that cover it
constexpr int PRING = 4;        // windows a lane keeps in flight

// The chains a thread carries on the block-a-thread route: S rounded up.
__host__ __device__ inline int thread_chains(int S) {
  if (S <= 8) return S;
  if (S <= 12) return 12;
  if (S <= 16) return 16;
  if (S <= 24) return 24;
  return 32;
}

// The register bucket that holds k chains a lane on the warp route.
__host__ __device__ inline int warp_bucket(int k) {
  if (k <= 4) return k;
  if (k <= 8) return (k + 1) & ~1;
  return (k + 3) & ~3;
}

// Merge checks in a block of B bytes: after 8, 16, 32, ... bytes, while
// bytes remain.
__host__ __device__ inline int merge_checks(int B) {
  int n = 0;
  for (long long t = FIRST_CHECK; t < B; t *= 2) ++n;
  return n;
}

struct Plan {
  int kind, table, merge, pack, chains, checks, warps, threads, ring, grid;
  size_t smem;
};

// Bytes of a packed block's map: 2 bits a start state (the survivor it
// follows), rounded up to whole words.
__host__ __device__ inline int map_bytes(int np) { return ((np + 3) / 4 + 3) & ~3; }

// Shared memory of the warp route: the table at offset 0, then from warp0
// on, per warp: its ring of windows and, with merging, owner (S uint16) and
// the list and rec (np uint32 each); with packing, the lanes' rings of the
// packed walk over the same bytes, then the team's maps, its survivors'
// states (PACK_CHAINS uint32 a block) and its blocks (TEAM int32). owner ...
// blocks are offsets within the warp's part.
struct WarpLayout {
  size_t warp0, per_warp, owner, list, rec, map, pst, blocks;
};

__host__ __device__ inline WarpLayout warp_layout(int C, int S, int table, bool merge,
                                                  bool pack) {
  WarpLayout L;
  const int np = S < PASS ? S : PASS;
  L.warp0 = table == SMEM16
                ? align16(sizeof(uint16_t) * ((size_t)C + 1) * chain::row_entries(S, 2))
                : 0;
  L.owner = (size_t)WRING * WBUF;
  L.list = L.owner + (merge ? align16(sizeof(uint16_t) * (size_t)S) : 0);
  L.rec = L.list + (merge ? align16(sizeof(uint32_t) * (size_t)np) : 0);
  L.map = L.rec + (merge ? align16(sizeof(uint32_t) * (size_t)np) : 0);
  if (pack && L.map < (size_t)TEAM * PRING * PBUF) L.map = (size_t)TEAM * PRING * PBUF;
  L.pst = L.map + (pack ? align16((size_t)TEAM * map_bytes(np)) : 0);
  L.blocks = L.pst + (pack ? sizeof(uint32_t) * TEAM * PACK_CHAINS : 0);
  L.per_warp = L.blocks + (pack ? sizeof(int) * TEAM : 0);
  return L;
}

Plan plan(int C, int S, int nb, int B) {
  Plan p = {};
  const chain::Residency res(THREAD_CTAS_PER_SM);
  if (S <= THREAD_MAX_STATES) {
    p.kind = BLOCK_A_THREAD;
    p.table = SMEM32;
    p.chains = thread_chains(S);
    p.checks = 0;
    p.warps = chain::LANES / 32;
    p.threads = chain::LANES;
    const size_t base = align16(sizeof(uint32_t) * ((size_t)C + 1) * S);
    p.ring = chain::ring_depth(res, base, chain::stage_bytes(1), nb);
    p.smem = base + (size_t)p.ring * chain::stage_bytes(1);
    p.grid = (nb + chain::LANES - 1) / chain::LANES;
    return p;
  }
  p.kind = BLOCK_A_WARP;
  const int np = S < PASS ? S : PASS;
  p.chains = (np + 31) / 32;
  const size_t room = res.limit > 1024 ? res.limit - 1024 : 0;  // 1 KB a CTA is the system's
  auto warps = [&](int table, bool merge, bool pack) {
    const WarpLayout L = warp_layout(C, S, table, merge, pack);
    if (L.warp0 + L.per_warp > room) return 0;
    const size_t n = (room - L.warp0) / L.per_warp;
    return (int)(n < (size_t)MAX_WARPS ? n : MAX_WARPS);
  };
  const bool narrow = S < 65536;
  const bool packable = S <= PASS && B > PACK_AT;
  struct Option { int table; bool merge, pack; int least; };
  const Option options[6] = {
      {SMEM16, true, true, MIN_MERGE_WARPS}, {SMEM16, true, false, MIN_MERGE_WARPS},
      {SMEM16, false, false, 1},             {GLOBAL, true, true, MIN_MERGE_WARPS},
      {GLOBAL, true, false, MIN_MERGE_WARPS}, {GLOBAL, false, false, 1}};
  p.table = GLOBAL, p.merge = 0, p.pack = 0, p.warps = 0;
  for (const Option& o : options) {
    if (o.table == SMEM16 && !narrow) continue;
    if (o.merge && !narrow) continue;  // names and states share a 32-bit entry
    if (o.pack && !packable) continue;
    const int w = warps(o.table, o.merge, o.pack);
    if (w >= o.least) {
      p.table = o.table, p.merge = o.merge, p.pack = o.pack, p.warps = w;
      break;
    }
  }
  p.checks = p.merge ? merge_checks(B) : 0;
  p.threads = 32 * (p.warps > 0 ? p.warps : 1);
  const WarpLayout L = warp_layout(C, S, p.table, p.merge, p.pack);
  p.smem = L.warp0 + (size_t)p.warps * L.per_warp;
  const int per_cta = p.warps * (p.pack ? TEAM : 1);  // blocks a CTA takes at a time
  p.grid = per_cta > 0 ? (nb + per_cta - 1) / per_cta : 0;
  return p;  // the launch caps the grid at what the card holds at once
}

// ------------------------------------------------------ block a thread (S <= 32)

struct ThreadArgs {
  chain::Source cls;  // (nb, B) uint8, steps contiguous
  const int* table;
  int C, S;
  int* out;
  int ring;
};

__device__ __forceinline__ void wait_ring(int ring) {  // window w of a ring of `ring`
  if (ring == 8)
    cp_async_wait<7>();
  else if (ring == 4)
    cp_async_wait<3>();
  else
    cp_async_wait<1>();
}

template <int CH>
__global__ void __launch_bounds__(chain::LANES, THREAD_CTAS_PER_SM)
    block_thread_kernel(ThreadArgs a) {
  constexpr int STAGE = chain::stage_bytes(1);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + (size_t)a.ring * STAGE);
  const int C = a.C, S = a.S, B = a.cls.steps;
  const int lane0 = blockIdx.x * chain::LANES;
  const int n = lane0 + threadIdx.x;
  const bool live = n < a.cls.nb;
  const int n_win = (B + chain::WIN - 1) / chain::WIN;
  auto steps_of = [&](int w) { return min(chain::WIN, B - w * chain::WIN); };

  const chain::Stager<1> stager(a.cls, lane0);
  for (int w = 0; w < a.ring; ++w) {
    if (w < n_win) stager.start(ring + w * STAGE, w, steps_of(w));
    cp_async_commit();
  }
  for (int k = threadIdx.x; k < C * S; k += chain::LANES) tab[k] = (uint32_t)__ldg(a.table + k);
  for (int s = threadIdx.x; s < S; s += chain::LANES) tab[C * S + s] = 0;
  __syncthreads();

  uint32_t st[CH];
#pragma unroll
  for (int u = 0; u < CH; ++u) st[u] = u < S ? u : 0;
  for (int w = 0; w < n_win; ++w) {
    wait_ring(a.ring);  // this thread's copies of window w have landed
    unsigned char* buf = ring + (w % a.ring) * STAGE;
    if (live) {
      const chain::WindowAddr wa = stager.addr(w);
      const int steps = steps_of(w);
      // the class ids two steps ahead, so that their loads are off the chain
      int c0 = chain::staged<uint8_t, true>(buf, wa, 0);
      int c1 = chain::staged<uint8_t, true>(buf, wa, min(1, steps - 1));
#pragma unroll 4
      for (int j = 0; j < steps; ++j) {
        const int c = c0;
        c0 = c1;
        c1 = chain::staged<uint8_t, true>(buf, wa, min(j + 2, steps - 1));
        const uint32_t* row = tab + min(c, C) * S;
#pragma unroll
        for (int u = 0; u < CH; ++u) st[u] = row[st[u]];
      }
    }
    if (w + a.ring < n_win) stager.start(buf, w + a.ring, steps_of(w + a.ring));
    cp_async_commit();
  }
  if (live) {
#pragma unroll
    for (int u = 0; u < CH; ++u)
      if (u < S) a.out[(size_t)n * S + u] = (int)st[u];
  }
}

// ------------------------------------------------------ block a warp (S > 32)

struct WarpArgs {
  const uint8_t* cls;  // (nb, B), rows contiguous
  const int* table;
  int C, S, nb, B;
  int* out;
  int merge, pack;
};

// One warp's walk through its block: the ring of windows over the row, the
// tables, and where the walk stands.
struct Walk {
  unsigned char* ring;
  uint16_t* owner;
  uint32_t* list;  // live chain i: name << 16 | state
  uint32_t* rec;   // by name: FINAL | state, or the leader's name
  uint8_t* map;    // packing: TEAM maps of map_bytes(S)
  uint32_t* pst;   // packing: PACK_CHAINS survivors' states a block of the team
  const uint8_t* row;
  int mis, n_win, lane;
  int w;           // the window the walk is in, or -1 before the first
};

// Start the copy of window w of the walk's row into its buffer (lanes copy
// the 16-byte chunks that cover it) and commit the group; past the last
// window, an empty group, so that the counts of groups stay in step.
__device__ __forceinline__ void warp_window(const Walk& k, int w, int B) {
  if (w < k.n_win) {
    const int len = min(WWIN, B - w * WWIN);
    const uint8_t* start = k.row + (size_t)w * WWIN - k.mis;
    if (k.lane * 16 < k.mis + len)
      cp_async16(k.ring + (w % WRING) * WBUF + k.lane * 16, start + k.lane * 16);
  }
  cp_async_commit();
}

// A staged class id, by its 32-bit shared address. volatile: it must stay
// after the wait for its window.
__device__ __forceinline__ unsigned staged_class(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// One byte of class c for chains st[0..K): on the shared route one add and
// one ld.shared.u16 a chain, by 32-bit shared addresses (tab_s: the table's),
// so that nothing else sits on the chain of dependent loads.
template <int K, int TABLE, int N>
__device__ __forceinline__ void step(uint32_t (&st)[N], int c, const WarpArgs& a,
                                     unsigned tab_s, int pitch) {
  if (TABLE == GLOBAL) {
    const bool ok = c < a.C;
    const int* row = a.table + (size_t)(ok ? c : 0) * a.S;
#pragma unroll
    for (int u = 0; u < K; ++u) st[u] = ok ? (uint32_t)__ldg(row + st[u]) : 0u;
  } else {
    const unsigned row = tab_s + (unsigned)(min(c, a.C) * pitch) * 2u;
#pragma unroll
    for (int u = 0; u < K; ++u) st[u] = chain::table_entry<uint16_t>(row + st[u] * 2u);
  }
}

// Step the live chains st[0..KB) from byte t0 to t1, entering windows as it
// goes: window w is waited for when the walk enters it, and the copy of
// window w - 1 + WRING starts in the buffer that window w - 1 leaves.
template <int KB, int TABLE>
__device__ __forceinline__ void walk(uint32_t (&st)[MAX_CHAINS], Walk& k, int t0, int t1,
                                     const WarpArgs& a, const uint16_t* tab, int pitch) {
  const unsigned tab_s = (unsigned)__cvta_generic_to_shared(tab);
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(k.ring);
  int t = t0;
  while (t < t1) {
    const int w = t / WWIN;
    if (w != k.w) {
      if (k.w >= 0) {
        __syncwarp();  // every lane has read window w - 1
        warp_window(k, k.w + WRING, a.B);
      }
      cp_async_wait<WRING - 1>();  // this lane's copies of window w have landed
      __syncwarp();                // and everyone's
      k.w = w;
    }
    const int n = min(t1, (w + 1) * WWIN) - t;
    const unsigned buf = ring_s + (w % WRING) * WBUF + k.mis + (t - w * WWIN);
    t += n;
    // the class ids two steps ahead, so that their loads are off the chain
    unsigned c0 = staged_class(buf), c1 = staged_class(buf + min(1, n - 1));
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int c = (int)c0;
      c0 = c1;
      c1 = staged_class(buf + min(j + 2, n - 1));
      step<KB, TABLE>(st, c, a, tab_s, pitch);
    }
  }
}

// One segment of the walk with KB chains a lane: take the live chains from
// the list (merging) or start them at p0 + i, walk them from t0 to t1, and
// put them back in the list, or store them (no merging: one segment).
template <int KB, int TABLE>
__device__ __forceinline__ void segment(Walk& k, int L, int p0, int t0, int t1, const WarpArgs& a,
                        const uint16_t* tab, int pitch, size_t out0) {
  uint32_t st[MAX_CHAINS];
#pragma unroll
  for (int u = 0; u < KB; ++u) {
    const int i = k.lane + 32 * u;
    st[u] = i < L ? (a.merge ? (k.list[i] & 0xFFFFu) : (uint32_t)(p0 + i)) : 0u;
  }
  walk<KB, TABLE>(st, k, t0, t1, a, tab, pitch);
#pragma unroll
  for (int u = 0; u < KB; ++u) {
    const int i = k.lane + 32 * u;
    if (i < L) {
      if (a.merge)
        k.list[i] = (k.list[i] & 0xFFFF0000u) | st[u];
      else
        a.out[out0 + p0 + i] = (int)st[u];
    }
  }
  __syncwarp();
}

template <int TABLE>
__device__ void run_segment(Walk& k, int L, int p0, int t0, int t1, const WarpArgs& a,
                            const uint16_t* tab, int pitch, size_t out0) {
  switch (warp_bucket((L + 31) / 32)) {
#define K6_SEGMENT(KB) \
  case KB:             \
    return segment<KB, TABLE>(k, L, p0, t0, t1, a, tab, pitch, out0);
    K6_SEGMENT(1) K6_SEGMENT(2) K6_SEGMENT(3) K6_SEGMENT(4) K6_SEGMENT(6) K6_SEGMENT(8)
    K6_SEGMENT(12) K6_SEGMENT(16) K6_SEGMENT(20) K6_SEGMENT(24) K6_SEGMENT(28)
    K6_SEGMENT(32)
#undef K6_SEGMENT
  }
}

// A merge check of the L live chains in the list: returns the survivors,
// compacted onto the first entries in their order; each chain that met
// another records that chain's name as its leader in rec[].
__device__ int merge_check(const Walk& k, int L) {
  const unsigned below = (1u << k.lane) - 1u;
  const int rows = (L + 31) / 32;
  uint32_t keep[MAX_CHAINS];  // the entries, in registers while the list is rewritten
#pragma unroll
  for (int r = 0; r < MAX_CHAINS; ++r) {
    const int i = k.lane + 32 * r;
    if (r < rows && i < L) {
      keep[r] = k.list[i];
      k.owner[keep[r] & 0xFFFFu] = (uint16_t)i;
    }
  }
  __syncwarp();
  // the slots first, with no warp vote between them, so that their loads
  // overlap; then the votes
  unsigned alive = 0;  // bit r: chain lane + 32 r survives
#pragma unroll
  for (int r = 0; r < MAX_CHAINS; ++r) {
    const int i = k.lane + 32 * r;
    if (r < rows && i < L) {
      const int lead = k.owner[keep[r] & 0xFFFFu];
      if (lead == i)
        alive |= 1u << r;
      else
        k.rec[keep[r] >> 16] = k.list[lead] >> 16;
    }
  }
  int n = 0;
#pragma unroll
  for (int r = 0; r < MAX_CHAINS; ++r)
    if (r < rows) n += __popc(__ballot_sync(0xFFFFFFFFu, (alive >> r) & 1u));
  if (n == L) return L;  // nothing met: the list stands
  __syncwarp();  // every lane has read the list
  int base = 0;
#pragma unroll
  for (int r = 0; r < MAX_CHAINS; ++r) {
    if (r < rows) {
      const bool lives = (alive >> r) & 1u;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, lives);
      if (lives) k.list[base + __popc(m & below)] = keep[r];
      base += __popc(m);
    }
  }
  __syncwarp();
  return n;
}

// A block whose chains have merged to at most PACK_CHAINS by byte PACK_AT
// joins the pack as slot g: its survivors' states go to pst, and each start
// state's survivor (by following its leaders) to 2 bits of its map.
__device__ void pack_block(const Walk& k, int g, int live, int np) {
  if (k.lane < live) {
    const uint32_t e = k.list[k.lane];
    k.rec[e >> 16] = FINAL | (uint32_t)k.lane;
    k.pst[g * PACK_CHAINS + k.lane] = e & 0xFFFFu;
  } else if (k.lane < PACK_CHAINS) {
    k.pst[g * PACK_CHAINS + k.lane] = 0;  // a spare chain walks state 0
  }
  __syncwarp();
  const int mb = map_bytes(np);
  for (int b = k.lane; b < mb; b += 32) {
    unsigned m = 0;
    if (live == 1) {  // one survivor: every start state follows it
      k.map[g * mb + b] = 0;
      continue;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = 4 * b + q;
      if (s < np) {
        uint32_t v = k.rec[s];
        while (!(v & FINAL)) v = k.rec[v];
        m |= (v & 3u) << (2 * q);
      }
    }
    k.map[g * mb + b] = (uint8_t)m;
  }
  __syncwarp();
}

// The packed walk: lane g carries the KP chains of the team's slot g (if it
// packed) from byte PACK_AT to the end of its block, its class ids streamed
// by its own cp.async ring; then the final states go to pst.
template <int KP, int TABLE>
__device__ void packed_walk(const Walk& k, unsigned packed, const int* blocks,
                            const WarpArgs& a, const uint16_t* tab, int pitch) {
  const int lane = k.lane, B = a.B;
  const bool live = (packed >> lane) & 1u;
  uint32_t st[KP];
#pragma unroll
  for (int u = 0; u < KP; ++u) st[u] = k.pst[lane * PACK_CHAINS + u];
  const uint8_t* row = a.cls + (live ? (size_t)blocks[lane] * B : 0) + PACK_AT;
  const int len = B - PACK_AT, n_win = (len + PWIN - 1) / PWIN;
  const int mis = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  unsigned char* ring = k.ring + lane * PRING * PBUF;
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  const unsigned tab_s = (unsigned)__cvta_generic_to_shared(tab);
  auto start = [&](int w) {
    if (live && w < n_win) {
      const int n = min(PWIN, len - w * PWIN);
      const uint8_t* src = row + (size_t)w * PWIN - mis;
#pragma unroll
      for (int q = 0; q < PBUF / 16; ++q)
        if (q * 16 < mis + n) cp_async16(ring + (w % PRING) * PBUF + q * 16, src + q * 16);
    }
    cp_async_commit();
  };
  for (int w = 0; w < PRING; ++w) start(w);
  for (int w = 0; w < n_win; ++w) {
    cp_async_wait<PRING - 1>();  // this lane's copies of window w have landed
    if (live) {
      const int n = min(PWIN, len - w * PWIN);
      const unsigned buf = ring_s + (w % PRING) * PBUF + mis;
      unsigned c0 = staged_class(buf), c1 = staged_class(buf + min(1, n - 1));
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int c = (int)c0;
        c0 = c1;
        c1 = staged_class(buf + min(j + 2, n - 1));
        step<KP, TABLE>(st, c, a, tab_s, pitch);
      }
    }
    start(w + PRING);
  }
  cp_async_wait<0>();
  if (live) {
#pragma unroll
    for (int u = 0; u < KP; ++u) k.pst[lane * PACK_CHAINS + u] = st[u];
  }
  __syncwarp();
}

template <int TABLE>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1) block_warp_kernel(WarpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WarpLayout L = warp_layout(a.C, a.S, TABLE, a.merge, a.pack);
  const int S = a.S, B = a.B;
  const int pitch = chain::row_entries(S, 2);
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem);
  if (TABLE == SMEM16) {
    for (int k = threadIdx.x; k < a.C * S; k += blockDim.x) {
      const int c = k / S;
      tab[c * pitch + (k - c * S)] = (uint16_t)__ldg(a.table + k);
    }
    for (int s = threadIdx.x; s < S; s += blockDim.x) tab[a.C * pitch + s] = 0;
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  unsigned char* mine = smem + L.warp0 + (size_t)warp * L.per_warp;
  Walk k;
  k.ring = mine;
  k.owner = reinterpret_cast<uint16_t*>(mine + L.owner);
  k.list = reinterpret_cast<uint32_t*>(mine + L.list);
  k.rec = reinterpret_cast<uint32_t*>(mine + L.rec);
  k.map = mine + L.map;
  k.pst = reinterpret_cast<uint32_t*>(mine + L.pst);
  k.lane = threadIdx.x & 31;
  k.n_win = (B + WWIN - 1) / WWIN;
  int* blocks = reinterpret_cast<int*>(mine + L.blocks);  // the team's blocks

  // the warp's blocks are first, first + stride, ...; with packing a team
  // of TEAM of them at a time
  const int first = blockIdx.x * warps + warp, stride = gridDim.x * warps;
  const int team = a.pack ? TEAM : 1;
  for (long long i0 = 0; first + i0 * stride < a.nb; i0 += team) {
    unsigned packed = 0;
    int kp = 0;
    for (int g = 0; g < team; ++g) {
      const long long nl = first + (i0 + g) * stride;
      if (nl >= a.nb) break;
      const int n = (int)nl;
      const size_t out0 = (size_t)n * S;
      k.row = a.cls + (size_t)n * B;
      k.mis = (int)(reinterpret_cast<uintptr_t>(k.row) & 15);
      for (int p0 = 0; p0 < S; p0 += PASS) {
        const int np = min(PASS, S - p0);
        __syncwarp();  // the last walk's reads of the rings and tables are done
        k.w = -1;
        for (int w = 0; w < WRING; ++w) warp_window(k, w, B);
        int live = np;
        if (a.merge)
          for (int i = k.lane; i < np; i += 32) k.list[i] = (uint32_t)i << 16 | (uint32_t)(p0 + i);
        __syncwarp();
        int t = 0;
        long long next = a.merge ? FIRST_CHECK : (long long)B;
        while (t < B) {
          const int t1 = (int)min((long long)B, next);
          run_segment<TABLE>(k, live, p0, t, t1, a, tab, pitch, out0);
          t = t1;
          if (t < B) live = merge_check(k, live);
          next *= 2;
          if (a.pack && t == PACK_AT && live <= PACK_CHAINS) break;
        }
        cp_async_wait<0>();  // what is left in flight is not needed
        if (t < B) {  // packed: the rest of the block walks in the team's pack
          pack_block(k, g, live, np);
          if (k.lane == 0) blocks[g] = n;
          packed |= 1u << g;
          kp = max(kp, live);
        } else if (a.merge) {
          // the survivors' final states, then every start state follows its
          // leaders (one hop a check at most) to one of them
          for (int i = k.lane; i < live; i += 32) {
            const uint32_t e = k.list[i];
            k.rec[e >> 16] = FINAL | (e & 0xFFFFu);
          }
          __syncwarp();
          for (int s = k.lane; s < np; s += 32) {
            uint32_t v = k.rec[s];
            while (!(v & FINAL)) v = k.rec[v];
            a.out[out0 + p0 + s] = (int)(v & ~FINAL);
          }
        }
      }
    }
    if (!packed) continue;
    __syncwarp();
    switch (kp) {
      case 1: packed_walk<1, TABLE>(k, packed, blocks, a, tab, pitch); break;
      case 2: packed_walk<2, TABLE>(k, packed, blocks, a, tab, pitch); break;
      case 3: packed_walk<3, TABLE>(k, packed, blocks, a, tab, pitch); break;
      default: packed_walk<4, TABLE>(k, packed, blocks, a, tab, pitch); break;
    }
    // every start state of a packed block takes its survivor's final state
    const int mb = map_bytes(S);
    for (int g = 0; g < TEAM; ++g) {
      if (!((packed >> g) & 1u)) continue;
      const size_t out0 = (size_t)blocks[g] * S;
      for (int s = k.lane; s < S; s += 32) {
        const int j = (k.map[g * mb + (s >> 2)] >> (2 * (s & 3))) & 3;
        a.out[out0 + s] = (int)k.pst[g * PACK_CHAINS + j];
      }
    }
  }
}

// persistent: the grid is capped at the CTAs the card holds at once, and
// each CTA's warps loop over the blocks
template <typename K>
int launch_kernel(K kernel, const Plan& p, cudaStream_t st, void* args, bool persistent) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  int grid = p.grid;
  if (persistent) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.threads, p.smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int most = per_sm * chain::device_attr(cudaDevAttrMultiProcessorCount, 1);
    if (grid > most) grid = most;
  }
  if (grid > 0) {
    e = cudaLaunchKernel((const void*)kernel, dim3(grid), dim3(p.threads), &args, p.smem, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

int launch_thread(const ThreadArgs& a, const Plan& p, cudaStream_t st) {
  void* args = const_cast<ThreadArgs*>(&a);
  switch (p.chains) {
#define K6_THREAD(CH) \
  case CH:            \
    return launch_kernel(block_thread_kernel<CH>, p, st, args, false);
    K6_THREAD(1) K6_THREAD(2) K6_THREAD(3) K6_THREAD(4) K6_THREAD(5) K6_THREAD(6) K6_THREAD(7)
    K6_THREAD(8) K6_THREAD(12) K6_THREAD(16) K6_THREAD(24) K6_THREAD(32)
#undef K6_THREAD
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ combine

constexpr int CWARPS = 16;        // warps (units) a CTA of the combine
constexpr int CTHREADS = 32 * CWARPS;
constexpr int HPL = 32;           // start states a lane carries per pass
constexpr int MIN_UNIT_ROWS = 4;  // fewer functions a unit and the CTAs are too many

struct CombinePlan {
  int grid, units;
};

CombinePlan combine_plan(int nb) {
  CombinePlan p;
  const int sms = chain::device_attr(cudaDevAttrMultiProcessorCount, 1);
  int grid = (nb + CWARPS * MIN_UNIT_ROWS - 1) / (CWARPS * MIN_UNIT_ROWS);
  if (grid > sms) grid = sms;
  if (grid < 1) grid = 1;
  p.units = grid * CWARPS < nb ? grid * CWARPS : nb;
  p.grid = (p.units + CWARPS - 1) / CWARPS;
  return p;
}

struct CombineArgs {
  const int* f;  // (nb, S)
  int nb, S;
  const int* start;
  int* entry;
  int* final_state;
  int* uagg;    // (units, S)
  int* cagg;    // (grid, S)
  int* uconst;  // (units,)
  int* cconst;  // (grid,)
  unsigned* bar;
  int units;
};

__device__ __forceinline__ int in_range(int v, int S) { return (unsigned)v < (unsigned)S ? v : 0; }

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every CTA of the (co-resident) grid arrives before any leaves.
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (ld_acquire(bar) < gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ int unit_row(int u, int nb, int units) {
  return (int)((long long)u * nb / units);
}

__global__ void __launch_bounds__(CTHREADS, 1) fn_combine_kernel(CombineArgs a) {
  __shared__ int s_entry[CWARPS];
  __shared__ int s_first;
  const int S = a.S, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u0 = blockIdx.x * CWARPS, u1 = min(u0 + CWARPS, a.units);
  const int u = u0 + warp;

  // 1. each warp composes its unit of functions from the identity
  if (u < u1) {
    const int r0 = unit_row(u, a.nb, a.units), r1 = unit_row(u + 1, a.nb, a.units);
    bool same = true;
    int first = 0;
    for (int s0 = 0; s0 < S; s0 += 32 * HPL) {
      int h[HPL];
#pragma unroll
      for (int q = 0; q < HPL; ++q) h[q] = min(s0 + lane + 32 * q, S - 1);
      for (int n = r0; n < r1; ++n) {
        const int* row = a.f + (size_t)n * S;
#pragma unroll
        for (int q = 0; q < HPL; ++q)  // rows of lanes past S take no load
          if (s0 + 32 * q < S) h[q] = in_range(__ldg(row + h[q]), S);
      }
      if (s0 == 0) first = __shfl_sync(0xFFFFFFFFu, h[0], 0);
#pragma unroll
      for (int q = 0; q < HPL; ++q) {
        const int s = s0 + lane + 32 * q;
        if (s < S) {
          a.uagg[(size_t)u * S + s] = h[q];
          same = same && h[q] == first;
        }
      }
    }
    same = __all_sync(0xFFFFFFFFu, same);
    if (lane == 0) a.uconst[u] = same;
  }
  __syncthreads();

  // 2. the CTA composes its units into its aggregate
  if (threadIdx.x == 0) {
    int v = 0;
    for (int w = u0; w < u1; ++w) v = a.uagg[(size_t)w * S + v];
    s_first = v;
  }
  __syncthreads();
  bool same = true;
  for (int s = threadIdx.x; s < S; s += CTHREADS) {
    int v = s;
    for (int w = u0; w < u1; ++w) v = a.uagg[(size_t)w * S + v];
    a.cagg[(size_t)blockIdx.x * S + s] = v;
    same = same && v == s_first;
  }
  same = __syncthreads_and(same);
  if (threadIdx.x == 0) a.cconst[blockIdx.x] = same;

  grid_barrier(a.bar);

  // 3. this CTA's entry from the aggregates before it (from the last
  // constant one on), then its units' entries
  if (threadIdx.x == 0) {
    int e = in_range(*a.start, S);
    int j0 = 0;
    for (int j = (int)blockIdx.x - 1; j >= 0; --j) {
      if (__ldcg(a.cconst + j)) {
        e = __ldcg(a.cagg + (size_t)j * S);
        j0 = j + 1;
        break;
      }
    }
    for (int j = j0; j < (int)blockIdx.x; ++j) e = __ldcg(a.cagg + (size_t)j * S + e);
    for (int w = u0; w < u1; ++w) {
      s_entry[w - u0] = e;
      e = a.uconst[w] ? a.uagg[(size_t)w * S] : a.uagg[(size_t)w * S + e];
    }
    if (blockIdx.x == gridDim.x - 1) *a.final_state = e;
  }
  __syncthreads();

  // 4. each warp walks its unit from its entry, one lookup a block
  if (u < u1 && lane == 0) {
    const int r0 = unit_row(u, a.nb, a.units), r1 = unit_row(u + 1, a.nb, a.units);
    int e = s_entry[warp];
    for (int n = r0; n < r1; ++n) {
      a.entry[n] = e;
      e = in_range(__ldg(a.f + (size_t)n * S + e), S);
    }
  }
}

}  // namespace

// K6 pass 1: out[n, s] = the state after block n of cls (nb rows of B uint8
// class ids, contiguous) entered in state s; out is (nb, S) int32. Every
// entry of table (C, S) int32 must lie in [0, S).
extern "C" int dfa_block_fns(const uint8_t* cls, const int* table, int C, int S, int nb, int B,
                             int* out, void* stream) {
  if (C < 1 || C > 256 || S < 1 || B < 1 || nb < 0) return (int)cudaErrorInvalidValue;
  if (nb == 0) return 0;
  const Plan p = plan(C, S, nb, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.kind == BLOCK_A_THREAD) {
    ThreadArgs a = {chain::Source{cls, B, 1, nb, B}, table, C, S, out, p.ring};
    return launch_thread(a, p, st);
  }
  if (p.warps < 1) return (int)cudaErrorInvalidValue;  // not even one warp fits
  WarpArgs a = {cls, table, C, S, nb, B, out, p.merge, p.pack};
  void* args = &a;
  if (p.table == SMEM16) return launch_kernel(block_warp_kernel<SMEM16>, p, st, args, true);
  return launch_kernel(block_warp_kernel<GLOBAL>, p, st, args, true);
}

// The route a launch takes: bits 0-1 the table (0 global memory, 1 shared
// uint32 entries, 2 shared uint16 entries), bit 2 the route (0 a block a
// thread, 1 a block a warp), bits 3-8 the chains a lane (before merging),
// bits 9-13 the merge checks a block, bit 14 packing, bits 15 and up the
// blocks a CTA walks at once (a block a thread: its threads; a block a warp:
// its warps, TEAM times that with packing).
extern "C" int dfa_block_fns_route(int C, int S, int nb, int B) {
  const Plan p = plan(C, S, nb, B);
  const int blocks = p.kind == BLOCK_A_THREAD ? chain::LANES : p.warps * (p.pack ? TEAM : 1);
  return p.table | (p.kind << 2) | (p.chains << 3) | (p.checks << 9) | (p.pack << 14) |
         (blocks << 15);
}

// The int32 scratch that dfa_fn_combine needs for nb functions of S states.
extern "C" long long dfa_fn_combine_scratch(int nb, int S) {
  const CombinePlan p = combine_plan(nb);
  return ((long long)p.units + p.grid) * S + p.units + p.grid;
}

// The combine: entry[n] = the state at the start of block n when the stream
// starts in *start (a device pointer), and *final_state the state after
// block nb - 1, for the (nb, S) int32 block functions f. scratch: the
// dfa_fn_combine_scratch(nb, S) int32 of its aggregates; bar: one zeroed
// uint32.
extern "C" int dfa_fn_combine(const int* f, int nb, int S, const int* start, int* entry,
                              int* final_state, int* scratch, unsigned* bar, void* stream) {
  if (nb < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const CombinePlan p = combine_plan(nb);
  CombineArgs a;
  a.f = f, a.nb = nb, a.S = S, a.start = start, a.entry = entry, a.final_state = final_state;
  a.uagg = scratch;
  a.cagg = a.uagg + (size_t)p.units * S;
  a.uconst = a.cagg + (size_t)p.grid * S;
  a.cconst = a.uconst + p.units;
  a.bar = bar;
  a.units = p.units;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn_combine_kernel,
                                                                CTHREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;  // the grid could not be resident
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)fn_combine_kernel, dim3(p.grid), dim3(CTHREADS),
                                  args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
