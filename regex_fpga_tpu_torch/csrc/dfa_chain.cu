// K1 and K2: the k=1 DFA chain pass, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernels regex_fpga_tpu/ops/pallas_dfa.py::_kernel (K1:
// finals, and the emit mode with the state and accept bit before each byte)
// and ::_counts_kernel (K2: finals plus the per-state accept-visit
// histogram), and the XLA passes they stood in for,
// regex_fpga_tpu/ops/dfa_fast.py::chain_pass_{finals,full,mask,counts} and
// ::_chain_pass_counts_multi (per-stream histograms).
//
// What it computes: NB independent chains; at each step lane n does
//     state <- T[class(n, t), state]
// and, by mode, records the state before the byte (full), its accept bit
// (full, mask), or counts the visit in hist[stream(n), state] when the state
// accepts (counts). A state or class outside the table steps to state 0 and
// never accepts, which is what the one-hot lookup of the JAX engines does.
//
// What bounds it on this card: each step is a load whose address depends on
// the previous load, so a lane is bound by the latency of its table load
// (about 12 ns from shared memory), not by device-memory bandwidth (the
// class stream is 1 byte per step and is read once). With few lanes (the
// lazy NFA path runs 1,024 lanes of 4,096 steps, four warps an SM) nothing
// hides what else a warp does: every instruction beside the chain, every
// barrier and every wait for device memory adds to the steps x latency
// floor.
//
// What the design does about it:
//   - The table sits in shared memory whenever it can, as uint32 entries or,
//     for S <= 32,767, uint16 ones (a Snort lazy-DFA snapshot of (83, 1025)
//     takes 172 KB), whichever lets an SM hold more of the CTAs the grid
//     needs (plan()). It is stored padded and sanitized: (C + 1) rows of
//     (S + 1) entries (padded to an odd number of words, row_entries()),
//     where an entry is the byte offset of the next
//     state's column within a row, row C and column S are the zero row and
//     column (every entry there leads to state 0), and a table entry
//     outside [0, S) is stored as column S. So whatever a lane loads is in
//     range, and a step on the chain of dependent loads is add, load (mask,
//     add, load where entries carry an accept bit): no range check, no
//     predicate. Entries that were outside [0, S) are re-read from the
//     int32 table only where a state is emitted (full mode, finals), so
//     corrupt tables give exactly the plain version's output. Only a table
//     that fits in neither form is read through the read-only cache (L2
//     latency on every step, with the range checks on the chain).
//   - One load per step in every mode: outside finals mode, bit 0 of an
//     entry carries the accept bit of the state it leads to (the lane's
//     entry state gets its bit from one load before the loop), so "accept
//     is counted before each byte" costs no second state-dependent load.
//     Column S never accepts.
//   - Nothing but the table load sits on the chain, and the rest fills the
//     time it waits: a window's class ids are in registers, as the byte
//     offset of their table row, before its chain starts; the next window's
//     ids are read from the staging ring into those registers inside the
//     chain's loop, in one block of straight-line code (run_window()). The
//     accept bits of a window are gathered in a 32-bit mask and stored
//     after its chain (full, mask), or counted as they come (counts): one
//     predicated shared-memory reduction on the state's counter, which
//     depends on the chain but the chain not on it, and which is no
//     compiler barrier between two table loads.
//   - Histogram rows in shared memory, merged into counts once per CTA:
//     for S <= 64 one private row per lane (hist[state][lane]: no two lanes
//     share an address or, within a warp, a bank, however dense the hits:
//     on tokenizer text every fourth step counts, on 11 of 23 states); for
//     larger S one row per stream the CTA can touch, where hits are rare
//     and spread over many states (under 1% of the steps on the Snort lazy
//     table). Both give exact (N, S) counts, a CTA that spans streams
//     included.
//   - Class ids are staged by cp.async in a ring of up to 8 windows
//     (chain_common.cuh): device memory takes over a microsecond to deliver
//     a window, more than two windows' chains. Where steps are contiguous
//     each thread copies its own lane's chunks, so no barrier separates
//     two windows.
//   - Raw bytes in, where the caller passes the byte-to-class map
//     (class_of): each CTA keeps a 256-entry table of row offsets in shared
//     memory, row_of(class_of[b]) for every byte b, and a window's ids
//     become rows by one shared load each, in the same straight-line block
//     that reads them from the ring, off the chain. The map costs the card
//     no pass of its own over the chunk and no ids array. Its own
//     instantiations (MAP): the launches without it keep their code, shared
//     memory and routes.
//   - One thread per lane, 128 lanes per CTA, at most 128 registers a lane
//     so that four CTAs fit an SM: a narrower CTA would use more SMs but
//     each CTA fills the whole table with fewer threads, and the chain of
//     one lane does not get shorter.
//
// No float GEMM: the TPU kernel looked T up with a one-hot matrix product in
// bf16/f32; here T is read directly, so no TF32 or bf16 rounding can touch a
// state id.
#include "chain_common.cuh"

using namespace chain;

namespace {

enum Mode { FINALS = 0, FULL = 1, MASK = 2, COUNTS = 3 };
enum Route { GLOBAL = 0, SMEM32 = 1, SMEM16 = 2 };      // where the table lives
enum Hist { HIST_GLOBAL = 0, HIST_STREAM = 1, HIST_LANE = 2 };  // and the histogram
constexpr int NARROW_MAX_STATES = 32767;   // column S, as a byte offset, fits uint16
constexpr int LANE_HIST_MAX_STATES = 64;   // private rows: 512 bytes a state
constexpr int CTAS_PER_SM = 4;  // at 128 registers a lane: 65,536 lanes (512 CTAs) are
                                // resident at once on 132 SMs

constexpr int BYTES = 256;  // entries of the byte-to-class map

struct DfaArgs {
  Source cls;
  const unsigned char* class_of;  // (256,) byte -> class, or null: cls holds class ids
  const int* table;
  const unsigned char* accept;
  int C, S;
  const int* entries;
  int* finals;
  int* states;
  unsigned char* acc;
  long long out_ls, out_ss;
  int* counts;
  int lanes_per_stream, n_streams;
  int hist, hist_rows;  // Hist, and the rows of HIST_STREAM
  int ring;             // windows in the staging ring: 2, 4 or 8
};

template <int ROUTE>
struct Entry {  // a shared-memory table entry: column << SHIFT | accept bit
  using type = uint32_t;
  static constexpr int SHIFT = 2;
};
template <>
struct Entry<SMEM16> {
  using type = uint16_t;
  static constexpr int SHIFT = 1;
};

__host__ __device__ inline size_t hist_words(int hist, int hist_rows, int S) {
  if (hist == HIST_LANE) return (size_t)LANES * S;
  return hist == HIST_STREAM ? (size_t)hist_rows * S : 0;
}

struct Layout {
  size_t ring, states, acc, table, bits, hist, rows, total;
};

__host__ __device__ inline Layout layout(int mode, int cls_bytes, int C, int S, int route,
                                         int hist, int hist_rows, int ring, bool mapped) {
  Layout L;
  size_t off = 0;
  L.ring = off;
  off += (size_t)ring * stage_bytes(cls_bytes);
  L.states = off;
  if (mode == FULL) off += align16(sizeof(int) * LANES * PITCH);
  L.acc = off;
  if (mode == FULL || mode == MASK) off += align16((size_t)LANES * BPITCH);
  L.table = off;  // (C + 1) rows of row_entries() entries: see fill_table()
  if (route == SMEM32) off += align16(sizeof(uint32_t) * ((size_t)C + 1) * row_entries(S, 4));
  if (route == SMEM16) off += align16(sizeof(uint16_t) * ((size_t)C + 1) * row_entries(S, 2));
  L.bits = off;  // the accept bitmap that the entries' accept bits are taken from
  if (route != GLOBAL && mode != FINALS) off += align16(sizeof(unsigned) * ((size_t)S / 32 + 1));
  L.hist = off;
  off += align16(sizeof(int) * hist_words(hist, hist_rows, S));
  L.rows = off;  // the byte map's row offsets: see fill_byte_rows()
  if (mapped) off += align16(sizeof(int) * BYTES);
  L.total = off;
  return L;
}

struct Plan {
  int route, hist, hist_rows, ring;
  size_t smem;
};

// Where a launch keeps its data. The table goes to shared memory when it
// fits, as uint32 entries or, while S allows, uint16: whichever lets an SM
// hold more of the CTAs the grid needs there (uint32 when it is a tie: its
// load is a little shorter). The histogram of counts mode: a private row per
// lane for few states, else a row per stream that a CTA can touch, else
// atomics on the counts in global memory. Then the staging ring, as deep as
// what is left allows (ring_depth()). mapped: the launch reads raw bytes
// through the byte-to-class map.
Plan plan(int mode, int cls_bytes, int C, int S, int nb, int lanes_per_stream, bool mapped) {
  const Residency res(CTAS_PER_SM);
  const int n_streams = (nb + lanes_per_stream - 1) / lanes_per_stream;
  int rows = (LANES - 1) / lanes_per_stream + 2;
  if (rows > n_streams) rows = n_streams;
  // the first histogram that fits beside the table of `route`, or -1
  auto hist_for = [&](int route) {
    const int hists[3] = {HIST_LANE, HIST_STREAM, HIST_GLOBAL};
    for (int h : hists) {
      if (mode != COUNTS && h != HIST_GLOBAL) continue;
      if (h == HIST_LANE && S > LANE_HIST_MAX_STATES) continue;
      if (res.resident(layout(mode, cls_bytes, C, S, route, h, rows, 2, mapped).total) > 0)
        return h;
    }
    return -1;
  };
  Plan p = {GLOBAL, hist_for(GLOBAL), rows, 2, 0};
  if (p.hist < 0) p.hist = HIST_GLOBAL;  // no room for the ring: the launch will say so
  int best = 0;
  const int routes[2] = {SMEM32, SMEM16};
  for (int r : routes) {
    const int h = r == SMEM16 && S > NARROW_MAX_STATES ? -1 : hist_for(r);
    if (h < 0) continue;
    int n = res.resident(layout(mode, cls_bytes, C, S, r, h, rows, 2, mapped).total);
    if (n > res.wanted(nb)) n = res.wanted(nb);
    if (n > best) p.route = r, p.hist = h, best = n;
  }
  const int stage = stage_bytes(cls_bytes);
  const size_t base = layout(mode, cls_bytes, C, S, p.route, p.hist, rows, 0, mapped).total;
  // a table in global memory: every step waits on L2 or L1 in any case, and
  // what the ring does not take of the SM stays L1 cache for the table
  p.ring = p.route == GLOBAL ? 2 : ring_depth(res, base, stage, nb);
  p.smem = base + (size_t)p.ring * stage;
  return p;
}

// The accept bits of the states as a bitmap in shared memory (bit S, the
// zero column, is clear), so that folding a state's bit into an entry costs
// one shared-memory load: a warp's ballot per 32 states.
__device__ void fill_accept_bits(unsigned* bits, const unsigned char* __restrict__ accept,
                                 int S) {
  const int ln = threadIdx.x & 31;
  for (int base = (threadIdx.x >> 5) * 32; base <= S; base += LANES) {
    const int state = base + ln;
    const unsigned word = __ballot_sync(0xFFFFFFFFu, state < S && __ldg(accept + state));
    if (ln == 0) bits[base >> 5] = word;
  }
}

// The shared-memory entry for table value v: its column as a byte offset,
// with the accept bit of the state in bit 0 (bits: fill_accept_bits(), or
// nullptr for entries without the bit); column S, which never accepts, for
// a value outside [0, S).
template <int ROUTE>
__device__ __forceinline__ unsigned encode(int v, int S, const unsigned* bits) {
  constexpr int SH = Entry<ROUTE>::SHIFT;
  const unsigned col = min((unsigned)v, (unsigned)S);
  return (col << SH) | (bits ? (bits[col >> 5] >> (col & 31)) & 1u : 0u);
}

// Fill the padded shared-memory table from the (C, S) int32 table, then the
// zero column S of every row and the zero row C. Where the source allows, a
// thread has FILL_BATCH 16-byte loads in flight before it encodes and stores
// any of them (340 KB come from L2 through 128 threads for a lazy-DFA
// snapshot), and it follows its place (row c, column s) from one load to the
// next by addition: no division but the first.
constexpr int FILL_BATCH = 8;

template <int ROUTE>
__device__ void fill_table(typename Entry<ROUTE>::type* dst, const int* __restrict__ src,
                           int C, int S, const unsigned* bits) {
  using ET = typename Entry<ROUTE>::type;
  const int P = row_entries(S, sizeof(ET));
  const int total = C * S;
  const int n4 = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? total >> 2 : 0;
  const int4* src4 = reinterpret_cast<const int4*>(src);
  int c = (threadIdx.x * 4) / S, s = threadIdx.x * 4 - c * S;
  const int dc = (LANES * 4) / S, ds = (LANES * 4) % S;  // from one load to the next
  for (int k = threadIdx.x; k < n4; k += LANES * FILL_BATCH) {
    int4 q[FILL_BATCH];
#pragma unroll
    for (int u = 0; u < FILL_BATCH; ++u)
      if (k + u * LANES < n4) q[u] = __ldg(src4 + k + u * LANES);
#pragma unroll
    for (int u = 0; u < FILL_BATCH; ++u) {
      if (k + u * LANES < n4) {
        const int v[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
        int ci = c, si = s;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dst[ci * P + si] = (ET)encode<ROUTE>(v[i], S, bits);
          if (++si == S) si = 0, ++ci;
        }
      }
      c += dc, s += ds;
      if (s >= S) s -= S, ++c;
    }
  }
  for (int k = n4 * 4 + threadIdx.x; k < total; k += LANES)
    dst[k + k / S * (P - S)] = (ET)encode<ROUTE>(__ldg(src + k), S, bits);  // c * P + s
  const ET zero = (ET)encode<ROUTE>(0, S, bits);
  for (int c = threadIdx.x; c < C; c += LANES) dst[c * P + S] = zero;
  for (int s = threadIdx.x; s <= S; s += LANES) dst[C * P + s] = zero;
}

// The state a lane emits (in full mode, and as its final state) for the
// value cur it carries. On the shared routes cur is a table entry: column S
// stands for a value outside [0, S), which is re-read from the int32 table
// at the place it was loaded from (from: its byte offset in the padded
// table); from < 0 means the lane still carries its entry state.
template <int ROUTE>
__device__ __forceinline__ int emitted(int cur, int from, int entry, int S,
                                       const int* __restrict__ g) {
  if (ROUTE == GLOBAL) return cur;
  constexpr int SH = Entry<ROUTE>::SHIFT;
  if (from < 0) return entry;
  const int col = cur >> SH;
  if (col != S) return col;
  const int P = row_entries(S, 1 << SH);
  const int e = from >> SH, c = e / P;
  return __ldg(g + c * S + (e - c * P));
}

// Where a lane counts its accept visits: its row of the histogram in shared
// memory (a 32-bit shared address) or in the counts in global memory, and
// the distance between two states' counters in bytes. The two spaces get
// their own reduction instruction: an atomic on a generic address that
// turns out to be shared memory takes several hundred cycles.
struct HistRow {
  unsigned shared;  // shared-memory address of state 0's counter, if in_shared
  int* global;      // else its address in global memory
  int pitch;        // bytes from one state's counter to the next
  bool in_shared;
};

// counter += 1 when bit is set: one predicated reduction, no branch. Not a
// compiler barrier ("memory" is not clobbered), so that the table loads of
// the chain move freely around it: nothing reads the counters before the
// barrier that follows the last window.
__device__ __forceinline__ void count_shared_if(unsigned bit, unsigned addr) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %0, 0;\n @p red.shared.add.u32 [%1], 1;\n}\n" ::"r"(bit),
      "r"(addr));
}
__device__ __forceinline__ void count_global_if(unsigned bit, int* p) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %0, 0;\n @p red.global.add.u32 [%1], 1;\n}\n" ::"r"(bit),
      "l"(p));
}

template <bool HIST_SHARED>
__device__ __forceinline__ void count_if(unsigned bit, int state, const HistRow& hist) {
  if (HIST_SHARED)
    count_shared_if(bit, hist.shared + (unsigned)(state * hist.pitch));
  else
    count_global_if(bit, hist.global + state);
}

// What a step adds to the value the lane carries, for class id c: on the
// shared routes the byte offset of the class's table row (row C for a class
// outside the table; pitch: the bytes of a row), on the global route c * S,
// or -1.
template <int ROUTE>
__device__ __forceinline__ int row_of(int c, int C, int S, int pitch) {
  if (ROUTE == GLOBAL) return (unsigned)c < (unsigned)C ? c * S : -1;
  return (int)min((unsigned)c, (unsigned)C) * pitch;
}

// The byte map's table in shared memory: rows[b] = row_of(class_of[b]), so
// a byte outside the table's classes keeps the meaning of such a class id.
template <int ROUTE>
__device__ void fill_byte_rows(int* rows, const unsigned char* __restrict__ class_of, int C,
                               int S) {
  const int pitch = row_entries(S, sizeof(typename Entry<ROUTE>::type)) << Entry<ROUTE>::SHIFT;
  for (int b = threadIdx.x; b < BYTES; b += LANES)
    rows[b] = row_of<ROUTE>(__ldg(class_of + b), C, S, pitch);
}

// The row a staged element steps by: a class id's own (row_of), or with
// the map (MAP, raw bytes) the byte's entry in the shared table rows.
template <typename CT, int ROUTE, bool MAP>
__device__ __forceinline__ int step_row(CT v, const int* rows, int C, int S, int pitch) {
  if (MAP) return rows[(unsigned char)v];
  return row_of<ROUTE>((int)v, C, S, pitch);
}

// Step one lane through a window whose rows are in registers, and read the
// next window's class ids from the ring into those registers as it goes:
// row[j] is free once step j has used it. Returns the value the lane
// carries after the window (a table entry on the shared routes, a state on
// the global one). The chain of dependent table loads carries nothing else:
// the next window's loads, the accept bits (gathered in a mask, full and
// mask mode) and the counting (a predicated reduction on the state's
// counter; HIST_SHARED: the counters are in shared memory) are independent
// of it and fill the time it waits.
template <typename CT, int MODE, int ROUTE, bool MAP, int PATH, bool HIST_SHARED>
__device__ __forceinline__ int run_window(int cur, int& from, int entry, int n, int n_next,
                                          int (&row)[WIN], const unsigned char* next_buf,
                                          const WindowAddr& next_wa, const int* rows, unsigned tab,
                                          const unsigned char* acc_of, const DfaArgs& a,
                                          int* s_states, unsigned char* s_acc,
                                          const HistRow& hist) {
  using ET = typename Entry<ROUTE>::type;
  constexpr int SH = Entry<ROUTE>::SHIFT;
  constexpr bool HOT = PATH != EDGE;
  const int C = a.C, S = a.S;
  const int pitch = row_entries(S, 1 << SH) << SH;
  unsigned hits = 0;
  // global route: a step's accept bit comes from a load of its own, and is
  // counted one step later, so that what waits on that load does not hold
  // up, in program order, the next step's table load
  unsigned hit_before = 0;
  int state_before = 0;
#pragma unroll
  for (int j = 0; j < WIN; ++j) {
    const int r = row[j];
    if (HOT || j < n_next)
      row[j] = step_row<CT, ROUTE, MAP>(staged<CT, PATH == HOT_SF>(next_buf, next_wa, j), rows,
                                        C, S, pitch);
    if (!HOT && j >= n) continue;
    int next, state = cur;
    unsigned hit = 0;
    if (ROUTE == GLOBAL) {
      const bool valid = (unsigned)cur < (unsigned)S;
      next = valid && r >= 0 ? __ldg(a.table + r + cur) : 0;
      if (MODE != FINALS) hit = valid ? (unsigned)__ldg(acc_of + cur) : 0u;
      if (MODE == COUNTS && !valid) state = 0;  // never counted: hit is 0
    } else {
      const int off = r + (MODE == FINALS ? cur : cur & ~1);
      next = (int)table_entry<ET>(tab + (unsigned)off);
      if (MODE != FINALS) hit = (unsigned)cur & 1u;
      if (MODE == FULL) state = emitted<ROUTE>(cur, from, entry, S, a.table);
      if (MODE == COUNTS) state = cur >> SH;
      from = off;
    }
    if (MODE == FULL) s_states[threadIdx.x * PITCH + j] = state;
    if (MODE == FULL || MODE == MASK) hits |= hit << j;
    if (MODE == COUNTS) {
      if (ROUTE == GLOBAL) {
        const unsigned h = hit_before;
        const int st = state_before;
        hit_before = hit, state_before = state;
        hit = h, state = st;
      }
      count_if<HIST_SHARED>(hit, state, hist);
    }
    cur = next;
  }
  if (MODE == COUNTS && ROUTE == GLOBAL) count_if<HIST_SHARED>(hit_before, state_before, hist);
  if (MODE == FULL || MODE == MASK) {
#pragma unroll
    for (int j = 0; j < WIN; ++j) s_acc[threadIdx.x * BPITCH + j] = (hits >> j) & 1u;
  }
  return cur;
}

// Add the CTA's private rows hist[state * LANES + lane] into counts: each
// warp sums 32 lanes of one state; when they belong to one stream (the rule)
// that is one reduction and one atomic, else one atomic per lane.
__device__ void merge_lane_rows(const int* s_hist, const DfaArgs& a, int lane0) {
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  for (int p = warp; p < a.S * (LANES / 32); p += LANES / 32) {
    const int s = p / (LANES / 32), l = (p % (LANES / 32)) * 32 + ln;
    const int v = s_hist[s * LANES + l];  // 0 for a lane past the last one
    const int stream = min((lane0 + l) / a.lanes_per_stream, a.n_streams - 1);
    const int first = __shfl_sync(0xFFFFFFFFu, stream, 0);
    if (__all_sync(0xFFFFFFFFu, stream == first)) {
      const int sum = __reduce_add_sync(0xFFFFFFFFu, v);
      if (ln == 0 && sum) atomicAdd(a.counts + (size_t)first * a.S + s, sum);
    } else if (v) {
      atomicAdd(a.counts + (size_t)stream * a.S + s, v);
    }
  }
}

template <typename CT, int MODE, int ROUTE, bool MAP>
__global__ void __launch_bounds__(LANES, CTAS_PER_SM) dfa_chain_kernel(DfaArgs a) {
  constexpr int ES = sizeof(CT);
  constexpr int STAGE = stage_bytes(ES);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(MODE, ES, a.C, a.S, ROUTE, a.hist, a.hist_rows, a.ring, MAP);
  unsigned char* ring = smem + L.ring;
  int* s_states = reinterpret_cast<int*>(smem + L.states);
  unsigned char* s_acc = smem + L.acc;
  int* s_hist = reinterpret_cast<int*>(smem + L.hist);
  int* s_rows = reinterpret_cast<int*>(smem + L.rows);
  const int S = a.S;
  const int lane0 = blockIdx.x * LANES;
  const int lane = lane0 + threadIdx.x;
  const bool live = lane < a.cls.nb;
  const int steps = a.cls.steps;
  const int n_win = (steps + WIN - 1) / WIN;

  // the ring's first windows are in flight while the table fills
  const Stager<ES> stager(a.cls, lane0);
  auto steps_of = [&](int w) { return min(WIN, steps - w * WIN); };
  const int ring_mask = a.ring - 1;
  for (int w = 0; w < a.ring; ++w) {
    if (w < n_win) stager.start(ring + w * STAGE, w, steps_of(w));
    cp_async_commit();
  }

  // outside finals mode the accept bits go into the shared table's entries
  const unsigned char* acc_of = a.accept;  // read per step on the global route only
  unsigned* bits = nullptr;
  if (ROUTE != GLOBAL) {
    if (MODE != FINALS) {
      bits = reinterpret_cast<unsigned*>(smem + L.bits);
      fill_accept_bits(bits, a.accept, S);
      __syncthreads();
    }
    fill_table<ROUTE>(reinterpret_cast<typename Entry<ROUTE>::type*>(smem + L.table),
                      a.table, a.C, S, bits);
  }
  if (MAP) fill_byte_rows<ROUTE>(s_rows, a.class_of, a.C, S);
  if (MODE == COUNTS)
    for (int k = threadIdx.x; k < (int)hist_words(a.hist, a.hist_rows, S); k += LANES)
      s_hist[k] = 0;
  const unsigned tab = (unsigned)__cvta_generic_to_shared(smem + L.table);

  const int entry = live ? a.entries[lane] : 0;
  int cur = ROUTE == GLOBAL ? entry : (int)encode<ROUTE>(entry, S, bits);
  int from = -1;
  HistRow hist = {0, nullptr, (int)sizeof(int), a.hist != HIST_GLOBAL};
  int stream0 = 0;
  if (MODE == COUNTS) {
    stream0 = lane0 / a.lanes_per_stream;
    const int stream = live ? lane / a.lanes_per_stream : stream0;
    if (a.hist == HIST_LANE) {
      hist.shared = (unsigned)__cvta_generic_to_shared(s_hist + threadIdx.x);
      hist.pitch = LANES * (int)sizeof(int);
    } else if (a.hist == HIST_STREAM) {
      hist.shared = (unsigned)__cvta_generic_to_shared(s_hist + (size_t)(stream - stream0) * S);
    } else {
      hist.global = a.counts + (size_t)stream * S;
    }
  }

  // The windows are pipelined: while a lane steps through window w out of
  // its registers, the ids of window w+1 go from the ring to registers and
  // the copies of the windows after it are in flight, so neither device
  // memory nor the ids' loads are waited for between two windows' chains.
  // With steps contiguous there is no barrier between windows either.
  int row[WIN];
  wait_next_window(a.ring);  // this thread's copies of window 0 have landed (of 1 too)
  __syncthreads();           // everyone's have, and the tables are filled
  {
    const WindowAddr wa = stager.addr(0);
    const int pitch = row_entries(S, sizeof(typename Entry<ROUTE>::type))
                      << Entry<ROUTE>::SHIFT;
#pragma unroll
    for (int j = 0; j < WIN; ++j)
      row[j] = live && j < steps
                   ? step_row<CT, ROUTE, MAP>(staged<CT>(ring, wa, j), s_rows, a.C, S, pitch)
                   : 0;
  }
  for (int w = 0; w < n_win; ++w) {
    const int n = steps_of(w);
    const int n_next = w + 1 < n_win ? steps_of(w + 1) : 0;
    const bool hot = n_next == WIN;  // then n == WIN too
    if (n_next) {
      wait_next_window(a.ring);  // this thread's copies of window w+1 have landed
      // where threads share the copies: everyone's have, and window w is in
      // everyone's registers
      if (stager.cooperative()) __syncthreads();
      if (w + a.ring < n_win) {  // window w's buffer takes the window a ring ahead
        unsigned char* buf = ring + (w & ring_mask) * STAGE;
        if (stager.steps_fast && steps_of(w + a.ring) == WIN)
          stager.start_whole(buf, w + a.ring);
        else
          stager.start(buf, w + a.ring, steps_of(w + a.ring));
      }
      cp_async_commit();
    }
    if (live) {
      const unsigned char* buf = ring + ((w + 1) & ring_mask) * STAGE;
      const WindowAddr wa = stager.addr(w + 1);
      // counters in global memory (more states than two shared rows hold)
      // take the predicated path for every window
      const bool shared_hist = MODE != COUNTS || hist.in_shared;
      if (hot && shared_hist && stager.steps_fast)
        cur = run_window<CT, MODE, ROUTE, MAP, HOT_SF, true>(
            cur, from, entry, n, n_next, row, buf, wa, s_rows, tab, acc_of, a, s_states, s_acc,
            hist);
      else if (hot && shared_hist)
        cur = run_window<CT, MODE, ROUTE, MAP, HOT_LF, true>(
            cur, from, entry, n, n_next, row, buf, wa, s_rows, tab, acc_of, a, s_states, s_acc,
            hist);
      else if (shared_hist)
        cur = run_window<CT, MODE, ROUTE, MAP, EDGE, true>(
            cur, from, entry, n, n_next, row, buf, wa, s_rows, tab, acc_of, a, s_states, s_acc,
            hist);
      else
        cur = run_window<CT, MODE, ROUTE, MAP, EDGE, false>(
            cur, from, entry, n, n_next, row, buf, wa, s_rows, tab, acc_of, a, s_states, s_acc,
            hist);
    }
    if (MODE == FULL || MODE == MASK) {  // the per-step outputs, stored coalesced
      __syncthreads();
      if (MODE == FULL)
        store_window<int, PITCH>(a.states, s_states, a.out_ls, a.out_ss, lane0, a.cls.nb,
                                 w * WIN, n);
      store_window<unsigned char, BPITCH>(a.acc, s_acc, a.out_ls, a.out_ss, lane0, a.cls.nb,
                                          w * WIN, n);
      __syncthreads();  // the tiles are stored before the next window fills them
    }
  }
  if (live) a.finals[lane] = emitted<ROUTE>(cur, from, entry, S, a.table);

  if (MODE == COUNTS && a.hist != HIST_GLOBAL) {
    __syncthreads();
    if (a.hist == HIST_LANE) {
      merge_lane_rows(s_hist, a, lane0);
    } else {
      for (int k = threadIdx.x; k < a.hist_rows * S; k += LANES) {
        const int v = s_hist[k];
        const int stream = stream0 + k / S;
        if (v && stream < a.n_streams) atomicAdd(a.counts + (size_t)stream * S + k % S, v);
      }
    }
  }
}

template <typename CT, int MODE, bool MAP>
int launch(const DfaArgs& a, cudaStream_t st) {
  const Plan p = plan(MODE, sizeof(CT), a.C, a.S, a.cls.nb, a.lanes_per_stream, MAP);
  DfaArgs b = a;
  b.hist = p.hist;
  b.hist_rows = p.hist_rows;
  b.ring = p.ring;
  switch (p.route) {
    case SMEM32:
      return launch_chain(dfa_chain_kernel<CT, MODE, SMEM32, MAP>, b, b.cls.nb, p.smem, st);
    case SMEM16:
      return launch_chain(dfa_chain_kernel<CT, MODE, SMEM16, MAP>, b, b.cls.nb, p.smem, st);
  }
  return launch_chain(dfa_chain_kernel<CT, MODE, GLOBAL, MAP>, b, b.cls.nb, p.smem, st, true);
}

template <int MODE>
int dispatch(const DfaArgs& a, int cls_bytes, cudaStream_t st) {
  // the staging copies rows along the contiguous axis (the wrapper makes
  // one stride 1)
  if (a.cls.ss != 1 && a.cls.ls != 1) return (int)cudaErrorInvalidValue;
  if (a.S < 1 || a.C < 1) return (int)cudaErrorInvalidValue;
  if (a.class_of) return cls_bytes == 1 ? launch<uint8_t, MODE, true>(a, st)
                                        : (int)cudaErrorInvalidValue;  // raw bytes only
  switch (cls_bytes) {
    case 1: return launch<uint8_t, MODE, false>(a, st);
    case 2: return launch<int16_t, MODE, false>(a, st);
    case 4: return launch<int32_t, MODE, false>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

DfaArgs dfa_args(const void* cls, long long cls_ls, long long cls_ss,
                 const unsigned char* class_of, const int* table, const unsigned char* accept,
                 int C, int S, const int* entries, int nb, int steps, int* finals) {
  DfaArgs a = {};
  a.cls = Source{cls, cls_ls, cls_ss, nb, steps};
  a.class_of = class_of;
  a.table = table;
  a.accept = accept;
  a.C = C;
  a.S = S;
  a.entries = entries;
  a.finals = finals;
  a.lanes_per_stream = 1;
  a.n_streams = 1;
  return a;
}

}  // namespace

// K1: finals (states == acc == NULL), full (both set) or mask (acc only).
// cls and the outputs are addressed by (lane, step) strides in elements; one
// of cls's strides must be 1. class_of: NULL (cls holds class ids), or the
// (256,) byte-to-class map, and cls holds raw bytes (cls_bytes 1).
extern "C" int dfa_chain(const void* cls, int cls_bytes, long long cls_ls, long long cls_ss,
                         const int* table, const unsigned char* accept, int C, int S,
                         const int* entries, int nb, int steps, int* finals, int* states,
                         unsigned char* acc, long long out_ls, long long out_ss,
                         const unsigned char* class_of, void* stream) {
  DfaArgs a = dfa_args(cls, cls_ls, cls_ss, class_of, table, accept, C, S, entries, nb, steps,
                       finals);
  a.states = states;
  a.acc = acc;
  a.out_ls = out_ls;
  a.out_ss = out_ss;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (states && !acc) return (int)cudaErrorInvalidValue;
  if (states) return dispatch<FULL>(a, cls_bytes, st);
  if (acc) return dispatch<MASK>(a, cls_bytes, st);
  return dispatch<FINALS>(a, cls_bytes, st);
}

// K2: finals plus counts[stream, state] += accept visits, where lane n
// belongs to stream n / lanes_per_stream. counts must be zeroed by the caller.
// class_of as in dfa_chain.
extern "C" int dfa_chain_counts(const void* cls, int cls_bytes, long long cls_ls,
                                long long cls_ss, const int* table,
                                const unsigned char* accept, int C, int S,
                                const int* entries, int nb, int steps, int* finals,
                                int* counts, int lanes_per_stream,
                                const unsigned char* class_of, void* stream) {
  DfaArgs a = dfa_args(cls, cls_ls, cls_ss, class_of, table, accept, C, S, entries, nb, steps,
                       finals);
  a.counts = counts;
  a.lanes_per_stream = lanes_per_stream;
  a.n_streams = (nb + lanes_per_stream - 1) / lanes_per_stream;
  return dispatch<COUNTS>(a, cls_bytes, static_cast<cudaStream_t>(stream));
}

// Where a launch keeps its data: bits 0-1 = the table's route (0 global
// memory, 1 shared uint32 entries, 2 shared uint16 entries), bits 2-3 = the
// histogram of counts mode (0 atomics on global memory, 1 a shared row per
// stream, 2 a shared row per lane), bits 4-7 = the windows in the staging
// ring. mode: 0 finals, 1 full, 2 mask, 3 counts. mapped: a launch given
// the byte-to-class map.
extern "C" int dfa_chain_route(int mode, int cls_bytes, int C, int S, int nb,
                               int lanes_per_stream, int mapped) {
  const Plan p = plan(mode, cls_bytes, C, S, nb, lanes_per_stream, mapped != 0);
  return p.route | (p.hist << 2) | (p.ring << 4);
}

// Chain lanes (threads) per CTA.
extern "C" int dfa_chain_lanes_per_cta() { return LANES; }
