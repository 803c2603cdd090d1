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
// the previous load, so a lane is bound by the latency of its table load,
// not by device-memory bandwidth (the class stream is 1 byte per step and is
// read once). With few lanes (the lazy NFA path runs 1,024 lanes of 4,096
// steps) the chain of one lane is the floor: steps x load latency.
//
// What the design does about it:
//   - The table sits in shared memory whenever it can: as int32 when that
//     fits beside the staging tiles, else narrowed to uint16 (S <= 65,535;
//     a Snort lazy-DFA snapshot of (83, 1025) takes 170 KB). A zero entry
//     after it is where every state and class outside the table steps, so
//     a step selects its index and loads, with no predicate on the load.
//     Entries outside [0, 65535) are stored as 0xFFFF, which steps like
//     them (to the zero entry), and are re-read from the int32 table only
//     where a state is emitted, so corrupt tables give exactly the plain
//     version's output. Only a table that fits in neither form is read
//     through the read-only cache (L2 latency on every step). The table is
//     filled with 16-byte loads.
//   - Class ids are staged in a ring of two windows of WIN steps, filled by
//     cp.async: window w+1 is in flight while the lanes step through window
//     w. Each lane row (steps contiguous) or step row (lanes contiguous) is
//     copied as the 16-byte aligned chunks that cover it, so any element
//     size and offset stays asynchronous; the consumer skips the leading
//     misalignment. cp.async rather than TMA: the rows are short (32-512
//     bytes) and may start anywhere, while a TMA tensor copy needs 16-byte
//     aligned strides and a tensor map built on the host for every call.
//   - A window's class ids go to registers first (as the offset of their
//     table row), so no class load or address arithmetic sits on the chain;
//     a step's accept bit (full, mask, counts) is stored or counted one step
//     later, so that nothing waiting on the accept load holds up, in issue
//     order, the next table load.
//   - One thread per lane, 128 lanes per CTA: a narrower CTA would use more
//     SMs but each CTA fills the whole table with fewer threads, and the
//     chain of one lane does not get shorter.
//
// No float GEMM: the TPU kernel looked T up with a one-hot matrix product in
// bf16/f32; here T is read directly, so no TF32 or bf16 rounding can touch a
// state id.
#include "chain_common.cuh"

using namespace chain;

namespace {

enum Mode { FINALS = 0, FULL = 1, MASK = 2, COUNTS = 3 };
enum Route { GLOBAL = 0, SMEM32 = 1, SMEM16 = 2 };  // where the table lives
constexpr int NARROW_INVALID = 0xFFFF;  // a uint16 entry to re-read as int32 (emitted())

struct DfaArgs {
  const void* cls;
  long long cls_ls, cls_ss;
  const int* table;
  const unsigned char* accept;
  int C, S;
  const int* entries;
  int nb, steps;
  int* finals;
  int* states;
  unsigned char* acc;
  long long out_ls, out_ss;
  int* counts;
  int lanes_per_stream, n_streams, hist_rows;  // hist_rows == 0: global atomics
};

// One staged window of class ids: rows of 16-byte chunks. With steps
// contiguous (ss == 1) a row is one lane's WIN steps; with lanes contiguous
// (ls == 1) a row is one step's LANES lanes. A row's run of bytes may start
// anywhere, so it takes up to one chunk more than its length.
__host__ __device__ constexpr int chunks_sf(int es) { return (15 + WIN * es + 15) / 16; }
__host__ __device__ constexpr int chunks_lf(int es) { return (15 + LANES * es + 15) / 16; }
__host__ __device__ constexpr int stage_bytes(int es) {
  return LANES * chunks_sf(es) > WIN * chunks_lf(es) ? LANES * chunks_sf(es) * 16
                                                      : WIN * chunks_lf(es) * 16;
}

struct Layout {
  size_t ring, states, acc, table, accept, hist, total;
};

__host__ __device__ inline Layout layout(int mode, int cls_bytes, int C, int S, int route,
                                         int hist_rows) {
  Layout L;
  size_t off = 0;
  L.ring = off;
  off += 2 * (size_t)stage_bytes(cls_bytes);
  L.states = off;
  if (mode == FULL) off += align16(sizeof(int) * LANES * PITCH);
  L.acc = off;
  if (mode == FULL || mode == MASK) off += align16((size_t)LANES * BPITCH);
  L.table = off;  // C * S entries and a zero one after them: see fill_table()
  const size_t entries = (size_t)C * S + 1;
  if (route == SMEM32) off += align16(sizeof(int) * entries);
  if (route == SMEM16) off += align16(sizeof(uint16_t) * entries);
  L.accept = off;
  if (route != GLOBAL) off += align16((size_t)S + 1);
  L.hist = off;
  off += align16(sizeof(int) * (size_t)hist_rows * S);
  L.total = off;
  return L;
}

struct Plan {
  int route;
  int hist_rows;
  size_t smem;
};

// The table in shared memory first (int32, then uint16), then the histogram
// rows a CTA can touch.
Plan plan(int mode, int cls_bytes, int C, int S, int n_streams, int lanes_per_stream) {
  const size_t limit = (size_t)smem_optin_bytes();
  int rows = 0;
  if (mode == COUNTS) {
    rows = (LANES - 1) / lanes_per_stream + 2;
    if (rows > n_streams) rows = n_streams;
  }
  const int routes[3] = {SMEM32, SMEM16, GLOBAL};
  for (int r : routes) {
    if (r == SMEM16 && S > 65535) continue;
    const int hists[2] = {rows, 0};
    for (int h : hists) {
      const Layout L = layout(mode, cls_bytes, C, S, r, h);
      if (L.total <= limit) return Plan{r, h, L.total};
    }
  }
  return Plan{GLOBAL, 0, layout(mode, cls_bytes, C, S, GLOBAL, 0).total};
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of the window of n steps at w0 into buf. Every 16-byte
// chunk copied holds at least one byte of the window, and a chunk never
// crosses the 16-byte aligned granule of the allocation it lies in.
template <typename CT>
__device__ __forceinline__ void issue_window(unsigned char* buf, const DfaArgs& a, int lane0,
                                             int w0, int n) {
  constexpr int ES = sizeof(CT);
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.cls);
  const bool steps_fast = a.cls_ss == 1;
  const int ch = steps_fast ? chunks_sf(ES) : chunks_lf(ES);
  const int rows = steps_fast ? LANES : WIN;
  const int nl = min(LANES, a.nb - lane0);
  for (int e = threadIdx.x; e < rows * ch; e += LANES) {
    const int r = e / ch, q = e % ch;
    uintptr_t start, len;
    if (steps_fast) {
      if (r >= nl) continue;
      start = base + (uintptr_t)(((long long)(lane0 + r) * a.cls_ls + w0) * ES);
      len = (uintptr_t)n * ES;
    } else {
      if (r >= n) continue;
      start = base + (uintptr_t)(((long long)(w0 + r) * a.cls_ss + lane0) * ES);
      len = (uintptr_t)nl * ES;
    }
    const uintptr_t chunk = (start & ~uintptr_t(15)) + (uintptr_t)q * 16;
    if (chunk < start + len)
      cp_async16(buf + (size_t)(r * ch + q) * 16, reinterpret_cast<const void*>(chunk));
  }
}

template <int ROUTE>
__device__ __forceinline__ int table_at(const void* t, int k) {
  if (ROUTE == SMEM32) return static_cast<const int*>(t)[k];
  return static_cast<const uint16_t*>(t)[k];
}

// hist[state] += 1 when hit, as one predicated reduction: no branch on the
// chain (the address may be shared or global memory).
__device__ __forceinline__ void count_if(unsigned hit, int* p) {
  asm volatile(
      "{\n .reg .pred h;\n setp.ne.u32 h, %0, 0;\n @h red.add.u32 [%1], 1;\n}\n" ::"r"(hit),
      "l"(p)
      : "memory");
}

// The state a lane emits (in full mode, and as its final state): on the
// uint16 route NARROW_INVALID stands for an entry that uint16 cannot hold,
// re-read from the int32 table at the index it came from (idx < 0: the
// state is the lane's entry, not a table entry). The chain itself steps
// from NARROW_INVALID exactly as from the original entry: both are outside
// [0, S), since S <= 65,535 on that route.
template <int ROUTE>
__device__ __forceinline__ int emitted(int state, int idx, const int* __restrict__ g) {
  if (ROUTE == SMEM16 && state == NARROW_INVALID && idx >= 0) return __ldg(g + idx);
  return state;
}

__device__ __forceinline__ unsigned short narrow(int v) {
  return (unsigned short)(v >= 0 && v < NARROW_INVALID ? v : NARROW_INVALID);
}

// Copy the (C * S) int32 table into shared memory, as int32 or narrowed,
// and a zero entry after it (index C * S), where every state or class
// outside the table steps: a step selects its index and loads, with no
// predicate on the load.
template <int ROUTE>
__device__ void fill_table(void* dst, const int* __restrict__ src, int total) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = total >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(src);
#pragma unroll 8
    for (int k = threadIdx.x; k < n4; k += LANES) {
      const int4 v = __ldg(s4 + k);
      if (ROUTE == SMEM32)
        static_cast<int4*>(dst)[k] = v;
      else
        static_cast<ushort4*>(dst)[k] = make_ushort4(narrow(v.x), narrow(v.y), narrow(v.z),
                                                     narrow(v.w));
    }
    done = n4 << 2;
  }
  for (int k = done + threadIdx.x; k <= total; k += LANES) {
    const int v = k < total ? __ldg(src + k) : 0;
    if (ROUTE == SMEM32)
      static_cast<int*>(dst)[k] = v;
    else
      static_cast<uint16_t*>(dst)[k] = narrow(v);
  }
}

// Step one lane through n steps of a staged window. The lane's class id of
// step j is at buf + a0 + j * pitch + ((mis0 + j * mis_step) & 15) (the
// last term is the misalignment of a step row when lanes are contiguous; 0
// when steps are). All the window's class ids are read into registers
// first, so the chain of dependent table loads carries no other load and no
// branch. idx is the table index the state came from (see emitted()).
template <typename CT, int MODE, int ROUTE, bool FULL_WIN>
__device__ __forceinline__ int run_window(int state, int& idx, int n, const unsigned char* buf,
                                          int a0, int pitch, int mis0, int mis_step,
                                          const void* tab, const unsigned char* acc_of,
                                          const DfaArgs& a, int* s_states,
                                          unsigned char* s_acc, int* hist) {
  const int C = a.C, S = a.S;
  int row[WIN];  // each step's c * S, or -1 for a class outside the table
#pragma unroll
  for (int j = 0; j < WIN; ++j) {
    if (FULL_WIN || j < n) {
      const int c = (int)*reinterpret_cast<const CT*>(buf + a0 + j * pitch +
                                                      ((mis0 + j * mis_step) & 15));
      row[j] = (unsigned)c < (unsigned)C ? c * S : -1;
    }
  }
  const int zero = C * S;  // the shared table's zero entry
  // Each step's accept bit is used one step later: a store or reduction
  // that waits on the accept load would hold up, in issue order, the next
  // step's table load.
  unsigned hit_prev = 0;
  int state_prev = 0;
#pragma unroll
  for (int j = 0; j < WIN; ++j) {
    if (!FULL_WIN && j >= n) break;
    int next_idx, next;
    unsigned hit = 0;
    if (ROUTE == GLOBAL) {
      const bool valid = (unsigned)state < (unsigned)S;
      next_idx = row[j] + state;
      next = valid && row[j] >= 0 ? __ldg(a.table + next_idx) : 0;
      if (MODE != FINALS) hit = valid ? __ldg(acc_of + state) : 0;
    } else {
      const bool valid = (unsigned)state < (unsigned)S;
      next_idx = valid && row[j] >= 0 ? row[j] + state : zero;
      next = table_at<ROUTE>(tab, next_idx);
      if (MODE != FINALS) hit = acc_of[valid ? state : S];  // acc_of[S] == 0
    }
    if (MODE == FULL) s_states[threadIdx.x * PITCH + j] = emitted<ROUTE>(state, idx, a.table);
    if (j > 0) {
      if (MODE == FULL || MODE == MASK) s_acc[threadIdx.x * BPITCH + j - 1] = hit_prev;
      if (MODE == COUNTS) count_if(hit_prev, hist + state_prev);
    }
    hit_prev = hit;
    state_prev = state;
    idx = next_idx;
    state = next;
  }
  const int last = (FULL_WIN ? WIN : n) - 1;
  if (MODE == FULL || MODE == MASK) s_acc[threadIdx.x * BPITCH + last] = hit_prev;
  if (MODE == COUNTS) count_if(hit_prev, hist + state_prev);
  return state;
}

template <typename CT, int MODE, int ROUTE>
__global__ void __launch_bounds__(LANES) dfa_chain_kernel(DfaArgs a) {
  constexpr int ES = sizeof(CT);
  constexpr int STAGE = stage_bytes(ES);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(MODE, sizeof(CT), a.C, a.S, ROUTE, a.hist_rows);
  unsigned char* ring = smem + L.ring;
  int* s_states = reinterpret_cast<int*>(smem + L.states);
  unsigned char* s_acc = smem + L.acc;
  int* s_hist = reinterpret_cast<int*>(smem + L.hist);
  const int S = a.S;
  const int lane0 = blockIdx.x * LANES;
  const int lane = lane0 + threadIdx.x;
  const bool live = lane < a.nb;
  const bool steps_fast = a.cls_ss == 1;
  const int n_win = (a.steps + WIN - 1) / WIN;

  // window 0 is in flight while the table fills
  if (n_win > 0) issue_window<CT>(ring, a, lane0, 0, min(WIN, a.steps));
  cp_async_commit();

  const void* tab = a.table;
  const unsigned char* acc_of = a.accept;
  if (ROUTE != GLOBAL) {
    void* t = smem + L.table;
    unsigned char* ac = smem + L.accept;
    fill_table<ROUTE>(t, a.table, a.C * S);
    for (int k = threadIdx.x; k <= S; k += LANES) ac[k] = k < S ? a.accept[k] : 0;
    tab = t;
    acc_of = ac;
  }
  if (MODE == COUNTS)
    for (int k = threadIdx.x; k < a.hist_rows * S; k += LANES) s_hist[k] = 0;

  int state = live ? a.entries[lane] : 0;
  int idx = -1;
  int* hist = nullptr;
  int stream0 = 0;
  if (MODE == COUNTS) {
    stream0 = lane0 / a.lanes_per_stream;
    const int stream = live ? lane / a.lanes_per_stream : stream0;
    hist = a.hist_rows ? s_hist + (size_t)(stream - stream0) * S
                       : a.counts + (size_t)stream * S;
  }
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.cls);

  for (int w = 0; w < n_win; ++w) {
    const int w0 = w * WIN;
    const int n = min(WIN, a.steps - w0);
    if (w + 1 < n_win)
      issue_window<CT>(ring + ((w + 1) & 1) * STAGE, a, lane0, w0 + WIN,
                       min(WIN, a.steps - w0 - WIN));
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of window w have landed
    __syncthreads();     // everyone's have (and the table is filled)
    if (live) {
      const unsigned char* buf = ring + (w & 1) * STAGE;
      int a0, pitch, mis0 = 0, mis_step = 0;
      if (steps_fast) {  // the lane's row, from its misalignment on
        const uintptr_t start = base + (uintptr_t)(((long long)lane * a.cls_ls + w0) * ES);
        a0 = threadIdx.x * chunks_sf(ES) * 16 + (int)(start & 15);
        pitch = ES;
      } else {  // the lane's column of the step rows
        mis0 = (int)((base + (uintptr_t)(((long long)w0 * a.cls_ss + lane0) * ES)) & 15);
        mis_step = (int)((a.cls_ss * ES) & 15);
        a0 = threadIdx.x * ES;
        pitch = chunks_lf(ES) * 16;
      }
      if (n == WIN)
        state = run_window<CT, MODE, ROUTE, true>(state, idx, n, buf, a0, pitch, mis0,
                                                  mis_step, tab, acc_of, a, s_states, s_acc,
                                                  hist);
      else
        state = run_window<CT, MODE, ROUTE, false>(state, idx, n, buf, a0, pitch, mis0,
                                                   mis_step, tab, acc_of, a, s_states, s_acc,
                                                   hist);
    }
    if (MODE == FULL || MODE == MASK) {
      __syncthreads();
      if (MODE == FULL)
        store_window<int, PITCH>(a.states, s_states, a.out_ls, a.out_ss, lane0, a.nb, w0, n);
      store_window<unsigned char, BPITCH>(a.acc, s_acc, a.out_ls, a.out_ss, lane0, a.nb, w0, n);
    }
    __syncthreads();  // window w is read before its buffer takes window w+2
  }
  if (live) a.finals[lane] = emitted<ROUTE>(state, idx, a.table);

  if (MODE == COUNTS && a.hist_rows) {
    __syncthreads();
    for (int k = threadIdx.x; k < a.hist_rows * S; k += LANES) {
      const int v = s_hist[k];
      const int stream = stream0 + k / S;
      if (v && stream < a.n_streams) atomicAdd(a.counts + (size_t)stream * S + k % S, v);
    }
  }
}

template <typename CT, int MODE>
int launch(const DfaArgs& a, cudaStream_t st) {
  const Plan p = plan(MODE, sizeof(CT), a.C, a.S, a.n_streams, a.lanes_per_stream);
  DfaArgs b = a;
  b.hist_rows = p.hist_rows;
  switch (p.route) {
    case SMEM32: return launch_chain(dfa_chain_kernel<CT, MODE, SMEM32>, b, b.nb, p.smem, st);
    case SMEM16: return launch_chain(dfa_chain_kernel<CT, MODE, SMEM16>, b, b.nb, p.smem, st);
  }
  return launch_chain(dfa_chain_kernel<CT, MODE, GLOBAL>, b, b.nb, p.smem, st);
}

template <int MODE>
int dispatch(const DfaArgs& a, int cls_bytes, cudaStream_t st) {
  // the staging copies rows along the contiguous axis (the wrapper makes
  // one stride 1)
  if (a.cls_ss != 1 && a.cls_ls != 1) return (int)cudaErrorInvalidValue;
  switch (cls_bytes) {
    case 1: return launch<uint8_t, MODE>(a, st);
    case 2: return launch<int16_t, MODE>(a, st);
    case 4: return launch<int32_t, MODE>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K1: finals (states == acc == NULL), full (both set) or mask (acc only).
// cls and the outputs are addressed by (lane, step) strides in elements; one
// of cls's strides must be 1.
extern "C" int dfa_chain(const void* cls, int cls_bytes, long long cls_ls, long long cls_ss,
                         const int* table, const unsigned char* accept, int C, int S,
                         const int* entries, int nb, int steps, int* finals, int* states,
                         unsigned char* acc, long long out_ls, long long out_ss,
                         void* stream) {
  DfaArgs a = {};
  a.cls = cls;
  a.cls_ls = cls_ls;
  a.cls_ss = cls_ss;
  a.table = table;
  a.accept = accept;
  a.C = C;
  a.S = S;
  a.entries = entries;
  a.nb = nb;
  a.steps = steps;
  a.finals = finals;
  a.states = states;
  a.acc = acc;
  a.out_ls = out_ls;
  a.out_ss = out_ss;
  a.lanes_per_stream = 1;
  a.n_streams = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (states && !acc) return (int)cudaErrorInvalidValue;
  if (states) return dispatch<FULL>(a, cls_bytes, st);
  if (acc) return dispatch<MASK>(a, cls_bytes, st);
  return dispatch<FINALS>(a, cls_bytes, st);
}

// K2: finals plus counts[stream, state] += accept visits, where lane n
// belongs to stream n / lanes_per_stream. counts must be zeroed by the caller.
extern "C" int dfa_chain_counts(const void* cls, int cls_bytes, long long cls_ls,
                                long long cls_ss, const int* table,
                                const unsigned char* accept, int C, int S,
                                const int* entries, int nb, int steps, int* finals,
                                int* counts, int lanes_per_stream, void* stream) {
  DfaArgs a = {};
  a.cls = cls;
  a.cls_ls = cls_ls;
  a.cls_ss = cls_ss;
  a.table = table;
  a.accept = accept;
  a.C = C;
  a.S = S;
  a.entries = entries;
  a.nb = nb;
  a.steps = steps;
  a.finals = finals;
  a.counts = counts;
  a.lanes_per_stream = lanes_per_stream;
  a.n_streams = (nb + lanes_per_stream - 1) / lanes_per_stream;
  return dispatch<COUNTS>(a, cls_bytes, static_cast<cudaStream_t>(stream));
}

// Where a launch keeps its data: bits 0-1 = the table's route (0 global
// memory, 1 shared int32, 2 shared uint16), bit 2 = histogram in shared
// memory (counts mode). mode: 0 finals, 1 full, 2 mask, 3 counts.
extern "C" int dfa_chain_route(int mode, int cls_bytes, int C, int S, int nb,
                               int lanes_per_stream) {
  const int n_streams = (nb + lanes_per_stream - 1) / lanes_per_stream;
  const Plan p = plan(mode, cls_bytes, C, S, n_streams, lanes_per_stream);
  return p.route | (p.hist_rows ? 4 : 0);
}

// Chain lanes (threads) per CTA.
extern "C" int dfa_chain_lanes_per_cta() { return LANES; }
