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
// the previous load, so a lane is latency-bound on the shared-memory (or L1)
// load of T, not on device-memory bandwidth: the class stream is 1 byte per
// step and the table is read from on-chip memory. The design hides the
// latency with lanes in flight: one thread per lane, 128 lanes per CTA and as
// many CTAs per SM as shared memory allows. The table sits in shared memory
// when it fits beside the staging tiles and is read through the read-only
// cache otherwise; class windows and per-step outputs pass through shared
// memory so that device-memory traffic is coalesced in either layout.
//
// No float GEMM: the TPU kernel looked T up with a one-hot matrix product in
// bf16/f32; here T is read directly as int32, so no TF32 or bf16 rounding can
// touch a state id.
#include "chain_common.cuh"

using namespace chain;

namespace {

enum Mode { FINALS = 0, FULL = 1, MASK = 2, COUNTS = 3 };

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

struct Layout {
  size_t cls, states, acc, table, accept, hist, total;
};

__host__ __device__ inline Layout layout(int mode, int C, int S, bool smem_table,
                                         int hist_rows) {
  Layout L;
  size_t off = 0;
  L.cls = off;
  off += align16(sizeof(int) * LANES * PITCH);
  L.states = off;
  if (mode == FULL) off += align16(sizeof(int) * LANES * PITCH);
  L.acc = off;
  if (mode == FULL || mode == MASK) off += align16((size_t)LANES * BPITCH);
  L.table = off;
  if (smem_table) off += align16(sizeof(int) * (size_t)C * S);
  L.accept = off;
  if (smem_table) off += align16((size_t)S);
  L.hist = off;
  off += align16(sizeof(int) * (size_t)hist_rows * S);
  L.total = off;
  return L;
}

struct Plan {
  bool smem_table;
  int hist_rows;
  size_t smem;
};

// Table in shared memory first, then the histogram rows a CTA can touch.
Plan plan(int mode, int C, int S, int n_streams, int lanes_per_stream) {
  const size_t limit = (size_t)smem_optin_bytes();
  int rows = 0;
  if (mode == COUNTS) {
    rows = (LANES - 1) / lanes_per_stream + 2;
    if (rows > n_streams) rows = n_streams;
  }
  const bool tables[2] = {true, false};
  for (bool t : tables) {
    const int hists[2] = {rows, 0};
    for (int h : hists) {
      const Layout L = layout(mode, C, S, t, h);
      if (L.total <= limit) return Plan{t, h, L.total};
    }
  }
  return Plan{false, 0, layout(mode, C, S, false, 0).total};
}

template <typename CT, int MODE, bool SMEM_TABLE>
__global__ void __launch_bounds__(LANES) dfa_chain_kernel(DfaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(MODE, a.C, a.S, SMEM_TABLE, a.hist_rows);
  int* s_cls = reinterpret_cast<int*>(smem + L.cls);
  int* s_states = reinterpret_cast<int*>(smem + L.states);
  unsigned char* s_acc = smem + L.acc;
  int* s_hist = reinterpret_cast<int*>(smem + L.hist);
  const int C = a.C, S = a.S;

  const int* tab = a.table;
  const unsigned char* acc_of = a.accept;
  if (SMEM_TABLE) {
    int* t = reinterpret_cast<int*>(smem + L.table);
    unsigned char* ac = smem + L.accept;
    for (int k = threadIdx.x; k < C * S; k += LANES) t[k] = a.table[k];
    for (int k = threadIdx.x; k < S; k += LANES) ac[k] = a.accept[k];
    tab = t;
    acc_of = ac;
  }
  if (MODE == COUNTS)
    for (int k = threadIdx.x; k < a.hist_rows * S; k += LANES) s_hist[k] = 0;

  const int lane0 = blockIdx.x * LANES;
  const int lane = lane0 + threadIdx.x;
  const bool live = lane < a.nb;
  int state = live ? a.entries[lane] : 0;
  int* hist = nullptr;
  int stream0 = 0;
  if (MODE == COUNTS) {
    stream0 = lane0 / a.lanes_per_stream;
    const int stream = live ? lane / a.lanes_per_stream : stream0;
    hist = a.hist_rows ? s_hist + (size_t)(stream - stream0) * S
                       : a.counts + (size_t)stream * S;
  }
  const CT* cls = static_cast<const CT*>(a.cls);

  for (int w0 = 0; w0 < a.steps; w0 += WIN) {
    const int n = min(WIN, a.steps - w0);
    __syncthreads();  // the previous window's tiles are consumed and stored
    load_window<CT>(s_cls, cls, a.cls_ls, a.cls_ss, lane0, a.nb, w0, n);
    __syncthreads();
    if (live) {
      const int* row = s_cls + threadIdx.x * PITCH;
      for (int j = 0; j < n; ++j) {
        const int c = row[j];
        const bool valid = (unsigned)state < (unsigned)S;
        if (MODE == FULL) s_states[threadIdx.x * PITCH + j] = state;
        if (MODE != FINALS) {
          const unsigned char hit = valid ? table_load<SMEM_TABLE>(acc_of, state) : 0;
          if (MODE == FULL || MODE == MASK) s_acc[threadIdx.x * BPITCH + j] = hit;
          if (MODE == COUNTS && hit) atomicAdd(hist + state, 1);
        }
        state = (valid && (unsigned)c < (unsigned)C)
                    ? table_load<SMEM_TABLE>(tab, c * S + state)
                    : 0;
      }
    }
    if (MODE == FULL || MODE == MASK) {
      __syncthreads();
      if (MODE == FULL)
        store_window<int, PITCH>(a.states, s_states, a.out_ls, a.out_ss, lane0, a.nb, w0, n);
      store_window<unsigned char, BPITCH>(a.acc, s_acc, a.out_ls, a.out_ss, lane0, a.nb, w0, n);
    }
  }
  if (live) a.finals[lane] = state;

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
  const Plan p = plan(MODE, a.C, a.S, a.n_streams, a.lanes_per_stream);
  DfaArgs b = a;
  b.hist_rows = p.hist_rows;
  if (p.smem_table)
    return launch_chain(dfa_chain_kernel<CT, MODE, true>, b, b.nb, p.smem, st);
  return launch_chain(dfa_chain_kernel<CT, MODE, false>, b, b.nb, p.smem, st);
}

template <int MODE>
int dispatch(const DfaArgs& a, int cls_bytes, cudaStream_t st) {
  switch (cls_bytes) {
    case 1: return launch<uint8_t, MODE>(a, st);
    case 2: return launch<int16_t, MODE>(a, st);
    case 4: return launch<int32_t, MODE>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K1: finals (states == acc == NULL), full (both set) or mask (acc only).
// cls and the outputs are addressed by (lane, step) strides in elements.
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

// Where a launch keeps its data: bit 0 = table in shared memory, bit 1 =
// histogram in shared memory (counts mode). mode: 0 finals, 1 full, 2 mask,
// 3 counts.
extern "C" int dfa_chain_route(int mode, int C, int S, int nb, int lanes_per_stream) {
  const int n_streams = (nb + lanes_per_stream - 1) / lanes_per_stream;
  const Plan p = plan(mode, C, S, n_streams, lanes_per_stream);
  return (p.smem_table ? 1 : 0) | (p.hist_rows ? 2 : 0);
}
