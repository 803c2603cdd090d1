// K3: the k-gram chain pass, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel regex_fpga_tpu/ops/pallas_kgram.py::_kernel (and
// its packed (C, 128) table layout, pack_ta128) and the XLA pass it stood in
// for, the lax.scan of regex_fpga_tpu/ops/kgram.py::dfa_scan_kgram.
//
// What it computes: NB independent chains over k-gram class ids; at each
// step lane n does
//     (state, total) <- (T_k[c, state], total + A_k[c, state])
// and returns its final state and its accept total. T_k and A_k are read
// interleaved as one int2 per (class, state), so a step is one 8-byte load.
// A state or class outside the table steps to state 0 and adds nothing,
// which is what the one-hot lookup of the JAX engines does. Unlike the TPU
// kernel there is no limit of 64 states.
//
// What bounds it on this card: as for dfa_chain.cu, a dependent chain of
// table loads, latency-bound on the shared-memory (or L1) load of each step;
// each step consumes k bytes of text, so the per-byte rate is k times the
// step rate. One thread per lane and many CTAs per SM hide the latency; the
// table sits in shared memory when it fits and is read through the read-only
// cache otherwise; class windows are staged through shared memory.
//
// No float GEMM: the TPU kernel packed T_k and A_k into a bf16 one-hot
// matrix product; here both are read directly as int32.
#include "chain_common.cuh"

using namespace chain;

namespace {

struct KgramArgs {
  const void* cls;
  long long cls_ls, cls_ss;
  const int2* ta;
  int C, S;
  const int* entries;
  int nb, steps;
  int* finals;
  int* totals;
};

__host__ __device__ inline size_t table_offset() { return align16(sizeof(int) * LANES * PITCH); }

size_t smem_bytes(int C, int S, bool smem_table) {
  return table_offset() + (smem_table ? align16(sizeof(int2) * (size_t)C * S) : 0);
}

bool table_fits(int C, int S) { return smem_bytes(C, S, true) <= (size_t)smem_optin_bytes(); }

template <typename CT, bool SMEM_TABLE>
__global__ void __launch_bounds__(LANES) kgram_chain_kernel(KgramArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_cls = reinterpret_cast<int*>(smem);
  const int C = a.C, S = a.S;
  const int2* ta = a.ta;
  if (SMEM_TABLE) {
    int2* t = reinterpret_cast<int2*>(smem + table_offset());
    for (int k = threadIdx.x; k < C * S; k += LANES) t[k] = a.ta[k];
    ta = t;
  }

  const int lane0 = blockIdx.x * LANES;
  const int lane = lane0 + threadIdx.x;
  const bool live = lane < a.nb;
  int state = live ? a.entries[lane] : 0;
  int total = 0;
  const CT* cls = static_cast<const CT*>(a.cls);

  for (int w0 = 0; w0 < a.steps; w0 += WIN) {
    const int n = min(WIN, a.steps - w0);
    __syncthreads();  // the previous window is consumed (and the table staged)
    load_window<CT>(s_cls, cls, a.cls_ls, a.cls_ss, lane0, a.nb, w0, n);
    __syncthreads();
    if (live) {
      const int* row = s_cls + threadIdx.x * PITCH;
      for (int j = 0; j < n; ++j) {
        const int c = row[j];
        int2 v = make_int2(0, 0);
        if ((unsigned)state < (unsigned)S && (unsigned)c < (unsigned)C)
          v = table_load<SMEM_TABLE>(ta, c * S + state);
        state = v.x;
        total += v.y;
      }
    }
  }
  if (live) {
    a.finals[lane] = state;
    a.totals[lane] = total;
  }
}

template <typename CT>
int launch(const KgramArgs& a, cudaStream_t st) {
  if (table_fits(a.C, a.S))
    return launch_chain(kgram_chain_kernel<CT, true>, a, a.nb, smem_bytes(a.C, a.S, true), st);
  return launch_chain(kgram_chain_kernel<CT, false>, a, a.nb, smem_bytes(a.C, a.S, false), st);
}

}  // namespace

// ta: (C, S) int2 = (T_k, A_k); cls addressed by (lane, step) strides in
// elements; finals and totals are (NB,) int32.
extern "C" int kgram_chain(const void* cls, int cls_bytes, long long cls_ls, long long cls_ss,
                           const int* ta, int C, int S, const int* entries, int nb,
                           int steps, int* finals, int* totals, void* stream) {
  KgramArgs a = {};
  a.cls = cls;
  a.cls_ls = cls_ls;
  a.cls_ss = cls_ss;
  a.ta = reinterpret_cast<const int2*>(ta);
  a.C = C;
  a.S = S;
  a.entries = entries;
  a.nb = nb;
  a.steps = steps;
  a.finals = finals;
  a.totals = totals;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cls_bytes) {
    case 1: return launch<uint8_t>(a, st);
    case 2: return launch<int16_t>(a, st);
    case 4: return launch<int32_t>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// 1 when the table sits in shared memory, 0 when it is read from global memory.
extern "C" int kgram_chain_route(int C, int S) { return table_fits(C, S) ? 1 : 0; }
