// K6, pass 1 of the exact DFA fallback: the transition function of every
// block, written by hand for Hopper (sm_90a).
//
// Replaces the XLA loop regex_fpga_tpu/ops/dfa_engine.py::
// block_transition_functions (lax.scan over the block's bytes, all S start
// states as one vector), which the JAX package never wrote in Pallas.
//
// What it computes: for block n of the (NB, B) class ids and every start
// state s, f[n, s] = the state after the block's B bytes when it is entered
// in s: NB * S independent chains of B dependent table loads. A class
// outside [0, C) steps to state 0, as in dfa_chain.cu; the wrapper has
// checked that every table entry lies in [0, S), so every state stays in
// range.
//
// What bounds it on this card: NB * S * B table loads, S times the work of a
// chain pass over the same bytes (56e9 loads for a 64 MiB chunk at S = 836),
// against (NB * B + C * S) * 4 bytes in and NB * S * 4 out. Neither
// device-memory bytes nor a peak arithmetic rate come near: the loads
// from shared memory do (about 32 a clock an SM).
//
// What the design does about it (a simple kernel that is right first):
//   - The table sits in shared memory as uint16 entries (S < 65,536) or
//     uint32 ones, with a zero row C where an out-of-range class leads; it
//     is filled once per CTA: the grid is as large as the card holds at once
//     and every CTA loops over rounds of blocks. Only a table that fits in
//     neither form is read from global memory through the read-only cache.
//   - A round stages the class ids of `group` blocks in shared memory once
//     (rows padded to an odd number of words, so that lanes of different
//     blocks read different banks); its lanes are the (block, start state)
//     pairs, so a small S still fills the CTA (S = 23: 44 blocks a round at
//     most, 16 by the staging limit).
//   - Each thread walks CHAINS start states side by side: their loads are
//     independent, so a warp has CHAINS loads in flight per step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHAINS = 4;                // start states a thread walks side by side
constexpr int LANES = THREADS * CHAINS;  // (block, start state) pairs a round walks at once
constexpr int STAGE_MAX = 16384;         // bytes of staged class ids per round
constexpr int MAX_CTAS_PER_SM = 2048 / THREADS;

enum Route { GLOBAL = 0, SMEM32 = 1, SMEM16 = 2 };

inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Bytes of a staged row of B class ids: an odd number of 32-bit words.
__host__ __device__ inline int row_pitch(int B) { return (((B + 3) / 4) | 1) * 4; }

int device_attr(cudaDeviceAttr attr, int fallback) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return fallback;
  if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) return fallback;
  return v;
}

struct Args {
  const uint8_t* cls;  // (nb, B) class ids, rows contiguous
  const int* table;    // (C, S) int32, entries in [0, S)
  int C, S, nb, B;
  int* out;            // (nb, S) int32
  int group;           // blocks per round
  size_t stage;        // bytes of the staging area (the table follows it)
};

struct Plan {
  int route, group, grid;
  size_t smem;
};

Plan plan(int C, int S, int nb, int B) {
  Plan p;
  const int pitch = row_pitch(B);
  int group = S >= LANES ? 1 : LANES / S;
  const int by_stage = STAGE_MAX / pitch > 0 ? STAGE_MAX / pitch : 1;
  if (group > by_stage) group = by_stage;
  if (group > nb) group = nb > 0 ? nb : 1;
  p.group = group;
  const size_t stage = align16((size_t)group * pitch);
  const size_t limit = (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 48 * 1024);
  const size_t t16 = align16(sizeof(uint16_t) * ((size_t)C + 1) * S);
  const size_t t32 = align16(sizeof(uint32_t) * ((size_t)C + 1) * S);
  if (S < 65536 && stage + t16 <= limit) {
    p.route = SMEM16, p.smem = stage + t16;
  } else if (stage + t32 <= limit) {
    p.route = SMEM32, p.smem = stage + t32;
  } else {
    p.route = GLOBAL, p.smem = stage;
  }
  const size_t per_sm = (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerMultiprocessor, 48 * 1024);
  int resident = (int)(per_sm / (p.smem + 1024));  // 1 KB a CTA is the system's
  if (resident > MAX_CTAS_PER_SM) resident = MAX_CTAS_PER_SM;
  if (resident < 1) resident = 1;
  const int rounds = (nb + group - 1) / group;
  const int most = device_attr(cudaDevAttrMultiProcessorCount, 1) * resident;
  p.grid = rounds < most ? rounds : most;
  return p;
}

template <int ROUTE>
struct Entry {
  using type = uint32_t;
};
template <>
struct Entry<SMEM16> {
  using type = uint16_t;
};

template <int ROUTE>
__global__ void __launch_bounds__(THREADS) block_fns_kernel(Args a) {
  using ET = typename Entry<ROUTE>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_cls = smem;
  ET* s_tab = reinterpret_cast<ET*>(smem + a.stage);
  const int C = a.C, S = a.S, B = a.B;
  const int pitch = row_pitch(B);

  if (ROUTE != GLOBAL) {
    for (int k = threadIdx.x; k < C * S; k += THREADS) s_tab[k] = (ET)__ldg(a.table + k);
    for (int s = threadIdx.x; s < S; s += THREADS) s_tab[C * S + s] = 0;
  }
  const int rounds = (a.nb + a.group - 1) / a.group;
  for (int r = blockIdx.x; r < rounds; r += gridDim.x) {
    const int n0 = r * a.group;
    const int blocks = min(a.group, a.nb - n0);
    __syncthreads();  // the previous round has read its class ids (and the table is filled)
    const uint8_t* src = a.cls + (size_t)n0 * B;
    for (int k = threadIdx.x; k < blocks * B; k += THREADS) {
      const int g = k / B;
      const int c = __ldg(src + k);
      s_cls[g * pitch + (k - g * B)] = (unsigned char)(c < C ? c : C);
    }
    __syncthreads();
    const int lanes = blocks * S;
    for (int l0 = threadIdx.x; l0 < lanes; l0 += LANES) {
      int st[CHAINS], row[CHAINS];
#pragma unroll
      for (int u = 0; u < CHAINS; ++u) {
        const int l = l0 + u * THREADS;
        const int g = l < lanes ? l / S : 0;
        st[u] = l < lanes ? l - g * S : 0;
        row[u] = g * pitch;
      }
      for (int t = 0; t < B; ++t) {
#pragma unroll
        for (int u = 0; u < CHAINS; ++u) {
          const int c = s_cls[row[u] + t];
          if (ROUTE == GLOBAL)
            st[u] = c < C ? __ldg(a.table + (size_t)c * S + st[u]) : 0;
          else
            st[u] = s_tab[c * S + st[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < CHAINS; ++u) {
        const int l = l0 + u * THREADS;
        if (l < lanes) a.out[(size_t)n0 * S + l] = st[u];
      }
    }
  }
}

template <int ROUTE>
int launch(const Args& a, const Plan& p, cudaStream_t st) {
  auto kernel = block_fns_kernel<ROUTE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  if (p.grid > 0) kernel<<<p.grid, THREADS, p.smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K6 pass 1: out[n, s] = the state after block n of cls (nb rows of B uint8
// class ids, contiguous) entered in state s; out is (nb, S) int32. Every
// entry of table (C, S) int32 must lie in [0, S).
extern "C" int dfa_block_fns(const uint8_t* cls, const int* table, int C, int S, int nb, int B,
                             int* out, void* stream) {
  if (C < 1 || C > 256 || S < 1 || B < 1 || nb < 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(C, S, nb, B);
  const size_t limit = (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 48 * 1024);
  if (p.smem > limit) return (int)cudaErrorInvalidValue;  // a row of B ids does not fit
  Args a = {cls, table, C, S, nb, B, out, p.group, align16((size_t)p.group * row_pitch(B))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.route) {
    case SMEM16: return launch<SMEM16>(a, p, st);
    case SMEM32: return launch<SMEM32>(a, p, st);
  }
  return launch<GLOBAL>(a, p, st);
}

// Where a launch keeps its table (bits 0-1: 0 global memory, 1 shared
// uint32 entries, 2 shared uint16 entries) and the blocks of a round (bits
// 2 and up).
extern "C" int dfa_block_fns_route(int C, int S, int nb, int B) {
  const Plan p = plan(C, S, nb, B);
  return p.route | (p.group << 2);
}
