// K3: the k-gram chain pass, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel regex_fpga_tpu/ops/pallas_kgram.py::_kernel (and
// its packed (C, 128) table layout, pack_ta128) and the XLA pass it stood in
// for, the lax.scan of regex_fpga_tpu/ops/kgram.py::dfa_scan_kgram; with raw
// bytes in, also the class mapping that ran in native host code there
// (regex_fpga_tpu/ops/kgram.py::map_kgram_classes).
//
// What it computes: NB independent chains over k-gram class ids; at each
// step lane n does
//     (state, total) <- (T_k[c, state], total + A_k[c, state])
// and returns its final state and its accept total. A state or class
// outside the table steps to state 0 and adds nothing, which is what the
// one-hot lookup of the JAX engines does. Unlike the TPU kernel there is no
// limit of 64 states. With raw bytes in, a step's class c is first derived
// from its k = 2^levels bytes: class_of[byte] for each, then one pair map
// per level (c <- map[c_left * C_level + c_right]).
//
// What bounds it on this card: as for dfa_chain.cu, a dependent chain of
// table loads, latency-bound on the shared-memory load of each step; each
// step consumes k bytes of text, so the per-byte rate is k times the step
// rate.
//
// What the design does about it:
//   - A narrow table in shared memory, packed once per automaton on the
//     host (hopper_kgram.pack_ta): (C + 1) rows of (S + 1) uint16 or uint32
//     entries, each row padded to an odd number of words (row_entries(): the
//     rows of a column then lie in different banks), the byte offset of the
//     next state's column in the low bits and the step's accept count above
//     them, with a zero row and a zero column where every class or state
//     outside the table leads, and T_k entries outside [0, S) stored as
//     column S (re-read from the wide table only for a lane's final state).
//     A step on the chain is mask, add, load; the count is shifted out and
//     added off the chain. The tokenizer's k=4 table (221 x 23) takes
//     11.5 KB instead of 40.7 KB.
//   - The same staging and window loop as dfa_chain.cu (chain_common.cuh):
//     a cp.async ring of up to 8 windows, each thread copying its own
//     lane's chunks where steps are contiguous; the next window's steps go
//     to registers, as row offsets, inside the chain's loop, one block of
//     straight-line code.
//   - Raw bytes in (k > 1): the ring stages the text itself, k bytes a
//     step, and class_of and the pair maps sit in shared memory as uint16;
//     each step's class is derived while the window goes to registers, off
//     the chain, so neither a class-id tensor nor its mapping passes touch
//     device memory.
//   - A table that the narrow form cannot hold (counts or S too large, or
//     too big for shared memory) is read as one int2 (T_k, A_k) per step
//     through the read-only cache, with the range checks on the chain; that
//     route takes class ids only.
//
// No float GEMM: the TPU kernel packed T_k and A_k into a bf16 one-hot
// matrix product; here both are read directly as integers.
#include "chain_common.cuh"

using namespace chain;

namespace {

constexpr int MAX_LEVELS = 3;  // k = 2, 4 or 8 bytes a step
constexpr int CTAS_PER_SM = 4;  // at 128 registers a lane: 65,536 lanes (512 CTAs) are
                                // resident at once on 132 SMs

struct KgramArgs {
  Source src;          // class ids, or k-gram steps of k bytes each
  const void* narrow;  // (C + 1, S + 1) entries, or nullptr
  int narrow_bytes;    // 2 or 4
  int cshift;          // entry = count << cshift | column byte offset
  const int2* wide;    // (C, S) (T_k, A_k)
  int C, S;
  const uint16_t* maps;  // class_of (256), then each level's pair map
  int maps_len;
  int level_classes[MAX_LEVELS];
  const int* entries;
  int* finals;
  int* totals;
  int ring;  // windows in the staging ring: 2, 4 or 8
};

struct Layout {
  size_t ring, table, maps, total;
};

// The narrow table as the host packs it: (C + 1) rows of row_entries()
// entries.
__host__ __device__ inline size_t narrow_table_bytes(int C, int S, int narrow_bytes) {
  return narrow_bytes ? (size_t)narrow_bytes * ((size_t)C + 1) * row_entries(S, narrow_bytes) : 0;
}

__host__ __device__ inline Layout layout(int es, int C, int S, int narrow_bytes,
                                         int maps_len, int ring) {
  Layout L;
  L.ring = 0;
  L.table = (size_t)ring * stage_bytes(es);
  L.maps = L.table + align16(narrow_table_bytes(C, S, narrow_bytes));
  L.total = L.maps + align16(sizeof(uint16_t) * (size_t)maps_len);
  return L;
}

bool narrow_fits(int es, int C, int S, int narrow_bytes, int maps_len) {
  return narrow_bytes > 0 &&
         layout(es, C, S, narrow_bytes, maps_len, 2).total <= (size_t)smem_optin_bytes();
}

// The staging ring's depth for the narrow kernel (chain_common.cuh).
int narrow_ring(int es, int C, int S, int narrow_bytes, int maps_len, int nb) {
  return ring_depth(Residency(CTAS_PER_SM), layout(es, C, S, narrow_bytes, maps_len, 0).total,
                    stage_bytes(es), nb);
}

__device__ __forceinline__ void copy16(void* dst, const void* src, size_t bytes) {
  // both 16-byte aligned (torch allocations and the layout's offsets);
  // bytes is rounded up inside the layout's padding
  const int4* s = static_cast<const int4*>(src);
  int4* d = static_cast<int4*>(dst);
  for (size_t k = threadIdx.x; k < (bytes + 15) / 16; k += LANES) d[k] = __ldg(s + k);
}

// The k-gram class of the K bytes in w (the first byte lowest).
template <int K>
__device__ __forceinline__ int map_class(unsigned long long w, const uint16_t* maps,
                                         const int* level_classes) {
  int c[K];
#pragma unroll
  for (int i = 0; i < K; ++i) c[i] = maps[(w >> (8 * i)) & 0xFF];
  int off = 256;
#pragma unroll
  for (int n = K, lvl = 0; n > 1; n >>= 1, ++lvl) {
    const int cl = level_classes[lvl];
#pragma unroll
    for (int i = 0; i < n / 2; ++i) c[i] = maps[off + c[2 * i] * cl + c[2 * i + 1]];
    off += cl * cl;
  }
  return c[0];
}

// The byte offset of a step's table row (row C for a class outside the
// table). CT: the staged element, a class id when K == 1, else the K bytes
// of a step, mapped to their class here, off the chain.
template <typename CT, int K>
__device__ __forceinline__ int row_of(CT e, const uint16_t* maps, const KgramArgs& a,
                                      int pitch) {
  const int c = K > 1 ? map_class<K>((unsigned long long)e, maps, a.level_classes) : (int)e;
  return (int)min((unsigned)c, (unsigned)a.C) * pitch;
}

// Step one lane through a window whose rows are in registers, and read the
// next window's steps from the ring into those registers as it goes (row[j]
// is free once step j has used it): mask, add, load on the chain; the next
// window's loads and lookups and the count, shifted out of the entry, are
// independent of it and fill the time it waits. from: the byte offset the
// carried entry was loaded from.
template <typename CT, typename ET, int K, int PATH>
__device__ __forceinline__ unsigned run_window(unsigned cur, int& from, unsigned& total, int n,
                                               int n_next, int (&row)[WIN],
                                               const unsigned char* next_buf,
                                               const WindowAddr& next_wa, unsigned tab,
                                               const uint16_t* maps, const KgramArgs& a,
                                               int pitch, unsigned cmask, int cshift) {
  constexpr bool HOT = PATH != EDGE;
#pragma unroll
  for (int j = 0; j < WIN; ++j) {
    const int r = row[j];
    if (HOT || j < n_next)
      row[j] = row_of<CT, K>(staged<CT, PATH == HOT_SF>(next_buf, next_wa, j), maps, a, pitch);
    if (!HOT && j >= n) continue;
    from = r + (int)(cur & cmask);
    cur = table_entry<ET>(tab + (unsigned)from);
    total += cur >> cshift;
  }
  return cur;
}

// ET: the narrow table's entry.
template <typename CT, typename ET, int K>
__global__ void __launch_bounds__(LANES, CTAS_PER_SM) kgram_narrow_kernel(KgramArgs a) {
  constexpr int ES = sizeof(CT);
  constexpr int STAGE = stage_bytes(ES);
  constexpr int SH = sizeof(ET) == 2 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(ES, a.C, a.S, sizeof(ET), a.maps_len, a.ring);
  unsigned char* ring = smem + L.ring;
  const unsigned tab = (unsigned)__cvta_generic_to_shared(smem + L.table);
  const uint16_t* maps = reinterpret_cast<const uint16_t*>(smem + L.maps);
  const int C = a.C, S = a.S;
  const int lane0 = blockIdx.x * LANES;
  const int lane = lane0 + threadIdx.x;
  const bool live = lane < a.src.nb;
  const int steps = a.src.steps;
  const int n_win = (steps + WIN - 1) / WIN;

  // the ring's first windows are in flight while the table and the maps fill
  const Stager<ES> stager(a.src, lane0);
  auto steps_of = [&](int w) { return min(WIN, steps - w * WIN); };
  const int ring_mask = a.ring - 1;
  for (int w = 0; w < a.ring; ++w) {
    if (w < n_win) stager.start(ring + w * STAGE, w, steps_of(w));
    cp_async_commit();
  }
  copy16(smem + L.table, a.narrow, narrow_table_bytes(C, S, sizeof(ET)));
  if (K > 1) copy16(smem + L.maps, a.maps, sizeof(uint16_t) * (size_t)a.maps_len);

  const unsigned cmask = (1u << a.cshift) - 1u;
  const int cshift = a.cshift;
  const int entry = live ? a.entries[lane] : 0;
  unsigned cur = (unsigned)min((unsigned)entry, (unsigned)S) << SH;
  int from = -1;  // the byte offset cur was loaded from
  unsigned total = 0;

  // The windows are pipelined as in dfa_chain.cu: while a lane steps through
  // window w out of its registers, window w+1 goes from the ring to
  // registers (and, for raw text, through the maps) and the copies of the
  // windows after it are in flight; no barrier between windows when steps
  // are contiguous.
  const int pitch = row_entries(S, sizeof(ET)) << SH;
  int row[WIN];
  wait_next_window(a.ring);  // this thread's copies of window 0 have landed
  __syncthreads();           // everyone's have, and the table and maps are filled
  {
    const WindowAddr wa = stager.addr(0);
#pragma unroll
    for (int j = 0; j < WIN; ++j)
      row[j] = live && j < steps ? row_of<CT, K>(staged<CT>(ring, wa, j), maps, a, pitch) : 0;
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
      if (hot && stager.steps_fast)
        cur = run_window<CT, ET, K, HOT_SF>(cur, from, total, n, n_next, row, buf, wa, tab, maps,
                                            a, pitch, cmask, cshift);
      else if (hot)
        cur = run_window<CT, ET, K, HOT_LF>(cur, from, total, n, n_next, row, buf, wa, tab, maps,
                                            a, pitch, cmask, cshift);
      else
        cur = run_window<CT, ET, K, EDGE>(cur, from, total, n, n_next, row, buf, wa, tab, maps,
                                          a, pitch, cmask, cshift);
    }
  }
  if (live) {
    int state = (int)((cur & cmask) >> SH);
    if (from < 0) {
      state = entry;
    } else if (state == S) {  // a T_k entry outside [0, S): the wide table has it
      const int e = from >> SH, P = row_entries(S, sizeof(ET)), c = e / P;
      state = __ldg(&a.wide[c * S + (e - c * P)].x);
    }
    a.finals[lane] = state;
    a.totals[lane] = (int)total;
  }
}

// The table as int2 (T_k, A_k) through the read-only cache, class ids only;
// a ring of two windows (each step waits on L2 in any case).
template <typename CT>
__global__ void __launch_bounds__(LANES) kgram_wide_kernel(KgramArgs a) {
  constexpr int ES = sizeof(CT);
  constexpr int STAGE = stage_bytes(ES);
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, S = a.S;
  const int lane0 = blockIdx.x * LANES;
  const int lane = lane0 + threadIdx.x;
  const bool live = lane < a.src.nb;
  const int steps = a.src.steps;
  const int n_win = (steps + WIN - 1) / WIN;

  const Stager<ES> stager(a.src, lane0);
  if (n_win > 0) stager.start(smem, 0, min(WIN, steps));
  cp_async_commit();
  int state = live ? a.entries[lane] : 0;
  int total = 0;
  for (int w = 0; w < n_win; ++w) {
    const int n = min(WIN, steps - w * WIN);
    if (w + 1 < n_win)
      stager.start(smem + ((w + 1) & 1) * STAGE, w + 1, min(WIN, steps - (w + 1) * WIN));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // window w has landed
    if (live) {
      const unsigned char* buf = smem + (w & 1) * STAGE;
      const WindowAddr wa = stager.addr(w);
      int row[WIN];  // c * S, or -1 for a class outside the table
#pragma unroll
      for (int j = 0; j < WIN; ++j) {
        if (j < n) {
          const int c = (int)staged<CT>(buf, wa, j);
          row[j] = (unsigned)c < (unsigned)C ? c * S : -1;
        }
      }
#pragma unroll
      for (int j = 0; j < WIN; ++j) {
        if (j >= n) break;
        int2 v = make_int2(0, 0);
        if ((unsigned)state < (unsigned)S && row[j] >= 0) v = __ldg(a.wide + row[j] + state);
        state = v.x;
        total += v.y;
      }
    }
    __syncthreads();  // window w is read before its buffer takes window w+2
  }
  if (live) {
    a.finals[lane] = state;
    a.totals[lane] = total;
  }
}

template <typename CT, int K>
int launch_narrow(const KgramArgs& a, cudaStream_t st) {
  KgramArgs b = a;
  b.ring = narrow_ring(sizeof(CT), a.C, a.S, a.narrow_bytes, a.maps_len, a.src.nb);
  const size_t smem = layout(sizeof(CT), a.C, a.S, a.narrow_bytes, a.maps_len, b.ring).total;
  if (a.narrow_bytes == 2)
    return launch_chain(kgram_narrow_kernel<CT, uint16_t, K>, b, b.src.nb, smem, st);
  return launch_chain(kgram_narrow_kernel<CT, uint32_t, K>, b, b.src.nb, smem, st);
}

template <typename CT>
int launch_wide(const KgramArgs& a, cudaStream_t st) {
  return launch_chain(kgram_wide_kernel<CT>, a, a.src.nb, 2 * (size_t)stage_bytes(sizeof(CT)),
                      st, true);
}

}  // namespace

// One pass over class ids (k == 1; elem_bytes 1, 2 or 4: uint8, int16,
// int32) or over raw text (k == 2, 4 or 8 bytes a step; elem_bytes == k).
// The source is addressed by (lane, step) strides in elements, one of them
// 1, its base aligned to elem_bytes. narrow: the (C + 1, S + 1) packed table
// of narrow_bytes (2 or 4) an entry, or NULL; wide: (C, S) int2 = (T_k,
// A_k). The narrow table is used when it fits in shared memory (with the
// maps, for raw text); raw text without it is refused. maps: class_of (256
// entries) followed by each level's pair map, uint16, 16-byte aligned.
// finals and totals are (NB,) int32.
extern "C" int kgram_chain(const void* src, int elem_bytes, long long ls, long long ss, int k,
                           const void* narrow, int narrow_bytes, int cshift, const int* wide,
                           int C, int S, const void* maps, int maps_len, int classes0,
                           int classes1, int classes2, const int* entries, int nb, int steps,
                           int* finals, int* totals, void* stream) {
  KgramArgs a = {};
  a.src = Source{src, ls, ss, nb, steps};
  a.narrow = narrow;
  a.narrow_bytes = narrow ? narrow_bytes : 0;
  a.cshift = cshift;
  a.wide = reinterpret_cast<const int2*>(wide);
  a.C = C;
  a.S = S;
  a.maps = static_cast<const uint16_t*>(maps);
  a.maps_len = k > 1 ? maps_len : 0;
  a.level_classes[0] = classes0;
  a.level_classes[1] = classes1;
  a.level_classes[2] = classes2;
  a.entries = entries;
  a.finals = finals;
  a.totals = totals;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((ls != 1 && ss != 1) || C < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const bool fits = narrow_fits(elem_bytes, C, S, a.narrow_bytes, a.maps_len);
  if (k > 1) {
    if (!fits || elem_bytes != k || !maps) return (int)cudaErrorInvalidValue;
    switch (k) {
      case 2: return launch_narrow<uint16_t, 2>(a, st);
      case 4: return launch_narrow<uint32_t, 4>(a, st);
      case 8: return launch_narrow<unsigned long long, 8>(a, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (elem_bytes) {
    case 1: return fits ? launch_narrow<uint8_t, 1>(a, st) : launch_wide<uint8_t>(a, st);
    case 2: return fits ? launch_narrow<int16_t, 1>(a, st) : launch_wide<int16_t>(a, st);
    case 4: return fits ? launch_narrow<int32_t, 1>(a, st) : launch_wide<int32_t>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Bit 0: 1 when a pass with these shapes keeps the narrow table (and, for
// raw text, the maps) in shared memory, 0 when it reads the wide table from
// global memory (class ids) or is refused (raw text); bits 4-7: the windows
// in the staging ring. narrow_bytes 0: the automaton has no narrow form.
extern "C" int kgram_chain_route(int elem_bytes, int C, int S, int narrow_bytes,
                                 int maps_len, int nb) {
  if (!narrow_fits(elem_bytes, C, S, narrow_bytes, maps_len)) return 2 << 4;
  return 1 | (narrow_ring(elem_bytes, C, S, narrow_bytes, maps_len, nb) << 4);
}
