// Shared pieces of the chain-pass kernels (dfa_chain.cu, kgram_chain.cu).
//
// A chain pass runs NB independent lanes over a (lanes x steps) grid of
// elements (class ids, or the k raw bytes of a k-gram step). Lane n steps
// through its own row; its element (n, t) sits at
// src[n * lane_stride + t * step_stride], so one kernel serves both the
// time-major (B, NB) columns of the public chain-pass functions and the
// block-major (NB, B) rows of a stream cut into blocks, without a transpose.
//
// One thread carries one lane. Each CTA takes LANES consecutive lanes and
// stages their elements in a ring of 2, 4 or 8 windows of WIN steps, filled
// by cp.async: the windows after w are in flight while the lanes step
// through window w (ring_depth() says how many).
// Each lane row (steps contiguous) or step row (lanes contiguous) is copied
// as the 16-byte aligned chunks that cover it, so any element size and
// offset stays asynchronous; the consumer skips the leading misalignment.
// cp.async rather than TMA: the rows are short (32-1,024 bytes) and may
// start anywhere, while a TMA tensor copy needs 16-byte aligned strides and
// a tensor map built on the host for every call. The per-step outputs are
// staged in shared memory too and stored coalesced (store_window).
//
// Tables in shared memory are stored padded and sanitized (see
// dfa_chain.cu): an entry is the byte offset of the next state's column, a
// state or class outside the table selects a zero column or row, and a step
// is mask, add, load, with no range check on the chain of dependent loads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace chain {

constexpr int LANES = 128;       // chain lanes (threads) per CTA
constexpr int WIN = 32;          // steps staged per window
constexpr int PITCH = WIN + 1;   // int32 row pitch of a staged tile: odd, so the
                                 // 32 lanes of a warp reading one column hit
                                 // 32 different banks
constexpr int BPITCH = WIN + 4;  // byte row pitch: 9 words, odd for the same reason

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// The entries in a row of a padded shared-memory table of S states and the
// zero column: S + 1, rounded up until a row is an odd number of 32-bit
// words. The lanes of a warp mostly sit in a few states and differ in their
// class, that is in the row they read: with an odd pitch 32 neighbouring
// rows of one column lie in 32 different banks, with the tokenizer's 24
// words its 10 rows share 4.
__host__ __device__ inline int row_entries(int S, int entry_bytes) {
  const int per_word = 4 / entry_bytes;
  int words = (S + 1 + per_word - 1) / per_word;
  words |= 1;
  return words * per_word;
}

// The elements a chain pass reads: (lane, step) strides in elements of ES
// bytes; one of the strides is 1, and the base is aligned to ES.
struct Source {
  const void* p;
  long long ls, ss;
  int nb, steps;
};

// One staged window: rows of 16-byte chunks. With steps contiguous (ss == 1)
// a row is one lane's WIN steps; with lanes contiguous (ls == 1) a row is one
// step's LANES lanes. A row's run of bytes may start anywhere, so it takes up
// to one chunk more than its length.
__host__ __device__ constexpr int chunks_sf(int es) { return (15 + WIN * es + 15) / 16; }
__host__ __device__ constexpr int chunks_lf(int es) { return (15 + LANES * es + 15) / 16; }
__host__ __device__ constexpr int stage_bytes(int es) {
  return LANES * chunks_sf(es) > WIN * chunks_lf(es) ? LANES * chunks_sf(es) * 16
                                                      : WIN * chunks_lf(es) * 16;
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

// Where this thread's lane finds its elements in a staged window: element j
// is at buf + a0 + j * pitch + ((mis0 + j * mis_step) & 15). The last term is
// the misalignment of a step row when lanes are contiguous; 0 when steps are.
struct WindowAddr {
  int a0, pitch, mis0, mis_step;
};

// The staging copies of one thread. A thread copies the same chunks of
// every window, so where each chunk's row begins is worked out once; a
// window then costs an add, a mask and a compare per chunk. With steps
// contiguous a thread copies the chunks of its own lane's row and nobody
// else's: what it reads it has copied itself, cp.async.wait_group alone
// orders the two, and the CTA needs no barrier between windows
// (cooperative() is false). With lanes contiguous a step row belongs to all
// lanes, the threads share its chunks out (chunk e = thread + i * LANES),
// and a barrier follows the wait. Every 16-byte chunk copied holds at least
// one byte of the window, and a chunk never crosses the 16-byte aligned
// granule of the allocation it lies in.
template <int ES>
struct Stager {
  static constexpr int CH_SF = chunks_sf(ES), CH_LF = chunks_lf(ES);
  static constexpr int N_SF = CH_SF;  // LANES rows of CH_SF chunks over LANES threads
  static constexpr int N_LF = (WIN * CH_LF + LANES - 1) / LANES;
  static constexpr int N = N_SF > N_LF ? N_SF : N_LF;
  uintptr_t row0[N];  // where chunk i's row begins in window 0; 0: no such row
  long long advance;  // bytes from a window's rows to the next window's
  int row_bytes;      // bytes of a step row (lanes contiguous)
  int mis0, mis_win, mis_step;  // see addr()
  unsigned whole;     // steps contiguous: bit i, chunk i is part of a window of WIN steps
  bool steps_fast;

  __device__ __forceinline__ Stager(const Source& a, int lane0) {
    const uintptr_t base = reinterpret_cast<uintptr_t>(a.p);
    steps_fast = a.ss == 1;
    const int nl = min(LANES, a.nb - lane0);
    row_bytes = nl * ES;
    advance = (steps_fast ? 1 : a.ss) * (long long)(WIN * ES);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = chunk_index(i);
      if (steps_fast) {
        row0[i] = i < N_SF && (int)threadIdx.x < nl
                      ? base + (uintptr_t)((long long)(lane0 + threadIdx.x) * a.ls * ES) : 0;
      } else {
        const int r = e / CH_LF;
        row0[i] = e < WIN * CH_LF ? base + (uintptr_t)(((long long)r * a.ss + lane0) * ES) : 0;
      }
    }
    whole = 0;
    if (steps_fast) {
      mis0 = (int)((base + (uintptr_t)((long long)(lane0 + threadIdx.x) * a.ls * ES)) & 15);
      mis_win = (WIN * ES) & 15;
      mis_step = 0;
#pragma unroll
      for (int i = 0; i < N_SF; ++i)
        if (row0[i] && (row0[i] & ~uintptr_t(15)) + (uintptr_t)i * 16 < row0[i] + WIN * ES)
          whole |= 1u << i;
    } else {
      mis0 = (int)((base + (uintptr_t)((long long)lane0 * ES)) & 15);
      mis_step = (int)((a.ss * ES) & 15);
      mis_win = (WIN * mis_step) & 15;
    }
  }

  // Whether threads read what other threads copied.
  __device__ __forceinline__ bool cooperative() const { return !steps_fast; }

  // The place of this thread's copy i among the window's chunks.
  __device__ __forceinline__ int chunk_index(int i) const {
    return steps_fast ? threadIdx.x * CH_SF + i : threadIdx.x + i * LANES;
  }

  // Start the copy of window w, of n steps, into buf.
  __device__ __forceinline__ void start(unsigned char* buf, int w, int n) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (!row0[i]) continue;
      const int e = chunk_index(i);
      int q;
      uintptr_t len;
      if (steps_fast) {
        q = i;
        len = (uintptr_t)(n * ES);
      } else {
        if (e / CH_LF >= n) continue;
        q = e % CH_LF;
        len = (uintptr_t)row_bytes;
      }
      const uintptr_t start = row0[i] + (uintptr_t)(w * advance);
      const uintptr_t chunk = (start & ~uintptr_t(15)) + (uintptr_t)q * 16;
      if (chunk < start + len)
        cp_async16(buf + (size_t)e * 16, reinterpret_cast<const void*>(chunk));
    }
  }

  // The same for a window of WIN steps when steps are contiguous: a window
  // advances every row by WIN * ES bytes, a multiple of 16, so a thread's
  // chunks keep their place and their part in the window (`whole`).
  __device__ __forceinline__ void start_whole(unsigned char* buf, int w) const {
    const uintptr_t adv = (uintptr_t)(w * advance);
#pragma unroll
    for (int i = 0; i < N_SF; ++i) {
      const uintptr_t start = row0[i] + adv;
      if (whole & (1u << i))
        cp_async16(buf + (size_t)(threadIdx.x * CH_SF + i) * 16,
                   reinterpret_cast<const void*>((start & ~uintptr_t(15)) + (uintptr_t)i * 16));
    }
  }

  // Where this thread's lane finds its elements in window w, once staged.
  __device__ __forceinline__ WindowAddr addr(int w) const {
    WindowAddr wa;
    const int mis = (mis0 + w * mis_win) & 15;
    if (steps_fast) {
      wa.a0 = threadIdx.x * CH_SF * 16 + mis;
      wa.pitch = ES;
      wa.mis0 = 0;
      wa.mis_step = 0;
    } else {
      wa.a0 = threadIdx.x * ES;
      wa.pitch = CH_LF * 16;
      wa.mis0 = mis;
      wa.mis_step = mis_step;
    }
    return wa;
  }
};

// How a kernel steps through a window (its run_window()). HOT_SF and HOT_LF: a window of WIN steps
// followed by another one, in straight-line code with no predicate (steps
// contiguous in the source, or lanes); EDGE: any window, its n steps and
// the n_next steps after it (0: the last window) under predicates.
enum Path { EDGE = 0, HOT_SF = 1, HOT_LF = 2 };

// Element j of the lane in a staged window. STEPS_FAST: known at compile
// time that steps are contiguous, so the element sits j elements on.
template <typename CT, bool STEPS_FAST = false>
__device__ __forceinline__ CT staged(const unsigned char* buf, const WindowAddr& w, int j) {
  if (STEPS_FAST) return *reinterpret_cast<const CT*>(buf + w.a0 + j * (int)sizeof(CT));
  return *reinterpret_cast<const CT*>(buf + w.a0 + j * w.pitch +
                                      ((w.mis0 + j * w.mis_step) & 15));
}

// A table entry from shared memory, by its 32-bit shared address. As PTX, so
// that a uint16 entry lands zero-extended in a 32-bit register with no
// conversion on the chain; not volatile: the table does not change once
// filled, and the compiler may schedule the load freely.
template <typename ET>
__device__ __forceinline__ unsigned table_entry(unsigned addr) {
  unsigned v;
  if (sizeof(ET) == 2)
    asm("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(addr));
  else
    asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// Store the (LANES x n) window tile[i * P + j] to dst so that neighbouring
// threads write neighbouring addresses whichever stride is 1.
template <typename T, int P>
__device__ __forceinline__ void store_window(T* __restrict__ dst, const T* tile,
                                             long long ls, long long ss, int lane0,
                                             int nb, int w0, int n) {
  const bool steps_fast = (ss == 1);
  for (int e = threadIdx.x; e < LANES * WIN; e += LANES) {
    const int i = steps_fast ? e / WIN : e % LANES;
    const int j = steps_fast ? e % WIN : e / LANES;
    const int lane = lane0 + i;
    if (lane < nb && j < n)
      dst[(long long)lane * ls + (long long)(w0 + j) * ss] = tile[i * P + j];
  }
}

inline int device_attr(cudaDeviceAttr attr, int fallback) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return fallback;
  if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) return fallback;
  return v;
}

inline int smem_optin_bytes() {
  return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 48 * 1024);
}

// How many CTAs of a chain kernel an SM holds at once, as far as shared
// memory decides it, and how many the grid needs there to be resident all at
// once (one wave), up to the most that the registers allow.
struct Residency {
  size_t limit, per_sm;
  int sms, max_ctas;
  explicit Residency(int max_ctas_per_sm)
      : limit((size_t)smem_optin_bytes()),
        per_sm((size_t)device_attr(cudaDevAttrMaxSharedMemoryPerMultiprocessor, 48 * 1024)),
        sms(device_attr(cudaDevAttrMultiProcessorCount, 1)),
        max_ctas(max_ctas_per_sm) {}
  int resident(size_t smem) const {  // 0: a CTA of `smem` bytes cannot launch
    if (smem > limit) return 0;
    const size_t n = per_sm / (smem + 1024);  // 1 KB a CTA is the system's
    return n < (size_t)max_ctas ? (int)n : max_ctas;
  }
  int wanted(int nb) const {
    const int grid = (nb + LANES - 1) / LANES;
    const int n = (grid + sms - 1) / sms;
    return n < max_ctas ? n : max_ctas;
  }
};

// How many windows the staging ring holds. A window's copy must be under
// way for about a device-memory latency (over a microsecond for a lane's
// 16-byte chunks, each from its own row) before the lanes need it, and a
// window's chain takes less than half of that: with a ring of two, a CTA
// alone on its SM waits for memory between any two windows. So the ring is
// as deep as shared memory allows (8, 4 or 2 windows; base: the bytes of
// everything but the ring), without taking a CTA off an SM that the grid
// needs there: other resident CTAs hide the latency as well, and a grid
// that is resident at once runs in one wave.
inline int ring_depth(const Residency& res, size_t base, int stage, int nb) {
  const int with_two = res.resident(base + 2 * (size_t)stage);
  const int want = res.wanted(nb) < with_two ? res.wanted(nb) : with_two;
  for (int ring = 8; ring > 2; ring >>= 1) {
    const int n = res.resident(base + (size_t)ring * stage);
    if (n > 0 && n >= want) return ring;
  }
  return 2;
}

// cp.async.wait_group for window w+1 of a ring of `ring` windows, one group
// committed per window: all but the newest ring - 2 groups have landed.
__device__ __forceinline__ void wait_next_window(int ring) {
  if (ring == 8)
    cp_async_wait<6>();
  else if (ring == 4)
    cp_async_wait<2>();
  else
    cp_async_wait<0>();
}

// Launch `kernel` over ceil(nb / LANES) CTAs with `smem` bytes of dynamic
// shared memory; returns the CUDA error code (0 on success). table_in_l1:
// the kernel reads its table from global memory through the L1 cache.
template <typename K, typename A>
inline int launch_chain(K kernel, const A& args, int nb, size_t smem, cudaStream_t st,
                        bool table_in_l1 = false) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  // A table read through the read-only cache lives on the L1 hits of its
  // hot rows: leave the cache all of the SM that the resident CTAs' shared
  // memory does not need. Shared-memory tables take the default split.
  int carveout = cudaSharedmemCarveoutDefault;
  if (table_in_l1) {
    const Residency res(1 << 20);
    const size_t need = (size_t)res.wanted(nb) * (smem + 1024);
    carveout = (int)((need * 100 + res.per_sm - 1) / res.per_sm);
    if (carveout > 100) carveout = 100;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  if (e != cudaSuccess) return (int)e;
  const int grid = (nb + LANES - 1) / LANES;
  if (grid > 0) kernel<<<grid, LANES, smem, st>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace chain
