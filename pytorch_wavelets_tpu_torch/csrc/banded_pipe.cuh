// The staging shared by K1 (banded_apply.cu) and K17 (banded_apply_tc.cu):
// the walk over an output tile's contraction segments, and a ring of
// shared-memory stages filled by asynchronous copies.
//
// Tiles.  An output tile is TT rows of the operator T (the tile of the
// per-tile segment table, ops/banded.py:_band_plan) by TX positions of the
// other side (the columns of a plane for the column entry, the rows of X
// for the row entry), contracted in stages of BK values of k.  A stage
// never reads across a segment's end: the step that reaches a segment's
// end copies zeros past it, and the next step starts at the next segment.
//
// Copies.  Each stage of each operand is copied from global to shared
// memory by cp.async, which carries the data without the threads'
// registers, COPY bytes at a time: 16 where the operand's base pointer and
// strides are 16-byte aligned, 4 where they are not (any fp32 view, and a
// bf16 view at an even element offset), and for a bf16 view at an odd
// element offset (2-byte aligned, which cp.async does not take) plain
// 2-byte loads and shared stores into the same ring.  The wrapper
// (ops/banded.py:_copy_bytes) chooses COPY from the pointers and strides,
// passes it, and counts each; the C entries check it.  A chunk that is
// partly past the data's edge copies only its valid bytes and zero-fills
// the rest (cp.async's src-size), so no copy reads out of bounds.
//
// The ring holds STAGES stages; the copies of stage s + STAGES - 1 are in
// flight while stage s computes, with one barrier a stage:
//   wait for my copies of stage s; barrier (every copy of s has landed,
//   and every warp is done with s - 1); issue the copies of
//   s + STAGES - 1 into s - 1's slot; compute s.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace banded {

// The planning sizes, checked against ops/banded.py's when each library
// loads: 64 T rows per output tile (the segment table's tile), segment
// starts at multiples of 16.  Timed on the card against 128 rows and
// 32-aligned starts on the products of the main, banded, scat_j2 and
// swt_main paths, both kernels: 64 rows skip more of a banded operator
// (128 lost most on the banded cell, and K17's 128-row tile spills), and
// 16-aligned starts skip more than 32; 64 x 16 was the fastest, or level
// with the fastest, on every group of products (PERF.md section 6).
constexpr int TT = 64;        // T rows per output tile (the segment table)
constexpr int TX = 128;       // the other side of an output tile
constexpr int BK = 32;        // k depth of a stage (K17's bf16: 2 BK)
constexpr int K_ALIGN = 16;   // segment starts are multiples of this
static_assert(K_ALIGN % 8 == 0, "segment starts keep 16-byte copies aligned");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of BYTES (16: .cg, L2 only; 4: .ca) of which the first
// src_bytes are read and the rest zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy a ROWS x COLS tile (row r at g + r * ld, COLS contiguous elements)
// into s (row stride LD) with THREADS threads: entries at r >= rows or
// c >= cols are zero.  COPY: bytes a copy (16 or 4: cp.async; 2: plain
// loads of one bf16 element).
template <typename E, int COPY, int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_tile(E* s, const E* g, long long ld,
                                          int rows, int cols) {
  constexpr int VEC = COPY / static_cast<int>(sizeof(E));
  static_assert(VEC >= 1 && COLS % VEC == 0, "copy width");
  constexpr int CPR = COLS / VEC;           // copies a row
  constexpr int N = ROWS * CPR;
  static_assert(N % THREADS == 0, "copies a thread");
#pragma unroll
  for (int it = 0; it < N / THREADS; ++it) {
    const int idx = it * THREADS + static_cast<int>(threadIdx.x);
    const int r = idx / CPR, c = (idx % CPR) * VEC;
    int n = r < rows ? cols - c : 0;
    n = n < 0 ? 0 : (n > VEC ? VEC : n);
    E* dst = s + r * LD + c;
    const E* src = n > 0 ? g + r * ld + c : g;
    if constexpr (COPY >= 4) {
      cp_async<COPY>(dst, src, n * static_cast<int>(sizeof(E)));
    } else {  // 2-byte elements at odd offsets: a plain load
      static_assert(sizeof(E) == 2, "plain loads are for bf16");
      const unsigned short v =
          n > 0 ? *reinterpret_cast<const unsigned short*>(src) : 0;
      *reinterpret_cast<unsigned short*>(dst) = v;
    }
  }
}

// The steps of one output tile: its segments [k0, k1) of T's columns
// (segs[2 s], segs[2 s + 1] for s in seg_ptr[tile] .. seg_ptr[tile + 1]),
// each cut into stages of STEP values of k; kb is a step's first k, k1
// its segment's end.
template <int STEP>
struct Steps {
  const int* __restrict__ segs;
  int s, s1, kb, k1;

  __device__ __forceinline__ Steps(const int* __restrict__ seg_ptr,
                                   const int* __restrict__ segs_, int tile)
      : segs(segs_), s(seg_ptr[tile]), s1(seg_ptr[tile + 1]), kb(0), k1(0) {
    if (s < s1) {
      kb = segs[2 * s];
      k1 = segs[2 * s + 1];
    }
  }

  __device__ __forceinline__ int count() const {
    int n = 0;
    for (int t = s; t < s1; ++t)
      n += (segs[2 * t + 1] - segs[2 * t] + STEP - 1) / STEP;
    return n;
  }

  __device__ __forceinline__ void next() {
    kb += STEP;
    if (kb >= k1 && ++s < s1) {
      kb = segs[2 * s];
      k1 = segs[2 * s + 1];
    }
  }
};

// Run the ring over a tile's steps: load(slot, kb, k1) issues one stage's
// copies, compute(slot) consumes a landed stage.  Returns the number of
// steps (0: the tile of T is all zero).  Ends with a barrier, so the ring
// may be refilled at once (the column entries' next plane).
template <int STAGES, int STEP, typename Load, typename Compute>
__device__ __forceinline__ int run_ring(Steps<STEP> w, Load&& load,
                                        Compute&& compute) {
  static_assert(STAGES >= 3, "a ring of at least three stages");
  const int n = w.count();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n) {
      load(st, w.kb, w.k1);
      w.next();
    }
    cp_async_commit();
  }
  for (int step = 0; step < n; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int ahead = step + STAGES - 1;
    if (ahead < n) {
      load(ahead % STAGES, w.kb, w.k1);
      w.next();
    }
    cp_async_commit();
    compute(step % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();
  return n;
}

// Whether p and every stride (in elements of `bytes_per`) keep `align`
// bytes of alignment.
inline bool aligned(const void* p, long long bytes_per, int align,
                    long long s0, long long s1 = 0) {
  return reinterpret_cast<uintptr_t>(p) % align == 0 &&
         (s0 * bytes_per) % align == 0 && (s1 * bytes_per) % align == 0;
}

// Grid of a launch: T-row tiles fastest (blockIdx.x % n_t), so the tiles
// of T that read one tile of X run side by side and find it in L2.
inline dim3 grid_of(int n_t, long long n_x, int planes) {
  return dim3(static_cast<unsigned>(n_t * n_x),
              static_cast<unsigned>(planes < 65535 ? planes : 65535), 1);
}

// The dynamic shared memory above 48 KB, allowed once per kernel and
// device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && (done >> dev) & 1u) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  return e;
}

}  // namespace banded
