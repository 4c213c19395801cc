// The index math that K6 (dwt_afb.cu) and K7 (dwt_sfb.cu) share.
//
// pad_src is B9, pytorch_wavelets_tpu/ops/pad.py:pad1d (l.28), folded into
// the kernels: the source sample that padded position i (relative to the
// signal's first sample) copies, for a length-n axis, or -1 where the mode
// pads with a zero.  The same closed form as ops/pad.py:pad_index, which
// equals numpy.pad of arange(n) at any pad size: reflections repeat with
// period 2n ('symmetric') and 2n - 2 ('reflect').
#pragma once

#include <cuda_runtime.h>

// The longest tap vector the kernels take; both vectors sit in shared memory
// (ops/afb_sfb.py:MAX_TAPS)
#define DWT_MAX_TAPS 128

// the codes of ops/pad.py:PAD_CODES
enum PadCode {
  PAD_ZERO = 0,
  PAD_SYMMETRIC = 1,
  PAD_REFLECT = 2,
  PAD_PERIODIC = 3,
  PAD_REPLICATE = 4,
};

struct DwtTaps {
  float f0[DWT_MAX_TAPS];
  float f1[DWT_MAX_TAPS];
};

__device__ __forceinline__ long long floor_mod(long long a, long long p) {
  const long long r = a % p;
  return r < 0 ? r + p : r;
}

__device__ __forceinline__ int pad_src(long long i, int n, int mode) {
  switch (mode) {
    case PAD_ZERO:
      return (i >= 0 && i < n) ? (int)i : -1;
    case PAD_SYMMETRIC: {
      const long long p = 2LL * n, r = floor_mod(i, p);
      return (int)(r < n ? r : p - 1 - r);
    }
    case PAD_REFLECT: {
      if (n == 1) return 0;
      const long long p = 2LL * n - 2, r = floor_mod(i, p);
      return (int)(r < n ? r : p - r);
    }
    case PAD_PERIODIC:
      return (int)floor_mod(i, n);
    default:
      return (int)(i < 0 ? 0 : (i >= n ? n - 1 : i));
  }
}

// pad_src for the 'zero' and 'symmetric' modes at a position no more than
// one axis length outside the signal (-n <= i < 2n), in 32-bit arithmetic
// with no division: one reflection at most.  The DTCWT stencils (K8-K10)
// take it for every window inside [-n, 2n) and pad_src otherwise.
__device__ __forceinline__ int pad_src_near(int i, int n, int mode) {
  if (i >= 0 && i < n) return i;
  if (mode == PAD_ZERO) return -1;
  return i < 0 ? -1 - i : 2 * n - 1 - i;
}

// Copy both tap vectors from the kernel's parameters into shared memory.
__device__ __forceinline__ void load_taps(const DwtTaps& t, int L, float* f0,
                                          float* f1) {
  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    f0[k] = t.f0[k];
    f1[k] = t.f1[k];
  }
  __syncthreads();
}

inline DwtTaps pack_taps(const float* f0, const float* f1, int L) {
  DwtTaps t;
  for (int k = 0; k < L; ++k) {
    t.f0[k] = f0[k];
    t.f1[k] = f1[k];
  }
  return t;
}

// Blocks for a grid of (pixels of a plane, planes): 256 threads each, the
// planes on grid y (looped past 65535).
inline dim3 dwt_grid(long long per_plane, long long planes, int threads) {
  const long long bx = (per_plane + threads - 1) / threads;
  return dim3((unsigned)(bx > 2147483647LL ? 2147483647LL : bx),
              (unsigned)(planes > 65535 ? 65535 : planes), 1);
}

// Launch a stencil kernel on that grid with the pixel index of a plane in
// 32-bit integers (k32) where the plane holds fewer than 2^30 outputs, so
// that the grid-stride step cannot overflow, and in 64-bit ones (k64, one
// division of 64 bits per output) on larger planes.  The host wrappers
// keep each axis below 2^30, so the index along one axis, and twice it,
// stay 32-bit in both.
template <typename Args>
inline void dwt_launch(void (*k32)(Args, DwtTaps), void (*k64)(Args, DwtTaps),
                       long long per_plane, long long planes, const Args& a,
                       const DwtTaps& taps, void* stream) {
  const int threads = 256;
  const dim3 grid = dwt_grid(per_plane, planes, threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (per_plane < (1LL << 30))
    k32<<<grid, threads, 0, st>>>(a, taps);
  else
    k64<<<grid, threads, 0, st>>>(a, taps);
}
