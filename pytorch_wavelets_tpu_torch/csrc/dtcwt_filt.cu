// K8 dtcwt_filt: the DTCWT's non-decimated level-1 filter along one axis.
//
// Replaces pytorch_wavelets_tpu/ops/dtcwt_fb.py:_filter_axis_conv (l.66),
// the pad + correlation behind colfilter / rowfilter (B7a).  Input: an
// (N, C, H, W) view read through its four strides (a band of a level's
// stack in place); axis 3 filters along W, axis 2 along H.  With L taps t
// in correlation order and m = L // 2, output i along the axis is
//
//   y[i] = sum_k t[k] x[src(i + k - m)],   0 <= i < n + (L even),
//
// where src is pad_src (dwt_index.cuh) in 'symmetric' or 'zero' mode: the
// boundary is evaluated per tap, no padded copy is made, and outputs whose
// window lies inside the signal skip it.  A window that reaches at most
// one axis length past either end (every boundary output unless the
// filter is longer than the axis) takes pad_src_near, 32-bit and free of
// the division that pad_src's general reflection costs per tap.  The
// result is written through the output's four strides, or added to what
// is there with ``acc`` (the inverse's sums, colfilter(hh, g1) +
// colfilter(hl, g0), need no separate add): out = out + y, the one
// rounding of the plain version's sum.
//
// Bound: bytes.  A near_sym_b filter does 13-19 multiply-adds per output,
// about 4 FLOP per byte moved, against ~20 for the card.  Consecutive
// threads take consecutive outputs along W (both axes), so a warp's loads
// are contiguous runs; the windows of neighbouring outputs overlap and are
// re-read from L1/L2, not from memory.  The tap loop walks a pointer, so
// an interior output costs one 64-bit add per tap.
#include <cuda_runtime.h>

#include "dwt_index.cuh"

namespace {

struct FiltArgs {
  const float* x;
  float* y;
  int L, C, n, m, mode, axis, Ho, Wo, acc;
  long long planes, sx0, sx1, sx2, sx3, sy0, sy1, sy2, sy3;
};

template <typename I>
__global__ void dtcwt_filt_kernel(FiltArgs a, DwtTaps taps) {
  __shared__ float t[DWT_MAX_TAPS];
  for (int k = threadIdx.x; k < a.L; k += blockDim.x) t[k] = taps.f0[k];
  __syncthreads();
  const I per_plane = (I)a.Ho * a.Wo;
  for (long long p = blockIdx.y; p < a.planes; p += gridDim.y) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* xp = a.x + nn * a.sx0 + c * a.sx1;
    float* yp = a.y + nn * a.sy0 + c * a.sy1;
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < per_plane;
         idx += (I)gridDim.x * blockDim.x) {
      const int i = (int)(idx / a.Wo), j = (int)(idx % a.Wo);
      int o;
      const float* base;
      long long step;
      if (a.axis == 3) {
        o = j;
        base = xp + i * a.sx2;
        step = a.sx3;
      } else {
        o = i;
        base = xp + j * a.sx3;
        step = a.sx2;
      }
      const int s0 = o - a.m;
      float v = 0.f;
      if (s0 >= 0 && s0 + a.L <= a.n) {
        const float* q = base + s0 * step;
        for (int k = 0; k < a.L; ++k, q += step) v = fmaf(t[k], *q, v);
      } else if (s0 >= -a.n && s0 + a.L <= 2 * a.n) {
        for (int k = 0; k < a.L; ++k) {
          const int r = pad_src_near(s0 + k, a.n, a.mode);
          if (r >= 0) v = fmaf(t[k], base[r * step], v);
        }
      } else {
        for (int k = 0; k < a.L; ++k) {
          const int r = pad_src(s0 + k, a.n, a.mode);
          if (r >= 0) v = fmaf(t[k], base[r * step], v);
        }
      }
      float* out = yp + i * a.sy2 + j * a.sy3;
      *out = a.acc ? *out + v : v;
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, C, H, W) at strides sx0..sx3; t: L host floats (correlation
// order); y: (N, C, H', W') at strides sy0..sy3, where the filtered axis
// has n + (L even) outputs and the other keeps its length; mode: a
// PadCode (PAD_ZERO or PAD_SYMMETRIC).
int dtcwt_filt(const void* x, void* y, const float* t, int L, long long N,
               int C, int H, int W, long long sx0, long long sx1,
               long long sx2, long long sx3, int axis, int mode, int acc,
               long long sy0, long long sy1, long long sy2, long long sy3,
               void* stream) {
  if (L < 1 || L > DWT_MAX_TAPS || (axis != 2 && axis != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  FiltArgs a;
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.L = L;
  a.C = C;
  a.n = axis == 3 ? W : H;
  a.m = L / 2;
  a.mode = mode;
  a.axis = axis;
  const int nout = a.n + (L % 2 == 0 ? 1 : 0);
  a.Ho = axis == 2 ? nout : H;
  a.Wo = axis == 3 ? nout : W;
  a.acc = acc;
  a.planes = N * C;
  a.sx0 = sx0; a.sx1 = sx1; a.sx2 = sx2; a.sx3 = sx3;
  a.sy0 = sy0; a.sy1 = sy1; a.sy2 = sy2; a.sy3 = sy3;
  const long long per_plane = (long long)a.Ho * a.Wo;
  if (per_plane == 0 || a.planes == 0) return 0;
  dwt_launch(dtcwt_filt_kernel<int>, dtcwt_filt_kernel<long long>,
             per_plane, a.planes, a, pack_taps(t, t, L), stream);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
