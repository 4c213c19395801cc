// K6 dwt_afb: the DWT's analysis split along one axis, lowpass and
// highpass in one pass, every boundary mode folded into the index math.
//
// Replaces pytorch_wavelets_tpu/ops/afb_sfb.py:_conv_axis (l.47) as used by
// _afb1d_corr_conv (l.125), with pad1d (ops/pad.py:28) folded in (B8a +
// B9).  Input: an (N, C, H, W) view read through its four strides (the
// lowpass band of a coarser level's (N, C, 4, H, W) output in place);
// axis 3 filters along W (the row pass), axis 2 along H (the column pass).
// For each output m along the axis, with taps h0/h1 in correlation order,
//
//   lo[m] = sum_k h0[k] X(2m + k)  (+ sum_k h0[k] X(2m + k + ne) if m < fold)
//   hi[m] = the same with h1, from the same loaded samples,
//
// where X(q) = x[min((pad_src(q - front, ne, mode) + shift) % ne, n - 1)],
// or 0 where pad_src gives -1: ops/afb_sfb.py:afb_plan computes front, ne,
// mode, shift and fold per mode ('periodization' evens an odd axis by
// repeating its last sample, and for filters longer than the evened axis
// mirrors the reference's roll, zero pad and single fold).  Outputs whose
// window lies inside the signal skip the index math.  lo and hi are
// written through the output's five strides (N, C, band, H', W'), and only
// the first m_out outputs along the axis (the crop of a backward).
//
// Bound: bytes.  A db4 split does 2 * 8 multiply-adds per output pair,
// about 2 FLOP per byte moved, against ~20 for the card.  Consecutive
// threads take consecutive outputs along W (both passes), so a warp's
// loads are contiguous runs; the L-tap window of neighbouring outputs
// overlaps and is re-read from L1/L2, not from memory.
#include <cuda_runtime.h>

#include "dwt_index.cuh"

namespace {

struct AfbArgs {
  const float* x;
  float* y;
  int L, C, n, ne, front, mode, shift, fold, axis, Ho, Wo;
  long long planes, sx0, sx1, sx2, sx3, sy0, sy1, syb, sy2, sy3;
};

__device__ __forceinline__ float sample(const AfbArgs& a, const float* base,
                                        long long step, long long q) {
  int r = pad_src(q - a.front, a.ne, a.mode);
  if (r < 0) return 0.f;
  if (a.shift) r = (r + a.shift) % a.ne;
  return base[(long long)min(r, a.n - 1) * step];
}

template <typename I>
__global__ void dwt_afb_kernel(AfbArgs a, DwtTaps taps) {
  __shared__ float h0[DWT_MAX_TAPS], h1[DWT_MAX_TAPS];
  load_taps(taps, a.L, h0, h1);
  const I per_plane = (I)a.Ho * a.Wo;
  for (long long p = blockIdx.y; p < a.planes; p += gridDim.y) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* xp = a.x + nn * a.sx0 + c * a.sx1;
    float* yp = a.y + nn * a.sy0 + c * a.sy1;
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < per_plane;
         idx += (I)gridDim.x * blockDim.x) {
      const int i = (int)(idx / a.Wo), j = (int)(idx % a.Wo);
      int m;
      const float* base;
      long long step;
      if (a.axis == 3) {
        m = j;
        base = xp + i * a.sx2;
        step = a.sx3;
      } else {
        m = i;
        base = xp + j * a.sx3;
        step = a.sx2;
      }
      const long long q0 = 2LL * m;
      const long long i0 = q0 - a.front;
      float lo = 0.f, hi = 0.f;
      if (a.shift == 0 && i0 >= 0 && i0 + a.L <= a.n) {
        const float* b = base + i0 * step;
        for (int k = 0; k < a.L; ++k) {
          const float v = b[k * step];
          lo = fmaf(h0[k], v, lo);
          hi = fmaf(h1[k], v, hi);
        }
      } else {
        for (int k = 0; k < a.L; ++k) {
          const float v = sample(a, base, step, q0 + k);
          lo = fmaf(h0[k], v, lo);
          hi = fmaf(h1[k], v, hi);
        }
        if (m < a.fold) {
          // the single fold of 'periodization' with L > ne: the outputs
          // of the second period, summed as the plain version sums them
          float lo2 = 0.f, hi2 = 0.f;
          for (int k = 0; k < a.L; ++k) {
            const float v = sample(a, base, step, q0 + a.ne + k);
            lo2 = fmaf(h0[k], v, lo2);
            hi2 = fmaf(h1[k], v, hi2);
          }
          lo += lo2;
          hi += hi2;
        }
      }
      float* o = yp + i * a.sy2 + j * a.sy3;
      o[0] = lo;
      o[a.syb] = hi;
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, C, H, W) at strides sx0..sx3; h0, h1: L host floats each;
// y: (N, C, 2, H', W') at strides sy0, sy1, syb, sy2, sy3, where the
// filtered axis has m_out outputs and the other keeps its length.
int dwt_afb(const void* x, void* y, const float* h0, const float* h1, int L,
            long long N, int C, int H, int W, long long sx0, long long sx1,
            long long sx2, long long sx3, int axis, int ne, int front,
            int mode, int shift, int fold, int m_out, long long sy0,
            long long sy1, long long syb, long long sy2, long long sy3,
            void* stream) {
  if (L < 1 || L > DWT_MAX_TAPS || (axis != 2 && axis != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  AfbArgs a;
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.L = L;
  a.C = C;
  a.n = axis == 3 ? W : H;
  a.ne = ne;
  a.front = front;
  a.mode = mode;
  a.shift = shift;
  a.fold = fold;
  a.axis = axis;
  a.Ho = axis == 2 ? m_out : H;
  a.Wo = axis == 3 ? m_out : W;
  a.planes = N * C;
  a.sx0 = sx0; a.sx1 = sx1; a.sx2 = sx2; a.sx3 = sx3;
  a.sy0 = sy0; a.sy1 = sy1; a.syb = syb; a.sy2 = sy2; a.sy3 = sy3;
  const long long per_plane = (long long)a.Ho * a.Wo;
  if (per_plane == 0 || a.planes == 0) return 0;
  dwt_launch(dwt_afb_kernel<int>, dwt_afb_kernel<long long>,
             per_plane, a.planes, a, pack_taps(h0, h1, L), stream);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
