// K9 dtcwt_dfilt: the DTCWT's q-shift decimation N -> N/2 along one axis.
//
// Replaces pytorch_wavelets_tpu/ops/dtcwt_fb.py:_dfilt_axis_conv (l.126)
// with _conv_grouped_pair (l.155), behind coldfilt / rowdfilt (B7b).  The
// plain version pads the axis symmetrically by m = len(ha), splits the
// padded signal xp into the streams xp[2::2] and xp[3::2], correlates them
// at stride 2 with ha and hb, and interleaves the two results, (a, b), or
// (b, a) when ``highpass``.  In closed form, output o (0 <= o < n/2) with
// r = o >> 1 takes stream s = highpass ^ (o & 1) (0: ha, 1: hb) and is
//
//   y[o] = sum_k h_s[k] x[src(4r + 2 + s + 2k - m)],   0 <= k < m,
//
// with src the 'symmetric' pad_src (dwt_index.cuh) evaluated per tap;
// outputs whose window lies inside the signal skip it, and windows within
// one axis length of it take the division-free pad_src_near.  Input and
// output are (N, C, H, W) views read and written through their strides.
//
// Bound: bytes.  A qshift_b level does 14 multiply-adds per output and
// halves the axis: about 4 FLOP per byte moved.  Consecutive threads take
// consecutive outputs along W; a warp's windows overlap, so samples are
// re-read from L1/L2.
#include <cuda_runtime.h>

#include "dwt_index.cuh"

namespace {

struct DfiltArgs {
  const float* x;
  float* y;
  int m, C, n, highpass, axis, Ho, Wo;
  long long planes, sx0, sx1, sx2, sx3, sy0, sy1, sy2, sy3;
};

template <typename I>
__global__ void dtcwt_dfilt_kernel(DfiltArgs a, DwtTaps taps) {
  __shared__ float ha[DWT_MAX_TAPS], hb[DWT_MAX_TAPS];
  load_taps(taps, a.m, ha, hb);
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
      const int s = a.highpass ^ (o & 1);
      const float* h = s ? hb : ha;
      const int s0 = 4 * (o >> 1) + 2 + s - a.m;
      float v = 0.f;
      if (s0 >= 0 && s0 + 2 * (a.m - 1) < a.n) {
        const float* q = base + s0 * step;
        const long long step2 = 2 * step;
        for (int k = 0; k < a.m; ++k, q += step2) v = fmaf(h[k], *q, v);
      } else if (s0 >= -a.n && s0 + 2 * (a.m - 1) < 2 * a.n) {
        for (int k = 0; k < a.m; ++k)
          v = fmaf(h[k],
                   base[pad_src_near(s0 + 2 * k, a.n, PAD_SYMMETRIC) * step],
                   v);
      } else {
        for (int k = 0; k < a.m; ++k)
          v = fmaf(h[k], base[pad_src(s0 + 2 * k, a.n, PAD_SYMMETRIC) * step],
                   v);
      }
      yp[i * a.sy2 + j * a.sy3] = v;
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, C, H, W) at strides sx0..sx3, the filtered axis a multiple of 4;
// ha, hb: m host floats each (correlation order); y: (N, C, H', W') at
// strides sy0..sy3 with the filtered axis halved.
int dtcwt_dfilt(const void* x, void* y, const float* ha, const float* hb,
                int m, int highpass, long long N, int C, int H, int W,
                long long sx0, long long sx1, long long sx2, long long sx3,
                int axis, long long sy0, long long sy1, long long sy2,
                long long sy3, void* stream) {
  const int n = axis == 3 ? W : H;
  if (m < 1 || m > DWT_MAX_TAPS || (axis != 2 && axis != 3) || n % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  DfiltArgs a;
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.m = m;
  a.C = C;
  a.n = n;
  a.highpass = highpass ? 1 : 0;
  a.axis = axis;
  a.Ho = axis == 2 ? n / 2 : H;
  a.Wo = axis == 3 ? n / 2 : W;
  a.planes = N * C;
  a.sx0 = sx0; a.sx1 = sx1; a.sx2 = sx2; a.sx3 = sx3;
  a.sy0 = sy0; a.sy1 = sy1; a.sy2 = sy2; a.sy3 = sy3;
  const long long per_plane = (long long)a.Ho * a.Wo;
  if (per_plane == 0 || a.planes == 0) return 0;
  dwt_launch(dtcwt_dfilt_kernel<int>, dtcwt_dfilt_kernel<long long>,
             per_plane, a.planes, a, pack_taps(ha, hb, m), stream);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
