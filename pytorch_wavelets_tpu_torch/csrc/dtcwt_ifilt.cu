// K10 dtcwt_ifilt: the DTCWT's q-shift interpolation N -> 2N along one axis.
//
// Replaces pytorch_wavelets_tpu/ops/dtcwt_fb.py:_ifilt_axis_conv (l.220)
// with _conv_quad (l.264), behind colifilt / rowifilt (B7c).  The plain
// version pads the axis symmetrically by m2 = m // 2 (m = len(ha), even),
// takes four phase streams xp[s::2] of the padded signal xp, correlates
// each with the odd or even taps of ha or hb, and interleaves the four
// results.  In closed form, output o (0 <= o < 2n) with q = o >> 2 and
// phase f = o & 3 is
//
//   y[o] = sum_k h_f[2k + par_f] x[src(start_f + 2q + 2k - m2)],
//          0 <= k < m/2,
//
// where h_f is ha for the even phases and hb for the odd ones, and
// (start_f, par_f) is the host's table (ops/dtcwt_fb.py:ifilt_plan) for
// the parity of m2 and ``highpass``, both branches of the plain version
// (dtcwt_fb.py l.238-249).  src is the 'symmetric' pad_src
// (dwt_index.cuh) per tap; interior outputs skip it, and windows within
// one axis length of the signal take the division-free pad_src_near.  The
// result is written through the output's strides, or added to what is
// there with ``acc`` (the inverse's sums).
//
// Bound: bytes.  A qshift_b level does 7 multiply-adds per output and
// doubles the axis: about 2 FLOP per byte moved.  Consecutive threads take
// consecutive outputs along W, four phases of each input window.
#include <cuda_runtime.h>

#include "dwt_index.cuh"

namespace {

struct IfiltArgs {
  const float* x;
  float* y;
  int m, C, n, plan, axis, Ho, Wo, acc;
  long long planes, sx0, sx1, sx2, sx3, sy0, sy1, sy2, sy3;
};

template <typename I>
__global__ void dtcwt_ifilt_kernel(IfiltArgs a, DwtTaps taps) {
  __shared__ float ha[DWT_MAX_TAPS], hb[DWT_MAX_TAPS];
  load_taps(taps, a.m, ha, hb);
  const I per_plane = (I)a.Ho * a.Wo;
  const int half = a.m / 2;   // m2, and the taps of each phase
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
      const int f = o & 3;
      // plan: per phase 3 bits, (start << 1) | par
      const int code = (a.plan >> (3 * f)) & 7;
      const float* h = ((f & 1) ? hb : ha) + (code & 1);
      const int s0 = (code >> 1) + 2 * (o >> 2) - half;
      float v = 0.f;
      if (s0 >= 0 && s0 + 2 * (half - 1) < a.n) {
        const float* q = base + s0 * step;
        const long long step2 = 2 * step;
        for (int k = 0; k < half; ++k, q += step2) v = fmaf(h[2 * k], *q, v);
      } else if (s0 >= -a.n && s0 + 2 * (half - 1) < 2 * a.n) {
        for (int k = 0; k < half; ++k)
          v = fmaf(h[2 * k],
                   base[pad_src_near(s0 + 2 * k, a.n, PAD_SYMMETRIC) * step],
                   v);
      } else {
        for (int k = 0; k < half; ++k)
          v = fmaf(h[2 * k],
                   base[pad_src(s0 + 2 * k, a.n, PAD_SYMMETRIC) * step], v);
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

// x: (N, C, H, W) at strides sx0..sx3; ha, hb: m host floats each
// (correlation order, m even); plan: the phase table, 3 bits per phase
// ((start << 1) | par); y: (N, C, H', W') at strides sy0..sy3 with the
// filtered axis doubled.
int dtcwt_ifilt(const void* x, void* y, const float* ha, const float* hb,
                int m, int plan, long long N, int C, int H, int W,
                long long sx0, long long sx1, long long sx2, long long sx3,
                int axis, int acc, long long sy0, long long sy1,
                long long sy2, long long sy3, void* stream) {
  if (m < 2 || m > DWT_MAX_TAPS || m % 2 || (axis != 2 && axis != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  IfiltArgs a;
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.m = m;
  a.C = C;
  a.n = axis == 3 ? W : H;
  a.plan = plan;
  a.axis = axis;
  a.Ho = axis == 2 ? 2 * a.n : H;
  a.Wo = axis == 3 ? 2 * a.n : W;
  a.acc = acc;
  a.planes = N * C;
  a.sx0 = sx0; a.sx1 = sx1; a.sx2 = sx2; a.sx3 = sx3;
  a.sy0 = sy0; a.sy1 = sy1; a.sy2 = sy2; a.sy3 = sy3;
  const long long per_plane = (long long)a.Ho * a.Wo;
  if (per_plane == 0 || a.planes == 0) return 0;
  dwt_launch(dtcwt_ifilt_kernel<int>, dtcwt_ifilt_kernel<long long>,
             per_plane, a.planes, a, pack_taps(ha, hb, m), stream);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
