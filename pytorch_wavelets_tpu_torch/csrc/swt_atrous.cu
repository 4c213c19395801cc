// K12 and K16, swt_atrous: the SWT's undecimated (à trous) two-band split
// along one axis (K12), the classic shift-averaged two-band merge (K16), and
// the exact transpose of each, every boundary mode folded into the index
// math.
//
// Replaces pytorch_wavelets_tpu/ops/afb_sfb.py:_conv_axis (l.47) as used by
// _afb1d_atrous_corr_conv (l.207; via _afb1d_atrous_corr l.179 and
// afb2d_atrous l.426), with pad1d (ops/pad.py:28) folded in (B8c + B9); the
// JAX package differentiates it by autodiff, which the adjoint entry
// replaces.  Taps h0/h1 in correlation order, d samples apart, on a
// length-n axis padded by front = (L d)/2 - d before and (L d)/2 after:
//
//   swt_afb:          lo[m] = sum_k h0[k] X(m + k d - front),
//                     hi[m] = the same with h1, from the same loaded samples,
//                     where X(q) = x[pad_src(q, n, mode)], or 0 where that
//                     is -1 (ops/afb_sfb.py:atrous_plan);
//   swt_afb_adjoint:  dx[t] = sum over (m, k) whose padded index maps to t
//                     of h0[k] dlo[m] + h1[k] dhi[m], a gather (no
//                     atomics): the direct window m = t + front - k d,
//                     plus, for t within the pads' reach of an edge, every
//                     padded position q outside [0, n) with
//                     pad_src(q) = t (reflected or wrapped images; the
//                     whole pad run for 'replicate'; several periods when a
//                     pad is longer than the axis).
//
// Both read their input through its strides (the LL band of the previous
// level's (N, C, 4, H, W) stack in place) and write through the output's,
// one output (pair) per thread, consecutive threads along W, as K6.
//
// Bound: bytes.  A db4 split does 2 * 8 multiply-adds per output pair
// against 12 bytes moved; the taps' window is re-read from L1/L2, not
// from memory.  Windows inside the axis skip the index math.
//
// K16 replaces _sfb1d_atrous_conv_conv (ops/afb_sfb.py l.337; via
// sfb1d_atrous l.358 and sfb2d_atrous l.450; B8c'), which JAX runs as the
// probed operator of _sfb_atrous_matrix (l.322) on a device and
// differentiates by autodiff.  Taps g0/g1 in correlation order (the
// synthesis taps reversed), halved by the wrapper, d apart, on a length-n
// axis padded by front = (L d)/2 before and L d - d - (L d)/2 after:
//
//   swt_sfb:          y[m] = sum_k g0[k] LO(m + k d - front)
//                            + sum_k g1[k] HI(m + k d - front), m < n,
//                     LO, HI read as X above, each through its own strides;
//   swt_sfb_adjoint:  dlo[t] = sum over (m, k) whose padded index maps to
//                     t of g0[k] dy[m], dhi[t] the same with g1: K12's
//                     adjoint gather (the same edge scan) with one
//                     cotangent and two outputs, written into the bands of
//                     an (N, C, 2, H, W) stack.
//
// Bound: bytes, as K12 (2 * 8 multiply-adds per output against 12 bytes).
#include <cuda_runtime.h>

#include "dwt_index.cuh"

namespace {

struct AtrousArgs {
  const float* in;
  float* out;
  int L, d, C, n, front, mode, m, axis, Ho, Wo;
  // in: (N, C[, band], H, W) strides; out: likewise.  The split reads 4
  // input strides and writes 5 output strides; the adjoint the reverse.
  long long planes, si0, si1, sib, si2, si3, so0, so1, sob, so2, so3;
};

template <typename I>
__global__ void swt_afb_kernel(AtrousArgs a, DwtTaps taps) {
  __shared__ float h0[DWT_MAX_TAPS], h1[DWT_MAX_TAPS];
  load_taps(taps, a.L, h0, h1);
  const I per_plane = (I)a.Ho * a.Wo;
  const long long span = (long long)(a.L - 1) * a.d;
  for (long long p = blockIdx.y; p < a.planes; p += gridDim.y) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* xp = a.in + nn * a.si0 + c * a.si1;
    float* yp = a.out + nn * a.so0 + c * a.so1;
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < per_plane;
         idx += (I)gridDim.x * blockDim.x) {
      const int i = (int)(idx / a.Wo), j = (int)(idx % a.Wo);
      int m;
      const float* base;
      long long step;
      if (a.axis == 3) {
        m = j;
        base = xp + i * a.si2;
        step = a.si3;
      } else {
        m = i;
        base = xp + j * a.si3;
        step = a.si2;
      }
      const long long q0 = (long long)m - a.front;
      float lo = 0.f, hi = 0.f;
      if (q0 >= 0 && q0 + span < a.n) {
        const float* b = base + q0 * step;
        const long long ds = (long long)a.d * step;
        for (int k = 0; k < a.L; ++k) {
          const float v = b[k * ds];
          lo = fmaf(h0[k], v, lo);
          hi = fmaf(h1[k], v, hi);
        }
      } else {
        for (int k = 0; k < a.L; ++k) {
          const int r = pad_src(q0 + (long long)k * a.d, a.n, a.mode);
          const float v = r < 0 ? 0.f : base[(long long)r * step];
          lo = fmaf(h0[k], v, lo);
          hi = fmaf(h1[k], v, hi);
        }
      }
      float* o = yp + i * a.so2 + j * a.so3;
      o[0] = lo;
      o[a.sob] = hi;
    }
  }
}

// The outputs m (0 <= m < a.m) that padded position q feeds through tap k
// are m = q + front - k d: add their cotangents.
__device__ __forceinline__ float window(const AtrousArgs& a, const float* h0,
                                        const float* h1, const float* base,
                                        long long step, long long q,
                                        float acc) {
  for (int k = 0; k < a.L; ++k) {
    const long long u = q + a.front - (long long)k * a.d;
    if (u >= 0 && u < a.m) {
      const float* g = base + u * step;
      acc = fmaf(h0[k], g[0], acc);
      acc = fmaf(h1[k], g[a.sib], acc);
    }
  }
  return acc;
}

// Call f(q) for each padded position q in [-front, qmax] whose source is
// sample t: t itself, and, for t within the pads' reach of an edge, every
// pad position with pad_src(q) = t (reflected or wrapped images; the whole
// pad run for 'replicate'; several periods when a pad is longer than the
// axis).  The adjoints of K12 and K16 gather over these.
template <typename F>
__device__ __forceinline__ void padded_images(const AtrousArgs& a, int t,
                                              F f) {
  f((long long)t);
  if (a.mode == PAD_ZERO) return;
  // the padded positions the split reads: [-front, qmax]
  const long long qmax = (long long)a.m - 1 - a.front + (long long)(a.L - 1) * a.d;
  const long long right = qmax >= a.n ? qmax - a.n + 1 : 0;
  // every image of a pad position lies within `edge` of an axis end
  const long long edge = (a.front > right ? a.front : right) + 1;
  if (t >= edge && t < a.n - edge) return;
  for (long long q = -a.front; q < 0; ++q)
    if (pad_src(q, a.n, a.mode) == t) f(q);
  for (long long q = a.n; q <= qmax; ++q)
    if (pad_src(q, a.n, a.mode) == t) f(q);
}

template <typename I>
__global__ void swt_afb_adjoint_kernel(AtrousArgs a, DwtTaps taps) {
  __shared__ float h0[DWT_MAX_TAPS], h1[DWT_MAX_TAPS];
  load_taps(taps, a.L, h0, h1);
  const I per_plane = (I)a.Ho * a.Wo;
  for (long long p = blockIdx.y; p < a.planes; p += gridDim.y) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* gp = a.in + nn * a.si0 + c * a.si1;
    float* xp = a.out + nn * a.so0 + c * a.so1;
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < per_plane;
         idx += (I)gridDim.x * blockDim.x) {
      const int i = (int)(idx / a.Wo), j = (int)(idx % a.Wo);
      int t;
      const float* base;
      long long step;
      if (a.axis == 3) {
        t = j;
        base = gp + i * a.si2;
        step = a.si3;
      } else {
        t = i;
        base = gp + j * a.si3;
        step = a.si2;
      }
      float acc = 0.f;
      padded_images(a, t, [&](long long q) {
        acc = window(a, h0, h1, base, step, q, acc);
      });
      xp[i * a.so2 + j * a.so3] = acc;
    }
  }
}

// K16: both inputs of the merge, each through its own strides.
struct MergeArgs {
  const float* lo;
  const float* hi;
  float* out;
  int L, d, C, n, front, mode, axis, H, W;
  long long planes, sl0, sl1, sl2, sl3, sh0, sh1, sh2, sh3, so0, so1, so2,
      so3;
};

template <typename I>
__global__ void swt_sfb_kernel(MergeArgs a, DwtTaps taps) {
  __shared__ float g0[DWT_MAX_TAPS], g1[DWT_MAX_TAPS];
  load_taps(taps, a.L, g0, g1);
  const I per_plane = (I)a.H * a.W;
  const long long span = (long long)(a.L - 1) * a.d;
  for (long long p = blockIdx.y; p < a.planes; p += gridDim.y) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* lp = a.lo + nn * a.sl0 + c * a.sl1;
    const float* hp = a.hi + nn * a.sh0 + c * a.sh1;
    float* yp = a.out + nn * a.so0 + c * a.so1;
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < per_plane;
         idx += (I)gridDim.x * blockDim.x) {
      const int i = (int)(idx / a.W), j = (int)(idx % a.W);
      int m;
      const float *lb, *hb;
      long long ls, hs;
      if (a.axis == 3) {
        m = j;
        lb = lp + i * a.sl2;
        hb = hp + i * a.sh2;
        ls = a.sl3;
        hs = a.sh3;
      } else {
        m = i;
        lb = lp + j * a.sl3;
        hb = hp + j * a.sh3;
        ls = a.sl2;
        hs = a.sh2;
      }
      const long long q0 = (long long)m - a.front;
      float lo = 0.f, hi = 0.f;
      if (q0 >= 0 && q0 + span < a.n) {
        for (int k = 0; k < a.L; ++k) {
          const long long q = q0 + (long long)k * a.d;
          lo = fmaf(g0[k], lb[q * ls], lo);
          hi = fmaf(g1[k], hb[q * hs], hi);
        }
      } else {
        for (int k = 0; k < a.L; ++k) {
          const int r = pad_src(q0 + (long long)k * a.d, a.n, a.mode);
          if (r < 0) continue;
          lo = fmaf(g0[k], lb[(long long)r * ls], lo);
          hi = fmaf(g1[k], hb[(long long)r * hs], hi);
        }
      }
      yp[i * a.so2 + j * a.so3] = lo + hi;
    }
  }
}

// The outputs m (0 <= m < a.m) that padded position q feeds through tap k
// are m = q + front - k d: add g0[k] and g1[k] times their cotangent.
__device__ __forceinline__ void window2(const AtrousArgs& a, const float* g0,
                                        const float* g1, const float* base,
                                        long long step, long long q,
                                        float& lo, float& hi) {
  for (int k = 0; k < a.L; ++k) {
    const long long u = q + a.front - (long long)k * a.d;
    if (u >= 0 && u < a.m) {
      const float v = base[u * step];
      lo = fmaf(g0[k], v, lo);
      hi = fmaf(g1[k], v, hi);
    }
  }
}

template <typename I>
__global__ void swt_sfb_adjoint_kernel(AtrousArgs a, DwtTaps taps) {
  __shared__ float g0[DWT_MAX_TAPS], g1[DWT_MAX_TAPS];
  load_taps(taps, a.L, g0, g1);
  const I per_plane = (I)a.Ho * a.Wo;
  for (long long p = blockIdx.y; p < a.planes; p += gridDim.y) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* gp = a.in + nn * a.si0 + c * a.si1;
    float* xp = a.out + nn * a.so0 + c * a.so1;
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < per_plane;
         idx += (I)gridDim.x * blockDim.x) {
      const int i = (int)(idx / a.Wo), j = (int)(idx % a.Wo);
      int t;
      const float* base;
      long long step;
      if (a.axis == 3) {
        t = j;
        base = gp + i * a.si2;
        step = a.si3;
      } else {
        t = i;
        base = gp + j * a.si3;
        step = a.si2;
      }
      float lo = 0.f, hi = 0.f;
      padded_images(a, t, [&](long long q) {
        window2(a, g0, g1, base, step, q, lo, hi);
      });
      float* o = xp + i * a.so2 + j * a.so3;
      o[0] = lo;
      o[a.sob] = hi;
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, C, H, W) at strides sx0..sx3, n = its length along axis; h0, h1:
// L host floats each, d apart; y: (N, C, 2, H', W') at strides sy0, sy1,
// syb, sy2, sy3, with m_out outputs along the axis.
int swt_afb(const void* x, void* y, const float* h0, const float* h1, int L,
            int d, long long N, int C, int H, int W, long long sx0,
            long long sx1, long long sx2, long long sx3, int axis, int front,
            int mode, int m_out, long long sy0, long long sy1, long long syb,
            long long sy2, long long sy3, void* stream) {
  if (L < 1 || L > DWT_MAX_TAPS || d < 1 || front < 0 ||
      (axis != 2 && axis != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  AtrousArgs a;
  a.in = static_cast<const float*>(x);
  a.out = static_cast<float*>(y);
  a.L = L;
  a.d = d;
  a.C = C;
  a.n = axis == 3 ? W : H;
  a.front = front;
  a.mode = mode;
  a.m = m_out;
  a.axis = axis;
  a.Ho = axis == 2 ? m_out : H;
  a.Wo = axis == 3 ? m_out : W;
  a.planes = N * C;
  a.si0 = sx0; a.si1 = sx1; a.sib = 0; a.si2 = sx2; a.si3 = sx3;
  a.so0 = sy0; a.so1 = sy1; a.sob = syb; a.so2 = sy2; a.so3 = sy3;
  const long long per_plane = (long long)a.Ho * a.Wo;
  if (per_plane == 0 || a.planes == 0) return 0;
  dwt_launch(swt_afb_kernel<int>, swt_afb_kernel<long long>, per_plane,
             a.planes, a, pack_taps(h0, h1, L), stream);
  return static_cast<int>(cudaGetLastError());
}

// dy: (N, C, 2, H', W') at strides sd0, sd1, sdb, sd2, sd3, with m samples
// along axis; dx: (N, C, Ho, Wo) at strides sx0..sx3, n = its length
// along the axis (the other dimension is dy's).
int swt_afb_adjoint(const void* dy, void* dx, const float* h0,
                    const float* h1, int L, int d, long long N, int C, int Ho,
                    int Wo, long long sd0, long long sd1, long long sdb,
                    long long sd2, long long sd3, int axis, int front,
                    int mode, int m, long long sx0, long long sx1,
                    long long sx2, long long sx3, void* stream) {
  if (L < 1 || L > DWT_MAX_TAPS || d < 1 || front < 0 ||
      (axis != 2 && axis != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  AtrousArgs a;
  a.in = static_cast<const float*>(dy);
  a.out = static_cast<float*>(dx);
  a.L = L;
  a.d = d;
  a.C = C;
  a.n = axis == 3 ? Wo : Ho;
  a.front = front;
  a.mode = mode;
  a.m = m;
  a.axis = axis;
  a.Ho = Ho;
  a.Wo = Wo;
  a.planes = N * C;
  a.si0 = sd0; a.si1 = sd1; a.sib = sdb; a.si2 = sd2; a.si3 = sd3;
  a.so0 = sx0; a.so1 = sx1; a.sob = 0; a.so2 = sx2; a.so3 = sx3;
  const long long per_plane = (long long)Ho * Wo;
  if (per_plane == 0 || a.planes == 0) return 0;
  dwt_launch(swt_afb_adjoint_kernel<int>, swt_afb_adjoint_kernel<long long>,
             per_plane, a.planes, a, pack_taps(h0, h1, L), stream);
  return static_cast<int>(cudaGetLastError());
}

// lo, hi: (N, C, H, W) at strides sl0..sl3, sh0..sh3; g0, g1: L host
// floats each (correlation order, halved), d apart; y: (N, C, H, W) at
// strides sy0..sy3, m_out = the axis length.
int swt_sfb(const void* lo, const void* hi, void* y, const float* g0,
            const float* g1, int L, int d, long long N, int C, int H, int W,
            long long sl0, long long sl1, long long sl2, long long sl3,
            long long sh0, long long sh1, long long sh2, long long sh3,
            int axis, int front, int mode, int m_out, long long sy0,
            long long sy1, long long sy2, long long sy3, void* stream) {
  const int n = axis == 3 ? W : H;
  if (L < 1 || L > DWT_MAX_TAPS || d < 1 || front < 0 || m_out != n ||
      (axis != 2 && axis != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  MergeArgs a;
  a.lo = static_cast<const float*>(lo);
  a.hi = static_cast<const float*>(hi);
  a.out = static_cast<float*>(y);
  a.L = L;
  a.d = d;
  a.C = C;
  a.n = n;
  a.front = front;
  a.mode = mode;
  a.axis = axis;
  a.H = H;
  a.W = W;
  a.planes = N * C;
  a.sl0 = sl0; a.sl1 = sl1; a.sl2 = sl2; a.sl3 = sl3;
  a.sh0 = sh0; a.sh1 = sh1; a.sh2 = sh2; a.sh3 = sh3;
  a.so0 = sy0; a.so1 = sy1; a.so2 = sy2; a.so3 = sy3;
  const long long per_plane = (long long)H * W;
  if (per_plane == 0 || a.planes == 0) return 0;
  dwt_launch(swt_sfb_kernel<int>, swt_sfb_kernel<long long>, per_plane,
             a.planes, a, pack_taps(g0, g1, L), stream);
  return static_cast<int>(cudaGetLastError());
}

// dy: (N, C, H, W) at strides sd0..sd3, m = n samples along axis; d2:
// (N, C, 2, H, W) at strides sx0, sx1, sxb, sx2, sx3.
int swt_sfb_adjoint(const void* dy, void* d2, const float* g0,
                    const float* g1, int L, int d, long long N, int C, int H,
                    int W, long long sd0, long long sd1, long long sd2,
                    long long sd3, int axis, int front, int mode, int m,
                    long long sx0, long long sx1, long long sxb,
                    long long sx2, long long sx3, void* stream) {
  const int n = axis == 3 ? W : H;
  if (L < 1 || L > DWT_MAX_TAPS || d < 1 || front < 0 || m != n ||
      (axis != 2 && axis != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  AtrousArgs a;
  a.in = static_cast<const float*>(dy);
  a.out = static_cast<float*>(d2);
  a.L = L;
  a.d = d;
  a.C = C;
  a.n = n;
  a.front = front;
  a.mode = mode;
  a.m = m;
  a.axis = axis;
  a.Ho = H;
  a.Wo = W;
  a.planes = N * C;
  a.si0 = sd0; a.si1 = sd1; a.sib = 0; a.si2 = sd2; a.si3 = sd3;
  a.so0 = sx0; a.so1 = sx1; a.sob = sxb; a.so2 = sx2; a.so3 = sx3;
  const long long per_plane = (long long)H * W;
  if (per_plane == 0 || a.planes == 0) return 0;
  dwt_launch(swt_sfb_adjoint_kernel<int>, swt_sfb_adjoint_kernel<long long>,
             per_plane, a.planes, a, pack_taps(g0, g1, L), stream);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
