// K14 nonsep_afb: one level of 2-D analysis as a single stride-(2, 2)
// correlation of each (N, C) plane with a stack of K point-spread functions
// (PSFs), every boundary mode folded into the index of each tap, and its
// exact transpose.
//
// Replaces pytorch_wavelets_tpu/ops/afb_sfb.py:_nonsep_conv (l.482; via
// afb2d_nonsep l.518, K = 4 outer products, and
// transforms/dtcwt_alt.py:quad_afb2d_nonsep l.334, K = 16), with pad1d
// (ops/pad.py:28) folded in (B8d + B9); the JAX package differentiates it
// by autodiff, which the adjoint entry replaces.  PSFs f[k] (Ly x Lx,
// correlation order), on an axis of length n padded by `front`
// (ops/nonsep.py:afb_axis_plan):
//
//   nonsep_afb:          y[k][o][o'] = sum_{a, b} f[k][a][b] X(2o + a - fy,
//                        2o' + b - fx), X(p, q) = x[src_y(p)][src_x(q)], a
//                        zero where either is -1; 'periodization' reads the
//                        axis evened by repeating its last sample, wrapped;
//   nonsep_afb_adjoint:  dx[i][j] = the sum of f[k][a][b] dy[k][o][o'] over
//                        the taps whose padded position maps to (i, j), a
//                        gather (no atomics): the direct position, and near
//                        an edge each pad position that copies the pixel
//                        (the evened copy of the last sample included).
//                        With per 2 on an axis it is the transpose of the
//                        separable split's plan there instead (K6's,
//                        ops/afb_sfb.py:afb_plan): 'periodization' with a
//                        filter longer than the evened axis, the
//                        reference's roll, zero pad and single fold, the
//                        backward of transforms/dtcwt_alt.py:quad_afb2d.
//
// The shared code is csrc/nonsep_stencil.cuh (corr and gather, templated on
// the axis map; K15 runs the same two with the synthesis's map).
//
// Bound: operations for the 16 10x10 PSFs of quad_afb2d_nonsep (2 * 1,600
// FLOP per output position against 4 bytes read and 64 written), bytes for
// K = 4 with short filters.  One thread computes all K outputs of a
// position from one read of each window sample (K fmas per load, the taps
// a shared-memory broadcast); the windows of neighbouring threads overlap
// and are re-read from L1.  Windows inside the plane skip the index math.
#include <cuda_runtime.h>

#include "nonsep_stencil.cuh"

namespace {

// `out` output positions; per 2 reads 2 out virtual ones (its fold)
inline AfbAxis afb_axis(int n, int front, int mode, int per, int shift,
                        int out, int L) {
  AfbAxis ax;
  ax.n = n;
  ax.front = front;
  ax.mode = mode;
  ax.per = per;
  ax.shift = shift;
  ax.nout = out;
  ax.umax = 2 * ((per == 2 ? 2 * out : out) - 1) + L - 1;
  return ax;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, C, H, W) at strides sx0..sx3; taps: Ly x Lx x K floats on the
// card; y: (N, C, K, Ho, Wo) at strides sy0, sy1, syk, sy2, sy3.
int nonsep_afb(const void* x, void* y, const void* taps, int K, int Ly,
               int Lx, long long N, int C, int H, int W, long long sx0,
               long long sx1, long long sx2, long long sx3, int Ho, int Wo,
               int fy, int fx, int mode, int per, long long sy0,
               long long sy1, long long syk, long long sy2, long long sy3,
               void* stream) {
  if (K < 1 || K > 16 || Ly < 1 || Lx < 1 || fy < 0 || fx < 0 || H < 1 ||
      W < 1 || per < 0 || per > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  StencilArgs<AfbAxis> a;
  a.in = static_cast<const float*>(x);
  a.out = static_cast<float*>(y);
  a.taps = static_cast<const float*>(taps);
  a.K = K;
  a.Ly = Ly;
  a.Lx = Lx;
  a.C = C;
  a.Hi = H;
  a.Wi = W;
  a.Ho = Ho;
  a.Wo = Wo;
  a.planes = N * C;
  a.si0 = sx0; a.si1 = sx1; a.sik = 0; a.si2 = sx2; a.si3 = sx3;
  a.so0 = sy0; a.so1 = sy1; a.sok = syk; a.so2 = sy2; a.so3 = sy3;
  a.y = afb_axis(H, fy, mode, per, 0, Ho, Ly);
  a.x = afb_axis(W, fx, mode, per, 0, Wo, Lx);
  const long long per_plane = (long long)Ho * Wo;
  if (per_plane == 0 || a.planes == 0) return 0;
  const int smem = (int)(sizeof(float) * K * Ly * Lx);
  if (K <= 4)
    return stencil_launch(nonsep_corr_kernel<4, AfbAxis, int>,
                          nonsep_corr_kernel<4, AfbAxis, long long>,
                          per_plane, a.planes, smem, a, stream);
  return stencil_launch(nonsep_corr_kernel<16, AfbAxis, int>,
                        nonsep_corr_kernel<16, AfbAxis, long long>,
                        per_plane, a.planes, smem, a, stream);
}

// dy: (N, C, K, Ho, Wo) at strides sd0, sd1, sdk, sd2, sd3; dx: (N, C, H,
// W) at strides sx0..sx3; the plan of nonsep_afb, or per axis (py, px)
// of the separable split (2, with its roll shy / shx).
int nonsep_afb_adjoint(const void* dy, void* dx, const void* taps, int K,
                       int Ly, int Lx, long long N, int C, int Ho, int Wo,
                       long long sd0, long long sd1, long long sdk,
                       long long sd2, long long sd3, int H, int W, int fy,
                       int fx, int mode, int py, int px, int shy, int shx,
                       long long sx0, long long sx1, long long sx2,
                       long long sx3, void* stream) {
  if (K < 1 || K > 16 || Ly < 1 || Lx < 1 || fy < 0 || fx < 0 || Ho < 1 ||
      Wo < 1 || py < 0 || py > 2 || px < 0 || px > 2 || shy < 0 ||
      shx < 0 || (py == 2 && (Ly <= H + (H & 1) || 2 * Ho != H + (H & 1))) ||
      (px == 2 && (Lx <= W + (W & 1) || 2 * Wo != W + (W & 1))))
    return static_cast<int>(cudaErrorInvalidValue);
  StencilArgs<AfbAxis> a;
  a.in = static_cast<const float*>(dy);
  a.out = static_cast<float*>(dx);
  a.taps = static_cast<const float*>(taps);
  a.K = K;
  a.Ly = Ly;
  a.Lx = Lx;
  a.C = C;
  a.Hi = py == 2 ? 2 * Ho : Ho;
  a.Wi = px == 2 ? 2 * Wo : Wo;
  a.Ho = H;
  a.Wo = W;
  a.planes = N * C;
  a.si0 = sd0; a.si1 = sd1; a.sik = sdk; a.si2 = sd2; a.si3 = sd3;
  a.so0 = sx0; a.so1 = sx1; a.sok = 0; a.so2 = sx2; a.so3 = sx3;
  a.y = afb_axis(H, fy, mode, py, shy, Ho, Ly);
  a.x = afb_axis(W, fx, mode, px, shx, Wo, Lx);
  const long long per_plane = (long long)H * W;
  if (per_plane == 0 || a.planes == 0) return 0;
  const int smem = (int)(sizeof(float) * K * Ly * Lx);
  return stencil_launch(nonsep_gather_kernel<AfbAxis, int>,
                        nonsep_gather_kernel<AfbAxis, long long>, per_plane,
                        a.planes, smem, a, stream);
}

}  // extern "C"
