// K15 nonsep_sfb: one level of 2-D synthesis as a single transposed
// filtering: the 4 bands, dilated by 2, each convolved with its (Ly x Lx)
// outer-product filter and summed, with the 'periodization' wrap-add and
// roll folded into the output index; and its exact transpose.
//
// Replaces pytorch_wavelets_tpu/ops/afb_sfb.py:sfb2d_nonsep (l.527: one
// lhs-dilated conv_general_dilated with the bands as input channels, pads
// (1, 1) or (L - 1, L - 1), then the wrap-add and roll of l.554-561; B8d),
// which the JAX package differentiates by autodiff.  With Y(u, v) =
// sum_band sum_{i, j} c[band][i][j] f[band][u - 2i][v - 2j], the full
// transposed convolution, and K7's plan on each axis (ops/afb_sfb.py:
// sfb_plan: s, wrap, r0, fold):
//
//   nonsep_sfb:          y[n][m] = sum of Y(u, v) over u in {t + s,
//                        t + s + wrap if t < fold}, t = n (or (n + r0) mod
//                        wrap for 'periodization'), and v likewise: a
//                        gather of at most 2 x 2 windows, no atomics and
//                        no second pass;
//   nonsep_sfb_adjoint:  dc[band][i][j] = sum_{a, b} f[band][a][b]
//                        dY(2i + a, 2j + b), dY(u, v) = dy at the output
//                        (u, v) lands on (0 where it is cropped): a
//                        stride-(2, 2) correlation of dy, all 4 bands from
//                        one read of each window.
//
// Both are csrc/nonsep_stencil.cuh's stencils (K14's code) with the
// synthesis's axis map (SfbAxis) in place of the analysis pads.
//
// Bound: bytes for the DWT's filters (db4: 4 * 16 fmas per output against
// 20 bytes moved); the 4 bands' windows are re-read from L1.
#include <cuda_runtime.h>

#include "nonsep_stencil.cuh"

namespace {

inline SfbAxis sfb_axis(int out, int s, int wrap, int r0, int fold,
                        int per) {
  SfbAxis ax;
  ax.out = out;
  ax.s = s;
  ax.wrap = wrap;
  ax.r0 = r0;
  ax.fold = fold;
  ax.per = per;
  return ax;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// c: (N, C, 4, Ny, Nx) at strides sc0, sc1, scb, sc2, sc3; taps: Ly x Lx x
// 4 floats on the card; each axis' plan (out, s, wrap, r0, fold); y: (N,
// C, Hout, Wout) at strides sy0..sy3.
int nonsep_sfb(const void* c, void* y, const void* taps, int Ly, int Lx,
               long long N, int C, int Ny, int Nx, long long sc0,
               long long sc1, long long scb, long long sc2, long long sc3,
               int Hout, int s_y, int wrap_y, int r0_y, int fold_y, int Wout,
               int s_x, int wrap_x, int r0_x, int fold_x, int per,
               long long sy0, long long sy1, long long sy2, long long sy3,
               void* stream) {
  if (Ly < 1 || Lx < 1 || Ny < 1 || Nx < 1 || s_y < 0 || s_x < 0 ||
      (per && (wrap_y < 1 || wrap_x < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  StencilArgs<SfbAxis> a;
  a.in = static_cast<const float*>(c);
  a.out = static_cast<float*>(y);
  a.taps = static_cast<const float*>(taps);
  a.K = 4;
  a.Ly = Ly;
  a.Lx = Lx;
  a.C = C;
  a.Hi = Ny;
  a.Wi = Nx;
  a.Ho = Hout;
  a.Wo = Wout;
  a.planes = N * C;
  a.si0 = sc0; a.si1 = sc1; a.sik = scb; a.si2 = sc2; a.si3 = sc3;
  a.so0 = sy0; a.so1 = sy1; a.sok = 0; a.so2 = sy2; a.so3 = sy3;
  a.y = sfb_axis(Hout, s_y, wrap_y, r0_y, fold_y, per);
  a.x = sfb_axis(Wout, s_x, wrap_x, r0_x, fold_x, per);
  const long long per_plane = (long long)Hout * Wout;
  if (per_plane <= 0 || a.planes == 0) return 0;
  const int smem = (int)(sizeof(float) * 4 * Ly * Lx);
  return stencil_launch(nonsep_gather_kernel<SfbAxis, int>,
                        nonsep_gather_kernel<SfbAxis, long long>, per_plane,
                        a.planes, smem, a, stream);
}

// dy: (N, C, Hout, Wout) at strides sd0..sd3; dc: (N, C, 4, Ny, Nx) at
// strides sc0, sc1, scb, sc2, sc3; the plans of nonsep_sfb.
int nonsep_sfb_adjoint(const void* dy, void* dc, const void* taps, int Ly,
                       int Lx, long long N, int C, int Hout, int Wout,
                       long long sd0, long long sd1, long long sd2,
                       long long sd3, int Ny, int Nx, int out_y, int s_y,
                       int wrap_y, int r0_y, int fold_y, int out_x, int s_x,
                       int wrap_x, int r0_x, int fold_x, int per,
                       long long sc0, long long sc1, long long scb,
                       long long sc2, long long sc3, void* stream) {
  if (Ly < 1 || Lx < 1 || out_y != Hout || out_x != Wout || s_y < 0 ||
      s_x < 0 || (per && (wrap_y < 1 || wrap_x < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  StencilArgs<SfbAxis> a;
  a.in = static_cast<const float*>(dy);
  a.out = static_cast<float*>(dc);
  a.taps = static_cast<const float*>(taps);
  a.K = 4;
  a.Ly = Ly;
  a.Lx = Lx;
  a.C = C;
  a.Hi = Hout;
  a.Wi = Wout;
  a.Ho = Ny;
  a.Wo = Nx;
  a.planes = N * C;
  a.si0 = sd0; a.si1 = sd1; a.sik = 0; a.si2 = sd2; a.si3 = sd3;
  a.so0 = sc0; a.so1 = sc1; a.sok = scb; a.so2 = sc2; a.so3 = sc3;
  a.y = sfb_axis(Hout, s_y, wrap_y, r0_y, fold_y, per);
  a.x = sfb_axis(Wout, s_x, wrap_x, r0_x, fold_x, per);
  const long long per_plane = (long long)Ny * Nx;
  if (per_plane == 0 || a.planes == 0) return 0;
  const int smem = (int)(sizeof(float) * 4 * Ly * Lx);
  return stencil_launch(nonsep_corr_kernel<4, SfbAxis, int>,
                        nonsep_corr_kernel<4, SfbAxis, long long>,
                        per_plane, a.planes, smem, a, stream);
}

}  // extern "C"
