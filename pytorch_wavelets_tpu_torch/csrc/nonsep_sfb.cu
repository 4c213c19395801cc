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
//                        wrap for 'periodization'), and v likewise;
//   nonsep_sfb_adjoint:  dc[band][i][j] = sum_{a, b} f[band][a][b]
//                        dY(2i + a, 2j + b), dY(u, v) = dy at the output
//                        (u, v) lands on (0 where it is cropped): a
//                        stride-(2, 2) correlation of dy, all 4 bands from
//                        one read of each window.
//
// Both run K14's staged tiles (csrc/nonsep_tile.cuh), the two functions
// being the same sums as K14's with another axis map:
//
// - The forward is the polyphase sum of K14's adjoint.  With u = 2U + du,
//   Y(u, v) = sum_band sum_{alpha, beta} f[band][2 alpha + du][2 beta +
//   dv] c[band][U - alpha][V - beta]: afb_adjoint_tile_kernel<4> with the
//   4 bands as its K planes, a quad of 2 x 2 positions from one staged
//   window of the bands.  Each output pixel has a direct position, n + s
//   outside 'periodization' (the crop an offset), (n + r0) mod wrap in it
//   (every position of [0, wrap) once, the roll an offset wrapped once at
//   the store, ROT): the tiles write it.  In 'periodization' the pixels
//   whose t < fold on an axis have a second position there, t + wrap (the
//   wrap-add); sfb_band_kernel adds their other position pairs after the
//   tiles, on one stream (no atomics), over the pixels outside the
//   interior rectangle [y0, y1) x [x0, x1) of pixels with one position,
//   each axis' positions read from a host table (ops/nonsep.py:
//   sfb_band_images: the direct position first), gathered by
//   nonsep_stencil.cuh's gather_window.
// - The adjoint is K14's forward: afb_tile_kernel<4, SfbAxis> stages each
//   tile's window of dy through SfbAxis::src (the output sample a
//   position lands on, -1 where cropped: the crop, the roll and the
//   wrap-add's second positions, the separable plan's single fold of a
//   long tail), each row's and column's source computed once a tile, and
//   each thread computes 4 rows of positions x the 4 bands.  Every plan
//   and PSF shape (one-tap axes of sfb1d's backward included) takes it.
//
// Bound: bytes for the DWT's filters (db4: 4 * 16 FMAs per output pixel
// against 20 bytes moved).  The first design (one output a thread,
// nonsep_stencil.cuh's per-output gather and correlation, each window
// re-read from L1, an axis map with a modulo per pixel) ran at 11-22x
// it.  The wrappers choose the tiles (ops/nonsep.py:sfb_tile for the
// forward's quads, afb_tile for the adjoint), count them and pass them.
#include <cuda_runtime.h>

#include "nonsep_tile.cuh"

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

// The forward's band: pixels outside [y0, y1) x [x0, x1); along an axis a
// pixel inside its interior has one position, its direct one; a pixel
// outside it the table's row (t, or lo + t - hi past the interior), the
// direct position first, up to m of them, -1 past the last.
struct SfbBand {
  const int* tab_y;
  const int* tab_x;
  int y0, y1, x0, x1, my, mx;
  long long nband;
};

__device__ __forceinline__ int direct_pos(const SfbAxis& ax, int t) {
  if (!ax.per) return t + ax.s;
  const int u = t + ax.r0;
  return u >= ax.wrap ? u - ax.wrap : (u < 0 ? u + ax.wrap : u);
}

__device__ __forceinline__ const int* sfb_band_row(const int* tab, int t,
                                                   int lo, int hi, int m) {
  return tab + (long long)(t < lo ? t : lo + t - hi) * m;
}

template <typename I>
__global__ void sfb_band_kernel(StencilArgs<SfbAxis> a, SfbBand b) {
  extern __shared__ float tp[];
  stage_taps(a.taps, a.K * a.Ly * a.Lx, tp);
  const I top = (I)b.y0 * a.Wo, bottom = (I)(a.Ho - b.y1) * a.Wo;
  const int side = b.x0 + (a.Wo - b.x1);
  for (long long p = blockIdx.y; p < a.planes; p += gridDim.y) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* gp = a.in + nn * a.si0 + c * a.si1;
    float* yp = a.out + nn * a.so0 + c * a.so1;
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < (I)b.nband;
         idx += (I)gridDim.x * blockDim.x) {
      int ty, tx;
      if (idx < top) {
        ty = (int)(idx / a.Wo);
        tx = (int)(idx - (I)ty * a.Wo);
      } else if (idx - top < bottom) {
        const I e = idx - top;
        ty = b.y1 + (int)(e / a.Wo);
        tx = (int)(e - (I)(ty - b.y1) * a.Wo);
      } else {
        const I e = idx - top - bottom;
        const int r = (int)(e / side), q = (int)(e - (I)r * side);
        ty = b.y0 + r;
        tx = q < b.x0 ? q : b.x1 + (q - b.x0);
      }
      const bool iny = ty >= b.y0 && ty < b.y1, inx = tx >= b.x0 && tx < b.x1;
      const int uy = direct_pos(a.y, ty), vx = direct_pos(a.x, tx);
      const int* ly =
          iny ? nullptr : sfb_band_row(b.tab_y, ty, b.y0, b.y1, b.my);
      const int* lx =
          inx ? nullptr : sfb_band_row(b.tab_x, tx, b.x0, b.x1, b.mx);
      const int ny = iny ? 1 : b.my, nx = inx ? 1 : b.mx;
      float acc = 0.f;
      for (int i = 0; i < ny; ++i) {
        const int u = iny ? uy : ly[i];
        if (u < 0) break;
        for (int j = 0; j < nx; ++j) {
          const int v = inx ? vx : lx[j];
          if (v < 0) break;
          if (i || j)  // the tiles wrote the direct pair
            acc += gather_window(a, tp, gp, u, v);
        }
      }
      float* o = yp + ty * a.so2 + tx * a.so3;
      *o += acc;
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// c: (N, C, 4, Ny, Nx) at strides sc0, sc1, scb, sc2, sc3; taps: Ly x Lx x
// 4 floats on the card; each axis' plan (out, s, wrap, r0, fold); y: (N,
// C, Hout, Wout) at strides sy0..sy3; (bx, by): the polyphase tile's block
// (ops/nonsep.py:sfb_tile); in 'periodization' each axis' interior [y0,
// y1), [x0, x1) of pixels with one position (ops/nonsep.py:sfb_interior)
// and the table of the positions of the pixels outside it (tab_y: Hout -
// (y1 - y0) rows of my positions, ops/nonsep.py:sfb_band_images; null
// where every pixel is interior).
int nonsep_sfb(const void* c, void* y, const void* taps, int Ly, int Lx,
               long long N, int C, int Ny, int Nx, long long sc0,
               long long sc1, long long scb, long long sc2, long long sc3,
               int Hout, int s_y, int wrap_y, int r0_y, int fold_y, int Wout,
               int s_x, int wrap_x, int r0_x, int fold_x, int per,
               long long sy0, long long sy1, long long sy2, long long sy3,
               int bx, int by, int y0, int y1, const void* tab_y, int my,
               int x0, int x1, const void* tab_x, int mx, void* stream) {
  if (Ly < 1 || Lx < 1 || Ny < 1 || Nx < 1 || s_y < 0 || s_x < 0 ||
      (per && (wrap_y != 2 * Ny || wrap_x != 2 * Nx || Hout != wrap_y ||
               Wout != wrap_x || fold_y > wrap_y || fold_x > wrap_x ||
               r0_y < -1 || r0_y > Ny || r0_x < -1 || r0_x > Nx)) ||
      !tile_ok(bx, by) || adj_smem(4, Ly, Lx, bx, by) > SMEM_MAX ||
      y0 < 0 || y0 > y1 || y1 > Hout || x0 < 0 || x0 > x1 || x1 > Wout ||
      (!per && (y1 - y0 < Hout || x1 - x0 < Wout)) ||
      ((y1 - y0 < Hout) && (!tab_y || my < 2)) ||
      ((x1 - x0 < Wout) && (!tab_x || mx < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)Hout * Wout == 0 || N * C == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  AdjArgs a;
  a.in = static_cast<const float*>(c);
  a.out = static_cast<float*>(y);
  a.taps = static_cast<const float*>(taps);
  a.K = 4;
  a.Ly = Ly;
  a.Lx = Lx;
  a.C = C;
  a.Hi = Ny;
  a.Wi = Nx;
  a.H = Hout;
  a.W = Wout;
  a.Ay = (Ly + 1) / 2;
  a.Ax = (Lx + 1) / 2;
  if (per) {  // every position of [0, wrap): quads [0, N)
    a.fy = r0_y;
    a.fx = r0_x;
    a.U0 = a.V0 = 0;
    a.nU = Ny;
    a.nV = Nx;
  } else {    // positions [s, s + out)
    a.fy = s_y;
    a.fx = s_x;
    a.U0 = s_y / 2;
    a.nU = (Hout - 1 + s_y) / 2 - a.U0 + 1;
    a.V0 = s_x / 2;
    a.nV = (Wout - 1 + s_x) / 2 - a.V0 + 1;
  }
  a.rows = PY * by + a.Ay - 1;
  a.cols = bx + a.Ax - 1;
  a.planes = N * C;
  a.si0 = sc0; a.si1 = sc1; a.sik = scb; a.si2 = sc2; a.si3 = sc3;
  a.so0 = sy0; a.so1 = sy1; a.so2 = sy2; a.so3 = sy3;
  const size_t smem = adj_smem(4, Ly, Lx, bx, by);
  const dim3 grid(clamp_grid((a.nV + bx - 1) / bx, 2147483647LL),
                  clamp_grid((a.nU + PY * by - 1) / (PY * by), 65535),
                  clamp_grid(a.planes, 65535));
  int rc;
  if (per) {
    if ((rc = set_smem(afb_adjoint_tile_kernel<4, true>, smem))) return rc;
    afb_adjoint_tile_kernel<4, true><<<grid, dim3(bx, by), smem, st>>>(a);
  } else {
    if ((rc = set_smem(afb_adjoint_tile_kernel<4, false>, smem))) return rc;
    afb_adjoint_tile_kernel<4, false><<<grid, dim3(bx, by), smem, st>>>(a);
  }
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  SfbBand b;
  b.tab_y = static_cast<const int*>(tab_y);
  b.tab_x = static_cast<const int*>(tab_x);
  b.y0 = y0;
  b.y1 = y1;
  b.x0 = x0;
  b.x1 = x1;
  b.my = my;
  b.mx = mx;
  b.nband = (long long)Hout * Wout - (long long)(y1 - y0) * (x1 - x0);
  if (b.nband == 0) return 0;
  StencilArgs<SfbAxis> g;
  g.in = a.in;
  g.out = a.out;
  g.taps = a.taps;
  g.K = 4;
  g.Ly = Ly;
  g.Lx = Lx;
  g.C = C;
  g.Hi = Ny;
  g.Wi = Nx;
  g.Ho = Hout;
  g.Wo = Wout;
  g.planes = a.planes;
  g.si0 = sc0; g.si1 = sc1; g.sik = scb; g.si2 = sc2; g.si3 = sc3;
  g.so0 = sy0; g.so1 = sy1; g.sok = 0; g.so2 = sy2; g.so3 = sy3;
  g.y = sfb_axis(Hout, s_y, wrap_y, r0_y, fold_y, per);
  g.x = sfb_axis(Wout, s_x, wrap_x, r0_x, fold_x, per);
  const int tsmem = (int)(sizeof(float) * 4 * Ly * Lx);
  void (*k)(StencilArgs<SfbAxis>, SfbBand) =
      b.nband < (1LL << 30) ? sfb_band_kernel<int> : sfb_band_kernel<long long>;
  if ((rc = set_smem(k, tsmem))) return rc;
  k<<<dwt_grid(b.nband, g.planes, 256), 256, tsmem, st>>>(g, b);
  return static_cast<int>(cudaGetLastError());
}

// dy: (N, C, Hout, Wout) at strides sd0..sd3; dc: (N, C, 4, Ny, Nx) at
// strides sc0, sc1, scb, sc2, sc3; the plans of nonsep_sfb (or, where a
// 'periodization' tail is longer than the output, the separable merge's:
// one fold, the rest cut); (bx, by): the staged tile's block
// (ops/nonsep.py:afb_tile).
int nonsep_sfb_adjoint(const void* dy, void* dc, const void* taps, int Ly,
                       int Lx, long long N, int C, int Hout, int Wout,
                       long long sd0, long long sd1, long long sd2,
                       long long sd3, int Ny, int Nx, int out_y, int s_y,
                       int wrap_y, int r0_y, int fold_y, int out_x, int s_x,
                       int wrap_x, int r0_x, int fold_x, int per,
                       long long sc0, long long sc1, long long scb,
                       long long sc2, long long sc3, int bx, int by,
                       void* stream) {
  if (Ly < 1 || Lx < 1 || out_y != Hout || out_x != Wout || s_y < 0 ||
      s_x < 0 || (per && (wrap_y < 1 || wrap_x < 1)) || !tile_ok(bx, by) ||
      fwd_smem(4, Ly, Lx, bx, by) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)Ny * Nx == 0 || N * C == 0) return 0;
  FwdArgs<SfbAxis> a;
  a.in = static_cast<const float*>(dy);
  a.out = static_cast<float*>(dc);
  a.taps = static_cast<const float*>(taps);
  a.K = 4;
  a.Ly = Ly;
  a.Lx = Lx;
  a.C = C;
  a.Ho = Ny;
  a.Wo = Nx;
  a.rows_w = 2 * PY * by + Ly - 2;
  a.cols_w = 2 * bx + Lx - 2;
  a.pitch = fwd_pitch(a.cols_w, bx);
  a.planes = N * C;
  a.si0 = sd0; a.si1 = sd1; a.si2 = sd2; a.si3 = sd3;
  a.so0 = sc0; a.so1 = sc1; a.sok = scb; a.so2 = sc2; a.so3 = sc3;
  a.y = sfb_axis(Hout, s_y, wrap_y, r0_y, fold_y, per);
  a.x = sfb_axis(Wout, s_x, wrap_x, r0_x, fold_x, per);
  const size_t smem = fwd_smem(4, Ly, Lx, bx, by);
  const dim3 grid(clamp_grid((Nx + bx - 1) / bx, 2147483647LL),
                  clamp_grid((Ny + PY * by - 1) / (PY * by), 65535),
                  clamp_grid(a.planes, 65535));
  int rc;
  if ((rc = set_smem(afb_tile_kernel<4, SfbAxis>, smem))) return rc;
  afb_tile_kernel<4, SfbAxis><<<grid, dim3(bx, by), smem,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
