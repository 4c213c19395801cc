// K14 nonsep_afb: one level of 2-D analysis as a single stride-(2, 2)
// correlation of each (N, C) plane with a stack of K point-spread functions
// (PSFs), every boundary mode folded into the staging, and its exact
// transpose.
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
//                        the taps whose padded position maps to (i, j): the
//                        direct position (u, v) = (i + fy, j + fx), and near
//                        an edge each pad position that copies the pixel
//                        (the evened copy of the last sample included).
//                        With per 2 on an axis it is the transpose of the
//                        separable split's plan there instead (K6's,
//                        ops/afb_sfb.py:afb_plan): 'periodization' with a
//                        filter longer than the evened axis, the
//                        reference's roll, zero pad and single fold, the
//                        backward of transforms/dtcwt_alt.py:quad_afb2d.
//
// Bound: operations for the 16 10x10 PSFs of quad_afb2d_nonsep (2 * 1,600
// FLOP per output position against 4 bytes read and 64 written), bytes
// for K = 4 with short filters (db4: 512 FLOP against 32 bytes).  So the
// design aims at the FMA rate, on the CUDA cores: K14 is held to fp32
// within 1e-5, which TF32 does not meet.
//
// Both tiles live in nonsep_tile.cuh, which K15 (nonsep_sfb.cu) runs
// too with its own maps: the forward's staging is templated on the axis
// map (AfbAxis here), the adjoint's store on the output map (here the
// direct position, never wrapped).
//
// Forward, afb_tile_kernel<KMAX, AfbAxis> (KMAX = 4 or 16: K padded with
// zero PSFs).  A block of BX x BY threads takes TY x TX = (PY BY) x BX output
// positions.  It stages their input window, (2 TY + Ly - 2) x (2 TX + Lx -
// 2) samples, in shared memory once, with each row's and each column's
// source (AfbAxis::src: every pad mode, 'periodization''s evening and
// wrap) computed once a tile and -1 staged as zero; the samples (and the
// taps) are copied by 4-byte (16-byte) cp.async, so a tile's loads are in
// flight together and the block waits once.  Columns are stored
// split by parity, so a tap's stride-2 reads are consecutive across a
// warp; the row pitch is chosen so that the 32 / BX thread rows of a warp
// fall on distinct banks.  Each thread computes PY = 4 positions (rows ty
// + BY p) x KMAX PSFs in registers: per tap, KMAX / 4 float4 broadcasts of
// the taps (laid out Ly x Lx x KMAX, K innermost) and PY window reads feed
// PY * KMAX FMAs (8 shared reads per 64 FMAs for K = 16).  The wrapper
// (ops/nonsep.py:afb_tile) chooses (BX, BY) by the positions the tiles
// cover, the FMAs and the staged samples.
//
// Adjoint, the polyphase identity (afb_adjoint_tile_kernel<KMAX, false>).
// With u = 2U + du and v = 2V + dv the direct padded position of a pixel,
//   dX(u, v) = sum_{alpha, beta, k} f[k][2 alpha + du][2 beta + dv]
//              dy[k][U - alpha][V - beta],
// dy read as zero outside its plane.  A block of BX x BY threads takes TQY
// x TQX = (PY BY) x BX quads, 2 TQY x 2 TQX pixels, and stages the K
// cotangent planes' window, (TQY + ceil(Ly/2) - 1) x (TQX + ceil(Lx/2) -
// 1), in shared memory once, K innermost in float4 groups.  Each thread
// computes PY quads (all four parities): per (alpha, beta) and group of 4
// PSFs, one float4 of the cotangent per quad, used by the four pixels, and
// the four parities' taps as float4 broadcasts (8 shared reads per 64
// FMAs).  This is the whole sum wherever the direct position is a pixel's
// only image.
//
// Pixels near an edge (the band): afb_adjoint_band_kernel keeps
// nonsep_stencil.cuh's gather (gather_window) over the band only.  The
// wrapper (ops/nonsep.py:adjoint_interior) gives each axis' interior,
// outside which a pixel may have pad images, and (ops/nonsep.py:
// band_images) a table of every band pixel's images along the axis, the
// positions u with src(u) = t, built on the host once per plan: no edge
// scan on the card.  Where both axes have a direct position (per 0 or 1),
// the polyphase kernel writes every pixel and the band kernel adds each
// band pixel's other image pairs (add_extras); where an axis takes the
// separable split's single fold (per 2: every pixel's positions come from
// the roll, and the cotangent rows from cot()), the band is the whole
// plane and the band kernel writes the full gather.  Launched in that
// order on one stream: no atomics, and the adjoint stays the exact
// transpose.
//
// This file takes AfbAxis and the band's gather (gather_window) from
// nonsep_stencil.cuh.
//
// Indices along an axis are 32-bit (the host keeps H, W below 2^30),
// element offsets 64-bit, so planes past 2^31 outputs take the same code;
// tiles and planes past the grid's limits loop.
#include <cuda_runtime.h>

#include "nonsep_tile.cuh"

namespace {

// `out` output positions; per 2 reads 2 out virtual ones (its fold)
inline AfbAxis afb_axis(int n, int front, int mode, int per, int shift,
                        int out) {
  AfbAxis ax;
  ax.n = n;
  ax.front = front;
  ax.mode = mode;
  ax.per = per;
  ax.shift = shift;
  ax.nout = out;
  return ax;
}

// The band: pixels outside the interior rectangle [y0, y1) x [x0, x1),
// each summing gather windows over its image pairs.  Along an axis a pixel
// t inside the interior has one image, t + front; one outside it has the
// table's row (t, or lo + t - hi past the interior), up to m positions,
// -1 past its last.  add_extras: the polyphase kernel wrote the direct
// pair, so add the others; else write the whole sum (a per-2 axis).
struct BandArgs {
  const int* tab_y;
  const int* tab_x;
  int y0, y1, x0, x1, my, mx, add_extras;
  long long nband;
};

__device__ __forceinline__ const int* band_row(const int* tab, int t, int lo,
                                               int hi, int m) {
  return tab + (long long)(t < lo ? t : lo + t - hi) * m;
}

template <typename I>
__global__ void afb_adjoint_band_kernel(StencilArgs<AfbAxis> a, BandArgs b) {
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
      const int uy = ty + a.y.front, vx = tx + a.x.front;
      const bool iny = ty >= b.y0 && ty < b.y1, inx = tx >= b.x0 && tx < b.x1;
      const int* ly = iny ? nullptr : band_row(b.tab_y, ty, b.y0, b.y1, b.my);
      const int* lx = inx ? nullptr : band_row(b.tab_x, tx, b.x0, b.x1, b.mx);
      const int ny = iny ? 1 : b.my, nx = inx ? 1 : b.mx;
      float acc = 0.f;
      for (int i = 0; i < ny; ++i) {
        const int u = iny ? uy : ly[i];
        if (u < 0) break;
        for (int j = 0; j < nx; ++j) {
          const int v = inx ? vx : lx[j];
          if (v < 0) break;
          if (!(b.add_extras && u == uy && v == vx))
            acc += gather_window(a, tp, gp, u, v);
        }
      }
      float* o = yp + ty * a.so2 + tx * a.so3;
      *o = b.add_extras ? *o + acc : acc;
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, C, H, W) at strides sx0..sx3; taps: Ly x Lx x K floats on the
// card; y: (N, C, K, Ho, Wo) at strides sy0, sy1, syk, sy2, sy3; (bx, by):
// the block's threads (ops/nonsep.py:afb_tile).
int nonsep_afb(const void* x, void* y, const void* taps, int K, int Ly,
               int Lx, long long N, int C, int H, int W, long long sx0,
               long long sx1, long long sx2, long long sx3, int Ho, int Wo,
               int fy, int fx, int mode, int per, int bx, int by,
               long long sy0, long long sy1, long long syk, long long sy2,
               long long sy3, void* stream) {
  const int kmax = K <= 4 ? 4 : 16;
  if (K < 1 || K > 16 || Ly < 1 || Lx < 1 || fy < 0 || fx < 0 || H < 1 ||
      W < 1 || per < 0 || per > 1 || !tile_ok(bx, by) ||
      fwd_smem(kmax, Ly, Lx, bx, by) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs<AfbAxis> a;
  a.in = static_cast<const float*>(x);
  a.out = static_cast<float*>(y);
  a.taps = static_cast<const float*>(taps);
  a.K = K;
  a.Ly = Ly;
  a.Lx = Lx;
  a.C = C;
  a.Ho = Ho;
  a.Wo = Wo;
  a.rows_w = 2 * PY * by + Ly - 2;
  a.cols_w = 2 * bx + Lx - 2;
  a.pitch = fwd_pitch(a.cols_w, bx);
  a.planes = N * C;
  a.si0 = sx0; a.si1 = sx1; a.si2 = sx2; a.si3 = sx3;
  a.so0 = sy0; a.so1 = sy1; a.sok = syk; a.so2 = sy2; a.so3 = sy3;
  a.y = afb_axis(H, fy, mode, per, 0, Ho);
  a.x = afb_axis(W, fx, mode, per, 0, Wo);
  if ((long long)Ho * Wo == 0 || a.planes == 0) return 0;
  const size_t smem = fwd_smem(kmax, Ly, Lx, bx, by);
  const dim3 grid(clamp_grid((Wo + bx - 1) / bx, 2147483647LL),
                  clamp_grid((Ho + PY * by - 1) / (PY * by), 65535),
                  clamp_grid(a.planes, 65535));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (kmax == 4) {
    if ((rc = set_smem(afb_tile_kernel<4, AfbAxis>, smem))) return rc;
    afb_tile_kernel<4, AfbAxis><<<grid, dim3(bx, by), smem, st>>>(a);
  } else {
    if ((rc = set_smem(afb_tile_kernel<16, AfbAxis>, smem))) return rc;
    afb_tile_kernel<16, AfbAxis><<<grid, dim3(bx, by), smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// dy: (N, C, K, Ho, Wo) at strides sd0, sd1, sdk, sd2, sd3; dx: (N, C, H,
// W) at strides sx0..sx3; the plan of nonsep_afb, or per axis (py, px)
// of the separable split (2, with its roll shy / shx); each axis'
// interior [y0, y1), [x0, x1) of pixels whose only image is the direct
// position (ops/nonsep.py:adjoint_interior; empty on a per-2 axis) and
// the table of the images of the pixels outside it (tab_y: H - (y1 - y0)
// rows of my positions, ops/nonsep.py:band_images; may be null where
// every pixel is interior); (bx, by): the polyphase kernel's block
// (ops/nonsep.py:adjoint_tile).
int nonsep_afb_adjoint(const void* dy, void* dx, const void* taps, int K,
                       int Ly, int Lx, long long N, int C, int Ho, int Wo,
                       long long sd0, long long sd1, long long sdk,
                       long long sd2, long long sd3, int H, int W, int fy,
                       int fx, int mode, int py, int px, int shy, int shx,
                       int y0, int y1, int x0, int x1, const void* tab_y,
                       int my, const void* tab_x, int mx, int bx, int by,
                       long long sx0, long long sx1, long long sx2,
                       long long sx3, void* stream) {
  const int kmax = K <= 4 ? 4 : 16;
  const bool poly = py < 2 && px < 2;
  if (K < 1 || K > 16 || Ly < 1 || Lx < 1 || fy < 0 || fx < 0 || Ho < 1 ||
      Wo < 1 || py < 0 || py > 2 || px < 0 || px > 2 || shy < 0 ||
      shx < 0 || (py == 2 && (Ly <= H + (H & 1) || 2 * Ho != H + (H & 1))) ||
      (px == 2 && (Lx <= W + (W & 1) || 2 * Wo != W + (W & 1))) ||
      y0 < 0 || y0 > y1 || y1 > H || x0 < 0 || x0 > x1 || x1 > W ||
      (py == 2 && y0 != y1) || (px == 2 && x0 != x1) ||
      ((y1 - y0 < H) && (!tab_y || my < 1)) ||
      ((x1 - x0 < W) && (!tab_x || mx < 1)) ||
      (poly && (!tile_ok(bx, by) || adj_smem(kmax, Ly, Lx, bx, by) >
                                        SMEM_MAX)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)H * W == 0 || N * C == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (poly) {
    AdjArgs a;
    a.in = static_cast<const float*>(dy);
    a.out = static_cast<float*>(dx);
    a.taps = static_cast<const float*>(taps);
    a.K = K;
    a.Ly = Ly;
    a.Lx = Lx;
    a.C = C;
    a.Hi = Ho;
    a.Wi = Wo;
    a.H = H;
    a.W = W;
    a.fy = fy;
    a.fx = fx;
    a.Ay = (Ly + 1) / 2;
    a.Ax = (Lx + 1) / 2;
    // every pixel: quads of u = i + fy over [fy, H - 1 + fy]
    a.U0 = fy / 2;
    a.nU = (H - 1 + fy) / 2 - a.U0 + 1;
    a.V0 = fx / 2;
    a.nV = (W - 1 + fx) / 2 - a.V0 + 1;
    a.rows = PY * by + a.Ay - 1;
    a.cols = bx + a.Ax - 1;
    a.planes = N * C;
    a.si0 = sd0; a.si1 = sd1; a.sik = sdk; a.si2 = sd2; a.si3 = sd3;
    a.so0 = sx0; a.so1 = sx1; a.so2 = sx2; a.so3 = sx3;
    const size_t smem = adj_smem(kmax, Ly, Lx, bx, by);
    const dim3 grid(clamp_grid((a.nV + bx - 1) / bx, 2147483647LL),
                    clamp_grid((a.nU + PY * by - 1) / (PY * by), 65535),
                    clamp_grid(a.planes, 65535));
    if (kmax == 4) {
      if ((rc = set_smem(afb_adjoint_tile_kernel<4, false>, smem))) return rc;
      afb_adjoint_tile_kernel<4, false><<<grid, dim3(bx, by), smem, st>>>(a);
    } else {
      if ((rc = set_smem(afb_adjoint_tile_kernel<16, false>, smem))) return rc;
      afb_adjoint_tile_kernel<16, false><<<grid, dim3(bx, by), smem, st>>>(a);
    }
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  }
  BandArgs b;
  b.tab_y = static_cast<const int*>(tab_y);
  b.tab_x = static_cast<const int*>(tab_x);
  b.y0 = y0;
  b.y1 = y1;
  b.x0 = x0;
  b.x1 = x1;
  b.my = my;
  b.mx = mx;
  b.add_extras = poly;
  b.nband = (long long)H * W - (long long)(y1 - y0) * (x1 - x0);
  if (b.nband == 0) return 0;
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
  a.y = afb_axis(H, fy, mode, py, shy, Ho);
  a.x = afb_axis(W, fx, mode, px, shx, Wo);
  const int smem = (int)(sizeof(float) * K * Ly * Lx);
  void (*k)(StencilArgs<AfbAxis>, BandArgs) =
      b.nband < (1LL << 30) ? afb_adjoint_band_kernel<int>
                            : afb_adjoint_band_kernel<long long>;
  if ((rc = set_smem(k, smem))) return rc;
  k<<<dwt_grid(b.nband, a.planes, 256), 256, smem, st>>>(a, b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
