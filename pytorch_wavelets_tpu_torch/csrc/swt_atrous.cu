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
// axis padded by front = (L d)/2 before and back = L d - d - (L d)/2
// after:
//
//   swt_sfb:          y[m] = sum_k g0[k] LO(m + k d - front)
//                            + sum_k g1[k] HI(m + k d - front), m < n,
//                     LO, HI read as X above, each through its own strides;
//   swt_sfb_adjoint:  dlo[t] = sum over (m, k) whose padded index maps to
//                     t of g0[k] dy[m], dhi[t] the same with g1.
//
// Both run one tile engine, a dilated correlation with NI inputs and NO
// outputs, out_o[m] = sum_i sum_k T[i][o][k] X_i(m + k d - F): the merge
// with (NI, NO) = (2, 1), T = (g0, g1), F = front and the mode's pads; the
// adjoint's direct images (each t read at padded position t) with (1, 2),
// T = (g0, g1) reversed, F = back and zeros outside [0, n), since there
// dlo[t] = sum_k g0[L-1-k] dy[t - back + k d].  The other images of t
// (the pad positions whose source is t) exist only within the pads' reach
// of an axis end; the host lists them per (n, L, d, mode)
// (ops/afb_sfb.py:merge_band_images: reflected and wrapped images, the
// whole pad run in 'replicate', several periods when a pad is longer than
// the axis), and merge_band_kernel adds their windows after the tiles.
//
// Bound: bytes (2 * 8 multiply-adds per output against 12 bytes for db4).
// The first design re-read every tap's sample from L2 (the reads, not
// DRAM, held it at 5.4x its bound).  Outputs m = r (mod d) read only the
// inputs of one residue class, so each thread walks a d-strided
// subsequence with the window undilated within it:
//
// - Column entry (axis 2), merge_col_kernel.  A 3-D grid of column tiles
//   x (residue, chunk) tiles x planes.  Each thread owns V columns (V =
//   4, one float4, where every input's rows are 16-byte aligned with
//   stride 1 along W; else 1, any strides) and MRC = 4 outputs r + d (c
//   MRC + o), holding the input rows of a block of MRC taps in registers
//   and loading the next MRC rows before the block's FMAs
//   (csrc/dtcwt_filt.cu's column kernel with rows d apart): each input
//   row is loaded once a tile plus its (L - 1)-row halo, each load feeds
//   MRC V NO FMAs, and the pad map is applied once per loaded row.  (8
//   outputs a thread held the forward at 154 registers and was 9%
//   slower.)
// - Row entry (axis 3), merge_row_kernel.  A block takes TR = 32 rows,
//   one a lane, and G residues (a power of two, G = d for d <= 16) x S
//   positions of each row: the outputs rho0 + g + d (P0 + s), one
//   contiguous run of G S outputs when G = d.  It stages each row's
//   samples of those subsequences, G (S + L - 1) a row and input (the
//   contiguous segment the tile reads when G = d), a 4-byte cp.async a
//   sample, every copy of the block in flight together (a warp copies 128
//   contiguous bytes of a row), the pad map applied once per sample
//   outside the axis.  Each thread then runs the column kernel's window
//   over its own row, MR outputs of one residue: a warp reads one sample
//   of 32 rows at a time, on 32 distinct banks as the row pitch is odd.
//   The outputs go through a shared tile and leave it as contiguous runs
//   of the row (a warp stores 128 contiguous bytes when G = d).  The host
//   picks (G, S) (ops/afb_sfb.py:merge_row_tile) within a budget of
//   shared memory.  The tile is bound by its instruction rate, not by
//   the shared memory, so the staging keeps the index math per sample
//   small: where G = d it indexes the run directly (with stride 1 along
//   W, row_run, inside the axis, a walk along one pointer; row_gather
//   maps each sample), and the edge samples take merge_src's
//   division-free map.
//   On swt_sfb's rows (32x3x256^2, db4; tools/stencil_probe.py, H100)
//   that took the merge's row entry from 0.077 to 0.060 ms: at 64
//   outputs a tile half the tiles of a 256-sample axis touch an edge,
//   and each of their samples had paid a 64-bit modulo.  (16-byte copies
//   into an aligned staging row, copied once more into the odd-pitch
//   rows, were slower: 0.141 ms.)
// - Stores of the column entry are float4 where the output view is
//   16-byte aligned with stride 1 along W, else scalar; the adjoint
//   writes the two bands of its (N, C, 2, H, W) stack.
// - Indices along an axis are 32-bit; positions d apart and element
//   offsets are 64-bit.  Tiles, rows and planes past the grid's limits
//   loop.
//
// The wrappers (ops/afb_sfb.py:sfb1d_atrous_conv / sfb1d_atrous_adjoint)
// choose the instantiation from the views and the tile (col_float4 /
// col_scalar along H, row_run / row_gather along W), count it and
// pass it as ``inst``, with the row tile and the band's table; the
// entries check them.
#include <cuda_runtime.h>

#include "stencil_tile.cuh"

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

// K16's tile engine: NI inputs, NO outputs, the taps T[i][o] at
// t[(i NO + o) L]
constexpr int MR = 8;     // outputs a thread walks (row tiles)
constexpr int MRC = 4;    // outputs a thread walks (column kernels)
constexpr int MCW = 32;   // threads along the columns (column kernel)
constexpr int MCT = 4;    // threads along the (residue, chunk) tiles

enum MergeInst {
  M_COL_SCALAR = 0,
  M_COL_FLOAT4 = 1,
  M_ROW_RUN = 2,
  M_ROW_GATHER = 3
};

struct MergeTile {
  const float* in[2];
  long long si[2][4];  // each input's (N, C, H, W) strides
  float* out[2];
  long long so[4];     // the outputs' strides (the adjoint's two bands)
  int L, d, F, n, mode, C, H, W, store4;
  int G, gs, S, seg, pitch_in, pitch_out, unit;  // the row tile
  long long planes;
};

struct MergeTaps {
  float t[2 * DWT_MAX_TAPS];
};

// The source of padded position q (-1: a zero), the map applied once per
// loaded row or staged sample: within one axis length of the signal in
// 32-bit arithmetic with one reflection or wrap at most, past it by
// pad_src (a 64-bit modulo).
__device__ __forceinline__ int merge_src(long long q, int n, int mode) {
  if (q >= 0 && q < n) return (int)q;
  if (q >= -n && q < 2LL * n) {
    const int i = (int)q;
    int r;
    switch (mode) {
      case PAD_ZERO:
        return -1;
      case PAD_SYMMETRIC:
        return i < 0 ? -1 - i : 2 * n - 1 - i;
      case PAD_REFLECT:
        r = n == 1 ? 0 : (i < 0 ? -i : 2 * n - 2 - i);
        break;
      case PAD_PERIODIC:
        return i < 0 ? i + n : i - n;
      default:
        return i < 0 ? 0 : n - 1;
    }
    if (r >= 0 && r < n) return r;
  }
  return pad_src(q, n, mode);
}

template <int NI, int NO, int V>
__global__ void __launch_bounds__(MCW* MCT)
    merge_col_kernel(MergeTile a, MergeTaps tp) {
  __shared__ float t[2 * DWT_MAX_TAPS];
  const int tid = threadIdx.y * MCW + threadIdx.x;
  for (int k = tid; k < NI * NO * a.L; k += MCW * MCT) t[k] = tp.t[k];
  __syncthreads();
  const int j0 = (blockIdx.x * MCW + threadIdx.x) * V;
  if (j0 >= a.W) return;
  const int ncols = a.W - j0 < V ? a.W - j0 : V;
  const int nres = a.d < a.n ? a.d : a.n;
  // (residue, chunk) tiles: at most n + nres, 32-bit
  const int ntiles = nres * (((a.n + a.d - 1) / a.d + MRC - 1) / MRC);
  for (long long p = blockIdx.z; p < a.planes; p += gridDim.z) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* xp[NI];
    float* yp[NO];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      xp[i] = a.in[i] + nn * a.si[i][0] + c * a.si[i][1] + j0 * a.si[i][3];
#pragma unroll
    for (int o = 0; o < NO; ++o)
      yp[o] = a.out[o] + nn * a.so[0] + c * a.so[1] + j0 * a.so[3];
    for (int ti = blockIdx.y * MCT + threadIdx.y; ti < ntiles;
         ti += gridDim.y * MCT) {
      // outputs m0 + d o: residue ti % nres, chunk ti / nres
      const long long m0 = ti % nres + (long long)a.d * MRC * (ti / nres);
      float acc[NO][MRC][V];
#pragma unroll
      for (int u = 0; u < NO; ++u)
#pragma unroll
        for (int o = 0; o < MRC; ++o)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[u][o][v] = 0.f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        // w[e] holds X_i(q0 + d (kb + e)): the MRC rows of the taps kb ..
        // kb + MRC - 1, then the next MRC, loaded before those taps' FMAs
        const long long q0 = m0 - a.F;
        float w[2 * MRC][V];
#pragma unroll
        for (int o = 0; o < MRC; ++o)
          load_row<V>(w[o], xp[i], merge_src(q0 + (long long)a.d * o, a.n,
                                             a.mode),
                      a.si[i][2], a.si[i][3], ncols);
        for (int kb = 0; kb < a.L; kb += MRC) {
#pragma unroll
          for (int q = MRC; q < 2 * MRC; ++q)
            if (kb + q <= a.L + MRC - 2)  // the last row an output reads
              load_row<V>(w[q], xp[i],
                          merge_src(q0 + (long long)a.d * (kb + q), a.n,
                                    a.mode),
                          a.si[i][2], a.si[i][3], ncols);
#pragma unroll
          for (int kk = 0; kk < MRC; ++kk) {
            if (kb + kk < a.L) {
#pragma unroll
              for (int u = 0; u < NO; ++u) {
                const float tk = t[(i * NO + u) * a.L + kb + kk];
#pragma unroll
                for (int o = 0; o < MRC; ++o)
#pragma unroll
                  for (int v = 0; v < V; ++v)
                    acc[u][o][v] = fmaf(tk, w[o + kk][v], acc[u][o][v]);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < MRC; ++q)
#pragma unroll
            for (int v = 0; v < V; ++v) w[q][v] = w[q + MRC][v];
        }
      }
#pragma unroll
      for (int o = 0; o < MRC; ++o) {
        const long long m = m0 + (long long)a.d * o;
        if (m < a.n)
#pragma unroll
          for (int u = 0; u < NO; ++u)
            store_vals<V>(yp[u] + m * a.so[2], acc[u][o], a.so[3], ncols,
                          a.store4, 0);
      }
    }
  }
}

template <int NI, int NO>
__global__ void __launch_bounds__(TR* TWARPS)
    merge_row_kernel(MergeTile a, MergeTaps tp) {
  extern __shared__ float sm[];
  float* t = sm;                                // NI NO L taps
  float* in_s = t + NI * NO * a.L;              // NI x TR staged rows
  float* out_s = in_s + NI * TR * a.pitch_in;   // NO x TR output rows
  const int lane = threadIdx.x, warp = threadIdx.y;
  for (int k = warp * 32 + lane; k < NI * NO * a.L; k += TR * TWARPS)
    t[k] = tp.t[k];
  const int nres = a.d < a.n ? a.d : a.n;
  const int ngroups = (nres + a.G - 1) >> a.gs;
  const int ntiles = ngroups * (((a.n + a.d - 1) / a.d + a.S - 1) / a.S);
  const int nrg = (a.H + TR - 1) / TR;
  for (long long p = blockIdx.z; p < a.planes; p += gridDim.z) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* xp[NI];
    float* yp[NO];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      xp[i] = a.in[i] + nn * a.si[i][0] + c * a.si[i][1];
#pragma unroll
    for (int o = 0; o < NO; ++o)
      yp[o] = a.out[o] + nn * a.so[0] + c * a.so[1];
    for (int rg = blockIdx.y; rg < nrg; rg += gridDim.y) {
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int rho0 = (tile % ngroups) << a.gs;
        const long long P0 = (long long)(tile / ngroups) * a.S;
        // staged sample e = k G + g of a row: X(q0 + g + d k), which is
        // X(q0 + e) when G = d: inside the axis, the row's segment at q0
        const long long q0 = rho0 - a.F + a.d * P0;
        const bool direct = a.G == a.d && q0 >= 0 && q0 + a.seg <= a.n;
        __syncthreads();  // the taps are staged; the last tile is written
        for (int rr = warp; rr < TR; rr += TWARPS) {
          const int i = rg * TR + rr;
          if (i >= a.H) continue;
#pragma unroll
          for (int u = 0; u < NI; ++u) {
            const float* row = xp[u] + i * a.si[u][2];
            float* dst = in_s + (u * TR + rr) * a.pitch_in;
            if (direct && a.unit) {  // a walk along the segment
              const float* seg = row + q0;
              for (int e = lane; e < a.seg; e += 32)
                cp_async(dst + e, seg + e, 4);
              continue;
            }
            for (int e = lane; e < a.seg; e += 32) {
              const int r = merge_src(
                  a.G == a.d ? q0 + e
                             : q0 + (e & (a.G - 1)) +
                                   (long long)a.d * (e >> a.gs),
                  a.n, a.mode);
              if (r >= 0)
                cp_async(dst + e, row + r * a.si[u][3], 4);
              else
                dst[e] = 0.f;
            }
          }
        }
        cp_async_wait_all();
        __syncthreads();
        for (int item = warp; item < a.G * (a.S / MR); item += TWARPS) {
          // MR outputs of residue g: window element e at staged sample
          // (ch MR + e) G + g of this lane's row
          const int g = item & (a.G - 1), ch = item >> a.gs;
          float acc[NO][MR];
#pragma unroll
          for (int u = 0; u < NO; ++u)
#pragma unroll
            for (int o = 0; o < MR; ++o) acc[u][o] = 0.f;
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const float* src =
                in_s + (i * TR + lane) * a.pitch_in + ch * MR * a.G + g;
            float w[2 * MR];
#pragma unroll
            for (int o = 0; o < MR; ++o) w[o] = src[o * a.G];
            for (int kb = 0; kb < a.L; kb += MR) {
#pragma unroll
              for (int q = MR; q < 2 * MR; ++q)
                if (kb + q <= a.L + MR - 2) w[q] = src[(kb + q) * a.G];
#pragma unroll
              for (int kk = 0; kk < MR; ++kk) {
                if (kb + kk < a.L) {
#pragma unroll
                  for (int u = 0; u < NO; ++u) {
                    const float tk = t[(i * NO + u) * a.L + kb + kk];
#pragma unroll
                    for (int o = 0; o < MR; ++o)
                      acc[u][o] = fmaf(tk, w[o + kk], acc[u][o]);
                  }
                }
              }
#pragma unroll
              for (int q = 0; q < MR; ++q) w[q] = w[q + MR];
            }
          }
#pragma unroll
          for (int u = 0; u < NO; ++u)
#pragma unroll
            for (int o = 0; o < MR; ++o)
              out_s[(u * TR + lane) * a.pitch_out + (ch * MR + o) * a.G + g] =
                  acc[u][o];
        }
        __syncthreads();
        for (int rr = warp; rr < TR; rr += TWARPS) {
          const int i = rg * TR + rr;
          if (i >= a.H) continue;
          if (a.G == a.d && a.so[3] == 1) {  // one run: outputs d P0 + e
            const long long m0 = a.d * P0;
            const int cnt = a.n - m0 < a.G * a.S ? (int)(a.n - m0)
                                                 : a.G * a.S;
#pragma unroll
            for (int u = 0; u < NO; ++u) {
              float* y = yp[u] + i * a.so[2] + m0;
              const float* o = out_s + (u * TR + rr) * a.pitch_out;
              for (int e = lane; e < cnt; e += 32) y[e] = o[e];
            }
            continue;
          }
          for (int e = lane; e < a.G * a.S; e += 32) {
            const int g = e & (a.G - 1);
            const long long m = rho0 + g + a.d * (P0 + (e >> a.gs));
            if (rho0 + g >= nres || m >= a.n) continue;
#pragma unroll
            for (int u = 0; u < NO; ++u)
              yp[u][i * a.so[2] + m * a.so[3]] =
                  out_s[(u * TR + rr) * a.pitch_out + e];
          }
        }
      }
    }
  }
}

// The adjoint's other images: for band entry e (row e of the host's
// table: t, then the padded positions u0 = q + front of its images, -1
// past the last), add sum_k g_o[k] dy[u0 - k d] to band o of pixel t.
struct MergeBand {
  const float* dy;
  long long sd[4];
  float* out[2];
  long long so[4];
  const int* tab;
  int width, nb, axis, n, L, d, C, other;
  long long planes;
};

template <typename I>
__global__ void merge_band_kernel(MergeBand b, MergeTaps tp) {
  __shared__ float t[2 * DWT_MAX_TAPS];
  for (int k = threadIdx.x; k < 2 * b.L; k += blockDim.x) t[k] = tp.t[k];
  __syncthreads();
  const I total = (I)b.nb * b.other;
  // the filtered axis' and the other axis' strides
  const long long sda = b.sd[b.axis], sdo = b.sd[5 - b.axis];
  const long long soa = b.so[b.axis], soo = b.so[5 - b.axis];
  for (long long p = blockIdx.y; p < b.planes; p += gridDim.y) {
    const long long nn = p / b.C;
    const int c = (int)(p % b.C);
    const float* gp = b.dy + nn * b.sd[0] + c * b.sd[1];
    const long long ob = nn * b.so[0] + c * b.so[1];
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
         idx += (I)gridDim.x * blockDim.x) {
      // consecutive threads along W: the other axis for axis 2
      const int e = (int)(b.axis == 2 ? idx / b.other : idx % b.nb);
      const int j = (int)(b.axis == 2 ? idx % b.other : idx / b.nb);
      const int* row = b.tab + (long long)e * b.width;
      const float* base = gp + j * sdo;
      float lo = 0.f, hi = 0.f;
      for (int w = 1; w < b.width && row[w] >= 0; ++w) {
        for (int k = 0; k < b.L; ++k) {
          const long long u = row[w] - (long long)k * b.d;
          if (u < 0) break;
          if (u < b.n) {
            const float v = base[u * sda];
            lo = fmaf(t[k], v, lo);
            hi = fmaf(t[b.L + k], v, hi);
          }
        }
      }
      const long long off = ob + row[0] * soa + j * soo;
      b.out[0][off] += lo;
      b.out[1][off] += hi;
    }
  }
}

// Launch the tile engine for inst on a (taps, F and mode set); the row
// tile (G, S) is the host's.
template <int NI, int NO>
int merge_launch(MergeTile& a, const MergeTaps& tp, int inst, int G, int S,
                 cudaStream_t st) {
  const unsigned gz = clamp_grid(a.planes, 65535);
  if (inst == M_COL_SCALAR || inst == M_COL_FLOAT4) {
    const int V = inst == M_COL_FLOAT4 ? 4 : 1;
    const int nres = a.d < a.n ? a.d : a.n;
    const long long ntiles =
        (long long)nres * (((a.n + a.d - 1) / a.d + MRC - 1) / MRC);
    const dim3 grid(clamp_grid((a.W + MCW * V - 1) / (MCW * V), 2147483647LL),
                    clamp_grid((ntiles + MCT - 1) / MCT, 65535), gz);
    if (V == 4)
      merge_col_kernel<NI, NO, 4><<<grid, dim3(MCW, MCT), 0, st>>>(a, tp);
    else
      merge_col_kernel<NI, NO, 1><<<grid, dim3(MCW, MCT), 0, st>>>(a, tp);
    return static_cast<int>(cudaGetLastError());
  }
  if (G < 1 || (G & (G - 1)) || S < MR || S % MR ||
      (inst == M_ROW_RUN && G != a.d))
    return static_cast<int>(cudaErrorInvalidValue);
  a.G = G;
  a.gs = __builtin_ctz(G);
  a.S = S;
  a.seg = G * (S + a.L - 1);
  a.pitch_in = a.seg | 1;
  a.pitch_out = (G * S) | 1;
  a.unit = inst == M_ROW_RUN;
  const size_t smem = sizeof(float) * (NI * NO * a.L + NI * TR * a.pitch_in +
                                       NO * TR * a.pitch_out);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const int e = allow_smem(merge_row_kernel<NI, NO>, smem);
  if (e) return e;
  const int nres = a.d < a.n ? a.d : a.n;
  const long long ntiles = (long long)((nres + G - 1) / G) *
                           (((a.n + a.d - 1) / a.d + S - 1) / S);
  const dim3 grid(clamp_grid(ntiles, 2147483647LL),
                  clamp_grid((a.H + TR - 1) / TR, 65535), gz);
  merge_row_kernel<NI, NO><<<grid, dim3(32, TWARPS), smem, st>>>(a, tp);
  return static_cast<int>(cudaGetLastError());
}

// The column entry's inputs are checked for its float4 loads, and the
// instantiation against the axis.
inline bool merge_inst_ok(int inst, int axis) {
  return axis == 2 ? (inst == M_COL_SCALAR || inst == M_COL_FLOAT4)
                   : (axis == 3 &&
                      (inst == M_ROW_RUN || inst == M_ROW_GATHER));
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
// strides sy0..sy3, m_out = the axis length; inst: a MergeInst (float4
// columns need both inputs' rows 16-byte aligned), (G, S) the row tile.
int swt_sfb(const void* lo, const void* hi, void* y, const float* g0,
            const float* g1, int L, int d, long long N, int C, int H, int W,
            long long sl0, long long sl1, long long sl2, long long sl3,
            long long sh0, long long sh1, long long sh2, long long sh3,
            int axis, int front, int mode, int m_out, long long sy0,
            long long sy1, long long sy2, long long sy3, int inst, int G,
            int S, void* stream) {
  const int n = axis == 3 ? W : H;
  if (L < 1 || L > DWT_MAX_TAPS || d < 1 || front < 0 || m_out != n ||
      !merge_inst_ok(inst, axis) ||
      (inst == M_COL_FLOAT4 &&
       !(rows_aligned(lo, N, C, H, W, sl0, sl1, sl2, sl3) &&
         rows_aligned(hi, N, C, H, W, sh0, sh1, sh2, sh3))) ||
      (inst == M_ROW_RUN && W > 1 && (sl3 != 1 || sh3 != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  MergeTile a;
  a.in[0] = static_cast<const float*>(lo);
  a.in[1] = static_cast<const float*>(hi);
  a.out[0] = a.out[1] = static_cast<float*>(y);
  const long long sl[4] = {sl0, sl1, sl2, sl3}, sh[4] = {sh0, sh1, sh2, sh3},
                  sy[4] = {sy0, sy1, sy2, sy3};
  for (int k = 0; k < 4; ++k) {
    a.si[0][k] = sl[k];
    a.si[1][k] = sh[k];
    a.so[k] = sy[k];
  }
  a.L = L;
  a.d = d;
  a.F = front;
  a.n = n;
  a.mode = mode;
  a.C = C;
  a.H = H;
  a.W = W;
  a.store4 = rows_aligned(y, N, C, H, W, sy0, sy1, sy2, sy3);
  a.planes = N * C;
  if ((long long)H * W == 0 || a.planes == 0) return 0;
  MergeTaps tp;
  for (int k = 0; k < L; ++k) {
    tp.t[k] = g0[k];
    tp.t[L + k] = g1[k];
  }
  return merge_launch<2, 1>(a, tp, inst, G, S,
                            static_cast<cudaStream_t>(stream));
}

// dy: (N, C, H, W) at strides sd0..sd3, m = n samples along axis; d2:
// (N, C, 2, H, W) at strides sx0, sx1, sxb, sx2, sx3; inst, (G, S) as for
// swt_sfb; tab: the band's table (nb rows of width int32s, device
// memory; null where no pad position has a source, 'zero' mode).
int swt_sfb_adjoint(const void* dy, void* d2, const float* g0,
                    const float* g1, int L, int d, long long N, int C, int H,
                    int W, long long sd0, long long sd1, long long sd2,
                    long long sd3, int axis, int front, int mode, int m,
                    long long sx0, long long sx1, long long sxb,
                    long long sx2, long long sx3, int inst, int G, int S,
                    const void* tab, int width, int nb, void* stream) {
  const int n = axis == 3 ? W : H;
  if (L < 1 || L > DWT_MAX_TAPS || d < 1 || front < 0 || m != n ||
      !merge_inst_ok(inst, axis) || (tab && (width < 2 || nb < 1)) ||
      (inst == M_COL_FLOAT4 &&
       !rows_aligned(dy, N, C, H, W, sd0, sd1, sd2, sd3)) ||
      (inst == M_ROW_RUN && W > 1 && sd3 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  MergeTile a;
  a.in[0] = a.in[1] = static_cast<const float*>(dy);
  a.out[0] = static_cast<float*>(d2);
  a.out[1] = a.out[0] + sxb;
  const long long sd[4] = {sd0, sd1, sd2, sd3}, sx[4] = {sx0, sx1, sx2, sx3};
  for (int k = 0; k < 4; ++k) {
    a.si[0][k] = a.si[1][k] = sd[k];
    a.so[k] = sx[k];
  }
  a.L = L;
  a.d = d;
  a.F = (L - 1) * d - front;  // back: the direct images' window
  a.n = n;
  a.mode = PAD_ZERO;
  a.C = C;
  a.H = H;
  a.W = W;
  a.store4 = rows_aligned(d2, N, C, H, W, sx0, sx1, sx2, sx3) &&
             sxb % 4 == 0;
  a.planes = N * C;
  if ((long long)H * W == 0 || a.planes == 0) return 0;
  MergeTaps tp;
  for (int k = 0; k < L; ++k) {
    tp.t[k] = g0[L - 1 - k];
    tp.t[L + k] = g1[L - 1 - k];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = merge_launch<1, 2>(a, tp, inst, G, S, st);
  if (e || !tab) return e;
  MergeBand b;
  b.dy = static_cast<const float*>(dy);
  b.out[0] = a.out[0];
  b.out[1] = a.out[1];
  for (int k = 0; k < 4; ++k) {
    b.sd[k] = sd[k];
    b.so[k] = sx[k];
  }
  b.tab = static_cast<const int*>(tab);
  b.width = width;
  b.nb = nb;
  b.axis = axis;
  b.n = n;
  b.L = L;
  b.d = d;
  b.C = C;
  b.other = axis == 3 ? H : W;
  b.planes = a.planes;
  for (int k = 0; k < L; ++k) {
    tp.t[k] = g0[k];
    tp.t[L + k] = g1[k];
  }
  const long long total = (long long)nb * b.other;
  const dim3 grid = dwt_grid(total, b.planes, 256);
  if (total < (1LL << 30))
    merge_band_kernel<int><<<grid, 256, 0, st>>>(b, tp);
  else
    merge_band_kernel<long long><<<grid, 256, 0, st>>>(b, tp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
