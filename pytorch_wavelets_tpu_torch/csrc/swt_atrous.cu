// K12 and K16, swt_atrous: the SWT's undecimated (à trous) two-band split
// along one axis (K12), the classic shift-averaged two-band merge (K16), and
// the exact transpose of each, every boundary mode folded into the index
// math.  All four run one tile engine.
//
// K12 replaces pytorch_wavelets_tpu/ops/afb_sfb.py:_conv_axis (l.47) as
// used by _afb1d_atrous_corr_conv (l.207; via _afb1d_atrous_corr l.179 and
// afb2d_atrous l.426), with pad1d (ops/pad.py:28) folded in (B8c + B9); the
// JAX package differentiates it by autodiff, which the adjoint entry
// replaces.  Taps h0/h1 in correlation order, d samples apart, on a
// length-n axis padded by front = (L d)/2 - d before and back = (L d)/2
// after (ops/afb_sfb.py:atrous_plan), m_out = n + front + back - (L - 1) d
// outputs (n, or n - 1 where L d is odd):
//
//   swt_afb:          lo[m] = sum_k h0[k] X(m + k d - front),
//                     hi[m] = the same with h1, m < m_out,
//                     where X(q) = x[pad_src(q, n, mode)], or 0 where that
//                     is -1;
//   swt_afb_adjoint:  dx[t] = sum over (m, k) whose padded index maps to t
//                     of h0[k] dlo[m] + h1[k] dhi[m], t < n.
//
// K16 replaces _sfb1d_atrous_conv_conv (ops/afb_sfb.py l.337; via
// sfb1d_atrous l.358 and sfb2d_atrous l.450; B8c'), which JAX runs as the
// probed operator of _sfb_atrous_matrix (l.322) on a device and
// differentiates by autodiff.  Taps g0/g1 in correlation order (the
// synthesis taps reversed), halved by the wrapper, d apart, on a length-n
// axis padded by front = (L d)/2 before and back = L d - d - (L d)/2
// after (atrous_merge_plan), n outputs:
//
//   swt_sfb:          y[m] = sum_k g0[k] LO(m + k d - front)
//                            + sum_k g1[k] HI(m + k d - front), m < n,
//                     LO, HI read as X above, each through its own strides;
//   swt_sfb_adjoint:  dlo[t] = sum over (m, k) whose padded index maps to
//                     t of g0[k] dy[m], dhi[t] the same with g1.
//
// The tile engine is a dilated correlation with NI inputs of n samples and
// NO outputs of m samples, out_o[m] = sum_i sum_k T[i][o][k] X_i(m + k d -
// F):
//
//   entry             (NI, NO)  T                     F      pads   n -> m
//   swt_afb           (1, 2)    (h0, h1)              front  mode   n -> m_out
//   swt_afb_adjoint   (2, 1)    (h0, h1) reversed     back'  zero   m_out -> n
//   swt_sfb           (2, 1)    (g0, g1)              front  mode   n -> n
//   swt_sfb_adjoint   (1, 2)    (g0, g1) reversed     back'  zero   n -> n
//
// with back' = (L - 1) d - front.  An adjoint's tile writes each sample's
// direct image (t read at padded position t: dx[t] = sum_k h0[L-1-k]
// dlo[t - back' + k d] + the same with h1 and dhi, zero outside the
// cotangent).  Its other images (the pad positions whose source is t)
// exist only within the pads' reach of an axis end; the host lists them
// per (n, L, d, mode) and plan (ops/afb_sfb.py:merge_band_images, the
// split's or the merge's pads: reflected and wrapped images, the whole pad
// run in 'replicate', several periods when a pad is longer than the axis),
// and merge_band_kernel<NI, NO> gathers their windows after the tiles, on
// the same stream, no atomics.
//
// Bound: bytes (2 * 8 multiply-adds per output pair against 12 bytes for
// db4).  The first designs (one output or pair a thread) re-read every
// tap's sample from L2 (the reads, not DRAM, held K16 at 5.4x its bound
// and K12's adjoint, scanning its taps with two bounds tests each, at
// 5.7-9.9x).  Outputs m = r (mod d) read only the inputs of one residue
// class, so each thread walks a d-strided subsequence with the window
// undilated within it:
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
//   outputs a thread held K16's forward at 154 registers and was 9%
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
//   16-byte aligned with stride 1 along W, else scalar; a two-output
//   entry writes the two bands of its (N, C, 2, H, W) stack, a band
//   stride apart, and a two-input one reads two bands of its cotangent.
// - Indices along an axis are 32-bit; positions d apart and element
//   offsets are 64-bit.  Tiles, rows and planes past the grid's limits
//   loop; the band kernel's element index is 64-bit past 2^30.
//
// The wrappers (ops/afb_sfb.py: afb1d_atrous_corr, afb1d_atrous_adjoint,
// sfb1d_atrous_conv, sfb1d_atrous_adjoint) choose the instantiation from
// the views and the tile (col_float4 / col_scalar along H, row_run /
// row_gather along W; merge_instantiation), count it and pass it as
// ``inst``, with the row tile (merge_row_tile) and an adjoint's band
// table; the entries check them.
#include <cuda_runtime.h>

#include "stencil_tile.cuh"

namespace {

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
  // n: the inputs' length along the axis (their pad map); m: the outputs'
  int L, d, F, n, m, mode, C, H, W, store4;
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

// Blocks an SM each column tile is compiled for, so the registers it may
// take: 6 for the two-input float4 tile (80 registers, a small spill), 5
// for the two-output one (96).  Left free they took 90 and 102 (5 and 4
// blocks); capped, K12's columns at 4096^2 take 0.421 ms (split) and
// 0.523 (adjoint), not 0.444 and 0.581, and K16's stay at or under their
// earlier times (H100, tools/stencil_probe.py).  The scalar tiles would
// spill under either cap.
template <int NI, int NO, int V>
__global__ void __launch_bounds__(MCW* MCT, V == 4 ? (NI == 2 ? 6 : 5) : 1)
    merge_col_kernel(MergeTile a, MergeTaps tp) {
  __shared__ float t[2 * DWT_MAX_TAPS];
  const int tid = threadIdx.y * MCW + threadIdx.x;
  for (int k = tid; k < NI * NO * a.L; k += MCW * MCT) t[k] = tp.t[k];
  __syncthreads();
  const int j0 = (blockIdx.x * MCW + threadIdx.x) * V;
  if (j0 >= a.W) return;
  const int ncols = a.W - j0 < V ? a.W - j0 : V;
  const int nres = a.d < a.m ? a.d : a.m;
  // (residue, chunk) tiles: at most m + nres, 32-bit
  const int ntiles = nres * (((a.m + a.d - 1) / a.d + MRC - 1) / MRC);
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
        if (m < a.m)
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
  const int nres = a.d < a.m ? a.d : a.m;
  const int ngroups = (nres + a.G - 1) >> a.gs;
  const int ntiles = ngroups * (((a.m + a.d - 1) / a.d + a.S - 1) / a.S);
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
            const int cnt = a.m - m0 < a.G * a.S ? (int)(a.m - m0)
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
            if (rho0 + g >= nres || m >= a.m) continue;
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

// An adjoint's other images: for band entry e (row e of the host's table:
// t, then the padded positions u0 = q + front of its images, -1 past the
// last), add sum_i sum_k T[i][o][k] in_i[u0 - k d] (the taps unreversed,
// the inputs' m samples) to output o at t.  NI inputs at strides sd (a
// band stride apart), NO outputs at strides so.
struct MergeBand {
  const float* in[2];
  long long sd[4];
  float* out[2];
  long long so[4];
  const int* tab;
  int width, nb, axis, m, L, d, C, other;
  long long planes;
};

template <int NI, int NO, typename I>
__global__ void merge_band_kernel(MergeBand b, MergeTaps tp) {
  __shared__ float t[2 * DWT_MAX_TAPS];
  for (int k = threadIdx.x; k < NI * NO * b.L; k += blockDim.x)
    t[k] = tp.t[k];
  __syncthreads();
  const I total = (I)b.nb * b.other;
  // the filtered axis' and the other axis' strides
  const long long sda = b.sd[b.axis], sdo = b.sd[5 - b.axis];
  const long long soa = b.so[b.axis], soo = b.so[5 - b.axis];
  for (long long p = blockIdx.y; p < b.planes; p += gridDim.y) {
    const long long nn = p / b.C;
    const int c = (int)(p % b.C);
    const long long ib = nn * b.sd[0] + c * b.sd[1];
    const long long ob = nn * b.so[0] + c * b.so[1];
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
         idx += (I)gridDim.x * blockDim.x) {
      // consecutive threads along W: the other axis for axis 2
      const int e = (int)(b.axis == 2 ? idx / b.other : idx % b.nb);
      const int j = (int)(b.axis == 2 ? idx % b.other : idx / b.nb);
      const int* row = b.tab + (long long)e * b.width;
      const float* base[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) base[i] = b.in[i] + ib + j * sdo;
      float acc[NO];
#pragma unroll
      for (int o = 0; o < NO; ++o) acc[o] = 0.f;
      for (int w = 1; w < b.width && row[w] >= 0; ++w) {
        for (int k = 0; k < b.L; ++k) {
          const long long u = row[w] - (long long)k * b.d;
          if (u < 0) break;
          if (u < b.m) {
#pragma unroll
            for (int i = 0; i < NI; ++i) {
              const float v = base[i][u * sda];
#pragma unroll
              for (int o = 0; o < NO; ++o)
                acc[o] = fmaf(t[(i * NO + o) * b.L + k], v, acc[o]);
            }
          }
        }
      }
      const long long off = ob + row[0] * soa + j * soo;
#pragma unroll
      for (int o = 0; o < NO; ++o) b.out[o][off] += acc[o];
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
    const int nres = a.d < a.m ? a.d : a.m;
    const long long ntiles =
        (long long)nres * (((a.m + a.d - 1) / a.d + MRC - 1) / MRC);
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
  const int nres = a.d < a.m ? a.d : a.m;
  const long long ntiles = (long long)((nres + G - 1) / G) *
                           (((a.m + a.d - 1) / a.d + S - 1) / S);
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

// An adjoint's band after its tiles (same stream): T the unreversed taps
// as the band kernel reads them, tab the host's table (nb rows of width
// int32s).
template <int NI, int NO>
int band_launch(MergeBand& b, const MergeTaps& tp, cudaStream_t st) {
  const long long total = (long long)b.nb * b.other;
  const dim3 grid = dwt_grid(total, b.planes, 256);
  if (total < (1LL << 30))
    merge_band_kernel<NI, NO, int><<<grid, 256, 0, st>>>(b, tp);
  else
    merge_band_kernel<NI, NO, long long><<<grid, 256, 0, st>>>(b, tp);
  return static_cast<int>(cudaGetLastError());
}

// The (NI, NO) taps T[i][o] of two tap vectors: f0, f1 as the two outputs'
// (NO = 2) or the two inputs' (NI = 2), reversed for an adjoint's tiles.
inline MergeTaps merge_taps(const float* f0, const float* f1, int L,
                            bool reversed) {
  MergeTaps tp;
  for (int k = 0; k < L; ++k) {
    const int s = reversed ? L - 1 - k : k;
    tp.t[k] = f0[s];
    tp.t[L + k] = f1[s];
  }
  return tp;
}

// The à trous plans' pads: the split's (atrous_plan) or the merge's
// (atrous_merge_plan), against the wrapper's front.
inline bool front_ok(int front, int L, int d, bool split) {
  const long long Ld = (long long)L * d;
  return front == (split ? Ld / 2 - d : Ld / 2);
}
}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, C, H, W) at strides sx0..sx3, n = its length along axis; h0, h1:
// L host floats each, d apart; y: (N, C, 2, H', W') at strides sy0, sy1,
// syb, sy2, sy3, with m_out outputs along the axis; inst: a MergeInst
// (float4 columns need x's rows 16-byte aligned), (G, S) the row tile.
int swt_afb(const void* x, void* y, const float* h0, const float* h1, int L,
            int d, long long N, int C, int H, int W, long long sx0,
            long long sx1, long long sx2, long long sx3, int axis, int front,
            int mode, int m_out, long long sy0, long long sy1, long long syb,
            long long sy2, long long sy3, int inst, int G, int S,
            void* stream) {
  const int n = axis == 3 ? W : H;
  if (L < 1 || L > DWT_MAX_TAPS || d < 1 || !front_ok(front, L, d, true) ||
      m_out != n - (int)(((long long)L * d) % 2) ||
      !merge_inst_ok(inst, axis) ||
      (inst == M_COL_FLOAT4 && !rows_aligned(x, N, C, H, W, sx0, sx1, sx2,
                                             sx3)) ||
      (inst == M_ROW_RUN && W > 1 && sx3 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = axis == 2 ? m_out : H, Wo = axis == 3 ? m_out : W;
  MergeTile a;
  a.in[0] = a.in[1] = static_cast<const float*>(x);
  a.out[0] = static_cast<float*>(y);
  a.out[1] = a.out[0] + syb;
  const long long sx[4] = {sx0, sx1, sx2, sx3}, sy[4] = {sy0, sy1, sy2, sy3};
  for (int k = 0; k < 4; ++k) {
    a.si[0][k] = a.si[1][k] = sx[k];
    a.so[k] = sy[k];
  }
  a.L = L;
  a.d = d;
  a.F = front;
  a.n = n;
  a.m = m_out;
  a.mode = mode;
  a.C = C;
  a.H = H;
  a.W = W;
  a.store4 = rows_aligned(y, N, C, Ho, Wo, sy0, sy1, sy2, sy3) &&
             syb % 4 == 0;
  a.planes = N * C;
  if ((long long)Ho * Wo == 0 || a.planes == 0) return 0;
  return merge_launch<1, 2>(a, merge_taps(h0, h1, L, false), inst, G, S,
                            static_cast<cudaStream_t>(stream));
}

// dy: (N, C, 2, H', W') at strides sd0, sd1, sdb, sd2, sd3, with m samples
// along axis; dx: (N, C, Ho, Wo) at strides sx0..sx3, n = its length
// along the axis (the other dimension is dy's); inst, (G, S) as for
// swt_afb (float4 columns need both of dy's bands' rows 16-byte aligned);
// tab: the band's table of the split's plan (nb rows of width int32s,
// device memory; null where no pad position has a source, 'zero' mode).
int swt_afb_adjoint(const void* dy, void* dx, const float* h0,
                    const float* h1, int L, int d, long long N, int C, int Ho,
                    int Wo, long long sd0, long long sd1, long long sdb,
                    long long sd2, long long sd3, int axis, int front,
                    int mode, int m, long long sx0, long long sx1,
                    long long sx2, long long sx3, int inst, int G, int S,
                    const void* tab, int width, int nb, void* stream) {
  const int n = axis == 3 ? Wo : Ho;
  const int Hd = axis == 2 ? m : Ho, Wd = axis == 3 ? m : Wo;
  const float* lo = static_cast<const float*>(dy);
  if (L < 1 || L > DWT_MAX_TAPS || d < 1 || !front_ok(front, L, d, true) ||
      m != n - (int)(((long long)L * d) % 2) || m < 1 ||
      !merge_inst_ok(inst, axis) || (tab && (width < 2 || nb < 1)) ||
      (inst == M_COL_FLOAT4 &&
       !(rows_aligned(lo, N, C, Hd, Wd, sd0, sd1, sd2, sd3) &&
         rows_aligned(lo + sdb, N, C, Hd, Wd, sd0, sd1, sd2, sd3))) ||
      (inst == M_ROW_RUN && Wd > 1 && sd3 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  MergeTile a;
  a.in[0] = lo;
  a.in[1] = lo + sdb;
  a.out[0] = a.out[1] = static_cast<float*>(dx);
  const long long sd[4] = {sd0, sd1, sd2, sd3}, sx[4] = {sx0, sx1, sx2, sx3};
  for (int k = 0; k < 4; ++k) {
    a.si[0][k] = a.si[1][k] = sd[k];
    a.so[k] = sx[k];
  }
  a.L = L;
  a.d = d;
  a.F = (L - 1) * d - front;  // back': the direct images' window
  a.n = m;
  a.m = n;
  a.mode = PAD_ZERO;
  a.C = C;
  a.H = Hd;
  a.W = Wd;
  a.store4 = rows_aligned(dx, N, C, Ho, Wo, sx0, sx1, sx2, sx3);
  a.planes = N * C;
  if ((long long)Ho * Wo == 0 || a.planes == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = merge_launch<2, 1>(a, merge_taps(h0, h1, L, true), inst, G, S,
                             st);
  if (e || !tab) return e;
  MergeBand b;
  b.in[0] = a.in[0];
  b.in[1] = a.in[1];
  b.out[0] = b.out[1] = a.out[0];
  for (int k = 0; k < 4; ++k) {
    b.sd[k] = sd[k];
    b.so[k] = sx[k];
  }
  b.tab = static_cast<const int*>(tab);
  b.width = width;
  b.nb = nb;
  b.axis = axis;
  b.m = m;
  b.L = L;
  b.d = d;
  b.C = C;
  b.other = axis == 3 ? Ho : Wo;
  b.planes = a.planes;
  return band_launch<2, 1>(b, merge_taps(h0, h1, L, false), st);
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
  if (L < 1 || L > DWT_MAX_TAPS || d < 1 || !front_ok(front, L, d, false) ||
      m_out != n || !merge_inst_ok(inst, axis) ||
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
  a.n = a.m = n;
  a.mode = mode;
  a.C = C;
  a.H = H;
  a.W = W;
  a.store4 = rows_aligned(y, N, C, H, W, sy0, sy1, sy2, sy3);
  a.planes = N * C;
  if ((long long)H * W == 0 || a.planes == 0) return 0;
  return merge_launch<2, 1>(a, merge_taps(g0, g1, L, false), inst, G, S,
                            static_cast<cudaStream_t>(stream));
}

// dy: (N, C, H, W) at strides sd0..sd3, m = n samples along axis; d2:
// (N, C, 2, H, W) at strides sx0, sx1, sxb, sx2, sx3; inst, (G, S) as for
// swt_sfb; tab: the band's table of the merge's plan (nb rows of width
// int32s, device memory; null where no pad position has a source, 'zero'
// mode).
int swt_sfb_adjoint(const void* dy, void* d2, const float* g0,
                    const float* g1, int L, int d, long long N, int C, int H,
                    int W, long long sd0, long long sd1, long long sd2,
                    long long sd3, int axis, int front, int mode, int m,
                    long long sx0, long long sx1, long long sxb,
                    long long sx2, long long sx3, int inst, int G, int S,
                    const void* tab, int width, int nb, void* stream) {
  const int n = axis == 3 ? W : H;
  if (L < 1 || L > DWT_MAX_TAPS || d < 1 || !front_ok(front, L, d, false) ||
      m != n || !merge_inst_ok(inst, axis) ||
      (tab && (width < 2 || nb < 1)) ||
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
  a.n = a.m = n;
  a.mode = PAD_ZERO;
  a.C = C;
  a.H = H;
  a.W = W;
  a.store4 = rows_aligned(d2, N, C, H, W, sx0, sx1, sx2, sx3) &&
             sxb % 4 == 0;
  a.planes = N * C;
  if ((long long)H * W == 0 || a.planes == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = merge_launch<1, 2>(a, merge_taps(g0, g1, L, true), inst, G, S, st);
  if (e || !tab) return e;
  MergeBand b;
  b.in[0] = b.in[1] = static_cast<const float*>(dy);
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
  b.m = n;
  b.L = L;
  b.d = d;
  b.C = C;
  b.other = axis == 3 ? H : W;
  b.planes = a.planes;
  return band_launch<1, 2>(b, merge_taps(g0, g1, L, false), st);
}

}  // extern "C"
