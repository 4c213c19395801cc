// K10 dtcwt_ifilt: the DTCWT's q-shift interpolation N -> 2N along one axis.
//
// Replaces pytorch_wavelets_tpu/ops/dtcwt_fb.py:_ifilt_axis_conv (l.220)
// with _conv_quad (l.264), behind colifilt / rowifilt (B7c).  The plain
// version pads the axis symmetrically by m2 = m // 2 (m = len(ha), even),
// takes four phase streams xp[s::2] of the padded signal xp, correlates
// each with the odd or even taps of ha or hb, and interleaves the four
// results.  In closed form, output o = 4q + f (0 <= o < 2n) is
//
//   y[o] = sum_k h_f[2k + par_f] x[src(start_f + 2q + 2k - m2)],
//          0 <= k < m/2,
//
// h_f = ha for the even phases, hb for the odd ones, (start_f, par_f) the
// host's table (ops/dtcwt_fb.py:ifilt_plan) for the parity of m2 and
// ``highpass``, src the 'symmetric' map (dwt_index.cuh).  Phases f and
// f + 2 read samples of one parity p, so pass pi in {0, 1} computes both
// from one window over the subsequence z(i) = x[src(p + 2i)]:
//
//   y[4q + pi + 2h] = sum_j T[pi + 2h][j] z(q + a + j),   0 <= j < Lz,
//
// with (p, a, Lz) per pass and the four tap rows T (h_f's taps shifted
// to a common window, zeros elsewhere) built by the host
// (ops/dtcwt_fb.py:ifilt_passes): the phase table becomes per-launch
// constants, never decoded per output.
//
// Bound: bytes.  A qshift_b level does 7 multiply-adds per output and
// doubles the axis: about 2 FLOP per byte moved.  The design reads each
// input sample from L2 about once a tile and keeps the FMAs off the
// critical path:
//
// - Column filter (axis 2, colifilt), ifilt_col_kernel.  A 3-D grid of
//   column tiles x q tiles x planes.  Each thread owns V columns (V = 4,
//   one float4, where the input's rows are 16-byte aligned with stride 1
//   along W; else V = 1, any strides) and walks R consecutive q, 4R
//   output rows.  Per pass it holds the 2R rows z(q0 + a + kb ..) of a
//   block of R taps in registers and loads the next R before the block's
//   FMAs (csrc/dtcwt_filt.cu's column kernel, with rows 2 apart), so each
//   input row is loaded once a tile plus its halo, not m times, and each
//   load feeds 2 R V FMAs.  The boundary map is applied once per loaded
//   row.
// - Row filter (axis 3, rowifilt), ifilt_row_kernel.  A block takes TR =
//   32 rows, one a lane, and TS = 32 values of q (128 outputs) of each.
//   It stages each row's segment (a 4-byte cp.async a sample, every copy
//   of the block in flight together; a warp copies 128 contiguous bytes
//   of a row), the symmetric map applied once per sample outside the
//   axis; inside it, with stride 1 along W (row_run), by one pointer
//   walk, with no index math per sample (row_gather: any strides): the
//   tile is bound by its instruction rate, and the walk took its 9216 x
//   4608 call from 0.84 to 0.59 ms (tools/stencil_probe.py, H100).  Each
//   thread then runs the column kernel's window over its own row: a warp
//   reads one sample of 32 rows at a time, on 32 distinct banks because
//   the row pitch is odd.  The outputs go through a shared tile, 4 TS a
//   row, and leave it as one contiguous 512-byte run a row (each warp
//   store 128 contiguous bytes),
//   read (the warp's reads in flight together), added to and written
//   where ``acc``.
// - Stores of the column kernel are float4 where the output view is
//   16-byte aligned with stride 1 along W (a runtime flag), else scalar
//   through the strides; ``acc`` adds to what is there (out = out + y,
//   the one rounding of the plain version's sum), every old value of a
//   pass read before its first store (the strides are runtime values, so
//   the compiler may not move a read above a store).
// - Indices along an axis are 32-bit (the host keeps each axis below
//   2^30); element offsets are 64-bit, so planes past 2^31 outputs take
//   the same code.  Tiles, rows and planes past the grid's limits loop.
//
// The wrapper (ops/dtcwt_fb.py:dtcwt_ifilt) chooses the instantiation
// from the view (col_float4 / col_scalar along H, row_run / row_gather
// along W),
// counts it and passes it as ``inst``; the entry checks it.
#include <cuda_runtime.h>

#include "stencil_tile.cuh"

namespace {

constexpr int R = 4;      // values of q a thread walks (column kernel)
constexpr int RR = 8;     // values of q a thread walks (row kernel)
constexpr int CW = 32;    // threads along the columns (column kernel)
constexpr int CT = 4;     // threads along the q tiles (column kernel)
constexpr int TS = 32;    // values of q a row tile takes
constexpr int LZMAX = DWT_MAX_TAPS / 2 + 1;

enum IfiltInst {
  COL_SCALAR = 0,
  COL_FLOAT4 = 1,
  ROW_RUN = 2,
  ROW_GATHER = 3
};

struct IfiltArgs {
  const float* x;
  float* y;
  int C, n, nq, Ho, Wo, acc, store4, lz;
  int p[2], a[2], Lz[2];             // per pass: parity, offset, taps
  int cmin, seg, pitch_in, pitch_out, unit;  // the row tile
  long long planes, sx0, sx1, sx2, sx3, sy0, sy1, sy2, sy3;
};

// T[f][j] at t[f * lz + j]
struct IfiltTaps {
  float t[4 * LZMAX];
};

template <int V>
__global__ void __launch_bounds__(CW* CT)
    ifilt_col_kernel(IfiltArgs a, IfiltTaps tp) {
  __shared__ float t[4 * LZMAX];
  const int tid = threadIdx.y * CW + threadIdx.x;
  for (int k = tid; k < 4 * a.lz; k += CW * CT) t[k] = tp.t[k];
  __syncthreads();
  const int j0 = (blockIdx.x * CW + threadIdx.x) * V;
  if (j0 >= a.Wo) return;
  const int ncols = a.Wo - j0 < V ? a.Wo - j0 : V;
  const int ntiles = (a.nq + R - 1) / R;
  for (long long p = blockIdx.z; p < a.planes; p += gridDim.z) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* xp = a.x + nn * a.sx0 + c * a.sx1 + j0 * a.sx3;
    float* yp = a.y + nn * a.sy0 + c * a.sy1 + j0 * a.sy3;
    for (int ti = blockIdx.y * CT + threadIdx.y; ti < ntiles;
         ti += gridDim.y * CT) {
      const int q0 = ti * R;
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        const int s0 = a.p[pi] + 2 * (q0 + a.a[pi]), Lz = a.Lz[pi];
        const float* ta = t + pi * a.lz;
        const float* tb = t + (pi + 2) * a.lz;
        // w[i] holds input row s0 + 2 (kb + i): the R rows of the taps kb
        // .. kb + R - 1, then the next R, loaded before those taps' FMAs
        float acc[2][R][V], w[2 * R][V];
#pragma unroll
        for (int o = 0; o < R; ++o) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[0][o][v] = acc[1][o][v] = 0.f;
          load_row<V>(w[o], xp, filt_src(s0 + 2 * o, a.n, PAD_SYMMETRIC),
                      a.sx2, a.sx3, ncols);
        }
        for (int kb = 0; kb < Lz; kb += R) {
#pragma unroll
          for (int q = R; q < 2 * R; ++q)
            if (kb + q <= Lz + R - 2)  // the last row an output reads
              load_row<V>(w[q], xp,
                          filt_src(s0 + 2 * (kb + q), a.n, PAD_SYMMETRIC),
                          a.sx2, a.sx3, ncols);
#pragma unroll
          for (int kk = 0; kk < R; ++kk) {
            if (kb + kk < Lz) {
              const float fa = ta[kb + kk], fb = tb[kb + kk];
#pragma unroll
              for (int o = 0; o < R; ++o)
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  acc[0][o][v] = fmaf(fa, w[o + kk][v], acc[0][o][v]);
                  acc[1][o][v] = fmaf(fb, w[o + kk][v], acc[1][o][v]);
                }
            }
          }
#pragma unroll
          for (int q = 0; q < R; ++q)
#pragma unroll
            for (int v = 0; v < V; ++v) w[q][v] = w[q + R][v];
        }
        if (a.acc)  // every old value read before any store
#pragma unroll
          for (int o = 0; o < R; ++o)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 4 * (q0 + o) + pi + 2 * h;
              if (row < a.Ho) {
                float old[V];
                load_vals<V>(old, yp + row * a.sy2, a.sy3, ncols, a.store4);
#pragma unroll
                for (int v = 0; v < V; ++v) acc[h][o][v] += old[v];
              }
            }
#pragma unroll
        for (int o = 0; o < R; ++o)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 4 * (q0 + o) + pi + 2 * h;
            if (row < a.Ho)
              store_vals<V>(yp + row * a.sy2, acc[h][o], a.sy3, ncols,
                            a.store4, 0);
          }
      }
    }
  }
}

__global__ void __launch_bounds__(TR* TWARPS)
    ifilt_row_kernel(IfiltArgs a, IfiltTaps tp) {
  extern __shared__ float sm[];
  float* t = sm;                           // 4 lz taps
  float* in_s = t + 4 * a.lz;              // TR staged segments
  float* out_s = in_s + TR * a.pitch_in;   // TR rows of 4 TS outputs
  const int lane = threadIdx.x, warp = threadIdx.y;
  for (int k = warp * 32 + lane; k < 4 * a.lz; k += TR * TWARPS)
    t[k] = tp.t[k];
  const int ntiles = (a.nq + TS - 1) / TS;
  const int nrg = (a.Ho + TR - 1) / TR;
  for (long long p = blockIdx.z; p < a.planes; p += gridDim.z) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* xp = a.x + nn * a.sx0 + c * a.sx1;
    float* yp = a.y + nn * a.sy0 + c * a.sy1;
    for (int rg = blockIdx.y; rg < nrg; rg += gridDim.y) {
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int Q0 = tile * TS, first = 2 * Q0 + a.cmin;
        const bool inside = first >= 0 && first + a.seg <= a.n;
        __syncthreads();  // the taps are staged; the last tile is written
        for (int rr = warp; rr < TR; rr += TWARPS) {
          const int i = rg * TR + rr;
          if (i >= a.Ho) continue;
          const float* row = xp + i * a.sx2;
          float* dst = in_s + rr * a.pitch_in;
          if (inside && a.unit) {  // a walk along the segment
            const float* seg = row + first;
            for (int e = lane; e < a.seg; e += 32)
              cp_async(dst + e, seg + e, 4);
            continue;
          }
          for (int e = lane; e < a.seg; e += 32) {
            const int r =
                inside ? first + e : filt_src(first + e, a.n, PAD_SYMMETRIC);
            if (r >= 0)
              cp_async(dst + e, row + r * a.sx3, 4);
            else
              dst[e] = 0.f;
          }
        }
        cp_async_wait_all();
        __syncthreads();
        for (int item = warp; item < TS / RR; item += TWARPS) {
#pragma unroll
          for (int pi = 0; pi < 2; ++pi) {
            const int Lz = a.Lz[pi];
            // window element i: staged sample base + 2 i of this lane's row
            const float* src = in_s + lane * a.pitch_in + a.p[pi] +
                               2 * a.a[pi] - a.cmin + 2 * item * RR;
            const float* ta = t + pi * a.lz;
            const float* tb = t + (pi + 2) * a.lz;
            float acc[2][RR], w[2 * RR];
#pragma unroll
            for (int o = 0; o < RR; ++o) {
              acc[0][o] = acc[1][o] = 0.f;
              w[o] = src[2 * o];
            }
            for (int kb = 0; kb < Lz; kb += RR) {
#pragma unroll
              for (int q = RR; q < 2 * RR; ++q)
                if (kb + q <= Lz + RR - 2) w[q] = src[2 * (kb + q)];
#pragma unroll
              for (int kk = 0; kk < RR; ++kk) {
                if (kb + kk < Lz) {
                  const float fa = ta[kb + kk], fb = tb[kb + kk];
#pragma unroll
                  for (int o = 0; o < RR; ++o) {
                    acc[0][o] = fmaf(fa, w[o + kk], acc[0][o]);
                    acc[1][o] = fmaf(fb, w[o + kk], acc[1][o]);
                  }
                }
              }
#pragma unroll
              for (int q = 0; q < RR; ++q) w[q] = w[q + RR];
            }
            float* dst = out_s + lane * a.pitch_out + 4 * item * RR + pi;
#pragma unroll
            for (int o = 0; o < RR; ++o) {
              dst[4 * o] = acc[0][o];
              dst[4 * o + 2] = acc[1][o];
            }
          }
        }
        __syncthreads();
        // a run of 4 TS outputs a row; every value of ``acc`` a lane
        // adds read before its first store, so the reads are in flight
        // together
        const int cnt = a.Wo - 4 * Q0 < 4 * TS ? a.Wo - 4 * Q0 : 4 * TS;
        for (int rr = warp; rr < TR; rr += TWARPS) {
          const int i = rg * TR + rr;
          if (i >= a.Ho) continue;
          float* y = yp + i * a.sy2 + 4LL * Q0 * a.sy3;
          const float* o = out_s + rr * a.pitch_out;
          float v[4 * TS / 32];
#pragma unroll
          for (int k = 0; k < 4 * TS / 32; ++k) {
            const int e = lane + 32 * k;
            v[k] = o[e];
            if (a.acc && e < cnt) v[k] += y[e * a.sy3];
          }
#pragma unroll
          for (int k = 0; k < 4 * TS / 32; ++k) {
            const int e = lane + 32 * k;
            if (e < cnt) y[e * a.sy3] = v[k];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, C, H, W) at strides sx0..sx3; taps: 4 lz host floats, the tap
// rows T[f] of ops/dtcwt_fb.py:ifilt_passes; passes: (p, a, Lz) of pass 0
// then pass 1; y: (N, C, H', W') at strides sy0..sy3 with the filtered
// axis doubled; inst: an IfiltInst, checked against the axis and view.
int dtcwt_ifilt(const void* x, void* y, const float* taps, int lz, int p0,
                int a0, int lz0, int p1, int a1, int lz1, long long N, int C,
                int H, int W, long long sx0, long long sx1, long long sx2,
                long long sx3, int axis, int acc, int inst, long long sy0,
                long long sy1, long long sy2, long long sy3, void* stream) {
  const bool col = inst == COL_SCALAR || inst == COL_FLOAT4;
  if (lz < 1 || lz > LZMAX || lz0 < 1 || lz0 > lz || lz1 < 1 || lz1 > lz ||
      (p0 & ~1) || (p1 & ~1) || (axis != 2 && axis != 3) ||
      (axis == 2) != col ||
      (axis == 3 && inst != ROW_RUN && inst != ROW_GATHER) ||
      (inst == COL_FLOAT4 &&
       !rows_aligned(x, N, C, H, W, sx0, sx1, sx2, sx3)) ||
      (inst == ROW_RUN && W > 1 && sx3 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  IfiltArgs a;
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.C = C;
  a.n = axis == 3 ? W : H;
  a.nq = (2 * a.n + 3) / 4;
  a.Ho = axis == 2 ? 2 * a.n : H;
  a.Wo = axis == 3 ? 2 * a.n : W;
  a.acc = acc;
  a.store4 = rows_aligned(y, N, C, a.Ho, a.Wo, sy0, sy1, sy2, sy3);
  a.lz = lz;
  a.p[0] = p0; a.a[0] = a0; a.Lz[0] = lz0;
  a.p[1] = p1; a.a[1] = a1; a.Lz[1] = lz1;
  // the row tile's segment: the window starts and ends of both passes
  const int c0 = p0 + 2 * a0, c1 = p1 + 2 * a1;
  const int e0 = p0 + 2 * (a0 + lz0 - 1), e1 = p1 + 2 * (a1 + lz1 - 1);
  a.cmin = c0 < c1 ? c0 : c1;
  a.seg = (e0 > e1 ? e0 : e1) - a.cmin + 2 * (TS - 1) + 1;
  a.pitch_in = a.seg | 1;
  a.pitch_out = 4 * TS + 1;
  a.unit = inst == ROW_RUN;
  a.planes = N * C;
  a.sx0 = sx0; a.sx1 = sx1; a.sx2 = sx2; a.sx3 = sx3;
  a.sy0 = sy0; a.sy1 = sy1; a.sy2 = sy2; a.sy3 = sy3;
  if ((long long)a.Ho * a.Wo == 0 || a.planes == 0) return 0;
  IfiltTaps tp;
  for (int k = 0; k < 4 * lz; ++k) tp.t[k] = taps[k];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned gz = clamp_grid(a.planes, 65535);
  if (col) {
    const int V = inst == COL_FLOAT4 ? 4 : 1;
    const long long ntiles = (a.nq + R - 1) / R;
    const dim3 grid(clamp_grid((a.Wo + CW * V - 1) / (CW * V), 2147483647LL),
                    clamp_grid((ntiles + CT - 1) / CT, 65535), gz);
    if (V == 4)
      ifilt_col_kernel<4><<<grid, dim3(CW, CT), 0, st>>>(a, tp);
    else
      ifilt_col_kernel<1><<<grid, dim3(CW, CT), 0, st>>>(a, tp);
  } else {
    const size_t smem =
        sizeof(float) * (4 * lz + TR * (a.pitch_in + a.pitch_out));
    const int e = allow_smem(ifilt_row_kernel, smem);
    if (e) return e;
    const dim3 grid(clamp_grid((a.nq + TS - 1) / TS, 2147483647LL),
                    clamp_grid((a.Ho + TR - 1) / TR, 65535), gz);
    ifilt_row_kernel<<<grid, dim3(32, TWARPS), smem, st>>>(a, tp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
