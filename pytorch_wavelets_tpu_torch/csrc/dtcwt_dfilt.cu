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
// with src the 'symmetric' map (dwt_index.cuh).  Input and output are
// (N, C, H, W) views read and written through their strides.
//
// Quarter-phase windows.  With k = 2j + e, tap k of output pair r reads
// sample 4 (r + j) + d_w, d_w = 2 + s + 2e - m, for the four windows w =
// 2s + e: each window is a unit-stride correlation of the subsequence of
// one residue mod 4 with the A = ceil(m/2) taps h_s[2j + e] (zero past
// m), so each output pair loads one new sample of each residue (4 for 2
// outputs) and a window of R pairs in registers feeds A R FMAs a loaded
// sample (stencil_tile.cuh:tap_window).  The interleave is fixed per
// launch: stream s goes to output 2r + (s ^ highpass).
//
// Bound: bytes.  A qshift_b level does 14 multiply-adds per output and
// halves the axis: about 4 FLOP per byte moved.  The first design (one
// output a thread, a division per output, one strided load per tap, each
// sample re-read by about m/2 outputs) ran at 3.2-4.7x its bound.
//
// - Column tiles (axis 2, coldfilt), dfilt_col_kernel.  A thread owns V
//   columns (V = 4, one float4, col_float4, where the input's rows are
//   16-byte aligned with stride 1 along W; else V = 1, col_scalar, any
//   strides, a warp's 4-byte loads coalesced along a row) and R
//   consecutive output pairs (4 for V = 4, 8 for V = 1), walking the four
//   windows in turn; the symmetric map runs once per loaded row.  The
//   threads' columns are flattened across the (N, C) planes, so that
//   narrow or odd planes fill whole warps, and the grid is chunk-major
//   (the blocks of one column group run together and share their halo
//   rows in L2, as K6's).  Stores are float4 where the output view allows
//   it (a runtime flag), else scalar through the strides (an ``out`` band
//   of the (N, C, 3, H', W') stack in place).
// - Row tiles (axis 3, rowdfilt), dfilt_row_kernel.  A block of RW = 8
//   warps takes TR = 32 rows (a lane each), flattened across the planes,
//   and a segment of S <= 64 output pairs of each (the row's pairs shared
//   evenly: ops/dtcwt_fb.py:dfilt_row_pairs), staged with its halo (4 S +
//   2 m - 4 samples) by 4-byte cp.async into odd-pitch shared rows
//   (row_run: stride 1 along W, a walk along the segment inside the axis;
//   row_gather maps each sample); each lane then walks its own row, PR =
//   8 pairs at a time, with the same windows (reads 4 apart, on 32
//   distinct banks because the pitch is odd), and the outputs leave
//   through shared rows (in the staged rows' space, once every window is
//   read) as contiguous runs (one warp store covers 128 bytes of a row).
// - The window's length is a template parameter for the paths' q-shift
//   banks (A = 5: qshift_a, m = 10; A = 7: qshift_b and qshift_b_bp, m =
//   14); other lengths up to DWT_MAX_TAPS take the same window with A at
//   run time.
// - Indices along an axis are 32-bit; element offsets 64-bit, so planes
//   past 2^31 outputs take the same code; tiles, rows and chunks past the
//   grid's limits loop.
//
// The wrapper (ops/dtcwt_fb.py:dtcwt_dfilt) chooses the instantiation
// (ops/dtcwt_fb.py:ifilt_instantiation: col_float4 / col_scalar along H,
// row_run / row_gather along W), counts it and passes it as ``inst`` with
// the row segment S; the entry checks both.
#include <cuda_runtime.h>

#include "stencil_tile.cuh"

namespace {

enum DfiltInst {
  COL_SCALAR = 0,
  COL_FLOAT4 = 1,
  ROW_RUN = 2,
  ROW_GATHER = 3
};

constexpr int CW = 32;       // column tile: threads along the columns
constexpr int CT = 4;        // column tile: threads along the pair chunks
constexpr int RS_MAX = 64;   // row tile: output pairs of each row, at most
constexpr int PR = 8;        // row tile: pairs a lane walks at a time
constexpr int RW = 8;        // row tile: warps
constexpr int IPW = (RS_MAX / PR + RW - 1) / RW;  // items a warp computes
constexpr int MAX_A = (DWT_MAX_TAPS + 1) / 2;

struct DfiltTile {
  const float* x;
  float* y;
  // A window taps; n samples; pair r of window w reads 4 (r + j) + d[w]
  int A, n, hp, npairs, C, H, W, tcols, store4;
  int d[4];
  int S, unit, cmin, seg, pitch_in, pitch_out;  // the row tile
  long long planes, rows, sx[4], sy[4];
};

// t[w A + j] = h_s[2 j + e] for window w = 2 s + e, 0 past m
struct DfiltTaps {
  float t[4 * MAX_A];
};

template <int V, int AT>
__global__ void __launch_bounds__(CW* CT)
    dfilt_col_kernel(DfiltTile a, DfiltTaps tp) {
  constexpr int R = V == 4 ? 4 : 8;
  __shared__ float t[4 * MAX_A];
  const int A = AT > 0 ? AT : a.A;
  const int tid = threadIdx.y * CW + threadIdx.x;
  for (int k = tid; k < 4 * A; k += CW * CT) t[k] = tp.t[k];
  __syncthreads();
  const int nchunks = (a.npairs + R - 1) / R;
  // the thread's columns: thread column g of the planes' tcols each
  for (long long g = (long long)blockIdx.y * CW + threadIdx.x;
       g < a.planes * a.tcols; g += (long long)gridDim.y * CW) {
    const long long p = g / a.tcols;
    const int j0 = (int)(g - p * a.tcols) * V;
    const int ncols = a.W - j0 < V ? a.W - j0 : V;
    const long long nn = p / a.C;
    const int c = (int)(p - nn * a.C);
    const float* xp = a.x + nn * a.sx[0] + c * a.sx[1] + j0 * a.sx[3];
    float* yp = a.y + nn * a.sy[0] + c * a.sy[1] + j0 * a.sy[3];
    for (int ch = blockIdx.x * CT + threadIdx.y; ch < nchunks;
         ch += gridDim.x * CT) {
      const int r0 = ch * R;
      float acc[2][1][R][V];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int o = 0; o < R; ++o)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[s][0][o][v] = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int d0 = 4 * r0 + a.d[w];
        tap_window<AT, R, V, 1>(
            a.A, t + w * A,
            [&](int e, float(&row)[V]) {
              load_row<V>(row, xp,
                          filt_src(d0 + 4 * e, a.n, PAD_SYMMETRIC),
                          a.sx[2], a.sx[3], ncols);
            },
            acc[w >> 1]);
      }
#pragma unroll
      for (int o = 0; o < R; ++o) {
        if (r0 + o >= a.npairs) break;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int row = 2 * (r0 + o) + (s ^ a.hp);
          store_vals<V>(yp + (long long)row * a.sy[2], acc[s][0][o],
                        a.sy[3], ncols, a.store4, 0);
        }
      }
    }
  }
}

template <int AT>
__global__ void __launch_bounds__(TR* RW)
    dfilt_row_kernel(DfiltTile a, DfiltTaps tp) {
  extern __shared__ long long smll[];
  long long* offs = smll;                   // 2 x TR: x, y rows
  float* t = reinterpret_cast<float*>(offs + 2 * TR);
  const int A = AT > 0 ? AT : a.A;
  float* in_s = t + 4 * A;                  // TR staged rows
  float* out_s = in_s;                      // then TR output rows
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * 32 + lane;
  for (int k = tid; k < 4 * A; k += TR * RW) t[k] = tp.t[k];
  const long long ngroups = (a.rows + TR - 1) / TR;
  const int ntiles = (a.npairs + a.S - 1) / a.S;
  for (long long rg = blockIdx.y; rg < ngroups; rg += gridDim.y) {
    __syncthreads();  // taps staged; the last group's rows written out
    if (tid < TR) {
      const long long r = rg * TR + tid;
      if (r < a.rows) {
        const long long p = r / a.H;
        const int i = (int)(r - p * a.H);
        const long long nn = p / a.C;
        const int c = (int)(p - nn * a.C);
        offs[tid] = nn * a.sx[0] + c * a.sx[1] + i * a.sx[2];
        offs[TR + tid] = nn * a.sy[0] + c * a.sy[1] + i * a.sy[2];
      }
    }
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int P0 = tile * a.S;
      const int first = 4 * P0 + a.cmin;  // staged sample e: x[src(first + e)]
      const bool direct = a.unit && first >= 0 && first + a.seg <= a.n;
      __syncthreads();  // the rows' offsets; the last tile written out
      for (int rr = warp; rr < TR; rr += RW) {
        if (rg * TR + rr >= a.rows) continue;
        const float* row = a.x + offs[rr];
        float* dst = in_s + rr * a.pitch_in;
        if (direct) {  // a walk along the segment
          const float* seg = row + first;
          for (int e = lane; e < a.seg; e += 32)
            cp_async(dst + e, seg + e, 4);
          continue;
        }
        for (int e = lane; e < a.seg; e += 32) {
          const int r = filt_src(first + e, a.n, PAD_SYMMETRIC);
          cp_async(dst + e, row + (long long)r * a.sx[3], 4);
        }
      }
      cp_async_wait_all();
      __syncthreads();
      float acc[IPW][2][1][PR][1];
#pragma unroll
      for (int q = 0; q < IPW; ++q) {
        const int item = warp + q * RW;
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int o = 0; o < PR; ++o) acc[q][s][0][o][0] = 0.f;
        if (item < a.S / PR) {
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const float* src = in_s + lane * a.pitch_in + a.d[w] - a.cmin +
                               4 * item * PR;
            tap_window<AT, PR, 1, 1>(
                a.A, t + w * A,
                [&](int e, float(&v)[1]) { v[0] = src[4 * e]; },
                acc[q][w >> 1]);
          }
        }
      }
      __syncthreads();  // every window read: the outputs take their place
#pragma unroll
      for (int q = 0; q < IPW; ++q) {
        const int item = warp + q * RW;
        if (item >= a.S / PR) continue;
        float* o_s = out_s + lane * a.pitch_out + 2 * item * PR;
#pragma unroll
        for (int o = 0; o < PR; ++o) {
          o_s[2 * o + a.hp] = acc[q][0][0][o][0];
          o_s[2 * o + (a.hp ^ 1)] = acc[q][1][0][o][0];
        }
      }
      __syncthreads();
      const int cnt = 2 * (a.npairs - P0 < a.S ? a.npairs - P0 : a.S);
      for (int rr = warp; rr < TR; rr += RW) {
        if (rg * TR + rr >= a.rows) continue;
        float* y = a.y + offs[TR + rr];
        const float* o_s = out_s + rr * a.pitch_out;
        for (int e = lane; e < cnt; e += 32)
          y[(long long)(2 * P0 + e) * a.sy[3]] = o_s[e];
      }
    }
  }
}

template <int AT>
int dfilt_launch(DfiltTile& a, const DfiltTaps& tp, int inst,
                 cudaStream_t st) {
  if (inst == COL_SCALAR || inst == COL_FLOAT4) {
    const int V = inst == COL_FLOAT4 ? 4 : 1, R = V == 4 ? 4 : 8;
    a.tcols = (a.W + V - 1) / V;
    const long long nchunks = (a.npairs + R - 1) / R;
    const dim3 grid(clamp_grid((nchunks + CT - 1) / CT, 2147483647LL),
        clamp_grid((a.planes * a.tcols + CW - 1) / CW, 65535), 1);
    if (V == 4)
      dfilt_col_kernel<4, AT><<<grid, dim3(CW, CT), 0, st>>>(a, tp);
    else
      dfilt_col_kernel<1, AT><<<grid, dim3(CW, CT), 0, st>>>(a, tp);
    return static_cast<int>(cudaGetLastError());
  }
  int dmax = a.d[0] + 4 * (a.A - 1);
  for (int w = 1; w < 4; ++w)
    if (a.d[w] + 4 * (a.A - 1) > dmax) dmax = a.d[w] + 4 * (a.A - 1);
  a.seg = dmax - a.cmin + 4 * (a.S - 1) + 1;
  a.pitch_in = a.seg | 1;
  a.pitch_out = (2 * a.S) | 1;
  const int rows_s =
      a.pitch_in > a.pitch_out ? a.pitch_in : a.pitch_out;
  const size_t smem = sizeof(long long) * 2 * TR +
                      sizeof(float) * (4 * a.A + TR * rows_s);
  const int e = allow_smem(dfilt_row_kernel<AT>, smem);
  if (e) return e;
  const dim3 grid(clamp_grid((a.npairs + a.S - 1) / a.S, 2147483647LL),
                  clamp_grid((a.rows + TR - 1) / TR, 65535), 1);
  dfilt_row_kernel<AT><<<grid, dim3(32, RW), smem, st>>>(a, tp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, C, H, W) at strides sx0..sx3, the filtered axis a multiple of 4;
// ha, hb: m host floats each (correlation order); y: (N, C, H', W') at
// strides sy0..sy3 with the filtered axis halved; inst: a DfiltInst
// (float4 columns need the input's rows 16-byte aligned, row_run stride 1
// along W); S: the row tile's pairs a row segment (a multiple of 8 up to
// 64; ignored by the column tiles).
int dtcwt_dfilt(const void* x, void* y, const float* ha, const float* hb,
                int m, int highpass, long long N, int C, int H, int W,
                long long sx0, long long sx1, long long sx2, long long sx3,
                int axis, long long sy0, long long sy1, long long sy2,
                long long sy3, int inst, int S, void* stream) {
  const int n = axis == 3 ? W : H;
  const bool col = inst == COL_SCALAR || inst == COL_FLOAT4;
  if (m < 1 || m > DWT_MAX_TAPS || (axis != 2 && axis != 3) || n % 4 ||
      (axis == 2) != col ||
      (axis == 3 && inst != ROW_RUN && inst != ROW_GATHER) ||
      (inst == COL_FLOAT4 &&
       !rows_aligned(x, N, C, H, W, sx0, sx1, sx2, sx3)) ||
      (inst == ROW_RUN && W > 1 && sx3 != 1) ||
      (!col && (S < PR || S > RS_MAX || S % PR)))
    return static_cast<int>(cudaErrorInvalidValue);
  DfiltTile a;
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.A = (m + 1) / 2;
  a.n = n;
  a.hp = highpass ? 1 : 0;
  a.npairs = n / 4;
  a.C = C;
  a.H = H;
  a.W = W;
  const int Ho = axis == 2 ? n / 2 : H, Wo = axis == 3 ? n / 2 : W;
  a.store4 = rows_aligned(y, N, C, Ho, Wo, sy0, sy1, sy2, sy3);
  for (int w = 0; w < 4; ++w) a.d[w] = 2 + (w >> 1) + 2 * (w & 1) - m;
  a.cmin = a.d[0];
  a.S = S;
  a.unit = inst == ROW_RUN;
  a.planes = N * C;
  a.rows = N * C * H;
  const long long sx[4] = {sx0, sx1, sx2, sx3}, sy[4] = {sy0, sy1, sy2, sy3};
  for (int k = 0; k < 4; ++k) {
    a.sx[k] = sx[k];
    a.sy[k] = sy[k];
  }
  if ((long long)Ho * Wo == 0 || a.planes == 0) return 0;
  DfiltTaps tp;
  for (int w = 0; w < 4; ++w)
    for (int j = 0; j < a.A; ++j) {
      const int k = 2 * j + (w & 1);
      tp.t[w * a.A + j] = k < m ? ((w >> 1) ? hb : ha)[k] : 0.f;
    }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.A == 5) return dfilt_launch<5>(a, tp, inst, st);
  if (a.A == 7) return dfilt_launch<7>(a, tp, inst, st);
  return dfilt_launch<0>(a, tp, inst, st);
}

}  // extern "C"
