// K6 dwt_afb: the DWT's analysis split along one axis, lowpass and
// highpass in one pass, every boundary mode folded into the index math.
//
// Replaces pytorch_wavelets_tpu/ops/afb_sfb.py:_conv_axis (l.47) as used by
// _afb1d_corr_conv (l.125), with pad1d (ops/pad.py:28) folded in (B8a +
// B9).  Input: an (N, C, H, W) view read through its four strides (the
// lowpass band of a coarser level's (N, C, 4, H, W) output in place);
// axis 3 filters along W (the row pass), axis 2 along H (the column pass).
// For each output m along the axis, with taps h0/h1 in correlation order,
//
//   lo[m] = sum_k h0[k] X(2m + k)  (+ sum_k h0[k] X(2m + k + ne) if m < fold)
//   hi[m] = the same with h1, from the same loaded samples,
//
// where X(q) = x[min((pad_src(q - front, ne, mode) + shift) % ne, n - 1)],
// or 0 where pad_src gives -1: ops/afb_sfb.py:afb_plan computes front, ne,
// mode, shift and fold per mode ('periodization' evens an odd axis by
// repeating its last sample, and for filters longer than the evened axis
// mirrors the reference's roll, zero pad and single fold).  lo and hi are
// written through the output's five strides (N, C, band, H', W'), and only
// the first m_out outputs along the axis (the crop of a backward).
//
// Polyphase windows (K7's pair windows, mirrored).  With k = 2a + e, lo[m]
// and hi[m] read X(2 (m + a) + e), a < A = ceil(L/2): one window over the
// even samples (e = 0) and one over the odd (e = 1), each feeding both
// outputs with the taps h0[2a + e], h1[2a + e] (zero past L), so each
// output m loads one new sample of each parity and does 2 L FMAs
// (stencil_tile.cuh:tap_window).  Where shift = fold = 0 (every mode but
// 'periodization' with L > ne) X is one map per sample (afb_src): the
// axis itself, one reflection or wrap within an axis length of it, no
// division; pad_src beyond.  The reference's roll and single fold of a
// longer filter keep the first design, one output a thread
// (dwt_afb_kernel, long_fold), counted as such.
//
// Bound: bytes.  A db4 split does 2 * 8 multiply-adds per output pair,
// about 2 FLOP per byte moved, against ~20 for the card.  The first
// design (a division per output, L strided loads per output, each sample
// re-read by about L/2 outputs) ran at 3.1-6.3x its bound.
//
// - Column tiles (axis 2), afb_col_kernel.  A thread owns V columns (V =
//   4, one float4, col_float4, where the input's rows are 16-byte aligned
//   with stride 1 along W; else V = 1, col_scalar, any strides, a warp's
//   4-byte loads coalesced along a row) and R consecutive outputs (4 for
//   V = 4, 8 for V = 1), the rows of a block of R window taps in
//   registers and the next R loaded before the block's FMAs; the edge map
//   runs once per loaded row.  The threads' columns are flattened across
//   the (N, C) planes, so that odd widths (dwt_main's 259, 133, 70) fill
//   whole warps, and the grid is chunk-major (blockIdx.x the output
//   chunks, blockIdx.y the column groups), so that the blocks of one
//   column group run together and read each other's halo rows from L2
//   (tools/stencil_probe.py, H100: dwt_main's first column split 0.404
//   -> 0.281 ms).  lo and hi are stored as float4 where the output view
//   allows it, else through the strides.
// - Row tiles (axis 3), afb_row_kernel.  A block of RW = 8 warps takes TR
//   = 32 rows (a lane each), flattened across the planes so that one-row
//   planes (DWT1D) fill it, and a segment of S <= 128 outputs of each
//   (the row's outputs shared evenly: ops/afb_sfb.py:afb_row_outs), staged
//   with its halo (2 S + 2 A - 2 samples) by 4-byte cp.async into
//   odd-pitch shared rows (row_run: stride 1 along W, a walk along the
//   segment inside the axis; row_gather maps each sample); each lane walks
//   its own row, PR = 8 outputs at a time, with the same windows (reads 2
//   apart, on 32 distinct banks), and lo and hi leave through shared rows
//   (in the staged rows' space) as contiguous runs, each into its band.
// - The window's length is a template parameter for the paths' filters
//   (A = 4: db4; A = 5: farras and the Selesnick banks); other lengths up
//   to DWT_MAX_TAPS take the same window with A at run time.
// - Indices along an axis are 32-bit; element offsets 64-bit, so planes
//   past 2^31 outputs take the same code; tiles, rows and columns past the
//   grid's limits loop.
//
// The wrapper (ops/afb_sfb.py:afb1d_corr) chooses the instantiation
// (ops/afb_sfb.py:afb_instantiation: col_float4 / col_scalar along H,
// row_run / row_gather along W, long_fold), counts it and passes it as
// ``inst`` with the row segment S; the entry checks both.
#include <cuda_runtime.h>

#include "stencil_tile.cuh"

namespace {

// ------------------------------------------------- long_fold (per output)

struct AfbArgs {
  const float* x;
  float* y;
  int L, C, n, ne, front, mode, shift, fold, axis, Ho, Wo;
  long long planes, sx0, sx1, sx2, sx3, sy0, sy1, syb, sy2, sy3;
};

__device__ __forceinline__ float sample(const AfbArgs& a, const float* base,
                                        long long step, long long q) {
  int r = pad_src(q - a.front, a.ne, a.mode);
  if (r < 0) return 0.f;
  if (a.shift) r = (r + a.shift) % a.ne;
  return base[(long long)min(r, a.n - 1) * step];
}

template <typename I>
__global__ void dwt_afb_kernel(AfbArgs a, DwtTaps taps) {
  __shared__ float h0[DWT_MAX_TAPS], h1[DWT_MAX_TAPS];
  load_taps(taps, a.L, h0, h1);
  const I per_plane = (I)a.Ho * a.Wo;
  for (long long p = blockIdx.y; p < a.planes; p += gridDim.y) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* xp = a.x + nn * a.sx0 + c * a.sx1;
    float* yp = a.y + nn * a.sy0 + c * a.sy1;
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < per_plane;
         idx += (I)gridDim.x * blockDim.x) {
      const int i = (int)(idx / a.Wo), j = (int)(idx % a.Wo);
      int m;
      const float* base;
      long long step;
      if (a.axis == 3) {
        m = j;
        base = xp + i * a.sx2;
        step = a.sx3;
      } else {
        m = i;
        base = xp + j * a.sx3;
        step = a.sx2;
      }
      const long long q0 = 2LL * m;
      const long long i0 = q0 - a.front;
      float lo = 0.f, hi = 0.f;
      if (a.shift == 0 && i0 >= 0 && i0 + a.L <= a.n) {
        const float* b = base + i0 * step;
        for (int k = 0; k < a.L; ++k) {
          const float v = b[k * step];
          lo = fmaf(h0[k], v, lo);
          hi = fmaf(h1[k], v, hi);
        }
      } else {
        for (int k = 0; k < a.L; ++k) {
          const float v = sample(a, base, step, q0 + k);
          lo = fmaf(h0[k], v, lo);
          hi = fmaf(h1[k], v, hi);
        }
        if (m < a.fold) {
          // the single fold of 'periodization' with L > ne: the outputs
          // of the second period, summed as the plain version sums them
          float lo2 = 0.f, hi2 = 0.f;
          for (int k = 0; k < a.L; ++k) {
            const float v = sample(a, base, step, q0 + a.ne + k);
            lo2 = fmaf(h0[k], v, lo2);
            hi2 = fmaf(h1[k], v, hi2);
          }
          lo += lo2;
          hi += hi2;
        }
      }
      float* o = yp + i * a.sy2 + j * a.sy3;
      o[0] = lo;
      o[a.syb] = hi;
    }
  }
}

// ------------------------------------------------------------- the tiles

enum AfbInst {
  A_COL_SCALAR = 0,
  A_COL_FLOAT4 = 1,
  A_ROW_RUN = 2,
  A_ROW_GATHER = 3,
  A_LONG_FOLD = 4
};

constexpr int ACW = 32;      // column tile: threads along the columns
constexpr int ACT = 4;       // column tile: threads along the output chunks
constexpr int AS_MAX = 128;  // row tile: outputs of each row, at most
constexpr int APR = 8;       // row tile: outputs a lane walks at a time
constexpr int ARW = 8;       // row tile: warps
constexpr int AIPW = (AS_MAX / APR + ARW - 1) / ARW;  // items a warp computes
constexpr int AMAX_A = (DWT_MAX_TAPS + 1) / 2;

struct AfbTile {
  const float* x;
  float* y;
  // A window taps; n samples, ne of the evened axis; output m reads
  // position 2 m + k - front; m_out outputs
  int A, n, ne, front, mode, m_out, C, H, W, tcols, store4;
  int S, unit, seg, pitch_in, pitch_out;  // the row tile
  long long planes, rows, sx[4], sy[4], syb;
};

// t[(2 e + i) A + a] = h_i[2 a + e] (window e, output i: lo, hi), 0 past L
struct AfbTaps {
  float t[4 * AMAX_A];
};

// The sample that position i of the split's axis reads (-1: a zero), for
// the tiles' plans (shift = fold = 0): pad_src over the evened length ne,
// without a division within an axis length of the signal, then the
// repeated last sample of an odd axis in 'periodization' (ne = n + 1).
__device__ __forceinline__ int afb_src(int i, int n, int ne, int mode) {
  int r;
  if (i >= 0 && i < ne)
    r = i;
  else if (mode == PAD_ZERO)
    return -1;
  else if (mode == PAD_SYMMETRIC && i >= -ne && i < 2 * ne)
    r = i < 0 ? -1 - i : 2 * ne - 1 - i;
  else if (mode == PAD_PERIODIC && i >= -ne && i < 2 * ne)
    r = i < 0 ? i + ne : i - ne;
  else if (mode == PAD_REFLECT && i > -ne && i < 2 * ne - 1)
    r = i < 0 ? -i : 2 * ne - 2 - i;
  else
    r = pad_src(i, ne, mode);
  return r < n ? r : n - 1;
}

template <int V, int AT>
__global__ void __launch_bounds__(ACW* ACT)
    afb_col_kernel(AfbTile a, AfbTaps tp) {
  constexpr int R = V == 4 ? 4 : 8;
  __shared__ float t[4 * AMAX_A];
  const int A = AT > 0 ? AT : a.A;
  const int tid = threadIdx.y * ACW + threadIdx.x;
  for (int k = tid; k < 4 * A; k += ACW * ACT) t[k] = tp.t[k];
  __syncthreads();
  const int nchunks = (a.m_out + R - 1) / R;
  // the thread's columns: thread column g of the planes' tcols each
  for (long long g = (long long)blockIdx.y * ACW + threadIdx.x;
       g < a.planes * a.tcols; g += (long long)gridDim.y * ACW) {
    const long long p = g / a.tcols;
    const int j0 = (int)(g - p * a.tcols) * V;
    const int ncols = a.W - j0 < V ? a.W - j0 : V;
    const long long nn = p / a.C;
    const int c = (int)(p - nn * a.C);
    const float* xp = a.x + nn * a.sx[0] + c * a.sx[1] + j0 * a.sx[3];
    float* yp = a.y + nn * a.sy[0] + c * a.sy[1] + j0 * a.sy[3];
    for (int ch = blockIdx.x * ACT + threadIdx.y; ch < nchunks;
         ch += gridDim.x * ACT) {
      const int m0 = ch * R;
      float acc[2][R][V];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int o = 0; o < R; ++o)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[i][o][v] = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q0 = 2 * m0 + e - a.front;
        tap_window<AT, R, V, 2>(
            a.A, t + 2 * e * A,
            [&](int u, float(&row)[V]) {
              load_row<V>(row, xp, afb_src(q0 + 2 * u, a.n, a.ne, a.mode),
                          a.sx[2], a.sx[3], ncols);
            },
            acc);
      }
#pragma unroll
      for (int o = 0; o < R; ++o) {
        if (m0 + o >= a.m_out) break;
        float* q = yp + (long long)(m0 + o) * a.sy[2];
        store_vals<V>(q, acc[0][o], a.sy[3], ncols, a.store4, 0);
        store_vals<V>(q + a.syb, acc[1][o], a.sy[3], ncols, a.store4, 0);
      }
    }
  }
}

template <int AT>
__global__ void __launch_bounds__(TR* ARW)
    afb_row_kernel(AfbTile a, AfbTaps tp) {
  extern __shared__ long long smll[];
  long long* offs = smll;                   // 2 x TR: x, y rows
  float* t = reinterpret_cast<float*>(offs + 2 * TR);
  const int A = AT > 0 ? AT : a.A;
  float* in_s = t + 4 * A;                  // TR staged rows
  float* out_s = in_s;                      // then TR lo, TR hi rows
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * 32 + lane;
  for (int k = tid; k < 4 * A; k += TR * ARW) t[k] = tp.t[k];
  const long long ngroups = (a.rows + TR - 1) / TR;
  const int ntiles = (a.m_out + a.S - 1) / a.S;
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
      const int M0 = tile * a.S;
      const int first = 2 * M0 - a.front;  // staged sample e: X(first + e)
      const bool direct = a.unit && first >= 0 && first + a.seg <= a.n;
      __syncthreads();  // the rows' offsets; the last tile written out
      for (int rr = warp; rr < TR; rr += ARW) {
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
          const int r = afb_src(first + e, a.n, a.ne, a.mode);
          if (r >= 0)
            cp_async(dst + e, row + (long long)r * a.sx[3], 4);
          else
            dst[e] = 0.f;
        }
      }
      cp_async_wait_all();
      __syncthreads();
      float acc[AIPW][2][APR][1];
#pragma unroll
      for (int q = 0; q < AIPW; ++q) {
        const int item = warp + q * ARW;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int o = 0; o < APR; ++o) acc[q][i][o][0] = 0.f;
        if (item < a.S / APR) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float* src =
                in_s + lane * a.pitch_in + e + 2 * item * APR;
            tap_window<AT, APR, 1, 2>(
                a.A, t + 2 * e * A,
                [&](int u, float(&v)[1]) { v[0] = src[2 * u]; }, acc[q]);
          }
        }
      }
      __syncthreads();  // every window read: the outputs take their place
#pragma unroll
      for (int q = 0; q < AIPW; ++q) {
        const int item = warp + q * ARW;
        if (item >= a.S / APR) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float* o_s = out_s + (i * TR + lane) * a.pitch_out + item * APR;
#pragma unroll
          for (int o = 0; o < APR; ++o) o_s[o] = acc[q][i][o][0];
        }
      }
      __syncthreads();
      const int cnt = a.m_out - M0 < a.S ? a.m_out - M0 : a.S;
      for (int rr = warp; rr < TR; rr += ARW) {
        if (rg * TR + rr >= a.rows) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float* y = a.y + offs[TR + rr] + i * a.syb;
          const float* o_s = out_s + (i * TR + rr) * a.pitch_out;
          for (int e = lane; e < cnt; e += 32)
            y[(long long)(M0 + e) * a.sy[3]] = o_s[e];
        }
      }
    }
  }
}

template <int AT>
int afb_launch(AfbTile& a, const AfbTaps& tp, int inst, cudaStream_t st) {
  if (inst == A_COL_SCALAR || inst == A_COL_FLOAT4) {
    const int V = inst == A_COL_FLOAT4 ? 4 : 1, R = V == 4 ? 4 : 8;
    a.tcols = (a.W + V - 1) / V;
    const long long nchunks = (a.m_out + R - 1) / R;
    const dim3 grid(clamp_grid((nchunks + ACT - 1) / ACT, 2147483647LL),
        clamp_grid((a.planes * a.tcols + ACW - 1) / ACW, 65535), 1);
    if (V == 4)
      afb_col_kernel<4, AT><<<grid, dim3(ACW, ACT), 0, st>>>(a, tp);
    else
      afb_col_kernel<1, AT><<<grid, dim3(ACW, ACT), 0, st>>>(a, tp);
    return static_cast<int>(cudaGetLastError());
  }
  a.seg = 2 * a.S + 2 * a.A - 2;
  a.pitch_in = a.seg | 1;
  a.pitch_out = a.S | 1;
  const int rows_s = a.pitch_in > 2 * a.pitch_out ? a.pitch_in
                                                  : 2 * a.pitch_out;
  const size_t smem = sizeof(long long) * 2 * TR +
                      sizeof(float) * (4 * a.A + TR * rows_s);
  const int e = allow_smem(afb_row_kernel<AT>, smem);
  if (e) return e;
  const dim3 grid(clamp_grid((a.m_out + a.S - 1) / a.S, 2147483647LL),
                  clamp_grid((a.rows + TR - 1) / TR, 65535), 1);
  afb_row_kernel<AT><<<grid, dim3(32, ARW), smem, st>>>(a, tp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, C, H, W) at strides sx0..sx3; h0, h1: L host floats each;
// y: (N, C, 2, H', W') at strides sy0, sy1, syb, sy2, sy3, where the
// filtered axis has m_out outputs and the other keeps its length; inst:
// an AfbInst (long_fold exactly where the plan folds, fold > 0; float4
// columns need the input's rows 16-byte aligned, row_run stride 1 along
// W); S: the row tile's outputs a row segment (a multiple of 8 up to 128;
// ignored by the other instantiations).
int dwt_afb(const void* x, void* y, const float* h0, const float* h1, int L,
            long long N, int C, int H, int W, long long sx0, long long sx1,
            long long sx2, long long sx3, int axis, int ne, int front,
            int mode, int shift, int fold, int m_out, long long sy0,
            long long sy1, long long syb, long long sy2, long long sy3,
            int inst, int S, void* stream) {
  const bool long_fold = fold > 0;
  const bool col = inst == A_COL_SCALAR || inst == A_COL_FLOAT4;
  const bool row = inst == A_ROW_RUN || inst == A_ROW_GATHER;
  if (L < 1 || L > DWT_MAX_TAPS || (axis != 2 && axis != 3) ||
      (inst == A_LONG_FOLD) != long_fold || (!long_fold && shift) ||
      (!long_fold && (axis == 2 ? !col : !row)) ||
      (inst == A_COL_FLOAT4 &&
       !rows_aligned(x, N, C, H, W, sx0, sx1, sx2, sx3)) ||
      (inst == A_ROW_RUN && W > 1 && sx3 != 1) ||
      (row && (S < APR || S > AS_MAX || S % APR)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = axis == 3 ? W : H;
  const int Ho = axis == 2 ? m_out : H, Wo = axis == 3 ? m_out : W;
  if ((long long)Ho * Wo == 0 || N * C == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (long_fold) {
    AfbArgs a;
    a.x = static_cast<const float*>(x);
    a.y = static_cast<float*>(y);
    a.L = L;
    a.C = C;
    a.n = n;
    a.ne = ne;
    a.front = front;
    a.mode = mode;
    a.shift = shift;
    a.fold = fold;
    a.axis = axis;
    a.Ho = Ho;
    a.Wo = Wo;
    a.planes = N * C;
    a.sx0 = sx0; a.sx1 = sx1; a.sx2 = sx2; a.sx3 = sx3;
    a.sy0 = sy0; a.sy1 = sy1; a.syb = syb; a.sy2 = sy2; a.sy3 = sy3;
    dwt_launch(dwt_afb_kernel<int>, dwt_afb_kernel<long long>,
               (long long)Ho * Wo, a.planes, a, pack_taps(h0, h1, L), stream);
    return static_cast<int>(cudaGetLastError());
  }
  AfbTile a;
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.A = (L + 1) / 2;
  a.n = n;
  a.ne = ne;
  a.front = front;
  a.mode = mode;
  a.m_out = m_out;
  a.C = C;
  a.H = H;
  a.W = W;
  // lo's and hi's rows both 16-byte aligned with stride 1 along W
  a.store4 = rows_aligned(y, N, C, Ho, Wo, sy0, sy1, sy2, sy3) &&
             syb % 4 == 0;
  a.S = S;
  a.unit = inst == A_ROW_RUN;
  a.planes = N * C;
  a.rows = N * C * H;
  const long long sx[4] = {sx0, sx1, sx2, sx3}, sy[4] = {sy0, sy1, sy2, sy3};
  for (int k = 0; k < 4; ++k) {
    a.sx[k] = sx[k];
    a.sy[k] = sy[k];
  }
  a.syb = syb;
  AfbTaps tp;
  for (int e = 0; e < 2; ++e)
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < a.A; ++j) {
        const int k = 2 * j + e;
        tp.t[(2 * e + i) * a.A + j] = k < L ? (i ? h1 : h0)[k] : 0.f;
      }
  if (a.A == 4) return afb_launch<4>(a, tp, inst, st);
  if (a.A == 5) return afb_launch<5>(a, tp, inst, st);
  return afb_launch<0>(a, tp, inst, st);
}

}  // extern "C"
