// K7 dwt_sfb: the DWT's synthesis merge along one axis, in polyphase form.
//
// Replaces pytorch_wavelets_tpu/ops/afb_sfb.py:_conv_axis (l.47) with
// lhs_dilation=2 as used by _sfb1d_conv_conv (l.262), the transposed
// stride-2 correlation of (lo, hi) summed (B8b), its periodization
// wrap-add and roll included.  Inputs: lo and hi as (N, C, H, W) views,
// each read through its own four strides (the bands of a level's
// (N, C, 3, H, W) stack in place); axis 3 merges along W, axis 2 along H.
// With taps g0/g1 in convolution order and
//
//   Y(u) = sum_j lo[j] g0[u - 2j] + hi[j] g1[u - 2j]   (0 <= u - 2j < L),
//
// output n is Y(t + s) + (Y(t + s + wrap) if t < fold), with t = n, or
// t = (n + r0) mod wrap for 'periodization' (ops/afb_sfb.py:sfb_plan).
// Only the first m_out outputs along the axis are written (the crop of a
// backward), through the output's four strides.
//
// Polyphase pairs.  Output position u = 2m + p reads only the A =
// ceil(L/2) taps of its phase p, over the samples X(m - a), a < A, of lo
// and hi: both outputs of the pair m read one window, and each next pair
// one new sample of each input.  Outside 'periodization' X(j) is the
// input inside [0, nin) and zero outside it, and output n is position
// n + s (the crop s = L - 2, an offset).  In 'periodization' with L - 2
// <= wrap = 2 nin the wrap-add makes the merge circular in the input
// index (X(j) = lo[j + nin] for -nin <= j < 0; A - 1 <= nin), and output
// n is position n + r0 mod wrap (the roll, an offset at the store).
// Neither map divides (pair_src, pair_out).  The reference's single fold
// of a longer tail (short axes under long filters) keeps the plain
// per-output kernel (long_fold), counted as such.
//
// Bound: bytes.  A db4 merge does 16 multiply-adds a pair against 16
// bytes moved (one sample of lo and hi in, two outputs out).  The first
// design (one output a thread, each sample re-read by the ~L outputs
// that take it, a 64-bit division per output) ran at 6.1-6.9x its bound.
//
// - Column tiles (axis 2), pair_col_kernel.  A 3-D grid of column tiles
//   x pair chunks x planes.  A thread owns V columns (V = 4, one float4,
//   col_float4, where both inputs' rows are 16-byte aligned with stride 1
//   along W; else V = 1, col_scalar, any strides, a warp's 4-byte loads
//   coalesced along a row) and R consecutive pairs (4 for V = 4, 8 for
//   V = 1), the input rows of a block of R window taps held in registers
//   and the next R rows loaded before the block's FMAs (K16's column
//   window, csrc/swt_atrous.cu; stencil_tile.cuh:tap_window): each row
//   is loaded once a chunk plus the chunk's A - 1 rows of halo, each load
//   feeds 2 R V FMAs, the edge map runs once per loaded row.
// - Row tiles (axis 3), pair_row_kernel.  A block of RW = 8 warps takes
//   TR = 32 rows (a lane each), flattened across the (N, C) planes so
//   that one-row planes (DWT1D) fill it, and a segment of S pairs of
//   each: rows are cut into segments along W (S <= 128 pairs, a multiple
//   of PR, the row's pairs shared evenly: ops/afb_sfb.py:sfb_row_pairs),
//   each staged with its A - 1 samples of halo by 4-byte cp.async into
//   odd-pitch shared rows (row_run: stride 1 along W, a walk along the
//   segment inside the axis; row_gather maps each sample), then each lane
//   walks its own row, PR = 8 pairs at a time, with the same register
//   window, and the outputs leave through shared rows (in the staged
//   rows' space, once every window is read) as contiguous runs (one warp
//   store covers 128 bytes of a row).  Against 32 pairs and 4 warps
//   (tools/stencil_probe.py, H100): dwt_main's first row merge 0.375 ->
//   0.239 ms, its shared memory halved, four times the pairs a block.
// - The window's length is a template parameter where the paths' filters
//   have it (A = 4: db4; A = 5: farras, qshift_a), so the window and tap
//   loops unroll; other lengths take the same window with A at run time.
// - Indices along an axis are 32-bit; element offsets 64-bit, so planes
//   past 2^31 outputs take the same code; tiles, rows and planes past
//   the grid's limits loop.
//
// The wrapper (ops/afb_sfb.py:sfb1d_conv) chooses the instantiation
// (ops/afb_sfb.py:sfb_instantiation: col_float4 / col_scalar along H,
// row_run / row_gather along W, long_fold), counts it and passes it as
// ``inst``; the entry checks it.
#include <cuda_runtime.h>

#include "stencil_tile.cuh"

namespace {

// ------------------------------------------------- long_fold (per output)

struct SfbArgs {
  const float* lo;
  const float* hi;
  float* y;
  int L, C, nin, s, wrap, r0, fold, axis, Ho, Wo;
  long long planes, sl0, sl1, sl2, sl3, sh0, sh1, sh2, sh3, sy0, sy1, sy2,
      sy3;
};

__device__ __forceinline__ float merge_at(long long u, const float* lo,
                                          long long slo, const float* hi,
                                          long long shi, int nin, int L,
                                          const float* g0, const float* g1) {
  // j in [ceil((u - L + 1) / 2), floor(u / 2)], clipped to [0, nin)
  const long long jhi = min((long long)nin - 1, u >> 1);
  const long long jlo = max(0LL, (u - L + 2) / 2);
  float acc = 0.f;
  for (long long j = jhi; j >= jlo; --j) {
    const int k = (int)(u - 2 * j);
    acc = fmaf(lo[j * slo], g0[k], acc);
    acc = fmaf(hi[j * shi], g1[k], acc);
  }
  return acc;
}

template <typename I>
__global__ void dwt_sfb_kernel(SfbArgs a, DwtTaps taps) {
  __shared__ float g0[DWT_MAX_TAPS], g1[DWT_MAX_TAPS];
  load_taps(taps, a.L, g0, g1);
  const I per_plane = (I)a.Ho * a.Wo;
  for (long long p = blockIdx.y; p < a.planes; p += gridDim.y) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* lp = a.lo + nn * a.sl0 + c * a.sl1;
    const float* hp = a.hi + nn * a.sh0 + c * a.sh1;
    float* yp = a.y + nn * a.sy0 + c * a.sy1;
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < per_plane;
         idx += (I)gridDim.x * blockDim.x) {
      const int i = (int)(idx / a.Wo), j = (int)(idx % a.Wo);
      int o;
      const float *lb, *hb;
      long long slo, shi;
      if (a.axis == 3) {
        o = j;
        lb = lp + i * a.sl2;
        hb = hp + i * a.sh2;
        slo = a.sl3;
        shi = a.sh3;
      } else {
        o = i;
        lb = lp + j * a.sl3;
        hb = hp + j * a.sh3;
        slo = a.sl2;
        shi = a.sh2;
      }
      const long long t = a.wrap ? floor_mod((long long)o + a.r0, a.wrap)
                                 : (long long)o;
      float v = merge_at(t + a.s, lb, slo, hb, shi, a.nin, a.L, g0, g1);
      if (t < a.fold)
        v += merge_at(t + a.s + a.wrap, lb, slo, hb, shi, a.nin, a.L, g0,
                      g1);
      yp[i * a.sy2 + j * a.sy3] = v;
    }
  }
}

// ------------------------------------------------------- the pair tiles

enum SfbInst {
  S_COL_SCALAR = 0,
  S_COL_FLOAT4 = 1,
  S_ROW_RUN = 2,
  S_ROW_GATHER = 3,
  S_LONG_FOLD = 4
};

constexpr int SCW = 32;  // column tile: threads along the columns
constexpr int SCT = 4;   // column tile: threads along the pair chunks
constexpr int RS_MAX = 128;  // row tile: pairs of each row, at most
constexpr int PR = 8;        // row tile: pairs a lane walks at a time
constexpr int RW = 8;        // row tile: warps
constexpr int IPW = (RS_MAX / PR + RW - 1) / RW;  // items a warp computes
constexpr int MAX_A = (DWT_MAX_TAPS + 1) / 2;

struct PairTile {
  const float* in[2];  // lo, hi
  long long si[2][4];  // each input's (N, C, H, W) strides
  float* y;
  long long so[4];
  // A window taps; nin input samples; the output map: n = 2 m + p - off
  // (mod wrap where per); pairs [m_lo, m_lo + npairs); m_out outputs
  int A, nin, per, off, wrap, m_out, m_lo, npairs, C, H, W, store4;
  int S, unit, seg, pitch_in, pitch_out;  // the row tile: S pairs a row
  long long planes, rows;
};

// taps[(2 i + p) A + e]: input i, phase p, window element e (sample
// X(m - A + 1 + e) of pair m), g_i[2 (A - 1 - e) + p] or 0 past L
struct PairTaps {
  float t[4 * MAX_A];
};

// The input sample that window index j reads (-1: a zero), no division:
// the axis itself, and in 'periodization' one wrap below it.
__device__ __forceinline__ int pair_src(int j, int nin, int per) {
  if (j >= 0 && j < nin) return j;
  return (per && j < 0 && j >= -nin) ? j + nin : -1;
}

// The output index of position u (written where 0 <= n < m_out): the
// crop's offset, or the roll's with one wrap.
__device__ __forceinline__ int pair_out(int u, const PairTile& a) {
  int n = u - a.off;
  if (a.per) {
    if (n < 0)
      n += a.wrap;
    else if (n >= a.wrap)
      n -= a.wrap;
  }
  return n;
}

template <int V, int AT>
__global__ void __launch_bounds__(SCW* SCT)
    pair_col_kernel(PairTile a, PairTaps tp) {
  constexpr int R = V == 4 ? 4 : 8;
  __shared__ float t[4 * MAX_A];
  const int A = AT > 0 ? AT : a.A;
  const int tid = threadIdx.y * SCW + threadIdx.x;
  for (int k = tid; k < 4 * A; k += SCW * SCT) t[k] = tp.t[k];
  __syncthreads();
  const int j0 = (blockIdx.x * SCW + threadIdx.x) * V;
  if (j0 >= a.W) return;
  const int ncols = a.W - j0 < V ? a.W - j0 : V;
  const int nchunks = (a.npairs + R - 1) / R;
  const int m_end = a.m_lo + a.npairs;
  for (long long p = blockIdx.z; p < a.planes; p += gridDim.z) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* xp[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      xp[i] = a.in[i] + nn * a.si[i][0] + c * a.si[i][1] + j0 * a.si[i][3];
    float* yp = a.y + nn * a.so[0] + c * a.so[1] + j0 * a.so[3];
    for (int ch = blockIdx.y * SCT + threadIdx.y; ch < nchunks;
         ch += gridDim.y * SCT) {
      const int m0 = a.m_lo + ch * R;
      const int jw = m0 - (A - 1);  // the window's first sample
      float acc[2][R][V];
#pragma unroll
      for (int p2 = 0; p2 < 2; ++p2)
#pragma unroll
        for (int o = 0; o < R; ++o)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[p2][o][v] = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        tap_window<AT, R, V, 2>(
            a.A, t + 2 * i * A,
            [&](int e, float(&w)[V]) {
              load_row<V>(w, xp[i], pair_src(jw + e, a.nin, a.per),
                          a.si[i][2], a.si[i][3], ncols);
            },
            acc);
#pragma unroll
      for (int o = 0; o < R; ++o) {
        if (m0 + o >= m_end) continue;
#pragma unroll
        for (int p2 = 0; p2 < 2; ++p2) {
          const int n = pair_out(2 * (m0 + o) + p2, a);
          if (n >= 0 && n < a.m_out)
            store_vals<V>(yp + (long long)n * a.so[2], acc[p2][o], a.so[3],
                          ncols, a.store4, 0);
        }
      }
    }
  }
}

template <int AT>
__global__ void __launch_bounds__(TR* RW)
    pair_row_kernel(PairTile a, PairTaps tp) {
  extern __shared__ long long smll[];
  long long* offs = smll;                   // 3 x TR: lo, hi, y rows
  float* t = reinterpret_cast<float*>(offs + 3 * TR);
  const int A = AT > 0 ? AT : a.A;
  float* in_s = t + 4 * A;                  // 2 x TR staged rows
  float* out_s = in_s;                      // then TR output rows
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * 32 + lane;
  for (int k = tid; k < 4 * A; k += TR * RW) t[k] = tp.t[k];
  const long long ngroups = (a.rows + TR - 1) / TR;
  const int ntiles = (a.npairs + a.S - 1) / a.S;
  const int m_end = a.m_lo + a.npairs;
  for (long long rg = blockIdx.y; rg < ngroups; rg += gridDim.y) {
    __syncthreads();  // taps staged; the last group's rows written out
    if (tid < TR) {
      const long long r = rg * TR + tid;
      if (r < a.rows) {
        const long long p = r / a.H;
        const int i = (int)(r - p * a.H);
        const long long nn = p / a.C;
        const int c = (int)(p - nn * a.C);
#pragma unroll
        for (int u = 0; u < 2; ++u)
          offs[u * TR + tid] =
              nn * a.si[u][0] + c * a.si[u][1] + i * a.si[u][2];
        offs[2 * TR + tid] = nn * a.so[0] + c * a.so[1] + i * a.so[2];
      }
    }
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int P0 = a.m_lo + tile * a.S;
      const int j0 = P0 - (A - 1);  // staged sample e: X(j0 + e)
      const bool direct = a.unit && j0 >= 0 && j0 + a.seg <= a.nin;
      __syncthreads();  // the rows' offsets; the last tile written out
      for (int rr = warp; rr < TR; rr += RW) {
        if (rg * TR + rr >= a.rows) continue;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* row = a.in[u] + offs[u * TR + rr];
          float* dst = in_s + (u * TR + rr) * a.pitch_in;
          if (direct) {  // a walk along the segment
            const float* seg = row + j0;
            for (int e = lane; e < a.seg; e += 32)
              cp_async(dst + e, seg + e, 4);
            continue;
          }
          for (int e = lane; e < a.seg; e += 32) {
            const int r = pair_src(j0 + e, a.nin, a.per);
            if (r >= 0)
              cp_async(dst + e, row + r * a.si[u][3], 4);
            else
              dst[e] = 0.f;
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      float acc[IPW][2][PR][1];
#pragma unroll
      for (int q = 0; q < IPW; ++q) {
        const int item = warp + q * RW;
#pragma unroll
        for (int p2 = 0; p2 < 2; ++p2)
#pragma unroll
          for (int o = 0; o < PR; ++o) acc[q][p2][o][0] = 0.f;
        if (item < a.S / PR) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float* src =
                in_s + (i * TR + lane) * a.pitch_in + item * PR;
            tap_window<AT, PR, 1, 2>(
                a.A, t + 2 * i * A,
                [&](int e, float(&w)[1]) { w[0] = src[e]; }, acc[q]);
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
          o_s[2 * o] = acc[q][0][o][0];
          o_s[2 * o + 1] = acc[q][1][o][0];
        }
      }
      __syncthreads();
      const int cnt = 2 * (m_end - P0 < a.S ? m_end - P0 : a.S);
      for (int rr = warp; rr < TR; rr += RW) {
        if (rg * TR + rr >= a.rows) continue;
        float* y = a.y + offs[2 * TR + rr];
        const float* o_s = out_s + rr * a.pitch_out;
        for (int e = lane; e < cnt; e += 32) {
          const int n = pair_out(2 * P0 + e, a);
          if (n >= 0 && n < a.m_out) y[(long long)n * a.so[3]] = o_s[e];
        }
      }
    }
  }
}

inline int floor_half(int v) { return v >= 0 ? v / 2 : -((1 - v) / 2); }

template <int AT>
int pair_launch(PairTile& a, const PairTaps& tp, int inst, cudaStream_t st) {
  if (inst == S_COL_SCALAR || inst == S_COL_FLOAT4) {
    const int V = inst == S_COL_FLOAT4 ? 4 : 1, R = V == 4 ? 4 : 8;
    const long long nchunks = (a.npairs + R - 1) / R;
    const dim3 grid(clamp_grid((a.W + SCW * V - 1) / (SCW * V), 2147483647LL),
                    clamp_grid((nchunks + SCT - 1) / SCT, 65535),
                    clamp_grid(a.planes, 65535));
    if (V == 4)
      pair_col_kernel<4, AT><<<grid, dim3(SCW, SCT), 0, st>>>(a, tp);
    else
      pair_col_kernel<1, AT><<<grid, dim3(SCW, SCT), 0, st>>>(a, tp);
    return static_cast<int>(cudaGetLastError());
  }
  a.seg = a.S + a.A - 1;
  a.pitch_in = a.seg | 1;
  a.pitch_out = (2 * a.S) | 1;
  // the output rows reuse the staged rows' space (2 pitch_in >= pitch_out)
  const size_t smem = sizeof(long long) * 3 * TR +
                      sizeof(float) * (4 * a.A + 2 * TR * a.pitch_in);
  const int e = allow_smem(pair_row_kernel<AT>, smem);
  if (e) return e;
  const dim3 grid(clamp_grid((a.npairs + a.S - 1) / a.S, 2147483647LL),
                  clamp_grid((a.rows + TR - 1) / TR, 65535), 1);
  pair_row_kernel<AT><<<grid, dim3(32, RW), smem, st>>>(a, tp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lo, hi: (N, C, Hin, Win) at strides sl0..sl3 and sh0..sh3; g0, g1: L host
// floats each; y: (N, C, H', W') at strides sy0..sy3, where the merged
// axis has m_out outputs and the other keeps its length; inst: a SfbInst
// (long_fold exactly where 'periodization' folds a tail longer than the
// output; float4 columns need both inputs' rows 16-byte aligned, row_run
// stride 1 along W).
int dwt_sfb(const void* lo, const void* hi, void* y, const float* g0,
            const float* g1, int L, long long N, int C, int Hin, int Win,
            long long sl0, long long sl1, long long sl2, long long sl3,
            long long sh0, long long sh1, long long sh2, long long sh3,
            int axis, int s, int wrap, int r0, int fold, int m_out,
            long long sy0, long long sy1, long long sy2, long long sy3,
            int inst, int S, void* stream) {
  const bool long_fold = wrap > 0 && L - 2 > wrap;
  if (L < 1 || L > DWT_MAX_TAPS || (axis != 2 && axis != 3) ||
      (inst == S_LONG_FOLD) != long_fold ||
      (axis == 2 && inst != S_COL_SCALAR && inst != S_COL_FLOAT4 &&
       !long_fold) ||
      (axis == 3 && inst != S_ROW_RUN && inst != S_ROW_GATHER &&
       !long_fold) ||
      (inst == S_COL_FLOAT4 &&
       !(rows_aligned(lo, N, C, Hin, Win, sl0, sl1, sl2, sl3) &&
         rows_aligned(hi, N, C, Hin, Win, sh0, sh1, sh2, sh3))) ||
      (inst == S_ROW_RUN && Win > 1 && (sl3 != 1 || sh3 != 1)) ||
      ((inst == S_ROW_RUN || inst == S_ROW_GATHER) &&
       (S < PR || S > RS_MAX || S % PR)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nin = axis == 3 ? Win : Hin;
  const int Ho = axis == 2 ? m_out : Hin, Wo = axis == 3 ? m_out : Win;
  if ((long long)Ho * Wo == 0 || N * C == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (long_fold) {
    SfbArgs a;
    a.lo = static_cast<const float*>(lo);
    a.hi = static_cast<const float*>(hi);
    a.y = static_cast<float*>(y);
    a.L = L;
    a.C = C;
    a.nin = nin;
    a.s = s;
    a.wrap = wrap;
    a.r0 = r0;
    a.fold = fold;
    a.axis = axis;
    a.Ho = Ho;
    a.Wo = Wo;
    a.planes = N * C;
    a.sl0 = sl0; a.sl1 = sl1; a.sl2 = sl2; a.sl3 = sl3;
    a.sh0 = sh0; a.sh1 = sh1; a.sh2 = sh2; a.sh3 = sh3;
    a.sy0 = sy0; a.sy1 = sy1; a.sy2 = sy2; a.sy3 = sy3;
    dwt_launch(dwt_sfb_kernel<int>, dwt_sfb_kernel<long long>,
               (long long)Ho * Wo, a.planes, a, pack_taps(g0, g1, L), stream);
    return static_cast<int>(cudaGetLastError());
  }
  PairTile a;
  a.in[0] = static_cast<const float*>(lo);
  a.in[1] = static_cast<const float*>(hi);
  a.y = static_cast<float*>(y);
  const long long sl[4] = {sl0, sl1, sl2, sl3}, sh[4] = {sh0, sh1, sh2, sh3},
                  sy[4] = {sy0, sy1, sy2, sy3};
  for (int k = 0; k < 4; ++k) {
    a.si[0][k] = sl[k];
    a.si[1][k] = sh[k];
    a.so[k] = sy[k];
  }
  a.A = (L + 1) / 2;
  a.nin = nin;
  a.per = wrap > 0;
  a.wrap = wrap;
  a.m_out = m_out;
  if (a.per) {  // every position of [0, wrap), rolled by r0
    a.off = r0;
    a.m_lo = 0;
    a.npairs = nin;
  } else {      // positions [s, s + m_out); s = -1 for L = 1
    a.off = s;
    a.m_lo = floor_half(s);
    a.npairs = floor_half(s + m_out - 1) + 1 - a.m_lo;
  }
  a.C = C;
  a.H = axis == 3 ? Hin : 1;
  a.W = Win;
  a.store4 = rows_aligned(y, N, C, Ho, Wo, sy0, sy1, sy2, sy3);
  a.unit = inst == S_ROW_RUN;
  a.S = S;
  a.planes = N * C;
  a.rows = N * C * Hin;
  PairTaps tp;
  for (int i = 0; i < 2; ++i)
    for (int p = 0; p < 2; ++p)
      for (int e = 0; e < a.A; ++e) {
        const int k = 2 * (a.A - 1 - e) + p;
        tp.t[(2 * i + p) * a.A + e] = k < L ? (i ? g1 : g0)[k] : 0.f;
      }
  if (a.A == 4) return pair_launch<4>(a, tp, inst, st);
  if (a.A == 5) return pair_launch<5>(a, tp, inst, st);
  return pair_launch<0>(a, tp, inst, st);
}

}  // extern "C"
