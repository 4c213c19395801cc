// K8 dtcwt_filt: the DTCWT's non-decimated level-1 filter along one axis.
//
// Replaces pytorch_wavelets_tpu/ops/dtcwt_fb.py:_filter_axis_conv (l.66),
// the pad + correlation behind colfilter / rowfilter (B7a).  Input: an
// (N, C, H, W) view read through its four strides (a band of a level's
// stack in place); axis 3 filters along W, axis 2 along H.  With L taps t
// in correlation order and m = L // 2, output i along the axis is
//
//   y[i] = sum_k t[k] x[src(i + k - m)],   0 <= i < n + (L even),
//
// where src is pad_src (dwt_index.cuh) in 'symmetric' or 'zero' mode (a
// -1 reads a zero).  No padded copy is made: the boundary map is applied
// once per loaded row (axis 2) or staged sample (axis 3), never per tap,
// with pad_src_near (32-bit, no division) within one axis length of the
// signal and pad_src past it.  The result is written through the output's
// four strides, or added to what is there with ``acc`` (the inverse's
// sums, colfilter(hh, g1) + colfilter(hl, g0), need no separate add): out
// = out + y, the one rounding of the plain version's sum.
//
// Bound: bytes.  A near_sym_b filter does 13-19 multiply-adds per output
// against 8 bytes moved (12 with ``acc``): about 4 FLOP per byte, against
// ~20 for the card.  The design keeps the FMAs off the critical path and
// reads each input sample from L2 about once a tile:
//
// - Column filter (axis 2), filt_col_kernel.  A 3-D grid of column tiles
//   x output-row tiles x planes (no division per output).  Each thread
//   owns V columns (V = 4, one float4, where the input's rows are 16-byte
//   aligned with stride 1 along W; else V = 1, any strides) and walks R =
//   8 consecutive outputs down them, holding the 2R input rows that taps
//   kb .. kb + R - 1 read in registers: tap k adds t[k] * w[o + k - kb]
//   to output o (static indices: the tap loop is unrolled by R).  The
//   next R rows are loaded before a block of R taps computes, so R loads
//   are in flight together.  Each input row is loaded once a tile plus an
//   (L - 1)-row halo ((R + L - 1) / R loads an output row instead of L,
//   from L2), and each load feeds R * V FMAs.
// - Row filter (axis 3), filt_row_kernel.  A block takes TW = 128 outputs
//   of RY = 8 rows (two a thread).  It stages each row's segment of TW +
//   LT samples in shared memory, every copy asynchronous so that a
//   block's loads are in flight together: 16-byte cp.async chunks where
//   the input is 16-byte aligned with stride 1 along W and the chunk lies
//   inside the row (row_async16), else 4-byte cp.async of each sample
//   from its mapped source, zeros stored (row_async4: any strides).  The
//   segment starts d < 4 samples before the first window (d = -m mod 4),
//   so its chunks are aligned; the taps are staged shifted by d (LT = L +
//   d rounded up to 4, zero outside), so each thread's 4 outputs read
//   16-byte-aligned float4 chunks: 4 taps of 4 outputs from two chunks
//   held in registers, one LDS.128 of data and one of taps per 16 FMAs,
//   conflict-free (a warp's 8-thread phases read consecutive chunks).
// - Stores are float4 where the output view is 16-byte aligned with stride
//   1 along W (a runtime flag), else scalar through the strides.
// - Indices along an axis are 32-bit (the host keeps each axis below
//   2^30); element offsets are 64-bit, so planes of any size (past 2^31
//   outputs) take the same code.  Tiles, rows and planes past the grid's
//   limits loop.
//
// The wrapper (ops/dtcwt_fb.py:dtcwt_filt) chooses the instantiation from
// the view (col_float4 / col_scalar, row_async16 / row_async4), counts
// it, and passes it as ``vec``; the entry checks it against the view.
#include <cuda_runtime.h>

#include "stencil_tile.cuh"

namespace {

constexpr int R = 8;      // outputs a thread walks down a column
constexpr int CW = 32;    // threads along the columns (column kernel)
constexpr int CT = 4;     // threads along the row tiles (column kernel)
constexpr int TW = 128;   // outputs along a row a block computes
constexpr int RY = 8;     // rows a block computes (row kernel)
constexpr int RT = 4;     // threads along those rows: 2 rows a thread

struct FiltArgs {
  const float* x;
  float* y;
  int L, C, n, m, mode, Ho, Wo, acc, store4, d, LT;
  long long planes, sx0, sx1, sx2, sx3, sy0, sy1, sy2, sy3;
};

struct FiltTaps {
  float t[DWT_MAX_TAPS];
};

template <int V>
__global__ void __launch_bounds__(CW* CT, 4)
    filt_col_kernel(FiltArgs a, FiltTaps tp) {
  __shared__ float t[DWT_MAX_TAPS];
  const int tid = threadIdx.y * CW + threadIdx.x;
  for (int k = tid; k < a.L; k += CW * CT) t[k] = tp.t[k];
  __syncthreads();
  const int j0 = (blockIdx.x * CW + threadIdx.x) * V;
  if (j0 >= a.Wo) return;
  const int ncols = a.Wo - j0 < V ? a.Wo - j0 : V;
  const int ntiles = (a.Ho + R - 1) / R;
  for (long long p = blockIdx.z; p < a.planes; p += gridDim.z) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* xp = a.x + nn * a.sx0 + c * a.sx1 + j0 * a.sx3;
    float* yp = a.y + nn * a.sy0 + c * a.sy1 + j0 * a.sy3;
    for (int ti = blockIdx.y * CT + threadIdx.y; ti < ntiles;
         ti += gridDim.y * CT) {
      const int i0 = ti * R, s0 = i0 - a.m;
      // w[q] holds input row s0 + kb + q: the R rows of the taps kb ..
      // kb + R - 1, then the next R, loaded before those taps' FMAs so
      // that R loads are in flight together
      float acc[R][V], w[2 * R][V];
#pragma unroll
      for (int o = 0; o < R; ++o) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[o][v] = 0.f;
        load_row<V>(w[o], xp, filt_src(s0 + o, a.n, a.mode), a.sx2, a.sx3,
                    ncols);
      }
      for (int kb = 0; kb < a.L; kb += R) {
#pragma unroll
        for (int q = R; q < 2 * R; ++q)
          if (kb + q <= a.L + R - 2)  // the last row an output reads
            load_row<V>(w[q], xp, filt_src(s0 + kb + q, a.n, a.mode), a.sx2,
                        a.sx3, ncols);
#pragma unroll
        for (int kk = 0; kk < R; ++kk) {
          if (kb + kk < a.L) {
            const float tk = t[kb + kk];
#pragma unroll
            for (int o = 0; o < R; ++o)
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[o][v] = fmaf(tk, w[o + kk][v], acc[o][v]);
          }
        }
#pragma unroll
        for (int q = 0; q < R; ++q)
#pragma unroll
          for (int v = 0; v < V; ++v) w[q][v] = w[q + R][v];
      }
#pragma unroll
      for (int o = 0; o < R; ++o)
        if (i0 + o < a.Ho)
          store_vals<V>(yp + (i0 + o) * a.sy2, acc[o], a.sy3, ncols,
                        a.store4, a.acc);
    }
  }
}

template <bool ASYNC16>
__global__ void __launch_bounds__(32 * RT)
    filt_row_kernel(FiltArgs a, FiltTaps tp) {
  extern __shared__ float4 sm4[];
  float* ts = reinterpret_cast<float*>(sm4);  // LT shifted taps
  float* rows = ts + a.LT;                    // RY segments of S samples
  const int S = TW + a.LT, S4 = S / 4;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int k = tid; k < a.LT; k += 32 * RT)
    ts[k] = (k >= a.d && k < a.d + a.L) ? tp.t[k - a.d] : 0.f;
  const int J0 = blockIdx.x * TW;
  const int a0 = J0 - a.m - a.d;  // the first staged position, = 0 mod 4
  const int nrg = (a.Ho + RY - 1) / RY;
  for (long long p = blockIdx.z; p < a.planes; p += gridDim.z) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* xp = a.x + nn * a.sx0 + c * a.sx1;
    float* yp = a.y + nn * a.sy0 + c * a.sy1;
    for (int g = blockIdx.y; g < nrg; g += gridDim.y) {
      __syncthreads();  // the taps are staged; the last group is consumed
      // every copy asynchronous: 16 bytes a chunk inside the row (ASYNC16),
      // else 4 bytes a sample from its mapped source, zeros stored
      for (int e = tid; e < RY * S4; e += 32 * RT) {
        const int rr = e / S4, ch = e - rr * S4;
        const int i = g * RY + rr;
        if (i >= a.Ho) continue;
        float* dst = rows + rr * S + 4 * ch;
        const float* row = xp + i * a.sx2;
        const int pos = a0 + 4 * ch;
        if (ASYNC16 && pos >= 0 && pos + 4 <= a.n) {
          cp_async(dst, row + pos, 16);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = filt_src(pos + u, a.n, a.mode);
            if (r >= 0)
              cp_async(dst + u, row + r * a.sx3, 4);
            else
              dst[u] = 0.f;
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      const int j = J0 + 4 * threadIdx.x;
#pragma unroll
      for (int h = 0; h < RY / RT; ++h) {
        const int rr = threadIdx.y + RT * h, i = g * RY + rr;
        if (i >= a.Ho || j >= a.Wo) continue;
        const float4* rs = reinterpret_cast<const float4*>(rows + rr * S);
        const float4* t4 = reinterpret_cast<const float4*>(ts);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        float4 cw = rs[threadIdx.x];
        for (int cb = 0; cb < a.LT / 4; ++cb) {
          const float4 nw = rs[threadIdx.x + cb + 1];
          const float4 tq = t4[cb];
          const float e[8] = {cw.x, cw.y, cw.z, cw.w, nw.x, nw.y, nw.z, nw.w};
          const float tk[4] = {tq.x, tq.y, tq.z, tq.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int kp = 4 * cb + kk;
            if (kp >= a.d && kp < a.d + a.L) {
#pragma unroll
              for (int v = 0; v < 4; ++v)
                acc[v] = fmaf(tk[kk], e[kk + v], acc[v]);
            }
          }
          cw = nw;
        }
        const int ncols = a.Wo - j < 4 ? a.Wo - j : 4;
        store_vals<4>(yp + i * a.sy2 + j * a.sy3, acc, a.sy3, ncols,
                      a.store4, a.acc);
      }
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, C, H, W) at strides sx0..sx3; t: L host floats (correlation
// order); y: (N, C, H', W') at strides sy0..sy3, where the filtered axis
// has n + (L even) outputs and the other keeps its length; mode: a
// PadCode (PAD_ZERO or PAD_SYMMETRIC); vec: 1 for the vector
// instantiation (col_float4 / row_async16: the input's rows 16-byte
// aligned, checked here), 0 for the other (any strides).
int dtcwt_filt(const void* x, void* y, const float* t, int L, long long N,
               int C, int H, int W, long long sx0, long long sx1,
               long long sx2, long long sx3, int axis, int mode, int acc,
               int vec, long long sy0, long long sy1, long long sy2,
               long long sy3, void* stream) {
  if (L < 1 || L > DWT_MAX_TAPS || (axis != 2 && axis != 3) ||
      (vec && !rows_aligned(x, N, C, H, W, sx0, sx1, sx2, sx3)))
    return static_cast<int>(cudaErrorInvalidValue);
  FiltArgs a;
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.L = L;
  a.C = C;
  a.n = axis == 3 ? W : H;
  a.m = L / 2;
  a.mode = mode;
  const int nout = a.n + (L % 2 == 0 ? 1 : 0);
  a.Ho = axis == 2 ? nout : H;
  a.Wo = axis == 3 ? nout : W;
  a.acc = acc;
  a.store4 = rows_aligned(y, N, C, a.Ho, a.Wo, sy0, sy1, sy2, sy3);
  a.d = (4 - (a.m & 3)) & 3;
  a.LT = (L + a.d + 3) / 4 * 4;
  a.planes = N * C;
  a.sx0 = sx0; a.sx1 = sx1; a.sx2 = sx2; a.sx3 = sx3;
  a.sy0 = sy0; a.sy1 = sy1; a.sy2 = sy2; a.sy3 = sy3;
  if ((long long)a.Ho * a.Wo == 0 || a.planes == 0) return 0;
  FiltTaps taps;
  for (int k = 0; k < L; ++k) taps.t[k] = t[k];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned gz = clamp_grid(a.planes, 65535);
  if (axis == 2) {
    const int V = vec ? 4 : 1;
    const long long ntiles = (a.Ho + R - 1) / R;
    const dim3 grid(clamp_grid((a.Wo + CW * V - 1) / (CW * V), 2147483647LL),
                    clamp_grid((ntiles + CT - 1) / CT, 65535), gz);
    if (vec)
      filt_col_kernel<4><<<grid, dim3(CW, CT), 0, st>>>(a, taps);
    else
      filt_col_kernel<1><<<grid, dim3(CW, CT), 0, st>>>(a, taps);
  } else {
    const dim3 grid(clamp_grid((a.Wo + TW - 1) / TW, 2147483647LL),
                    clamp_grid((a.Ho + RY - 1) / RY, 65535), gz);
    const size_t smem = sizeof(float) * (a.LT + RY * (TW + a.LT));
    if (vec)
      filt_row_kernel<true><<<grid, dim3(32, RT), smem, st>>>(a, taps);
    else
      filt_row_kernel<false><<<grid, dim3(32, RT), smem, st>>>(a, taps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
