// The axis maps of the stride-2 2-D filterbanks K14 (nonsep_afb.cu) and
// K15 (nonsep_sfb.cu), and the gather their edge bands run.
//
// - AfbAxis: the analysis pads of one axis (src, the sample a padded
//   position reads; cot, the virtual rows of the separable split's single
//   fold).  K14's staged forward tile reads its window through src; its
//   adjoint's band gathers through cot.
// - SfbAxis: the synthesis's output index of one axis, K7's plan (src,
//   the output sample a position of the full transposed convolution
//   lands on, -1 where cropped).  K15's adjoint stages its window through
//   src (csrc/nonsep_tile.cuh:afb_tile_kernel).
// - gather_window: the sum over the K input planes' windows that one
//   position (u, u') of the transposed stride-2 filtering reads, windows
//   inside the input only; K14's adjoint band (a pixel's pad images) and
//   K15's forward band (the 'periodization' wrap-add's second images)
//   add it over the image pairs of the host's tables.
//
// The tap stack T (Ly x Lx x K floats) sits in shared memory (dynamic,
// above 48 KB by opt-in; the wrappers keep it within the H100's 227 KB),
// read by all threads of a warp at one address (a broadcast).  The tiles
// both kernels run are in nonsep_tile.cuh.
#pragma once

#include <cuda_runtime.h>

#include "dwt_index.cuh"

// The analysis pads of one axis (ops/nonsep.py:afb_axis_plan): position u
// reads sample p = u - front of a length-n axis, in the pad mode (per 0),
// or of the axis evened by repeating its last sample (ne samples) and
// wrapped (per 1, 'periodization'), or of that evened axis rolled by
// `shift` and zero outside one period (per 2: the separable split's plan
// where the filter is longer than ne; its outputs each add the window
// nout rows on, so the adjoint reads 2 nout virtual rows).
struct AfbAxis {
  int n, front, mode, per, shift, nout;

  __device__ __forceinline__ int src(int u) const {
    const long long p = (long long)u - front;
    const int ne = n + (n & 1);
    if (per == 1) {
      const long long r = floor_mod(p, ne);
      return (int)(r < n ? r : n - 1);
    }
    if (per == 2) {
      if (p < 0 || p >= ne) return -1;
      const int r = (int)((p + shift) % ne);
      return r < n ? r : n - 1;
    }
    return pad_src(p, n, mode);
  }
  // the real row of virtual row j
  __device__ __forceinline__ int cot(int j) const {
    return j < nout ? j : j - nout;
  }
};

// The synthesis's output index of one axis, K7's plan (ops/afb_sfb.py:
// sfb_plan): output t is the full transposed convolution at t + s, plus
// at t + s + wrap where the periodization wrap-add folds the tail onto
// the first `fold` samples (once: a tail longer than wrap is cut, as K7
// cuts it), with t = (t_out + r0) mod wrap under the roll; out is the
// output's length.
struct SfbAxis {
  int s, wrap, r0, fold, out, per;

  __device__ __forceinline__ int src(int u) const {
    if (!per) {
      const int v = u - s;
      return (v >= 0 && v < out) ? v : -1;
    }
    int t = u;
    if (t >= wrap) {
      t -= wrap;
      if (t >= fold || t >= wrap) return -1;
    }
    return (int)floor_mod((long long)t - r0, wrap);
  }
  __device__ __forceinline__ int cot(int j) const { return j; }
};

template <typename Axis>
struct StencilArgs {
  const float* in;
  float* out;
  const float* taps;  // Ly x Lx x K on the card
  int K, Ly, Lx, C;
  // in (N, C, K, Hi, Wi) (virtual rows and columns, read through cot()),
  // out (N, C, Ho, Wo): the bands' gathers.  sik / sok: the K axis'
  // stride.
  int Hi, Wi, Ho, Wo;
  long long planes, si0, si1, sik, si2, si3, so0, so1, sok, so2, so3;
  Axis y, x;
};

__device__ __forceinline__ void stage_taps(const float* taps, int n,
                                           float* sm) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) sm[t] = taps[t];
  __syncthreads();
}

// The windows of input planes 0..K-1 that position (u, u') reads.
template <typename Axis>
__device__ __forceinline__ float gather_window(const StencilArgs<Axis>& a,
                                               const float* tp,
                                               const float* g, int u,
                                               int v) {
  const int a0 = (u & 1) > u - 2 * (a.Hi - 1) ? (u & 1) : u - 2 * (a.Hi - 1);
  const int a1 = a.Ly - 1 < u ? a.Ly - 1 : u;
  const int b0 = (v & 1) > v - 2 * (a.Wi - 1) ? (v & 1) : v - 2 * (a.Wi - 1);
  const int b1 = a.Lx - 1 < v ? a.Lx - 1 : v;
  float acc = 0.f;
  for (int ay = a0; ay <= a1; ay += 2) {
    const float* grow = g + a.y.cot((u - ay) >> 1) * a.si2;
    for (int bx = b0; bx <= b1; bx += 2) {
      const float* gp = grow + a.x.cot((v - bx) >> 1) * a.si3;
      const float* t = tp + (ay * a.Lx + bx) * a.K;
      for (int k = 0; k < a.K; ++k) acc = fmaf(t[k], gp[k * a.sik], acc);
    }
  }
  return acc;
}
