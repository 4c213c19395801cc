// The stride-2 2-D stencils of K15 (nonsep_sfb.cu), templated on the
// index map of one axis, and the pieces K14 (nonsep_afb.cu) takes from
// them: its axis map (AfbAxis: src for the forward's staging, cot for the
// virtual rows of its adjoint's single fold) and gather_window (its
// adjoint's edge band).
//
// corr:   out[k][o][o'] = sum_{a, b} T[a][b][k] * in[Y.src(2o + a)][X.src(2o' + b)]
//         (a zero where a map gives -1): one thread per output position
//         computes all K outputs from one read of its window.  K15's
//         adjoint (SfbAxis: the inverse of the synthesis's output index).
// gather: out[t][t'] = sum over positions u of Y.images(t), u' of
//         X.images(t'), of sum_{a = u mod 2, b = u' mod 2} sum_k
//         T[a][b][k] * in[k][(u - a) / 2][(u' - b) / 2] (windows inside
//         the input only, gather_window): the transpose of corr when
//         images() lists the positions that src() maps to t.  K15's
//         forward (the output's one or two positions before the wrap-add
//         and roll).  Row j of a virtual input of Hi rows reads row cot(j)
//         of the real one: the separable split's single fold, whose
//         outputs each sum two windows, read as a twice longer input
//         (K14's adjoint).
//
// Both maps are separable, so a 2-D output reads the product of its rows'
// and columns' positions.  The tap stack T (Ly x Lx x K floats) sits in
// shared memory (dynamic, above 48 KB by opt-in; the wrappers keep it
// within the H100's 227 KB), read by all threads of a warp at one address
// (a broadcast).  Inputs and outputs are read and written through their
// strides.  K14's own kernels (staged tiles, the polyphase adjoint) are in
// nonsep_afb.cu.
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
  __device__ __forceinline__ bool interior(int u0, int L, int& shift) const {
    if (!per) {
      shift = -s;
      return u0 >= s && u0 + L - 1 - s < out;
    }
    shift = -r0;
    return u0 >= r0 && u0 + L - 1 < wrap;
  }
  template <typename F>
  __device__ __forceinline__ void images(int t, F f) const {
    if (!per) {
      f(t + s);
      return;
    }
    const int tt = (t + r0) % wrap;
    f(tt + s);
    if (tt < fold) f(tt + s + wrap);
  }
  __device__ __forceinline__ int cot(int j) const { return j; }
};

template <typename Axis>
struct StencilArgs {
  const float* in;
  float* out;
  const float* taps;  // Ly x Lx x K on the card
  int K, Ly, Lx, C;
  // corr: in (N, C, H, W), out (N, C, K, Ho, Wo); gather: in (N, C, K,
  // Hi, Wi) (virtual rows and columns, read through cot()), out (N, C,
  // Ho, Wo).  sik / sok: the K axis' stride.
  int Hi, Wi, Ho, Wo;
  long long planes, si0, si1, sik, si2, si3, so0, so1, sok, so2, so3;
  Axis y, x;
};

__device__ __forceinline__ void stage_taps(const float* taps, int n,
                                           float* sm) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) sm[t] = taps[t];
  __syncthreads();
}

template <int KMAX, typename Axis, typename I>
__global__ void nonsep_corr_kernel(StencilArgs<Axis> a) {
  extern __shared__ float tp[];
  stage_taps(a.taps, a.K * a.Ly * a.Lx, tp);
  const I per_plane = (I)a.Ho * a.Wo;
  const int row_taps = a.Lx * a.K;
  for (long long p = blockIdx.y; p < a.planes; p += gridDim.y) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* xp = a.in + nn * a.si0 + c * a.si1;
    float* yp = a.out + nn * a.so0 + c * a.so1;
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < per_plane;
         idx += (I)gridDim.x * blockDim.x) {
      const int oy = (int)(idx / a.Wo), ox = (int)(idx % a.Wo);
      float acc[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) acc[k] = 0.f;
      const int uy = 2 * oy, ux = 2 * ox;
      int sy, sx;
      const bool yin = a.y.interior(uy, a.Ly, sy);
      const bool xin = a.x.interior(ux, a.Lx, sx);
      for (int ay = 0; ay < a.Ly; ++ay) {
        const int r = yin ? uy + ay + sy : a.y.src(uy + ay);
        if (r < 0) continue;
        const float* row = xp + r * a.si2;
        const float* t = tp + ay * row_taps;
        for (int bx = 0; bx < a.Lx; ++bx, t += a.K) {
          const int q = xin ? ux + bx + sx : a.x.src(ux + bx);
          if (q < 0) continue;
          const float v = row[q * a.si3];
#pragma unroll
          for (int k = 0; k < KMAX; ++k)
            if (k < a.K) acc[k] = fmaf(t[k], v, acc[k]);
        }
      }
      float* o = yp + oy * a.so2 + ox * a.so3;
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < a.K) o[k * a.sok] = acc[k];
    }
  }
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

template <typename Axis, typename I>
__global__ void nonsep_gather_kernel(StencilArgs<Axis> a) {
  extern __shared__ float tp[];
  stage_taps(a.taps, a.K * a.Ly * a.Lx, tp);
  const I per_plane = (I)a.Ho * a.Wo;
  for (long long p = blockIdx.y; p < a.planes; p += gridDim.y) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* gp = a.in + nn * a.si0 + c * a.si1;
    float* yp = a.out + nn * a.so0 + c * a.so1;
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < per_plane;
         idx += (I)gridDim.x * blockDim.x) {
      const int ty = (int)(idx / a.Wo), tx = (int)(idx % a.Wo);
      float acc = 0.f;
      a.y.images(ty, [&](int u) {
        a.x.images(tx, [&](int v) { acc += gather_window(a, tp, gp, u, v); });
      });
      yp[ty * a.so2 + tx * a.so3] = acc;
    }
  }
}

// Launch a stencil over (pixels of an output plane, planes), the pixel
// index in 32 bits below 2^30 outputs a plane and in 64 bits above (as
// dwt_launch), with `smem` bytes of taps (the opt-in above 48 KB).
template <typename Args>
inline int stencil_launch(void (*k32)(Args), void (*k64)(Args),
                          long long per_plane, long long planes, int smem,
                          const Args& a, void* stream) {
  void (*k)(Args) = per_plane < (1LL << 30) ? k32 : k64;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = 256;
  k<<<dwt_grid(per_plane, planes, threads), threads, smem,
      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
