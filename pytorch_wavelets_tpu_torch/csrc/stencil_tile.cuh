// The pieces that the one-axis stencil tiles of K6 (dwt_afb.cu), K7
// (dwt_sfb.cu), K8 (dtcwt_filt.cu), K9 (dtcwt_dfilt.cu), K10
// (dtcwt_ifilt.cu) and K16 (swt_atrous.cu) share: the boundary map of a
// loaded row or staged sample, cp.async, float4 row loads and stores
// (with the inverse's accumulation), the register window of K6, K7 and
// K9 (tap_window), the view checks of the vector instantiations, and
// the shape of the row tile (32 rows a block, one per lane;
// csrc/dtcwt_ifilt.cu and csrc/swt_atrous.cu say why).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "dwt_index.cuh"

namespace {

// The row tile of K10 and K16: TR rows, one a lane of each of TWARPS warps
constexpr int TR = 32;
constexpr int TWARPS = 4;

// The sample that position s of a length-n axis reads (-1: a zero), in
// 'zero' or 'symmetric' mode.
__device__ __forceinline__ int filt_src(int s, int n, int mode) {
  if (s >= 0 && s < n) return s;
  if (s >= -n && s < 2 * n) return pad_src_near(s, n, mode);
  return pad_src(s, n, mode);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (.cg, L2 only) or 4 (.ca) bytes
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// V columns of row r (xp: the plane at the thread's first column): zeros
// for r = -1; ncols of them valid when the thread's columns pass the edge.
template <int V>
__device__ __forceinline__ void load_row(float (&w)[V], const float* xp,
                                         int r, long long sx2, long long sx3,
                                         int ncols) {
  if (r < 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = 0.f;
    return;
  }
  const float* q = xp + r * sx2;
  if (V == 4 && ncols >= 4) {
    const float4 f = *reinterpret_cast<const float4*>(q);
    w[0] = f.x;
    w[V > 1 ? 1 : 0] = f.y;
    w[V > 2 ? 2 : 0] = f.z;
    w[V > 3 ? 3 : 0] = f.w;
    return;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) w[v] = v < ncols ? q[v * sx3] : 0.f;
}

// Store (or add) V outputs at q; float4 where the view allows it.
template <int V>
__device__ __forceinline__ void store_vals(float* q, const float (&v)[V],
                                           long long s3, int ncols,
                                           int store4, int acc) {
  if (V == 4 && store4 && ncols >= 4) {
    float4* q4 = reinterpret_cast<float4*>(q);
    float4 o = make_float4(v[0], v[V > 1 ? 1 : 0], v[V > 2 ? 2 : 0],
                           v[V > 3 ? 3 : 0]);
    if (acc) {
      const float4 p = *q4;
      o.x = p.x + o.x;
      o.y = p.y + o.y;
      o.z = p.z + o.z;
      o.w = p.w + o.w;
    }
    *q4 = o;
    return;
  }
#pragma unroll
  for (int u = 0; u < V; ++u)
    if (u < ncols) {
      float* e = q + u * s3;
      *e = acc ? *e + v[u] : v[u];
    }
}

// V outputs at q (store_vals' reads): float4 where the view allows it.
template <int V>
__device__ __forceinline__ void load_vals(float (&v)[V], const float* q,
                                          long long s3, int ncols,
                                          int vec4) {
  if (V == 4 && vec4 && ncols >= 4) {
    const float4 f = *reinterpret_cast<const float4*>(q);
    v[0] = f.x;
    v[V > 1 ? 1 : 0] = f.y;
    v[V > 2 ? 2 : 0] = f.z;
    v[V > 3 ? 3 : 0] = f.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < V; ++u) v[u] = u < ncols ? q[u * s3] : 0.f;
}

// acc[i][o] += sum_e t[i A + e] X(o + e), o < R, for NT tap rows that
// share one window: X(e) by load(e, w), the samples of a block of R taps
// held in registers and the next R loaded before the block's FMAs, so
// each sample is loaded once a window and feeds NT R V FMAs.  AT > 0: A
// = AT at compile time (the window and tap loops unroll).
template <int AT, int R, int V, int NT, typename Load>
__device__ __forceinline__ void tap_window(int A_rt, const float* t,
                                           Load load,
                                           float (&acc)[NT][R][V]) {
  const int A = AT > 0 ? AT : A_rt;
  float w[2 * R][V];
#pragma unroll
  for (int o = 0; o < R; ++o) load(o, w[o]);
  for (int kb = 0; kb < A; kb += R) {
#pragma unroll
    for (int q = R; q < 2 * R; ++q)
      if (kb + q <= A + R - 2)  // the last sample an output reads
        load(kb + q, w[q]);
#pragma unroll
    for (int kk = 0; kk < R; ++kk) {
      if (kb + kk < A) {
        float ti[NT];
#pragma unroll
        for (int i = 0; i < NT; ++i) ti[i] = t[i * A + kb + kk];
#pragma unroll
        for (int o = 0; o < R; ++o)
#pragma unroll
          for (int v = 0; v < V; ++v)
#pragma unroll
            for (int i = 0; i < NT; ++i)
              acc[i][o][v] = fmaf(ti[i], w[o + kk][v], acc[i][o][v]);
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int v = 0; v < V; ++v) w[q][v] = w[q + R][v];
  }
}

// A view's rows are 16-byte aligned with stride 1 along W: base pointer
// aligned, and every stride of a dimension longer than 1 a multiple of 4.
bool rows_aligned(const void* p, long long N, int C, int H, int W,
                  long long s0, long long s1, long long s2, long long s3) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (W < 2 || s3 == 1) &&
         (H < 2 || s2 % 4 == 0) && (C < 2 || s1 % 4 == 0) &&
         (N < 2 || s0 % 4 == 0);
}

inline unsigned clamp_grid(long long v, long long cap) {
  return (unsigned)(v < 1 ? 1 : (v > cap ? cap : v));
}

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <typename K>
int allow_smem(K* k, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

}  // namespace
