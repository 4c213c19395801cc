// The staged tiles of K14 (nonsep_afb.cu) that K15 (nonsep_sfb.cu) runs
// too: the stride-(2, 2) correlation of a plane with a stack of K PSFs,
// its window staged through an axis map (afb_tile_kernel; csrc/
// nonsep_afb.cu's header describes it), and the polyphase sum of K
// planes, 2 x 2 pixels a quad (afb_adjoint_tile_kernel), with the
// pieces they share (cp.async, the taps' staging, the tiles' checks and
// shared-memory sizes).
//
// - afb_tile_kernel<KMAX, Axis>: y[k][o][o'] = sum_{a, b} f[k][a][b]
//   x[Y.src(2o + a)][X.src(2o' + b)], zero where a map gives -1.  K14's
//   forward with AfbAxis (the analysis pads); K15's adjoint with SfbAxis
//   (the output sample a position of the full transposed convolution
//   lands on, -1 where cropped), where x is the cotangent dy and the K =
//   4 outputs are the bands' cotangents.
// - afb_adjoint_tile_kernel<KMAX, ROT>: with u = 2U + du, v = 2V + dv,
//   Z(u, v) = sum_{alpha, beta, k} f[k][2 alpha + du][2 beta + dv]
//   g[k][U - alpha][V - beta], g read as zero outside its plane, written
//   to pixel (u - fy, v - fx) where that is inside the output.  K14's
//   adjoint (the direct padded position of each pixel, ROT false); K15's
//   forward (Z the full transposed convolution of the 4 bands; outside
//   'periodization' pixel n is position n + s, ROT false; in it every
//   position of [0, wrap) once, pixel (u - r0) wrapped into [0, wrap),
//   ROT true).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "nonsep_stencil.cuh"

namespace {

constexpr int PY = 4;           // positions (forward) / quads (adjoint) a
                                // thread computes along the rows
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

inline unsigned clamp_grid(long long v, long long cap) {
  return (unsigned)(v < 1 ? 1 : (v > cap ? cap : v));
}

inline bool tile_ok(int bx, int by) {
  return (bx == 8 || bx == 16 || bx == 32) && by >= 1 && by <= 16 &&
         bx * by >= 32 && bx * by <= 256;
}

// The Ly x Lx x K tap stack into shared memory as Ly x Lx x KMAX, zeros
// for the PSFs past K: 16-byte cp.async where K = KMAX and the stack is
// 16-byte aligned (the wrappers' stacks are), else loads and stores.  The
// caller waits (cp_async_wait_all) and synchronises.
template <int KMAX>
__device__ __forceinline__ void stage_padded_taps(const float* taps, int K,
                                                  int nab, float* tp,
                                                  int tid, int nth) {
  if (K == KMAX && reinterpret_cast<uintptr_t>(taps) % 16 == 0) {
    for (int e = 4 * tid; e < nab * KMAX; e += 4 * nth)
      cp_async16(tp + e, taps + e);
    return;
  }
  for (int e = tid; e < nab * KMAX; e += nth) {
    const int k = e % KMAX;
    tp[e] = k < K ? taps[(e / KMAX) * K + k] : 0.f;
  }
}

// ---------------------------------------------------------------- forward

template <typename Axis>
struct FwdArgs {
  const float* in;
  float* out;
  const float* taps;  // Ly x Lx x K on the card
  int K, Ly, Lx, C, Ho, Wo;
  int rows_w, cols_w, pitch;  // the staged window, a parity plane's pitch
  long long planes, si0, si1, si2, si3, so0, so1, sok, so2, so3;
  Axis y, x;  // each staged row's and column's source: Axis::src(u)
};

// floats of a parity plane's row: ceil(cols / 2), raised so that 2 pitch =
// bx (mod 32): a warp's 32 / bx thread rows, 2 window rows apart, then
// read distinct banks
inline int fwd_pitch(int cols_w, int bx) {
  int p = (cols_w + 1) / 2;
  if (bx < 32) p += ((bx / 2 - p) % 16 + 16) % 16;
  return p;
}

inline size_t fwd_smem(int kmax, int Ly, int Lx, int bx, int by) {
  const int rows_w = 2 * PY * by + Ly - 2, cols_w = 2 * bx + Lx - 2;
  return sizeof(float) * ((size_t)Ly * Lx * kmax + rows_w + cols_w +
                          2 * (size_t)rows_w * fwd_pitch(cols_w, bx));
}

template <int KMAX, typename Axis>
__global__ void __launch_bounds__(256) afb_tile_kernel(FwdArgs<Axis> a) {
  extern __shared__ float4 sm4[];
  float* tp = reinterpret_cast<float*>(sm4);  // Ly x Lx x KMAX
  int* rsrc = reinterpret_cast<int*>(tp + a.Ly * a.Lx * KMAX);
  int* csrc = rsrc + a.rows_w;
  float* win = reinterpret_cast<float*>(csrc + a.cols_w);
  const int BX = blockDim.x, BY = blockDim.y, nth = BX * BY;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
  stage_padded_taps<KMAX>(a.taps, a.K, a.Ly * a.Lx, tp, tid, nth);
  const int TX = BX, TY = BY * PY;
  const int nty = (a.Ho + TY - 1) / TY;
  const int plane = a.rows_w * a.pitch;
  const int ox0 = blockIdx.x * TX;
  for (long long p = blockIdx.z; p < a.planes; p += gridDim.z) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* xp = a.in + nn * a.si0 + c * a.si1;
    float* yp = a.out + nn * a.so0 + c * a.so1;
    for (int tyt = blockIdx.y; tyt < nty; tyt += gridDim.y) {
      const int oy0 = tyt * TY;
      __syncthreads();  // taps staged; the last tile's window consumed
      for (int r = tid; r < a.rows_w; r += nth) rsrc[r] = a.y.src(2 * oy0 + r);
      for (int q = tid; q < a.cols_w; q += nth)
        csrc[q] = a.x.src(2 * ox0 + q);
      __syncthreads();
      {
        int r = tid / a.cols_w, q = tid - r * a.cols_w;
        const int dr = nth / a.cols_w, dq = nth - dr * a.cols_w;
        while (r < a.rows_w) {
          const int rs = rsrc[r], cs = csrc[q];
          float* dst = win + (q & 1) * plane + r * a.pitch + (q >> 1);
          if (rs >= 0 && cs >= 0)
            cp_async4(dst, xp + rs * a.si2 + cs * a.si3);
          else
            *dst = 0.f;
          r += dr;
          q += dq;
          if (q >= a.cols_w) {
            q -= a.cols_w;
            ++r;
          }
        }
      }
      cp_async_wait_all();  // the window's (and the first time the taps')
      __syncthreads();
      float acc[PY][KMAX];
#pragma unroll
      for (int i = 0; i < PY; ++i)
#pragma unroll
        for (int k = 0; k < KMAX; ++k) acc[i][k] = 0.f;
      const int pstep = 2 * BY * a.pitch;
      for (int ay = 0; ay < a.Ly; ++ay) {
        const float* rowp = win + (2 * ty + ay) * a.pitch + tx;
        const float4* trow =
            reinterpret_cast<const float4*>(tp + ay * a.Lx * KMAX);
#pragma unroll 2
        for (int c2 = 0; 2 * c2 < a.Lx; ++c2) {
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const int bx = 2 * c2 + par;
            if (bx < a.Lx) {
              float t[KMAX];
#pragma unroll
              for (int q = 0; q < KMAX / 4; ++q) {
                const float4 f = trow[bx * (KMAX / 4) + q];
                t[4 * q] = f.x;
                t[4 * q + 1] = f.y;
                t[4 * q + 2] = f.z;
                t[4 * q + 3] = f.w;
              }
              const float* vp = rowp + par * plane + c2;
#pragma unroll
              for (int i = 0; i < PY; ++i) {
                const float v = vp[i * pstep];
#pragma unroll
                for (int k = 0; k < KMAX; ++k)
                  acc[i][k] = fmaf(t[k], v, acc[i][k]);
              }
            }
          }
        }
      }
      const int ox = ox0 + tx;
      if (ox < a.Wo) {
#pragma unroll
        for (int i = 0; i < PY; ++i) {
          const int oy = oy0 + ty + BY * i;
          if (oy < a.Ho) {
            float* o = yp + oy * a.so2 + ox * a.so3;
#pragma unroll
            for (int k = 0; k < KMAX; ++k)
              if (k < a.K) o[k * a.sok] = acc[i][k];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- adjoint

struct AdjArgs {
  const float* in;  // dy (N, C, K, Hi, Wi)
  float* out;       // dx (N, C, H, W)
  const float* taps;
  int K, Ly, Lx, C, Hi, Wi, H, W, fy, fx;
  int Ay, Ax;                 // ceil(Ly / 2), ceil(Lx / 2)
  int U0, V0, nU, nV;         // the quads (padded position / 2) computed
  int rows, cols;             // the staged cotangent window
  long long planes, si0, si1, sik, si2, si3, so0, so1, so2, so3;
};

inline size_t adj_smem(int kmax, int Ly, int Lx, int bx, int by) {
  const int rows = PY * by + (Ly + 1) / 2 - 1, cols = bx + (Lx + 1) / 2 - 1;
  return sizeof(float) * ((size_t)Ly * Lx * kmax + (size_t)kmax * rows * cols);
}

// The pixel of position u - f along an axis of n pixels: itself (a pixel
// where 0 <= it < n), or under ROT (K15's 'periodization' roll) wrapped
// once into [0, n).
template <bool ROT>
__device__ __forceinline__ int out_index(int i, int n) {
  if (ROT) {
    if (i < 0) return i + n;
    if (i >= n) return i - n;
  }
  return i;
}

__device__ __forceinline__ float dot4(float4 t, float4 d, float acc) {
  acc = fmaf(t.x, d.x, acc);
  acc = fmaf(t.y, d.y, acc);
  acc = fmaf(t.z, d.z, acc);
  return fmaf(t.w, d.w, acc);
}

template <int KMAX, bool ROT>
__global__ void __launch_bounds__(256) afb_adjoint_tile_kernel(AdjArgs a) {
  extern __shared__ float4 sm4[];
  float* tp = reinterpret_cast<float*>(sm4);  // Ly x Lx x KMAX
  float4* dyw = reinterpret_cast<float4*>(tp + a.Ly * a.Lx * KMAX);
  const int BX = blockDim.x, BY = blockDim.y, nth = BX * BY;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
  stage_padded_taps<KMAX>(a.taps, a.K, a.Ly * a.Lx, tp, tid, nth);
  const int TQX = BX, TQY = BY * PY;
  const int nty = (a.nU + TQY - 1) / TQY;
  const int Vt = a.V0 + blockIdx.x * TQX;
  const int rc = a.rows * a.cols;
  for (long long p = blockIdx.z; p < a.planes; p += gridDim.z) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* gp = a.in + nn * a.si0 + c * a.si1;
    float* yp = a.out + nn * a.so0 + c * a.so1;
    for (int tyt = blockIdx.y; tyt < nty; tyt += gridDim.y) {
      const int Ut = a.U0 + tyt * TQY;
      const int o0 = Ut - (a.Ay - 1), q0 = Vt - (a.Ax - 1);
      __syncthreads();  // taps staged; the last tile's window consumed
      {
        // element ((g rc + r cols + q) 4 + kk) of the window holds
        // dy[4 g + kk][o0 + r][q0 + q]; nth is a multiple of 8, so a
        // thread keeps its kk and walks (g, r, q)
        const int kk = tid & 3, step = nth >> 2;
        int e = tid >> 2;
        int g = e / rc, rem = e - g * rc;
        int r = rem / a.cols, q = rem - r * a.cols;
        const int dg = step / rc, drem = step - dg * rc;
        const int dr = drem / a.cols, dq = drem - dr * a.cols;
        float* w = reinterpret_cast<float*>(dyw);
        while (g < KMAX / 4) {
          const int k = 4 * g + kk, o = o0 + r, oq = q0 + q;
          float* dst = w + (g * rc + r * a.cols + q) * 4 + kk;
          if (k < a.K && o >= 0 && o < a.Hi && oq >= 0 && oq < a.Wi)
            cp_async4(dst, gp + k * a.sik + o * a.si2 + oq * a.si3);
          else
            *dst = 0.f;
          g += dg;
          r += dr;
          q += dq;
          if (q >= a.cols) {
            q -= a.cols;
            ++r;
          }
          if (r >= a.rows) {
            r -= a.rows;
            ++g;
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      float acc[PY][2][2];
#pragma unroll
      for (int i = 0; i < PY; ++i)
        acc[i][0][0] = acc[i][0][1] = acc[i][1][0] = acc[i][1][1] = 0.f;
      for (int al = 0; al < a.Ay; ++al) {
        const bool y1 = 2 * al + 1 < a.Ly;
#pragma unroll 2
        for (int be = 0; be < a.Ax; ++be) {
          const bool x1 = 2 * be + 1 < a.Lx;
          const float4* t00 = reinterpret_cast<const float4*>(
              tp + ((2 * al) * a.Lx + 2 * be) * KMAX);
          const float4* t01 = t00 + KMAX / 4;
          const float4* t10 = t00 + a.Lx * (KMAX / 4);
          const float4* t11 = t10 + KMAX / 4;
          const float4* dp =
              dyw + (ty + a.Ay - 1 - al) * a.cols + tx + a.Ax - 1 - be;
#pragma unroll
          for (int g = 0; g < KMAX / 4; ++g) {
            const float4 f00 = t00[g];
            const float4 f01 = x1 ? t01[g] : make_float4(0, 0, 0, 0);
            const float4 f10 = y1 ? t10[g] : make_float4(0, 0, 0, 0);
            const float4 f11 =
                (x1 && y1) ? t11[g] : make_float4(0, 0, 0, 0);
#pragma unroll
            for (int i = 0; i < PY; ++i) {
              const float4 d = dp[g * rc + i * BY * a.cols];
              acc[i][0][0] = dot4(f00, d, acc[i][0][0]);
              if (x1) acc[i][0][1] = dot4(f01, d, acc[i][0][1]);
              if (y1) acc[i][1][0] = dot4(f10, d, acc[i][1][0]);
              if (x1 && y1) acc[i][1][1] = dot4(f11, d, acc[i][1][1]);
            }
          }
        }
      }
      const int V = Vt + tx;
#pragma unroll
      for (int i = 0; i < PY; ++i) {
        const int U = Ut + ty + BY * i;
        if (U >= a.U0 + a.nU || V >= a.V0 + a.nV) continue;
#pragma unroll
        for (int du = 0; du < 2; ++du) {
          const int ii = out_index<ROT>(2 * U + du - a.fy, a.H);
          if (ii < 0 || ii >= a.H) continue;
#pragma unroll
          for (int dv = 0; dv < 2; ++dv) {
            const int jj = out_index<ROT>(2 * V + dv - a.fx, a.W);
            if (jj >= 0 && jj < a.W)
              yp[ii * a.so2 + jj * a.so3] = acc[i][du][dv];
          }
        }
      }
    }
  }
}

template <typename K>
int set_smem(K* k, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace
