// K11 avg_pool2: the scattering layers' 2x2 average pool and its adjoint.
//
// Replaces pytorch_wavelets_tpu/transforms/scatternet.py:avg_pool2 (l.46),
// which the TPU runs as two thin operator matmuls (part of B6).
//
// - avg_pool2_fwd: y[i, j] = 0.25 * ((x[2i, 2j] + x[2i, 2j+1]) +
//   (x[2i+1, 2j] + x[2i+1, 2j+1])) of every (N, C) plane of an (N, C, H, W)
//   view read through its strides, into a contiguous (N, C, H/2, W/2)
//   tensor.  The rounded intrinsics fix the order of the sums, so the
//   result is bit-equal to the plain version's (ops/pool.py).
// - avg_pool2_bwd: the adjoint, dx[2i + a, 2j + b] = 0.25 * g[i, j], from a
//   strided cotangent into a contiguous (N, C, 2h, 2w) tensor.
//
// Bound: bytes (forward: 4 reads and 1 write per output, 4 flops; adjoint:
// 1 read and 4 writes).  Two instantiations of each; the C entries pick
// one and return it to the wrappers (ops/pool.py counts it):
//
// - `vector`: rows at unit stride whose pairs (2j, 2j+1) of x never
//   straddle a 16-byte line (x on a whole pair, its row and plane strides
//   even), for the forward; a cotangent at unit stride along w, for the
//   adjoint.  The grid is planes x chunks of the plane's h x S slots; a
//   block splits its plane into (n, c) once and holds the 64-bit bases,
//   offsets within a plane are 32-bit; (i, slot) by one 32-bit division
//   by S.  A slot is 2 outputs, P_SLOTS slots a thread, P_THREADS apart,
//   all loaded before any is stored.  Forward: one float4 of each of rows
//   2i and 2i+1 (row 2i's where the slots are anchored, on its 16-byte
//   lines; row 2i+1's where it is aligned, else two float2), one float2
//   store where aligned.  Adjoint: slots anchored on dx's lines; a float2
//   of the cotangent (where aligned) becomes one float4 (v0, v0, v1, v1)
//   in each of rows 2i and 2i+1 (two float2 where row 2i+1 is not on a
//   line: odd w).  A row's partial first or last slot (an x row that
//   starts 8 bytes into a line, odd w) is taken value by value.
// - `strided`: every other view: P_STEPS outputs a thread, (i, j) by one
//   division by w, 32-bit offsets within a plane where the extents fit,
//   64-bit past that.
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int P_THREADS = 256;   // a block (both instantiations)
constexpr int P_SLOTS = 2;       // vector: slots of 2 outputs a thread
constexpr int P_STEPS = 4;       // strided: outputs a thread
constexpr long long SIZE32 = 1LL << 31;

// The instantiation codes the C entries return (ops/pool.py:POOL_INSTS).
enum PInst { P_VECTOR = 0, P_STRIDED = 1 };

struct PArgs {
  int C, h, w;                   // the pooled (cotangent) plane
  long long s0, s1, s2, s3;      // the input's strides
  int S;                         // vector: slots a row
  long long cpp;                 // chunks a plane
  long long nb;                  // blocks: planes * cpp
};

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// 0.25 * ((x00 + x01) + (x10 + x11)), in the plain version's order
__device__ __forceinline__ float pool4(float x00, float x01, float x10,
                                       float x11) {
  return __fmul_rn(__fadd_rn(__fadd_rn(x00, x01), __fadd_rn(x10, x11)),
                   0.25f);
}

// four floats at p: one float4 where aligned, else two float2 (p 8-byte
// aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  if (aligned(p, 16)) return __ldg(reinterpret_cast<const float4*>(p));
  const float2 a = __ldg(reinterpret_cast<const float2*>(p));
  const float2 b = __ldg(reinterpret_cast<const float2*>(p + 2));
  return make_float4(a.x, a.y, b.x, b.y);
}

// (v0, v0, v1, v1) at p, streamed (evict-first: dx is written once and
// is 4x the cotangent): one float4 where aligned, else two float2 (p
// 8-byte aligned)
__device__ __forceinline__ void store_spread(float* p, float v0, float v1) {
  if (aligned(p, 16)) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v0, v0, v1, v1));
  } else {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v0, v0));
    __stcs(reinterpret_cast<float2*>(p + 2), make_float2(v1, v1));
  }
}

// ---------------------------------------------------------------------------
// vector
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(P_THREADS)
    pool_fwd_vector(const float* __restrict__ x, float* __restrict__ y,
                    PArgs a) {
  const int s2 = (int)a.s2, h = a.h, w = a.w, S = a.S;
  const int slots = h * S;
  for (int blk = blockIdx.x; blk < (int)a.nb; blk += gridDim.x) {
    const int p = blk / (int)a.cpp, chunk = blk - p * (int)a.cpp;
    const int n = p / a.C, c = p - n * a.C;
    const float* xb = x + n * a.s0 + c * a.s1;
    float* yb = y + (long long)p * h * w;
    float4 top[P_SLOTS], bot[P_SLOTS];
    int row[P_SLOTS], j0[P_SLOTS];
    bool full[P_SLOTS];
#pragma unroll
    for (int u = 0; u < P_SLOTS; ++u) {
      const int e = chunk * (P_THREADS * P_SLOTS) + u * P_THREADS +
                    threadIdx.x;
      full[u] = false;
      row[u] = -1;
      if (e >= slots) continue;
      const int i = e / S, s = e - i * S;
      const float* r = xb + 2 * i * s2;
      // slots are anchored on row 2i's 16-byte lines: a row that starts
      // 8 bytes into one has its first output before the line
      row[u] = i;
      j0[u] = 2 * s - (int)((reinterpret_cast<uintptr_t>(r) & 15) / 8);
      full[u] = j0[u] >= 0 && j0[u] + 2 <= w;
      if (!full[u]) continue;
      top[u] = __ldg(reinterpret_cast<const float4*>(r + 2 * j0[u]));
      bot[u] = load4(r + s2 + 2 * j0[u]);
    }
#pragma unroll
    for (int u = 0; u < P_SLOTS; ++u) {
      if (row[u] < 0) continue;
      const int i = row[u];
      float* yr = yb + i * w;
      if (full[u]) {
        const float v0 = pool4(top[u].x, top[u].y, bot[u].x, bot[u].y);
        const float v1 = pool4(top[u].z, top[u].w, bot[u].z, bot[u].w);
        float* q = yr + j0[u];
        if (aligned(q, 8)) {
          *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
        } else {
          q[0] = v0;
          q[1] = v1;
        }
      } else {   // a row's partial first or last slot
        const float* r = xb + 2 * i * s2;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int j = j0[u] + v;
          if (j < 0 || j >= w) continue;
          const float* q = r + 2 * j;
          yr[j] = pool4(q[0], q[1], q[s2], q[s2 + 1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(P_THREADS)
    pool_bwd_vector(const float* __restrict__ g, float* __restrict__ dx,
                    PArgs a) {
  const int s2 = (int)a.s2, h = a.h, w = a.w, S = a.S;
  const int slots = h * S;
  for (int blk = blockIdx.x; blk < (int)a.nb; blk += gridDim.x) {
    const int p = blk / (int)a.cpp, chunk = blk - p * (int)a.cpp;
    const int n = p / a.C, c = p - n * a.C;
    const float* gb = g + n * a.s0 + c * a.s1;
    float* db = dx + (long long)p * 4 * h * w;
    float2 v[P_SLOTS];
    int row[P_SLOTS], j0[P_SLOTS];
#pragma unroll
    for (int u = 0; u < P_SLOTS; ++u) {
      const int e = chunk * (P_THREADS * P_SLOTS) + u * P_THREADS +
                    threadIdx.x;
      row[u] = -1;
      if (e >= slots) continue;
      const int i = e / S, s = e - i * S;
      const float* q = gb + i * s2 + 2 * s;
      row[u] = i;
      j0[u] = 2 * s;   // dx's rows start on 16-byte lines
      if (j0[u] + 2 <= w) {
        v[u] = aligned(q, 8) ? __ldg(reinterpret_cast<const float2*>(q))
                             : make_float2(__ldg(q), __ldg(q + 1));
      } else {         // odd w: the row's last j alone
        v[u] = make_float2(__ldg(q), 0.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < P_SLOTS; ++u) {
      if (row[u] < 0) continue;
      float* r = db + row[u] * 4 * w + 2 * j0[u];   // row 2i
      const float v0 = __fmul_rn(v[u].x, 0.25f);
      if (j0[u] + 2 <= w) {
        const float v1 = __fmul_rn(v[u].y, 0.25f);
        __stcs(reinterpret_cast<float4*>(r), make_float4(v0, v0, v1, v1));
        store_spread(r + 2 * w, v0, v1);           // 8 bytes off: odd w
      } else {
        __stcs(reinterpret_cast<float2*>(r), make_float2(v0, v0));
        __stcs(reinterpret_cast<float2*>(r + 2 * w), make_float2(v0, v0));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// strided
// ---------------------------------------------------------------------------

template <typename I>
__global__ void __launch_bounds__(P_THREADS)
    pool_fwd_strided(const float* __restrict__ x, float* __restrict__ y,
                     PArgs a) {
  const I per = (I)P_THREADS * P_STEPS, hw = (I)a.h * a.w;
  for (long long blk = blockIdx.x; blk < a.nb; blk += gridDim.x) {
    const long long p = blk / a.cpp;
    const I chunk = (I)(blk - p * a.cpp);
    const long long n = p / a.C;
    const int c = (int)(p - n * a.C);
    const float* xb = x + n * a.s0 + c * a.s1;
    float* yb = y + p * hw;
#pragma unroll
    for (int u = 0; u < P_STEPS; ++u) {
      const I e = chunk * per + (I)u * P_THREADS + (I)threadIdx.x;
      if (e >= hw) break;
      const I i = e / a.w, j = e - i * a.w;
      const float* q = xb + (2 * i * (I)a.s2 + 2 * j * (I)a.s3);
      const I s2 = (I)a.s2, s3 = (I)a.s3;
      yb[e] = pool4(q[0], q[s3], q[s2], q[s2 + s3]);
    }
  }
}

template <typename I>
__global__ void __launch_bounds__(P_THREADS)
    pool_bwd_strided(const float* __restrict__ g, float* __restrict__ dx,
                     PArgs a) {
  const I per = (I)P_THREADS * P_STEPS, hw = (I)a.h * a.w;
  for (long long blk = blockIdx.x; blk < a.nb; blk += gridDim.x) {
    const long long p = blk / a.cpp;
    const I chunk = (I)(blk - p * a.cpp);
    const long long n = p / a.C;
    const int c = (int)(p - n * a.C);
    const float* gb = g + n * a.s0 + c * a.s1;
    float* db = dx + p * 4 * hw;
#pragma unroll
    for (int u = 0; u < P_STEPS; ++u) {
      const I e = chunk * per + (I)u * P_THREADS + (I)threadIdx.x;
      if (e >= hw) break;
      const I i = e / a.w, j = e - i * a.w;
      const float v = __fmul_rn(gb[i * (I)a.s2 + j * (I)a.s3], 0.25f);
      // dx 8-byte aligned, as every allocation is: (2i, 2j) a whole pair
      float2* r = reinterpret_cast<float2*>(db + 4 * i * (I)a.w + 2 * j);
      r[0] = make_float2(v, v);
      r[a.w] = make_float2(v, v);
    }
  }
}

long long abs_ll(long long v) { return v < 0 ? -v : v; }

unsigned grid_of(long long nb) {
  return static_cast<unsigned>(nb < (1LL << 30) ? nb : (1LL << 30));
}

// The vector grid (a.cpp, a.nb) for S slots a row; false where a plane's
// slots or the blocks pass 32 bits
bool vector_grid(long long planes, PArgs& a) {
  const long long per = (long long)P_THREADS * P_SLOTS;
  a.cpp = ((long long)a.h * a.S + per - 1) / per;
  a.nb = planes * a.cpp;
  return (long long)a.h * a.S + per < SIZE32 && a.nb < SIZE32;
}

// The strided grid; true where 32-bit offsets within a plane do (the
// input's extent ``ext``, the outputs 4 h w)
bool strided_grid(long long planes, long long ext, PArgs& a) {
  const long long per = (long long)P_THREADS * P_STEPS;
  const long long hw = (long long)a.h * a.w;
  a.cpp = (hw + per - 1) / per;
  a.nb = planes * a.cpp;
  return 4 * hw + per < SIZE32 / 2 && ext < SIZE32 / 2;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, C, 2h, 2w) at strides sx0..sx3; y: contiguous (N, C, h, w);
// inst: set to the instantiation launched, 0 vector, 1 strided.
int avg_pool2_fwd(const void* x, void* y, long long N, int C, int h, int w,
                  long long sx0, long long sx1, long long sx2, long long sx3,
                  int* inst, void* stream) {
  const long long planes = N * C;
  if (planes * h * w == 0) return 0;
  PArgs a{C, h, w, sx0, sx1, sx2, sx3, 0, 0, 0};
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the vector layout: unit stride along W, every pair (2j, 2j+1) within
  // a 16-byte line, 32-bit offsets within a plane
  bool ok = sx3 == 1 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  for (long long s : {sx0, sx1, sx2}) ok = ok && s % 2 == 0;
  ok = ok && (2LL * h) * abs_ll(sx2) + 2LL * w < SIZE32;
  // slots of 2 outputs anchored on row 2i's lines: one more a row unless
  // every row starts on one
  const bool lines = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     sx0 % 4 == 0 && sx1 % 4 == 0;
  a.S = (w - 1 + (lines ? 0 : 1)) / 2 + 1;
  if (ok && vector_grid(planes, a)) {
    *inst = P_VECTOR;
    pool_fwd_vector<<<grid_of(a.nb), P_THREADS, 0, st>>>(xp, yp, a);
    return static_cast<int>(cudaGetLastError());
  }
  *inst = P_STRIDED;
  const long long ext = (2LL * h - 1) * abs_ll(sx2) +
                        (2LL * w - 1) * abs_ll(sx3);
  if (strided_grid(planes, ext, a))
    pool_fwd_strided<int><<<grid_of(a.nb), P_THREADS, 0, st>>>(xp, yp, a);
  else
    pool_fwd_strided<long long><<<grid_of(a.nb), P_THREADS, 0, st>>>(xp, yp,
                                                                    a);
  return static_cast<int>(cudaGetLastError());
}

// g: (N, C, h, w) at strides sg0..sg3; dx: contiguous (N, C, 2h, 2w)
// (vector: 16-byte aligned, as every allocation is; strided: 8); inst as
// above.
int avg_pool2_bwd(const void* g, void* dx, long long N, int C, int h, int w,
                  long long sg0, long long sg1, long long sg2, long long sg3,
                  int* inst, void* stream) {
  const long long planes = N * C;
  if (planes * h * w == 0) return 0;
  PArgs a{C, h, w, sg0, sg1, sg2, sg3, 0, 0, 0};
  const float* gp = static_cast<const float*>(g);
  float* dp = static_cast<float*>(dx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  a.S = (w + 1) / 2;
  if (sg3 == 1 && reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
      (long long)h * abs_ll(sg2) + w < SIZE32 &&
      4LL * h * w < SIZE32 && vector_grid(planes, a)) {
    *inst = P_VECTOR;
    pool_bwd_vector<<<grid_of(a.nb), P_THREADS, 0, st>>>(gp, dp, a);
    return static_cast<int>(cudaGetLastError());
  }
  *inst = P_STRIDED;
  const long long ext = (h - 1LL) * abs_ll(sg2) + (w - 1LL) * abs_ll(sg3);
  if (strided_grid(planes, ext, a))
    pool_bwd_strided<int><<<grid_of(a.nb), P_THREADS, 0, st>>>(gp, dp, a);
  else
    pool_bwd_strided<long long><<<grid_of(a.nb), P_THREADS, 0, st>>>(gp, dp,
                                                                    a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
