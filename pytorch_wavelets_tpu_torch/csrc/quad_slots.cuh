// The slot plan K2 (q2c_pack.cu) and K3 (c2q_unpack.cu) share: both walk
// a level's bands in their default layout (re/im adjacent, w pairs
// adjacent), K2 writing them and K3 reading them, in slots of V = 16 /
// (2 * size) values of j (2 on fp32, 4 on bf16) anchored on the 16-byte
// lines of orientation o1's rows, and take every other view through its
// strides.  Here: the launch constants, the 8- and 16-byte accesses of
// each element type with their alignment checks, the anchor and the
// slots a row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "elem.cuh"

constexpr int Q_THREADS = 256;   // a block (both instantiations)
constexpr int Q_SLOTS = 2;       // vector: slots a thread, Q_THREADS apart
constexpr int Q_STEPS = 4;       // strided: values a thread
constexpr long long SIZE32 = 1LL << 31;

// The instantiation codes the C entries return (ops/quad.py:Q2C_INSTS).
enum QInst { Q_VECTOR = 0, Q_STRIDED = 1 };

// The 8- and 16-byte accesses of V values of each element type.
template <typename E>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int V = 2;
  // V values at p (8 bytes)
  __device__ static void run(const float* p, float (&v)[2]) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  }
  // 2V values at p (16 bytes), a and b interleaved
  __device__ static void pairs(const float* p, float (&a)[2],
                               float (&b)[2]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    a[0] = q.x;
    b[0] = q.y;
    a[1] = q.z;
    b[1] = q.w;
  }
  // V (re, im) pairs at p (16 bytes)
  __device__ static void store(float* p, const float (&re)[2],
                               const float (&im)[2]) {
    *reinterpret_cast<float4*>(p) = make_float4(re[0], im[0], re[1], im[1]);
  }
  // one (re, im) pair at p (8 bytes)
  __device__ static void store1(float* p, float re, float im) {
    *reinterpret_cast<float2*>(p) = make_float2(re, im);
  }
  // V values at p (8 bytes)
  __device__ static void put(float* p, const float (&v)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
  // 2V values at p (16 bytes): a's V, then b's
  __device__ static void put2(float* p, const float (&a)[2],
                              const float (&b)[2]) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], b[0], b[1]);
  }
};

__device__ __forceinline__ __nv_bfloat162 as_bf2(unsigned u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<const unsigned*>(&h);
}

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 4;
  __device__ static void run(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __low2float(as_bf2(q.x));
    v[1] = __high2float(as_bf2(q.x));
    v[2] = __low2float(as_bf2(q.y));
    v[3] = __high2float(as_bf2(q.y));
  }
  __device__ static void pairs(const __nv_bfloat16* p, float (&a)[4],
                               float (&b)[4]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      a[v] = __low2float(as_bf2(w[v]));
      b[v] = __high2float(as_bf2(w[v]));
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&re)[4],
                               const float (&im)[4]) {
    unsigned w[4];
#pragma unroll
    for (int v = 0; v < 4; ++v)
      w[v] = as_u32(__floats2bfloat162_rn(re[v], im[v]));
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static void store1(__nv_bfloat16* p, float re, float im) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(re, im);
  }
  __device__ static void put(__nv_bfloat16* p, const float (&v)[4]) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(as_u32(__floats2bfloat162_rn(v[0], v[1])),
                   as_u32(__floats2bfloat162_rn(v[2], v[3])));
  }
  __device__ static void put2(__nv_bfloat16* p, const float (&a)[4],
                              const float (&b)[4]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(as_u32(__floats2bfloat162_rn(a[0], a[1])),
                   as_u32(__floats2bfloat162_rn(a[2], a[3])),
                   as_u32(__floats2bfloat162_rn(b[0], b[1])),
                   as_u32(__floats2bfloat162_rn(b[2], b[3])));
  }
};

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// V values at p: one 8-byte load where aligned, else value by value
template <typename E>
__device__ __forceinline__ void load_run(const E* p, float (&v)[Vec<E>::V]) {
  if (aligned(p, 8)) {
    Vec<E>::run(p, v);
  } else {
#pragma unroll
    for (int u = 0; u < Vec<E>::V; ++u) v[u] = to_float(p[u]);
  }
}

// 2V interleaved values at p: one 16-byte load where aligned
template <typename E>
__device__ __forceinline__ void load_pairs(const E* p, float (&a)[Vec<E>::V],
                                           float (&b)[Vec<E>::V]) {
  if (aligned(p, 16)) {
    Vec<E>::pairs(p, a, b);
  } else {
#pragma unroll
    for (int u = 0; u < Vec<E>::V; ++u) {
      a[u] = to_float(p[2 * u]);
      b[u] = to_float(p[2 * u + 1]);
    }
  }
}

// V (re, im) pairs at p: one 16-byte store where aligned, else a pair a
// store (p on a whole pair)
template <typename E>
__device__ __forceinline__ void store_cplx(E* p, const float (&re)[Vec<E>::V],
                                           const float (&im)[Vec<E>::V]) {
  if (aligned(p, 16)) {
    Vec<E>::store(p, re, im);
  } else {
#pragma unroll
    for (int u = 0; u < Vec<E>::V; ++u)
      Vec<E>::store1(p + 2 * u, re[u], im[u]);
  }
}

// V values at p: one 8-byte store where aligned, else value by value
template <typename E>
__device__ __forceinline__ void store_run(E* p, const float (&v)[Vec<E>::V]) {
  if (aligned(p, 8)) {
    Vec<E>::put(p, v);
  } else {
#pragma unroll
    for (int u = 0; u < Vec<E>::V; ++u) p[u] = from_float<E>(v[u]);
  }
}

// 2V values at p, a's V then b's: one 16-byte store where aligned, else
// two runs
template <typename E>
__device__ __forceinline__ void store_run2(E* p, const float (&a)[Vec<E>::V],
                                           const float (&b)[Vec<E>::V]) {
  if (aligned(p, 16)) {
    Vec<E>::put2(p, a, b);
  } else {
    store_run(p, a);
    store_run(p + Vec<E>::V, b);
  }
}

// The j of a band row that lie before the 16-byte line it starts in: the
// row's first slot begins there (slots are anchored on o1's lines).
template <typename E>
__device__ __forceinline__ int line_head(const E* row) {
  return (int)((reinterpret_cast<uintptr_t>(row) & 15) / (2 * sizeof(E)));
}

inline long long abs_ll(long long v) { return v < 0 ? -v : v; }

inline unsigned grid_of(long long nb) {
  return static_cast<unsigned>(nb < (1LL << 30) ? nb : (1LL << 30));
}

// The vector walk's layout test on the bands (N, C, 6, h, w, 2) at
// ``bands`` with strides sn, sc, so, sh, sw, sri: (re, im) adjacent, w
// pairs adjacent, the bands on a whole pair, rows and planes whole pairs
// apart.
inline bool pair_layout(const void* bands, long long sn, long long sc,
                        long long so, long long sh, long long sw,
                        long long sri, long long esz) {
  bool ok = sri == 1 && sw == 2 &&
            reinterpret_cast<uintptr_t>(bands) % (2 * esz) == 0;
  for (long long s : {sn, sc, so, sh}) ok = ok && s % 2 == 0;
  return ok;
}

// Slots a row of k values of j, J j a slot (J a multiple of V, the j of
// one 16-byte line): one more than ceil(k / J) unless every row of the
// bands starts on a 16-byte line (the anchor puts up to V - 1 j of a row
// before its first line).
inline int slots_a_row(const void* bands, long long sn, long long sc,
                       long long so, long long sh, long long esz, int V,
                       int J, long long k) {
  bool lines = reinterpret_cast<uintptr_t>(bands) % 16 == 0;
  for (long long s : {sn, sc, so, sh}) lines = lines && (s * esz) % 16 == 0;
  return (int)((k - 1 + (lines ? 0 : V - 1)) / J + 1);
}
