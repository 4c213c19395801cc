// K4 scat_mag_fwd, K5 scat_mag_bwd and K18 scat_mag_bwd2: the scattering
// layers' smooth magnitude, its backward and that backward's backward, as
// streaming passes over the bandpass tensor.
//
// Replaces pytorch_wavelets_tpu/transforms/scatternet.py:smooth_mag (l.25)
// and _combined_mag (l.32), and the JAX autodiff of both, to second
// order.  Input: one level's bands as a (N, 6, C, h, w, 2) view (re/im
// last).
//
//   K4: r[n, o, c, i, j] = sqrt(re^2 + im^2 + b^2) - b, written to the
//       contiguous (N, 6, C, h, w) output; with `combine` the re^2 + im^2
//       are first summed over the C channels and r is (N, 6, 1, h, w).
//   K5: d re = g * re / (r + b),  d im = g * im / (r + b), with r + b
//       recomputed from the bands it reads anyway (nothing is saved in the
//       forward), g read through its strides (with `combine` one g and one
//       ratio per (n, o, i, j), broadcast over C), written to the
//       contiguous (N, 6, C, h, w, 2) band gradient.
//   K18: K5 as a function of (h, g), differentiated for the cotangent u
//       of its output dh (any strides, dh's shape): with s = r + b and
//       t = sum u * h over (re, im) (and over C with `combine`),
//       dg = t / s and dh' = (u - h * (dg / s)) * (g / s), written to a
//       contiguous (N, 6, cout, h, w) dg and (N, 6, C, h, w, 2) dh'.
//
// Every product, sum, square root and quotient is the IEEE-rounded
// intrinsic, in the order of the plain PyTorch version
// (ops/scat_mag.py), so that no FMA contraction changes a result; at
// b = 0 a zero coefficient gives 0 forward and 0/0 = NaN backward, as the
// plain version and JAX's autodiff do.
//
// Bound: bytes.  K4 reads 8 and writes 4 bytes a coefficient, K5 reads
// 8 + 4 and writes 8, K18 reads 8 + 4 + 8 and writes 4 + 8, against a
// few operations.  The design (K18 walks as K5 does, with u beside h):
//
// - No per-element index division.  The grid walks planes p = (n * 6 + o)
//   * cout + c and chunks within a plane; a block splits its p into
//   (n, o, c) with three 32-bit divisions and works out the plane's base
//   offsets in h, g and the output once.  Offsets within a plane are
//   32-bit (64-bit only where a strided view spreads a plane past 2^31
//   floats).
// - 16-byte accesses, several in flight.  The `vector` instantiation
//   takes the layout the scattering pyramids write (each plane's 2 h w
//   floats one run: re/im adjacent, rows contiguous).  A thread loads
//   MAG_PAIRS float4s of h (two coefficients each, MAG_THREADS apart, so
//   a warp's load is 512 contiguous bytes) before it uses any, and with
//   `combine` those of every channel (up to MAG_MAX_NC, kept in
//   registers: each coefficient is read once).  K4 stores r as float2,
//   K5 reads g as float2 and stores dh as float4, each where the plane's
//   alignment allows (else narrower stores, decided once a block).
// - The ragged edges.  A plane that starts 8 bytes past a 16-byte line
//   (odd h w, an offset view) takes its first coefficient alone (the
//   head); an odd count left takes its last one alone (the tail), both in
//   the plane's first chunk.
// - The `strided` instantiation keeps the arbitrary strides of every
//   other view: MAG_STEPS coefficients a thread, MAG_THREADS apart, its
//   (i, j) in the plane stepped without division.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAG_THREADS = 256;   // a block (both instantiations)
constexpr int MAG_PAIRS = 2;       // vector: float4s of h a thread
constexpr int MAG_MAX_NC = 4;      // vector: channels summed in registers
constexpr int MAG_STEPS = 4;       // strided: coefficients a thread
constexpr long long SIZE32 = 1LL << 30;  // 32-bit sizes, with headroom

enum MagInst { M_VECTOR = 0, M_STRIDED = 1 };

__device__ __forceinline__ float sq2(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

// The (n, o, c) of plane p = (n * 6 + o) * cout + c.
template <typename I>
__device__ __forceinline__ void split_plane(I p, int cout, I& n, I& o,
                                            I& c) {
  const I q = p / cout;
  c = p - q * cout;
  n = q / 6;
  o = q - n * 6;
}

struct Strides3 {
  long long n, o, c;
  __device__ __forceinline__ long long at(long long n_, long long o_,
                                          long long c_) const {
    return n_ * n + o_ * o + c_ * c;
  }
};

// ---------------------------------------------------------------------------
// vector: each plane one run of 2 P floats
// ---------------------------------------------------------------------------

struct VecArgs {
  const float* h;
  Strides3 hs;           // h's plane strides (floats)
  long long sc;          // h's channel stride, summed over with combine
  const float* g;        // K5: the cotangent, each plane one run of P
  Strides3 gs;
  int cout;              // planes a (n, o): C, or 1 with combine
  int P;                 // coefficients a plane
  int cpp;               // chunks a plane
  int nb;                // planes * cpp
  float b2, b;
};

// Coefficient k of plane hp alone (a plane's head or tail): its NC
// channels' (re, im) loaded once, as float2 (a plane starts 8-byte
// aligned), and their sum of re^2 + im^2 in channel order.
template <int NC>
__device__ __forceinline__ float load_one(const float* hp, long long sc,
                                          int k, float2 (&e)[NC]) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    e[t] = __ldg(reinterpret_cast<const float2*>(hp + t * sc) + k);
    s = __fadd_rn(s, sq2(e[t].x, e[t].y));
  }
  return s;
}

template <int NC>
__global__ void __launch_bounds__(MAG_THREADS)
    mag_fwd_vector(VecArgs a, float* __restrict__ r) {
  for (int blk = blockIdx.x; blk < a.nb; blk += gridDim.x) {
    const int p = blk / a.cpp, chunk = blk - p * a.cpp;
    int n, o, c;
    split_plane(p, a.cout, n, o, c);
    const float* hp = a.h + a.hs.at(n, o, c);
    const int head = (reinterpret_cast<uintptr_t>(hp) & 15) ? 1 : 0;
    const int pairs = (a.P - head) >> 1;
    float* rp = r + (long long)p * a.P;
    float* rq = rp + head;   // pair q's two outputs at rq + 2 q
    const bool st2 = (reinterpret_cast<uintptr_t>(rq) & 7) == 0;
    const int q0 = chunk * (MAG_THREADS * MAG_PAIRS) + threadIdx.x;
    float4 v[NC][MAG_PAIRS];
#pragma unroll
    for (int u = 0; u < MAG_PAIRS; ++u) {
      const int q = q0 + u * MAG_THREADS;
#pragma unroll
      for (int t = 0; t < NC; ++t)
        v[t][u] = q < pairs ? __ldg(reinterpret_cast<const float4*>(
                                        hp + t * a.sc + 2 * head) + q)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < MAG_PAIRS; ++u) {
      const int q = q0 + u * MAG_THREADS;
      if (q >= pairs) continue;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        s0 = __fadd_rn(s0, sq2(v[t][u].x, v[t][u].y));
        s1 = __fadd_rn(s1, sq2(v[t][u].z, v[t][u].w));
      }
      const float r0 = __fsub_rn(__fsqrt_rn(__fadd_rn(s0, a.b2)), a.b);
      const float r1 = __fsub_rn(__fsqrt_rn(__fadd_rn(s1, a.b2)), a.b);
      if (st2) {
        *reinterpret_cast<float2*>(rq + 2 * q) = make_float2(r0, r1);
      } else {
        rq[2 * q] = r0;
        rq[2 * q + 1] = r1;
      }
    }
    if (chunk == 0 && threadIdx.x == 0) {   // the head and the tail
      float2 e[NC];
      if (head)
        rp[0] = __fsub_rn(__fsqrt_rn(__fadd_rn(load_one(hp, a.sc, 0, e),
                                               a.b2)), a.b);
      if ((a.P - head) & 1)
        rp[a.P - 1] = __fsub_rn(
            __fsqrt_rn(__fadd_rn(load_one(hp, a.sc, a.P - 1, e), a.b2)),
            a.b);
    }
  }
}

// d(re, im) of coefficient k alone, every channel, for cotangent gv
template <int NC>
__device__ __forceinline__ void bwd_one(const float* hp, long long sc,
                                        float* dp, long long dstride, int k,
                                        float gv, float b2) {
  float2 e[NC];
  const float den = __fsqrt_rn(__fadd_rn(load_one(hp, sc, k, e), b2));
#pragma unroll
  for (int t = 0; t < NC; ++t)
    reinterpret_cast<float2*>(dp + t * dstride)[k] = make_float2(
        __fdiv_rn(__fmul_rn(gv, e[t].x), den),
        __fdiv_rn(__fmul_rn(gv, e[t].y), den));
}

template <int NC>
__global__ void __launch_bounds__(MAG_THREADS)
    mag_bwd_vector(VecArgs a, float* __restrict__ dh) {
  for (int blk = blockIdx.x; blk < a.nb; blk += gridDim.x) {
    const int p = blk / a.cpp, chunk = blk - p * a.cpp;
    int n, o, c;
    split_plane(p, a.cout, n, o, c);
    const float* hp = a.h + a.hs.at(n, o, c);
    const float* gp = a.g + a.gs.at(n, o, c);
    const int head = (reinterpret_cast<uintptr_t>(hp) & 15) ? 1 : 0;
    const int pairs = (a.P - head) >> 1;
    // dh is contiguous (N, 6, C, h, w, 2): channel t of this (n, o, c) at
    // plane p * NC + t (NC = 1 without combine, where p runs over C)
    const long long dstride = 2LL * a.P;
    float* dp = dh + (long long)p * NC * dstride;
    const float* gq = gp + head;
    const bool ld2 = (reinterpret_cast<uintptr_t>(gq) & 7) == 0;
    const int q0 = chunk * (MAG_THREADS * MAG_PAIRS) + threadIdx.x;
    float4 v[NC][MAG_PAIRS];
    float2 gv[MAG_PAIRS];
#pragma unroll
    for (int u = 0; u < MAG_PAIRS; ++u) {
      const int q = q0 + u * MAG_THREADS;
      const bool in = q < pairs;
#pragma unroll
      for (int t = 0; t < NC; ++t)
        v[t][u] = in ? __ldg(reinterpret_cast<const float4*>(
                                 hp + t * a.sc + 2 * head) + q)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      if (!in)
        gv[u] = make_float2(0.f, 0.f);
      else if (ld2)
        gv[u] = __ldg(reinterpret_cast<const float2*>(gq) + q);
      else
        gv[u] = make_float2(__ldg(gq + 2 * q), __ldg(gq + 2 * q + 1));
    }
#pragma unroll
    for (int u = 0; u < MAG_PAIRS; ++u) {
      const int q = q0 + u * MAG_THREADS;
      if (q >= pairs) continue;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        s0 = __fadd_rn(s0, sq2(v[t][u].x, v[t][u].y));
        s1 = __fadd_rn(s1, sq2(v[t][u].z, v[t][u].w));
      }
      const float d0 = __fsqrt_rn(__fadd_rn(s0, a.b2));
      const float d1 = __fsqrt_rn(__fadd_rn(s1, a.b2));
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        const float4 w = v[t][u];
        const float4 out = make_float4(
            __fdiv_rn(__fmul_rn(gv[u].x, w.x), d0),
            __fdiv_rn(__fmul_rn(gv[u].x, w.y), d0),
            __fdiv_rn(__fmul_rn(gv[u].y, w.z), d1),
            __fdiv_rn(__fmul_rn(gv[u].y, w.w), d1));
        float* dq = dp + t * dstride + 2 * head;
        if ((reinterpret_cast<uintptr_t>(dq) & 15) == 0) {
          reinterpret_cast<float4*>(dq)[q] = out;
        } else {   // 8 bytes past a line: a misaligned plane of odd P
          reinterpret_cast<float2*>(dq)[2 * q] = make_float2(out.x, out.y);
          reinterpret_cast<float2*>(dq)[2 * q + 1] = make_float2(out.z,
                                                                 out.w);
        }
      }
    }
    if (chunk == 0 && threadIdx.x == 0) {   // the head and the tail
      if (head) bwd_one<NC>(hp, a.sc, dp, dstride, 0, __ldg(gp), a.b2);
      if ((a.P - head) & 1)
        bwd_one<NC>(hp, a.sc, dp, dstride, a.P - 1, __ldg(gp + a.P - 1),
                    a.b2);
    }
  }
}

// ---------------------------------------------------------------------------
// strided: any view, one coefficient at a time
// ---------------------------------------------------------------------------

template <typename I>
struct StridedArgs {
  const float* h;
  Strides3 hs;
  long long sc;          // the channel stride summed over with combine
  I sh, sw, sri;         // in-plane strides of h
  const float* g;        // K5
  Strides3 gs;
  I gh, gw;
  int cout, nc;          // planes a (n, o); channels summed (1 or C)
  I P, w, cpp, nb;
  I di, dj;              // MAG_THREADS / w, MAG_THREADS % w
  float b2, b;
};

template <typename I>
__device__ __forceinline__ float strided_sum(const float* e, int nc,
                                             long long sc, I sri) {
  float s = 0.f;
  for (int t = 0; t < nc; ++t)
    s = __fadd_rn(s, sq2(e[t * sc], e[t * sc + sri]));
  return s;
}

template <typename I>
__global__ void __launch_bounds__(MAG_THREADS)
    mag_fwd_strided(StridedArgs<I> a, float* __restrict__ r) {
  for (I blk = blockIdx.x; blk < a.nb; blk += gridDim.x) {
    const I p = blk / a.cpp, chunk = blk - p * a.cpp;
    I n, o, c;
    split_plane(p, a.cout, n, o, c);
    const float* hp = a.h + a.hs.at(n, o, c);
    float* rp = r + (long long)p * a.P;
    I k = chunk * (MAG_THREADS * MAG_STEPS) + (I)threadIdx.x;
    I i = k / a.w, j = k - i * a.w;
#pragma unroll
    for (int m = 0; m < MAG_STEPS; ++m) {
      if (k < a.P) {
        const float s = strided_sum(hp + i * a.sh + j * a.sw, a.nc, a.sc,
                                    a.sri);
        rp[k] = __fsub_rn(__fsqrt_rn(__fadd_rn(s, a.b2)), a.b);
      }
      k += MAG_THREADS;
      i += a.di;
      j += a.dj;
      if (j >= a.w) {
        j -= a.w;
        ++i;
      }
    }
  }
}

template <typename I>
__global__ void __launch_bounds__(MAG_THREADS)
    mag_bwd_strided(StridedArgs<I> a, float2* __restrict__ dh) {
  for (I blk = blockIdx.x; blk < a.nb; blk += gridDim.x) {
    const I p = blk / a.cpp, chunk = blk - p * a.cpp;
    I n, o, c;
    split_plane(p, a.cout, n, o, c);
    const float* hp = a.h + a.hs.at(n, o, c);
    const float* gp = a.g + a.gs.at(n, o, c);
    // channel t of this (n, o, c) at dh's plane p * nc + t
    float2* dp = dh + (long long)p * a.nc * a.P;
    I k = chunk * (MAG_THREADS * MAG_STEPS) + (I)threadIdx.x;
    I i = k / a.w, j = k - i * a.w;
#pragma unroll
    for (int m = 0; m < MAG_STEPS; ++m) {
      if (k < a.P) {
        const float* e = hp + i * a.sh + j * a.sw;
        const float den = __fsqrt_rn(__fadd_rn(
            strided_sum(e, a.nc, a.sc, a.sri), a.b2));
        const float gv = gp[i * a.gh + j * a.gw];
        for (int t = 0; t < a.nc; ++t) {
          const float re = e[t * a.sc], im = e[t * a.sc + a.sri];
          dp[(long long)t * a.P + k] = make_float2(
              __fdiv_rn(__fmul_rn(gv, re), den),
              __fdiv_rn(__fmul_rn(gv, im), den));
        }
      }
      k += MAG_THREADS;
      i += a.di;
      j += a.dj;
      if (j >= a.w) {
        j -= a.w;
        ++i;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K18: the backward's backward, both walks
// ---------------------------------------------------------------------------

// One coefficient's K18 terms for NC channels: e the bands, w the
// cotangent u, gv the output cotangent; returns dg and writes dh' to o.
template <int NC>
__device__ __forceinline__ float bwd2_terms(const float2 (&e)[NC],
                                            const float2 (&w)[NC], float gv,
                                            float b2, float2 (&o)[NC]) {
  float s = 0.f, t = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    s = __fadd_rn(s, sq2(e[c].x, e[c].y));
    t = __fadd_rn(t, __fadd_rn(__fmul_rn(w[c].x, e[c].x),
                               __fmul_rn(w[c].y, e[c].y)));
  }
  const float den = __fsqrt_rn(__fadd_rn(s, b2));
  const float dg = __fdiv_rn(t, den);
  const float q = __fdiv_rn(dg, den), a = __fdiv_rn(gv, den);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    o[c] = make_float2(__fmul_rn(__fsub_rn(w[c].x, __fmul_rn(e[c].x, q)), a),
                       __fmul_rn(__fsub_rn(w[c].y, __fmul_rn(e[c].y, q)), a));
  return dg;
}

struct Bwd2Args {
  VecArgs v;             // h, g and the plane walk, as K5's
  const float* u;        // the cotangent of dh
  Strides3 us;
  long long uc;          // u's channel stride, summed over with combine
};

// Coefficient k of one plane alone (a head or a tail)
template <int NC>
__device__ __forceinline__ void bwd2_one(const float* hp, long long sc,
                                         const float* up, long long uc,
                                         float gv, float b2, int k,
                                         float* dgp, float* dp,
                                         long long dstride) {
  float2 e[NC], w[NC], o[NC];
  load_one<NC>(hp, sc, k, e);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float* uk = up + c * uc + 2 * k;
    w[c] = make_float2(__ldg(uk), __ldg(uk + 1));
  }
  dgp[k] = bwd2_terms<NC>(e, w, gv, b2, o);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    reinterpret_cast<float2*>(dp + c * dstride)[k] = o[c];
}

template <int NC>
__global__ void __launch_bounds__(MAG_THREADS)
    mag_bwd2_vector(Bwd2Args b, float* __restrict__ dg,
                    float* __restrict__ dh) {
  const VecArgs a = b.v;
  for (int blk = blockIdx.x; blk < a.nb; blk += gridDim.x) {
    const int p = blk / a.cpp, chunk = blk - p * a.cpp;
    int n, o, c;
    split_plane(p, a.cout, n, o, c);
    const float* hp = a.h + a.hs.at(n, o, c);
    const float* gp = a.g + a.gs.at(n, o, c);
    const float* up = b.u + b.us.at(n, o, c);
    const int head = (reinterpret_cast<uintptr_t>(hp) & 15) ? 1 : 0;
    const int pairs = (a.P - head) >> 1;
    float* dgp = dg + (long long)p * a.P;
    float* dgq = dgp + head;
    const bool st2 = (reinterpret_cast<uintptr_t>(dgq) & 7) == 0;
    const long long dstride = 2LL * a.P;
    float* dp = dh + (long long)p * NC * dstride;
    const float* gq = gp + head;
    const bool ld2 = (reinterpret_cast<uintptr_t>(gq) & 7) == 0;
    const int q0 = chunk * (MAG_THREADS * MAG_PAIRS) + threadIdx.x;
    float4 v[NC][MAG_PAIRS], w[NC][MAG_PAIRS];
    float2 gv[MAG_PAIRS];
#pragma unroll
    for (int k = 0; k < MAG_PAIRS; ++k) {
      const int q = q0 + k * MAG_THREADS;
      const bool in = q < pairs;
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        v[t][k] = in ? __ldg(reinterpret_cast<const float4*>(
                                 hp + t * a.sc + 2 * head) + q)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        const float* uq = up + t * b.uc + 2 * head;
        if (!in) {
          w[t][k] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else if ((reinterpret_cast<uintptr_t>(uq) & 15) == 0) {
          w[t][k] = __ldg(reinterpret_cast<const float4*>(uq) + q);
        } else {   // 8 bytes past a line
          const float2 lo = __ldg(reinterpret_cast<const float2*>(uq) + 2 * q);
          const float2 hi =
              __ldg(reinterpret_cast<const float2*>(uq) + 2 * q + 1);
          w[t][k] = make_float4(lo.x, lo.y, hi.x, hi.y);
        }
      }
      if (!in)
        gv[k] = make_float2(0.f, 0.f);
      else if (ld2)
        gv[k] = __ldg(reinterpret_cast<const float2*>(gq) + q);
      else
        gv[k] = make_float2(__ldg(gq + 2 * q), __ldg(gq + 2 * q + 1));
    }
#pragma unroll
    for (int k = 0; k < MAG_PAIRS; ++k) {
      const int q = q0 + k * MAG_THREADS;
      if (q >= pairs) continue;
      float2 e0[NC], e1[NC], w0[NC], w1[NC], o0[NC], o1[NC];
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        e0[t] = make_float2(v[t][k].x, v[t][k].y);
        e1[t] = make_float2(v[t][k].z, v[t][k].w);
        w0[t] = make_float2(w[t][k].x, w[t][k].y);
        w1[t] = make_float2(w[t][k].z, w[t][k].w);
      }
      const float g0 = bwd2_terms<NC>(e0, w0, gv[k].x, a.b2, o0);
      const float g1 = bwd2_terms<NC>(e1, w1, gv[k].y, a.b2, o1);
      if (st2) {
        *reinterpret_cast<float2*>(dgq + 2 * q) = make_float2(g0, g1);
      } else {
        dgq[2 * q] = g0;
        dgq[2 * q + 1] = g1;
      }
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        const float4 out = make_float4(o0[t].x, o0[t].y, o1[t].x, o1[t].y);
        float* dq = dp + t * dstride + 2 * head;
        if ((reinterpret_cast<uintptr_t>(dq) & 15) == 0) {
          reinterpret_cast<float4*>(dq)[q] = out;
        } else {
          reinterpret_cast<float2*>(dq)[2 * q] = o0[t];
          reinterpret_cast<float2*>(dq)[2 * q + 1] = o1[t];
        }
      }
    }
    if (chunk == 0 && threadIdx.x == 0) {   // the head and the tail
      if (head)
        bwd2_one<NC>(hp, a.sc, up, b.uc, __ldg(gp), a.b2, 0, dgp, dp,
                     dstride);
      if ((a.P - head) & 1)
        bwd2_one<NC>(hp, a.sc, up, b.uc, __ldg(gp + a.P - 1), a.b2,
                     a.P - 1, dgp, dp, dstride);
    }
  }
}

template <typename I>
struct Bwd2Strided {
  StridedArgs<I> s;      // h, g and the walk, as K5's
  const float* u;
  Strides3 us;
  long long uc;
  I uh, uw, uri;
};

template <typename I>
__global__ void __launch_bounds__(MAG_THREADS)
    mag_bwd2_strided(Bwd2Strided<I> b, float* __restrict__ dg,
                     float2* __restrict__ dh) {
  const StridedArgs<I> a = b.s;
  for (I blk = blockIdx.x; blk < a.nb; blk += gridDim.x) {
    const I p = blk / a.cpp, chunk = blk - p * a.cpp;
    I n, o, c;
    split_plane(p, a.cout, n, o, c);
    const float* hp = a.h + a.hs.at(n, o, c);
    const float* gp = a.g + a.gs.at(n, o, c);
    const float* up = b.u + b.us.at(n, o, c);
    float* dgp = dg + (long long)p * a.P;
    float2* dp = dh + (long long)p * a.nc * a.P;
    I k = chunk * (MAG_THREADS * MAG_STEPS) + (I)threadIdx.x;
    I i = k / a.w, j = k - i * a.w;
#pragma unroll
    for (int m = 0; m < MAG_STEPS; ++m) {
      if (k < a.P) {
        const float* e = hp + i * a.sh + j * a.sw;
        const float* f = up + i * b.uh + j * b.uw;
        float s = 0.f, t = 0.f;
        for (int ch = 0; ch < a.nc; ++ch) {
          const float re = e[ch * a.sc], im = e[ch * a.sc + a.sri];
          const float ur = f[ch * b.uc], ui = f[ch * b.uc + b.uri];
          s = __fadd_rn(s, sq2(re, im));
          t = __fadd_rn(t, __fadd_rn(__fmul_rn(ur, re), __fmul_rn(ui, im)));
        }
        const float den = __fsqrt_rn(__fadd_rn(s, a.b2));
        const float dgk = __fdiv_rn(t, den);
        const float q = __fdiv_rn(dgk, den);
        const float av = __fdiv_rn(gp[i * a.gh + j * a.gw], den);
        dgp[k] = dgk;
        for (int ch = 0; ch < a.nc; ++ch) {
          const float re = e[ch * a.sc], im = e[ch * a.sc + a.sri];
          const float ur = f[ch * b.uc], ui = f[ch * b.uc + b.uri];
          dp[(long long)ch * a.P + k] = make_float2(
              __fmul_rn(__fsub_rn(ur, __fmul_rn(re, q)), av),
              __fmul_rn(__fsub_rn(ui, __fmul_rn(im, q)), av));
        }
      }
      k += MAG_THREADS;
      i += a.di;
      j += a.dj;
      if (j >= a.w) {
        j -= a.w;
        ++i;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Geometry {
  long long planes;   // N * 6 * cout
  int cout, nc;
  long long P;
};

Geometry geometry(long long N, int C, int hh, int ww, int combine) {
  Geometry q;
  q.cout = combine ? 1 : C;
  q.nc = combine ? C : 1;
  q.planes = N * 6 * q.cout;
  q.P = (long long)hh * ww;
  return q;
}

long long vector_chunks(long long P) {
  const long long per = MAG_THREADS * MAG_PAIRS;
  const long long c = (P / 2 + per - 1) / per;
  return c > 0 ? c : 1;
}

// The vector instantiation's layout (ops/scat_mag.py:mag_instantiation):
// every plane one run of 2 P floats starting 8-byte aligned, with
// combine the channels a multiple of 16 bytes apart, and 32-bit sizes.
bool vector_layout(const void* h, long long N, int C, int hh, int ww,
                   const Geometry& q, long long sn, long long so,
                   long long sc, long long sh, long long sw,
                   long long sri) {
  if (sri != 1 || (ww > 1 && sw != 2) || (hh > 1 && sh != 2LL * ww))
    return false;
  if ((reinterpret_cast<uintptr_t>(h) & 7) || (N > 1 && sn % 2) || so % 2 ||
      (C > 1 && sc % 2))
    return false;
  if (q.nc != 1 && (q.nc < 1 || q.nc > MAG_MAX_NC || sc % 4)) return false;
  return 2 * q.P < SIZE32 && q.planes * vector_chunks(q.P) < SIZE32;
}

unsigned grid_of(long long nb) {
  return static_cast<unsigned>(nb < SIZE32 ? nb : SIZE32);
}

template <typename I>
StridedArgs<I> strided_args(const void* h, const Geometry& q, int ww,
                            long long sn, long long so, long long sc,
                            long long sh, long long sw, long long sri,
                            float b2, float b) {
  StridedArgs<I> a;
  a.h = static_cast<const float*>(h);
  a.hs = Strides3{sn, so, sc};
  a.sc = sc;
  a.sh = (I)sh;
  a.sw = (I)sw;
  a.sri = (I)sri;
  a.g = nullptr;
  a.gs = Strides3{0, 0, 0};
  a.gh = a.gw = 0;
  a.cout = q.cout;
  a.nc = q.nc;
  a.P = (I)q.P;
  a.w = ww;
  const long long per = MAG_THREADS * MAG_STEPS;
  a.cpp = (I)((q.P + per - 1) / per);
  a.nb = (I)(q.planes * a.cpp);
  a.di = MAG_THREADS / ww;
  a.dj = MAG_THREADS % ww;
  a.b2 = b2;
  a.b = b;
  return a;
}

// A strided launch indexes in 32 bits where every plane's extent, the
// block count and the plane's coefficients fit.
bool strided_fits32(const Geometry& q, int hh, int ww, long long sh,
                    long long sw, long long sri, long long gh, long long gw) {
  const long long per = MAG_THREADS * MAG_STEPS;
  const long long ext = (hh - 1) * sh + (ww - 1) * sw + sri;
  const long long gext = (hh - 1) * gh + (ww - 1) * gw;
  return q.P + per < SIZE32 && q.planes * ((q.P + per - 1) / per) < SIZE32 &&
         ext < 2 * SIZE32 && gext < 2 * SIZE32;
}

VecArgs vec_args(const void* h, const Geometry& q, long long sn, long long so,
                 long long sc, float b2, float b) {
  VecArgs a;
  a.h = static_cast<const float*>(h);
  a.hs = Strides3{sn, so, sc};
  a.sc = sc;
  a.g = nullptr;
  a.gs = Strides3{0, 0, 0};
  a.cout = q.cout;
  a.P = (int)q.P;
  a.cpp = (int)vector_chunks(q.P);
  a.nb = (int)(q.planes * a.cpp);
  a.b2 = b2;
  a.b = b;
  return a;
}

// K18's vector walk also reads u as h is read: each plane one run of
// 2 P floats starting 8-byte aligned.
bool u_vector_layout(const void* u, long long N, int C, int hh, int ww,
                     long long un, long long uo, long long uc, long long uh,
                     long long uw, long long uri) {
  return uri == 1 && (ww <= 1 || uw == 2) && (hh <= 1 || uh == 2LL * ww) &&
         (reinterpret_cast<uintptr_t>(u) & 7) == 0 && (N <= 1 || un % 2 == 0) &&
         uo % 2 == 0 && (C <= 1 || uc % 2 == 0);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h: (N, 6, C, hh, ww, 2) at strides sn..sri; r: contiguous
// (N, 6, combine ? 1 : C, hh, ww).  b2 = b * b rounded to float.  inst: a
// MagInst (vector only on its layout, vector_layout).
int scat_mag_fwd(const void* h, void* r, long long N, int C, int hh, int ww,
                 int combine, long long sn, long long so, long long sc,
                 long long sh, long long sw, long long sri, float b2,
                 float b, int inst, void* stream) {
  const Geometry q = geometry(N, C, hh, ww, combine);
  if (inst != M_VECTOR && inst != M_STRIDED)
    return static_cast<int>(cudaErrorInvalidValue);
  if (inst == M_VECTOR &&
      !vector_layout(h, N, C, hh, ww, q, sn, so, sc, sh, sw, sri))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q.planes * q.P == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(r);
  if (inst == M_VECTOR) {
    const VecArgs a = vec_args(h, q, sn, so, sc, b2, b);
    const unsigned grid = grid_of(a.nb);
    switch (q.nc) {
      case 1: mag_fwd_vector<1><<<grid, MAG_THREADS, 0, st>>>(a, out); break;
      case 2: mag_fwd_vector<2><<<grid, MAG_THREADS, 0, st>>>(a, out); break;
      case 3: mag_fwd_vector<3><<<grid, MAG_THREADS, 0, st>>>(a, out); break;
      default: mag_fwd_vector<4><<<grid, MAG_THREADS, 0, st>>>(a, out);
    }
  } else if (strided_fits32(q, hh, ww, sh, sw, sri, 0, 0)) {
    const auto a = strided_args<int>(h, q, ww, sn, so, sc, sh, sw, sri, b2,
                                     b);
    mag_fwd_strided<int><<<grid_of(a.nb), MAG_THREADS, 0, st>>>(a, out);
  } else {
    const auto a = strided_args<long long>(h, q, ww, sn, so, sc, sh, sw, sri,
                                           b2, b);
    mag_fwd_strided<long long><<<grid_of(a.nb), MAG_THREADS, 0, st>>>(a,
                                                                      out);
  }
  return static_cast<int>(cudaGetLastError());
}

// h as for scat_mag_fwd; g: (N, 6, combine ? 1 : C, hh, ww) at strides
// gn..gw (the vector instantiation: each plane one run, gw == 1 and
// gh == ww); dh: contiguous (N, 6, C, hh, ww, 2).
int scat_mag_bwd(const void* h, const void* g, void* dh, long long N, int C,
                 int hh, int ww, int combine, long long sn, long long so,
                 long long sc, long long sh, long long sw, long long sri,
                 long long gn, long long go, long long gc, long long gh,
                 long long gw, float b2, int inst, void* stream) {
  const Geometry q = geometry(N, C, hh, ww, combine);
  if (inst != M_VECTOR && inst != M_STRIDED)
    return static_cast<int>(cudaErrorInvalidValue);
  if (inst == M_VECTOR &&
      (!vector_layout(h, N, C, hh, ww, q, sn, so, sc, sh, sw, sri) ||
       (ww > 1 && gw != 1) || (hh > 1 && gh != ww)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q.planes * q.P == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (inst == M_VECTOR) {
    VecArgs a = vec_args(h, q, sn, so, sc, b2, 0.f);
    a.g = static_cast<const float*>(g);
    a.gs = Strides3{gn, go, gc};
    float* out = static_cast<float*>(dh);
    const unsigned grid = grid_of(a.nb);
    switch (q.nc) {
      case 1: mag_bwd_vector<1><<<grid, MAG_THREADS, 0, st>>>(a, out); break;
      case 2: mag_bwd_vector<2><<<grid, MAG_THREADS, 0, st>>>(a, out); break;
      case 3: mag_bwd_vector<3><<<grid, MAG_THREADS, 0, st>>>(a, out); break;
      default: mag_bwd_vector<4><<<grid, MAG_THREADS, 0, st>>>(a, out);
    }
    return static_cast<int>(cudaGetLastError());
  }
  float2* out = static_cast<float2*>(dh);
  if (strided_fits32(q, hh, ww, sh, sw, sri, gh, gw)) {
    auto a = strided_args<int>(h, q, ww, sn, so, sc, sh, sw, sri, b2, 0.f);
    a.g = static_cast<const float*>(g);
    a.gs = Strides3{gn, go, gc};
    a.gh = (int)gh;
    a.gw = (int)gw;
    mag_bwd_strided<int><<<grid_of(a.nb), MAG_THREADS, 0, st>>>(a, out);
  } else {
    auto a = strided_args<long long>(h, q, ww, sn, so, sc, sh, sw, sri, b2,
                                     0.f);
    a.g = static_cast<const float*>(g);
    a.gs = Strides3{gn, go, gc};
    a.gh = gh;
    a.gw = gw;
    mag_bwd_strided<long long><<<grid_of(a.nb), MAG_THREADS, 0, st>>>(a,
                                                                       out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K18.  h as for scat_mag_fwd, g as for scat_mag_bwd; u: the cotangent of
// K5's dh, (N, 6, C, hh, ww, 2) at strides un..uri; dg: contiguous
// (N, 6, combine ? 1 : C, hh, ww); dh: contiguous (N, 6, C, hh, ww, 2).
// inst: vector only where h and g take K5's vector walk and u's planes
// are each one run (u_vector_layout).
int scat_mag_bwd2(const void* h, const void* g, const void* u, void* dg,
                  void* dh, long long N, int C, int hh, int ww, int combine,
                  long long sn, long long so, long long sc, long long sh,
                  long long sw, long long sri, long long gn, long long go,
                  long long gc, long long gh, long long gw, long long un,
                  long long uo, long long uc, long long uh, long long uw,
                  long long uri, float b2, int inst, void* stream) {
  const Geometry q = geometry(N, C, hh, ww, combine);
  if (inst != M_VECTOR && inst != M_STRIDED)
    return static_cast<int>(cudaErrorInvalidValue);
  if (inst == M_VECTOR &&
      (!vector_layout(h, N, C, hh, ww, q, sn, so, sc, sh, sw, sri) ||
       (ww > 1 && gw != 1) || (hh > 1 && gh != ww) ||
       !u_vector_layout(u, N, C, hh, ww, un, uo, uc, uh, uw, uri)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q.planes * q.P == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dgo = static_cast<float*>(dg);
  if (inst == M_VECTOR) {
    Bwd2Args b;
    b.v = vec_args(h, q, sn, so, sc, b2, 0.f);
    b.v.g = static_cast<const float*>(g);
    b.v.gs = Strides3{gn, go, gc};
    b.u = static_cast<const float*>(u);
    b.us = Strides3{un, uo, uc};
    b.uc = uc;
    float* out = static_cast<float*>(dh);
    const unsigned grid = grid_of(b.v.nb);
    switch (q.nc) {
      case 1: mag_bwd2_vector<1><<<grid, MAG_THREADS, 0, st>>>(b, dgo, out);
        break;
      case 2: mag_bwd2_vector<2><<<grid, MAG_THREADS, 0, st>>>(b, dgo, out);
        break;
      case 3: mag_bwd2_vector<3><<<grid, MAG_THREADS, 0, st>>>(b, dgo, out);
        break;
      default: mag_bwd2_vector<4><<<grid, MAG_THREADS, 0, st>>>(b, dgo, out);
    }
    return static_cast<int>(cudaGetLastError());
  }
  float2* out = static_cast<float2*>(dh);
  const long long uext = (hh - 1) * uh + (ww - 1) * uw + uri;
  if (strided_fits32(q, hh, ww, sh, sw, sri, gh, gw) && uext < 2 * SIZE32) {
    Bwd2Strided<int> b;
    b.s = strided_args<int>(h, q, ww, sn, so, sc, sh, sw, sri, b2, 0.f);
    b.s.g = static_cast<const float*>(g);
    b.s.gs = Strides3{gn, go, gc};
    b.s.gh = (int)gh;
    b.s.gw = (int)gw;
    b.u = static_cast<const float*>(u);
    b.us = Strides3{un, uo, uc};
    b.uc = uc;
    b.uh = (int)uh;
    b.uw = (int)uw;
    b.uri = (int)uri;
    mag_bwd2_strided<int><<<grid_of(b.s.nb), MAG_THREADS, 0, st>>>(b, dgo,
                                                                    out);
  } else {
    Bwd2Strided<long long> b;
    b.s = strided_args<long long>(h, q, ww, sn, so, sc, sh, sw, sri, b2,
                                  0.f);
    b.s.g = static_cast<const float*>(g);
    b.s.gs = Strides3{gn, go, gc};
    b.s.gh = gh;
    b.s.gw = gw;
    b.u = static_cast<const float*>(u);
    b.us = Strides3{un, uo, uc};
    b.uc = uc;
    b.uh = uh;
    b.uw = uw;
    b.uri = uri;
    mag_bwd2_strided<long long><<<grid_of(b.s.nb), MAG_THREADS, 0, st>>>(
        b, dgo, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
