// K3 c2q_unpack: the inverse's complex -> quad combine, read straight out
// of the bandpass tensor.
//
// Replaces the combine and concatenations of
// pytorch_wavelets_tpu/ops/fused_dtcwt.py:synthesis_pyramid (l.290-306),
// and, per level, ops/dtcwt_fb.py:c2q (l.304) with the moveaxis of
// transforms/dtcwt.py:orientations_to_highs (l.183).  Input: one level's
// bandpass tensor, read through its strides for (n, c, orientation, h, w,
// re/im), so any o_dim/ri_dim layout is taken in place.  For member t of a
// subband group, with orientations (o1, o2) holding w1 = (w1r, w1i) and
// w2 = (w2r, w2i), it writes
//   x1 = (w1r + w2r) * scale     x2 = (w1i + w2i) * scale
//   x3 = (w1i - w2i) * scale     x4 = (w2r - w1r) * scale
// at xq + p*sxp + t*sxm + i*sxi + j*sxj + {x1o, x2o, x3o, x4o} of the
// contiguous output: the composed path's quadrant planes (planes,
// nm*2h, 2w), x1 at [t*2h + i, j], x2 at [t*2h + i, w + j], x3 at
// [t*2h + h + i, j], x4 at [t*2h + h + i, w + j] (the row operators
// carrying the 1/sqrt2, scale 1), or the per-level path's interleaved
// (planes, nm, 2h, 2w) images, x1..x4 at [2i, 2j], [2i, 2j+1], [2i+1, 2j],
// [2i+1, 2j+1] (scale 1/sqrt2).  The rounded intrinsics fix the order of
// the operations, so the result is bit-equal to the plain versions' on
// the card, where PyTorch divides by sqrt2 as a multiplication by
// fp32(1/sqrt2).
//
// bf16 (bands and output bf16): the same arithmetic in fp32 on the
// loaded values, each output rounded once to bf16 as it is stored
// (elem.cuh).
//
// Bound: bytes (each (re, im) read once, each quadrant value written
// once, 2 or 4 bytes a value) against one add or subtract a value and a
// scaling.  K2's mirror: two instantiations, the C entry picks one and
// returns it to the wrapper (ops/quad.py counts it):
//
// - `vector`: the bands in the default layout (re/im adjacent, sri = 1;
//   w pairs adjacent, sw = 2) and the output composed (sxj = 1) or
//   interleaved (sxj = 2, x2o = 1, x4o = x3o + 1).  The grid is
//   (plane, member) x chunks of the member's h x S slots; a block splits
//   its (plane, member) into (n, c, t) once and holds the 64-bit bases,
//   offsets within a plane are 32-bit.  A slot is L lines of V = 16 /
//   (2 * size) j each (V = 2 on fp32, 4 on bf16), anchored on o1's
//   16-byte lines (K2's slot plan, quad_slots.cuh): each line of each
//   orientation is one 16-byte load of V (re, im), o2's where it is
//   aligned, else a value at a time.  Per level (L = 1), (x1, x2) for the
//   V j are one 16-byte store of 2V values on row 2i and (x3, x4) one on
//   row 2i+1; composed (L = 2), each of x1..x4 is one 16-byte run of 2V
//   values (a slot of one line, 8-byte runs, ties on fp32 and runs 6%
//   slower on bf16: PERF.md section 6); each store where its address is
//   aligned, else smaller.  A row that starts past a line (odd w, an
//   offset view) has a first and a last slot that are partial: their j
//   are taken one at a time.
//   Q_SLOTS slots a thread, Q_THREADS apart, all loaded before any is
//   stored; (i, slot) by one 32-bit division by S.
// - `strided`: every other view (any o_dim / ri_dim layout): Q_STEPS
//   values a thread, (i, j) by one division by w, 32-bit offsets within a
//   plane where the extents fit, 64-bit past that.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "quad_slots.cuh"

namespace {

struct UArgs {
  int C, h, w, nm, orients;
  long long sn, sc, so;          // the bands' plane and orientation strides
  long long sh, sw, sri;
  long long sxp, sxm, sxi, sxj;  // the output's
  long long x1o, x2o, x3o, x4o;
  float scale;
  int S;                         // vector: slots a row
  long long cpp;                 // chunks a (plane, member)
  long long nb;                  // blocks: planes * nm * cpp
};

// x1..x4 of one j from (w1r, w1i, w2r, w2i), in today's order
struct Quad {
  float x1, x2, x3, x4;
};

__device__ __forceinline__ Quad combine(float w1r, float w1i, float w2r,
                                        float w2i, float scale) {
  return {__fmul_rn(__fadd_rn(w1r, w2r), scale),
          __fmul_rn(__fadd_rn(w1i, w2i), scale),
          __fmul_rn(__fsub_rn(w1i, w2i), scale),
          __fmul_rn(__fsub_rn(w2r, w1r), scale)};
}

// ---------------------------------------------------------------------------
// vector
// ---------------------------------------------------------------------------

template <typename E, bool IL>
__global__ void __launch_bounds__(Q_THREADS)
    c2q_vector(const E* __restrict__ hb, E* __restrict__ xq, UArgs a) {
  constexpr int V = Vec<E>::V;
  constexpr int L = IL ? 1 : 2;  // 16-byte lines a slot
  constexpr int J = L * V;       // j a slot
  constexpr int SXJ = IL ? 2 : 1;
  const int sh = (int)a.sh, sxi = (int)a.sxi, w = a.w, S = a.S;
  const int x2o = (int)a.x2o, x3o = (int)a.x3o, x4o = (int)a.x4o;
  const int slots = a.h * S;
  for (int blk = blockIdx.x; blk < (int)a.nb; blk += gridDim.x) {
    const int pm = blk / (int)a.cpp, chunk = blk - pm * (int)a.cpp;
    const int p = pm / a.nm, t = pm - p * a.nm;
    const int n = p / a.C, c = p - n * a.C;
    const int o1 = (a.orients >> (8 * t)) & 0xF;
    const int o2 = (a.orients >> (8 * t + 4)) & 0xF;
    const E* b1 = hb + n * a.sn + c * a.sc + o1 * a.so;
    const E* b2 = hb + n * a.sn + c * a.sc + o2 * a.so;
    E* xb = xq + p * a.sxp + t * a.sxm;
    // (re, im) of o1 and o2 for each slot's L lines of V j
    float r1[Q_SLOTS][L][V], i1[Q_SLOTS][L][V];
    float r2[Q_SLOTS][L][V], i2[Q_SLOTS][L][V];
    int row[Q_SLOTS], j0[Q_SLOTS];
    bool full[Q_SLOTS];
#pragma unroll
    for (int u = 0; u < Q_SLOTS; ++u) {
      const int e = chunk * (Q_THREADS * Q_SLOTS) + u * Q_THREADS +
                    threadIdx.x;
      full[u] = false;
      row[u] = -1;
      if (e >= slots) continue;
      const int i = e / S, s = e - i * S;
      // slots are anchored on o1's 16-byte lines
      row[u] = i;
      j0[u] = s * J - line_head(b1 + i * sh);
      full[u] = j0[u] >= 0 && j0[u] + J <= w;
      if (!full[u]) continue;
      const E* q1 = b1 + i * sh + 2 * j0[u];
      const E* q2 = b2 + i * sh + 2 * j0[u];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        Vec<E>::pairs(q1 + 2 * V * l, r1[u][l], i1[u][l]);  // on a line
        load_pairs(q2 + 2 * V * l, r2[u][l], i2[u][l]);
      }
    }
#pragma unroll
    for (int u = 0; u < Q_SLOTS; ++u) {
      if (row[u] < 0) continue;
      const int i = row[u];
      E* xr = xb + i * sxi;
      if (full[u]) {
        float x1[L][V], x2[L][V], x3[L][V], x4[L][V];
#pragma unroll
        for (int l = 0; l < L; ++l) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const Quad q = combine(r1[u][l][v], i1[u][l][v], r2[u][l][v],
                                   i2[u][l][v], a.scale);
            x1[l][v] = q.x1;
            x2[l][v] = q.x2;
            x3[l][v] = q.x3;
            x4[l][v] = q.x4;
          }
        }
        if (IL) {   // (x1, x2) along row 2i, (x3, x4) along row 2i + 1
#pragma unroll
          for (int l = 0; l < L; ++l) {
            E* xl = xr + 2 * (j0[u] + l * V);
            store_cplx(xl, x1[l], x2[l]);
            store_cplx(xl + x3o, x3[l], x4[l]);
          }
        } else {    // x1..x4 as runs of 2V
          store_run2(xr + j0[u], x1[0], x1[L - 1]);
          store_run2(xr + x2o + j0[u], x2[0], x2[L - 1]);
          store_run2(xr + x3o + j0[u], x3[0], x3[L - 1]);
          store_run2(xr + x4o + j0[u], x4[0], x4[L - 1]);
        }
      } else {   // a row's partial first or last slot, one j at a time
#pragma unroll
        for (int v = 0; v < J; ++v) {
          const int j = j0[u] + v;
          if (j < 0 || j >= w) continue;
          const E* q1 = b1 + i * sh + 2 * j;
          const E* q2 = b2 + i * sh + 2 * j;
          const Quad q = combine(to_float(q1[0]), to_float(q1[1]),
                                 to_float(q2[0]), to_float(q2[1]), a.scale);
          E* xj = xr + j * SXJ;
          xj[0] = from_float<E>(q.x1);
          xj[x2o] = from_float<E>(q.x2);
          xj[x3o] = from_float<E>(q.x3);
          xj[x4o] = from_float<E>(q.x4);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// strided
// ---------------------------------------------------------------------------

template <typename E, typename I>
__global__ void __launch_bounds__(Q_THREADS)
    c2q_strided(const E* __restrict__ hb, E* __restrict__ xq, UArgs a) {
  const I per = (I)Q_THREADS * Q_STEPS, hw = (I)a.h * a.w;
  for (long long blk = blockIdx.x; blk < a.nb; blk += gridDim.x) {
    const long long pm = blk / a.cpp;
    const I chunk = (I)(blk - pm * a.cpp);
    const long long p = pm / a.nm;
    const int t = (int)(pm - p * a.nm);
    const long long n = p / a.C;
    const int c = (int)(p - n * a.C);
    const int o1 = (a.orients >> (8 * t)) & 0xF;
    const int o2 = (a.orients >> (8 * t + 4)) & 0xF;
    const E* b1 = hb + n * a.sn + c * a.sc + o1 * a.so;
    const E* b2 = hb + n * a.sn + c * a.sc + o2 * a.so;
    E* xb = xq + p * a.sxp + t * a.sxm;
#pragma unroll
    for (int u = 0; u < Q_STEPS; ++u) {
      const I e = chunk * per + (I)u * Q_THREADS + (I)threadIdx.x;
      if (e >= hw) break;
      const I i = e / a.w, j = e - i * a.w;
      const I off = i * (I)a.sh + j * (I)a.sw;
      const Quad q = combine(to_float(b1[off]), to_float(b1[off + (I)a.sri]),
                             to_float(b2[off]), to_float(b2[off + (I)a.sri]),
                             a.scale);
      E* xj = xb + (i * (I)a.sxi + j * (I)a.sxj);
      xj[(I)a.x1o] = from_float<E>(q.x1);
      xj[(I)a.x2o] = from_float<E>(q.x2);
      xj[(I)a.x3o] = from_float<E>(q.x3);
      xj[(I)a.x4o] = from_float<E>(q.x4);
    }
  }
}

// The vector instantiation's slots and grid (a.S, a.cpp, a.nb) where the
// layout takes it and a plane's offsets fit in 32 bits; else false.
template <typename E>
bool vector_plan(const void* hb, const void* xq, long long planes, bool il,
                 UArgs& a) {
  const int V = Vec<E>::V;
  const long long esz = sizeof(E);
  bool ok = pair_layout(hb, a.sn, a.sc, a.so, a.sh, a.sw, a.sri, esz) &&
            a.x1o == 0 && (a.sxj == 1 || il);
  // per level, the output's (x1, x2) and (x3, x4) on whole pairs
  if (il) {
    ok = ok && reinterpret_cast<uintptr_t>(xq) % (2 * esz) == 0;
    for (long long s : {a.sxp, a.sxm, a.sxi, a.x3o}) ok = ok && s % 2 == 0;
  }
  // 32-bit within a plane
  const long long xext = (a.h + 1) * abs_ll(a.sxi) + 2LL * a.w +
                         abs_ll(a.x2o) + abs_ll(a.x3o) + abs_ll(a.x4o);
  ok = ok && xext < SIZE32 && (a.h + 1) * abs_ll(a.sh) + 2LL * a.w < SIZE32;
  a.S = slots_a_row(hb, a.sn, a.sc, a.so, a.sh, esz, V, (il ? 1 : 2) * V,
                    a.w);
  const long long per = (long long)Q_THREADS * Q_SLOTS;
  a.cpp = ((long long)a.h * a.S + per - 1) / per;
  a.nb = planes * a.nm * a.cpp;
  return ok && (long long)a.h * a.S < SIZE32 && a.nb < SIZE32;
}

template <typename E>
int launch(const void* hb, void* xq, long long planes, UArgs& a, int* inst,
           cudaStream_t st) {
  const E* hp = static_cast<const E*>(hb);
  E* xp = static_cast<E*>(xq);
  const bool il = a.sxj == 2 && a.x2o == 1 && a.x4o == a.x3o + 1;
  if (vector_plan<E>(hb, xq, planes, il, a)) {
    *inst = Q_VECTOR;
    if (il)
      c2q_vector<E, true><<<grid_of(a.nb), Q_THREADS, 0, st>>>(hp, xp, a);
    else
      c2q_vector<E, false><<<grid_of(a.nb), Q_THREADS, 0, st>>>(hp, xp, a);
    return static_cast<int>(cudaGetLastError());
  }
  *inst = Q_STRIDED;
  const long long per = (long long)Q_THREADS * Q_STEPS;
  const long long hw = (long long)a.h * a.w;
  a.cpp = (hw + per - 1) / per;
  a.nb = planes * a.nm * a.cpp;
  const long long bext = (a.h - 1) * abs_ll(a.sh) + (a.w - 1) * abs_ll(a.sw) +
                         abs_ll(a.sri);
  const long long xext = (a.h - 1) * abs_ll(a.sxi) +
                         (a.w - 1) * abs_ll(a.sxj) + abs_ll(a.x1o) +
                         abs_ll(a.x2o) + abs_ll(a.x3o) + abs_ll(a.x4o);
  if (hw + per < SIZE32 / 2 && bext < SIZE32 / 2 && xext < SIZE32 / 2)
    c2q_strided<E, int><<<grid_of(a.nb), Q_THREADS, 0, st>>>(hp, xp, a);
  else
    c2q_strided<E, long long><<<grid_of(a.nb), Q_THREADS, 0, st>>>(hp, xp,
                                                                    a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// planes = N*C; members packed as orients |= (o1 | o2 << 4) << (8 * t);
// the output's addressing as in the header; bf16: bands and output bf16;
// inst: set to the instantiation launched, 0 vector, 1 strided
// (ops/quad.py:Q2C_INSTS).
int c2q_unpack(const void* hb, void* xq, long long planes, int C, int h,
               int w, int nm, int orients, long long sn, long long sc,
               long long so, long long sh, long long sw, long long sri,
               long long sxp, long long sxm, long long sxi, long long sxj,
               long long x1o, long long x2o, long long x3o, long long x4o,
               float scale, int bf16, int* inst, void* stream) {
  if (planes * nm * h * w == 0) return 0;
  UArgs a{C,   h,   w,   nm,  orients, sn,  sc,  so,    sh, sw, sri,
          sxp, sxm, sxi, sxj, x1o,     x2o, x3o, x4o, scale, 0,  0,  0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(hb, xq, planes, a, inst, st)
              : launch<float>(hb, xq, planes, a, inst, st);
}

}  // extern "C"
