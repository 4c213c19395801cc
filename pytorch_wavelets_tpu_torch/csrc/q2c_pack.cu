// K2 q2c_pack: the forward's quad -> complex butterfly, written straight
// into the final bandpass tensor.
//
// Replaces pytorch_wavelets_tpu/ops/fused_dtcwt.py:_q2c_epilogue (l.126)
// and the jnp.stacks around it (fused_dtcwt.py:126-136 and
// transforms/dtcwt.py:763), and, per level, ops/dtcwt_fb.py:q2c (l.294)
// with the stacks of transforms/dtcwt.py:highs_to_orientations (l.169).
// Input: one subband group's filtered planes y; member t's corners at
// (i, j) are read at
//   y + n*syn + c*syc + t*smem + i*si + j*sj + {oa, ob, oc, od}
// for a, b, c, d: the composed path's stage-2 output holds them as row and
// column blocks (a = [t*2m + i, j], b = [t*2m + i, k + j],
// c = [t*2m + m + i, j], d = [t*2m + m + i, k + j], its column operators
// carrying the 1/sqrt2, scale 1); the per-level path as the interleaved
// corners y[2i, 2j], y[2i, 2j+1], y[2i+1, 2j], y[2i+1, 2j+1] of each
// member's (2m, 2k) plane, scale 1/sqrt2.  With a' = a * scale, ...,
// member t with orientations (o1, o2) writes
//   out[o1] = (a' - d', b' + c'),   out[o2] = (a' + d', b' - c')   as (re, im)
// through the output's strides for (n, c, orientation, h, w, re/im), so
// any o_dim/ri_dim layout is filled in one pass with no stacking copies.
// The rounded intrinsics keep the compiler from fusing the scale into the
// sums, so the result is bit-equal to the plain versions' on the card,
// where PyTorch divides by sqrt2 as a multiplication by fp32(1/sqrt2)
// (scale 1 leaves the composed path's values as they were).
//
// bf16 (y and out bf16): the same arithmetic in fp32 on the loaded
// values, each output rounded once to bf16 as it is stored (elem.cuh).
//
// Bound: bytes (each corner read once, each (re, im) written once, 2 or 4
// bytes a value) against one add or subtract a value (and per level a
// scaling per read).  Two instantiations; the C entry picks one and
// returns it to the wrapper (ops/quad.py counts it):
//
// - `vector`: the bands in the default layout (re/im adjacent, sri = 1;
//   w pairs adjacent, sw = 2) and corners along j at unit stride (the
//   composed path's contiguous rows, sj = 1) or interleaved in pairs (the
//   per-level path's, sj = 2, b = a + 1, d = c + 1).  The grid is
//   (plane, member) x chunks of the member's m x S slots; a block splits
//   its (plane, member) into (n, c, t) once and holds the 64-bit bases,
//   offsets within a plane are 32-bit.  A slot is V = 16 / (2 * size) j
//   (2 on fp32, 4 on bf16): one 16-byte store of each orientation's
//   (re, im) for V j.  Slots are anchored on o1's 16-byte lines, so a row
//   that starts past a line (odd k, an offset view) has a first and a
//   last slot that are partial: their j are taken one at a time, an
//   (re, im) pair a store.  A full slot loads each corner as one 8-byte
//   run of V values (composed) or a, b (and c, d) as one 16-byte run of
//   2V interleaved values (per level), and stores o2 as one 16-byte
//   store, each where its address is aligned, else value by value.
//   Q_SLOTS slots a thread, Q_THREADS apart, all loaded before any is
//   stored; (i, slot) by one 32-bit division by S.  The slot plan and
//   the wide accesses are K3's too (quad_slots.cuh).
// - `strided`: every other view (any o_dim / ri_dim layout): Q_STEPS
//   values a thread, (i, j) by one division by k, 32-bit offsets within a
//   plane where the extents fit, 64-bit past that.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "quad_slots.cuh"

namespace {

struct QArgs {
  int C, m, k, nm, orients;
  long long syn, syc, smem;      // y's plane and member strides
  long long si, sj, oa, ob, oc, od;
  float scale;
  long long sn, sc, so;          // out's plane and orientation strides
  long long sh, sw, sri;
  int S;                         // vector: slots a row
  long long cpp;                 // chunks a (plane, member)
  long long nb;                  // blocks: planes * nm * cpp
};

// ---------------------------------------------------------------------------
// vector
// ---------------------------------------------------------------------------

template <typename E, bool IL>
__global__ void __launch_bounds__(Q_THREADS)
    q2c_vector(const E* __restrict__ y, E* __restrict__ out, QArgs a) {
  constexpr int V = Vec<E>::V;
  const int si = (int)a.si, ob = (int)a.ob, oc = (int)a.oc, od = (int)a.od;
  const int sh = (int)a.sh, k = a.k, S = a.S;
  const int slots = a.m * S;
  for (int blk = blockIdx.x; blk < (int)a.nb; blk += gridDim.x) {
    const int pm = blk / (int)a.cpp, chunk = blk - pm * (int)a.cpp;
    const int p = pm / a.nm, t = pm - p * a.nm;
    const int n = p / a.C, c = p - n * a.C;
    const E* yb = y + n * a.syn + c * a.syc + t * a.smem;
    const int o1 = (a.orients >> (8 * t)) & 0xF;
    const int o2 = (a.orients >> (8 * t + 4)) & 0xF;
    E* out1 = out + n * a.sn + c * a.sc + o1 * a.so;
    E* out2 = out + n * a.sn + c * a.sc + o2 * a.so;
    float av[Q_SLOTS][V], bv[Q_SLOTS][V], cv[Q_SLOTS][V], dv[Q_SLOTS][V];
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
      // slots are anchored on o1's 16-byte lines: h j lie before the row
      const int h = line_head(out1 + i * sh);
      row[u] = i;
      j0[u] = s * V - h;
      full[u] = j0[u] >= 0 && j0[u] + V <= k;
      if (!full[u]) continue;
      const E* ya = yb + i * si + (IL ? 2 * j0[u] : j0[u]);
      if (IL) {
        load_pairs(ya, av[u], bv[u]);
        load_pairs(ya + oc, cv[u], dv[u]);
      } else {
        load_run(ya, av[u]);
        load_run(ya + ob, bv[u]);
        load_run(ya + oc, cv[u]);
        load_run(ya + od, dv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < Q_SLOTS; ++u) {
      if (row[u] < 0) continue;
      const int i = row[u];
      E* r1 = out1 + i * sh;
      E* r2 = out2 + i * sh;
      if (full[u]) {
        float re1[V], im1[V], re2[V], im2[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float A = __fmul_rn(av[u][v], a.scale);
          const float B = __fmul_rn(bv[u][v], a.scale);
          const float Cc = __fmul_rn(cv[u][v], a.scale);
          const float D = __fmul_rn(dv[u][v], a.scale);
          re1[v] = __fsub_rn(A, D);
          im1[v] = __fadd_rn(B, Cc);
          re2[v] = __fadd_rn(A, D);
          im2[v] = __fsub_rn(B, Cc);
        }
        Vec<E>::store(r1 + 2 * j0[u], re1, im1);   // aligned by the anchor
        store_cplx(r2 + 2 * j0[u], re2, im2);
      } else {   // a row's partial first or last slot, one j at a time
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int j = j0[u] + v;
          if (j < 0 || j >= k) continue;
          const E* yj = yb + i * si + (IL ? 2 * j : j);
          const float A = __fmul_rn(to_float(yj[0]), a.scale);
          const float B = __fmul_rn(to_float(yj[ob]), a.scale);
          const float Cc = __fmul_rn(to_float(yj[oc]), a.scale);
          const float D = __fmul_rn(to_float(yj[od]), a.scale);
          Vec<E>::store1(r1 + 2 * j, __fsub_rn(A, D), __fadd_rn(B, Cc));
          Vec<E>::store1(r2 + 2 * j, __fadd_rn(A, D), __fsub_rn(B, Cc));
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
    q2c_strided(const E* __restrict__ y, E* __restrict__ out, QArgs a) {
  const I per = (I)Q_THREADS * Q_STEPS, mk = (I)a.m * a.k;
  for (long long blk = blockIdx.x; blk < a.nb; blk += gridDim.x) {
    const long long pm = blk / a.cpp;
    const I chunk = (I)(blk - pm * a.cpp);
    const long long p = pm / a.nm;
    const int t = (int)(pm - p * a.nm);
    const long long n = p / a.C;
    const int c = (int)(p - n * a.C);
    const E* yb = y + n * a.syn + c * a.syc + t * a.smem;
    const int o1 = (a.orients >> (8 * t)) & 0xF;
    const int o2 = (a.orients >> (8 * t + 4)) & 0xF;
    E* ob1 = out + n * a.sn + c * a.sc + o1 * a.so;
    E* ob2 = out + n * a.sn + c * a.sc + o2 * a.so;
#pragma unroll
    for (int u = 0; u < Q_STEPS; ++u) {
      const I e = chunk * per + (I)u * Q_THREADS + (I)threadIdx.x;
      if (e >= mk) break;
      const I i = e / a.k, j = e - i * a.k;
      const E* yp = yb + (i * (I)a.si + j * (I)a.sj);
      const float A = __fmul_rn(to_float(yp[(I)a.oa]), a.scale);
      const float B = __fmul_rn(to_float(yp[(I)a.ob]), a.scale);
      const float Cc = __fmul_rn(to_float(yp[(I)a.oc]), a.scale);
      const float D = __fmul_rn(to_float(yp[(I)a.od]), a.scale);
      const I off = i * (I)a.sh + j * (I)a.sw;
      ob1[off] = from_float<E>(__fsub_rn(A, D));
      ob1[off + (I)a.sri] = from_float<E>(__fadd_rn(B, Cc));
      ob2[off] = from_float<E>(__fadd_rn(A, D));
      ob2[off + (I)a.sri] = from_float<E>(__fsub_rn(B, Cc));
    }
  }
}

// The vector instantiation's slots and grid (a.S, a.cpp, a.nb) where the
// layout takes it and a plane's offsets fit in 32 bits; else false.
template <typename E>
bool vector_plan(const void* out, long long planes, bool il, QArgs& a) {
  const int V = Vec<E>::V;
  const long long esz = sizeof(E);
  // the layout: the bands' pairs (quad_slots.cuh), corners along j at
  // unit stride or interleaved
  bool ok = pair_layout(out, a.sn, a.sc, a.so, a.sh, a.sw, a.sri, esz) &&
            a.oa == 0 && (a.sj == 1 || il);
  // 32-bit within a plane
  const long long yext = (a.m + 1) * abs_ll(a.si) + 2LL * a.k +
                         abs_ll(a.ob) + abs_ll(a.oc) + abs_ll(a.od);
  ok = ok && yext < SIZE32 && (a.m + 1) * abs_ll(a.sh) + 2LL * a.k < SIZE32;
  a.S = slots_a_row(out, a.sn, a.sc, a.so, a.sh, esz, V, V, a.k);
  const long long per = (long long)Q_THREADS * Q_SLOTS;
  a.cpp = ((long long)a.m * a.S + per - 1) / per;
  a.nb = planes * a.nm * a.cpp;
  return ok && (long long)a.m * a.S < SIZE32 && a.nb < SIZE32;
}

template <typename E>
int launch(const void* y, void* out, long long planes, QArgs& a, int* inst,
           cudaStream_t st) {
  const E* yp = static_cast<const E*>(y);
  E* op = static_cast<E*>(out);
  const bool il = a.sj == 2 && a.ob == 1 && a.od == a.oc + 1;
  if (vector_plan<E>(out, planes, il, a)) {
    *inst = Q_VECTOR;
    if (il)
      q2c_vector<E, true><<<grid_of(a.nb), Q_THREADS, 0, st>>>(yp, op, a);
    else
      q2c_vector<E, false><<<grid_of(a.nb), Q_THREADS, 0, st>>>(yp, op, a);
    return static_cast<int>(cudaGetLastError());
  }
  *inst = Q_STRIDED;
  const long long per = (long long)Q_THREADS * Q_STEPS;
  const long long mk = (long long)a.m * a.k;
  a.cpp = (mk + per - 1) / per;
  a.nb = planes * a.nm * a.cpp;
  const long long yext = (a.m - 1) * abs_ll(a.si) + (a.k - 1) * abs_ll(a.sj) +
                         abs_ll(a.oa) + abs_ll(a.ob) + abs_ll(a.oc) +
                         abs_ll(a.od);
  const long long oext = (a.m - 1) * abs_ll(a.sh) +
                         (a.k - 1) * abs_ll(a.sw) + abs_ll(a.sri);
  if (mk + per < SIZE32 / 2 && yext < SIZE32 / 2 && oext < SIZE32 / 2)
    q2c_strided<E, int><<<grid_of(a.nb), Q_THREADS, 0, st>>>(yp, op, a);
  else
    q2c_strided<E, long long><<<grid_of(a.nb), Q_THREADS, 0, st>>>(yp, op, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// planes = N*C; members packed as orients |= (o1 | o2 << 4) << (8 * t);
// the input's addressing as in the header; bf16: y and out are bf16;
// inst: set to the instantiation launched, 0 vector, 1 strided
// (ops/quad.py:Q2C_INSTS).
int q2c_pack(const void* y, void* out, long long planes, int C, int m,
             int k, int nm, int orients, long long syn, long long syc,
             long long smem, long long si, long long sj, long long oa,
             long long ob, long long oc, long long od, float scale,
             long long sn, long long sc, long long so, long long sh,
             long long sw, long long sri, int bf16, int* inst, void* stream) {
  if (planes * nm * m * k == 0) return 0;
  QArgs a{C,  m,  k,  nm, orients, syn, syc, smem, si, sj, oa, ob, oc, od,
          scale, sn, sc, so, sh, sw, sri, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(y, out, planes, a, inst, st)
              : launch<float>(y, out, planes, a, inst, st);
}

}  // extern "C"
