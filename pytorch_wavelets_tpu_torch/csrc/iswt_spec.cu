// K13 iswt_spec: the spectral body of the inverse SWT's least-squares merge
// of a circular two-band split, and its adjoint.
//
// Replaces the frequency-domain product of
// pytorch_wavelets_tpu/transforms/dwt.py:_fft_ls_merge (l.394; its filters
// from _iswt_fft_filters l.385), the FFT branch of _ls_merge (l.345) for
// circular modes on axes past _ISWT_PINV_MAX_N.  The FFTs stay cuFFT
// (torch.fft), as the JAX package leaves them to XLA.  On complex64
// spectra of an (N, C, H, W)-shaped tensor, along axis 2 (H) or 3 (W),
// with the filters indexed by the frequency f along that axis:
//
//   spec_merge:  Z[f] = G0[f] A[f] + G1[f] B[f]
//   spec_split:  A'[f] = conj(G0[f]) Z'[f],  B'[f] = conj(G1[f]) Z'[f]
//                (the merge's transpose: the filters of real taps are
//                Hermitian, so each band's circulant transposes to the
//                conjugate spectrum)
//
// Each value's products and sums are the fmaf chain of the plain version's
// order (ops/iswt_merge.py), the same in every walk.
//
// Bound: bytes, 24 per value (two spectra read and one written, or one
// read and two written) against 14 (merge) or 12 (split) FLOP.  The
// filters, 16 bytes a frequency, are read from L1/L2.  Two walks; the C
// entries pick one and return it to the wrapper (ops/iswt_merge.py counts
// it):
//
// - `stream`: every spectrum, the outputs too, has stride 1 along one axis
//   u (2 or 3), the axis torch.fft.rfft leaves innermost (its frequency
//   axis; the wrapper writes its outputs in the inputs' layout), and the
//   rows and blocks fit in 32 bits.  A row is the L values along u of one
//   (n, c, other-axis index); the grid is row groups x chunks, a row
//   taking TPR threads (a power of two, 32-256, sized to the row: rows per
//   block = 256 / TPR), each thread SPEC_PAIRS pairs of values TPR apart,
//   a pair one float4 of each spectrum.  Each thread resolves its row's
//   64-bit bases once; offsets within a row are 32-bit.  Rows of an rfft
//   spectrum are n/2 + 1 values long, odd for even n, so every other row
//   starts 8 bytes past a 16-byte line: the pairs follow the first input's
//   row alignment (a row starting 8 bytes in takes its first value alone,
//   the head; an odd count left takes its last alone, the tail; both by
//   lane 0 of the row's first chunk).  A pair of
//   the other spectra, or of the filters (when u is the filters' axis they
//   vary along the row: a pair starting at an odd frequency), not 16-byte
//   aligned takes two float2s instead.  When u is not the filters' axis
//   each row has one filter pair, held in registers.
// - `strided`: any other view (no shared unit-stride axis: a broadcast
//   input, a mixed layout): planes x chunks, SPEC_STEPS values a thread,
//   SPEC_THREADS apart, (i, j) by one division by W; 32-bit within a plane
//   where every spectrum's plane extent fits, 64-bit past that (planes of
//   2^30 values and more).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SPEC_THREADS = 256;   // a block (every walk)
constexpr int SPEC_PAIRS = 2;       // stream: float4 pairs a thread
constexpr int SPEC_STEPS = 4;       // strided: values a thread
constexpr long long SIZE32 = 1LL << 31;

enum SpecWalk { S_STREAM = 0, S_STRIDED = 1 };

struct Spectra {
  const float2* in0;
  const float2* in1;   // merge: B; split: unused
  float2* out0;
  float2* out1;        // split: B'; merge: unused
  const float2* g0;
  const float2* g1;
  long long s[4][4];   // strides of in0, in1, out0, out1 (N, C, H, W)
};

// G0 z + G1 b, in the plain version's order
__device__ __forceinline__ float2 merge1(float2 g0, float2 g1, float2 z,
                                         float2 b) {
  float2 u;
  u.x = fmaf(g0.x, z.x, -g0.y * z.y);
  u.x = fmaf(g1.x, b.x, u.x);
  u.x = fmaf(-g1.y, b.y, u.x);
  u.y = fmaf(g0.x, z.y, g0.y * z.x);
  u.y = fmaf(g1.x, b.y, u.y);
  u.y = fmaf(g1.y, b.x, u.y);
  return u;
}

// conj(g) z
__device__ __forceinline__ float2 conj_mul(float2 g, float2 z) {
  float2 u;
  u.x = fmaf(g.x, z.x, g.y * z.y);
  u.y = fmaf(g.x, z.y, -g.y * z.x);
  return u;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// values p[0], p[1]: one float4 where p is 16-byte aligned, else two float2s
__device__ __forceinline__ void load2(const float2* p, float2& v0,
                                      float2& v1) {
  if (aligned16(p)) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v0 = make_float2(q.x, q.y);
    v1 = make_float2(q.z, q.w);
  } else {
    v0 = __ldg(p);
    v1 = __ldg(p + 1);
  }
}

__device__ __forceinline__ void store2(float2* p, float2 v0, float2 v1) {
  if (aligned16(p)) {
    *reinterpret_cast<float4*>(p) = make_float4(v0.x, v0.y, v1.x, v1.y);
  } else {
    p[0] = v0;
    p[1] = v1;
  }
}

// ---------------------------------------------------------------------------
// stream: rows along the unit-stride axis u
// ---------------------------------------------------------------------------

struct StreamArgs {
  Spectra sp;
  int C, R;            // channels; rows a plane (the other axis' length)
  int L;               // values a row
  int rows;            // N * C * R
  int tpr_log2;        // threads a row: 1 << tpr_log2
  int cpr;             // chunks a row
  int nb;              // blocks: row groups x cpr
  int uo;              // the strides' index of the other axis (2 or 3)
};

__device__ __forceinline__ long long row_off(const long long* s, int n,
                                             int c, int r, int uo) {
  return (long long)n * s[0] + (long long)c * s[1] + (long long)r * s[uo];
}

// One value f of a row alone (the head or the tail).
template <bool SPLIT, bool FREQ>
__device__ __forceinline__ void stream_one(const float2* A, const float2* B,
                                           float2* Z0, float2* Z1,
                                           const StreamArgs& a, int f,
                                           float2 g0r, float2 g1r) {
  const float2 g0 = FREQ ? __ldg(a.sp.g0 + f) : g0r;
  const float2 g1 = FREQ ? __ldg(a.sp.g1 + f) : g1r;
  const float2 z = __ldg(A + f);
  if (SPLIT) {
    Z0[f] = conj_mul(g0, z);
    Z1[f] = conj_mul(g1, z);
  } else {
    Z0[f] = merge1(g0, g1, z, __ldg(B + f));
  }
}

template <bool SPLIT, bool FREQ>
__global__ void __launch_bounds__(SPEC_THREADS) spec_stream(StreamArgs a) {
  const int tpr = 1 << a.tpr_log2;
  const int lane = threadIdx.x & (tpr - 1);
  for (int blk = blockIdx.x; blk < a.nb; blk += gridDim.x) {
    const int rg = blk / a.cpr, chunk = blk - rg * a.cpr;
    const int row = (rg << (8 - a.tpr_log2)) + (threadIdx.x >> a.tpr_log2);
    if (row >= a.rows) continue;
    const int t = row / a.R, r = row - t * a.R;
    const int n = t / a.C, c = t - n * a.C;
    const float2* A = a.sp.in0 + row_off(a.sp.s[0], n, c, r, a.uo);
    const float2* B =
        SPLIT ? nullptr : a.sp.in1 + row_off(a.sp.s[1], n, c, r, a.uo);
    float2* Z0 = a.sp.out0 + row_off(a.sp.s[2], n, c, r, a.uo);
    float2* Z1 = SPLIT ? a.sp.out1 + row_off(a.sp.s[3], n, c, r, a.uo)
                       : nullptr;
    // the filter pair of the row (u is not the filters' axis)
    const float2 g0r = FREQ ? make_float2(0.f, 0.f) : __ldg(a.sp.g0 + r);
    const float2 g1r = FREQ ? make_float2(0.f, 0.f) : __ldg(a.sp.g1 + r);
    const int head = aligned16(A) ? 0 : 1;
    const int pairs = (a.L - head) >> 1;
    const int q0 = chunk * (tpr * SPEC_PAIRS) + lane;
    float2 v[SPEC_PAIRS][2], w[SPEC_PAIRS][2];
#pragma unroll
    for (int u = 0; u < SPEC_PAIRS; ++u) {
      const int q = q0 + u * tpr;
      if (q < pairs) {
        const int f = head + 2 * q;
        const float4 z = __ldg(reinterpret_cast<const float4*>(A + f));
        v[u][0] = make_float2(z.x, z.y);
        v[u][1] = make_float2(z.z, z.w);
        if (!SPLIT) load2(B + f, w[u][0], w[u][1]);
      }
    }
#pragma unroll
    for (int u = 0; u < SPEC_PAIRS; ++u) {
      const int q = q0 + u * tpr;
      if (q >= pairs) continue;
      const int f = head + 2 * q;
      float2 g0[2], g1[2];
      if (FREQ) {
        load2(a.sp.g0 + f, g0[0], g0[1]);
        load2(a.sp.g1 + f, g1[0], g1[1]);
      } else {
        g0[0] = g0[1] = g0r;
        g1[0] = g1[1] = g1r;
      }
      if (SPLIT) {
        store2(Z0 + f, conj_mul(g0[0], v[u][0]), conj_mul(g0[1], v[u][1]));
        store2(Z1 + f, conj_mul(g1[0], v[u][0]), conj_mul(g1[1], v[u][1]));
      } else {
        store2(Z0 + f, merge1(g0[0], g1[0], v[u][0], w[u][0]),
               merge1(g0[1], g1[1], v[u][1], w[u][1]));
      }
    }
    if (chunk == 0 && lane == 0) {   // the head and the tail
      if (head) stream_one<SPLIT, FREQ>(A, B, Z0, Z1, a, 0, g0r, g1r);
      if ((a.L - head) & 1)
        stream_one<SPLIT, FREQ>(A, B, Z0, Z1, a, a.L - 1, g0r, g1r);
    }
  }
}

// ---------------------------------------------------------------------------
// strided: any view
// ---------------------------------------------------------------------------

struct StridedArgs {
  Spectra sp;
  int C, H, W, axis;
  long long HW;        // values a plane
  long long cpp;       // chunks a plane
  long long nb;        // planes * cpp
};

template <typename I, bool SPLIT>
__global__ void __launch_bounds__(SPEC_THREADS) spec_strided(StridedArgs a) {
  const I per = (I)SPEC_THREADS * SPEC_STEPS;
  for (long long blk = blockIdx.x; blk < a.nb; blk += gridDim.x) {
    const long long p = blk / a.cpp;
    const I chunk = (I)(blk - p * a.cpp);
    const long long n = p / a.C;
    const int c = (int)(p - n * a.C);
    const float2* bases[4];
    const long long(*s)[4] = a.sp.s;
    const float2* ptr[4] = {a.sp.in0, a.sp.in1, a.sp.out0, a.sp.out1};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      bases[t] = ptr[t] ? ptr[t] + n * s[t][0] + c * s[t][1] : nullptr;
#pragma unroll
    for (int u = 0; u < SPEC_STEPS; ++u) {
      const I idx = chunk * per + (I)u * SPEC_THREADS + (I)threadIdx.x;
      if (idx >= (I)a.HW) break;
      const I i = idx / a.W, j = idx - i * a.W;
      const int f = a.axis == 3 ? (int)j : (int)i;
      const float2 g0 = __ldg(a.sp.g0 + f), g1 = __ldg(a.sp.g1 + f);
      const float2 z = __ldg(bases[0] + (i * (I)s[0][2] + j * (I)s[0][3]));
      float2* z0 = const_cast<float2*>(bases[2]) +
                   (i * (I)s[2][2] + j * (I)s[2][3]);
      if (SPLIT) {
        float2* z1 = const_cast<float2*>(bases[3]) +
                     (i * (I)s[3][2] + j * (I)s[3][3]);
        *z0 = conj_mul(g0, z);
        *z1 = conj_mul(g1, z);
      } else {
        const float2 b =
            __ldg(bases[1] + (i * (I)s[1][2] + j * (I)s[1][3]));
        *z0 = merge1(g0, g1, z, b);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

unsigned grid_of(long long nb) {
  return static_cast<unsigned>(nb < (1LL << 30) ? nb : (1LL << 30));
}

long long abs_ll(long long v) { return v < 0 ? -v : v; }

// The stream walk's threads a row (log2) and chunks a row, for rows of L
// values: the fewest threads, a power of two from 32 to SPEC_THREADS,
// whose SPEC_PAIRS pairs each cover the row's L / 2 pairs.
void stream_plan(int L, int& tpr_log2, int& cpr) {
  const int pairs = L / 2;
  tpr_log2 = 5;
  while ((1 << tpr_log2) < SPEC_THREADS &&
         (1LL << tpr_log2) * SPEC_PAIRS < pairs)
    ++tpr_log2;
  const int per = (1 << tpr_log2) * SPEC_PAIRS;
  cpr = pairs > per ? (pairs + per - 1) / per : 1;
}

// The stream walk's arguments where every spectrum has stride 1 along one
// axis (W first) and the rows and blocks fit in 32 bits; else false.
template <bool SPLIT>
bool stream_args(const Spectra& sp, long long planes, int C, int H, int W,
                 StreamArgs& a) {
  const int used[4] = {1, SPLIT ? 0 : 1, 1, SPLIT ? 1 : 0};
  int u = 0;
  for (int cand = 3; cand >= 2 && !u; --cand) {
    bool unit = true;
    for (int t = 0; t < 4; ++t)
      unit = unit && (!used[t] || sp.s[t][cand] == 1);
    if (unit) u = cand;
  }
  if (!u) return false;
  a.sp = sp;
  a.C = C;
  a.R = u == 3 ? H : W;
  a.L = u == 3 ? W : H;
  a.uo = 5 - u;
  const long long rows = planes * a.R;
  if (rows >= SIZE32) return false;
  a.rows = (int)rows;
  stream_plan(a.L, a.tpr_log2, a.cpr);
  const long long groups = (rows + (SPEC_THREADS >> a.tpr_log2) - 1) >>
                           (8 - a.tpr_log2);
  if (groups * a.cpr >= SIZE32) return false;
  a.nb = (int)(groups * a.cpr);
  return true;
}

template <bool SPLIT>
int launch(Spectra& sp, long long N, int C, int H, int W, int axis,
           int* walk, void* stream) {
  const long long planes = N * C;
  if (planes == 0 || (long long)H * W == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  StreamArgs sa;
  if (stream_args<SPLIT>(sp, planes, C, H, W, sa)) {
    *walk = S_STREAM;
    const unsigned grid = grid_of(sa.nb);
    if (5 - sa.uo == axis)
      spec_stream<SPLIT, true><<<grid, SPEC_THREADS, 0, st>>>(sa);
    else
      spec_stream<SPLIT, false><<<grid, SPEC_THREADS, 0, st>>>(sa);
    return static_cast<int>(cudaGetLastError());
  }
  *walk = S_STRIDED;
  const int used[4] = {1, SPLIT ? 0 : 1, 1, SPLIT ? 1 : 0};
  StridedArgs a;
  a.sp = sp;
  a.C = C;
  a.H = H;
  a.W = W;
  a.axis = axis;
  a.HW = (long long)H * W;
  const long long per = (long long)SPEC_THREADS * SPEC_STEPS;
  a.cpp = (a.HW + per - 1) / per;
  a.nb = planes * a.cpp;
  // 32-bit within a plane where the index and every extent fit
  bool fits = a.HW + per < SIZE32 / 2;
  for (int t = 0; t < 4; ++t)
    if (used[t])
      fits = fits && (H - 1) * abs_ll(sp.s[t][2]) +
                             (W - 1) * abs_ll(sp.s[t][3]) < SIZE32 / 2;
  if (fits)
    spec_strided<int, SPLIT><<<grid_of(a.nb), SPEC_THREADS, 0, st>>>(a);
  else
    spec_strided<long long, SPLIT><<<grid_of(a.nb), SPEC_THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

void set_strides(long long* s, long long s0, long long s1, long long s2,
                 long long s3) {
  s[0] = s0;
  s[1] = s1;
  s[2] = s2;
  s[3] = s3;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// A, B, Z: complex64 (N, C, H, W) at their strides (in complex elements);
// g0, g1: device complex64 vectors indexed by the frequency along axis;
// walk: set to the walk launched, 0 stream, 1 strided
// (ops/iswt_merge.py:SPEC_WALKS).
int spec_merge(const void* A, const void* B, void* Z, const void* g0,
               const void* g1, long long N, int C, int H, int W,
               long long sa0, long long sa1, long long sa2, long long sa3,
               long long sb0, long long sb1, long long sb2, long long sb3,
               long long sz0, long long sz1, long long sz2, long long sz3,
               int axis, int* walk, void* stream) {
  if (axis != 2 && axis != 3) return static_cast<int>(cudaErrorInvalidValue);
  Spectra sp;
  sp.in0 = static_cast<const float2*>(A);
  sp.in1 = static_cast<const float2*>(B);
  sp.out0 = static_cast<float2*>(Z);
  sp.out1 = nullptr;
  sp.g0 = static_cast<const float2*>(g0);
  sp.g1 = static_cast<const float2*>(g1);
  set_strides(sp.s[0], sa0, sa1, sa2, sa3);
  set_strides(sp.s[1], sb0, sb1, sb2, sb3);
  set_strides(sp.s[2], sz0, sz1, sz2, sz3);
  set_strides(sp.s[3], 0, 0, 0, 0);
  return launch<false>(sp, N, C, H, W, axis, walk, stream);
}

// Z: the cotangent spectrum; A, B: the two band spectra written.
int spec_split(const void* Z, void* A, void* B, const void* g0,
               const void* g1, long long N, int C, int H, int W,
               long long sz0, long long sz1, long long sz2, long long sz3,
               long long sa0, long long sa1, long long sa2, long long sa3,
               long long sb0, long long sb1, long long sb2, long long sb3,
               int axis, int* walk, void* stream) {
  if (axis != 2 && axis != 3) return static_cast<int>(cudaErrorInvalidValue);
  Spectra sp;
  sp.in0 = static_cast<const float2*>(Z);
  sp.in1 = nullptr;
  sp.out0 = static_cast<float2*>(A);
  sp.out1 = static_cast<float2*>(B);
  sp.g0 = static_cast<const float2*>(g0);
  sp.g1 = static_cast<const float2*>(g1);
  set_strides(sp.s[0], sz0, sz1, sz2, sz3);
  set_strides(sp.s[1], 0, 0, 0, 0);
  set_strides(sp.s[2], sa0, sa1, sa2, sa3);
  set_strides(sp.s[3], sb0, sb1, sb2, sb3);
  return launch<true>(sp, N, C, H, W, axis, walk, stream);
}

}  // extern "C"
