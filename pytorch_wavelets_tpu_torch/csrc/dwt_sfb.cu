// K7 dwt_sfb: the DWT's synthesis merge along one axis, in polyphase form.
//
// Replaces pytorch_wavelets_tpu/ops/afb_sfb.py:_conv_axis (l.47) with
// lhs_dilation=2 as used by _sfb1d_conv_conv (l.262), the transposed
// stride-2 correlation of (lo, hi) summed (B8b), its periodization
// wrap-add and roll included.  Inputs: lo and hi as (N, C, H, W) views,
// each read through its own four strides (the bands of a level's
// (N, C, 3, H, W) stack in place); axis 3 merges along W, axis 2 along H.
// With taps g0/g1 in convolution order and
//
//   Y(u) = sum_j lo[j] g0[u - 2j] + hi[j] g1[u - 2j]   (0 <= u - 2j < L),
//
// output n is Y(t + s) + (Y(t + s + wrap) if t < fold), with t = n, or
// t = (n + r0) mod wrap for 'periodization' (ops/afb_sfb.py:sfb_plan).
// Each output reads only the ceil(L/2) taps of its phase (u's parity):
// no multiply by an inserted zero.  Only the first m_out outputs along
// the axis are written (the crop of a backward), through the output's
// four strides.
//
// Bound: bytes.  A db4 merge does 8 multiply-adds per output and reads
// two inputs of half its length: about 2 FLOP per byte moved, against ~20
// for the card.  Consecutive threads take consecutive outputs along W, so
// a warp reads contiguous runs of lo and hi (each sample twice, from L1).
#include <cuda_runtime.h>

#include "dwt_index.cuh"

namespace {

struct SfbArgs {
  const float* lo;
  const float* hi;
  float* y;
  int L, C, nin, s, wrap, r0, fold, axis, Ho, Wo;
  long long planes, sl0, sl1, sl2, sl3, sh0, sh1, sh2, sh3, sy0, sy1, sy2,
      sy3;
};

__device__ __forceinline__ float merge_at(long long u, const float* lo,
                                          long long slo, const float* hi,
                                          long long shi, int nin, int L,
                                          const float* g0, const float* g1) {
  // j in [ceil((u - L + 1) / 2), floor(u / 2)], clipped to [0, nin)
  const long long jhi = min((long long)nin - 1, u >> 1);
  const long long jlo = max(0LL, (u - L + 2) / 2);
  float acc = 0.f;
  for (long long j = jhi; j >= jlo; --j) {
    const int k = (int)(u - 2 * j);
    acc = fmaf(lo[j * slo], g0[k], acc);
    acc = fmaf(hi[j * shi], g1[k], acc);
  }
  return acc;
}

template <typename I>
__global__ void dwt_sfb_kernel(SfbArgs a, DwtTaps taps) {
  __shared__ float g0[DWT_MAX_TAPS], g1[DWT_MAX_TAPS];
  load_taps(taps, a.L, g0, g1);
  const I per_plane = (I)a.Ho * a.Wo;
  for (long long p = blockIdx.y; p < a.planes; p += gridDim.y) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    const float* lp = a.lo + nn * a.sl0 + c * a.sl1;
    const float* hp = a.hi + nn * a.sh0 + c * a.sh1;
    float* yp = a.y + nn * a.sy0 + c * a.sy1;
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < per_plane;
         idx += (I)gridDim.x * blockDim.x) {
      const int i = (int)(idx / a.Wo), j = (int)(idx % a.Wo);
      int o;
      const float *lb, *hb;
      long long slo, shi;
      if (a.axis == 3) {
        o = j;
        lb = lp + i * a.sl2;
        hb = hp + i * a.sh2;
        slo = a.sl3;
        shi = a.sh3;
      } else {
        o = i;
        lb = lp + j * a.sl3;
        hb = hp + j * a.sh3;
        slo = a.sl2;
        shi = a.sh2;
      }
      const long long t = a.wrap ? floor_mod((long long)o + a.r0, a.wrap)
                                 : (long long)o;
      float v = merge_at(t + a.s, lb, slo, hb, shi, a.nin, a.L, g0, g1);
      if (t < a.fold)
        v += merge_at(t + a.s + a.wrap, lb, slo, hb, shi, a.nin, a.L, g0,
                      g1);
      yp[i * a.sy2 + j * a.sy3] = v;
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lo, hi: (N, C, Hin, Win) at strides sl0..sl3 and sh0..sh3; g0, g1: L host
// floats each; y: (N, C, H', W') at strides sy0..sy3, where the merged
// axis has m_out outputs and the other keeps its length.
int dwt_sfb(const void* lo, const void* hi, void* y, const float* g0,
            const float* g1, int L, long long N, int C, int Hin, int Win,
            long long sl0, long long sl1, long long sl2, long long sl3,
            long long sh0, long long sh1, long long sh2, long long sh3,
            int axis, int s, int wrap, int r0, int fold, int m_out,
            long long sy0, long long sy1, long long sy2, long long sy3,
            void* stream) {
  if (L < 1 || L > DWT_MAX_TAPS || (axis != 2 && axis != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  SfbArgs a;
  a.lo = static_cast<const float*>(lo);
  a.hi = static_cast<const float*>(hi);
  a.y = static_cast<float*>(y);
  a.L = L;
  a.C = C;
  a.nin = axis == 3 ? Win : Hin;
  a.s = s;
  a.wrap = wrap;
  a.r0 = r0;
  a.fold = fold;
  a.axis = axis;
  a.Ho = axis == 2 ? m_out : Hin;
  a.Wo = axis == 3 ? m_out : Win;
  a.planes = N * C;
  a.sl0 = sl0; a.sl1 = sl1; a.sl2 = sl2; a.sl3 = sl3;
  a.sh0 = sh0; a.sh1 = sh1; a.sh2 = sh2; a.sh3 = sh3;
  a.sy0 = sy0; a.sy1 = sy1; a.sy2 = sy2; a.sy3 = sy3;
  const long long per_plane = (long long)a.Ho * a.Wo;
  if (per_plane == 0 || a.planes == 0) return 0;
  dwt_launch(dwt_sfb_kernel<int>, dwt_sfb_kernel<long long>,
             per_plane, a.planes, a, pack_taps(g0, g1, L), stream);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
