// K4 scat_mag_fwd and K5 scat_mag_bwd: the scattering layers' smooth
// magnitude and its backward, as single passes over the bandpass tensor.
//
// Replaces pytorch_wavelets_tpu/transforms/scatternet.py:smooth_mag (l.25)
// and _combined_mag (l.32), and the JAX autodiff of both.  Input: one
// level's bands as a (N, 6, C, h, w, 2) view, read through its strides
// for (n, orientation, c, h, w, re/im).
//
//   K4: r[n, o, c, i, j] = sqrt(re^2 + im^2 + b^2) - b, written to the
//       contiguous (N, 6, C, h, w) output; with `combine` the re^2 + im^2
//       are first summed over the C channels and r is (N, 6, 1, h, w).
//   K5: d re = g * re / (r + b),  d im = g * im / (r + b), with r + b
//       recomputed from the bands (one extra read of the bands; nothing
//       is saved in the forward), g read through its strides (with
//       `combine` one g and one ratio per (n, o, i, j), broadcast over C),
//       written to the contiguous (N, 6, C, h, w, 2) band gradient.
//
// Every product, sum, square root and quotient is the IEEE-rounded
// intrinsic, in the order of the plain PyTorch version
// (ops/scat_mag.py), so that no FMA contraction changes a result; at
// b = 0 a zero coefficient gives 0 forward and 0/0 = NaN backward, as the
// plain version and JAX's autodiff do.
//
// Bound: bytes (K4 reads 8 and writes 4 bytes per coefficient, K5 reads
// 8 + 4 and writes 8, against 4-8 flops).  Consecutive threads take
// consecutive w, so the re/im pairs of a warp are one contiguous run.
#include <cuda_runtime.h>

namespace {

struct Bands {
  const float* p;
  long long sn, so, sc, sh, sw, sri;
};

// Sum over the k channels from c of re^2 + im^2, in channel order.
__device__ __forceinline__ float sum_sq(const float* p, int k, long long sc,
                                        long long sri) {
  float s = 0.f;
  for (int t = 0; t < k; ++t) {
    const float re = p[t * sc], im = p[t * sc + sri];
    s = __fadd_rn(s, __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
  }
  return s;
}

__global__ void scat_mag_fwd_kernel(Bands hb, float* __restrict__ r,
                                    long long total, int cout, int nc,
                                    int hh, int ww, float b2, float b) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx % ww);
    long long t = idx / ww;
    const int i = (int)(t % hh);
    t /= hh;
    const int c = (int)(t % cout);
    t /= cout;
    const int o = (int)(t % 6);
    const long long n = t / 6;
    const float* p = hb.p + n * hb.sn + o * hb.so + c * hb.sc + i * hb.sh +
                     j * hb.sw;
    const float s = sum_sq(p, nc, hb.sc, hb.sri);
    r[idx] = __fsub_rn(__fsqrt_rn(__fadd_rn(s, b2)), b);
  }
}

__global__ void scat_mag_bwd_kernel(Bands hb, const float* __restrict__ g,
                                    long long gn, long long go, long long gc,
                                    long long gh, long long gw,
                                    float* __restrict__ dh, long long total,
                                    int C, int cout, int nc, int hh, int ww,
                                    float b2) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx % ww);
    long long t = idx / ww;
    const int i = (int)(t % hh);
    t /= hh;
    const int c = (int)(t % cout);
    t /= cout;
    const int o = (int)(t % 6);
    const long long n = t / 6;
    const float* p = hb.p + n * hb.sn + o * hb.so + c * hb.sc + i * hb.sh +
                     j * hb.sw;
    const float den = __fsqrt_rn(__fadd_rn(sum_sq(p, nc, hb.sc, hb.sri),
                                           b2));
    const float gv = g[n * gn + o * go + c * gc + i * gh + j * gw];
    // dh is contiguous (N, 6, C, h, w, 2): channel c + k at plane
    // (n * 6 + o) * C + c + k
    const long long plane = (n * 6 + o) * C + c;
    for (int k = 0; k < nc; ++k) {
      const float re = p[k * hb.sc], im = p[k * hb.sc + hb.sri];
      float2 v;
      v.x = __fdiv_rn(__fmul_rn(gv, re), den);
      v.y = __fdiv_rn(__fmul_rn(gv, im), den);
      reinterpret_cast<float2*>(dh)[((plane + k) * hh + i) * ww + j] = v;
    }
  }
}

unsigned grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  return (unsigned)(blocks > 1048576 ? 1048576 : blocks);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h: (N, 6, C, hh, ww, 2) at strides sn..sri; r: contiguous
// (N, 6, combine ? 1 : C, hh, ww).  b2 = b * b rounded to float.
int scat_mag_fwd(const void* h, void* r, long long N, int C, int hh, int ww,
                 int combine, long long sn, long long so, long long sc,
                 long long sh, long long sw, long long sri, float b2,
                 float b, void* stream) {
  const int cout = combine ? 1 : C, nc = combine ? C : 1;
  const long long total = N * 6 * cout * hh * ww;
  if (total == 0) return 0;
  const int threads = 256;
  Bands hb{static_cast<const float*>(h), sn, so, sc, sh, sw, sri};
  scat_mag_fwd_kernel<<<grid_for(total, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      hb, static_cast<float*>(r), total, cout, nc, hh, ww, b2, b);
  return static_cast<int>(cudaGetLastError());
}

// h as for scat_mag_fwd; g: (N, 6, combine ? 1 : C, hh, ww) at strides
// gn..gw; dh: contiguous (N, 6, C, hh, ww, 2).
int scat_mag_bwd(const void* h, const void* g, void* dh, long long N, int C,
                 int hh, int ww, int combine, long long sn, long long so,
                 long long sc, long long sh, long long sw, long long sri,
                 long long gn, long long go, long long gc, long long gh,
                 long long gw, float b2, void* stream) {
  const int cout = combine ? 1 : C, nc = combine ? C : 1;
  const long long total = N * 6 * cout * hh * ww;
  if (total == 0) return 0;
  const int threads = 256;
  Bands hb{static_cast<const float*>(h), sn, so, sc, sh, sw, sri};
  scat_mag_bwd_kernel<<<grid_for(total, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      hb, static_cast<const float*>(g), gn, go, gc, gh, gw,
      static_cast<float*>(dh), total, C, cout, nc, hh, ww, b2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
