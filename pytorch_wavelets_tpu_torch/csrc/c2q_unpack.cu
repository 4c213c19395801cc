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
// at xq + p*sxp + t*sxm + i*sxi + j*sxj + {o1, o2, o3, o4} of the
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
// Bound: bytes (4 reads and 4 writes of fp32 per thread, 4-8 flops);
// consecutive threads take consecutive w, so writes coalesce.
#include <cuda_runtime.h>

namespace {

__global__ void c2q_unpack_kernel(const float* __restrict__ hb,
                                  float* __restrict__ xq, long long total,
                                  int C, int h, int w, int nm, int orients,
                                  long long sn, long long sc, long long so,
                                  long long sh, long long sw,
                                  long long sri, long long sxp,
                                  long long sxm, long long sxi,
                                  long long sxj, long long x1o,
                                  long long x2o, long long x3o,
                                  long long x4o, float scale) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx % w);
    long long t = idx / w;
    const int i = (int)(t % h);
    t /= h;
    const int mem = (int)(t % nm);
    const long long p = t / nm;
    const int o1 = (orients >> (8 * mem)) & 0xF;
    const int o2 = (orients >> (8 * mem + 4)) & 0xF;
    const float* base = hb + (p / C) * sn + (p % C) * sc + i * sh + j * sw;
    const float w1r = base[o1 * so], w1i = base[o1 * so + sri];
    const float w2r = base[o2 * so], w2i = base[o2 * so + sri];
    float* xp = xq + p * sxp + mem * sxm + i * sxi + j * sxj;
    xp[x1o] = __fmul_rn(__fadd_rn(w1r, w2r), scale);
    xp[x2o] = __fmul_rn(__fadd_rn(w1i, w2i), scale);
    xp[x3o] = __fmul_rn(__fsub_rn(w1i, w2i), scale);
    xp[x4o] = __fmul_rn(__fsub_rn(w2r, w1r), scale);
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// planes = N*C; members packed as orients |= (o1 | o2 << 4) << (8 * t);
// the output's addressing as in the header.
int c2q_unpack(const void* hb, void* xq, long long planes, int C, int h,
               int w, int nm, int orients, long long sn, long long sc,
               long long so, long long sh, long long sw, long long sri,
               long long sxp, long long sxm, long long sxi, long long sxj,
               long long x1o, long long x2o, long long x3o, long long x4o,
               float scale, void* stream) {
  const long long total = planes * nm * h * w;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  c2q_unpack_kernel<<<(unsigned)blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hb), static_cast<float*>(xq), total, C, h,
      w, nm, orients, sn, sc, so, sh, sw, sri, sxp, sxm, sxi, sxj, x1o, x2o,
      x3o, x4o, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
