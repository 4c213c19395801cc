// K3 c2q_unpack: the inverse's complex -> quad combine, read straight out
// of the bandpass tensor.
//
// Replaces the combine and concatenations of
// pytorch_wavelets_tpu/ops/fused_dtcwt.py:synthesis_pyramid (l.290-306).
// Input: one level's bandpass tensor, read through its strides for
// (n, c, orientation, h, w, re/im), so any o_dim/ri_dim layout is taken
// in place.  For member t of a subband group, with orientations (o1, o2)
// holding w1 = (w1r, w1i) and w2 = (w2r, w2i), it writes the member's
// quadrant planes into the contiguous (planes, nm*2h, 2w) tensor xq:
//   [t*2h + i,     j] = w1r + w2r     [t*2h + i,     w + j] = w1i + w2i
//   [t*2h + h + i, j] = w1i - w2i     [t*2h + h + i, w + j] = w2r - w1r
// (the row operators carry the 1/sqrt2), which the row stage then reads.
//
// Bound: bytes (4 reads and 4 writes of fp32 per thread, 4 flops);
// consecutive threads take consecutive w, so writes coalesce.
#include <cuda_runtime.h>

namespace {

__global__ void c2q_unpack_kernel(const float* __restrict__ hb,
                                  float* __restrict__ xq, long long total,
                                  int C, int h, int w, int nm, int orients,
                                  long long sn, long long sc, long long so,
                                  long long sh, long long sw,
                                  long long sri) {
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
    const long long w2 = 2LL * w;
    float* xp = xq + p * (long long)nm * 2 * h * w2;
    const long long top = (long long)(mem * 2 * h + i) * w2;
    const long long bot = top + (long long)h * w2;
    xp[top + j] = w1r + w2r;
    xp[top + w + j] = w1i + w2i;
    xp[bot + j] = w1i - w2i;
    xp[bot + w + j] = w2r - w1r;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// planes = N*C; members packed as orients |= (o1 | o2 << 4) << (8 * t).
int c2q_unpack(const void* hb, void* xq, long long planes, int C, int h,
               int w, int nm, int orients, long long sn, long long sc,
               long long so, long long sh, long long sw, long long sri,
               void* stream) {
  const long long total = planes * nm * h * w;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  c2q_unpack_kernel<<<(unsigned)blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hb), static_cast<float*>(xq), total, C, h,
      w, nm, orients, sn, sc, so, sh, sw, sri);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
