// K2 q2c_pack: the forward's quad -> complex butterfly, written straight
// into the final bandpass tensor.
//
// Replaces pytorch_wavelets_tpu/ops/fused_dtcwt.py:_q2c_epilogue (l.126)
// and the jnp.stacks around it (fused_dtcwt.py:126-136 and
// transforms/dtcwt.py:763).  Input: one subband group's stage-2 output y,
// a contiguous (planes, nm*2m, 2k) tensor in which member t holds the
// corner quadrants a = [t*2m + i, j], b = [t*2m + i, k + j],
// c = [t*2m + m + i, j], d = [t*2m + m + i, k + j] (the column operators
// carry the 1/sqrt2).  For member t with orientations (o1, o2) it writes
//   out[o1] = (a - d, b + c),   out[o2] = (a + d, b - c)   as (re, im)
// through the output's strides for (n, c, orientation, h, w, re/im), so
// any o_dim/ri_dim layout is filled in one pass with no stacking copies.
//
// Bound: bytes (4 reads and 4 writes of fp32 per thread, 4 flops);
// consecutive threads take consecutive w, so reads coalesce and writes go
// out at the layout's w stride.
#include <cuda_runtime.h>

namespace {

__global__ void q2c_pack_kernel(const float* __restrict__ y,
                                float* __restrict__ out, long long total,
                                int C, int m, int k, int nm, int orients,
                                long long sy, long long sn, long long sc,
                                long long so, long long sh, long long sw,
                                long long sri) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx % k);
    long long t = idx / k;
    const int i = (int)(t % m);
    t /= m;
    const int mem = (int)(t % nm);
    const long long p = t / nm;
    const float* yp = y + p * sy;
    const long long w2 = 2LL * k;
    const long long top = (long long)(mem * 2 * m + i) * w2;
    const long long bot = top + (long long)m * w2;
    const float a = yp[top + j], b = yp[top + k + j];
    const float c = yp[bot + j], d = yp[bot + k + j];
    const int o1 = (orients >> (8 * mem)) & 0xF;
    const int o2 = (orients >> (8 * mem + 4)) & 0xF;
    float* base = out + (p / C) * sn + (p % C) * sc + i * sh + j * sw;
    base[o1 * so] = a - d;
    base[o1 * so + sri] = b + c;
    base[o2 * so] = a + d;
    base[o2 * so + sri] = b - c;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// planes = N*C; members packed as orients |= (o1 | o2 << 4) << (8 * t).
int q2c_pack(const void* y, void* out, long long planes, int C, int m,
             int k, int nm, int orients, long long sy, long long sn,
             long long sc, long long so, long long sh, long long sw,
             long long sri, void* stream) {
  const long long total = planes * nm * m * k;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  q2c_pack_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<float*>(out), total, C, m,
      k, nm, orients, sy, sn, sc, so, sh, sw, sri);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
