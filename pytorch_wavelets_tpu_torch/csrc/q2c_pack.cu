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
// Bound: bytes (4 reads and 4 writes of fp32 per thread, 4-8 flops);
// consecutive threads take consecutive w, so reads coalesce (every other
// float per corner on the per-level path) and writes go out at the
// layout's w stride.
#include <cuda_runtime.h>

namespace {

__global__ void q2c_pack_kernel(const float* __restrict__ y,
                                float* __restrict__ out, long long total,
                                int C, int m, int k, int nm, int orients,
                                long long syn, long long syc,
                                long long smem, long long si, long long sj,
                                long long oa, long long ob, long long oc,
                                long long od, float scale, long long sn,
                                long long sc, long long so, long long sh,
                                long long sw, long long sri) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx % k);
    long long t = idx / k;
    const int i = (int)(t % m);
    t /= m;
    const int mem = (int)(t % nm);
    const long long p = t / nm;
    const float* yp = y + (p / C) * syn + (p % C) * syc + mem * smem +
                      i * si + j * sj;
    const float a = __fmul_rn(yp[oa], scale), b = __fmul_rn(yp[ob], scale);
    const float c = __fmul_rn(yp[oc], scale), d = __fmul_rn(yp[od], scale);
    const int o1 = (orients >> (8 * mem)) & 0xF;
    const int o2 = (orients >> (8 * mem + 4)) & 0xF;
    float* base = out + (p / C) * sn + (p % C) * sc + i * sh + j * sw;
    base[o1 * so] = __fsub_rn(a, d);
    base[o1 * so + sri] = __fadd_rn(b, c);
    base[o2 * so] = __fadd_rn(a, d);
    base[o2 * so + sri] = __fsub_rn(b, c);
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// planes = N*C; members packed as orients |= (o1 | o2 << 4) << (8 * t);
// the input's addressing as in the header.
int q2c_pack(const void* y, void* out, long long planes, int C, int m,
             int k, int nm, int orients, long long syn, long long syc,
             long long smem, long long si, long long sj, long long oa,
             long long ob, long long oc, long long od, float scale,
             long long sn, long long sc, long long so, long long sh,
             long long sw, long long sri, void* stream) {
  const long long total = planes * nm * m * k;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  q2c_pack_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<float*>(out), total, C, m,
      k, nm, orients, syn, syc, smem, si, sj, oa, ob, oc, od, scale, sn, sc,
      so, sh, sw, sri);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
