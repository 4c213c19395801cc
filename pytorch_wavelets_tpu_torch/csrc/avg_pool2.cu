// K11 avg_pool2: the scattering layers' 2x2 average pool and its adjoint.
//
// Replaces pytorch_wavelets_tpu/transforms/scatternet.py:avg_pool2 (l.46),
// which the TPU runs as two thin operator matmuls (part of B6).
//
// - avg_pool2_fwd: y[i, j] = 0.25 * ((x[2i, 2j] + x[2i, 2j+1]) +
//   (x[2i+1, 2j] + x[2i+1, 2j+1])) of every (N, C) plane of an (N, C, H, W)
//   view read through its strides, into a contiguous (N, C, H/2, W/2)
//   tensor.  The rounded intrinsics fix the order of the sums, so the
//   result is bit-equal to the plain version's (ops/pool.py).
// - avg_pool2_bwd: the adjoint, dx[2i + a, 2j + b] = 0.25 * g[i, j], from a
//   strided cotangent into a contiguous (N, C, 2h, 2w) tensor.
//
// Bound: bytes (forward: 4 reads and 1 write per output, 4 flops; adjoint:
// 1 read and 4 writes).  Consecutive threads take consecutive outputs
// along W (the adjoint: consecutive cotangent values, each writing its
// 2x2 block as two float2 stores), so reads and writes are contiguous
// runs.
#include <cuda_runtime.h>

namespace {

__global__ void avg_pool2_fwd_kernel(const float* __restrict__ x,
                                     float* __restrict__ y, long long total,
                                     int C, int h, int w, long long sx0,
                                     long long sx1, long long sx2,
                                     long long sx3) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx % w);
    long long t = idx / w;
    const int i = (int)(t % h);
    const long long p = t / h;
    const float* b = x + (p / C) * sx0 + (p % C) * sx1 + (2LL * i) * sx2 +
                     (2LL * j) * sx3;
    const float top = __fadd_rn(b[0], b[sx3]);
    const float bot = __fadd_rn(b[sx2], b[sx2 + sx3]);
    y[idx] = __fmul_rn(__fadd_rn(top, bot), 0.25f);
  }
}

__global__ void avg_pool2_bwd_kernel(const float* __restrict__ g,
                                     float* __restrict__ dx, long long total,
                                     int C, int h, int w, long long sg0,
                                     long long sg1, long long sg2,
                                     long long sg3) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    // idx runs over g (N, C, h, w); each value fills its 2x2 block of dx
    const int j = (int)(idx % w);
    long long t = idx / w;
    const int i = (int)(t % h);
    const long long p = t / h;
    const float v = __fmul_rn(g[(p / C) * sg0 + (p % C) * sg1 +
                                (long long)i * sg2 + (long long)j * sg3],
                              0.25f);
    float2* row = reinterpret_cast<float2*>(dx + (p * 2 * h + 2 * i) *
                                            (2LL * w)) + j;
    row[0] = make_float2(v, v);
    row[w] = make_float2(v, v);
  }
}

inline unsigned blocks_for(long long total, int threads) {
  long long b = (total + threads - 1) / threads;
  return (unsigned)(b > 1048576 ? 1048576 : b);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, C, 2h, 2w) at strides sx0..sx3; y: contiguous (N, C, h, w).
int avg_pool2_fwd(const void* x, void* y, long long N, int C, int h, int w,
                  long long sx0, long long sx1, long long sx2, long long sx3,
                  void* stream) {
  const long long total = N * C * (long long)h * w;
  if (total == 0) return 0;
  const int threads = 256;
  avg_pool2_fwd_kernel<<<blocks_for(total, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), total, C, h, w,
      sx0, sx1, sx2, sx3);
  return static_cast<int>(cudaGetLastError());
}

// g: (N, C, h, w) at strides sg0..sg3; dx: contiguous (N, C, 2h, 2w)
// (8-byte aligned, as every allocation is).
int avg_pool2_bwd(const void* g, void* dx, long long N, int C, int h, int w,
                  long long sg0, long long sg1, long long sg2, long long sg3,
                  void* stream) {
  const long long total = N * C * (long long)h * w;
  if (total == 0) return 0;
  const int threads = 256;
  avg_pool2_bwd_kernel<<<blocks_for(total, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<float*>(dx), total, C, h, w,
      sg0, sg1, sg2, sg3);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
