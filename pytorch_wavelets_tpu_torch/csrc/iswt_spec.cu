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
// Every spectrum is read and written through its own four strides (in
// complex elements), so the strided views torch.fft returns are taken as
// they are.  Bound: bytes, 24 per element (two spectra read and one
// written, or one read and two written) against 8 FLOP.  One element per
// thread, consecutive threads along W.
#include <cuda_runtime.h>

namespace {

struct SpecArgs {
  const float2* in0;
  const float2* in1;
  float2* out0;
  float2* out1;
  const float2* g0;
  const float2* g1;
  int C, H, W, axis;
  long long planes;
  long long s[4][4];  // strides of in0, in1, out0, out1 (N, C, H, W)
};

template <typename T>
__device__ __forceinline__ T* at(T* base, const long long* s, long long nn,
                                 int c, int i, int j) {
  return base + nn * s[0] + c * s[1] + i * s[2] + j * s[3];
}

template <typename I, bool SPLIT>
__global__ void spec_kernel(SpecArgs a) {
  const I per_plane = (I)a.H * a.W;
  for (long long p = blockIdx.y; p < a.planes; p += gridDim.y) {
    const long long nn = p / a.C;
    const int c = (int)(p % a.C);
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < per_plane;
         idx += (I)gridDim.x * blockDim.x) {
      const int i = (int)(idx / a.W), j = (int)(idx % a.W);
      const int f = a.axis == 3 ? j : i;
      const float2 g0 = a.g0[f], g1 = a.g1[f];
      const float2 z = *at(a.in0, a.s[0], nn, c, i, j);
      if (SPLIT) {
        // conj(g) * z
        float2 u, v;
        u.x = fmaf(g0.x, z.x, g0.y * z.y);
        u.y = fmaf(g0.x, z.y, -g0.y * z.x);
        v.x = fmaf(g1.x, z.x, g1.y * z.y);
        v.y = fmaf(g1.x, z.y, -g1.y * z.x);
        *at(a.out0, a.s[2], nn, c, i, j) = u;
        *at(a.out1, a.s[3], nn, c, i, j) = v;
      } else {
        const float2 b = *at(a.in1, a.s[1], nn, c, i, j);
        float2 u;
        u.x = fmaf(g0.x, z.x, -g0.y * z.y);
        u.x = fmaf(g1.x, b.x, u.x);
        u.x = fmaf(-g1.y, b.y, u.x);
        u.y = fmaf(g0.x, z.y, g0.y * z.x);
        u.y = fmaf(g1.x, b.y, u.y);
        u.y = fmaf(g1.y, b.x, u.y);
        *at(a.out0, a.s[2], nn, c, i, j) = u;
      }
    }
  }
}

template <bool SPLIT>
int launch(SpecArgs& a, void* stream) {
  const long long per_plane = (long long)a.H * a.W;
  if (per_plane == 0 || a.planes == 0) return 0;
  const int threads = 256;
  const long long bx = (per_plane + threads - 1) / threads;
  const dim3 grid((unsigned)(bx > 2147483647LL ? 2147483647LL : bx),
                  (unsigned)(a.planes > 65535 ? 65535 : a.planes), 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (per_plane < (1LL << 30))
    spec_kernel<int, SPLIT><<<grid, threads, 0, st>>>(a);
  else
    spec_kernel<long long, SPLIT><<<grid, threads, 0, st>>>(a);
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
// g0, g1: device complex64 vectors indexed by the frequency along axis.
int spec_merge(const void* A, const void* B, void* Z, const void* g0,
               const void* g1, long long N, int C, int H, int W,
               long long sa0, long long sa1, long long sa2, long long sa3,
               long long sb0, long long sb1, long long sb2, long long sb3,
               long long sz0, long long sz1, long long sz2, long long sz3,
               int axis, void* stream) {
  if (axis != 2 && axis != 3) return static_cast<int>(cudaErrorInvalidValue);
  SpecArgs a;
  a.in0 = static_cast<const float2*>(A);
  a.in1 = static_cast<const float2*>(B);
  a.out0 = static_cast<float2*>(Z);
  a.out1 = nullptr;
  a.g0 = static_cast<const float2*>(g0);
  a.g1 = static_cast<const float2*>(g1);
  a.C = C;
  a.H = H;
  a.W = W;
  a.axis = axis;
  a.planes = N * C;
  set_strides(a.s[0], sa0, sa1, sa2, sa3);
  set_strides(a.s[1], sb0, sb1, sb2, sb3);
  set_strides(a.s[2], sz0, sz1, sz2, sz3);
  set_strides(a.s[3], 0, 0, 0, 0);
  return launch<false>(a, stream);
}

// Z: the cotangent spectrum; A, B: the two band spectra written.
int spec_split(const void* Z, void* A, void* B, const void* g0,
               const void* g1, long long N, int C, int H, int W,
               long long sz0, long long sz1, long long sz2, long long sz3,
               long long sa0, long long sa1, long long sa2, long long sa3,
               long long sb0, long long sb1, long long sb2, long long sb3,
               int axis, void* stream) {
  if (axis != 2 && axis != 3) return static_cast<int>(cudaErrorInvalidValue);
  SpecArgs a;
  a.in0 = static_cast<const float2*>(Z);
  a.in1 = nullptr;
  a.out0 = static_cast<float2*>(A);
  a.out1 = static_cast<float2*>(B);
  a.g0 = static_cast<const float2*>(g0);
  a.g1 = static_cast<const float2*>(g1);
  a.C = C;
  a.H = H;
  a.W = W;
  a.axis = axis;
  a.planes = N * C;
  set_strides(a.s[0], sz0, sz1, sz2, sz3);
  set_strides(a.s[1], 0, 0, 0, 0);
  set_strides(a.s[2], sa0, sa1, sa2, sa3);
  set_strides(a.s[3], sb0, sb1, sb2, sb3);
  return launch<true>(a, stream);
}

}  // extern "C"
