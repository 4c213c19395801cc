// K1 banded_apply: a constant operator matrix T applied along one spatial
// axis of an NCHW fp32 batch, skipping the zero tiles of T.
//
// Replaces pytorch_wavelets_tpu/ops/banded.py:apply_col / apply_row (the
// dense einsums, l.321/332) and _apply_banded + _band_plan (the
// block-banded variant, l.410/369): one kernel serves both, driven by a
// per-output-tile table of contraction segments [k0, k1).  A single full
// segment per tile is the dense product.
//
//   column entry: Y_p = T . X_p            for every plane p = (n, c)
//                 (M x K) . (K x Wc), planes over blockIdx.z, optional
//                 accumulate into Y (the inverse's summed column stage)
//   row entry:    Y (+)= X . T^T           with X viewed as (N*C*H) x K
//                 rows at a row stride, so a column slice of a wider
//                 tensor (the forward's z[..., go:go+gn]) is read in place,
//                 optional accumulate into Y (the inverse SWT's row merge
//                 of two bands)
//
// Bound: dense, the 10x10x128^2 J=2 forward is 3.15 GFLOP and the inverse
// 3.78 GFLOP of fp32 (47 and 56 us at the 67 TFLOP/s of the CUDA cores:
// compute-bound, against ~30 MB of bytes per pass).  The operators are
// short-banded, though: counting only T's nonzeros (2*nnz(T)*cols FLOP)
// the work falls below the bytes of X, T and Y, which then bound the
// ideal kernel.  Skipping zero tiles takes most of that gap on large
// axes; this simple kernel is bound by its own shared-memory traffic
// (two shared loads per FMA).  Design: a tiled fp32 SIMT
// GEMM (IEEE fp32 FMAs on the CUDA cores: the 'highest' precision level),
// 64x64 output tiles, 16-deep K steps staged through shared memory, 256
// threads each holding a 4x4 block of accumulators strided by 16 so that
// shared reads are conflict-free and global stores coalesce.  wgmma/TMA
// and 3xTF32 are later work.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // output tile rows
constexpr int BN = 64;       // output tile cols
constexpr int BK = 16;       // contraction step; segments are BK-aligned
constexpr int THREADS = 256;     // 16 x 16 threads, 4 x 4 outputs each

// One output tile C[i0:i0+BM, j0:j0+BN] (+)= sum over the tile's segments
// of A[i, k] * B[k, j].  A is always k-contiguous: A(i, k) = A[i*lda + k].
// B is j-contiguous (B_KCONTIG=false: B(k, j) = B[k*ldb + j]) or
// k-contiguous (true: B(k, j) = B[j*ldb + k]).
template <bool B_KCONTIG>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ A, long long lda, int rows_a,
    const float* __restrict__ B, long long ldb, int cols_b,
    float* __restrict__ C, long long ldc, int accumulate,
    int i0, int j0, const int* __restrict__ seg_ptr,
    const int* __restrict__ segs, int tile,
    float (&As)[BK][BM + 1], float (&Bs)[BK][BN + 1]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  const int s0 = seg_ptr[tile], s1 = seg_ptr[tile + 1];
  for (int s = s0; s < s1; ++s) {
    const int k0 = segs[2 * s], k1 = segs[2 * s + 1];
    for (int kb = k0; kb < k1; kb += BK) {
      {  // A tile: 16 consecutive k per row, 16 rows per pass
        const int lk = tid % BK, li = tid / BK;
        const int k = kb + lk;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + li + 16 * r;
          As[lk][li + 16 * r] =
              (i < rows_a && k < k1) ? A[(long long)i * lda + k] : 0.f;
        }
      }
      if (B_KCONTIG) {  // 16 consecutive k per column
        const int lk = tid % BK, lj = tid / BK;
        const int k = kb + lk;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = j0 + lj + 16 * r;
          Bs[lk][lj + 16 * r] =
              (j < cols_b && k < k1) ? B[(long long)j * ldb + k] : 0.f;
        }
      } else {  // 64 consecutive j per k row
        const int lj = tid % BN, lk = tid / BN;
        const int j = j0 + lj;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = kb + lk + 4 * r;
          Bs[lk + 4 * r][lj] =
              (j < cols_b && k < k1) ? B[(long long)k * ldb + j] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= rows_a) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j >= cols_b) continue;
      float* dst = C + (long long)i * ldc + j;
      *dst = accumulate ? *dst + acc[r][c] : acc[r][c];
    }
  }
}

// Column entry: blockIdx.x = Wc tile, blockIdx.y = T-row tile (indexes the
// segment table), blockIdx.z strides over planes.
__global__ void __launch_bounds__(THREADS) banded_apply_col_kernel(
    const float* __restrict__ T, const float* __restrict__ x,
    float* __restrict__ y, const int* __restrict__ seg_ptr,
    const int* __restrict__ segs, int M, int K, int Wc, int planes,
    long long ldx, long long sx, long long ldy, long long sy,
    int accumulate) {
  __shared__ float As[BK][BM + 1];  // +1: conflict-free tile stores
  __shared__ float Bs[BK][BN + 1];
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  for (int p = blockIdx.z; p < planes; p += gridDim.z) {
    tile_product<false>(T, K, M, x + (long long)p * sx, ldx, Wc,
                        y + (long long)p * sy, ldy, accumulate, i0, j0,
                        seg_ptr, segs, blockIdx.y, As, Bs);
  }
}

// Row entry: blockIdx.x = tile of X rows, blockIdx.y = T-row tile (output
// columns; indexes the segment table).
__global__ void __launch_bounds__(THREADS) banded_apply_row_kernel(
    const float* __restrict__ x, const float* __restrict__ T,
    float* __restrict__ y, const int* __restrict__ seg_ptr,
    const int* __restrict__ segs, long long R, int K, int Kout,
    long long ldx, long long ldy, int accumulate) {
  __shared__ float As[BK][BM + 1];  // +1: conflict-free tile stores
  __shared__ float Bs[BK][BN + 1];
  const long long r0 = (long long)blockIdx.x * BM;
  const int rows = (int)((R - r0) < BM ? (R - r0) : BM);
  tile_product<true>(x + r0 * ldx, ldx, rows, T, K, Kout, y + r0 * ldy, ldy,
                     accumulate, 0, blockIdx.y * BN, seg_ptr, segs,
                     blockIdx.y, As, Bs);
}

}  // namespace

extern "C" {

int banded_apply_tile_rows() { return BM; }  // == BN: T-row tile height
int banded_apply_k_align() { return BK; }

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y[p] (+)= T . x[p]; T (M x K) row-major; x[p] (K x Wc) at row stride ldx,
// plane stride sx; y[p] (M x Wc) at row stride ldy, plane stride sy.
int banded_apply_col(const void* T, const void* x, void* y,
                     const void* seg_ptr, const void* segs, int M, int K,
                     int Wc, int planes, long long ldx, long long sx,
                     long long ldy, long long sy, int accumulate,
                     void* stream) {
  if (M == 0 || Wc == 0 || planes == 0) return 0;
  const int gz = planes < 65535 ? planes : 65535;
  dim3 grid((Wc + BN - 1) / BN, (M + BM - 1) / BM, gz);
  banded_apply_col_kernel<<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T), static_cast<const float*>(x),
      static_cast<float*>(y), static_cast<const int*>(seg_ptr),
      static_cast<const int*>(segs), M, K, Wc, planes, ldx, sx, ldy, sy,
      accumulate);
  return static_cast<int>(cudaGetLastError());
}

// y (+)= x . T^T; x (R x K) at row stride ldx; T (Kout x K) row-major;
// y (R x Kout) at row stride ldy.
int banded_apply_row(const void* x, const void* T, void* y,
                     const void* seg_ptr, const void* segs, long long R,
                     int K, int Kout, long long ldx, long long ldy,
                     int accumulate, void* stream) {
  if (R == 0 || Kout == 0) return 0;
  dim3 grid((unsigned)((R + BM - 1) / BM), (Kout + BN - 1) / BN, 1);
  banded_apply_row_kernel<<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(T),
      static_cast<float*>(y), static_cast<const int*>(seg_ptr),
      static_cast<const int*>(segs), R, K, Kout, ldx, ldy, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
