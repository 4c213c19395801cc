// K17 banded_apply_tc: K1's operator product (csrc/banded_apply.cu) on
// the tensor cores, in the arithmetic of the matmul precision level and
// the data's type (ops/precision.py):
//
//   mode 0, TF32   ("default", fp32 data): each operand rounded to TF32
//                  (cvt.rna.tf32.f32, nearest, ties away from zero),
//                  mma.sync m16n8k8 .tf32 with an fp32 accumulator;
//   mode 1, 3xTF32 ("high", fp32 data): each operand split as
//                  big = tf32(a), small = tf32(a - big); per 8-deep k
//                  step the fp32 partial takes small.big, then
//                  big.small, then big.big (three m16n8k8 .tf32
//                  products);
//   mode 2, bf16   (bf16 data, every level): X and T in bf16 (T is the
//                  operator rounded to bf16, as the JAX package's
//                  jnp.asarray(T, dtype=x.dtype) rounds it), mma.sync
//                  m16n8k16 .bf16 with an fp32 accumulator, the output
//                  rounded to bf16 once, where it is written (where the
//                  JAX einsum rounds).  With accumulate, Y is read,
//                  added to the fp32 sum, and the sum rounded once.
//
// Replaces pytorch_wavelets_tpu/ops/banded.py:apply_col / apply_row
// (l.321/332) and _apply_banded (l.410) at Precision.HIGH and DEFAULT
// and on bf16 inputs (on the TPU: three bf16 passes, one bf16 pass, and
// the bf16 einsum), where K1 takes Precision.HIGHEST in fp32.  The
// interface is K1's: the same per-output-tile segment table
// (seg_ptr/segs: 64 T rows a tile, segments 16-aligned, so the 8-deep
// TF32 and 16-deep bf16 k steps fit), the same column and row entries,
// plane, row and column strides, and accumulate.
//
// Bound: 2 nnz(T) columns FLOP over 495 TFLOP/s (TF32; three times the
// work for 3xTF32) or 989 TFLOP/s (bf16), or the bytes of X, T and Y
// over 3.35 TB/s, whichever is larger.  The operators are short-banded,
// so counted on T's nonzeros the bytes bound the ideal kernel; the dense
// operators (the ISWT's pinv, the stacked row operators) are
// operation-bound.  Design, simple first: 64x64 output tiles of 128
// threads (four warps of 32x32, each 2x4 mma tiles), 16-deep k steps
// staged through shared memory in fp32 (TF32 operands rounded as they
// are stored; 3xTF32 split and bf16 pairs packed as the fragments are
// read), the next step's global loads issued into registers before the
// current step's products (one shared buffer, two barriers a step), each
// step's products summed into a zeroed partial that one IEEE fp32 add
// folds into the sum (the tensor cores' own fp32 accumulation does not
// round to nearest), zero tiles of T skipped as in K1.  cp.async or TMA
// staging, wgmma and a persistent schedule are later work.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int BM = 64;       // output tile rows (T rows: the segment table)
constexpr int BN = 64;       // output tile cols
constexpr int BK = 16;       // k step; segments are BK-aligned
constexpr int THREADS = 128;     // 4 warps, 2 x 2, each 32 x 32
constexpr int LDK = BK + 4;      // [row][k] tiles: conflict-free fragments
constexpr int LDJ = BN + 8;      // [k][col] tiles: conflict-free fragments
constexpr int SMEM_B = (BN * LDK > BK * LDJ) ? BN * LDK : BK * LDJ;

enum { TF32 = 0, TF32X3 = 1, BF16 = 2 };

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // exact: bf16 values
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output tile C[i0:i0+BM, j0:j0+BN] (+)= sum over the tile's segments
// of A[i, k] * B[k, j].  A is always k-contiguous: A(i, k) = A[i*lda + k].
// B is j-contiguous (B_KCONTIG=false: B(k, j) = B[k*ldb + j]) or
// k-contiguous (true: B(k, j) = B[j*ldb + k]).  Shared tiles: As[i][k]
// (LDK), Bs[j][k] (LDK) when B is k-contiguous, else Bs[k][j] (LDJ).
template <int MODE, bool B_KCONTIG, typename E>
__device__ __forceinline__ void tile_product(
    const E* __restrict__ A, long long lda, int rows_a,
    const E* __restrict__ B, long long ldb, int cols_b, E* __restrict__ C,
    long long ldc, int accumulate, int i0, int j0,
    const int* __restrict__ seg_ptr, const int* __restrict__ segs, int tile,
    float* __restrict__ As, float* __restrict__ Bs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, q = lane & 3;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  float ra[8], rb[8];
  auto load = [&](int kb, int k1) {
    {  // A: 16 consecutive k per row, 8 rows per pass
      const int k = kb + tid % BK, li = tid / BK;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = i0 + li + 8 * r;
        ra[r] = (i < rows_a && k < k1) ? to_float(A[(long long)i * lda + k])
                                       : 0.f;
      }
    }
    if (B_KCONTIG) {  // 16 consecutive k per column
      const int k = kb + tid % BK, lj = tid / BK;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = j0 + lj + 8 * r;
        rb[r] = (j < cols_b && k < k1) ? to_float(B[(long long)j * ldb + k])
                                       : 0.f;
      }
    } else {  // 64 consecutive j per k row
      const int j = j0 + tid % BN, lk = tid / BN;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int k = kb + lk + 2 * r;
        rb[r] = (j < cols_b && k < k1) ? to_float(B[(long long)k * ldb + j])
                                       : 0.f;
      }
    }
  };
  auto stored = [](float v) {  // TF32: round once, as the tile is stored
    return MODE == TF32 ? __uint_as_float(tf32_bits(v)) : v;
  };
  auto store = [&]() {
    {
      const int lk = tid % BK, li = tid / BK;
#pragma unroll
      for (int r = 0; r < 8; ++r) As[(li + 8 * r) * LDK + lk] = stored(ra[r]);
    }
    if (B_KCONTIG) {
      const int lk = tid % BK, lj = tid / BK;
#pragma unroll
      for (int r = 0; r < 8; ++r) Bs[(lj + 8 * r) * LDK + lk] = stored(rb[r]);
    } else {
      const int lj = tid % BN, lk = tid / BN;
#pragma unroll
      for (int r = 0; r < 8; ++r) Bs[(lk + 2 * r) * LDJ + lj] = stored(rb[r]);
    }
  };
  auto a_at = [&](int i, int k) { return As[i * LDK + k]; };
  auto b_at = [&](int k, int j) {
    return B_KCONTIG ? Bs[j * LDK + k] : Bs[k * LDJ + j];
  };
  auto compute = [&]() {
    // this step's products, summed by the tensor cores into a zeroed
    // partial and added to the sum by an IEEE fp32 add (below): the
    // tensor cores do not round their fp32 accumulation to nearest, so an
    // accumulator that took every product of a long contraction would
    // drift from the IEEE sum (by ~5e-5 relative at K = 2048 in 3xTF32)
    float part[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
    if (MODE == BF16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + 16 * mi + g;
        a[mi][0] = bf16_pair(a_at(r, 2 * q), a_at(r, 2 * q + 1));
        a[mi][1] = bf16_pair(a_at(r + 8, 2 * q), a_at(r + 8, 2 * q + 1));
        a[mi][2] = bf16_pair(a_at(r, 2 * q + 8), a_at(r, 2 * q + 9));
        a[mi][3] = bf16_pair(a_at(r + 8, 2 * q + 8), a_at(r + 8, 2 * q + 9));
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn + 8 * ni + g;
        b[ni][0] = bf16_pair(b_at(2 * q, c), b_at(2 * q + 1, c));
        b[ni][1] = bf16_pair(b_at(2 * q + 8, c), b_at(2 * q + 9, c));
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(part[mi][ni], a[mi], b[ni]);
    }
#pragma unroll
    for (int ks = 0; ks < (MODE == BF16 ? 0 : BK); ks += 8) {
      float av[2][4], bv[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + 16 * mi + g;
        av[mi][0] = a_at(r, ks + q);
        av[mi][1] = a_at(r + 8, ks + q);
        av[mi][2] = a_at(r, ks + q + 4);
        av[mi][3] = a_at(r + 8, ks + q + 4);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn + 8 * ni + g;
        bv[ni][0] = b_at(ks + q, c);
        bv[ni][1] = b_at(ks + q + 4, c);
      }
      uint32_t ab[2][4], bb[4][2];  // TF32 values (stored rounded) / big
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ab[mi][e] = MODE == TF32 ? __float_as_uint(av[mi][e])
                                   : tf32_bits(av[mi][e]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bb[ni][e] = MODE == TF32 ? __float_as_uint(bv[ni][e])
                                   : tf32_bits(bv[ni][e]);
      if (MODE == TF32X3) {
        uint32_t as[2][4], bs[4][2];  // the small parts
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            as[mi][e] = tf32_bits(av[mi][e] - __uint_as_float(ab[mi][e]));
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            bs[ni][e] = tf32_bits(bv[ni][e] - __uint_as_float(bb[ni][e]));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            mma_tf32(part[mi][ni], as[mi], bb[ni]);
            mma_tf32(part[mi][ni], ab[mi], bs[ni]);
            mma_tf32(part[mi][ni], ab[mi], bb[ni]);
          }
      } else {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_tf32(part[mi][ni], ab[mi], bb[ni]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], part[mi][ni][e]);
  };

  // the (segment, k step) pairs of the tile, in order
  int s = seg_ptr[tile];
  const int s1 = seg_ptr[tile + 1];
  int kb = 0, k1 = 0;
  if (s < s1) {
    kb = segs[2 * s];
    k1 = segs[2 * s + 1];
    load(kb, k1);
  }
  while (s < s1) {
    __syncthreads();  // the previous step's products have read the tiles
    store();
    __syncthreads();
    kb += BK;
    if (kb >= k1 && ++s < s1) {
      kb = segs[2 * s];
      k1 = segs[2 * s + 1];
    }
    if (s < s1) load(kb, k1);  // in flight during this step's products
    compute();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + wm + 16 * mi + g + 8 * half;
      if (i >= rows_a) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + wn + 8 * ni + 2 * q + e;
          if (j >= cols_b) continue;
          E* dst = C + (long long)i * ldc + j;
          const float v = acc[mi][ni][2 * half + e];
          *dst = from_float<E>(accumulate ? to_float(*dst) + v : v);
        }
    }
}

// Column entry: blockIdx.x = Wc tile, blockIdx.y = T-row tile (indexes the
// segment table), blockIdx.z strides over planes.
template <int MODE, typename E>
__global__ void __launch_bounds__(THREADS) tc_col_kernel(
    const E* __restrict__ T, const E* __restrict__ x, E* __restrict__ y,
    const int* __restrict__ seg_ptr, const int* __restrict__ segs, int M,
    int K, int Wc, int planes, long long ldx, long long sx, long long ldy,
    long long sy, int accumulate) {
  __shared__ float As[BM * LDK];
  __shared__ float Bs[SMEM_B];
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  for (int p = blockIdx.z; p < planes; p += gridDim.z) {
    tile_product<MODE, false>(T, K, M, x + (long long)p * sx, ldx, Wc,
                              y + (long long)p * sy, ldy, accumulate, i0, j0,
                              seg_ptr, segs, blockIdx.y, As, Bs);
  }
}

// Row entry: blockIdx.x = tile of X rows, blockIdx.y = T-row tile (output
// columns; indexes the segment table).
template <int MODE, typename E>
__global__ void __launch_bounds__(THREADS) tc_row_kernel(
    const E* __restrict__ x, const E* __restrict__ T, E* __restrict__ y,
    const int* __restrict__ seg_ptr, const int* __restrict__ segs,
    long long R, int K, int Kout, long long ldx, long long ldy,
    int accumulate) {
  __shared__ float As[BM * LDK];
  __shared__ float Bs[SMEM_B];
  const long long r0 = (long long)blockIdx.x * BM;
  const int rows = (int)((R - r0) < BM ? (R - r0) : BM);
  tile_product<MODE, true>(x + r0 * ldx, ldx, rows, T, K, Kout, y + r0 * ldy,
                           ldy, accumulate, 0, blockIdx.y * BN, seg_ptr, segs,
                           blockIdx.y, As, Bs);
}

template <int MODE, typename E>
int launch_col(const void* T, const void* x, void* y, const void* seg_ptr,
               const void* segs, int M, int K, int Wc, int planes,
               long long ldx, long long sx, long long ldy, long long sy,
               int accumulate, cudaStream_t stream) {
  const int gz = planes < 65535 ? planes : 65535;
  dim3 grid((Wc + BN - 1) / BN, (M + BM - 1) / BM, gz);
  tc_col_kernel<MODE, E><<<grid, THREADS, 0, stream>>>(
      static_cast<const E*>(T), static_cast<const E*>(x), static_cast<E*>(y),
      static_cast<const int*>(seg_ptr), static_cast<const int*>(segs), M, K,
      Wc, planes, ldx, sx, ldy, sy, accumulate);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, typename E>
int launch_row(const void* x, const void* T, void* y, const void* seg_ptr,
               const void* segs, long long R, int K, int Kout, long long ldx,
               long long ldy, int accumulate, cudaStream_t stream) {
  dim3 grid((unsigned)((R + BM - 1) / BM), (Kout + BN - 1) / BN, 1);
  tc_row_kernel<MODE, E><<<grid, THREADS, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(T), static_cast<E*>(y),
      static_cast<const int*>(seg_ptr), static_cast<const int*>(segs), R, K,
      Kout, ldx, ldy, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int banded_tc_tile_rows() { return BM; }  // == BN: T-row tile height
int banded_tc_k_align() { return BK; }

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1's column entry in mode 0 (TF32), 1 (3xTF32) or 2 (bf16: T, x and y
// bf16; else fp32): y[p] (+)= T . x[p].
int banded_tc_col(const void* T, const void* x, void* y, const void* seg_ptr,
                  const void* segs, int M, int K, int Wc, int planes,
                  long long ldx, long long sx, long long ldy, long long sy,
                  int accumulate, int mode, void* stream) {
  if (M == 0 || Wc == 0 || planes == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case TF32:
      return launch_col<TF32, float>(T, x, y, seg_ptr, segs, M, K, Wc,
                                     planes, ldx, sx, ldy, sy, accumulate,
                                     st);
    case TF32X3:
      return launch_col<TF32X3, float>(T, x, y, seg_ptr, segs, M, K, Wc,
                                       planes, ldx, sx, ldy, sy, accumulate,
                                       st);
    case BF16:
      return launch_col<BF16, __nv_bfloat16>(T, x, y, seg_ptr, segs, M, K,
                                             Wc, planes, ldx, sx, ldy, sy,
                                             accumulate, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K1's row entry in the same modes: y (+)= x . T^T.
int banded_tc_row(const void* x, const void* T, void* y, const void* seg_ptr,
                  const void* segs, long long R, int K, int Kout,
                  long long ldx, long long ldy, int accumulate, int mode,
                  void* stream) {
  if (R == 0 || Kout == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case TF32:
      return launch_row<TF32, float>(x, T, y, seg_ptr, segs, R, K, Kout, ldx,
                                     ldy, accumulate, st);
    case TF32X3:
      return launch_row<TF32X3, float>(x, T, y, seg_ptr, segs, R, K, Kout,
                                       ldx, ldy, accumulate, st);
    case BF16:
      return launch_row<BF16, __nv_bfloat16>(x, T, y, seg_ptr, segs, R, K,
                                             Kout, ldx, ldy, accumulate, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
