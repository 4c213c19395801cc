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
//                 (M x K) . (K x Wc), planes over blockIdx.y, optional
//                 accumulate into Y (the inverse's summed column stage)
//   row entry:    Y (+)= X . T^T           with X viewed as (N*C*H) x K
//                 rows at a row stride, so a column slice of a wider
//                 tensor (the forward's z[..., go:go+gn]) is read in place,
//                 optional accumulate into Y (the inverse SWT's row merge
//                 of two bands)
//
// Bound: 2 nnz(T) columns FLOP at the 67 TFLOP/s of the CUDA cores (IEEE
// fp32 FMAs: the 'highest' precision level), or the bytes of X, T and Y
// at 3.35 TB/s, whichever is larger.  Counted on T's nonzeros, the short
// bands put most operators under the bytes; the dense ones (the ISWT's
// 256-sample pinv) are operation-bound.  The kernel itself computes every
// product of the tiles its segments cover, so on banded operators its
// floor is that covered work over 67 TFLOP/s.
//
// Design: a tiled fp32 SIMT GEMM fed by the staging of
// csrc/banded_pipe.cuh (cp.async, 16 or 4 bytes a copy by the wrapper's
// choice, into a ring of 3 stages of 32 values of k, one barrier a stage,
// T-row tiles fastest in the grid so a tile of X is read from HBM about
// once).  An output tile is 64 rows of T by 128 columns of a plane
// (column entry; 64 columns where a plane is that narrow or 128 would
// leave the card short of two waves of blocks: the wrapper chooses,
// ops/banded.py:_col_tile, and counts each) or 128
// rows of X by 64 rows of T (row entry); 128 threads each hold an 8 x 8
// micro-tile of accumulators (8 x 4 in the narrow column tile).  For each
// group of 4 values of k a thread reads its 8 rows of A as float4 along k
// ([i][k] tiles, padded to 36 words a row) and its 8 columns of B as
// float4 (along j in the column entry's [k][j] tile, along k in the row
// entry's [j][k] tile): 16 shared loads of 16 bytes feed 256 FMAs (12
// feed 128 in the narrow tile), and the next group's fragments are loaded
// while this group's FMAs run (two register buffers).  Shared reads are
// conflict-free: a quarter-warp reads one A row (a broadcast) and 8
// consecutive float4 of a [k][j] row or 8 consecutive [j][k] rows 36
// words apart.  The epilogue stores coalesced
// rows: float4 in the column entry where the output allows (scalar
// otherwise), and in the row entry 8 consecutive columns per
// quarter-warp; with accumulate it reads every output it adds to before
// it stores any, so the reads overlap.  Tile skipping: a tile of T with
// no segment does no work (and writes zeros, or nothing under
// accumulate).
//
// Instantiations: 16-byte copies (128- or 64-column tiles in the column
// entry) where T, x and their strides are 16-byte aligned, which every
// call of the main paths is (main, train_main, banded, scat_j2, swt_main:
// row widths and the forward's slices at multiples of 4 elements); 4-byte
// copies for other views (odd widths and offsets, K = 45 in the tests).
// chip_smoke.py's path lines count which instantiation each call took.
#include <cuda_runtime.h>

#include "banded_pipe.cuh"

namespace {

using namespace banded;

// The tile geometry of an entry (ROW: the row entry; XW: the column
// entry's tile width, 128 or 64 columns of a plane).  A is the
// k-contiguous operand ([i][k]: T for the column entry, x for the row
// entry); B is x's [k][j] tile (column entry) or T's [j][k] tile (row
// entry).  Threads form a TY x TXS grid, each an 8 x MC micro-tile: 8 x
// 8, or 8 x 4 in the narrow column tile (so it runs four warps, not two).
template <bool ROW, int XW = TX>
struct Shape {
  static constexpr int BM = ROW ? TX : TT;
  static constexpr int BN = ROW ? TT : XW;
  static constexpr int MC = !ROW && XW == 64 ? 4 : 8;
  static constexpr int TY = BM / 8, TXS = BN / MC;
  static constexpr int THREADS = TY * TXS;
  static constexpr int LDA = BK + 4;
  static constexpr int LDB = ROW ? BK + 4 : BN;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE = A_ELEMS + (ROW ? BN : BK) * LDB;
  static constexpr int STAGES = 3;
  static constexpr int SMEM = STAGES * STAGE * 4;
};

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One output tile C[i0:i0+BM, j0:j0+BN] (+)= sum over the tile's segments
// of A[i, k] * B[k, j].  A(i, k) = A[i*lda + k]; B(k, j) = B[k*ldb + j]
// (column entry) or B[j*ldb + k] (row entry).
template <bool ROW, int COPY, int XW>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ A, long long lda, int rows_a,
    const float* __restrict__ B, long long ldb, int cols_b,
    float* __restrict__ C, long long ldc, int accumulate, int vec4, int i0,
    int j0, const int* __restrict__ seg_ptr, const int* __restrict__ segs,
    int tile, float* smem) {
  using S = Shape<ROW, XW>;
  constexpr int LDA = S::LDA, LDB = S::LDB, TXS = S::TXS, MC = S::MC;
  constexpr int HB = MC / 4;   // float4 of a thread in a [k][j] tile row
  const int tid = threadIdx.x, ty = tid / TXS, tx = tid % TXS;
  float acc[8][MC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < MC; ++c) acc[r][c] = 0.f;

  auto load = [&](int slot, int kb, int k1) {
    float* sa = smem + slot * S::STAGE;
    float* sb = sa + S::A_ELEMS;
    load_tile<float, COPY, S::BM, BK, LDA, S::THREADS>(
        sa, A + static_cast<long long>(i0) * lda + kb, lda, rows_a - i0,
        k1 - kb);
    if constexpr (ROW) {
      load_tile<float, COPY, S::BN, BK, LDB, S::THREADS>(
          sb, B + static_cast<long long>(j0) * ldb + kb, ldb, cols_b - j0,
          k1 - kb);
    } else {
      load_tile<float, COPY, BK, S::BN, LDB, S::THREADS>(
          sb, B + static_cast<long long>(kb) * ldb + j0, ldb, k1 - kb,
          cols_b - j0);
    }
  };

  auto compute = [&](int slot) {
    const float* sa = smem + slot * S::STAGE + ty * 8 * LDA;
    const float* sb = smem + slot * S::STAGE + S::A_ELEMS;
    // fragments of one group of 4 values of k: a[r] = A(row r, k..k+3);
    // b[kk * HB + h] = B(k + kk, 4 columns) (column entry) or
    // b[c] = B(k..k+3, column c) (row entry)
    constexpr int NB = ROW ? 8 : 4 * HB;
    auto frag = [&](int k, float4 (&a)[8], float4 (&b)[8]) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
        a[r] = *reinterpret_cast<const float4*>(sa + r * LDA + k);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const float* p =
            ROW ? sb + (tx + TXS * c) * LDB + k
                : sb + (k + c / HB) * LDB + tx * 4 + (c % HB) * TXS * 4;
        b[c] = *reinterpret_cast<const float4*>(p);
      }
    };
    float4 fa[2][8], fb[2][8];
    frag(0, fa[0], fb[0]);
#pragma unroll
    for (int grp = 0; grp < BK / 4; ++grp) {
      if (grp + 1 < BK / 4) frag(4 * (grp + 1), fa[(grp + 1) & 1],
                                 fb[(grp + 1) & 1]);
      const float4 (&a)[8] = fa[grp & 1];
      const float4 (&b)[8] = fb[grp & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float av = at(a[r], kk);
#pragma unroll
          for (int c = 0; c < MC; ++c) {
            const float bv = ROW ? at(b[c], kk)
                                 : at(b[kk * HB + c / 4], c % 4);
            acc[r][c] = fmaf(av, bv, acc[r][c]);
          }
        }
    }
  };

  const int steps = run_ring<S::STAGES>(Steps<BK>(seg_ptr, segs, tile),
                                        load, compute);
  if (steps == 0 && accumulate) return;  // a zero tile of T adds nothing

  // The epilogue's columns: j0 + tx + TXS c (row entry: 8 consecutive a
  // quarter-warp) or j0 + tx*4 + TXS*4 h + 0..3, h < HB (column entry, as
  // float4 where the output allows).  With accumulate, every read comes first,
  // so the reads overlap.
  if (accumulate) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + ty * 8 + r;
      if (i >= rows_a) continue;
      const float* row = C + static_cast<long long>(i) * ldc;
      if constexpr (ROW) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = j0 + tx + TXS * c;
          if (j < cols_b) acc[r][c] = row[j] + acc[r][c];
        }
      } else {
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          const int j = j0 + tx * 4 + h * TXS * 4;
          if (vec4 && j + 3 < cols_b) {
            const float4 o = *reinterpret_cast<const float4*>(row + j);
            acc[r][4 * h] = o.x + acc[r][4 * h];
            acc[r][4 * h + 1] = o.y + acc[r][4 * h + 1];
            acc[r][4 * h + 2] = o.z + acc[r][4 * h + 2];
            acc[r][4 * h + 3] = o.w + acc[r][4 * h + 3];
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (j + c < cols_b)
                acc[r][4 * h + c] = row[j + c] + acc[r][4 * h + c];
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + ty * 8 + r;
    if (i >= rows_a) continue;
    float* row = C + static_cast<long long>(i) * ldc;
    if constexpr (ROW) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = j0 + tx + TXS * c;
        if (j < cols_b) row[j] = acc[r][c];
      }
    } else {
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        const int j = j0 + tx * 4 + h * TXS * 4;
        if (vec4 && j + 3 < cols_b) {
          *reinterpret_cast<float4*>(row + j) =
              make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                          acc[r][4 * h + 3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (j + c < cols_b) row[j + c] = acc[r][4 * h + c];
        }
      }
    }
  }
}

// Column entry: blockIdx.x = (X-column tile, T-row tile), T-row tiles
// fastest; blockIdx.y strides over planes.
template <int COPY, int XW>
__global__ void __launch_bounds__(Shape<false, XW>::THREADS)
    banded_apply_col_kernel(const float* __restrict__ T,
                            const float* __restrict__ x,
                            float* __restrict__ y,
                            const int* __restrict__ seg_ptr,
                            const int* __restrict__ segs, int M, int K,
                            int Wc, int planes, long long ldx, long long sx,
                            long long ldy, long long sy, int accumulate,
                            int vec4) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int n_t = (M + TT - 1) / TT;
  const int tile = static_cast<int>(blockIdx.x % n_t);
  const int i0 = tile * TT, j0 = static_cast<int>(blockIdx.x / n_t) * XW;
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    tile_product<false, COPY, XW>(
        T, K, M, x + static_cast<long long>(p) * sx, ldx, Wc,
        y + static_cast<long long>(p) * sy, ldy, accumulate, vec4, i0, j0,
        seg_ptr, segs, tile, smem);
  }
}

// Row entry: blockIdx.x = (tile of X rows, T-row tile = output columns),
// T-row tiles fastest.
template <int COPY>
__global__ void __launch_bounds__(Shape<true>::THREADS)
    banded_apply_row_kernel(const float* __restrict__ x,
                            const float* __restrict__ T,
                            float* __restrict__ y,
                            const int* __restrict__ seg_ptr,
                            const int* __restrict__ segs, long long R, int K,
                            int Kout, long long ldx, long long ldy,
                            int accumulate) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int n_t = (Kout + TT - 1) / TT;
  const int tile = static_cast<int>(blockIdx.x % n_t);
  const long long r0 = static_cast<long long>(blockIdx.x / n_t) * TX;
  const int rows = static_cast<int>((R - r0) < TX ? (R - r0) : TX);
  tile_product<true, COPY, TX>(x + r0 * ldx, ldx, rows, T, K, Kout,
                               y + r0 * ldy, ldy, accumulate, 0, 0, tile * TT,
                               seg_ptr, segs, tile, smem);
}

template <int COPY, int XW>
int launch_col(const void* T, const void* x, void* y, const void* seg_ptr,
               const void* segs, int M, int K, int Wc, int planes,
               long long ldx, long long sx, long long ldy, long long sy,
               int accumulate, cudaStream_t stream) {
  using S = Shape<false, XW>;
  static unsigned done = 0;
  auto kernel = banded_apply_col_kernel<COPY, XW>;
  cudaError_t e = allow_smem(kernel, S::SMEM, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec4 = aligned(y, 4, 16, ldy, sy);
  kernel<<<grid_of((M + TT - 1) / TT, (Wc + XW - 1) / XW, planes),
           S::THREADS, S::SMEM, stream>>>(
      static_cast<const float*>(T), static_cast<const float*>(x),
      static_cast<float*>(y), static_cast<const int*>(seg_ptr),
      static_cast<const int*>(segs), M, K, Wc, planes, ldx, sx, ldy, sy,
      accumulate, vec4);
  return static_cast<int>(cudaGetLastError());
}

template <int COPY>
int launch_row(const void* x, const void* T, void* y, const void* seg_ptr,
               const void* segs, long long R, int K, int Kout, long long ldx,
               long long ldy, int accumulate, cudaStream_t stream) {
  using S = Shape<true>;
  static unsigned done = 0;
  auto kernel = banded_apply_row_kernel<COPY>;
  cudaError_t e = allow_smem(kernel, S::SMEM, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid_of((Kout + TT - 1) / TT, (R + TX - 1) / TX, 1), S::THREADS,
           S::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(T),
      static_cast<float*>(y), static_cast<const int*>(seg_ptr),
      static_cast<const int*>(segs), R, K, Kout, ldx, ldy, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int banded_apply_tile_rows() { return TT; }  // T rows a segment-table tile
int banded_apply_k_align() { return K_ALIGN; }

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y[p] (+)= T . x[p]; T (M x K) row-major; x[p] (K x Wc) at row stride ldx,
// plane stride sx; y[p] (M x Wc) at row stride ldy, plane stride sy;
// staged by copies of `copy` bytes (16 or 4), in output tiles `cols`
// columns wide (TX, or 64 with 16-byte copies: the wrapper's choice,
// ops/banded.py:_col_tile).
int banded_apply_col(const void* T, const void* x, void* y,
                     const void* seg_ptr, const void* segs, int M, int K,
                     int Wc, int planes, long long ldx, long long sx,
                     long long ldy, long long sy, int accumulate, int copy,
                     int cols, void* stream) {
  if (M == 0 || Wc == 0 || planes == 0) return 0;
  if ((copy != 16 && copy != 4) || !aligned(T, 4, copy, K) ||
      !aligned(x, 4, copy, ldx, sx))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (cols != TX && !(cols == 64 && copy == 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols == 64)
    return launch_col<16, 64>(T, x, y, seg_ptr, segs, M, K, Wc, planes, ldx,
                              sx, ldy, sy, accumulate, st);
  return copy == 16
             ? launch_col<16, TX>(T, x, y, seg_ptr, segs, M, K, Wc, planes,
                                  ldx, sx, ldy, sy, accumulate, st)
             : launch_col<4, TX>(T, x, y, seg_ptr, segs, M, K, Wc, planes,
                                 ldx, sx, ldy, sy, accumulate, st);
}

// y (+)= x . T^T; x (R x K) at row stride ldx; T (Kout x K) row-major;
// y (R x Kout) at row stride ldy; copies of `copy` bytes.
int banded_apply_row(const void* x, const void* T, void* y,
                     const void* seg_ptr, const void* segs, long long R,
                     int K, int Kout, long long ldx, long long ldy,
                     int accumulate, int copy, void* stream) {
  if (R == 0 || Kout == 0) return 0;
  if ((copy != 16 && copy != 4) || !aligned(T, 4, copy, K) ||
      !aligned(x, 4, copy, ldx))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return copy == 16 ? launch_row<16>(x, T, y, seg_ptr, segs, R, K, Kout, ldx,
                                     ldy, accumulate, st)
                    : launch_row<4>(x, T, y, seg_ptr, segs, R, K, Kout, ldx,
                                    ldy, accumulate, st);
}

}  // extern "C"
