// K17 banded_apply_tc: K1's operator product (csrc/banded_apply.cu) on
// the tensor cores, in the arithmetic of the matmul precision level and
// the data's type (ops/precision.py):
//
//   mode 0, TF32   ("default", fp32 data): each operand rounded to TF32
//                  (cvt.rna.tf32.f32, nearest, ties away from zero) as its
//                  fragment is read, mma.sync m16n8k8 .tf32 with an fp32
//                  accumulator;
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
// (seg_ptr/segs: banded::TT rows of T a tile, segment starts multiples
// of banded::K_ALIGN), the same column and row entries, plane, row and
// column strides, and accumulate, and the copy width the wrapper chose.
//
// Bound: 2 nnz(T) columns FLOP over 495 TFLOP/s (TF32; three times the
// work for 3xTF32) or 989 TFLOP/s (bf16), or the bytes of X, T and Y
// over 3.35 TB/s, whichever is larger.  The operators are short-banded,
// so counted on T's nonzeros the bytes bound the ideal kernel at every
// measured shape but the ISWT's dense pinv in 3xTF32 (operation-bound).
//
// Design.  The staging of csrc/banded_pipe.cuh: each operand is staged in
// its own type (bf16 tiles are bf16 in shared memory; fp32 tiles fp32,
// rounded to TF32 when a fragment is read), by cp.async into a ring of 3
// stages of 32 values of k in fp32 and 64 in bf16 (about 80 KB a block
// either way: the deeper bf16 stage halves the fold and the barriers per
// MMA), one barrier a stage.  An output tile is 64 rows of T by 128
// columns of a plane (column entry) or 128 rows of X by 64 rows of T (row
// entry).  The column entry runs eight warps of 32 x 32 m16n8
// accumulators (at most 128 registers a thread, two blocks a
// multiprocessor), the row entry four warps of 64 x 32 (no spill at 255
// registers, each A fragment feeding 4 MMAs): timed side by side on the
// card on scat_j2's, swt_main's and main's products, each layout was the
// faster one in its entry.  Fragments come from ldmatrix: A ([i][k],
// k-contiguous) always; B of the row entry ([j][k], T's rows) by
// ldmatrix; B of the column entry ([k][j], x's rows) by ldmatrix.trans in
// bf16, and in TF32 by 32-bit shared reads of a tile padded to a row
// stride of 136 words (8 mod 32: the 32 lanes of a fragment read hit 32
// banks).  Rounding each staged value once instead, in shared memory by
// the thread that copied it once its copies landed (before the stage's
// barrier), was timed on the card and was slower on every TF32 product
// of the main, banded and scat_j2 paths: the pass sits
// between the copies' wait and the barrier, where every warp waits,
// while conversions at fragment reads overlap the MMAs.  The A and
// [j][k] tiles are padded by 16 bytes a row (144 or 80 bytes: the eight
// rows of an 8x8 ldmatrix hit distinct banks), the
// bf16 [k][j] tile to 272 bytes.  Blocks are ordered with the tiles of T
// fastest, so the T-row tiles that read one tile of X run together and
// find it in L2 (X is read from HBM about once, not once per tile of T).
// With accumulate the epilogue reads every output it adds to before it
// stores any, so the reads overlap.
//
// The IEEE fold.  The tensor cores do not round their fp32 accumulation to
// nearest: an accumulator that took every product of a long contraction
// drifts from the IEEE sum (by ~5e-5 relative at K = 2048 in 3xTF32).  So
// each stage's products (32 deep in fp32, 64 in bf16) go to a zeroed
// partial, which one IEEE fp32 add (__fadd_rn) folds into the sum.
//
// Why mma.sync and not wgmma.  wgmma reads B from shared memory, and in
// .tf32 both operands must be K-major: the column entry's x tile is
// j-contiguous, so its TF32 and 3xTF32 modes cannot take wgmma without a
// transpose in shared memory.  The row entry, and bf16 in either layout,
// could; but the MMA instruction does not set the time here.  In bf16 the
// products are bytes-bound; in TF32 the issue slots go to what surrounds
// the MMAs: cvt.rna.tf32.f32 compiles to four instructions a value on
// sm_90a (its NaN test, the rounding add, the mask, a select) and each
// fragment value is converted as it is read, then the fold's adds.
// wgmma would remove neither, so one mma.sync design serves all six
// entry-mode pairs.
//
// Instantiations by copy width (banded_pipe.cuh): 16-byte cp.async where
// T, x and their strides are 16-byte aligned: every call of the main
// paths (main, train_main, scat_j2 and the precision phases: row widths
// and the forward's slices z[..., go:go + gn] at multiples of 32
// elements); 4-byte cp.async for fp32 and even-offset bf16 views that are
// not (odd widths, K = 45 in the tests); plain 2-byte loads for a bf16
// view at an odd element offset.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "banded_pipe.cuh"
#include "elem.cuh"

namespace {

using namespace banded;

enum { TF32 = 0, TF32X3 = 1, BF16 = 2 };

template <int MODE>
using Elem = std::conditional_t<MODE == BF16, __nv_bfloat16, float>;

// The tile geometry of an entry (ROW: the row entry) in a mode.  A is the
// k-contiguous operand (T for the column entry, x for the row entry), B
// the other; the output tile is BM x BN.
template <int MODE, bool ROW>
struct Shape {
  using E = Elem<MODE>;
  static constexpr int BM = ROW ? TX : TT;
  static constexpr int BN = ROW ? TT : TX;
  // warp tiles: 32 x 32 in the column entry (eight warps, two blocks a
  // multiprocessor), 64 x 32 in the row entry (four warps)
  static constexpr int WARPS_M = ROW ? 2 : TT / 32;
  static constexpr int WARPS_N = ROW ? TT / 32 : 4;
  static constexpr int MIN_BLOCKS = ROW ? 1 : 2;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int KS = MODE == BF16 ? 2 * BK : BK;  // stage depth
  static constexpr int PAD = 16 / static_cast<int>(sizeof(E));
  static constexpr int LDA = KS + PAD;                    // [i][k]
  static constexpr int LDB = ROW ? KS + PAD : BN + 8;     // [j][k] / [k][j]
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE = A_ELEMS + (ROW ? BN : KS) * LDB;
  static constexpr int STAGES = 3;
  static constexpr int SMEM = STAGES * STAGE * static_cast<int>(sizeof(E));
  static_assert(NI % 2 == 0, "B fragments come in pairs");
};

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 matrices of 16-bit elements (for fp32 data: 8 rows of 4
// words), row addresses from lanes 0-7, 8-15, 16-23, 24-31.
__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

// Two adjacent outputs dst[0], dst[1] (the second if `two`), read (add2:
// added to v0, v1 in fp32) or written (store2: rounded once to E), as one
// 8-byte (fp32) or 4-byte (bf16) access where `vec` says the address
// allows.
template <typename E>
__device__ __forceinline__ void add2(const E* src, float& v0, float& v1,
                                     bool two, bool vec) {
  if (two && vec) {
    if constexpr (sizeof(E) == 4) {
      const float2 c = *reinterpret_cast<const float2*>(src);
      v0 = c.x + v0;
      v1 = c.y + v1;
    } else {
      const float2 c = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(src));
      v0 = c.x + v0;
      v1 = c.y + v1;
    }
    return;
  }
  v0 = to_float(src[0]) + v0;
  if (two) v1 = to_float(src[1]) + v1;
}

template <typename E>
__device__ __forceinline__ void store2(E* dst, float v0, float v1, bool two,
                                       bool vec) {
  if (two && vec) {
    if constexpr (sizeof(E) == 4)
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  dst[0] = from_float<E>(v0);
  if (two) dst[1] = from_float<E>(v1);
}

// One output tile C[i0:i0+BM, j0:j0+BN] (+)= sum over the tile's segments
// of A[i, k] * B[k, j].  A is k-contiguous: A(i, k) = A[i*lda + k].  B is
// j-contiguous for the column entry (B(k, j) = B[k*ldb + j]) and
// k-contiguous for the row entry (B(k, j) = B[j*ldb + k]).
template <int MODE, bool ROW, int COPY>
__device__ __forceinline__ void tile_product(
    const Elem<MODE>* __restrict__ A, long long lda, int rows_a,
    const Elem<MODE>* __restrict__ B, long long ldb, int cols_b,
    Elem<MODE>* __restrict__ C, long long ldc, int accumulate, int pairs,
    int i0, int j0, const int* __restrict__ seg_ptr,
    const int* __restrict__ segs, int tile, Elem<MODE>* smem) {
  using S = Shape<MODE, ROW>;
  using E = typename S::E;
  constexpr int MI = S::MI, NI = S::NI, LDA = S::LDA, LDB = S::LDB;
  constexpr int KS = S::KS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / S::WARPS_N) * S::WM;
  const int wn = (warp % S::WARPS_N) * S::WN;
  const int g = lane >> 2, q = lane & 3;
  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  auto load = [&](int slot, int kb, int k1) {
    E* sa = smem + slot * S::STAGE;
    E* sb = sa + S::A_ELEMS;
    load_tile<E, COPY, S::BM, KS, LDA, S::THREADS>(
        sa, A + static_cast<long long>(i0) * lda + kb, lda, rows_a - i0,
        k1 - kb);
    if constexpr (ROW) {
      load_tile<E, COPY, S::BN, KS, LDB, S::THREADS>(
          sb, B + static_cast<long long>(j0) * ldb + kb, ldb, cols_b - j0,
          k1 - kb);
    } else {
      load_tile<E, COPY, KS, S::BN, LDB, S::THREADS>(
          sb, B + static_cast<long long>(kb) * ldb + j0, ldb, k1 - kb,
          cols_b - j0);
    }
  };

  auto compute = [&](int slot) {
    const E* sa = smem + slot * S::STAGE;
    const E* sb = sa + S::A_ELEMS;
    float part[MI][NI][4];  // this stage's products (the IEEE fold)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
    if constexpr (MODE == BF16) {
#pragma unroll
      for (int ks = 0; ks < KS; ks += 16) {
        uint32_t a[MI][4], b[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldsm_x4(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                  sa + (wm + 16 * mi + (lane & 15)) * LDA + ks +
                      (lane >> 4) * 8);
#pragma unroll
        for (int ni = 0; ni < NI; ni += 2) {
          if constexpr (ROW) {
            ldsm_x4(b[ni][0], b[ni][1], b[ni + 1][0], b[ni + 1][1],
                    sb + (wn + 8 * ni + (lane & 7) + ((lane >> 4) << 3)) *
                             LDB +
                        ks + ((lane >> 3) & 1) * 8);
          } else {
            ldsm_x4_trans(b[ni][0], b[ni][1], b[ni + 1][0], b[ni + 1][1],
                          sb + (ks + (lane & 15)) * LDB + wn + 8 * ni +
                              (lane >> 4) * 8);
          }
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            mma_bf16(part[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ks += 8) {
        uint32_t a[MI][4], b[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldsm_x4(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                  sa + (wm + 16 * mi + (lane & 15)) * LDA + ks +
                      (lane >> 4) * 4);
#pragma unroll
        for (int ni = 0; ni < NI; ni += 2) {
          if constexpr (ROW) {
            ldsm_x4(b[ni][0], b[ni][1], b[ni + 1][0], b[ni + 1][1],
                    sb + (wn + 8 * ni + (lane & 7) + ((lane >> 4) << 3)) *
                             LDB +
                        ks + ((lane >> 3) & 1) * 4);
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float* col = sb + wn + 8 * (ni + h) + g;
              b[ni + h][0] = __float_as_uint(col[(ks + q) * LDB]);
              b[ni + h][1] = __float_as_uint(col[(ks + q + 4) * LDB]);
            }
          }
        }
        if constexpr (MODE == TF32) {
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              a[mi][e] = tf32_bits(__uint_as_float(a[mi][e]));
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              b[ni][e] = tf32_bits(__uint_as_float(b[ni][e]));
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
              mma_tf32(part[mi][ni], a[mi], b[ni][0], b[ni][1]);
        } else {
          uint32_t as[MI][4], bs[NI][2];  // big in a / b, small in as / bs
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = __uint_as_float(a[mi][e]);
              a[mi][e] = tf32_bits(v);
              as[mi][e] = tf32_bits(v - __uint_as_float(a[mi][e]));
            }
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = __uint_as_float(b[ni][e]);
              b[ni][e] = tf32_bits(v);
              bs[ni][e] = tf32_bits(v - __uint_as_float(b[ni][e]));
            }
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
              mma_tf32(part[mi][ni], as[mi], b[ni][0], b[ni][1]);
              mma_tf32(part[mi][ni], a[mi], bs[ni][0], bs[ni][1]);
              mma_tf32(part[mi][ni], a[mi], b[ni][0], b[ni][1]);
            }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], part[mi][ni][e]);
  };

  const int steps = run_ring<S::STAGES>(Steps<KS>(seg_ptr, segs, tile),
                                        load, compute);
  if (steps == 0 && accumulate) return;  // a zero tile of T adds nothing

  // With accumulate, every read comes first, so the reads overlap.
  if (accumulate) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + wm + 16 * mi + g + 8 * half;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int j = j0 + wn + 8 * ni + 2 * q;
          if (i < rows_a && j < cols_b)
            add2(C + static_cast<long long>(i) * ldc + j,
                 acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1],
                 j + 1 < cols_b, pairs);
        }
      }
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + wm + 16 * mi + g + 8 * half;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int j = j0 + wn + 8 * ni + 2 * q;
        if (i < rows_a && j < cols_b)
          store2(C + static_cast<long long>(i) * ldc + j,
                 acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1],
                 j + 1 < cols_b, pairs);
      }
    }
}

// Column entry: blockIdx.x = (X-column tile, T-row tile), T-row tiles
// fastest; blockIdx.y strides over planes.
template <int MODE, int COPY>
__global__ void __launch_bounds__(Shape<MODE, false>::THREADS,
                                  Shape<MODE, false>::MIN_BLOCKS)
    tc_col_kernel(const Elem<MODE>* __restrict__ T,
                  const Elem<MODE>* __restrict__ x, Elem<MODE>* __restrict__ y,
                  const int* __restrict__ seg_ptr,
                  const int* __restrict__ segs, int M, int K, int Wc,
                  int planes, long long ldx, long long sx, long long ldy,
                  long long sy, int accumulate, int pairs) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Elem<MODE>* smem = reinterpret_cast<Elem<MODE>*>(smem_raw);
  const int n_t = (M + TT - 1) / TT;
  const int tile = static_cast<int>(blockIdx.x % n_t);
  const int i0 = tile * TT, j0 = static_cast<int>(blockIdx.x / n_t) * TX;
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    tile_product<MODE, false, COPY>(
        T, K, M, x + static_cast<long long>(p) * sx, ldx, Wc,
        y + static_cast<long long>(p) * sy, ldy, accumulate, pairs, i0, j0,
        seg_ptr, segs, tile, smem);
  }
}

// Row entry: blockIdx.x = (tile of X rows, T-row tile = output columns),
// T-row tiles fastest.
template <int MODE, int COPY>
__global__ void __launch_bounds__(Shape<MODE, true>::THREADS,
                                  Shape<MODE, true>::MIN_BLOCKS)
    tc_row_kernel(const Elem<MODE>* __restrict__ x,
                  const Elem<MODE>* __restrict__ T, Elem<MODE>* __restrict__ y,
                  const int* __restrict__ seg_ptr,
                  const int* __restrict__ segs, long long R, int K, int Kout,
                  long long ldx, long long ldy, int accumulate, int pairs) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Elem<MODE>* smem = reinterpret_cast<Elem<MODE>*>(smem_raw);
  const int n_t = (Kout + TT - 1) / TT;
  const int tile = static_cast<int>(blockIdx.x % n_t);
  const long long r0 = static_cast<long long>(blockIdx.x / n_t) * TX;
  const int rows = static_cast<int>((R - r0) < TX ? (R - r0) : TX);
  tile_product<MODE, true, COPY>(x + r0 * ldx, ldx, rows, T, K, Kout,
                                 y + r0 * ldy, ldy, accumulate, pairs, 0,
                                 tile * TT, seg_ptr, segs, tile, smem);
}

template <int MODE, int COPY>
int launch_col(const void* T, const void* x, void* y, const void* seg_ptr,
               const void* segs, int M, int K, int Wc, int planes,
               long long ldx, long long sx, long long ldy, long long sy,
               int accumulate, cudaStream_t stream) {
  using S = Shape<MODE, false>;
  using E = Elem<MODE>;
  static unsigned done = 0;
  auto kernel = tc_col_kernel<MODE, COPY>;
  cudaError_t e = allow_smem(kernel, S::SMEM, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pairs = aligned(y, sizeof(E), 2 * sizeof(E), ldy, sy);
  kernel<<<grid_of((M + TT - 1) / TT, (Wc + TX - 1) / TX, planes),
           S::THREADS, S::SMEM, stream>>>(
      static_cast<const E*>(T), static_cast<const E*>(x), static_cast<E*>(y),
      static_cast<const int*>(seg_ptr), static_cast<const int*>(segs), M, K,
      Wc, planes, ldx, sx, ldy, sy, accumulate, pairs);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, int COPY>
int launch_row(const void* x, const void* T, void* y, const void* seg_ptr,
               const void* segs, long long R, int K, int Kout, long long ldx,
               long long ldy, int accumulate, cudaStream_t stream) {
  using S = Shape<MODE, true>;
  using E = Elem<MODE>;
  static unsigned done = 0;
  auto kernel = tc_row_kernel<MODE, COPY>;
  cudaError_t e = allow_smem(kernel, S::SMEM, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pairs = aligned(y, sizeof(E), 2 * sizeof(E), ldy);
  kernel<<<grid_of((Kout + TT - 1) / TT, (R + TX - 1) / TX, 1), S::THREADS,
           S::SMEM, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(T), static_cast<E*>(y),
      static_cast<const int*>(seg_ptr), static_cast<const int*>(segs), R, K,
      Kout, ldx, ldy, accumulate, pairs);
  return static_cast<int>(cudaGetLastError());
}

// Whether `copy` bytes a copy fit T (row stride K) and x (the strides
// given): cudaErrorMisalignedAddress if not.
template <int MODE>
bool copy_fits(int copy, const void* T, int K, const void* x, long long s0,
               long long s1) {
  const int es = static_cast<int>(sizeof(Elem<MODE>));
  if (copy == 16 || copy == 4)
    return aligned(T, es, copy, K) && aligned(x, es, copy, s0, s1);
  return copy == 2 && es == 2;
}

template <int MODE>
int col_mode(int copy, const void* T, const void* x, void* y,
             const void* seg_ptr, const void* segs, int M, int K, int Wc,
             int planes, long long ldx, long long sx, long long ldy,
             long long sy, int accumulate, cudaStream_t st) {
  if (!copy_fits<MODE>(copy, T, K, x, ldx, sx))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (copy == 16)
    return launch_col<MODE, 16>(T, x, y, seg_ptr, segs, M, K, Wc, planes,
                                ldx, sx, ldy, sy, accumulate, st);
  if (copy == 4)
    return launch_col<MODE, 4>(T, x, y, seg_ptr, segs, M, K, Wc, planes, ldx,
                               sx, ldy, sy, accumulate, st);
  if constexpr (MODE == BF16)
    return launch_col<MODE, 2>(T, x, y, seg_ptr, segs, M, K, Wc, planes, ldx,
                               sx, ldy, sy, accumulate, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int MODE>
int row_mode(int copy, const void* x, const void* T, void* y,
             const void* seg_ptr, const void* segs, long long R, int K,
             int Kout, long long ldx, long long ldy, int accumulate,
             cudaStream_t st) {
  if (!copy_fits<MODE>(copy, T, K, x, ldx, 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (copy == 16)
    return launch_row<MODE, 16>(x, T, y, seg_ptr, segs, R, K, Kout, ldx, ldy,
                                accumulate, st);
  if (copy == 4)
    return launch_row<MODE, 4>(x, T, y, seg_ptr, segs, R, K, Kout, ldx, ldy,
                               accumulate, st);
  if constexpr (MODE == BF16)
    return launch_row<MODE, 2>(x, T, y, seg_ptr, segs, R, K, Kout, ldx, ldy,
                               accumulate, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int banded_tc_tile_rows() { return TT; }  // T rows a segment-table tile
int banded_tc_k_align() { return K_ALIGN; }

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1's column entry in mode 0 (TF32), 1 (3xTF32) or 2 (bf16: T, x and y
// bf16; else fp32): y[p] (+)= T . x[p], staged by copies of `copy` bytes
// (16, 4, or 2: plain loads, bf16 only).
int banded_tc_col(const void* T, const void* x, void* y, const void* seg_ptr,
                  const void* segs, int M, int K, int Wc, int planes,
                  long long ldx, long long sx, long long ldy, long long sy,
                  int accumulate, int mode, int copy, void* stream) {
  if (M == 0 || Wc == 0 || planes == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case TF32:
      return col_mode<TF32>(copy, T, x, y, seg_ptr, segs, M, K, Wc, planes,
                            ldx, sx, ldy, sy, accumulate, st);
    case TF32X3:
      return col_mode<TF32X3>(copy, T, x, y, seg_ptr, segs, M, K, Wc, planes,
                              ldx, sx, ldy, sy, accumulate, st);
    case BF16:
      return col_mode<BF16>(copy, T, x, y, seg_ptr, segs, M, K, Wc, planes,
                            ldx, sx, ldy, sy, accumulate, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K1's row entry in the same modes: y (+)= x . T^T.
int banded_tc_row(const void* x, const void* T, void* y, const void* seg_ptr,
                  const void* segs, long long R, int K, int Kout,
                  long long ldx, long long ldy, int accumulate, int mode,
                  int copy, void* stream) {
  if (R == 0 || Kout == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case TF32:
      return row_mode<TF32>(copy, x, T, y, seg_ptr, segs, R, K, Kout, ldx,
                            ldy, accumulate, st);
    case TF32X3:
      return row_mode<TF32X3>(copy, x, T, y, seg_ptr, segs, R, K, Kout, ldx,
                              ldy, accumulate, st);
    case BF16:
      return row_mode<BF16>(copy, x, T, y, seg_ptr, segs, R, K, Kout, ldx,
                            ldy, accumulate, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
