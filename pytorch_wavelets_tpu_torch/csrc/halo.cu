// K19 halo: the on-card halves of the ring halo exchange of a spatially
// sharded tile (parallel/halo.py).
//
// Replaces pytorch_wavelets_tpu/parallel/halo.py:halo_exchange_1d (l.23),
// which the TPU runs as two lax.ppermute rings, two edge slices, a flip
// and a select at the global edge, and a concatenate.  Here the ring is
// one torch.distributed.batch_isend_irecv of contiguous buffers (NCCL, or
// gloo through pinned host memory), and the three passes around it are
// this kernel's three entries:
//
// - halo_pack: the tile's last `tail` and first `head` samples along the
//   axis, for every other index, into two contiguous blocks (the ring's
//   send buffers: the tail goes to the right neighbour, the head to the
//   left one).  The backward packs the window cotangent's halos the same
//   way (its right halo as the tail, its left halo as the head).
// - halo_assemble: the (left + tile + right)-wide window, written through
//   its strides (a slice of a wider window for multi-block operators):
//   each halo from the received block, or at the global edge the flipped
//   own edge ('symmetric') or zeros.
// - halo_fold: the adjoint.  The window cotangent's tile part, plus the
//   flipped cotangent of a 'symmetric' edge halo, plus the halo
//   cotangents received back from the neighbours, added into the edge
//   samples they were sent from, in that order (the plain version's).
//
// A tile is a 4-D (n0, n1, n2, n3) view at any strides; the axis is 2 or
// 3.  Seen along the axis it is (P, L, Q): P the product of the dims
// before the axis, L its length, Q the dims after it (1 along W, n3
// along H).  A block of width k is a contiguous (P, k, Q) run.
//
// Bound: bytes (pack: reads and writes the halos; assemble: reads the
// tile and the halos, writes the window; fold: reads the window and the
// received halos, writes the tile).  A first, simple kernel: one thread
// an output element, a grid-stride loop, 64-bit indices, the offset of a
// strided element by two or three divisions.  fp32 and bf16 (elem.cuh):
// the copies move the element type as it is; the fold sums in float and
// rounds once.
#include <cuda_runtime.h>

#include <cstdint>

#include "elem.cuh"

namespace {

constexpr int H_THREADS = 256;
constexpr long long H_MAX_BLOCKS = 1LL << 20;

// a halo's source (parallel/halo.py:SRC): the ring, the flipped own edge,
// zeros
enum Src { SRC_RECV = 0, SRC_FLIP = 1, SRC_ZERO = 2 };

struct View {
  long long n1, n2, n3;        // the dims after the first
  long long s0, s1, s2, s3;    // strides, in elements
  int axis;                    // 2 or 3
};

// the offset of element (p, j, q) of the (P, L, Q) view along the axis
__device__ __forceinline__ long long offset(const View& v, long long p,
                                            long long j, long long q) {
  if (v.axis == 3) {
    const long long i2 = p % v.n2;
    const long long t = p / v.n2;
    return (t / v.n1) * v.s0 + (t % v.n1) * v.s1 + i2 * v.s2 + j * v.s3;
  }
  return (p / v.n1) * v.s0 + (p % v.n1) * v.s1 + j * v.s2 + q * v.s3;
}

long long grid_of(long long total) {
  const long long b = (total + H_THREADS - 1) / H_THREADS;
  return b < H_MAX_BLOCKS ? b : H_MAX_BLOCKS;
}

template <typename E>
__global__ void pack_kernel(const E* __restrict__ x, E* __restrict__ tail_out,
                            E* __restrict__ head_out, View v, long long L,
                            long long Q, int tail, int head,
                            long long total) {
  const long long n_tail = total / (tail + head) * tail;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const bool is_tail = e < n_tail;
    const long long r = is_tail ? e : e - n_tail;
    const int k = is_tail ? tail : head;
    const long long q = r % Q;
    const long long pj = r / Q;
    const long long j = pj % k;
    const long long p = pj / k;
    const E val = x[offset(v, p, is_tail ? L - tail + j : j, q)];
    (is_tail ? tail_out : head_out)[r] = val;
  }
}

template <typename E>
__global__ void assemble_kernel(const E* __restrict__ x,
                                const E* __restrict__ recv_l,
                                const E* __restrict__ recv_r,
                                E* __restrict__ out, View v, View o,
                                long long L, long long Q, int left, int right,
                                int lsrc, int rsrc, long long total) {
  const long long Lw = left + L + right;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long q = e % Q;
    const long long pj = e / Q;
    const long long j = pj % Lw;
    const long long p = pj / Lw;
    E val;
    if (j < left) {
      if (lsrc == SRC_RECV)
        val = recv_l[(p * left + j) * Q + q];
      else if (lsrc == SRC_FLIP)
        val = x[offset(v, p, left - 1 - j, q)];
      else
        val = from_float<E>(0.0f);
    } else if (j < left + L) {
      val = x[offset(v, p, j - left, q)];
    } else {
      const long long jj = j - left - L;
      if (rsrc == SRC_RECV)
        val = recv_r[(p * right + jj) * Q + q];
      else if (rsrc == SRC_FLIP)
        val = x[offset(v, p, L - 1 - jj, q)];
      else
        val = from_float<E>(0.0f);
    }
    out[offset(o, p, j, q)] = val;
  }
}

// from_l: the left neighbour's cotangent of its right halo (my head,
// `right` wide); from_r: the right neighbour's of its left halo (my tail,
// `left` wide)
template <typename E>
__global__ void fold_kernel(const E* __restrict__ gw,
                            const E* __restrict__ from_l,
                            const E* __restrict__ from_r,
                            E* __restrict__ dx, View g, long long L,
                            long long Q, int left, int right, int lsrc,
                            int rsrc, long long total) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long q = e % Q;
    const long long pj = e / Q;
    const long long j = pj % L;
    const long long p = pj / L;
    float acc = to_float(gw[offset(g, p, left + j, q)]);
    if (lsrc == SRC_FLIP && j < left)
      acc += to_float(gw[offset(g, p, left - 1 - j, q)]);
    if (rsrc == SRC_FLIP && j >= L - right)
      acc += to_float(gw[offset(g, p, left + L + (L - 1 - j), q)]);
    if (lsrc == SRC_RECV && j < right)
      acc += to_float(from_l[(p * right + j) * Q + q]);
    if (rsrc == SRC_RECV && j >= L - left)
      acc += to_float(from_r[(p * left + (j - (L - left))) * Q + q]);
    dx[e] = from_float<E>(acc);
  }
}

View view_of(long long n1, long long n2, long long n3, long long s0,
             long long s1, long long s2, long long s3, int axis) {
  return View{n1, n2, n3, s0, s1, s2, s3, axis};
}

// (P, L, Q) of an (n0, n1, n2, n3) tile along the axis
void plq(long long n0, long long n1, long long n2, long long n3, int axis,
         long long* P, long long* L, long long* Q) {
  *P = axis == 3 ? n0 * n1 * n2 : n0 * n1;
  *L = axis == 3 ? n3 : n2;
  *Q = axis == 3 ? 1 : n3;
}

bool bad(int axis, int a, int b, int c, int d) {
  return (axis != 2 && axis != 3) || a < 0 || b < 0 || c < 0 || c > 2 ||
         d < 0 || d > 2;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: the (n0, n1, n2, n3) tile at strides s0..s3; tail_out / head_out:
// contiguous (P, tail, Q) / (P, head, Q) blocks.
int halo_pack(const void* x, void* tail_out, void* head_out, long long n0,
              long long n1, long long n2, long long n3, long long s0,
              long long s1, long long s2, long long s3, int axis, int tail,
              int head, int bf16, void* stream) {
  if (bad(axis, tail, head, 0, 0)) return cudaErrorInvalidValue;
  long long P, L, Q;
  plq(n0, n1, n2, n3, axis, &P, &L, &Q);
  if (tail > L || head > L) return cudaErrorInvalidValue;
  const long long total = P * Q * (tail + head);
  if (total == 0) return 0;
  const View v = view_of(n1, n2, n3, s0, s1, s2, s3, axis);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid_of(total));
  if (bf16)
    pack_kernel<__nv_bfloat16><<<g, H_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(tail_out),
        static_cast<__nv_bfloat16*>(head_out), v, L, Q, tail, head, total);
  else
    pack_kernel<float><<<g, H_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(tail_out),
        static_cast<float*>(head_out), v, L, Q, tail, head, total);
  return static_cast<int>(cudaGetLastError());
}

// x: the tile at strides s0..s3; recv_l / recv_r: contiguous (P, left, Q)
// / (P, right, Q) received blocks (read only where that side's source is
// the ring); out: the (left + L + right)-wide window at strides o0..o3.
int halo_assemble(const void* x, const void* recv_l, const void* recv_r,
                  void* out, long long n0, long long n1, long long n2,
                  long long n3, long long s0, long long s1, long long s2,
                  long long s3, long long o0, long long o1, long long o2,
                  long long o3, int axis, int left, int right, int lsrc,
                  int rsrc, int bf16, void* stream) {
  if (bad(axis, left, right, lsrc, rsrc)) return cudaErrorInvalidValue;
  long long P, L, Q;
  plq(n0, n1, n2, n3, axis, &P, &L, &Q);
  if (left > L || right > L) return cudaErrorInvalidValue;
  const long long total = P * Q * (left + L + right);
  if (total == 0) return 0;
  const View v = view_of(n1, n2, n3, s0, s1, s2, s3, axis);
  const View o = view_of(n1, axis == 2 ? n2 + left + right : n2, n3, o0, o1,
                         o2, o3, axis);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid_of(total));
  if (bf16)
    assemble_kernel<__nv_bfloat16><<<g, H_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(recv_l),
        static_cast<const __nv_bfloat16*>(recv_r),
        static_cast<__nv_bfloat16*>(out), v, o, L, Q, left, right, lsrc,
        rsrc, total);
  else
    assemble_kernel<float><<<g, H_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(recv_l),
        static_cast<const float*>(recv_r), static_cast<float*>(out), v, o, L,
        Q, left, right, lsrc, rsrc, total);
  return static_cast<int>(cudaGetLastError());
}

// gw: the window cotangent at strides g0..g3 (its tile's sizes n0..n3,
// the axis `left + L + right` long); from_l / from_r: contiguous
// (P, right, Q) / (P, left, Q) received blocks (read only where that
// side's source is the ring); dx: the contiguous tile.
int halo_fold(const void* gw, const void* from_l, const void* from_r,
              void* dx, long long n0, long long n1, long long n2,
              long long n3, long long g0, long long g1, long long g2,
              long long g3, int axis, int left, int right, int lsrc, int rsrc,
              int bf16, void* stream) {
  if (bad(axis, left, right, lsrc, rsrc)) return cudaErrorInvalidValue;
  long long P, L, Q;
  plq(n0, n1, n2, n3, axis, &P, &L, &Q);
  if (left > L || right > L) return cudaErrorInvalidValue;
  const long long total = P * L * Q;
  if (total == 0) return 0;
  const View g = view_of(n1, axis == 2 ? n2 + left + right : n2, n3, g0, g1,
                         g2, g3, axis);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned b = static_cast<unsigned>(grid_of(total));
  if (bf16)
    fold_kernel<__nv_bfloat16><<<b, H_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(gw),
        static_cast<const __nv_bfloat16*>(from_l),
        static_cast<const __nv_bfloat16*>(from_r),
        static_cast<__nv_bfloat16*>(dx), g, L, Q, left, right, lsrc, rsrc,
        total);
  else
    fold_kernel<float><<<b, H_THREADS, 0, st>>>(
        static_cast<const float*>(gw), static_cast<const float*>(from_l),
        static_cast<const float*>(from_r), static_cast<float*>(dx), g, L, Q,
        left, right, lsrc, rsrc, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
