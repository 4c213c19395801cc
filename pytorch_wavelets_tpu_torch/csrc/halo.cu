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
// - halo_pack: each tile's last `tail` and first `head` samples along the
//   axis, for every other index, into two contiguous blocks (the ring's
//   send buffers: the tail goes to the right neighbour, the head to the
//   left one).  The backward packs the window cotangent's halos the same
//   way (its right halo as the tail, its left halo as the head).
// - halo_assemble: each (left + tile + right)-wide window, written through
//   its strides (the windows of several parts side by side along the
//   axis): each halo from the received block, or at the global edge the
//   flipped own edge ('symmetric') or zeros.
// - halo_fold: the adjoint.  The window cotangent's tile part, plus the
//   flipped cotangent of a 'symmetric' edge halo, plus the halo
//   cotangents received back from the neighbours, added into the edge
//   samples they were sent from, in that order (the plain version's).
//
// A tile is a 4-D (n0, n1, n2, n3) view at any strides; the axis is 2 or
// 3.  Seen along the axis it is (P, L, Q): P the product of the dims
// before the axis, L its length, Q the dims after it (1 along W, n3
// along H).  A block of width k is a contiguous (P, k, Q) run.  One
// launch takes a table of up to 8 parts by value (the column blocks of a
// multi-block operator: tiles that differ only in L), so an exchange is
// one pack and one assemble or one fold, whatever its parts.
//
// Bound: bytes (pack: reads and writes the halos; assemble: reads the
// tile and the halos, writes the window; fold: reads the window and the
// received halos, writes the tile); at the main path's tiles the launch
// too.  The design walks rows, not elements, and divides nowhere: along W
// a row is one (n0, n1, n2) line (of the window, of the tile cotangent,
// or a tile's edge run for pack), along H one line of n3 samples of an
// (n0, n1) plane (a window row, a tile row, a halo row).  A block of 128
// threads holds rows of one plane of one part: the plane (i0, i1) from
// blockIdx.z and .y, the part and the row from blockIdx.x and the
// thread.  A row's LPR lanes (4-32, a power of two the host picks so that
// each lane has at least LANE_CHUNKS 16-byte chunks where the row has as
// many) walk it side by side.  A row is a few terms: ranges of its
// positions that copy (pack, assemble) or add (fold, in the plain
// version's order) a source at a step of +-1 (a flip) or the row's
// stride, or zeros.  Two walks, which the C entries pick and return:
//
// - vector: every strided operand (the tile; the window of assemble and
//   fold) has unit stride along W.  A lane takes one 16-byte line of the
//   destination row (4 fp32 or 8 bf16 samples) and stores it with one
//   16-byte store.  Where one term copies the whole line (the tile of an
//   assemble's W row, a pack's or an assemble's H row) the line is one
//   run of it, loaded 16, 8 or 4 bytes at a time as the source address
//   allows; any other line (a halo, a fold's sums, a line a term's edge
//   cuts) reads each term that covers it whole as such a run (reversed
//   in registers for a flip) and the rest sample by sample.  A row's
//   samples before its first whole line and after its last are stored
//   in 8-, 4- and 2-byte pieces, wherever the row starts: the second
//   part's window beside the first (the inverse's [lo | hi] merges start
//   8 bytes into a line), rows at a pitch off the lines (bf16 windows of
//   148 samples), pack's send blocks and the fold's tile cotangent along
//   W (rows of `tail` or L samples).
// - strided: any other view (transposed, a strided slice along W): the
//   same row walk, a sample a lane, through the strides.
//
// Offsets are 64-bit products.  fp32 and bf16 (elem.cuh): the copies move
// the element type as it is; the fold sums in float and rounds once.
#include <cuda_runtime.h>

#include <cstdint>

#include "elem.cuh"

namespace {

constexpr int H_THREADS = 128;
constexpr int MAX_PARTS = 8;
constexpr int MAX_GRID_YZ = 65535;
constexpr int LANE_CHUNKS = 4;   // the chunks of a row a lane aims at

// a halo's source (parallel/halo.py:SRC): the ring, the flipped own edge,
// zeros
enum Src { SRC_RECV = 0, SRC_FLIP = 1, SRC_ZERO = 2 };
// the walks (ops/halo.py:HALO_WALKS)
enum Walk { WALK_VECTOR = 0, WALK_STRIDED = 1 };
enum Op { OP_PACK = 0, OP_ASSEMBLE = 1, OP_FOLD = 2 };

}  // namespace

// One part of a launch, as the wrapper passes it (ops/halo.py:_Part).
struct HaloPart {
  const void* x;     // the tile (pack, assemble) or window cotangent (fold)
  void* y;           // pack: tail block; assemble: window; fold: dx
  void* y2;          // pack: head block
  const void* rl;    // assemble: recv_l; fold: from_l (contiguous)
  const void* rr;    // assemble: recv_r; fold: from_r (contiguous)
  long long xs[4];   // x's strides, in elements
  long long ys[4];   // assemble: the window's strides
  long long L;       // the tile's length along the axis
};

namespace {

struct Table {
  HaloPart part[MAX_PARTS];
  int first[MAX_PARTS + 1];   // each part's first blockIdx.x
  int rows[MAX_PARTS];        // its rows a plane
  int nparts;
  int n0, n1;                 // dims 0 and 1 (a plane is an (i0, i1))
  int n2;                     // along W: the rows of a plane
  int n3;                     // along H: the length of a row
  int axis, a, b, lsrc, rsrc; // pack: a = tail, b = head; else left, right
  int lpr_log2;               // lanes a row
};

// positions [a, b) of a row take src[(j - a) * step] (src == nullptr:
// zeros)
template <typename E>
struct Term {
  const E* src;
  long long step;
  int a, b;
};

template <typename E>
struct alignas(16) Chunk {
  E e[16 / sizeof(E)];
};

// V consecutive samples from p, as wide as p's alignment allows
template <typename E, int V>
__device__ __forceinline__ void load_run(const E* p, Chunk<E>& c) {
  if constexpr (V == 1) {
    c.e[0] = *p;
  } else {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if ((a & 15) == 0) {
      *reinterpret_cast<uint4*>(c.e) = *reinterpret_cast<const uint4*>(p);
    } else if ((a & 7) == 0) {
      const uint2* q = reinterpret_cast<const uint2*>(p);
      uint2* d = reinterpret_cast<uint2*>(c.e);
      d[0] = q[0];
      d[1] = q[1];
    } else if ((a & 3) == 0) {
      const unsigned* q = reinterpret_cast<const unsigned*>(p);
      unsigned* d = reinterpret_cast<unsigned*>(c.e);
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = q[k];
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) c.e[k] = p[k];
    }
  }
}

// The V positions j0.. of a row (those in [0, n)): each the copy (pack,
// assemble: the terms partition the row) or the ordered sum (fold: term
// 0 covers the row) of its terms.
template <typename E, int V, bool SUM, int NT>
__device__ __forceinline__ void gather(int j0, const Term<E> (&T)[NT],
                                       Chunk<E>& v) {
  float acc[V];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const Term<E>& u = T[t];
    const int lo = max(j0, u.a), hi = min(j0 + V, u.b);
    if (lo >= hi) continue;
    const bool whole = lo == j0 && hi == j0 + V;
    Chunk<E> r;
    if (u.src && whole && (u.step == 1 || u.step == -1)) {
      // the whole chunk from one run (reversed for a flip)
      load_run<E, V>(u.src + (u.step == 1 ? j0 - u.a : u.a - j0 - V + 1), r);
      if (u.step == -1) {
#pragma unroll
        for (int k = 0; k < V / 2; ++k) {
          const E s = r.e[k];
          r.e[k] = r.e[V - 1 - k];
          r.e[V - 1 - k] = s;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = j0 + k;
        if (j >= lo && j < hi)
          r.e[k] = u.src ? u.src[(j - u.a) * u.step] : from_float<E>(0.0f);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = j0 + k;
      if (!whole && (j < lo || j >= hi)) continue;
      if constexpr (SUM) {
        if (t == 0)
          acc[k] = to_float(r.e[k]);
        else
          acc[k] += to_float(r.e[k]);
      } else {
        v.e[k] = r.e[k];
      }
    }
  }
  if constexpr (SUM) {
#pragma unroll
    for (int k = 0; k < V; ++k) v.e[k] = from_float<E>(acc[k]);
  }
}

// Store positions j0.. of v that lie in [0, n): a whole 16-byte line at
// once; a partial line (a row's head or tail) by its 8-, 4- or 2-byte
// pieces that lie wholly inside.
template <typename E, int V>
__device__ __forceinline__ void put(E* dst, long long dst_step, int j0, int n,
                                    const Chunk<E>& v) {
  if constexpr (V == 1) {
    if (j0 >= 0 && j0 < n) dst[j0 * dst_step] = v.e[0];
  } else {
    if (j0 >= 0 && j0 + V <= n) {
      *reinterpret_cast<uint4*>(dst + j0) =
          *reinterpret_cast<const uint4*>(v.e);
      return;
    }
    const int klo = max(0, -j0), khi = min(V, n - j0);
    constexpr int P8 = 8 / sizeof(E), P4 = 4 / sizeof(E);
#pragma unroll
    for (int u = 0; u < V; u += P8) {
      if (u >= klo && u + P8 <= khi) {
        *reinterpret_cast<uint2*>(dst + j0 + u) =
            *reinterpret_cast<const uint2*>(v.e + u);
        continue;
      }
#pragma unroll
      for (int w = u; w < u + P8; w += P4) {
        if (w >= klo && w + P4 <= khi) {
          *reinterpret_cast<unsigned*>(dst + j0 + w) =
              *reinterpret_cast<const unsigned*>(v.e + w);
          continue;
        }
#pragma unroll
        for (int k = w; k < w + P4; ++k)
          if (k >= klo && k < khi) dst[j0 + k] = v.e[k];
      }
    }
  }
}

// One row of n positions of dst (at dst_step; 1 on the vector walk).  The
// row's lanes walk its chunks, V positions a chunk, the first chunk
// shifted back so that every other one starts on a 16-byte line.  Inside
// [plo, phi) the row is a copy of term d alone (the tile of an assemble's
// W row, a pack's or an assemble's H row whole): a chunk there is one run
// of d; any other goes through gather.
template <typename E, int V, bool SUM, int NT>
__device__ __forceinline__ void walk_row(E* dst, long long dst_step, int n,
                                         const Term<E> (&T)[NT],
                                         const Term<E>& d, int plo, int phi,
                                         int lane, int lpr) {
  int m = 0;
  if constexpr (V > 1)
    m = static_cast<int>((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(E));
  if (!d.src || (V > 1 && d.step != 1)) phi = plo;
  const int chunks = (n + m + V - 1) / V;
  for (int c = lane; c < chunks; c += lpr) {
    const int j0 = c * V - m;
    Chunk<E> v;
    if (j0 >= plo && j0 + V <= phi) {
      if constexpr (V == 1)
        v.e[0] = d.src[(j0 - d.a) * d.step];
      else
        load_run<E, V>(d.src + (j0 - d.a), v);
    } else {
      gather<E, V, SUM, NT>(j0, T, v);
    }
    put<E, V>(dst, dst_step, j0, n, v);
  }
}

template <typename E>
__device__ __forceinline__ void set(Term<E>& t, const E* src, long long step,
                                    int a, int b) {
  t.src = src;
  t.step = step;
  t.a = a;
  t.b = b;
}

// a halo term of assemble: positions [a, a + k) from the received row
// (recv), the tile's flipped edge starting at `flip` (flip) or zeros
template <typename E>
__device__ __forceinline__ void halo_term(Term<E>& t, int src, const E* recv,
                                          const E* flip, long long xstep,
                                          int a, int k) {
  if (src == SRC_RECV)
    set(t, recv, 1, a, a + k);
  else if (src == SRC_FLIP)
    set(t, flip, -xstep, a, a + k);
  else
    set<E>(t, nullptr, 0, a, a + k);
}

template <typename E, int V, int OP>
__global__ void __launch_bounds__(H_THREADS)
    halo_kernel(const __grid_constant__ Table t) {
  const int bx = blockIdx.x;
  int part = 0;
  while (part + 1 < t.nparts && bx >= t.first[part + 1]) ++part;
  const HaloPart& P = t.part[part];
  const int lpr = 1 << t.lpr_log2;
  const int row = (bx - t.first[part]) * (H_THREADS >> t.lpr_log2) +
                  static_cast<int>(threadIdx.x >> t.lpr_log2);
  if (row >= t.rows[part]) return;
  const int lane = threadIdx.x & (lpr - 1);
  const int L = static_cast<int>(P.L);
  const int a = t.a, b = t.b;
  const E* x = static_cast<const E*>(P.x);
  const long long* xs = P.xs;
  for (int i0 = blockIdx.z; i0 < t.n0; i0 += gridDim.z) {
    for (int i1 = blockIdx.y; i1 < t.n1; i1 += gridDim.y) {
      const int q = i0 * t.n1 + i1;   // the plane's index in the blocks
      const E* xp = x + i0 * xs[0] + i1 * xs[1];   // the plane of x
      // the terms of a row: pack 1, assemble 3 (1 along H), fold 5
      constexpr int NT = OP == OP_FOLD ? 5 : (OP == OP_ASSEMBLE ? 3 : 1);
      Term<E> T[NT];
#pragma unroll
      for (int k = 0; k < NT; ++k) set<E>(T[k], nullptr, 0, 0, 0);
      E* dst;
      int n;
      long long dst_step = 1;
      if (t.axis == 3) {   // the row: one W line of the plane
        if constexpr (OP == OP_PACK) {
          const int tail_rows = a ? t.n2 : 0;
          const bool is_tail = row < tail_rows;
          const int i2 = is_tail ? row : row - tail_rows;
          const long long p = static_cast<long long>(q) * t.n2 + i2;
          const E* xr = xp + i2 * xs[2];
          n = is_tail ? a : b;
          dst = static_cast<E*>(is_tail ? P.y : P.y2) + p * n;
          set(T[0], xr + (is_tail ? L - a : 0) * xs[3], xs[3], 0, n);
        } else if constexpr (OP == OP_ASSEMBLE) {
          const long long p = static_cast<long long>(q) * t.n2 + row;
          const E* xr = xp + row * xs[2];
          n = a + L + b;
          dst = static_cast<E*>(P.y) + i0 * P.ys[0] + i1 * P.ys[1] +
                row * P.ys[2];
          dst_step = P.ys[3];
          halo_term(T[0], t.lsrc, static_cast<const E*>(P.rl) + p * a,
                    xr + (a - 1) * xs[3], xs[3], 0, a);
          set(T[1], xr, xs[3], a, a + L);
          halo_term(T[2], t.rsrc, static_cast<const E*>(P.rr) + p * b,
                    xr + (L - 1) * xs[3], xs[3], a + L, b);
        } else {   // fold: x is the window cotangent
          const long long p = static_cast<long long>(q) * t.n2 + row;
          const E* g = xp + row * xs[2];
          const long long gs = xs[3];
          n = L;
          dst = static_cast<E*>(P.y) + p * L;
          set(T[0], g + a * gs, gs, 0, L);
          if (t.lsrc == SRC_FLIP) set(T[1], g + (a - 1) * gs, -gs, 0, a);
          if (t.rsrc == SRC_FLIP)
            set(T[2], g + (a + L + b - 1) * gs, -gs, L - b, L);
          if (t.lsrc == SRC_RECV)
            set(T[3], static_cast<const E*>(P.rl) + p * b, 1, 0, b);
          if (t.rsrc == SRC_RECV)
            set(T[4], static_cast<const E*>(P.rr) + p * a, 1, L - a, L);
        }
      } else {   // the row: one line of n3 samples along W of the plane
        n = t.n3;
        const long long qq = q;
        if constexpr (OP == OP_PACK) {
          const bool is_tail = row < a;
          const int j = is_tail ? row : row - a;
          const int k = is_tail ? a : b;
          dst = static_cast<E*>(is_tail ? P.y : P.y2) + (qq * k + j) * n;
          set(T[0], xp + (is_tail ? L - a + j : j) * xs[2], xs[3], 0, n);
        } else if constexpr (OP == OP_ASSEMBLE) {
          const int j = row;
          dst = static_cast<E*>(P.y) + i0 * P.ys[0] + i1 * P.ys[1] +
                j * P.ys[2];
          dst_step = P.ys[3];
          if (j < a)
            halo_term(T[0], t.lsrc,
                      static_cast<const E*>(P.rl) + (qq * a + j) * n,
                      xp + (a - 1 - j) * xs[2], -xs[3], 0, n);
          else if (j < a + L)
            set(T[0], xp + (j - a) * xs[2], xs[3], 0, n);
          else
            halo_term(T[0], t.rsrc,
                      static_cast<const E*>(P.rr) + (qq * b + j - a - L) * n,
                      xp + (2 * L + a - 1 - j) * xs[2], -xs[3], 0, n);
        } else {   // fold
          const int j = row;
          dst = static_cast<E*>(P.y) + (qq * L + j) * n;
          set(T[0], xp + (a + j) * xs[2], xs[3], 0, n);
          if (t.lsrc == SRC_FLIP && j < a)
            set(T[1], xp + (a - 1 - j) * xs[2], xs[3], 0, n);
          if (t.rsrc == SRC_FLIP && j >= L - b)
            set(T[2], xp + (a + 2 * L - 1 - j) * xs[2], xs[3], 0, n);
          if (t.lsrc == SRC_RECV && j < b)
            set(T[3], static_cast<const E*>(P.rl) + (qq * b + j) * n, 1, 0,
                n);
          if (t.rsrc == SRC_RECV && j >= L - a)
            set(T[4],
                static_cast<const E*>(P.rr) + (qq * a + j - (L - a)) * n, 1,
                0, n);
        }
      }
      // the run of the row that one term copies alone (none for the fold:
      // its sums go through gather)
      Term<E> d = T[0];
      int plo = 0, phi = OP == OP_FOLD ? 0 : n;
      if constexpr (OP == OP_ASSEMBLE) {
        if (t.axis == 3) {
          d = T[1];
          plo = a;
          phi = a + L;
        }
      }
      walk_row<E, V, OP == OP_FOLD, NT>(dst, dst_step, n, T, d, plo, phi,
                                        lane, lpr);
    }
  }
}

// unit stride along W (a dim of one sample has no stride to keep)
bool vector_view(const long long* n, const long long* s) {
  return n[3] == 1 || s[3] == 1;
}

// lanes a row: a power of two in 4-32, the most that leave each lane at
// least LANE_CHUNKS chunks
int lpr_log2_for(long long chunks) {
  int lg = 2;
  while (lg < 5 && (LANE_CHUNKS << (lg + 1)) <= chunks) ++lg;
  return lg;
}

template <int OP>
int launch(const HaloPart* parts, int nparts, long long n0, long long n1,
           long long n2, long long n3, int axis, int a, int b, int lsrc,
           int rsrc, int bf16, int* walk, void* stream) {
  if (nparts < 1 || nparts > MAX_PARTS || (axis != 2 && axis != 3) ||
      a < 0 || b < 0 || lsrc < 0 || lsrc > 2 || rsrc < 0 || rsrc > 2)
    return cudaErrorInvalidValue;
  const long long lim = 1LL << 30;
  if (n0 * n1 > lim || n2 > lim || n3 > lim) return cudaErrorInvalidValue;
  const int esize = bf16 ? 2 : 4;
  Table t;
  t.nparts = nparts;
  t.n0 = static_cast<int>(n0);
  t.n1 = static_cast<int>(n1);
  t.n2 = static_cast<int>(n2);
  t.n3 = static_cast<int>(n3);
  t.axis = axis;
  t.a = a;
  t.b = b;
  t.lsrc = lsrc;
  t.rsrc = rsrc;
  bool vec = true;
  long long row_len = 0;
  for (int i = 0; i < nparts; ++i) {
    const HaloPart& p = parts[i];
    const long long L = p.L;
    if (L < 0 || L > lim || a > L || b > L) return cudaErrorInvalidValue;
    t.part[i] = p;
    long long dims[4] = {n0, n1, n2, n3};
    dims[axis] = OP == OP_FOLD ? a + L + b : L;
    vec = vec && vector_view(dims, p.xs);
    if (OP == OP_ASSEMBLE) {
      dims[axis] = a + L + b;
      vec = vec && vector_view(dims, p.ys);
    }
    long long rows, len;
    if (axis == 3) {
      rows = OP == OP_PACK ? ((a ? n2 : 0) + (b ? n2 : 0)) : n2;
      len = OP == OP_PACK ? (a > b ? a : b)
                          : (OP == OP_ASSEMBLE ? a + L + b : L);
    } else {
      rows = OP == OP_PACK ? a + b : (OP == OP_ASSEMBLE ? a + L + b : L);
      len = n3;
    }
    if (rows > lim) return cudaErrorInvalidValue;
    t.rows[i] = static_cast<int>(rows);
    row_len = len > row_len ? len : row_len;
  }
  *walk = vec ? WALK_VECTOR : WALK_STRIDED;
  const int v = vec ? 16 / esize : 1;
  // a row whose length is off the 16-byte lines may start off them too,
  // and take one more chunk
  t.lpr_log2 = lpr_log2_for((row_len + v - 1) / v + (row_len % v ? 1 : 0));
  const long long rpb = H_THREADS >> t.lpr_log2;
  long long total = 0;
  for (int i = 0; i < nparts; ++i) {
    t.first[i] = static_cast<int>(total);
    total += (t.rows[i] + rpb - 1) / rpb;
  }
  t.first[nparts] = static_cast<int>(total);
  if (total == 0 || n0 * n1 == 0 || row_len == 0) return 0;
  if (total > (1LL << 31) - 1) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(total),
                  static_cast<unsigned>(n1 < MAX_GRID_YZ ? n1 : MAX_GRID_YZ),
                  static_cast<unsigned>(n0 < MAX_GRID_YZ ? n0 : MAX_GRID_YZ));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (vec)
      halo_kernel<__nv_bfloat16, 8, OP><<<grid, H_THREADS, 0, st>>>(t);
    else
      halo_kernel<__nv_bfloat16, 1, OP><<<grid, H_THREADS, 0, st>>>(t);
  } else {
    if (vec)
      halo_kernel<float, 4, OP><<<grid, H_THREADS, 0, st>>>(t);
    else
      halo_kernel<float, 1, OP><<<grid, H_THREADS, 0, st>>>(t);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each entry: `parts` a host array of `nparts` (1-8) HaloPart; n0..n3
// the parts' sizes (dim `axis` is each part's L); `walk` receives the
// walk taken (WALK_VECTOR / WALK_STRIDED).  Blocks are contiguous
// (P, k, Q) runs.
//
// pack: x the tile; y / y2 its (P, tail, Q) / (P, head, Q) blocks.
int halo_pack(const HaloPart* parts, int nparts, long long n0, long long n1,
              long long n2, long long n3, int axis, int tail, int head,
              int lsrc, int rsrc, int bf16, int* walk, void* stream) {
  return launch<OP_PACK>(parts, nparts, n0, n1, n2, n3, axis, tail, head,
                         lsrc, rsrc, bf16, walk, stream);
}

// assemble: x the tile; rl / rr its (P, left, Q) / (P, right, Q)
// received blocks (read only where that side's source is the ring); y the
// (left + L + right)-wide window at strides ys.
int halo_assemble(const HaloPart* parts, int nparts, long long n0,
                  long long n1, long long n2, long long n3, int axis,
                  int left, int right, int lsrc, int rsrc, int bf16,
                  int* walk, void* stream) {
  return launch<OP_ASSEMBLE>(parts, nparts, n0, n1, n2, n3, axis, left,
                             right, lsrc, rsrc, bf16, walk, stream);
}

// fold: x the window cotangent (the axis `left + L + right` long); rl /
// rr the (P, right, Q) / (P, left, Q) blocks received back (from_l /
// from_r; read only where that side's source is the ring); y the
// contiguous (P, L, Q) tile cotangent.
int halo_fold(const HaloPart* parts, int nparts, long long n0, long long n1,
              long long n2, long long n3, int axis, int left, int right,
              int lsrc, int rsrc, int bf16, int* walk, void* stream) {
  return launch<OP_FOLD>(parts, nparts, n0, n1, n2, n3, axis, left, right,
                         lsrc, rsrc, bf16, walk, stream);
}

}  // extern "C"
