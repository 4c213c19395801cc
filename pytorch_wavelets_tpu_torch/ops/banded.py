"""Operator-matrix products for 1-D filterbank ops, and kernel K1.

Port of ``pytorch_wavelets_tpu/ops/banded.py``.  Each linear 1-D op
(q-shift decimation/interpolation, non-decimated filter, and their
compositions across levels) is a constant operator matrix T applied along
one spatial axis:  col op:  y[m, w] = sum_h T[m, h] x[h, w]
                   row op:  y[h, m] = sum_w T[m, w] x[h, w]

T is built on the host by *probing* the conv path with an identity image
(the ops are linear, so op(I) IS the operator matrix), in fp32 on the CPU.
On the device the product is kernel K1 (``csrc/banded_apply.cu``, IEEE
fp32) or, at the matmul precision levels "high" and "default" and on bf16
data, kernel K17 (``csrc/banded_apply_tc.cu``, the tensor cores in
3xTF32, TF32 or bf16: :func:`kernel_mode`).  Both skip the zero tiles of
T through one per-tile segment table (:func:`_band_plan`).  The plain
PyTorch versions are dense ``einsum``s: exact fp32 (the CPU path at every
level), and one per K17 mode that rounds as the mode does.
"""
from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from pytorch_wavelets_tpu_torch.ops import _cuda
from pytorch_wavelets_tpu_torch.ops.precision import (
    get_matmul_precision, plain_flags,
)

__all__ = ["apply_col", "apply_row", "apply_col_plain", "apply_row_plain",
           "kernel_mode", "K17_MODES",
           "Operator", "probe_op", "compose", "extend_wrap_operator",
           "extend_operator", "synthesized_or_probe", "content_key",
           "set_operator_matmul", "matmul_requested", "composed_enabled",
           "MAX_MATMUL_N", "MAX_OP_MATMUL_N", "DIRECT_PROBE_N"]

# Above this axis length the composed planners hand over to the per-level
# path (``transforms/dtcwt.py``).  The value is the JAX package's, kept so
# both packages take the composed path on the same shapes.
MAX_MATMUL_N = 8832

_FORCE = None   # None: auto; True / False: forced (set_operator_matmul)


def set_operator_matmul(enabled):
    """Force the operator-matmul (composed) path on or off; None = auto.

    The JAX package's switch, with its meaning on a device: auto and True
    take the composed whole-transform path wherever a plan exists (both
    axes at most ``MAX_MATMUL_N``, filters that are not bandpass-diagonal),
    and the per-level stencils (K8-K10) elsewhere; False takes the
    per-level path everywhere.  The port's per-level path always runs the
    stencils: the JAX package's per-level operator products are an MXU
    choice the port does not make."""
    global _FORCE
    _FORCE = enabled


def matmul_requested() -> bool:
    """Whether the composed operator path is wanted at all."""
    return _FORCE is None or bool(_FORCE)


def composed_enabled(n: int) -> bool:
    """Whether an axis of length ``n`` may take the composed path."""
    return matmul_requested() and n <= MAX_MATMUL_N


def compose(A, B):
    """Host-side operator composition A @ B, sparse above a size
    threshold: composed filterbank operators are banded, so the dense
    product wastes O(n^3) host FLOPs where the sparse product costs
    O(n * band^2).  Returns a dense ndarray."""
    if A.shape[1] >= 2048 or B.shape[1] >= 2048:
        from scipy import sparse
        out = (sparse.csr_matrix(A) @ sparse.csr_matrix(B)).toarray()
        return np.ascontiguousarray(out)
    return A @ B


# Per-level operators: above DIRECT_PROBE_N their matrices are synthesized
# from a small verified probe (extend_operator) instead of an O(n^2)
# identity probe.  The values are the JAX package's.
MAX_OP_MATMUL_N = 32768
DIRECT_PROBE_N = 4096


def synthesized_or_probe(direct_fn, n, ns, row_blocks, col_blocks, shift):
    """Matrix for length ``n``: direct probe when small, otherwise
    synthesized from a probe at ``ns`` via :func:`extend_operator`
    (falling back to the direct probe when the structure doesn't admit
    extension, e.g. odd lengths breaking the affine size relation)."""
    if n <= DIRECT_PROBE_N or ns >= n:
        return direct_fn(n)
    try:
        return extend_operator(direct_fn(ns), n, row_blocks, col_blocks,
                               shift)
    except ValueError:
        return direct_fn(n)


def extend_operator(T_small: np.ndarray, n_big: int, row_blocks: int,
                    col_blocks: int, shift) -> np.ndarray:
    """Synthesize a big filterbank operator from a small probe, any mode.

    All 1-D filterbank operators in this library are translation-invariant
    away from the axis ends: within each (row block, col block) pair, rows
    advance their band by ``a`` columns every ``p`` rows
    (``shift = (p, a)``; analysis (1, 2), non-decimated and a trous
    (1, 1), interpolating/synthesis (2, 1)).  Boundary handling — whether
    reflection folding, zero truncation, or periodization wrap-adds — only
    affects rows whose band reaches an axis end, and depends only on the
    distance to that end.

    Extension rule: rows matching the translation prediction (phase
    patterns read from the probe's middle rows) are re-anchored at
    ``n_big``'s scale; the remaining rows must form a contiguous top
    prefix / bottom suffix and are copied verbatim with each nonzero
    anchored to its nearer axis end (left-half columns keep their index,
    right-half columns shift by the axis growth — this maps periodization
    wrap-adds to the correct far columns too).  Exactness is guaranteed
    by construction because boundary rows see the identical edge
    geometry; validated against direct probes in the JAX package's
    tests/test_banded.py.

    Raises ValueError when the probe is too small to separate the
    boundary regions or the structure does not match ``shift``.
    """
    M_s, C_s = T_small.shape
    if M_s % row_blocks or C_s % col_blocks:
        raise ValueError("block structure does not divide the probe")
    m_s, c_s = M_s // row_blocks, C_s // col_blocks
    p, a = shift
    if ((n_big - c_s) * p) % a:
        raise ValueError("n_big incompatible with the shift structure")
    grow = ((n_big - c_s) * p) // a
    m_b, c_b = m_s + grow, n_big
    if m_b <= 0:
        raise ValueError("probe larger than target")
    tol = np.abs(T_small).max() * 1e-12
    out = np.zeros((row_blocks * m_b, col_blocks * c_b), T_small.dtype)
    for rb in range(row_blocks):
        for cb in range(col_blocks):
            B = T_small[rb * m_s:(rb + 1) * m_s,
                        cb * c_s:(cb + 1) * c_s]
            # phase patterns from the middle rows
            pats = {}
            for q in range(p):
                r0 = q + p * max(0, ((m_s // 2) - q) // p)
                anchor0 = a * ((r0 - q) // p)
                nz = np.nonzero(np.abs(B[r0]) > tol)[0]
                pats[q] = (nz - anchor0, B[r0][nz], r0)

            def predict(r, c_len):
                q = r % p
                offs, vals, _ = pats[q]
                cols = offs + a * ((r - q) // p)
                ok = (cols >= 0) & (cols < c_len)
                return cols, vals, bool(ok.all())

            interior = np.zeros(m_s, bool)
            for r in range(m_s):
                cols, vals, ok = predict(r, c_s)
                if not ok:
                    continue
                row = np.zeros(c_s, T_small.dtype)
                row[cols] = vals
                interior[r] = np.array_equal(row, B[r])
            if not interior.any():
                raise ValueError("probe too small: no interior rows")
            top = int(np.argmax(interior))              # first interior row
            bot = int(np.argmax(interior[::-1]))        # trailing boundary
            if not interior[top:m_s - bot].all():
                raise ValueError(
                    "boundary rows are not a contiguous prefix/suffix — "
                    "operator does not match the declared shift structure")
            half = c_s // 2
            dc = c_b - c_s

            def anchor_copy(r_src, r_dst):
                nz = np.nonzero(np.abs(B[r_src]) > tol)[0]
                left, right = nz[nz < half], nz[nz >= half]
                if left.size and right.size and \
                        int(right.min()) - int(left.max()) < c_s // 4:
                    raise ValueError(
                        "probe too small: a boundary row's band straddles "
                        "the column midpoint — use a larger small probe")
                cols = np.where(nz < half, nz, nz + dc)
                out[rb * m_b + r_dst, cb * c_b + cols] = B[r_src][nz]

            for r in range(top):                        # top boundary rows
                anchor_copy(r, r)
            for rr in range(bot):                       # bottom boundary
                anchor_copy(m_s - 1 - rr, m_b - 1 - rr)
            for r in range(top, m_b - bot):             # interior rows
                cols, vals, ok = predict(r, c_b)
                if not ok:
                    raise ValueError("probe too small: interior band "
                                     "escapes the axis")
                out[rb * m_b + r, cb * c_b + cols] = vals
    return out


def extend_wrap_operator(T_small: np.ndarray, n_big: int,
                         row_blocks: int, col_blocks: int) -> np.ndarray:
    """Synthesize a big wrap-mode (circulant) operator from a small probe.

    Wrap-mode (periodization / periodic) filterbank operators are
    block-circulant: within each (row block, col block) pair,
    ``T[r] == roll(T[0], a * r)`` with ``a = cols / rows`` of the block
    (2 for a decimating analysis, 1 for a trous, 1/2 per column for a
    synthesis merge).  The band pattern is length <= filter support,
    independent of the axis length — so probing at a small length and
    translating the band to ``n_big`` gives the EXACT big operator at
    O(support) cost instead of an O(n_big^2) identity probe.

    T_small: (row_blocks * m_s, col_blocks * c_s) verified probe.
    Circulant structure is checked exactly on the probe; a non-circulant
    operator raises ValueError.  Returns the
    (row_blocks * m_b, col_blocks * c_b) operator for ``n_big`` where
    m_b / c_b scale with n_big.
    """
    M_s, C_s = T_small.shape
    if M_s % row_blocks or C_s % col_blocks:
        raise ValueError("block structure does not divide the probe")
    m_s, c_s = M_s // row_blocks, C_s // col_blocks
    if c_s == 0 or m_s == 0:
        raise ValueError("empty probe block")
    # shift structure: every `p` rows the band advances `a` columns
    # (analysis: p=1, a=2; a trous: p=1, a=1; synthesis merge: p=2, a=1)
    if c_s % m_s == 0:
        p, a = 1, c_s // m_s
    elif m_s % c_s == 0:
        p, a = m_s // c_s, 1
    else:
        raise ValueError(f"unsupported block aspect {m_s}x{c_s}")
    if (m_s * n_big) % c_s:
        raise ValueError("n_big must scale the probe blocks integrally")
    m_b, c_b = m_s * n_big // c_s, n_big
    tol = np.abs(T_small).max() * 1e-12
    out = np.zeros((row_blocks * m_b, col_blocks * c_b), T_small.dtype)
    for rb in range(row_blocks):
        for cb in range(col_blocks):
            B = T_small[rb * m_s:(rb + 1) * m_s,
                        cb * c_s:(cb + 1) * c_s]
            for q in range(p):                # row-phase patterns
                base = B[q]
                nz = np.nonzero(np.abs(base) > tol)[0]
                if nz.size == 0:
                    continue
                offs = np.where(nz > c_s // 2, nz - c_s, nz)
                if offs.max() - offs.min() >= c_s - 2 * a:
                    raise ValueError(
                        "probe too small: band support wraps ambiguously"
                        " — use a larger small probe")
                # verify the circulant structure exactly on the probe
                for r in range(q, m_s, p):
                    if not np.array_equal(np.roll(base, a * ((r - q)
                                                             // p)), B[r]):
                        raise ValueError(
                            "operator block is not circulant — wrap-mode"
                            " extension only applies to periodic "
                            "operators")
                rows = np.arange(q, m_b, p)
                shifts = a * ((rows - q) // p)
                cols = (offs[None, :] + shifts[:, None]) % c_b
                out[rb * m_b + rows[:, None],
                    cb * c_b + cols] = base[nz][None, :]
    return out



def probe_op(fn, n: int, dtype=np.float32) -> np.ndarray:
    """Extract the operator matrix of a linear column-op.

    fn maps (1, 1, n, n) -> (1, 1, ..., m, n) acting along axis -2,
    uniformly over the last axis.  Feeding the identity as the image makes
    column j of the output the response to basis vector e_j.  Runs on the
    host CPU, in fp32 by default like the JAX package's probe.
    """
    eye = torch.from_numpy(np.eye(n, dtype=dtype)[None, None])
    with torch.no_grad():
        out = fn(eye).numpy()
    # (1, 1, ..., m, n) -> (prod(band_dims) * m, n)
    return out.reshape(-1, n)


# --------------------------------------------------------------------------
# K1 and K17: the operator product on the device, skipping T's zero tiles
#
# The segment table is planned at the kernels' tile: 64 rows of T per
# output tile, contraction segments starting at multiples of 16 (both
# fixed in csrc/banded_pipe.cuh, reported by K1's and K17's libraries and
# checked when each loads).  Every operator takes the table: a dense tile
# is one full segment, so no size threshold decides between a dense and a
# banded path.
# --------------------------------------------------------------------------

_TILE_ROWS = 64
_K_ALIGN = 16
# the copy widths of the kernels' staging, in bytes (csrc/banded_pipe.cuh):
# 16-byte and 4-byte cp.async, and plain 2-byte loads (bf16 views at odd
# element offsets); each wrapper counts its launches of each
COPY_NAMES = {16: "async16", 4: "async4", 2: "load2"}
# K1's column entry with 16-byte copies also has a narrow instantiation,
# output tiles 64 columns wide (:func:`_col_tile`), counted apart
NARROW = "async16_narrow"
# K17's modes, by the code its C entries take
K17_MODES = {"tf32": 0, "3xtf32": 1, "bf16": 2}
_LEVEL_MODES = {"highest": "fp32", "high": "3xtf32", "default": "tf32"}

_PLAN_CACHE: dict = {}


def content_key(A: np.ndarray):
    """Collision-safe content key for caching operator matrices (hash()
    of bytes can silently collide)."""
    return (A.shape, A.dtype.str, hashlib.sha1(A.tobytes()).hexdigest())


def _band_plan(T: np.ndarray, tile: int = _TILE_ROWS,
               align: int = _K_ALIGN):
    """[(r0, r1, [(c0, c1), ...])]: the rows of T in tiles of ``tile``,
    each with the ``align``-aligned column segments that cover its
    nonzeros (several segments for block-concatenated operators like
    [even | odd] parity stacks; none for an all-zero tile)."""
    key = (content_key(T), tile, align)
    if key in _PLAN_CACHE:
        return _PLAN_CACHE[key]
    M, N = T.shape
    nbins = -(-N // align)
    nz = np.zeros((M, nbins * align), bool)
    nz[:, :N] = T != 0
    chunks = []
    for r0 in range(0, M, tile):
        r1 = min(r0 + tile, M)
        bins = nz[r0:r1].any(axis=0).reshape(nbins, align).any(axis=1)
        edges = np.diff(np.concatenate([[0], bins.astype(np.int8), [0]]))
        starts = np.flatnonzero(edges == 1)
        ends = np.flatnonzero(edges == -1)
        chunks.append((r0, r1, [(int(s) * align, min(N, int(e) * align))
                                for s, e in zip(starts, ends)]))
    _PLAN_CACHE[key] = chunks
    return chunks


def kernel_mode(dtype) -> str:
    """The arithmetic of an operator product on a CUDA tensor of ``dtype``
    at the current matmul precision level: 'fp32' (K1) for fp32 at
    'highest', else K17's mode: '3xtf32' ('high'), 'tf32' ('default'),
    'bf16' (bf16 data, every level).  Any other dtype is 'fp32', whose
    checks refuse it."""
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype == torch.float32:
        return _LEVEL_MODES[get_matmul_precision()]
    return "fp32"


class Operator:
    """A constant operator matrix T (M x K) on one device: the matrix (fp32
    by default; a float64 ``dtype`` keeps a float64 operator for the plain
    versions' float64 inputs) and, on CUDA, K1's and K17's tile -> segment
    table (``seg_ptr[t]:seg_ptr[t+1]`` index the ``[k0, k1)`` rows of
    ``segs`` for T-row tile t).  :meth:`values` gives T in another dtype
    (bf16 for K17's bf16 mode), made at first use and kept; ``nbytes``
    counts it."""

    def __init__(self, T: np.ndarray, device, dtype=np.float32):
        T = np.ascontiguousarray(T, dtype=dtype)
        if torch.device(device).type == "cuda" and T.dtype != np.float32:
            raise TypeError(f"K1 takes float32 operators, got {T.dtype}")
        self.shape = T.shape
        self.nnz = int(np.count_nonzero(T))
        self.T = torch.from_numpy(T).to(device)
        self._copies = {}
        self.seg_ptr = self.segs = None
        if self.T.is_cuda:
            plan = _band_plan(T)
            ptr = np.zeros(len(plan) + 1, np.int32)
            ptr[1:] = np.cumsum([len(tile_segs) for _, _, tile_segs in plan])
            segs = np.array([k for _, _, tile_segs in plan
                             for seg in tile_segs for k in seg], np.int32)
            self.seg_ptr = torch.from_numpy(ptr).to(device)
            self.segs = torch.from_numpy(segs).to(device)

    def values(self, dtype) -> torch.Tensor:
        """T in ``dtype`` (rounded once from the fp32 matrix)."""
        if dtype == self.T.dtype:
            return self.T
        t = self._copies.get(dtype)
        if t is None:
            t = self._copies[dtype] = self.T.to(dtype)
        return t

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.T, self.seg_ptr, self.segs,
                             *self._copies.values())
                   if t is not None)


def _operator(T, device) -> Operator:
    if isinstance(T, Operator):
        if T.T.device != device:
            raise ValueError(f"operator on {T.T.device}, input on {device}")
        return T
    return Operator(T, device)


def _merged_stride(sizes, strides):
    """The stride of the flattened index over dims (outer to inner), or
    None when the dims do not merge into one uniformly strided axis."""
    step = span = None
    for n, s in reversed(list(zip(sizes, strides))):
        if n == 1:
            continue
        if step is None:
            step = s
        elif s != span:
            return None
        span = s * n
    return 0 if step is None else step


_checked_libs: dict = {}


def _lib(name):
    """K1's (``banded_apply``) or K17's (``banded_apply_tc``) library,
    its tile sizes checked against the segment planning here."""
    lib = _checked_libs.get(name)
    if lib is None:
        lib = _cuda.library(name)
        sizes = ((lib.banded_apply_tile_rows(), lib.banded_apply_k_align())
                 if name == "banded_apply" else
                 (lib.banded_tc_tile_rows(), lib.banded_tc_k_align()))
        if sizes != (_TILE_ROWS, _K_ALIGN):
            raise RuntimeError(f"csrc/{name}.cu plans {sizes}, ops/banded.py"
                               f" {(_TILE_ROWS, _K_ALIGN)}")
        _checked_libs[name] = lib
    return lib


_EQ = {"col": "mh,nchw->ncmw", "row": "mw,nchw->nchm"}


def _into(y, out, accumulate):
    """A plain version's product, returned, added to ``out`` (a new
    tensor, as the JAX sum) or written into it, in ``out``'s dtype."""
    if out is None:
        return y
    if accumulate:
        return (out.to(y.dtype) + y).to(out.dtype)
    return out.copy_(y)


def apply_col_plain(x, T, out=None, accumulate=True):
    """Plain PyTorch version of :func:`apply_col` (dense einsum; on a
    CUDA tensor IEEE fp32, as K1)."""
    T = _operator(T, x.device).T.to(x.dtype)
    with plain_flags():
        y = torch.einsum(_EQ["col"], T, x)
    return _into(y, out, accumulate)


def apply_row_plain(x, T, out=None, accumulate=True):
    """Plain PyTorch version of :func:`apply_row` (dense einsum; on a
    CUDA tensor IEEE fp32, as K1)."""
    T = _operator(T, x.device).T.to(x.dtype)
    with plain_flags():
        y = torch.einsum(_EQ["row"], T, x)
    return _into(y, out, accumulate)


def _tf32(t):
    """fp32 values rounded to TF32 (10 mantissa bits), to nearest, ties
    away from zero: K17's ``cvt.rna.tf32.f32``."""
    b = t.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _tc_plain(entry, mode):
    """The plain version of K17's ``entry`` in ``mode``: the dense einsum
    in IEEE fp32 on operands rounded as the mode rounds them, the result
    in the input's dtype."""
    def plain(x, T, out=None, accumulate=True):
        Tv, xv = _operator(T, x.device).T.float(), x.float()
        eq = _EQ[entry]
        with plain_flags():
            if mode == "tf32":
                y = torch.einsum(eq, _tf32(Tv), _tf32(xv))
            elif mode == "3xtf32":
                Tb, xb = _tf32(Tv), _tf32(xv)
                Ts, xs = _tf32(Tv - Tb), _tf32(xv - xb)
                y = (torch.einsum(eq, Ts, xb) + torch.einsum(eq, Tb, xs)
                     + torch.einsum(eq, Tb, xb))
            else:   # bf16: T rounded to bf16, x bf16, summed in fp32
                y = torch.einsum(eq, Tv.to(torch.bfloat16).float(), xv)
        if out is None:
            return y.to(x.dtype)
        return _into(y, out, accumulate)
    plain.__name__ = plain.__qualname__ = f"apply_{entry}_{mode}_plain"
    plain.__doc__ = (f"Plain PyTorch version of :func:`apply_{entry}_"
                     f"{mode}` (K17 {entry} entry, {mode} mode).")
    return plain


def _copy_bytes(x, T, strides):
    """The widest copy of the kernels' staging that ``x`` (its pointer
    and ``strides``, in elements) and the operator values ``T`` (row
    stride its width) allow: 16 or 4 bytes (cp.async), else 2 (plain
    loads: a bf16 view at an odd element offset)."""
    es = x.element_size()
    bits = x.data_ptr() | T.data_ptr() | T.shape[1] * es   # the low bits
    for s in strides:                                       # of every value
        bits |= s * es
    return 16 if bits % 16 == 0 else 4 if bits % 4 == 0 else 2


@functools.lru_cache(maxsize=None)
def _multiprocessors(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _col_tile(M, Wc, planes, sms):
    """The width of K1's column tiles, 128 or 64 columns of a plane (the
    narrow tile, 16-byte copies only): 64 where a plane is at most 64
    wide (a 128-wide tile would compute half zeros), or where 128-wide
    tiles would give fewer than two waves of two blocks on each of the
    card's ``sms`` multiprocessors (small batches: more, smaller tiles
    keep the card busy)."""
    blocks = -(-M // _TILE_ROWS) * -(-Wc // 128) * planes
    return 64 if Wc <= 64 or blocks < 4 * sms else 128


def _launch(entry, x, op, out, accumulate, mode):
    """Check ``x`` and ``out`` against the operator, allocate the output
    (in ``x``'s dtype) and launch K1 (``mode`` 'fp32') or K17's mode.
    Returns (the output, the name of the instantiation that ran: its copy
    width, :data:`COPY_NAMES`, or :data:`NARROW`)."""
    kernel = f"banded_apply_{entry}" if mode == "fp32" else \
        f"banded_tc_{entry} ({mode})"
    _cuda.check_inputs(kernel, x, *(() if out is None else (out,)),
                       dtypes=(torch.bfloat16,) if mode == "bf16"
                       else (torch.float32,))
    M = op.shape[0]
    if entry == "col":
        N, C, K, Wc = x.shape
        sx = _merged_stride((N, C), x.stride()[:2])
        if K != op.shape[1] or sx is None or (Wc > 1 and x.stride(3) != 1):
            raise ValueError(f"{kernel}: input {tuple(x.shape)} with "
                             f"strides {x.stride()} does not fit operator "
                             f"{op.shape} (planes must be uniformly "
                             f"strided, columns contiguous)")
        shape = (N, C, M, Wc)
    else:
        N, C, H, K = x.shape
        sx = _merged_stride((N, C, H), x.stride()[:3])
        if K != op.shape[1] or sx is None or (K > 1 and x.stride(3) != 1):
            raise ValueError(f"{kernel}: input {tuple(x.shape)} with "
                             f"strides {x.stride()} does not fit operator "
                             f"{op.shape} (rows must be uniformly strided, "
                             f"columns contiguous)")
        shape = (N, C, H, M)
    y = torch.empty(shape, device=x.device, dtype=x.dtype) if out is None \
        else out
    outer = 2 if entry == "col" else 3
    sy = _merged_stride(shape[:outer], y.stride()[:outer])
    if (tuple(y.shape) != shape or sy is None
            or (shape[3] > 1 and y.stride(3) != 1)):
        what = "planes" if outer == 2 else "rows"
        raise ValueError(f"{kernel}: out {tuple(y.shape)} with strides "
                         f"{y.stride()} is not a {shape} tensor with "
                         f"uniformly strided {what} and contiguous columns")
    acc = int(out is not None and accumulate)
    Tv = op.values(x.dtype)
    name = "banded_apply" if mode == "fp32" else "banded_apply_tc"
    lib = _lib(name)
    strides = (x.stride(2), sx) if entry == "col" else (sx,)
    copy = _copy_bytes(x, Tv, strides)
    inst = COPY_NAMES[copy]
    extra = (copy,) if mode == "fp32" else (K17_MODES[mode], copy)
    if entry == "col" and mode == "fp32":
        cols = 128 if copy != 16 else _col_tile(
            M, Wc, N * C, _multiprocessors(x.device.index))
        extra += (cols,)
        inst = NARROW if cols == 64 else inst
    if entry == "col":
        rc = (lib.banded_apply_col if mode == "fp32" else lib.banded_tc_col)(
            Tv.data_ptr(), x.data_ptr(), y.data_ptr(), op.seg_ptr.data_ptr(),
            op.segs.data_ptr(), M, K, Wc, N * C, x.stride(2), sx,
            y.stride(2), sy, acc, *extra, _cuda.stream_of(x))
    else:
        rc = (lib.banded_apply_row if mode == "fp32" else lib.banded_tc_row)(
            x.data_ptr(), Tv.data_ptr(), y.data_ptr(), op.seg_ptr.data_ptr(),
            op.segs.data_ptr(), N * C * H, K, M, sx, sy, acc, *extra,
            _cuda.stream_of(x))
    _cuda.check(lib, kernel, rc)
    return y, inst


def _count(wrapper, inst):
    """One launch of ``wrapper``'s kernel, in instantiation ``inst``."""
    wrapper.launches += 1
    wrapper.copies[inst] += 1


def _counters(wrapper, insts):
    wrapper.launches = 0
    wrapper.copies = dict.fromkeys(insts, 0)


def _k17(entry, mode):
    """K17's wrapper of ``entry`` in ``mode``, with its own launch count.
    CPU tensors take its plain version."""
    plain = _tc_plain(entry, mode)

    def wrapper(x, T, out=None, accumulate=True):
        op = _operator(T, x.device)
        if x.device.type == "cpu":
            return plain(x, op, out, accumulate)
        y, inst = _launch(entry, x, op, out, accumulate, mode)
        _count(wrapper, inst)
        return y
    wrapper.__name__ = wrapper.__qualname__ = f"apply_{entry}_{mode}"
    wrapper.__doc__ = (f"K17's {entry} entry in its {mode} mode, with the "
                       f"arguments of :func:`apply_{entry}`.  ``copies`` "
                       f"counts its launches by copy width.")
    _counters(wrapper, [COPY_NAMES[w] for w in
                        ((16, 4, 2) if mode == "bf16" else (16, 4))])
    return wrapper, plain


apply_col_tf32, apply_col_tf32_plain = _k17("col", "tf32")
apply_col_3xtf32, apply_col_3xtf32_plain = _k17("col", "3xtf32")
apply_col_bf16, apply_col_bf16_plain = _k17("col", "bf16")
apply_row_tf32, apply_row_tf32_plain = _k17("row", "tf32")
apply_row_3xtf32, apply_row_3xtf32_plain = _k17("row", "3xtf32")
apply_row_bf16, apply_row_bf16_plain = _k17("row", "bf16")


def _k17_wrapper(entry, mode):
    """K17's wrapper of ``entry`` in ``mode`` (``apply_{entry}_{mode}``)."""
    return globals()[f"apply_{entry}_{mode}"]


def apply_col(x, T, out=None, accumulate=True):
    """y[n, c, m, w] = sum_h T[m, h] x[n, c, h, w].

    With ``out`` and ``accumulate`` the product is added to ``out`` (in
    place on CUDA) and the sum returned; with ``accumulate=False`` it is
    written into ``out``, which may be any view with unit column stride
    and uniform row and plane strides (such as a column slice
    ``dz[..., go:go + gn]`` of a wider tensor), and ``out`` is returned.

    CPU tensors take :func:`apply_col_plain`; CUDA tensors launch K1's
    column entry (fp32 at 'highest') or K17's in the mode
    :func:`kernel_mode` names (planes over the grid, any uniform plane
    stride and row stride, unit column stride, for the input and the
    output alike).  The output has ``x``'s dtype.
    """
    op = _operator(T, x.device)
    if x.device.type == "cpu":
        return apply_col_plain(x, op, out, accumulate)
    mode = kernel_mode(x.dtype)
    if mode != "fp32":
        return _k17_wrapper("col", mode)(x, op, out, accumulate)
    y, inst = _launch("col", x, op, out, accumulate, mode)
    _count(apply_col, inst)
    return y


def apply_row(x, T, out=None, accumulate=True):
    """y[n, c, h, m] = sum_w T[m, w] x[n, c, h, w].

    ``out`` and ``accumulate`` as in :func:`apply_col`: with them the
    product is added to ``out`` (in place on CUDA) and the sum returned;
    with ``accumulate=False`` it is written into ``out``, which may be any
    view with unit column stride and one uniform row stride.

    CPU tensors take :func:`apply_row_plain`; CUDA tensors launch K1's row
    entry (fp32 at 'highest') or K17's in the mode :func:`kernel_mode`
    names, which reads (N*C*H) rows at one row stride, so a column slice
    of a wider contiguous tensor is read in place.
    """
    op = _operator(T, x.device)
    if x.device.type == "cpu":
        return apply_row_plain(x, op, out, accumulate)
    mode = kernel_mode(x.dtype)
    if mode != "fp32":
        return _k17_wrapper("row", mode)(x, op, out, accumulate)
    y, inst = _launch("row", x, op, out, accumulate, mode)
    _count(apply_row, inst)
    return y


# K1's launch counts, and by instantiation (``copies``: copy width, and
# the column entry's narrow tile)
_counters(apply_col, ("async16", NARROW, "async4"))
_counters(apply_row, ("async16", "async4"))

# K17's wrappers, one launch count per entry and mode
K17_WRAPPERS = (apply_row_tf32, apply_col_tf32, apply_row_3xtf32,
                apply_col_3xtf32, apply_row_bf16, apply_col_bf16)
