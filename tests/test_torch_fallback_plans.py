"""The host plans of the routes that replace the JAX package's GSPMD
fallbacks, checked in numpy and on the CPU plain versions, one process:

- the per-level route's zero-embedded storage
  (``parallel/sharded.py:_embedded_strategy``): an embedded operator
  computes the logical one and keeps the storage tails zero; the level-1
  pads it folds in (``_pad_matrix``: ``DTCWTForward``'s and
  ``ScatLayer``'s even pad, ``ScatLayerj2``'s %8 pad) are the modules'
  pads; the per-level plans' logical operators, folded pads and %4 pads
  included, give the transform without a mesh at odd and ragged sizes;
- the stencil halo route's window rule (``parallel/sharded_conv.py``):
  each rank's tile with the level's halo from its neighbours (none at the
  image's edges; the whole axis where the halo exceeds the tile), the
  level run on the window and its own outputs kept, reproduces every
  level of the transform without a mesh, forward and inverse, for the
  banks of the chip's cases (the bandpass-diagonal ones included), both
  level-1 modes, at the alignment :func:`axis_plan` asks for; the halos
  are multiples of their levels' groups; the axis rules;
- the sharded ISWT's least-squares merges (``parallel/sharded_dwt.py:
  _iswt_ls_strategies``): the dense pinv and the circulant past 2048 give
  the merges of the inverse without a mesh;
- the two warnings of the routes that move more than a halo, and
  ``DTCWTForward2`` with ``mesh=`` on a world of one."""
import numpy as np
import pytest
import torch

from pytorch_wavelets_tpu_torch.parallel import sharded, sharded_conv
from pytorch_wavelets_tpu_torch.parallel.sharded import (
    _Axis, _dtcwt_fwd_perlevel_shard_plans, _embedded_strategy,
    _fwd_level_plans, _pad_matrix, _Strategy,
)
from pytorch_wavelets_tpu_torch.parallel.sharded_conv import (
    AxisPlan, axis_plan, fwd_align, fwd_halos, inv_halos, inv_tiles,
    level_halos, operator_reach,
)
from pytorch_wavelets_tpu_torch.transforms.dtcwt import (
    fwd_j1_rot_op, fwd_j2plus_rot_op, inv_j1_op, inv_j2plus_op,
)
from pytorch_wavelets_tpu_torch.transforms.dtcwt_xfm import (
    _replicate_pad_even, dtcwt2d, dtcwt_fwd_filters, dtcwt_inv_filters,
)
from pytorch_wavelets_tpu_torch.transforms.scatternet import _pad_mod8

torch.set_num_threads(1)


def rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape)


# --------------------------------------------------------------------------
# Zero-embedded storage
# --------------------------------------------------------------------------

def _dense(strat):
    """The (embedded) operator a strategy applies, rebuilt from its host
    object: the matrix itself ('local', 'gather'), or each rank's block
    of a 'shard' strategy placed at its window's columns."""
    if strat.kind == "local":
        return strat.obj
    if strat.kind == "gather":
        return strat.obj[0]
    op = strat.obj
    n, m_loc, _ = op.blocks.shape
    tiles = op.col_tiles
    E = np.zeros((n * m_loc, n * sum(tiles)))
    hl, hr = op.halo_left, op.halo_right
    for i in range(n):
        c = cofs = 0
        for w in tiles:
            for p in range(w + hl + hr):
                g = i * w - hl + p
                if 0 <= g < n * w:
                    E[i * m_loc:(i + 1) * m_loc, cofs + g] += \
                        op.blocks[i][:, c + p]
            c += w + hl + hr
            cofs += n * w
    return E


def _row_perm(strat, rows_storage, n):
    """Local row order of a 'shard' strategy's output (each rank its
    chunk of every row block) -> the storage order."""
    if strat.kind != "shard":
        return np.arange(sum(rows_storage))
    perm = []
    for i in range(n):
        ofs = 0
        for s in rows_storage:
            loc = s // n
            perm += list(range(ofs + i * loc, ofs + (i + 1) * loc))
            ofs += s
    return np.argsort(perm)


@pytest.mark.parametrize("rows,cols,quanta,n", [
    ([19, 19, 38], [38], [1, 1, 2], 2),
    ([63, 63], [125, 125], None, 4),
    ([16, 16, 32], [32], None, 4),            # divides: no embedding
    ([5], [9, 9, 9], None, 4),
])
def test_embedded_operator_is_logical(rows, cols, quanta, n):
    T = rand((sum(rows), sum(cols)), 1)
    strat, rs = _embedded_strategy(T, n, rows, cols, quanta)
    E = _dense(strat)
    E = E[_row_perm(strat, rs, n)]
    q = quanta or [1] * len(rows)
    assert rs == [-(-r // (n * k)) * n * k for r, k in zip(rows, q)]
    cs = [-(-c // n) * n for c in cols]
    x = rand((sum(cols),), 2)
    xs = np.zeros(sum(cs))
    o = oo = 0
    for c, s in zip(cols, cs):
        xs[oo:oo + c] = x[o:o + c]
        o += c
        oo += s
    y, ys = T @ x, E @ xs
    o = oo = 0
    for r, s in zip(rows, rs):
        np.testing.assert_allclose(ys[oo:oo + r], y[o:o + r], atol=1e-10)
        assert not np.any(ys[oo + r:oo + s])
        o += r
        oo += s


@pytest.mark.parametrize("n", range(1, 26))
def test_pad_matrices_are_the_modules_pads(n):
    x = torch.from_numpy(rand((1, 1, n, 3), n))
    for pad, fn in (("even", _replicate_pad_even), ("mod8", _pad_mod8)):
        P = _pad_matrix(n, pad)
        want = fn(x)[0, 0, :, 0].numpy()
        got = x[0, 0, :, 0].numpy() if P is None else P @ x[0, 0, :, 0].numpy()
        np.testing.assert_array_equal(got, want)


FF = dtcwt_fwd_filters("near_sym_a", "qshift_a")
FI = dtcwt_inv_filters("near_sym_a", "qshift_a")
TAPS = tuple(FF[k] for k in ("h0o", "h1o", "h0a", "h1a", "h0b", "h1b"))


@pytest.mark.parametrize("hw,J,pad", [((30, 38), 2, "even"),
                                      ((31, 37), 2, "even"),
                                      ((126, 32), 2, "even"),
                                      ((60, 44), 2, "mod8"),
                                      ((31, 29), 3, "even")])
def test_perlevel_logical_operators(hw, J, pad):
    """The per-level plans' logical operators (the level-1 pad and the %4
    pads folded in) give the lowpass of the transform without a mesh,
    and the plans record its sizes."""
    H, W = hw
    x = rand((H, W), 3)
    levels = _fwd_level_plans(*TAPS, J, (False,) * J, "symmetric", H, W,
                              pad)
    ll = x
    for lev, _ in levels:
        R, C = lev["ll"]
        ll = C @ ll @ R.T
    xt = torch.from_numpy(x)[None, None]
    if pad == "mod8":
        xt = _pad_mod8(xt)
    yl, yh = dtcwt2d(xt, FF, J=J)
    np.testing.assert_allclose(ll, yl[0, 0].numpy(), atol=1e-5)
    plans = _dtcwt_fwd_perlevel_shard_plans(*TAPS, J, (False,) * J,
                                            "symmetric", H, W, 2, 2, pad)
    for (_, sizes), h in zip(plans, yh):
        assert sizes.bands == tuple(h.shape[3:5])
    assert plans[-1][1].ll == tuple(yl.shape[2:])


# --------------------------------------------------------------------------
# The stencil halo route's windows
# --------------------------------------------------------------------------

BANKS = [("near_sym_a", "qshift_a"), ("near_sym_b_bp", "qshift_b_bp"),
         ("near_sym_b", "qshift_b")]


def _bp_filters(biort, qshift):
    """The forward filter dict, with the bandpass-diagonal taps where the
    bank has them (as ``ScatLayerj2`` builds it)."""
    import pytorch_wavelets_tpu_torch as tt
    if biort.endswith("_bp"):
        return dict(tt.ScatLayerj2(biort=biort, qshift=qshift,
                                   device="cpu")._filters)
    return dtcwt_fwd_filters(biort, qshift)


def _windows(x, n, halo, axis=3):
    """Each rank's window along ``axis`` as the route builds it: the tile
    with ``halo`` samples of its neighbours (none at the image's edges),
    or the whole axis where the halo exceeds the tile; with the tile's
    offset in it."""
    W = x.shape[axis]
    t = W // n
    out = []
    for i in range(n):
        if halo > t:
            out.append((x, i * t))
            continue
        lo = max(0, i * t - halo)
        hi = min(W, (i + 1) * t + halo)
        out.append((x.narrow(axis, lo, hi - lo), i * t - lo))
    return out


def _cut(y, off, t, num, den, axis):
    return y.narrow(axis, off * num // den, t * num // den)


@pytest.mark.parametrize("bank", BANKS, ids=[b[0] for b in BANKS])
@pytest.mark.parametrize("mode", ["symmetric", "zero"])
@pytest.mark.parametrize("n", [2, 4])
def test_forward_windows_reproduce_levels(bank, mode, n):
    """Level 1 and a q-shift level on the windows of their input tiles:
    the ranks' own outputs are the level without a mesh."""
    f = _bp_filters(*bank)
    J = 2
    W = n * fwd_align(J) * 4
    halos = fwd_halos(f, J, mode)
    assert halos[0] % 2 == 0 and halos[1] % 4 == 0
    x = torch.from_numpy(rand((1, 2, 8, W), 4))
    ll0, h0 = fwd_j1_rot_op(x, f["h0o"], f["h1o"], f.get("h2o"), False, 2,
                            -1, mode)
    lq, hq = fwd_j2plus_rot_op(ll0, f["h0a"], f["h1a"], f["h0b"], f["h1b"],
                               f.get("h2a"), f.get("h2b"), False, 2, -1,
                               mode)
    for inp, level, scale_ll, scale_b, (ref_ll, ref_b) in (
            (x, 0, 1, 2, (ll0, h0)), (ll0, 1, 2, 4, (lq, hq))):
        t = inp.shape[3] // n
        lls, bs = [], []
        for win, off in _windows(inp, n, halos[level]):
            if level == 0:
                lo, hi = fwd_j1_rot_op(win, f["h0o"], f["h1o"], f.get("h2o"),
                                       False, 2, -1, mode)
            else:
                lo, hi = fwd_j2plus_rot_op(
                    win, f["h0a"], f["h1a"], f["h0b"], f["h1b"],
                    f.get("h2a"), f.get("h2b"), False, 2, -1, mode)
            lls.append(_cut(lo, off, t, 1, scale_ll, 3))
            bs.append(_cut(hi, off, t, 1, scale_b, 4))
        torch.testing.assert_close(torch.cat(lls, 3), ref_ll, atol=1e-6,
                                   rtol=0)
        torch.testing.assert_close(torch.cat(bs, 4), ref_b, atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("qshift", ["qshift_a", "qshift_b"])
@pytest.mark.parametrize("mode", ["symmetric", "zero"])
@pytest.mark.parametrize("n", [2, 4])
def test_inverse_windows_reproduce_levels(qshift, mode, n):
    """Inverse level 1 and a q-shift inverse level on the windows of the
    lowpass and the bands: the ranks' own outputs are the level without
    a mesh (also without the lowpass)."""
    f = dtcwt_inv_filters("near_sym_a", qshift)
    halos = inv_halos(f, 2, mode)
    assert all(h % 2 == 0 for h in halos)
    L = 8 * n
    ll = torch.from_numpy(rand((1, 2, 8, L), 5))
    h = torch.from_numpy(rand((1, 2, 6, 4, L // 2, 2), 6))
    for level in (0, 1):
        for low in (ll, None):
            def run(lw, hw_):
                if level == 0:
                    return inv_j1_op(lw, hw_, f["g0o"], f["g1o"], 2, -1, mode)
                return inv_j2plus_op(lw, hw_, f["g0a"], f["g1a"], f["g0b"],
                                     f["g1b"], 2, -1, mode)
            ref = run(low, h)
            t = L // n
            outs = []
            for (lw, off), (hw_, hoff) in zip(
                    _windows(ll, n, halos[level]),
                    _windows(h, n, halos[level] // 2, axis=4)):
                assert 2 * hoff == off
                y = run(None if low is None else lw, hw_)
                outs.append(_cut(y, off, t, 1 + level, 1, 3))
            torch.testing.assert_close(torch.cat(outs, 3), ref, atol=1e-6,
                                       rtol=0)


def test_halos_and_axis_rules():
    T = np.zeros((4, 8))
    T[1, 0] = T[1, 7] = 1.0      # row 1 stands for input samples 2, 3
    assert operator_reach(T) == (2, 4)
    for bank in BANKS:
        f = _bp_filters(*bank)
        h1, hq = fwd_halos(f, 2, "symmetric")
        assert h1 % 2 == 0 and hq % 4 == 0 and 0 < h1 <= hq
    # near_sym_a's 7 taps reach 3 samples: level 1's halo is 4
    assert level_halos((FF["h0o"], FF["h1o"]), "fwd1") == 4
    ax = _Axis(None, 4, 1)
    assert axis_plan(128, ax, fwd_align(3)) == AxisPlan(ax, True, False)
    assert axis_plan(126, ax, 4) == AxisPlan(ax, False, True)
    assert axis_plan(96, ax, 16) == AxisPlan(ax, False, True)
    assert axis_plan(96, _Axis(None, 1, 0), 16).tiled is False
    assert inv_tiles(64, [64, 32], 4)
    assert not inv_tiles(66, [64, 32], 4)          # a [1:-1] crop
    assert not inv_tiles(64, [62, 32], 4)
    assert inv_tiles(None, [32, None, 8], 4)
    assert not inv_tiles(None, [32, None, 2], 4)   # a band tile < 1


# --------------------------------------------------------------------------
# The sharded ISWT's least-squares merges
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,n,d", [("symmetric", 31, 1),
                                      ("zero", 48, 2),
                                      ("periodization", 2056, 1),
                                      ("zero", 2056, 1)])
def test_iswt_ls_strategies_are_the_merges(mode, n, d):
    """The dense merges as 'gather' over zero-embedded storage; past 2048
    in a non-circular mode the banded T^T as 'shard', then G^-1 as
    'gather'."""
    from pytorch_wavelets_tpu_torch.parallel.sharded_dwt import (
        _iswt_ls_strategies,
    )
    from pytorch_wavelets_tpu_torch.transforms.dwt import (
        _iswt_banded_ls, _iswt_fft_filters, _iswt_pinv, dec_filters,
    )
    h0, h1 = dec_filters("bior2.2")[:2]
    taps = (tuple(np.asarray(h0)[::-1].tolist()),
            tuple(np.asarray(h1)[::-1].tolist()))
    strats = _iswt_ls_strategies(taps, mode, d, n, 2)
    s = -(-n // 2) * 2
    lo, hi = rand((n,), 7), rand((n,), 8)
    z = np.concatenate([np.pad(lo, (0, s - n)), np.pad(hi, (0, s - n))])
    for strat in strats:
        E = _dense(strat)
        z = E[_row_perm(strat, [E.shape[0]], 2)] @ z
    v = np.concatenate([lo, hi])
    if n <= 2048:
        want = _iswt_pinv(*taps, mode, d, n, False) @ v
    elif mode == "periodization":
        G0, G1 = _iswt_fft_filters(*taps, d, n)
        want = np.fft.ifft(G0 * np.fft.fft(lo) + G1 * np.fft.fft(hi)).real
    else:
        Tt, Ginv = _iswt_banded_ls(*taps, mode, d, n, False)
        want = Ginv @ (Tt @ v)
    assert [st.kind for st in strats] == (
        ["shard", "gather"] if n > 2048 and mode == "zero" else ["gather"])
    np.testing.assert_allclose(z[:n], want, atol=1e-4)
    assert not np.any(z[n:])


# --------------------------------------------------------------------------
# Warnings and DTCWTForward2 on a world of one
# --------------------------------------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this process alone, and its (1, 1) mesh."""
    import torch.distributed as dist
    from pytorch_wavelets_tpu_torch.parallel import make_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_routes_past_a_halo_warn_once(world_of_one, monkeypatch):
    """The ISWT's least-squares merge and the stencil route's gathered
    axis name themselves with a UserWarning, once a process."""
    import warnings

    import pytorch_wavelets_tpu_torch as tt
    monkeypatch.setattr(sharded, "_WARNED", set())
    x = torch.from_numpy(rand((2, 1, 16, 20), 9)).float()
    coeffs = tt.SWTForward(J=2, wave="db2", mode="symmetric",
                           mesh=world_of_one, device="cpu")(x)
    inv = tt.SWTInverse(wave="db2", mode="symmetric", mesh=world_of_one,
                        device="cpu")
    with pytest.warns(UserWarning, match="moves more than a halo"):
        rec = inv(coeffs)
    torch.testing.assert_close(rec.full_tensor(), x, atol=1e-5, rtol=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        inv(coeffs)                                  # once
    ax = _Axis(None, 4, 0)
    with pytest.warns(UserWarning, match="W axis does not tile"):
        sharded_conv._warn_replicated(
            "sharded_scat_j2", [("H", AxisPlan(ax, False, False)),
                                ("W", AxisPlan(ax, False, True))])


def test_alt_mesh_world_of_one(world_of_one):
    """``DTCWTForward2`` / ``DTCWTInverse2`` with ``mesh=`` on a (1, 1)
    mesh: the module without a mesh bit for bit, as DTensors."""
    from pytorch_wavelets_tpu_torch.transforms.dtcwt_alt import (
        DTCWTForward2, DTCWTInverse2,
    )
    x = torch.from_numpy(rand((3, 2, 32, 32), 10)).float()
    yl, yh = DTCWTForward2(J=2, mesh=world_of_one, device="cpu")(x)
    ryl, ryh = DTCWTForward2(J=2, device="cpu")(x)
    for a, b in zip([t for row in yl for t in row] + list(yh),
                    [t for row in ryl for t in row] + list(ryh)):
        assert torch.equal(a.to_local(), b)
    rec = DTCWTInverse2(mesh=world_of_one, device="cpu")((yl, yh))
    assert torch.equal(rec.to_local(),
                       DTCWTInverse2(device="cpu")((ryl, ryh)))


def test_strategy_kinds_of_embedded_plans():
    """The per-level route's embedded plans keep the strategies: 'shard'
    where the halo fits the storage tile, 'gather' on a deep level, and a
    stage-1 strategy of its own (``_Strategy``)."""
    plans = _dtcwt_fwd_perlevel_shard_plans(*TAPS, 4, (False,) * 4,
                                            "symmetric", 32, 62, 4, 1)
    kinds = [st1.kind for (st1, _), _ in plans]
    assert isinstance(plans[0][0][0], _Strategy)
    assert kinds[0] == "shard" and kinds[-1] == "gather", kinds
