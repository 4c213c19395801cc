"""The port's Selesnick DTCWT (``transforms/dtcwt_alt.py``) on the CPU
against the JAX package: ``cplxdual2d`` (J = 1, 2, 3, ``mag`` on and off,
each mode) and ``icplxdual2d``, ``DTCWTForward2`` / ``DTCWTInverse2``
(defaults and ``qshift_b``), the quad analyses ``quad_afb2d`` (K6) and
``quad_afb2d_nonsep`` (K14's plain version) against JAX and each other,
``prep_filt_quad_afb2d_nonsep``, and ``convert.alt_filters_from_jax``;
within 2e-5 (the JAX suite's DTCWT tolerance)."""
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_wavelets_tpu.filters import qshift as jqshift
from pytorch_wavelets_tpu.transforms import dtcwt_alt as ja
from pytorch_wavelets_tpu_torch import convert
from pytorch_wavelets_tpu_torch.transforms import dtcwt_alt as pa
from tests.torch_parity import INV_ATOL, cmp, rand

torch.set_num_threads(1)

ATOL = 2e-5
_FAST = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
_jax_cplxdual = jax.jit(
    lambda x, J, mode, mag: ja.cplxdual2d(x, J, mode=mode, mag=mag),
    static_argnums=(1, 2, 3), compiler_options=_FAST)
_jax_icplxdual = jax.jit(lambda c, mode: ja.icplxdual2d(*c, mode=mode),
                         static_argnums=(1,), compiler_options=_FAST)


@pytest.mark.parametrize("mode", ["periodization", "symmetric", "zero"])
@pytest.mark.parametrize("J", [1, 2, 3])
def test_cplxdual2d_matches_jax(J, mode):
    """Forward with and without ``mag``, and the inverse of JAX's own
    coefficients; perfect reconstruction where JAX has it (not in
    'periodization' where a q-shift filter outgrows the coarsest level)."""
    x = rand((2, 3, 32, 32), J)
    xt = torch.from_numpy(x)
    for mag in (False, True):
        cmp(pa.cplxdual2d(xt, J, mode=mode, mag=mag),
            _jax_cplxdual(jnp.asarray(x), J, mode, mag), ATOL)
    jc = _jax_cplxdual(jnp.asarray(x), J, mode, False)
    pc = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jc)
    rec = pa.icplxdual2d(*pc, mode=mode)
    cmp(rec, _jax_icplxdual(jc, mode), INV_ATOL)
    if mode != "periodization" or J < 3:
        cmp(rec, x, INV_ATOL)


def test_cplxdual2d_names_and_custom_banks():
    """Banks by name or as 8-tuples of arrays; an odd-size input."""
    from pytorch_wavelets_tpu_torch.filters import level1, qshift
    x = rand((1, 2, 27, 22), 4)
    mine = pa.cplxdual2d(torch.from_numpy(x), 2, level1("farras"),
                         qshift("qshift_b"), mode="symmetric")
    cmp(mine, ja.cplxdual2d(jnp.asarray(x), 2, "farras", "qshift_b",
                            mode="symmetric"), ATOL)
    lows, yh = mine
    assert [tuple(h.shape) for h in yh] == [(1, 6, 2, 18, 15, 2),
                                            (1, 6, 2, 15, 14, 2)]
    assert tuple(lows[1][0].shape) == (1, 2, 15, 14)


@pytest.mark.parametrize("kw", [dict(), dict(qshift="qshift_b"),
                                dict(mode="periodization", J=2)])
def test_dtcwt2_modules_match_jax(kw):
    x = rand((2, 3, 40, 36), 5)
    inv_kw = {k: v for k, v in kw.items() if k != "J"}
    jf, ji = ja.DTCWTForward2(**kw), ja.DTCWTInverse2(**inv_kw)
    pf = pa.DTCWTForward2(device="cpu", **kw)
    pi = pa.DTCWTInverse2(device="cpu", **inv_kw)
    jy, py = jf(jnp.asarray(x)), pf(torch.from_numpy(x))
    cmp(py, jy, ATOL)
    rec = pi(py)
    cmp(rec, ji(jy), INV_ATOL)
    cmp(rec, x, INV_ATOL)


def test_dtcwt2_module_options():
    # mesh= takes a DeviceMesh (batch data parallelism:
    # tests/test_torch_sharded_dtcwt.py::test_alt_mesh_matches_jax)
    with pytest.raises(TypeError, match="DeviceMesh"):
        pa.DTCWTForward2(mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        pa.DTCWTInverse2(mesh=object(), device="cpu")
    f = pa.DTCWTForward2(device="cpu")
    assert (f.biort, f.qshift, f.J, f.mode) == ("farras", "qshift_a", 3,
                                                "symmetric")
    with pytest.raises(ValueError, match="is on cpu"):
        f(torch.zeros(1, 1, 16, 16, device="meta"))
    custom = pa.DTCWTForward2(biort=jax.tree.map(np.asarray, ja._level1(
        "farras")), device="cpu")
    assert custom.biort == "custom"
    assert sorted(dict(custom.named_buffers())) == sorted(
        f"{p}_{n}" for p in ("l1", "q") for n in pa.BANK)


def test_alt_filters_from_jax():
    """A JAX module's _l1 / _q -> the port's buffers: loaded into modules
    whose buffers were zeroed, they compute what the JAX modules
    compute."""
    jf = ja.DTCWTForward2(qshift="qshift_b")
    ji = ja.DTCWTInverse2(qshift="qshift_b")
    ref = pa.DTCWTForward2(qshift="qshift_b", device="cpu")
    pf = pa.DTCWTForward2(qshift="qshift_b", device="cpu")
    pi = pa.DTCWTInverse2(qshift="qshift_b", device="cpu")
    for m, j in ((pf, jf), (pi, ji)):
        m.load_state_dict({k: torch.zeros_like(v)
                           for k, v in m.state_dict().items()})
        m.load_state_dict(convert.alt_filters_from_jax(j._l1, j._q))
    for k, v in ref.state_dict().items():
        assert torch.equal(pf.state_dict()[k], v)
    x = rand((1, 2, 24, 24), 6)
    cmp(pf(torch.from_numpy(x)), jf(jnp.asarray(x)), ATOL)
    cmp(pi(pf(torch.from_numpy(x))), x, INV_ATOL)
    with pytest.raises(ValueError, match="8-tuple"):
        convert.alt_filters_from_jax(jf._l1[:4], jf._q)


def _quad_bank(name):
    h0a, h0b, _, _, h1a, h1b, _, _ = jqshift(name)
    return h0a, h1a, h0b, h1b


@pytest.mark.parametrize("mode", ["zero", "symmetric", "reflect",
                                  "periodization"])
def test_quad_matches_jax(mode):
    """quad_afb2d and quad_afb2d_nonsep against JAX and each other."""
    bank = _quad_bank("qshift_a")
    x = rand((2, 3, 30, 26), 7)
    xt = torch.from_numpy(x)
    ref = ja.quad_afb2d(jnp.asarray(x), *bank, mode=mode)
    sep = pa.quad_afb2d(xt, *bank, mode=mode)
    ns = pa.quad_afb2d_nonsep(xt, *bank, mode=mode)
    cmp(sep, ref, ATOL)
    cmp(ns, ja.quad_afb2d_nonsep(jnp.asarray(x), *bank, mode=mode), ATOL)
    cmp(ns, sep, ATOL)
    assert tuple(sep[0].shape) == (2, 3, 2 * sep[1].shape[3],
                                   2 * sep[1].shape[4])


def test_prep_filt_quad_matches_jax():
    for name in ("qshift_a", "qshift_b"):
        bank = _quad_bank(name)
        mine = pa.prep_filt_quad_afb2d_nonsep(*bank)
        assert mine.shape == (16, len(bank[0]), len(bank[0]))
        np.testing.assert_array_equal(
            mine, ja.prep_filt_quad_afb2d_nonsep(*bank))


def test_exports():
    import pytorch_wavelets_tpu.ops as jops
    import pytorch_wavelets_tpu.transforms as jtr
    import pytorch_wavelets_tpu_torch.ops as pops
    import pytorch_wavelets_tpu_torch.transforms as ptr
    for name in ("cplxdual2d", "icplxdual2d", "DTCWTForward2",
                 "DTCWTInverse2"):
        assert hasattr(jtr, name) and hasattr(ptr, name)
    assert set(ja.__all__) == set(pa.__all__)
    for name in ("afb1d", "sfb1d", "afb1d_atrous", "sfb1d_atrous", "afb2d",
                 "sfb2d", "afb2d_atrous", "sfb2d_atrous", "afb2d_nonsep",
                 "sfb2d_nonsep"):
        assert hasattr(jops, name) and callable(getattr(pops, name))
        assert (list(inspect.signature(getattr(pops, name)).parameters)
                == list(inspect.signature(getattr(jops, name)).parameters))
