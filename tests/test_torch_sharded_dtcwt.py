"""The port's sharded DTCWT (``parallel/sharded.py`` through
``DTCWTForward`` / ``DTCWTInverse`` with ``mesh=``) against the JAX
package's ``sharded_dtcwt2d`` / ``sharded_idtcwt2d`` on its operator path
(``banded.set_operator_matmul(True)``), on the conftest's host devices.

The port runs on the CPU in one world of two and one of four gloo
processes (tests/torch_mesh_workers.py: a ``FileStore`` in ``tmp_path``,
each world joined with a deadline), every case of its world in it:
meshes (1, 2), (2, 1) with an odd batch of 3, (2, 2) with an odd batch,
(1, 2, 2) and (1, 4, 1) at J=3 (its deep levels take the 'gather'
strategy), ``skip_hps`` / ``include_scale``; outputs, the
reconstruction, input gradients of fixed random cotangents, the
inverse's coefficient gradients and one Hessian-vector product, within
2e-5.  The 64² J=3 case on 4 'spatial' ranks, where JAX leaves the
composed route, raises NotImplementedError."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_wavelets_tpu.ops import banded as jbanded
from pytorch_wavelets_tpu.parallel import (
    make_mesh as jmake_mesh, sharded_dtcwt2d as jfwd,
    sharded_idtcwt2d as jinv,
)
from pytorch_wavelets_tpu.transforms.dtcwt_xfm import (
    dtcwt_fwd_filters, dtcwt_inv_filters,
)

from pytorch_wavelets_tpu_torch.parallel.sharded import (
    _dtcwt_fwd_shard_plans, _strategy,
)
from tests.torch_mesh_workers import (
    DTCWT_CASES, chunk, dtcwt_inputs, dtcwt_worker, spawn_world,
)
from tests.torch_parity import FAST

torch.set_num_threads(1)

TOL = 2e-5
FF = dtcwt_fwd_filters("near_sym_a", "qshift_a")
FI = dtcwt_inv_filters("near_sym_a", "qshift_a")
CASES = [(w, c) for w in DTCWT_CASES for c in DTCWT_CASES[w]]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: spawn_world(dtcwt_worker, w,
                           tmp_path_factory.mktemp(f"mesh{w}"))
            for w in DTCWT_CASES}


@pytest.fixture
def jax_matmul():
    jbanded.set_operator_matmul(True)
    yield
    jbanded.set_operator_matmul(None)


def _coords(world, nd, nh, ns):
    """Each rank's (data, spatial_h, spatial) coordinate: the ranks laid
    out as the mesh reshapes them."""
    return [np.unravel_index(r, (nd, nh, ns)) for r in range(world)]


def _chunk_of(full, coord, mesh_shape, spec):
    """A rank's chunk of ``full``: spec names a mesh dim (0 data,
    1 spatial_h, 2 spatial) per tensor dim, or None."""
    out = full
    for d, m in enumerate(spec):
        if m is not None:
            s, k = chunk(full.shape[d], mesh_shape[m], coord[m])
            out = np.take(out, range(s, s + k), axis=d)
    return out


SP4 = (0, None, 1, 2)
SP6 = (0, None, None, 1, 2, None)      # default o_dim=2, ri_dim=-1


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    return [] if out is None else [out]


def _check(mine, ref, what):
    assert mine.shape == ref.shape, (what, mine.shape, ref.shape)
    atol = TOL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(mine, ref, atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("world,case", CASES,
                         ids=[c[0] for _, c in CASES])
def test_sharded_dtcwt_matches_jax(worlds, jax_matmul, world, case):
    name, (nd, nh, ns), J, N, opts = case
    res = worlds[world]
    seed = DTCWT_CASES[world].index(case)
    if opts.get("raises"):
        for r in range(world):
            assert "A5d" in str(res[r][name + "/raised"])
        return
    mesh = jmake_mesh(n_data=nd, n_spatial=ns, n_spatial_h=nh,
                      devices=jax.devices()[:world])
    x, a, bs, c, v = dtcwt_inputs(J, N, 100 * seed)
    kw = {k: (list(v) if isinstance(v, tuple) else v)
          for k, v in opts.items() if k in ("skip_hps", "include_scale")}

    def fwd(z):
        return jfwd(z, mesh, FF, J=J, **kw)

    def inv(yl, yh):
        return jinv((yl, yh), mesh, FI)

    def refs(z, a, bs, c, v):
        (yl, yh), vjp = jax.vjp(fwd, z)
        out = {"yl": yl, "yh": yh}
        if kw:
            return out
        rec, ivjp = jax.vjp(inv, yl, yh)
        out["rec"] = rec
        if opts.get("grads"):
            out["gx"] = vjp((a, list(bs)))[0]
            out["ginv"] = ivjp(c)
        if opts.get("hvp"):
            def cubic(t):
                yl_, yh_ = fwd(t)
                return jnp.sum(yl_ ** 3) + sum(jnp.sum(h ** 3) for h in yh_)
            out["hvp"] = jax.grad(lambda t: jnp.vdot(jax.grad(cubic)(t),
                                                     v))(z)
        return out
    ref = jax.jit(refs, compiler_options=FAST)(
        jnp.asarray(x), jnp.asarray(a), [jnp.asarray(b) for b in bs],
        jnp.asarray(c), jnp.asarray(v))
    coords = _coords(world, nd, nh, ns)
    for r, coord in enumerate(coords):
        got = res[r]
        assert str(got[name + "/path"]) == "matmul"
        for j, t in enumerate(_leaves(ref["yl"])):
            _check(got[f"{name}/yl{j}"],
                   _chunk_of(np.asarray(t), coord, (nd, nh, ns), SP4),
                   f"rank {r} yl{j}")
        for j, t in enumerate(ref["yh"]):
            if t is None:
                assert f"{name}/yh{j}" not in got
                continue
            _check(got[f"{name}/yh{j}"],
                   _chunk_of(np.asarray(t), coord, (nd, nh, ns), SP6),
                   f"rank {r} yh{j}")
        if "rec" in ref:
            _check(got[name + "/rec"],
                   _chunk_of(np.asarray(ref["rec"]), coord, (nd, nh, ns),
                             SP4), f"rank {r} rec")
        if "gx" in ref:
            _check(got[name + "/gx"], np.asarray(ref["gx"]), "x.grad")
            specs = [SP4] + [SP6] * J
            for j, (g, sp) in enumerate(zip(_leaves(ref["ginv"]), specs)):
                _check(got[f"{name}/ginv{j}"],
                       _chunk_of(np.asarray(g), coord, (nd, nh, ns), sp),
                       f"rank {r} inverse grad {j}")
        if "hvp" in ref:
            _check(got[name + "/hvp"], np.asarray(ref["hvp"]), "hvp")


def test_strategies_taken():
    """The meshes above take every strategy: 'shard' at stage 2 on
    (1, 2, 2), 'gather' and 'shard' at J=3 on (1, 4, 1), 'local' where H
    is not sharded (host plans only)."""
    def kinds(J, n_sp, n_h):
        op, s2 = _dtcwt_fwd_shard_plans(
            FF["h0o"], FF["h1o"], FF["h0a"], FF["h1a"], FF["h0b"], FF["h1b"],
            J, (False,) * J, (False,) * J, "symmetric", 64, 64, n_sp, n_h)
        return {g[3].kind for e in s2 for g in e["groups"]}
    assert kinds(2, 2, 1) == {"local"}
    assert kinds(2, 2, 2) == {"shard"}
    assert kinds(3, 1, 4) == {"shard", "gather"}
    assert _strategy(np.eye(8), 1, [8], [8]).kind == "local"


def test_batch_chunk_warning_and_state_dict(worlds):
    for w, res in worlds.items():
        for r in range(w):
            assert "batch_chunk ignored" in str(res[r]["chunk_warning"])
            assert res[r]["state_dict_err"] <= 1e-6
            assert res[r]["state_dict_back_err"] == 0.0
