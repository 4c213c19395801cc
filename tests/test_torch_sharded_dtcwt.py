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
2e-5.  The per-level route: the 64² J=3 case on 4 'spatial' ranks
(halo 26, tile 16: JAX leaves the composed route), and cases on (1, 2)
and (1, 2, 2) forced on both sides by shrinking the composed gate
(``_mm_enabled``), with ``skip_hps`` / ``include_scale`` and inverses
without the lowpass, with a level's bands None and with a size-0
placeholder; the route each entry took (``LAST_PATH``) is JAX's."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_wavelets_tpu.parallel.sharded as jsh
from pytorch_wavelets_tpu.ops import banded as jbanded
from pytorch_wavelets_tpu.parallel import (
    make_mesh as jmake_mesh, sharded_dtcwt2d as jfwd,
    sharded_idtcwt2d as jinv,
)
from pytorch_wavelets_tpu.transforms.dtcwt_xfm import (
    dtcwt_fwd_filters, dtcwt_inv_filters, idtcwt2d as jinv_single,
)

from pytorch_wavelets_tpu_torch.parallel.sharded import (
    _dtcwt_fwd_shard_plans, _strategy,
)
from tests.torch_mesh_workers import (
    ALT_CASE, DTCWT_CASES, chunk, chunk_of as _chunk_of, coords as _coords,
    dtcwt_cotangents, dtcwt_image, dtcwt_worker, rand, spawn_world,
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
def test_sharded_dtcwt_matches_jax(worlds, jax_matmul, monkeypatch, world,
                                   case):
    name, (nd, nh, ns), J, N, opts = case
    res = worlds[world]
    seed = DTCWT_CASES[world].index(case)
    if opts.get("perlevel"):
        monkeypatch.setattr(jsh, "_mm_enabled", lambda n: False)
    if "cap" in opts:
        monkeypatch.setattr(jsh, "_SHARDED_MM_CAP", opts["cap"])
    if opts.get("conv"):
        jbanded.set_operator_matmul(False)
    mesh = jmake_mesh(n_data=nd, n_spatial=ns, n_spatial_h=nh,
                      devices=jax.devices()[:world])
    x = dtcwt_image(N, 100 * seed, opts.get("hw"))
    kw = {k: (list(v) if isinstance(v, tuple) else v)
          for k, v in opts.items() if k in ("skip_hps", "include_scale")}

    def fwd(z):
        return jfwd(z, mesh, FF, J=J, **kw)

    def inv(yl, yh):
        if opts.get("jax_inv") == "single":
            return jinv_single((yl, yh), FI)
        return jinv((yl, yh), mesh, FI)
    yl_s, yh_s = jax.eval_shape(fwd, jnp.asarray(x))
    grads = opts.get("grads") or opts.get("hvp")
    if grads:
        rec_s = jax.eval_shape(inv, yl_s, yh_s)
        a, bs, c, v = dtcwt_cotangents(yl_s.shape, [h.shape for h in yh_s],
                                       x.shape, rec_s.shape, 100 * seed)
    else:
        a = bs = c = v = None

    def refs(z, a, bs, c, v):
        (yl, yh), vjp = jax.vjp(fwd, z)
        out = {"yl": yl, "yh": yh}
        if kw:
            return out
        out["path"] = jsh.LAST_PATH["dtcwt2d"]
        rec, ivjp = jax.vjp(inv, yl, yh)
        out["rec"] = rec
        if opts.get("jax_inv") != "single":
            out["ipath"] = jsh.LAST_PATH["idtcwt2d"]
        drops = []
        if opts.get("drop"):
            drops += [("low", (None, yh)),
                      ("level_none", (yl, [yh[0], None, *yh[2:]])),
                      ("level_empty", (yl, [jnp.zeros((0,)), *yh[1:]]))]
        for key, coeffs in drops:
            out["rec_" + key] = jinv(coeffs, mesh, FI)
            out["ipath_" + key] = jsh.LAST_PATH["idtcwt2d"]
        if opts.get("drop_both"):
            # the JAX package raises without the lowpass and the coarsest
            # level (its level walk filters the missing lowpass); the
            # transform without a mesh adds nothing for a missing level
            # with nothing below it, so the port is held to the inverse of
            # the levels below
            if opts.get("jax_inv") == "single":
                out["rec_both"] = jinv_single((None, yh[:-1]), FI)
            else:
                out["rec_both"] = jinv((None, yh[:-1]), mesh, FI)
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
    paths = {}

    def arrays(z, a, bs, c, v):
        out = refs(z, a, bs, c, v)
        for k in [k for k in out if "path" in k]:
            paths[k] = out.pop(k)
        return out
    args = [jnp.asarray(x)]
    args += ([jnp.asarray(a), [jnp.asarray(b) for b in bs], jnp.asarray(c),
              jnp.asarray(v)] if grads else [None, None, None, None])
    ref = jax.jit(arrays, compiler_options=FAST)(*args)
    paths.setdefault("path", jsh.LAST_PATH["dtcwt2d"])
    if opts.get("perlevel") and "route" not in opts:
        assert set(paths.values()) == {"perlevel"}, paths
    if name == "sp4_J3_raises":     # the forward's halo exceeds its tile
        assert paths["path"] == "perlevel", paths
    want = dict(paths)
    if "route" in opts:
        # the JAX package runs GSPMD; the port its own route
        assert set(paths.values()) == {"gspmd"}, paths
        want = {k: opts["route"] for k in paths}
        if opts.get("jax_inv") == "single":
            want["ipath"] = opts["route"]
    if opts.get("drop_both"):
        want["ipath_both"] = opts.get("route", "perlevel")
    coords = _coords(world, nd, nh, ns)
    for r, coord in enumerate(coords):
        got = res[r]
        for k, w in want.items():
            assert str(got[f"{name}/{k}"]) == w, (k, w)
        warned = str(got[name + "/warnings"])
        if "warns" in opts:
            assert opts["warns"] in warned, warned
        else:
            assert "more than a halo" not in warned, warned
        for k in ("low", "level_none", "level_empty", "both"):
            if "rec_" + k in ref:
                _check(got[f"{name}/rec_{k}"],
                       _chunk_of(np.asarray(ref["rec_" + k]), coord,
                                 (nd, nh, ns), SP4), f"rank {r} rec {k}")
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
            gx = np.asarray(ref["gx"])
            if opts.get("dtensor"):
                gx = _chunk_of(gx, coord, (nd, nh, ns), SP4)
            _check(got[name + "/gx"], gx, "x.grad")
            specs = [SP4] + [SP6] * J
            for j, (g, sp) in enumerate(zip(_leaves(ref["ginv"]), specs)):
                _check(got[f"{name}/ginv{j}"],
                       _chunk_of(np.asarray(g), coord, (nd, nh, ns), sp),
                       f"rank {r} inverse grad {j}")
        if "hvp" in ref:
            _check(got[name + "/hvp"], np.asarray(ref["hvp"]), "hvp")


def test_alt_mesh_matches_jax(worlds):
    """``DTCWTForward2`` / ``DTCWTInverse2`` with ``mesh=`` (batch data
    parallelism, the JAX package's ``_gspmd_apply``) on a (2, 1) mesh
    with a batch of 3: each rank's chunk of every output, x.grad of fixed
    cotangents and the reconstruction against the JAX modules on the
    same mesh (JAX ``tests/test_dtcwt_alt.py:test_form2_mesh_optin``)."""
    from pytorch_wavelets_tpu.transforms.dtcwt_alt import (
        DTCWTForward2 as JF2, DTCWTInverse2 as JI2,
    )
    (nd, nh, ns), J, shape = ALT_CASE
    mesh = jmake_mesh(n_data=nd, n_spatial=ns, n_spatial_h=nh,
                      devices=jax.devices()[:nd * nh * ns])
    x = jnp.asarray(rand(shape, 77))
    fwd, inv = JF2(J=J, mesh=mesh), JI2(mesh=mesh)

    def leaves(out):
        yl, yh = out
        return [t for row in yl for t in row] + list(yh)
    outs, vjp = jax.vjp(lambda z: leaves(fwd(z)), x)
    cts = [jnp.asarray(rand(tuple(t.shape), 78 + j))
           for j, t in enumerate(outs)]
    gx = np.asarray(vjp(cts)[0])
    rec = np.asarray(inv(fwd(x)))
    res = worlds[2]
    for r, (d, _, _) in enumerate(_coords(2, nd, nh, ns)):
        got = res[r]
        s, k = chunk(shape[0], nd, d)
        for j, t in enumerate(outs):
            _check(got[f"alt/out{j}"], np.asarray(t)[s:s + k],
                   f"rank {r} out{j}")
        _check(got["alt/gx"], gx, "x.grad")
        _check(got["alt/rec"], rec[s:s + k], f"rank {r} rec")
        assert "Shard(dim=0)" in str(got["alt/placements"])


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
