"""The port's sharded DWT, 1-D DWT and SWT (``parallel/sharded_dwt.py``
through ``DWTForward`` / ``DWTInverse``, ``DWT1DForward`` /
``DWT1DInverse`` and ``SWTForward`` / ``SWTInverse`` with ``mesh=``)
against the JAX package's ``sharded_dwt2d`` / ``sharded_idwt2d`` /
``sharded_dwt1d`` / ``sharded_idwt1d`` / ``sharded_swt2d`` /
``sharded_iswt2d`` on the same mesh shape, on the conftest's host
devices: the operator route under ``banded.set_operator_matmul(True)``
on the JAX side (the port's default), the conv halo route under
``(False)`` on both.

The port runs on the CPU in one world of two and one of four gloo
processes (tests/torch_mesh_workers.py: ``DWT_CASES``, a ``FileStore`` in
``tmp_path``, each world joined within ``DEADLINE``): 'zero',
'symmetric' and 'reflect' on 32x48 and the ragged 31x57, 'periodization'
on both routes (an odd H too), (1, 2, 2) HxW meshes, a (2, 1) mesh with
an odd batch of 3, a deep level on the 'gather' strategy, the 1-D DWT
with a ragged length, a DTensor input whose last shard is short, the SWT
in 'periodization' (both routes) and 'periodic' with names, bior2.2 and
the orthonormal tuple
``dec_filters('db2')``, its 'zero' / 'symmetric' forward, None bands in
the inverses; forward, inverse, input and coefficient gradients of fixed
random cotangents and one Hessian-vector product, within 2e-5 *
max(1, max |JAX|).  ``sharded_iswt2d`` in 'zero', 'symmetric' and
'reflect' (ragged sizes too, HxW meshes) and with
``dec_filters('bior2.2')`` runs the least-squares merge gathered per axis
('matmul'; the JAX package runs GSPMD there).  The raises: 'periodic' on
the sharded DWT (where the JAX sharded result differs from the JAX
``dwt2d``), an HxW mesh on the conv route, an uneven circular axis.  A 4-tuple ``wave`` filters W
with its first pair, as ``dwt2d`` without a mesh does (the JAX sharded
entry takes the second)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_wavelets_tpu.ops import banded as jbanded
from pytorch_wavelets_tpu.parallel import (
    make_mesh as jmake_mesh, sharded_dwt1d as jdwt1d,
    sharded_dwt2d as jdwt2d, sharded_idwt1d as jidwt1d,
    sharded_idwt2d as jidwt2d, sharded_iswt2d as jiswt2d,
    sharded_swt2d as jswt2d,
)
from pytorch_wavelets_tpu.transforms.dwt import (
    dwt2d as jdwt2d_single, idwt2d as jidwt2d_single,
)

from tests.torch_mesh_workers import (
    DWT_CASES, chunk_of, coords, dwt_rec_wave, dwt_wave, dwt_worker, rand,
    spawn_world,
)
from tests.torch_parity import FAST

torch.set_num_threads(1)

TOL = 2e-5
CASES = [(w, c) for w in DWT_CASES for c in DWT_CASES[w]]
SP4 = (0, None, 1, 2)
SP5 = (0, None, None, 1, 2)
SP3 = (0, None, 2)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: spawn_world(dwt_worker, w, tmp_path_factory.mktemp(f"dwt{w}"))
            for w in DWT_CASES}


def _check(mine, ref, what):
    assert mine.shape == ref.shape, (what, mine.shape, ref.shape)
    atol = TOL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(mine, ref, atol=atol, rtol=0, err_msg=what)


def _jax_wave(wave):
    w = dwt_wave(wave)
    return w if isinstance(w, str) else tuple(jnp.asarray(f) for f in w)


def _entries(kind, mesh, J, mode, wave):
    """The JAX (forward, inverse) of a case, with outputs flattened to
    the worker's leaves; the 4-tuple case's are the JAX ``dwt2d`` without
    a mesh (the port follows it, ``parallel/sharded_dwt.py``)."""
    w = _jax_wave(wave)
    if kind == "dwt" and wave == "db2_db1":
        wr = _jax_wave_rec(kind, wave)

        def fwd(z):
            yl, yh = jdwt2d_single(z, w, J=J, mode=mode)
            return [yl, *yh]

        def inv(ls):
            return jidwt2d_single((ls[0], list(ls[1:])), wr, mode=mode)
        return fwd, inv
    if kind == "dwt":
        def fwd(z):
            yl, yh = jdwt2d(z, mesh, wave=w, J=J, mode=mode)
            return [yl, *yh]

        def inv(ls):
            return jidwt2d((ls[0], list(ls[1:])), mesh, wave=w, mode=mode)
        return fwd, inv
    if kind == "dwt1d":
        def fwd(z):
            x0, hs = jdwt1d(z, mesh, wave=w, J=J, mode=mode)
            return [x0, *hs]

        def inv(ls):
            return jidwt1d((ls[0], list(ls[1:])), mesh, wave=w, mode=mode)
        return fwd, inv
    # the JAX inverse's GSPMD route keys its jit cache on the taps' bytes,
    # which it reads from numpy arrays only
    wi = w if isinstance(w, str) else tuple(np.asarray(f) for f in w)
    return (lambda z: list(jswt2d(z, mesh, wave=w, J=J, mode=mode)),
            lambda ls: jiswt2d(list(ls), mesh, wave=wi, mode=mode))


def _jax_wave_rec(kind, wave):
    w = dwt_rec_wave(kind, wave)
    return w if isinstance(w, str) else tuple(jnp.asarray(f) for f in w)


def _specs(kind, n):
    if kind == "dwt1d":
        return [SP3] * n, SP3
    if kind == "dwt":
        return [SP4] + [SP5] * (n - 1), SP4
    return [SP5] * n, SP4


@pytest.fixture
def jax_route():
    yield jbanded.set_operator_matmul
    jbanded.set_operator_matmul(None)


@pytest.mark.parametrize("world,case", CASES, ids=[c[0] for _, c in CASES])
def test_sharded_dwt_matches_jax(worlds, jax_route, world, case):
    name, kind, (nd, nh, ns), shape, J, mode, wave, opts = case
    res = worlds[world]
    seed = DWT_CASES[world].index(case)
    mesh = jmake_mesh(n_data=nd, n_spatial=ns, n_spatial_h=nh,
                      devices=jax.devices()[:world])
    jax_route(not opts.get("conv"))
    x = rand(shape, 1000 + seed)
    fwd, inv = _entries(kind, mesh, J, mode, wave)
    if opts.get("raises"):
        for r in range(world):
            assert str(res[r][name + "/raised"]).startswith(opts["raises"])
        if mode == "periodic":
            # the JAX sharded entry runs, with periodization's sizes: not
            # the JAX transform without a mesh
            assert all("periodization" in str(res[r][name + "/raised"])
                       for r in range(world))
            got = fwd(jnp.asarray(x))
            if kind == "dwt":
                want = jdwt2d_single(jnp.asarray(x), wave, J=J, mode=mode)
                want = [want[0], *want[1]]
                assert [a.shape for a in got] != [b.shape for b in want]
        else:
            with pytest.raises(ValueError):
                jax.block_until_ready(fwd(jnp.asarray(x)))
        return

    def refs(z, cts, c, v):
        out, vjp = jax.vjp(fwd, z)
        r = {"out": out}
        if opts.get("grads"):
            r["gx"] = vjp(list(cts))[0]
        if opts.get("fwd_only"):
            return r
        ins = list(out)
        if opts.get("none"):
            ins[1] = None
        rec, ivjp = jax.vjp(inv, ins)
        r["rec"] = rec
        if opts.get("grads"):
            r["ginv"] = ivjp(c)[0]
        if opts.get("hvp"):
            def cubic(t):
                return sum(jnp.sum(a ** 3) for a in fwd(t))
            r["hvp"] = jax.grad(lambda t: jnp.vdot(jax.grad(cubic)(t),
                                                   v))(z)
        return r
    shapes = [o.shape for o in jax.eval_shape(fwd, jnp.asarray(x))]
    cts = [jnp.asarray(rand(tuple(s), 2000 + 10 * seed + j))
           for j, s in enumerate(shapes)]
    rec_shape = None
    if not opts.get("fwd_only") and not opts.get("none"):
        rec_shape = jax.eval_shape(inv, [jax.ShapeDtypeStruct(s, jnp.float32)
                                         for s in shapes]).shape
    c = jnp.asarray(rand(tuple(rec_shape), 3000 + seed)) if rec_shape \
        else jnp.zeros(())
    v = jnp.asarray(rand(shape, 4000 + seed))
    ref = jax.jit(refs, compiler_options=FAST)(jnp.asarray(x), cts, c, v)
    leaves_specs, rec_spec = _specs(kind, len(shapes))
    ms = (nd, nh, ns)
    route = "conv" if opts.get("conv") else "matmul"
    for r, coord in enumerate(coords(world, nd, nh, ns)):
        got = res[r]
        assert str(got[name + "/path"]) == route
        for j, (t, sp) in enumerate(zip(ref["out"], leaves_specs)):
            _check(got[f"{name}/out{j}"],
                   chunk_of(np.asarray(t), coord, ms, sp), f"rank {r} out{j}")
        if "gx" in ref:
            want = np.asarray(ref["gx"])
            if opts.get("dtensor"):
                want = chunk_of(want, coord, ms, SP4)
            _check(got[name + "/gx"], want, "x.grad")
        if "rec" in ref:
            assert str(got[name + "/ipath"]) == route
            _check(got[name + "/rec"],
                   chunk_of(np.asarray(ref["rec"]), coord, ms, rec_spec),
                   f"rank {r} rec")
        if "ginv" in ref:
            for j, (g, sp) in enumerate(zip(ref["ginv"], leaves_specs)):
                _check(got[f"{name}/ginv{j}"],
                       chunk_of(np.asarray(g), coord, ms, sp),
                       f"rank {r} inverse grad {j}")
        if "hvp" in ref:
            _check(got[name + "/hvp"], np.asarray(ref["hvp"]), "hvp")
    if wave == "db2_db1":
        # the JAX sharded entry filters W with the second pair
        jbanded.set_operator_matmul(True)
        yl, _ = jdwt2d(jnp.asarray(x), mesh, wave=_jax_wave(wave), J=J,
                       mode=mode)
        assert yl.shape != ref["out"][0].shape or not np.allclose(
            np.asarray(yl), np.asarray(ref["out"][0]), atol=1e-3)
