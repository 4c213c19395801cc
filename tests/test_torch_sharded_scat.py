"""The port's sharded scattering layers (``parallel/sharded_scat.py``
through ``ScatLayer`` / ``ScatLayerj2`` with ``mesh=``) against the JAX
package's ``sharded_scat_j1`` / ``sharded_scat_j2`` on its operator path
(``banded.set_operator_matmul(True)``), on the conftest's host devices.

The port runs on the CPU in one world of two and one of four gloo
processes (tests/torch_mesh_workers.py: ``SCAT_CASES``, a ``FileStore`` in
``tmp_path``, each world joined within ``DEADLINE``): ScatLayerj2 on
(1, 2), (2, 1) with a batch of 3, (2, 2) with an odd batch, (1, 2, 2) and
(1, 4), a DTensor input, ScatLayer on an odd 15x31 image (edge-padded
even), ``combine_colour`` on both layers, and the giant-image fronts
(per level, the last lowpass pooled on the tiles) forced on both sides by
shrinking the composed gate: the output, x.grad of a fixed cotangent and
one Hessian-vector product each on the composed and the per-level
fronts, within 2e-5 * max(1, max |JAX|), and the route ``LAST_PATH``
names.  Where the JAX package runs the layer under GSPMD (its
``LAST_PATH`` 'gspmd') the port runs a route of its own, held to the JAX
results the same way: the bandpass-diagonal filters on (1, 2), (1, 2, 2)
and a ragged (1, 4) ('conv', the stencil halo route; the ragged axis
gathered, with its warning), H not a multiple of 8 (a full tensor padded
first: 'matmul'; a DTensor, the pad folded into the per-level fronts:
'perlevel'), tiles that do not divide ('perlevel' on zero-embedded
storage) and ``set_operator_matmul(False)`` ('conv')."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_wavelets_tpu as tw
import pytorch_wavelets_tpu.parallel.sharded as jsh
from pytorch_wavelets_tpu.ops import banded as jbanded
from pytorch_wavelets_tpu.parallel import (
    make_mesh as jmake_mesh, sharded_scat_j1 as jscat_j1,
    sharded_scat_j2 as jscat_j2,
)

from tests.torch_mesh_workers import (
    SCAT_CASES, chunk_of, coords, rand, scat_layer_kw, scat_worker,
    spawn_world,
)
from tests.torch_parity import FAST

torch.set_num_threads(1)

TOL = 2e-5
CASES = [(w, c) for w in SCAT_CASES for c in SCAT_CASES[w]]
SP4 = (0, None, 1, 2)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: spawn_world(scat_worker, w,
                           tmp_path_factory.mktemp(f"scat{w}"))
            for w in SCAT_CASES}


@pytest.fixture
def jax_matmul():
    jbanded.set_operator_matmul(True)
    yield
    jbanded.set_operator_matmul(None)


def _check(mine, ref, what):
    assert mine.shape == ref.shape, (what, mine.shape, ref.shape)
    atol = TOL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(mine, ref, atol=atol, rtol=0, err_msg=what)


def _jax_route(layer, f, shape, nh, ns, forced):
    """'matmul' where the JAX package runs the composed fronts (every
    front has a plan), else 'perlevel'."""
    if forced:
        return "perlevel"
    H, W = shape[2] + shape[2] % 2, shape[3] + shape[3] % 2
    if layer == "j1":
        taps, fronts = (f["h0o"], f["h1o"]) * 3, [(1, H, W)]
    else:
        taps = tuple(f[k] for k in ("h0o", "h1o", "h0a", "h1a", "h0b",
                                    "h1b"))
        fronts = [(2, H, W), (1, H // 2, W // 2)]
    if all(jsh._scat_shard_plans(*taps, J, "symmetric", h, w, ns, nh)
           is not None for J, h, w in fronts):
        return "matmul"
    return "perlevel"


@pytest.mark.parametrize("world,case", CASES,
                         ids=[c[0] for _, c in CASES])
def test_sharded_scat_matches_jax(worlds, jax_matmul, monkeypatch, world,
                                  case):
    name, layer, (nd, nh, ns), shape, opts = case
    res = worlds[world]
    mesh = jmake_mesh(n_data=nd, n_spatial=ns, n_spatial_h=nh,
                      devices=jax.devices()[:world])
    if opts.get("perlevel"):
        monkeypatch.setattr(jsh, "_mm_enabled", lambda n: False)
    if opts.get("conv"):
        jbanded.set_operator_matmul(False)
    kw = scat_layer_kw(opts)
    if layer == "j2":
        filters, entry = dict(tw.ScatLayerj2(**kw)._filters), jscat_j2
    else:
        kw.pop("qshift", None)
        filters, entry = dict(tw.ScatLayer(**kw)._filters), jscat_j1
    colour, bp = bool(opts.get("colour")), bool(opts.get("bp"))
    seed = SCAT_CASES[world].index(case)
    x = rand(shape, 500 + seed)

    def fwd(z):
        return entry(z, mesh, filters, combine_colour=colour,
                     bandpass_diag=bp)

    def refs(z, ct, v):
        out, vjp = jax.vjp(fwd, z)
        r = {"out": out}
        if opts.get("grads"):
            r["gx"] = vjp(ct)[0]
        if opts.get("hvp"):
            def cubic(t):
                return jnp.sum(fwd(t) ** 3)
            r["hvp"] = jax.grad(lambda t: jnp.vdot(jax.grad(cubic)(t),
                                                   v))(z)
        return r
    out_shape = jax.eval_shape(fwd, jnp.asarray(x)).shape
    ref = jax.jit(refs, compiler_options=FAST)(
        jnp.asarray(x), jnp.asarray(rand(out_shape, 600 + seed)),
        jnp.asarray(rand(shape, 700 + seed)))
    if "route" in opts:
        # the JAX package runs GSPMD; the port its own route
        assert jsh.LAST_PATH["scat_" + layer] == "gspmd"
        want_path = opts["route"]
    else:
        # the JAX package names both of its fronts' routes 'matmul'; the
        # port names the per-level one 'perlevel'
        assert jsh.LAST_PATH["scat_" + layer] == "matmul"
        want_path = _jax_route(layer, filters, shape, nh, ns,
                               opts.get("perlevel"))
    for r, coord in enumerate(coords(world, nd, nh, ns)):
        got = res[r]
        assert str(got[name + "/path"]) == want_path
        warned = str(got[name + "/warnings"])
        if "warns" in opts:
            assert opts["warns"] in warned, warned
        else:
            assert "more than a halo" not in warned, warned
        _check(got[name + "/out"],
               chunk_of(np.asarray(ref["out"]), coord, (nd, nh, ns), SP4),
               f"rank {r} output")
        if "gx" in ref:
            gx = np.asarray(ref["gx"])
            if opts.get("dtensor"):
                gx = chunk_of(gx, coord, (nd, nh, ns), SP4)
            _check(got[name + "/gx"], gx, f"rank {r} x.grad")
        if "hvp" in ref:
            _check(got[name + "/hvp"], np.asarray(ref["hvp"]),
                   f"rank {r} hvp")


def test_batch_chunk_warning(worlds):
    for w, res in worlds.items():
        for r in range(w):
            msg = str(res[r]["chunk_warning"])
            assert msg.count("batch_chunk ignored") == 2, msg
