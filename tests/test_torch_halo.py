"""The port's ring halo exchange (``parallel/halo.py``, K19's plain
versions on the CPU) against the JAX package's
``parallel/halo.py:halo_exchange_1d`` inside a ``shard_map``, and its
VJP, for every boundary, both axes and rings of 1, 2 and 3 ranks.

The port runs in one world of three gloo processes (a ``FileStore`` in
``tmp_path``, joined with a deadline: tests/torch_mesh_workers.py); the
JAX side on the conftest's host devices.  Copies are exact; the VJP adds
at most three terms, so it is held at 1e-6.  Also: the exchange's
backward differentiates again to the exchange, a halo wider than the
tile raises, and K19's three plain versions agree with each other as a
map and its adjoint."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pytorch_wavelets_tpu.parallel.halo import halo_exchange_1d as jhalo

from pytorch_wavelets_tpu_torch.ops import halo as k19
from tests.torch_mesh_workers import (
    HALO_CASES, halo_inputs, halo_worker, spawn_world,
)
from tests.torch_parity import FAST

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return spawn_world(halo_worker, 3, tmp_path_factory.mktemp("halo"))


def _jax_case(n, axis, boundary, left, right, L):
    x, g = halo_inputs(n, axis, left, right, L)
    mesh = Mesh(np.array(jax.devices()[:n]), ("spatial",))
    spec = P(None, None, "spatial", None) if axis == 2 else \
        P(None, None, None, "spatial")
    f = shard_map(lambda t: jhalo(t, axis, "spatial", left, right,
                                  boundary),
                  mesh=mesh, in_specs=(spec,), out_specs=spec)

    def both(t, u):
        y, vjp = jax.vjp(f, t)
        return y, vjp(u)[0]
    y, dx = jax.jit(both, compiler_options=FAST)(jnp.asarray(x),
                                                  jnp.asarray(g))
    return np.asarray(y), np.asarray(dx)


@pytest.mark.parametrize("case", HALO_CASES,
                         ids=["-".join(map(str, c)) for c in HALO_CASES])
def test_halo_matches_jax(world3, case):
    n, axis, boundary, left, right, L = case
    y, dx = _jax_case(*case)
    key = "/".join(map(str, case))
    w = L + left + right
    for r in range(n):
        res = world3[r]
        np.testing.assert_array_equal(
            res[key + "/y"], np.take(y, range(r * w, (r + 1) * w), axis))
        np.testing.assert_allclose(
            res[key + "/dx"], np.take(dx, range(r * L, (r + 1) * L), axis),
            atol=1e-6, rtol=0)
        assert res[key + "/gg_err"] == 0.0


def test_halo_wider_than_tile_raises(world3):
    assert all(world3[r]["too_wide_raises"] for r in range(3))


@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("lsrc,rsrc", [("recv", "recv"), ("flip", "zero"),
                                       ("zero", "flip"), ("flip", "recv")])
def test_k19_fold_is_assemble_adjoint(axis, lsrc, rsrc):
    """<assemble(x, recv), g> == <x, fold(g)> + <recv, halos(g)> in
    float64, on a strided (transposed) tile: K19's plain versions are a
    map and its adjoint, with pack taking the halos out of g."""
    rng = np.random.RandomState(axis)
    left, right, L = 3, 2, 6
    base = torch.from_numpy(rng.randn(2, 3, 7, L).astype(np.float64))
    x = base if axis == 3 else base.transpose(2, 3)     # strided view
    per = x.numel() // x.shape[axis]
    recv_l = torch.from_numpy(rng.randn(per * left))
    recv_r = torch.from_numpy(rng.randn(per * right))
    win = x.new_empty(k19.block_shape(x, axis, left + x.shape[axis] + right))
    k19.halo_assemble(x, axis, left, right, lsrc, rsrc, recv_l, recv_r, win)
    g = torch.from_numpy(rng.randn(*win.shape))
    # the halo cotangents: the right halo's as the tail, the left's as the
    # head (from_l / from_r of the fold are the neighbours' of these)
    tail, head = g.new_empty(per * right), g.new_empty(per * left)
    k19.halo_pack(g, axis, right, left, tail, head)
    dx = k19.halo_fold(g, axis, left, right, lsrc, rsrc,
                       torch.zeros(per * right), torch.zeros(per * left))
    lhs = float((win * g).sum())
    rhs = float((x * dx).sum())
    if lsrc == "recv":
        rhs += float((recv_l * head).sum())
    if rsrc == "recv":
        rhs += float((recv_r * tail).sum())
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


def test_k19_plain_bf16_copies_exact():
    """bf16 tiles: pack and assemble move values as they are; the fold
    sums in fp32 and rounds once."""
    x = torch.randn(2, 2, 5, 8).to(torch.bfloat16)
    per = x.numel() // 8
    tail, head = x.new_empty(per * 3), x.new_empty(per * 2)
    k19.halo_pack(x, 3, 3, 2, tail, head)
    assert torch.equal(tail.view(2, 2, 5, 3), x[..., -3:])
    assert torch.equal(head.view(2, 2, 5, 2), x[..., :2])
    win = x.new_empty(2, 2, 5, 13)
    k19.halo_assemble(x, 3, 3, 2, "flip", "recv", None, head, win)
    assert torch.equal(win[..., :3], x[..., :3].flip(-1))
    assert torch.equal(win[..., 3:11], x)
    dx = k19.halo_fold(win, 3, 3, 2, "flip", "zero", None, None)
    ref = win[..., 3:11].float()
    ref[..., :3] += win[..., :3].flip(-1).float()
    assert torch.equal(dx, ref.to(torch.bfloat16))
