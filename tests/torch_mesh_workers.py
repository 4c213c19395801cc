"""Multi-process helpers of the port's sharded tests
(tests/test_torch_halo.py, tests/test_torch_sharded_dtcwt.py,
tests/test_torch_sharded_dwt.py, tests/test_torch_sharded_scat.py).

A world of processes runs on the CPU with gloo, rendezvousing on a
``FileStore`` in the test's ``tmp_path``; every rank runs every case of
its world, then writes its local results to ``rank<r>.npz``.  The parent
compares them with the JAX package.  This module imports torch and the
port only (no JAX), so the children start fast.
"""
import multiprocessing as mp
import os
import sys
import time
import traceback

import numpy as np
import torch

DEADLINE = 120          # seconds a world may take before it is killed

IMAGE = (4, 2, 64, 64)
# sharded DTCWT cases: (name, (n_data, n_spatial_h, n_spatial), J, batch,
# options); world 2 then world 4
DTCWT_CASES = {
    2: [
        ("sp2_J1", (1, 1, 2), 1, 4, {}),
        ("sp2_J2", (1, 1, 2), 2, 4, {"grads": True}),
        ("data2_odd", (2, 1, 1), 2, 3, {"grads": True}),
        ("sp2_skip", (1, 1, 2), 3, 4, {"skip_hps": (True, False, False)}),
        ("sp2_scale", (1, 1, 2), 2, 4, {"include_scale": True}),
        ("sp2_perlevel", (1, 1, 2), 2, 4, {"perlevel": True, "grads": True,
                                           "drop": True}),
        ("sp2_perlevel_skip", (1, 1, 2), 3, 4, {
            "perlevel": True, "skip_hps": (True, False, False)}),
        # where the JAX package runs GSPMD: odd tiles, an odd DTensor,
        # the operator route off, the cap shrunk past the image
        ("sp2_odd_tiles", (1, 1, 2), 2, 2, {
            "hw": (30, 38), "grads": True, "route": "perlevel",
            "jax_inv": "single",
            "drop_both": True}),
        ("sp2_dtensor_odd", (1, 1, 2), 2, 2, {
            "hw": (31, 37), "dtensor": True, "grads": True,
            "route": "perlevel",
            "jax_inv": "single"}),
        ("sp2_conv_off", (1, 1, 2), 3, 2, {
            "conv": True, "grads": True, "hvp": True, "route": "conv",
            "drop_both": True}),
        ("sp2_conv_cap", (1, 1, 2), 2, 2, {
            "perlevel": True, "cap": 48, "grads": True, "route": "conv"}),
    ],
    4: [
        ("data2_sp2_odd", (2, 1, 2), 2, 3, {"grads": True}),
        ("h2_sp2_J1", (1, 2, 2), 1, 4, {}),
        ("h2_sp2_J2", (1, 2, 2), 2, 4, {"grads": True, "hvp": True}),
        ("h2_sp2_opts", (1, 2, 2), 2, 4, {"skip_hps": (True, False),
                                          "include_scale": True}),
        ("h4_J3_gather", (1, 4, 1), 3, 4, {"grads": True}),
        # the id is kept from when the port raised here; the halo (26)
        # is wider than the tile (16), so JAX runs it level by level
        ("sp4_J3_raises", (1, 1, 4), 3, 4, {"grads": True}),
        ("h2_sp2_perlevel", (1, 2, 2), 2, 4, {"perlevel": True,
                                              "grads": True, "hvp": True}),
        ("h2_sp2_perlevel_opts", (1, 2, 2), 3, 4, {
            "perlevel": True, "skip_hps": (False, True, False),
            "include_scale": (True, False, True)}),
        ("sp4_ragged_w126", (1, 1, 4), 2, 2, {
            "hw": (32, 126), "grads": True, "route": "perlevel",
            "jax_inv": "single"}),
        ("h4_ragged_h126", (1, 4, 1), 2, 2, {
            "hw": (126, 32), "route": "perlevel",
            "jax_inv": "single"}),
        ("hw_conv_off", (1, 2, 2), 2, 2, {
            "conv": True, "grads": True, "route": "conv"}),
        ("sp4_conv_ragged", (1, 1, 4), 2, 2, {
            "conv": True, "hw": (32, 126), "grads": True, "route": "conv",
            "warns": "does not tile"}),
    ],
}
# sharded DTCWT options: 'perlevel' (the composed gate shrunk to force the
# per-level route), 'drop' (inverses of the forward's coefficients with
# the lowpass None, level 1's bands None, and level 0's a size-0
# placeholder), 'drop_both' (the inverse with the lowpass and the
# coarsest level None, which the JAX package refuses), 'hw' (the
# image's H and W, else IMAGE's), 'dtensor' (the input a DTensor placed as spatial_placements; its
# gradient this rank's chunk), 'conv' (set_operator_matmul(False)),
# 'cap' (the sharded operator routes' cap shrunk to this), 'route' (the
# port's route where the JAX package runs GSPMD), 'jax_inv' 'single'
# (the JAX package's sharded inverse raises on these bands, which do not
# divide its mesh: its composed plan checks only the row blocks, and its
# shard_map refuses them; the port is held to the JAX inverse without a
# mesh, which its GSPMD route would run), 'warns' (a text the forward's
# warnings must hold)
# the Selesnick DTCWT (DTCWTForward2 / DTCWTInverse2, farras, qshift_a)
# with batch data parallelism: (mesh, J, input shape), run in the world
# of 2
ALT_CASE = ((2, 1, 1), 3, (3, 2, 64, 64))

# halo cases on a world of 3 (rings of 1, 2 and 3 ranks): (ring size,
# axis, boundary, left, right, tile length)
HALO_CASES = [(n, axis, b, left, right, 5)
              for n in (1, 2, 3) for axis in (2, 3)
              for b in ("wrap", "symmetric", "zero")
              for left, right in ((2, 3), (5, 0))]
HALO_IMAGE = (2, 3, 6, 7)     # (N, C, H, W) with the axis set per case


def rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def chunk(n, parts, i):
    """(start, length) of part ``i`` of ``n`` as ``torch.chunk`` cuts."""
    s = -(-n // parts)
    start = min(n, i * s)
    return start, max(0, min(s, n - start))


def coords(world, nd, nh, ns):
    """Each rank's (data, spatial_h, spatial) coordinate: the ranks laid
    out as the mesh reshapes them."""
    return [np.unravel_index(r, (nd, nh, ns)) for r in range(world)]


def chunk_of(full, coord, mesh_shape, spec):
    """A rank's chunk of ``full``: spec names a mesh dim (0 data,
    1 spatial_h, 2 spatial) per tensor dim, or None."""
    out = full
    for d, m in enumerate(spec):
        if m is not None:
            s, k = chunk(full.shape[d], mesh_shape[m], coord[m])
            out = np.take(out, range(s, s + k), axis=d)
    return out


def spawn_world(target, world, tmp_path, *args):
    """Run ``target(rank, world, store_path, out_dir, *args)`` in
    ``world`` processes; fail on any non-zero exit or past DEADLINE.
    Returns the per-rank results ({rank: {key: array}})."""
    ctx = mp.get_context("spawn")
    store = str(tmp_path / f"store{world}")
    out = tmp_path / f"out{world}"
    out.mkdir()
    procs = [ctx.Process(target=target,
                         args=(r, world, store, str(out), *args))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + DEADLINE
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} still running after {DEADLINE} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return {r: dict(np.load(out / f"rank{r}.npz")) for r in range(world)}


def _init(rank, world, store_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)


def _run(body, rank, world, store_path, out_dir, *args):
    import torch.distributed as dist
    try:
        _init(rank, world, store_path)
        res = {}
        body(rank, world, res, *args)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


# --------------------------------------------------------------------------
# The halo exchange
# --------------------------------------------------------------------------

def halo_inputs(n, axis, left, right, L):
    shape = list(HALO_IMAGE)
    shape[axis] = n * L
    wshape = list(HALO_IMAGE)
    wshape[axis] = n * (L + left + right)
    return rand(shape, 1 + axis), rand(wshape, 11 + axis)


def _halo_body(rank, world, res):
    import torch.distributed as dist
    from pytorch_wavelets_tpu_torch.parallel import halo_exchange_1d
    groups = {n: dist.new_group(list(range(n))) for n in (1, 2, 3)}
    for case in HALO_CASES:
        n, axis, b, left, right, L = case
        if rank >= n:
            continue
        key = "/".join(map(str, case))
        x, g = halo_inputs(n, axis, left, right, L)
        xl = torch.from_numpy(x).narrow(axis, rank * L, L).clone()
        w = L + left + right
        gl = torch.from_numpy(g).narrow(axis, rank * w, w).clone()
        xl.requires_grad_()
        gl.requires_grad_()
        y = halo_exchange_1d(xl, axis, groups[n], left, right, b)
        dx, = torch.autograd.grad(y, xl, gl, create_graph=True)
        # the backward's backward is the exchange again
        u = torch.from_numpy(rand(tuple(xl.shape), 21 + rank))
        gg, = torch.autograd.grad((dx * u).sum(), gl)
        again = halo_exchange_1d(u, axis, groups[n], left, right, b)
        res[key + "/y"] = y.detach().numpy()
        res[key + "/dx"] = dx.detach().numpy()
        res[key + "/gg_err"] = np.float32((gg - again).abs().max())
    # a halo wider than the tile raises
    try:
        halo_exchange_1d(torch.zeros(1, 1, 4, 3), 3, groups[1], 4, 0)
    except ValueError:
        res["too_wide_raises"] = np.bool_(True)


def halo_worker(rank, world, store_path, out_dir):
    _run(_halo_body, rank, world, store_path, out_dir)


# --------------------------------------------------------------------------
# The sharded DTCWT
# --------------------------------------------------------------------------

def dtcwt_image(N, seed, hw=None):
    """A case's image: (N, 2, H, W), IMAGE's H and W unless ``hw``."""
    return rand((N, IMAGE[1]) + tuple(hw or IMAGE[2:]), seed)


def dtcwt_cotangents(yl_shape, yh_shapes, x_shape, rec_shape, seed):
    """The cotangents of yl and each yh (None for a skipped level), of
    the reconstruction, and a direction (the image's shape)."""
    return (rand(yl_shape, seed + 1),
            [None if s is None else rand(s, seed + 2 + j)
             for j, s in enumerate(yh_shapes)],
            rand(rec_shape, seed + 9), rand(x_shape, seed + 10))


def _local_of(full, mesh, dt):
    """This rank's chunk of ``full`` (numpy) as DTensor ``dt`` holds it."""
    from torch.distributed.tensor import Shard
    t = torch.from_numpy(full)
    names = mesh.mesh_dim_names
    for name, p in zip(names, dt.placements):
        if isinstance(p, Shard):
            n = mesh.size(names.index(name))
            s, k = chunk(full.shape[p.dim], n, mesh.get_local_rank(name))
            t = t.narrow(p.dim, s, k)
    return t


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    return [] if out is None else [out]


def _dtcwt_body(rank, world, res, cases):
    import warnings

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    import pytorch_wavelets_tpu_torch as tt
    from pytorch_wavelets_tpu_torch.ops import banded
    from pytorch_wavelets_tpu_torch.parallel import (
        LAST_PATH, make_mesh, spatial_placements,
    )
    from pytorch_wavelets_tpu_torch.parallel import sharded

    composed_gate, cap = sharded._mm_enabled, sharded._SHARDED_MM_CAP
    for seed, (name, (nd, nh, ns), J, N, opts) in enumerate(cases):
        sharded._mm_enabled = (composed_gate if not opts.get("perlevel")
                               else lambda n: False)
        sharded._SHARDED_MM_CAP = opts.get("cap", cap)
        banded.set_operator_matmul(False if opts.get("conv") else None)
        mesh = make_mesh(nd, ns, nh, device_type="cpu")
        kw = {k: (list(v) if isinstance(v, tuple) else v)
              for k, v in opts.items()
              if k in ("skip_hps", "include_scale")}
        fwd = tt.DTCWTForward(J=J, mesh=mesh, device="cpu", **kw)
        inv = tt.DTCWTInverse(mesh=mesh, device="cpu")
        x = dtcwt_image(N, 100 * seed, opts.get("hw"))
        xt = torch.from_numpy(x).requires_grad_()
        xin = xt
        if opts.get("dtensor"):
            xt = _chunk_leaf(x, mesh)
            xin = DTensor.from_local(
                xt, mesh, spatial_placements(mesh), run_check=False,
                shape=torch.Size(x.shape),
                stride=torch.from_numpy(x).stride())
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yl, yh = fwd(xin)
        res[name + "/warnings"] = np.str_(" | ".join(
            str(m.message) for m in caught))
        for j, t in enumerate(_leaves(yl)):
            res[f"{name}/yl{j}"] = t.to_local().detach().numpy()
        for j, t in enumerate(yh):
            if t is not None:
                res[f"{name}/yh{j}"] = t.to_local().detach().numpy()
        res[name + "/path"] = np.str_(LAST_PATH["dtcwt2d"])
        if opts.get("include_scale") or opts.get("skip_hps"):
            continue
        # the inverse of the forward's coefficients, from fresh leaves
        ll_loc = yl.to_local().detach().requires_grad_()
        h_locs = [h.to_local().detach().requires_grad_() for h in yh]
        yl2 = DTensor.from_local(ll_loc, mesh, yl.placements,
                                 run_check=False, shape=yl.shape,
                                 stride=yl.stride())
        yh2 = [DTensor.from_local(hl, mesh, h.placements, run_check=False,
                                  shape=h.shape, stride=h.stride())
               for hl, h in zip(h_locs, yh)]
        rec = inv((yl2, yh2))
        res[name + "/rec"] = rec.to_local().detach().numpy()
        res[name + "/ipath"] = np.str_(LAST_PATH["idtcwt2d"])
        drops = []
        if opts.get("drop"):
            drops += [("low", (None, yh2)),
                      ("level_none", (yl2, [yh2[0], None, *yh2[2:]])),
                      ("level_empty", (yl2, [torch.zeros(0), *yh2[1:]]))]
        if opts.get("drop_both"):
            drops.append(("both", (None, [*yh2[:-1], None])))
        for key, coeffs in drops:
            r = inv(coeffs)
            res[f"{name}/rec_{key}"] = r.to_local().detach().numpy()
            res[f"{name}/ipath_{key}"] = np.str_(LAST_PATH["idtcwt2d"])
        if opts.get("grads"):
            # input gradients of <yl, a> + sum_j <yh_j, b_j>, and of
            # <rec, c>
            a, bs, c, v = dtcwt_cotangents(
                tuple(yl.shape), [tuple(h.shape) for h in yh], x.shape,
                tuple(rec.shape), 100 * seed)
            loss = (yl.to_local() * _local_of(a, mesh, yl)).sum() + sum(
                (h.to_local() * _local_of(b, mesh, h)).sum()
                for h, b in zip(yh, bs))
            gx, = torch.autograd.grad(loss, xt)
            gx = gx.contiguous()
            if not opts.get("dtensor"):
                dist.all_reduce(gx)
            res[name + "/gx"] = gx.numpy()
            grads = torch.autograd.grad(
                (rec.to_local() * _local_of(c, mesh, rec)).sum(),
                [ll_loc, *h_locs])
            for j, g in enumerate(grads):
                res[f"{name}/ginv{j}"] = g.numpy()
        if opts.get("hvp"):
            yl, yh = fwd(xt)
            cubic = (yl.to_local() ** 3).sum() + sum(
                (h.to_local() ** 3).sum() for h in yh)
            g, = torch.autograd.grad(cubic, xt, create_graph=True)
            hv, = torch.autograd.grad((g * torch.from_numpy(v)).sum(), xt)
            dist.all_reduce(hv)
            res[name + "/hvp"] = hv.numpy()
    sharded._mm_enabled, sharded._SHARDED_MM_CAP = composed_gate, cap
    banded.set_operator_matmul(None)

    if world == 2:
        _alt_case(res, mesh_of=make_mesh)

    # batch_chunk is dropped beside mesh=, with a warning
    mesh = make_mesh(world, 1, 1, device_type="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tt.DTCWTForward(J=1, mesh=mesh, batch_chunk=1, device="cpu")(
            torch.zeros(2 * world, 1, 8, 8))
    res["chunk_warning"] = np.str_(" | ".join(str(m.message) for m in w))
    # a state dict moves between a mesh= module and a plain one (taps
    # scaled, so the loaded buffers are the ones that run)
    plain = tt.DTCWTForward(device="cpu")
    plain.load_state_dict({k: 1.5 * t for k, t in
                           plain.state_dict().items()})
    sharded = tt.DTCWTForward(mesh=mesh, device="cpu")
    sharded.load_state_dict(plain.state_dict())
    back = tt.DTCWTForward(device="cpu")
    back.load_state_dict(sharded.state_dict())
    z = torch.from_numpy(rand((world, 2, 32, 32), 7))
    ref = plain(z)
    res["state_dict_err"] = np.float32(max(
        (s.full_tensor() - r).abs().max().item()
        for s, r in zip(_leaves(sharded(z)), _leaves(ref))))
    res["state_dict_back_err"] = np.float32(max(
        (s - r).abs().max().item()
        for s, r in zip(_leaves(back(z)), _leaves(ref))))


def _alt_case(res, mesh_of):
    """``DTCWTForward2`` / ``DTCWTInverse2`` with ``mesh=`` (ALT_CASE):
    the outputs' local chunks, x.grad of fixed cotangents, the
    reconstruction."""
    import torch.distributed as dist

    from pytorch_wavelets_tpu_torch.transforms.dtcwt_alt import (
        DTCWTForward2, DTCWTInverse2,
    )
    (nd, nh, ns), J, shape = ALT_CASE
    mesh = mesh_of(nd, ns, nh, device_type="cpu")
    x = rand(shape, 77)
    xt = torch.from_numpy(x).requires_grad_()
    yl, yh = DTCWTForward2(J=J, mesh=mesh, device="cpu")(xt)
    leaves = [t for row in yl for t in row] + list(yh)
    for j, t in enumerate(leaves):
        res[f"alt/out{j}"] = t.to_local().detach().numpy()
    loss = sum((t.to_local() * _local_of(
        rand(tuple(t.shape), 78 + j), mesh, t)).sum()
        for j, t in enumerate(leaves))
    gx, = torch.autograd.grad(loss, xt)
    dist.all_reduce(gx)
    res["alt/gx"] = gx.numpy()
    rec = DTCWTInverse2(mesh=mesh, device="cpu")((yl, yh))
    res["alt/rec"] = rec.to_local().detach().numpy()
    res["alt/placements"] = np.str_(repr(list(rec.placements)))


def dtcwt_worker(rank, world, store_path, out_dir):
    _run(_dtcwt_body, rank, world, store_path, out_dir, DTCWT_CASES[world])


# --------------------------------------------------------------------------
# The sharded DWT, 1-D DWT and SWT
# --------------------------------------------------------------------------

# (name, kind, (n_data, n_spatial_h, n_spatial), shape, J, mode, wave,
# options) per world: kind 'dwt' (DWTForward / DWTInverse), 'dwt1d'
# (DWT1DForward / DWT1DInverse) or 'swt' (SWTForward / SWTInverse); wave a
# name, or 'db2_tuple' (dec_filters('db2')), 'bior22_tuple'
# (dec_filters('bior2.2')) or 'db2_db1' (db2 along W, db1 along H: a
# 4-tuple); options: 'conv' (the conv halo route, set_operator_matmul
# False), 'grads' (input and coefficient gradients), 'hvp', 'none' (the
# inverse of the forward with its level-0 bands None), 'fwd_only',
# 'dtensor' (the input a DTensor placed as spatial_placements, its last
# shard short; its gradient this rank's chunk), and 'raises' (the
# exception expected instead of a result)
DWT_CASES = {
    2: [
        ("dwt_zero_sp2", "dwt", (1, 1, 2), (2, 2, 32, 48), 2, "zero", "db2",
         {"grads": True}),
        ("dwt_sym_sp2_ragged", "dwt", (1, 1, 2), (2, 2, 31, 57), 2,
         "symmetric", "db2", {"grads": True}),
        ("dwt_sym_sp2_dtensor_in", "dwt", (1, 1, 2), (2, 2, 31, 57), 2,
         "symmetric", "db2", {"grads": True, "dtensor": True}),
        ("dwt_reflect_sp2_ragged", "dwt", (1, 1, 2), (2, 2, 31, 57), 2,
         "reflect", "db2", {}),
        ("dwt_zero_sp2_ragged", "dwt", (1, 1, 2), (2, 2, 31, 57), 2, "zero",
         "db3", {}),
        ("dwt_sym_sp2", "dwt", (1, 1, 2), (2, 2, 32, 48), 2, "symmetric",
         "db3", {}),
        ("dwt_reflect_sp2", "dwt", (1, 1, 2), (2, 2, 32, 48), 2, "reflect",
         "db2", {}),
        ("dwt_per_sp2", "dwt", (1, 1, 2), (2, 2, 32, 48), 2, "periodization",
         "db2", {"grads": True}),
        ("dwt_per_sp2_conv", "dwt", (1, 1, 2), (2, 2, 32, 48), 2,
         "periodization", "db2", {"grads": True, "conv": True}),
        ("dwt_per_sp2_oddh", "dwt", (1, 1, 2), (2, 2, 29, 48), 2,
         "periodization", "db2", {"grads": True}),
        ("dwt_data2_odd", "dwt", (2, 1, 1), (3, 2, 32, 48), 2, "symmetric",
         "db2", {"grads": True}),
        ("dwt_none_sp2", "dwt", (1, 1, 2), (2, 2, 31, 57), 2, "zero", "db2",
         {"none": True}),
        ("dwt_none_sp2_per", "dwt", (1, 1, 2), (2, 2, 32, 48), 2,
         "periodization", "db2", {"none": True}),
        ("dwt_tuple4_sp2", "dwt", (1, 1, 2), (2, 2, 32, 48), 2, "zero",
         "db2_db1", {}),
        ("dwt1d_zero_sp2", "dwt1d", (1, 1, 2), (2, 2, 61), 3, "zero", "db2",
         {"grads": True}),
        ("dwt1d_sym_sp2", "dwt1d", (1, 1, 2), (2, 2, 64), 2, "symmetric",
         "db3", {}),
        ("dwt1d_per_sp2", "dwt1d", (1, 1, 2), (2, 2, 64), 3, "periodization",
         "db2", {"grads": True}),
        ("dwt1d_none_sp2", "dwt1d", (1, 1, 2), (2, 2, 61), 2, "zero", "db2",
         {"none": True}),
        ("swt_per_sp2", "swt", (1, 1, 2), (2, 2, 32, 48), 2, "periodization",
         "db2", {"grads": True}),
        ("swt_per_sp2_conv", "swt", (1, 1, 2), (2, 2, 32, 48), 2,
         "periodization", "db2", {"grads": True, "conv": True}),
        ("swt_periodic_bior_sp2", "swt", (1, 1, 2), (2, 2, 32, 48), 2,
         "periodic", "bior2.2", {}),
        ("swt_per_bior_sp2_conv", "swt", (1, 1, 2), (2, 2, 32, 48), 2,
         "periodization", "bior2.2", {"conv": True}),
        ("swt_per_tuple_sp2", "swt", (1, 1, 2), (2, 2, 32, 48), 2,
         "periodization", "db2_tuple", {}),
        ("swt_per_tuple_sp2_conv", "swt", (1, 1, 2), (2, 2, 32, 48), 2,
         "periodization", "db2_tuple", {"conv": True}),
        ("swt_per_data2_odd", "swt", (2, 1, 1), (3, 2, 32, 48), 2,
         "periodization", "db2", {"grads": True}),
        ("swt_zero_sp2_ragged", "swt", (1, 1, 2), (2, 2, 31, 57), 2, "zero",
         "db2", {"grads": True}),
        ("swt_sym_sp2_ragged", "swt", (1, 1, 2), (2, 2, 31, 57), 2,
         "symmetric", "bior2.2", {}),
        ("dwt_periodic_raises", "dwt", (1, 1, 2), (2, 2, 32, 32), 2,
         "periodic", "db2", {"raises": "ValueError"}),
        ("dwt1d_periodic_raises", "dwt1d", (1, 1, 2), (2, 2, 64), 2,
         "periodic", "db2", {"raises": "ValueError"}),
        # the ids are kept from when the port raised here: the inverse's
        # least-squares merge, gathered per axis
        ("iswt_sym_raises", "swt", (1, 1, 2), (2, 2, 32, 48), 2,
         "symmetric", "db2", {"grads": True}),
        ("iswt_bior_tuple_raises", "swt", (1, 1, 2), (2, 2, 32, 48), 2,
         "periodization", "bior22_tuple", {}),
        ("iswt_reflect_sp2_ragged", "swt", (1, 1, 2), (2, 2, 31, 57), 2,
         "reflect", "db2", {}),
        ("dwt_uneven_raises", "dwt", (1, 1, 2), (2, 2, 32, 36), 2,
         "periodization", "db2", {"raises": "ValueError"}),
        ("swt_uneven_raises", "swt", (1, 1, 2), (2, 2, 32, 45), 2,
         "periodization", "db2", {"raises": "ValueError"}),
    ],
    4: [
        ("dwt_hw_sym_ragged", "dwt", (1, 2, 2), (2, 2, 31, 57), 2,
         "symmetric", "db2", {"grads": True, "hvp": True}),
        ("dwt_hw_zero", "dwt", (1, 2, 2), (2, 2, 32, 48), 2, "zero", "db3",
         {}),
        ("dwt_hw_per", "dwt", (1, 2, 2), (2, 2, 32, 48), 2, "periodization",
         "db2", {"grads": True}),
        ("dwt_sp4_gather", "dwt", (1, 1, 4), (2, 2, 32, 57), 3, "zero", "db4",
         {"grads": True}),
        ("dwt_data2_sp2_odd", "dwt", (2, 1, 2), (3, 2, 31, 57), 2,
         "symmetric", "db2", {"grads": True}),
        ("dwt_sp4_per_conv", "dwt", (1, 1, 4), (2, 2, 32, 64), 2,
         "periodization", "db2", {"grads": True, "conv": True}),
        ("dwt1d_zero_sp4", "dwt1d", (1, 1, 4), (2, 2, 61), 3, "zero", "db2",
         {"grads": True}),
        ("swt_hw_per", "swt", (1, 2, 2), (2, 2, 32, 48), 2, "periodization",
         "db2", {"grads": True}),
        ("swt_sp4_per_conv", "swt", (1, 1, 4), (2, 2, 32, 64), 2,
         "periodization", "db2", {"grads": True, "conv": True}),
        ("swt_hw_zero_ragged", "swt", (1, 2, 2), (2, 2, 31, 57), 2, "zero",
         "db2", {"grads": True}),
        ("dwt_hw_conv_raises", "dwt", (1, 2, 2), (2, 2, 32, 48), 2,
         "periodization", "db2", {"conv": True, "raises": "ValueError"}),
        ("swt_hw_conv_raises", "swt", (1, 2, 2), (2, 2, 32, 48), 2,
         "periodization", "db2", {"conv": True, "raises": "ValueError"}),
    ],
}


def dwt_wave(wave):
    """A case's ``wave``: a name, or the tuples its alias names (made
    with the port's filters)."""
    from pytorch_wavelets_tpu_torch.transforms.dwt import dec_filters
    if wave == "db2_tuple":
        return tuple(np.asarray(f) for f in dec_filters("db2"))
    if wave == "bior22_tuple":
        return tuple(np.asarray(f) for f in dec_filters("bior2.2"))
    if wave == "db2_db1":
        return tuple(np.asarray(f) for f in dec_filters("db2")[:2]
                     + dec_filters("db1")[:2])
    return wave


def dwt_rec_wave(kind, wave):
    """The inverse module's ``wave``: the SWT's takes the analysis
    filters, the DWT's the synthesis ones."""
    from pytorch_wavelets_tpu_torch.transforms.dwt import rec_filters
    w = dwt_wave(wave)
    if kind == "swt" or isinstance(w, str):
        return w
    return tuple(np.asarray(f) for f in rec_filters("db2")[:2]
                 + rec_filters("db1")[:2])


def dwt_out_leaves(out):
    """(forward leaves, inverse input) of a forward's output: the DWTs'
    (yl, yh) flattened, the SWT's list."""
    if isinstance(out, tuple):
        return [out[0], *out[1]]
    return list(out)


def _chunk_leaf(full, mesh):
    """This rank's ``torch.chunk`` of ``full`` (N over 'data', H over
    'spatial_h', W over 'spatial'), a leaf that requires grad."""
    t = torch.from_numpy(full)
    names = mesh.mesh_dim_names
    for d, name in ((0, "data"), (2, "spatial_h"), (3, "spatial")):
        if name in names:
            s, k = chunk(full.shape[d], mesh.size(names.index(name)),
                         mesh.get_local_rank(name))
            t = t.narrow(d, s, k)
    return t.clone().requires_grad_()


def _dwt_modules(tt, kind, J, mode, wave, mesh):
    w = dwt_wave(wave)
    if kind == "dwt":
        return (tt.DWTForward(J=J, wave=w, mode=mode, mesh=mesh, device="cpu"),
                tt.DWTInverse(wave=dwt_rec_wave(kind, wave), mode=mode,
                              mesh=mesh, device="cpu"))
    if kind == "dwt1d":
        return (tt.DWT1DForward(J=J, wave=w, mode=mode, mesh=mesh,
                                device="cpu"),
                tt.DWT1DInverse(wave=w, mode=mode, mesh=mesh, device="cpu"))
    return (tt.SWTForward(J=J, wave=w, mode=mode, mesh=mesh, device="cpu"),
            tt.SWTInverse(wave=w, mode=mode, mesh=mesh, device="cpu"))


def _dwt_body(rank, world, res, cases):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    import pytorch_wavelets_tpu_torch as tt
    from pytorch_wavelets_tpu_torch.ops import banded
    from pytorch_wavelets_tpu_torch.parallel import (
        LAST_PATH, make_mesh, spatial_placements,
    )

    for seed, (name, kind, (nd, nh, ns), shape, J, mode, wave,
               opts) in enumerate(cases):
        mesh = make_mesh(nd, ns, nh, device_type="cpu")
        banded.set_operator_matmul(False if opts.get("conv") else None)
        x = rand(shape, 1000 + seed)
        try:
            fwd, inv = _dwt_modules(tt, kind, J, mode, wave, mesh)
            xt = torch.from_numpy(x).requires_grad_()
            xin = xt
            if opts.get("dtensor"):
                xt = _chunk_leaf(x, mesh)
                xin = DTensor.from_local(
                    xt, mesh, spatial_placements(mesh), run_check=False,
                    shape=torch.Size(shape), stride=torch.from_numpy(
                        x).stride())
            out = fwd(xin)
            if opts.get("raises") and kind != "swt":
                inv(out)
            elif opts.get("raises"):
                inv([c.detach() for c in out])
        except (ValueError, NotImplementedError) as e:
            res[name + "/raised"] = np.str_(f"{type(e).__name__}: {e}")
            continue
        finally:
            banded.set_operator_matmul(None)
        banded.set_operator_matmul(False if opts.get("conv") else None)
        leaves = dwt_out_leaves(out)
        for j, t in enumerate(leaves):
            res[f"{name}/out{j}"] = t.to_local().detach().numpy()
        res[name + "/path"] = np.str_(LAST_PATH[
            {"dwt": "dwt2d", "dwt1d": "dwt1d", "swt": "swt2d"}[kind]])
        if opts.get("grads"):
            cts = [rand(tuple(t.shape), 2000 + 10 * seed + j)
                   for j, t in enumerate(leaves)]
            loss = sum((t.to_local() * _local_of(c, mesh, t)).sum()
                       for t, c in zip(leaves, cts))
            gx, = torch.autograd.grad(loss, xt, retain_graph=True)
            # a padded input's gradient is a view: all_reduce needs it
            # contiguous
            gx = gx.contiguous()
            if not opts.get("dtensor"):
                dist.all_reduce(gx)
            res[name + "/gx"] = gx.numpy()
        if opts.get("fwd_only"):
            banded.set_operator_matmul(None)
            continue
        # the inverse of the forward's coefficients, from fresh leaves
        locs = [t.to_local().detach().requires_grad_() for t in leaves]
        ins = [DTensor.from_local(loc, mesh, t.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
               for loc, t in zip(locs, leaves)]
        if opts.get("none"):
            ins[1] = None
        coeffs = ins if kind == "swt" else (ins[0], ins[1:])
        rec = inv(coeffs)
        res[name + "/rec"] = rec.to_local().detach().numpy()
        res[name + "/ipath"] = np.str_(LAST_PATH[
            {"dwt": "idwt2d", "dwt1d": "idwt1d", "swt": "iswt2d"}[kind]])
        if opts.get("grads"):
            c = rand(tuple(rec.shape), 3000 + seed)
            grads = torch.autograd.grad(
                (rec.to_local() * _local_of(c, mesh, rec)).sum(), locs)
            for j, g in enumerate(grads):
                res[f"{name}/ginv{j}"] = g.numpy()
        if opts.get("hvp"):
            v = torch.from_numpy(rand(shape, 4000 + seed))
            outs = dwt_out_leaves(fwd(xt))
            cubic = sum((t.to_local() ** 3).sum() for t in outs)
            g, = torch.autograd.grad(cubic, xt, create_graph=True)
            hv, = torch.autograd.grad((g * v).sum(), xt)
            hv = hv.contiguous()
            dist.all_reduce(hv)
            res[name + "/hvp"] = hv.numpy()
        banded.set_operator_matmul(None)


def dwt_worker(rank, world, store_path, out_dir):
    _run(_dwt_body, rank, world, store_path, out_dir, DWT_CASES[world])


# --------------------------------------------------------------------------
# The sharded scattering layers
# --------------------------------------------------------------------------

# (name, layer 'j2' (ScatLayerj2) or 'j1' (ScatLayer), (n_data,
# n_spatial_h, n_spatial), shape, options) per world; options:
# 'colour' (combine_colour), 'bp' (the bandpass-diagonal filters),
# 'perlevel' (the composed gate shrunk: the giant-image fronts), 'grads'
# (x.grad of a fixed cotangent), 'hvp', 'dtensor' (the input a DTensor
# placed as spatial_placements), 'conv' (set_operator_matmul(False)),
# 'route' (the port's route where the JAX package runs GSPMD) and 'warns'
# (a text the layer's warnings must hold)
SCAT_CASES = {
    2: [
        ("j2_sp2", "j2", (1, 1, 2), (2, 2, 64, 64), {"grads": True,
                                                     "hvp": True}),
        ("j2_data2_b3", "j2", (2, 1, 1), (3, 2, 64, 64), {"grads": True}),
        ("j2_sp2_dtensor", "j2", (1, 1, 2), (2, 2, 64, 48),
         {"grads": True, "dtensor": True}),
        ("j1_sp2_odd", "j1", (1, 1, 2), (2, 2, 15, 31), {"grads": True}),
        ("j2_colour_sp2", "j2", (1, 1, 2), (2, 3, 64, 64), {"colour": True,
                                                            "grads": True}),
        ("j1_colour_sp2", "j1", (1, 1, 2), (2, 3, 32, 32), {"colour": True}),
        ("j2_giant_sp2", "j2", (1, 1, 2), (2, 2, 64, 64),
         {"perlevel": True, "grads": True, "hvp": True}),
        ("j1_giant_sp2", "j1", (1, 1, 2), (2, 2, 32, 64),
         {"perlevel": True, "grads": True}),
        # the ids of the cases named *raise* are kept from when the port
        # raised there (the JAX package runs GSPMD)
        ("j2_bp_raises", "j2", (1, 1, 2), (2, 2, 64, 64), {
            "bp": True, "grads": True, "route": "conv"}),
        ("j2_not8_raises", "j2", (1, 1, 2), (2, 2, 60, 64),
         {"route": "matmul", "grads": True}),
        ("j2_dtensor_not8", "j2", (1, 1, 2), (2, 2, 60, 44),
         {"dtensor": True, "grads": True, "route": "perlevel"}),
        ("j1_bp_sp2", "j1", (1, 1, 2), (2, 2, 32, 32), {
            "bp": True, "grads": True, "route": "conv"}),
    ],
    4: [
        ("j2_hw", "j2", (1, 2, 2), (2, 2, 64, 64), {"grads": True,
                                                    "hvp": True}),
        ("j2_data2_sp2_odd", "j2", (2, 1, 2), (3, 2, 64, 64),
         {"grads": True}),
        ("j2_colour_data2_sp2_odd", "j2", (2, 1, 2), (3, 3, 64, 64),
         {"colour": True}),
        ("j2_sp4_wide_halo", "j2", (1, 1, 4), (2, 1, 64, 32),
         {"grads": True}),
        ("j2_giant_hw", "j2", (1, 2, 2), (2, 2, 64, 64),
         {"perlevel": True, "grads": True}),
        ("j1_giant_hw", "j1", (1, 2, 2), (2, 2, 32, 32), {"perlevel": True}),
        ("j1_tiles_raise", "j1", (1, 1, 4), (2, 2, 32, 34),
         {"grads": True, "route": "perlevel"}),
        ("j2_giant_tiles_raise", "j2", (1, 1, 4), (2, 2, 64, 72),
         {"perlevel": True, "route": "perlevel"}),
        ("j2_bp_hw", "j2", (1, 2, 2), (2, 2, 64, 64), {
            "bp": True, "grads": True, "route": "conv"}),
        ("j2_conv_off_sp4", "j2", (1, 1, 4), (2, 2, 64, 64), {
            "conv": True, "route": "conv"}),
        ("j2_bp_ragged", "j2", (1, 1, 4), (2, 2, 64, 56), {
            "bp": True, "grads": True, "route": "conv",
            "warns": "does not tile"}),
    ],
}


def scat_layer_kw(opts):
    """The scattering layer's keyword arguments of a case."""
    kw = {"combine_colour": True} if opts.get("colour") else {}
    if opts.get("bp"):
        kw.update(biort="near_sym_b_bp", qshift="qshift_b_bp")
    return kw


def _scat_body(rank, world, res, cases):
    import warnings

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    import pytorch_wavelets_tpu_torch as tt
    from pytorch_wavelets_tpu_torch.ops import banded
    from pytorch_wavelets_tpu_torch.parallel import (
        LAST_PATH, make_mesh, spatial_placements,
    )
    from pytorch_wavelets_tpu_torch.parallel import sharded_scat

    composed_gate = sharded_scat._mm_enabled
    for seed, (name, layer, (nd, nh, ns), shape, opts) in enumerate(cases):
        sharded_scat._mm_enabled = (composed_gate if not opts.get("perlevel")
                                    else lambda n: False)
        banded.set_operator_matmul(False if opts.get("conv") else None)
        mesh = make_mesh(nd, ns, nh, device_type="cpu")
        kw = scat_layer_kw(opts)
        if layer == "j1":
            kw.pop("qshift", None)
        m = (tt.ScatLayerj2 if layer == "j2" else tt.ScatLayer)(
            mesh=mesh, device="cpu", **kw)
        x = rand(shape, 500 + seed)
        xt = torch.from_numpy(x).requires_grad_()
        xin = xt
        if opts.get("dtensor"):
            xt = _chunk_leaf(x, mesh)
            xin = DTensor.from_local(
                xt, mesh, spatial_placements(mesh), run_check=False,
                shape=torch.Size(shape),
                stride=torch.from_numpy(x).stride())
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = m(xin)
        res[name + "/warnings"] = np.str_(" | ".join(
            str(w.message) for w in caught))
        res[name + "/out"] = out.to_local().detach().numpy()
        res[name + "/path"] = np.str_(LAST_PATH["scat_" + layer])
        if opts.get("grads"):
            ct = rand(tuple(out.shape), 600 + seed)
            gx, = torch.autograd.grad(
                (out.to_local() * _local_of(ct, mesh, out)).sum(), xt)
            gx = gx.contiguous()
            if not opts.get("dtensor"):
                dist.all_reduce(gx)
            res[name + "/gx"] = gx.numpy()
        if opts.get("hvp"):
            v = torch.from_numpy(rand(shape, 700 + seed))
            g, = torch.autograd.grad((m(xt).to_local() ** 3).sum(), xt,
                                     create_graph=True)
            hv, = torch.autograd.grad((g * v).sum(), xt)
            dist.all_reduce(hv)
            res[name + "/hvp"] = hv.numpy()
    sharded_scat._mm_enabled = composed_gate
    banded.set_operator_matmul(None)

    # batch_chunk is dropped beside mesh=, with a warning
    mesh = make_mesh(world, 1, 1, device_type="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for cls in (tt.ScatLayerj2, tt.ScatLayer):
            cls(mesh=mesh, batch_chunk=1, device="cpu")(
                torch.zeros(2 * world, 1, 16, 16))
    res["chunk_warning"] = np.str_(" | ".join(str(m.message) for m in w))


def scat_worker(rank, world, store_path, out_dir):
    _run(_scat_body, rank, world, store_path, out_dir, SCAT_CASES[world])
