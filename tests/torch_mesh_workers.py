"""Multi-process helpers of the port's sharded tests
(tests/test_torch_halo.py, tests/test_torch_sharded_dtcwt.py).

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
    ],
    4: [
        ("data2_sp2_odd", (2, 1, 2), 2, 3, {"grads": True}),
        ("h2_sp2_J1", (1, 2, 2), 1, 4, {}),
        ("h2_sp2_J2", (1, 2, 2), 2, 4, {"grads": True, "hvp": True}),
        ("h2_sp2_opts", (1, 2, 2), 2, 4, {"skip_hps": (True, False),
                                          "include_scale": True}),
        ("h4_J3_gather", (1, 4, 1), 3, 4, {"grads": True}),
        ("sp4_J3_raises", (1, 1, 4), 3, 4, {"raises": True}),
    ],
}

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

def dtcwt_inputs(J, N, seed):
    """The image, the cotangents of yl and each yh (default layout, the
    yh of an unskipped level), of the reconstruction, and a direction."""
    shape = (N,) + IMAGE[1:]
    x = rand(shape, seed)
    a = rand((N, 2, 64 >> (J - 1), 64 >> (J - 1)), seed + 1)
    bs = [rand((N, 2, 6, 64 >> (j + 1), 64 >> (j + 1), 2), seed + 2 + j)
          for j in range(J)]
    c = rand(shape, seed + 9)
    v = rand(shape, seed + 10)
    return x, a, bs, c, v


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
    from pytorch_wavelets_tpu_torch.parallel import LAST_PATH, make_mesh

    for seed, (name, (nd, nh, ns), J, N, opts) in enumerate(cases):
        mesh = make_mesh(nd, ns, nh, device_type="cpu")
        kw = {k: (list(v) if isinstance(v, tuple) else v)
              for k, v in opts.items()
              if k in ("skip_hps", "include_scale")}
        fwd = tt.DTCWTForward(J=J, mesh=mesh, device="cpu", **kw)
        inv = tt.DTCWTInverse(mesh=mesh, device="cpu")
        x, a, bs, c, v = dtcwt_inputs(J, N, 100 * seed)
        if opts.get("raises"):
            try:
                fwd(torch.from_numpy(x))
            except NotImplementedError as e:
                res[name + "/raised"] = np.str_(str(e))
            continue
        xt = torch.from_numpy(x).requires_grad_()
        yl, yh = fwd(xt)
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
        if not opts.get("grads"):
            continue
        # input gradients of <yl, a> + sum_j <yh_j, b_j>, and of <rec, c>
        loss = (yl.to_local() * _local_of(a, mesh, yl)).sum() + sum(
            (h.to_local() * _local_of(b, mesh, h)).sum()
            for h, b in zip(yh, bs))
        gx, = torch.autograd.grad(loss, xt)
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


def dtcwt_worker(rank, world, store_path, out_dir):
    _run(_dtcwt_body, rank, world, store_path, out_dir, DTCWT_CASES[world])
