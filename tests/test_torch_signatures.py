"""The port's modules take the JAX package's parameters, in its order,
then ``device``: a positional call written for the JAX package binds the
same arguments in the port.  ``batch_chunk`` None, False and 0 are "off"
in both packages (tests/test_torch_batch_chunk.py has the chunks); a
positive chunk beside ``mesh=`` raises where ``mesh=`` is not ported, and
the DTCWT modules run sharded on a ``DeviceMesh``."""
import inspect

import pytest
import torch

import pytorch_wavelets_tpu as tw
import pytorch_wavelets_tpu.transforms as jtr
import pytorch_wavelets_tpu_torch as tt
import pytorch_wavelets_tpu_torch.transforms as ptr

MODULES = ("DWTForward", "DWTInverse", "DWT1DForward", "DWT1DInverse",
           "SWTForward", "SWTInverse", "DTCWTForward", "DTCWTInverse",
           "ScatLayer", "ScatLayerj2", "DTCWTForward2", "DTCWTInverse2")


def _pair(name):
    if name.endswith("2") and name.startswith("DTCWT"):
        return getattr(jtr, name), getattr(ptr, name)
    return getattr(tw, name), getattr(tt, name)


@pytest.mark.parametrize("name", MODULES)
def test_signature_is_jax_then_device(name):
    jcls, pcls = _pair(name)
    jp = list(inspect.signature(jcls).parameters.values())
    pp = list(inspect.signature(pcls).parameters.values())
    assert [p.name for p in pp] == [p.name for p in jp] + ["device"]
    for a, b in zip(jp, pp):
        assert (a.kind, a.default) == (b.kind, b.default), a.name
    assert pp[-1].default == "cuda"


@pytest.mark.parametrize("name", ["DTCWTForward", "DTCWTInverse",
                                  "ScatLayer", "ScatLayerj2"])
@pytest.mark.parametrize("chunk", [None, False, 0])
def test_batch_chunk_off(name, chunk):
    """None, False and 0 all mean "off" (JAX models/_base.py:117-124)."""
    m = getattr(tt, name)(batch_chunk=chunk, device="cpu")
    x = torch.zeros(1, 3, 16, 16)
    if name == "DTCWTInverse":
        x = tt.DTCWTForward(J=1, device="cpu")(x)
    m(x)


@pytest.mark.parametrize("name", ["DTCWTForward", "DTCWTInverse",
                                  "ScatLayer", "ScatLayerj2"])
def test_positive_batch_chunk_raises(name):
    """A positive chunk constructs.  Beside ``mesh=`` the DTCWT modules
    and the scattering layers take a ``DeviceMesh`` (and drop the chunk
    with a warning when called, test_dtcwt_mesh_world_of_one,
    test_scat_mesh_world_of_one) and raise on anything else."""
    getattr(tt, name)(batch_chunk=8, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        getattr(tt, name)(batch_chunk=8, mesh=object(), device="cpu")


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


def test_dtcwt_mesh_world_of_one(world_of_one):
    """``mesh=`` on the DTCWT modules, in the JAX package's position: on a
    (1, 1) mesh the sharded path gives the unsharded results bit for bit,
    as DTensors, and a positive ``batch_chunk`` is dropped with the JAX
    package's warning."""
    x = torch.randn(2, 3, 32, 32)
    f = tt.DTCWTForward(J=2, mesh=world_of_one, batch_chunk=1, device="cpu")
    i = tt.DTCWTInverse(mesh=world_of_one, batch_chunk=1, device="cpu")
    with pytest.warns(UserWarning, match="batch_chunk ignored"):
        yl, yh = f(x)
    with pytest.warns(UserWarning, match="batch_chunk ignored"):
        rec = i((yl, yh))
    ryl, ryh = tt.DTCWTForward(J=2, device="cpu")(x)
    assert torch.equal(yl.to_local(), ryl)
    assert all(torch.equal(a.to_local(), b) for a, b in zip(yh, ryh))
    assert torch.equal(rec.to_local(), tt.DTCWTInverse(device="cpu")(
        (ryl, ryh)))


@pytest.mark.parametrize("layer", ["ScatLayer", "ScatLayerj2"])
def test_scat_mesh_world_of_one(world_of_one, layer):
    """``mesh=`` on the scattering layers: on a (1, 1) mesh the sharded
    fronts give the layer without a mesh bit for bit, as a DTensor, and a
    positive ``batch_chunk`` is dropped with the JAX package's
    warning."""
    x = torch.randn(2, 3, 32, 40)
    m = getattr(tt, layer)(mesh=world_of_one, batch_chunk=1, device="cpu")
    with pytest.warns(UserWarning, match="batch_chunk ignored"):
        out = m(x)
    assert torch.equal(out.to_local(), getattr(tt, layer)(device="cpu")(x))


@pytest.mark.parametrize("kind", ["dwt", "dwt1d"])
@pytest.mark.parametrize("mode", ["reflect", "symmetric", "zero",
                                  "periodization"])
def test_dwt_mesh_input_gradient(world_of_one, kind, mode):
    """What ``mesh=`` does to the DWT's input gradient (the README's
    multi-GPU paragraph, the ``DWTForward`` / ``DWT1DForward``
    docstrings): with a mesh it is the exact adjoint of the forward (the
    sharded operators' autodiff), without one the reference's backward.
    The two differ in 'reflect' and 'symmetric' by more than 1e-2 of the
    gradient's size, and agree within 2e-6 in 'zero' and
    'periodization'.  Both are the JAX package's."""
    x = torch.randn(2, 2, 40, 72, generator=torch.Generator().manual_seed(3))
    cls = tt.DWTForward
    if kind == "dwt1d":
        x, cls = x[:, :, 0].contiguous(), tt.DWT1DForward
    grads = []
    for mesh in (None, world_of_one):
        z = x.clone().requires_grad_()
        yl, yh = cls(J=3, wave="db4", mode=mode, mesh=mesh, device="cpu")(z)
        leaves = [t if mesh is None else t.to_local() for t in (yl, *yh)]
        grads.append(torch.autograd.grad(
            sum((t ** 2).sum() for t in leaves), z)[0])
    diff = float((grads[0] - grads[1]).abs().max())
    if mode in ("zero", "periodization"):
        assert diff <= 2e-6
    else:
        assert diff > 1e-2 * float(grads[0].abs().max())


def test_positional_call_binds_like_jax():
    """A JAX-order positional call: mesh and coeff_dtype land where the
    JAX package puts them."""
    f = tt.DWTForward(2, "db2", "symmetric", None, "bfloat16", "cpu")
    assert (f.J, f.mode, f.coeff_dtype) == (2, "symmetric", torch.bfloat16)
    i = tt.SWTInverse("db2", "zero", None, False, "cpu")
    assert (i.mode, i.upcast) == ("zero", False)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tt.DWTInverse("db1", "zero", object(), "cpu")


@pytest.mark.parametrize("kind", ["dwt", "dwt1d", "swt"])
def test_dwt_swt_mesh_world_of_one(world_of_one, kind):
    """``mesh=`` on the six DWT / SWT modules, in the JAX package's
    position: on a (1, 1) mesh the sharded operator route gives the
    results without a mesh, as DTensors."""
    x = torch.randn(2, 3, 32, 32) if kind != "dwt1d" else torch.randn(
        2, 3, 64)
    fwd, inv = {"dwt": (tt.DWTForward, tt.DWTInverse),
                "dwt1d": (tt.DWT1DForward, tt.DWT1DInverse),
                "swt": (tt.SWTForward, tt.SWTInverse)}[kind]
    mode = "periodization" if kind == "swt" else "symmetric"
    f = fwd(2, "db2", mode, world_of_one, None, "cpu")
    i = inv("db2", mode, world_of_one, device="cpu")
    out = f(x)
    ref = fwd(2, "db2", mode, device="cpu")(x)
    if kind == "swt":
        got, want = list(out), list(ref)
    else:
        got, want = [out[0], *out[1]], [ref[0], *ref[1]]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.to_local(), b, atol=1e-5, rtol=0)
    rec = i(out)
    torch.testing.assert_close(rec.to_local(), x, atol=1e-4, rtol=0)


def test_parallel_exports_the_jax_entries():
    """``parallel`` exports every sharded entry of the JAX package."""
    import pytorch_wavelets_tpu.parallel as jp
    from pytorch_wavelets_tpu_torch import parallel as pp
    want = {n for n in jp.__all__ if n.startswith("sharded_")}
    assert want - set(pp.__all__) == set()
    assert all(callable(getattr(pp, n)) for n in pp.__all__
               if n.startswith("sharded_"))


def test_dwt_swt_mesh_coeff_dtype(world_of_one):
    """``coeff_dtype`` narrows the bands and the inverses upcast them with
    ``mesh=`` as without it."""
    x = torch.randn(2, 3, 32, 32)
    yl, yh = tt.DWTForward(2, "db2", "zero", world_of_one, "bfloat16",
                           "cpu")(x)
    assert yl.dtype == torch.float32
    assert all(h.dtype == torch.bfloat16 for h in yh)
    rec = tt.DWTInverse("db2", "zero", world_of_one, "cpu")((yl, yh))
    assert rec.dtype == torch.float32 and rec.shape == x.shape
    cs = tt.SWTForward(2, "db2", "periodization", world_of_one, "bfloat16",
                       "cpu")(x)
    assert all(c.dtype == torch.bfloat16 for c in cs)
    rec = tt.SWTInverse("db2", "periodization", world_of_one, True,
                        "cpu")(cs)
    assert rec.dtype == torch.float32
    torch.testing.assert_close(rec.to_local(), x, atol=0.1, rtol=0)
