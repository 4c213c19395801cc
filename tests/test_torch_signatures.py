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
    """A positive chunk constructs.  Beside ``mesh=`` the scattering
    layers raise, naming A5 (their sharded paths are not ported); the
    DTCWT modules take a ``DeviceMesh`` (and drop the chunk with a
    warning when called, test_dtcwt_mesh_world_of_one) and raise on
    anything else."""
    getattr(tt, name)(batch_chunk=8, device="cpu")
    if name.startswith("DTCWT"):
        with pytest.raises(TypeError, match="DeviceMesh"):
            getattr(tt, name)(batch_chunk=8, mesh=object(), device="cpu")
        return
    with pytest.raises(NotImplementedError, match="A5"):
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


def test_positional_call_binds_like_jax():
    """A JAX-order positional call: mesh and coeff_dtype land where the
    JAX package puts them."""
    f = tt.DWTForward(2, "db2", "symmetric", None, "bfloat16", "cpu")
    assert (f.J, f.mode, f.coeff_dtype) == (2, "symmetric", torch.bfloat16)
    i = tt.SWTInverse("db2", "zero", None, False, "cpu")
    assert (i.mode, i.upcast) == ("zero", False)
    with pytest.raises(NotImplementedError):
        tt.DWTInverse("db1", "zero", object(), "cpu")
