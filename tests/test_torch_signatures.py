"""The port's modules take the JAX package's parameters, in its order,
then ``device``: a positional call written for the JAX package binds the
same arguments in the port.  ``batch_chunk`` None, False and 0 are "off"
in both packages (tests/test_torch_batch_chunk.py has the chunks); a
positive chunk beside ``mesh=`` raises, as ``mesh=`` is not ported."""
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
    """A positive chunk constructs; with ``mesh=`` it raises, naming A5
    (the JAX package would drop the chunk there, with a warning, for its
    sharded path)."""
    getattr(tt, name)(batch_chunk=8, device="cpu")
    with pytest.raises(NotImplementedError, match="A5"):
        getattr(tt, name)(batch_chunk=8, mesh=object(), device="cpu")


def test_positional_call_binds_like_jax():
    """A JAX-order positional call: mesh and coeff_dtype land where the
    JAX package puts them."""
    f = tt.DWTForward(2, "db2", "symmetric", None, "bfloat16", "cpu")
    assert (f.J, f.mode, f.coeff_dtype) == (2, "symmetric", torch.bfloat16)
    i = tt.SWTInverse("db2", "zero", None, False, "cpu")
    assert (i.mode, i.upcast) == ("zero", False)
    with pytest.raises(NotImplementedError):
        tt.DWTInverse("db1", "zero", object(), "cpu")
