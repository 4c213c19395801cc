"""The port's ``utils/profiling.py`` on the CPU: ``time_op`` chains its
function and returns seconds a call, ``mpix_per_s`` and ``coeff_loss``
as the JAX package's (``coeff_loss`` of the same coefficients equal to
its value), and ``trace`` writes a trace file."""
import pytest
import torch

import jax.numpy as jnp

import pytorch_wavelets_tpu as tw
from pytorch_wavelets_tpu.utils import profiling as jprof

import pytorch_wavelets_tpu_torch as tt
from pytorch_wavelets_tpu_torch.utils import profiling as prof
from tests.torch_parity import rand

torch.set_num_threads(1)


def test_time_op_chains_and_times():
    calls = []

    def fn(z):
        calls.append(z)
        return z + 1.0

    x = torch.zeros(8, 8)
    s = prof.time_op(fn, x, repeats=5, iters=2)
    assert 0 < s < 1.0
    # one untimed chain and two timed ones, each fed by its own output
    assert len(calls) == 15
    assert float(calls[4].max()) == 4.0
    s2 = prof.time_op(lambda z: z @ z, torch.eye(64), repeats=3, iters=1,
                      device="cpu")
    assert s2 > 0


def test_mpix_per_s():
    assert prof.mpix_per_s((10, 10, 128, 128), 0.5) == pytest.approx(
        jprof.mpix_per_s((10, 10, 128, 128), 0.5))
    assert prof.mpix_per_s((1000, 1000), 1.0) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["DWTForward", "DTCWTForward",
                                  "SWTForward"])
def test_coeff_loss_matches_jax(name):
    """Tuples with lists (DWT, DTCWT with a skipped level's None) and
    lists (SWT)."""
    x = rand((2, 3, 16, 16), 6)
    kw = dict(J=2)
    if name == "DTCWTForward":
        kw["skip_hps"] = [True, False]
    ref = float(jprof.coeff_loss(getattr(tw, name)(**kw)(jnp.asarray(x))))
    got = prof.coeff_loss(getattr(tt, name)(device="cpu", **kw)(
        torch.from_numpy(x)))
    assert float(got) == pytest.approx(ref, rel=1e-5)
    assert prof.coeff_loss([None, torch.ones(3)]) == 3


def test_trace_writes_a_file(tmp_path):
    with prof.trace(str(tmp_path / "t")) as p:
        torch.ones(4).sum()
    assert p.key_averages() is not None
    files = list((tmp_path / "t").glob("trace-*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
