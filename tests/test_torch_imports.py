"""The port stands alone: no JAX, no JAX package, and CPU tensors take the
plain PyTorch versions without launching anything."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pytorch_wavelets_tpu_torch as tt
from pytorch_wavelets_tpu_torch import ops
from pytorch_wavelets_tpu_torch.ops import precision

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "pytorch_wavelets_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module == "pytorch_wavelets_tpu"
            or module.startswith("pytorch_wavelets_tpu."))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_forbidden_matches_exact_names():
    assert _forbidden("pytorch_wavelets_tpu.ops")
    assert not _forbidden("pytorch_wavelets_tpu_torch.ops")
    assert not _forbidden("jaxlib_free")


def test_imports_and_runs_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "sys.modules['pytorch_wavelets_tpu'] = None\n"
        "import torch, pytorch_wavelets_tpu_torch as tt\n"
        "x = torch.randn(1, 1, 16, 16)\n"
        "y = tt.DTCWTForward(J=2, device='cpu')(x)\n"
        "r = tt.DTCWTInverse(device='cpu')(y)\n"
        "assert (r - x).abs().max() < 1e-5\n"
        "c = tt.SWTForward(J=2, wave='db4', device='cpu')(x)\n"
        "r = tt.SWTInverse(wave='db4', device='cpu')(c)\n"
        "assert (r - x).abs().max() < 1e-5\n"
        "from pytorch_wavelets_tpu_torch import transforms as tr\n"
        "c = tr.DTCWTForward2(J=2, device='cpu')(x)\n"
        "r = tr.DTCWTInverse2(device='cpu')(c)\n"
        "assert (r - x).abs().max() < 1e-5\n"
        "from pytorch_wavelets_tpu_torch import parallel\n"
        "assert parallel.sharded_dtcwt2d and parallel.make_mesh\n"
        "assert all(getattr(parallel, 'sharded_' + n) for n in ('dwt2d', "
        "'idwt2d', 'dwt1d', 'idwt1d', 'swt2d', 'iswt2d'))\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in "
        "sys.modules if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)


def test_cpu_tensors_take_plain_versions():
    ops.reset_launches()
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 2, 32, 32).astype(np.float32))
    f, i = tt.DTCWTForward(J=2, device="cpu"), tt.DTCWTInverse(device="cpu")
    i(f(x))
    tt.ScatLayerj2(device="cpu")(torch.cat([x, x[:, :1]], dim=1))
    tt.DWTInverse(device="cpu")(tt.DWTForward(J=2, device="cpu")(x))
    tt.DWT1DInverse(device="cpu")(tt.DWT1DForward(J=2, device="cpu")(x[0]))
    tt.ScatLayerj2(biort="near_sym_b_bp", qshift="qshift_b_bp",
                   device="cpu")(x)
    # the SWT, its backward, and a row past 2048 (the FFT merge, K13)
    for shape in ((1, 2, 32, 32), (1, 1, 2, 2056)):
        xs = torch.zeros(shape, requires_grad=True)
        c = tt.SWTForward(J=2, device="cpu")(xs)
        torch.autograd.grad(tt.SWTInverse(device="cpu")(c).sum(), xs)
    # the Selesnick DTCWT, the non-separable and the à trous merge
    from pytorch_wavelets_tpu_torch.transforms import dtcwt_alt
    xs = x.clone().requires_grad_()
    c = dtcwt_alt.DTCWTForward2(J=2, device="cpu")(xs)
    torch.autograd.grad(dtcwt_alt.DTCWTInverse2(device="cpu")(c).sum(), xs)
    from pytorch_wavelets_tpu_torch.filters import qshift
    q = qshift("qshift_a")
    bank = (q[0], q[4], q[1], q[5])
    torch.autograd.grad(dtcwt_alt.quad_afb2d_nonsep(xs, *bank)[0].sum(), xs)
    y = ops.afb2d_nonsep(xs, [0.5, 0.5], [0.5, -0.5])
    ops.sfb2d_nonsep(y, [0.5, 0.5], [0.5, -0.5])
    ops.sfb2d_atrous(torch.stack([x] * 4, 2), [1, 1], [1, -1], [1, 1],
                     [1, -1])
    # every matmul precision level, and bf16 (K17's modes on the card)
    for level in ("high", "default"):
        with tt.matmul_precision(level):
            i(f(x))
    i(f(x.to(torch.bfloat16)))
    # a Hessian-vector product (K18's plain version, the backwards' own
    # backwards)
    xs = torch.cat([x, x[:, :1]], dim=1).requires_grad_()
    g, = torch.autograd.grad(tt.ScatLayerj2(device="cpu")(xs).square().sum(),
                             xs, create_graph=True)
    torch.autograd.grad(g.sum(), xs)
    # K19's plain versions: a window and its adjoint along both axes
    from pytorch_wavelets_tpu_torch.ops import halo
    for axis in (2, 3):
        per = x.numel() // x.shape[axis]
        tail, head = x.new_empty(per * 2), x.new_empty(per * 3)
        halo.halo_pack(x, axis, 2, 3, tail, head)
        w = halo.halo_assemble(
            x, axis, 2, 3, "recv", "flip", tail, None,
            x.new_empty(halo.block_shape(x, axis, x.shape[axis] + 5)))
        halo.halo_fold(w, axis, 2, 3, "zero", "recv", None,
                       x.new_zeros(per * 2))
    # the sharded conv route's windows (K6, K7, K12, K16 wrappers)
    h = np.array([0.5, 0.5])
    ops.afb1d_window(x, h, h, 3, 0, 8)
    ops.sfb1d_window(x, x, h, h, 3, 1, 8)
    ops.afb1d_atrous_window(x, h, h, 3, 2)
    ops.sfb1d_atrous_window(x, x, h, h, 2, 2)
    assert ops.launch_counts() == {k.__name__: 0 for k in ops.KERNELS}
    assert set(ops.launch_counts()) == {
        "apply_row", "apply_col", "q2c_pack", "c2q_unpack", "scat_mag_fwd",
        "scat_mag_bwd", "scat_mag_bwd2", "afb1d_corr", "sfb1d_conv", "dtcwt_filt",
        "dtcwt_dfilt", "dtcwt_ifilt", "avg_pool2_fwd", "avg_pool2_bwd",
        "afb1d_atrous_corr", "afb1d_atrous_adjoint", "spec_merge",
        "spec_split", "nonsep_afb", "nonsep_afb_adjoint", "nonsep_sfb",
        "nonsep_sfb_adjoint", "sfb1d_atrous_conv", "sfb1d_atrous_adjoint",
        "apply_row_tf32", "apply_col_tf32", "apply_row_3xtf32",
        "apply_col_3xtf32", "apply_row_bf16", "apply_col_bf16",
        "halo_pack", "halo_assemble", "halo_fold", "afb1d_window",
        "sfb1d_window", "afb1d_atrous_window", "sfb1d_atrous_window"}


def test_parallel_files_are_checked():
    """The sharded layer's modules are among the files whose imports are
    checked, and it imports no JAX-side name (the mesh, the halo, the
    sharded operators and transforms)."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for mod in ("__init__", "mesh", "halo", "banded_shard", "sharded",
                "sharded_dwt", "sharded_scat", "sharded_conv"):
        assert f"pytorch_wavelets_tpu_torch/parallel/{mod}.py" in names


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.DTCWTForward()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.DTCWTInverse()
    for cls in (tt.SWTForward, tt.SWTInverse):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls()


def test_device_mismatch_raises():
    f = tt.DTCWTForward(J=1, device="cpu")
    with pytest.raises(ValueError, match="is on cpu"):
        f(torch.zeros(1, 1, 8, 8, device="meta"))


def test_precision_dial():
    assert tt.get_matmul_precision() == "highest"
    with tt.matmul_precision("high"):
        assert tt.get_matmul_precision() == "high"
        # on the card the levels are K17's modes
        assert ops.banded.kernel_mode(torch.float32) == "3xtf32"
        assert ops.banded.kernel_mode(torch.bfloat16) == "bf16"
        # the CPU path is the plain version, which has no TF32
        tt.DTCWTForward(J=1, device="cpu")(torch.zeros(1, 1, 8, 8))
        with precision.plain_flags():
            assert not torch.backends.cuda.matmul.allow_tf32
    with tt.matmul_precision("default"):
        assert ops.banded.kernel_mode(torch.float32) == "tf32"
    assert ops.banded.kernel_mode(torch.float32) == "fp32"
    assert tt.get_matmul_precision() == "highest"
    with pytest.raises(ValueError):
        tt.set_matmul_precision("fast")
    with precision.plain_flags():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
