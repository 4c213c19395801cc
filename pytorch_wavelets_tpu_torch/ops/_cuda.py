"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
build runs at first use, from the package's sources alone, one ``nvcc``
per source, all started together, into ``build/kernels/`` at the root of
the checkout.  A library's file
name carries a hash of its source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source is rebuilt.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import inspect
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["build", "library", "check", "check_inputs", "stream_of",
           "via_fp32", "cast", "BUILD_DIR"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C signatures: every pointer and the stream as c_void_p, sizes as int,
# strides as int64, scalars as float.  Each launcher returns
# cudaGetLastError(); K2's, K3's, K11's, K13's and K19's also write the
# variant they launched through an int pointer.  K19's take a host array of
# parts (ops/halo.py:_Part) and their count.
_SIGNATURES = {
    "banded_apply": {
        "banded_apply_col": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _L, _L, _L, _L, _I, _I, _I, _P],
        "banded_apply_row": [_P, _P, _P, _P, _P, _L, _I, _I, _L, _L, _I,
                             _I, _P],
        "banded_apply_tile_rows": [],
        "banded_apply_k_align": [],
    },
    "banded_apply_tc": {
        "banded_tc_col": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _L, _L, _L, _L, _I, _I, _I, _P],
        "banded_tc_row": [_P, _P, _P, _P, _P, _L, _I, _I, _L, _L, _I, _I,
                          _I, _P],
        "banded_tc_tile_rows": [],
        "banded_tc_k_align": [],
    },
    "q2c_pack": {
        "q2c_pack": [_P, _P, _L, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L,
                     _L, _L, _L, _L, _F, _L, _L, _L, _L, _L, _L, _I, _P,
                     _P],
    },
    "c2q_unpack": {
        "c2q_unpack": [_P, _P, _L, _I, _I, _I, _I, _I,
                       _L, _L, _L, _L, _L, _L,
                       _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _P, _P],
    },
    "scat_mag": {
        "scat_mag_fwd": [_P, _P, _L, _I, _I, _I, _I,
                         _L, _L, _L, _L, _L, _L, _F, _F, _I, _P],
        "scat_mag_bwd": [_P, _P, _P, _L, _I, _I, _I, _I,
                         _L, _L, _L, _L, _L, _L,
                         _L, _L, _L, _L, _L, _F, _I, _P],
        "scat_mag_bwd2": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                          *[_L] * 17, _F, _I, _P],
    },
    "dwt_afb": {
        "dwt_afb": [_P, _P, _P, _P, _I, _L, _I, _I, _I, _L, _L, _L, _L,
                    _I, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _I, _I,
                    _P],
    },
    "dwt_sfb": {
        "dwt_sfb": [_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _L, _L, _L, _L,
                    _L, _L, _L, _L, _I, _I, _I, _I, _I, _I,
                    _L, _L, _L, _L, _I, _I, _P],
    },
    "dtcwt_filt": {
        "dtcwt_filt": [_P, _P, _P, _I, _L, _I, _I, _I, _L, _L, _L, _L,
                       _I, _I, _I, _I, _L, _L, _L, _L, _P],
    },
    "dtcwt_dfilt": {
        "dtcwt_dfilt": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _I,
                        _L, _L, _L, _L, _I, _L, _L, _L, _L, _I, _I, _P],
    },
    "dtcwt_ifilt": {
        "dtcwt_ifilt": [_P, _P, _P, *[_I] * 7, _L, _I, _I, _I,
                        _L, _L, _L, _L, _I, _I, _I, _L, _L, _L, _L, _P],
    },
    "avg_pool2": {
        "avg_pool2_fwd": [_P, _P, _L, _I, _I, _I, _L, _L, _L, _L, _P, _P],
        "avg_pool2_bwd": [_P, _P, _L, _I, _I, _I, _L, _L, _L, _L, _P, _P],
    },
    "swt_atrous": {
        "swt_afb": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _L, _L, _L, _L,
                    _I, _I, _I, _I, _L, _L, _L, _L, _L, _I, _I, _I, _P],
        "swt_afb_adjoint": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _I,
                            _L, _L, _L, _L, _L, _I, _I, _I, _I,
                            _L, _L, _L, _L, _I, _I, _I, _P, _I, _I, _P],
        "swt_sfb": [_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I,
                    *[_L] * 8, _I, _I, _I, _I, _L, _L, _L, _L, _I, _I, _I,
                    _P],
        "swt_sfb_adjoint": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _I,
                            _L, _L, _L, _L, _I, _I, _I, _I,
                            _L, _L, _L, _L, _L, _I, _I, _I, _P, _I, _I,
                            _P],
    },
    "nonsep_afb": {
        "nonsep_afb": [_P, _P, _P, _I, _I, _I, _L, _I, _I, _I,
                       _L, _L, _L, _L, *[_I] * 8,
                       _L, _L, _L, _L, _L, _P],
        "nonsep_afb_adjoint": [_P, _P, _P, _I, _I, _I, _L, _I, _I, _I,
                               _L, _L, _L, _L, _L, *[_I] * 13,
                               _P, _I, _P, _I, _I, _I,
                               _L, _L, _L, _L, _P],
    },
    "nonsep_sfb": {
        "nonsep_sfb": [_P, _P, _P, _I, _I, _L, _I, _I, _I,
                       _L, _L, _L, _L, _L, *[_I] * 11,
                       _L, _L, _L, _L, _I, _I, _I, _I, _P, _I, _I, _I, _P,
                       _I, _P],
        "nonsep_sfb_adjoint": [_P, _P, _P, _I, _I, _L, _I, _I, _I,
                               _L, _L, _L, _L, _I, _I, *[_I] * 11,
                               _L, _L, _L, _L, _L, _I, _I, _P],
    },
    "halo": {
        "halo_pack": [_P, _I, *[_L] * 4, *[_I] * 6, _P, _P],
        "halo_assemble": [_P, _I, *[_L] * 4, *[_I] * 6, _P, _P],
        "halo_fold": [_P, _I, *[_L] * 4, *[_I] * 6, _P, _P],
    },
    "iswt_spec": {
        "spec_merge": [_P, _P, _P, _P, _P, _L, _I, _I, _I, *[_L] * 12, _I,
                       _P, _P],
        "spec_split": [_P, _P, _P, _P, _P, _L, _I, _I, _I, *[_L] * 12, _I,
                       _P, _P],
    },
}

_libs: dict = {}
BUILD_LOG: dict = {}   # name -> {"seconds": s, "log": nvcc's stderr}


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def _target(name: str) -> Path:
    h = hashlib.sha1((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):   # the shared headers
        h.update(header.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build() -> dict:
    """Compile every library that is not built yet, in parallel; raise
    with nvcc's output if any fails.  Returns :data:`BUILD_LOG`."""
    todo = [n for n in _SIGNATURES if not _target(n).exists()]
    if not todo:
        return BUILD_LOG
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _target(n).with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return BUILD_LOG


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        err = lib.kernel_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, kernel: str, rc: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                           f"({lib.kernel_error_string(rc).decode()})")


def check_inputs(kernel: str, *tensors: torch.Tensor,
                 dtypes: tuple = (torch.float32,)) -> None:
    """Raise on what the kernels do not take: a tensor off CUDA, tensors
    of differing dtypes or of a dtype not in ``dtypes`` (fp32 for most
    entries; fp32 or bf16 for K2/K3; complex64 for K13), or a gradient
    request (a raw kernel call records no autograd graph)."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{kernel}: expected a CPU or CUDA tensor, got "
                             f"one on {t.device}")
        if t.dtype not in dtypes or t.dtype != tensors[0].dtype:
            raise TypeError(f"{kernel}: the CUDA kernel takes "
                            f"{' or '.join(map(str, dtypes))} tensors of "
                            f"one dtype, got {[u.dtype for u in tensors]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: a raw kernel call has no backward; differentiate "
            f"through the autograd entry points (ops/fused_dtcwt.py "
            f"pyramids, transforms/scatternet.py:smooth_mag, the modules), "
            f"or call "
            f"it under torch.no_grad()")


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t.to(dtype)``: the casts around the fp32 kernels that take bf16
    through :func:`via_fp32` (one name, so a run can count them)."""
    return t.to(dtype)


def _bf16_on_card(values) -> bool:
    return any(isinstance(v, torch.Tensor) and v.is_cuda
               and v.dtype == torch.bfloat16 for v in values)


def via_fp32(wrapper):
    """bf16 CUDA tensors through a CUDA-core kernel's fp32 wrapper: each
    bf16 tensor argument is cast to fp32, the fp32 kernel launches, and
    its tensor results are cast back to bf16, so the op rounds once, where
    the JAX op rounds.  An ``out`` argument in bf16 takes the fp32 result
    (added in fp32 with ``accumulate``, then rounded once).  Other calls
    pass straight through (CPU tensors take the plain versions in their
    own dtype)."""
    sig = inspect.signature(wrapper)

    @functools.wraps(wrapper)
    def run(*args, **kwargs):
        if not (_bf16_on_card(args) or _bf16_on_card(kwargs.values())):
            return wrapper(*args, **kwargs)
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        a = bound.arguments
        out, acc = a.get("out"), a.get("accumulate")
        if out is not None:   # the fp32 result goes to a new tensor first
            a["out"] = None
            if acc is not None:
                a["accumulate"] = False
        for k, v in a.items():
            if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
                a[k] = cast(v, torch.float32)
        y = wrapper(*bound.args, **bound.kwargs)
        if out is not None:
            return out.add_(y) if acc else out.copy_(y)
        if isinstance(y, torch.Tensor):
            return cast(y, torch.bfloat16)
        return type(y)(cast(t, torch.bfloat16) for t in y)
    return run


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream
