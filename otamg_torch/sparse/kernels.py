"""ELL SpMV: the CUDA kernel and its plain PyTorch version (port of
``otamg/sparse/kernels.py``).

``ell_spmv`` computes ``y_i = sum_r vals[i, r] * x[cols[i, r]]`` where a
column outside ``[0, n)`` contributes 0 — the Pallas kernel's rule
(``valid = (local >= 0) & ...``).  On a CUDA tensor it launches the
hand-written kernel of ``otamg_torch/csrc/ell_spmv.cu`` (built at first
use, see :mod:`otamg_torch.cuda_build`), on a CPU tensor it runs
:func:`ell_spmv_plain`.  There is no fallback between the two: a failed
build or launch raises.

The JAX package's ``ell_spmv_xla`` is not this function's twin for
negative columns: ``jnp.take(..., mode="fill")`` wraps them.
"""

from __future__ import annotations

import ctypes

import torch


def ell_spmv_plain(cols: torch.Tensor, vals: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Masked gather plus row sum, with the kernel's out-of-range rule."""
    n = x.shape[0]
    valid = (cols >= 0) & (cols < n)
    g = x[torch.where(valid, cols, 0).long()]
    return (vals * torch.where(valid, g, 0)).sum(dim=1)


_FN = {torch.float32: "ell_spmv_f32", torch.float64: "ell_spmv_f64"}


def _check(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor):
    if not (cols.is_cuda and vals.is_cuda and x.is_cuda):
        raise ValueError("ell_spmv: a CUDA call needs cols, vals and x "
                         "all on the card")
    if not (cols.device == vals.device == x.device):
        raise ValueError("ell_spmv: cols, vals and x lie on different cards")
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_spmv: cols must be int32, got {cols.dtype}")
    if vals.dtype not in _FN or x.dtype != vals.dtype:
        raise TypeError(f"ell_spmv: vals and x must share float32 or "
                        f"float64, got {vals.dtype} and {x.dtype}")
    if cols.dim() != 2 or vals.shape != cols.shape or x.dim() != 1:
        raise ValueError(f"ell_spmv: shapes cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}, x {tuple(x.shape)}")
    if not (cols.is_contiguous() and vals.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("ell_spmv: cols, vals and x must be contiguous")
    if x.shape[0] >= 2 ** 31:
        raise ValueError("ell_spmv: x longer than int32 columns can reach")


def _entry(dtype):
    from otamg_torch import cuda_build

    lib = cuda_build.load("ell_spmv")
    fn = getattr(lib, _FN[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ell_spmv_error_string.argtypes = [ctypes.c_int]
        lib.ell_spmv_error_string.restype = ctypes.c_char_p
    return lib, fn


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV; CUDA kernel on a card, :func:`ell_spmv_plain` on the
    CPU.  ``ell_spmv.launches`` counts kernel launches."""
    if not (cols.is_cuda or vals.is_cuda or x.is_cuda):
        return ell_spmv_plain(cols, vals, x)
    _check(cols, vals, x)
    lib, fn = _entry(vals.dtype)
    nrows, cap = cols.shape
    y = torch.empty(nrows, dtype=vals.dtype, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                 y.data_ptr(), nrows, cap, x.shape[0], stream)
    if err != 0:
        raise RuntimeError("ell_spmv launch failed: "
                           + lib.ell_spmv_error_string(err).decode())
    ell_spmv.launches += 1
    return y


ell_spmv.launches = 0
