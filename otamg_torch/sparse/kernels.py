"""ELL SpMV: the CUDA kernel and its plain PyTorch version (port of
``otamg/sparse/kernels.py``).

``ell_spmv`` computes ``y_i = sum_r vals[i, r] * x[cols[i, r]]`` where a
column outside ``[0, n)`` contributes 0 — the Pallas kernel's rule
(``valid = (local >= 0) & ...``).  On a CUDA tensor it launches the
hand-written kernel of ``otamg_torch/csrc/ell_spmv.cu`` (built at first
use, see :mod:`otamg_torch.cuda_build`), on a CPU tensor it runs
:func:`ell_spmv_plain`.  There is no fallback between the two: a failed
build or launch raises.

The kernel has variants of one source, picked by :func:`plan` from the
row length ``cap``: short rows stage slabs of rows in shared memory with
``G`` lanes per row (``slab<G>``), long rows take a warp per row
(``warp``).

The JAX package's ``ell_spmv_xla`` is not this function's twin for
negative columns: ``jnp.take(..., mode="fill")`` wraps them.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch


def ell_spmv_plain(cols: torch.Tensor, vals: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Masked gather plus row sum, with the kernel's out-of-range rule."""
    n = x.shape[0]
    valid = (cols >= 0) & (cols < n)
    g = x[torch.where(valid, cols, 0).long()]
    return (vals * torch.where(valid, g, 0)).sum(dim=1)


_SIZE = {torch.float32: 4, torch.float64: 8}

# (largest cap, lanes per row G) of the slab variant; longer rows take a
# warp each.  Set by measurement (ell_spmv_sweep.py, PERF.md Findings PR 2).
_SLAB = ((16, 1), (32, 4))
WARP = 0
VARIANTS = {1: "slab1", 4: "slab4", WARP: "warp"}


def plan(cap: int) -> int:
    """The variant code ``csrc/ell_spmv.cu`` launches for rows of length
    ``cap`` (see :data:`VARIANTS`)."""
    for top, g in _SLAB:
        if cap <= top:
            return g
    return WARP


def _check(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor):
    if not (cols.is_cuda and vals.is_cuda and x.is_cuda):
        raise ValueError("ell_spmv: a CUDA call needs cols, vals and x "
                         "all on the card")
    if not (cols.device == vals.device == x.device):
        raise ValueError("ell_spmv: cols, vals and x lie on different cards")
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_spmv: cols must be int32, got {cols.dtype}")
    if vals.dtype not in _SIZE or x.dtype != vals.dtype:
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


# The launch's arguments as one block of native int64 (see
# csrc/ell_spmv.cu::ell_spmv_launch): one ctypes argument converts in a
# fraction of the time of eleven.
_ARGS = struct.Struct("=11q")


@functools.cache
def _bound():
    """(launch, error string, raw current stream of a device), bound at
    the first call."""
    from otamg_torch import cuda_build

    lib = cuda_build.load("ell_spmv")
    lib.ell_spmv_launch.argtypes = [ctypes.c_char_p]
    lib.ell_spmv_launch.restype = ctypes.c_int
    lib.ell_spmv_error_string.argtypes = [ctypes.c_int]
    lib.ell_spmv_error_string.restype = ctypes.c_char_p
    stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
        lambda i: torch.cuda.current_stream(i).cuda_stream)
    return lib.ell_spmv_launch, lib.ell_spmv_error_string, stream


def _launch(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
            code: int | None = None) -> torch.Tensor:
    """Launch variant ``code`` (by default :func:`plan`'s) on checked
    tensors; returns ``y``."""
    launch, error_string, stream = _bound()
    nrows, cap = cols.shape
    y = vals.new_empty(nrows)
    dev = vals.get_device()
    err = launch(_ARGS.pack(
        cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(), nrows,
        cap, x.shape[0], plan(cap) if code is None else code, stream(dev),
        dev, _SIZE[vals.dtype]))
    if err != 0:
        raise RuntimeError("ell_spmv launch failed: "
                           + error_string(err).decode())
    return y


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV; CUDA kernel on a card, :func:`ell_spmv_plain` on the
    CPU.  ``ell_spmv.launches`` counts kernel launches (none for zero
    rows)."""
    dev = vals.get_device()
    if dev < 0 and not (cols.is_cuda or x.is_cuda):
        return ell_spmv_plain(cols, vals, x)
    dtype = vals.dtype
    if not (dev >= 0 and cols.get_device() == dev and x.get_device() == dev
            and cols.dtype is torch.int32 and x.dtype is dtype
            and dtype in _SIZE and cols.shape == vals.shape
            and cols.dim() == 2 and x.dim() == 1 and x.shape[0] < 2 ** 31
            and cols.is_contiguous() and vals.is_contiguous()
            and x.is_contiguous()):
        _check(cols, vals, x)
        raise AssertionError("ell_spmv: _check passed what the fast check "
                             "refused")
    if cols.shape[0] == 0:
        return vals.new_empty(0)
    y = _launch(cols, vals, x)
    ell_spmv.launches += 1
    return y


ell_spmv.launches = 0
