"""otamg_torch — the PyTorch/CUDA port of ``otamg``.

The same layers as the JAX package, module for module (``ot/``,
``opt/``, ``krylov/``, ``amg/``, ``hybrid/``, ``sparse/``), in f64, with
hand-written CUDA kernels for Hopper under ``csrc/``.  Entry points run
on CUDA unless the caller names another device (:mod:`otamg_torch.device`).
The port imports neither ``jax`` nor anything of ``otamg``.

Keep ``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default):
the JAX package multiplies at ``Precision.HIGHEST``, and TF32 would keep
about three decimal digits of any float32 product.  The slice runs in
f64, where TF32 does not apply.
"""

__version__ = "0.1.0"

from otamg_torch.config import (  # noqa: F401
    AMGOptions,
    APDOptions,
    Cycle,
    InnerSolver,
    PCGOptions,
    WarmupOptions,
)
