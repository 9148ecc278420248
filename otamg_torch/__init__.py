"""otamg_torch — the PyTorch/CUDA port of ``otamg``.

The same layers as the JAX package, module for module (``ot/``,
``opt/``, ``krylov/``, ``amg/``, ``hybrid/``, ``sparse/``, ``diag/``,
the CLI ``python -m otamg_torch.cli``, and of ``dist/`` only the ELL
duplicate merge), with hand-written CUDA kernels for Hopper under
``csrc/``.  Problems are f64 by
default; ``APDOptions(solve_dtype="float32")`` runs the AMG hierarchy in
fp32 with f64 refinement, and an fp32 plan keeps its dual state and
reductions in f64.  Entry points run on CUDA unless the caller names
another device (:mod:`otamg_torch.device`).  The port imports neither
``jax`` nor anything of ``otamg``.

Keep ``torch.backends.cuda.matmul.allow_tf32`` False and
``torch.get_float32_matmul_precision()`` at ``"highest"`` (PyTorch's
defaults): the JAX package multiplies at ``Precision.HIGHEST``, TF32
keeps about three decimal digits of a float32 product, and the fp32
hierarchy's coarse cutoff, its ``4 eps`` tolerance floor and the
refinement all assume true fp32.
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
from otamg_torch.ot import operators, problems  # noqa: F401
from otamg_torch.ot.problems import (  # noqa: F401
    Class1Problem,
    Class2Problem,
    assignment_problem,
    capacitated_problem,
    load_class1_mat,
    load_class2_mat,
    random_class1,
    random_class2,
)
from otamg_torch.opt.admm import warmup_class1, warmup_class2  # noqa: F401
from otamg_torch.opt.apd import (SolveResult, make_class1_step,  # noqa: F401
                                 solve_class1)
from otamg_torch.opt.apd2 import (Solve2Result, make_class2_step,  # noqa: F401
                                  solve_class2)
from otamg_torch.opt.newton import (NewtonSolveResult,  # noqa: F401
                                    make_pcg_solver)
from otamg_torch.hybrid.solver import (  # noqa: F401
    make_aug_pcg_solver,
    make_direct_solver,
    make_hybrid_amg_solver,
)
