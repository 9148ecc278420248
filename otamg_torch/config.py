"""Typed configuration dataclasses.

A copy of ``otamg/config.py``: the same frozen dataclasses, enums and
defaults, so an options object means the same thing to both packages.
The reference keeps configuration as in-file constants plus two MATLAB
option structs (``pcg_options`` at ``Class1/APD_SsN_Class1.m:81-84`` /
``PCG.m:18-32`` and ``amg_options`` at ``Class1/APD_SsN_Class1.m:87-88`` /
``AMG/Class_AMG.m:20-40``).

Fields that only the JAX package reads (``explicit_dist``,
``MeshOptions``) are kept so the two option sets stay field-for-field
equal; the port raises where such a field selects a path it has not
ported.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Preconditioner(enum.Enum):
    """PCG preconditioner menu (reference ``PCG.m:12-17``)."""

    NONE = 1
    JACOBI = 2
    SSOR = 3
    ICHOL = 4
    BI_SSOR = 5


class Cycle(enum.Enum):
    V = "v"
    W = "w"
    # F-cycle (TPU-build extension, no reference analogue): the W-cycle
    # revisit structure but the SECOND child visit runs as a V-cycle, so
    # level l is visited l+1 times (linear in depth) instead of 2^(l-1)
    # (exponential).  Round-4 measurement: a W-cycle's wall time is
    # op-count bound at the deep (tiny) levels, so F trades a little
    # convergence rate for a much shorter tape.
    F = "f"


class InnerSolver(enum.Enum):
    """Newton-system solver choice (reference ``Class1/APD_SsN_Class1.m:66-71``)."""

    DIRECT = 1
    PCG = 2
    AUG_PCG = 3
    AMG = 4
    TWOGRID = 5


@dataclasses.dataclass(frozen=True)
class PCGOptions:
    """Options for :func:`otamg.krylov.pcg`.

    Defaults follow ``PCG.m:18-27``: relative tolerance 1e-11, maxit 1e4,
    Jacobi preconditioner, zero initial guess.
    """

    retol: float = 1e-11
    maxit: int = 10_000
    precd: Preconditioner = Preconditioner.JACOBI
    omega: float = 1.5  # SSOR relaxation weight (``PCG.m:40``, ``:96``)


@dataclasses.dataclass(frozen=True)
class AMGOptions:
    """Options for the AMG engine (reference ``Class_AMG.m:6-18``).

    Field-for-field match with the MATLAB ``amg_options`` struct; the demo
    drivers use retol 1e-11, bigph, maxit 30/40, theta 1/4, smoth 5/10,
    W-cycle, isnsp, standard interpolation
    (``Class1/APD_SsN_Class1.m:87-88``, ``Class2/APD_SsN_Class2.m:80-81``).
    """

    retol: float = 1e-11
    bigph: bool = True
    maxit: int = 30
    theta: float = 0.25
    smoth: int = 5
    cycle: Cycle = Cycle.W
    isnsp: bool = True
    inter: float = 1.0  # 0 direct / 1 standard / 2 ideal interpolation
    # --- TPU-build extensions (no reference analogue) ---
    max_levels: int = 10          # static unroll bound for the hierarchy
    coarsen_ratio: float = 0.625  # per-level capacity shrink for padding
    coarse_pcg: PCGOptions = dataclasses.field(default_factory=PCGOptions)
    # Coarsest-grid solver: "direct" factors the (tiny) coarsest matrix
    # once at setup and back-substitutes per cycle visit; "pcg" is the
    # reference behavior (Jacobi-PCG per visit, ``MG_Vcycle.m:43`` — its
    # own direct solve is the commented ``:44``).  Exactness makes the two
    # trajectory-equivalent to the PCG tolerance.
    coarse_solver: str = "direct"
    # Spectral-truncation margin of the direct coarse solve for LOW solve
    # dtypes, in ulps: eigenvalues below ``coarse_cutoff_ulps * eps(dtype)
    # * lambda_max`` are dropped (the deterministic analogue of the
    # reference PCG's low-precision stagnation floor).  f64 always uses 4.
    coarse_cutoff_ulps: float = 256.0
    # Coarsest-grid target size.  None = the reference depth rule
    # ``1 + floor(N_fine^(1/3))`` (``Class_AMG.m:76``) — sized for a
    # sparse-CPU direct/PCG solve.  With the setup-time eigensolve a much
    # larger coarsest level costs the same per visit (one small GEMV pair
    # on the MXU) while cutting hierarchy depth — and a W-cycle's tape
    # length is EXPONENTIAL in depth, which dominates the per-cycle cost.
    # Default 128: 2.8x faster end-to-end than the reference rule on the
    # 500x500 fixture with identical outer trajectories (it=58, 0 fails,
    # both precisions).  Set None for the reference depth rule.
    coarse_target: Optional[int] = 128
    # Coarsest-grid target size: reference coarsens until
    # ``size <= 1 + floor(N_fine**(1/3))`` (``Class_AMG.m:76``).
    # Fused deep correction: materialize the (linear) sub-tape below the
    # fine level as ONE dense matrix per Newton solve and apply it as a
    # single GEMV per cycle, replacing the op-count-bound deep visit
    # chain (round-4 measurement: ~34 ms/W-cycle at 4096 nodes was
    # serialized µs-GEMV dispatches).  Same linear algebra at a
    # different rounding order; trajectory pins are tested with the
    # flag both off and on.  No effect with fewer than 2 dense levels.
    fuse_deep: bool = False


@dataclasses.dataclass(frozen=True)
class WarmupOptions:
    """A-ADMM warm start (reference ``warmup_class1.m``, 100 its from the
    drivers: ``Class1/APD_SsN_Class1.m:55,59``)."""

    maxit: int = 100
    res: float = 0.0


@dataclasses.dataclass(frozen=True)
class APDOptions:
    """Outer APD + SsN loop parameters.

    Reference: ``maxit=1e2, KKT_Tol=1e-6, SsN_IT=50, SsN_Tol1=1e-11,
    nu=0.2, delta=0.9, ll_max=500`` (``Class1/APD_SsN_Class1.m:35-36``;
    Class2 uses ``SsN_Tol1=1e-10``, ``Class2/APD_SsN_Class2.m:27-28``).
    """

    maxit: int = 100
    kkt_tol: float = 1e-6
    ssn_maxit: int = 50
    ssn_tol1: float = 1e-11
    nu: float = 0.2
    delta: float = 0.9
    ll_max: int = 500
    inner_solver: InnerSolver = InnerSolver.AMG
    pcg: PCGOptions = dataclasses.field(default_factory=PCGOptions)
    amg: AMGOptions = dataclasses.field(default_factory=AMGOptions)
    warmup: WarmupOptions = dataclasses.field(default_factory=WarmupOptions)
    # Restart heuristic (``Class1/APD_SsN_Class1.m:245-249``): when
    # bk1 < restart_bk_floor and the KKT residual grew, roll back.
    restart_bk_floor: float = 1e-8
    seed: int = 0
    # Mixed precision: dtype name ("float32") for the inner Newton-system
    # solver; None = same precision as the problem.  With fp32 the hybrid
    # solvers polish via f64 iterative refinement (TPU mode: f64 APD
    # layer, fp32 MXU hierarchy).
    solve_dtype: Optional[str] = None
    # Class-2 tail safeguard (no reference analogue): when the three
    # complementarity residuals are at target but the feasibility
    # residual kkt_l stalls (degenerate active-set chatter under TPU
    # emulated-f64 rounding), project the primal onto {Hu=b} via the
    # closed-form inv_hht and re-measure the FULL KKT on the polished
    # iterate (otamg/ot/operators.py::feasibility_polish).  Off by
    # default so fixture-trajectory contracts match the reference
    # exactly; the bench/CLI enable it.
    feas_polish: bool = False
    # Distributed assembly with EXPLICIT collectives (shard_map psum /
    # all_gather, :mod:`otamg.dist.assembly`) for the hybrid transform,
    # instead of relying on the implicit XLA SPMD partitioner.  Uses a 1-D
    # mesh over all visible devices; tested trajectory-equal to the
    # implicit path (``ASAt.m:14-19`` -> ``transform_sharded``).
    explicit_dist: bool = False


@dataclasses.dataclass(frozen=True)
class MeshOptions:
    """Device-mesh / sharding configuration for :mod:`otamg.dist`."""

    axis_name: str = "x"
    num_devices: Optional[int] = None  # None = all visible devices
