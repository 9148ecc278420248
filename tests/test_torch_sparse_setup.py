"""Parity of the port's sparse layer (``COO``, ``CSR.from_coo``,
``spgemm``, ``asat_coo``, ``ell_row_sum_duplicates``) and of the
sparse-setup AMG path (``setup_hierarchy_sparse`` + ``amg_solve``) with
the JAX package, on the CPU in f64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch

import otamg.config as jcfg
import otamg_torch.config as tcfg
from otamg.amg import hierarchy as jh
from otamg.dist.assembly import ell_row_sum_duplicates as j_merge
from otamg.sparse import COO as JCOO
from otamg.sparse import CSR as JCSR
from otamg.sparse.containers import spgemm as j_spgemm
from otamg.sparse.ot_assembly import asat_coo as j_asat
from otamg_torch import interop
from otamg_torch.amg import hierarchy as th
from otamg_torch.dist import assembly as tassembly
from otamg_torch.sparse.containers import COO, CSR, spgemm
from otamg_torch.sparse.ot_assembly import asat_coo

T = lambda a: torch.as_tensor(np.array(a))
N_ = lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def same_coo(t, j, rtol=1e-12, what="COO"):
    """Slot for slot: equal rows, cols and nnz, values to ``rtol`` of
    the largest."""
    assert t.shape == tuple(j.shape), f"{what}: shape"
    assert int(t.nnz) == int(j.nnz), f"{what}: nnz"
    for f in ("rows", "cols"):
        assert np.array_equal(N_(getattr(t, f)), N_(getattr(j, f))), \
            f"{what}: {f} exact"
    want = N_(j.vals)
    np.testing.assert_allclose(N_(t.vals), want, rtol=rtol,
                               atol=rtol * np.abs(want).max(),
                               err_msg=f"{what}: vals rtol {rtol}")


def coo_pair(rows, cols, vals, nnz, shape):
    return (COO(shape, T(rows).int(), T(cols).int(), T(vals), T(nnz)),
            JCOO(shape, jnp.asarray(rows, jnp.int32),
                 jnp.asarray(cols, jnp.int32), jnp.asarray(vals),
                 jnp.int32(nnz)))


def random_triplets(rng, nr, nc, count, cap):
    """``count`` random triplets with duplicates, padded to ``cap``."""
    rows = np.zeros(cap, np.int64)
    cols = np.zeros(cap, np.int64)
    vals = np.zeros(cap)
    rows[:count] = rng.integers(0, nr, count)
    cols[:count] = rng.integers(0, nc, count)
    vals[:count] = rng.standard_normal(count)
    return rows, cols, vals


def test_coo_from_dense_and_ops():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((9, 7)) * (rng.uniform(size=(9, 7)) < 0.3)
    x, y = rng.standard_normal(7), rng.standard_normal(9)
    for cap in (None, 40):
        t = COO.from_dense(T(A), capacity=cap)
        j = JCOO.from_dense(jnp.asarray(A), capacity=cap)
        same_coo(t, j, 0, "from_dense")
        np.testing.assert_array_equal(t.to_dense().numpy(), A)
        np.testing.assert_allclose(t.matvec(T(x)).numpy(),
                                   np.asarray(j.matvec(jnp.asarray(x))),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(t.rmatvec(T(y)).numpy(),
                                   np.asarray(j.rmatvec(jnp.asarray(y))),
                                   rtol=1e-12, atol=1e-12)
        same_coo(t.transpose(), j.transpose(), 0, "transpose")
        np.testing.assert_array_equal(t.transpose().to_dense().numpy(), A.T)


@pytest.mark.parametrize("count", [0, 17, 60])
def test_coo_sum_duplicates(count):
    rng = np.random.default_rng(2 + count)
    rows, cols, vals = random_triplets(rng, 6, 5, count, 64)
    t, j = coo_pair(rows, cols, vals, count, (6, 5))
    ts, js = t.sum_duplicates(), j.sum_duplicates()
    same_coo(ts, js, 1e-12, "sum_duplicates")
    np.testing.assert_allclose(ts.to_dense().numpy(),
                               np.asarray(j.to_dense()), rtol=1e-12,
                               atol=1e-12)


def test_csr_from_coo_matches_jax():
    """A matrix whose row 0 starts at column 0, loose and tight row
    capacity: slot for slot as the JAX package."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((8, 8)) * (rng.uniform(size=(8, 8)) < 0.4)
    A[0, 0] = 2.0
    rows, cols, vals = (np.nonzero(A)[0], np.nonzero(A)[1], A[A != 0])
    cap = 2 * rows.size
    pad = lambda a: np.concatenate([a, np.zeros(cap - a.size, a.dtype)])
    # every entry twice, halves summing to the value
    t, j = coo_pair(pad(np.tile(rows, 2)), pad(np.tile(cols, 2)),
                    pad(np.tile(vals / 2, 2)), 2 * rows.size, (8, 8))
    for row_cap in (8, 2):
        ct, cj = CSR.from_coo(t, row_cap), JCSR.from_coo(j, row_cap)
        for f in ("indptr", "ell_cols"):
            assert np.array_equal(getattr(ct, f).numpy(),
                                  np.asarray(getattr(cj, f))), f
        np.testing.assert_allclose(ct.ell_vals.numpy(),
                                   np.asarray(cj.ell_vals), rtol=1e-12,
                                   atol=1e-12)
        assert ct.ell_cols.dtype == torch.int32
    np.testing.assert_allclose(CSR.from_coo(t, 8).to_dense().numpy(), A,
                               rtol=1e-12, atol=1e-12)


def test_csr_from_coo_keeps_row0_column():
    """Row 0 with no entry at column 0: the port keeps its column, where
    the JAX package's padding entries overwrite it with 0 (ROADMAP
    Queue 3)."""
    A = np.zeros((3, 5))
    A[0, 3], A[1, 1], A[2, 4] = 2.0, 1.0, 5.0
    ct = CSR.from_coo(COO.from_dense(T(A), capacity=8), 2)
    np.testing.assert_array_equal(ct.to_dense().numpy(), A)
    assert ct.ell_cols[0, 0] == 3
    cj = JCSR.from_coo(JCOO.from_dense(jnp.asarray(A), capacity=8), 2)
    assert int(cj.ell_cols[0, 0]) == 0  # the JAX package's fault


@pytest.mark.parametrize("out_cap", [200, 12])
def test_spgemm(out_cap):
    """``COO @ CSR`` with a loose and a tight output capacity, as the JAX
    package; the loose one is the dense product."""
    rng = np.random.default_rng(4)
    A = rng.standard_normal((10, 9)) * (rng.uniform(size=(10, 9)) < 0.3)
    B = rng.standard_normal((9, 11)) * (rng.uniform(size=(9, 11)) < 0.3)
    At, Aj = COO.from_dense(T(A), capacity=40), JCOO.from_dense(
        jnp.asarray(A), capacity=40)
    Bt, Bj = CSR.from_dense(T(B), row_cap=6), JCSR.from_dense(
        jnp.asarray(B), row_cap=6)
    ct, cj = spgemm(At, Bt, out_cap), j_spgemm(Aj, Bj, out_cap)
    same_coo(ct, cj, 1e-12, f"spgemm cap {out_cap}")
    if out_cap == 200:
        np.testing.assert_allclose(ct.to_dense().numpy(), A @ B,
                                   rtol=1e-12, atol=1e-12)
    else:
        assert int(ct.nnz) == out_cap < np.count_nonzero(A @ B)


def test_asat_coo():
    rng = np.random.default_rng(5)
    m, n = 6, 5
    S = (rng.uniform(size=(m, n)) < 0.5).astype(float)
    p, q = rng.uniform(0.5, 1.5, m), rng.uniform(0.5, 1.5, n)
    ct = asat_coo(T(S), T(p), T(q))
    cj = j_asat(jnp.asarray(S), jnp.asarray(p), jnp.asarray(q))
    same_coo(ct, cj, 1e-12, "asat_coo")
    # H0 = [[diag(S^T p^2), diag(q) S^T diag(p)], [.^T, diag(S q^2)]]
    off = q[:, None] * S.T * p[None, :]
    H0 = np.block([[np.diag(S.T @ p ** 2), off], [off.T, np.diag(S @ q ** 2)]])
    np.testing.assert_allclose(ct.to_dense().numpy(), H0, rtol=1e-12,
                               atol=1e-12)
    tight = asat_coo(T(S), T(p), T(q), capacity=20)
    same_coo(tight, j_asat(jnp.asarray(S), jnp.asarray(p), jnp.asarray(q),
                           capacity=20), 1e-12, "asat_coo tight")


def ell_rows(rng, R, width, ncols, nreal):
    """ELL rows with ``nreal`` real (possibly repeated) columns each and
    padding (column 0, value 0) after them."""
    cols = np.zeros((R, width), np.int64)
    vals = np.zeros((R, width))
    cols[:, :nreal] = rng.integers(1, ncols, (R, nreal))
    vals[:, :nreal] = rng.standard_normal((R, nreal))
    return cols, vals


@pytest.mark.parametrize("case", ["exact_fit", "overflow", "zero_values"])
def test_ell_row_sum_duplicates(case):
    """As the JAX package on rows that fit exactly, on rows that
    overflow (``ngroups_max`` reports it), and with zero-valued entries
    at real columns; no scatter slot is negative."""
    rng = np.random.default_rng({"exact_fit": 6, "overflow": 7,
                                 "zero_values": 8}[case])
    cols, vals = ell_rows(rng, 40, 10, 200, 6)
    if case == "exact_fit":
        # six distinct columns per row into six slots
        cols[:, :6] = np.sort(rng.permutation(199)[:6] + 1)[None, :]
        cols[:, 6] = cols[:, 0]
        vals[:, 6] = 1.0
        out_cap = 6
    elif case == "overflow":
        out_cap = 4
    else:
        vals[:, ::3] = 0.0
        out_cap = 6
    oc, ov, ng = tassembly.ell_row_sum_duplicates(T(cols).int(), T(vals),
                                                  out_cap)
    jc, jv, jng = j_merge(jnp.asarray(cols, jnp.int32), jnp.asarray(vals),
                          out_cap)
    assert int(ng) == int(jng)
    assert (int(ng) > out_cap) == (case == "overflow")
    assert np.array_equal(oc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ov.numpy(), np.asarray(jv), rtol=1e-12,
                               atol=1e-12)
    _, _, slot, _ = tassembly._group_slots(T(cols).int(), T(vals), out_cap)
    assert int(slot.min()) >= 0 and int(slot.max()) <= out_cap


def banded_ell(N, shift=0.01):
    """The 1-D Laplacian + ``shift`` I as scipy CSR and padded ELL
    arrays (cap 3), as ``tests/test_amg.py`` builds it."""
    A = sp.diags([-np.ones(N - 1), np.full(N, 2.0 + shift),
                  -np.ones(N - 1)], [-1, 0, 1]).tocsr()
    cols = np.zeros((N, 3), np.int32)
    vals = np.zeros((N, 3))
    for i in range(N):
        s, e = A.indptr[i], A.indptr[i + 1]
        cols[i, :e - s] = A.indices[s:e]
        vals[i, :e - s] = A.data[s:e]
    return A, cols, vals


SP_J = jcfg.AMGOptions(maxit=60, cycle=jcfg.Cycle.W, coarse_target=32,
                       retol=1e-10)
SP_T = tcfg.AMGOptions(maxit=60, cycle=tcfg.Cycle.W, coarse_target=32,
                       retol=1e-10)


def jitted_jax_stages(mp):
    """Run the JAX setup's two stages, the aggregation Galerkin product
    and the dense chain, each under ``jax.jit``, as the JAX solvers run
    the dense chain: eager, their op-by-op compilation takes ~40 s of
    CPU time at N = 4096; jitted ~4 s, with bit-identical levels on this
    problem."""
    agg = jh._agg_galerkin_ell
    agg_jit = jax.jit(lambda c, v, k, cap: agg(c, v, k, cap)[:3],
                      static_argnums=(2, 3))
    chain_jit = jax.jit(jh._build_dense_chain, static_argnums=(4, 5, 7))
    mp.setattr(jh, "_agg_galerkin_ell", lambda c, v, k, cap: (
        *agg_jit(c, v, k, cap), -(-c.shape[0] // k)))
    mp.setattr(jh, "_build_dense_chain", lambda A, a, lab, nsp, caps, opts,
               key, nseg: chain_jit(A, a, lab, nsp, tuple(caps), opts, key,
                                    nseg))


@pytest.fixture(scope="module")
def sparse_setup():
    N = 4096
    A, cols, vals = banded_ell(N)
    key = jax.random.PRNGKey(0)
    jcsr = JCSR(shape=(N, N), indptr=jnp.asarray(A.indptr),
                ell_cols=jnp.asarray(cols), ell_vals=jnp.asarray(vals))
    tcsr = interop.csr(A.indptr, cols, vals, (N, N), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        jitted_jax_stages(mp)
        hj = jh.setup_hierarchy_sparse(jcsr, SP_J, key, agg=2,
                                       dense_crossover=256)
    ht = th.setup_hierarchy_sparse(tcsr, SP_T, interop.key(key), agg=2,
                                   dense_crossover=256)
    b = np.random.default_rng(3).standard_normal(N)
    return A, b, hj, ht


def test_setup_hierarchy_sparse_levels(sparse_setup):
    _, _, (j0, jrest), (t0, trest) = sparse_setup
    assert isinstance(t0, th.CSRLevel)
    kinds = [type(lv).__name__ for lv in trest]
    assert kinds == [type(lv).__name__ for lv in jrest]
    assert kinds.count("AggCSRLevel") >= 1
    sizes = [th._lvl_size(lv) for lv in (t0, *trest)]
    assert sizes == [jh._lvl_size(lv) for lv in (j0, *jrest)]
    assert sizes[:5] == [4096, 2048, 1024, 512, 256]
    for lt, lj in zip((t0, *trest), (j0, *jrest)):
        if isinstance(lt, (th.CSRLevel, th.AggCSRLevel)):
            assert np.array_equal(lt.ell_cols.numpy(),
                                  np.asarray(lj.ell_cols))
            np.testing.assert_allclose(lt.ell_vals.numpy(),
                                       np.asarray(lj.ell_vals), rtol=1e-12,
                                       atol=1e-12)
            np.testing.assert_allclose(lt.dg.numpy(), np.asarray(lj.dg),
                                       rtol=1e-12)
        else:
            for f in ("A", "P"):
                want = np.asarray(getattr(lj, f))
                np.testing.assert_allclose(
                    getattr(lt, f).numpy(), want, rtol=1e-10,
                    atol=1e-10 * np.abs(want).max(), err_msg=f)


def test_sparse_setup_amg_solve(sparse_setup):
    """W-cycle: the JAX iterations, ``x`` to 1e-10 of JAX's and 1e-8 of
    the direct solution."""
    A, b, (j0, jrest), (t0, trest) = sparse_setup
    rj = jh.amg_solve(j0, jrest, jnp.asarray(b), jnp.zeros(b.size), SP_J)
    rt = th.amg_solve(t0, trest, T(b), torch.zeros(b.size,
                                                   dtype=torch.float64), SP_T)
    assert rt.iters == int(rj.iters)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=1e-10,
                               atol=1e-10 * np.abs(xj).max())
    want = spl.spsolve(A.tocsc(), b)
    err = np.linalg.norm(rt.x.numpy() - want) / np.linalg.norm(want)
    assert err < 1e-8, f"err {err:.2e} after {rt.iters} cycles"


def test_sparse_setup_overflow_raises():
    """An operator that is not banded overflows the aggregated rows'
    capacity: the same ValueError as the JAX package."""
    N = 2048
    rng = np.random.default_rng(9)
    cols = rng.integers(0, N, (N, 4)).astype(np.int32)
    cols[:, 0] = np.arange(N)
    vals = np.where(cols == np.arange(N)[:, None], 4.0, -0.5)
    indptr = np.arange(0, 4 * N + 1, 4)
    jcsr = JCSR(shape=(N, N), indptr=jnp.asarray(indptr),
                ell_cols=jnp.asarray(cols), ell_vals=jnp.asarray(vals))
    with pytest.raises(ValueError, match="aggregation Galerkin overflow") \
            as jexc, pytest.MonkeyPatch.context() as mp:
        jitted_jax_stages(mp)
        jh.setup_hierarchy_sparse(jcsr, SP_J, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="aggregation Galerkin overflow") \
            as texc:
        th.setup_hierarchy_sparse(
            interop.csr(indptr, cols, vals, (N, N), device="cpu"), SP_T,
            interop.key(jax.random.PRNGKey(0)))
    assert str(texc.value) == str(jexc.value)
