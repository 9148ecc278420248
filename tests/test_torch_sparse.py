"""Parity of otamg_torch.sparse (CSR container, ELL SpMV) with the JAX
package.  The CPU runs the kernel's plain version; the Pallas kernel runs
in interpret mode, as tests/test_sparse.py runs it.  The CUDA kernel is
compared with its plain version by a test that needs the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otamg.sparse import CSR as JCSR
from otamg.sparse.kernels import ell_spmv as j_ell_spmv
from otamg.sparse.kernels import ell_spmv_xla
from otamg_torch.sparse import CSR, ell_spmv, ell_spmv_plain
from otamg_torch.sparse.kernels import VARIANTS, plan


def assert_rowsum_close(got, want, cols, vals, x, rtol, what):
    """|got - want| <= rtol * sum_r |vals[i, r] x[cols[i, r]]| per row: a
    relative tolerance on each row's sum that does not depend on the
    order of its terms."""
    scale = ell_spmv_plain(torch.as_tensor(np.asarray(cols)),
                           torch.as_tensor(np.abs(np.asarray(vals))),
                           torch.as_tensor(np.abs(np.asarray(x)))).numpy()
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert np.all(err <= rtol * scale), (
        f"{what}: rtol {rtol} of the absolute row sum, worst "
        f"{np.max(err / np.maximum(scale, 1e-300)):.2e}")


def rand_sparse(rng, m, n, density):
    A = rng.standard_normal((m, n))
    A[rng.uniform(size=(m, n)) > density] = 0.0
    return A


@pytest.mark.parametrize("row_cap", [None, 16, 3])
def test_csr_from_dense_exact(row_cap):
    A = rand_sparse(np.random.default_rng(1), 30, 25, 0.3)
    cj = JCSR.from_dense(jnp.asarray(A), row_cap=row_cap)
    ct = CSR.from_dense(torch.as_tensor(A), row_cap=row_cap)
    assert ct.shape == cj.shape
    for f in ("indptr", "ell_cols", "ell_vals"):
        assert np.array_equal(np.asarray(getattr(cj, f)),
                              getattr(ct, f).numpy()), f"{f}: exact"
    assert ct.ell_cols.dtype == torch.int32 and ct.ell_cols.is_contiguous()
    assert np.array_equal(np.asarray(cj.to_dense()), ct.to_dense().numpy())
    np.testing.assert_array_equal(np.asarray(cj.diag()), ct.diag().numpy())
    x = np.random.default_rng(2).standard_normal(25)
    np.testing.assert_allclose(ct.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(cj.matvec(jnp.asarray(x))),
                               rtol=1e-14, atol=1e-14,
                               err_msg="CSR.matvec: rtol 1e-14")


# (rows, n, density, row_cap, block_rows) of tests/test_sparse.py:105-160
SHAPES = [(70, 50, 0.2, 50, 32), (70, 50, 0.2, 16, 32),
          (200, 300, 0.45, 150, 64)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}c{s[3]}")
def test_plain_vs_pallas_interpret_f32(shape):
    nr, n, dens, cap, br = shape
    rng = np.random.default_rng(6)
    A = rand_sparse(rng, nr, n, dens)
    c = JCSR.from_dense(jnp.asarray(A, jnp.float32), row_cap=cap)
    x = rng.standard_normal(n).astype(np.float32)
    want = j_ell_spmv(c.ell_cols, c.ell_vals, jnp.asarray(x), block_rows=br,
                      interpret=True)
    cols, vals = np.array(c.ell_cols), np.array(c.ell_vals)
    got = ell_spmv_plain(torch.as_tensor(cols), torch.as_tensor(vals),
                         torch.as_tensor(x))
    assert_rowsum_close(got.numpy(), want, cols, vals, x, 1e-6,
                        "vs Pallas f32")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}c{s[3]}")
def test_plain_vs_xla_f64(shape):
    nr, n, dens, cap, _ = shape
    rng = np.random.default_rng(7)
    A = rand_sparse(rng, nr, n, dens)
    c = JCSR.from_dense(jnp.asarray(A), row_cap=cap)
    vals = np.array(c.ell_vals)
    # columns >= n in some padding slots (the Pallas rule gives them 0)
    cols = np.where(vals == 0, n + 7, np.asarray(c.ell_cols)).astype(np.int32)
    x = rng.standard_normal(n)
    want = ell_spmv_xla(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x))
    got = ell_spmv(torch.as_tensor(cols), torch.as_tensor(vals),
                   torch.as_tensor(x))
    assert_rowsum_close(got.numpy(), want, cols, vals, x, 1e-14,
                        "vs ell_spmv_xla f64")


def test_out_of_range_columns_give_zero():
    """Columns >= n contribute 0: the Pallas kernel, ell_spmv_xla and the
    port agree."""
    cols = np.asarray([[0, 5, 999], [2, 998, 997]], np.int32)
    vals = np.asarray([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32)
    x = np.arange(6, dtype=np.float32)
    want = np.asarray([2.0 * 5.0, 4.0 * 2.0], np.float32)
    got = ell_spmv(torch.as_tensor(cols), torch.as_tensor(vals),
                   torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = j_ell_spmv(jnp.asarray(cols), jnp.asarray(vals),
                        jnp.pad(jnp.asarray(x), (0, 194)), block_rows=2,
                        interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas), want)


def test_negative_columns_follow_the_pallas_kernel():
    """A negative column contributes 0 in the Pallas kernel
    (``valid = (local >= 0) & ...``).  ``ell_spmv_xla`` wraps it
    (``jnp.take(mode="fill")``), a fault of the JAX package; the port
    follows the kernel."""
    cols = np.asarray([[1, -1, 0], [-3, 2, -200]], np.int32)
    vals = np.asarray([[1.0, 10.0, 100.0], [1.0, 2.0, 3.0]], np.float32)
    x = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    kernel_rule = np.asarray([2.0 + 100.0, 2.0 * 3.0], np.float32)
    pallas = j_ell_spmv(jnp.asarray(cols), jnp.asarray(vals),
                        jnp.pad(jnp.asarray(x), (0, 195)), block_rows=2,
                        interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas), kernel_rule)
    xla = np.asarray(ell_spmv_xla(jnp.asarray(cols), jnp.asarray(vals),
                                  jnp.asarray(x)))
    assert xla[0] != kernel_rule[0], "ell_spmv_xla no longer wraps"
    got = ell_spmv(torch.as_tensor(cols), torch.as_tensor(vals),
                   torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), kernel_rule)


# (rows, n, cap, block_rows): the kernel's cap boundaries, rows that are
# no multiple of the Pallas block.
CAPS = [(300, 257, 1, 64), (203, 140, 7, 32), (150, 160, 16, 64),
        (130, 300, 27, 64), (77, 200, 33, 32)]


@pytest.mark.parametrize("shape", CAPS, ids=lambda s: f"{s[0]}x{s[2]}")
def test_plain_vs_pallas_interpret_caps(shape):
    """The plain version against the Pallas kernel in interpret mode at
    the caps where the CUDA kernel changes variant, with columns out of
    range on both sides."""
    nr, n, cap, br = shape
    rng = np.random.default_rng(cap)
    cols = rng.integers(-3, n + 3, (nr, cap)).astype(np.int32)
    vals = rng.standard_normal((nr, cap)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    assert (cols < 0).any() and (cols >= n).any()
    want = j_ell_spmv(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x),
                      block_rows=br, interpret=True)
    got = ell_spmv(torch.as_tensor(cols), torch.as_tensor(vals),
                   torch.as_tensor(x))
    assert_rowsum_close(got.numpy(), want, cols, vals, x, 1e-6,
                        f"cap {cap} vs Pallas f32")


@pytest.mark.parametrize("cap,name", [
    (0, "slab1"), (1, "slab1"), (5, "slab1"), (9, "slab1"), (16, "slab1"),
    (17, "slab4"), (27, "slab4"), (32, "slab4"), (33, "warp"),
    (200, "warp")])
def test_plan_boundaries(cap, name):
    assert VARIANTS[plan(cap)] == name


# (rows, cap, row-sliced view): one case per kernel variant, the
# misaligned views of a 5-point stencil, and a ragged last slab.
CUDA_CASES = [(4096, 1, False), (4099, 5, False), (4096, 5, True),
              (4096, 7, False), (4096, 16, False), (4096, 27, False),
              (4096, 27, True), (4096, 33, False), (4096, 33, True),
              (4096, 200, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cap,view", CUDA_CASES,
                         ids=lambda v: str(v))
def test_cuda_kernel_matches_plain(rows, cap, view):
    """The CUDA kernel against its plain version on the card, f32 and
    f64, with out-of-range columns of both signs; a view ``[1:]`` starts
    ``cap`` elements into its allocation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check")
    gen = torch.Generator(device="cuda").manual_seed(cap)
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        cols = torch.randint(-8, 1032, (rows + view, cap), generator=gen,
                             device="cuda", dtype=torch.int32)
        vals = torch.randn(rows + view, cap, generator=gen, device="cuda",
                           dtype=dtype)
        if view:
            cols, vals = cols[1:], vals[1:]
        x = torch.randn(1024, generator=gen, device="cuda", dtype=dtype)
        before = ell_spmv.launches
        y = ell_spmv(cols, vals, x)
        torch.cuda.synchronize()
        assert ell_spmv.launches == before + 1
        scale = ell_spmv_plain(cols, vals.abs(), x.abs())
        err = (y - ell_spmv_plain(cols, vals, x)).abs()
        assert bool((err <= rtol * scale).all()), f"rtol {rtol}"
