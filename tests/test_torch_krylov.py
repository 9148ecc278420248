"""Parity of otamg_torch.krylov (the dense preconditioner menu and
``pcg_matrix``) with the JAX package, on the CPU in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otamg.config as jcfg
import otamg_torch.config as tcfg
from otamg.krylov.pcg import make_preconditioner as j_make
from otamg.krylov.pcg import pcg_matrix as j_pcg_matrix
from otamg_torch.krylov.pcg import make_preconditioner, pcg_matrix

NF = 18


@pytest.fixture(scope="module")
def bipartite_spd():
    """A random SPD ``[[diag(V), U], [U^T, diag(T)]]`` (the bipartite
    shape BI_SSOR assumes), made diagonally dominant, and a right-hand
    side."""
    rng = np.random.default_rng(11)
    U = rng.uniform(0.0, 1.0, (NF, 12)) * (rng.uniform(size=(NF, 12)) < 0.5)
    H = np.zeros((NF + 12, NF + 12))
    H[:NF, NF:] = -U
    H[NF:, :NF] = -U.T
    H[np.diag_indices(NF + 12)] = np.abs(H).sum(1) + rng.uniform(0.1, 1.0,
                                                                 NF + 12)
    assert np.linalg.eigvalsh(H).min() > 0
    return H, rng.standard_normal(NF + 12)


@pytest.mark.parametrize("which", list(tcfg.Preconditioner),
                         ids=lambda w: w.name)
def test_make_preconditioner_matches_jax(bipartite_spd, which):
    """``M^{-1} r`` of every menu entry, to 1e-12 of its largest entry."""
    H, r = bipartite_spd
    jw = jcfg.Preconditioner[which.name]
    want = np.asarray(j_make(jnp.asarray(H), jw, 1.3, NF)(jnp.asarray(r)))
    got = make_preconditioner(torch.as_tensor(H), which, 1.3, NF)(
        torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_bi_ssor_needs_nf(bipartite_spd):
    H, _ = bipartite_spd
    with pytest.raises(ValueError, match="nf"):
        make_preconditioner(torch.as_tensor(H),
                            tcfg.Preconditioner.BI_SSOR)


@pytest.mark.parametrize("which", list(tcfg.Preconditioner),
                         ids=lambda w: w.name)
def test_pcg_matrix_matches_jax(bipartite_spd, which):
    """The same iterations, the solution to 1e-10 and the residual
    history (``resk=True``) to 1e-6 of each entry plus 1e-11: the last
    relative residuals sit near the f64 rounding floor of CG, where the
    two packages' summation orders part."""
    H, e = bipartite_spd
    jopts = jcfg.PCGOptions(retol=1e-12, maxit=60,
                            precd=jcfg.Preconditioner[which.name])
    topts = tcfg.PCGOptions(retol=1e-12, maxit=60, precd=which)
    rj = j_pcg_matrix(jnp.asarray(H), jnp.asarray(e), jopts, nf=NF,
                      resk=True)
    rt = pcg_matrix(torch.as_tensor(H), torch.as_tensor(e), topts, nf=NF,
                    resk=True)
    assert rt.iters == int(rj.iters) > 0
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(rj.x)).max())
    np.testing.assert_allclose(rt.resk.numpy(), np.asarray(rj.resk),
                               rtol=1e-6, atol=1e-11)
    assert rt.resk.shape == (60,) and not rt.resk[rt.iters:].any()
    assert float(rt.res) <= 1e-12
    assert pcg_matrix(torch.as_tensor(H), torch.as_tensor(e), topts,
                      nf=NF).resk is None
