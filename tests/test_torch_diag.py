"""Parity of otamg_torch.diag (checkpoint/resume in both loop drivers,
solver_report, RunLog, plot_run, the roofline model) with the JAX
package, on the CPU in f64."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import otamg.config as jcfg
import otamg_torch.config as tcfg
from otamg.diag import solver_report as j_report
from otamg.diag.roofline import solve_bytes_model as j_bytes
from otamg.opt import solve_class1 as j_solve1
from otamg.opt.apd2 import solve_class2 as j_solve2
from otamg.ot import random_class1 as j_random1
from otamg.ot import random_class2 as j_random2
from otamg_torch import random as tr
from otamg_torch.diag import RunLog, plot_run, solver_report
from otamg_torch.diag import checkpoint as ckpt
from otamg_torch.diag import roofline
from otamg_torch.opt import solve_class1, solve_class2
from otamg_torch.ot import random_class1, random_class2

N_ = lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(got, want, rtol, what):
    """rtol relative to the largest entry of ``want``."""
    got, want = N_(got), N_(want)
    assert got.shape == want.shape, f"{what}: shape"
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=f"{what}: rtol {rtol} (of max)")


def c1_opts(cfg, maxit):
    return cfg.APDOptions(inner_solver=cfg.InnerSolver.PCG, maxit=maxit,
                          kkt_tol=1e-30)  # fixed-length runs


def c2_opts(cfg, maxit):
    return cfg.APDOptions(ssn_tol1=1e-10, maxit=maxit, kkt_tol=1e-30,
                          inner_solver=cfg.InnerSolver.AUG_PCG)


@pytest.fixture(scope="module")
def class1_runs(tmp_path_factory):
    """16x12, PCG, 20 fixed iterations: JAX uninterrupted, the port
    uninterrupted, and the port stopped at 10 and resumed."""
    jp = j_random1(jax.random.PRNGKey(5), 16, 12)
    tp = random_class1(tr.PRNGKey(5), 16, 12, device="cpu")
    ck = str(tmp_path_factory.mktemp("ck1"))
    part = solve_class1(tp, c1_opts(tcfg, 10), checkpoint_dir=ck,
                        checkpoint_every=5)
    return dict(jax=j_solve1(jp, c1_opts(jcfg, 20)),
                full=solve_class1(tp, c1_opts(tcfg, 20)), part=part,
                resumed=solve_class1(tp, c1_opts(tcfg, 20),
                                     checkpoint_dir=ck, resume=True,
                                     return_state=True),
                ck=ck)


def test_class1_resume_equals_uninterrupted(class1_runs):
    r = class1_runs
    # 5 and 10 by the stopped run, 20 by the resumed one (every 10)
    assert sorted(os.listdir(r["ck"])) == ["step_10.npz", "step_20.npz",
                                           "step_5.npz"]
    res, full = r["resumed"], r["full"]
    assert res.iters == full.iters == 20
    # records: the warm start, then iterations 11..20
    assert len(res.fxk) == 11 and len(res.ssn_itnum) == 10
    close(res.X, full.X, 1e-12, "resumed X vs port")
    close(res.lam, full.lam, 1e-12, "resumed lam vs port")
    close(res.fxk[1:], full.fxk[11:], 1e-12, "resumed fxk vs port")
    assert np.array_equal(res.ssn_itnum, full.ssn_itnum[10:])
    X, V, lam, bk, key = res.state
    assert torch.equal(X, res.X) and torch.equal(lam, res.lam)
    assert key.dtype == torch.int64 and key.shape == (2,)


def test_class1_resume_equals_jax(class1_runs):
    r = class1_runs
    res, jres = r["resumed"], r["jax"]
    close(res.X, jres.X, 1e-10, "resumed X vs JAX")
    close(res.lam, jres.lam, 1e-10, "resumed lam vs JAX")
    close(res.fxk[1:], jres.fxk[11:], 1e-10, "resumed fxk vs JAX")


def test_class2_resume(tmp_path):
    """12x10, AUG_PCG, 16 fixed iterations, stopped at 8 and resumed:
    to 1e-12 of the port uninterrupted, 1e-10 of JAX."""
    jp = j_random2(jax.random.PRNGKey(8), 12, 10, mu_frac=0.5)
    tp = random_class2(tr.PRNGKey(8), 12, 10, mu_frac=0.5, device="cpu")
    ck = str(tmp_path / "ck2")
    jfull = j_solve2(jp, c2_opts(jcfg, 16))
    full = solve_class2(tp, c2_opts(tcfg, 16))
    solve_class2(tp, c2_opts(tcfg, 8), checkpoint_dir=ck,
                 checkpoint_every=4)
    d = ckpt.load_dict(ck)
    assert d["k"] == 8 and set(d) == {"X", "us", "VX", "vs", "lam", "bk",
                                      "key", "prev_kkt", "k"}
    res = solve_class2(tp, c2_opts(tcfg, 16), checkpoint_dir=ck,
                       resume=True)
    assert res.iters == 16 and len(res.fxk) == 9
    for name in ("X", "y", "z", "lam"):
        close(getattr(res, name), getattr(full, name), 1e-12,
              f"resumed {name} vs port")
        close(getattr(res, name), getattr(jfull, name), 1e-10,
              f"resumed {name} vs JAX")
    close(res.fxk[1:], full.fxk[9:], 1e-12, "resumed fxk vs port")
    close(res.fxk[1:], jfull.fxk[9:], 1e-10, "resumed fxk vs JAX")
    close(res.kkt[1:], full.kkt[9:], 1e-10, "resumed KKT vs port")


def test_fp32_plan_round_trip(tmp_path):
    """A restored fp32 plan stays fp32 and its dual f64, on the device
    of the template; without a template arrays keep their saved dtype."""
    tp = random_class1(tr.PRNGKey(5), 16, 12, dtype=torch.float32,
                       device="cpu")
    ck = str(tmp_path / "ck32")
    res = solve_class1(tp, c1_opts(tcfg, 4), checkpoint_dir=ck,
                       checkpoint_every=2, return_state=True)
    X, V, lam, bk, key = res.state
    assert X.dtype == torch.float32 and lam.dtype == torch.float64
    st = ckpt.load_state(ck, template=dict(X=X, V=V, lam=lam, bk=bk,
                                           key=key))
    assert st.k == 4
    assert st.X.dtype == torch.float32 and st.V.dtype == torch.float32
    assert st.lam.dtype == torch.float64 and st.key.dtype == torch.int64
    assert st.X.device == X.device
    assert torch.equal(st.X, X) and torch.equal(st.lam, lam)
    # The template decides the dtype: an f64 template casts the fp32 X.
    d = ckpt.load_dict(ck, template=dict(X=X.double()))
    assert d["X"].dtype == torch.float64
    assert ckpt.load_dict(ck)["lam"].dtype == torch.float64
    # Resuming the fp32 plan continues in fp32.
    res2 = solve_class1(tp, c1_opts(tcfg, 6), checkpoint_dir=ck,
                        resume=True)
    assert res2.X.dtype == torch.float32 and res2.lam.dtype == torch.float64


def test_checkpoint_files(tmp_path):
    path = str(tmp_path / "ck")
    assert ckpt.latest_step(path) is None
    with pytest.raises(FileNotFoundError):
        ckpt.load_dict(path)
    ckpt.save_dict(path, 3, dict(a=torch.arange(4.0), b=np.int64(7)))
    assert os.listdir(path) == ["step_3.npz"]  # no temporary left behind
    d = ckpt.load_dict(path)
    assert d["k"] == 3 and torch.equal(d["a"], torch.arange(4.0))
    with pytest.raises(FileNotFoundError):
        ckpt.load_dict(path, step=4)
    # A multi-process run's shard files wait for otamg_torch.dist.
    mp = tmp_path / "mp"
    mp.mkdir()
    for pid in range(2):
        np.savez(mp / f"step_7.proc{pid}of2.npz", k=7, __meta__="{}",
                 lam=np.zeros(3))
    assert ckpt.latest_step(str(mp)) == 7
    with pytest.raises(NotImplementedError, match="otamg_torch.dist"):
        ckpt.load_dict(str(mp))


def test_solver_report_matches_jax():
    """The port's report on the port's solve equals JAX's report on JAX's
    solve, key for key, except the wall time, with the objective to 1e-8
    (Class 1 with the AMG inner solver, Class 2 with augmented PCG)."""
    amg = lambda cfg: cfg.APDOptions(inner_solver=cfg.InnerSolver.AMG,
                                     amg=cfg.AMGOptions(cycle=cfg.Cycle.F))
    aug = lambda cfg: cfg.APDOptions(ssn_tol1=1e-10,
                                     inner_solver=cfg.InnerSolver.AUG_PCG)
    pairs = [(j_solve1(j_random1(jax.random.PRNGKey(0), 20, 16), amg(jcfg)),
              solve_class1(random_class1(tr.PRNGKey(0), 20, 16,
                                         device="cpu"), amg(tcfg))),
             (j_solve2(j_random2(jax.random.PRNGKey(0), 12, 10,
                                 mu_frac=0.6), aug(jcfg)),
              solve_class2(random_class2(tr.PRNGKey(0), 12, 10, mu_frac=0.6,
                                         device="cpu"), aug(tcfg)))]
    for jres, tres in pairs:
        rj, rt = j_report(jres), solver_report(tres)
        assert set(rt) == set(rj)
        assert rt["objective"] == pytest.approx(rj["objective"], rel=1e-8)
        for k in set(rj) - {"wall_time_s", "objective"}:
            assert rt[k] == rj[k], k


def test_runlog_and_plot(tmp_path):
    res = solve_class1(random_class1(tr.PRNGKey(6), 12, 10, device="cpu"),
                       tcfg.APDOptions(inner_solver=tcfg.InnerSolver.PCG))
    path = tmp_path / "log.jsonl"
    log = RunLog(str(path))
    for k in range(len(res.kkt_x)):
        log.log(it=k, kkt_x=float(res.kkt_x[k]))
    log.close()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["it"] for r in recs] == list(range(res.iters + 1))
    assert all("t" in r for r in recs) and log.records == recs
    pytest.importorskip("matplotlib")
    paths = plot_run(res, str(tmp_path / "run"))
    assert paths == [str(tmp_path / "run_convergence.png")]
    assert os.path.getsize(paths[0]) > 0


@pytest.mark.parametrize("gamma,fuse,caps,itemsizes", [
    (3, True, [500, 313, 196, 123], (8, 8)),
    (2, False, [500, 313, 196, 123], (8, 4)),
    (1, True, [64], (4, 4)),
    (3, False, [1024, 640, 400, 250, 157, 99], (8, 8)),
])
def test_solve_bytes_model_matches_jax(gamma, fuse, caps, itemsizes):
    kw = dict(m=caps[0], n=caps[0] - 3, iters=58, ssn_total=131,
              cycles_total=517, smoth=5, gamma=gamma, caps=caps,
              fuse_deep=fuse, plan_itemsize=itemsizes[0],
              solve_itemsize=itemsizes[1])
    got, want = roofline.solve_bytes_model(**kw), j_bytes(**kw)
    assert got == pytest.approx(want, rel=1e-12) and got > 0


def test_roofline_report_peak():
    rep = roofline.roofline_report(3.35e10, 0.02, 3.35e12)
    assert rep["model_gbps"] == pytest.approx(1675.0)
    assert rep["roofline_frac"] == pytest.approx(0.5)
    by_name = roofline.roofline_report(3.35e10, 0.02,
                                       "NVIDIA H100 80GB HBM3")
    assert by_name == rep
    assert roofline.hbm_rate("NVIDIA H100 NVL") == 3.9e12
    with pytest.raises(ValueError, match="no memory bandwidth"):
        roofline.roofline_report(1.0, 1.0, "TPU v5 lite")
    with pytest.raises(ValueError, match="cpu"):
        roofline.roofline_report(1.0, 1.0, torch.device("cpu"))
