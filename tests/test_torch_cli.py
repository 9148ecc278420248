"""The port's CLI (``python -m otamg_torch.cli``) against the JAX
package's (``python -m otamg.cli``) on the same small problems on the
CPU, and its own behaviour: checkpoint/resume, profiling, the drivers
and flags it refuses, and the device it runs on."""

import glob
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from otamg.cli import main as j_main
from otamg_torch.cli import main as t_main

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run(main, argv, capsys):
    """(exit code, the report: the JSON of the last stdout line)."""
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


@pytest.mark.parametrize("argv", [
    ["class1", "--m", "16", "--n", "16", "--inner", "pcg"],
    ["class1", "--m", "20", "--n", "16", "--inner", "amg", "--cycle", "f"],
    ["class2", "--m", "12", "--n", "10", "--inner", "aug_pcg"],
], ids=["class1-pcg", "class1-amg-f", "class2-aug_pcg"])
def test_report_matches_jax_cli(argv, tmp_path, capsys):
    """The same report except ``wall_time_s``, with the objective to
    1e-8, and as many log records.  With the PCG inner solver the inner
    iteration counts are not compared: each Newton solve's PCG stops at
    ``delta <= (1e-11)^2 delta_0``, where the two packages' summation
    orders move single iterations (16x16: 835 against 840 in all, one
    outer iteration's steps apart by up to 5), while the outer
    trajectory, the SsN steps and the failures agree."""
    rc_j, rep_j = run(j_main, argv + ["--log", str(tmp_path / "j.jsonl")],
                      capsys)
    rc_t, rep_t = run(t_main, argv + ["--device", "cpu", "--log",
                                      str(tmp_path / "t.jsonl")], capsys)
    assert rc_t == rc_j == 0 and rep_t["converged"]
    assert set(rep_t) == set(rep_j)
    assert rep_t["objective"] == pytest.approx(rep_j["objective"], rel=1e-8)
    skip = {"wall_time_s", "objective"}
    if "pcg" in argv:
        skip |= {"inner_max", "inner_sum"}
    for k in set(rep_j) - skip:
        assert rep_t[k] == rep_j[k], k
    lines = [(tmp_path / f).read_text().splitlines()
             for f in ("j.jsonl", "t.jsonl")]
    assert len(lines[1]) == len(lines[0]) == rep_t["iters"] + 1


def test_checkpoint_resume(tmp_path, capsys):
    """``--checkpoint`` then ``--resume`` reaches the uninterrupted
    run's report; Class 1 also saves the result."""
    ck = str(tmp_path / "ck")
    base = ["class1", "--m", "16", "--n", "12", "--inner", "amg",
            "--cycle", "f", "--device", "cpu"]
    rc_full, full = run(t_main, base, capsys)
    rc_part, part = run(t_main, base + ["--maxit", "20", "--checkpoint", ck],
                        capsys)
    assert rc_part == 1 and not part["converged"] and full["iters"] > 20
    assert sorted(os.listdir(ck)) == ["result.npz", "step_10.npz",
                                      "step_20.npz"]
    rc_res, res = run(t_main, base + ["--checkpoint", ck, "--resume"],
                      capsys)
    assert rc_res == rc_full == 0
    assert (res["converged"], res["iters"]) == (full["converged"],
                                                full["iters"])
    assert res["objective"] == pytest.approx(full["objective"], rel=1e-12)


def test_profile_writes_trace(tmp_path, capsys):
    tdir = str(tmp_path / "trace")
    rc, rep = run(t_main, ["class1", "--m", "12", "--n", "12", "--inner",
                           "pcg", "--device", "cpu", "--profile", tdir],
                  capsys)
    assert rc == 0 and rep["converged"]
    traces = glob.glob(os.path.join(tdir, "trace_*.json"))
    assert len(traces) == 1
    assert json.loads(pathlib.Path(traces[0]).read_text())["traceEvents"]


@pytest.mark.parametrize("flags", [
    ["--driver", "scan"], ["--driver"], ["--chunk", "four"],
    ["--shard"], ["--num-processes", "2"], ["--coordinator", "h:1"],
    ["--process-id", "0"]])
def test_unported_flags_refused(flags, capsys):
    """The multi-process flags, which are not ported, and a driver or a
    chunk size that does not exist are refused by the parser, never
    mapped onto the loop driver."""
    with pytest.raises(SystemExit) as exc:
        t_main(["class1", "--m", "8", "--n", "8", "--device", "cpu", *flags])
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""


def test_no_cpu_fallback(capsys):
    """Without CUDA and without ``--device cpu`` the CLI exits nonzero
    and solves nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    rc = t_main(["class1", "--m", "8", "--n", "8", "--inner", "pcg"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err and "device='cpu'" in out.err


def test_info_subprocess():
    out = subprocess.run([sys.executable, "-m", "otamg_torch.cli", "info"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["version"] and rep["torch"] == torch.__version__
    assert rep["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert isinstance(rep["kernels_built"], bool)
