"""The port stands alone: no module of otamg_torch, and none of
chip_smoke.py, chip_profile.py and ell_spmv_sweep.py, imports jax or
anything of the JAX package otamg."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "otamg_torch"


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "chip_profile.py",
                                        ROOT / "ell_spmv_sweep.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "otamg")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_otamg_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_import_all_modules_without_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(
            ".__init__", "")
        for p in PKG.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'otamg'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_device_raises_without_cuda():
    import torch

    from otamg_torch import device

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve(None)
    assert device.resolve("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_cuda():
    """Without a card the script exits nonzero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
