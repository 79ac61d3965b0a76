"""The port stands alone: no module of tpu_operator_torch, and not
chip_smoke.py, imports JAX, flax or the JAX package, and its entry points
default to the CUDA device and refuse to run without one unless the
caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_operator_torch.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "tpu_operator_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpu_operator")


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts), path


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_no_forbidden_import_in_source():
    """AST scan, every import statement, nested ones included."""
    files = [path for _name, path in _modules()] + [REPO / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax_module():
    """A fresh interpreter (this one already holds jax, via conftest)
    imports every module of the port and chip_smoke, then lists what got
    loaded."""
    names = [name for name, _path in _modules()]
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = [m for m in out.stdout.split() if _forbidden(m)]
    assert not loaded, loaded
    assert "tpu_operator_torch.payload.serve" in out.stdout.split()


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_entry_point_refuses_to_run_without_cuda(monkeypatch):
    from tpu_operator_torch.payload import bootstrap, serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.parse_args(["--checkpoint-dir", ""])
    with pytest.raises(RuntimeError):
        serve.ServeLoop(args, bootstrap.process_info_from_env({}),
                        heartbeat=None, recorder=None)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Run without CUDA (this machine, or a copy holding only the script):
    it exits non-zero and prints no result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_classifier_entry_points_refuse_to_run_without_cuda(monkeypatch):
    """cifar and linear default to the CUDA device too: without a card
    their builds raise unless the caller asks for the CPU."""
    from tpu_operator_torch.payload import bootstrap, cifar, linear

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cifar.build(cifar.parse_args(["--checkpoint-dir", "",
                                      "--profile-dir", ""]))
    with pytest.raises(RuntimeError, match="CUDA"):
        linear.run(bootstrap.process_info_from_env({}),
                   linear.parse_args(["--profile-dir", ""]))
    tiny = ["--device", "cpu", "--batch", "8", "--widths", "4", "4", "4",
            "--blocks", "1", "--checkpoint-dir", "", "--profile-dir", ""]
    assert cifar.build(cifar.parse_args(tiny)).device == torch.device("cpu")
