"""Every cell's CPU form prints a last line that meets the benchmark's
contract, in a process that loads neither JAX nor the JAX package."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny

MANIFEST = harness.load_json(tiny.ROOT / harness.MANIFEST)
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def run_form(name: str, trace: int, seed: int):
    proc = subprocess.run(
        [sys.executable, str(tiny.ROOT / "portbench" / "tests" / "tiny.py"),
         name, str(trace), str(seed)],
        capture_output=True, text=True, timeout=600, cwd=tiny.ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1]), proc.stderr


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cpu_form_prints_a_contract_line(name, trace):
    loaded, line, err = run_form(name, trace, 2 ** 31 + 977)
    assert loaded == {"forbidden": []}
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    c = tiny.cell(name, 1, bool(trace))
    e2e, layers = harness.metric_names(c)
    units = {m["name"]: m["unit"] for m in e2e + layers}
    if trace:
        assert set(line["metrics"]) <= {m["name"] for m in layers}
        assert line["device"]["window_s"] > 0
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == {m["name"] for m in e2e}
        assert "setup_s" in line["metrics"]
    for metric, body in line["metrics"].items():
        assert body["unit"] == units[metric]
        assert isinstance(body["value"], float) and body["value"] > 0
    device = line["device"]
    assert device["platform"] == "cpu" and device["count"] == 1
    checks = err.strip().splitlines()[-len(line["checks"]):]
    for text, (number, body) in zip(checks, line["checks"].items()):
        assert text.startswith(f"check {number}: ")
        assert repr(body["limit"]) in text
