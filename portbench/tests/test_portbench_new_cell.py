"""A cell, a configuration, a mix and a per-layer metric added purely as
new files and manifest entries are found and run by the harness, with no
file that is already there changed."""

import json
import shutil

import torch

from portbench import harness
from portbench.tests import tiny

READER = '''"""The count of requests the run attempted (a test's)."""


def read(run):
    return float(run.attempted) if run.attempted else None
'''


def test_cell_from_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(tiny.ROOT / harness.MANIFEST, root / harness.MANIFEST)
    shutil.copytree(tiny.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    bench = root / "portbench"
    config = {**harness.load_json(bench / "configs" / "flagship-gqa.json"),
              **tiny.CONFIG, "name": "tiny-lm", "num_hidden_layers": 3}
    (bench / "configs" / "tiny-lm.json").write_text(json.dumps(config))
    (bench / "traffic" / "chat-burst.json").write_text(json.dumps(
        {**harness.load_json(bench / "traffic" / "chat.json"),
         **tiny.TRAFFIC["serve"], "rate_per_s": 30.0}))
    (bench / "limits" / "serve.tiny-lm.burst.json").write_text(json.dumps(
        {"logit_gap": 0.5, "unanswered": 0.0}))
    (bench / "metrics" / "requests_count.serve.py").write_text(READER)
    manifest = harness.load_json(root / harness.MANIFEST)
    manifest["configs"].append({"name": "tiny-lm", "source": "test",
                                "file": "portbench/configs/tiny-lm.json",
                                "reduced": [], "why": "a test's"})
    manifest["workloads"].append({"name": "serve.tiny-lm.burst",
                                  "config": "tiny-lm",
                                  "traffic": "chat-burst", "chips": 1,
                                  "why": "a test's"})
    for m in manifest["end_to_end"]:
        if "workloads" in m and m["name"].startswith("serve"):
            m["workloads"].append("serve.tiny-lm.burst")
    manifest["per_layer"].append({
        "name": "requests_count.serve", "unit": "requests", "better": "higher",
        "source": "program_span", "layer": "a test's",
        "moves": "serve_tokens_per_s",
        "workloads": ["serve.tiny-lm.burst"]})
    (root / harness.MANIFEST).write_text(json.dumps(manifest))
    torch.set_num_threads(2)
    for trace in (False, True):
        c = harness.cell(root, "serve.tiny-lm.burst", 5, tiny.SECONDS,
                         trace, "cpu", tiny.CLOCK_START)
        assert c.config["num_hidden_layers"] == 3
        line, _run = harness.run_cell(c)
        assert line["correct"] is True
        if trace:
            assert line["metrics"]["requests_count.serve"]["value"] > 0
        else:
            assert set(line["metrics"]) == {"serve_tokens_per_s", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before
