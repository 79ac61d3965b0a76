"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name in
it has its file."""

import math
import re

from portbench import harness
from portbench.tests import tiny

ROOT = tiny.ROOT
M = harness.load_json(ROOT / harness.MANIFEST)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head_size|experts_per_tok|expansion")


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / harness.MANIFEST).stat().st_size <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32
    assert all(one_line(w) and not w.startswith("/") and ".." not in w
               for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # A full check of 24 cells fits in its 43200 s.
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (M["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_configs_cells_and_metrics():
    configs = {c["name"]: c for c in M["configs"]}
    assert 1 <= len(configs) <= 24
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(M["paths"][0] + "/")
        assert (ROOT / c["file"]).is_file()
        assert not any(WIDTH.search(k) for k in c["reduced"])
    used = {w["config"] for w in M["workloads"]}
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= 1
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        bench = ROOT / "portbench"
        traffic = harness.load_json(bench / "traffic" / f"{w['traffic']}.json")
        assert (bench / "drivers" / f"{traffic['driver']}.py").is_file()
        assert (bench / "limits" / f"{w['name']}.json").is_file()
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and one_line(m["layer"])
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in M["workloads"]:
        c = tiny.cell(w["name"], 1, False)
        e2e_here, layers = harness.metric_names(c)
        assert "setup_s" in {m["name"] for m in e2e_here}
        assert len(e2e_here) >= 2 and layers
        assert any("mfu" in m["name"] for m in layers)
    assert not math.isnan(M["run_seconds"])
