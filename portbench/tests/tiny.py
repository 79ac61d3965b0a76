"""The cells' CPU forms: each cell's files with the widths and the mix cut
to a size a CPU test can run, and a runner that prints the result line as
the benchmark's command does.

    python portbench/tests/tiny.py <cell> <trace 0|1> <seed>
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

CLOCK_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[2]

CONFIG = {"vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8,
          "intermediate_size": 128, "max_position_embeddings": 32}
TRAFFIC = {
    "train": {"batch": 4, "seq_len": 32, "grad_accum": 2,
              "reference_rows": 2},
    "serve": {"slots": 4, "window": 24, "decode_tokens": 8,
              "rate_per_s": 20.0,
              "prompt": {"dist": "lognormal", "median": 8, "sigma": 1.0,
                         "min": 2, "max": 24},
              "output": {"dist": "lognormal", "median": 4, "sigma": 0.7,
                         "min": 2, "max": 8},
              "drain_s": 20.0, "profile_at": 0.2, "profile_s": 0.3},
}
SECONDS = 1.5


def cell(name: str, seed: int, trace: bool, root: Path = ROOT,
         clock_start: float = CLOCK_START):
    from portbench import harness

    manifest = harness.load_json(root / harness.MANIFEST)
    work = {w["name"]: w for w in manifest["workloads"]}[name]
    driver = harness.load_json(
        root / "portbench" / "traffic" / f"{work['traffic']}.json")["driver"]
    return harness.cell(root, name, seed, SECONDS, trace, "cpu",
                        clock_start, overrides={"config": CONFIG,
                                                "traffic": TRAFFIC[driver]})


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    torch.set_num_threads(2)
    line, _run = harness.run_cell(cell(argv[0], int(argv[2]),
                                       bool(int(argv[1]))))
    for text in harness.check_lines(line):
        print(text, file=sys.stderr)
    print(json.dumps({"forbidden": harness.forbidden_loaded()}))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
