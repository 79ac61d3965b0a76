"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers that decide ``correct`` are the last lines of
standard error. Without enough CUDA cards for the cell, or with JAX or the
JAX package loaded once the window has closed, it prints no result and
exits non-zero.
"""

from __future__ import annotations

import time

CLOCK_START = time.perf_counter()

import argparse  # noqa: E402 — the clock above is the process's start
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The program's environment knobs that would make it read or write outside
# the checkout, or talk to an operator: a benchmark run sets none of them.
PROGRAM_ENV = ("TPU_CHECKPOINT_DIR", "TPU_PROFILE_DIR", "TPU_DATA_PATH",
               "JAX_COMPILATION_CACHE_DIR")


def process_start() -> float:
    """perf_counter() at this process's start (from /proc where it can be
    read, else the first line of this file)."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return CLOCK_START


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for name in list(os.environ):
        if name in PROGRAM_ENV or name.startswith("TPUJOB_"):
            del os.environ[name]
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    import torch

    manifest = harness.load_json(ROOT / harness.MANIFEST)
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    c = harness.cell(ROOT, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", process_start())
    line, _run = harness.run_cell(c)
    found = harness.forbidden_loaded()
    if found:
        print(f"loaded in the result's process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for text in harness.check_lines(line):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
