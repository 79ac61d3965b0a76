"""The knee of a serving cell: its mix at a series of fixed rates, one
window each, on the chip.

    python3 portbench/sweep.py --workload <cell> --rates 10,30,50 \\
        [--seconds 15] [--seed 7] [--out <file.jsonl>]

Each rate runs the cell's driver once with the mix's ``rate_per_s`` set to
it, and prints one JSON line: the offered and delivered output tokens per
second, the 95th-percentile latency, the requests that failed. The knee
is the highest rate whose delivered tokens keep up with the offered ones
(no growing backlog) and whose p95 meets a limit set from the unloaded
p95; the cell's mix then takes a rate below it as a number. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=4_000_000_007)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import arrivals, harness

    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        c = harness.cell(ROOT, args.workload, args.seed, args.seconds, False,
                         "cuda", time.perf_counter(),
                         overrides={"traffic": {"rate_per_s": rate}})
        reqs = arrivals.requests(c.traffic, c.seed, c.seconds,
                                 c.config["vocab_size"])
        line, run = harness.run_cell(c)
        m = line["metrics"]
        row = {"workload": c.name, "rate_per_s": rate,
               "offered_tokens_per_s": sum(r.max_tokens for r in reqs)
               / c.seconds,
               "serve_tokens_per_s": m["serve_tokens_per_s"]["value"],
               "serve_p50_s": run.end_to_end["serve_p50_s"],
               "serve_p95_s": run.end_to_end["serve_p95_s"],
               "attempted": line["attempted"], "failed": line["failed"],
               "correct": line["correct"],
               "generator_late_s": run.counters["generator_late_s"],
               "kind": line["device"]["kind"]}
        rows.append(row)
        emit(row, args.out)
    emit(knee(rows), args.out)
    return 0


def knee(rows, keep_up: float = 0.85, slack: float = 2.0):
    """The highest rate whose delivered tokens keep up with the offered
    ones (``keep_up``), with no request failed, and whose p95 is within
    ``slack`` x the lowest rate's p95; and 0.8 x it."""
    limit = slack * rows[0]["serve_p95_s"]
    ok = [r["rate_per_s"] for r in rows
          if r["failed"] == 0 and r["serve_p95_s"] <= limit
          and r["serve_tokens_per_s"] >= keep_up * r["offered_tokens_per_s"]]
    top = max(ok) if ok else 0.0
    return {"knee_rate_per_s": top, "p95_limit_s": limit,
            "cell_rate_per_s": round(0.8 * top, 1)}


def emit(row, out: str) -> None:
    text = json.dumps(row)
    print(text, flush=True)
    if out:
        with open(out, "a", encoding="utf-8") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    sys.exit(main())
