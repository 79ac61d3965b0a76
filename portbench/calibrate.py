"""Readings that set a cell's limits, on the chip at the cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \\
        --control-seeds 3 [--seconds 8] [--out <file.jsonl>]

For each seed, the program's compared numbers (a training cell's checked
steps against the float32 reference; a serving cell's short window at its
own load, its sample against the reference). For the first
``--control-seeds`` seeds also the control (the reference with its dense
products in 8-bit floats put in the program's place) and, for training,
the fault that leaves out half of each batch (planted in the reference).
One JSON line a reading, to standard output and ``--out``. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def train_readings(c, seed: int, control: bool):
    from portbench.drivers import train as drv
    from portbench.reference import compare, precision

    prog = drv.Program(c.config, c.traffic, seed, c.device)
    dev = prog.device
    readings = prog.check()
    prog = None
    drv.free_device(dev)
    ref = drv.reference_readings(c.config, c.traffic, seed, dev)
    out = [{"seed": seed, "side": "program",
            **compare.train_numbers(readings, ref)}]
    if control:
        for side, kw in (("control_fp8", {"quant": precision.fp8}),
                         ("fault_half_batch", {"half": True})):
            other = drv.reference_readings(c.config, c.traffic, seed, dev,
                                           **kw)
            out.append({"seed": seed, "side": side,
                        **compare.train_numbers(other, ref)})
    drv.free_device(dev)
    return out


def serve_readings(c, seed: int, control: bool):
    from portbench import harness
    from portbench.drivers import serve as drv
    from portbench.reference import precision

    c.seed = seed
    line, run = harness.run_cell(c)
    out = [{"seed": seed, "side": "program", "correct": line["correct"],
            **{k: v["value"] for k, v in line["checks"].items()},
            "checked_tokens": run.counters["checked_tokens"]}]
    if control:
        import torch

        dev = torch.device(c.device)
        out.append({"seed": seed, "side": "control_fp8",
                    "logit_gap": drv.reference_gaps(
                        c.config, seed, dev, run.data["checked"],
                        quant=precision.fp8)})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_011)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rate", type=float, default=0.0,
                   help="a serving mix's rate in place of its file's")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    c = harness.cell(ROOT, args.workload, args.first_seed, args.seconds,
                     False, "cuda", time.perf_counter(),
                     overrides={"traffic": {"rate_per_s": args.rate}}
                     if args.rate else None)
    kind = c.traffic["driver"]
    sink = open(args.out, "a", encoding="utf-8") if args.out else None
    try:
        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            fn = train_readings if kind == "train" else serve_readings
            for row in fn(c, seed, i < args.control_seeds):
                text = json.dumps({"workload": c.name, **row})
                print(text, flush=True)
                if sink:
                    sink.write(text + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
