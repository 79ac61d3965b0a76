"""The one generator of serving traffic: open-loop arrivals and request
sizes from a mix's parameters (``traffic/<mix>.json``).

``rate_per_s`` x the window's seconds requests arrive as a Poisson
process conditioned on that count (normalised exponential gaps). Prompt
and output lengths are lognormal (``median``, ``sigma``), clipped to
``min`` .. ``max``. Gaps and sizes come from the mix's own ``base_seed``,
so every run seed gives the same set of sizes and gaps; the run seed only
orders them and draws the prompt tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Request:
    due_s: float          # after the window's start
    prompt: np.ndarray    # int32 token ids
    max_tokens: int


def _lengths(rng: np.random.Generator, spec: Dict, n: int) -> np.ndarray:
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    x = np.exp(rng.normal(np.log(spec["median"]), spec["sigma"], n))
    return np.clip(np.floor(x), spec["min"], spec["max"]).astype(np.int64)


def requests(traffic: Dict, seed: int, seconds: float, vocab: int
             ) -> List[Request]:
    """The window's requests in due order."""
    n = max(1, int(round(traffic["rate_per_s"] * seconds)))
    base = np.random.default_rng(traffic["base_seed"])
    gaps = base.exponential(1.0, n + 1)
    prompts = _lengths(base, traffic["prompt"], n)
    outputs = _lengths(base, traffic["output"], n)
    run = np.random.default_rng([int(seed) & (2 ** 63 - 1), 1])
    gaps = gaps[run.permutation(n + 1)]
    order = run.permutation(n)
    due = np.cumsum(gaps[:n]) * seconds / gaps.sum()
    tokens = run.integers(0, vocab, int(prompts.sum()), dtype=np.int32)
    out: List[Request] = []
    at = 0
    for i, k in enumerate(order):
        length = int(prompts[k])
        out.append(Request(float(due[i]), tokens[at:at + length],
                           int(outputs[k])))
        at += length
    return out
