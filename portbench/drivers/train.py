"""The training driver: the program's ``train.train_loop`` over
``transformer.build(...).step`` on one card, fed from the seed.

Set-up builds the step once (the program's flags from the configuration
and the mix), loads the benchmark's weights into it, and drives it through
``check_steps`` steps of the loop: those steps are the ones checked, and
the same object goes on into the window. The window is the loop again,
over fresh rows, until ``--seconds`` have passed; it ends at a step
boundary through the loop's own planned-drain latch, and its time runs to
the card's end of the last step. Every token of every completed step
counts once.

Once the window has closed and the peak memory has been read, the program
is freed and the reference follows the checked steps in float32 from the
same weights and rows (:func:`reference_readings`).

With ``--trace 1``, from the first step boundary past ``profile_at`` x
the window, ``DEVICE_STEPS`` steps run under the profiler tracing the card
alone, then ``HOST_STEPS`` tracing the host's ranges too
(``profiling.py``). ``mfu.train`` and ``train.dispatch_ms`` read the steps
before the profiler began (fenced there).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from portbench import harness, profiling, weights
from portbench.reference import compare, counts
from portbench.reference import model as ref_model

DEVICE_STEPS = 3
HOST_STEPS = 2
OPS = ("tpu_operator_torch::flash_fwd", "tpu_operator_torch::flash_bwd")


def program_args(cfg: Dict, traffic: Dict, seed: int, device: str):
    """The training payload's flags for this configuration and mix."""
    from tpu_operator_torch.payload import transformer

    if cfg["intermediate_size"] != 4 * cfg["hidden_size"]:
        raise ValueError("the program's MLP is 4 x hidden wide")
    if cfg["max_position_embeddings"] != traffic["seq_len"]:
        raise ValueError("the program's position table spans --seq-len")
    argv = ["--batch", str(traffic["batch"]),
            "--seq-len", str(traffic["seq_len"]),
            "--grad-accum", str(traffic["grad_accum"]),
            "--vocab", str(cfg["vocab_size"]),
            "--dim", str(cfg["hidden_size"]),
            "--heads", str(cfg["num_attention_heads"]),
            "--kv-heads", str(cfg["num_key_value_heads"]),
            "--layers", str(cfg["num_hidden_layers"]),
            "--lr", repr(traffic["adam"]["lr"]),
            "--optimizer", "adam",
            "--adam-mu-dtype", traffic["adam"]["mu_dtype"],
            "--seed", str(seed % 2 ** 31), "--device", device]
    if traffic.get("remat_policy"):
        argv += ["--remat", "--remat-policy", traffic["remat_policy"]]
    return transformer.parse_args(argv)


def rows(cfg: Dict, traffic: Dict, seed: int, step: int) -> np.ndarray:
    """Step ``step``'s [batch, seq_len] token ids, uniform from the seed."""
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), step])
    return rng.integers(0, cfg["vocab_size"],
                        size=(traffic["batch"], traffic["seq_len"]),
                        dtype=np.int64)


def batches(cfg: Dict, traffic: Dict, seed: int, first: int
            ) -> Iterator[Tuple[np.ndarray]]:
    step = first
    while True:
        yield (rows(cfg, traffic, seed, step),)
        step += 1


def _norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.float().pow(2).sum() for t in tensors]).sqrt()


class Program:
    """The program's training step with the benchmark's weights, and the
    readings of its checked steps."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: str):
        from tpu_operator_torch.payload import autotune, transformer

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.args = program_args(cfg, traffic, seed, device)
        self.built = transformer.build(self.args)
        self.device = self.built.device
        self.initial = weights.make(cfg, seed, self.device)
        weights.load_into(self.built.model, self.initial)
        self.names = [n for n, _ in self.built.model.named_parameters()]
        self.params = [p for _, p in self.built.model.named_parameters()]
        self.prefetch = autotune.resolve_prefetch_depth(
            self.args.prefetch_depth)

    def loop(self, step, first: int, steps: int, recorder=None,
             compile_fn=None) -> None:
        """The program's loop over ``step`` from batch ``first``."""
        from tpu_operator_torch.payload import train

        train.train_loop(step, batches(self.cfg, self.traffic, self.seed,
                                       first),
                         steps, device=self.device, heartbeat=None,
                         steptrace=recorder, dataplane=None,
                         prefetch=self.prefetch, compile_fn=compile_fn)

    def check(self) -> Dict:
        """Drive the checked steps through the loop; the losses, the first
        gradient's leaf norms (from adam's second moment after one step)
        and the leaf norms of the change."""
        from tpu_operator_torch.payload import steptrace, train

        losses: List[torch.Tensor] = []
        nu_sq: List[torch.Tensor] = []
        state = self.built.opt_state

        def step(tokens):
            metrics = self.built.step(tokens)
            losses.append(metrics["loss"].detach().clone())
            if len(losses) == 1:
                nu_sq.append(torch.stack([nu.float().sum()
                                          for nu in state.nu]))
            return metrics

        self.loop(step, 0, self.traffic["check_steps"],
                  recorder=steptrace.StepRecorder(),
                  compile_fn=train.kernel_loader(self.device))
        b2 = self.traffic["adam"]["b2"]
        grad = (nu_sq[0] / (1.0 - b2)).sqrt()
        delta = _norms([p.detach() - self.initial[n]
                        for n, p in zip(self.names, self.params)])
        self.initial = None
        return {"losses": [float(x) for x in losses],
                "grad": dict(zip(self.names, grad.tolist())),
                "delta": dict(zip(self.names, delta.tolist()))}


def reference_readings(cfg: Dict, traffic: Dict, seed: int, device,
                       quant=None, half: bool = False) -> Dict:
    """The reference's readings of the checked steps: float32 products
    with TF32 off (``quant``: the control's precision; ``half``: the fault
    that leaves out half of each batch and takes the mean over the rest)."""
    ref_model.set_exact_float32()
    params = weights.make(cfg, seed, device)
    initial = {n: p.clone() for n, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    adam = traffic["adam"]
    opt = ref_model.Adam(adam["lr"], adam["b1"], adam["b2"], adam["eps"])
    losses: List[float] = []
    grad: Dict[str, float] = {}
    pass_rows = traffic["reference_rows"]
    for i in range(traffic["check_steps"]):
        tokens = torch.from_numpy(rows(cfg, traffic, seed, i)).to(device)
        if half:
            tokens = tokens[:tokens.shape[0] // 2]
        for p in params.values():
            p.grad = None
        total = torch.zeros((), device=device)
        for part in tokens.split(pass_rows):
            loss = ref_model.next_token_loss(params, cfg, part, quant) \
                * (part.shape[0] / tokens.shape[0])
            loss.backward()
            total += loss.detach()
        losses.append(float(total))
        if i == 0:
            grad = {n: float(p.grad.norm()) for n, p in params.items()}
        opt.step(params)
    delta = {n: float((p.detach() - initial[n]).norm())
             for n, p in params.items()}
    return {"losses": losses, "grad": grad, "delta": delta}


def step_spread(walls: List[float]) -> Dict[str, float]:
    """The window's step walls on the host's clock: where a slow run lost
    its time, in a few long steps (the host stood still) or in all."""
    if not walls:
        return {}
    w = np.asarray(walls)
    p50 = float(np.median(w))
    return {"p10": float(np.percentile(w, 10)), "p50": p50,
            "p90": float(np.percentile(w, 90)), "max": float(w.max()),
            "over_1.1x_p50": int((w > 1.1 * p50).sum()),
            "excess_s": float(np.clip(w - 1.1 * p50, 0, None).sum())}


def device_kind(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def free_device(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run(cell: harness.Cell) -> harness.Run:
    from tpu_operator_torch.payload import bootstrap, steptrace
    from tpu_operator_torch.payload import flash_attention as fa

    cfg, traffic = cell.config, cell.traffic
    # Where set-up goes, in seconds from the process's start.
    phases = {"imported": time.perf_counter() - cell.clock_start}
    prog = Program(cfg, traffic, cell.seed, cell.device)
    dev = prog.device
    cuda = dev.type == "cuda"
    phases["built"] = time.perf_counter() - cell.clock_start
    readings = prog.check()
    windows = [profiling.Window(cuda, host=False),
               profiling.Window(cuda, host=True)] if cell.trace else []
    edges: List[int] = []  # the steps that start and stop the windows
    steady = {}
    recorder = steptrace.StepRecorder(capacity=1 << 16)
    fa.reset_launch_counts()
    count = [0]
    if cuda:
        torch.cuda.synchronize(dev)
    t_start = time.perf_counter()
    setup_s = t_start - cell.clock_start

    def step(tokens):
        i = count[0]
        if windows and not steady and time.perf_counter() - t_start \
                >= traffic["profile_at"] * cell.seconds:
            if cuda:
                torch.cuda.synchronize(dev)
            steady.update(steps=i, seconds=time.perf_counter() - t_start)
            edges[:] = [i, i + DEVICE_STEPS, i + DEVICE_STEPS + HOST_STEPS]
        if windows and i in edges:
            k = edges.index(i)
            if k:
                windows[k - 1].stop()
            if k < len(windows):
                windows[k].start()
        metrics = prog.built.step(tokens)
        count[0] += 1
        if time.perf_counter() - t_start >= cell.seconds:
            bootstrap.request_planned_drain()
        return metrics

    try:
        prog.loop(step, traffic["check_steps"], 1 << 62, recorder=recorder)
    except SystemExit as e:
        if e.code != bootstrap.EXIT_PLANNED:
            raise
    finally:
        bootstrap.reset_drain()
    if cuda:
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    for w in windows:
        if w.running:
            w.stop()
    steps = count[0]
    window_s = t_end - t_start
    launches = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace = None
    if windows and windows[0].done:
        trace = profiling.combine(
            profiling.reduce(windows[0]),
            profiling.reduce(windows[1], OPS) if windows[1].done else None)
    steady = steady or {"steps": steps, "seconds": window_s}
    first = traffic["check_steps"]
    records = recorder.snapshot()
    dispatch = [r.get("dispatch", 0.0) for r in records
                if r["step"] < first + steady["steps"]]
    walls = [r["stepSeconds"] for r in records if r["step"] >= first]
    prog = None
    free_device(dev)
    ref = reference_readings(cfg, traffic, cell.seed, dev)
    checks = compare.train_numbers(readings, ref)
    free_device(dev)
    return harness.Run(
        attempted=steps, failed=0,
        end_to_end={"train_tokens_per_s":
                    steps * traffic["batch"] * traffic["seq_len"] / window_s,
                    "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak,
        device_kind=device_kind(dev), device_count=1,
        data={"window_s": steady["seconds"], "steps": steady["steps"],
              "cards": 1,
              "flops_per_step": counts.train_step_flops(
                  cfg, traffic["batch"], traffic["seq_len"]),
              "dispatch_s": dispatch},
        trace=trace, counters={"launches": launches,
                               "trace": trace["counts"] if trace else {},
                               "step_s": step_spread(walls),
                               "setup_phases_s": {**phases,
                                                  "checked": setup_s}})
