"""The pod entry point of a GPU job: one payload process per card (one
for a serve pod's cards).

    python -m tpu_operator_torch.payload.launch [--cards N] [--device cpu]
        -- <payload> <args...>

``<payload>`` is a port module: ``transformer``, ``cifar``, ``moe``,
``pipeline``, ``linear`` or ``serve``. The operator gives each pod one
process identity (``JAX_PROCESS_ID`` p of ``JAX_NUM_PROCESSES`` P, one
``JAX_COORDINATOR_ADDRESS``), and a JAX payload drives every chip of its
host from that one process. A port training payload process drives one
card, so this launcher turns the pod's identity into C card processes
(a serve pod: one process for its C cards), C being the cards the
container sees (``torch.cuda.device_count()``: what the device
plugin gave the pod), or fewer with ``--cards``. ``--device cpu --cards N``
runs N gloo processes on the CPU (tests); with no CUDA device and no
``--device cpu`` the launcher raises, and nothing falls back to the CPU.

- **Ranks.** Card c runs ``python -m tpu_operator_torch.payload.<payload>
  <args...>`` with ``JAX_PROCESS_ID`` p·C + c and ``JAX_NUM_PROCESSES``
  P·C; the coordinator address is unchanged, so global rank 0 (pod 0,
  card 0) hosts the TCP store on the operator's port. The launcher binds
  nothing. Ranks are pod-major: a pod's cards hold adjacent ranks, so
  every mesh's innermost (model) group lies inside one pod when C is a
  multiple of its degree (TP over NVLink, data across pods), and a slice's
  ranks stay contiguous (``collectives.check_slices``). The payload's
  ``process_id % device_count`` is then card c. Every other variable
  (``TPU_WORKER_*``, ``MEGASCALE_*``, ``TPUJOB_*``) passes through.
- **Heartbeats keep the operator's identity.** ``TPUJOB_HEARTBEAT_ID`` is
  p on card 0 and ``none`` on the others (``heartbeat.from_env``): pod 0's
  card 0 sends the full stream, the other pods' card 0 cadence-only
  beats, the other cards none. A drain directive thus reaches global rank
  0, and ``train.agreed_drain_code`` carries it to every process.
  ``TPUJOB_POD_CARDS`` is C, which rank 0 checks across pods before the
  rendezvous (``bootstrap.check_pods``).
- **Kernels are built once**, here, into the operator's cache volume
  (``bootstrap.enable_compilation_cache``), before any card process
  starts; the card processes load that library. A failed build exits 1.
- **The exit contract is the reference bootstrap's, for the pod.** The
  launcher is the container's PID 1: it reaps its children and forwards
  every SIGTERM (and SIGINT) to every card process. A card that exits
  with any code but 0, 143 or 160 makes the launcher SIGTERM the rest,
  SIGKILL them after ``GRACE`` seconds, and exit with that card's code
  (128 + the signal when a signal ended it). Otherwise it exits with the
  code the cards agreed on, the largest of theirs (160 over 143 over 0,
  the operator's precedence). Codes it forced by killing siblings do not
  count. Each line a card prints is prefixed with ``[card c]``.
- **A serve pod is one process.** A serve pod (``TPUJOB_SERVE=1`` or the
  ``serve`` payload) runs one process for its C cards, as the JAX replica
  drives its host's chips: ``JAX_PROCESS_ID`` and ``JAX_NUM_PROCESSES``
  pass through (serve replicas form no process group),
  ``TPUJOB_HEARTBEAT_ID`` is the pod's id and ``TPUJOB_POD_CARDS`` is C;
  the server spreads its slots over ``cuda:0`` ... ``cuda:C-1`` behind one
  ingress (``serve.py``).

The launcher has no counterpart module in the JAX package: it is the
port's counterpart of one JAX process driving its host's chips.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import heartbeat

log = logging.getLogger(__name__)

PAYLOADS = ("transformer", "cifar", "moe", "pipeline", "linear", "serve")
# The codes a card process ends with on its own: done, drained, planned.
AGREED = (0, bootstrap.EXIT_RETRYABLE, bootstrap.EXIT_PLANNED)
# Seconds between the SIGTERM to a failed card's siblings and the SIGKILL.
GRACE = 30.0
POLL = 0.05  # seconds between reaps


def card_count(cards: int, device: str) -> int:
    """The cards this pod runs: the container's CUDA devices, or
    ``cards`` of them; on the CPU (``device`` "cpu") ``cards``, default
    1. Raises RuntimeError with no CUDA device, ValueError for a count
    out of range."""
    if cards < 0:
        raise ValueError(f"--cards {cards} must be >= 1")
    if device == "cpu":
        return cards or 1
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device in this container: a GPU pod needs its "
            "nvidia.com/gpu request (pass --device cpu to run gloo "
            "processes on the CPU)")
    seen = torch.cuda.device_count()
    if cards > seen:
        raise ValueError(f"--cards {cards} asks for more cards than the "
                         f"{seen} this container sees")
    return cards or seen


def is_serve(payload: str, env: Dict[str, str]) -> bool:
    return payload == "serve" or env.get("TPUJOB_SERVE") == "1"


def card_envs(env: Dict[str, str], cards: int,
              payload: str = "") -> List[Dict[str, str]]:
    """The env of each process of the pod whose operator env is ``env``:
    per card, rank p·C + c of P·C, the heartbeat identity and the card
    count; a serve pod's one process keeps the pod's rank and world and
    beats under the pod's id. Every other variable is unchanged."""
    if cards < 1:
        raise ValueError(f"a pod runs at least one card, got {cards}")
    pod = int(env.get("JAX_PROCESS_ID", "0"))
    if is_serve(payload, env):
        e = dict(env)
        e[heartbeat.ENV_BEAT_ID] = str(pod)
        e[bootstrap.ENV_POD_CARDS] = str(cards)
        return [e]
    pods = int(env.get("JAX_NUM_PROCESSES", "1"))
    out = []
    for card in range(cards):
        e = dict(env)
        e["JAX_PROCESS_ID"] = str(pod * cards + card)
        e["JAX_NUM_PROCESSES"] = str(pods * cards)
        e[heartbeat.ENV_BEAT_ID] = str(pod) if card == 0 \
            else heartbeat.NO_BEATS
        e[bootstrap.ENV_POD_CARDS] = str(cards)
        out.append(e)
    return out


def card_command(payload: str, args: Sequence[str],
                 device: str = "") -> List[str]:
    """One card process's command line: the payload module under this
    interpreter (``--device cpu`` appended on the CPU)."""
    if payload not in PAYLOADS:
        raise ValueError(f"unknown payload {payload!r}; one of "
                         f"{', '.join(PAYLOADS)}")
    extra = ["--device", "cpu"] if device == "cpu" else []
    return [sys.executable, "-m", f"tpu_operator_torch.payload.{payload}",
            *args, *extra]


def exit_code(returncode: int) -> int:
    """A child's return code as a shell reports it: 128 + the signal
    that ended it."""
    return 128 - returncode if returncode < 0 else returncode


def _pump(card: int, stream, out, lock: threading.Lock) -> None:
    prefix = f"[card {card}] ".encode()
    for line in iter(stream.readline, b""):
        with lock:
            out.write(prefix + line)
            out.flush()
    stream.close()


def supervise(commands: Sequence[Sequence[str]],
              envs: Sequence[Dict[str, str]], grace: float = GRACE) -> int:
    """Run one process per card (``commands[c]`` under ``envs[c]``) to
    its end under the pod's exit contract (module docstring); returns the
    pod's exit code. Call it from the main thread: it installs the
    SIGTERM and SIGINT handlers that forward to the cards."""
    out = sys.stdout.buffer
    lock = threading.Lock()
    procs: List[subprocess.Popen] = []
    signals: List[tuple] = []  # (signal, cards spawned when it came)

    def forward(signum, _frame):
        signals.append((signum, len(procs)))
        for proc in procs:
            if proc.returncode is None:
                try:
                    os.kill(proc.pid, signum)
                except ProcessLookupError:
                    pass

    previous = {s: signal.signal(s, forward)
                for s in (signal.SIGTERM, signal.SIGINT)}
    pumps = []
    try:
        for card, (cmd, env) in enumerate(zip(commands, envs)):
            proc = subprocess.Popen(list(cmd), env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
            procs.append(proc)
            pumps.append(threading.Thread(
                target=_pump, args=(card, proc.stdout, out, lock),
                daemon=True, name=f"card-{card}-output"))
            pumps[-1].start()
        if signals:
            # A signal that came while the cards were starting reaches
            # the ones started after it, too.
            signum, spawned = signals[0]
            for proc in procs[spawned:]:
                proc.send_signal(signum)
        code = _reap(procs, grace)
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
        for proc in procs:
            if proc.returncode is None:
                proc.kill()
                proc.wait()
        for pump in pumps:
            pump.join(timeout=5)
    return code


def _ended(procs: List[subprocess.Popen], done) -> List[tuple]:
    """(card, wait status) of the card processes that ended since the
    last call. As the container's PID 1 this reaps every child, the
    orphans the container's processes leave to it included."""
    if os.getpid() == 1:
        by_pid = {proc.pid: card for card, proc in enumerate(procs)}
        ended = []
        while True:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                return ended
            if pid == 0:
                return ended
            if pid in by_pid:
                ended.append((by_pid[pid], status))
    ended = []
    for card, proc in enumerate(procs):
        if card not in done:
            pid, status = os.waitpid(proc.pid, os.WNOHANG)
            if pid:
                ended.append((card, status))
    return ended


def _reap(procs: List[subprocess.Popen], grace: float) -> int:
    """Wait for every card process; the pod's exit code."""
    codes: Dict[int, int] = {}
    failed: Optional[int] = None
    kill_at: Optional[float] = None
    while len(codes) < len(procs):
        ended = _ended(procs, codes)
        for card, status in ended:
            procs[card].returncode = os.waitstatus_to_exitcode(status)
            codes[card] = exit_code(procs[card].returncode)
            log.info("card %d exited %d", card, codes[card])
            if failed is None and codes[card] not in AGREED:
                failed = codes[card]
                log.error("card %d failed (exit %d): stopping the other "
                          "cards", card, failed)
                for proc in procs:
                    if proc.returncode is None:
                        proc.send_signal(signal.SIGTERM)
                kill_at = time.monotonic() + grace
        if kill_at is not None and time.monotonic() >= kill_at:
            for card, proc in enumerate(procs):
                if proc.returncode is None:
                    log.error("card %d outlived the %.0f s grace period: "
                              "SIGKILL", card, grace)
                    proc.kill()
            kill_at = None
        if not ended:
            time.sleep(POLL)
    if failed is not None:
        return failed
    return max(codes.values())


def parse_args(argv: Sequence[str]):
    """(launcher options, payload, payload args) from ``argv``: the
    launcher's options, ``--``, then the payload and its arguments."""
    argv = list(argv)
    if "--" not in argv:
        raise SystemExit("usage: python -m tpu_operator_torch.payload.launch "
                         "[--cards N] [--device cpu] -- <payload> "
                         "<args...>")
    split = argv.index("--")
    p = argparse.ArgumentParser(
        prog="python -m tpu_operator_torch.payload.launch",
        description="Run one payload process per card of this pod.")
    p.add_argument("--cards", type=int, default=0,
                   help="cards to run (default: every card the container "
                        "sees; on the CPU 1)")
    p.add_argument("--device", default="", choices=["", "cpu"],
                   help="cpu: gloo processes on the CPU (tests)")
    opts = p.parse_args(argv[:split])
    rest = argv[split + 1:]
    if not rest:
        p.error("no payload after --")
    return opts, rest[0], rest[1:]


def plan(argv: Sequence[str], env: Optional[Dict[str, str]] = None):
    """(commands, envs, options) of the pod that ``argv`` describes: one
    process per card, or one for a serve pod's cards."""
    opts, payload, args = parse_args(argv)
    env = dict(env if env is not None else os.environ)
    cards = card_count(opts.cards, opts.device)
    envs = card_envs(env, cards, payload)
    for e in envs:
        # A card's prints reach its prefixed stream as they happen, not
        # when a pipe's buffer fills (or never, when it is killed).
        e.setdefault("PYTHONUNBUFFERED", "1")
    command = card_command(payload, args, opts.device)
    return [command] * len(envs), envs, opts


def build_kernels() -> None:
    """Build (or find and verify) the kernel library once for every card
    process, in the operator's cache volume when it mounted one; the
    card processes load it."""
    bootstrap.enable_compilation_cache()
    from tpu_operator_torch.kernels import build

    build.build()


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s [launch] "
                               "%(message)s")
    try:
        commands, envs, opts = plan(sys.argv[1:] if argv is None else argv)
        if opts.device != "cpu":
            build_kernels()
    except Exception:  # noqa: BLE001 — the contract: a pod error is permanent
        log.exception("pod launch failed")
        return 1
    log.info("pod %s of %s: %d card process(es), ranks %s of %s, %s "
             "card(s)", os.environ.get("JAX_PROCESS_ID", "0"),
             os.environ.get("JAX_NUM_PROCESSES", "1"), len(commands),
             [int(e.get("JAX_PROCESS_ID", "0")) for e in envs],
             envs[0].get("JAX_NUM_PROCESSES", "1"),
             envs[0][bootstrap.ENV_POD_CARDS])
    code = supervise(commands, envs)
    log.info("pod exits %d", code)
    return code


if __name__ == "__main__":
    sys.exit(main())
