"""Process bootstrap and the exit-code contract for the PyTorch payload
(counterpart of ``tpu_operator/payload/bootstrap.py``).

The operator's env contract is framework-neutral: ``JAX_COORDINATOR_ADDRESS``,
``JAX_PROCESS_ID`` and ``JAX_NUM_PROCESSES`` name the rendezvous, the
``TPUJOB_*`` variables the job. :func:`process_info_from_env` parses them
into :class:`ProcessInfo`.

:func:`initialize` forms the multi-process group of a training job from
that env: ``JAX_COORDINATOR_ADDRESS`` is the TCP store's address,
``JAX_PROCESS_ID`` the rank and ``JAX_NUM_PROCESSES`` the world size. One
process runs per pod and drives one card, ``cuda:(process_id %
device_count)``; the backend follows the device the entry point runs on
(NCCL for CUDA, gloo only when the caller asked for the CPU; NCCL never
falls back to gloo; beside NCCL a gloo group carries the host-side
agreement of the drain code). A one-process job (a serve replica, the
one-card trainer) forms no group. Under the pod launcher (``launch.py``:
one process per card, ``TPUJOB_POD_CARDS`` cards a pod) global rank 0
first checks that every pod runs that many cards (:func:`check_pods`),
so pods that disagree fail with a clear error instead of waiting out the
rendezvous.

The remote warm-start store's prefetch (``warmstore.py``) starts before
the rendezvous and is joined after it, so the download overlaps the wait
(the RENDEZVOUS and PREFETCH startup stages). :func:`enable_compilation_cache`
points the kernel library at the operator's cache volume
(``JAX_COMPILATION_CACHE_DIR`` / ``TPUJOB_CACHE_PATH``, the operator's
names): ``kernels/build.py`` then builds into and loads from it.

``run_payload`` maps clean completion -> 0, an application error -> 1
(permanent), SIGTERM (preemption/eviction) -> 143 (retryable), and an
operator-directed drain -> ``EXIT_PLANNED`` (160), the signals the
operator's restart machinery classifies; on 0, 143 and 160 it ships the
cache to the store. While a training step loop runs, SIGTERM defers to
the next step boundary through the drain latch below.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import socket
import sys
import threading
import time
from datetime import timedelta
from typing import Callable, Optional

from tpu_operator_torch.payload import startup as startup_mod
from tpu_operator_torch.payload import warmstore

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    """This process's place in the job (parsed injected env)."""

    coordinator_address: str  # host:port
    process_id: int
    num_processes: int
    worker_id: int
    worker_hostnames: tuple
    job_name: str = ""
    replica_type: str = "worker"
    attempt: int = 0
    num_slices: int = 1
    slice_id: int = 0
    runtime_id: str = ""
    replica_index: int = 0
    pod_cards: int = 0  # cards of this pod under the launcher, else 0


# Set by the pod launcher on each card process: the pod's card count.
ENV_POD_CARDS = "TPUJOB_POD_CARDS"


def process_info_from_env(env: Optional[dict] = None) -> ProcessInfo:
    e = env if env is not None else os.environ
    return ProcessInfo(
        coordinator_address=e.get("JAX_COORDINATOR_ADDRESS", ""),
        process_id=int(e.get("JAX_PROCESS_ID", "0")),
        num_processes=int(e.get("JAX_NUM_PROCESSES", "1")),
        worker_id=int(e.get("TPU_WORKER_ID", e.get("JAX_PROCESS_ID", "0"))),
        worker_hostnames=tuple(
            h for h in e.get("TPU_WORKER_HOSTNAMES", "").split(",") if h
        ),
        job_name=e.get("TPUJOB_NAME", ""),
        replica_type=e.get("TPUJOB_REPLICA_TYPE", "worker"),
        attempt=int(e.get("TPUJOB_ATTEMPT", "0")),
        num_slices=int(e.get("MEGASCALE_NUM_SLICES", "1")),
        slice_id=int(e.get("MEGASCALE_SLICE_ID", "0")),
        runtime_id=e.get("TPUJOB_RUNTIME_ID", ""),
        replica_index=int(e.get("TPUJOB_REPLICA_INDEX", "0")),
        pod_cards=int(e.get(ENV_POD_CARDS, "0")),
    )


# First DNS poll delay; doubles up to the ``interval`` cap.
INITIAL_DNS_POLL = 0.05

# How long process-group formation and each collective may wait for peers.
GROUP_TIMEOUT = timedelta(minutes=10)


def wait_for_coordinator(address: str, timeout: float = 300.0,
                         interval: float = 2.0,
                         sleep: Callable[[float], None] = time.sleep,
                         clock: Callable[[], float] = time.monotonic) -> None:
    """Block until the coordinator's DNS name resolves (the operator
    creates the Service before any pod, but cluster DNS takes seconds to
    propagate). Polls at 50 ms first, with capped exponential backoff up to
    ``interval``; raises TimeoutError after ``timeout`` seconds.
    ``sleep``/``clock`` are injectable for tests."""
    host = address.rsplit(":", 1)[0]
    deadline = clock() + timeout
    delay = min(INITIAL_DNS_POLL, interval) if interval > 0 else 0.0
    while True:
        try:
            socket.getaddrinfo(host, None)
            return
        except socket.gaierror:
            now = clock()
            if now >= deadline:
                raise TimeoutError(
                    f"coordinator DNS {host!r} did not resolve in "
                    f"{timeout:.0f}s")
            if delay >= interval:
                log.info("waiting for coordinator DNS %s ...", host)
            else:
                log.debug("waiting for coordinator DNS %s ...", host)
            sleep(min(delay, max(0.0, deadline - now)))
            delay = min(delay * 2 if delay > 0 else interval, interval)


def initialize(info: Optional[ProcessInfo] = None,
               device: Optional[str] = None) -> ProcessInfo:
    """Form the process group of a multi-process job; a one-process job
    forms none. ``device`` is the device the entry point runs on (default
    CUDA): CUDA takes NCCL and the card ``process_id % device_count``, the
    CPU takes gloo. The DNS wait and the rendezvous are the RENDEZVOUS
    stage; the store prefetch starts first and is joined last, so only
    its tail beyond the rendezvous is the PREFETCH stage."""
    info = info or process_info_from_env()
    prefetching = warmstore.start_prefetch()
    if info.num_processes <= 1:
        log.info("single-process job; no process group")
        startup_mod.record_rendezvous(0.0)
        if prefetching:
            warmstore.finish_prefetch()
        return info
    t0 = time.perf_counter()
    import torch
    import torch.distributed as dist

    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device for the NCCL process group; pass device="
                "'cpu' to form a gloo group on the CPU")
        torch.cuda.set_device(info.process_id % torch.cuda.device_count())
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    wait_for_coordinator(info.coordinator_address)
    host, port = info.coordinator_address.rsplit(":", 1)
    # Rank 0 hosts the store without waiting for the others to connect,
    # so that it can check the pods before the group's rendezvous.
    store = dist.TCPStore(host, int(port), info.num_processes,
                          info.process_id == 0, GROUP_TIMEOUT,
                          wait_for_workers=False)
    if info.pod_cards:
        check_pods(store, info)
    dist.init_process_group(
        backend, store=store, rank=info.process_id,
        world_size=info.num_processes, timeout=GROUP_TIMEOUT)
    global _host_group
    # Host-side agreement (the drain code) rides gloo on CPU tensors, so
    # reading it never waits on the card's stream.
    _host_group = dist.new_group(backend="gloo") if backend == "nccl" \
        else None
    startup_mod.record_rendezvous(time.perf_counter() - t0)
    if prefetching:
        warmstore.finish_prefetch()
    log.info("process %d/%d joined the %s group at %s", info.process_id,
             info.num_processes, backend, info.coordinator_address)
    return info


_host_group = None


def check_pods(store, info: ProcessInfo,
               timeout: timedelta = GROUP_TIMEOUT) -> None:
    """The launched world's check: the launcher gives pod p's card c the
    rank p·C + c of P·C, which holds only when every pod runs the same C.
    Each pod's card 0 writes its C under its pod index; global rank 0
    waits for all P pods and raises RuntimeError naming the pods whose
    count differs from its own. The other pods' processes then fail when
    rank 0's store goes away, instead of waiting out the rendezvous with
    ranks that collide or never come."""
    cards = info.pod_cards
    pod, card = divmod(info.process_id, cards)
    if card == 0:
        store.set(f"tpujob/pod/{pod}/cards", str(cards))
    if info.process_id != 0:
        return
    pods = info.num_processes // cards
    keys = [f"tpujob/pod/{q}/cards" for q in range(pods)]
    store.wait(keys, timeout)
    counts = [int(store.get(k)) for k in keys]
    other = {q: n for q, n in enumerate(counts) if n != cards}
    if other or info.num_processes % cards:
        raise RuntimeError(
            f"the pods of this job run different card counts: pod 0 runs "
            f"{cards} (a world of {info.num_processes} processes), "
            + ", ".join(f"pod {q} runs {n}" for q, n in other.items())
            + "; every pod of a GPU job must ask for the same number of "
              "cards")


def enable_compilation_cache(env: Optional[dict] = None) -> str:
    """Point the kernel library at the operator-mounted cache volume
    (``JAX_COMPILATION_CACHE_DIR``, or its mirror ``TPUJOB_CACHE_PATH``;
    ``TPUJOB_CACHE_ENABLED=0`` turns it off): ``kernels/build.py`` then
    builds into and loads from ``<dir>/kernels/``. Returns the dir, or ""
    when caching is off or the dir is unusable.

    Best-effort: a read-only or otherwise unwritable dir logs a warning
    and the attempt builds cold in ``kernels/_build/``; a broken cache
    volume degrades warm restarts, never fails them."""
    e = env if env is not None else os.environ
    path = warmstore.cache_dir_from_env(e)
    if not path:
        return ""
    if e.get("TPUJOB_CACHE_ENABLED", "1").lower() in ("0", "false"):
        return ""
    try:
        os.makedirs(path, exist_ok=True)
        probe = os.path.join(path, f".tpujob-cache-probe-{os.getpid()}")
        with open(probe, "w", encoding="utf-8") as f:
            f.write("ok")
        os.remove(probe)
    except OSError as err:
        log.warning("compilation cache dir %s unusable (%s); proceeding "
                    "with a cold kernel build", path, err)
        return ""
    startup_mod.set_cache_dir(path)
    log.info("persistent compilation cache at %s (medium %s)",
             path, e.get("TPUJOB_CACHE_MEDIUM", "unset"))
    return path


def host_group():
    """The group for small host-side collectives on CPU tensors: a gloo
    group beside NCCL, else the default group (None)."""
    return _host_group


def world_size() -> int:
    """Processes in the job's group (1 when no group was formed)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank in the job's group (0 when no group was
    formed)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def shutdown() -> None:
    """Leave the process group, if one was formed."""
    import torch.distributed as dist

    global _host_group
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


EXIT_RETRYABLE = 143  # 128 + SIGTERM: the retryable band
EXIT_PLANNED = 160    # operator-directed (cooperative-drain) restart


# Drain latch (the reference's, bootstrap.py:239-280). SIGTERM inside the
# step loop sets it, and the loop exits EXIT_RETRYABLE at the next step
# boundary instead of mid-step; outside the loop, or on a second SIGTERM,
# the process exits at once. A drain DIRECTIVE (the operator's
# cooperative-drain protocol, riding a heartbeat ACK) arms the same latch
# plus _planned, and the loop exits EXIT_PLANNED, so the restart is billed
# as planned, not preempted.
_drain = threading.Event()
_planned = threading.Event()
_in_step_loop = threading.Event()


def request_drain() -> None:
    _drain.set()


def request_planned_drain() -> None:
    """Arm the drain latch for an operator-directed (planned) restart:
    drain at the next step boundary and exit EXIT_PLANNED."""
    _planned.set()
    _drain.set()


def draining() -> bool:
    return _drain.is_set()


def drain_exit_code() -> int:
    """The exit code the current drain latch maps to: EXIT_PLANNED for a
    directive-driven drain, EXIT_RETRYABLE for a signal-driven one."""
    return EXIT_PLANNED if _planned.is_set() else EXIT_RETRYABLE


def reset_drain() -> None:
    """Test hook: clear the module-level drain latches."""
    _drain.clear()
    _planned.clear()


def enter_step_loop() -> None:
    """The training loop marks itself drainable; SIGTERM then defers to
    the next step boundary instead of killing the process mid-step."""
    _in_step_loop.set()


def exit_step_loop() -> None:
    _in_step_loop.clear()


def run_payload(fn: Callable[[ProcessInfo], None],
                device: Optional[str] = None) -> int:
    """Run a payload under the exit-code contract: SIGTERM exits 143
    (retryable; inside a training step loop, at the next step boundary),
    a planned drain 160, any other exception 1 (permanent), a clean
    return 0. ``device`` picks the process group's backend
    (:func:`initialize`). The compilation cache is enabled after the
    group forms, and synced to the store on exits 0, 143 and 160."""

    def _sigterm(_signum, _frame):
        if _drain.is_set() or not _in_step_loop.is_set():
            raise SystemExit(EXIT_RETRYABLE)
        log.info("SIGTERM: draining at the next step boundary (send again "
                 "to exit immediately)")
        request_drain()

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        info = initialize(device=device)
        enable_compilation_cache()
        fn(info)
        code = 0
    except SystemExit as e:
        code = int(e.code or 0)
    except Exception:  # noqa: BLE001 — the contract: app error = permanent
        log.exception("payload failed")
        code = 1
    finally:
        shutdown()
    if code in (0, EXIT_RETRYABLE, EXIT_PLANNED):
        # Ship this attempt's kernel library to the store on the clean and
        # drain exits: a job without checkpoints has no write-behind
        # uploader, and an attempt may drain before its first save.
        warmstore.upload_cache_once()
    return code


def main_wrapper(fn: Callable[[ProcessInfo], None],
                 device: Optional[str] = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    sys.exit(run_payload(fn, device=device))
