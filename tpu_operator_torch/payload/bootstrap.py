"""Process bootstrap and the exit-code contract for the PyTorch payload
(counterpart of ``tpu_operator/payload/bootstrap.py``).

The operator's env contract is framework-neutral: ``JAX_COORDINATOR_ADDRESS``,
``JAX_PROCESS_ID`` and ``JAX_NUM_PROCESSES`` name the rendezvous, the
``TPUJOB_*`` variables the job. :func:`process_info_from_env` parses them
into :class:`ProcessInfo`.

Serve replicas are single-process servers, so this slice forms no process
group: :func:`initialize` accepts a one-process job and raises for more
(a multi-process NCCL group comes with the training slice).

``run_payload`` maps clean completion -> 0, an application error -> 1
(permanent), and SIGTERM (preemption/eviction) -> 143 (retryable), the
signals the operator's restart machinery classifies. ``EXIT_PLANNED``
(160, a cooperative drain) is kept for the training loop of a later slice.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import sys
from typing import Callable, Optional

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
    )


def initialize(info: Optional[ProcessInfo] = None) -> ProcessInfo:
    """Single-process jobs need no process group. A multi-process job is
    refused: the NCCL rendezvous is not ported yet."""
    info = info or process_info_from_env()
    if info.num_processes > 1:
        raise NotImplementedError(
            f"{info.num_processes}-process jobs need the NCCL process "
            f"group, which is not yet ported to the PyTorch payload")
    log.info("single-process job; no process group")
    return info


EXIT_RETRYABLE = 143  # 128 + SIGTERM: the retryable band
EXIT_PLANNED = 160    # operator-directed (cooperative-drain) restart


def run_payload(fn: Callable[[ProcessInfo], None]) -> int:
    """Run a payload under the exit-code contract: SIGTERM exits 143
    (retryable), any other exception exits 1 (permanent), a clean return
    exits 0."""

    def _sigterm(_signum, _frame):
        raise SystemExit(EXIT_RETRYABLE)

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        info = initialize()
        fn(info)
        code = 0
    except SystemExit as e:
        code = int(e.code or 0)
    except Exception:  # noqa: BLE001 — the contract: app error = permanent
        log.exception("payload failed")
        return 1
    return code


def main_wrapper(fn: Callable[[ProcessInfo], None]) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    sys.exit(run_payload(fn))
