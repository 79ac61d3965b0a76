"""The operator's env contract against the port: the reference rule
``tpu_operator/analysis/env_contract.py`` pointed at
``tpu_operator_torch/payload/`` (its ``PAYLOAD_DIR``, patched for the
test; the analyzer itself is unchanged). Every env name the port reads is
injected by ``trainer/replicas.py`` or stands below with its reason, and
every name the operator injects is read by the port or stands below with
its reason."""

from pathlib import Path

from tpu_operator.analysis import env_contract

REPO = Path(__file__).resolve().parent.parent

# Names the port reads that the operator does not inject.
READ_UNINJECTED = {
    # The pod launcher's own variables (payload/launch.py sets them on
    # each card process).
    "TPUJOB_HEARTBEAT_ID": "launcher: the pod's process id on its card 0, "
                           "'none' on the others (heartbeat.from_env)",
    "TPUJOB_POD_CARDS": "launcher: the pod's card count, which rank 0 "
                        "checks across pods (bootstrap.check_pods) and a "
                        "serve pod's one process drives "
                        "(serve.pod_devices)",
    # User knobs, as the reference's allowlist has them.
    "TPUJOB_HEARTBEAT_INTERVAL": "user-tunable via template env; the "
                                 "default is in code",
    "TPU_DATA_PATH": "dataset path users provide via template env",
}

# Names the operator injects that the port does not read.
INJECTED_UNREAD = {
    "TPU_TOPOLOGY": "consumed by libtpu on a TPU host; a GPU job has no "
                    "tpuTopology",
    "MEGASCALE_COORDINATOR_ADDRESS": "consumed by libtpu's megascale DCN "
                                     "transport; the port's groups ride "
                                     "JAX_COORDINATOR_ADDRESS",
}


def _findings(monkeypatch):
    monkeypatch.setattr(env_contract, "PAYLOAD_DIR",
                        ("tpu_operator_torch", "payload"))
    return {f.key: f for f in env_contract.run(REPO)}


def test_every_name_the_port_reads_is_injected_or_listed(monkeypatch):
    found = _findings(monkeypatch)
    read = {k.split(":", 1)[1] for k in found
            if k.startswith("read-uninjected:")}
    assert read == set(READ_UNINJECTED), {
        k: f"{f.path}:{f.line}" for k, f in found.items()
        if k.split(":", 1)[1] not in READ_UNINJECTED}


def test_every_name_the_operator_injects_is_read_or_listed(monkeypatch):
    found = _findings(monkeypatch)
    unread = {k.split(":", 1)[1] for k in found
              if k.startswith("injected-unread:")}
    assert unread == set(INJECTED_UNREAD)


def test_the_rule_sees_the_port(monkeypatch):
    """The patched rule reads the port's files, not the reference's: the
    launcher's names are found there, and in no file of the reference."""
    assert "TPUJOB_HEARTBEAT_ID" not in env_contract._payload_reads(REPO)
    monkeypatch.setattr(env_contract, "PAYLOAD_DIR",
                        ("tpu_operator_torch", "payload"))
    reads = env_contract._payload_reads(REPO)
    for name in ("TPUJOB_HEARTBEAT_ID", "JAX_PROCESS_ID"):
        assert reads[name].startswith("tpu_operator_torch/payload/"), name
