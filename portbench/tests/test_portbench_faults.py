"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have: a training step that returns its state
unchanged, or that leaves out half of the batch and takes the mean over
the rest; a served token altered where it is produced. (No cell runs on
several cards, so none can leave out an exchange between them.) The
harness's look for a chip is skipped: these are the cells' CPU forms."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests import tiny


def run(name):
    torch.set_num_threads(2)
    line, _run = harness.run_cell(tiny.cell(name, 2 ** 31 + 4099, False))
    return line


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_train_fault_is_not_correct(monkeypatch, fault):
    from tpu_operator_torch.payload import optimizers, train

    if fault == "state_unchanged":
        monkeypatch.setattr(optimizers.Adam, "step",
                            lambda self, params, state: None)
    else:
        whole = train.next_token_nll

        def half(logits, tokens):
            n = logits.shape[0] // 2
            return whole(logits[:n], tokens[:n])

        monkeypatch.setattr(train, "next_token_nll", half)
    line = run("train.flagship-gqa")
    assert line["correct"] is False, line["checks"]


def test_train_unbroken_is_correct():
    assert run("train.flagship-gqa")["correct"] is True


def test_served_token_altered_is_not_correct(monkeypatch):
    from tpu_operator_torch.payload import kvcache

    step = kvcache.DecodeEngine._step
    vocab = tiny.CONFIG["vocab_size"]

    def altered(self, model, active):
        out = np.array(step(self, model, active))
        return (out + vocab // 2) % vocab

    monkeypatch.setattr(kvcache.DecodeEngine, "_step", altered)
    line = run("serve.flagship-gqa.chat")
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["logit_gap"]["value"] \
        > line["checks"]["logit_gap"]["limit"]
