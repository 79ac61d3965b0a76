"""The isolation check compares each loaded module's top-level name whole:
the port (``tpu_operator_torch``) is allowed, JAX and the JAX package
(``tpu_operator``) are refused."""

import sys
import types

import pytest

from portbench import harness
from portbench.tests import tiny


@pytest.mark.parametrize("name,refused", [
    ("tpu_operator_torch", False),
    ("tpu_operator_torch.payload.serve", False),
    ("tpu_operator_tools", False),
    ("jaxtyping", False),
    ("tpu_operator", True),
    ("tpu_operator.payload.serve", True),
    ("jax", True),
    ("jax.numpy", True),
    ("jaxlib", True),
    ("flax.linen", True),
])
def test_top_level_names_are_compared_whole(monkeypatch, name, refused):
    for key in [k for k in sys.modules
                if k.split(".", 1)[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, key)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_loaded()
    assert found == ([name.split(".", 1)[0]] if refused else [])


def test_benchmark_sources_import_no_jax():
    """No file of the benchmark names JAX or the JAX package in an
    import."""
    for path in (tiny.ROOT / "portbench").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".", 1)[0].rstrip(",")
                assert top not in harness.FORBIDDEN, f"{path}: {line}"
