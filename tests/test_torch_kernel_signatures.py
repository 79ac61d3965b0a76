"""The ctypes signatures in ``kernels/build.py`` against the C entry points
of ``kernels/csrc/*.cu``.

No kernel runs here (no nvcc, no card), so a pointer added to or dropped
from an entry point would otherwise show only on the card, as a shifted
argument. Each ``extern "C" int name(...)`` is parsed from the sources and
its parameter types are held against ``build.SIGNATURES``: a pointer (or
the stream) is ``c_void_p``, an ``int`` is ``c_int``, a ``float`` is
``c_float``."""

from __future__ import annotations

import ctypes
import re

import pytest

from tpu_operator_torch.kernels import build

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _entry_points():
    """name -> list of ctypes types, from every ``extern "C" int`` entry."""
    found = {}
    for path in build.sources():
        for name, params in _ENTRY.findall(path.read_text()):
            types = []
            for param in params.split(","):
                param = param.strip()
                if "*" in param:
                    types.append(ctypes.c_void_p)
                elif param.startswith("float"):
                    types.append(ctypes.c_float)
                elif param.startswith("int"):
                    types.append(ctypes.c_int)
                else:
                    raise AssertionError(f"{name}: unknown parameter {param!r}")
            found[name] = types
    return found


def test_every_entry_point_has_a_signature_and_no_more():
    assert set(_entry_points()) == set(build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_signature_matches_the_c_entry_point(name):
    types = _entry_points()[name]
    assert len(build.SIGNATURES[name]) == len(types)
    assert build.SIGNATURES[name] == types

