"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``_build/libkernels.so`` at first use, one ``nvcc`` per source, all
started together, then linked into one shared library with a plain C
interface and loaded with ``ctypes``. The library is rebuilt when the hash
of the sources, the ``csrc/*.cuh`` headers they include, and the flags
changes. Nothing here runs at import time: the
CPU-only tests import every module of the port.

A failed build raises RuntimeError with the compiler's output; so does a
kernel whose C entry point returns a non-zero ``cudaError_t``
(:func:`check`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libkernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                 "-lineinfo"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: name -> argtypes (every pointer and the stream as c_void_p,
# so ctypes never truncates them to 32 bits).
SIGNATURES = {
    "flash_fwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, lengths, o, workspace, counters | B, Tq, S, H, KVH,
    # head_dim, workspace floats | scale | stream
    "flash_decode_bf16": [_P] * 7 + [_I] * 7 + [_F, _P],
    # q, k, v, dO, L, O, D, D_out, dq | B, Tq, Tk, H, KVH, head_dim,
    # causal, q_off, k_off, stride | scale | out_f32 | stream
    "flash_bwd_dq_bf16": [_P] * 9 + [_I] * 10 + [_F, _I, _P],
    # q, k, v, dO, L, D, dk, dv | (the same scalars)
    "flash_bwd_dkv_bf16": [_P] * 8 + [_I] * 10 + [_F, _I, _P],
    # q, k, v, o_in, l_in, m_in, o_out, l_out, m_out | B, Tq, Tk, H, KVH,
    # head_dim, causal, q_off, k_off, stride | scale | stream
    "flash_merge_bf16": [_P] * 9 + [_I] * 10 + [_F, _P],
}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    """``$NVCC``, else ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``."""
    explicit = os.environ.get("NVCC")
    if explicit:
        return explicit
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def source_digest() -> str:
    h = hashlib.sha256()
    for path in sources() + headers():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    return h.hexdigest()


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile (if the sources changed) and return the library's path.
    The compiler's output, ptxas register and spill report included, is
    kept in ``build.log`` beside the library."""
    digest = source_digest()
    lib_path = build_dir / LIB_NAME
    stamp = build_dir / "libkernels.sha256"
    if lib_path.exists() and stamp.exists() \
            and stamp.read_text().strip() == digest:
        return lib_path
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log_parts, failed = [], []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            log_parts.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(log_parts)
        (build_dir / "build.log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _src, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    stamp.write_text(digest)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernels_error_string.argtypes = [ctypes.c_int]
            lib.kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().kernels_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
