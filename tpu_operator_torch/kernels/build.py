"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` at first use,
one ``nvcc`` per source, all started together, then linked into one
shared library with a plain C interface and loaded with ``ctypes``.
Nothing here runs at import time: the CPU-only tests import every module
of the port.

The library is the payload's compilation cache. It is content-named,
``libkernels-<digest>.so``, by the hash of the sources, the
``csrc/*.cuh`` headers they include and the flags
(:func:`source_digest`), with the sha256 of its bytes beside it in
``libkernels-<digest>.sha256``. It lives in ``<cache>/kernels/`` when
``bootstrap.enable_compilation_cache`` enabled the operator's cache dir
(``JAX_COMPILATION_CACHE_DIR`` / ``TPUJOB_CACHE_PATH``), else in
``kernels/_build/``. A library whose name matches the digest and whose
bytes match the recorded sha256 loads with no ``nvcc`` run: a cache hit.
A library that fails that check (torn, corrupt, or the sha256 file lost)
is deleted and rebuilt from the sources, never loaded; a source change
gives another name, so a store that syncs the cache by file name never
hands out a stale library.

A failed build raises RuntimeError with the compiler's output; so does a
kernel whose C entry point returns a non-zero ``cudaError_t``
(:func:`check`). Nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger(__name__)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# The compilation cache's subdirectory that holds the library.
CACHE_SUBDIR = "kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                 "-lineinfo"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock
# How this process got its library: path, seconds, whether nvcc ran.
_load: Dict[str, Any] = {}  # guarded-by: _lock

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
    # head_dim | cluster size out, max active clusters out
    "flash_fwd_wide_cluster": [_I, _P, _P],
    "flash_bwd_dq_wide_cluster": [_I, _P, _P],
    "flash_bwd_dkv_wide_cluster": [_I, _P, _P],
    "flash_merge_wide_cluster": [_I, _P, _P],
    # head_dim, query rows | cluster size out, max active clusters out
    "flash_decode_wide_cluster": [_I, _I, _P, _P],
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


def lib_name(digest: str) -> str:
    """The library's content name for a :func:`source_digest`."""
    return f"libkernels-{digest[:32]}.so"


def kernel_dir() -> Path:
    """Where the library is built and loaded: the compilation cache's
    ``kernels/`` when bootstrap enabled one, else ``kernels/_build/``."""
    from tpu_operator_torch.payload import startup

    cache = startup.cache_dir()
    return Path(cache) / CACHE_SUBDIR if cache else BUILD_DIR


def log_path(build_dir: Optional[Path] = None) -> Path:
    """The compiler's output (ptxas's register and spill report
    included) of the build of the current sources."""
    d = Path(build_dir) if build_dir is not None else kernel_dir()
    return d / (lib_name(source_digest())[:-3] + ".log")


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def verified(lib_path: Path) -> bool:
    """True when ``lib_path`` and its ``.sha256`` file both exist and the
    library's bytes hash to the recorded value."""
    try:
        want = lib_path.with_suffix(".sha256").read_text().strip()
        return bool(want) and _sha256_file(lib_path) == want
    except OSError:
        return False


def _nvcc_build(out: Path, log_file: Path) -> None:
    """Compile every source (one nvcc each, in parallel) into a private
    temporary directory and link the library to ``out``."""
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(src),
                   "-o", str(obj)]
            try:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
            except OSError as e:
                for _s, _o, p in procs:
                    p.kill()
                    p.wait()
                raise RuntimeError(f"nvcc ({nvcc}) did not start: {e}") \
                    from e
            procs.append((src, obj, proc))
        log_parts, failed = [], []
        for src, _obj, proc in procs:
            out_text, _ = proc.communicate()
            log_parts.append(
                f"== {src.name} (rc {proc.returncode})\n{out_text}")
            if proc.returncode != 0:
                failed.append(src.name)
        text = "\n".join(log_parts)
        log_file.write_text(text)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{text}")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
             *[str(obj) for _src, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")


def build(build_dir: Optional[Path] = None,
          compiler: Optional[Callable[[Path, Path], None]] = None) -> Path:
    """Return the path of a verified library for the current sources,
    building it when none is there (``build_dir`` defaults to
    :func:`kernel_dir`). ``compiler(out, log_file)`` writes the library
    to ``out`` (default: nvcc; injectable for tests). A library under the
    digest's name that fails :func:`verified` is removed and rebuilt."""
    d = Path(build_dir) if build_dir is not None else kernel_dir()
    lib_path = d / lib_name(source_digest())
    stamp = lib_path.with_suffix(".sha256")
    if verified(lib_path):
        return lib_path
    if lib_path.exists() or stamp.exists():
        log.warning("kernel library %s fails its sha256 check; rebuilding "
                    "it from the sources", lib_path)
        for stale in (lib_path, stamp):
            try:
                stale.unlink()
            except FileNotFoundError:
                pass
    d.mkdir(parents=True, exist_ok=True)
    # ``*.tmp`` names: the store's cache sync never ships a partial file.
    tmp_lib = d / f"{lib_path.name}.{os.getpid()}.tmp"
    try:
        (compiler or _nvcc_build)(tmp_lib, log_path(d))
        digest = _sha256_file(tmp_lib)
        os.replace(tmp_lib, lib_path)
    finally:
        if tmp_lib.exists():
            tmp_lib.unlink()
    tmp_stamp = d / f"{stamp.name}.{os.getpid()}.tmp"
    tmp_stamp.write_text(digest + "\n")
    os.replace(tmp_stamp, stamp)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            cached = verified(kernel_dir() / lib_name(source_digest()))
            path = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernels_error_string.argtypes = [ctypes.c_int]
            lib.kernels_error_string.restype = ctypes.c_char_p
            _load.update(path=str(path), ranNvcc=not cached,
                         seconds=time.perf_counter() - t0)
            from tpu_operator_torch.payload import startup

            startup.record_kernel_load(ran_nvcc=not cached)
            _lib = lib
        return _lib


def load_info() -> Dict[str, Any]:
    """How this process got its library (``path``, ``seconds``,
    ``ranNvcc``); empty before :func:`library` loaded it."""
    with _lock:
        return dict(_load)


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().kernels_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
