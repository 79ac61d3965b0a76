"""The blob-backend contract: a minimal object-store-shaped API.

Everything above this layer (chunked transfer, the warm-start store)
speaks only these five verbs over flat string keys:

    put(key, data)   — whole-object write, atomic per object
    get(key)         — whole-object read (BlobNotFound when absent)
    delete(key)      — idempotent remove
    list(prefix)     — keys under a prefix, sorted
    exists(key)      — cheap presence probe

That is deliberately the intersection of GCS/S3/ABS object semantics: no
append, no rename, no partial read — so a cloud backend is a thin SDK
wrapper with nothing clever in it. Two backends ship in-repo:

- :class:`LocalFSBackend` — keys are files under a root directory (any
  shared filesystem mount: NFS, Filestore, a gcsfuse mount). Writes are
  tmp-file + ``os.replace``, so an object is either absent or complete —
  the atomicity the transfer layer's resume logic relies on.
- :class:`FakeBackend` — in-process dict with injectable per-op latency
  and fault hooks, for tests and the write-behind bench guard.

Cloud schemes are *gated*: ``from_uri("gs://...")`` raises a clear error
naming :func:`register_backend` instead of importing an SDK this image
does not ship (the container constraint: stub or gate missing deps).
"""

from __future__ import annotations

import os
import threading
import time
import urllib.parse
from typing import Callable, Dict, List, Optional

# Longest key accepted (object stores cap around 1024; ours are short).
_MAX_KEY = 512


class BlobError(Exception):
    """A blob-backend operation failed."""


class BlobNotFound(BlobError):
    """The requested key does not exist."""


def _check_key(key: str) -> str:
    """Keys are '/'-separated relative paths: no empties, no absolute
    paths, no traversal — a malicious or buggy key must not be able to
    escape a filesystem-backed root."""
    if not key or len(key) > _MAX_KEY:
        raise BlobError(f"invalid blob key {key!r}")
    parts = key.split("/")
    if any(p in ("", ".", "..") for p in parts):
        raise BlobError(f"invalid blob key {key!r} (empty/dot segment)")
    return key


class BlobBackend:
    """Abstract backend. Subclasses implement the five verbs; all are
    expected to be thread-safe (the transfer layer fans calls across a
    pool)."""

    scheme = "abstract"

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        try:
            self.get(key)
            return True
        except BlobNotFound:
            return False


class LocalFSBackend(BlobBackend):
    """Objects as files under a root directory (shared-filesystem remote).

    Atomicity: put writes ``<path>.<pid>.tmp`` then ``os.replace``s it, so
    concurrent writers of the same key last-win with complete bytes and a
    reader never observes a torn object. ``*.tmp`` files are invisible to
    list/exists/get."""

    scheme = "file"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *_check_key(key).split("/"))

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as e:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise BlobError(f"put {key!r}: {e}") from e

    def get(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise BlobNotFound(key) from None
        except OSError as e:
            raise BlobError(f"get {key!r}: {e}") from e

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass
        except OSError as e:
            raise BlobError(f"delete {key!r}: {e}") from e

    def list(self, prefix: str = "") -> List[str]:
        # Descend only the subtree the prefix pins: on a shared mount
        # holding MANY jobs' stores, walking the whole root per list
        # (the write-behind worker lists after every verified save) would
        # cost O(all objects of all jobs) in getdents round-trips. The
        # last '/'-segment may be a partial key component, so the walk
        # starts at its parent and the exact-prefix filter finishes the
        # job.
        comps = [c for c in prefix.split("/") if c]
        if comps and not prefix.endswith("/"):
            comps = comps[:-1]
        base = os.path.join(self.root, *comps) if comps else self.root
        out: List[str] = []
        for dirpath, _dirs, files in os.walk(base):
            for fn in files:
                if fn.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))


class FakeBackend(BlobBackend):
    """In-process backend for tests and benches: a dict plus the two knobs
    real object stores hurt with — per-op latency and injected faults.

    ``latency`` sleeps (off-lock) on every op, standing in for a network
    round trip; the write-behind bench guard uses it to prove uploads
    never ride the step loop. ``fault_hook(op, key)`` may raise to inject
    failures (torn uploads, flaky reads); ``corrupt_once(key)`` arms a
    one-shot bit-flip on the next get of ``key`` — the transient-corruption
    case the chunk retry exists for. ``op_counts`` records traffic so
    tests can assert resume actually skipped re-uploads."""

    scheme = "fake"

    def __init__(self, latency: float = 0.0,
                 fault_hook: Optional[Callable[[str, str], None]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.latency = latency
        self.fault_hook = fault_hook
        self._sleep = sleep
        self._lock = threading.Lock()
        self._objects: Dict[str, bytes] = {}  # guarded-by: _lock
        self._corrupt_once: set = set()  # guarded-by: _lock
        self.op_counts: Dict[str, int] = {}  # guarded-by: _lock

    def _op(self, op: str, key: str) -> None:
        with self._lock:
            self.op_counts[op] = self.op_counts.get(op, 0) + 1
        if self.latency > 0:
            self._sleep(self.latency)
        if self.fault_hook is not None:
            self.fault_hook(op, key)

    def corrupt_once(self, key: str) -> None:
        with self._lock:
            self._corrupt_once.add(key)

    def corrupt(self, key: str, data: bytes = b"\xde\xad\xbe\xef") -> None:
        """Permanently replace a stored object's bytes (keeps the key)."""
        with self._lock:
            if key in self._objects:
                self._objects[key] = data

    def put(self, key: str, data: bytes) -> None:
        _check_key(key)
        self._op("put", key)
        with self._lock:
            self._objects[key] = bytes(data)

    def get(self, key: str) -> bytes:
        self._op("get", key)
        with self._lock:
            if key not in self._objects:
                raise BlobNotFound(key)
            data = self._objects[key]
            if key in self._corrupt_once:
                self._corrupt_once.discard(key)
                return b"\x00" * len(data) if data else b"\x00"
            return data

    def delete(self, key: str) -> None:
        self._op("delete", key)
        with self._lock:
            self._objects.pop(key, None)

    def list(self, prefix: str = "") -> List[str]:
        self._op("list", prefix)
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def exists(self, key: str) -> bool:
        self._op("exists", key)
        with self._lock:
            return key in self._objects


# --- URI resolution ----------------------------------------------------------

# Named in-process fake backends: fake://<name> resolves to one shared
# instance per name, so a payload and the test driving it can see the same
# "remote" store without any filesystem.
_fake_lock = threading.Lock()
_fake_registry: Dict[str, FakeBackend] = {}  # guarded-by: _fake_lock

# Deployment-registered schemes (the cloud-SDK hook): scheme -> factory
# taking the full URI.
_scheme_lock = threading.Lock()
# guarded-by: _scheme_lock
_scheme_registry: Dict[str, Callable[[str], BlobBackend]] = {}


def register_backend(scheme: str,
                     factory: Callable[[str], BlobBackend]) -> None:
    """Register a backend factory for a URI scheme (``gs``, ``s3``, ...).
    This is the gate for cloud SDKs the images do not ship: a deployment
    registers its own wrapper at payload/operator start instead of this
    repo importing boto/google-cloud-storage."""
    with _scheme_lock:
        _scheme_registry[scheme.lower()] = factory


def fake_backend(name: str, latency: float = 0.0) -> FakeBackend:
    """The shared named fake instance (created on first use)."""
    with _fake_lock:
        backend = _fake_registry.get(name)
        if backend is None:
            backend = FakeBackend(latency=latency)
            _fake_registry[name] = backend
        return backend


def reset_fake_backends() -> None:
    """Test hook: drop every named fake instance."""
    with _fake_lock:
        _fake_registry.clear()


def from_uri(uri: str) -> BlobBackend:
    """Resolve a store URI to a backend.

    - ``file:///shared/warmstore`` or a bare absolute path → LocalFS
    - ``fake://name[?latency=0.05]`` → the shared named in-process fake
    - a registered scheme (``register_backend``) → its factory
    - anything else → a BlobError naming the registration hook, NOT an
      import error at job runtime.
    """
    if not uri:
        raise BlobError("empty store URI")
    if uri.startswith("/"):
        return LocalFSBackend(uri)
    parsed = urllib.parse.urlparse(uri)
    scheme = (parsed.scheme or "").lower()
    if scheme == "file":
        path = parsed.path or parsed.netloc
        if not path.startswith("/"):
            raise BlobError(f"file:// store URI must be absolute: {uri!r}")
        return LocalFSBackend(path)
    if scheme == "fake":
        params = dict(urllib.parse.parse_qsl(parsed.query))
        try:
            latency = float(params.get("latency", 0.0))
        except ValueError:
            latency = 0.0
        return fake_backend(parsed.netloc or "default", latency=latency)
    with _scheme_lock:
        factory = _scheme_registry.get(scheme)
    if factory is not None:
        return factory(uri)
    raise BlobError(
        f"no blob backend for scheme {scheme!r} ({uri!r}): this build "
        f"ships file:// and fake:// only; register a cloud backend via "
        f"tpu_operator_torch.payload.store.blob.register_backend("
        f"{scheme!r}, factory)")
