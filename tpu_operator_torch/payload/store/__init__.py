"""Remote warm-start store of the PyTorch payload: a blob backend for
checkpoints and the compilation cache (the port's own copy of
``tpu_operator/store``).

Checkpoints and the kernel library live on node-local directories, so
they survive only a restart on the same node. This package is their
remote half, with the reference's keys, chunking, commit marker, corrupt
markers, retention and artifact paths, so a bucket that either payload
wrote is read by the other: an object-store-shaped blob API
(``blob.py``), chunked parallel transfer with per-chunk sha256 integrity
(``transfer.py``), a job-scoped store of checkpoints, cache entries and
a corrupt-step index (``warmstart.py``), and an asynchronous write-behind
uploader that keeps remote persistence off the step loop
(``writebehind.py``).

Stdlib only, with plain ``threading`` locks. Only the backends the
reference registers ship (``file://`` or a bare path, ``fake://``);
``blob.register_backend`` is the hook for any other scheme.
"""

from tpu_operator_torch.payload.store.blob import (  # noqa: F401
    BlobBackend,
    BlobError,
    BlobNotFound,
    FakeBackend,
    LocalFSBackend,
    from_uri,
    register_backend,
)
from tpu_operator_torch.payload.store.transfer import (  # noqa: F401
    IntegrityError,
    TransferError,
    download_tree,
    upload_tree,
)
from tpu_operator_torch.payload.store.warmstart import (  # noqa: F401
    WarmStartStore,
)
from tpu_operator_torch.payload.store.writebehind import (  # noqa: F401
    WriteBehindUploader,
)
