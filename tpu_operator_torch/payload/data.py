"""The data pipeline of the PyTorch payload (the port's own copy of
``tpu_operator/payload/data.py``'s generators: the LM token streams and
the classifier and regression data).

The generators are numpy only and byte-identical to the reference's: the
same seed gives the same batches, so a parity test can feed both payloads
one stream. In a multi-process job every process draws the same global
batch and keeps its data rank's rows (:func:`lm_batches`,
:func:`data_rank_rows`). :func:`device_prefetch` keeps ``depth``
batches in flight to the device: each batch is staged in pinned host
memory and copied with ``non_blocking``, so the copies overlap the
device's work on earlier steps. Its depth can follow a live knob
(``control``) and its host work can run on a background thread
(``pipeline``), both from the data-plane runtime (``autotune.py``); the
batch order never changes.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, Tuple

import numpy as np
import torch

CIFAR_SHAPE = (32, 32, 3)


def synthetic_cifar(seed: int, batch: int, num_classes: int = 10,
                    noise: float = 0.1
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite stream of (images [batch, 32, 32, 3] f32, labels [batch]
    i32): class k's images cluster around a fixed random prototype plus
    noise, so a model can fit them."""
    rng = np.random.default_rng(seed)
    prototypes = rng.normal(0.5, 0.25, size=(num_classes, *CIFAR_SHAPE)
                            ).astype(np.float32)
    while True:
        labels = rng.integers(0, num_classes, size=batch).astype(np.int32)
        images = prototypes[labels] + rng.normal(
            0.0, noise, size=(batch, *CIFAR_SHAPE)).astype(np.float32)
        yield images, labels


def npz_classification(path: str, seed: int, batch: int,
                       num_classes: int = 0, image_shape: Tuple[int, ...] = ()
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream (images, labels) batches from a mounted ``.npz`` holding
    ``images [N, H, W, C]`` (integer dtypes scaled to [0, 1]) and
    ``labels [N]``, reshuffled every epoch from ``seed``. Validates
    eagerly, with the reference's messages: the label count, the batch
    size, ``image_shape`` and the label range against ``num_classes``
    (an out-of-range label would index past the logits)."""
    with np.load(path) as z:
        raw = z["images"]
        labels = z["labels"].astype(np.int32)
    images = raw.astype(np.float32)
    if np.issubdtype(raw.dtype, np.integer):
        images = images / np.float32(255.0)
    n = len(images)
    if len(labels) != n:
        raise ValueError(
            f"dataset {path}: {n} images but {len(labels)} labels")
    if n < batch:
        raise ValueError(f"dataset {path} has {n} examples < batch {batch}")
    if image_shape and tuple(images.shape[1:]) != tuple(image_shape):
        raise ValueError(
            f"dataset {path} images are {images.shape[1:]}, model expects "
            f"{tuple(image_shape)}")
    if num_classes and (labels.min() < 0 or labels.max() >= num_classes):
        raise ValueError(
            f"dataset {path} labels span [{labels.min()}, {labels.max()}], "
            f"model has {num_classes} classes")

    def stream():
        rng = np.random.default_rng(seed)
        while True:
            perm = rng.permutation(n)
            for i in range(0, n - batch + 1, batch):
                idx = perm[i:i + batch]
                yield images[idx], labels[idx]

    return stream()


def synthetic_linear(seed: int, batch: int, dim: int = 8,
                     noise: float = 0.01
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """y = X w* + b* + noise for a fixed hidden (w*, b*): the
    linear-regression task."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(dim, 1)).astype(np.float32)
    b_true = np.float32(rng.normal())
    while True:
        x = rng.normal(size=(batch, dim)).astype(np.float32)
        y = x @ w_true + b_true + rng.normal(
            0.0, noise, size=(batch, 1)).astype(np.float32)
        yield x, y


def data_rank_rows(stream, rank: int, ranks: int):
    """The rows of data rank ``rank`` of ``ranks`` from each global batch
    (a tuple of arrays sharing the leading batch dim)."""
    if ranks == 1:
        return stream

    def rows(arrays):
        b = arrays[0].shape[0]
        if b % ranks:
            raise ValueError(f"batch {b} does not split over {ranks} data "
                             f"ranks")
        n = b // ranks
        return tuple(a[rank * n:(rank + 1) * n] for a in arrays)

    return (rows(arrays) for arrays in stream)


def synthetic_lm(seed: int, batch: int, seq_len: int,
                 vocab: int = 256) -> Iterator[Tuple[np.ndarray]]:
    """Infinite stream of token sequences [batch, seq_len] i32 following a
    fixed affine recurrence x_{t+1} = (a·x_t + b) mod vocab with random
    starts: a deterministic next-token structure a small LM fits quickly."""
    rng = np.random.default_rng(seed)
    # x → a·x + b mod vocab is a bijection iff gcd(a, vocab) == 1; pick the
    # first odd multiplier coprime to the caller's vocab.
    a, b = 5, 17
    while np.gcd(a, vocab) != 1:
        a += 2
    while True:
        seq = np.empty((batch, seq_len), np.int64)
        seq[:, 0] = rng.integers(0, vocab, size=batch)
        for t in range(1, seq_len):
            seq[:, t] = (a * seq[:, t - 1] + b) % vocab
        yield (seq.astype(np.int32),)


def token_file_lm(path: str, seed: int, batch: int, seq_len: int,
                  vocab: int = 0) -> Iterator[Tuple[np.ndarray]]:
    """Stream [batch, seq_len] i32 token batches from a mounted ``.npy``
    token file (1-D integer array), memory-mapped. Tokens chunk into
    non-overlapping ``seq_len`` windows (remainder dropped); every epoch
    draws a fresh seeded permutation of windows, so the stream is an exact
    function of (file contents, seed). ``vocab`` validates the token range
    eagerly."""
    tokens = np.load(path, mmap_mode="r")
    if tokens.ndim != 1 or not np.issubdtype(tokens.dtype, np.integer):
        raise ValueError(
            f"token file {path}: expected a 1-D integer array, got "
            f"{tokens.dtype}{list(tokens.shape)}")
    n_windows = len(tokens) // seq_len
    if n_windows < batch:
        raise ValueError(
            f"token file {path}: {len(tokens)} tokens = {n_windows} "
            f"windows of {seq_len} < batch {batch}")
    if vocab:
        lo, hi = int(tokens.min()), int(tokens.max())
        if lo < 0 or hi >= vocab:
            raise ValueError(
                f"token file {path} spans [{lo}, {hi}], model vocab is "
                f"{vocab}")

    def stream():
        rng = np.random.default_rng(seed)
        while True:
            perm = rng.permutation(n_windows)
            for i in range(0, n_windows - batch + 1, batch):
                idx = perm[i:i + batch]
                out = np.zeros((batch, seq_len), np.int32)
                for row in range(batch):
                    w = idx[row]
                    out[row] = tokens[w * seq_len:(w + 1) * seq_len]
                yield (out,)

    return stream()


def lm_batches(args, mesh=None) -> Iterator[Tuple[np.ndarray]]:
    """``--data /path/tokens.npy`` selects the memory-mapped token stream,
    else the synthetic recurrence. Every process draws the same global
    ``[batch, seq_len]`` stream and keeps the rows of its batch shard
    (``mesh.batch_rank`` of ``mesh.batch_ranks``; all of them without a
    mesh): whole sequences. On the (data, seq) mesh the shard is the data
    rank, which its seq group shares; on the MoE payload's (data, expert)
    mesh every process holds a shard of its own."""
    data_path = getattr(args, "data", "")
    if data_path:
        stream = token_file_lm(data_path, args.seed, args.batch,
                               args.seq_len, vocab=args.vocab)
    else:
        stream = synthetic_lm(args.seed, args.batch, args.seq_len,
                              vocab=args.vocab)
    if mesh is None:
        return stream
    if args.batch % mesh.batch_ranks:
        raise ValueError(f"batch {args.batch} does not split over "
                         f"{mesh.batch_ranks} data ranks")
    return data_rank_rows(stream, mesh.batch_rank, mesh.batch_ranks)


def device_prefetch(batches, device: torch.device, depth: int = 2,
                    control=None, pipeline: bool = False
                    ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Host batches (tuples of numpy arrays) -> device tensors, ``depth``
    batches ahead of the consumer (0 = one synchronous copy per batch;
    the spec-level 0 = auto is resolved by
    ``autotune.resolve_prefetch_depth`` before it reaches here). On CUDA
    each array is staged in pinned memory and copied with
    ``non_blocking``: the copy is queued on the device's current stream,
    behind the steps already dispatched, and the host returns at once.
    Each batch gets its own pinned buffer from PyTorch's pinned-memory
    allocator, which hands a buffer out again only after the event
    recorded for its copy has completed.

    ``control`` (``autotune.PrefetchControl``) makes the depth live: it
    is re-read before each refill, so a deeper target fills ahead and a
    shallower one stops refilling until the buffer drains down.
    ``pipeline=True`` runs the iterator's ``next()`` and the staging on
    a background thread (``autotune.HostPipeline``); one worker, so the
    stream order is the iterator's, and an error reaches the consumer at
    its position in the stream."""
    if depth < 0:
        raise ValueError(
            f"device_prefetch depth must be >= 0, got {depth} (spec-level "
            f"0=auto is resolved by autotune.resolve_prefetch_depth)")
    device = torch.device(device)
    pinned = device.type == "cuda"
    if pinned and device.index is None:
        # Resolved on the caller's thread: a pipeline worker's current
        # device is its own.
        device = torch.device("cuda", torch.cuda.current_device())

    def place(arrs):
        out = []
        for arr in arrs:
            host = torch.from_numpy(np.ascontiguousarray(arr))
            if pinned:
                host = host.pin_memory()
            out.append(host.to(device, non_blocking=pinned))
        return tuple(out)

    it = iter(batches)
    if pipeline:
        from tpu_operator_torch.payload import autotune as autotune_mod

        pl = autotune_mod.HostPipeline(
            fill=lambda: place(next(it)), control=control,
            depth=max(1, depth))
        try:
            while True:
                try:
                    item = pl.get()
                except StopIteration:
                    return
                yield item
        finally:
            pl.close()
    if control is None and depth == 0:
        for arrs in it:
            yield place(arrs)
        return
    buf: deque = deque()
    exhausted = False
    while True:
        target = depth if control is None else max(1, control.depth)
        while not exhausted and len(buf) < target:
            try:
                buf.append(place(next(it)))
            except StopIteration:
                exhausted = True
        if not buf:
            return
        yield buf.popleft()
