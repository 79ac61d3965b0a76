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
device's work on earlier steps.
"""

from __future__ import annotations

import logging
import os
from collections import deque
from typing import Iterator, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

ENV_PREFETCH_DEPTH = "TPUJOB_DATAPLANE_PREFETCH_DEPTH"
DEFAULT_PREFETCH_DEPTH = 2

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
    ``[batch, seq_len]`` stream and keeps the rows of its data rank
    (``mesh.data_rank`` of ``mesh.data``; all of them without a mesh):
    whole sequences, which its seq group shares."""
    data_path = getattr(args, "data", "")
    if data_path:
        stream = token_file_lm(data_path, args.seed, args.batch,
                               args.seq_len, vocab=args.vocab)
    else:
        stream = synthetic_lm(args.seed, args.batch, args.seq_len,
                              vocab=args.vocab)
    if mesh is None:
        return stream
    if args.batch % mesh.data:
        raise ValueError(f"batch {args.batch} does not split over "
                         f"{mesh.data} data ranks")
    return data_rank_rows(stream, mesh.data_rank, mesh.data)


def device_prefetch(batches, device: torch.device,
                    depth: int = 2) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Host batches (tuples of numpy arrays) -> device tensors, ``depth``
    batches ahead of the consumer (0 = one synchronous copy per batch).
    On CUDA each array is staged in pinned memory and copied with
    ``non_blocking``: the copy is queued on the current stream, behind the
    steps already dispatched, and the host returns at once."""
    if depth < 0:
        raise ValueError(f"device_prefetch depth must be >= 0, got {depth}")
    device = torch.device(device)
    pinned = device.type == "cuda"

    def place(arrs):
        out = []
        for arr in arrs:
            host = torch.from_numpy(np.ascontiguousarray(arr))
            if pinned:
                host = host.pin_memory()
            out.append(host.to(device, non_blocking=pinned))
        return tuple(out)

    it = iter(batches)
    if depth == 0:
        for arrs in it:
            yield place(arrs)
        return
    buf: deque = deque()
    exhausted = False
    while True:
        while not exhausted and len(buf) < depth:
            try:
                buf.append(place(next(it)))
            except StopIteration:
                exhausted = True
        if not buf:
            return
        yield buf.popleft()


def _env_int(var: str, default: int) -> int:
    try:
        return int(os.environ.get(var) or default)
    except ValueError:
        log.warning("ignoring malformed %s=%r", var, os.environ.get(var))
        return default


def add_prefetch_argument(parser) -> None:
    """``--prefetch-depth`` (default ``$TPUJOB_DATAPLANE_PREFETCH_DEPTH``,
    0 = auto), shared by the training payloads."""
    parser.add_argument(
        "--prefetch-depth", type=int, default=_env_int(ENV_PREFETCH_DEPTH, 0),
        help="batches in flight to the device ahead of the step (0 = auto, "
             f"the default depth {DEFAULT_PREFETCH_DEPTH})")


def prefetch_depth(args) -> int:
    """The prefetch depth: > 0 as given, 0 = auto (the default depth)."""
    depth = int(args.prefetch_depth)
    if depth < 0:
        raise ValueError(f"prefetch depth must be >= 0 (0 = auto), "
                         f"got {depth}")
    return depth or DEFAULT_PREFETCH_DEPTH
