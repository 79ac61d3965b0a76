"""The LM data pipeline of the PyTorch payload (the port's own copy of the
LM half of ``tpu_operator/payload/data.py``).

The generators are numpy only and, for one process, byte-identical to the
reference's: the same seed gives the same token batches, so a parity test
can feed both payloads one stream. :func:`device_prefetch` keeps ``depth``
batches in flight to the device: each batch is staged in pinned host
memory and copied with ``non_blocking``, so the copies overlap the
device's work on earlier steps.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, Tuple

import numpy as np
import torch


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


def lm_batches(args) -> Iterator[Tuple[np.ndarray]]:
    """``--data /path/tokens.npy`` selects the memory-mapped token stream,
    else the synthetic recurrence."""
    data_path = getattr(args, "data", "")
    if data_path:
        return token_file_lm(data_path, args.seed, args.batch, args.seq_len,
                             vocab=args.vocab)
    return synthetic_lm(args.seed, args.batch, args.seq_len,
                        vocab=args.vocab)


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
