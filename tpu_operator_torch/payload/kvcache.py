"""Block-paged KV cache + incremental decode engine for the serve path
(counterpart of ``tpu_operator/payload/kvcache.py``).

- **Paged cache.** K/V of every request live in fixed-size pages of one
  device pool per tensor (``[layers, pages + 1, page_size, kv_heads,
  head_dim]``, bf16). The pools live on the device and are updated IN
  PLACE (index writes into the pool tensors), where the reference returns
  new pools from each jitted call. A request owns
  ``ceil((prompt + budget) / page_size)`` pages from admission to
  release. Per-slot page tables, lengths and last tokens are host numpy
  arrays, shipped to the device each step.
- **Prefill = the batched causal forward** over the padded prompt on the
  flash forward kernel; the first generated token is the argmax at
  ``length - 1``, and the prompt's K/V are scattered through the slot's
  page table (the padded tail included: it lands in owned-but-not-yet-
  valid slots or the trash page and is masked until overwritten).
- **Decode = one token per slot per step.** The step embeds each slot's
  last token at position ``min(length, max_seq - 1)``, writes its K/V
  through the page table (inactive slots write the trash page), gathers
  the slot's page span with a plain torch index and attends on
  ``lengths + 1`` with the flash decode kernel.

Masking discipline: every cache position >= a slot's length is never read
by the decode kernel, so stale pages and the padded tail contribute
nothing, and a paged gather is bit-equal to a dense cache. Invalid writes
go to a sacrificial trash page (index ``num_pages``) that no table reads
as valid.

Threading: the engine belongs to the serve loop's single decode thread;
the host tables and the allocator need no lock. The model is an argument
to every call (``params`` in the reference's signatures).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.payload import flash_attention as fa

DEFAULT_PAGE_SIZE = 16


class PageAllocator:
    """Free-list page allocator with strict invariants: a page is either
    free or held, double-free and foreign-free raise, and allocation is
    all-or-nothing (a request that cannot get every page it needs gets
    none, so admission never deadlocks holding a partial set)."""

    def __init__(self, num_pages: int):
        if num_pages <= 0:
            raise ValueError(f"num_pages must be positive, got {num_pages}")
        self.num_pages = int(num_pages)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._held: set = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def held_pages(self) -> int:
        return len(self._held)

    def utilization(self) -> float:
        return len(self._held) / self.num_pages

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages, or None when the pool cannot satisfy all of them
        (the caller leaves the request queued: backpressure, not error)."""
        if n <= 0:
            raise ValueError(f"alloc needs a positive page count, got {n}")
        if len(self._free) < n:
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._held.update(pages)
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._held:
                raise ValueError(
                    f"page {p} is not held (double free or foreign page)")
            self._held.discard(p)
            self._free.append(p)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The decode model's shape (``TransformerLM`` constructor args)."""

    vocab: int
    dim: int
    heads: int
    layers: int
    max_seq: int
    kv_heads: int = 0

    @property
    def grouped_kv_heads(self) -> int:
        return self.kv_heads or self.heads

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


class DecodeEngine:
    """Paged-cache incremental decode over ``slots`` concurrent requests.

    Host side: page allocator + per-slot page tables / lengths / last
    tokens (numpy). Device side: the two page pools. The model is passed
    per call; the engine never holds weights. ``prefills`` and
    ``decode_steps`` count the forwards run (each runs one attention
    kernel launch per layer).
    """

    def __init__(self, spec: ModelSpec, *, slots: int,
                 prompt_pad: int, max_new: int,
                 page_size: int = DEFAULT_PAGE_SIZE, num_pages: int = 0,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        if slots <= 0:
            raise ValueError(f"slots must be positive, got {slots}")
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.spec = spec
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.prompt_pad = int(prompt_pad)
        self.max_context = int(prompt_pad + max_new)
        if self.max_context > spec.max_seq:
            raise ValueError(
                f"max context {self.max_context} (prompt {prompt_pad} + "
                f"{max_new} new) exceeds the model's max_seq {spec.max_seq}")
        self.pages_per_slot = -(-self.max_context // self.page_size)
        self.num_pages = int(num_pages) or self.slots * self.pages_per_slot
        self.capacity_tokens = self.pages_per_slot * self.page_size
        self._trash = self.num_pages  # sacrificial page for invalid writes
        shape = (spec.layers, self.num_pages + 1, self.page_size,
                 spec.grouped_kv_heads, spec.head_dim)
        self._k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self._v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.allocator = PageAllocator(self.num_pages)
        self._tables = np.full((self.slots, self.pages_per_slot),
                               self._trash, np.int32)
        self._lengths = np.zeros(self.slots, np.int32)
        self._last = np.zeros(self.slots, np.int32)
        self._capacity = np.zeros(self.slots, np.int32)
        self._owned: List[Optional[List[int]]] = [None] * self.slots
        self.prefills = 0
        self.decode_steps = 0

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(
            self.device, non_blocking=True)

    # -- device compute ----------------------------------------------------------

    @torch.inference_mode()
    def _prefill(self, model, tokens: np.ndarray, length: int,
                 table: np.ndarray) -> int:
        """One request's admission forward: causal attention over the
        padded prompt, first-token argmax at ``length - 1``, prompt K/V
        scattered through the slot's page table."""
        collected = []

        def attend_for_layer(_i):
            def attend(q, k, v):
                collected.append((k, v))
                return fa.flash_attention(q, k, v, causal=True)
            return attend

        dev = self.device
        positions = torch.arange(self.prompt_pad, device=dev)[None, :]
        logits = model(self._to_device(tokens), positions, attend_for_layer)
        nxt = torch.argmax(logits[0, length - 1].float())
        pos = np.arange(self.prompt_pad)
        page_ids = self._to_device(table[pos // self.page_size].astype(
            np.int64))
        offs = self._to_device((pos % self.page_size).astype(np.int64))
        for i, (k, v) in enumerate(collected):
            self._k_pages[i, page_ids, offs] = k[0]
            self._v_pages[i, page_ids, offs] = v[0]
        self.prefills += 1
        return int(nxt)

    @torch.inference_mode()
    def _step(self, model, active: np.ndarray) -> np.ndarray:
        """One decode iteration over every slot: embed each slot's last
        token at its current position, write its K/V through the page
        table (inactive slots write the trash page), and attend against
        the gathered span with the length-masked decode kernel."""
        s = self.spec
        kvh, hd = s.grouped_kv_heads, s.head_dim
        lengths = self._lengths
        rows = np.arange(self.slots)
        col = np.minimum(lengths // self.page_size, self.pages_per_slot - 1)
        page_sel = np.where(active, self._tables[rows, col], self._trash)
        tokens = self._to_device(self._last.astype(np.int64))[:, None]
        positions = self._to_device(np.minimum(
            lengths, s.max_seq - 1).astype(np.int64))[:, None]
        page_sel = self._to_device(page_sel.astype(np.int64))
        offs = self._to_device((lengths % self.page_size).astype(np.int64))
        tables = self._to_device(self._tables.astype(np.int64))
        attend_lengths = self._to_device((lengths + 1).astype(np.int32))

        def attend_for_layer(i):
            def attend(q, k, v):
                self._k_pages[i, page_sel, offs] = k[:, 0]
                self._v_pages[i, page_sel, offs] = v[:, 0]
                kd = self._k_pages[i][tables].reshape(
                    self.slots, self.capacity_tokens, kvh, hd)
                vd = self._v_pages[i][tables].reshape(
                    self.slots, self.capacity_tokens, kvh, hd)
                return fa.flash_decode(q, kd, vd, attend_lengths)
            return attend

        logits = model(tokens, positions, attend_for_layer)
        nxt = torch.argmax(logits[:, 0].float(), dim=-1)
        self.decode_steps += 1
        return nxt.to(torch.int32).cpu().numpy()

    # -- host-side slot management ---------------------------------------------

    def pages_needed(self, prompt_len: int, new_tokens: int) -> int:
        return -(-(prompt_len + new_tokens) // self.page_size)

    def can_admit(self, prompt_len: int, new_tokens: int) -> bool:
        return (self.allocator.free_pages
                >= self.pages_needed(prompt_len, new_tokens))

    def admit(self, slot: int, prompt, new_tokens: int,
              params) -> Optional[int]:
        """Admit a request into ``slot`` (``params`` is the model): allocate
        its pages, prefill, and return the FIRST generated token (it counts
        against the request's budget). None = page pool exhausted; the
        request stays queued."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self._owned[slot] is not None:
            raise ValueError(f"slot {slot} is already occupied")
        if new_tokens <= 0:
            raise ValueError(f"new_tokens must be positive, got {new_tokens}")
        if len(prompt) == 0 or len(prompt) > self.prompt_pad:
            raise ValueError(
                f"prompt length {len(prompt)} not in [1, {self.prompt_pad}]")
        if len(prompt) + new_tokens > self.max_context:
            raise ValueError(
                f"prompt {len(prompt)} + {new_tokens} new tokens exceeds "
                f"max context {self.max_context}")
        pages = self.allocator.alloc(
            self.pages_needed(len(prompt), new_tokens))
        if pages is None:
            return None
        table = np.full(self.pages_per_slot, self._trash, np.int32)
        table[:len(pages)] = pages
        padded = np.zeros((1, self.prompt_pad), np.int64)
        padded[0, :len(prompt)] = prompt
        nxt = self._prefill(params, padded, len(prompt), table)
        self._tables[slot] = table
        self._lengths[slot] = len(prompt)
        self._last[slot] = nxt
        self._capacity[slot] = len(prompt) + new_tokens
        self._owned[slot] = pages
        return nxt

    def step(self, params, active) -> np.ndarray:
        """One decode iteration; ``active`` is a bool [slots] mask. Returns
        the int32 [slots] next tokens (garbage at inactive slots). Active
        slots advance one position: their previous token's K/V is written
        before it attends, so the new token sees its own key."""
        active = np.asarray(active, bool)
        for slot in np.nonzero(active)[0]:
            if self._owned[slot] is None:
                raise ValueError(f"slot {slot} is active but unoccupied")
            # A step advances the slot to length + 1; the prefill's first
            # token already counted, so a slot whose next token would
            # land past prompt + budget is already over budget.
            if self._lengths[slot] + 1 >= self._capacity[slot]:
                raise ValueError(
                    f"slot {slot} at capacity {self._capacity[slot]}")
        out = self._step(params, active)
        self._lengths[active] += 1
        self._last[active] = out[active]
        return out

    def release(self, slot: int) -> None:
        """Free the slot's pages back to the pool the moment its request
        completes."""
        pages = self._owned[slot]
        if pages is None:
            raise ValueError(f"slot {slot} is not occupied")
        self.allocator.free(pages)
        self._owned[slot] = None
        self._tables[slot] = self._trash
        self._lengths[slot] = 0
        self._capacity[slot] = 0

    def utilization(self) -> float:
        """Held fraction of the page pool (``kvCacheUtilization``)."""
        return self.allocator.utilization()

    def slot_pages(self, slot: int) -> Optional[List[int]]:
        pages = self._owned[slot]
        return None if pages is None else list(pages)
