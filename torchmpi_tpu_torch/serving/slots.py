"""Paged KV-cache slot pool (the JAX package's ``serving/slots.py``, bit
for bit): fixed-size slot blocks, allocated per
request, freed on EOS/retirement.

A slot is one row of the replica's pool cache — a fixed block of
``slot_tokens`` KV positions.  Admission allocates a free slot, prefill
overwrites the row, retirement returns it to the free list, and the
per-row causal mask in the decode step makes reuse safe without zeroing
(stale entries beyond a row's filled prefix are ``-inf``'d out of every
attention, so a reused slot decodes bit-identically to a fresh cache —
asserted in tests/test_serving.py).

Memory therefore bounds at ``n_slots x slot_tokens`` cache positions per
replica — the slot pool's whole point: a long straggler pins ONE block,
not the whole batch's ``batch x max_len`` cache.

Dependency-free (no torch): the pool is bookkeeping; the cache arrays live
in the engine.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class SlotPool:
    """Free-list of ``n_slots`` fixed-size KV blocks.

    LIFO reuse (the most recently freed slot is handed out first) keeps
    the hot block resident and the allocation order deterministic — the
    replica-kill chaos runs replay identically from a seed.

    ``prefix_blocks`` > 0 additionally arms the **refcounted block
    ledger** the radix prefix cache (:mod:`.prefix_cache`) accounts its
    shared cache fragments against: ``block_alloc`` hands out at most
    ``prefix_blocks`` live block ids (the cache's capacity), each born
    with refcount 1 (the tree's own reference); ``block_ref`` /
    ``block_deref`` move the count as live slots pin and release a
    shared block, and a deref to exactly zero frees the id.  Going
    below zero — or touching an id the ledger never issued — raises:
    a miscounted shared block is either a leak (capacity silently gone
    forever) or a use-after-free (an evicted fragment a live slot still
    believes in), and both must be loud.
    """

    def __init__(self, n_slots: int, slot_tokens: int,
                 prefix_blocks: int = 0):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if slot_tokens < 1:
            raise ValueError(
                f"slot_tokens must be >= 1, got {slot_tokens}")
        if prefix_blocks < 0:
            raise ValueError(
                f"prefix_blocks must be >= 0, got {prefix_blocks}")
        self.n_slots = int(n_slots)
        self.slot_tokens = int(slot_tokens)
        self._free: List[int] = list(range(n_slots - 1, -1, -1))
        self._in_use: set = set()
        self.prefix_blocks = int(prefix_blocks)
        #: block id -> refcount (1 = only the prefix tree holds it).
        self._block_refs: Dict[int, int] = {}
        #: Monotonic id source: ids are never reissued, so a stale id
        #: held across an eviction FAILS the ledger lookup instead of
        #: silently aliasing a new block (the ABA hazard).
        self._next_block = 0

    def fits(self, total_tokens: int) -> bool:
        """Can a request of ``prompt + max_new`` tokens ever live in one
        slot block?  (Admission-time check — an unservable request must
        be rejected at the door, not wedge a slot forever.)"""
        return 0 < total_tokens <= self.slot_tokens

    def alloc(self) -> Optional[int]:
        """Allocate a slot; None when the pool is exhausted (the request
        stays in the admission queue for the next tick)."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._in_use.add(slot)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._in_use:
            raise ValueError(
                f"slot {slot} is not allocated (double free, or never "
                f"alloc'd from this pool)")
        self._in_use.remove(slot)
        self._free.append(slot)

    @property
    def in_use(self) -> int:
        return len(self._in_use)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def occupancy_pct(self) -> float:
        """Percent of slot blocks in use (JAX's
        ``tm_serving_slot_occupancy_pct`` gauge sample)."""
        return 100.0 * len(self._in_use) / self.n_slots

    # ----- prefix-cache block ledger -------------------------------
    #
    # Refcount protocol (see prefix_cache.py for the tree that drives
    # it): a block is born at refcount 1 — the radix tree's own
    # reference.  Every live slot assembled from the block pins it
    # (+1 on admission, -1 at retirement), so refcount == 1 means
    # "cached but idle" — exactly the eviction-eligible state — and
    # refcount >= 2 means a live row was built from this fragment and
    # eviction would corrupt an in-flight decode.

    def block_alloc(self) -> Optional[int]:
        """Issue a new prefix block id at refcount 1, or None when the
        ledger is at ``prefix_blocks`` capacity (the cache must evict
        an idle block first — or give up and prefill in full)."""
        if len(self._block_refs) >= self.prefix_blocks:
            return None
        bid = self._next_block
        self._next_block += 1
        self._block_refs[bid] = 1
        return bid

    def block_ref(self, bid: int) -> int:
        """Pin ``bid`` (+1); returns the new refcount."""
        if bid not in self._block_refs:
            raise ValueError(f"block {bid} is not live in this ledger")
        self._block_refs[bid] += 1
        return self._block_refs[bid]

    def block_deref(self, bid: int) -> int:
        """Unpin ``bid`` (-1); at zero the id is freed and its capacity
        returns to the pool.  Returns the new refcount (0 = freed)."""
        if bid not in self._block_refs:
            raise ValueError(f"block {bid} is not live in this ledger")
        self._block_refs[bid] -= 1
        n = self._block_refs[bid]
        if n <= 0:
            # == 0: clean release.  < 0 can't happen — the ledger
            # entry is deleted the moment it reaches zero, so a second
            # deref lands in the "not live" raise above.
            del self._block_refs[bid]
        return n

    def block_refcount(self, bid: int) -> int:
        """Current refcount of ``bid`` (0 if not live)."""
        return self._block_refs.get(bid, 0)

    @property
    def blocks_in_use(self) -> int:
        """Live prefix block count (capacity used, any refcount)."""
        return len(self._block_refs)
