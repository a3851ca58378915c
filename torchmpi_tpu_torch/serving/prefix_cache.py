"""Radix prefix-sharing KV cache over the paged :class:`.slots.SlotPool`
(the JAX package's ``serving/prefix_cache.py``).

Serving traffic is dominated by shared prefixes — system prompts,
few-shot headers — and a plain slot engine prefills each copy from
scratch.
This module is the paper's resource-cache philosophy (cache every
expensive artifact keyed by what actually distinguishes it) applied to
KV state: the first request to carry a prefix prefills it once, the
cache keeps the resulting k/v as **block-aligned fragments** in a radix
tree keyed by token content, and every later request assembles the
matched fragments into its slot row and runs ``slot_extend`` over only
the unshared suffix.

Correctness rests on two facts the rest of the stack already depends
on:

- **Causality + absolute-position rope**: a prefix's k/v depend only on
  the prefix tokens, so a fragment sliced from one request's prefill is
  bitwise the fragment any other request sharing that prefix would have
  computed.
- **Per-row depth masking**: everything in a slot row beyond the
  assembled depth is invisible to attention, so an assembled row decodes
  bit-identically to a freshly prefilled one — the same argument that
  makes slot reuse and bucketed-prefill padding safe.

Sharing is accounted through the pool's refcounted block ledger: each
tree node owns one ledger block (refcount 1 = cached but idle), every
live slot built from the node pins it for the session's lifetime, and
eviction is LRU strictly over idle **leaves** — never a block a live
slot holds (use-after-free), never an interior node (orphaned children
would claim a prefix whose head is gone).

The tree stores fragments as opaque objects (it never imports torch):
the engine slices and writes them with the ``slot_cache_slice`` /
``slot_cache_write`` primitives, and a fragment's ``nbytes`` is its
size.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .slots import SlotPool


def _frag_nbytes(frag) -> int:
    """Total bytes of a fragment pytree (duck-typed ``.nbytes`` so the
    pure-bookkeeping tests can use numpy or even plain objects)."""
    total = 0
    stack = [frag]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        else:
            total += int(getattr(x, "nbytes", 0) or 0)
    return total


class _Node:
    """One radix-tree edge: ``key`` is this node's block of tokens,
    ``frag`` the k/v fragment those tokens produced, ``bid`` its ledger
    block id."""

    __slots__ = ("key", "frag", "bid", "parent", "children",
                 "last_used", "nbytes")

    def __init__(self, key: Tuple[int, ...], frag, bid: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.frag = frag
        self.bid = bid
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0
        self.nbytes = _frag_nbytes(frag)


class PrefixCache:
    """Block-aligned radix tree of shared prompt-prefix KV fragments.

    ``block_tokens`` is the sharing granularity: prefixes match in whole
    blocks only (token-aligned at block boundaries, longest match wins),
    which keeps fragments fixed-shape — one compiled slice/write per
    layout instead of one per prefix length.  Capacity is the pool's
    ``prefix_blocks`` ledger; the deterministic integer LRU clock makes
    eviction order replayable from a seed, same discipline as the slot
    free-list.
    """

    def __init__(self, pool: SlotPool, *, block_tokens: int = 8):
        if block_tokens < 1:
            raise ValueError(
                f"block_tokens must be >= 1, got {block_tokens}")
        if block_tokens > pool.slot_tokens:
            raise ValueError(
                f"block_tokens ({block_tokens}) cannot exceed "
                f"slot_tokens ({pool.slot_tokens})")
        if pool.prefix_blocks < 1:
            raise ValueError(
                "pool has no prefix block ledger (prefix_blocks == 0)")
        self.pool = pool
        self.block_tokens = int(block_tokens)
        self._root_children: Dict[Tuple[int, ...], _Node] = {}
        self._nodes: List[_Node] = []
        self._clock = 0
        self.stats = {"hits": 0, "misses": 0, "inserted": 0,
                      "evicted": 0, "tokens_saved": 0, "bytes_saved": 0}

    # ----- lookup --------------------------------------------------

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    def match(self, tokens: Sequence[int]) -> List[_Node]:
        """Longest block-aligned cached prefix of ``tokens`` — a chain
        of nodes root-down.  Capped one block short of covering the
        whole prompt so at least one suffix token always remains to
        extend with (the forward needs a query token to sample the
        first output from, exactly as full prefill does).

        Counts one hit (with ``tokens_saved``/``bytes_saved``) or one
        miss per call; does NOT pin — callers that build a row from the
        chain must :meth:`pin` it before any tick in which eviction
        could run.
        """
        B = self.block_tokens
        toks = [int(t) for t in tokens]
        max_blocks = max(0, (len(toks) - 1) // B)
        chain: List[_Node] = []
        children = self._root_children
        for i in range(max_blocks):
            key = tuple(toks[i * B:(i + 1) * B])
            node = children.get(key)
            if node is None:
                break
            chain.append(node)
            children = node.children
        for node in chain:
            self._touch(node)
        if chain:
            self.stats["hits"] += 1
            self.stats["tokens_saved"] += len(chain) * B
            self.stats["bytes_saved"] += sum(n.nbytes for n in chain)
        else:
            self.stats["misses"] += 1
        return chain

    # ----- pinning -------------------------------------------------

    def pin(self, chain: Sequence[_Node]) -> None:
        """Take a live-slot reference on every block in ``chain`` (the
        admission side of copy-on-extend: the session shares the
        fragments read-only; its own writes land in its slot row)."""
        for node in chain:
            self.pool.block_ref(node.bid)

    def release(self, chain: Sequence[_Node]) -> None:
        """Drop the live-slot references (session retirement — EOS,
        budget exhaustion, or a drain)."""
        for node in chain:
            self.pool.block_deref(node.bid)

    # ----- insertion / eviction ------------------------------------

    def _evict_one(self, protect: set) -> bool:
        """Evict the least-recently-used idle leaf.  Idle = ledger
        refcount 1 (the tree's own reference — no live slot);
        leaf = no children (evicting an interior node would leave
        descendants claiming a prefix whose head is gone).  ``protect``
        holds ids of nodes in the chain currently being extended —
        they are this insertion's own parents and must survive it."""
        best = None
        for node in self._nodes:
            if id(node) in protect or node.children:
                continue
            if self.pool.block_refcount(node.bid) != 1:
                continue
            if best is None or node.last_used < best.last_used:
                best = node
        if best is None:
            return False
        if best.parent is None:
            del self._root_children[best.key]
        else:
            del best.parent.children[best.key]
        self._nodes.remove(best)
        self.pool.block_deref(best.bid)  # 1 -> 0: ledger slot freed
        self.stats["evicted"] += 1
        return True

    def insert(self, tokens: Sequence[int], true_len: int,
               make_frag: Callable[[int], Any]
               ) -> Tuple[List[_Node], int, int]:
        """Cache every full block of ``tokens[:true_len]``, reusing
        nodes that already exist and calling ``make_frag(i)`` (the
        engine's fragment slicer — block i covers token positions
        ``[i*B, (i+1)*B)``) only for blocks the tree doesn't hold yet.

        Returns ``(chain, n_new, n_evicted)`` — the full node chain
        covering the prompt's blocks (existing + new; the caller pins
        it), how many were newly inserted, and how many idle leaves
        were evicted to make room.  Fills best-effort: when the ledger
        is exhausted and nothing is evictable the tail blocks simply
        stay uncached.
        """
        B = self.block_tokens
        toks = [int(t) for t in tokens[:true_len]]
        n_blocks = len(toks) // B
        chain: List[_Node] = []
        protect: set = set()
        children = self._root_children
        parent: Optional[_Node] = None
        n_new = n_evicted = 0
        for i in range(n_blocks):
            key = tuple(toks[i * B:(i + 1) * B])
            node = children.get(key)
            if node is None:
                bid = self.pool.block_alloc()
                while bid is None:
                    if not self._evict_one(protect):
                        # Full of held/interior blocks: stop caching
                        # the tail; what's in the chain so far is
                        # still valid and pinnable.
                        return chain, n_new, n_evicted
                    n_evicted += 1
                    bid = self.pool.block_alloc()
                node = _Node(key, make_frag(i), bid, parent)
                children[key] = node
                self._nodes.append(node)
                n_new += 1
                self.stats["inserted"] += 1
            self._touch(node)
            chain.append(node)
            protect.add(id(node))
            parent = node
            children = node.children
        return chain, n_new, n_evicted

    @property
    def n_nodes(self) -> int:
        return len(self._nodes)
