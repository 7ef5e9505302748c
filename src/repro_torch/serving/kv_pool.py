"""NUMA-aware paged KV-cache pool with refcounted prefix sharing.

ArcLight's §2.3 memory discipline — pre-allocate node-bound pools at
startup, then *bind* rather than *allocate* at runtime — applied to the
serving KV cache.  The physical cache is a fixed pool of fixed-size
**pages** (``page_size`` token slots each, all layers of a page
co-resident on one NUMA node).  At runtime a sequence owns an ordered
list of pages (its *block table*); admission, growth, sharing and
eviction move page *references* around on the host without ever moving
cache bytes on the device (the one exception: copy-on-write, which
emits an explicit page-copy the engine applies).

Placement is planned through :class:`repro_torch.core.memory.MemoryManager`
(``plan_kv_pages``), so KV pages sit in the same per-node accounting as
weights and activations: pages stripe round-robin across node pools and
``MemoryManager.per_node_bytes`` reports the whole model's residency.
On TPU the "node" is a mesh shard; on CPU it is a NUMA node the engine
would ``mbind`` the page's carve-out to.  Under **tensor-parallel
serving** (``KVPoolConfig.n_shards`` > 1, the engine's ``mesh=`` mode)
a page's rows still stripe across nodes, but its *bytes* split across
the mesh shards — each shard holds the page's local kv-head slice in a
per-(node, shard) pool (``kv_page_placement``).  Nothing else here
changes: page ids are global, so refcounts, the prefix map, retention
and CoW plans are shard-agnostic host bookkeeping.

Prefix caching: KV bytes are a pure
function of ``(token values, absolute positions)``, so two requests
whose prompts agree on a page-aligned prefix can point their block
tables at the *same* physical pages.  The pool keeps a **prompt-prefix
hash map** — a chain hash over full token blocks, so a block's key
commits to everything before it — from which admission resolves how
many resident pages a new prompt can reuse (:meth:`match_prefix` /
:meth:`adopt_prefix`).  When the new prompt diverges from the cached
content *mid-page*, the matching head of the divergent page is reused
by **copy-on-write**: a fresh page is allocated, a ``(src, dst)`` copy
is queued in :attr:`pending_copies`, and only the divergent suffix is
recomputed.

Retention (``retain=``, on by default with the prefix cache): a
prefix-indexed page whose refcount drops to 0 is not forgotten — it
moves to a **cached-free LRU** (:attr:`_retained`).  Its bytes stay
resident and its prefix-map entries stay valid, so a repeat prompt hits
the cache even after every sequence that wrote it has finished.
Retained pages still count as allocatable (:meth:`n_free` includes
them): when the true free lists run dry, :meth:`_take_page` evicts the
least-recently-retired page (forgetting its prefix entries) — caching
never costs capacity, only the reuse opportunity of whatever is
evicted.  Sharing a retained page *revives* it (back to refcount 1,
``retention_hits`` stat).

Invariants (property-tested in ``tests/test_serving_paged.py`` and
``tests/test_prefix_chunking.py``):

* **scratch-page rule** — page 0 is never handed out: it is the
  device-side scratch page that idle batch slots and padded prefill
  positions write into;
* **refcount lifecycle** — every page in any live block table has
  refcount >= 1; a page leaves the live set exactly when its refcount
  drops to 0 (to its node free-list, or to the retained LRU when it is
  prefix-indexed); ``release``/``free`` only ever decrement, so a
  shared page outlives any single owner;
* **immutability of shared pages** — a page with refcount > 1 is never
  written: writers go through :meth:`ensure_writable`, which swaps in a
  private copy-on-write page first;
* freed pages return to their node free-list and are reused (LIFO, so
  recently-touched — cache-warm — pages are preferred);
* per-node live-byte accounting never exceeds the planned capacity.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.memory import MemoryManager


@dataclasses.dataclass(frozen=True)
class KVPoolConfig:
    """Static shape of the physical page pool.

    ``n_pages`` includes the reserved scratch page 0; the usable pool is
    ``n_pages - 1`` pages.  ``page_bytes`` covers K and V for all layers
    of one page.
    """

    n_pages: int
    page_size: int
    n_layers: int
    n_kv_heads: int
    head_dim: int
    dtype_bytes: int = 4
    n_nodes: int = 1
    numa: bool = True
    #: tensor-parallel mesh shards the pool is head-sharded over: each
    #: page's bytes live 1/S on every shard (kv heads split S ways), so
    #: planning carves a per-(node, shard) region for every page
    n_shards: int = 1
    #: KV page element format ("fp32" | "int8" — the engine's
    #: ``--kv-dtype``).  "int8" pages hold 1-byte codes plus one f32
    #: scale per (token row, kv head) (``repro_torch.quant.kv_int8``, the
    #: port of the reference's ``repro.quant.kv_int8``), so a token-head costs
    #: head_dim + 4 bytes instead of head_dim * dtype_bytes — the same
    #: pool byte budget holds ~dtype_bytes·D/(D+4) times the pages.  Page *accounting* (page
    #: ids, refcounts, prefix map, CoW, block tables) is byte-agnostic;
    #: only this byte arithmetic and the device buffers change.
    kv_dtype: str = "fp32"

    @property
    def page_bytes(self) -> int:
        if self.kv_dtype == "int8":
            # int8 codes + one f32 scale per (token row, kv head)
            per_row_head = self.head_dim + 4
        elif self.kv_dtype == "fp32":
            per_row_head = self.head_dim * self.dtype_bytes
        else:
            raise ValueError(f"kv_dtype={self.kv_dtype!r}: "
                             "choose 'fp32' or 'int8'")
        return (2 * self.n_layers * self.page_size * self.n_kv_heads
                * per_row_head)

    @property
    def page_shard_bytes(self) -> int:
        """One shard's slice of a page (its local kv-head block)."""
        return self.page_bytes // self.n_shards

    @property
    def max_pages_per_seq(self) -> int:
        return self.n_pages - 1

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Outcome of a prompt-prefix lookup.

    ``pages`` are resident full pages the prompt can share outright;
    ``cow_src``/``cow_len`` describe a mid-page divergence: the first
    ``cow_len`` tokens of the block *after* the shared pages match the
    resident page ``cow_src``, so a copy-on-write clone of it saves
    recomputing those tokens.  ``n_tokens`` is the total cached-token
    count (``len(pages) * page_size + cow_len``) — prefill resumes at
    this offset.
    """

    pages: Tuple[int, ...] = ()
    n_tokens: int = 0
    cow_src: Optional[int] = None
    cow_len: int = 0


_CHAIN_ROOT = 0x9E3779B97F4A7C15   # arbitrary non-zero chain seed


def prefix_chain_key(tokens: Sequence[int], page_size: int, *,
                     max_blocks: Optional[int] = None) -> Optional[int]:
    """Chain hash over the leading *full* ``page_size`` token blocks of
    a prompt — the same ``hash((chain, block))`` scheme
    :class:`PrefixCache` keys pages by, exposed for callers that need
    the *identity* of a shared prefix without a pool: the multi-replica
    router uses it to map shared-system-prompt requests onto the
    replica whose pool already holds those pages (prefix-affinity
    routing, the reference package's ``repro.serving.router``).

    ``max_blocks`` caps how much of the prompt the key commits to (the
    router keys on the first block or two — the system prompt — so
    requests differing only in their user tail still share a key).
    Returns ``None`` when the prompt has no full block: there is no
    shareable page-aligned prefix to be affine to.
    """
    n = len(tokens) // page_size
    if max_blocks is not None:
        n = min(n, max_blocks)
    if n <= 0:
        return None
    h = _CHAIN_ROOT
    for i in range(n):
        h = hash((h, tuple(tokens[i * page_size:(i + 1) * page_size])))
    return h


class PrefixCache:
    """Prompt-prefix hash map: token-block chain hash -> physical page.

    Keys are *chain* hashes — block i's key commits to the contents of
    blocks 0..i — so one flat dict resolves "longest shared prefix" by
    walking the request's blocks in order.  ``_next`` maps a chain
    prefix to *some* resident page that follows it, which is what
    mid-page divergence (copy-on-write) compares against.  Entries are
    content-verified on hit (``_tokens``) so a hash collision can only
    cost a missed reuse, never a wrong one.

    The map points at **resident** pages: live (refcount >= 1) or
    retained (refcount 0, bytes intact, reclaimable).  The pool forgets
    a page's entries when the page's bytes stop being trustworthy —
    immediately at refcount 0 without retention, or at LRU eviction
    with it.
    """

    def __init__(self, page_size: int) -> None:
        self.page_size = page_size
        self._full: Dict[int, int] = {}    # chain hash -> page id
        self._next: Dict[int, int] = {}    # chain prefix -> following page
        self._tokens: Dict[int, Tuple[int, ...]] = {}  # page -> its tokens
        self._keys: Dict[int, List[Tuple[str, int]]] = {}  # page -> entries

    def __len__(self) -> int:
        return len(self._full)

    def register(self, tokens: Sequence[int],
                 pages: Sequence[int]) -> None:
        """Index every *full* token block of a resident prompt."""
        ps = self.page_size
        h = _CHAIN_ROOT
        for i in range(len(tokens) // ps):
            blk = tuple(tokens[i * ps:(i + 1) * ps])
            key = hash((h, blk))
            pid = pages[i]
            if key not in self._full:
                self._full[key] = pid
                self._tokens.setdefault(pid, blk)
                self._keys.setdefault(pid, []).append(("full", key))
            if h not in self._next:
                self._next[h] = pid
                self._tokens.setdefault(pid, blk)
                self._keys.setdefault(pid, []).append(("next", h))
            h = key

    def match(self, tokens: Sequence[int], limit: int) -> PrefixMatch:
        """Longest resident prefix of ``tokens[:limit]``, full pages
        first, then a token-wise compare inside the divergent block."""
        ps = self.page_size
        pages: List[int] = []
        h = _CHAIN_ROOT
        for i in range(limit // ps):
            blk = tuple(tokens[i * ps:(i + 1) * ps])
            key = hash((h, blk))
            pid = self._full.get(key)
            if pid is None or self._tokens.get(pid) != blk:
                break
            pages.append(pid)
            h = key
        matched = len(pages) * ps
        cand = self._next.get(h)
        cow_src, cow_len = None, 0
        if cand is not None and matched < limit:
            cand_toks = self._tokens.get(cand, ())
            tail = tokens[matched:limit]
            for a, b in zip(cand_toks, tail):
                if a != b:
                    break
                cow_len += 1
            if cow_len:
                cow_src = cand
        return PrefixMatch(pages=tuple(pages), n_tokens=matched + cow_len,
                           cow_src=cow_src, cow_len=cow_len)

    def is_indexed(self, pid: int) -> bool:
        """True when the map holds entries pointing at page ``pid`` —
        the retention test: only indexed pages are worth keeping."""
        return pid in self._keys

    def forget(self, pid: int) -> None:
        for kind, key in self._keys.pop(pid, []):
            table = self._full if kind == "full" else self._next
            if table.get(key) == pid:
                del table[key]
        self._tokens.pop(pid, None)


class KVCachePool:
    """Free-list page allocator with refcounted, prefix-shared block
    tables (see module docstring for the invariants)."""

    def __init__(self, cfg: KVPoolConfig,
                 mm: Optional[MemoryManager] = None, *,
                 prefix_cache: bool = True, retain: bool = True) -> None:
        if cfg.n_pages < 2:
            raise ValueError("need at least one usable page besides scratch")
        self.cfg = cfg
        if cfg.n_shards > 1 and cfg.n_kv_heads % cfg.n_shards:
            raise ValueError(
                f"{cfg.n_kv_heads} kv heads do not head-shard over "
                f"{cfg.n_shards} mesh shards")
        self.mm = mm if mm is not None else MemoryManager(
            cfg.n_nodes, numa=cfg.numa)
        self.mm.plan_kv_pages(cfg.n_pages, cfg.page_bytes,
                              n_shards=cfg.n_shards)
        self._free: Dict[int, List[int]] = {}
        for pid in range(cfg.n_pages - 1, 0, -1):   # page 0 stays reserved
            self._free.setdefault(self.mm.kv_page_node(pid), []).append(pid)
        self._pages: Dict[int, List[int]] = {}      # seq uid -> logical order
        self._ref: Dict[int, int] = {}              # page id -> refcount
        self.prefix = PrefixCache(cfg.page_size) if prefix_cache else None
        self.retain = retain and prefix_cache
        #: cached-free LRU: prefix-indexed pages at refcount 0, oldest
        #: retirement first — reclaimed by ``_take_page`` when the free
        #: lists run dry, revived by ``share_pages`` on a prefix hit
        self._retained: "OrderedDict[int, None]" = OrderedDict()
        #: device page copies the engine must apply before the next
        #: forward pass: list of (src page id, dst page id)
        self.pending_copies: List[Tuple[int, int]] = []
        self.stats: Dict[str, int] = {
            "fresh_pages": 0,      # pages handed out from the free lists
            "shared_pages": 0,     # block-table entries served by sharing
            "cow_copies": 0,       # copy-on-write page clones
            "cached_tokens": 0,    # prompt tokens whose prefill was skipped
            "retention_hits": 0,   # refcount-0 pages revived by sharing
            "retained_evictions": 0,   # retained pages reclaimed when dry
        }
        #: optional registry-backed twins of ``stats`` (``bind_registry``)
        self._stat_counters: Dict[str, object] = {}

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    #: stats key -> metric name (docs/observability.md catalogue)
    STAT_METRICS: Dict[str, str] = {
        "fresh_pages": "kv_pool.pages_fresh",
        "shared_pages": "kv_pool.pages_shared",
        "cow_copies": "kv_pool.cow_copies",
        "cached_tokens": "prefix_cache.hit_tokens",
        "retention_hits": "kv_pool.retention_hits",
        "retained_evictions": "kv_pool.retained_evictions",
    }

    def bind_registry(self, registry) -> None:
        """Mirror every ``stats`` increment into ``registry`` counters
        (the legacy ``stats`` ints stay authoritative as thin views —
        benches reset them per run without touching the registry)."""
        self._stat_counters = {
            key: registry.counter(
                name, f"KVCachePool stats[{key!r}] (cumulative)").labels()
            for key, name in self.STAT_METRICS.items()}

    def _stat(self, key: str, n: int = 1) -> None:
        self.stats[key] += n
        c = self._stat_counters.get(key)
        if c is not None:
            c.inc(n)

    def free_pages_by_node(self) -> Dict[int, int]:
        """Truly-free pages per node (retained pages excluded — they
        are reclaimable but their bytes still hold cached prefixes)."""
        return {n: len(v) for n, v in self._free.items()}

    # ------------------------------------------------------------------
    def n_free(self) -> int:
        """Allocatable pages: truly free + retained (reclaimable)."""
        return sum(len(v) for v in self._free.values()) + len(self._retained)

    def n_retained(self) -> int:
        return len(self._retained)

    def n_live(self) -> int:
        return len(self._ref)

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    def can_grow(self, uid: int, n_tokens: int) -> bool:
        need = self.cfg.pages_for(n_tokens) - len(self._pages.get(uid, []))
        return need <= self.n_free()

    def _take_page(self, node_hint: int) -> int:
        """Pop a free page, preferring the hinted node's pool; when the
        free lists are dry, evict the least-recently-retired cached
        page (its prefix entries die with it)."""
        order = sorted(self._free, key=lambda n: (n != node_hint,
                                                  -len(self._free[n]), n))
        for node in order:
            if self._free[node]:
                return self._free[node].pop()
        if self._retained:
            pid, _ = self._retained.popitem(last=False)   # LRU order
            if self.prefix is not None:
                self.prefix.forget(pid)
            self._stat("retained_evictions")
            return pid
        raise RuntimeError("KV pool exhausted")

    # ------------------------------------------------------------------
    def grow(self, uid: int, n_tokens: int, *, node_hint: int = 0) -> bool:
        """Ensure ``uid``'s block table covers ``n_tokens`` token slots.

        Shared (prefix-adopted) pages count toward coverage, so only the
        uncached tail allocates.  Returns False (allocating nothing)
        when the free pool cannot cover the growth — the scheduler then
        preempts somebody.
        """
        pages = self._pages.setdefault(uid, [])
        need = self.cfg.pages_for(n_tokens) - len(pages)
        if need <= 0:
            return True
        if self.cfg.pages_for(n_tokens) > self.cfg.max_pages_per_seq:
            raise ValueError(
                f"sequence of {n_tokens} tokens needs "
                f"{self.cfg.pages_for(n_tokens)} pages; pool only has "
                f"{self.cfg.max_pages_per_seq}")
        if need > self.n_free():
            return False
        for _ in range(need):
            pid = self._take_page(node_hint)
            self._ref[pid] = 1
            self._stat("fresh_pages")
            pages.append(pid)
        return True

    def free(self, uid: int) -> int:
        """Drop all of ``uid``'s page references; returns how many pages
        left the live set (shared pages survive until their last
        reference is released).  Refcount-0 pages that are prefix-
        indexed retire to the retained LRU instead of the free list, so
        repeat prompts can still hit them (``retain=``)."""
        pages = self._pages.pop(uid, [])
        freed = 0
        for pid in pages:       # stack top = last-written (warmest) page
            if pid == 0:        # window-recycled entry (release_below)
                continue
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                del self._ref[pid]
                freed += 1
                if (self.retain and self.prefix is not None
                        and self.prefix.is_indexed(pid)):
                    self._retained[pid] = None      # most recent at end
                    continue
                if self.prefix is not None:
                    self.prefix.forget(pid)
                self._free[self.mm.kv_page_node(pid)].append(pid)
        if freed and self.pending_copies:
            # a queued clone whose target died (admission rollback,
            # same-step preemption) must not clobber the page's next owner
            self.pending_copies = [(s, d) for s, d in self.pending_copies
                                   if d in self._ref]
        return freed

    #: protocol alias — ``share_pages`` attaches references,
    #: ``release`` drops them
    release = free

    def block_table(self, uid: int) -> List[int]:
        return list(self._pages.get(uid, []))

    # ------------------------------------------------------------------
    # prefix sharing protocol
    # ------------------------------------------------------------------
    def share_pages(self, uid: int, pages: Sequence[int]) -> None:
        """Append references to resident ``pages`` onto ``uid``'s block
        table (refcount + 1 each).  The pages become immutable for every
        holder until refcounts fall back to 1 (`ensure_writable`).  A
        *retained* page (refcount 0, still indexed) is revived: it
        leaves the cached-free LRU and comes back at refcount 1 — the
        cross-request prefix hit retention exists for."""
        table = self._pages.setdefault(uid, [])
        for pid in pages:
            if pid in self._ref:
                self._ref[pid] += 1
            elif pid != 0 and pid in self._retained:
                del self._retained[pid]
                self._ref[pid] = 1
                self._stat("retention_hits")
            else:
                raise ValueError(f"page {pid} is not live (cannot share)")
            table.append(pid)
            self._stat("shared_pages")

    def match_prefix(self, tokens: Sequence[int]) -> PrefixMatch:
        """Longest reusable resident prefix of a prompt.

        Capped at ``len(tokens) - 1``: at least one prompt token is
        always left to prefill, so (a) there are logits to sample the
        first output token from and (b) the page receiving the next
        write is never a shared one.
        """
        if self.prefix is None or len(tokens) < 2:
            return PrefixMatch()
        return self.prefix.match(tokens, len(tokens) - 1)

    def adopt_prefix(self, uid: int, match: PrefixMatch, *,
                     node_hint: int = 0) -> bool:
        """Attach a :meth:`match_prefix` result to a fresh sequence:
        share the full pages and, on mid-page divergence, allocate the
        copy-on-write clone (queueing its device copy).  Returns False —
        leaving ``uid`` untouched — when the clone cannot be allocated.
        """
        if self._pages.get(uid):
            raise ValueError(f"uid {uid} already holds pages")
        if match.cow_src is not None and self.n_free() == 0:
            return False
        if match.pages:
            self.share_pages(uid, match.pages)
        if match.cow_src is not None:
            dst = self._take_page(node_hint)
            self._ref[dst] = 1
            self._stat("fresh_pages")
            self._stat("cow_copies")
            # a divergence inside the FIRST block matches no full page,
            # so the clone may be the table's very first entry
            self._pages.setdefault(uid, []).append(dst)
            self.pending_copies.append((match.cow_src, dst))
        self._stat("cached_tokens", match.n_tokens)
        return True

    def register_prefix(self, uid: int, tokens: Sequence[int]) -> None:
        """Index ``uid``'s now-resident prompt pages for future reuse
        (call once the prefill that filled them has run)."""
        if self.prefix is not None:
            self.prefix.register(tokens, self._pages.get(uid, []))

    def ensure_writable(self, uid: int, pos: int, *,
                        node_hint: int = 0) -> bool:
        """Copy-on-write guard: make the page holding token slot ``pos``
        private to ``uid`` before it is written.  No-op for refcount-1
        pages; for shared pages, swaps in a fresh clone and queues the
        device copy.  Returns False when the pool has no page for the
        clone (caller preempts, exactly like a failed ``grow``)."""
        table = self._pages.get(uid, [])
        li = pos // self.cfg.page_size
        if li >= len(table):
            raise ValueError(f"uid {uid} pos {pos} beyond its block table")
        pid = table[li]
        if self._ref[pid] == 1:
            return True
        if self.n_free() == 0:
            return False
        dst = self._take_page(node_hint)
        self._ref[dst] = 1
        self._stat("fresh_pages")
        self._stat("cow_copies")
        self._ref[pid] -= 1
        table[li] = dst
        self.pending_copies.append((pid, dst))
        return True

    def truncate_to(self, uid: int, n_tokens: int) -> int:
        """Speculative-grant rollback: shrink ``uid``'s block table to
        the pages covering ``n_tokens`` token slots, releasing every
        trailing over-allocation.

        The scheduler grows a speculating sequence's table for the
        *worst-case* ``k`` draft tokens before the verify step; when the
        model rejects part of the draft the tail pages were granted for
        positions that will now never be written this round — this
        returns them.  Refcount-aware exactly like :meth:`free`: each
        dropped entry is one reference, a page only leaves the live set
        at refcount 0, and a prefix-indexed page retires to the
        retention LRU (bytes intact) rather than the free list.
        Returns the number of references dropped (0 when the table
        already fits — the all-accepted fast path).
        """
        table = self._pages.get(uid, [])
        keep = self.cfg.pages_for(n_tokens)
        dropped = 0
        while len(table) > keep:
            pid = table.pop()
            if pid == 0:            # window-recycled scratch entry
                continue
            dropped += 1
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                del self._ref[pid]
                if (self.retain and self.prefix is not None
                        and self.prefix.is_indexed(pid)):
                    self._retained[pid] = None
                    continue
                if self.prefix is not None:
                    self.prefix.forget(pid)
                self._free[self.mm.kv_page_node(pid)].append(pid)
        if dropped and self.pending_copies:
            # same rule as free(): a queued clone whose target just left
            # the live set must not clobber the page's next owner
            self.pending_copies = [(s, d) for s, d in self.pending_copies
                                   if d in self._ref]
        return dropped

    def release_below(self, uid: int, pos: int) -> int:
        """Sliding-window page recycling: drop ``uid``'s references to
        every page that is **fully** below token position ``pos`` (all
        ``page_size`` slots < pos), i.e. pages a window of ``pos``
        onward can never attend over again.

        The recycled block-table entries are rewritten to the scratch
        page 0 — the table keeps its logical length, so position ->
        page arithmetic for the still-resident tail is untouched; the
        out-of-window positions resolve to scratch, which window
        masking already excludes.  Refcount-aware exactly like
        :meth:`free`: a shared page just loses one reference, and a
        prefix-indexed page whose refcount hits 0 retires to the
        retention LRU (bytes intact for future prefix hits) instead of
        the free list.  Returns the number of references dropped.
        """
        table = self._pages.get(uid, [])
        full_below = min(pos // self.cfg.page_size, len(table))
        dropped = 0
        for li in range(full_below):
            pid = table[li]
            if pid == 0:                    # already recycled
                continue
            table[li] = 0
            dropped += 1
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                del self._ref[pid]
                if (self.retain and self.prefix is not None
                        and self.prefix.is_indexed(pid)):
                    self._retained[pid] = None
                    continue
                if self.prefix is not None:
                    self.prefix.forget(pid)
                self._free[self.mm.kv_page_node(pid)].append(pid)
        if dropped and self.pending_copies:
            # same rule as free(): a queued clone whose target just left
            # the live set must not clobber the page's next owner
            self.pending_copies = [(s, d) for s, d in self.pending_copies
                                   if d in self._ref]
        return dropped

    def drain_copies(self) -> List[Tuple[int, int]]:
        """Hand the queued (src, dst) page copies to the engine."""
        out, self.pending_copies = self.pending_copies, []
        return out

    def copy_row_plan(self, copies: Sequence[Tuple[int, int]], *,
                      pad_to_pages: Optional[int] = None,
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Expand drained page copies into flat (src_rows, dst_rows)
        index vectors for ONE per-layer pool buffer.

        The device cache holds each layer's pool as an independent
        ``(n_pages * page_size, H, D)`` buffer (the scan-escape layout),
        so a page copy is the same row-index gather+scatter on every
        layer's buffer — one plan serves all layers.  ``pad_to_pages``
        pads the plan with scratch-page self-copies (row ``0 -> 0`` is a
        no-op write into the reserved scratch page) so the engine's
        compiled copier sees bucketed shapes and compiles a handful of
        times, not once per copy count.
        """
        ps = self.cfg.page_size
        n = pad_to_pages if pad_to_pages is not None else len(copies)
        if n < len(copies):
            raise ValueError(f"pad_to_pages={n} < {len(copies)} copies")
        src = np.zeros((n * ps,), np.int32)
        dst = np.zeros((n * ps,), np.int32)
        for i, (s, d) in enumerate(copies):
            src[i * ps:(i + 1) * ps] = np.arange(s * ps, (s + 1) * ps)
            dst[i * ps:(i + 1) * ps] = np.arange(d * ps, (d + 1) * ps)
        return src, dst

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    def live_bytes_per_node(self) -> Dict[int, int]:
        out = {n: 0 for n in self._free}
        for pid in self._ref:
            out[self.mm.kv_page_node(pid)] += self.cfg.page_bytes
        return out

    def capacity_bytes_per_node(self) -> Dict[int, int]:
        """Planned (pre-allocated) KV bytes per node, from the planner's
        pool peaks — what the node's carve-out actually reserves.  Under
        TP this sums the node's per-shard pools (a page's bytes live 1/S
        on each shard)."""
        out: Dict[int, int] = {}
        for p in self.mm.kv_pools:
            out[p.node_id or 0] = out.get(p.node_id or 0, 0) + p.peak
        return out

    def capacity_bytes_per_shard(self) -> Dict[int, int]:
        """Planned KV bytes per mesh shard (``{0: total}`` without TP):
        every shard reserves its head slice of every node's pages."""
        out: Dict[int, int] = {}
        for p in self.mm.kv_pools:
            sid = p.shard_id or 0
            out[sid] = out.get(sid, 0) + p.peak
        return out
