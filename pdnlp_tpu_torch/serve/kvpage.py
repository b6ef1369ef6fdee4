"""Paged KV memory: page allocator + refcounted cross-request prefix index.

The slot cache charged every stream a full ``max_len`` stripe and
stored two identical system prompts twice.  This module is the memory
half of the paged rebase (the math half is ``models.decoder``'s
``paged_*`` programs; the serving half is ``serve.decode``'s
``PagedDecodeEngine``):

- **pages**: K/V storage is ``[L, n_pages, page_sz, N, D]``; a stream
  holds pages for the positions it actually uses (``ceil((prompt +
  max_new) / page_sz)``, reserved IN FULL at claim time — no mid-decode
  page faults, no preemption machinery, and the capacity math stays
  deterministic), mapped through a per-stream page table the decode step
  gathers through.
- **:class:`PageAllocator`**: the free-list + refcount ledger.  Every
  page has one refcount; a stream's claim increments it, completion/kill
  decrements it, and a page returns to the free list exactly when its
  count reaches zero.  Per-owner accounting makes :meth:`leak_check` a
  real audit (the chaos tests and the bench storm call it after drain),
  and exhaustion is a LOUD :class:`KVPagesExhausted` with the page math
  — never an OOM three layers deep.
- **:class:`PrefixIndex`**: page-granularity prefix sharing.  Every FULL
  page of a prefilled prompt registers under the exact token tuple it
  covers (token-tuple keys, so hash collisions cannot alias two
  prompts), and the whole prompt registers as a FULL entry carrying the
  first generated token.  A later identical prompt is a **full hit**:
  map the pages at refcount+1, emit the stored first token, skip prefill
  entirely.  A shared-prefix prompt is a **partial hit**: map the
  matching full pages and run only the divergent suffix
  (``decoder.paged_chunk_step``).  Copy-on-write: a full hit whose last
  page is partial copies THAT page before the stream writes into it
  (``decoder.copy_pages``); full pages are immutable once written, so
  they share without copying.
- **eviction**: the index holds its own reference on every registered
  page, so a "cached" prompt's pages survive the stream that computed
  them — that IS the prefix cache.  When an allocation falls short the
  allocator asks the index (its ``reclaimer``) to drop least-recently-
  used entries until enough pages fall free; entries whose pages live
  streams still hold can be dropped too (they just stop being
  shareable).  Evictions are counted and surfaced, never silent.

``snapshot()`` blocks ride ``DecodeEngine.kv_snapshot`` ->
``router.snapshot()``/``control_snapshot()`` -> the Prometheus exporter,
so page occupancy, free-list depth, prefix-hit rate and copy-on-write
counts are one scrape away.
"""
from __future__ import annotations

import threading
from collections import Counter, OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from pdnlp_tpu_torch.obs.memory import KVBudgetExceeded

#: owner key for references the prefix index itself holds
INDEX_OWNER = "__prefix_index__"

#: suffix marking a stream's DRAFT-side page references (speculative
#: decoding).  Two-owner custody: on the drafter engine, pages wholly
#: beyond the committed length are held by ``draft_owner(owner)`` while
#: the drafter writes tentative K/V into them; each verify round
#: ``transfer``\ s boundary-crossed pages back to the stream owner
#: (commit), and a rejection simply leaves them under the draft owner to
#: be overwritten in place next round.  ``detach`` releases both owners,
#: so drained-allocator audits (and leaklint L1, which recognises
#: ``transfer`` as a releaser) stay clean.
DRAFT_SUFFIX = "#draft"


def draft_owner(owner: str) -> str:
    """Owner key for a stream's draft-side (uncommitted) page refs."""
    return owner + DRAFT_SUFFIX


#: suffix marking pages staged for a cross-engine KV handoff
#: (disaggregated prefill -> decode).  The prefill engine moves a
#: finished stream's pages from the stream owner to
#: ``handoff_owner(owner)`` the moment the payload is exported; from
#: that point the stream no longer "lives" on the prefill engine (its
#: slot and table row are reusable) but the pages stay pinned until the
#: decode side acknowledges the import — then the staged owner is
#: released in one sweep.  A dispatch failure releases the SAME staged
#: owner, so there is exactly one discharge point per outcome and
#: ``leak_check`` reconciles to zero on both allocators.
HANDOFF_SUFFIX = "#handoff"


def handoff_owner(owner: str) -> str:
    """Owner key for a stream's staged (in-flight handoff) page refs."""
    return owner + HANDOFF_SUFFIX


def stage_handoff(allocator: "PageAllocator", pages: Sequence[int],
                  from_owner: str) -> str:
    """Re-ledger ``from_owner``'s pages onto its handoff staging owner
    and return that owner key.  This is the custody acquire of a KV
    handoff: the caller now OWES a ``release_owner`` (success ack or
    dispatch failure) on the returned key — leaklint L1 tracks the
    obligation (``kv-pages`` spec, ``stage_handoff`` in ``funcs``), so a
    path that exports a payload and forgets the staged pages is a lint
    finding, not a slow leak."""
    staged = handoff_owner(from_owner)
    allocator.transfer(pages, from_owner, staged)
    return staged


class KVPagesExhausted(KVBudgetExceeded):
    """A page allocation could not be satisfied even after index
    eviction — the paged engine's loud refusal, in page units."""


def pages_needed(positions: int, page_sz: int) -> int:
    """Logical pages backing ``positions`` KV positions (ceil)."""
    return -(-int(positions) // int(page_sz))


class PageAllocator:
    """Free-list page allocator with refcounts and per-owner accounting.

    Thread-safe: the decode worker allocates/releases while snapshot
    threads read.  ``reclaimer`` (installed by the engine) is called with
    the shortfall when :meth:`alloc` comes up short — the prefix index's
    LRU eviction hook — and the allocation retries once before raising
    :class:`KVPagesExhausted`."""

    def __init__(self, n_pages: int, page_sz: int, page_bytes: int = 0):
        self.n_pages = int(n_pages)
        self.page_sz = int(page_sz)
        self.page_bytes = int(page_bytes)
        self._free: deque = deque(range(self.n_pages))
        self._ref = [0] * self.n_pages
        self._owned: Dict[str, Counter] = {}
        self._lock = threading.Lock()
        self.reclaimer: Optional[Callable[[int], int]] = None
        # counters (ints under the lock; snapshot reads them JSON-ready)
        self.cow_copies = 0
        self.evictions = 0
        self.alloc_failures = 0

    # ------------------------------------------------------------- internal
    def _incref_locked(self, pages: Sequence[int], owner: str) -> None:
        owned = self._owned.setdefault(owner, Counter())
        for p in pages:
            self._ref[p] += 1
            owned[p] += 1

    def _decref_locked(self, pages: Sequence[int], owner: str) -> int:
        freed = 0
        owned = self._owned.get(owner)
        for p in pages:
            if owned is None or owned[p] <= 0:
                raise AssertionError(
                    f"decref of page {p} not held by owner {owner!r}")
            owned[p] -= 1
            if owned[p] == 0:
                del owned[p]
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                freed += 1
        if owned is not None and not owned:
            del self._owned[owner]
        return freed

    # -------------------------------------------------------------- surface
    def alloc(self, n: int, owner: str) -> List[int]:
        """Claim ``n`` fresh pages for ``owner`` (refcount 1 each).  When
        the free list is short the reclaimer (prefix-index eviction) runs
        once; still short -> :class:`KVPagesExhausted` with the math."""
        n = int(n)
        if n == 0:
            return []
        with self._lock:
            short = n - len(self._free)
        if short > 0 and self.reclaimer is not None:
            self.reclaimer(short)
        with self._lock:
            if n > len(self._free):
                self.alloc_failures += 1
                raise KVPagesExhausted(
                    f"need {n} KV pages but only {len(self._free)} of "
                    f"{self.n_pages} are free "
                    f"({self.page_bytes * n / 2**20:.2f} MB requested "
                    "under --kv_hbm_mb) — streams will retry as pages "
                    "drain, or raise the budget")
            pages = [self._free.popleft() for _ in range(n)]
            self._incref_locked(pages, owner)
            # alloc hands out refcount-1 pages; _incref pushed 0 -> 1
            return pages

    def share(self, pages: Sequence[int], owner: str) -> None:
        """Add ``owner``'s reference to already-live pages (prefix hit:
        a new stream maps shared pages at refcount+1)."""
        with self._lock:
            for p in pages:
                if self._ref[p] <= 0:
                    raise AssertionError(
                        f"share of free page {p} (refcount 0)")
            self._incref_locked(pages, owner)

    def release(self, pages: Sequence[int], owner: str) -> int:
        """Drop ``owner``'s reference on ``pages``; returns how many fell
        free (refcount reached zero -> back on the free list)."""
        with self._lock:
            return self._decref_locked(pages, owner)

    def release_if_idle(self, pages: Sequence[int],
                        owner: str) -> Optional[int]:
        """Drop one ``owner`` reference per page — but only when at
        least one of ``pages`` is held by ``owner`` ALONE (its whole
        refcount is ``owner``'s): releasing then makes progress toward
        freeing.  Returns pages freed, or ``None`` (nothing released)
        when every page is also mapped by someone else.  The prefix
        index's eviction uses this to skip entries whose pages are all
        still mapped by live streams — dropping those frees nothing and
        only destroys shareability.  Atomic under the allocator lock, so
        a concurrent stream release can't slip between the check and the
        decref."""
        with self._lock:
            owned = self._owned.get(owner)
            if owned is None:
                return None
            if not any(owned.get(p, 0) > 0
                       and self._ref[p] == owned.get(p, 0)
                       for p in pages):
                return None
            return self._decref_locked(list(pages), owner)

    def release_owner(self, owner: str) -> int:
        """Drop EVERY reference ``owner`` holds (stream completion/kill
        path — also the stop()-time sweep)."""
        with self._lock:
            owned = self._owned.get(owner)
            if not owned:
                return 0
            pages = [p for p, c in owned.items() for _ in range(c)]
            return self._decref_locked(pages, owner)

    def transfer(self, pages: Sequence[int], from_owner: str,
                 to_owner: str) -> None:
        """Re-ledger one ``from_owner`` reference per page (with
        multiplicity) onto ``to_owner``, atomically.  Total refcounts
        never move, so no page can transit the free list mid-handoff —
        the blip a ``share``-then-``release`` pair would open if the
        source dropped to refcount 0 between the calls.  This is the
        sanctioned ownership-handoff idiom (the lifecycle lint's L1
        recognizes it as a release on ``from_owner``'s side).  The
        whole batch is validated before any page moves: raises
        :class:`AssertionError` (and changes nothing) when
        ``from_owner`` does not hold every requested page."""
        with self._lock:
            if from_owner == to_owner:
                return
            need = Counter(int(p) for p in pages)
            if not need:
                return
            owned = self._owned.get(from_owner)
            for p, c in need.items():
                held = owned.get(p, 0) if owned else 0
                if held < c:
                    raise AssertionError(
                        f"transfer of page {p} x{c} not held by owner "
                        f"{from_owner!r} (holds {held})")
            dst = self._owned.setdefault(to_owner, Counter())
            for p, c in need.items():
                owned[p] -= c
                if owned[p] == 0:
                    del owned[p]
                dst[p] += c
            if not owned:
                del self._owned[from_owner]

    # ------------------------------------------------------------- metering
    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self) -> int:
        with self._lock:
            return self.n_pages - len(self._free)

    def owners(self) -> List[str]:
        with self._lock:
            return list(self._owned)

    def count_cow(self, n: int = 1) -> None:
        with self._lock:
            self.cow_copies += int(n)

    def count_evictions(self, n: int = 1) -> None:
        with self._lock:
            self.evictions += int(n)

    def leak_check(self) -> Dict:
        """Audit the ledger: every page's refcount must equal the sum of
        owner holds, free pages must have refcount 0, and used + free
        must cover the pool.  ``leaked_pages`` counts pages that are
        unreachable (nonzero refcount with NO owner holding them) —
        after a drained storm releases every stream and the index is
        cleared, it must be 0.  Called by the chaos tests and the bench
        storm gate."""
        with self._lock:
            held = Counter()
            for owned in self._owned.values():
                held.update(owned)
            free_set = set(self._free)
            mismatched = [p for p in range(self.n_pages)
                          if self._ref[p] != held.get(p, 0)]
            free_referenced = [p for p in free_set if self._ref[p] != 0]
            leaked = [p for p in range(self.n_pages)
                      if self._ref[p] > 0 and held.get(p, 0) == 0]
            double_free = len(self._free) != len(free_set)
            unaccounted = [p for p in range(self.n_pages)
                           if self._ref[p] == 0 and p not in free_set]
            ok = not (mismatched or free_referenced or leaked
                      or double_free or unaccounted)
            return {
                "ok": ok,
                "leaked_pages": len(leaked) + len(unaccounted),
                "refcount_mismatches": len(mismatched),
                "free_but_referenced": len(free_referenced),
                "double_free": double_free,
                "owners": len(self._owned),
                "free": len(free_set),
                "total": self.n_pages,
            }

    def snapshot(self) -> Dict:
        with self._lock:
            free = len(self._free)
            used = self.n_pages - free
            return {
                "total_pages": self.n_pages,
                "page_sz": self.page_sz,
                "page_bytes": self.page_bytes,
                "pages_live": used,
                "free_depth": free,
                "page_occupancy": (used / self.n_pages
                                   if self.n_pages else 0.0),
                "owners": len(self._owned),
                "cow_copies": self.cow_copies,
                "evictions": self.evictions,
                "alloc_failures": self.alloc_failures,
            }


class PrefixHit:
    """One lookup result: ``kind`` in {"full", "partial", "miss"};
    ``pages`` = the shareable physical pages in logical order (full
    pages only for partial hits; ALL prompt pages, including a trailing
    partial page, for full hits); ``first_token`` = the stored first
    generated token (full hits only)."""

    __slots__ = ("kind", "pages", "first_token")

    def __init__(self, kind: str, pages: Tuple[int, ...] = (),
                 first_token: Optional[int] = None):
        self.kind = kind
        self.pages = tuple(pages)
        self.first_token = first_token


class PrefixIndex:
    """Token-prefix -> shared-pages index at page granularity.

    Entries are keyed by the EXACT token tuple they cover (``("chain",
    tokens[:k * page_sz])`` for full page k-1; ``("full", tokens)`` for
    a whole prefilled prompt), so two prompts can never alias.  The
    index holds one allocator reference per entry per page (owner
    :data:`INDEX_OWNER`); :meth:`evict` drops LRU entries and returns
    how many pages actually fell free."""

    def __init__(self, allocator: PageAllocator, page_sz: int, *,
                 max_entries: int = 4096):
        self.alloc = allocator
        self.page_sz = int(page_sz)
        self.max_entries = int(max_entries)
        self._lru: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits_full = 0
        self.hits_partial = 0
        self.misses = 0

    # -------------------------------------------------------------- lookup
    def lookup(self, tokens: Sequence[int], *,
               count: bool = True) -> PrefixHit:
        """Best shareable prefix for ``tokens``: a full-prompt entry
        wins outright; otherwise walk the page chain from page 0 while
        entries match.  ``count=False`` is the admission-time PEEK (the
        ``admit`` hop's ``prefix_hit`` attr) — no LRU movement, no hit
        accounting, so the authoritative attach-time lookup stays the
        only one that counts."""
        toks = tuple(int(t) for t in tokens)
        ps = self.page_sz
        with self._lock:
            full = self._lru.get(("full", toks))
            if full is not None:
                if count:
                    self._lru.move_to_end(("full", toks))
                    for k in range(1, len(toks) // ps + 1):
                        key = ("chain", toks[:k * ps])
                        if key in self._lru:
                            self._lru.move_to_end(key)
                    self.hits_full += 1
                return PrefixHit("full", full[0], full[1])
            pages: List[int] = []
            for k in range(1, len(toks) // ps + 1):
                entry = self._lru.get(("chain", toks[:k * ps]))
                if entry is None:
                    break
                pages.append(entry[0][0])
                if count:
                    self._lru.move_to_end(("chain", toks[:k * ps]))
            if count:
                if pages:
                    self.hits_partial += 1
                else:
                    self.misses += 1
            return PrefixHit("partial" if pages else "miss", pages)

    # ------------------------------------------------------------ register
    def register(self, tokens: Sequence[int], pages: Sequence[int],
                 first_token: Optional[int] = None) -> None:
        """Index a freshly prefilled prompt: one chain entry per FULL
        page not already indexed, plus (when ``first_token`` is given) a
        full-prompt entry over ALL the prompt's pages.  The index takes
        its own allocator reference on every page it records, so the
        entries outlive the stream — that reference is what the LRU
        eviction later releases."""
        toks = tuple(int(t) for t in tokens)
        ps = self.page_sz
        with self._lock:
            for k in range(1, len(toks) // ps + 1):
                key = ("chain", toks[:k * ps])
                if key not in self._lru:
                    page = int(pages[k - 1])
                    self.alloc.share([page], INDEX_OWNER)
                    self._lru[key] = ((page,), None)
                self._lru.move_to_end(key)
            if first_token is not None:
                key = ("full", toks)
                if key not in self._lru:
                    held = tuple(int(p) for p in pages)
                    self.alloc.share(held, INDEX_OWNER)
                    self._lru[key] = (held, int(first_token))
                self._lru.move_to_end(key)
            over = len(self._lru) - self.max_entries
        if over > 0:
            self.evict(0, entries=over)

    # ------------------------------------------------------------- evict
    def evict(self, need_pages: int, entries: int = 0) -> int:
        """Drop least-recently-used entries until ``need_pages`` pages
        fell free (or ``entries`` entries dropped, when given); returns
        pages actually freed.  The pages-driven path SKIPS entries whose
        pages are all still mapped by live streams (rotating them to
        MRU): dropping those releases the INDEX references only — the
        pages stay allocated, so nothing falls free and the hot prefix
        just stops being shareable.  One pool-pressure event must not
        sweep the shared prefix the whole mix is riding.  The
        entries-driven path (the ``max_entries`` bound, :meth:`clear`)
        drops unconditionally."""
        freed = 0
        dropped = 0
        scanned = 0
        with self._lock:
            bound = len(self._lru)
        while True:
            with self._lock:
                done = ((need_pages and freed >= need_pages)
                        or (entries and dropped >= entries)
                        or (not need_pages and not entries)
                        or (not entries and scanned >= bound)
                        or not self._lru)
                if done:
                    return freed
                key = next(iter(self._lru))
                pages, _tok = self._lru[key]
            scanned += 1
            if entries:
                with self._lock:
                    if self._lru.pop(key, None) is None:
                        continue
                freed += self.alloc.release(list(pages), INDEX_OWNER)
                dropped += 1
                self.alloc.count_evictions()
                continue
            got = self.alloc.release_if_idle(list(pages), INDEX_OWNER)
            with self._lock:
                if got is None:
                    if key in self._lru:
                        self._lru.move_to_end(key)
                    continue
                self._lru.pop(key, None)
            freed += got
            dropped += 1
            self.alloc.count_evictions()

    def clear(self) -> int:
        """Drop every entry (teardown/leak-audit path)."""
        with self._lock:
            n = len(self._lru)
        return self.evict(0, entries=n) if n else 0

    # ------------------------------------------------------------ metering
    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def snapshot(self) -> Dict:
        with self._lock:
            total = self.hits_full + self.hits_partial + self.misses
            return {
                "entries": len(self._lru),
                "hits_full": self.hits_full,
                "hits_partial": self.hits_partial,
                "misses": self.misses,
                "hit_rate": ((self.hits_full + self.hits_partial) / total
                             if total else 0.0),
            }
