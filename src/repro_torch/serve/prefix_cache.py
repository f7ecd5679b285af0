"""Radix prefix index over the packed (MXFP4) KV pool.

Port of ``repro.serve.prefix_cache`` (plain Python and numpy, copied).

Requests that share a prompt prefix — N users × one system prompt, or
conversation continuations — produce **bit-identical** KV pages, because the
pool's MXFP4 packing is deterministic quantize-on-write (same tokens at the
same positions ⇒ same E2M1 codes + E8M0 scales; dense pools trivially so).
That makes aliasing safe: a new request can map already-written physical
pages into its own page table and skip re-prefilling them entirely.

The index is a radix trie keyed on **page-sized token chunks**: each node
owns exactly one physical page and the ``page_size`` token ids whose KV it
holds; a node's path from the root spells the full token prefix, so two
prompts share a node only when their ENTIRE prefix up to that page matches
(KV at position p depends on all positions ≤ p — matching the chunk alone
would be unsound).  Only fully-written pages are ever indexed or aliased:
partial tail pages are re-prefilled by the admitting request through the
scratch-sentinel write-mask machinery, never shared.

Page lifetime is reference-counted by :class:`~repro_torch.serve.paged_cache.
PagedCache`: the index pins each cached page with one external reference
(``ref_page``), every slot that aliases it adds another, and the physical
page returns to the free list only when the last holder lets go.  Under pool
pressure the engine evicts least-recently-matched leaves (``evict``) until
admission fits; evicting a node whose page some slot still maps merely drops
the index's pin (the page frees later, when the slot retires).
"""

from __future__ import annotations

import numpy as np


class _Node:
    """One cached page: ``key`` is the page's token chunk (bytes of
    ``page_size`` int32 ids), ``page`` its physical page id, ``stamp`` the
    last time the node was matched or inserted (LRU eviction order)."""

    __slots__ = ("key", "page", "stamp", "parent", "children")

    def __init__(self, key: bytes, page: int, stamp: float, parent):
        self.key, self.page, self.stamp = key, page, stamp
        self.parent = parent
        self.children: dict[bytes, _Node] = {}


class PrefixIndex:
    """Host-side radix trie mapping token prefixes to pool page ids."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._root = _Node(b"", 0, 0.0, None)  # sentinel, owns no page
        self._n_nodes = 0

    # -- helpers ------------------------------------------------------------

    def _chunks(self, tokens: np.ndarray, n_pages: int):
        ps = self.page_size
        tokens = np.ascontiguousarray(tokens, np.int32)
        for i in range(n_pages):
            yield i, tokens[i * ps:(i + 1) * ps].tobytes()

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def cached_pages(self) -> int:
        """Nodes in the index == physical pages it pins (1:1)."""
        return self._n_nodes

    # -- admission-side API --------------------------------------------------

    def match(self, tokens: np.ndarray, stamp: float) -> list[int]:
        """Longest cached chain of FULL pages prefixing ``tokens`` → their
        page ids, root-first.  Touches every matched node's LRU stamp.  The
        caller aliases these pages (``PagedCache.alloc(shared=...)``) and
        prefills only the uncovered tail."""
        out: list[int] = []
        node = self._root
        for _, key in self._chunks(tokens, len(tokens) // self.page_size):
            child = node.children.get(key)
            if child is None:
                break
            child.stamp = stamp
            out.append(child.page)
            node = child
        return out

    def evictable_pages(self, cache, exclude=()) -> int:
        """Pages eviction could return to the free list right now: cached
        nodes whose page has no holder besides the index's own pin
        (refcount == 1) and is not in ``exclude`` (a match about to be
        aliased must not be counted as reclaimable)."""
        exclude = set(exclude)
        return sum(1 for nd in self._iter_nodes()
                   if nd.page not in exclude and int(cache.refcounts[nd.page]) == 1)

    def evict(self, cache, n_pages: int, exclude=()) -> int:
        """LRU-evict leaves until ``n_pages`` pages have returned to the free
        list (or nothing evictable remains); returns pages actually freed.
        Leaf-first keeps every surviving node reachable from the root; a
        dropped node whose page a live slot still maps frees no page now but
        unblocks its ancestors for the next pass.  ``exclude`` pins pages
        (the admission match being aliased)."""
        exclude = set(exclude)
        freed = 0
        while freed < n_pages:
            leaf = None
            for nd in self._iter_nodes():
                if nd.children or nd.page in exclude:
                    continue
                if leaf is None or nd.stamp < leaf.stamp:
                    leaf = nd
            if leaf is None:
                break
            del leaf.parent.children[leaf.key]
            self._n_nodes -= 1
            if cache.unref_page(leaf.page):
                freed += 1
        return freed

    # -- publish-side API ----------------------------------------------------

    def insert(self, cache, tokens: np.ndarray, table_row, stamp: float) -> int:
        """Publish a slot's fully-written pages: walk the chain for
        ``tokens`` (only ``len(tokens) // page_size`` FULL pages), creating
        missing nodes from ``table_row``'s page ids and pinning each new page
        with ``cache.ref_page``.  Existing nodes keep their page — same chain
        means same full prefix, and deterministic quantize-on-write makes the
        payloads bit-identical.  Returns pages newly inserted."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        node, added = self._root, 0
        for i, key in self._chunks(tokens, len(tokens) // self.page_size):
            child = node.children.get(key)
            if child is None:
                pid = int(table_row[i])
                if pid == 0:
                    break  # slot doesn't map this page — nothing to publish
                cache.ref_page(pid)
                child = _Node(key, pid, stamp, node)
                node.children[key] = child
                self._n_nodes += 1
                added += 1
            else:
                child.stamp = stamp
            node = child
        return added
