"""Host-side bookkeeping for the shared-prefix KV block pool (the port's
own copy of ``cloud_tpu/serving/prefix_cache.py``: plain Python, kept here
so that the port imports nothing of the JAX package).

The device half is ``generation.init_prefix_pool`` — ``num_blocks`` KV
rows of ``block_tokens`` positions each, plus the copy/save programs
that move blocks between the pool and the slot grid.  This module owns
WHICH token prefix each block holds: a token-trie (radix tree at block
granularity) where every node is one block, keyed by that block's
token tuple, child nodes extending the prefix by one block.  A prompt's
longest cached prefix is a root-down walk (:meth:`PrefixCacheManager.
match`); the blocks it returns are the pool rows to copy.

Lifecycle is reference-counted: a slot that copies blocks in (a hit) or
saves new blocks out (a miss becoming tomorrow's hit) holds a reference
on each until the slot retires, so a block shared by two in-flight
requests survives either one finishing.  Eviction is LRU over
*unreferenced leaves* — a parent can never leave before its children
(the trie walk would dangle), and a referenced block never leaves at
all.  When every block is pinned, :meth:`insert` simply caches less:
the prefix cache is an accelerator, never a correctness dependency.

**Host-DRAM second tier** (``dram_blocks > 0``): a block evicted from
the HBM pool does not vanish — its bytes are *demoted* to a bounded
host-side pool (host tensors captured through an engine-installed
``demote_fn``) and the node stays in the trie, flagged
``tier == "dram"``.  A later match that walks through demoted nodes is
still a hit; :meth:`acquire_swapin` *promotes* those nodes back —
allocating fresh HBM rows (which may itself demote colder blocks) and
returning the host payloads for the engine to upload asynchronously —
and a promotion that cannot allocate rows (the pool fully pinned:
the swap-in lost the race) fails the acquire exactly like the
single-tier evicted-between-match-and-acquire window, so the engine falls
back to a cold prefill and greedy outputs stay token-identical in every tier
state.  A *pinned* block (refs > 0) never demotes and never leaves
DRAM; when the DRAM pool overflows, its LRU unreferenced leaf is
evicted for real (the miss-after-demote-evict state).  With
``dram_blocks == 0`` (the default) none of this machinery exists and
behavior is byte-identical to the single-tier manager.

``match`` does NOT pin.  The scheduler pins with :meth:`acquire` (or
:meth:`acquire_swapin` when the DRAM tier is armed), which re-validates
that every matched node is still live — a block evicted between lookup
and insert (allocation pressure from a neighboring request in the same
scheduling pass) fails the acquire, and the engine falls back to a
cold prefill instead of copying a reused block's bytes (the
no-stale-KV contract).

Everything here is plain host Python on the scheduler thread; a small
lock guards the counters that ``health()``/``stats()`` read from other
threads.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: Scatter sentinel for "do not write this block": out of any real pool's
#: range, so ``generation.save_prefix_program``'s drop-mode scatter skips
#: it.  (Reads clamp rather than drop, so the COPY side pads with real
#: hit ids instead — see ``ServingEngine._copy_prefix``.)
SKIP_BLOCK = 2 ** 30

#: Leading tokens hashed into a request's router affinity key AND into
#: the per-replica cached-prefix summary (:meth:`PrefixCacheManager.
#: hot_prefixes`) the cost-model router scores against.  One spelling,
#: defined at the serving layer so the engine's summary and the fleet's
#: request key can never drift: sized to cover typical shared
#: system-prompt heads without making every long unique prompt its own
#: key.
AFFINITY_PREFIX_TOKENS = 32


def affinity_key(tokens: Sequence[int]) -> int:
    """The router-facing key of a token sequence's leading prefix —
    used by the fleet for each request and by the engine's
    ``hot_prefixes`` summary, so a summary lookup with a request's key
    estimates how many of ITS prefix tokens the replica caches."""
    return hash(tuple(int(t) for t in tokens[:AFFINITY_PREFIX_TOKENS]))


@dataclasses.dataclass(eq=False)  # identity semantics: nodes are unique,
class _Node:                      # and the evictable set hashes them
    """One cached block: ``key`` is this block's token tuple (the full
    prefix is the root-down concatenation), ``block`` its pool row."""

    key: Tuple[int, ...]
    block: int
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict
    )
    refs: int = 0
    last_used: int = 0
    #: Flipped False on (full) eviction: a PrefixHit holding this node
    #: fails ``acquire`` instead of copying a reused block's bytes.
    live: bool = True
    #: Which pool holds the block's bytes: ``"hbm"`` (``block`` is a
    #: live device pool row) or ``"dram"`` (``payload`` is the host
    #: copy; ``block`` is meaningless until a promotion re-rows it).
    tier: str = "hbm"
    #: Host-side bytes while demoted (whatever ``demote_fn`` returned —
    #: the engine uses a per-leaf dict of host tensors mirroring the pool
    #: row).
    payload: object = None


@dataclasses.dataclass(frozen=True)
class PrefixHit:
    """A ``match`` result: the trie nodes of the longest cached prefix
    (root-down order) and how many prompt tokens they cover.  Holds no
    references until :meth:`PrefixCacheManager.acquire`."""

    nodes: Tuple[_Node, ...]
    tokens: int

    @property
    def blocks(self) -> List[int]:
        return [node.block for node in self.nodes]

    def __bool__(self) -> bool:
        return bool(self.nodes)


class PrefixCacheManager:
    """Radix bookkeeping over a ``num_blocks``-row device pool, with an
    optional ``dram_blocks``-slot host tier (module docstring).

    ``demote_fn`` captures an HBM block's bytes host-side at demotion
    time — ``demote_fn(block) -> payload`` — and is installed by the
    engine (it owns the device pool the bytes come from).  Without one,
    an armed DRAM tier never demotes (blocks vanish as in the single-tier
    cache);
    manager-level tests install trivial fakes.
    """

    def __init__(self, num_blocks: int, block_tokens: int, *,
                 dram_blocks: int = 0,
                 demote_fn: Optional[Callable[[int], object]] = None,
                 summary_ttl_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_tokens < 1:
            raise ValueError(
                f"block_tokens must be >= 1, got {block_tokens}"
            )
        if dram_blocks < 0:
            raise ValueError(
                f"dram_blocks must be >= 0, got {dram_blocks}"
            )
        if summary_ttl_s is not None and summary_ttl_s <= 0:
            raise ValueError(
                f"summary_ttl_s must be > 0, got {summary_ttl_s}"
            )
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self.dram_blocks = dram_blocks
        self.demote_fn = demote_fn
        #: TTL on :meth:`hot_prefixes` entries (None = never expire —
        #: byte-identical to the pre-TTL summary).  ``clock`` is the
        #: wall source (monotonic seconds); tests inject fakes.
        self.summary_ttl_s = summary_ttl_s
        self._wall = clock if clock is not None else time.monotonic
        #: Last time each summary key was HIT (acquire / insert /
        #: seed), keyed like ``_summary``.  Entries for keys no longer
        #: in the summary are pruned at each rebuild, so it stays
        #: bounded by the summary's own limit.
        self._last_hit: Dict[int, float] = {}
        self._root = _Node(key=(), block=-1, parent=None)
        self._free: List[int] = list(range(num_blocks))[::-1]
        #: Eviction candidates — nodes that WERE (refs == 0, childless)
        #: at their last transition, one set per tier.  Maintained
        #: incrementally so an allocation under pool pressure scans
        #: candidates, not the whole trie (entries are re-validated at
        #: eviction time, so a stale member is skipped, never wrongly
        #: evicted).
        self._evictable: set = set()
        self._dram_evictable: set = set()
        self._dram_used = 0
        #: Router-facing hot-prefix summary (see :meth:`hot_prefixes`):
        #: rebuilt whole on the scheduler thread, read by reference
        #: from health() callers.  ``_shape_version`` ticks on every
        #: node ADDITION or REMOVAL (tier flips don't change the
        #: summary), so ``_maybe_refresh`` skips the DFS on the
        #: steady hot path — hits, swap-ins, and pure demotions.
        self._summary: Dict[int, int] = {}
        self._shape_version = 0
        self._summary_version = 0
        self._clock = 0
        self._lock = threading.Lock()
        self._stats = {
            "lookups": 0, "hits": 0, "misses": 0, "hit_tokens": 0,
            "acquire_failures": 0, "evictions": 0, "saved_blocks": 0,
            # DRAM-tier counters (all stay 0 with dram_blocks == 0).
            "demotions": 0, "promotions": 0, "dram_evictions": 0,
            "dram_hits": 0, "dram_hit_tokens": 0, "swapin_failures": 0,
            # Save-backs inserted while a pipelined chunk was still in
            # flight (stays 0 at pipeline_depth=1) — see "Save-back
            # ordering under pipelined scheduling" below.
            "deferred_saves": 0,
        }

    def note_deferred_save(self) -> None:
        """Count one save-back that landed while a pipelined chunk was
        still in flight (engine calls this from its scheduler thread;
        the counter is the parity tests' evidence that the deferred
        ordering path actually ran).

        Save-back ordering under pipelined scheduling: with
        ``pipeline_depth=2`` the engine inserts a prompt's trie entry —
        and dispatches the pool write for its new blocks — while the
        PREVIOUS decode chunk is still executing on the device.  Two
        facts keep that safe with zero extra synchronization.  On the
        device, the save program consumes the same donated grid cache
        the in-flight chunk produces, so XLA's dataflow ordering runs
        the pool write strictly AFTER the chunk — the saved rows are
        exactly the post-prefill rows, never a torn snapshot.  On the
        host, the trie entry becomes matchable the moment ``insert``
        returns, but the only thread that can act on a match is the
        scheduler thread itself (match/acquire/copy-in all happen
        there), which by construction has already moved past the save —
        so no request can attach a block whose pool write hasn't been
        enqueued behind everything that could disturb it."""
        with self._lock:
            self._stats["deferred_saves"] += 1

    # -- introspection -----------------------------------------------------

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def dram_blocks_in_use(self) -> int:
        return self._dram_used

    def stats(self) -> dict:
        with self._lock:
            snap = dict(self._stats)
        snap["blocks_in_use"] = self.blocks_in_use
        snap["dram_blocks_in_use"] = self.dram_blocks_in_use
        return snap

    def hot_prefixes(self) -> Dict[int, int]:
        """The router-facing cached-prefix summary: ``{affinity key ->
        deepest cached prefix tokens}`` over the trie's hot roots, both
        tiers (a demoted prefix still serves via swap-in, so it still
        deserves traffic).  Keys are :func:`affinity_key` hashes of
        each cached prefix's leading tokens — the same hash the fleet
        stamps on every request — so ``summary.get(request.affinity_
        key, 0)`` estimates the prefix tokens this replica would serve
        from cache.

        Only prefixes covering at least ``AFFINITY_PREFIX_TOKENS``
        tokens appear (shorter cached paths cannot match any request's
        key — ``_refresh_summary``).  Returns a SNAPSHOT: the summary
        is recomputed on the scheduler thread after every trie-shape
        change and swapped in whole, so ``health()`` callers on router
        threads never walk a trie that is mutating under them.

        With ``summary_ttl_s`` armed, entries whose prefix has not been
        HIT (acquired, re-inserted, or handoff-seeded) within the TTL
        are filtered out of the snapshot: a replica that lost its hot
        tenant stops advertising stale cached-prefix credit to the
        router cost model, even though the blocks may still sit in the
        trie waiting for LRU pressure.  The blocks themselves remain
        servable — a late request still hits; only the ADVERTISEMENT
        ages out."""
        summary = self._summary
        ttl = self.summary_ttl_s
        if ttl is None:
            return dict(summary)
        now = self._wall()
        last = self._last_hit
        return {
            key: depth for key, depth in summary.items()
            if now - last.get(key, now) <= ttl
        }

    def _touch_summary_key(self, lead_tokens: Sequence[int]) -> None:
        """Refresh the TTL clock of the summary entry covering
        ``lead_tokens`` (no-op without a TTL or below the affinity
        span — such paths never appear in the summary at all)."""
        if self.summary_ttl_s is None:
            return
        if len(lead_tokens) < AFFINITY_PREFIX_TOKENS:
            return
        key = hash(tuple(
            int(t) for t in lead_tokens[:AFFINITY_PREFIX_TOKENS]
        ))
        self._last_hit[key] = self._wall()

    def _lead_tokens(self, nodes: Sequence[_Node]) -> List[int]:
        """The leading tokens of a root-down node chain, just enough to
        cover the affinity span."""
        lead: List[int] = []
        for node in nodes:
            lead.extend(node.key)
            if len(lead) >= AFFINITY_PREFIX_TOKENS:
                break
        return lead

    def _maybe_refresh(self) -> None:
        """Rebuild the summary iff the trie's node set changed since
        the last build (scheduler thread only — every caller of
        insert/acquire/evict ends with this)."""
        if self._summary_version != self._shape_version:
            self._refresh_summary()
            self._summary_version = self._shape_version

    def _refresh_summary(self, *, limit: int = 64) -> None:
        """Recompute the hot-prefix summary (scheduler thread only).
        Entries are emitted
        only once a root-down path covers ``AFFINITY_PREFIX_TOKENS``
        tokens (deeper nodes just raise that entry's depth): a
        shallower cached path can never match ANY request's affinity
        key — the cacheable span caps at ``len - 1``, so a request
        able to hit a ``d``-token path hashes at least ``d + 1``
        leading tokens, a strictly longer tuple — and emitting such
        paths would burn the ``limit`` bound on dead keys while a
        genuinely hot long prefix gets dropped.  At most ``limit``
        distinct keys (new keys past the bound are dropped — the
        summary is an estimate, not an index)."""
        out: Dict[int, int] = {}
        stack: List[Tuple[_Node, Tuple[int, ...], int]] = [
            (self._root, (), 0)
        ]
        while stack:
            node, lead, depth = stack.pop()
            for key, child in node.children.items():
                clead = (
                    lead if len(lead) >= AFFINITY_PREFIX_TOKENS
                    else (lead + key)[:AFFINITY_PREFIX_TOKENS]
                )
                cdepth = depth + len(key)
                if len(clead) >= AFFINITY_PREFIX_TOKENS:
                    k = hash(tuple(clead))
                    if k in out:
                        out[k] = max(out[k], cdepth)
                    elif len(out) < limit:
                        out[k] = cdepth
                stack.append((child, clead, cdepth))
        if self.summary_ttl_s is not None:
            # New keys start their TTL clock at first appearance; keys
            # that left the summary drop their clock (bounds the map).
            now = self._wall()
            last = self._last_hit
            self._last_hit = {
                key: last.get(key, now) for key in out
            }
        self._summary = out

    def _count(self, **deltas) -> None:
        with self._lock:
            for key, delta in deltas.items():
                self._stats[key] += delta

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @staticmethod
    def _has_hbm_child(node: _Node) -> bool:
        return any(c.tier == "hbm" for c in node.children.values())

    def _mark_if_evictable_leaf(self, node: _Node) -> None:
        """(Re)enter ``node`` into its tier's eviction-candidate set.

        HBM candidates are unreferenced nodes with no HBM children — a
        node whose children all demoted to DRAM may itself DEMOTE
        (the trie keeps it, so nothing dangles) but never vanish;
        ``_evict_node`` enforces that split.  DRAM candidates must be
        fully childless: DRAM eviction is removal, and a removed parent
        would orphan its subtree."""
        if node is self._root or not node.live:
            return
        if node.refs != 0:
            return
        if node.tier == "dram":
            if not node.children:
                self._dram_evictable.add(node)
        elif not self._has_hbm_child(node):
            self._evictable.add(node)

    def _unmark_evictable(self, node: _Node) -> None:
        self._evictable.discard(node)
        self._dram_evictable.discard(node)

    # -- lookup / pin ------------------------------------------------------

    def _walk(self, tokens: Sequence[int], max_tokens: int) -> PrefixHit:
        node = self._root
        nodes: List[_Node] = []
        offset = 0
        while offset + self.block_tokens <= max_tokens:
            key = tuple(
                int(t) for t in tokens[offset:offset + self.block_tokens]
            )
            child = node.children.get(key)
            if child is None:
                break
            nodes.append(child)
            node = child
            offset += self.block_tokens
        return PrefixHit(nodes=tuple(nodes), tokens=offset)

    def match(self, tokens: Sequence[int]) -> PrefixHit:
        """Longest cached prefix of ``tokens``, in whole blocks, capped
        at ``len(tokens) - 1`` tokens — at least the prompt's last token
        always prefills, so even a fully cached prompt produces the
        logits its first sampled token needs.  Counts a lookup (and the
        miss, when nothing matched); a HIT is only counted by a
        successful :meth:`acquire` — a match whose blocks evict before
        the pin lands serves cold, and the stats must say so (the same
        verdict the engine's own counters reach).  The walk crosses
        tier boundaries freely: demoted nodes match, and the acquire
        step promotes them."""
        hit = self._walk(tokens, max(len(tokens) - 1, 0))
        self._count(lookups=1, misses=0 if hit.nodes else 1)
        return hit

    def acquire(self, hit: PrefixHit) -> bool:
        """Pin a match's blocks (ref +1 each, LRU bumped).  Returns
        False — pinning NOTHING, counting a miss — if any node was
        evicted since the match: the caller must fall back to a cold
        prefill.  This is the single-tier pin: a hit that walked into
        DRAM-demoted nodes also fails (their bytes are not on the
        device) — a tier-armed engine pins through
        :meth:`acquire_swapin` instead, which promotes them."""
        plan = self.acquire_swapin(hit, promote=False)
        return plan is not None

    def acquire_swapin(
        self, hit: PrefixHit, *, promote: bool = True,
    ) -> Optional[List[Tuple[_Node, int, object]]]:
        """Pin a match's blocks, promoting any DRAM-demoted ones back
        into fresh HBM rows.  Returns the promotion plan — ``[(node,
        new_block, payload), ...]`` root-down, empty when the whole hit
        was already HBM-resident — whose payloads the caller must
        upload into the pool rows BEFORE dispatching the prefix copy.
        Returns ``None`` — pinning nothing, counting a miss (plus
        ``swapin_failures`` when a promotion was needed) — when any
        node was evicted since the match OR the promotion could not
        allocate rows (HBM fully pinned: the swap-in lost the race);
        the caller falls back to a cold prefill either way."""
        if not hit.nodes:
            return None
        if not all(node.live for node in hit.nodes):
            self._count(misses=1, acquire_failures=1)
            return None
        demoted = [n for n in hit.nodes if n.tier == "dram"]
        if demoted and not promote:
            self._count(misses=1, acquire_failures=1)
            return None
        # Pin FIRST: allocation pressure from the promotion below must
        # never evict (or re-demote) the hit's own blocks.
        now = self._tick()
        for node in hit.nodes:
            node.refs += 1
            node.last_used = now
            self._unmark_evictable(node)
        plan: List[Tuple[_Node, int, object]] = []
        if demoted:
            rows: List[int] = []
            for _ in demoted:
                block, _ = self._allocate()
                if block is None:
                    # Lost the race: HBM is fully pinned right now.
                    # Unwind entirely — rows back, pins off — and tell
                    # the caller to serve cold.
                    self._free.extend(rows)
                    self.release(list(hit.nodes))
                    self._count(misses=1, acquire_failures=1,
                                swapin_failures=1)
                    self._maybe_refresh()  # _allocate may have removed
                    return None
                rows.append(block)
            for node, block in zip(demoted, rows):
                plan.append((node, block, node.payload))
                node.payload = None
                node.block = block
                node.tier = "hbm"
                self._dram_used -= 1
            self._count(
                promotions=len(plan), dram_hits=1,
                dram_hit_tokens=len(plan) * self.block_tokens,
            )
            self._maybe_refresh()  # _allocate may have removed
        self._count(hits=1, hit_tokens=hit.tokens)
        self._touch_summary_key(self._lead_tokens(hit.nodes))
        return plan

    def release(self, nodes: Sequence[_Node]) -> None:
        """Drop one reference per node (a retiring slot's held blocks).
        Evicted-while-held nodes still count down safely."""
        for node in nodes:
            if node.refs > 0:
                node.refs -= 1
            self._mark_if_evictable_leaf(node)

    # -- insert / evict ----------------------------------------------------

    def insert(self, tokens: Sequence[int],
               already: PrefixHit,
               ) -> Tuple[List[_Node], List[_Node], int]:
        """Extend the trie with the full blocks of ``tokens`` beyond the
        ``already``-cached prefix (the hit the caller copied in, or an
        empty one).  Allocates pool rows — evicting LRU unreferenced
        leaves as needed — and returns ``(held, created, evicted)``:
        ``held`` is every walked node beyond the prefix (one reference
        taken on each — the caller's slot releases them at retire;
        in-flight siblings may have cached some of them since the
        caller's match), ``created`` the subset whose pool rows are NEW
        and must be written by ``save_prefix_program`` (existing blocks
        are never rewritten — in-flight readers may share them), and
        ``evicted`` how many LRU blocks THIS insert reclaimed (demoted
        to DRAM or dropped).  Stops early, caching less, when the pool
        is fully pinned.  A walk that lands on a DRAM-demoted node
        stops there too — the slot did its own prefill for those
        positions, and extending the trie below bytes the device does
        not hold would hand a later match a hit it cannot copy.  The
        last ``len(tokens) % block_tokens`` tokens never cache (partial
        blocks are not addressable), and like :meth:`match` the
        cacheable span is capped at ``len(tokens) - 1``."""
        max_tokens = max(len(tokens) - 1, 0)
        node = self._root if not already.nodes else already.nodes[-1]
        offset = already.tokens
        now = self._tick()
        held: List[_Node] = []
        created: List[_Node] = []
        evicted = 0
        while offset + self.block_tokens <= max_tokens:
            key = tuple(
                int(t) for t in tokens[offset:offset + self.block_tokens]
            )
            child = node.children.get(key)
            if child is not None and child.tier == "dram":
                break
            if child is None:
                block, from_eviction = self._allocate()
                if block is None:
                    break
                evicted += 1 if from_eviction else 0
                child = _Node(key=key, block=block, parent=node)
                node.children[key] = child
                self._unmark_evictable(node)  # no longer a leaf
                created.append(child)
                self._shape_version += 1
                self._count(saved_blocks=1)
            child.refs += 1
            child.last_used = now
            self._unmark_evictable(child)
            held.append(child)
            node = child
            offset += self.block_tokens
        # Shape-change only: a pure re-walk of already-cached blocks
        # (the steady hot state) must not pay the summary DFS on the
        # scheduler thread — and neither must pure demotions.
        self._maybe_refresh()
        if offset >= AFFINITY_PREFIX_TOKENS:
            self._touch_summary_key(tokens)
        return held, created, evicted

    def seed_blocks(
        self, keys: Sequence[Sequence[int]],
    ) -> Tuple[List[_Node], List[_Node]]:
        """Walk/extend the trie along exactly ``keys`` — one
        ``block_tokens``-long token tuple per block, root-down — the
        handoff-import seam: a decode replica plants the blocks a
        prefill replica exported, so its very next lookup for the same
        prompt is an ordinary prefix hit.

        Allocates pool rows for missing nodes (evicting LRU leaves
        under pressure, exactly like :meth:`insert`) and returns
        ``(held, created)``: one reference taken on EVERY walked node —
        the caller releases them once its own acquire has pinned the
        hit, so allocation pressure in between can never evict the
        seeded chain — and ``created`` the subset whose pool rows must
        be WRITTEN (``upload_prefix_block``) by the caller before any
        copy/attach reads them.  Blocks already cached are never
        rewritten (same tokens, same bytes — the cross-replica dedup
        that makes a re-handoff of a hot prefix nearly free).  Stops
        early — seeding less — when allocation fails or the walk lands
        on a DRAM-demoted node, mirroring :meth:`insert`'s contract:
        the import is an accelerator, never a correctness dependency.
        """
        node = self._root
        now = self._tick()
        held: List[_Node] = []
        created: List[_Node] = []
        for key in keys:
            key = tuple(int(t) for t in key)
            if len(key) != self.block_tokens:
                raise ValueError(
                    f"seed key length {len(key)} != block_tokens "
                    f"{self.block_tokens}"
                )
            child = node.children.get(key)
            if child is not None and child.tier == "dram":
                break
            if child is None:
                block, _ = self._allocate()
                if block is None:
                    break
                child = _Node(key=key, block=block, parent=node)
                node.children[key] = child
                self._unmark_evictable(node)  # no longer a leaf
                created.append(child)
                self._shape_version += 1
                self._count(saved_blocks=1)
            child.refs += 1
            child.last_used = now
            self._unmark_evictable(child)
            held.append(child)
            node = child
        self._maybe_refresh()
        if len(held) * self.block_tokens >= AFFINITY_PREFIX_TOKENS:
            self._touch_summary_key(self._lead_tokens(held))
        return held, created

    def _allocate(self) -> Tuple[Optional[int], bool]:
        """A free pool row, or an evicted one: ``(block | None,
        came_from_eviction)``."""
        if self._free:
            return self._free.pop(), False
        block = self._evict_one()
        return block, block is not None

    def _scan_lru(self, candidates: set, tier: str, *,
                  allow_children: bool) -> Optional[_Node]:
        """The LRU valid eviction candidate of ``candidates`` for
        ``tier`` (dropping stale set members as it goes) — ONE scan
        loop for both tiers' candidate sets.  ``allow_children=False``
        restricts to fully childless nodes — the ones that may VANISH
        (DRAM eviction is always removal, so its callers never relax
        it)."""
        victim: Optional[_Node] = None
        stale = []
        for node in candidates:
            if (not node.live or node.refs > 0 or node.tier != tier
                    or (self._has_hbm_child(node) if tier == "hbm"
                        else bool(node.children))):
                stale.append(node)
                continue
            if node.children and not allow_children:
                continue
            if victim is None or node.last_used < victim.last_used:
                victim = node
        for node in stale:
            candidates.discard(node)
        return victim

    def _scan_evictable(self, *, allow_children: bool) -> Optional[_Node]:
        return self._scan_lru(self._evictable, "hbm",
                              allow_children=allow_children)

    def _evict_one(self) -> Optional[int]:
        """Reclaim the LRU unreferenced LEAF block; None if every block
        is referenced (or an HBM ancestor of one).  Scans the
        incrementally-maintained candidate set — not the trie — and
        re-validates each member (stale entries are dropped), so the
        scheduler-thread cost of an allocation under pool pressure is
        bounded by the evictable population.  With the DRAM tier armed
        the victim's bytes demote instead of vanishing; a victim with
        DRAM children can ONLY demote, so when the tier cannot take it
        the scan falls back to the LRU childless candidate."""
        victim = self._scan_evictable(allow_children=True)
        if victim is None:
            return None
        block = victim.block
        if self._evict_node(victim):
            return block
        # Demotion was required (DRAM children) but impossible: only a
        # childless candidate can vanish instead.
        self._evictable.add(victim)  # still a candidate for next time
        victim = self._scan_evictable(allow_children=False)
        if victim is None:
            return None
        block = victim.block
        if self._evict_node(victim):
            return block
        self._evictable.add(victim)
        return None

    def _evict_node(self, victim: _Node, *,
                    allow_demote: bool = True) -> bool:
        """Take ``victim``'s HBM row back: demote its bytes to the DRAM
        tier when armed (the node stays in the trie, ``tier ==
        "dram"``), else evict it for real.  On success the row is the
        caller's to reuse; False when the victim could neither demote
        (no tier room) nor vanish (it still has DRAM children a removal
        would orphan)."""
        self._evictable.discard(victim)
        if (allow_demote and self.dram_blocks > 0
                and self.demote_fn is not None
                and self._demote_room()):
            victim.payload = self.demote_fn(victim.block)
            victim.tier = "dram"
            victim.block = -1
            self._dram_used += 1
            self._mark_if_evictable_leaf(victim)
            # Its parent may have just lost its last HBM child.
            if victim.parent is not None:
                self._mark_if_evictable_leaf(victim.parent)
            self._count(evictions=1, demotions=1)
            return True
        if victim.children:
            # All-DRAM children (the HBM-child scan excluded the rest):
            # removal would orphan them, and demotion just failed.
            return False
        victim.live = False
        victim.payload = None
        parent = victim.parent
        parent.children.pop(victim.key, None)
        self._mark_if_evictable_leaf(parent)  # now a leaf itself
        self._shape_version += 1
        self._count(evictions=1)
        return True

    def _demote_room(self) -> bool:
        """Make room in the DRAM pool for one more demotion, evicting
        its LRU unreferenced leaf if needed.  False when DRAM is full
        of pinned (or interior) blocks — the caller's victim then
        vanishes instead of demoting."""
        if self._dram_used < self.dram_blocks:
            return True
        victim = self._scan_lru(self._dram_evictable, "dram",
                                allow_children=False)
        if victim is None:
            return False
        self._evict_dram_node(victim)
        return True

    def _evict_dram_node(self, victim: _Node) -> None:
        """Full eviction of a DRAM-tier leaf (the miss-after-demote-
        evict state: a later match that reaches it goes cold)."""
        victim.live = False
        victim.payload = None
        self._dram_used -= 1
        self._dram_evictable.discard(victim)
        parent = victim.parent
        parent.children.pop(victim.key, None)
        self._mark_if_evictable_leaf(parent)
        self._shape_version += 1
        self._count(dram_evictions=1)

    def evict_prefix(self, tokens: Sequence[int], *,
                     allow_demote: bool = False) -> int:
        """Force-evict every cached block along ``tokens``'s prefix that
        is unreferenced and childless, deepest first (a test/ops hook —
        the eviction-between-lookup-and-insert seam).  By default the
        blocks vanish even with the DRAM tier armed (the single-tier
        semantics this hook exists to simulate);
        ``allow_demote=True`` routes them through the tier instead.
        Returns the number of blocks evicted."""
        hit = self._walk(tokens, len(tokens))
        evicted = 0
        for node in reversed(hit.nodes):
            if node.refs > 0 or node.children:
                break
            if node.tier == "dram":
                self._evict_dram_node(node)
            else:
                block = node.block
                if not self._evict_node(node, allow_demote=allow_demote):
                    break
                # Whether the bytes demoted or vanished, the HBM row
                # itself is reclaimed.
                self._free.append(block)
            evicted += 1
        self._maybe_refresh()
        return evicted
