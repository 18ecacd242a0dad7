"""Disaggregated prefill/decode serving: roles, KV handoff, host pool
(port of ``cloud_tpu/fleet/disagg.py``).

The datacenter-scale serving shape: compute-bound
prefill and latency-bound decode scale independently only when they are
separate pools.  This module owns the fleet-side half of that split —
everything that is policy, not device work:

* **Roles.**  Every replica carries a ``role`` — ``"prefill"``,
  ``"decode"``, or ``"both"`` (the default, byte-identical to the
  colocated fleet: no handoff programs are ever built and the handoff
  schema keys read zero).  The router only offers a new request to
  prefill-capable replicas and a handoff-carrying request to
  decode-capable ones (:func:`serves_prefill` / :func:`serves_decode`).

* **Handoff payloads.**  A prefill replica serves a request's first
  token and, on the way, donates the prompt's full blocks to its prefix
  pool exactly as a colocated engine would; the engine then exports
  those blocks host-side via ``generation.download_prefix_blocks`` —
  per-leaf host tensors, the SAME serialization the DRAM demote tier
  uses, so kv_quant int8 blocks and their scale leaves ride verbatim.
  The payload travels as a plain dict (:func:`payload_blocks` describes
  the shape) and a decode replica imports it by seeding its own prefix
  trie (``PrefixCacheManager.seed_blocks`` + ``upload_prefix_blocks``),
  after which the request's normal admission sees an ordinary prefix
  hit — the block-table ATTACH when paged, ``copy_prefix_
  program`` otherwise — and decodes to completion.  Token-identity
  with colocated ``generate()`` therefore falls out of the prefix
  cache's existing proven contract rather than a new decode path.

* **Host pool.**  :class:`HostPrefixPool` is the shared per-host DRAM
  store: exported block bytes are stashed once
  per host keyed by their full prefix CHAIN (not just the block's own
  tokens), so the flash crowd's 240-token system prompt lives once per
  host instead of once per in-flight handoff, and a re-handoff of a
  hot prefix ships references instead of bytes.  :func:`stash` moves a
  payload's bytes into the pool (deduplicating); :func:`rehydrate`
  pulls them back out right before the decode-side submit.  A pool
  entry evicted between the two simply truncates the import at the
  first gap — the decode replica prefills the remainder, correctness
  never depends on the pool.

Failure semantics live in ``fleet.py``: a handoff leg that dies
classifies through ``route_transient`` like any other replica failure,
and the request re-enters the queue at the front as a FRESH prefill —
a dead decode replica re-prefills at another prefill replica, with the
frozen ``TraceContext`` riding the retry so ``serve/kv_handoff`` and
``fleet/handoff`` spans stitch into one timeline and
``ttft_decomposition()`` grows a ``handoff`` share.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence, Tuple

#: The replica roles a disaggregated fleet understands.  ``"both"`` is
#: the colocated default — pinned byte-identical to the pre-disagg
#: fleet when every replica carries it.
ROLES = ("prefill", "decode", "both")


def validate_role(role: str) -> str:
    """Typed validation for a replica role (ctor seam for Replica,
    FleetConfig and ServeConfig)."""
    if role not in ROLES:
        raise ValueError(
            f"role must be one of {ROLES}, got {role!r}"
        )
    return role


def serves_prefill(role: str) -> bool:
    """Whether a replica with ``role`` may take a request's prefill leg
    (every NEW request routes to one of these first)."""
    return role in ("prefill", "both")


def serves_decode(role: str) -> bool:
    """Whether a replica with ``role`` may take a request's decode leg
    (handoff-carrying requests route only to these)."""
    return role in ("decode", "both")


def validate_roles(roles: Sequence[str]) -> Tuple[str, ...]:
    """Validate a fleet's per-replica role assignment: every value a
    known role, and — when any differs from ``"both"`` — at least one
    prefill-capable AND one decode-capable entry, else the two-leg
    route could never complete."""
    roles = tuple(validate_role(r) for r in roles)
    if roles and any(r != "both" for r in roles):
        if not any(serves_prefill(r) for r in roles):
            raise ValueError(
                f"roles={roles!r} has no prefill-capable replica "
                "('prefill' or 'both'): new requests could never route"
            )
        if not any(serves_decode(r) for r in roles):
            raise ValueError(
                f"roles={roles!r} has no decode-capable replica "
                "('decode' or 'both'): handoffs could never land"
            )
    return roles


def chain_keys(block_keys: Sequence[Sequence[int]]) -> List[int]:
    """One host-pool key per block, hashing the block's FULL root-down
    prefix chain — two different prompts sharing a block's 16 tokens at
    different depths must never collide, so each key folds in the one
    before it."""
    out: List[int] = []
    previous = 0
    for key in block_keys:
        previous = hash((previous, tuple(int(t) for t in key)))
        out.append(previous)
    return out


def payload_blocks(payload: Optional[dict]) -> int:
    """Number of blocks a handoff payload carries (0 for None/empty —
    the counters' one spelling)."""
    if not payload:
        return 0
    return len(payload.get("keys") or ())


class HostPrefixPool:
    """Shared per-host DRAM store of exported prefix-block bytes.

    One pool per host (the fleet builds one and every same-host replica
    hands off through it): entries are keyed by :func:`chain_keys`
    hashes, LRU-bounded at ``capacity_blocks`` payloads, thread-safe
    (prefill completions land on per-replica scheduler threads).  The
    dedup contract: stashing bytes under a chain key that is already
    resident is a no-op on the stored bytes (same tokens, same KV), so
    a hot system prompt's blocks live ONCE per host however many
    replicas or in-flight requests reference them.
    """

    def __init__(self, capacity_blocks: int = 1024):
        if capacity_blocks < 1:
            raise ValueError(
                f"capacity_blocks must be >= 1, got {capacity_blocks}"
            )
        self.capacity_blocks = capacity_blocks
        self._lock = threading.Lock()
        self._blocks: "collections.OrderedDict[int, object]" = (
            collections.OrderedDict()
        )
        self._stats = {
            "puts": 0, "dedup_hits": 0, "gets": 0, "misses": 0,
            "evictions": 0,
        }

    def put(self, chain_key: int, payload: object) -> bool:
        """Stash one block's bytes; True when the key was already
        resident (the dedup hit — stored bytes untouched, LRU bumped)."""
        with self._lock:
            if chain_key in self._blocks:
                self._blocks.move_to_end(chain_key)
                self._stats["dedup_hits"] += 1
                return True
            self._blocks[chain_key] = payload
            self._stats["puts"] += 1
            while len(self._blocks) > self.capacity_blocks:
                self._blocks.popitem(last=False)
                self._stats["evictions"] += 1
            return False

    def get(self, chain_key: int) -> Optional[object]:
        """One block's bytes, LRU-bumped; None when evicted (the caller
        truncates its import there)."""
        with self._lock:
            payload = self._blocks.get(chain_key)
            if payload is None:
                self._stats["misses"] += 1
                return None
            self._blocks.move_to_end(chain_key)
            self._stats["gets"] += 1
            return payload

    def __len__(self) -> int:
        with self._lock:
            return len(self._blocks)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            snap = dict(self._stats)
            snap["blocks"] = len(self._blocks)
        return snap


def stash(pool: Optional[HostPrefixPool],
          payload: Optional[dict]) -> Optional[dict]:
    """Move an exported payload's block bytes into the host pool,
    returning the slim reference payload that travels with the request
    (bytes replaced by chain keys).  Without a pool the payload passes
    through untouched — bytes ride inline, correct but undeduplicated
    (the engine-level tests' shape)."""
    if not payload or pool is None:
        return payload
    keys = payload.get("keys") or ()
    chain = chain_keys(keys)
    for ck, block_payload in zip(chain, payload.get("payloads") or ()):
        if block_payload is not None:
            pool.put(ck, block_payload)
    slim = dict(payload)
    slim["chain"] = chain
    slim["payloads"] = [None] * len(keys)
    return slim


def rehydrate(pool: Optional[HostPrefixPool],
              payload: Optional[dict]) -> Optional[dict]:
    """Fill a slim payload's bytes back in from the host pool, right
    before the decode-side submit.  A chain key the pool has since
    evicted truncates the payload there — the decode replica seeds the
    surviving head and prefills the rest (the import is an accelerator,
    never a correctness dependency).  Payloads that still carry inline
    bytes (no pool on the export side) pass through untouched."""
    if not payload or pool is None:
        return payload
    chain = payload.get("chain")
    if not chain:
        return payload
    keys = list(payload.get("keys") or ())
    payloads = list(payload.get("payloads") or ())
    filled: List[object] = []
    for i, ck in enumerate(chain):
        block_payload = (
            payloads[i] if i < len(payloads) and payloads[i] is not None
            else pool.get(ck)
        )
        if block_payload is None:
            break
        filled.append(block_payload)
    fat = dict(payload)
    fat["keys"] = keys[:len(filled)]
    fat["chain"] = list(chain[:len(filled)])
    fat["payloads"] = filled
    fat["covered_tokens"] = len(filled) * int(
        payload.get("block_tokens") or 0
    )
    return fat
