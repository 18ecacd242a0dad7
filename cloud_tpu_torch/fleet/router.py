"""Replica selection: route each request to the least-loaded replica
(port of ``cloud_tpu/fleet/router.py``).

The router is a pure policy object — no threads, no locks of its own.
The fleet's dispatcher calls :meth:`LeastLoadedRouter.pick` once per
routing attempt with a snapshot of the replica list; the router reads
each candidate's ``health()`` (a cheap, lock-bounded snapshot — the
``queue_depth``/``active_slots`` fields exist exactly so this does not
have to reach into ``stats()``) and returns the routable replica with
the smallest load signal::

    load = queue_depth + active_slots

Queue depth is work promised, active slots work in progress; their sum
is the number of requests ahead of a new arrival, which under identical
replicas is proportional to its expected wait.  Ties break toward the
lowest replica id, so a cold fleet fills deterministically — unless
**prefix affinity** is on (``LeastLoadedRouter(prefix_affinity=True)``):
then a tie breaks toward the replica that last served the same prompt
prefix, so a hot prefix's KV blocks concentrate on replicas that
already cache them (each engine's prefix cache is per-replica; spraying
a shared system prompt across the fleet re-prefills it everywhere).
Affinity NEVER overrides load — it only picks among equals — so the
balancing contract is unchanged.

``exclude`` carries the ids already tried during the current failover
pass — a replica that just raised ``QueueFullError`` must not be picked
again until every other candidate had its chance (the fleet clears the
set once it round-robins through everyone).

**Cache-aware cost model** (``cache_alpha > 0``): replicas export a
cached-prefix summary in ``health()`` (``cached_prefixes``: affinity
key -> cached prefix tokens, from the prefix trie's hot roots — both
tiers, since a host-DRAM-demoted prefix still serves via swap-in), and
the router scores each candidate as::

    score = load - cache_alpha * expected_cached_prefix_tokens

where the expectation is the candidate summary's entry for THIS
request's ``affinity_key`` (0 when absent).  Unlike the tie-break,
this is a real cost model: a replica that caches a long enough prefix
wins even against a less-loaded cold one, because the prefill compute
a hit skips is worth ``alpha`` load units per token.  ``alpha``
calibrates that trade; 0 (the default) disables the
term entirely — byte-identical to the load-plus-tie-break contract.
The summary is LIVE (re-read from ``health()`` per decision), so a
restarted replica's empty cache stops attracting traffic immediately —
the ``record_affinity`` LRU map can go stale across a failover, which
is why it remains a tie-break only and never outranks the score.
The class-weight discount composes: ``load`` above is already the
QoS-discounted signal when ``class_weights`` is armed.

**QoS-aware load** (``class_weights=...``): a QoS fleet's replicas run
priority schedulers, so a deep *batch* backlog delays an arriving
*interactive* request far less than the raw queue depth suggests — the
engine will admit the interactive request past it.  With a class-weight
map (normally ``{name: cls.weight for ...}`` from the fleet's
``QosConfig``), the load signal discounts backlog BELOW the arriving
request's class by the weight ratio::

    load = active_slots + sum_c backlog_c * min(1, w_c / w_request)

Same-or-higher classes count in full (they genuinely queue ahead).
Replicas without a per-class backlog in ``health()``, requests without
a priority, and routers without the map all fall back to the plain
``queue + active`` signal — the default contract is unchanged.
"""

from __future__ import annotations

import collections
from typing import Iterable, Mapping, Optional, Tuple

from cloud_tpu_torch.fleet.replica import Replica


class LeastLoadedRouter:
    """Pick the ready replica with the smallest ``queue + active`` load.

    ``prefix_affinity=True`` enables the tie-break memory: up to
    ``affinity_capacity`` prefix keys map to the replica that last won
    them (LRU-bounded — the map must not grow with unique-traffic
    volume).  The fleet passes each request's ``affinity_key`` (a hash
    of its leading tokens) through :meth:`pick`; callers that pass
    ``None`` get the plain lowest-id tie-break.  ``class_weights``
    arms the QoS-aware load discount and ``cache_alpha`` the
    cache-aware cost model (module docstring) — both compose with the
    affinity tie-break, which only ever picks among score-equals.
    """

    def __init__(self, prefix_affinity: bool = False,
                 affinity_capacity: int = 1024,
                 class_weights: Optional[Mapping[str, float]] = None,
                 cache_alpha: float = 0.0):
        if affinity_capacity < 1:
            raise ValueError(
                f"affinity_capacity must be >= 1, got {affinity_capacity}"
            )
        if cache_alpha < 0:
            raise ValueError(
                f"cache_alpha must be >= 0, got {cache_alpha}"
            )
        self._cache_alpha = float(cache_alpha)
        #: Cached prefix tokens credited to the LAST pick's winner (0
        #: without the cost model or on a cold pick).  The fleet stamps
        #: it on the traced ``fleet/route`` span so a TTFT drill-down
        #: shows whether cache-aware routing — not just load — chose
        #: the replica.  Read on the fleet's single router thread, same
        #: as every other pick-path access.
        self.last_pick_cached_tokens = 0
        self._affinity: Optional[collections.OrderedDict] = (
            collections.OrderedDict() if prefix_affinity else None
        )
        self._affinity_capacity = affinity_capacity
        if class_weights is not None:
            class_weights = dict(class_weights)
            for name, weight in class_weights.items():
                if weight <= 0:
                    raise ValueError(
                        f"class_weights[{name!r}] must be > 0, "
                        f"got {weight}"
                    )
        self._class_weights = class_weights

    def _load_for(self, health: dict,
                  priority: Optional[str]) -> float:
        """The candidate's load as seen by THIS request: plain
        ``queue + active`` unless the QoS discount applies."""
        weights = self._class_weights
        backlog = health.get("class_backlog")
        if (weights is None or priority is None
                or priority not in weights or not backlog):
            return float(Replica.load_of(health))
        w_req = weights[priority]
        classed = 0
        load = float(int(health.get("active_slots") or 0))
        for name, count in backlog.items():
            count = int(count or 0)
            classed += count
            load += count * min(1.0, weights.get(name, w_req) / w_req)
        # Queue depth beyond the classed backlog (a replica whose own
        # QoS is off reports zeros): count it in full.
        load += max(int(health.get("queue_depth") or 0) - classed, 0)
        return load

    def _score_for(self, health: dict, priority: Optional[str],
                   affinity_key: Optional[int]) -> float:
        """The candidate's routing cost for THIS request: the (QoS-
        discounted) load minus the cache-awareness credit (module
        docstring).  With ``cache_alpha == 0`` this IS the load."""
        score = self._load_for(health, priority)
        if self._cache_alpha and affinity_key is not None:
            summary = health.get("cached_prefixes") or {}
            score -= self._cache_alpha * int(
                summary.get(affinity_key) or 0
            )
        return score

    def pick(self, replicas: Iterable[Replica],
             exclude: Iterable[int] = (),
             affinity_key: Optional[int] = None,
             priority: Optional[str] = None,
             role: Optional[str] = None,
             ) -> Tuple[Optional[Replica], Optional[dict]]:
        """Return ``(replica, its health snapshot)`` or ``(None, None)``
        when no routable candidate exists (all excluded, draining,
        restarting, or unhealthy).

        ``role`` restricts candidates to replicas serving that
        disaggregated leg — ``"prefill"`` admits prefill-capable
        replicas (role ``"prefill"`` or ``"both"``), ``"decode"``
        decode-capable ones.  ``None`` (the default — and the colocated
        fleet's only spelling) considers every replica, byte-identical
        to the pre-disagg contract.  The filter reads the live
        ``health()`` role (the same snapshot the load signal comes
        from), falling back to the replica's assigned role."""
        from cloud_tpu_torch.fleet import disagg

        excluded = set(exclude)
        self.last_pick_cached_tokens = 0
        tied: list = []  # (replica, health) rows at the best score
        best_score: Optional[float] = None
        for replica in replicas:
            if replica.id in excluded:
                continue
            health = replica.health()
            if not replica.routable(health):
                continue
            if role is not None:
                served = health.get("role") or getattr(
                    replica, "role", "both"
                )
                if role == "prefill" and not disagg.serves_prefill(served):
                    continue
                if role == "decode" and not disagg.serves_decode(served):
                    continue
            score = self._score_for(health, priority, affinity_key)
            if best_score is None or score < best_score:
                tied = [(replica, health)]
                best_score = score
            elif score == best_score:
                tied.append((replica, health))
        if not tied:
            return None, None
        best, best_health = min(tied, key=lambda row: row[0].id)
        if (self._affinity is not None and affinity_key is not None
                and len(tied) > 1):
            preferred = self._affinity.get(affinity_key)
            if preferred is not None:
                for replica, health in tied:
                    if replica.id == preferred:
                        best, best_health = replica, health
                        break
        if self._cache_alpha and affinity_key is not None:
            self.last_pick_cached_tokens = int(
                (best_health.get("cached_prefixes") or {}).get(
                    affinity_key
                ) or 0
            )
        return best, best_health

    def record_affinity(self, affinity_key: Optional[int],
                        replica_id: int) -> None:
        """Remember that ``replica_id`` actually SERVED ``affinity_key``
        (LRU-bounded).  Called by the fleet after a successful submit —
        not from :meth:`pick` — so a candidate that rejected the request
        (QueueFull failover to a cold replica) does not steal the
        prefix's affinity from the replica whose cache still holds its
        KV.  No-op without ``prefix_affinity`` or without a key."""
        if self._affinity is None or affinity_key is None:
            return
        self._affinity[affinity_key] = replica_id
        self._affinity.move_to_end(affinity_key)
        while len(self._affinity) > self._affinity_capacity:
            self._affinity.popitem(last=False)
