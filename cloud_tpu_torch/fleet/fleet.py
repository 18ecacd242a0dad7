"""Health-aware serving fleet: one submit surface over N engine replicas
(port of ``cloud_tpu/fleet/fleet.py``).

Everything below the fleet tops out at ONE
:class:`~cloud_tpu_torch.serving.ServingEngine` — a single scheduler thread
driving a single decode grid.  Serving heavy traffic needs the thin
layer TF-Replicator argues for over single-device programs (arxiv
1902.00465): replicate the proven unit, then route around its failures.
:class:`Fleet` is that layer, three cooperating pieces over the engine's
typed-error seams:

* **Router** — every :meth:`Fleet.submit` lands in one fleet-level
  queue; a dispatcher thread routes each request to the least-loaded
  ready replica (``queue_depth + active_slots`` from ``health()`` —
  :mod:`cloud_tpu_torch.fleet.router`).  A replica that raises
  :class:`~cloud_tpu_torch.serving.QueueFullError` or went unready fails over
  to the next candidate, bounded by a
  :class:`~cloud_tpu_torch.utils.retries.RetryPolicy` (attempts + backoff);
  per-request ``deadline_s`` is preserved across hops — the remaining
  budget, not the original, reaches the replica — and a request whose
  deadline expires while queued at the fleet is shed with
  :class:`~cloud_tpu_torch.serving.DeadlineExceededError` *before* any
  replica submit.  Failover never re-submits an expired request.
* **Replica supervisor** — a poll loop watches every replica's
  ``health()``; an engine that went unhealthy (watchdog fire, dead or
  crashed scheduler) is killed and rebuilt through the engine factory
  (``fleet.replica_start`` fault seam).  Its admitted requests fail
  with the engine's typed errors, which the fleet's completion
  callbacks convert into re-entry at the *front* of the fleet queue —
  supervision drops nothing, and greedy outputs stay token-identical
  because a re-run request replays the same deterministic decode.
* **Autoscaler** — windowed fleet queue depth and mean slot occupancy
  feed :class:`~cloud_tpu_torch.fleet.autoscaler.QueueDepthAutoscaler`;
  sustained backlog adds replicas up to ``max_replicas``, sustained
  idleness drains them back to ``min_replicas`` — scale-down only ever
  via graceful drain (the retiring replica serves everything it
  admitted).

Observability rides the tracing and metrics surfaces: ``fleet/route``
spans (replica, load, occupancy, attempt), ``fleet/failover`` /
``fleet/restart`` / ``fleet/scale`` / ``fleet/shed`` event spans,
``fleet/*`` counters, and ``fleet/replicas`` / ``fleet/queue_depth`` /
``fleet/occupancy`` gauges; ``python -m
cloud_tpu_torch.monitoring.report`` renders them as a dedicated fleet
section.  ``utils.faults`` seams (``fleet.route``,
``fleet.replica_start``) let a chaos test kill and starve replicas
deterministically.  On one card every replica's engine shares it: each
scheduler thread enqueues on the card's default stream.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Dict, List, Optional

import numpy as np

from cloud_tpu_torch.fleet import disagg
from cloud_tpu_torch.fleet.autoscaler import AutoscaleConfig, QueueDepthAutoscaler
from cloud_tpu_torch.fleet.replica import Replica
from cloud_tpu_torch.fleet.router import LeastLoadedRouter
from cloud_tpu_torch.monitoring import metrics, tracing
from cloud_tpu_torch.serving import prefix_cache
from cloud_tpu_torch.serving.engine import (
    DeadlineExceededError,
    EngineClosedError,
    QueueFullError,
    ServeResult,
)
from cloud_tpu_torch.serving import qos as qos_lib
from cloud_tpu_torch.serving.qos import (
    BrownoutShedError,
    QosConfig,
    QuotaExceededError,
    TokenBucket,
    TokenStream,
)
from cloud_tpu_torch.utils import faults, retries

logger = logging.getLogger(__name__)

#: Leading tokens hashed into a request's router affinity key — ONE
#: spelling shared with the engines' ``cached_prefixes`` summaries
#: (serving.prefix_cache defines it), so the cost-model router's
#: summary lookups and the fleet's request keys can never drift.
#: Replicas tie-break (and, with ``cache_alpha``, score) toward the
#: replica whose prefix cache holds these tokens' KV (router.py).
AFFINITY_PREFIX_TOKENS = prefix_cache.AFFINITY_PREFIX_TOKENS

#: Fleet-owned threads (prefix-matched by the leak guards, same family
#: as the serving engine's ``cloud-tpu-serve-*`` names).
FLEET_ROUTER_THREAD_NAME = "cloud-tpu-fleet-router"
FLEET_SUPERVISOR_THREAD_NAME = "cloud-tpu-fleet-supervisor"
FLEET_DRAIN_THREAD_NAME = "cloud-tpu-fleet-drain"


class FleetClosedError(RuntimeError):
    """The fleet is closed (or closing): the request was not admitted."""


class NoReplicaAvailableError(RuntimeError):
    """No routable replica right now (all restarting, draining, or
    excluded) — transient by classification: the route policy backs off
    and retries while the supervisor restores capacity."""


def default_route_policy(**overrides) -> retries.RetryPolicy:
    """The routing/failover budget: enough attempts with short backoff
    to ride out one replica restart, bounded so a truly dead fleet
    sheds load typed instead of queueing forever."""
    args = dict(
        max_attempts=8, initial_backoff_s=0.05, max_backoff_s=1.0,
        classify=route_transient,
    )
    args.update(overrides)
    return retries.RetryPolicy(**args)


def route_transient(exc: BaseException) -> bool:
    """Failover classification for routing and completion failures.

    Permanent: an expired deadline (shed, never re-submitted), a closed
    fleet, caller errors (bad prompt shape / budget — a retry would
    fail identically), and the QoS verdicts — an exceeded quota or a
    brownout shed (re-submitting into the same overload amplifies it).
    Everything else — queue-full, a replica that closed or crashed
    mid-request, a watchdogged dispatch, an injected chaos fault — is
    the replica's failure, not the request's, and the request deserves
    another candidate.
    """
    return not isinstance(
        exc, (DeadlineExceededError, FleetClosedError, ValueError,
              TypeError, QuotaExceededError, BrownoutShedError),
    )


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet knobs: sizing bounds, admission, routing, supervision.

    ``min_replicas`` engines are built at construction;
    the autoscaler moves the count within ``[min_replicas,
    max_replicas]``.  ``max_queue``/``admission`` are the fleet-level
    backpressure contract (same semantics as ``ServeConfig``'s — the
    engine-level queues stay as the per-replica backstop).
    ``route_policy`` bounds failover: attempts, backoff, and the
    transient classification; ``poll_interval_s`` paces the supervisor
    (jittered ±20% so many fleets never poll in lockstep).
    """

    min_replicas: int = 1
    max_replicas: Optional[int] = None  # None: min_replicas (fixed size)
    max_queue: int = 1024
    admission: str = "block"
    route_policy: Optional[retries.RetryPolicy] = None
    poll_interval_s: float = 0.2
    #: Bound on any graceful drain (scale-down, restart close, close()).
    drain_timeout_s: float = 60.0
    #: Autoscaler thresholds; ``min/max_replicas`` above are authoritative
    #: (they overwrite the ones in a user-supplied AutoscaleConfig).
    autoscale: Optional[AutoscaleConfig] = None
    #: Multi-tenant QoS at the fleet surface: per-tenant token-bucket
    #: quotas enforced at ``submit()`` (typed ``QuotaExceededError``),
    #: fleet-queue ordering by (SLO slack, weighted fairness debt)
    #: instead of arrival order, class-aware brownout shedding, and the
    #: per-class backlog signal for the router/autoscaler.  ``None``
    #: (default) keeps the FIFO fleet byte-identical (per-class keys
    #: read zero).  Independent of the engines' own ``ServeConfig.qos``
    #: — arm both for end-to-end class ordering.
    qos: Optional[QosConfig] = None
    #: Disaggregated prefill/decode roles, one per initial replica id
    #: (``fleet.disagg`` module docstring).  ``None`` (default) — and a
    #: tuple of all ``"both"`` — keep the colocated fleet byte-identical:
    #: no handoff legs are ever built.  With any ``"prefill"``/
    #: ``"decode"`` entry, new requests route to prefill-capable
    #: replicas; a prefill-ONLY replica serves the first token, exports
    #: its prompt KV blocks, and the request re-enters the queue as a
    #: decode leg routed to a decode-capable replica.  Replicas beyond
    #: the tuple (autoscaler scale-ups) default to ``"both"``.
    roles: Optional[tuple] = None
    #: Capacity (blocks) of the shared per-host DRAM pool deduplicating
    #: handoff payload bytes across replicas (only built when ``roles``
    #: arms disaggregation).
    host_pool_blocks: int = 1024

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas is None:
            object.__setattr__(self, "max_replicas", self.min_replicas)
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})"
            )
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.admission not in ("block", "reject"):
            raise ValueError(
                f"admission must be 'block' or 'reject', "
                f"got {self.admission!r}"
            )
        if self.poll_interval_s <= 0:
            raise ValueError("poll_interval_s must be > 0")
        if self.qos is not None and not isinstance(self.qos, QosConfig):
            raise ValueError(
                f"qos must be a serving.qos.QosConfig, got "
                f"{type(self.qos).__name__}"
            )
        if self.roles is not None:
            object.__setattr__(
                self, "roles", disagg.validate_roles(self.roles)
            )
        if self.host_pool_blocks < 1:
            raise ValueError(
                f"host_pool_blocks must be >= 1, "
                f"got {self.host_pool_blocks}"
            )
        base = self.autoscale or AutoscaleConfig()
        object.__setattr__(self, "autoscale", dataclasses.replace(
            base, min_replicas=self.min_replicas,
            max_replicas=self.max_replicas,
        ))


#: eq=False: requests are removed from mid-queue by IDENTITY (QoS
#: admission, brownout shed) — a generated __eq__ would compare numpy
#: prompt arrays element-wise and raise on the first non-match.
@dataclasses.dataclass(eq=False)
class _FleetRequest:
    prompt: np.ndarray
    max_new_tokens: Optional[int]
    future: Future
    submitted: float  # perf_counter
    deadline: Optional[float] = None
    #: Replica submits accepted so far (attempt N+1 is failover N).
    attempts: int = 0
    #: Hash of the prompt's leading tokens — the router's
    #: prefix-affinity tie-break key (ignored by routers without one).
    affinity_key: Optional[int] = None
    #: QoS class (resolved at submit when FleetConfig.qos is armed;
    #: carried-but-inert otherwise) and the submitting tenant.
    priority: Optional[str] = None
    tenant: Optional[str] = None
    #: Per-token stream (``submit(stream=True)``): fed by the serving
    #: replica through an ``on_token`` forward (idempotent by index, so
    #: a failover's deterministic re-run resumes it), closed by the
    #: fleet future's done-callback.
    stream: Optional[TokenStream] = None
    #: Fairness debt charged (at the first pop): a failover re-entry is
    #: popped again but must not charge its class a second time for
    #: service it never received.
    charged: bool = False
    #: Trace context minted at submit while tracing is enabled (None
    #: otherwise — inert).  Lives on the REQUEST, not the attempt: a
    #: failover re-admission carries the same identity, which is what
    #: lets report.py stitch a request's hops across replicas.
    trace: Optional[tracing.TraceContext] = None
    #: Disaggregated-serving phase marker: None = prefill phase (route
    #: like any new request); a payload dict = decode leg — the prefill
    #: replica's exported KV blocks travel here (slimmed through the
    #: host pool) and the router offers the request only to
    #: decode-capable replicas.  A decode-leg failure RESETS this to
    #: None: a dead decode replica re-prefills at another prefill
    #: replica.
    handoff: Optional[dict] = None
    #: Replica id that served the prefill leg (span attribution only).
    prefill_replica: Optional[int] = None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline

    def remaining(self, now: float) -> Optional[float]:
        return None if self.deadline is None else self.deadline - now

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace.trace_id if self.trace is not None else None


def _trace_attrs(request: "_FleetRequest", **attrs) -> dict:
    """Span attributes + the request's ``trace_id`` when it carries a
    trace context (untraced requests keep the exact attrs passed in)."""
    if request.trace is not None:
        attrs["trace_id"] = request.trace.trace_id
    return attrs


class Fleet:
    """N supervised replicas behind one ``submit()`` (module docstring).

    ``engine_factory`` is any zero-arg callable returning a started
    engine (``submit``/``health``/``close`` — duck-typed; production
    passes a lambda over :class:`~cloud_tpu_torch.serving.ServingEngine`).
    Every replica — initial, restarted, or scaled up — comes from the
    same factory, which is what makes failover output-invisible: any
    replica serves any request identically.
    """

    def __init__(
        self,
        engine_factory: Callable[[], object],
        config: Optional[FleetConfig] = None,
        *,
        router: Optional[LeastLoadedRouter] = None,
        start: bool = True,
    ):
        import inspect

        self.config = config or FleetConfig()
        self._factory = engine_factory
        self._router = router or LeastLoadedRouter()
        # Custom routers predating the prefix-affinity tie-break (or the
        # QoS-aware priority hint) keep their two-argument pick();
        # probe the signature once.
        try:
            pick_params = inspect.signature(
                self._router.pick
            ).parameters
        except (TypeError, ValueError):  # pragma: no cover - exotic pick
            pick_params = {}
        self._pick_takes_affinity = "affinity_key" in pick_params
        self._pick_takes_priority = "priority" in pick_params
        self._pick_takes_role = "role" in pick_params
        #: Disaggregation armed: any configured role differs from
        #: "both".  Off (the default) keeps every routing and submit
        #: path byte-identical to the colocated fleet.
        self._roles = self.config.roles
        self._disagg = bool(
            self._roles and any(r != "both" for r in self._roles)
        )
        #: Shared per-host DRAM pool deduplicating handoff payload
        #: bytes across replicas (None without disaggregation).
        self._host_pool = (
            disagg.HostPrefixPool(self.config.host_pool_blocks)
            if self._disagg else None
        )
        self._route_policy = (
            self.config.route_policy
            if self.config.route_policy is not None
            else default_route_policy()
        )
        self._autoscaler = QueueDepthAutoscaler(self.config.autoscale)
        #: QoS state (None keeps the FIFO fleet byte-identical): the
        #: admission-order policy, the per-tenant token buckets (built
        #: lazily so unlisted tenants under a default_quota get one on
        #: first submit), and per-class counters for health()/stats().
        self._qos = self.config.qos
        self._qos_sched = (
            qos_lib.QosScheduler(self._qos) if self._qos else None
        )
        self._buckets: Dict[str, TokenBucket] = {}
        self._buckets_lock = threading.Lock()
        classes = (
            tuple(self._qos.classes) if self._qos
            else qos_lib.DEFAULT_PRIORITIES
        )
        self._class_names = classes
        self._class_completed = {c: 0 for c in classes}
        self._class_shed = {c: 0 for c in classes}

        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._in_flight = 0
        self._closed = False
        self._draining = True
        self._replicas: List[Replica] = []
        self._next_replica_id = 0
        self._router_thread: Optional[threading.Thread] = None
        self._supervisor_thread: Optional[threading.Thread] = None
        #: Scale-down drain helpers (joined by close(); the supervisor
        #: must keep polling health while a victim finishes decoding).
        self._drainers: List[threading.Thread] = []
        self._stop = threading.Event()

        self._stats_lock = threading.Lock()
        self._stats = {
            "submitted": 0, "completed": 0, "failed": 0, "rejected": 0,
            "shed": 0, "failovers": 0, "restarts": 0,
            "scale_ups": 0, "scale_downs": 0,
            # QoS counters (0 unless FleetConfig.qos arms them).
            "quota_rejected": 0, "brownout_shed": 0,
            # Requests submitted carrying a TraceContext (0 with
            # tracing off — stable schema either way).
            "traced": 0,
            # Disaggregated serving (0 with roles off — stable schema):
            # prefill->decode handoffs completed, and decode-leg
            # failures that reset a request to re-prefill.
            "handoffs": 0, "handoff_failovers": 0,
        }
        self._routed: Dict[int, int] = {}

        try:
            for _ in range(self.config.min_replicas):
                self._new_replica()  # factory failure here IS a
                # constructor failure: a fleet that cannot build its
                # minimum capacity must not pretend to be up...
        except BaseException:
            # ...but the replicas already built own live engine threads
            # and no Fleet object will exist to close() them.
            for replica in self._replicas:
                try:
                    replica.close(drain=False)
                except Exception:  # noqa: BLE001 — best-effort unwind
                    logger.exception(
                        "closing replica %d during failed construction",
                        replica.id,
                    )
            raise
        metrics.gauge_set("fleet/replicas", len(self._replicas))
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Fleet":
        """Launch the router + supervisor threads (idempotent)."""
        with self._cond:
            if self._closed:
                raise FleetClosedError("fleet already closed")
            if self._router_thread is not None:
                return self
            self._router_thread = threading.Thread(
                target=self._router_loop, daemon=True,
                name=FLEET_ROUTER_THREAD_NAME,
            )
            self._supervisor_thread = threading.Thread(
                target=self._supervisor_loop, daemon=True,
                name=FLEET_SUPERVISOR_THREAD_NAME,
            )
            self._router_thread.start()
            self._supervisor_thread.start()
        return self

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop the fleet: no more admissions, resolve what is owed.

        ``drain=True`` (default) serves every admitted request — the
        supervisor stays up through the drain so a replica dying
        mid-drain is still restarted and its requests still fail over —
        then retires every replica gracefully.  ``drain=False`` fails
        the fleet queue immediately and closes replicas without drain
        (their owed requests fail typed).  After return the fleet owns
        zero live threads (the same hygiene contract as the engine).
        """
        with self._cond:
            self._closed = True
            self._draining = drain
            # A never-started fleet has no router to drain through: fail
            # what waits rather than wait on a thread that never ran.
            if not drain or self._router_thread is None:
                self._fail_queue_locked(
                    FleetClosedError("fleet closed before dispatch")
                )
            self._cond.notify_all()
        deadline = None if timeout is None else time.monotonic() + timeout
        if drain:
            # Wait for the router (and failover re-entries) to finish
            # the owed work before tearing supervision down.
            timed_out = False
            with self._cond:
                while self._queue or self._in_flight:
                    remaining = (
                        None if deadline is None
                        else deadline - time.monotonic()
                    )
                    if remaining is not None and remaining <= 0:
                        timed_out = True
                        break
                    self._cond.wait(
                        0.5 if remaining is None else min(remaining, 0.5)
                    )
            if timed_out:
                # The drain budget is spent: fall back to the hard path
                # for whatever is left — fail it typed NOW so the router
                # can observe empty+idle and exit, rather than return
                # with a live thread and futures that resolve later.
                drain = False
                with self._cond:
                    self._draining = False  # stop failover re-entries
                    self._fail_queue_locked(FleetClosedError(
                        f"fleet close(drain=True) timed out after "
                        f"{timeout}s"
                    ))
                    self._cond.notify_all()
        if not drain:
            # Replicas first: failing their owed requests is what lets
            # the router observe in_flight drain to zero and exit.
            for replica in self.replicas():
                self._close_replica(replica, drain=False, deadline=deadline)
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for thread in (self._supervisor_thread, self._router_thread):
            if thread is not None:
                thread.join(
                    None if deadline is None
                    else max(deadline - time.monotonic(), 0.1)
                )
        if drain:
            for replica in self.replicas():
                self._close_replica(replica, drain=True, deadline=deadline)
        for drainer in list(self._drainers):
            drainer.join(
                None if deadline is None
                else max(deadline - time.monotonic(), 0.1)
            )
        metrics.gauge_set("fleet/replicas", 0)

    def _close_replica(self, replica: Replica, *, drain: bool,
                       deadline: Optional[float]) -> None:
        remaining = (
            self.config.drain_timeout_s if deadline is None
            else max(deadline - time.monotonic(), 0.1)
        )
        try:
            replica.close(drain=drain, timeout=remaining)
        except Exception:  # noqa: BLE001 — teardown must visit them all
            logger.exception("closing replica %d failed", replica.id)

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- submission --------------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None,
               priority: Optional[str] = None,
               tenant: Optional[str] = None,
               stream: bool = False) -> Future:
        """Enqueue one prompt; returns a Future of the replica's result
        (a :class:`~cloud_tpu_torch.serving.ServeResult` for real engines,
        with ``latency_seconds`` AND ``ttft_seconds`` re-based to the
        *fleet* submit time), or a
        :class:`~cloud_tpu_torch.serving.qos.TokenStream` with ``stream=True``
        — fed per token by the serving replica, failover-transparent
        (a re-run's deterministic greedy tokens resume the stream
        without duplicates).

        Same surface as ``ServingEngine.submit``: ``deadline_s`` bounds
        the total queue wait — fleet queue plus replica queue; the
        remaining budget travels with the request across failover hops,
        and an expired request is shed typed, never served late.
        Thread-safe; blocks or raises :class:`QueueFullError` at
        ``max_queue`` per the admission policy.

        With ``FleetConfig.qos`` armed, ``priority`` names the
        request's class (default ``qos.default_priority``) and
        ``tenant`` is charged the request's token cost — prompt plus
        decode budget — against its token-bucket quota, rejecting with
        :class:`~cloud_tpu_torch.serving.QuotaExceededError` BEFORE the
        request costs anyone else queue position.
        """
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if self._qos is not None:
            priority = self._qos.resolve_priority(priority)
        else:
            priority = qos_lib.validate_priority(priority)
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(
                f"prompt must be 1-D token ids, got shape {prompt.shape}"
            )
        bucket = None
        cost = 0
        if self._qos is not None and tenant is not None:
            # One cost definition (qos.request_cost) for quota and
            # fairness both: prompt + decode budget, with an omitted
            # budget charged at unbudgeted_decode_cost — never free.
            cost = self._qos.request_cost(
                int(prompt.shape[0]), max_new_tokens
            )
            bucket = self._tenant_bucket(tenant)
            if bucket is not None and not bucket.try_acquire(cost):
                with self._stats_lock:
                    self._stats["quota_rejected"] += 1
                metrics.counter_inc("fleet/quota_rejected")
                raise QuotaExceededError(
                    f"tenant {tenant!r} quota exhausted: request costs "
                    f"{cost} tokens, {bucket.available():.0f} available "
                    f"(refill {bucket.quota.tokens_per_s}/s, burst "
                    f"{bucket.quota.burst_tokens})"
                )
        submitted = time.perf_counter()
        token_stream = TokenStream() if stream else None
        request = _FleetRequest(
            prompt=prompt, max_new_tokens=max_new_tokens, future=Future(),
            submitted=submitted,
            deadline=(
                None if deadline_s is None else submitted + deadline_s
            ),
            affinity_key=prefix_cache.affinity_key(prompt),
            priority=priority, tenant=tenant, stream=token_stream,
            trace=tracing.new_trace_context(),
        )
        if token_stream is not None:
            token_stream.trace_id = request.trace_id
            # Every fleet resolution path goes through the future; the
            # callback closes the stream with the re-based result (or
            # the typed failure) and back-fills undelivered tokens.
            request.future.add_done_callback(
                token_stream._complete_from_future
            )
        cfg = self.config
        try:
            with self._cond:
                if self._closed:
                    raise FleetClosedError("fleet is closed")
                if len(self._queue) >= cfg.max_queue:
                    if cfg.admission == "reject":
                        with self._stats_lock:
                            self._stats["rejected"] += 1
                        metrics.counter_inc("fleet/rejected")
                        raise QueueFullError(
                            f"fleet queue full ({cfg.max_queue} waiting); "
                            "retry with backoff or raise "
                            "max_queue/max_replicas"
                        )
                    while (len(self._queue) >= cfg.max_queue
                           and not self._closed):
                        self._cond.wait()
                    if self._closed:
                        raise FleetClosedError(
                            "fleet closed while blocked on admission"
                        )
                self._queue.append(request)
                self._cond.notify_all()
        except (QueueFullError, FleetClosedError):
            # The request never entered the queue: refund its quota
            # charge — burning tokens on work the fleet refused would
            # quota-block the tenant for service it never received.
            if bucket is not None:
                bucket.credit(cost)
            raise
        with self._stats_lock:
            self._stats["submitted"] += 1
            if request.trace is not None:
                self._stats["traced"] += 1
        metrics.counter_inc("fleet/requests")
        return token_stream if token_stream is not None else request.future

    def _tenant_bucket(self, tenant: str) -> Optional[TokenBucket]:
        """The tenant's token bucket (lazily built; ``None`` when the
        tenant has no configured quota and there is no default)."""
        with self._buckets_lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                quota = self._qos.quotas.get(
                    tenant, self._qos.default_quota
                )
                if quota is None:
                    return None
                bucket = self._buckets[tenant] = TokenBucket(quota)
            return bucket

    # -- router ------------------------------------------------------------

    def _router_loop(self) -> None:
        try:
            while True:
                with self._cond:
                    request = None
                    while True:
                        now = time.perf_counter()
                        self._shed_expired_locked(now)
                        if self._qos_sched is not None:
                            self._shed_brownout_locked(now)
                        if self._queue:
                            request = self._pop_request_locked(now)
                            # In flight from the POP: a draining close()
                            # waits on queue+in_flight, and a request
                            # mid-routing belongs to neither otherwise.
                            self._in_flight += 1
                            self._cond.notify_all()  # admission space
                            break
                        if self._closed and not self._in_flight:
                            return
                        deadline = self._earliest_deadline_locked()
                        self._cond.wait(
                            None if deadline is None
                            else max(deadline - now, 1e-4)
                        )
                self._route(request)
        except BaseException as exc:  # noqa: BLE001 — the dispatcher must
            # not die silently: refuse new work and fail what waits.
            logger.exception("fleet router crashed")
            with self._cond:
                self._closed = True
                self._fail_queue_locked(exc)
                self._cond.notify_all()

    def _earliest_deadline_locked(self) -> Optional[float]:
        deadlines = [
            r.deadline for r in self._queue if r.deadline is not None
        ]
        return min(deadlines) if deadlines else None

    def _pop_request_locked(self, now: float) -> _FleetRequest:
        """Take the next request to route (caller holds the lock and
        guarantees a non-empty queue): FIFO without QoS — byte-identical
        to the pre-QoS fleet — else the (SLO slack, weighted fairness
        debt) order over the whole fleet queue, charged to the class's
        fairness debt at the pop."""
        if self._qos_sched is None:
            return self._queue.popleft()
        best = self._qos_sched.select(self._queue, now)
        self._queue.remove(best)
        if not best.charged:
            # Same cost definition as the quota (qos.request_cost), and
            # charged ONCE — a failover re-entry already paid.
            best.charged = True
            self._qos_sched.charge(
                best.priority,
                self._qos.request_cost(
                    int(best.prompt.shape[0]), best.max_new_tokens
                ),
            )
        return best

    def _shed_brownout_locked(self, now: float) -> int:
        """Fleet-level class-aware brownout (caller holds the lock;
        no-op unless ``qos.brownout_queue_depth`` is armed): while the
        fleet queue exceeds the depth, shed the LOWEST-weight class
        first, newest first within a class, typed
        :class:`BrownoutShedError` — batch sheds before interactive."""
        if (self._qos is None
                or self._qos.brownout_queue_depth is None
                or len(self._queue) <= self._qos.brownout_queue_depth):
            return 0
        excess = len(self._queue) - self._qos.brownout_queue_depth
        # ONE shed-order definition for both schedulers (qos_lib owns
        # the policy; this method owns the fleet's queue mechanics).
        victims = qos_lib.brownout_victims(self._queue, excess, self._qos)
        shed = 0
        for request in victims:
            self._queue.remove(request)
            shed += 1
            tracing.record_span(
                "fleet/shed", request.submitted, now,
                **_trace_attrs(request, reason="brownout",
                               priority=request.priority),
            )
            self._resolve(request, exc=BrownoutShedError(
                f"request shed under brownout: fleet queue exceeded "
                f"brownout_queue_depth="
                f"{self._qos.brownout_queue_depth} and "
                f"{request.priority!r} is the lowest class still queued"
            ), shed=True)
            with self._stats_lock:
                self._stats["brownout_shed"] += 1
        if shed:
            metrics.counter_inc("fleet/brownout_shed", shed)
            self._cond.notify_all()
        return shed

    def _shed_expired_locked(self, now: float) -> int:
        """Fleet-level deadline shedding: an expired request leaves the
        queue with a typed failure BEFORE any replica submit (caller
        holds the lock)."""
        if not any(r.expired(now) for r in self._queue):
            return 0
        kept: collections.deque = collections.deque()
        shed = 0
        while self._queue:
            request = self._queue.popleft()
            if not request.expired(now):
                kept.append(request)
                continue
            shed += 1
            tracing.record_span(
                "fleet/shed", request.submitted, now,
                **_trace_attrs(request, reason="deadline"),
            )
            self._resolve(request, exc=DeadlineExceededError(
                f"request shed at the fleet after waiting "
                f"{now - request.submitted:.3f}s; deadline_s="
                f"{request.deadline - request.submitted:.3f}"
            ), shed=True)
        self._queue.extend(kept)
        if shed:
            metrics.counter_inc("fleet/shed", shed)
            self._cond.notify_all()
        return shed

    def _route(self, request: _FleetRequest) -> None:
        """One routing pass: pick -> submit, failing over across
        candidates under the route policy; on success, hook the replica
        future back into the fleet."""
        tried: set = set()
        route_start = time.perf_counter()

        def attempt():
            now = time.perf_counter()
            if request.expired(now):
                # Permanent by classification: shed, never submitted.
                tracing.record_span(
                    "fleet/shed", request.submitted, now,
                    **_trace_attrs(request, reason="deadline"),
                )
                metrics.counter_inc("fleet/shed")
                raise DeadlineExceededError(
                    f"request expired before reaching a replica "
                    f"({now - request.submitted:.3f}s in the fleet)"
                )
            faults.fault_point("fleet.route")
            with self._cond:
                if self._closed and not self._draining:
                    raise FleetClosedError("fleet closed during routing")
                candidates = list(self._replicas)
            pick_kwargs = {}
            if self._pick_takes_affinity:
                pick_kwargs["affinity_key"] = request.affinity_key
            if self._pick_takes_priority and request.priority is not None:
                pick_kwargs["priority"] = request.priority
            if self._disagg and self._pick_takes_role:
                # Leg-aware candidate filter: a decode leg (handoff
                # payload attached) only lands on decode-capable
                # replicas; everything else routes prefill-capable.
                pick_kwargs["role"] = (
                    "decode" if request.handoff is not None else "prefill"
                )
            replica, health = self._router.pick(
                candidates, exclude=tried, **pick_kwargs
            )
            if replica is None:
                tried.clear()  # widen the next pass: a restarted or
                # previously-full replica deserves a fresh look.
                raise NoReplicaAvailableError(
                    "no routable replica (restarting/draining/unhealthy)"
                )
            remaining = request.remaining(time.perf_counter())
            if remaining is not None and remaining <= 0:
                raise DeadlineExceededError(
                    "request expired while routing"
                )
            # Priority and the stream's per-token forward ride along
            # only when set, so duck-typed engines predating the QoS
            # kwargs keep working on the plain path.  The stream feed
            # is idempotent by index: a failover re-run's deterministic
            # greedy tokens resume it without duplicates.
            extra = {}
            if request.priority is not None:
                extra["priority"] = request.priority
            if request.stream is not None:
                extra["on_token"] = request.stream.feed
            if request.trace is not None and replica.accepts_trace:
                # The trace context hops with the request — same object
                # on every failover re-submit — but only to engines
                # whose submit() takes it (the replica probes the
                # signature at start(), same idiom as the router-pick
                # probes above).
                extra["trace"] = request.trace
            # Disaggregated legs.  A prefill-ONLY replica serves just
            # the first token and exports the prompt KV (two_leg); a
            # "both" replica picked in a disagg fleet serves colocated
            # — one leg, no handoff — and a decode leg carries the
            # rehydrated payload in.  All of this is keyed off the
            # roles config: a colocated fleet never enters here.
            two_leg = False
            budget = request.max_new_tokens
            if self._disagg and replica.accepts_handoff:
                if request.handoff is not None:
                    extra["handoff"] = disagg.rehydrate(
                        self._host_pool, request.handoff
                    )
                elif (
                    health.get("role")
                    or getattr(replica, "role", "both")
                ) == "prefill":
                    two_leg = True
                    budget = 1
                    extra["handoff_export"] = True
                    # The stream feeds only from the decode leg: the
                    # prefill leg's first token is re-derived there
                    # (greedy decode is deterministic), and feeding it
                    # twice would be harmless-but-wasteful; feeding it
                    # from a leg that then dies would not be.
                    extra.pop("on_token", None)
            try:
                inner = replica.engine.submit(
                    request.prompt,
                    max_new_tokens=budget,
                    deadline_s=remaining,
                    **extra,
                )
            except (QueueFullError, EngineClosedError) as exc:
                # This candidate is out; fail over to the next one.
                tried.add(replica.id)
                self._record_failover(request, replica, exc)
                raise
            return replica, health, inner, two_leg

        try:
            replica, health, inner, two_leg = self._route_policy.call(
                attempt, name="fleet.route", classify=route_transient,
            )
        except BaseException as exc:  # noqa: BLE001 — classified above
            with self._cond:
                self._in_flight -= 1
                self._cond.notify_all()
            shed = isinstance(exc, DeadlineExceededError)
            self._resolve(request, exc=exc, shed=shed)
            return
        request.attempts += 1
        # Affinity follows the replica that actually ACCEPTED the
        # request (a QueueFull failover must not re-stick a hot prefix
        # to its cold fallback replica).
        record = getattr(self._router, "record_affinity", None)
        if record is not None:
            record(request.affinity_key, replica.id)
        now = time.perf_counter()
        span_attrs = {
            "replica": replica.id,
            "load": Replica.load_of(health),
            "attempt": request.attempts,
        }
        if request.priority is not None:
            span_attrs["priority"] = request.priority
        if two_leg or request.handoff is not None:
            span_attrs["leg"] = "prefill" if two_leg else "decode"
        occupancy = Replica.occupancy_of(health)
        if occupancy is not None:
            span_attrs["occupancy"] = round(occupancy, 4)
        if request.trace is not None:
            span_attrs["trace_id"] = request.trace.trace_id
            if request.attempts == 1:
                # Pure fleet queue wait (submit -> this route pass) —
                # only meaningful on the FIRST accepted attempt; a
                # re-route's gap includes the failed service time.
                # report.py's TTFT decomposition reads it.
                span_attrs["queue_s"] = round(
                    route_start - request.submitted, 6
                )
            cached = getattr(self._router, "last_pick_cached_tokens", 0)
            if cached:
                # Cache-aware routing credit that won this pick — lets
                # the TTFT drill-down show WHY a replica was chosen.
                span_attrs["cached_tokens"] = int(cached)
        tracing.record_span("fleet/route", route_start, now, **span_attrs)
        metrics.counter_inc("fleet/routed")
        with self._stats_lock:
            self._routed[replica.id] = self._routed.get(replica.id, 0) + 1
        if two_leg:
            inner.add_done_callback(
                lambda f, req=request, rep=replica: self._on_prefill_done(
                    req, rep, f
                )
            )
        else:
            inner.add_done_callback(
                lambda f, req=request, rep=replica: self._on_replica_done(
                    req, rep, f
                )
            )

    def _record_failover(self, request: _FleetRequest, replica: Replica,
                         exc: BaseException) -> None:
        now = time.perf_counter()
        tracing.record_span(
            "fleet/failover", now, now,
            **_trace_attrs(request, replica=replica.id,
                           error=type(exc).__name__,
                           attempt=request.attempts),
        )
        metrics.counter_inc("fleet/failovers")
        with self._stats_lock:
            self._stats["failovers"] += 1

    def _on_prefill_done(self, request: _FleetRequest, replica: Replica,
                         inner: Future) -> None:
        """Completion hook for a disaggregated PREFILL leg (runs on the
        prefill replica's resolving thread): on success the exported KV
        payload is stashed into the host pool (bytes deduplicated
        per host) and the request re-enters the fleet queue at the
        FRONT as a decode leg; any failure classifies exactly like a
        colocated replica failure — the request re-prefills elsewhere
        under the same failover budget (``_on_replica_done`` owns that
        path, and ``request.handoff`` is still None, so the retry IS a
        fresh prefill)."""
        if inner.exception() is not None:
            self._on_replica_done(request, replica, inner)
            return
        result = inner.result()
        payload = (
            result.handoff if isinstance(result, ServeResult) else None
        )
        if payload is None:
            # Engine served the leg but exported nothing (prefix cache
            # races are not errors): an EMPTY payload still flips the
            # request into its decode leg — the decode replica simply
            # runs a cold prefill.
            payload = {
                "version": 1, "block_tokens": 0, "covered_tokens": 0,
                "keys": [], "payloads": [],
            }
        start = time.perf_counter()
        request.handoff = disagg.stash(self._host_pool, payload)
        request.prefill_replica = replica.id
        tracing.record_span(
            "fleet/handoff", start, time.perf_counter(),
            **_trace_attrs(request, replica=replica.id,
                           blocks=disagg.payload_blocks(payload)),
        )
        metrics.counter_inc("fleet/handoffs")
        with self._stats_lock:
            self._stats["handoffs"] += 1
        with self._cond:
            self._in_flight -= 1
            if self._closed and not self._draining:
                self._cond.notify_all()
                self._resolve(request, exc=FleetClosedError(
                    "fleet closed between prefill and decode legs"
                ))
                return
            # Front of the queue: the request already waited its turn
            # (same re-entry contract as failover, minus the failure).
            self._queue.appendleft(request)
            self._cond.notify_all()

    def _on_replica_done(self, request: _FleetRequest, replica: Replica,
                         inner: Future) -> None:
        """Completion hook (runs on the replica's resolving thread):
        success propagates; a replica-side failure re-enters the fleet
        queue unless the deadline or the failover budget says stop.

        The in-flight decrement and any re-entry happen under ONE lock
        acquisition: a draining ``close()`` waits for "queue empty and
        nothing in flight", and a gap between the two would let it start
        tearing replicas down with a failover re-entry still landing.
        """
        exc = inner.exception()
        now = time.perf_counter()
        requeue = False
        if exc is not None and not isinstance(exc, DeadlineExceededError):
            requeue = (
                not request.expired(now)
                and route_transient(exc)
                and request.attempts < self._route_policy.max_attempts
            )
        with self._cond:
            self._in_flight -= 1
            if requeue and not (self._closed and not self._draining):
                self._record_failover(request, replica, exc)
                if request.handoff is not None:
                    # A dead DECODE leg re-prefills at another prefill
                    # replica: the seeded blocks died with the decode
                    # replica's pool, so the payload is void — reset to
                    # the prefill phase (the frozen trace context rides
                    # the retry, stitching both passes).
                    request.handoff = None
                    metrics.counter_inc("fleet/handoff_failovers")
                    with self._stats_lock:
                        self._stats["handoff_failovers"] += 1
                # Front of the queue: the request already waited its
                # turn once.
                self._queue.appendleft(request)
                self._cond.notify_all()
                return
            self._cond.notify_all()
        if exc is None:
            result = inner.result()
            if isinstance(result, ServeResult):
                # Latency the caller actually saw: fleet submit -> done
                # (includes fleet queueing, routing, and any failover).
                # TTFT re-bases the same way: the engine measured
                # engine-submit -> first token, so the first-token
                # instant is ``done - (latency - ttft)`` and the fleet
                # TTFT adds the fleet queueing/routing in front of it —
                # the number the QoS classes' SLOs are judged by.
                fleet_latency = time.perf_counter() - request.submitted
                result = dataclasses.replace(
                    result,
                    latency_seconds=fleet_latency,
                    ttft_seconds=max(
                        fleet_latency - (
                            result.latency_seconds - result.ttft_seconds
                        ),
                        0.0,
                    ),
                    # Backfill for engines whose submit() predates the
                    # trace kwarg: the fleet still owns the identity.
                    trace_id=result.trace_id or request.trace_id,
                )
            self._resolve(request, result=result)
            return
        if isinstance(exc, (DeadlineExceededError, BrownoutShedError)):
            # The replica shed it: the deadline/brownout verdict stands
            # (re-submitting a brownout shed into the same overload
            # would amplify it).
            if isinstance(exc, BrownoutShedError):
                with self._stats_lock:
                    self._stats["brownout_shed"] += 1
            self._resolve(request, exc=exc, shed=True)
            return
        if request.expired(now):
            # Failover never re-submits an expired request.
            self._resolve(request, exc=DeadlineExceededError(
                f"request expired during failover (replica {replica.id} "
                f"failed with {type(exc).__name__}: {exc})"
            ), shed=True)
            return
        self._resolve(request, exc=exc)

    def _resolve(self, request: _FleetRequest, *, result=None,
                 exc: Optional[BaseException] = None,
                 shed: bool = False) -> None:
        try:
            if exc is None:
                request.future.set_result(result)
            else:
                request.future.set_exception(exc)
        except InvalidStateError:  # pragma: no cover - caller cancelled
            return
        with self._stats_lock:
            if exc is None:
                self._stats["completed"] += 1
            elif shed:
                self._stats["shed"] += 1
            else:
                self._stats["failed"] += 1
            if self._qos is not None and request.priority is not None:
                if exc is None:
                    self._class_completed[request.priority] += 1
                elif shed:
                    self._class_shed[request.priority] += 1
        if exc is None:
            metrics.counter_inc("fleet/completed")
        elif not shed:
            metrics.counter_inc("fleet/failed")

    def _fail_queue_locked(self, exc: BaseException) -> None:
        while self._queue:
            self._resolve(self._queue.popleft(), exc=exc)

    # -- supervisor --------------------------------------------------------

    def _supervisor_loop(self) -> None:
        interval = self.config.poll_interval_s
        while not self._stop.wait(retries.jittered(interval)):
            try:
                self._supervise_once()
            except Exception:  # noqa: BLE001 — supervision must outlive
                # any single bad poll.
                logger.exception("fleet supervisor iteration failed")

    def _supervise_once(self) -> None:
        with self._cond:
            replicas = list(self._replicas)
            queue_depth = len(self._queue)
            class_backlog = self._class_backlog_locked()
        ready = 0
        busy_slots = 0
        total_slots = 0
        dram_blocks = 0
        dram_demotions = 0
        for replica in replicas:
            health = replica.health()
            # Tiered-prefix-cache FOOTPRINT (not load): host memory a
            # replica's DRAM pool holds is held whether or not the
            # replica is currently routable — a draining replica's
            # engine keeps its pool until the drain completes, and the
            # capacity gauge must say so.  Accumulated before the
            # routable branch below for exactly that reason (zeros
            # when the tier is off everywhere, and for engineless
            # replicas via the health stub).
            dram_blocks += int(health.get("prefix_dram_blocks") or 0)
            dram_demotions += int(
                health.get("prefix_dram_demotions") or 0
            )
            if replica.state == "ready" and not (
                health.get("healthy") and health.get("live")
            ):
                self._restart_replica(
                    replica, reason=health.get("reason") or "scheduler dead"
                )
                health = replica.health()
            if replica.state == "dead":
                # A start/restart that failed earlier: keep trying at
                # poll cadence until the factory succeeds again.
                try:
                    replica.start()
                    health = replica.health()
                except Exception:  # noqa: BLE001
                    logger.exception(
                        "replica %d start retry failed", replica.id
                    )
            if replica.routable(health):
                ready += 1
                busy_slots += int(health.get("active_slots") or 0)
                total_slots += int(health.get("num_slots") or 0)
                # The backlog the autoscaler sizes against is EVERYTHING
                # still waiting, wherever it waits: block-admission
                # replicas absorb the fleet queue into their own, and a
                # signal that only watched the fleet queue would read a
                # saturated fleet as idle.
                queue_depth += int(health.get("queue_depth") or 0)
                # Same totality for the per-class signal: a QoS engine's
                # own queue carries classes the fleet queue already
                # drained into it.
                for name, count in (
                    health.get("class_backlog") or {}
                ).items():
                    if name in class_backlog:
                        class_backlog[name] += int(count or 0)
        occupancy = busy_slots / total_slots if total_slots else 0.0
        metrics.gauge_set("fleet/replicas", len(replicas))
        metrics.gauge_set("fleet/queue_depth", queue_depth)
        metrics.gauge_set("fleet/occupancy", occupancy)
        metrics.gauge_set("fleet/prefix_dram_blocks", dram_blocks)
        metrics.gauge_set("fleet/prefix_dram_demotions", dram_demotions)
        if self._qos is not None:
            for name, count in class_backlog.items():
                metrics.gauge_set(f"fleet/class_{name}_backlog", count)
        if self._closed:
            return  # draining: capacity is frozen, only health matters
        decision = self._autoscaler.observe(
            queue_depth=queue_depth, ready_replicas=ready,
            occupancy=occupancy,
            class_backlog=class_backlog if self._qos is not None else None,
        )
        if decision == "up":
            self._scale_up()
        elif decision == "down":
            self._scale_down()

    def _restart_replica(self, replica: Replica, *, reason: str) -> None:
        logger.warning(
            "fleet: restarting unhealthy replica %d (%s)", replica.id,
            reason,
        )
        start = time.perf_counter()
        try:
            replica.restart(close_timeout=self.config.drain_timeout_s)
        except Exception:  # noqa: BLE001 — retried next poll (state dead)
            logger.exception("replica %d restart failed", replica.id)
        tracing.record_span(
            "fleet/restart", start, time.perf_counter(),
            replica=replica.id, reason=reason[:200],
        )
        metrics.counter_inc("fleet/restarts")
        with self._stats_lock:
            self._stats["restarts"] += 1

    def _new_replica(self, counter: Optional[str] = None) -> Replica:
        """A replica added to the routing set; ``counter`` names the
        stat that counts it, bumped in the same critical section, so a
        reader who sees the replica sees it counted."""
        with self._cond:
            rid = self._next_replica_id
            self._next_replica_id += 1
        # Configured roles map by replica id; scale-ups beyond the
        # tuple default to "both" (they can serve either leg).
        role = "both"
        if self._roles is not None and rid < len(self._roles):
            role = self._roles[rid]
        replica = Replica(rid, self._factory, role=role)
        with self._cond:
            self._replicas.append(replica)
            if counter is not None:
                with self._stats_lock:
                    self._stats[counter] += 1
            self._cond.notify_all()
        return replica

    def _scale_up(self) -> None:
        with self._cond:
            # The autoscaler's bound is on READY replicas (its load
            # signal), but the sizing contract is on replicas that
            # exist: a dead-but-owned replica still counts against
            # max_replicas — its start retry would otherwise overshoot
            # the bound once it succeeds.
            if len(self._replicas) >= self.config.max_replicas:
                return
        start = time.perf_counter()
        try:
            replica = self._new_replica(counter="scale_ups")
        except Exception:  # noqa: BLE001 — a failed scale-up is a missed
            # opportunity, not a fleet failure; the window re-fires.
            logger.exception("fleet scale-up failed")
            return
        count = len(self.replicas())
        tracing.record_span(
            "fleet/scale", start, time.perf_counter(), direction="up",
            replica=replica.id, replicas=count,
        )
        metrics.counter_inc("fleet/scale_up")
        metrics.gauge_set("fleet/replicas", count)
        logger.info("fleet: scaled up to %d replicas", count)

    def _scale_down(self) -> None:
        """Retire the least-loaded ready replica via graceful drain:
        removed from the routing set FIRST (no new work), then
        ``close(drain=True)`` serves everything it already admitted.

        The drain itself runs on a short-lived helper thread (joined by
        ``close()``): a victim may take up to ``drain_timeout_s`` to
        finish decoding, and the supervisor must keep polling health —
        a replica watchdogged DURING the drain window still needs its
        restart on the next poll, not after the drain.
        """
        with self._cond:
            if len(self._replicas) <= self.config.min_replicas:
                return
            candidates = [r for r in self._replicas if r.state == "ready"]
        # pick() reads engine health (the engine's own lock) — done
        # OUTSIDE the fleet lock; engine threads resolve futures while
        # holding theirs and our completion hook takes ours.
        victim, _ = self._router.pick(candidates)
        with self._cond:
            if (
                victim is None
                or victim not in self._replicas
                or len(self._replicas) <= self.config.min_replicas
            ):
                return
            self._replicas.remove(victim)
            # Counted with the removal: a reader who sees the smaller
            # set sees the scale-down.
            with self._stats_lock:
                self._stats["scale_downs"] += 1
        start = time.perf_counter()

        def drain_victim():
            self._close_replica(victim, drain=True, deadline=None)
            tracing.record_span(
                "fleet/scale", start, time.perf_counter(),
                direction="down", replica=victim.id,
                replicas=len(self.replicas()),
            )

        drainer = threading.Thread(
            target=drain_victim, daemon=True,
            name=FLEET_DRAIN_THREAD_NAME,
        )
        self._drainers.append(drainer)
        drainer.start()
        count = len(self.replicas())
        metrics.counter_inc("fleet/scale_down")
        metrics.gauge_set("fleet/replicas", count)
        logger.info(
            "fleet: draining replica %d out, %d remain", victim.id, count
        )

    # -- introspection -----------------------------------------------------

    def replicas(self) -> List[Replica]:
        with self._cond:
            return list(self._replicas)

    def num_replicas(self) -> int:
        with self._cond:
            return len(self._replicas)

    def wait_ready(self, timeout: Optional[float] = None) -> None:
        """Block until every current replica's engine finished its AOT
        warmup (no-op for engines without ``wait_ready``)."""
        for replica in self.replicas():
            engine = replica.engine
            if engine is not None and hasattr(engine, "wait_ready"):
                engine.wait_ready(timeout=timeout)

    def health(self) -> dict:
        """Fleet-level snapshot: aggregate readiness plus one entry per
        replica (each the engine's own ``health()`` stamped with
        replica id and state) — the shape a fleet /healthz serves."""
        with self._cond:
            queue_depth = len(self._queue)
            in_flight = self._in_flight
            closed = self._closed
            replicas = list(self._replicas)
            class_backlog = self._class_backlog_locked()
        snapshots = [r.health() for r in replicas]
        for snap in snapshots:
            for name, count in (snap.get("class_backlog") or {}).items():
                if name in class_backlog:
                    class_backlog[name] += int(count or 0)
        ready = sum(
            1 for r, h in zip(replicas, snapshots) if r.routable(h)
        )
        return {
            "ready": not closed and ready > 0,
            "closed": closed,
            "replicas": snapshots,
            "num_replicas": len(replicas),
            "ready_replicas": ready,
            # The fleet composes SLICES, not chips: each replica's
            # health carries its slice_shape/slice_chips (1 per chip-
            # replica, tp*sp for a sharded slice), and this is their
            # sum — the fleet's hardware footprint.  Router load math
            # is deliberately unchanged: load stays queued + in-flight
            # requests per replica, whatever its slice width.
            "total_chips": sum(
                int(h.get("slice_chips") or 0) for h in snapshots
            ),
            "queue_depth": queue_depth,
            "in_flight": in_flight,
            # Per-class backlog — fleet queue plus every ready
            # replica's own (QoS engines carry theirs in health()).
            # All-zeros when QoS is off — stable schema.
            "class_backlog": class_backlog,
        }

    def _class_backlog_locked(self) -> Dict[str, int]:
        """Fleet-queue requests per QoS class (caller holds ``_cond``).
        Zeros for every class when QoS is off."""
        backlog = {name: 0 for name in self._class_names}
        if self._qos is not None:
            for request in self._queue:
                backlog[request.priority] += 1
        return backlog

    def stats(self) -> dict:
        """Counters snapshot plus per-replica routed counts (replica id
        -> requests routed there, restarts included in identity)."""
        with self._stats_lock:
            snap = dict(self._stats)
            snap["routed"] = dict(self._routed)
            # Per-class service accounting (zeros when QoS is off).
            snap["class_completed"] = dict(self._class_completed)
            snap["class_shed"] = dict(self._class_shed)
        snap["replicas"] = self.num_replicas()
        # Shared host-DRAM prefix pool (zeros when disaggregation is
        # off — stable schema).
        snap["host_pool"] = (
            self._host_pool.stats() if self._host_pool is not None
            else {"puts": 0, "dedup_hits": 0, "gets": 0, "misses": 0,
                  "evictions": 0, "blocks": 0}
        )
        return snap

    def dump_timeline(self, path: str) -> str:
        """Write ONE merged Chrome-trace JSON for the whole fleet.

        Every replica's spans land in their own labelled ``pid`` lane
        (the lane its engine's scheduler adopted at ``Replica.start``)
        and the fleet's own spans — routing, failover, shed — plus any
        events no replica lane claimed (engine construction, warmup
        compiles) land in the ``fleet`` lane, so a single Perfetto view
        shows a request bouncing between replicas.  Today all lanes
        share one in-process collector, so their epochs coincide; the
        merge still goes through :func:`tracing.merge_timelines`'s
        monotonic-offset normalization so per-process collectors
        (disaggregated prefill/decode, multi-host pods) drop in without
        changing this file format.  Empty-but-valid JSON when tracing
        is off.
        """
        collector = tracing.active()
        snap = collector.snapshot() if collector is not None else {
            "epoch": 0.0, "events": [], "evicted": 0,
        }
        lanes = []  # (lane pid, label), fleet's default lane first
        with self._cond:
            replicas = list(self._replicas)
        for replica in replicas:
            lane = getattr(replica, "trace_lane", None)
            if lane is not None:
                lanes.append((lane, f"replica {replica.id}"))
        by_lane: Dict[int, List[dict]] = {lane: [] for lane, _ in lanes}
        fleet_events: List[dict] = []
        for event in snap["events"]:
            bucket = by_lane.get(event.get("pid"))
            (bucket if bucket is not None else fleet_events).append(event)
        sources = [{
            "label": "fleet",
            "epoch": snap["epoch"],
            "events": fleet_events,
            # The ring buffer is shared: account its evictions once,
            # on the fleet source.
            "evicted": snap["evicted"],
            "pid": os.getpid(),
        }]
        sources += [
            {
                "label": label,
                "epoch": snap["epoch"],
                "events": by_lane[lane],
                "pid": lane,
            }
            for lane, label in lanes
        ]
        return tracing.merge_timelines(sources, path)
