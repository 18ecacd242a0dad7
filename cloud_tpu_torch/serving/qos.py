"""Multi-tenant QoS for the serving engine (port of
``cloud_tpu/serving/qos.py``): priority classes, tenant quotas, SLO-aware
slot admission and per-token streaming.

The port's own copy of the reference's module (plain Python, no
framework); the engine's hooks live in ``serving.engine``.  With
``ServeConfig(qos=None)`` the engine is FIFO, priority tags are inert and
nothing here runs.

* **Priority classes** (:class:`PriorityClass`): each named class (default
  ``interactive`` / ``standard`` / ``batch``) carries a fairness
  ``weight`` and a TTFT SLO target ``slo_s``.  Slot admission orders by
  ``(SLO slack, weighted fairness debt)`` (:class:`QosScheduler`):
  earliest-expiring SLO first while slack remains, weighted fair queuing
  once every SLO is blown.
* **Tenant quotas** (:class:`TenantQuota` / :class:`TokenBucket`):
  per-tenant token buckets charged ``prompt + decode budget`` tokens; an
  empty bucket raises :class:`QuotaExceededError`.
* **Brownout shedding**: past ``brownout_queue_depth`` waiting requests,
  the excess is shed lowest-weight class first, newest first within a
  class, with :class:`BrownoutShedError`.
* **Per-token streaming** (:class:`TokenStream`): ``submit(...,
  stream=True)`` returns a stream fed as chunks commit; its ``result()``
  is the final ``ServeResult``, and feeds are idempotent by token index.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, Iterator, List, Mapping, Optional

#: The default class ladder (highest service priority first).  The shed
#: order is the reverse of the WEIGHT order, not this tuple's — a custom
#: class map defines its own ladder through the weights.
DEFAULT_PRIORITIES = ("interactive", "standard", "batch")


class QuotaExceededError(RuntimeError):
    """Typed rejection at submit: the tenant's token bucket cannot cover
    this request's cost right now — retry after the bucket refills, or
    raise the tenant's quota.  Never queued, never routed."""


class BrownoutShedError(RuntimeError):
    """The request was shed under brownout: the waiting set exceeded
    ``QosConfig.brownout_queue_depth`` and this request's class was the
    lowest-weight one still queued.  Permanent by routing
    classification — re-submitting into the same overload amplifies
    it."""


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """One service class: fairness weight + TTFT SLO target.

    ``weight`` is the weighted-fair-queuing share under saturation
    (a weight-4 class gets 4x a weight-1 class's token share once every
    SLO is blown) AND the shed ladder (lowest weight sheds first).
    ``slo_s`` is the time-to-first-token target; admission slack is
    measured against it, so a tighter SLO wins the queue while slack
    remains.
    """

    weight: float = 1.0
    slo_s: float = 1.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.slo_s <= 0:
            raise ValueError(f"slo_s must be > 0, got {self.slo_s}")


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Token-bucket quota for one tenant: sustained ``tokens_per_s``
    refill with a ``burst_tokens`` ceiling.  A request costs its prompt
    length plus its decode budget (the tokens it may make the fleet
    produce), charged at submit."""

    tokens_per_s: float
    burst_tokens: float

    def __post_init__(self):
        if self.tokens_per_s <= 0:
            raise ValueError(
                f"tokens_per_s must be > 0, got {self.tokens_per_s}"
            )
        if self.burst_tokens < 1:
            raise ValueError(
                f"burst_tokens must be >= 1, got {self.burst_tokens}"
            )


def _default_classes() -> Dict[str, PriorityClass]:
    return {
        "interactive": PriorityClass(weight=8.0, slo_s=0.25),
        "standard": PriorityClass(weight=4.0, slo_s=2.0),
        "batch": PriorityClass(weight=1.0, slo_s=30.0),
    }


@dataclasses.dataclass(frozen=True)
class QosConfig:
    """The QoS policy knobs (shared by ``ServeConfig.qos`` and
    ``FleetConfig.qos``; both default ``None`` — FIFO, byte-identical
    to the pre-QoS path).

    ``classes`` maps class name -> :class:`PriorityClass`;
    ``default_priority`` is assigned to requests submitted without one.
    ``quotas`` maps tenant name -> :class:`TenantQuota` (a tenant not
    listed gets ``default_quota``, or no quota when that is ``None`` —
    quotas bind only where they are configured).
    ``brownout_queue_depth`` arms class-aware shedding of the waiting
    set (``None``: never shed for depth; deadlines still shed).
    """

    classes: Mapping[str, PriorityClass] = dataclasses.field(
        default_factory=_default_classes
    )
    default_priority: str = "standard"
    quotas: Mapping[str, TenantQuota] = dataclasses.field(
        default_factory=dict
    )
    default_quota: Optional[TenantQuota] = None
    brownout_queue_depth: Optional[int] = None
    #: Decode-token cost charged (quota AND fairness debt) for a
    #: request that omits ``max_new_tokens``.  The fleet surface cannot
    #: see the engine-side budget such a request resolves to, and an
    #: omitted budget must not read as free — a tenant could otherwise
    #: consume full decode capacity while its bucket only drains by
    #: prompt lengths.  Set it near your engines' ``max_new_tokens``.
    unbudgeted_decode_cost: int = 256

    def __post_init__(self):
        classes = dict(self.classes)
        object.__setattr__(self, "classes", classes)
        if not classes:
            raise ValueError("QosConfig.classes must name at least one "
                             "priority class")
        for name, pc in classes.items():
            if not isinstance(pc, PriorityClass):
                raise ValueError(
                    f"classes[{name!r}] must be a PriorityClass, "
                    f"got {type(pc).__name__}"
                )
        if self.default_priority not in classes:
            raise ValueError(
                f"default_priority {self.default_priority!r} is not a "
                f"configured class (have {sorted(classes)})"
            )
        quotas = dict(self.quotas)
        object.__setattr__(self, "quotas", quotas)
        for tenant, quota in quotas.items():
            if not isinstance(quota, TenantQuota):
                raise ValueError(
                    f"quotas[{tenant!r}] must be a TenantQuota, "
                    f"got {type(quota).__name__}"
                )
        if (self.brownout_queue_depth is not None
                and self.brownout_queue_depth < 1):
            raise ValueError(
                f"brownout_queue_depth must be >= 1 or None, got "
                f"{self.brownout_queue_depth}"
            )
        if self.unbudgeted_decode_cost < 0:
            raise ValueError(
                f"unbudgeted_decode_cost must be >= 0, got "
                f"{self.unbudgeted_decode_cost}"
            )

    def request_cost(self, prompt_len: int,
                     max_new_tokens: Optional[int]) -> int:
        """One request's token cost — prompt plus decode budget — as
        charged against quotas and the fairness debt.  ONE definition
        for both schedulers (engine and fleet), so the WFQ shares and
        the buckets can never disagree on what a request costs."""
        budget = (
            int(max_new_tokens) if max_new_tokens is not None
            else self.unbudgeted_decode_cost
        )
        return int(prompt_len) + budget

    def resolve_priority(self, priority: Optional[str]) -> str:
        """Validate a submitted priority against the class map (typed
        error naming the valid classes), defaulting unset ones."""
        if priority is None:
            return self.default_priority
        if priority not in self.classes:
            raise ValueError(
                f"unknown priority {priority!r}: configured classes are "
                f"{sorted(self.classes)}"
            )
        return priority

    def shed_order(self) -> List[str]:
        """Class names in shed precedence: lowest weight first (ties to
        the later name, so the default ladder sheds batch -> standard ->
        interactive)."""
        return sorted(self.classes, key=lambda c: (
            self.classes[c].weight, c
        ))


def brownout_victims(requests, excess: int,
                     config: QosConfig) -> List[object]:
    """Select which waiting requests a brownout sheds: lowest-weight
    class first, NEWEST arrival first within a class (the requests
    that waited longest keep their place), up to ``excess`` victims.

    ONE definition of the shed order for both schedulers — the engine
    and the fleet each own their queue mechanics (removal, typed
    failure, counters) but must never drift on the policy itself.
    ``requests`` is any iterable of objects with ``.priority`` and
    ``.submitted``.
    """
    if excess <= 0:
        return []
    victims: List[object] = []
    by_class: Dict[str, List[object]] = {}
    for request in requests:
        by_class.setdefault(request.priority, []).append(request)
    for name in config.shed_order():
        if len(victims) >= excess:
            break
        pool = sorted(
            by_class.get(name, ()), key=lambda r: -r.submitted
        )
        victims.extend(pool[:excess - len(victims)])
    return victims


def validate_priority(priority: Optional[str]) -> Optional[str]:
    """Validation for a priority tag submitted WITHOUT a QoS config:
    type-checked only.  The FIFO path records the tag but never
    reorders on it, and it must accept ANY class name — a QoS fleet
    with custom classes legitimately forwards them to replicas whose
    own QoS is off (rejecting there would typed-fail every request of
    a perfectly valid deployment).  Class-NAME validation happens at
    whichever surface has a :class:`QosConfig` armed —
    :meth:`QosConfig.resolve_priority`."""
    if priority is not None and not isinstance(priority, str):
        raise ValueError(
            f"priority must be a class name (str) or None, got "
            f"{type(priority).__name__}"
        )
    return priority


class TokenBucket:
    """Thread-safe token bucket (one per tenant).

    ``try_acquire(n)`` refills by elapsed time x rate (capped at the
    burst ceiling), then takes ``n`` tokens or takes nothing — quota
    charging is all-or-nothing so a partially-charged rejected request
    cannot exist.  ``clock`` is injectable for tests.
    """

    def __init__(self, quota: TenantQuota, clock=time.monotonic):
        self.quota = quota
        self._clock = clock
        self._tokens = float(quota.burst_tokens)
        self._last = clock()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = self._clock()
        elapsed = max(now - self._last, 0.0)
        self._last = now
        self._tokens = min(
            self._tokens + elapsed * self.quota.tokens_per_s,
            float(self.quota.burst_tokens),
        )

    def try_acquire(self, tokens: float) -> bool:
        with self._lock:
            self._refill_locked()
            if tokens > self._tokens:
                return False
            self._tokens -= tokens
            return True

    def credit(self, tokens: float) -> None:
        """Refund tokens (capped at the burst ceiling): a request whose
        charge succeeded but which was then REJECTED before entering
        the queue (admission full, fleet closing) received no service —
        burning its tokens would quota-block the tenant for work the
        fleet refused to do."""
        with self._lock:
            self._refill_locked()
            self._tokens = min(
                self._tokens + tokens, float(self.quota.burst_tokens)
            )

    def available(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens


class QosScheduler:
    """The admission-order policy: pick the waiting request minimizing
    ``(max(SLO slack, 0), weighted fairness debt, arrival)``.

    *Slack* is ``submitted + slo_s - now``: while any request still has
    positive slack, the earliest-expiring SLO is served first (EDF —
    interactive's tight SLO wins the queue under light load).  Once
    slack is exhausted (clamped to 0 — the saturated regime where every
    SLO is blown), the *fairness debt* decides: each class accrues
    virtual service ``tokens / weight`` as its requests are admitted,
    and the class with the least virtual service goes first — weighted
    fair queuing, so a flood cannot starve anyone and weights set the
    shares.  Arrival time is the final tiebreak (FIFO within a class).

    Pure policy: no locks (callers hold their queue lock), no clock of
    its own.  One instance per scheduler (engine or fleet); the debt
    state is the only mutation, via :meth:`charge`.
    """

    def __init__(self, config: QosConfig):
        self.config = config
        self._vservice: Dict[str, float] = {
            name: 0.0 for name in config.classes
        }
        #: Virtual time: the max-ever of min-vservice-over-backlogged
        #: classes.  A class that returns from idleness is lifted to
        #: it (the WFQ start-tag clamp) so it cannot hoard an idle
        #: period as credit and monopolize admission afterwards; a
        #: continuously-backlogged lagging class DEFINES the min, so
        #: the lift never erases debt it is legitimately owed.
        self._vtime = 0.0

    def key(self, priority: str, submitted: float, now: float):
        """The admission sort key for one waiting request (smaller =
        admitted sooner)."""
        pc = self.config.classes[priority]
        slack = submitted + pc.slo_s - now
        return (max(slack, 0.0), self._vservice[priority], submitted)

    def select(self, requests, now: float):
        """The waiting request to admit next — argmin of :meth:`key`
        over ``requests`` (objects with ``.priority``/``.submitted``),
        or None when empty.  ONE selection definition for both
        schedulers (the engine's slot admission and the fleet's queue
        pop own only their removal mechanics), and the place the
        idle-credit clamp runs: classes present in this waiting set
        are lifted to the virtual time before their keys compare."""
        requests = list(requests)
        present = {r.priority for r in requests}
        if present:
            floor = min(self._vservice[name] for name in present)
            if floor > self._vtime:
                self._vtime = floor
            for name in present:
                if self._vservice[name] < self._vtime:
                    self._vservice[name] = self._vtime
        best = None
        best_key = None
        for request in requests:
            key = self.key(request.priority, request.submitted, now)
            if best_key is None or key < best_key:
                best, best_key = request, key
        return best

    def charge(self, priority: str, tokens: int) -> None:
        """Accrue one admitted request's virtual service to its class
        (``tokens`` = prompt + decode budget — the work the admission
        bought)."""
        pc = self.config.classes[priority]
        self._vservice[priority] += tokens / pc.weight

    def virtual_service(self) -> Dict[str, float]:
        return dict(self._vservice)


class TokenStream:
    """Per-token delivery for one request: a thread-safe token list fed
    by the scheduler as emissions commit, plus the final result future.

    Iterating yields token ids as they arrive and returns at
    end-of-generation (raising the request's failure, if any, after the
    tokens already delivered).  ``feed`` is idempotent by token index —
    re-feeding an already-delivered index is a no-op — which is what
    makes a fleet failover's deterministic greedy re-run resume the
    stream instead of duplicating it.  ``result()`` blocks for the same
    final result the non-streamed future resolves with; the streamed
    tokens are a prefix-consistent view of exactly that row.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._tokens: List[int] = []
        self._done = False
        self._exc: Optional[BaseException] = None
        #: Resolves with the final ServeResult (or the typed failure) —
        #: the same object the non-streamed submit future carries.
        self.future: Future = Future()
        #: Fleet-wide trace id when the submit carried a TraceContext
        #: (engine/fleet stamp it at admission); None otherwise.  Lets a
        #: streaming consumer correlate its tokens with the request's
        #: spans in a merged timeline without waiting for the final
        #: ServeResult.
        self.trace_id: Optional[str] = None

    # -- producer side (scheduler / fleet threads) -------------------------

    def feed(self, index: int, token: int) -> None:
        """Deliver the token at emission ``index`` (idempotent: indexes
        at or below what was already delivered are dropped; a gap —
        impossible from the in-order emission path — is dropped too
        rather than delivering out of order)."""
        with self._cond:
            if self._done or index != len(self._tokens):
                return
            self._tokens.append(int(token))
            self._cond.notify_all()

    def _complete_from_future(self, fut: Future) -> None:
        """Done-callback for the request's future: back-fill any tokens
        the incremental path did not deliver (the batch scheduler
        materializes them all at once), then close the stream with the
        same result/exception."""
        try:
            exc = fut.exception()
        except BaseException as cancelled:  # noqa: BLE001 - cancelled
            exc = cancelled
        if exc is None:
            result = fut.result()
            tokens = getattr(result, "tokens", None)
            count = getattr(result, "num_generated", None)
            if tokens is not None and count is not None:
                for i in range(int(count)):
                    self.feed(i, int(tokens[i]))
            with self._cond:
                self._done = True
                self._cond.notify_all()
            try:
                self.future.set_result(result)
            except InvalidStateError:  # pragma: no cover - double close
                pass
            return
        with self._cond:
            self._exc = exc
            self._done = True
            self._cond.notify_all()
        try:
            self.future.set_exception(exc)
        except InvalidStateError:  # pragma: no cover - double close
            pass

    # -- consumer side -----------------------------------------------------

    def __iter__(self) -> Iterator[int]:
        i = 0
        while True:
            with self._cond:
                while i >= len(self._tokens) and not self._done:
                    self._cond.wait()
                if i < len(self._tokens):
                    token = self._tokens[i]
                else:
                    if self._exc is not None:
                        raise self._exc
                    return
            yield token
            i += 1

    def result(self, timeout: Optional[float] = None):
        """The final :class:`~cloud_tpu_torch.serving.ServeResult` (or the
        request's typed failure) — same contract as the plain future."""
        return self.future.result(timeout)

    def tokens_so_far(self) -> List[int]:
        with self._cond:
            return list(self._tokens)

    def done(self) -> bool:
        with self._cond:
            return self._done
