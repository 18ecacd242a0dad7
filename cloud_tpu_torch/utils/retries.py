"""Unified retry/backoff (port of ``cloud_tpu/utils/retries.py``): one
policy object for every transient seam.

The classification -- *which* failures are worth retrying -- and the
pacing -- jittered exponential backoff under max-attempts AND max-elapsed
budgets, honoring ``retry_after`` hints -- live in one :class:`RetryPolicy`:

    policy = RetryPolicy(max_attempts=4, initial_backoff_s=0.5)
    node = policy.call(lambda: session.get(url), name="node_poll")

Classification is typed, not string-matched: an
:class:`~cloud_tpu_torch.utils.api_client.ApiTransientError` (429/5xx,
connection resets, timeouts) retries, as do raw ``TimeoutError`` /
``ConnectionError``; a permanent ``ApiError`` (4xx) or any other exception
fails fast.  Override with ``classify=`` for seams with their own notion
of transient (the fleet's ``route_transient``).

Observability: every retried call lands a ``retry/<name>`` span carrying
``attempts`` and ``outcome`` attributes, plus ``retry/attempts`` /
``retry/retries`` / ``retry/giveups`` counters.

Jitter is *full jitter* (uniform in [0, backoff]), with an injectable
``rng`` so tests are deterministic; ``sleep`` is injectable so they are
instant.
"""

from __future__ import annotations

import functools
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, TypeVar

from cloud_tpu_torch.monitoring import metrics, tracing

logger = logging.getLogger(__name__)

T = TypeVar("T")


def default_classify(exc: BaseException) -> bool:
    """Transient iff typed so: ``api_client.ApiTransientError`` (the
    session wraps 429/5xx and transport failures into it) or an injected
    one (``faults.InjectedTransientError``), plus raw ``TimeoutError`` /
    ``ConnectionError`` from callers below the session layer; a permanent
    ``ApiError`` (or ``faults.InjectedApiError``) fails fast."""
    from cloud_tpu_torch.utils import api_client, faults

    if isinstance(exc, (api_client.ApiTransientError,
                        faults.InjectedTransientError)):
        return True
    if isinstance(exc, (api_client.ApiError, faults.InjectedApiError)):
        return False
    return isinstance(exc, (ConnectionError, TimeoutError))


@dataclass
class RetryPolicy:
    """Jittered-exponential-backoff retry with attempt + elapsed budgets.

    ``max_attempts`` counts total calls (1 = no retries).
    ``max_elapsed_s`` bounds submit-to-give-up wall clock: once the
    budget is spent no further attempt starts (a server ``Retry-After``
    pointing beyond the budget gives up immediately rather than sleep
    past it).  A transient error's ``retry_after`` attribute (seconds)
    overrides the computed backoff when larger — the server knows its
    own load shedding better than our curve does.
    """

    max_attempts: int = 4
    initial_backoff_s: float = 0.5
    max_backoff_s: float = 30.0
    multiplier: float = 2.0
    max_elapsed_s: Optional[float] = None
    classify: Callable[[BaseException], bool] = field(
        default=default_classify
    )
    jitter: bool = True
    sleep: Callable[[float], None] = field(default=time.sleep)
    rng: random.Random = field(default_factory=random.Random)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.initial_backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff seconds must be >= 0")

    def backoff_s(self, attempt: int) -> float:
        """Backoff before attempt ``attempt + 1`` (0-based failures)."""
        raw = min(
            self.initial_backoff_s * (self.multiplier ** attempt),
            self.max_backoff_s,
        )
        if not self.jitter:
            return raw
        return self.rng.uniform(0.0, raw)  # full jitter

    def call(self, fn: Callable[[], T], *, name: str = "call",
             on_retry: Optional[Callable[[BaseException, int], None]] = None,
             classify: Optional[Callable[[BaseException], bool]] = None,
             ) -> T:
        """Run ``fn`` under the policy; returns its result or re-raises.

        Raises the LAST error when the budget runs out or immediately on
        a permanent (non-transient) failure.  ``on_retry(exc, attempt)``
        fires before each backoff sleep (attempt is the 1-based failed
        attempt) — e.g. to log which poll is struggling.
        ``classify`` narrows the policy's classifier for THIS call (the
        session passes one that refuses to re-send a non-idempotent
        request after an ambiguous transport failure).
        """
        classify = classify if classify is not None else self.classify
        start = time.perf_counter()
        attempts = 0
        outcome = "ok"
        try:
            while True:
                attempts += 1
                metrics.counter_inc("retry/attempts")
                try:
                    return fn()
                except BaseException as exc:  # noqa: BLE001 — classified
                    if not classify(exc):
                        outcome = "permanent"
                        raise
                    if attempts >= self.max_attempts:
                        outcome = "gave_up"
                        metrics.counter_inc("retry/giveups")
                        raise
                    backoff = self.backoff_s(attempts - 1)
                    retry_after = getattr(exc, "retry_after", None)
                    if retry_after is not None:
                        backoff = max(backoff, float(retry_after))
                    if self.max_elapsed_s is not None:
                        elapsed = time.perf_counter() - start
                        if elapsed + backoff > self.max_elapsed_s:
                            outcome = "gave_up"
                            metrics.counter_inc("retry/giveups")
                            raise
                    metrics.counter_inc("retry/retries")
                    if on_retry is not None:
                        on_retry(exc, attempts)
                    logger.warning(
                        "transient failure in %s (attempt %d/%d): %s; "
                        "retrying in %.2fs", name, attempts,
                        self.max_attempts, exc, backoff,
                    )
                    self.sleep(backoff)
        finally:
            end = time.perf_counter()
            # One span per POLICY call (not per attempt): the robustness
            # report reads attempts/outcome off the attributes.  Only
            # recorded when a retry or failure happened — a first-try
            # success is the boring common case and would drown the rest.
            if attempts > 1 or outcome != "ok":
                tracing.record_span(
                    f"retry/{name}", start, end,
                    attempts=attempts, outcome=outcome,
                )

    def wrap(self, fn: Callable[..., T], *, name: Optional[str] = None
             ) -> Callable[..., T]:
        """``policy.wrap(session.get)`` -> a callable with retries baked
        in (same signature)."""
        label = name or getattr(fn, "__name__", "call")

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(lambda: fn(*args, **kwargs), name=label)

        return wrapped


#: Session-level default: absorbs short API blips (a few seconds) without
#: masking a real outage from the caller's own (coarser) retry layer.
DEFAULT_API_POLICY_ARGS = dict(
    max_attempts=4, initial_backoff_s=0.5, max_backoff_s=8.0,
    max_elapsed_s=60.0,
)


def default_api_policy(**overrides) -> RetryPolicy:
    """A fresh session-grade policy (own rng, so no cross-session lock-step)."""
    args = dict(DEFAULT_API_POLICY_ARGS)
    args.update(overrides)
    return RetryPolicy(**args)


def jittered(seconds: float, *, fraction: float = 0.2,
             rng: Optional[random.Random] = None) -> float:
    """A poll interval de-synchronized across processes: uniform in
    ``[seconds * (1 - fraction), seconds * (1 + fraction)]``.

    Recreated multi-node jobs boot near-simultaneously; fixed-interval
    polls from every host then hit the API in lockstep forever.  ±20%
    spreads them out while keeping budgets (attempts x interval)
    meaningful.
    """
    rng = rng if rng is not None else random
    return seconds * rng.uniform(1.0 - fraction, 1.0 + fraction)
