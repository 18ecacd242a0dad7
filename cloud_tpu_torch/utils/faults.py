"""Deterministic fault injection (port of ``cloud_tpu/utils/faults.py``).

The seams where a device or a service can fail each carry a named
:func:`fault_point`; a test activates a :class:`FaultPlan` against those
names:

    plan = [{"site": "serve.chunk", "mode": "hang", "hang_s": 3.0,
             "nth": 1}]
    with faults.inject(plan):
        engine.submit(prompt)   # the first decode chunk hangs for 3 s;
                                # the dispatch watchdog must fail it

Triggers are deterministic: ``nth`` (fire on exactly the nth call of that
site, 1-based), ``every`` (every k-th call), ``times`` (stop after n
firings; default 1 for ``nth``, unbounded for ``every``).  Modes:

``raise``
    Raise at the seam.  ``error`` picks the class: ``"transient"`` an
    :class:`InjectedTransientError` (status 503, the retryable class),
    ``"api"`` an :class:`InjectedApiError` (status 400), anything else (or
    omitted) a plain :class:`FaultInjected`.
``hang``
    Sleep ``hang_s`` seconds at the seam (default 30): a finite stand-in
    for a wedged dispatch.
``corrupt``
    Make ``fault_point(site, result=x)`` return the rule's ``value``
    (default ``None``) instead of ``x``.

:func:`inject` also exports the plan as ``CLOUD_TPU_FAULT_PLAN`` (JSON),
and :func:`maybe_install_from_env` installs it in a child process.  Call
counters are per process.  With no plan installed a seam costs one
``is None`` check.

The port's copy keeps the reference's plan format, triggers and modes;
``"transient"`` and ``"api"`` raise the two classes below, with the
``status`` of the API session's errors (``utils/api_client.py``), and the
retry layer classifies them as it classifies those
(``retries.default_classify``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

#: JSON fault plan, exported by :func:`inject` for child processes.
ENV_FAULT_PLAN = "CLOUD_TPU_FAULT_PLAN"

_VALID_MODES = ("raise", "hang", "corrupt")


class FaultInjected(RuntimeError):
    """The default injected failure (mode="raise" with no error class)."""


class InjectedApiError(FaultInjected):
    """An injected permanent API failure (``error: "api"``)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class InjectedTransientError(InjectedApiError):
    """An injected retryable API failure (``error: "transient"``)."""


class _Rule:
    """One compiled plan entry; owns its own firing bookkeeping."""

    __slots__ = ("site", "mode", "nth", "every", "times", "hang_s",
                 "error", "value", "fired")

    def __init__(self, spec: Dict[str, Any]):
        unknown = set(spec) - {
            "site", "mode", "nth", "every", "times", "hang_s", "error",
            "value",
        }
        if unknown:
            raise ValueError(f"unknown fault-rule keys {sorted(unknown)}")
        self.site = spec.get("site")
        if not self.site or not isinstance(self.site, str):
            raise ValueError(f"fault rule needs a string 'site': {spec}")
        self.mode = spec.get("mode", "raise")
        if self.mode not in _VALID_MODES:
            raise ValueError(
                f"fault mode must be one of {_VALID_MODES}, "
                f"got {self.mode!r}"
            )
        self.nth = spec.get("nth")
        self.every = spec.get("every")
        if self.nth is not None and self.every is not None:
            raise ValueError("fault rule takes 'nth' OR 'every', not both")
        for name in ("nth", "every"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(f"'{name}' must be a positive int, got {v!r}")
        # Default trigger: every call (nth=None, every=1) bounded by times.
        default_times = 1 if self.nth is not None else None
        self.times = spec.get("times", default_times)
        if self.times is not None and self.times < 1:
            raise ValueError(f"'times' must be >= 1, got {self.times}")
        self.hang_s = float(spec.get("hang_s", 30.0))
        self.error = spec.get("error")
        self.value = spec.get("value")
        self.fired = 0

    def should_fire(self, call_number: int) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.nth is not None:
            return call_number == self.nth
        every = self.every or 1
        return call_number % every == 0


class FaultPlan:
    """A compiled plan: site -> rules, plus per-site call counters."""

    def __init__(self, rules: Sequence[Dict[str, Any]]):
        self._lock = threading.Lock()
        self._rules: List[_Rule] = [_Rule(dict(r)) for r in rules]
        self._calls: Dict[str, int] = {}
        self.spec = [dict(r) for r in rules]

    def match(self, site: str) -> Optional[_Rule]:
        """Count one call at ``site``; return the rule to fire, if any."""
        with self._lock:
            n = self._calls.get(site, 0) + 1
            self._calls[site] = n
            for rule in self._rules:
                if rule.site == site and rule.should_fire(n):
                    rule.fired += 1
                    return rule
        return None

    def fired(self) -> Dict[str, int]:
        """Total firings per site."""
        with self._lock:
            out: Dict[str, int] = {}
            for rule in self._rules:
                out[rule.site] = out.get(rule.site, 0) + rule.fired
            return out

    def calls(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._calls)


_active: Optional[FaultPlan] = None
_lock = threading.Lock()


def active_plan() -> Optional[FaultPlan]:
    return _active


def fault_point(site: str, result: Any = None, sleep=time.sleep) -> Any:
    """A named seam: returns ``result`` untouched unless an active plan
    fires here.  ``sleep`` is injectable so tests of hang rules stay
    instant."""
    plan = _active
    if plan is None:
        return result
    rule = plan.match(site)
    if rule is None:
        return result
    from cloud_tpu_torch.monitoring import metrics, tracing

    metrics.counter_inc("faults/injected")
    metrics.counter_inc(f"faults/injected/{site}")
    start = time.perf_counter()
    if rule.mode == "hang":
        logger.warning("fault injected at %s: hang %.1fs", site, rule.hang_s)
        sleep(rule.hang_s)
        tracing.record_span(f"fault/{site}", start, time.perf_counter(),
                            mode="hang")
        return result
    tracing.record_span(f"fault/{site}", start, start, mode=rule.mode)
    if rule.mode == "corrupt":
        logger.warning("fault injected at %s: corrupt result", site)
        return rule.value
    logger.warning("fault injected at %s: raise %s", site,
                   rule.error or "FaultInjected")
    raise _make_error(site, rule)


def _make_error(site: str, rule: _Rule) -> BaseException:
    if rule.error == "transient":
        return InjectedTransientError(
            503, f"injected transient fault at {site}")
    if rule.error == "api":
        return InjectedApiError(400, f"injected permanent fault at {site}")
    return FaultInjected(f"injected fault at {site}")


class inject:
    """Install a fault plan for a block (and export it to children).

    ``plan`` is a list of rule dicts, a :class:`FaultPlan`, or a JSON
    string of the list form.  Nesting is rejected.  The plan object is
    yielded so the block can assert ``plan.fired()``.
    """

    def __init__(self, plan, *, propagate: bool = True):
        if isinstance(plan, str):
            plan = json.loads(plan)
        self.plan = plan if isinstance(plan, FaultPlan) else FaultPlan(plan)
        self.propagate = propagate
        # Serialised before any global state is touched: a plan that cannot
        # round-trip fails here, not with the plan left installed.
        self._env_value = json.dumps(self.plan.spec)
        self._env_before: Optional[str] = None

    def __enter__(self) -> FaultPlan:
        global _active
        with _lock:
            if _active is not None:
                raise RuntimeError("a fault plan is already active")
            _active = self.plan
        if self.propagate:
            self._env_before = os.environ.get(ENV_FAULT_PLAN)
            os.environ[ENV_FAULT_PLAN] = self._env_value
        return self.plan

    def __exit__(self, exc_type, exc, tb):
        global _active
        with _lock:
            _active = None
        if self.propagate:
            if self._env_before is None:
                os.environ.pop(ENV_FAULT_PLAN, None)
            else:
                os.environ[ENV_FAULT_PLAN] = self._env_before
        return False


def maybe_install_from_env() -> bool:
    """Install the plan from ``CLOUD_TPU_FAULT_PLAN`` (a child process of
    an :func:`inject` block).  Idempotent; a malformed plan logs and is
    ignored."""
    global _active
    raw = os.environ.get(ENV_FAULT_PLAN)
    if not raw:
        return False
    with _lock:
        if _active is not None:
            return True
        try:
            _active = FaultPlan(json.loads(raw))
        except (ValueError, TypeError):
            logger.exception("ignoring malformed %s", ENV_FAULT_PLAN)
            return False
    logger.warning("fault plan installed from env: %s", raw)
    return True


def _clear_for_tests() -> None:
    global _active
    with _lock:
        _active = None
