"""One supervised serving replica: an engine plus its lifecycle state
(port of ``cloud_tpu/fleet/replica.py``).

The fleet never talks to a :class:`~cloud_tpu_torch.serving.ServingEngine`
directly — it talks to a :class:`Replica`, which owns the engine
*instance* (the engine object changes identity across restarts; the
replica id does not) and a small state machine the router and supervisor
coordinate through:

``starting -> ready -> (restarting -> ready)* -> draining -> dead``

* ``ready`` — the router may submit here.
* ``restarting`` — the supervisor killed an unhealthy engine and is
  building a fresh one; the router skips the replica meanwhile.
* ``draining`` — scale-down in progress: no new routes, admitted
  requests complete (the engine's graceful ``close(drain=True)``).
* ``dead`` — no engine (start failed, or the replica was removed); the
  supervisor retries ``start()`` on its next poll for replicas it still
  owns.

Engines are produced by an ``engine_factory`` — any zero-arg callable
returning a started engine-shaped object (``submit``/``health``/
``close``).  The factory is the whole coupling surface: production
passes a lambda building a real ``ServingEngine``; tests pass fakes.
Every (re)start runs through the ``fleet.replica_start`` fault seam so
the chaos harness can make replica creation fail deterministically.
"""

from __future__ import annotations

import inspect
import logging
import threading
import time
from typing import Callable, Optional

from cloud_tpu_torch.monitoring import tracing
from cloud_tpu_torch.utils import faults

logger = logging.getLogger(__name__)


def _submit_accepts(engine: object, kwarg: str) -> bool:
    """True when the engine's ``submit`` takes ``kwarg`` (named or via
    ``**kwargs``).  Probed once per engine build — never per request —
    so forwarding the kwarg costs routing nothing."""
    submit = getattr(engine, "submit", None)
    if submit is None:
        return False
    try:
        params = inspect.signature(submit).parameters
    except (TypeError, ValueError):  # builtins / exotic callables
        return False
    return kwarg in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
    )


def _submit_accepts_trace(engine: object) -> bool:
    """True when the engine's ``submit`` takes a ``trace`` kwarg."""
    return _submit_accepts(engine, "trace")


class Replica:
    """One slot in the fleet: a stable id, a replaceable engine."""

    def __init__(self, replica_id: int, factory: Callable[[], object],
                 *, start: bool = True, role: str = "both"):
        from cloud_tpu_torch.fleet import disagg

        self.id = replica_id
        self._factory = factory
        # Role-aware factories (signature-probed once, same idiom as
        # the fleet's router-pick probes): a factory declaring a
        # ``role`` parameter receives the replica's role on every
        # (re)build, so disaggregated fleets can tune each engine to
        # its leg — decode replicas pack more concurrent slots (and a
        # deeper import pool) because they never run prefill.  Zero-arg
        # factories are untouched, keeping the colocated contract
        # byte-identical.
        try:
            self._factory_takes_role = "role" in inspect.signature(
                factory
            ).parameters
        except (TypeError, ValueError):  # pragma: no cover - exotic
            self._factory_takes_role = False
        #: Disaggregated-serving role.  ``"both"`` (the default) keeps
        #: the colocated fleet byte-identical; ``"prefill"``/``"decode"``
        #: restrict which request legs the router offers this replica.
        #: Survives restarts — the role belongs to the replica identity,
        #: not the engine incarnation.
        self.role = disagg.validate_role(role)
        self._lock = threading.Lock()
        self.engine: Optional[object] = None
        self.state = "dead"
        self.restarts = 0
        self.started_at: Optional[float] = None
        #: Timeline lane (synthetic Chrome-trace pid) the replica's
        #: engines stamp their spans with.  Allocated once, on the first
        #: start of a lane-capable engine, and REUSED across restarts —
        #: one Perfetto row per replica identity, not per engine
        #: incarnation.  None until then (and forever, for fakes
        #: without ``set_trace_lane``).
        self.trace_lane: Optional[int] = None
        #: Whether this replica's engine ``submit()`` accepts the
        #: ``trace`` kwarg (signature-probed at start, same idiom as
        #: the fleet's router-pick probes) — duck-typed fakes predating
        #: the kwarg keep working on the plain path.
        self.accepts_trace = False
        #: Whether the engine's ``submit()`` accepts the disaggregated
        #: ``handoff``/``handoff_export`` kwargs (same probe idiom) —
        #: the fleet only builds handoff legs through replicas that do.
        self.accepts_handoff = False
        if start:
            self.start()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Replica(id={self.id}, state={self.state!r})"

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Build a fresh engine through the factory (and the chaos seam).

        On factory failure the replica stays ``dead`` — the supervisor
        retries on its next poll rather than the fleet dying with it.
        """
        with self._lock:
            if self.state == "ready":
                return
            self.state = "starting"
        try:
            faults.fault_point("fleet.replica_start")
            if self._factory_takes_role:
                engine = self._factory(role=self.role)
            else:
                engine = self._factory()
        except BaseException:
            with self._lock:
                self.state = "dead"
            raise
        self.accepts_trace = _submit_accepts_trace(engine)
        self.accepts_handoff = _submit_accepts(engine, "handoff")
        if hasattr(engine, "set_trace_lane"):
            if self.trace_lane is None:
                self.trace_lane = tracing.register_lane(
                    f"replica {self.id}"
                )
            engine.set_trace_lane(self.trace_lane)
        if self.role != "both" and hasattr(engine, "set_role"):
            # Restamp fresh incarnations: the role outlives the engine.
            engine.set_role(self.role)
        with self._lock:
            self.engine = engine
            self.state = "ready"
            self.started_at = time.perf_counter()

    def restart(self, *, close_timeout: Optional[float] = None) -> None:
        """Kill the current (unhealthy) engine and build a fresh one.

        ``close(drain=False)``: an unhealthy engine cannot be drained —
        its waiting and in-flight requests fail with the engine's typed
        errors, and the fleet's submit callbacks re-enter them into the
        fleet queue, so supervision never drops an admitted request.
        """
        with self._lock:
            self.state = "restarting"
            old, self.engine = self.engine, None
        if old is not None:
            try:
                old.close(drain=False, timeout=close_timeout)
            except Exception:  # noqa: BLE001 — a broken engine must not
                # block its own replacement.
                logger.exception(
                    "replica %d: closing unhealthy engine failed", self.id
                )
        self.restarts += 1
        self.start()

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Retire the replica: graceful drain (scale-down / fleet close)
        or immediate failure of everything owed (``drain=False``)."""
        with self._lock:
            self.state = "draining" if drain else "dead"
            engine = self.engine
        if engine is not None:
            engine.close(drain=drain, timeout=timeout)
        with self._lock:
            self.state = "dead"

    # -- introspection -----------------------------------------------------

    def health(self) -> dict:
        """The engine's health snapshot, stamped with replica identity.

        A replica without an engine (starting/dead) reports itself
        unroutable without raising — the supervisor and the router both
        poll this on every decision.
        """
        engine = self.engine
        if engine is None:
            return {
                "healthy": False, "ready": False, "live": False,
                "reason": f"replica {self.state}", "queue_depth": 0,
                "active_slots": 0, "num_slots": 0,
                "slice_shape": (0, 0), "slice_chips": 0,
                "class_backlog": {},
                # Tiered-prefix-cache schema (an engineless replica
                # caches nothing): the cost-model router and the
                # supervisor's dram gauges read these without probing —
                # the FULL _prefix_snapshot key set, so the stub and a
                # live engine expose one shape.
                "prefix_cache_blocks": 0, "prefix_hit_tokens": 0,
                "evictions": 0, "prefix_dram_blocks": 0,
                "prefix_dram_hits": 0, "prefix_dram_hit_tokens": 0,
                "prefix_dram_demotions": 0, "prefix_dram_evictions": 0,
                "prefix_dram_swapin_failures": 0,
                "prefix_deferred_saves": 0,
                "cached_prefixes": {},
                # Pipelined-scheduling schema (an engineless replica
                # schedules nothing): depth 1, no dispatch gap — the
                # supervisor's gap gauges read these without probing.
                "pipeline_depth": 1, "dispatch_gap_ms": 0.0,
                # Disaggregated-serving schema (an engineless replica
                # still advertises its assigned role; handoff counters
                # are zero — stable shape next to the prefix keys).
                "role": self.role,
                "handoff_exports": 0, "handoff_export_blocks": 0,
                "handoff_imports": 0, "handoff_import_blocks": 0,
                "replica": self.id, "state": self.state,
            }
        snap = engine.health()
        snap["replica"] = self.id
        snap["state"] = self.state
        if "role" not in snap:
            # Engine-shaped fakes without the disagg schema: stamp the
            # replica's assigned role so the router's leg filter always
            # has one spelling to read.
            snap["role"] = self.role
        return snap

    @staticmethod
    def load_of(health: dict) -> int:
        """The router's load signal: queued + in-flight work."""
        return int(health.get("queue_depth") or 0) + int(
            health.get("active_slots") or 0
        )

    @staticmethod
    def occupancy_of(health: dict) -> Optional[float]:
        """Fraction of the replica's decode slots in use (None when the
        engine doesn't report a slot count)."""
        slots = health.get("num_slots")
        if not slots:
            return None
        return int(health.get("active_slots") or 0) / float(slots)

    def routable(self, health: Optional[dict] = None) -> bool:
        snap = health if health is not None else self.health()
        return self.state == "ready" and bool(snap.get("ready"))
