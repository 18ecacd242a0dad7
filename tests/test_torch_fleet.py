"""The port's fleet on the CPU, against the JAX package's.

``cloud_tpu_torch/fleet`` is the port's own copy of ``cloud_tpu/fleet``
(plain Python over the port's engine).  Three layers of checks:

* **Policies, both copies.**  The router (``LeastLoadedRouter``: load,
  readiness, exclusion, ties, prefix affinity, the cache-aware cost model,
  the QoS class discount, the disaggregated role filter), the autoscaler
  (``QueueDepthAutoscaler``) and the disaggregated-serving helpers
  (``chain_keys``, ``HostPrefixPool``, ``stash``/``rehydrate``, role
  validation) run one scripted scenario each on both copies, fed the same
  health snapshots and observations: the picks, decisions and pool states
  must be equal.  The scenarios are the reference's
  (``tests/unit/test_fleet.py``, ``tests/unit/test_fleet_disagg.py``).
* **The port's ``Fleet`` over duck-typed fake engines**: routing,
  failover on ``QueueFullError``, the deadline kept across the hop and
  shed before any submit, supervision restarting an unhealthy replica,
  autoscaling up and down through a graceful drain, request tracing, and
  ``close()`` joining every thread.
* **Real engines**: a 2-replica port fleet of TINY f32 engines on the
  reference's own weights serves the reference's churn requests
  token-identical to JAX ``generate()`` (the prompts are tie-free).
"""

import threading
import time
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloud_tpu.fleet as jax_fleet
from cloud_tpu.fleet import disagg as jax_disagg
from cloud_tpu.models import generation as jax_gen
from cloud_tpu.serving import prefix_cache as jax_prefix
import cloud_tpu_torch.fleet as port_fleet
from cloud_tpu_torch.fleet import disagg as port_disagg
from cloud_tpu_torch.monitoring import tracing
from cloud_tpu_torch.monitoring.report import TraceReport
from cloud_tpu_torch.serving import (
    DeadlineExceededError,
    DispatchTimeoutError,
    EngineClosedError,
    QueueFullError,
    ServeConfig,
    ServingEngine,
    prefix_cache as port_prefix,
)
from cloud_tpu_torch.utils import faults, retries
from helpers.torch_port import tiny_models

torch.set_num_threads(1)

#: Every thread a port fleet may own while live: its router, supervisor
#: and drain helpers, and its engines' scheduler, warmup and dispatch
#: threads.
FLEET_THREAD_PREFIXES = ("cloud-tpu-fleet", "cloud-tpu-torch-serve")


def fleet_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(FLEET_THREAD_PREFIXES)]


# ---------------------------------------------------------------------------
# The policies: one script, both copies.

SIDES = {
    "jax": (jax_fleet, jax_disagg, jax_prefix),
    "port": (port_fleet, port_disagg, port_prefix),
}

#: A routable engine's health snapshot, the keys the router reads.
HEALTH = {"healthy": True, "ready": True, "live": True, "reason": None,
          "queue_depth": 0, "active_slots": 0, "num_slots": 4,
          "cached_prefixes": {}, "class_backlog": {}}


class ScriptedEngine:
    """An engine reduced to a health snapshot a scenario edits."""

    def __init__(self, **health):
        self.snap = dict(HEALTH, **health)

    def health(self):
        return dict(self.snap)

    def close(self, drain=True, timeout=None):
        pass


def _replicas(fleet_mod, healths, roles=None):
    roles = roles or ["both"] * len(healths)
    engines = [ScriptedEngine(**h) for h in healths]
    replicas = [fleet_mod.Replica(i, lambda e=e: e, role=r)
                for i, (e, r) in enumerate(zip(engines, roles))]
    return engines, replicas


def _picked(pick):
    replica, health = pick
    if replica is None:
        return None
    return (replica.id, health["queue_depth"], health["active_slots"],
            health.get("role"))


def _router_basics(mods, log):
    """Least loaded wins; unready and excluded replicas are skipped; ties
    go to the lowest id; an exhausted candidate set picks nothing."""
    fleet_mod = mods[0]
    router = fleet_mod.LeastLoadedRouter()
    _, reps = _replicas(fleet_mod, [{"queue_depth": 3}, {}])
    log.append(("least loaded", _picked(router.pick(reps))))
    _, reps = _replicas(fleet_mod, [{"healthy": False, "ready": False}, {}])
    log.append(("skip unready", _picked(router.pick(reps))))
    log.append(("exclude", _picked(router.pick(reps, exclude={1}))))
    _, reps = _replicas(fleet_mod, [{}, {}, {}])
    log.append(("ties", _picked(router.pick(reps))))
    _, reps = _replicas(fleet_mod, [{"active_slots": 2}, {"queue_depth": 1},
                                    {"queue_depth": 1, "active_slots": 1}])
    log.append(("queue + active", _picked(router.pick(reps)),
                _picked(router.pick(reps, exclude={1}))))


def _router_affinity(mods, log):
    """Prefix affinity breaks ties toward the replica that last served
    the prefix, never against load; the LRU map is bounded."""
    fleet_mod, _, prefix_mod = mods
    router = fleet_mod.LeastLoadedRouter(prefix_affinity=True,
                                         affinity_capacity=2)
    engines, reps = _replicas(fleet_mod, [{}, {}, {}])
    key = prefix_mod.affinity_key(np.arange(1, 40))
    log.append(("cold", _picked(router.pick(reps, affinity_key=key))))
    router.record_affinity(key, 2)
    log.append(("sticky", _picked(router.pick(reps, affinity_key=key))))
    engines[2].snap["queue_depth"] = 1
    log.append(("load wins", _picked(router.pick(reps, affinity_key=key))))
    engines[2].snap["queue_depth"] = 0
    for other in (11, 12):
        router.record_affinity(other, 1)
    log.append(("evicted", _picked(router.pick(reps, affinity_key=key))))


def _router_cost_model(mods, log):
    """The cache-aware score follows the live ``cached_prefixes``
    summaries, beats a less-loaded cold replica when the prefix is long
    enough, and a stale affinity entry cannot override it."""
    fleet_mod, _, prefix_mod = mods
    router = fleet_mod.LeastLoadedRouter(prefix_affinity=True,
                                         cache_alpha=0.5)
    key = prefix_mod.affinity_key(np.arange(1, 40))
    engines, reps = _replicas(fleet_mod, [{"cached_prefixes": {key: 64}},
                                          {}])
    log.append(("warm", _picked(router.pick(reps, affinity_key=key)),
                router.last_pick_cached_tokens))
    router.record_affinity(key, 0)
    engines[0].snap["cached_prefixes"] = {}
    engines[1].snap["cached_prefixes"] = {key: 64}
    log.append(("moved", _picked(router.pick(reps, affinity_key=key)),
                router.last_pick_cached_tokens))
    engines[1].snap["queue_depth"] = 20
    log.append(("worth 32 load", _picked(router.pick(reps, affinity_key=key))))
    engines[1].snap["queue_depth"] = 40
    log.append(("outweighed", _picked(router.pick(reps, affinity_key=key)),
                router.last_pick_cached_tokens))
    log.append(("no key", _picked(router.pick(reps))))


def _router_qos(mods, log):
    """The QoS-aware load discounts backlog below the request's class by
    the weight ratio; requests without a class see the plain load."""
    fleet_mod = mods[0]
    router = fleet_mod.LeastLoadedRouter(
        class_weights={"interactive": 8.0, "standard": 2.0, "batch": 1.0})
    _, reps = _replicas(fleet_mod, [
        {"queue_depth": 6, "class_backlog": {"batch": 6}},
        {"queue_depth": 2, "class_backlog": {"interactive": 2}},
        {"queue_depth": 3, "class_backlog": {}},
    ])
    for priority in ("interactive", "standard", "batch", None):
        log.append((priority, _picked(router.pick(reps, priority=priority))))


def _router_roles(mods, log):
    """The disaggregated leg filter: prefill legs land on prefill-capable
    replicas, decode legs on decode-capable ones, None filters nothing;
    the live health role wins over the assigned one."""
    fleet_mod = mods[0]
    router = fleet_mod.LeastLoadedRouter()
    engines, reps = _replicas(fleet_mod, [{"queue_depth": 1}, {}, {}],
                              roles=["prefill", "decode", "both"])
    for role in ("prefill", "decode", None):
        log.append((role, _picked(router.pick(reps, role=role))))
    engines[1].snap["role"] = "prefill"
    log.append(("restamped", _picked(router.pick(reps, role="prefill")),
                _picked(router.pick(reps, role="decode"))))
    log.append(("none left", _picked(router.pick(reps, role="decode",
                                                 exclude={2}))))


def _replica_stub(mods, log):
    """An engineless replica's health stub (its role and zero handoff
    counters) and the load/occupancy helpers."""
    fleet_mod = mods[0]
    rep = fleet_mod.Replica(3, lambda: None, start=False, role="decode")
    snap = rep.health()
    log.append(("stub", sorted(snap.items(), key=lambda kv: kv[0])))
    log.append(("load", fleet_mod.Replica.load_of(
        {"queue_depth": 2, "active_slots": 3}),
        fleet_mod.Replica.occupancy_of({"active_slots": 3, "num_slots": 4}),
        fleet_mod.Replica.occupancy_of({})))
    with pytest.raises(ValueError, match="role"):
        fleet_mod.Replica(0, lambda: None, start=False, role="gpu")


def _autoscaler(mods, log):
    """Sustained depth scales up (then cools down), one burst does not,
    sustained idleness scales down to the floor and never below it, busy
    slots block it, a per-class threshold fires on its own backlog."""
    fleet_mod = mods[0]
    scripts = [
        (dict(min_replicas=1, max_replicas=3, scale_up_queue_depth=2.0,
              window=3, cooldown=2),
         [(6, 1, 0.0)] * 3 + [(9, 2, 0.0)] * 3 + [(9, 3, 0.0)] * 2),
        (dict(min_replicas=1, max_replicas=3, scale_up_queue_depth=4.0,
              window=3, cooldown=0),
         [(100, 1, 0.0), (0, 1, 0.0), (0, 1, 0.0)]),
        (dict(min_replicas=1, max_replicas=3, idle_window=3, cooldown=0,
              window=2),
         [(0, 2, 0.0)] * 3 + [(0, 1, 0.0)] * 5),
        (dict(min_replicas=1, max_replicas=2, idle_window=2, cooldown=0),
         [(0, 2, 0.5)] * 4),
    ]
    for kwargs, obs in scripts:
        scaler = fleet_mod.QueueDepthAutoscaler(
            fleet_mod.AutoscaleConfig(**kwargs))
        log.append([scaler.observe(queue_depth=d, ready_replicas=r,
                                   occupancy=o) for d, r, o in obs])
    scaler = fleet_mod.QueueDepthAutoscaler(fleet_mod.AutoscaleConfig(
        min_replicas=1, max_replicas=3, scale_up_queue_depth=50.0,
        window=2, cooldown=0, class_scale_up_depth={"interactive": 1.0}))
    log.append([scaler.observe(queue_depth=3, ready_replicas=1,
                               class_backlog={"interactive": n, "batch": 1})
                for n in (2, 0, 2, 2)])
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                dict(cooldown=-1), dict(class_scale_up_depth={"x": 0.0})):
        with pytest.raises(ValueError):
            fleet_mod.AutoscaleConfig(**bad)


def _payload(num_blocks, block_tokens=4, base=0):
    return {
        "version": 1, "block_tokens": block_tokens,
        "covered_tokens": num_blocks * block_tokens,
        "keys": [tuple(range(base + i * block_tokens,
                             base + (i + 1) * block_tokens))
                 for i in range(num_blocks)],
        "payloads": [f"bytes {base + i}" for i in range(num_blocks)],
    }


def _disagg_helpers(mods, log):
    """Role validation, chain keys folding the whole prefix, the host
    pool's dedup and LRU eviction, stash/rehydrate round trips and their
    truncation at the first evicted block."""
    disagg = mods[1]
    log.append([disagg.validate_role(r) for r in disagg.ROLES])
    log.append([(r, disagg.serves_prefill(r), disagg.serves_decode(r))
                for r in disagg.ROLES])
    log.append(disagg.validate_roles(("prefill", "decode", "both")))
    for bad in (("prefill", "prefill"), ("decode",), ("gpu",)):
        with pytest.raises(ValueError):
            disagg.validate_roles(bad)
    a = disagg.chain_keys([(1, 2), (3, 4)])
    b = disagg.chain_keys([(9, 9), (3, 4)])
    log.append((a == disagg.chain_keys([(1, 2), (3, 4)]), a[1] != b[1],
                len(a), disagg.payload_blocks(None),
                disagg.payload_blocks(_payload(3))))
    pool = disagg.HostPrefixPool(capacity_blocks=3)
    log.append([pool.put(k, f"v{k}") for k in (1, 2, 1, 3, 4)])
    log.append((pool.get(1), pool.get(2), len(pool), pool.stats()))
    pool = disagg.HostPrefixPool(capacity_blocks=8)
    slim = disagg.stash(pool, _payload(3))
    log.append((slim["payloads"], slim["keys"], pool.stats()))
    again = disagg.stash(pool, _payload(3))
    fat = disagg.rehydrate(pool, again)
    log.append((fat["payloads"], fat["covered_tokens"], pool.stats()))
    small = disagg.HostPrefixPool(capacity_blocks=2)
    slim = disagg.stash(small, _payload(3, base=100))
    fat = disagg.rehydrate(small, slim)
    log.append((fat["payloads"], fat["covered_tokens"], len(fat["keys"]),
                small.stats()))
    log.append((disagg.stash(None, _payload(1))["payloads"],
                disagg.rehydrate(None, None)))
    with pytest.raises(ValueError, match="capacity_blocks"):
        disagg.HostPrefixPool(capacity_blocks=0)


SCENARIOS = {fn.__name__.lstrip("_"): fn for fn in (
    _router_basics, _router_affinity, _router_cost_model, _router_qos,
    _router_roles, _replica_stub, _autoscaler, _disagg_helpers)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policies_answer_as_the_reference(name):
    logs = {}
    for side, mods in SIDES.items():
        logs[side] = []
        SCENARIOS[name](mods, logs[side])
    assert logs["port"] == logs["jax"]
    assert logs["port"]


def test_fleet_copy_keeps_the_reference_surface():
    assert sorted(port_fleet.__all__) == sorted(jax_fleet.__all__)
    for name in ("FLEET_ROUTER_THREAD_NAME", "FLEET_SUPERVISOR_THREAD_NAME",
                 "FLEET_DRAIN_THREAD_NAME"):
        assert getattr(port_fleet, name) == getattr(jax_fleet, name)
    assert port_disagg.ROLES == jax_disagg.ROLES
    port_cfg = port_fleet.FleetConfig()
    jax_cfg = jax_fleet.FleetConfig()
    for field in ("min_replicas", "max_replicas", "max_queue", "admission",
                  "poll_interval_s", "drain_timeout_s", "roles",
                  "host_pool_blocks"):
        assert getattr(port_cfg, field) == getattr(jax_cfg, field), field
    assert retries.RetryPolicy().max_attempts == 4
    policy = port_fleet.default_route_policy()
    assert (policy.max_attempts, policy.initial_backoff_s,
            policy.max_backoff_s) == (8, 0.05, 1.0)
    for exc, transient in ((QueueFullError("x"), True),
                           (DispatchTimeoutError("x"), True),
                           (DeadlineExceededError("x"), False),
                           (ValueError("x"), False),
                           (port_fleet.FleetClosedError("x"), False),
                           (port_fleet.QuotaExceededError("x"), False)):
        assert port_fleet.route_transient(exc) is transient


# ---------------------------------------------------------------------------
# The port's Fleet over fake engines.


def fast_policy(**overrides):
    args = dict(max_attempts=8, initial_backoff_s=0.01, max_backoff_s=0.05,
                classify=port_fleet.route_transient, jitter=False)
    args.update(overrides)
    return retries.RetryPolicy(**args)


class FakeEngine:
    """Duck-typed engine: records submits, resolves at once (``auto``) or
    on demand; ``max_queue`` makes submit raise ``QueueFullError``."""

    def __init__(self, name, *, auto=True, max_queue=None):
        self.name = name
        self.auto = auto
        self.max_queue = max_queue
        self.healthy = True
        self.ready_override = None
        self.closed = False
        self.drained_close = None
        self.submits = []
        self.pending = []
        self._lock = threading.Lock()

    def submit(self, prompt, *, max_new_tokens=None, deadline_s=None):
        with self._lock:
            if self.closed:
                raise EngineClosedError(f"{self.name} closed")
            if self.max_queue is not None and (
                    len(self.pending) >= self.max_queue):
                raise QueueFullError(f"{self.name} full")
            self.submits.append({"prompt": np.asarray(prompt).tolist(),
                                 "max_new_tokens": max_new_tokens,
                                 "deadline_s": deadline_s})
            future = Future()
            if self.auto:
                future.set_result({"served_by": self.name})
            else:
                self.pending.append(future)
            return future

    def resolve_all(self):
        with self._lock:
            pending, self.pending = self.pending, []
        for future in pending:
            future.set_result({"served_by": self.name})

    def fail_all(self, exc):
        with self._lock:
            pending, self.pending = self.pending, []
        for future in pending:
            future.set_exception(exc)

    def health(self):
        with self._lock:
            depth = len(self.pending)
            closed = self.closed
        ready = (self.ready_override if self.ready_override is not None
                 else (self.healthy and not closed))
        return {"healthy": self.healthy, "ready": ready,
                "live": self.healthy,
                "reason": None if self.healthy else f"{self.name} unhealthy",
                "closed": closed, "waiting": depth, "queue_depth": depth,
                "active_slots": 0, "num_slots": 4, "slice_shape": (1, 1),
                "slice_chips": 1, "cached_prefixes": {}}

    def close(self, drain=True, timeout=None):
        with self._lock:
            self.closed = True
            self.drained_close = drain
            pending, self.pending = self.pending, []
        for future in pending:
            if drain:
                future.set_result({"served_by": self.name})
            else:
                future.set_exception(EngineClosedError(f"{self.name} closed"))


class TracedFakeEngine(FakeEngine):
    """A fake whose ``submit`` takes ``trace`` and records the terminal
    ``serve/request`` span, as a traced engine does."""

    def __init__(self, name, **kwargs):
        super().__init__(name, **kwargs)
        self.traces = []

    def submit(self, prompt, *, max_new_tokens=None, deadline_s=None,
               trace=None):
        self.traces.append(trace)
        future = super().submit(prompt, max_new_tokens=max_new_tokens,
                                deadline_s=deadline_s)
        if self.auto and trace is not None:
            now = time.perf_counter()
            tracing.record_span("serve/request", now - 0.002, now,
                                trace_id=trace.trace_id, ttft_s=0.001,
                                tokens=2)
        return future


class Factory:
    """Hands out prepared fakes, then fresh ``auto`` ones."""

    def __init__(self, engines=()):
        self.prepared = list(engines)
        self.built = []
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            engine = (self.prepared.pop(0) if self.prepared
                      else FakeEngine(f"auto{len(self.built)}"))
            self.built.append(engine)
            return engine


def quiet_config(**overrides):
    args = dict(min_replicas=1, poll_interval_s=60.0,
                route_policy=fast_policy())
    args.update(overrides)
    return port_fleet.FleetConfig(**args)


def wait_for(predicate, timeout=10.0):
    deadline = time.perf_counter() + timeout
    while not predicate():
        assert time.perf_counter() < deadline
        time.sleep(0.005)


def test_routes_to_least_loaded_and_sums_slices():
    busy = FakeEngine("busy", auto=False)
    idle = FakeEngine("idle")
    for _ in range(4):
        busy.submit(np.asarray([9], np.int32))
    fleet = port_fleet.Fleet(Factory([busy, idle]),
                             quiet_config(min_replicas=2))
    try:
        result = fleet.submit(np.asarray([1, 2, 3], np.int32)).result(10)
        assert result["served_by"] == "idle"
        stats = fleet.stats()
        assert stats["routed"] == {1: 1} and stats["completed"] == 1
        assert fleet.health()["total_chips"] == 2
    finally:
        busy.resolve_all()
        fleet.close()
    assert not fleet_threads()


def test_failover_on_queue_full():
    full = FakeEngine("full", max_queue=0)
    spare = FakeEngine("spare", auto=False)
    with tracing.collecting() as collector:
        fleet = port_fleet.Fleet(Factory([full, spare]),
                                 quiet_config(min_replicas=2))
        try:
            future = fleet.submit(np.asarray([7], np.int32))
            wait_for(lambda: spare.submits)
            spare.resolve_all()
            assert future.result(10)["served_by"] == "spare"
            assert full.submits == []
            assert fleet.stats()["failovers"] >= 1
        finally:
            fleet.close()
    names = [e["name"] for e in collector.events()]
    assert "fleet/failover" in names and "fleet/route" in names
    assert not fleet_threads()


def test_deadline_kept_across_the_hop_and_shed_before_submit():
    engine = FakeEngine("only")
    fleet = port_fleet.Fleet(Factory([engine]), quiet_config())
    try:
        fleet.submit(np.asarray([1], np.int32), deadline_s=5.0).result(10)
        passed = engine.submits[0]["deadline_s"]
        assert passed is not None and 0 < passed <= 5.0
    finally:
        fleet.close()
    unroutable = FakeEngine("unroutable")
    unroutable.ready_override = False
    fleet = port_fleet.Fleet(Factory([unroutable]), quiet_config())
    try:
        future = fleet.submit(np.asarray([1, 2], np.int32), deadline_s=0.05)
        with pytest.raises(DeadlineExceededError):
            future.result(10)
        assert unroutable.submits == []
        assert fleet.stats()["shed"] == 1 and fleet.stats()["failed"] == 0
    finally:
        fleet.close()
    assert not fleet_threads()


def test_failover_never_resubmits_an_expired_request():
    first = FakeEngine("first", auto=False)
    second = FakeEngine("second", auto=False)
    fleet = port_fleet.Fleet(Factory([first, second]),
                             quiet_config(min_replicas=2))
    try:
        future = fleet.submit(np.asarray([3], np.int32), deadline_s=0.1)
        wait_for(lambda: first.submits)
        time.sleep(0.15)
        first.fail_all(DispatchTimeoutError("replica died"))
        with pytest.raises(DeadlineExceededError):
            future.result(10)
        assert second.submits == []
    finally:
        fleet.close()


def test_caller_errors_fail_without_failover():
    class Picky(FakeEngine):
        def submit(self, prompt, **kwargs):
            raise ValueError("prompt too long")

    spare = FakeEngine("spare")
    fleet = port_fleet.Fleet(Factory([Picky("picky"), spare]),
                             quiet_config(min_replicas=2))
    try:
        with pytest.raises(ValueError, match="too long"):
            fleet.submit(np.asarray([1], np.int32)).result(10)
        assert spare.submits == []
    finally:
        fleet.close()


def test_supervision_restarts_unhealthy_replica_and_request_reenters():
    sick = FakeEngine("sick", auto=False)
    factory = Factory([sick])
    plan = [{"site": "fleet.replica_start", "mode": "raise", "nth": 2}]
    with faults.inject(plan) as active:
        fleet = port_fleet.Fleet(factory, port_fleet.FleetConfig(
            min_replicas=1, poll_interval_s=0.02,
            route_policy=fast_policy(max_attempts=12,
                                     initial_backoff_s=0.02,
                                     max_backoff_s=0.1)))
        try:
            future = fleet.submit(np.asarray([5, 6], np.int32))
            wait_for(lambda: sick.submits)
            sick.healthy = False
            sick.fail_all(DispatchTimeoutError("dispatch hung"))
            assert future.result(30)["served_by"] == "auto1"
            stats = fleet.stats()
            assert stats["restarts"] >= 1 and stats["failovers"] >= 1
            assert stats["completed"] == 1
            assert sick.drained_close is False
            assert fleet.replicas()[0].restarts >= 1
        finally:
            fleet.close()
    assert active.fired() == {"fleet.replica_start": 1}
    assert not fleet_threads()


def test_scales_up_under_backlog_and_drains_back_when_idle():
    factory = Factory([FakeEngine("seed", auto=False, max_queue=1)])

    def capped():
        engine = factory()
        engine.auto = False
        engine.max_queue = 1
        return engine

    fleet = port_fleet.Fleet(capped, port_fleet.FleetConfig(
        min_replicas=1, max_replicas=3, poll_interval_s=0.02,
        route_policy=fast_policy(max_attempts=50),
        autoscale=port_fleet.AutoscaleConfig(
            scale_up_queue_depth=1.0, window=2, idle_window=3, cooldown=1)))
    try:
        futures = [fleet.submit(np.asarray([i + 1], np.int32))
                   for i in range(6)]
        wait_for(lambda: fleet.num_replicas() >= 2, 15)
        assert fleet.stats()["scale_ups"] >= 1

        def served():
            for engine in list(factory.built):
                engine.resolve_all()
            return all(f.done() for f in futures)

        wait_for(served, 15)
        assert all("served_by" in f.result(5) for f in futures)

        def shrunk():
            for engine in list(factory.built):
                engine.resolve_all()
            return fleet.num_replicas() == 1

        wait_for(shrunk, 15)
        assert fleet.stats()["scale_downs"] >= 1
        wait_for(lambda: any(e.closed and e.drained_close is True
                             for e in factory.built), 15)
    finally:
        fleet.close()
    assert not fleet_threads()


def test_close_drains_or_fails_and_joins_every_thread():
    fleet = port_fleet.Fleet(Factory(), quiet_config())
    futures = [fleet.submit(np.asarray([i], np.int32)) for i in range(1, 4)]
    fleet.close()
    assert all("served_by" in f.result(5) for f in futures)
    assert fleet.stats()["completed"] == 3
    with pytest.raises(port_fleet.FleetClosedError):
        fleet.submit(np.asarray([1], np.int32))
    assert not fleet_threads()

    held = FakeEngine("held", auto=False)
    fleet = port_fleet.Fleet(Factory([held]), quiet_config())
    future = fleet.submit(np.asarray([1, 2], np.int32))
    wait_for(lambda: held.submits)
    fleet.close(drain=False)
    with pytest.raises((EngineClosedError, port_fleet.FleetClosedError)):
        future.result(5)
    assert not fleet_threads()

    stuck = FakeEngine("stuck", auto=False)
    fleet = port_fleet.Fleet(Factory([stuck]), quiet_config())
    owed = [fleet.submit(np.asarray([1], np.int32))]
    wait_for(lambda: stuck.submits)
    owed.append(fleet.submit(np.asarray([2], np.int32)))
    start = time.perf_counter()
    fleet.close(drain=True, timeout=0.5)
    assert time.perf_counter() - start < 5
    assert not fleet_threads()
    for future in owed:
        with pytest.raises((EngineClosedError, port_fleet.FleetClosedError)):
            future.result(5)


def test_admission_and_validation():
    fleet = port_fleet.Fleet(Factory([FakeEngine("slow", auto=False)]),
                             quiet_config(max_queue=1, admission="reject"),
                             start=False)
    try:
        fleet.submit(np.asarray([1], np.int32))
        with pytest.raises(QueueFullError):
            fleet.submit(np.asarray([2], np.int32))
        assert fleet.stats()["rejected"] == 1
        with pytest.raises(ValueError, match="1-D"):
            fleet.submit(np.zeros((2, 2), np.int32))
        with pytest.raises(ValueError, match="deadline_s"):
            fleet.submit(np.asarray([1], np.int32), deadline_s=0)
    finally:
        fleet.close(drain=False)
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=1),
                dict(admission="drop"), dict(roles=("prefill",)),
                dict(host_pool_blocks=0)):
        with pytest.raises(ValueError):
            port_fleet.FleetConfig(**bad)


def test_trace_survives_failover_and_stitches_one_lifecycle(tmp_path):
    full = TracedFakeEngine("full", max_queue=0)
    ok = TracedFakeEngine("ok")
    path = str(tmp_path / "fleet.json")
    with tracing.collecting():
        fleet = port_fleet.Fleet(Factory([full, ok]),
                                 quiet_config(min_replicas=2))
        try:
            result = fleet.submit(np.asarray([1, 2], np.int32)).result(30)
            assert result["served_by"] == "ok"
            assert all(r.accepts_trace for r in fleet.replicas())
            assert fleet.stats()["traced"] == 1
            assert fleet.dump_timeline(path) == path
        finally:
            fleet.close()
    summary = TraceReport.from_file(path).request_summary()
    ((trace_id, row),) = summary.items()
    assert trace_id == ok.traces[0].trace_id
    assert row["complete"] and row["routes"] == 1 and row["failovers"] == 1


# ---------------------------------------------------------------------------
# Real engines: two replicas of TINY f32 on the reference's weights.


@pytest.fixture(scope="module")
def model():
    return tiny_models(0)


def test_churn_parity_across_two_replicas(model):
    """The reference's ``test_churn_parity_across_two_replicas``: greedy
    outputs through a 2-replica port fleet are token-identical to JAX
    ``generate()``, whichever replica served each request (the reference's
    prompts, tie-free at 1e-3)."""
    jax_cfg, jparams, cfg, params = model
    serve = ServeConfig(max_new_tokens=5, prompt_buckets=(8, 16),
                        batch_buckets=(1, 2, 4), chunk_tokens=2)
    rng = np.random.default_rng(4)
    lens = (3, 8, 12, 5, 16, 2, 7, 9)
    budgets = (5, 2, 4, 1, 5, 3, 5, 2)
    prompts = [rng.integers(1, 255, n).astype(np.int32) for n in lens]
    fleet = port_fleet.Fleet(
        lambda: ServingEngine(params, cfg, serve, device="cpu"),
        port_fleet.FleetConfig(min_replicas=2, poll_interval_s=0.1))
    try:
        futures = []
        for i, prompt in enumerate(prompts):
            futures.append(fleet.submit(prompt, max_new_tokens=budgets[i]))
            if i in (3, 6):
                time.sleep(0.05)
        results = [f.result(timeout=120) for f in futures]
        stats = fleet.stats()
        health = fleet.health()
    finally:
        fleet.close()
    batch = np.zeros((len(prompts), max(lens)), np.int32)
    for i, prompt in enumerate(prompts):
        batch[i, :len(prompt)] = prompt
    want = np.asarray(jax_gen.generate(
        jparams, jnp.asarray(batch), jnp.asarray(lens, np.int32), jax_cfg,
        max_new_tokens=max(budgets))["tokens"])
    for i, (budget, result) in enumerate(zip(budgets, results)):
        np.testing.assert_array_equal(result.tokens, want[i, :budget])
        assert result.num_generated == budget
        assert result.latency_seconds >= result.ttft_seconds > 0
    assert stats["completed"] == len(prompts) and stats["failed"] == 0
    assert set(stats["routed"]) == {0, 1}
    assert health["total_chips"] == 2
    assert [s["slice_shape"] for s in health["replicas"]] == [(1, 1)] * 2
    assert not fleet_threads()
