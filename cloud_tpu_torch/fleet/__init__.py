"""Horizontally scalable serving (port of ``cloud_tpu/fleet``): a
health-aware router, replica supervision, and queue-depth autoscaling
over N serving engines.  On one card the replicas share it.

``cloud_tpu_torch.serving`` proves the single-engine unit (continuous
batching, deadlines, watchdog, typed errors); this package is the thin
replication layer over it — one :class:`Fleet` fronts many engine
replicas behind a single ``submit()``, routes each request to the
least-loaded healthy replica, fails over around dead or saturated ones
(bounded by a :class:`~cloud_tpu_torch.utils.retries.RetryPolicy`), restarts
unhealthy engines without dropping admitted requests, and scales the
replica count with queue depth — scale-down only via graceful drain.
See :mod:`cloud_tpu_torch.fleet.fleet`.
"""

from cloud_tpu_torch.fleet.autoscaler import AutoscaleConfig, QueueDepthAutoscaler
from cloud_tpu_torch.fleet.fleet import (
    FLEET_DRAIN_THREAD_NAME,
    FLEET_ROUTER_THREAD_NAME,
    FLEET_SUPERVISOR_THREAD_NAME,
    Fleet,
    FleetClosedError,
    FleetConfig,
    NoReplicaAvailableError,
    default_route_policy,
    route_transient,
)
from cloud_tpu_torch.fleet.replica import Replica
from cloud_tpu_torch.fleet.router import LeastLoadedRouter
# QoS policy types live in cloud_tpu_torch.serving.qos (one canonical home);
# re-exported here because FleetConfig.qos and the quota/shed errors
# are part of the fleet's submit surface.
from cloud_tpu_torch.serving.qos import (
    BrownoutShedError,
    PriorityClass,
    QosConfig,
    QuotaExceededError,
    TenantQuota,
    TokenStream,
)

__all__ = [
    "BrownoutShedError",
    "PriorityClass",
    "QosConfig",
    "QuotaExceededError",
    "TenantQuota",
    "TokenStream",
    "AutoscaleConfig",
    "Fleet",
    "FleetClosedError",
    "FleetConfig",
    "FLEET_DRAIN_THREAD_NAME",
    "FLEET_ROUTER_THREAD_NAME",
    "FLEET_SUPERVISOR_THREAD_NAME",
    "LeastLoadedRouter",
    "NoReplicaAvailableError",
    "QueueDepthAutoscaler",
    "Replica",
    "default_route_policy",
    "route_transient",
]
