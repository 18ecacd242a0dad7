"""In-process continuous-batching serving on the card (port of
``cloud_tpu/serving``).  See :mod:`cloud_tpu_torch.serving.engine`; for
priority classes, quotas and streaming, :mod:`cloud_tpu_torch.serving.qos`;
for several engines behind one router, :mod:`cloud_tpu_torch.fleet`."""

from cloud_tpu_torch.serving.engine import (
    DeadlineExceededError,
    DispatchTimeoutError,
    DraftConfig,
    EngineClosedError,
    QueueFullError,
    SERVE_DISPATCH_THREAD_NAME,
    SERVE_SCHEDULER_THREAD_NAME,
    ServeConfig,
    ServeResult,
    ServingEngine,
)
from cloud_tpu_torch.serving.prefix_cache import (
    AFFINITY_PREFIX_TOKENS,
    PrefixCacheManager,
    PrefixHit,
    affinity_key,
)
from cloud_tpu_torch.serving.qos import (
    BrownoutShedError,
    PriorityClass,
    QosConfig,
    QosScheduler,
    QuotaExceededError,
    TenantQuota,
    TokenBucket,
    TokenStream,
)

__all__ = [
    "AFFINITY_PREFIX_TOKENS",
    "affinity_key",
    "BrownoutShedError",
    "DeadlineExceededError",
    "DispatchTimeoutError",
    "DraftConfig",
    "EngineClosedError",
    "PrefixCacheManager",
    "PrefixHit",
    "PriorityClass",
    "QosConfig",
    "QosScheduler",
    "QueueFullError",
    "QuotaExceededError",
    "SERVE_DISPATCH_THREAD_NAME",
    "SERVE_SCHEDULER_THREAD_NAME",
    "ServeConfig",
    "ServeResult",
    "ServingEngine",
    "TenantQuota",
    "TokenBucket",
    "TokenStream",
]
