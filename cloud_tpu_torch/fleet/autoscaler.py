"""Queue-depth autoscaling (port of ``cloud_tpu/fleet/autoscaler.py``):
grow capacity when the fleet queue backs up, drain it back when the fleet
goes idle.

Serving economics punish both directions of sizing error: too few
replicas and queue wait dominates latency; too many and each replica's
occupancy — the quantity every decode step's weight reads are amortized
over — collapses (arxiv 2605.25645).  The autoscaler closes the loop
from *windowed* load observations, not instantaneous ones, so a single
burst or a single empty poll never thrashes the replica count:

* **scale up** when the fleet queue depth *per ready replica* reached
  ``scale_up_queue_depth`` in EVERY one of the last ``window``
  observations (a windowed minimum, so one transient burst whose spike
  would dominate a mean cannot trigger capacity) — requests are
  arriving faster than the current replicas admit them, sustained.
* **scale down** when every one of the last ``idle_window``
  observations was idle — empty fleet queue AND mean slot occupancy at
  or below ``scale_down_occupancy`` — and the fleet is above
  ``min_replicas``.  Scale-down is advisory only; the fleet executes it
  exclusively via graceful drain (the shrinking replica serves
  everything it admitted before it dies).
* ``cooldown`` observations must pass after any scale event before the
  next — capacity changes have lag (a new replica compiles its grid),
  and deciding again before the last decision landed oscillates.

The class is pure decision logic (feed observations, get
``"up" | "down" | "hold"``), so tests drive it with plain numbers and
the fleet supervisor owns the clock.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Sizing bounds and the windowed thresholds (module docstring)."""

    min_replicas: int = 1
    max_replicas: int = 1
    #: Queued requests per ready replica that every observation in the
    #: window must reach to trigger a scale-up.
    scale_up_queue_depth: float = 2.0
    #: Observations in the scale-up averaging window.
    window: int = 3
    #: Consecutive idle observations before scaling down.
    idle_window: int = 5
    #: Mean slot occupancy at or below which an observation counts as
    #: idle (0.0: every slot must be free).
    scale_down_occupancy: float = 0.0
    #: Observations after any scale event before the next may fire.
    cooldown: int = 3
    #: Per-CLASS scale-up thresholds (QoS fleets): class name ->
    #: queued-requests-per-ready-replica that every observation in the
    #: window must reach.  Lets an interactive backlog trigger capacity
    #: at a depth the total-queue threshold would shrug off (a small
    #: interactive pile-up hurts more than a big batch one).  ``None``
    #: (default): the total-depth signal alone decides.
    class_scale_up_depth: Optional[Mapping[str, float]] = None

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})"
            )
        if self.window < 1 or self.idle_window < 1:
            raise ValueError("window and idle_window must be >= 1")
        if self.cooldown < 0:
            raise ValueError(f"cooldown must be >= 0, got {self.cooldown}")
        if self.class_scale_up_depth is not None:
            depths = dict(self.class_scale_up_depth)
            object.__setattr__(self, "class_scale_up_depth", depths)
            for name, depth in depths.items():
                if depth <= 0:
                    raise ValueError(
                        f"class_scale_up_depth[{name!r}] must be > 0, "
                        f"got {depth}"
                    )


class QueueDepthAutoscaler:
    """Feed one observation per supervisor poll; read the decision."""

    def __init__(self, config: AutoscaleConfig):
        self.config = config
        self._depths = collections.deque(maxlen=config.window)
        #: Per-class windowed depths (QoS fleets feed class_backlog).
        self._class_depths: Dict[str, collections.deque] = {}
        self._idle_streak = 0
        self._cooldown_left = 0

    def observe(self, *, queue_depth: int, ready_replicas: int,
                occupancy: float = 0.0,
                class_backlog: Optional[Mapping[str, int]] = None) -> str:
        """One windowed observation -> ``"up" | "down" | "hold"``.

        ``queue_depth`` is the fleet-level waiting count, ``occupancy``
        the mean fraction of decode slots in use across ready replicas,
        ``class_backlog`` the per-class waiting counts (QoS fleets; the
        per-class thresholds only see classes it names).  A fired
        decision resets every window and starts the cooldown.
        """
        cfg = self.config
        self._depths.append(queue_depth / max(ready_replicas, 1))
        if class_backlog is not None and cfg.class_scale_up_depth:
            for name in cfg.class_scale_up_depth:
                window = self._class_depths.get(name)
                if window is None:
                    window = self._class_depths[name] = collections.deque(
                        maxlen=cfg.window
                    )
                window.append(
                    int(class_backlog.get(name, 0)) /
                    max(ready_replicas, 1)
                )
        if queue_depth == 0 and occupancy <= cfg.scale_down_occupancy:
            self._idle_streak += 1
        else:
            self._idle_streak = 0
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return "hold"
        if (
            len(self._depths) == cfg.window
            and min(self._depths) >= cfg.scale_up_queue_depth
            and ready_replicas < cfg.max_replicas
        ):
            self._fired()
            return "up"
        # Per-class trigger: a sustained backlog in any thresholded
        # class scales up even when the total depth looks tolerable.
        if cfg.class_scale_up_depth and ready_replicas < cfg.max_replicas:
            for name, threshold in cfg.class_scale_up_depth.items():
                window = self._class_depths.get(name)
                if (window is not None and len(window) == cfg.window
                        and min(window) >= threshold):
                    self._fired()
                    return "up"
        if (
            self._idle_streak >= cfg.idle_window
            and ready_replicas > cfg.min_replicas
        ):
            self._fired()
            return "down"
        return "hold"

    def _fired(self) -> None:
        self._depths.clear()
        for window in self._class_depths.values():
            window.clear()
        self._idle_streak = 0
        self._cooldown_left = self.config.cooldown
