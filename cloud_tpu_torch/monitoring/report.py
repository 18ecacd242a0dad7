"""Phase-latency breakdown of a tracing timeline dump (port of
``cloud_tpu/monitoring/report.py``, the whole module, its CLI included).

``python -m cloud_tpu_torch.monitoring.report /path/to/timeline.json`` prints a
per-span-name table (count, total, mean, p50, max, % of wall) from a
Chrome trace-event file written by ``tracing.dump_timeline``.  The same
summarization is importable as :class:`TraceReport` for programmatic use.

When the timeline contains serving spans (``serve/*`` — the
``cloud_tpu_torch.serving`` engine), a dedicated breakdown follows the main
table: queue wait vs prefill vs decode/chunk, each as a percentage of
total serve-span time, so "requests are slow" resolves one level deeper
— waiting for a slot (raise ``max_queue``, add capacity) vs paying
compute (shrink buckets, raise occupancy) — without leaving the CLI.
Continuous-batching timelines (``serve/chunk`` spans) additionally get
a grid-health line: chunk count, mean slot occupancy, mean active
slots, and total emitted tokens, aggregated from the per-dispatch span
attributes the scheduler stamps on every chunk — plus the slice shape
(``slice 2x1 (2 chips)``) next to occupancy when the engine is a
sharded multi-chip slice.  Prefix-cache /
chunked-prefill timelines (``serve/prefix_lookup`` /
``serve/prefill_chunk`` spans) get hit rate, hit tokens, prefill-chunk
count, and decode-stall attribution (one interleaved prefill chunk is
exactly the stall a decode chunk can see, so the max chunk duration is
the worst stall of the run).  Speculative-decoding timelines
(``serve/draft`` / ``serve/verify`` spans) get a line with the verify
dispatch count, the draft-token acceptance rate (from the
``accepted``/``proposed`` attributes the scheduler stamps per verify),
and the draft-vs-verify wall-clock split — the numbers ``spec_k`` is
tuned against, printed next to the occupancy line.

QoS timelines (``serve/request`` spans — the engine stamps one per
retired request when ``ServeConfig.qos`` is armed, carrying
``priority`` and ``ttft_s`` attributes) get a **QoS classes** section:
per-class request counts with TTFT and end-to-end latency p50/p99 —
the per-class SLO numbers the priority weights and quotas are tuned
against.  FIFO timelines carry no such spans and render no section.

Timelines carrying ``trace_id`` attributes (requests submitted while
tracing was active — the fleet mints a :class:`tracing.TraceContext`
per request and every layer stamps it) additionally get per-request
stitching: a **traced requests** line, a **TTFT decomposition** table
attributing fleet TTFT to queue / route / swap-in / prefill /
first-decode shares at p50/p99 (the distributional gate a fleet benchmark
compares instead of raw percentiles), and a ``--trace
<id>`` drill-down that prints one request's whole lifecycle — every
span under its trace id across fleet and replicas, failovers included
— in start order.

Timelines with ``fleet/*`` spans (the ``cloud_tpu_torch.fleet`` layer) get a
**fleet** section: per-replica routed-request counts with mean
load/occupancy (from the attributes the router stamps on every
``fleet/route`` decision), failover / restart / scale-event counts, and
the occupancy spread across replicas — the imbalance number a fleet
operator tunes the router against.

Timelines touched by the fault-tolerance layer get a **robustness**
section: retry activity (``retry/*`` spans — the ``utils.retries``
policy stamps ``attempts``/``outcome`` on every retried call), shed /
deadline-exceeded serving requests (``serve/shed``), injected chaos
faults (``fault/<site>`` spans from ``utils.faults``), preemption
drains (``preempt/drain``), checkpoint restore fallbacks from the
verified walk-back (``checkpoint/fallback``), non-finite step
quarantine activity (``train/nonfinite_skip``), and divergence
rollbacks (``train/rollback``) — so a post-mortem of "what went wrong
and what absorbed it" reads off the same CLI as the latency breakdown.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional


def _percentile(sorted_values: List[float], q: float) -> float:
    if not sorted_values:
        return 0.0
    idx = min(len(sorted_values) - 1, int(q * (len(sorted_values) - 1) + 0.5))
    return sorted_values[idx]


class TraceReport:
    """Aggregates complete ("ph": "X") events from a timeline dump."""

    def __init__(self, events: List[dict]):
        self.events = [
            e for e in events
            if e.get("ph") == "X" and isinstance(e.get("dur"), (int, float))
        ]

    @classmethod
    def from_file(cls, path: str) -> "TraceReport":
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        return cls(events)

    def wall_seconds(self) -> float:
        """End of the last span minus start of the first (timeline span)."""
        if not self.events:
            return 0.0
        start = min(e["ts"] for e in self.events)
        end = max(e["ts"] + e["dur"] for e in self.events)
        return (end - start) / 1e6

    def rows(self) -> List[Dict[str, float]]:
        """One row per span name, sorted by total time descending."""
        by_name: Dict[str, List[float]] = {}
        for event in self.events:
            by_name.setdefault(event["name"], []).append(event["dur"] / 1e6)
        wall = self.wall_seconds()
        rows = []
        for name, durations in by_name.items():
            durations.sort()
            total = sum(durations)
            rows.append({
                "name": name,
                "count": len(durations),
                "total_s": total,
                "mean_s": total / len(durations),
                "p50_s": _percentile(durations, 0.5),
                "max_s": durations[-1],
                "pct_wall": 100.0 * total / wall if wall else 0.0,
            })
        rows.sort(key=lambda r: r["total_s"], reverse=True)
        return rows

    #: The serving phases, in request order (the ``cloud_tpu_torch.serving``
    #: engine's span names — batch-mode batch_form/decode, continuous-
    #: mode chunk); anything else under ``serve/`` rides along.
    _SERVE_ORDER = (
        "serve/queue_wait", "serve/batch_form", "serve/prefill",
        "serve/decode", "serve/chunk", "serve/draft", "serve/verify",
        "serve/host_bubble", "serve/dispatch_gap",
    )

    def continuous_summary(self) -> Optional[Dict[str, float]]:
        """Aggregate the ``serve/chunk`` spans' per-dispatch attributes
        (the continuous-batching scheduler stamps ``active``, ``slots``,
        ``tokens`` and ``occupancy`` on every chunk) into one line of
        grid health: how full the decode grid ran.  None when the
        timeline has no chunk spans (batch-mode or non-serving trace).
        """
        chunks = [
            e.get("args") or {} for e in self.events
            if e.get("name") == "serve/chunk"
        ]
        if not chunks:
            return None

        def mean_of(key):
            values = [
                a[key] for a in chunks
                if isinstance(a.get(key), (int, float))
            ]
            return sum(values) / len(values) if values else None

        tokens = [
            a["tokens"] for a in chunks
            if isinstance(a.get("tokens"), (int, float))
        ]
        # Sharded engines stamp the slice ("2x1") and its chip count on
        # every chunk span; single-chip timelines carry neither.
        slice_shape = next(
            (a["slice"] for a in chunks if a.get("slice")), None
        )
        slice_chips = next(
            (
                a["slice_chips"] for a in chunks
                if isinstance(a.get("slice_chips"), (int, float))
            ),
            None,
        )
        # Pipelined scheduling: the drain records the blocking host
        # copy it actually paid as serve/host_bubble, so bubble time /
        # chunk time is the fraction of the decode timeline the host
        # still stalls the device for (None on depth-1 timelines,
        # which record no bubble spans).
        chunk_us = sum(
            e.get("dur", 0.0) for e in self.events
            if e.get("name") in ("serve/chunk", "serve/verify")
        )
        bubble_us = sum(
            e.get("dur", 0.0) for e in self.events
            if e.get("name") == "serve/host_bubble"
        )
        bubble_fraction = (
            bubble_us / chunk_us
            if bubble_us and chunk_us else None
        )
        return {
            "chunks": len(chunks),
            "mean_occupancy": mean_of("occupancy"),
            "mean_active": mean_of("active"),
            "slots": mean_of("slots"),
            "tokens": sum(tokens) if tokens else None,
            "slice": slice_shape,
            "slice_chips": slice_chips,
            "bubble_fraction": bubble_fraction,
        }

    def prefix_summary(self) -> Optional[Dict[str, object]]:
        """Aggregate the prefix-cache / chunked-prefill spans.

        ``lookups``/``hits``/``hit_rate``/``hit_tokens`` come from
        ``serve/prefix_lookup`` span attributes (the scheduler stamps
        ``hit`` and ``hit_tokens`` per admission); ``prefill_chunks`` /
        ``prefill_chunk_seconds`` / ``max_decode_stall_seconds`` from
        the ``serve/prefill_chunk`` spans — the scheduler interleaves
        exactly one prefill chunk between decode chunks, so a single
        chunk's duration IS the decode stall a long arrival imposes,
        and the max over chunks is the worst stall of the run.

        The host-DRAM tier shows up two ways: lookup spans
        stamp ``dram=True`` on hits that needed a swap-in, splitting
        ``hits`` into ``hbm_hits``/``dram_hits``, and the
        ``serve/prefix_swapin`` spans carry the swap-in stall the
        admission path paid to promote demoted blocks (count, total,
        and max — the worst single admission stall attributable to the
        tier).  None when the timeline has none of these spans (prefix
        caching and chunked prefill off, batch mode, or a non-serving
        trace).
        """
        lookups = 0
        hits = 0
        dram_hits = 0
        hit_tokens = 0
        chunk_durs: List[float] = []
        swapin_durs: List[float] = []
        swapin_blocks = 0
        for event in self.events:
            name = event.get("name", "")
            args = event.get("args") or {}
            if name == "serve/prefix_lookup":
                lookups += 1
                if args.get("hit"):
                    hits += 1
                    if args.get("dram"):
                        dram_hits += 1
                tokens = args.get("hit_tokens")
                if isinstance(tokens, (int, float)):
                    hit_tokens += int(tokens)
            elif name == "serve/prefill_chunk":
                chunk_durs.append(event["dur"] / 1e6)
            elif name == "serve/prefix_swapin":
                swapin_durs.append(event["dur"] / 1e6)
                blocks = args.get("blocks")
                if isinstance(blocks, (int, float)):
                    swapin_blocks += int(blocks)
        if not lookups and not chunk_durs and not swapin_durs:
            return None
        return {
            "lookups": lookups,
            "hits": hits,
            "hit_rate": hits / lookups if lookups else None,
            "hit_tokens": hit_tokens,
            "hbm_hits": hits - dram_hits,
            "dram_hits": dram_hits,
            "swapins": len(swapin_durs),
            "swapin_blocks": swapin_blocks,
            "swapin_seconds": sum(swapin_durs),
            "max_swapin_stall_seconds": (
                max(swapin_durs) if swapin_durs else None
            ),
            "prefill_chunks": len(chunk_durs),
            "prefill_chunk_seconds": sum(chunk_durs),
            "max_decode_stall_seconds": (
                max(chunk_durs) if chunk_durs else None
            ),
        }

    def spec_summary(self) -> Optional[Dict[str, object]]:
        """Aggregate the speculative-decoding spans.

        ``serve/verify`` spans carry ``tokens``/``accepted``/``proposed``
        attributes (the scheduler stamps them per verify dispatch), so
        the acceptance rate is committed-draft tokens over proposed
        ones; ``draft_seconds`` sums the ``serve/draft`` +
        ``serve/draft_prefill`` spans and ``verify_seconds`` the verify
        spans — the draft/verify wall-clock split the spec_k knob is
        tuned against.  None when the timeline has no speculative spans
        (draft off, batch mode, or a non-serving trace).
        """
        verify_durs: List[float] = []
        draft_durs: List[float] = []
        counts = {"tokens": 0, "accepted": 0, "proposed": 0}
        for event in self.events:
            name = event.get("name", "")
            if name == "serve/verify":
                verify_durs.append(event["dur"] / 1e6)
                args = event.get("args") or {}
                for key in counts:
                    value = args.get(key)
                    if isinstance(value, (int, float)):
                        counts[key] += int(value)
            elif name in ("serve/draft", "serve/draft_prefill"):
                draft_durs.append(event["dur"] / 1e6)
        if not verify_durs and not draft_durs:
            return None
        return {
            "verify_dispatches": len(verify_durs),
            "tokens": counts["tokens"],
            "accepted": counts["accepted"],
            "proposed": counts["proposed"],
            "acceptance_rate": (
                counts["accepted"] / counts["proposed"]
                if counts["proposed"] else None
            ),
            "draft_seconds": sum(draft_durs),
            "verify_seconds": sum(verify_durs),
        }

    def serving_rows(self, rows: Optional[List[Dict[str, float]]] = None
                     ) -> List[Dict[str, float]]:
        """The ``serve/*`` spans as a queue-wait vs prefill vs decode
        breakdown: same aggregates as :meth:`rows`, but ``pct_serve`` is
        each phase's share of total serve-span time (the phases are
        sequential per request, so shares read as "where a request's
        latency went") and rows come in request order, not sorted by
        cost.  Empty when the timeline has no serving spans.  Pass
        precomputed :meth:`rows` output to skip re-aggregating a large
        timeline.
        """
        if rows is None:
            rows = self.rows()
        rows = [dict(r) for r in rows if r["name"].startswith("serve/")]
        total = sum(r["total_s"] for r in rows)
        order = {name: i for i, name in enumerate(self._SERVE_ORDER)}
        rows.sort(key=lambda r: (order.get(r["name"], len(order)),
                                 r["name"]))
        for row in rows:
            row["pct_serve"] = 100.0 * row["total_s"] / total if total else 0.0
        return rows

    def robustness_summary(self) -> Optional[Dict[str, object]]:
        """Aggregate the fault-tolerance spans into one post-mortem dict.

        ``retries``: per-``retry/<name>`` — calls that needed retrying,
        total attempts, and give-ups (from the ``attempts``/``outcome``
        attributes the policy stamps; first-try successes record no
        span, so these are exactly the interesting calls).
        ``shed``: deadline-exceeded serving requests (``serve/shed``).
        ``faults``: injected chaos faults per site (``fault/<site>``).
        ``drains``: preemption drains (``preempt/drain``).
        ``restore_fallbacks``: checkpoints skipped by the verified
        walk-back restore (``checkpoint/fallback`` — corrupt, partial,
        or unrestorable steps the resume stepped past).
        ``nonfinite``: the non-finite step quarantine —
        ``{"windows": N, "steps": M}`` from ``train/nonfinite_skip``
        spans (N bad dispatch windows, M skipped state updates).
        ``rollbacks``: divergence rollbacks to the last verified
        checkpoint (``train/rollback``).  None when the timeline shows
        no robustness activity at all.
        """
        retries: Dict[str, Dict[str, int]] = {}
        faults: Dict[str, int] = {}
        shed = 0
        drains = 0
        restore_fallbacks = 0
        nonfinite_windows = 0
        nonfinite_steps = 0
        rollbacks = 0
        for event in self.events:
            name = event.get("name", "")
            args = event.get("args") or {}
            if name.startswith("retry/"):
                row = retries.setdefault(
                    name[len("retry/"):],
                    {"calls": 0, "attempts": 0, "gave_up": 0},
                )
                row["calls"] += 1
                attempts = args.get("attempts")
                if isinstance(attempts, (int, float)):
                    row["attempts"] += int(attempts)
                if args.get("outcome") == "gave_up":
                    row["gave_up"] += 1
            elif name == "serve/shed":
                shed += 1
            elif name.startswith("fault/"):
                faults[name[len("fault/"):]] = (
                    faults.get(name[len("fault/"):], 0) + 1
                )
            elif name == "preempt/drain":
                drains += 1
            elif name == "checkpoint/fallback":
                restore_fallbacks += 1
            elif name == "train/nonfinite_skip":
                nonfinite_windows += 1
                skipped = args.get("skipped")
                nonfinite_steps += (
                    int(skipped) if isinstance(skipped, (int, float)) else 1
                )
            elif name == "train/rollback":
                rollbacks += 1
        if (not retries and not faults and not shed and not drains
                and not restore_fallbacks and not nonfinite_windows
                and not rollbacks):
            return None
        return {
            "retries": retries, "shed": shed, "faults": faults,
            "drains": drains, "restore_fallbacks": restore_fallbacks,
            "nonfinite": {"windows": nonfinite_windows,
                          "steps": nonfinite_steps},
            "rollbacks": rollbacks,
        }

    def qos_summary(self) -> Optional[Dict[str, object]]:
        """Aggregate the per-request QoS spans into a per-class SLO
        table.

        ``serve/request`` spans exist only on QoS-armed engines (one
        per retired request, duration = end-to-end latency, ``ttft_s``
        attribute = submit -> first token); grouping by the
        ``priority`` attribute yields per-class request counts and
        TTFT / latency p50/p99 — the numbers class weights, SLO
        targets, and quotas are tuned against.  None when the timeline
        has no QoS spans (FIFO engine, or a non-serving trace).
        """
        by_class: Dict[str, Dict[str, List[float]]] = {}
        for event in self.events:
            if event.get("name") != "serve/request":
                continue
            args = event.get("args") or {}
            priority = args.get("priority")
            if priority is None:
                # Traced FIFO requests also emit a terminal
                # serve/request span (it anchors the per-request
                # lifecycle) but carry no priority — they belong to
                # request_summary(), not to a phantom QoS class.
                continue
            name = str(priority)
            row = by_class.setdefault(
                name, {"ttft": [], "latency": []}
            )
            row["latency"].append(event["dur"] / 1e6)
            ttft = args.get("ttft_s")
            if isinstance(ttft, (int, float)):
                row["ttft"].append(float(ttft))
        if not by_class:
            return None
        classes = {}
        for name, row in by_class.items():
            ttft = sorted(row["ttft"])
            latency = sorted(row["latency"])
            classes[name] = {
                "requests": len(latency),
                "ttft_p50_s": _percentile(ttft, 0.5) if ttft else None,
                "ttft_p99_s": _percentile(ttft, 0.99) if ttft else None,
                "latency_p50_s": _percentile(latency, 0.5),
                "latency_p99_s": _percentile(latency, 0.99),
            }
        return {"classes": classes}

    def fleet_summary(self) -> Optional[Dict[str, object]]:
        """Aggregate the serving-fleet spans into one operations dict.

        ``replicas``: per-replica-id — requests routed there (one
        ``fleet/route`` span each) plus mean load and mean occupancy
        from the attributes the router stamps per decision.
        ``occupancy_spread``: max - min of the per-replica mean
        occupancies (an unbalanced fleet wastes exactly this much of
        its best replica's amortization) — None until two replicas
        report occupancy.  Plus counts of ``fleet/failover``,
        ``fleet/restart``, ``fleet/shed``, and ``fleet/scale`` events
        by direction.  None when the timeline has no fleet spans.
        """
        replicas: Dict[object, Dict[str, float]] = {}
        failovers = 0
        restarts = 0
        shed = 0
        scale = {"up": 0, "down": 0}
        seen = False
        for event in self.events:
            name = event.get("name", "")
            if not name.startswith("fleet/"):
                continue
            seen = True
            args = event.get("args") or {}
            if name == "fleet/route":
                row = replicas.setdefault(args.get("replica"), {
                    "requests": 0, "load_sum": 0.0, "load_n": 0,
                    "occ_sum": 0.0, "occ_n": 0,
                })
                row["requests"] += 1
                if isinstance(args.get("load"), (int, float)):
                    row["load_sum"] += args["load"]
                    row["load_n"] += 1
                if isinstance(args.get("occupancy"), (int, float)):
                    row["occ_sum"] += args["occupancy"]
                    row["occ_n"] += 1
            elif name == "fleet/failover":
                failovers += 1
            elif name == "fleet/restart":
                restarts += 1
            elif name == "fleet/shed":
                shed += 1
            elif name == "fleet/scale":
                direction = args.get("direction")
                if direction in scale:
                    scale[direction] += 1
        if not seen:
            return None
        per_replica = {}
        occupancies = []
        for rid, row in replicas.items():
            mean_occ = (
                row["occ_sum"] / row["occ_n"] if row["occ_n"] else None
            )
            if mean_occ is not None:
                occupancies.append(mean_occ)
            per_replica[rid] = {
                "requests": int(row["requests"]),
                "mean_load": (
                    row["load_sum"] / row["load_n"] if row["load_n"]
                    else None
                ),
                "mean_occupancy": mean_occ,
            }
        spread = (
            max(occupancies) - min(occupancies)
            if len(occupancies) >= 2 else None
        )
        return {
            "replicas": per_replica,
            "failovers": failovers,
            "restarts": restarts,
            "shed": shed,
            "scale": scale,
            "occupancy_spread": spread,
        }

    # -- per-request trace stitching ------------------------------------

    #: Prefill-phase span names charged to the "prefill" TTFT component
    #: (batch prefill, chunked prefill, and the finalize insert).
    _PREFILL_SPANS = (
        "serve/prefill", "serve/prefill_chunk", "serve/prefill_finalize",
    )

    def trace_spans(self, trace_id: str) -> List[dict]:
        """Every span stitched under ``trace_id``, in start order.

        A span belongs to a trace either directly (its ``trace_id``
        attribute — fleet/route, serve/request, serve/queue_wait, ...)
        or through the ``traces`` slot map the continuous scheduler
        stamps on shared dispatches (serve/chunk, serve/verify serve
        many slots at once; the map says which requests rode along).
        """
        wanted = str(trace_id)
        spans = []
        for event in self.events:
            args = event.get("args") or {}
            tid = args.get("trace_id")
            if tid is not None and str(tid) == wanted:
                spans.append(event)
                continue
            traces = args.get("traces")
            if isinstance(traces, dict) and any(
                    str(t) == wanted for t in traces.values()):
                spans.append(event)
        spans.sort(key=lambda e: e["ts"])
        return spans

    def _spans_by_trace(self) -> Dict[str, List[dict]]:
        by_trace: Dict[str, List[dict]] = {}
        for event in self.events:
            args = event.get("args") or {}
            tid = args.get("trace_id")
            if tid is not None:
                by_trace.setdefault(str(tid), []).append(event)
            traces = args.get("traces")
            if isinstance(traces, dict):
                for tid in {str(t) for t in traces.values()}:
                    by_trace.setdefault(tid, []).append(event)
        return by_trace

    def request_summary(self) -> Optional[Dict[str, dict]]:
        """Per-request lifecycle, stitched by ``trace_id``.

        One row per traced request (fleet or engine submissions made
        with tracing active), with the milestone gaps of its life as
        durations in seconds:

        * ``queue_s`` — fleet-queue wait before the first routing
          attempt (the attempt-1 ``fleet/route`` span's ``queue_s``
          attribute; None on engine-only timelines).
        * ``route_s`` / ``routes`` — total routing time and attempt
          count; ``failovers`` counts ``fleet/failover`` re-admissions.
        * ``engine_queue_s`` — admission waits inside the engine(s).
        * ``swapin_s`` — host-DRAM prefix swap-in stall paid at
          admission.
        * ``prefill_s`` — prefill compute (batch, chunked, finalize).
        * ``ttft_s`` / ``latency_s`` / ``tokens`` — from the terminal
          ``serve/request`` span (engine-clock TTFT, end-to-end
          latency, emitted tokens); ``fleet_ttft_s`` adds the fleet
          queue + routing time on top of the engine TTFT.
        * ``chunks`` — shared decode dispatches the request rode
          (via the slot map); ``spec_accepted`` — draft tokens the
          verify dispatches it participated in committed (batch-level:
          a shared verify credits every rider).
        * ``handoff_s`` / ``handoffs`` — disaggregated-serving KV
          transport time (``serve/kv_handoff`` export/import dispatches
          plus the fleet's ``fleet/handoff`` stash) and the number of
          prefill->decode handoffs; ``prefill_leg_s`` — the prefill
          leg's full service time (its non-final ``serve/request``
          terminals).  All zero on colocated timelines.
        * ``shed`` — the request hit a shed span; ``complete`` — a
          terminal ``serve/request`` span exists.

        Rows degrade gracefully when the ring buffer evicted early
        spans: missing milestones are None (or 0 for counters), and
        ``complete`` only needs the terminal span.  None when the
        timeline carries no trace ids at all.
        """
        by_trace = self._spans_by_trace()
        if not by_trace:
            return None
        requests: Dict[str, dict] = {}
        for tid, spans in sorted(by_trace.items()):
            routes = [e for e in spans if e["name"] == "fleet/route"]
            terminals = [
                e for e in spans if e["name"] == "serve/request"
            ]
            queue_s = next(
                (
                    (e.get("args") or {}).get("queue_s")
                    for e in routes
                    if isinstance((e.get("args") or {}).get("queue_s"),
                                  (int, float))
                ),
                None,
            )

            def total_of(*names):
                return sum(
                    e["dur"] / 1e6 for e in spans if e["name"] in names
                )

            spec_accepted = 0
            for event in spans:
                if event["name"] != "serve/verify":
                    continue
                accepted = (event.get("args") or {}).get("accepted")
                if isinstance(accepted, (int, float)):
                    spec_accepted += int(accepted)
            row = {
                "spans": len(spans),
                "routes": len(routes),
                "failovers": sum(
                    1 for e in spans if e["name"] == "fleet/failover"
                ),
                "queue_s": queue_s,
                "route_s": total_of("fleet/route"),
                "engine_queue_s": total_of("serve/queue_wait"),
                "swapin_s": total_of("serve/prefix_swapin"),
                "prefill_s": total_of(*self._PREFILL_SPANS),
                "chunks": sum(
                    1 for e in spans if e["name"] == "serve/chunk"
                ),
                "spec_accepted": spec_accepted,
                "handoff_s": total_of("serve/kv_handoff",
                                      "fleet/handoff"),
                "handoffs": sum(
                    1 for e in spans if e["name"] == "fleet/handoff"
                ),
                "prefill_leg_s": 0.0,
                "shed": any(
                    e["name"] in ("serve/shed", "fleet/shed")
                    for e in spans
                ),
                "ttft_s": None,
                "fleet_ttft_s": None,
                "latency_s": None,
                "tokens": None,
                "complete": bool(terminals),
            }
            if terminals:
                # Re-admitted requests keep one trace identity; the
                # engine that actually finished them retired them last.
                terminal = max(terminals, key=lambda e: e["ts"])
                args = terminal.get("args") or {}
                row["latency_s"] = terminal["dur"] / 1e6
                if row["handoffs"]:
                    # Disaggregated request: the earlier terminals are
                    # its prefill leg(s) — service time the decode
                    # leg's own TTFT never saw.  Colocated rows (no
                    # handoff spans) keep this at exactly 0.0 even
                    # across failover re-runs, whose earlier terminals
                    # are retries, not legs.
                    row["prefill_leg_s"] = sum(
                        e["dur"] / 1e6 for e in terminals
                        if e is not terminal
                    )
                ttft = args.get("ttft_s")
                if isinstance(ttft, (int, float)):
                    row["ttft_s"] = float(ttft)
                    row["fleet_ttft_s"] = (
                        float(ttft) + (queue_s or 0.0) + row["route_s"]
                        + row["prefill_leg_s"]
                    )
                tokens = args.get("tokens")
                if isinstance(tokens, (int, float)):
                    row["tokens"] = int(tokens)
            requests[tid] = row
        return requests

    #: The TTFT components, in lifecycle order (render + bench key
    #: order; first_decode is the remainder after the attributable
    #: phases).
    TTFT_COMPONENTS = (
        "queue", "route", "swapin", "prefill", "handoff", "first_decode",
    )

    def ttft_decomposition(
            self, summary: Optional[Dict[str, dict]] = None,
    ) -> Optional[Dict[str, object]]:
        """Fleet-level TTFT attribution across all stitched requests.

        For every traced request with a terminal span, fleet TTFT is
        ``queue_s + route_s + engine ttft_s`` and decomposes into:

        * ``queue`` — fleet-queue wait plus engine admission waits,
        * ``route`` — routing decisions (all attempts),
        * ``swapin`` — host-DRAM prefix swap-in stalls,
        * ``prefill`` — prefill compute,
        * ``handoff`` — disaggregated KV transport (export/import
          dispatches plus the host-pool stash; 0 on colocated
          timelines, whose totals are unchanged),
        * ``first_decode`` — the remainder (scheduler slack + the first
          decode step), clamped at zero.

        Disaggregated requests count their prefill leg's service time
        (``prefill_leg_s``) inside the total: fleet TTFT is the time
        the CALLER waited for the first decode-leg token, wherever the
        work ran.

        Returns per-component **shares** of fleet TTFT at p50/p99
        across requests, plus the fleet-TTFT percentiles themselves —
        the distributional gate the chaos harness and the QPS sweep
        check instead of raw percentiles (a regression that moves time
        *between* phases at equal TTFT still shows here).  None when no
        request decomposes (tracing off, or all terminals evicted).
        Pass a precomputed :meth:`request_summary` to skip restitching.
        """
        if summary is None:
            summary = self.request_summary()
        if not summary:
            return None
        shares: Dict[str, List[float]] = {
            name: [] for name in self.TTFT_COMPONENTS
        }
        totals: List[float] = []
        for row in summary.values():
            if row["ttft_s"] is None:
                continue
            queue = (row["queue_s"] or 0.0) + row["engine_queue_s"]
            route = row["route_s"]
            total = (
                (row["queue_s"] or 0.0) + route
                + row.get("prefill_leg_s", 0.0) + row["ttft_s"]
            )
            if total <= 0:
                continue
            components = {
                "queue": queue,
                "route": route,
                "swapin": row["swapin_s"],
                "prefill": row["prefill_s"],
                "handoff": row.get("handoff_s", 0.0),
            }
            components["first_decode"] = max(
                total - sum(components.values()), 0.0
            )
            totals.append(total)
            for name, value in components.items():
                shares[name].append(value / total)
        if not totals:
            return None
        totals.sort()
        return {
            "requests": len(totals),
            "ttft_p50_s": _percentile(totals, 0.5),
            "ttft_p99_s": _percentile(totals, 0.99),
            "shares": {
                name: {
                    "p50": _percentile(sorted(values), 0.5),
                    "p99": _percentile(sorted(values), 0.99),
                }
                for name, values in shares.items()
            },
        }

    def render_trace(self, trace_id: str) -> Optional[str]:
        """One request's stitched lifecycle as text (the ``--trace``
        drill-down): every span in start order with offset, duration
        and attributes, then the request's summary row.  None when the
        timeline holds no span for the id."""
        spans = self.trace_spans(trace_id)
        if not spans:
            return None
        t0 = spans[0]["ts"]
        lines = [f"trace {trace_id}: {len(spans)} span(s)"]
        for event in spans:
            args = dict(event.get("args") or {})
            for noise in ("trace_id", "traces", "span_id", "parent_id"):
                args.pop(noise, None)
            attrs = " ".join(
                f"{k}={v}" for k, v in sorted(args.items())
            )
            offset = _fmt_s((event["ts"] - t0) / 1e6)
            lines.append(
                f"  +{offset:>8}  {event['name']:<24}"
                f"  {_fmt_s(event['dur'] / 1e6):>8}"
                + (f"  {attrs}" if attrs else "")
            )
        row = (self.request_summary() or {}).get(str(trace_id))
        if row:
            parts = [
                f"routes {row['routes']}",
                f"failovers {row['failovers']}",
            ]
            if row["ttft_s"] is not None:
                parts.append(f"engine ttft {_fmt_s(row['ttft_s'])}")
            if row["fleet_ttft_s"] is not None:
                parts.append(
                    f"fleet ttft {_fmt_s(row['fleet_ttft_s'])}"
                )
            if row["latency_s"] is not None:
                parts.append(f"latency {_fmt_s(row['latency_s'])}")
            if row["tokens"] is not None:
                parts.append(f"{row['tokens']} tokens")
            if row["spec_accepted"]:
                parts.append(
                    f"{row['spec_accepted']} spec-accepted tokens"
                )
            if row["shed"]:
                parts.append("SHED")
            if not row["complete"]:
                parts.append("incomplete (no terminal span)")
            lines.append("  " + " · ".join(parts))
        return "\n".join(lines)

    @staticmethod
    def _render_table(rows, header) -> List[str]:
        table = [header] + rows
        widths = [max(len(row[i]) for row in table) for i in range(len(header))]
        lines = []
        for i, row in enumerate(table):
            lines.append("  ".join(
                cell.ljust(w) if j == 0 else cell.rjust(w)
                for j, (cell, w) in enumerate(zip(row, widths))
            ))
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
        return lines

    def render(self) -> str:
        rows = self.rows()
        header = ("span", "count", "total", "mean", "p50", "max", "% wall")
        lines = self._render_table([
            (
                r["name"],
                str(r["count"]),
                _fmt_s(r["total_s"]),
                _fmt_s(r["mean_s"]),
                _fmt_s(r["p50_s"]),
                _fmt_s(r["max_s"]),
                f"{r['pct_wall']:.1f}",
            )
            for r in rows
        ], header)
        serve_rows = self.serving_rows(rows)
        if serve_rows:
            lines.append("")
            lines.append("serving breakdown (per-request phases, % of "
                         "serve time):")
            lines.extend(self._render_table([
                (
                    r["name"],
                    str(r["count"]),
                    _fmt_s(r["total_s"]),
                    _fmt_s(r["mean_s"]),
                    _fmt_s(r["p50_s"]),
                    _fmt_s(r["max_s"]),
                    f"{r['pct_serve']:.1f}",
                )
                for r in serve_rows
            ], ("phase", "count", "total", "mean", "p50", "max",
                "% serve")))
        robustness = self.robustness_summary()
        if robustness:
            lines.append("")
            lines.append("robustness (retries, shedding, faults, drains):")
            for name, row in sorted(robustness["retries"].items()):
                detail = (
                    f"  retry/{name}: {row['calls']} retried call(s), "
                    f"{row['attempts']} attempts"
                )
                if row["gave_up"]:
                    detail += f", {row['gave_up']} gave up"
                lines.append(detail)
            if robustness["shed"]:
                lines.append(
                    f"  shed requests (deadline exceeded): "
                    f"{robustness['shed']}"
                )
            for site, count in sorted(robustness["faults"].items()):
                lines.append(f"  injected fault {site}: x{count}")
            if robustness["drains"]:
                lines.append(
                    f"  preemption drains: {robustness['drains']}"
                )
            if robustness["restore_fallbacks"]:
                lines.append(
                    f"  checkpoint restore fallbacks (walk-back): "
                    f"{robustness['restore_fallbacks']}"
                )
            nonfinite = robustness["nonfinite"]
            if nonfinite["windows"]:
                lines.append(
                    f"  non-finite updates skipped: {nonfinite['steps']} "
                    f"step(s) over {nonfinite['windows']} window(s)"
                )
            if robustness["rollbacks"]:
                lines.append(
                    f"  divergence rollbacks to verified checkpoint: "
                    f"{robustness['rollbacks']}"
                )
        fleet = self.fleet_summary()
        if fleet:
            lines.append("")
            lines.append("fleet (routing, supervision, scaling):")
            for rid in sorted(fleet["replicas"], key=str):
                row = fleet["replicas"][rid]
                detail = f"  replica {rid}: {row['requests']} request(s)"
                if row["mean_load"] is not None:
                    detail += f", mean load {row['mean_load']:.2f}"
                if row["mean_occupancy"] is not None:
                    detail += f", mean occupancy {row['mean_occupancy']:.1%}"
                lines.append(detail)
            events_line = (
                f"  failovers: {fleet['failovers']} · restarts: "
                f"{fleet['restarts']} · scale up x{fleet['scale']['up']} / "
                f"down x{fleet['scale']['down']}"
            )
            if fleet["shed"]:
                events_line += f" · shed {fleet['shed']}"
            lines.append(events_line)
            if fleet["occupancy_spread"] is not None:
                lines.append(
                    f"  occupancy spread across replicas: "
                    f"{fleet['occupancy_spread']:.1%}"
                )
        qos = self.qos_summary()
        if qos:
            lines.append("")
            lines.append("QoS classes (per-class TTFT / latency):")
            for name in sorted(qos["classes"]):
                row = qos["classes"][name]
                detail = f"  {name}: {row['requests']} request(s)"
                if row["ttft_p50_s"] is not None:
                    detail += (
                        f", ttft p50 {_fmt_s(row['ttft_p50_s'])} / "
                        f"p99 {_fmt_s(row['ttft_p99_s'])}"
                    )
                detail += (
                    f", latency p50 {_fmt_s(row['latency_p50_s'])} / "
                    f"p99 {_fmt_s(row['latency_p99_s'])}"
                )
                lines.append(detail)
        summary = self.request_summary()
        if summary:
            complete = sum(1 for r in summary.values() if r["complete"])
            failed_over = sum(
                1 for r in summary.values() if r["failovers"]
            )
            shed_traces = sum(1 for r in summary.values() if r["shed"])
            line = (
                f"traced requests: {len(summary)} · {complete} complete"
            )
            if failed_over:
                line += f" · {failed_over} failed over"
            if shed_traces:
                line += f" · {shed_traces} shed"
            lines.append("")
            lines.append(line)
        decomposition = self.ttft_decomposition(summary)
        if decomposition:
            lines.append("")
            lines.append(
                f"TTFT decomposition ({decomposition['requests']} traced "
                "request(s), share of fleet TTFT):"
            )
            lines.extend(self._render_table([
                (
                    name,
                    f"{decomposition['shares'][name]['p50'] * 100:.1f}",
                    f"{decomposition['shares'][name]['p99'] * 100:.1f}",
                )
                for name in self.TTFT_COMPONENTS
            ], ("component", "% p50", "% p99")))
            lines.append(
                f"  fleet ttft p50 {_fmt_s(decomposition['ttft_p50_s'])}"
                f" / p99 {_fmt_s(decomposition['ttft_p99_s'])}"
            )
        continuous = self.continuous_summary()
        if continuous:
            parts = [f"{continuous['chunks']} chunks"]
            if continuous["mean_occupancy"] is not None:
                parts.append(
                    f"mean occupancy {continuous['mean_occupancy']:.1%}"
                )
            if continuous.get("slice"):
                slice_part = f"slice {continuous['slice']}"
                if continuous.get("slice_chips"):
                    slice_part += (
                        f" ({continuous['slice_chips']:.0f} chips)"
                    )
                parts.append(slice_part)
            if continuous["mean_active"] is not None:
                active = f"mean active {continuous['mean_active']:.1f}"
                if continuous["slots"]:
                    active += f"/{continuous['slots']:.0f} slots"
                parts.append(active)
            if continuous["tokens"] is not None:
                parts.append(f"{continuous['tokens']:.0f} tokens")
            if continuous.get("bubble_fraction") is not None:
                parts.append(
                    f"host bubble {continuous['bubble_fraction']:.1%}"
                )
            lines.append("")
            lines.append("continuous batching: " + " · ".join(parts))
        spec = self.spec_summary()
        if spec:
            parts = [f"{spec['verify_dispatches']} verify dispatches"]
            if spec["acceptance_rate"] is not None:
                parts.append(
                    f"accept rate {spec['acceptance_rate']:.1%}"
                )
            if spec["tokens"]:
                parts.append(f"{spec['tokens']} tokens committed")
            parts.append(
                f"draft {_fmt_s(spec['draft_seconds'])} / verify "
                f"{_fmt_s(spec['verify_seconds'])}"
            )
            lines.append("")
            lines.append("speculative decoding: " + " · ".join(parts))
        prefix = self.prefix_summary()
        if prefix:
            parts = []
            if prefix["lookups"]:
                parts.append(
                    f"{prefix['lookups']} lookups · "
                    f"{prefix['hit_rate']:.1%} hit rate · "
                    f"{prefix['hit_tokens']} hit tokens"
                )
            lines.append("")
            lines.append(
                "prefix cache: " + (" · ".join(parts) if parts else "off")
            )
            if prefix["dram_hits"] or prefix["swapins"]:
                tier_parts = [
                    f"{prefix['hbm_hits']} hbm hits",
                    f"{prefix['dram_hits']} dram swap-in hits",
                ]
                if prefix["swapins"]:
                    tier_parts.append(
                        f"{prefix['swapins']} swap-ins "
                        f"({prefix['swapin_blocks']} blocks, "
                        f"{_fmt_s(prefix['swapin_seconds'])} total)"
                    )
                    tier_parts.append(
                        "max swap-in stall "
                        f"{_fmt_s(prefix['max_swapin_stall_seconds'])}"
                    )
                lines.append("prefix tiers: " + " · ".join(tier_parts))
            if prefix["prefill_chunks"]:
                lines.append(
                    f"chunked prefill: {prefix['prefill_chunks']} chunks · "
                    f"{_fmt_s(prefix['prefill_chunk_seconds'])} total · "
                    "max decode stall "
                    f"{_fmt_s(prefix['max_decode_stall_seconds'])}"
                )
        lines.append("")
        lines.append(
            f"{len(self.events)} spans over {_fmt_s(self.wall_seconds())} "
            "of timeline"
        )
        return "\n".join(lines)


def _fmt_s(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:.2f}s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.1f}ms"
    return f"{seconds * 1e6:.0f}us"


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m cloud_tpu_torch.monitoring.report",
        description="Summarize a tracing.dump_timeline() Chrome-trace file.",
    )
    parser.add_argument("timeline", help="path to timeline.json")
    parser.add_argument(
        "--trace", metavar="ID", default=None,
        help="render one traced request's stitched lifecycle (every "
             "span carrying this trace_id, plus the shared dispatches "
             "it rode) instead of the timeline summary",
    )
    args = parser.parse_args(argv)
    try:
        report = TraceReport.from_file(args.timeline)
    except (OSError, ValueError, KeyError) as exc:
        print(f"could not read {args.timeline!r}: {exc}", file=sys.stderr)
        return 2
    if not report.events:
        print("no spans in timeline (was tracing enabled?)")
        return 0
    if args.trace is not None:
        rendered = report.render_trace(args.trace)
        if rendered is None:
            print(
                f"trace {args.trace!r} not found in timeline "
                "(was tracing enabled on the fleet?)",
                file=sys.stderr,
            )
            return 2
        print(rendered)
        return 0
    print(report.render())
    return 0


if __name__ == "__main__":
    sys.exit(main())
