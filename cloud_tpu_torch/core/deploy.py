"""Deployment: emit and submit Cloud TPU VM job specs (the port's copy of
``cloud_tpu/core/deploy.py``).

Node bodies and startup scripts are the reference's, byte for byte, for
the same inputs: the startup script names no framework.  It pulls the
image and runs its ENTRYPOINT (the port's ``core/bootstrap.py``) with the
``CLOUD_TPU_*`` process contract (coordinator, process count, rank), the
monitoring and profiler gates, ``CLOUD_TPU_SUBMIT_TS`` and
``CLOUD_TPU_COMPILE_CACHE``; inside the container
``parallel.distributed.initialize_from_env`` turns the contract into a
``torch.distributed`` process group.  ``deploy_job`` keeps the
reference's retry policy and rollback, ``supervise_job`` its restart
budget, ``stream_logs`` its cursor.
"""

from __future__ import annotations

import logging
import os
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence

from cloud_tpu_torch.core import gcp, machine_config
from cloud_tpu_torch.parallel import planner
from cloud_tpu_torch.utils import api_client, retries

logger = logging.getLogger(__name__)

_TPU_API = "https://tpu.googleapis.com/v2"

#: Node-create LRO poll budget (creation request acknowledged).
_LRO_POLL_INTERVAL_SECONDS = 5
_LRO_POLL_ATTEMPTS = 60
#: Node READY-state poll budget — the analogue of the reference's TPU
#: provisioning wait, 40 x 10 s (preprocess.py:238-261).
_READY_POLL_INTERVAL_SECONDS = 10
_READY_POLL_ATTEMPTS = 40


def _poll_sleep(sleep: Callable[[float], None], seconds: float) -> None:
    """All fixed-interval poll waits go through here, ±20% jittered:
    recreated multi-node jobs boot near-simultaneously, and without
    jitter their supervisors/awaits poll the API in lockstep forever.
    The injectable ``sleep`` seam is preserved (tests stay instant and
    can assert the base interval from the jittered value)."""
    sleep(retries.jittered(seconds))


def _deploy_retry_policy(sleep: Callable[[float], None]) -> retries.RetryPolicy:
    """Deploy-layer policy over the SESSION's own retries: coarser
    backoff for polls that may legitimately run for minutes, threaded
    through the same injectable ``sleep`` the poll loops use."""
    return retries.default_api_policy(
        max_attempts=5, initial_backoff_s=1.0, max_backoff_s=20.0,
        max_elapsed_s=120.0, sleep=sleep,
    )


class ProvisioningError(RuntimeError):
    """A TPU node failed to provision; partial slices were rolled back."""


def _job_id() -> str:
    """cloud_tpu_train_<uuid> (reference deploy.py:214-218)."""
    return f"cloud-tpu-train-{uuid.uuid4().hex[:8]}"


def startup_script(
    image_uri: str,
    *,
    coordinator_address: str,
    num_processes: int,
    process_id_base: int,
    monitoring: bool = True,
    profiler_port: Optional[int] = None,
    submit_ts: Optional[float] = None,
    compile_cache: Optional[str] = None,
) -> str:
    """TPU-VM startup script: pull + run the training container on each host.

    ``process_id_base`` is the rank of this node's host 0; TPU VM metadata
    exposes the within-node worker index as ``agent-worker-number``, so the
    global rank is base + local index.  This replaces the reference's
    resolver-wait prologue (preprocess.py:215-262) — topology is fully
    determined before boot.

    ``monitoring=True`` (default) passes the exporter's enabling env pair
    into the container so every deployed job exports runtime metrics with
    zero user code — the reference registered its exporter into the
    runtime and had the job spec set the env gate
    (stackdriver_exporter.cc:31-36,128).  The project id is read from the
    VM metadata server at boot (the node's own project is where its time
    series belong), so building this script needs no ADC locally.
    ``profiler_port`` additionally gates the on-demand profiler server
    (bootstrap reads CLOUD_TPU_PROFILER_PORT; --net=host exposes it).
    ``submit_ts`` (wall-clock unix seconds of run()'s submission) rides
    into the container as CLOUD_TPU_SUBMIT_TS so the remote trainer's
    first completed step can publish the true end-to-end
    ``run/submit_to_first_step_seconds`` gauge (monitoring.tracing).
    ``compile_cache`` (default: the submitting process's
    ``CLOUD_TPU_COMPILE_CACHE``) forwards the persistent-compile-cache
    directory into the container — a container-local path, where the
    bootstrap's safety probe decides whether to actually enable it
    (training.compile_cache); pass ``""`` to suppress forwarding.
    """
    if compile_cache is None:
        compile_cache = os.environ.get("CLOUD_TPU_COMPILE_CACHE", "")
    lines = [
        "#! /bin/bash",
        "set -ex",
        'LOCAL_ID=$(curl -sf -H "Metadata-Flavor: Google" '
        '"http://metadata.google.internal/computeMetadata/v1/instance/'
        'attributes/agent-worker-number" || echo 0)',
    ]
    if monitoring:
        lines.append(
            'PROJECT_ID=$(curl -sf -H "Metadata-Flavor: Google" '
            '"http://metadata.google.internal/computeMetadata/v1/project/'
            'project-id" || echo "")'
        )
    lines += [
        f"docker pull {image_uri}",
        "docker run --privileged --net=host \\",
        f"  -e CLOUD_TPU_COORDINATOR={coordinator_address} \\",
        f"  -e CLOUD_TPU_NUM_PROCESSES={num_processes} \\",
        f"  -e CLOUD_TPU_PROCESS_ID=$(({process_id_base} + LOCAL_ID)) \\",
    ]
    if monitoring:
        lines += [
            "  -e CLOUD_TPU_MONITORING_ENABLED=1 \\",
            "  -e CLOUD_TPU_MONITORING_PROJECT_ID=$PROJECT_ID \\",
        ]
    if profiler_port:
        lines.append(f"  -e CLOUD_TPU_PROFILER_PORT={int(profiler_port)} \\")
    if submit_ts is not None:
        lines.append(f"  -e CLOUD_TPU_SUBMIT_TS={submit_ts!r} \\")
    if compile_cache:
        import shlex

        # First arbitrary user-environment string baked into this root
        # startup script: quote it, or a space truncates the docker line
        # and shell metacharacters execute on the TPU VM.
        lines.append(
            "  -e "
            + shlex.quote(f"CLOUD_TPU_COMPILE_CACHE={compile_cache}")
            + " \\"
        )
    lines.append(f"  {image_uri}")
    return "\n".join(lines)


def build_node_request(
    image_uri: str,
    config: machine_config.MachineConfig,
    *,
    coordinator_address: str,
    num_processes: int,
    process_id_base: int,
    job_labels: Optional[Dict[str, str]] = None,
    service_account: Optional[str] = None,
    monitoring: bool = True,
    profiler_port: Optional[int] = None,
    submit_ts: Optional[float] = None,
    compile_cache: Optional[str] = None,
) -> dict:
    """The TPU v2 API Node body for one slice (golden-tested)."""
    topo = config.tpu_topology()
    node: dict = {
        "acceleratorType": topo.accelerator_type,
        "runtimeVersion": gcp.TPU_RUNTIME_VERSIONS[config.accelerator_type],
        "metadata": {
            "startup-script": startup_script(
                image_uri,
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id_base=process_id_base,
                monitoring=monitoring,
                profiler_port=profiler_port,
                submit_ts=submit_ts,
                compile_cache=compile_cache,
            )
        },
        "labels": dict(job_labels or {}),
    }
    if service_account:
        node["serviceAccount"] = {"email": service_account}
    return node


def build_job_request(
    image_uri: str,
    chief_config: machine_config.MachineConfig,
    worker_count: int,
    plan: planner.MeshPlan,
    *,
    job_id: Optional[str] = None,
    job_labels: Optional[Dict[str, str]] = None,
    service_account: Optional[str] = None,
    monitoring: bool = True,
    profiler_port: Optional[int] = None,
    submit_ts: Optional[float] = None,
    compile_cache: Optional[str] = None,
) -> dict:
    """All node bodies for a (multi-)slice job, keyed by node id.

    Slice i's hosts get ranks [i * hosts_per_slice, (i+1) * hosts_per_slice);
    the coordinator is slice 0 host 0, reachable by node DNS name.
    """
    job_id = job_id or _job_id()
    num_slices = worker_count + 1
    hosts_per_slice = plan.hosts_per_slice
    num_processes = num_slices * hosts_per_slice
    coordinator = f"{job_id}-0-w0:8476"
    nodes = {}
    for i in range(num_slices):
        nodes[f"{job_id}-{i}"] = build_node_request(
            image_uri,
            chief_config,
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id_base=i * hosts_per_slice,
            job_labels={**(job_labels or {}), "cloud_tpu_job": job_id},
            service_account=service_account,
            monitoring=monitoring,
            profiler_port=profiler_port,
            submit_ts=submit_ts,
            compile_cache=compile_cache,
        )
    return {"job_id": job_id, "nodes": nodes}


def build_serve_fleet_request(
    image_uri: str,
    replica_config: machine_config.MachineConfig,
    num_replicas: int,
    plan: planner.MeshPlan,
    *,
    job_id: Optional[str] = None,
    job_labels: Optional[Dict[str, str]] = None,
    service_account: Optional[str] = None,
    monitoring: bool = True,
    profiler_port: Optional[int] = None,
    submit_ts: Optional[float] = None,
    compile_cache: Optional[str] = None,
    roles: Optional[Sequence[str]] = None,
) -> dict:
    """Node bodies for a serve FLEET: N independent single-slice replicas.

    The topology deliberately inverts :func:`build_job_request`'s.  A
    training job is ONE jax_graft process group — every slice dials the
    same coordinator, so losing any slice stalls the whole job.  A serve
    fleet is N *separate* process groups: replica i's coordinator is its
    own host 0 (``<node>-w0``), process ids restart at 0 per replica, so
    replicas boot, fail, restart, and scale independently — exactly the
    unit ``fleet.Fleet`` routes over and its supervisor
    recreates.  Node ids are ``<job_id>-r<i>`` and every node carries
    ``cloud_tpu_role: serve-replica`` plus its ``cloud_tpu_replica``
    index, so a fronting router (or ``supervise_job``-style tooling) can
    enumerate the fleet by label.  The same request shape deploys through
    :func:`deploy_job` (each replica is just a node create).

    Since sharded serving (one replica = one multi-chip slice) the wire
    format also records the SLICE TOPOLOGY explicitly: each replica node
    is a ``workers_per_replica``-host jax_graft process group over
    ``chips_per_replica`` chips, with its own coordinator (host 0 of its
    own slice) — the ``slice_topology`` block carries worker count, chip
    count, and the per-replica coordinator map, so fleet tooling can
    size health checks and dial slices without parsing startup scripts.
    A single-chip fleet degenerates to ``workers_per_replica=1`` with
    the same schema.

    ``roles`` is the disaggregated prefill/decode assignment, one of
    ``"prefill" | "decode" | "both"`` per replica index (padded with
    ``"both"`` when shorter than the fleet; validated by
    ``fleet.disagg.validate_roles`` — a split fleet must keep at least
    one replica on each side).  The ``slice_topology`` block grows a
    ``roles`` axis (node id -> role) and each node carries its role as
    the ``cloud_tpu_serve_role`` label, so a fronting router can
    enumerate the prefill and decode pools by label alone.  ``None``
    (the default) records every replica as ``"both"`` — the colocated
    fleet, same schema.
    """
    from cloud_tpu_torch.fleet import disagg

    if num_replicas < 1:
        raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
    if roles is not None and len(roles) > num_replicas:
        raise ValueError(
            f"roles has {len(roles)} entries for {num_replicas} replicas"
        )
    padded = list(roles or ())
    padded += ["both"] * (num_replicas - len(padded))
    padded = list(disagg.validate_roles(padded))
    job_id = job_id or _job_id()
    hosts = plan.hosts_per_slice
    nodes = {}
    coordinators = {}
    node_roles = {}
    for i in range(num_replicas):
        node_id = f"{job_id}-r{i}"
        coordinators[node_id] = f"{node_id}-w0:8476"
        node_roles[node_id] = padded[i]
        nodes[node_id] = build_node_request(
            image_uri,
            replica_config,
            coordinator_address=coordinators[node_id],
            num_processes=hosts,
            process_id_base=0,
            job_labels={
                **(job_labels or {}),
                "cloud_tpu_job": job_id,
                "cloud_tpu_role": "serve-replica",
                "cloud_tpu_replica": str(i),
                "cloud_tpu_serve_role": padded[i],
            },
            service_account=service_account,
            monitoring=monitoring,
            profiler_port=profiler_port,
            submit_ts=submit_ts,
            compile_cache=compile_cache,
        )
    return {
        "job_id": job_id,
        "nodes": nodes,
        "role": "serve-fleet",
        "slice_topology": {
            "workers_per_replica": hosts,
            "chips_per_replica": plan.chips_per_slice,
            "coordinators": coordinators,
            "roles": node_roles,
        },
    }


def deploy_job(
    image_uri: str,
    chief_config: machine_config.MachineConfig,
    worker_count: int,
    plan: planner.MeshPlan,
    *,
    project: Optional[str] = None,
    zone: Optional[str] = None,
    job_labels: Optional[Dict[str, str]] = None,
    service_account: Optional[str] = None,
    monitoring: bool = True,
    profiler_port: Optional[int] = None,
    session: Optional[api_client.GcpApiSession] = None,
    stream_logs: bool = False,
    request: Optional[dict] = None,
    wait_for_ready: bool = True,
    sleep: Callable[[float], None] = time.sleep,
    retry: Optional[retries.RetryPolicy] = None,
) -> dict:
    """Create the TPU nodes for the job; returns job info incl. console URL.

    ``request`` may carry a prebuilt ``build_job_request`` result (run()
    builds one for its report; passing it here guarantees the submitted
    nodes are exactly the reported ones).

    ``retry`` (default: a deploy-grade :class:`retries.RetryPolicy`)
    absorbs transient API failures — 429/5xx/transport, surfaced as
    typed :class:`api_client.ApiTransientError` — around every submit
    POST and status poll, on top of whatever the session itself retries;
    permanent 4xx still fails (and rolls back) on the first attempt.

    Lifecycle (the part the reference delegated to CAIP's managed
    ``cloud_tpu`` worker — SURVEY.md §7 hard parts): each create's LRO is
    polled to completion, then the node is awaited READY under the
    reference's 40 x 10 s provisioning budget (preprocess.py:238-261).  If
    any slice fails, every already-created slice is deleted before the
    error propagates — a multi-slice job never leaks stray paid-for nodes.
    ``wait_for_ready=False`` degrades to fire-and-forget submission.
    """
    if not chief_config.is_tpu():
        raise NotImplementedError(
            "deploy_job launches Cloud TPU jobs; CPU-only/chief-off-slice "
            "jobs are not yet supported. "
            + (
                machine_config.gpu_migration_hint(chief_config)
                if chief_config.is_gpu()
                else ""
            )
        )
    project = project or gcp.get_project_name()
    zone = zone or gcp.get_zone(chief_config)
    session = session or api_client.default_session()
    if request is None:
        request = build_job_request(
            image_uri, chief_config, worker_count, plan,
            job_labels=job_labels, service_account=service_account,
            monitoring=monitoring, profiler_port=profiler_port,
        )
    retry = retry if retry is not None else _deploy_retry_policy(sleep)
    parent = f"projects/{project}/locations/{zone}"
    created: List[str] = []
    try:
        operations = {}
        for node_id, body in request["nodes"].items():
            # Appended BEFORE the POST: if the request reaches the API
            # but the response is lost (ambiguous transient), the node
            # may exist server-side — rollback must try to delete it
            # (a 404 for a never-created node is best-effort-swallowed).
            created.append(node_id)
            op = _create_node(session, parent, node_id, body, retry)
            operations[node_id] = op
            logger.info(
                "creating TPU node %s (%s)", node_id, body["acceleratorType"]
            )
        if wait_for_ready:
            for node_id, op in operations.items():
                _await_operation(session, op, node_id, sleep=sleep,
                                 retry=retry)
                _await_node_ready(
                    session, parent, node_id, sleep=sleep, retry=retry
                )
    except Exception as exc:
        logger.error("provisioning failed (%s); rolling back %d node(s)",
                     exc, len(created))
        _rollback_nodes(session, parent, created)
        if isinstance(exc, (ProvisioningError, api_client.ApiError)):
            raise
        raise ProvisioningError(str(exc)) from exc
    job_id = request["job_id"]
    console_url = (
        f"https://console.cloud.google.com/compute/tpus?project={project}"
    )
    print(f"Job submitted: {job_id}")
    print(f"Your TPU nodes are visible at: {console_url}")
    if stream_logs:
        _stream_logs(job_id, project, session=session)
    return {
        "job_id": job_id,
        "nodes": list(request["nodes"]),
        "project": project,
        "zone": zone,
        "console_url": console_url,
    }


def _create_node(session, parent: str, node_id: str, body: dict,
                 retry: retries.RetryPolicy) -> dict:
    """One node-create, retried under ``retry`` and 409-tolerant AFTER a
    transient.

    Node creation is not idempotent: if an attempt's request reached the
    API before its response was lost, the retry gets 409 ALREADY_EXISTS
    — which would classify as a permanent failure and (in deploy_job)
    roll back healthy slices, or (in supervise_job) burn a restart for a
    node that exists.  A 409 is treated as created ONLY when an earlier
    attempt of THIS call failed transiently — a first-attempt 409 (a
    stale node from a caller-supplied job id) still raises and rolls
    back, because adopting a READY node running the OLD workload would
    report success for a job that never started.  The empty op
    short-circuits ``_await_operation``; the READY await then validates
    the node for real.
    """
    saw_transient: List[BaseException] = []

    def attempt() -> dict:
        try:
            return session.post(
                f"{_TPU_API}/{parent}/nodes", body=body,
                params={"nodeId": node_id},
            )
        except api_client.ApiTransientError:
            saw_transient.append(True)
            raise
        except api_client.ApiError as exc:
            if exc.status == 409 and saw_transient:
                logger.info(
                    "node %s already exists after a retried create (the "
                    "lost attempt landed); proceeding to READY await",
                    node_id,
                )
                return {}
            raise

    return retry.call(attempt, name="node_create")


def _await_operation(
    session, op: dict, node_id: str, *, sleep: Callable[[float], None],
    retry: Optional[retries.RetryPolicy] = None,
) -> dict:
    """Poll a TPU v2 long-running operation until done (bounded).

    A transient failure of one status GET retries under ``retry``
    instead of aborting provisioning (and rolling back healthy slices)
    over a blip; the poll-interval sleeps are jittered so concurrent
    awaits don't hit the API in lockstep.
    """
    name = op.get("name")
    if not name:
        # Some fakes/environments return the node body directly.
        return op
    retry = retry if retry is not None else _deploy_retry_policy(sleep)
    for _ in range(_LRO_POLL_ATTEMPTS):
        if op.get("done"):
            if "error" in op:
                raise ProvisioningError(
                    f"node {node_id} create operation failed: {op['error']}"
                )
            return op
        _poll_sleep(sleep, _LRO_POLL_INTERVAL_SECONDS)
        op = retry.call(
            lambda: session.get(f"{_TPU_API}/{name}"), name="operation_poll"
        )
    raise ProvisioningError(
        f"node {node_id} create operation {name!r} not done after "
        f"{_LRO_POLL_ATTEMPTS * _LRO_POLL_INTERVAL_SECONDS}s"
    )


def _await_node_ready(
    session, parent: str, node_id: str, *, sleep: Callable[[float], None],
    retry: Optional[retries.RetryPolicy] = None,
) -> dict:
    """Poll the node until state == READY (reference budget 40 x 10 s)."""
    node = {}
    retry = retry if retry is not None else _deploy_retry_policy(sleep)
    for attempt in range(_READY_POLL_ATTEMPTS):
        node = retry.call(
            lambda: session.get(f"{_TPU_API}/{parent}/nodes/{node_id}"),
            name="node_ready_poll",
        )
        state = node.get("state")
        if state == "READY":
            logger.info("TPU node %s READY", node_id)
            return node
        if state in ("PREEMPTED", "TERMINATED"):
            raise ProvisioningError(
                f"node {node_id} entered terminal state {state}"
            )
        if attempt + 1 < _READY_POLL_ATTEMPTS:
            _poll_sleep(sleep, _READY_POLL_INTERVAL_SECONDS)
    raise ProvisioningError(
        f"node {node_id} not READY after "
        f"{_READY_POLL_ATTEMPTS * _READY_POLL_INTERVAL_SECONDS}s "
        f"(last state: {node.get('state')!r})"
    )


def _rollback_nodes(session, parent: str, node_ids: List[str]) -> None:
    """Best-effort deletion of partially-provisioned slices."""
    for node_id in node_ids:
        try:
            session.delete(f"{_TPU_API}/{parent}/nodes/{node_id}")
            logger.info("rolled back TPU node %s", node_id)
        except Exception:  # noqa: BLE001 — rollback must visit every node
            logger.exception("rollback of node %s failed", node_id)


def supervise_job(
    job_info: dict,
    request: dict,
    *,
    session: Optional[api_client.GcpApiSession] = None,
    poll_seconds: float = 30.0,
    max_restarts: int = 3,
    should_stop: Optional[Callable[[], bool]] = None,
    sleep: Callable[[float], None] = time.sleep,
    retry: Optional[retries.RetryPolicy] = None,
) -> dict:
    """Watch a running job's nodes and recreate any that get preempted.

    The reference's recovery story was CAIP job restarts (SURVEY.md §5
    "recovery is delegated to CAIP job restarts"); this framework owns
    the node lifecycle, so it owns the restart: a node observed in
    PREEMPTED/TERMINATED after the job started is deleted (best-effort)
    and re-created from its original body in ``request`` (the
    ``build_job_request`` result that deploy_job submitted), then awaited
    READY again.  The recreated node boots the same startup script, the
    container re-enters bootstrap, and training resumes from the latest
    checkpoint (``CheckpointCallback(resume=True)`` / cloud_fit's
    ``_maybe_restore``) — compute is lost back to the last save, nothing
    more.

    ``max_restarts`` bounds TOTAL restarts across all nodes; exceeding it
    raises :class:`ProvisioningError` (the job is likely being preempted
    faster than it can checkpoint).  Runs until ``should_stop()`` returns
    True — or until every node has been deleted out from under it
    (``delete_job`` from anywhere, console teardown), which is the normal
    end-of-job signal; returns ``{"restarts": {node_id: count}}``.
    Transient API errors on the state poll retry inline under ``retry``
    (typed classification — the ``utils.retries`` policy), and even an
    exhausted retry budget only skips to the next round, never fatal —
    this loop may run for days.  Poll sleeps are jittered (±20%) so the
    supervisors of a recreated multi-node job don't poll in lockstep.
    """
    session = session or api_client.default_session()
    retry = retry if retry is not None else _deploy_retry_policy(sleep)
    parent = f"projects/{job_info['project']}/locations/{job_info['zone']}"
    restarts: Dict[str, int] = {}
    watching = list(job_info["nodes"])
    # Nodes whose last recreate FAILED don't exist in the API; a 404 for
    # them means "retry the recreate", while a 404 for a healthy node
    # means someone tore it down (job finished) — stop watching it.
    recreate_pending: set = set()

    def _recreate(node_id: str, why: str) -> None:
        total = sum(restarts.values())
        if total >= max_restarts:
            raise ProvisioningError(
                f"node {node_id} {why}; restart budget ({max_restarts}) "
                "exhausted — preemption is outpacing checkpointing"
            )
        logger.warning("node %s %s; recreating (restart %d/%d)",
                       node_id, why, total + 1, max_restarts)
        restarts[node_id] = restarts.get(node_id, 0) + 1
        recreate_pending.add(node_id)
        try:
            # nodes.delete is an LRO: creating the replacement before the
            # old node is fully gone gets 409 ALREADY_EXISTS.
            del_op = session.delete(f"{_TPU_API}/{parent}/nodes/{node_id}")
            if isinstance(del_op, dict):
                _await_operation(session, del_op, node_id, sleep=sleep)
        except (api_client.ApiError, ProvisioningError):
            logger.info("delete of %s failed (already gone?)", node_id)
        try:
            # Same ambiguity handling as deploy_job's creates: a 409
            # after a transient means the lost recreate landed — await
            # it READY instead of burning another restart on it.
            op = _create_node(
                session, parent, node_id, request["nodes"][node_id], retry
            )
            _await_operation(session, op, node_id, sleep=sleep, retry=retry)
            _await_node_ready(session, parent, node_id, sleep=sleep,
                              retry=retry)
            recreate_pending.discard(node_id)
        except Exception:  # noqa: BLE001 — the budget raise is earlier
            # The replacement died too (preempted while provisioning,
            # capacity, transient API/transport failure).  The restart is
            # spent; the next round retries until the budget runs out.
            logger.warning(
                "recreated node %s failed to reach READY; retrying",
                node_id, exc_info=True,
            )

    while not (should_stop and should_stop()):
        for node_id in list(watching):
            if should_stop and should_stop():
                break
            try:
                node = retry.call(
                    lambda: session.get(
                        f"{_TPU_API}/{parent}/nodes/{node_id}"
                    ),
                    name="supervise_poll",
                )
            except api_client.ApiError as exc:
                if exc.status == 404:
                    if node_id in recreate_pending:
                        _recreate(node_id, "missing after failed recreate")
                    else:
                        logger.info(
                            "node %s deleted externally; done watching it",
                            node_id,
                        )
                        watching.remove(node_id)
                else:
                    logger.warning("state poll of %s failed (%s); will "
                                   "retry", node_id, exc)
                continue
            except Exception as exc:  # noqa: BLE001 — days-long loop:
                # transport errors (connection reset, auth refresh
                # hiccup) are not ApiErrors but are just as transient.
                logger.warning("state poll of %s failed (%s); will retry",
                               node_id, exc)
                continue
            # The node exists: any earlier failed-recreate bookkeeping is
            # obsolete (e.g. the await timed out but creation finished),
            # and a future 404 must mean external teardown, not retry.
            recreate_pending.discard(node_id)
            state = node.get("state")
            if state in ("PREEMPTED", "TERMINATED"):
                _recreate(node_id, state)
        if not watching:
            logger.info("all nodes gone; supervision complete")
            break
        if should_stop and should_stop():
            break
        _poll_sleep(sleep, poll_seconds)
    return {"restarts": restarts}


def delete_job(job_info: dict,
               session: Optional[api_client.GcpApiSession] = None) -> None:
    """Tear the job's TPU nodes down (the lifecycle the reference delegated
    to CAIP — SURVEY.md §7 hard parts)."""
    session = session or api_client.default_session()
    parent = f"projects/{job_info['project']}/locations/{job_info['zone']}"
    for node_id in job_info["nodes"]:
        session.delete(f"{_TPU_API}/{parent}/nodes/{node_id}")
        logger.info("deleted TPU node %s", node_id)


_LOGGING_API = "https://logging.googleapis.com/v2"


def stream_logs(
    job_id: str,
    project: str,
    *,
    session: Optional[api_client.GcpApiSession] = None,
    poll_seconds: float = 10.0,
    should_stop: Optional[Callable[[], bool]] = None,
    sleep: Callable[[float], None] = time.sleep,
    out: Callable[[str], None] = print,
    retry: Optional[retries.RetryPolicy] = None,
) -> int:
    """Continuously stream the job's TPU-worker logs (Cloud Logging REST).

    Reference analogue: ``deploy.py:187-211`` shelled out to ``gcloud
    ai-platform jobs stream-logs`` (blocking follow).  Here the follow loop
    is framework-owned: poll ``entries:list`` with a timestamp cursor so
    each round prints only new entries, forever until ``should_stop`` says
    otherwise (or Ctrl-C).  A transient Logging-API failure retries under
    ``retry`` (the cursor is untouched, so nothing is skipped or
    reprinted).  Returns the number of entries printed.
    """
    session = session or api_client.default_session()
    retry = retry if retry is not None else _deploy_retry_policy(sleep)
    base_filter = (
        f'resource.type="tpu_worker" AND labels.cloud_tpu_job="{job_id}"'
    )
    cursor: Optional[str] = None
    printed = 0
    try:
        while True:
            log_filter = base_filter + (
                f' AND timestamp>"{cursor}"' if cursor else ""
            )
            resp = retry.call(
                lambda log_filter=log_filter: session.post(
                    f"{_LOGGING_API}/entries:list",
                    body={
                        "resourceNames": [f"projects/{project}"],
                        "filter": log_filter,
                        "orderBy": "timestamp asc",
                        "pageSize": 1000,
                    },
                ),
                name="log_poll",
            )
            for entry in resp.get("entries", []):
                payload = entry.get("textPayload")
                if payload is None:
                    import json

                    payload = json.dumps(entry.get("jsonPayload", {}))
                out(payload)
                printed += 1
                cursor = entry.get("timestamp", cursor)
            if should_stop is not None and should_stop():
                return printed
            _poll_sleep(sleep, poll_seconds)
    except KeyboardInterrupt:
        logger.info("log streaming interrupted")
        return printed


#: deploy_job's ``stream_logs`` kwarg shadows the function inside its body;
#: the alias keeps the call site unambiguous.
_stream_logs = stream_logs
