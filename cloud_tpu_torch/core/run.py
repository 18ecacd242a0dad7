"""The front door: ``run()`` scales a local script to a TPU pod (the port's
copy of ``cloud_tpu/core/run.py``).

The same pipeline as the JAX package (guard -> defaults -> validate ->
plan -> containerize -> deploy -> exit), the same strict kwargs, the same
``_session``/``_builder`` seams, ``dry_run``, ``max_restarts`` with
``deploy.supervise_job``, script mode's ``sys.exit(0)``, and
``tracing.clear_submit()`` on failure.  The image it builds runs the
port's bootstrap (``core/containerize.py``); the job requests are the
reference's.

``remote()`` is the re-entry contract (reference run.py:31-33): the same
script calls run() locally (submits and stops) and trains when re-executed
inside the container (bootstrap sets CLOUD_TPU_RUNNING_REMOTELY).
"""

from __future__ import annotations

import logging
import os
import shutil
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from cloud_tpu_torch.core import containerize, deploy, gcp, machine_config, notebook
from cloud_tpu_torch.core import validate as validate_lib
from cloud_tpu_torch.core.bootstrap import ENV_RUNNING_REMOTELY
from cloud_tpu_torch.monitoring import tracing
from cloud_tpu_torch.parallel import planner

logger = logging.getLogger(__name__)


def remote() -> bool:
    """True inside the cloud container (reference run.py:31-33)."""
    return bool(os.environ.get(ENV_RUNNING_REMOTELY))


@dataclass
class RunReport:
    """Everything run() decided and produced — inspectable in dry runs."""

    job_id: Optional[str] = None
    console_url: Optional[str] = None
    image_uri: Optional[str] = None
    mesh_plan: Optional[planner.MeshPlan] = None
    dockerfile: Optional[str] = None
    node_requests: Dict[str, dict] = field(default_factory=dict)
    submitted: bool = False


def run(
    entry_point: Optional[str] = None,
    requirements_txt: Optional[str] = None,
    distribution_strategy: Optional[str] = "auto",
    docker_config: Optional[containerize.DockerConfig] = None,
    chief_config: Union[str, machine_config.MachineConfig] = "auto",
    worker_config: Union[str, machine_config.MachineConfig] = "auto",
    worker_count: int = 0,
    entry_point_args: Optional[List[str]] = None,
    stream_logs: bool = False,
    job_labels: Optional[Dict[str, str]] = None,
    service_account: Optional[str] = None,
    parallelism_hints: Optional[planner.ParallelismHints] = None,
    dry_run: bool = False,
    max_restarts: int = 0,
    monitoring: bool = True,
    profiler_port: Optional[int] = None,
    _session=None,
    _builder=None,
    **kwargs,
) -> RunReport:
    """Validate, plan, containerize and launch a training job on Cloud TPU.

    Args mirror the reference ``run()`` (run.py:36-131) plus
    ``parallelism_hints`` (mesh axis pins — capability the reference's
    strategy picker couldn't express), ``dry_run`` (produce every
    artifact, submit nothing), and ``max_restarts`` (> 0: stay alive
    after submission supervising the job — preempted nodes are recreated
    up to this many times and training resumes from the latest
    checkpoint; the reference delegated this to CAIP job restarts.
    Blocking, like ``stream_logs``; if both are set, log streaming wins
    and supervision never starts).  ``monitoring`` (default True) makes
    every deployed host export runtime metrics to Cloud Monitoring with
    zero user code — the job spec carries the exporter's env gate, the
    reference's stackdriver_exporter.cc:31-36 contract;
    ``profiler_port`` additionally starts the on-demand profiler server
    on each host.  ``_session``/``_builder`` are test seams.

    Returns a RunReport.  In script mode (entry_point=None, run() called
    from the training script itself) the local process exits after
    submission, mirroring reference run.py:243-246.
    """
    if remote():
        # Inside the container: fall through to the caller's training code.
        return RunReport(submitted=False)

    if kwargs:
        # Strict kwargs for forward compatibility (reference run.py:137-145).
        raise TypeError(f"Unknown arguments to run(): {sorted(kwargs)}")

    # Arm the submit-to-first-step composite: the trainer's first completed
    # step (local smoke runs) or the in-container re-entry (via the
    # CLOUD_TPU_SUBMIT_TS env below) publishes the gauge.
    submit_ts = time.time()
    tracing.mark_submit()

    try:
        called_from_notebook = notebook.called_from_notebook()

        if chief_config == "auto":
            chief_config = machine_config.COMMON_MACHINE_CONFIGS["TPU"]
        if worker_config == "auto":
            worker_config = chief_config if worker_count > 0 else None

        docker_config = docker_config or containerize.DockerConfig()

        with tracing.span("run/validate"):
            validate_lib.validate(
                entry_point=entry_point,
                requirements_txt=requirements_txt,
                distribution_strategy=distribution_strategy,
                chief_config=chief_config,
                worker_config=worker_config,
                worker_count=worker_count,
                entry_point_args=entry_point_args,
                stream_logs=stream_logs,
                docker_image_build_bucket=docker_config.image_build_bucket,
                called_from_notebook=called_from_notebook,
                job_labels=job_labels,
                service_account=service_account,
            )

        # --- plan the mesh (replaces strategy-code generation) ---
        plan = None
        if distribution_strategy == "auto":
            with tracing.span("run/plan"):
                plan = planner.plan_mesh(
                    chief_config=chief_config,
                    worker_count=worker_count,
                    hints=parallelism_hints,
                )
            logger.info("mesh plan: %s", plan.description)

        # --- resolve the entry point ---
        script_mode = entry_point is None
        resolved_entry = entry_point
        temp_dirs = []
        if called_from_notebook and entry_point is None:
            # Colab: the live notebook is fetched over the kernel RPC — it
            # need not exist on disk (reference preprocess.py:196-212).
            try:
                resolved_entry = notebook.fetch_live_notebook_script()
            except (RuntimeError, KeyError, TypeError) as exc:
                # RuntimeError: not a Colab runtime / frontend returned None;
                # KeyError/TypeError: malformed RPC response shape.  All get
                # the same actionable guidance instead of a raw traceback.
                raise ValueError(
                    "In this notebook environment the live-notebook fetch is "
                    f"unavailable ({exc!r}); pass entry_point= (the .ipynb or "
                    ".py to run)."
                ) from exc
            temp_dirs.append(os.path.dirname(resolved_entry))
        if resolved_entry is not None and resolved_entry.endswith(".ipynb"):
            resolved_entry = notebook.notebook_to_script(resolved_entry)
            temp_dirs.append(os.path.dirname(resolved_entry))
        if script_mode and not called_from_notebook:
            # run() was called from inside the training script: ship that script.
            resolved_entry = os.path.abspath(sys.argv[0])

        # --- containerize ---
        project = None
        image_uri = docker_config.image
        if image_uri is None:
            project = gcp.get_project_name()
            image_uri = containerize.default_image_uri(project)
        dockerfile = containerize.make_dockerfile(
            os.path.basename(resolved_entry),
            chief_config,
            requirements_name=(
                os.path.basename(requirements_txt) if requirements_txt else None
            ),
            parent_image=docker_config.parent_image,
            torch_version=docker_config.torch_version,
            mesh_plan_json=plan.to_json() if plan else None,
            distribution_strategy="auto" if distribution_strategy == "auto" else "none",
            entry_point_args=entry_point_args,
        )

        deploy_plan = plan or planner.plan_mesh(
            chief_config=chief_config, worker_count=worker_count
        )
        # Built exactly once: the report's node requests ARE the submitted ones.
        job_request = deploy.build_job_request(
            image_uri, chief_config, worker_count, deploy_plan,
            job_labels=job_labels, service_account=service_account,
            monitoring=monitoring, profiler_port=profiler_port,
            submit_ts=submit_ts,
        )
        report = RunReport(
            image_uri=image_uri, mesh_plan=plan, dockerfile=dockerfile,
            job_id=job_request["job_id"], node_requests=job_request["nodes"],
        )

        try:
            if dry_run:
                return report

            with tracing.span("run/containerize"):
                context_dir = containerize.build_context(
                    dockerfile, resolved_entry, requirements_txt
                )
                temp_dirs.append(context_dir)
                if _builder is not None:
                    builder = _builder
                elif docker_config.image_build_bucket:
                    builder = containerize.CloudContainerBuilder(
                        image_uri, context_dir,
                        project=project or gcp.get_project_name(),
                        bucket=docker_config.image_build_bucket,
                        session=_session,
                    )
                else:
                    builder = containerize.LocalContainerBuilder(
                        image_uri, context_dir, cache_from=docker_config.cache_from
                    )
                report.image_uri = builder.get_docker_image()
            if report.image_uri != image_uri:
                # Builder renamed the image: regenerate node bodies so their
                # startup scripts pull the image that actually exists.
                job_request = deploy.build_job_request(
                    report.image_uri, chief_config, worker_count, deploy_plan,
                    job_id=job_request["job_id"],
                    job_labels=job_labels, service_account=service_account,
                    monitoring=monitoring, profiler_port=profiler_port,
                    submit_ts=submit_ts,
                )
                report.node_requests = job_request["nodes"]

            # --- deploy ---
            with tracing.span("run/deploy"):
                job_info = deploy.deploy_job(
                    report.image_uri,
                    chief_config,
                    worker_count,
                    deploy_plan,
                    job_labels=job_labels,
                    service_account=service_account,
                    session=_session,
                    stream_logs=stream_logs,
                    request=job_request,
                )
            report.job_id = job_info["job_id"]
            report.console_url = job_info["console_url"]
            report.submitted = True
        finally:
            for d in temp_dirs:
                shutil.rmtree(d, ignore_errors=True)

        if max_restarts > 0 and not stream_logs:
            # After cleanup: supervision may run for the job's whole life and
            # needs none of the build artifacts.  Returns when the job's
            # nodes are torn down (delete_job/console) or raises when the
            # restart budget is exhausted.  Not after stream_logs: the only
            # way out of the log tail is Ctrl-C, and that interrupt means
            # "stop run()", not "enter a second blocking loop".
            deploy.supervise_job(
                job_info, job_request, session=_session,
                max_restarts=max_restarts,
            )

        if script_mode and not called_from_notebook:
            # Stop local execution of the training script after submitting
            # (reference run.py:243-246).
            sys.exit(0)
        return report
    except Exception:
        # A run() that raised before submitting must not leave a
        # pending submit mark for a later unrelated fit() in this
        # process to consume as its submit-to-first-step origin.
        tracing.clear_submit()
        raise
