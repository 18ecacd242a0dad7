"""Container-side bootstrap: the runtime the image's ENTRYPOINT runs (the
port's copy of ``cloud_tpu/core/bootstrap.py``).

    python -m cloud_tpu_torch.core.bootstrap \
        --entry-point=train.py --mesh-plan='{"sizes": ...}'

On every host it (1) marks the process as remote (the ``remote()``
contract), (2) installs the preemption drain and any exported fault plan,
(3) joins the ``torch.distributed`` job the env contract names (deploy.py
writes it into the TPU-VM startup script; one process per rank), (4)
starts the env-gated exporter and profiler server and the persistent
kernel cache, (5) builds this rank's view of the planned mesh and installs
it as the global mesh, then (6) runs the user script under ``__main__``
semantics.  The same script that called ``run()`` locally re-enters here,
hits the ``remote()`` guard, and falls through to its training code.

What differs from the JAX package:

* the plan: with no ``--mesh-plan`` it plans over the job's process count
  (one process per rank), where JAX plans over its local devices; a plan
  whose device count is not the process count raises, naming both;
* the device: the card by default.  The CPU is used only when asked for
  (``--device=cpu``, as ``utils.local_rig`` passes it); a bootstrap not
  asked for the CPU raises on a host with no card.  Process groups are
  gloo on the CPU and NCCL on cards unless ``--backend`` names one (ranks
  sharing one card need gloo: NCCL refuses two ranks on a device).
"""

from __future__ import annotations

import argparse
import logging
import os
import runpy
import sys

logger = logging.getLogger(__name__)

ENV_RUNNING_REMOTELY = "CLOUD_TPU_RUNNING_REMOTELY"


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--entry-point", required=True,
                        help=".py or .ipynb to execute under the mesh")
    parser.add_argument("--mesh-plan", default=None,
                        help="MeshPlan JSON (omit: plan over the processes)")
    parser.add_argument("--distribution-strategy", default="auto",
                        choices=["auto", "none"],
                        help="'none': user script owns mesh construction")
    parser.add_argument("--device", default=None, choices=["cuda", "cpu"],
                        help="where the ranks run (default: the card)")
    parser.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                        help="process-group backend (default: the device's)")
    parser.add_argument("entry_point_args", nargs="*",
                        help="argv passed through to the entry point")
    return parser


def main(argv=None) -> None:
    args = _parser().parse_args(argv)

    from cloud_tpu_torch._device import resolve_device

    # Raises on a host with no card unless the CPU was asked for.
    device = resolve_device(args.device)

    os.environ[ENV_RUNNING_REMOTELY] = "1"

    # Preemption drain: SIGTERM sets a stop event Trainer.fit checks at
    # every dispatch boundary, so training checkpoints and exits (status
    # PREEMPTION_EXIT_CODE below) instead of dying mid-step.
    from cloud_tpu_torch.training import preemption

    preemption.install_sigterm_handler()

    # A fault plan exported by faults.inject() in the submitting process
    # (CLOUD_TPU_FAULT_PLAN) is re-installed here.
    from cloud_tpu_torch.utils import faults

    faults.maybe_install_from_env()

    from cloud_tpu_torch.parallel import distributed

    distributed.initialize_from_env(device=device, backend=args.backend)

    # Env-gated observability: the job spec turns these on per host via
    # CLOUD_TPU_MONITORING_ENABLED / CLOUD_TPU_PROFILER_PORT.
    from cloud_tpu_torch import monitoring

    try:
        if monitoring.start_exporter():
            # The native timer thread calls back into Python; it must be
            # joined before interpreter finalization.  atexit also covers
            # user scripts that sys.exit().
            import atexit

            atexit.register(monitoring.stop_exporter)
    except Exception:
        # Misconfigured monitoring must not kill the training job.
        logger.exception("metrics exporter failed to start")
    monitoring.profiler.maybe_start_server_from_env()

    # Env-gated persistent kernel cache (CLOUD_TPU_COMPILE_CACHE, forwarded
    # by deploy's startup script): probe + enable BEFORE the user script
    # launches a kernel, so a restarted container loads the libraries it
    # built before instead of running nvcc again.
    try:
        from cloud_tpu_torch.training import compile_cache

        compile_cache.maybe_enable_persistent_cache()
    except Exception:  # noqa: BLE001 — cache is an optimization, never fatal
        logger.exception("persistent compile cache setup failed; continuing")

    entry_point = args.entry_point
    if entry_point.endswith(".ipynb"):
        from cloud_tpu_torch.core import notebook

        entry_point = notebook.notebook_to_script(entry_point)

    sys.argv = [entry_point] + list(args.entry_point_args)

    if args.distribution_strategy == "none":
        # User-owned parallelism (reference validate.py:117-124 None path).
        runpy.run_path(entry_point, run_name="__main__")
        _exit_if_drained()
        return

    from cloud_tpu_torch.parallel import mesh as mesh_lib
    from cloud_tpu_torch.parallel import planner

    processes = distributed.process_count()
    if args.mesh_plan:
        plan = planner.MeshPlan.from_json(args.mesh_plan)
    else:
        plan = planner.plan_mesh(num_devices=processes)
    if plan.spec.num_devices != processes:
        raise ValueError(
            f"the mesh plan spans {plan.spec.num_devices} devices "
            f"({plan.description}) but the job has {processes} process(es); "
            "the port runs one process per rank (set CLOUD_TPU_NUM_PROCESSES "
            "or pass a plan of that size)")
    logger.info("bootstrap: %s", plan.description)
    devices = ([device] * processes) if device.type == "cpu" else None
    mesh = plan.build(devices, backend=args.backend)
    with mesh_lib.use_mesh(mesh):
        runpy.run_path(entry_point, run_name="__main__")
    _exit_if_drained()


def _exit_if_drained() -> None:
    """Exit with the distinct preemption status when the user script
    finished BECAUSE the drain stop event fired: the supervisor can tell
    "checkpointed and yielded to preemption" (143) apart from success (0)
    and a crash (!= 0, != 143)."""
    from cloud_tpu_torch.training import preemption

    if preemption.stop_requested():
        logger.warning(
            "bootstrap exiting with preemption-drain status %d (%s)",
            preemption.PREEMPTION_EXIT_CODE, preemption.stop_reason(),
        )
        sys.exit(preemption.PREEMPTION_EXIT_CODE)


if __name__ == "__main__":
    main()
