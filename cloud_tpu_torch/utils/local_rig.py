"""The local rig: run the container bootstrap as a job of real processes
(the port's copy of ``cloud_tpu/utils/local_rig.py``).

The JAX rig fakes a slice as N virtual XLA CPU devices in one process.
The port runs one process per rank, so its rig starts N processes with
the ``CLOUD_TPU_*`` env contract (coordinator, process count, rank) that
deploy's startup script gives a container.  Every entry point takes
``device=`` and no default: with ``"cpu"`` (the bootstrap's
``--device=cpu``) the ranks form a gloo job on one intra-op thread each;
with ``"cuda"`` they use the host's cards (ranks that share a card form
a gloo job: NCCL refuses two ranks on a device).
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, List, Optional

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

#: The module a rank runs when none is given: the per-host self-check.
SELFCHECK = "cloud_tpu_torch.parallel.selfcheck"


def rank_env(rank: Optional[int] = None, num_processes: int = 1,
             coordinator: Optional[str] = None, *, device: str,
             extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Subprocess env of one rank: the repo on ``PYTHONPATH``, the process
    contract when ``coordinator`` is given, and, only when ``device`` is
    ``"cpu"``, one intra-op thread and the self-check's CPU switch; with
    ``"cuda"`` the rank uses the host's cards."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device is 'cpu' or 'cuda', got {device!r}")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("CLOUD_TPU_RUNNING_REMOTELY", None)
    if coordinator is not None:
        env.update({
            "CLOUD_TPU_COORDINATOR": coordinator,
            "CLOUD_TPU_NUM_PROCESSES": str(num_processes),
            "CLOUD_TPU_PROCESS_ID": str(rank),
        })
    if device == "cpu":
        env.update({"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                    "CLOUD_TPU_SELFCHECK_FORCE_CPU": "1"})
    else:
        env.pop("CLOUD_TPU_SELFCHECK_FORCE_CPU", None)
    env.update(extra or {})
    return env


def fleet_cpu_deficit(num_processes: int) -> Optional[str]:
    """Why this machine cannot run a ``num_processes``-rank CPU fleet, or
    None.

    On a box with fewer cores than ranks the processes time-slice so
    slowly that the rendezvous can time out mid-handshake — a
    hang-then-fail that looks like a framework bug.  Callers should SKIP
    loudly instead.  ``CLOUD_TPU_FLEET_FORCE=1`` overrides.
    """
    if os.environ.get("CLOUD_TPU_FLEET_FORCE") == "1":
        return None
    if num_processes <= 2:
        return None
    cpus = os.cpu_count() or 1
    if cpus < num_processes:
        return (
            f"{num_processes}-process fleet on a {cpus}-CPU machine: ranks "
            "time-slice so slowly the rendezvous can exceed its deadline "
            "(set CLOUD_TPU_FLEET_FORCE=1 to run anyway)"
        )
    return None


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _shares_cards(num_processes: int) -> bool:
    import torch

    return num_processes > max(torch.cuda.device_count(), 1)


def launch_process_fleet(
    num_processes: int = 2,
    *,
    device: str,
    module: str = SELFCHECK,
    extra_env: Optional[Dict[str, str]] = None,
    timeout: int = 300,
):
    """Spawn ``num_processes`` REAL OS processes forming one
    ``torch.distributed`` job over the ``CLOUD_TPU_*`` env contract, on
    ``device`` (``"cpu"`` or ``"cuda"``, :func:`rank_env`); each runs
    ``python -m <module>`` (or a ``.py`` path).  The timeout turns a hang
    into a visible failure.  Returns ``subprocess.CompletedProcess`` per
    rank, in rank order."""
    coordinator = f"localhost:{_free_port()}"
    cmd = ([sys.executable, module] if module.endswith(".py")
           else [sys.executable, "-m", module])
    procs = [
        subprocess.Popen(
            cmd,
            env=rank_env(rank, num_processes, coordinator, device=device,
                         extra=extra_env),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(num_processes)
    ]
    return _drain_fleet(procs, timeout)


def _drain_fleet(procs, timeout: int) -> List[subprocess.CompletedProcess]:
    """Drain every rank's pipes CONCURRENTLY: ranks run in lockstep through
    collectives, so a sequential drain would deadlock the moment any
    later rank fills its pipe buffer while rank 0 is still being waited
    on."""
    from concurrent.futures import ThreadPoolExecutor

    def drain(proc):
        try:
            out, err = proc.communicate(timeout=timeout)
            return subprocess.CompletedProcess(
                proc.args, proc.returncode, out, err
            )
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            return subprocess.CompletedProcess(proc.args, -9, out, err)

    try:
        with ThreadPoolExecutor(max_workers=len(procs)) as pool:
            results = list(pool.map(drain, procs))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return results


_CURL_SHIM = """#!/bin/bash
# Fake VM metadata server: the startup script asks for
# attributes/agent-worker-number (answer this emulated host's index) and,
# with monitoring on, project/project-id (answer nothing).
case "$*" in
  *agent-worker-number*) echo -n "${AGENT_WORKER_NUMBER}" ;;
  *) echo -n "" ;;
esac
"""

#: Fake docker CLI: ``pull`` is a no-op; ``run`` turns every ``-e K=V``
#: into the environment, points the coordinator at this host and execs
#: the image's ENTRYPOINT in its working directory, which is also the
#: whole ``PYTHONPATH``.  The placeholders are filled in with ``repr``;
#: an argv starting with ``python`` gets the launcher's own interpreter (a
#: PATH ``python`` may be another environment, without torch).
_DOCKER_SHIM = """#!/usr/bin/env python3
import os, sys

args = sys.argv[1:]
if not args or args[0] == "pull":
    sys.exit(0)
env = dict(os.environ)
rest = args[1:]
while rest:
    a = rest.pop(0)
    if a == "-e":
        k, _, v = rest.pop(0).partition("=")
        env[k] = v
if "CLOUD_TPU_COORDINATOR" in env:
    env["CLOUD_TPU_COORDINATOR"] = __COORDINATOR__
env["PYTHONPATH"] = __CONTEXT__
argv = __ENTRYPOINT__
if argv[0] == "python":
    argv[0] = __PYTHON__
os.chdir(__CONTEXT__)
os.execvpe(argv[0], argv, env)
"""


def launch_emulated_slice(
    hosts_per_slice: int = 2,
    *,
    device: str,
    startup_script: Optional[str] = None,
    entrypoint: Optional[List[str]] = None,
    context_dir: Optional[str] = None,
    extra_env: Optional[Dict[str, str]] = None,
    timeout: int = 300,
):
    """Boot one multi-host slice by EXECUTING deploy's real startup script.

    The bash script runs per emulated host with a shimmed ``curl`` (a fake
    metadata server answering the worker index) and a shimmed ``docker``
    (``-e K=V`` into the environment, the coordinator's VM name mapped to
    this host, then the image's ENTRYPOINT ``entrypoint`` run in
    ``context_dir``, the image's working directory).  By default the
    script is ``deploy.startup_script`` for ``hosts_per_slice`` hosts, the
    ENTRYPOINT the self-check (``python -m`` :data:`SELFCHECK`) and the
    working directory the repo; pass a node request's script, the
    Dockerfile's ENTRYPOINT (``containerize.entrypoint_argv``) and a
    ``containerize.build_context`` directory to boot a job's own image.
    ``device`` is ``"cpu"`` or ``"cuda"`` (:func:`rank_env`); the
    ENTRYPOINT runs as given, so a bootstrap on the CPU needs its
    ``--device=cpu``.  Returns CompletedProcess per host in worker order."""
    import shutil
    import stat
    import tempfile

    coordinator = f"localhost:{_free_port()}"
    if startup_script is None:
        from cloud_tpu_torch.core import deploy

        startup_script = deploy.startup_script(
            "gcr.io/emulated/selfcheck:0",
            coordinator_address=coordinator,
            num_processes=hosts_per_slice,
            process_id_base=0,
        )
    docker_shim = _DOCKER_SHIM
    for key, value in (
            ("COORDINATOR", coordinator),
            ("CONTEXT", context_dir or REPO_ROOT),
            ("ENTRYPOINT", list(entrypoint or ["python", "-m", SELFCHECK])),
            ("PYTHON", sys.executable)):
        docker_shim = docker_shim.replace(f"__{key}__", repr(value))
    tmp = tempfile.mkdtemp(prefix="cloud_tpu_slice_")
    try:
        script_path = os.path.join(tmp, "startup-script.sh")
        with open(script_path, "w") as f:
            f.write(startup_script)
        bin_dir = os.path.join(tmp, "bin")
        os.makedirs(bin_dir)
        for name, body in (("curl", _CURL_SHIM), ("docker", docker_shim)):
            path = os.path.join(bin_dir, name)
            with open(path, "w") as f:
                f.write(body)
            os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
        procs = []
        for worker in range(hosts_per_slice):
            env = rank_env(device=device, extra={
                "AGENT_WORKER_NUMBER": str(worker),
                "PATH": bin_dir + os.pathsep + os.environ.get("PATH", ""),
                **(extra_env or {}),
            })
            procs.append(subprocess.Popen(
                ["bash", script_path], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        return _drain_fleet(procs, timeout)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_bootstrap(
    entry_point: str,
    *,
    device: str,
    mesh_plan_json: Optional[str] = None,
    num_processes: int = 1,
    extra_env: Optional[Dict[str, str]] = None,
    args: Optional[List[str]] = None,
    timeout: int = 600,
) -> subprocess.CompletedProcess:
    """Execute the container ENTRYPOINT locally as ``num_processes`` ranks
    on ``device``: ``"cpu"`` passes the bootstrap ``--device=cpu``;
    ``"cuda"`` lets it take the host's cards (gloo when ranks share one).

    Returns rank 0's ``CompletedProcess``, its ``returncode`` replaced by
    the first failing rank's (0 when all passed) and every rank's result
    under ``.ranks``."""
    cmd = [sys.executable, "-m", "cloud_tpu_torch.core.bootstrap",
           "--entry-point", entry_point]
    if device == "cpu":
        cmd.append("--device=cpu")
    elif num_processes > 1 and _shares_cards(num_processes):
        cmd.append("--backend=gloo")
    if mesh_plan_json is not None:
        cmd += ["--mesh-plan", mesh_plan_json]
    if args:
        cmd += ["--", *args]
    coordinator = (f"localhost:{_free_port()}" if num_processes > 1
                   else None)
    procs = [
        subprocess.Popen(
            cmd,
            env=rank_env(rank, num_processes, coordinator, device=device,
                         extra=extra_env),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(num_processes)
    ]
    ranks = _drain_fleet(procs, timeout)
    first = ranks[0]
    failed = next((r.returncode for r in ranks if r.returncode != 0), 0)
    result = subprocess.CompletedProcess(first.args, failed, first.stdout,
                                         first.stderr)
    result.ranks = ranks
    return result
