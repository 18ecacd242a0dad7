"""Shared rig for the launcher parity tests: the JAX package's launcher and
the port's side by side, and the one list of where they may differ.

The port keeps the reference's catalog, request bodies, startup scripts
and errors, so those are compared as data.  The framework's own lines are
listed here and nowhere else (:data:`FRAMEWORK_LINES`): the Dockerfile's
base image and framework install, the ENTRYPOINT's module, and the
vendored package's name in the build context.
"""

import json
import types

from cloud_tpu.core import bootstrap as jax_bootstrap
from cloud_tpu.core import containerize as jax_containerize
from cloud_tpu.core import deploy as jax_deploy
from cloud_tpu.core import gcp as jax_gcp
from cloud_tpu.core import machine_config as jax_machine_config
from cloud_tpu.core import notebook as jax_notebook
from cloud_tpu.core import run as jax_run
from cloud_tpu.core import validate as jax_validate
from cloud_tpu.parallel import planner as jax_planner
from cloud_tpu.utils import api_client as jax_api_client
from cloud_tpu_torch.core import bootstrap, containerize, deploy, gcp
from cloud_tpu_torch.core import machine_config, notebook
from cloud_tpu_torch.core import run as run_lib
from cloud_tpu_torch.core import validate
from cloud_tpu_torch.parallel import planner
from cloud_tpu_torch.utils import api_client

JAX = types.SimpleNamespace(
    name="jax", bootstrap=jax_bootstrap, containerize=jax_containerize,
    deploy=jax_deploy, gcp=jax_gcp, machine_config=jax_machine_config,
    notebook=jax_notebook, run=jax_run, validate=jax_validate,
    planner=jax_planner, api_client=jax_api_client, package="cloud_tpu")
PORT = types.SimpleNamespace(
    name="port", bootstrap=bootstrap, containerize=containerize,
    deploy=deploy, gcp=gcp, machine_config=machine_config,
    notebook=notebook, run=run_lib, validate=validate, planner=planner,
    api_client=api_client, package="cloud_tpu_torch")
SIDES = (JAX, PORT)

#: Where the two launchers may differ, each the framework's own: a line
#: prefix of the Dockerfile -> why.  The ENTRYPOINT differs only in its
#: module (``<package>.core.bootstrap``) and the build context only in the
#: vendored package's directory name (``SimpleNamespace.package``).
FRAMEWORK_LINES = {
    "FROM ": "the base image: the port's carries nvcc (kernels build from "
             "the vendored sources)",
    "RUN pip install --no-cache-dir 'jax": "the JAX package's install",
    "RUN pip install --no-cache-dir 'torch": "the port's install",
}


def dockerfile_as_data(text: str, side) -> list:
    """The Dockerfile's lines with the framework's own replaced by a
    marker, and the ENTRYPOINT parsed with its module named neutrally."""
    out = []
    for line in text.splitlines():
        framework = next((p for p in FRAMEWORK_LINES if line.startswith(p)),
                         None)
        if framework is not None:
            out.append(("framework line", framework.split()[0]))
        elif line.startswith("ENTRYPOINT "):
            argv = json.loads(line[len("ENTRYPOINT "):])
            module = f"{side.package}.core.bootstrap"
            out.append(("ENTRYPOINT", ["<bootstrap>" if a == module else a
                                       for a in argv]))
        else:
            out.append(line)
    return out


def mc(side, name):
    return side.machine_config.COMMON_MACHINE_CONFIGS[name]


def as_data(obj):
    """Dataclasses, enums and plans of either package as plain data (the
    enum's name and value, a dataclass's fields), so the two packages'
    objects compare."""
    import dataclasses
    import enum

    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.name, obj.value)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                {f.name: as_data(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {(k if isinstance(k, str) else as_data(k)): as_data(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [as_data(v) for v in obj]
    return obj


def error_of(call):
    """``(type name, message)`` of what ``call()`` raises, or ``("ok",
    result)``."""
    try:
        return ("ok", call())
    except Exception as exc:  # noqa: BLE001 — the error IS the datum
        return (type(exc).__name__, str(exc))
