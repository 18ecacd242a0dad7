"""Containerization: Dockerfile synthesis + image builders (the port's copy
of ``cloud_tpu/core/containerize.py``).

Reference analogue: ``src/python/tensorflow_cloud/core/containerize.py``
(Dockerfile synthesis :134-228, build-context tar :124-132/:235-277,
LocalContainerBuilder :304-383, CloudContainerBuilder :386-507).

What differs from the JAX package is the framework, each in one place:

* the base image (:data:`DEFAULT_BASE_IMAGE`) carries CUDA's ``nvcc``,
  because the port's kernels build from the vendored sources
  (``ops/csrc/``) at first use; ``parent_image`` still overrides it;
* the Dockerfile installs the submitting client's ``torch`` release
  (:func:`default_torch_pin`), where the JAX package installs
  ``jax[tpu]`` from the libtpu index;
* the ENTRYPOINT runs ``cloud_tpu_torch.core.bootstrap``;
* :func:`build_context` vendors ``cloud_tpu_torch/`` with its kernel and
  host C++ sources, without build outputs.

The docker SDK dependency is replaced by the docker CLI via subprocess
(injectable for tests), and Cloud Build is driven through the plain REST
session from ``utils/api_client.py``; ``google.cloud.storage`` stays a
deferred import.
"""

from __future__ import annotations

import abc
import io
import json
import logging
import os
import shutil
import subprocess
import tarfile
import tempfile
import time
import uuid
from dataclasses import dataclass
from typing import Callable, List, Optional

from cloud_tpu_torch.utils import api_client

logger = logging.getLogger(__name__)

#: The default base image: CUDA's compiler (the kernels build in the
#: container), Python and pip.
DEFAULT_BASE_IMAGE = "pytorch/pytorch:2.11.0-cuda12.8-cudnn9-devel"

#: The package the build context vendors and the ENTRYPOINT runs.
PACKAGE = "cloud_tpu_torch"


def default_base_image() -> str:
    """:data:`DEFAULT_BASE_IMAGE`: a devel image, because the port's
    kernels are built with ``nvcc`` from the vendored sources at first
    use (the JAX package's ``python:<minor>-slim`` has no compiler)."""
    return DEFAULT_BASE_IMAGE


def default_torch_pin() -> Optional[str]:
    """``torch==<local release>`` — client/container version lock.

    The local build's label (``+cpu``, ``+cu128``) is dropped: the
    container installs the same release's card build.  Returns None
    (=> install unpinned, with a warning) for a dev/source build with no
    release to pin to.  Reads the distribution metadata, not ``import
    torch``, unless torch is already imported.
    """
    import sys

    version = getattr(sys.modules.get("torch"), "__version__", None)
    if version is None:
        try:
            import importlib.metadata

            version = importlib.metadata.version("torch")
        except Exception:  # noqa: BLE001 — source trees without dist-info
            import torch

            version = torch.__version__
    version = str(version).split("+", 1)[0]
    if "dev" in version or "git" in version:
        logger.warning(
            "local torch %s is a dev/source build with no released wheel; "
            "container installs UNPINNED torch — set "
            "DockerConfig(torch_version=...) to pin explicitly",
            version,
        )
        return None
    return f"torch=={version}"


_CLOUD_BUILD_POLL_INTERVAL_SECONDS = 30
_CLOUD_BUILD_POLL_ATTEMPTS = 20  # reference budget: 20 x 30s (:390,432-453)


@dataclass
class DockerConfig:
    """User knobs for image naming and building (reference run.py docker_config)."""

    image: Optional[str] = None  # full target URI; default gcr.io/<proj>/...
    parent_image: Optional[str] = None  # overrides default_base_image()
    cache_from: Optional[str] = None  # warm-layer source image
    image_build_bucket: Optional[str] = None  # GCS bucket => Cloud Build
    torch_version: Optional[str] = None  # e.g. "2.11.0"; default = local


def make_dockerfile(
    entry_point_name: str,
    chief_config,
    *,
    requirements_name: Optional[str] = None,
    parent_image: Optional[str] = None,
    mesh_plan_json: Optional[str] = None,
    distribution_strategy: str = "auto",
    entry_point_args: Optional[List[str]] = None,
    torch_version: Optional[str] = None,
) -> str:
    """Render the Dockerfile text (golden-tested, like reference :134-228).

    ``torch_version`` overrides the container's torch pin (a bare version
    string like "2.11.0"); default pins to the submitting client's local
    torch release (see :func:`default_torch_pin`).  The chief's machine
    config does not change the install: one torch build serves the card
    and the CPU.
    """
    del chief_config  # one install line for every config (see docstring)
    pin = f"torch=={torch_version}" if torch_version else default_torch_pin()
    lines = [f"FROM {parent_image or default_base_image()}", "WORKDIR /app"]
    lines.append(f"RUN pip install --no-cache-dir '{pin or 'torch'}'")
    if requirements_name:
        lines.append(f"COPY {requirements_name} /app/{requirements_name}")
        lines.append(
            f"RUN pip install --no-cache-dir -r /app/{requirements_name}"
        )
    # The build context vendors the framework tree (the reference pip-
    # installed tensorflow-cloud, :208-209; vendoring pins the image to the
    # submitting client's exact version).
    lines.append("COPY . /app")
    lines.append('ENV PYTHONPATH="/app:${PYTHONPATH}"')
    entrypoint = [
        "python",
        "-m",
        f"{PACKAGE}.core.bootstrap",
        f"--entry-point={entry_point_name}",
        f"--distribution-strategy={distribution_strategy}",
    ]
    if mesh_plan_json:
        entrypoint.append(f"--mesh-plan={mesh_plan_json}")
    if entry_point_args:
        entrypoint.append("--")  # bootstrap passes the rest to the script
        entrypoint.extend(entry_point_args)
    # json.dumps produces the exec-form array with correct escaping — the
    # mesh-plan JSON contains quotes that naive formatting would corrupt
    # (Docker would silently fall back to shell form).
    lines.append(f"ENTRYPOINT {json.dumps(entrypoint)}")
    return "\n".join(lines) + "\n"


def entrypoint_argv(dockerfile_text: str) -> List[str]:
    """The exec-form ENTRYPOINT argv of a Dockerfile :func:`make_dockerfile`
    rendered (what ``docker run`` executes in the container)."""
    for line in reversed(dockerfile_text.splitlines()):
        if line.startswith("ENTRYPOINT "):
            return json.loads(line[len("ENTRYPOINT "):])
    raise ValueError("the Dockerfile has no ENTRYPOINT line")


def default_image_uri(project: str) -> str:
    """gcr.io/<project>/cloud_tpu_train:<uuid> (reference :279-285)."""
    return f"gcr.io/{project}/cloud_tpu_train:{uuid.uuid4().hex[:12]}"


#: What the vendored package leaves out: build outputs (the kernel
#: libraries under ``build/``, host libraries, objects, C test binaries)
#: and caches.  The container builds what it needs from the sources.
_VENDOR_IGNORE = shutil.ignore_patterns(
    "__pycache__", "*.pyc", "*.so", "*.o", "build", "registry_test",
    "wire_client_test", "records_native_test",
)


def build_context(
    dockerfile_text: str,
    entry_point: Optional[str],
    requirements_txt: Optional[str],
    dst_dir: Optional[str] = None,
) -> str:
    """Assemble the docker build context directory.

    Contents: Dockerfile, the entry point's whole directory (multi-file
    projects work, reference tests/examples/multi_file_example), optional
    requirements, and the ``cloud_tpu_torch`` tree with its ``ops/csrc/``
    and ``*/cpp/`` sources (no build outputs, :data:`_VENDOR_IGNORE`).
    """
    if dst_dir is None:
        dst_dir = tempfile.mkdtemp(prefix="cloud_tpu_ctx_")
    os.makedirs(dst_dir, exist_ok=True)
    with open(os.path.join(dst_dir, "Dockerfile"), "w") as f:
        f.write(dockerfile_text)
    if entry_point is not None:
        src_dir = os.path.dirname(os.path.abspath(entry_point)) or "."
        for name in os.listdir(src_dir):
            src = os.path.join(src_dir, name)
            dst = os.path.join(dst_dir, name)
            if name in ("Dockerfile", PACKAGE) or name.startswith("."):
                continue
            if os.path.isdir(src):
                if not os.path.exists(dst):
                    shutil.copytree(src, dst)
            else:
                shutil.copy2(src, dst)
    if requirements_txt is not None:
        shutil.copy2(
            requirements_txt,
            os.path.join(dst_dir, os.path.basename(requirements_txt)),
        )
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg_dst = os.path.join(dst_dir, PACKAGE)
    if not os.path.exists(pkg_dst):
        shutil.copytree(pkg_root, pkg_dst, ignore=_VENDOR_IGNORE)
    return dst_dir


class ContainerBuilder(abc.ABC):
    """Build + publish an image, returning its URI (reference :44-301)."""

    def __init__(self, image_uri: str, context_dir: str):
        self.image_uri = image_uri
        self.context_dir = context_dir

    @abc.abstractmethod
    def get_docker_image(self) -> str: ...


class LocalContainerBuilder(ContainerBuilder):
    """docker CLI build + push (reference drove the docker SDK, :304-383).

    ``runner`` is injectable: signature ``(argv: List[str]) -> None``; tests
    substitute a recorder.
    """

    def __init__(self, image_uri, context_dir, *,
                 cache_from: Optional[str] = None,
                 runner: Optional[Callable[[List[str]], None]] = None):
        super().__init__(image_uri, context_dir)
        self.cache_from = cache_from
        self._runner = runner or self._run_streaming

    @staticmethod
    def _run_streaming(argv: List[str]) -> None:
        logger.info("$ %s", " ".join(argv))
        proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        assert proc.stdout is not None
        for line in proc.stdout:
            logger.info("%s", line.rstrip())
        if proc.wait() != 0:
            raise RuntimeError(f"Command failed ({proc.returncode}): {argv}")

    def get_docker_image(self) -> str:
        build = ["docker", "build", "-t", self.image_uri]
        if self.cache_from:
            build += ["--cache-from", self.cache_from]
        build.append(self.context_dir)
        self._runner(build)
        self._runner(["docker", "push", self.image_uri])
        return self.image_uri


class CloudContainerBuilder(ContainerBuilder):
    """GCS-upload + Cloud Build (reference :386-507), REST via the
    injectable session."""

    def __init__(self, image_uri, context_dir, *, project: str, bucket: str,
                 session: Optional[api_client.GcpApiSession] = None,
                 storage_client=None,
                 sleeper: Callable[[float], None] = time.sleep):
        super().__init__(image_uri, context_dir)
        self.project = project
        self.bucket = bucket
        self._session = session
        self._storage_client = storage_client
        self._sleep = sleeper

    def _tarball(self) -> bytes:
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tar:
            tar.add(self.context_dir, arcname=".")
        return buf.getvalue()

    def _upload_context(self) -> str:
        object_name = f"cloud_tpu_build/{uuid.uuid4().hex}.tgz"
        client = self._storage_client
        if client is None:
            from google.cloud import storage

            client = storage.Client(project=self.project)
        blob = client.bucket(self.bucket).blob(object_name)
        blob.upload_from_string(self._tarball(), content_type="application/gzip")
        return object_name

    def build_request(self, object_name: str) -> dict:
        """The Cloud Build request body (golden-tested, reference :481-507)."""
        return {
            "source": {
                "storageSource": {
                    "bucket": self.bucket,
                    "object": object_name,
                }
            },
            "steps": [
                {
                    "name": "gcr.io/cloud-builders/docker",
                    "args": ["build", "-t", self.image_uri, "."],
                }
            ],
            "images": [self.image_uri],
        }

    def get_docker_image(self) -> str:
        session = self._session or api_client.default_session()
        object_name = self._upload_context()
        url = f"https://cloudbuild.googleapis.com/v1/projects/{self.project}/builds"
        op = session.post(url, body=self.build_request(object_name))
        build_id = op.get("metadata", {}).get("build", {}).get("id")
        if not build_id:
            raise RuntimeError(f"Cloud Build returned no build id: {op}")
        status_url = (
            f"https://cloudbuild.googleapis.com/v1/projects/{self.project}"
            f"/builds/{build_id}"
        )
        for _ in range(_CLOUD_BUILD_POLL_ATTEMPTS):
            build = session.get(status_url)
            status = build.get("status")
            if status == "SUCCESS":
                return self.image_uri
            if status in ("FAILURE", "INTERNAL_ERROR", "TIMEOUT", "CANCELLED"):
                raise RuntimeError(f"Cloud Build {build_id} failed: {status}")
            self._sleep(_CLOUD_BUILD_POLL_INTERVAL_SECONDS)
        raise TimeoutError(
            f"Cloud Build {build_id} did not finish within "
            f"{_CLOUD_BUILD_POLL_ATTEMPTS * _CLOUD_BUILD_POLL_INTERVAL_SECONDS}s"
        )
