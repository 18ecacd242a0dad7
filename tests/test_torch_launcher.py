"""The port's launcher (``cloud_tpu_torch.core``: validate, containerize,
deploy, run, notebook, bootstrap) against the JAX package's, on the CPU.

The scenarios are those of ``tests/unit/test_launcher.py``, each run on
both packages with the same ``RecordingSession`` scripts
(``tests/unit/fakes.py``), and compared as data: the request sequences and
bodies, the Dockerfile apart from the framework's own lines
(``helpers/torch_launcher.py`` ``FRAMEWORK_LINES``), the ``RunReport``
fields (job id fixed), and the exceptions' types and messages.  The
bootstrap's subprocess contract runs on 2 gloo ranks: ``remote()`` is
true, the planned mesh is installed and argv is forwarded; a plan whose
size is not the process count raises.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from helpers.torch_launcher import (JAX, PORT, SIDES, as_data,
                                    dockerfile_as_data, error_of, mc)
from unit.fakes import RecordingSession

torch.set_num_threads(1)


class FakeSession(RecordingSession):
    """GETs default to a READY node (as the reference's test fixture)."""

    def __init__(self, responses=None):
        super().__init__(responses, get_default={"state": "READY"})


def both(scenario, *args, **kwargs):
    """``scenario(side, ...)`` on the JAX package and on the port."""
    return [scenario(side, *args, **kwargs) for side in SIDES]


def assert_same(scenario, *args, **kwargs):
    want, got = both(scenario, *args, **kwargs)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# validate


def _validate_kwargs(side, **overrides):
    kw = dict(entry_point=None, requirements_txt=None,
              distribution_strategy="auto", chief_config=mc(side, "TPU"),
              worker_config=None, worker_count=0, entry_point_args=None,
              stream_logs=False, docker_image_build_bucket=None,
              called_from_notebook=False)
    kw.update(overrides)
    return kw


def _validate_cases(tmp_path):
    bad = tmp_path / "train.sh"
    bad.write_text("echo hi")
    good = tmp_path / "train.py"
    good.write_text("pass")
    return {
        "defaults": lambda s: {},
        "missing entry point": lambda s: {"entry_point": "/nope/missing.py"},
        "bad suffix": lambda s: {"entry_point": str(bad)},
        "missing requirements": lambda s: {"entry_point": str(good),
                                           "requirements_txt": "/nope.txt"},
        "bad strategy": lambda s: {"distribution_strategy": "mirrored"},
        "gpu chief": lambda s: {"chief_config": mc(s, "T4_1X")},
        "worker needs config": lambda s: {"worker_count": 2},
        "bad worker count": lambda s: {"worker_count": -1},
        "heterogeneous slices": lambda s: {
            "worker_count": 1, "worker_config": mc(s, "TPU_V5E_16")},
        "gpu worker": lambda s: {"worker_count": 1,
                                 "chief_config": mc(s, "CPU"),
                                 "worker_config": mc(s, "V100_1X")},
        "not a config": lambda s: {"chief_config": "TPU"},
        "notebook needs bucket": lambda s: {"called_from_notebook": True},
        "bad entry point args": lambda s: {"entry_point_args": [1, 2]},
        "bad stream_logs": lambda s: {"stream_logs": "yes"},
        "bad service account": lambda s: {"service_account": "nobody"},
        "bad labels": lambda s: {"job_labels": {"Bad": "x"}},
    }


VALIDATE_CASES = (
    "defaults", "missing entry point", "bad suffix", "missing requirements",
    "bad strategy", "gpu chief", "worker needs config", "bad worker count",
    "heterogeneous slices", "gpu worker", "not a config",
    "notebook needs bucket", "bad entry point args", "bad stream_logs",
    "bad service account", "bad labels")


@pytest.mark.parametrize("case", VALIDATE_CASES)
def test_validate_equals_the_reference(case, tmp_path):
    overrides = _validate_cases(tmp_path)[case]
    assert_same(lambda s: error_of(lambda: s.validate.validate(
        **_validate_kwargs(s, **overrides(s)))))


# ---------------------------------------------------------------------------
# containerize


def _dockerfiles(side):
    c = side.containerize
    tpu, cpu = mc(side, "TPU"), mc(side, "CPU")
    return {
        "golden": c.make_dockerfile("train.py", tpu,
                                    requirements_name="requirements.txt"),
        "plan and args": c.make_dockerfile(
            "train.py", tpu, mesh_plan_json='{"s": 1}',
            entry_point_args=["--epochs", "3"]),
        "cpu": c.make_dockerfile("train.py", cpu),
        "no strategy": c.make_dockerfile("t.py", tpu,
                                         distribution_strategy="none"),
        "parent image": c.make_dockerfile("t.py", tpu,
                                          parent_image="my/base:1"),
    }


@pytest.mark.parametrize("case", ["golden", "plan and args", "cpu",
                                  "no strategy", "parent image"])
def test_dockerfile_equals_the_reference_but_its_framework_lines(case):
    want, got = (dockerfile_as_data(_dockerfiles(s)[case], s) for s in SIDES)
    assert got == want
    text = _dockerfiles(PORT)[case]
    assert "jax" not in text
    argv = PORT.containerize.entrypoint_argv(text)
    assert argv[:3] == ["python", "-m", "cloud_tpu_torch.core.bootstrap"]
    if case == "parent image":
        assert text.splitlines()[0] == "FROM my/base:1"
    else:
        assert text.splitlines()[0] == (
            f"FROM {PORT.containerize.DEFAULT_BASE_IMAGE}")


def test_dockerfile_pins_the_local_torch_release():
    text = PORT.containerize.make_dockerfile("t.py", mc(PORT, "TPU"))
    release = torch.__version__.split("+")[0]
    assert f"RUN pip install --no-cache-dir 'torch=={release}'" in text
    text = PORT.containerize.make_dockerfile("t.py", mc(PORT, "TPU"),
                                             torch_version="2.11.0")
    assert "'torch==2.11.0'" in text
    assert PORT.containerize.DockerConfig(torch_version="2.11.0")


def test_build_context_vendors_the_port_with_its_sources(tmp_path):
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "train.py").write_text("print('hi')")
    (proj / "helper.py").write_text("x = 1")
    names = {}
    for side in SIDES:
        ctx = side.containerize.build_context(
            "FROM x", str(proj / "train.py"), None,
            dst_dir=str(tmp_path / f"ctx_{side.name}"))
        names[side.name] = set(os.listdir(ctx)) - {side.package}
        assert os.path.isfile(os.path.join(ctx, side.package, "core",
                                           "run.py"))
    assert names["port"] == names["jax"] == {"Dockerfile", "train.py",
                                             "helper.py"}
    vendored = tmp_path / "ctx_port" / "cloud_tpu_torch"
    files = {str(p.relative_to(vendored)) for p in vendored.rglob("*")
             if p.is_file()}
    assert "ops/csrc/group_norm.cu" in files
    assert "monitoring/cpp/wire_client.cc" in files
    assert "monitoring/cpp/Makefile" in files
    assert "training/cpp/records_native.cc" in files
    assert not any(f.startswith("build/") or f.endswith((".so", ".o", ".pyc"))
                   or "__pycache__" in f for f in files), sorted(files)


def _cloud_builder(side, tmp_path, responses):
    ctx = tmp_path / f"ctx_{side.name}"
    ctx.mkdir(exist_ok=True)
    (ctx / "Dockerfile").write_text("FROM x")
    uploads = []

    class FakeBlob:
        def upload_from_string(self, data, content_type=None):
            uploads.append(content_type)

    class FakeBucket:
        def blob(self, name):
            return FakeBlob()

    class FakeStorage:
        def bucket(self, name):
            return FakeBucket()

    session = FakeSession(responses)
    builder = side.containerize.CloudContainerBuilder(
        "gcr.io/p/i:1", str(ctx), project="p", bucket="b", session=session,
        storage_client=FakeStorage(), sleeper=lambda s: None)
    return builder, session, uploads


@pytest.mark.parametrize("responses", [
    [{"metadata": {"build": {"id": "bid"}}}, {"status": "WORKING"},
     {"status": "SUCCESS"}],
    [{"metadata": {"build": {"id": "bid"}}}, {"status": "FAILURE"}],
    [{}],
], ids=["success", "failure", "no build id"])
def test_cloud_builder_equals_the_reference(responses, tmp_path):
    def scenario(side):
        builder, session, uploads = _cloud_builder(side, tmp_path,
                                                   list(responses))
        golden = builder.build_request("obj.tgz")
        outcome = error_of(builder.get_docker_image)
        calls = [(m, u, b if "builds" not in str(b) else None, p)
                 for m, u, b, p in session.calls]
        # The uploaded object's name is random: compare the body's shape.
        for call in calls:
            if call[2] and "source" in call[2]:
                call[2]["source"]["storageSource"]["object"] = "<object>"
        return golden, outcome, calls, uploads

    assert_same(scenario)


def test_local_builder_equals_the_reference(tmp_path):
    def scenario(side):
        calls = []
        builder = side.containerize.LocalContainerBuilder(
            "img:1", str(tmp_path), cache_from="img:0", runner=calls.append)
        return builder.get_docker_image(), calls

    assert_same(scenario)


# ---------------------------------------------------------------------------
# deploy


def _plan(side, name="TPU", workers=0):
    return side.planner.plan_mesh(chief_config=mc(side, name),
                                  worker_count=workers)


def _requests(side):
    d = side.deploy
    tpu = mc(side, "TPU")
    return {
        "golden": d.build_job_request("gcr.io/p/img:1", tpu, 0, _plan(side),
                                      job_id="cloud-tpu-train-abc123"),
        "knobs": d.build_job_request(
            "img", tpu, 0, _plan(side), job_id="j", monitoring=False,
            profiler_port=9012, submit_ts=1234.5, compile_cache="/c c/$x",
            job_labels={"team": "ml"}, service_account="sa@p.iam"),
        "multi-slice": d.build_job_request(
            "img", mc(side, "TPU_V5E_32"), 1,
            _plan(side, "TPU_V5E_32", 1), job_id="j"),
        "serve fleet": d.build_serve_fleet_request(
            "img", mc(side, "TPU_V5E_4"), 3, _plan(side, "TPU_V5E_4"),
            job_id="f", roles=["prefill", "decode"]),
    }


@pytest.mark.parametrize("case", ["golden", "knobs", "multi-slice",
                                  "serve fleet"])
def test_node_requests_and_startup_scripts_equal_the_reference(
        case, monkeypatch):
    monkeypatch.delenv("CLOUD_TPU_COMPILE_CACHE", raising=False)
    want, got = (_requests(s)[case] for s in SIDES)
    assert got == want
    for node in got["nodes"].values():
        script = node["metadata"]["startup-script"]
        assert "jax" not in script and "torch" not in script


def test_startup_script_forwards_the_compile_cache_from_env(monkeypatch):
    monkeypatch.setenv("CLOUD_TPU_COMPILE_CACHE", "/cache/dir")
    want, got = (s.deploy.startup_script(
        "img", coordinator_address="c:1", num_processes=2,
        process_id_base=0, submit_ts=1.0, profiler_port=9012)
        for s in SIDES)
    assert got == want
    assert "-e CLOUD_TPU_COMPILE_CACHE=/cache/dir \\" in got
    assert "-e CLOUD_TPU_SUBMIT_TS=1.0 \\" in got


def _calls(session, job_id_of=None):
    """Recorded calls, the random job id replaced."""
    out = []
    for method, url, body, params in session.calls:
        text = json.dumps([method, url, body, params], sort_keys=True)
        if job_id_of:
            text = text.replace(job_id_of, "<job>")
        out.append(json.loads(text))
    return out


def _deploy_scenarios():
    def posts_nodes(side):
        session = FakeSession(responses=[
            {"name": "projects/proj/locations/us-west4-a/operations/op1",
             "done": True},
            {"state": "READY"},
        ])
        info = side.deploy.deploy_job("img", mc(side, "TPU"), 0,
                                      _plan(side), session=session,
                                      zone="us-west4-a")
        return info["console_url"], _calls(session, info["job_id"])

    def polls(side):
        sleeps = []
        session = FakeSession(responses=[
            {"name": "ops/op1"}, {"name": "ops/op1"},
            {"name": "ops/op1", "done": True}, {"state": "CREATING"},
            {"state": "READY"},
        ])
        req = side.deploy.build_job_request("img", mc(side, "TPU"), 0,
                                            _plan(side), job_id="j")
        side.deploy.deploy_job("img", mc(side, "TPU"), 0, _plan(side),
                               session=session, project="p", zone="z",
                               sleep=sleeps.append, request=req)
        bases = [5, 5, 10]
        assert all(b * 0.8 <= s <= b * 1.2 for s, b in zip(sleeps, bases))
        return len(sleeps), _calls(session)

    def rolls_back(side):
        api = side.api_client

        class FailSecondPost(FakeSession):
            def post(self, url, body=None, params=None):
                if len([c for c in self.calls if c[0] == "POST"]) == 1:
                    self.calls.append(("POST", url, body, params))
                    raise api.ApiError(429, "quota")
                return super().post(url, body=body, params=params)

        session = FailSecondPost(responses=[{"done": True, "name": "ops/1"}])
        req = side.deploy.build_job_request(
            "img", mc(side, "TPU_V5E_32"), 1, _plan(side, "TPU_V5E_32", 1),
            job_id="j")
        out = error_of(lambda: side.deploy.deploy_job(
            "img", mc(side, "TPU_V5E_32"), 1, _plan(side, "TPU_V5E_32", 1),
            session=session, project="p", zone="z", sleep=lambda _: None,
            request=req))
        return out, _calls(session)

    def transient_then_409(side):
        api = side.api_client

        class Flaky(FakeSession):
            def post(self, url, body=None, params=None):
                self.calls.append(("POST", url, body, params))
                if len(self.calls) == 1:
                    raise api.ApiTransientError(503, "blip")
                if len(self.calls) == 2:
                    raise api.ApiError(409, "exists")
                return {}

        session = Flaky()
        req = side.deploy.build_job_request("img", mc(side, "TPU"), 0,
                                            _plan(side), job_id="j")
        side.deploy.deploy_job("img", mc(side, "TPU"), 0, _plan(side),
                               session=session, project="p", zone="z",
                               sleep=lambda _: None, request=req)
        return _calls(session)

    def terminal_state(side):
        session = FakeSession(responses=[{"name": "ops/1", "done": True},
                                         {"state": "PREEMPTED"}])
        req = side.deploy.build_job_request("img", mc(side, "TPU"), 0,
                                            _plan(side), job_id="j")
        out = error_of(lambda: side.deploy.deploy_job(
            "img", mc(side, "TPU"), 0, _plan(side), session=session,
            project="p", zone="z", sleep=lambda _: None, request=req))
        return out, _calls(session)

    def rejects_cpu(side):
        return error_of(lambda: side.deploy.deploy_job(
            "img", mc(side, "CPU"), 0, _plan(side, "CPU"),
            session=FakeSession(), project="p", zone="z"))

    def rejects_gpu(side):
        return error_of(lambda: side.deploy.deploy_job(
            "img", mc(side, "V100_4X"), 0, _plan(side, "CPU"),
            session=FakeSession(), project="p", zone="z"))

    def deletes(side):
        session = FakeSession()
        side.deploy.delete_job({"project": "p", "zone": "z",
                                "nodes": ["a", "b"]}, session=session)
        return _calls(session)

    def streams_logs(side):
        session = FakeSession(responses=[
            {"entries": [{"textPayload": "a", "timestamp": "t1"},
                         {"jsonPayload": {"k": 1}, "timestamp": "t2"}]},
            {"entries": [{"textPayload": "c", "timestamp": "t3"}]},
            {"entries": []},
        ])
        lines, polls = [], []
        printed = side.deploy.stream_logs(
            "job1", "proj", session=session,
            should_stop=lambda: len(polls) >= 2, sleep=polls.append,
            out=lines.append)
        return printed, lines, _calls(session)

    return {f.__name__: f for f in (
        posts_nodes, polls, rolls_back, transient_then_409, terminal_state,
        rejects_cpu, rejects_gpu, deletes, streams_logs)}


@pytest.mark.parametrize("case", sorted(_deploy_scenarios()))
def test_deploy_equals_the_reference(case, monkeypatch):
    monkeypatch.setenv("GOOGLE_CLOUD_PROJECT", "proj")
    assert_same(_deploy_scenarios()[case])


def _supervise_scenarios():
    def setup(side):
        request = side.deploy.build_job_request("img", mc(side, "TPU"), 0,
                                                _plan(side), job_id="j")
        job_info = {"job_id": "j", "nodes": list(request["nodes"]),
                    "project": "p", "zone": "z"}
        return request, job_info

    def recreates(side):
        request, job_info = setup(side)
        session = FakeSession(responses=[
            {"state": "READY"}, {"state": "PREEMPTED"}, {},
            {"name": "ops/r", "done": True}, {"state": "READY"},
            {"state": "READY"},
        ])
        rounds = []
        result = side.deploy.supervise_job(
            job_info, request, session=session,
            should_stop=lambda: len(rounds) >= 3,
            sleep=lambda _: rounds.append(1))
        return result, _calls(session)

    def budget(side):
        request, job_info = setup(side)

        class AlwaysPreempted(FakeSession):
            def get(self, url, params=None):
                self.calls.append(("GET", url, None, params))
                if "/nodes/" in url:
                    return {"state": "PREEMPTED"}
                return {"done": True, "name": "ops/x"}

        session = AlwaysPreempted()
        out = error_of(lambda: side.deploy.supervise_job(
            job_info, request, session=session, max_restarts=2,
            sleep=lambda _: None))
        return out, _calls(session)

    def delete_lro(side):
        request, job_info = setup(side)
        session = FakeSession(responses=[
            {"state": "PREEMPTED"}, {"name": "ops/del", "done": False},
            {"name": "ops/del", "done": True},
            {"name": "ops/cr", "done": True}, {"state": "READY"},
        ])
        rounds = []
        side.deploy.supervise_job(
            job_info, request, session=session,
            should_stop=lambda: len(rounds) >= 1,
            sleep=lambda s: rounds.append(s) if s else None)
        return _calls(session)

    def torn_down(side):
        request, job_info = setup(side)
        api = side.api_client

        class Gone(FakeSession):
            def get(self, url, params=None):
                self.calls.append(("GET", url, None, params))
                raise api.ApiError(404, "not found")

        session = Gone()
        result = side.deploy.supervise_job(job_info, request,
                                           session=session,
                                           sleep=lambda _: None)
        return result, _calls(session)

    def pending_cleared(side):
        request, job_info = setup(side)
        api = side.api_client

        class Script(FakeSession):
            def get(self, url, params=None):
                if "/nodes/j-0" in url and not self.responses:
                    self.calls.append(("GET", url, None, params))
                    raise api.ApiError(404, "torn down")
                return super().get(url, params=params)

        session = Script(responses=[
            {"state": "PREEMPTED"}, {},
            {"name": "ops/c", "done": True, "error": {"code": 8}},
            {"state": "READY"},
        ])
        result = side.deploy.supervise_job(job_info, request,
                                           session=session, max_restarts=5,
                                           sleep=lambda _: None)
        return result, _calls(session)

    return {f.__name__: f for f in (recreates, budget, delete_lro,
                                    torn_down, pending_cleared)}


@pytest.mark.parametrize("case", sorted(_supervise_scenarios()))
def test_supervise_equals_the_reference(case):
    assert_same(_supervise_scenarios()[case])


# ---------------------------------------------------------------------------
# run


class _FakeBuilder:
    def get_docker_image(self):
        return "gcr.io/proj/built:1"


def _fixed_job_id(monkeypatch):
    """Pin the random job id and default image tag on both sides."""
    for side in SIDES:
        monkeypatch.setattr(side.deploy, "_job_id",
                            lambda: "cloud-tpu-train-fixed")
        monkeypatch.setattr(
            side.containerize, "default_image_uri",
            lambda project: f"gcr.io/{project}/cloud_tpu_train:fixed")


def _report(side, report):
    out = as_data(report)[1]
    out["dockerfile"] = (dockerfile_as_data(report.dockerfile, side)
                         if report.dockerfile else None)
    return out


def _run_scenarios(tmp_path):
    script = tmp_path / "train.py"
    script.write_text("print('train')")
    reqs = tmp_path / "requirements.txt"
    reqs.write_text("numpy\n")

    def dry_run(side):
        report = side.run.run(entry_point=str(script), dry_run=True)
        assert report.image_uri == "gcr.io/proj/cloud_tpu_train:fixed"
        assert report.mesh_plan.spec.size("fsdp") == 8
        return _report(side, report)

    def dry_run_v5e_1_with_args(side):
        return _report(side, side.run.run(
            entry_point=str(script), requirements_txt=str(reqs),
            chief_config=mc(side, "TPU_V5E_1"),
            docker_config=side.containerize.DockerConfig(image="gcr.io/p/i"),
            entry_point_args=["--epochs", "2"], job_labels={"team": "ml"},
            profiler_port=9012, dry_run=True))

    def dry_run_multi_slice_hints(side):
        return _report(side, side.run.run(
            entry_point=str(script), chief_config=mc(side, "TPU_V5E_16"),
            worker_count=1, parallelism_hints=side.planner.ParallelismHints(
                tp=2), dry_run=True,
            docker_config=side.containerize.DockerConfig(image="i")))

    def no_strategy(side):
        return _report(side, side.run.run(
            entry_point=str(script), distribution_strategy=None,
            docker_config=side.containerize.DockerConfig(image="i"),
            dry_run=True))

    def unknown_kwargs(side):
        return error_of(lambda: side.run.run(entry_point=str(script),
                                             dry_run=True, bogus=1))

    def invalid(side):
        return error_of(lambda: side.run.run(
            entry_point=str(script), chief_config=mc(side, "T4_1X"),
            dry_run=True))

    def end_to_end(side):
        session = FakeSession()
        report = side.run.run(entry_point=str(script),
                              _builder=_FakeBuilder(), _session=session)
        return _report(side, report), _calls(session)

    def supervision(side):
        calls = {}

        def fake_supervise(job_info, request, *, session, max_restarts):
            calls.update(job_info=job_info, nodes=sorted(request["nodes"]),
                         max_restarts=max_restarts)
            return {"restarts": {}}

        orig = side.deploy.supervise_job
        side.deploy.supervise_job = fake_supervise
        try:
            report = side.run.run(entry_point=str(script), max_restarts=2,
                                  _session=FakeSession(),
                                  _builder=_FakeBuilder())
        finally:
            side.deploy.supervise_job = orig
        return _report(side, report), calls

    return {f.__name__: f for f in (
        dry_run, dry_run_v5e_1_with_args, dry_run_multi_slice_hints,
        no_strategy, unknown_kwargs, invalid, end_to_end, supervision)}


RUN_CASES = ("dry_run", "dry_run_v5e_1_with_args",
             "dry_run_multi_slice_hints", "no_strategy", "unknown_kwargs",
             "invalid", "end_to_end", "supervision")


@pytest.mark.parametrize("case", RUN_CASES)
def test_run_equals_the_reference(case, tmp_path, monkeypatch):
    monkeypatch.setenv("GOOGLE_CLOUD_PROJECT", "proj")
    monkeypatch.delenv("CLOUD_TPU_RUNNING_REMOTELY", raising=False)
    monkeypatch.delenv("CLOUD_TPU_COMPILE_CACHE", raising=False)
    _fixed_job_id(monkeypatch)
    # submit_ts is the wall clock at submission: pin it.
    monkeypatch.setattr(__import__("time"), "time", lambda: 1000.0)
    assert_same(_run_scenarios(tmp_path)[case])


def test_remote_guard_and_script_mode(tmp_path, monkeypatch):
    monkeypatch.setenv("GOOGLE_CLOUD_PROJECT", "proj")
    script = tmp_path / "self_launch.py"
    script.write_text("print('x')")
    for side in SIDES:
        monkeypatch.setenv(side.run.ENV_RUNNING_REMOTELY, "1")
        report = side.run.run(entry_point="does_not_matter.py")
        assert not report.submitted and side.run.remote()
        monkeypatch.delenv(side.run.ENV_RUNNING_REMOTELY)
        assert not side.run.remote()
        monkeypatch.setattr(sys, "argv", [str(script)])
        with pytest.raises(SystemExit) as excinfo:
            side.run.run(_builder=_FakeBuilder(), _session=FakeSession())
        assert excinfo.value.code == 0


def test_failed_run_clears_the_submit_mark(tmp_path, monkeypatch):
    from cloud_tpu_torch.monitoring import tracing

    monkeypatch.setenv("GOOGLE_CLOUD_PROJECT", "proj")
    tracing.clear_submit()
    with pytest.raises(ValueError):
        PORT.run.run(entry_point=str(tmp_path / "missing.py"))
    assert tracing.record_submit_to_first_step() is None


# ---------------------------------------------------------------------------
# notebook


def test_notebook_conversion_equals_the_reference(tmp_path):
    nb = {"cells": [{"cell_type": "code", "metadata": {}, "outputs": [],
                     "execution_count": None,
                     "source": ["!pip install something\n",
                                "%matplotlib inline\n", "x = 1\n",
                                "print(x)\n"]}],
          "metadata": {}, "nbformat": 4, "nbformat_minor": 5}
    path = tmp_path / "nb.ipynb"
    path.write_text(json.dumps(nb))
    texts = []
    for side in SIDES:
        out = tmp_path / side.name
        out.mkdir()
        texts.append(open(side.notebook.notebook_to_script(
            str(path), str(out))).read())
    assert texts[0] == texts[1]
    assert "x = 1" in texts[1] and "pip install" not in texts[1]


IPYNB = {"ipynb": {"cells": [
    {"cell_type": "markdown", "source": ["# title\n"]},
    {"cell_type": "code", "source": ["!pip install something\n",
                                     "%load_ext autoreload\n", "x = 41\n"]},
    {"cell_type": "code", "source": "y = x + 1\nprint(y)\n"},
]}}


def test_colab_live_fetch_equals_the_reference(tmp_path, monkeypatch):
    import types

    def scenario(side):
        out = tmp_path / side.name
        out.mkdir()
        calls = []
        script = side.notebook.fetch_live_notebook_script(
            str(out), _request=lambda m, b: calls.append((m, b)) or IPYNB)
        none = error_of(lambda: side.notebook.fetch_live_notebook_script(
            _request=lambda m, b: None))
        return calls, open(script).read(), none

    assert_same(scenario)

    monkeypatch.setenv("GOOGLE_CLOUD_PROJECT", "proj")
    for side in SIDES:
        monkeypatch.setattr(side.notebook, "called_from_notebook",
                            lambda: True)
    message = types.SimpleNamespace(
        blocking_request=lambda method, request, timeout_sec: IPYNB)
    colab = types.ModuleType("google.colab")
    colab._message = message
    monkeypatch.setitem(sys.modules, "google.colab", colab)
    monkeypatch.setitem(sys.modules, "google.colab._message", message)
    _fixed_job_id(monkeypatch)
    monkeypatch.setattr(__import__("time"), "time", lambda: 1000.0)
    assert_same(lambda s: _report(s, s.run.run(
        docker_config=s.containerize.DockerConfig(image_build_bucket="bkt",
                                                  image="i"),
        dry_run=True)))
    monkeypatch.delitem(sys.modules, "google.colab")
    monkeypatch.delitem(sys.modules, "google.colab._message")
    assert_same(lambda s: error_of(lambda: s.run.run(
        docker_config=s.containerize.DockerConfig(image_build_bucket="bkt"),
        dry_run=True)))


# ---------------------------------------------------------------------------
# bootstrap


_USER_SCRIPT = """
import json, sys
from cloud_tpu_torch.core import run as run_lib
from cloud_tpu_torch.parallel import distributed
from cloud_tpu_torch.parallel import mesh as mesh_lib
assert run_lib.remote(), "remote() must be True in the container"
mesh = mesh_lib.get_global_mesh()
print(json.dumps({
    "axes": mesh.shape, "rank": distributed.process_index(),
    "device": str(mesh.device), "backend": mesh.backend,
    "argv": sys.argv[1:],
}))
"""


def test_bootstrap_subprocess_contract_on_two_gloo_ranks(tmp_path):
    from cloud_tpu_torch.utils import local_rig

    user_script = tmp_path / "user_train.py"
    user_script.write_text(textwrap.dedent(_USER_SCRIPT))
    for plan in (None, PORT.planner.plan_mesh(num_devices=2).to_json()):
        result = local_rig.run_bootstrap(
            str(user_script), device="cpu", mesh_plan_json=plan,
            num_processes=2, args=["--epochs", "2"], timeout=120)
        assert result.returncode == 0, [r.stderr for r in result.ranks]
        outs = [json.loads(r.stdout.strip().splitlines()[-1])
                for r in result.ranks]
        assert [o["rank"] for o in outs] == [0, 1]
        for out in outs:
            assert out["axes"]["fsdp"] == 2
            assert (out["device"], out["backend"]) == ("cpu", "gloo")
            assert out["argv"] == ["--epochs", "2"]


def test_bootstrap_plan_of_another_size_raises(tmp_path):
    from cloud_tpu_torch.utils import local_rig

    user_script = tmp_path / "user_train.py"
    user_script.write_text("print('never')\n")
    plan = PORT.planner.plan_mesh(num_devices=8).to_json()
    result = local_rig.run_bootstrap(str(user_script), device="cpu",
                                     mesh_plan_json=plan, num_processes=2,
                                     timeout=120)
    assert result.returncode != 0
    for rank in result.ranks:
        assert "spans 8 devices" in rank.stderr
        assert "2 process(es)" in rank.stderr
        assert "never" not in rank.stdout


def test_bootstrap_not_asked_for_the_cpu_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    user_script = tmp_path / "user_train.py"
    user_script.write_text("print('never')\n")
    env = dict(os.environ)
    env.pop("CLOUD_TPU_RUNNING_REMOTELY", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(__import__("pathlib").Path(__file__).resolve().parents[1]),
         env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-m", "cloud_tpu_torch.core.bootstrap",
         f"--entry-point={user_script}"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "never" not in out.stdout


def test_api_session_retries_like_the_reference():
    """The API session through a fake transport: the same retries of an
    injected transient fault (and of a 503 answer), the same failure on a
    permanent one, the same user agent."""
    from cloud_tpu.utils import faults as jax_faults
    from cloud_tpu.utils import retries as jax_retries
    from cloud_tpu_torch.utils import faults, retries

    class Response:
        def __init__(self, status, body=b"{}"):
            self.status_code, self.content, self.text = status, body, "x"
            self.headers = {}

        def json(self):
            return json.loads(self.content)

    def scenario(side, faults_mod, retries_mod, plan):
        answers = [Response(503), Response(200, b'{"ok": 1}')]
        sent = []

        class Transport:
            def request(self, method, url, **kw):
                sent.append((method, url, kw["headers"]["user-agent"]))
                return answers.pop(0)

        session = side.api_client.GcpApiSession(
            requests_session=Transport(),
            retry=retries_mod.default_api_policy(sleep=lambda s: None))
        with faults_mod.inject(plan) as fired:
            out = error_of(lambda: session.get("http://localhost/x"))
        agents = {agent for _, _, agent in sent}
        return out, [(m, u) for m, u, _ in sent], fired.fired(), agents

    for plan in ([{"site": "api.request", "mode": "raise",
                   "error": "transient", "times": 2}],
                 [{"site": "api.request", "mode": "raise", "error": "api",
                   "nth": 1}]):
        want = scenario(JAX, jax_faults, jax_retries, plan)
        got = scenario(PORT, faults, retries, plan)
        assert got[1:3] == want[1:3]
        assert got[0][0] == want[0][0] or (
            got[0][0], want[0][0]) == ("InjectedApiError", "ApiError")
        assert all(a.startswith("cloud-tpu/") for a in got[3])
