"""The port's tuner (``cloud_tpu_torch.tuner``) against the JAX package's
(``cloud_tpu.tuner``), on the CPU.

The port's counterpart of every case of ``tests/unit/test_tuner.py``:
hyperparameters, the Vizier converters, the engine, the local study
service, distributed tuning over one study file (its workers meet at a
file barrier once each holds a trial, so a late worker cannot find the
budget spent), the Vizier client on a scripted ``FakeSession``
(``tests/helpers/torch_tuner_fakes.py``) and ``CloudTuner`` end to end.
And parity with the JAX package:

* the same ``HyperParameters`` give the same study config, and the same
  operations on a seeded local study write the same bytes;
* the same ``FakeSession`` script gives the same request bodies from
  both Vizier clients;
* a JAX worker and a port worker (JAX blocked in its process) share one
  study directory: the study ends with the budget's trials, each
  completed once, and both workers' ids;
* a ``RandomSearchOracle`` with the same seed drives the JAX tuner and
  the port's over the MNIST hypermodel on the same (bridged) weights:
  the same trials, each score within 1e-4;
* ``dispatch_search(..., dry_run=True)`` gives the same worker args and
  labels as JAX's;
* the golden workload (``tests/helpers/torch_tuner_mnist_example.py``)
  and the launcher example's dry run
  (``tests/helpers/torch_call_run_with_tuner_search.py``).
"""

import dataclasses
import functools
import json
import os
import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from cloud_tpu import tuner as jax_tuner
from cloud_tpu.tuner import vizier_client as jax_vizier_client
from cloud_tpu.utils.api_client import ApiError as JaxApiError
from cloud_tpu_torch import tuner as tuner_lib
from cloud_tpu_torch.tuner import (
    CloudOracle,
    CloudTuner,
    HyperParameters,
    LocalStudyService,
    Objective,
    TrialStatus,
    Tuner,
    vizier_utils,
)
from cloud_tpu_torch.tuner.engine import RandomSearchOracle
from cloud_tpu_torch.tuner.vizier_client import VizierStudyService
from cloud_tpu_torch.utils.api_client import ApiError
from helpers.torch_launcher import dockerfile_as_data
from helpers.torch_port import mnist_models
from helpers.torch_tuner_fakes import FakeSession, FakeTrainer

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
HELPERS = REPO / "tests" / "helpers"


def _hp(lib=tuner_lib):
    hp = lib.HyperParameters()
    hp.Float("lr", 0.0, 1.0)
    return hp


def _study_config(lib=tuner_lib):
    return lib.vizier_utils.make_study_config(lib.Objective("loss", "min"),
                                              _hp(lib))


# --- hyperparameters --------------------------------------------------------


def test_register_and_defaults():
    hp = HyperParameters()
    lr = hp.Float("lr", 1e-4, 1e-1, sampling="log")
    units = hp.Int("units", 32, 128, step=32)
    act = hp.Choice("act", ["relu", "gelu"])
    flag = hp.Boolean("flag")
    assert lr == 1e-4 and units == 32 and act == "relu" and flag is False
    assert [s.name for s in hp.space] == ["lr", "units", "act", "flag"]


def test_sampling_respects_bounds():
    hp = HyperParameters()
    hp.Float("lr", 1e-4, 1e-1, sampling="log")
    hp.Int("units", 32, 128, step=32)
    for _ in range(50):
        values = hp.sample(random.Random())
        assert 1e-4 <= values["lr"] <= 1e-1
        assert values["units"] in (32, 64, 96, 128)


def test_copy_with_values():
    hp = HyperParameters()
    hp.Float("lr", 0.1, 1.0)
    hp2 = hp.copy_with_values({"lr": 0.5})
    assert hp2.get("lr") == 0.5
    assert hp.get("lr") == 0.1


def test_sampling_equals_the_reference_draw_for_draw():
    sides = []
    for lib in (jax_tuner, tuner_lib):
        hp = lib.HyperParameters()
        hp.Float("lr", 1e-4, 1e-1, sampling="log")
        hp.Int("units", 32, 128, step=32)
        hp.Int("log_units", 2, 64, sampling="log")
        hp.Choice("act", ["relu", "gelu"])
        hp.Boolean("flag")
        hp.Fixed("tag", 7)
        rng = random.Random(3)
        sides.append([hp.sample(rng) for _ in range(20)])
    assert sides[0] == sides[1]


# --- converters -------------------------------------------------------------


def _space(lib):
    hp = lib.HyperParameters()
    hp.Float("lr", 1e-4, 1e-1, sampling="log")
    hp.Int("units", 32, 512)
    hp.Int("stepped", 2, 8, step=2)
    hp.Choice("act", ["relu", "gelu"])
    hp.Choice("hidden", [64, 128])
    hp.Boolean("flag")
    hp.Fixed("tag", 42)
    return hp


def test_study_config_round_trip():
    hp = _space(tuner_lib)
    config = vizier_utils.make_study_config(Objective("accuracy", "max"), hp)
    assert config["metrics"] == [{"metric": "accuracy", "goal": "MAXIMIZE"}]
    types = {p["parameter"]: p["type"] for p in config["parameters"]}
    assert types == {
        "lr": "DOUBLE", "units": "INTEGER", "stepped": "DISCRETE",
        "act": "CATEGORICAL", "hidden": "DISCRETE", "flag": "CATEGORICAL",
        "tag": "CATEGORICAL",
    }
    lr = next(p for p in config["parameters"] if p["parameter"] == "lr")
    assert lr["scaleType"] == "UNIT_LOG_SCALE"
    back = vizier_utils.convert_study_config_to_hps(config)
    assert {s.name for s in back.space} == set(types)


def test_same_hyperparameters_give_the_same_study_config():
    for objective in ("loss", "accuracy"):
        configs = [lib.vizier_utils.make_study_config(objective, _space(lib))
                   for lib in (jax_tuner, tuner_lib)]
        assert configs[0] == configs[1]
        backs = [[(type(s).__name__, dataclasses.asdict(s)) for s in
                  lib.vizier_utils.convert_study_config_to_hps(
                      configs[0]).space]
                 for lib in (jax_tuner, tuner_lib)]
        assert backs[0] == backs[1]


def test_coerce_values_restores_native_types():
    hp = HyperParameters()
    hp.Choice("hidden", [64, 128])
    hp.Choice("act", ["relu", "gelu"])
    hp.Int("units", 32, 512)
    hp.Boolean("flag")
    out = vizier_utils.coerce_values(
        hp, {"hidden": 64.0, "act": "gelu", "units": 48.0, "flag": "False"})
    assert out == {"hidden": 64, "act": "gelu", "units": 48, "flag": False}
    assert type(out["hidden"]) is int


def test_trial_to_values():
    trial = {
        "name": "projects/p/locations/r/studies/s/trials/7",
        "parameters": [
            {"parameter": "lr", "floatValue": 0.01},
            {"parameter": "units", "intValue": "64"},
            {"parameter": "act", "stringValue": "gelu"},
        ],
    }
    assert vizier_utils.convert_vizier_trial_to_values(trial) == {
        "lr": 0.01, "units": 64, "act": "gelu"}


# --- engine -----------------------------------------------------------------


def test_random_search_finds_good_lr():
    hp = _hp()
    oracle = RandomSearchOracle(Objective("loss", "min"), hp, max_trials=30,
                                seed=0)
    tuner = Tuner(lambda h: FakeTrainer(h.get("lr")), oracle)
    tuner.search(epochs=1)
    best = tuner.get_best_hyperparameters(1)[0]
    assert abs(best.get("lr") - 0.3) < 0.15
    assert len(oracle.trials) == 30


def test_infeasible_trials_are_recorded():
    oracle = RandomSearchOracle(Objective("loss", "min"), _hp(), max_trials=3)

    def broken(h):
        raise RuntimeError("boom")

    Tuner(broken, oracle).search(epochs=1)
    assert len(oracle.trials) == 3
    assert all(t.status == TrialStatus.INFEASIBLE
               for t in oracle.trials.values())


def test_a_trials_trainer_is_dropped_before_the_next_is_built():
    import weakref

    alive = []

    class Tracked(FakeTrainer):
        pass

    def hypermodel(h):
        assert not [r for r in alive if r() is not None], (
            "the previous trial's trainer is still alive")
        t = Tracked(h.get("lr"))
        alive.append(weakref.ref(t))
        return t

    oracle = RandomSearchOracle(Objective("loss", "min"), _hp(), max_trials=3)
    Tuner(hypermodel, oracle).search(epochs=2)
    assert len(alive) == 3


# --- the local study --------------------------------------------------------


def test_exhaustion(tmp_path):
    svc = LocalStudyService("s1", str(tmp_path), max_trials=2)
    svc.create_or_load_study(_study_config())
    assert svc.get_suggestion("w0") is not None
    assert svc.get_suggestion("w1") is not None
    assert svc.get_suggestion("w0") is None


def test_trial_lifecycle(tmp_path):
    svc = LocalStudyService("s2", str(tmp_path), max_trials=5)
    svc.create_or_load_study(_study_config())
    trial_id, values = svc.get_suggestion("w0")
    assert 0.0 <= values["lr"] <= 1.0
    svc.report_intermediate(trial_id, 0, 0.5)
    svc.complete_trial(trial_id, 0.5)
    trials = svc.list_trials()
    assert trials[0]["status"] == "COMPLETED"
    assert trials[0]["final"] == 0.5


def test_median_stopping(tmp_path):
    svc = LocalStudyService("s3", str(tmp_path), max_trials=10)
    svc.create_or_load_study(_study_config())
    ids = [svc.get_suggestion(f"w{i}")[0] for i in range(5)]
    for tid in ids[:4]:
        svc.report_intermediate(tid, 0, 0.1)
    svc.report_intermediate(ids[4], 0, 5.0)
    assert svc.should_stop(ids[4]) is True
    assert svc.should_stop(ids[0]) is False


def test_the_same_operations_write_the_same_study_bytes(tmp_path):
    files = []
    for lib in (jax_tuner, tuner_lib):
        directory = tmp_path / lib.__name__
        svc = lib.LocalStudyService("bytes", str(directory), max_trials=4,
                                    seed=11)
        svc.create_or_load_study(_study_config(lib))
        ids = [svc.get_suggestion(f"w{i}")[0] for i in range(3)]
        for step, tid in enumerate(ids):
            svc.report_intermediate(tid, step, 0.25 * step)
        svc.should_stop(ids[0])
        svc.complete_trial(ids[0], 0.5)
        svc.complete_trial(ids[1], None, infeasible=True)
        files.append((directory / "bytes.json").read_bytes())
    assert files[0] == files[1]


# --- distributed tuning: workers as processes -------------------------------

_WORKER = """
import json
import sys

kind, directory, barrier_dir, name, parties, budget = sys.argv[1:7]
if kind == "port":
    sys.modules["jax"] = None
    from cloud_tpu_torch import tuner as lib
else:
    from cloud_tpu import tuner as lib
from helpers.torch_tuner_fakes import FakeTrainer, barrier_hypermodel

hp = lib.HyperParameters()
hp.Float("lr", 0.0, 1.0)
svc = lib.LocalStudyService("dist", directory, max_trials=int(budget))
oracle = lib.CloudOracle(svc, objective="loss", hyperparameters=hp,
                         max_trials=int(budget))
tuner = lib.Tuner(barrier_hypermodel(
    barrier_dir, name, int(parties), lambda h: FakeTrainer(h.get("lr"))),
    oracle, tuner_id=name)
tuner.search(epochs=1)
print(json.dumps({"trials": len(oracle.trials)}))
"""


def _workers(tmp_path, kinds, budget):
    study = tmp_path / "study"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, kind, str(study),
         str(tmp_path / "barrier"), f"{kind}{i}", str(len(kinds)),
         str(budget)], cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i, kind in enumerate(kinds)]
    counts = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err[-3000:]
            counts.append(json.loads(out.strip().splitlines()[-1])["trials"])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return str(study), counts


def test_four_workers_share_one_study(tmp_path):
    study, counts = _workers(tmp_path, ["port"] * 4, budget=12)
    trials = LocalStudyService("dist", study, max_trials=12).list_trials()
    assert len(trials) == 12 and sum(counts) == 12
    assert all(t["status"] == "COMPLETED" for t in trials)
    assert len({t["client_id"] for t in trials}) == 4
    assert all(c >= 1 for c in counts)


def test_a_jax_worker_and_a_port_worker_share_one_study(tmp_path):
    study, counts = _workers(tmp_path, ["jax", "port"], budget=6)
    sides = [lib.LocalStudyService("dist", study, max_trials=6).list_trials()
             for lib in (jax_tuner, tuner_lib)]
    assert sides[0] == sides[1]
    trials = sides[1]
    assert len(trials) == 6 and sum(counts) == 6
    assert sorted(t["id"] for t in trials) == [f"{i:04d}" for i in
                                               range(1, 7)]
    assert all(t["status"] == "COMPLETED" and t["final"] is not None
               and len(t["measurements"]) == 1 for t in trials)
    assert {t["client_id"] for t in trials} == {"jax0", "port1"}


# --- the Vizier client on a FakeSession -------------------------------------


def _service(script):
    return VizierStudyService("proj", "us-central1", "study1",
                              session=FakeSession(script),
                              sleeper=lambda s: None)


def test_create_or_load_handles_409():
    svc = _service([("POST", ApiError(409, "exists")),
                    ("GET", {"name": "studies/study1"})])
    svc.create_or_load_study(_study_config())


def test_create_propagates_other_errors():
    svc = _service([("POST", ApiError(500, "boom"))])
    with pytest.raises(ApiError):
        svc.create_or_load_study(_study_config())


def test_suggestion_with_lro_poll():
    svc = _service([
        ("trials:suggest", {"name": "operations/op1", "done": False}),
        ("GET", {"name": "operations/op1", "done": True,
                 "response": {"trials": [{
                     "name": ".../trials/3",
                     "parameters": [{"parameter": "lr", "floatValue": 0.2}],
                 }]}}),
    ])
    assert svc.get_suggestion("w0") == ("3", {"lr": 0.2})


def test_429_means_exhausted():
    svc = _service([("trials:suggest", ApiError(429, "exhausted"))])
    assert svc.get_suggestion("w0") is None


def test_early_stop_true_stops_trial():
    svc = _service([
        (":checkEarlyStoppingState",
         {"name": "op", "done": True, "response": {"shouldStop": True}}),
        (":stop", {}),
    ])
    assert svc.should_stop("5") is True


def test_complete_with_final_measurement():
    session = FakeSession([("studies", {}), (":complete", {})])
    svc = VizierStudyService("p", "r", "s", session=session,
                             sleeper=lambda s: None)
    svc.create_or_load_study(_study_config())
    svc.complete_trial("7", 0.42)
    _, url, body, _ = session.calls[-1]
    assert url.endswith("trials/7:complete")
    assert body == {"finalMeasurement": {
        "metrics": [{"metric": "loss", "value": 0.42}]}}


def test_measurement_metric_name_fetched_when_study_loaded():
    session = FakeSession([
        ("GET", {"studyConfig": _study_config()}),
        (":addMeasurement", {}),
        (":addMeasurement", {}),
    ])
    svc = VizierStudyService("p", "r", "s", session=session,
                             sleeper=lambda s: None)
    svc.report_intermediate("7", 1, 0.9)
    svc.report_intermediate("7", 2, 0.8)
    assert len([c for c in session.calls if c[0] == "GET"]) == 1
    _, _, body, _ = session.calls[-1]
    assert body["measurement"]["metrics"] == [{"metric": "loss",
                                               "value": 0.8}]


def _client_script(error):
    """One script of every call a worker's client makes, with the error
    type of its package."""
    return [
        ("POST", error(409, "exists")),
        ("GET", {"name": "studies/study1"}),
        ("trials:suggest", {"name": "operations/op1", "done": False}),
        ("GET", {"name": "operations/op1", "done": True,
                 "response": {"trials": [{
                     "name": ".../trials/3",
                     "parameters": [{"parameter": "lr", "floatValue": 0.2},
                                    {"parameter": "units",
                                     "intValue": "64"}]}]}}),
        (":addMeasurement", {}),
        (":checkEarlyStoppingState",
         {"name": "op2", "done": True, "response": {"shouldStop": False}}),
        (":addMeasurement", error(400, "inactive")),
        (":complete", {}),
        ("trials:suggest", error(429, "exhausted")),
        ("GET", {"trials": [{"name": ".../trials/3"}]}),
        ("DELETE", {}),
    ]


def _drive(lib_client, session):
    svc = lib_client.VizierStudyService("proj", "us-central1", "study1",
                                        session=session,
                                        sleeper=lambda s: None)
    svc.create_or_load_study(_study_config())
    out = [svc.get_suggestion("tuner0")]
    svc.report_intermediate("3", 1, 0.5)
    out.append(svc.should_stop("3"))
    try:
        svc.report_intermediate("3", 2, 0.4)
    except Exception as exc:  # noqa: BLE001 — its type is compared
        out.append(type(exc).__name__)
    svc.complete_trial("3", 0.4)
    out.append(svc.get_suggestion("tuner0"))
    out.append(svc.list_trials())
    svc.delete_study()
    return out


def test_same_script_gives_the_same_requests_from_both_clients():
    import cloud_tpu_torch.tuner.vizier_client as port_client

    sessions = [FakeSession(_client_script(JaxApiError)),
                FakeSession(_client_script(ApiError))]
    results = [_drive(jax_vizier_client, sessions[0]),
               _drive(port_client, sessions[1])]
    assert results[0] == results[1]
    assert sessions[0].calls == sessions[1].calls
    assert len(sessions[1].calls) == 11


# --- CloudTuner end to end --------------------------------------------------


def test_search_with_local_service(tmp_path):
    svc = LocalStudyService("e2e", str(tmp_path), max_trials=8, seed=7)
    tuner = CloudTuner(lambda h: FakeTrainer(h.get("lr")), svc,
                       objective="loss", hyperparameters=_hp(), max_trials=8)
    tuner.search(epochs=2)
    best = tuner.get_best_hyperparameters(1)
    assert best and 0.0 <= best[0].get("lr") <= 1.0
    assert all(t["status"] == "COMPLETED" for t in svc.list_trials())


def test_type_fidelity_through_service(tmp_path):
    hp = HyperParameters()
    hp.Boolean("use_bias")
    hp.Int("units", 2, 8, step=2)
    hp.Fixed("tag", 42)
    hp.Float("lr", 0.0, 1.0)
    svc = LocalStudyService("types", str(tmp_path), max_trials=6, seed=1)
    oracle = CloudOracle(svc, objective="loss", hyperparameters=hp,
                         max_trials=6)
    seen = set()
    for _ in range(6):
        trial = oracle.create_trial("t0")
        assert isinstance(trial.hyperparameters.get("use_bias"), bool)
        assert isinstance(trial.hyperparameters.get("units"), int)
        assert trial.hyperparameters.get("tag") == 42
        assert isinstance(trial.hyperparameters.get("lr"), float)
        seen.add(trial.hyperparameters.get("use_bias"))
    assert seen == {True, False}


def test_study_config_xor_objective(tmp_path):
    svc = LocalStudyService("x", str(tmp_path))
    with pytest.raises(ValueError, match="not both"):
        CloudOracle(svc, objective="loss", hyperparameters=_hp(),
                    study_config=_study_config())
    with pytest.raises(ValueError, match="objective and hyperparameters"):
        CloudOracle(svc)


def test_same_seed_random_search_over_mnist_equals_jax():
    """The same seeded oracle drives both tuners over the MNIST
    hypermodel on the same weights and batches: the same trials in the
    same order, each score within 1e-4."""
    import jax
    import optax

    from cloud_tpu.models import mnist as jax_mnist
    from cloud_tpu.training import data as jax_data
    from cloud_tpu.training import trainer as jax_trainer
    from cloud_tpu.tuner.engine import RandomSearchOracle as JaxOracle
    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import mnist
    from cloud_tpu_torch.training import data, optimizers, trainer

    jax_cfg, params, cfg, _ = mnist_models(0)
    rng = np.random.default_rng(4)
    arrays = {"image": rng.normal(size=(32, 784)).astype(np.float32),
              "label": rng.integers(0, 10, 32).astype(np.int64)}

    def jax_model(h):
        t = jax_trainer.Trainer(
            functools.partial(jax_mnist.loss_fn, config=jax_cfg),
            optax.sgd(h.get("lr"), momentum=h.get("momentum")),
            lambda _: jax.tree_util.tree_map(jax.numpy.asarray, params))
        t.init_state(jax.random.PRNGKey(0))
        return t

    def port_model(h):
        t = trainer.Trainer(
            functools.partial(mnist.loss_fn, config=cfg, device="cpu"),
            optimizers.sgd(h.get("lr"), momentum=h.get("momentum")),
            lambda _: bridge.mnist_to_torch(params, device="cpu"),
            device="cpu")
        t.init_state(torch.Generator().manual_seed(0))
        return t

    runs = []
    for lib, oracle_cls, model, ds in (
            (jax_tuner, JaxOracle, jax_model,
             jax_data.ArrayDataset(arrays, 8)),
            (tuner_lib, RandomSearchOracle, port_model,
             data.ArrayDataset(arrays, 8))):
        hp = lib.HyperParameters()
        hp.Float("lr", 1e-3, 1e-1, sampling="log")
        hp.Choice("momentum", [0.0, 0.9])
        oracle = oracle_cls(lib.Objective("loss", "min"), hp, max_trials=3,
                            seed=5)
        lib.Tuner(model, oracle).search(train_data=ds, epochs=2)
        runs.append([(t.trial_id, t.hyperparameters.values, t.status.value,
                      t.score, [m["loss"] for m in t.measurements])
                     for t in oracle.trials.values()])
    assert len(runs[1]) == 3
    for (jid, jvalues, jstatus, jscore, jloss), (pid, pvalues, pstatus,
                                                 pscore, ploss) in zip(*runs):
        assert (jid, jvalues, jstatus) == (pid, pvalues, pstatus)
        assert pstatus == "COMPLETED" and len(ploss) == 2
        assert abs(pscore - jscore) <= 1e-4 * max(1.0, abs(jscore))
        np.testing.assert_allclose(ploss, jloss, rtol=1e-4)


# --- dispatch and the golden workloads --------------------------------------


def _dispatch(lib_dispatch, containerize, machine_config):
    study, reports = lib_dispatch.dispatch_search(
        3, str(HELPERS / "torch_tuner_mnist_example.py"),
        study_id="My Study/1", entry_point_args=["--epochs", "1"],
        job_labels={"team": "hp"},
        chief_config=machine_config.COMMON_MACHINE_CONFIGS["TPU_V5E_1"],
        docker_config=containerize.DockerConfig(image="gcr.io/p/tuner:0"),
        dry_run=True)
    return study, reports


def test_dispatch_search_dry_run_equals_jax():
    from cloud_tpu.core import containerize as jax_containerize
    from cloud_tpu.core import machine_config as jax_machine_config
    from cloud_tpu.tuner import dispatch as jax_dispatch
    from cloud_tpu_torch.core import containerize, machine_config
    from cloud_tpu_torch.tuner import dispatch
    from helpers.torch_launcher import JAX, PORT

    sides = [_dispatch(jax_dispatch, jax_containerize, jax_machine_config),
             _dispatch(dispatch, containerize, machine_config)]
    assert sides[0][0] == sides[1][0] == "My Study/1"
    for worker, (jr, pr) in enumerate(zip(sides[0][1], sides[1][1])):
        jargv = [l for l in dockerfile_as_data(jr.dockerfile, JAX)
                 if isinstance(l, tuple) and l[0] == "ENTRYPOINT"]
        pargv = [l for l in dockerfile_as_data(pr.dockerfile, PORT)
                 if isinstance(l, tuple) and l[0] == "ENTRYPOINT"]
        assert jargv == pargv
        argv = pargv[0][1]
        assert argv[argv.index("--") + 1:] == [
            "--epochs", "1", "--study-id", "My Study/1", "--tuner-id",
            f"tuner{worker}"]
        # Each job's own id label is random (cloud-tpu-train-<uuid>).
        jlabels, plabels = [[{k: v for k, v in n["labels"].items()
                              if k != "cloud_tpu_job"}
                             for n in r.node_requests.values()]
                            for r in (jr, pr)]
        assert jlabels == plabels
        assert plabels[0]["study_id"] == "my-study-1"
        assert plabels[0]["team"] == "hp"
    with pytest.raises(ValueError, match="n_workers"):
        tuner_lib.dispatch_search(0, "x.py")


def _load(path, name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_tuner_example(monkeypatch, tmp_path):
    monkeypatch.setenv("TUNER_EXAMPLE_MAX_TRIALS", "2")
    monkeypatch.setenv("TUNER_EXAMPLE_STUDY_DIR", str(tmp_path))
    mod = _load(HELPERS / "torch_tuner_mnist_example.py",
                "torch_tuner_mnist_example")
    best = mod.main(["--device", "cpu"])
    assert 1e-4 <= best.get("learning_rate") <= 1e-1
    assert best.get("hidden_dim") in (64, 128)
    trials = LocalStudyService("mnist_hp_study", str(tmp_path)).list_trials()
    assert len(trials) == 2
    assert all(t["status"] == "COMPLETED" for t in trials)


def test_tuner_search_launcher_dry_run():
    mod = _load(HELPERS / "torch_call_run_with_tuner_search.py",
                "torch_call_run_with_tuner_search")
    report = mod.main(dry_run=True)
    assert report.dockerfile and report.dockerfile.startswith("FROM ")
    assert report.node_requests and not report.submitted
    assert "torch_tuner_mnist_example.py" in report.dockerfile
    for node in report.node_requests.values():
        assert "guestAccelerators" not in str(node)
        assert node["labels"]["workload"] == "hp-search"
