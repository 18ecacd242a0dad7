"""``chip_smoke.py``'s phases 9t, 9f, 9g, 6enc and 10g rehearsed on the CPU:
their whole Python path, the launch checks aside (on the CPU no kernel
launches).

* 9t: ``tuner.dispatch_search`` of two workers of
  ``tests/helpers/torch_tuner_resnet_example.py`` (a dry run), each job's
  build context and startup script booted by
  ``utils.local_rig.launch_emulated_slice`` on gloo CPU ranks, at a narrow
  ResNet in f32 with 8 rows a batch: one study of 4 trials, all
  COMPLETED with 2 measurements and finite losses.
* 9f: ``cloud_tpu_torch.cloud_fit`` (a dry run) for two one-chip hosts,
  its ENTRYPOINT as generated (``run()``'s plan ``{dp: 2}``) on two
  emulated hosts, a checkpoint written by rank 0 alone; two ranks under
  the bootstrap's own ``{fsdp: 2}`` restore it into their shards and save
  a sharded checkpoint holding both ranks' files; a one-process
  ``remote.run`` restores that.  Each restore equals the parameters saved
  bit for bit.
* 9g: records written to ``gs://`` on the directory-backed fake client, a
  fit from ``RecordDataset(gs://...)`` checkpointing to ``gs://`` every 2
  steps, a fresh process restoring the latest step bit for bit, two
  ``{fsdp: 2}`` ranks saving to the same bucket and this process
  restoring that, at ResNet TINY with 8 rows a batch.
* 6enc: every arm on two gloo ranks against one process, at BERT TINY,
  ViT TINY, MNIST with 16 hidden units and ResNet-8 in place of the
  full-width models.
* 10g: the golden copies (generate_text in this process, the ring
  example on 4 ranks, save_and_load and the custom loop on 2).
* 6win: every arm on two gloo ranks, at CloudLM TINY (2 layers, T=32),
  ResNet-8 with 4 rows a rank and 2 in the f32 arm: each window equals
  the eager steps under the mesh, the fits' compile-ahead serves both
  steps with no error and checkpoints the window boundaries.
"""

import dataclasses

import torch

import chip_smoke
from helpers import torch_tuner_resnet_example as worker
from helpers.torch_sigterm import sigterm_restored  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_tuner_phase_on_the_cpu():
    out = chip_smoke.run_tuner_phase(CPU, "cpu", batch=8, rig="cpu",
                                     worker_args=("--config", "tiny"))
    assert len(out["trials"]) == 4
    assert sum(out["trials_per_worker"].values()) == 4
    assert out["steps"] == 4 * 2 * 3


def test_cloud_fit_phase_on_the_cpu():
    out = chip_smoke.run_cloud_fit_phase(CPU, "cpu", config=worker.TINY,
                                         batch=8, rig="cpu")
    assert out["plan"] == {"dp": 2}
    assert [r["mesh"] for r in out["dp_ranks"]] == [{"dp": 2}] * 2
    assert [r["mesh"] for r in out["fsdp_ranks"]] == [{"fsdp": 2}] * 2
    assert out["dp_files_by_rank"][1] == 0
    assert all(out["fsdp_files_by_rank"].values())


def test_gcs_phase_on_the_cpu():
    out = chip_smoke.run_gcs_phase(CPU, "cpu", config=worker.TINY, batch=8,
                                   rig="cpu")
    assert all(out["fsdp_pieces_by_rank"].values())
    assert out["checkpoint_bytes"] > 0


def test_encoder_mesh_phase_on_the_cpu():
    from cloud_tpu_torch.models import bert, mnist, resnet, vit

    out = chip_smoke.run_encoder_mesh(CPU, "cpu", configs={
        "bert": bert.TINY, "vit": vit.VIT_TINY_CIFAR.scaled(num_layers=2),
        "mnist": mnist.MnistConfig(hidden_dim=16),
        "resnet": dataclasses.replace(resnet.RESNET8_CIFAR)})
    assert list(out["arms"]) == [arm[0] for arm in chip_smoke.ENC_ARMS]
    for name, arm in out["arms"].items():
        if "grad_err_rel" in arm["rank0"]:
            assert arm["rank0"]["grad_err_rel"] <= chip_smoke.ENC_GRAD_TOL


def test_golden_phase_on_the_cpu():
    out = chip_smoke.run_golden_phase(CPU, "cpu", rig="cpu")
    assert out["generate_text"]["steps"] > 0
    assert len(out["ring"]) == chip_smoke.GOLDEN_RANKS["ring"]
    assert all(r["losses"][-1] < r["losses"][0] for r in out["ring"])


def test_window_phase_on_the_cpu():
    from cloud_tpu_torch.models import resnet, transformer

    out = chip_smoke.run_window_training(CPU, "cpu", configs={
        "lm": transformer.TINY.scaled(num_layers=2), "seq": 32,
        "resnet": resnet.RESNET8_CIFAR, "batch": 4, "f32_batch": 2})
    assert list(out["arms"]) == [arm[0] for arm in chip_smoke.WIN_ARMS]
    for name, arm in out["arms"].items():
        for rank in ("rank0", "rank1"):
            got = arm[rank]
            if "windows" in got:
                assert got["windows"]["steps"] == chip_smoke.WIN_FIT_BATCHES
            if name == "resnet fit":
                assert got["windows"]["checkpoints"] == [4, 8, 10]
                assert got["windows"]["served"] == ["eval_step",
                                                    "multi_step"]
            elif "captures" in got:
                assert got["captures"] == 0
                assert got["param_err"] <= chip_smoke.WIN_TOL
                assert got["ahead_error"] == "None" and got["ahead_served"]
                assert got["ahead_param_err"] <= chip_smoke.WIN_TOL
                assert got["ahead_eval_err"] <= chip_smoke.WIN_TOL
