"""End-to-end durable-resume drill: kill -9, corrupt, walk back (the
port's counterpart of the JAX package's ``scripts/check_durability.py``).

    python -m cloud_tpu_torch.training.check_durability --device cpu
    python -m cloud_tpu_torch.training.check_durability --device cuda \\
        --model resnet50_cifar

It drives the whole composition in fresh processes:

1. **control** — an uninterrupted stochastic run (shuffled data and
   input-noise dropout drawn from the step's rng chain, so the chain
   shapes the gradients and a resume matches only if it restores
   bit-exactly) records its per-step losses and a digest of its final
   params.
2. **crash** — the same run with ``CheckpointCallback(resume_data=True)``
   is ``kill -9``'d mid-fit: no drain save, no manifest finalize for the
   newest step.
3. **corrupt** — the parent garbles the newest (unmanifested) step dir
   entirely and flips ONE byte in the newest *manifested* step, so the
   restart must survive both failure shapes: a partial write that fails
   restore, and bit rot only the manifest checksum can catch.
4. **resume** — a fresh process re-runs the same script.  The walk-back
   restore must quarantine both damaged steps, land on the older intact
   checkpoint, fast-forward the data stream to its recorded position,
   restore the rng chain with the state, and finish with per-step losses
   and final params IDENTICAL to the control run.

Models: ``mnist`` (hidden 16, batch 4; seconds on the CPU) and
``resnet50_cifar`` (ResNet-50 CIFAR in f32 at batch 8 through the
GroupNorm kernels on the card, with cuDNN's deterministic algorithms and
TF32 off, so that two runs compute the same sums).  Children run on
``--device`` (``cuda`` by default) and load the kernel libraries already
built under ``cloud_tpu_torch/build/``.

Prints one JSON line per phase plus a summary::

    {"phase": "summary", "ok": true, "digest_match": true,
     "resumed_step": 20, ...}

and exits 0 only when every phase passed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

#: Save cadence / crash point: saves land at 4, 8, ..., 32; the kill at
#: step 34 leaves step 32's manifest uncommitted (it would have been
#: finalized at the step-36 save that never happens); max_to_keep=4 keeps
#: the newest four steps.
EVERY_N_STEPS = 4
MAX_TO_KEEP = 4
KILL_AT_STEP = 34
EPOCHS = 3
BATCHES_PER_EPOCH = 12
TOTAL_STEPS = EPOCHS * BATCHES_PER_EPOCH

#: Root of the checkout: the children import the package from there.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: model -> (batch size, per-example input shape, classes).
MODELS = {"mnist": (4, (784,), 10), "resnet50_cifar": (8, (32, 32, 3), 10)}


def _noisy(loss_fn):
    """``loss_fn`` behind input-noise dropout drawn from the step key:
    ``image * bernoulli(rng, 0.9) / 0.9``, as the JAX package's drill."""

    def noisy_loss(params, batch, *, rng=None):
        from cloud_tpu_torch import random as random_lib

        images = batch["image"]
        if rng is not None:
            keep = random_lib.bernoulli(rng, 0.9, images.shape)
            images = images * keep.to(images.dtype) / 0.9
        return loss_fn(params, {"image": images, "label": batch["label"]})

    return noisy_loss


def _build(model: str, device: str, ckpt_dir=None):
    """The shared workload: ``model`` in f32 over a shuffled in-memory
    dataset from a numpy seed, ``sgd(0.1)``, stochastic (``_noisy``)."""
    import functools

    import numpy as np
    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.training import data as data_lib
    from cloud_tpu_torch.training import optimizers
    from cloud_tpu_torch.training.checkpoint import CheckpointCallback
    from cloud_tpu_torch.training.trainer import Trainer

    torch.set_num_threads(1)
    if model == "mnist":
        from cloud_tpu_torch.models import mnist

        cfg = mnist.MnistConfig(hidden_dim=16)
        loss = functools.partial(mnist.loss_fn, config=cfg, device=device)

        def init(gen):
            return bridge.init_mnist(cfg, gen, device=device)
    else:
        import dataclasses

        from cloud_tpu_torch.models import resnet

        cfg = dataclasses.replace(resnet.RESNET50_CIFAR, dtype=torch.float32)
        loss = functools.partial(resnet.loss_fn, config=cfg, device=device)
        # Two f32 runs must compute the same sums (cuDNN's default f32
        # convolution algorithms vary from run to run).
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

        def init(gen):
            return bridge.init_resnet(cfg, gen, device=device)

    trainer = Trainer(_noisy(loss), optimizers.sgd(0.1), init_fn=init,
                      stochastic=True, device=device)
    trainer.init_state(torch.Generator(device=device).manual_seed(0))
    batch, shape, classes = MODELS[model]
    rng = np.random.default_rng(0)
    n = BATCHES_PER_EPOCH * batch
    dataset = data_lib.ArrayDataset(
        {"image": rng.normal(size=(n,) + shape).astype(np.float32),
         "label": rng.integers(0, classes, n).astype(np.int64)},
        batch_size=batch, shuffle=True, seed=7,
    )
    callback = None
    if ckpt_dir is not None:
        callback = CheckpointCallback(
            ckpt_dir, every_n_steps=EVERY_N_STEPS, max_to_keep=MAX_TO_KEEP,
            resume_data=True, device=device,
        )
    return trainer, dataset, callback


def _params_digest(state) -> str:
    from cloud_tpu_torch.bridge import leaves

    digest = hashlib.sha256()
    for leaf in leaves(state.params):
        digest.update(leaf.detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def _run_child(args) -> None:
    """Child body for --mode control|crash|resume (one fresh process
    each: resume must cross a real process boundary)."""
    from cloud_tpu_torch.monitoring import metrics as metrics_lib
    from cloud_tpu_torch.training import trainer as trainer_lib

    mode = args.mode
    report = {"mode": mode, "losses": {}, "start_step": None}
    trainer, dataset, callback = _build(
        args.model, args.device, None if mode == "control" else args.ckpt_dir
    )

    class Recorder(trainer_lib.Callback):
        def on_train_begin(self, tr):
            # Runs AFTER CheckpointCallback.on_train_begin (callback
            # order), so this is the step training actually starts from.
            report["start_step"] = int(tr.state.step)

        def on_step_end(self, step, logs, tr):
            report["losses"][str(step)] = float(logs["loss"])
            if mode == "crash" and step == KILL_AT_STEP:
                # A hard preemption mid-write window: no drain, no
                # train-end save, no manifest finalize.
                os.kill(os.getpid(), signal.SIGKILL)

    callbacks = [callback] if callback is not None else []
    callbacks.append(Recorder())
    trainer.fit(dataset, epochs=EPOCHS, callbacks=callbacks)

    counters = metrics_lib.snapshot()["counters"]
    report.update({
        "final_step": int(trainer.state.step),
        "params_digest": _params_digest(trainer.state),
        "data_state": dict(trainer.data_state),
        "fallbacks": counters.get("checkpoint/fallbacks", 0),
        "quarantined": counters.get("checkpoint/quarantined", 0),
    })
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(report, f)


def _spawn(args, mode: str, out_path: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    if args.device != "cpu":
        # cuBLAS's documented setting for bit-reproducible results.
        env.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    return subprocess.run(
        [sys.executable, "-m", "cloud_tpu_torch.training.check_durability",
         "--mode", mode, "--ckpt-dir", args.ckpt_dir, "--out", out_path,
         "--device", args.device, "--model", args.model],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env,
    )


def _corrupt_newest(ckpt_dir: str) -> dict:
    """Garble the newest (uncommitted) step entirely; flip one byte in
    the newest manifested step's first entry."""
    from cloud_tpu_torch.training.checkpoint import MANIFEST_NAME

    steps = sorted(
        int(name) for name in os.listdir(ckpt_dir) if name.isdigit()
    )
    manifested = [
        s for s in steps
        if os.path.exists(os.path.join(ckpt_dir, str(s), MANIFEST_NAME))
    ]
    newest = steps[-1]
    newest_manifested = [s for s in manifested if s != newest][-1]

    garbled_files = 0
    for root, _dirs, files in os.walk(os.path.join(ckpt_dir, str(newest))):
        for name in files:
            with open(os.path.join(root, name), "wb") as f:
                f.write(b"\x00garbage\xff" * 8)
            garbled_files += 1

    with open(os.path.join(ckpt_dir, str(newest_manifested),
                           MANIFEST_NAME), encoding="utf-8") as f:
        manifest = json.load(f)
    entry = sorted(manifest["entries"])[0]
    target = os.path.join(ckpt_dir, str(newest_manifested), entry)
    with open(target, "r+b") as f:
        f.seek(os.path.getsize(target) // 2)
        original = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([original[0] ^ 0xFF]))

    # The restart must land on the newest UNDAMAGED committed step.
    # (Whether the final save got to commit before the SIGKILL is a race;
    # both outcomes are valid lineages and both are handled.)
    intact = [s for s in manifested if s not in (newest, newest_manifested)]
    return {
        "phase": "corrupt",
        "ok": garbled_files > 0 and bool(intact),
        "steps_on_disk": steps,
        "manifested": manifested,
        "garbled_step": newest,
        "bitflipped_step": newest_manifested,
        "expect_resume_at": intact[-1] if intact else None,
    }


def _load(path: str, proc) -> dict:
    if proc.returncode != 0 or not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def run_drill(args) -> int:
    shutil.rmtree(args.tmp_dir, ignore_errors=True)
    os.makedirs(args.tmp_dir, exist_ok=True)
    args.ckpt_dir = os.path.join(args.tmp_dir, "ckpt")
    start = time.perf_counter()
    phases = []

    # Phase 1: control.
    control_out = os.path.join(args.tmp_dir, "control.json")
    proc = _spawn(args, "control", control_out)
    control = _load(control_out, proc)
    phases.append({
        "phase": "control",
        "ok": (proc.returncode == 0
               and control.get("final_step") == TOTAL_STEPS),
        "final_step": control.get("final_step"),
        "stderr_tail": proc.stderr[-500:] if proc.returncode != 0 else "",
    })
    print(json.dumps(phases[-1]), flush=True)

    # Phase 2: hard crash (kill -9, not a drain).
    proc = _spawn(args, "crash", os.path.join(args.tmp_dir, "crash.json"))
    phases.append({
        "phase": "crash",
        "ok": proc.returncode == -signal.SIGKILL,
        "returncode": proc.returncode,
        "stderr_tail": (proc.stderr[-500:]
                        if proc.returncode != -signal.SIGKILL else ""),
    })
    print(json.dumps(phases[-1]), flush=True)

    # Phase 3: damage the lineage both ways.
    corrupt = _corrupt_newest(args.ckpt_dir)
    phases.append(corrupt)
    print(json.dumps(corrupt), flush=True)

    # Phase 4: restart — walk back, resume exactly-once, match control.
    resume_out = os.path.join(args.tmp_dir, "resume.json")
    proc = _spawn(args, "resume", resume_out)
    resume = _load(resume_out, proc)
    expect_at = corrupt["expect_resume_at"]
    resumed_losses = resume.get("losses", {})
    control_losses = control.get("losses", {})
    # Exactly-once: every step the resumed run executed must reproduce
    # the control run's loss bit for bit (same batch, same params),
    # starting at exactly expect_at + 1.
    errors = [abs(control_losses[s] - v) for s, v in resumed_losses.items()
              if s in control_losses]
    replay_ok = (
        bool(resumed_losses) and expect_at is not None
        and min(int(s) for s in resumed_losses) == expect_at + 1
        and all(control_losses.get(s) == v
                for s, v in resumed_losses.items())
    )
    quarantine_dir = os.path.join(args.ckpt_dir, "quarantine")
    quarantined = (sorted(os.listdir(quarantine_dir))
                   if os.path.isdir(quarantine_dir) else [])
    digest_match = (bool(control.get("params_digest"))
                    and resume.get("params_digest")
                    == control.get("params_digest"))
    phases.append({
        "phase": "resume",
        "ok": (
            proc.returncode == 0
            and resume.get("start_step") == expect_at
            and resume.get("final_step") == TOTAL_STEPS
            and digest_match
            and replay_ok
            and resume.get("fallbacks", 0) >= 2
            and len(quarantined) >= 2
        ),
        "resumed_step": resume.get("start_step"),
        "expected_step": expect_at,
        "final_step": resume.get("final_step"),
        "digest_match": digest_match,
        "replay_exact": replay_ok,
        "max_loss_err": max(errors) if errors else None,
        "fallbacks": resume.get("fallbacks"),
        "quarantined": quarantined,
        "stderr_tail": proc.stderr[-500:] if proc.returncode != 0 else "",
    })
    print(json.dumps(phases[-1]), flush=True)

    ok = all(p["ok"] for p in phases)
    print(json.dumps({
        "phase": "summary",
        "ok": ok,
        "resumed_step": resume.get("start_step"),
        "digest_match": digest_match,
        "max_loss_err": phases[-1]["max_loss_err"],
        "model": args.model,
        "device": args.device,
        "wall_seconds": round(time.perf_counter() - start, 3),
    }), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--model", choices=sorted(MODELS), default="mnist")
    parser.add_argument("--tmp-dir", default=None,
                        help="work directory, emptied first and kept after "
                             "the run (by default a fresh temporary one, "
                             "removed after the run)")
    parser.add_argument("--mode", choices=("control", "crash", "resume"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--ckpt-dir", help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.mode:
        _run_child(args)
        return 0
    from cloud_tpu_torch._device import resolve_device

    resolve_device(args.device)  # a card asked for and missing raises here
    if args.tmp_dir is not None:
        return run_drill(args)
    args.tmp_dir = tempfile.mkdtemp(prefix="cloud_tpu_torch_durability_")
    try:
        return run_drill(args)
    finally:
        shutil.rmtree(args.tmp_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
