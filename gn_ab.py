"""Paired A/B of the GroupNorm kernels (K1-K4) between two trees of this
repo, on one CUDA card.

    python3 gn_ab.py --parent DIR [--out FILE]

``DIR`` holds another checkout of the repo, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory.  The script
runs four child processes in the order parent, this tree, this tree,
parent.  Each imports ``cloud_tpu_torch`` from its own tree (so it builds
and launches that tree's ``group_norm.cu``) and the timing helpers from
this tree's ``chip_smoke.py``, then measures in bf16:

- K1-K4 over the GroupNorm calls of one ResNet-50 CIFAR b256 step (37 or
  16 calls back to back), at the two largest 224 b128 shapes (K1/K3 at
  (128, 112, 112, 64), K2/K4 at (128, 56, 56, 256)) and over every call
  of one 224 b128 step (each shape timed once, times its calls a step),
  in device time (``device_ms``: torch.profiler's kernel rows) and in
  CUDA-event time (``ms``: events around back-to-back calls);
- one ResNet-50 224 b128 training step: steps/s over 3 + 10 chained
  steps, then one profiled step (device ms, GroupNorm ms, idle share);
- one ResNet-50 CIFAR b256 step: steps/s over 3 + 20 chained steps and
  the host's enqueue time of one step.

It prints each child's output, then a table of every number, parent
against this tree (the mean of each side's two runs; steps/s with each
side's two values), with the card's name and power limit, and with
``--out FILE`` writes all runs there as JSON.  It exits nonzero if any
child fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MARK = "GN_AB "
#: The two 224 b128 shapes of the headline rows, by kernel.
BIG = {"gn_fwd": (128, 112, 112, 64), "gn_bwd": (128, 112, 112, 64),
       "gn_fwd_res": (128, 56, 56, 256), "gn_bwd_res": (128, 56, 56, 256)}


def _chip_smoke():
    """This tree's ``chip_smoke.py``, loaded by path (the other tree has
    its own, which must not shadow it)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    spec.loader.exec_module(module)
    return module


def _times(cs, gn, name, calls, gen) -> dict:
    """Device and event ms of ``calls`` of kernel ``name`` back to back."""
    t, _, _ = cs._time_gn(gn, name, calls, gen, plain=False)
    return {"device_ms": t["kernel"][0], "ms": t["kernel"][1],
            "library_device_ms": t["library"][0]}


def child(tree: str, card: str) -> dict:
    """Every measurement on ``tree``'s kernels; returns them as a dict."""
    sys.path.insert(0, tree)
    import torch

    cs = _chip_smoke()
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.ops import group_norm as gn

    if not os.path.abspath(gn.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {gn.__file__}, not from {tree}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    start = time.perf_counter()
    dispatch.build_all(["group_norm"])
    print(f"  built group_norm of {tree} in "
          f"{time.perf_counter() - start:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gen = torch.Generator(device=device).manual_seed(7)
    cifar = cs.gn_calls(cs.CIFAR_BATCH, 32)
    at_224 = cs.gn_calls(cs.IMAGENET_BATCH, 224)
    kernels = {}
    for name in cs.GN_KERNELS:
        row = {"cifar": _times(cs, gn, name, cs._gn_kernel_calls(name, cifar),
                               gen),
               "224_one": _times(cs, gn, name, [(BIG[name], True)], gen)}
        step = {"device_ms": 0.0, "ms": 0.0, "library_device_ms": 0.0}
        for call, n in cs._gn_step_shapes(name, at_224).items():
            for k, v in _times(cs, gn, name, [call], gen).items():
                step[k] += n * v
        row["224_step"] = step
        kernels[name] = row
        print(f"  {name}: " + ", ".join(
            f"{where} {v['device_ms']:.4f} ms" for where, v in row.items()),
              flush=True)

    # The parent's kernels launch three GroupNorm kernels a direction.
    records = 3 if hasattr(gn, "_plan") else 6
    records *= sum(cs.GN_PER_STEP[k] for k in ("gn_fwd", "gn_fwd_res"))
    steps = {}
    for what, imagenet, iters in (("224", True, 10), ("cifar", False, 20)):
        result, run = cs.run_training(device, card, imagenet=imagenet,
                                      warmup=3, iters=iters)
        result.update(cs.profile_train_step(card, *run, gn_records=records))
        del run
        torch.cuda.empty_cache()
        steps[what] = {k: v for k, v in result.items()
                       if isinstance(v, (int, float))}
    return {"tree": tree, "kernels": kernels, "steps": steps}


def _mean(runs, *keys):
    values = []
    for run in runs:
        x = run
        for key in keys:
            x = x[key]
        values.append(x)
    return sum(values) / len(values)


def report(parent_runs, change_runs, card) -> None:
    """Parent against this tree, each the mean of its runs."""
    print(f"GroupNorm A/B, mean of {len(parent_runs)} runs a side [{card}]")
    print(f"  {'kernel':11s} {'where':9s} {'measure':18s} "
          f"{'parent ms':>11s} {'this ms':>11s} {'ratio':>8s}")
    for name, by_where in change_runs[0]["kernels"].items():
        for where, measures in by_where.items():
            for measure in measures:
                keys = ("kernels", name, where, measure)
                before = _mean(parent_runs, *keys)
                after = _mean(change_runs, *keys)
                print(f"  {name:11s} {where:9s} {measure:18s} "
                      f"{before:11.5f} {after:11.5f} "
                      f"{before / after if after else float('nan'):8.2f}")
    for what in ("224", "cifar"):
        for key in ("steps_per_s", "step_wall_ms", "step_enqueue_ms",
                    "step_device_busy_ms", "gn_ms", "step_idle_share"):
            sides = [[run["steps"][what][key] for run in runs]
                     for runs in (parent_runs, change_runs)]
            print(f"  {what:5s} step {key:20s} parent "
                  + ", ".join(f"{v:.4f}" for v in sides[0]) + "; this "
                  + ", ".join(f"{v:.4f}" for v in sides[1]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True,
                        help="another checkout of the repo to compare with")
    parser.add_argument("--out", help="write every run as JSON here")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    parser.add_argument("--card", default="", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(MARK + json.dumps(child(os.path.abspath(args.child),
                                      args.card)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("gn_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    trees = {"parent": os.path.abspath(args.parent), "this": HERE}
    runs = {"parent": [], "this": []}
    for side in ("parent", "this", "this", "parent"):
        print(f"run {sum(map(len, runs.values())) + 1}: {side} "
              f"({trees[side]})", flush=True)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent",
             trees["parent"], "--child", trees[side], "--card", card],
            cwd=trees[side], capture_output=True, text=True, timeout=900)
        lines = proc.stdout.splitlines()
        print("\n".join(line for line in lines
                        if not line.startswith(MARK)), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            print(f"gn_ab: the {side} run failed", file=sys.stderr)
            return 1
        runs[side].append(json.loads(next(
            line for line in lines if line.startswith(MARK))[len(MARK):]))
    report(runs["parent"], runs["this"], card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, **runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
