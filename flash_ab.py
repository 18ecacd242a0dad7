"""Paired A/B of the attention kernels (flash and paged) between two trees
of this repo, on one CUDA card.

    python3 flash_ab.py --parent DIR [--out FILE]

``DIR`` holds another checkout of the repo, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory.  The script
runs four child processes in the order parent, this tree, this tree,
parent.  Each imports ``cloud_tpu_torch`` from its own tree (so it builds
and launches that tree's ``flash_fwd.cu``, ``flash_bwd.cu`` and
``paged_attention.cu``) and the timing helpers from this tree's
``chip_smoke.py``, then measures, at the shapes ``chip_smoke.py`` uses:

- K5 at the serving insert shape (B=1, T=128, masked), and K5, K6, K7 at
  the LM (B=4, T=1024, causal) and BERT (B=32, T=128) training shapes,
  each in CUDA-event time (``ms``: events around back-to-back calls) and
  in device time (``device_ms``: torch.profiler's kernel rows), beside
  the plain version and SDPA;
- K8 and K8q at the engine's decode step (B=8, Tq=1, slot rows of S=576)
  and at S=4096, in event and device time, beside SDPA on the same K/V in
  bf16 (dequantized beforehand for K8q);
- one CloudLM SMALL b4 x T1024 training step and one BERT-base b32 x T128
  step: steps/s over 3 + 5 chained steps, then one profiled step split
  into K5, K6, K7, matrix products and the rest.

It prints each child's output, then a table of every time, parent against
this tree (the mean of each side's two runs), with the card's name and
power limit, and with ``--out FILE`` writes all runs there as JSON.  It
exits nonzero if any child fails.

    python3 flash_ab.py --parent DIR --host-checks

needs no card: in the same four-run order it times, on the host's CPU,
the argument checks a flash wrapper call makes before its launch
(``_check_qkv`` and ``_mask_i32`` on CPU tensors of the serving insert
shape, microseconds a call over 20000 calls), and prints them.
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
MARK = "FLASH_AB "


def _chip_smoke():
    """This tree's ``chip_smoke.py``, loaded by path (the other tree has
    its own, which must not shadow it)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    spec.loader.exec_module(module)
    return module


def child(tree: str, card: str) -> dict:
    """Every measurement on ``tree``'s kernels; returns them as a dict."""
    sys.path.insert(0, tree)
    import torch

    cs = _chip_smoke()
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.ops import flash_attention as fa

    if not os.path.abspath(fa.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {fa.__file__}, not from {tree}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    start = time.perf_counter()
    libraries = ["flash_fwd", "flash_bwd", "paged_attention"]
    dispatch.build_all(libraries)
    print(f"  built {', '.join(libraries)} of {tree} in "
          f"{time.perf_counter() - start:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gen = torch.Generator(device=device).manual_seed(5)
    t = 128
    q, k, v = (torch.randn((1, t, cs.HEADS, cs.HEAD_DIM), generator=gen,
                           device=device).to(torch.bfloat16)
               for _ in range(3))
    mask = (torch.arange(t, device=device) < (2 * t) // 3).to(
        torch.int32)[None]
    with torch.no_grad():
        kernels = {"serving": {"flash_fwd": cs.time_flash_serving(
            fa, q, k, v, mask, card)}}
    for path in cs.TRAIN_SHAPES:
        kernels[path] = cs._time_attention(fa, path, card, gen)
    with torch.no_grad():
        kernels.update(_time_paged(cs, device, card, gen))

    lm, lm_run = cs.run_lm_training(device, card, fused_ce=False, warmup=3,
                                    iters=5)
    lm.update(cs.profile_attn_step(card, f"LM b{cs.LM_BATCH}xT{cs.LM_SEQ}",
                                   cs.LM_PER_STEP, *lm_run))
    del lm_run
    torch.cuda.empty_cache()
    bert, bert_run = cs.run_bert_training(device, card, warmup=3, iters=5)
    bert.update(cs.profile_attn_step(
        card, f"BERT b{cs.BERT_BATCH}xT{cs.BERT_SEQ}", cs.BERT_PER_STEP,
        *bert_run))
    return {"tree": tree, "kernels": kernels, "steps": {"LM": lm,
                                                        "BERT": bert}}


def _time_paged(cs, device, card, gen) -> dict:
    """K8 and K8q at every ``chip_smoke.PAGED_LENGTHS`` slot length, on one
    set of decode rows a length (``chip_smoke._time_paged_int8``: K8q on
    int8 K/V, K8 on the bf16 K/V they were quantized from); the library
    yardstick of both is SDPA on the dequantized bf16 K/V."""
    from cloud_tpu_torch.ops import paged_attention as pa

    out = {}
    for s in cs.PAGED_LENGTHS:
        t = cs._time_paged_int8(pa, device, card, gen, s)
        library = {"library_ms": t["library_ms"],
                   "library_device_ms": t["library_device_ms"]}
        out[f"S={s}"] = {
            "paged_attention": {"ms": t["bf16_k8_ms"],
                                "device_ms": t["bf16_k8_device_ms"],
                                **library},
            "paged_attention_int8": {"ms": t["ms"],
                                     "device_ms": t["device_ms"], **library}}
    return out


def host_checks(tree: str) -> dict:
    """Microseconds a call of ``tree``'s flash-wrapper argument checks."""
    sys.path.insert(0, tree)
    import timeit

    import torch

    from cloud_tpu_torch.ops import flash_attention as fa

    if not os.path.abspath(fa.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {fa.__file__}, not from {tree}")
    q, k, v = (torch.randn(1, 128, 12, 64).to(torch.bfloat16)
               for _ in range(3))
    mask = (torch.arange(128) < 85).to(torch.int32)[None]
    n = 20000
    return {
        "check_qkv_us": timeit.timeit(lambda: fa._check_qkv(q, k, v),
                                      number=n) / n * 1e6,
        "mask_i32_us": timeit.timeit(
            lambda: fa._mask_i32(mask, 1, 128, q.device), number=n) / n * 1e6}


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
    print(f"flash A/B, mean of {len(parent_runs)} runs a side [{card}]")
    print(f"  {'kernel':20s} {'shape':8s} {'measure':18s} "
          f"{'parent ms':>11s} {'this ms':>11s} {'ratio':>8s}")
    for shape, by_kernel in change_runs[0]["kernels"].items():
        for name in by_kernel:
            for measure in ("ms", "device_ms", "library_ms",
                            "library_device_ms"):
                keys = ("kernels", shape, name, measure)
                before = _mean(parent_runs, *keys)
                after = _mean(change_runs, *keys)
                print(f"  {name:20s} {shape:8s} {measure:18s} "
                      f"{before:11.5f} {after:11.5f} "
                      f"{before / after if after else float('nan'):8.2f}")
    for path in ("LM", "BERT"):
        for key in ("steps_per_s", "step_wall_ms", "step_enqueue_ms",
                    "step_device_busy_ms", "step_idle_share"):
            before = _mean(parent_runs, "steps", path, key)
            after = _mean(change_runs, "steps", path, key)
            print(f"  {path} step {key:20s} {before:11.4f} {after:11.4f}")
        for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "matmul",
                    "rest"):
            before = _mean(parent_runs, "steps", path, "device_ms", key)
            after = _mean(change_runs, "steps", path, "device_ms", key)
            print(f"  {path} step device {key:13s} {before:11.4f} "
                  f"{after:11.4f}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True,
                        help="another checkout of the repo to compare with")
    parser.add_argument("--out", help="write every run as JSON here")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    parser.add_argument("--card", default="", help=argparse.SUPPRESS)
    parser.add_argument("--host-checks", action="store_true",
                        help="time the wrappers' argument checks on the "
                             "CPU instead (no card needed)")
    args = parser.parse_args()
    if args.child:
        tree = os.path.abspath(args.child)
        print(MARK + json.dumps(host_checks(tree) if args.host_checks
                                else child(tree, args.card)))
        return 0
    if args.host_checks:
        trees = {"parent": os.path.abspath(args.parent), "this": HERE}
        for side in ("parent", "this", "this", "parent"):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--parent",
                 trees["parent"], "--child", trees[side], "--host-checks"],
                cwd=trees[side], capture_output=True, text=True, timeout=300,
                check=True)
            got = json.loads(proc.stdout.strip().splitlines()[-1][len(MARK):])
            print(f"{side:6s} " + ", ".join(f"{k} {v:.2f}"
                                            for k, v in got.items()))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
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
            print(f"flash_ab: the {side} run failed", file=sys.stderr)
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
