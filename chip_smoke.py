#!/usr/bin/env python3
"""Drive the PyTorch port's serving (full precision and int8), ResNet and transformer training paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one CUDA card, ``nvcc``
and ``nvidia-smi``.  It imports only ``cloud_tpu_torch`` (never JAX) and:

1. prints the card's name and power limit, then builds every CUDA kernel
   library from ``cloud_tpu_torch/ops/csrc`` (one ``nvcc`` per source, in
   parallel) and prints the build time, and counts the tensor-core
   instructions (HMMA, HGMMA) of each flash kernel in ``cuobjdump -sass``:
   every instantiation of the bf16 K5, K6 and K7 must have some;
2. holds each kernel against its plain PyTorch version on the card at its
   path's shapes (tolerances at ``check_close``: f32 within 1e-4 absolute;
   bf16 within 2e-2 + 2^-7 |ref|, one bf16 ulp relative plus the absolute
   term; float32 statistics and per-sample sums within 1e-4 of
   max(1, max |ref|); gradients of the flash backward, sums over up to
   1024 keys, with both limits scaled by s = max(1, max |ref|): f32
   within 1e-4 s, bf16 within 2e-2 s + 2^-7 |ref|; K5's f32 lse also
   within 1e-4 max(1, |lse|) of an lse from f32 scores), and times the
   kernel, the plain version and one PyTorch library call computing the
   same function (a yardstick only: the port never calls it): K5 at the
   serving shape (CUDA events around back-to-back launches, and device
   time, torch.profiler's kernel rows), K8 and K8q (bf16 or int8 K/V,
   with and without a pool, Tq 1 and 4, q in bf16 and f32, slot rows of
   S=576 and 4096 with lengths from 1 to S) timed at B=8 with S=576 and
   S=4096 (K8q beside K8 on bf16 K/V at the same lengths and SDPA on K/V
   dequantized beforehand), in event and device time, K1-K4 (GroupNorm)
   at every shape of a ResNet-50 CIFAR b256 step and of a 224 b128 step,
   plus 30 channels in 6 groups and a misaligned pointer (the scalar
   route), with bit-identical repeat launches and at most two kernels a
   call per direction (timed over a CIFAR step's calls, at two 224
   shapes beside the plain version and at every 224 shape; device time
   from torch.profiler's kernel rows: a GroupNorm call is shorter than its
   host launch cost), K5 and K6/K7 (flash
   backward, on K5's out and lse) in 20 cases per type at both training
   shapes plus ragged T (200, 1000), and in bf16 at every head dim the
   kernels take; bf16 K6 and K7 also against their f32 kernels where
   causal rows have no valid key (the plain version's answer differs
   there by design), then K5, K6 and K7 timed at the LM (B=4, T=1024,
   causal) and BERT (B=32, T=128) shapes against
   ``scaled_dot_product_attention``'s forward and backward, in event and
   device time;
3. serves 16 staggered requests of mixed lengths through
   ``ServingEngine`` with CloudLM SMALL in bf16 (random weights from a
   seed), checks that every request resolves with valid tokens and that
   the path launched K5 and K8, and checks greedy parity with the port's
   own ``generate()`` at SMALL width in f32; then splits one decode
   chunk's device time by kernel (torch.profiler; the rows of K8's split
   pass and of its combine hold one launch a layer a step); then the
   quantized
   path: the same 16 requests with ``quantize_params`` weights and
   ``kv_quant=True`` (exactly 12 K5 launches per insert, 12 K8q per
   decode step, no K8), f32 greedy parity of that engine with
   ``generate(kv_quant=True)`` on four prompts whose quantized greedy path
   keeps a top-2 logit gap of 1e-2, the decode A/B of
   ``scripts/bench_daemon.py`` (bf16, int8, int8 + kv_quant weights at b4,
   prompt 128, 128 new tokens) and ``beam_search`` (int8 + kv_quant, b4,
   4 beams, 32 new tokens, 12 K8q launches per step);
4. trains ResNet-50 (CIFAR, batch 256, bf16) for 3 + 20 chained steps
   with SGD momentum, checks finite loss and grad norm and exactly 37 K1,
   16 K2, 37 K3 and 16 K4 launches per step; holds one f32 step on the
   card (batch 8, through the kernels) against the same step on the CPU;
   splits one step's device time (GroupNorm, convolution, idle);
5. trains ResNet-50 at 224x224 (batch 128, bf16) for 3 + 5 steps, with
   the same launch checks and breakdown;
6. trains CloudLM ``SMALL.scaled(tied_embeddings=True)`` at b4 x T1024
   (bf16 on f32 master weights, remat "full", ``adamw(1e-4)``) for 3 + 10
   steps with the plain CE and 3 + 5 with ``fused_ce`` (steps/s and peak
   memory of each arm), checking finite metrics and exactly 24 K5, 12 K6
   and 12 K7 launches per step; splits one plain step's device time (K5,
   K6, K7, matrix products, idle; it fails if the profiler's rows of K5,
   K6 or K7 do not hold the step's launches); holds f32 gradients of SMALL at 2
   layers (b2 x T256) on the card against the CPU, and one AdamW update
   on identical gradients;
7. trains BERT-base at b32 x T128 (``adamw(2e-5)``) for 3 + 10 steps with
   exactly 12 K5, 12 K6 and 12 K7 launches per step, and splits one step's
   device time as phase 6 does;
8. prints one JSON line describing every kernel, then, as its last line,
   ``{"ok": true, "device": {...}}``.

Any failed phase ends the run with a nonzero exit and no result line.
Without a CUDA card, or without the rest of the repository beside it, it
exits nonzero before doing any work.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

#: Published H100 SXM peaks (NVIDIA data sheet) for the bound column.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: Kernel against plain version.  f32: absolute.  bf16: |a - b| <= ATOL +
#: RTOL |b|, one bf16 ulp relative (2^-7) plus the absolute term, so an
#: output of magnitude 4 or more is not held to less than its own ulp.
TOL_F32 = 1e-4
BF16_ATOL, BF16_RTOL = 2e-2, 2.0 ** -7

#: The serving path's shapes: bench.py's churn probe on CloudLM SMALL.
NUM_SLOTS, MAX_NEW, CHUNK = 8, 64, 8
BUCKETS = (32, 128, 512)
HEADS, HEAD_DIM = 12, 64
SERVING_KERNELS = ("flash_fwd", "paged_attention")


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call of ``fn``: the summed durations of the CUDA
    kernels it launches (torch.profiler kernel rows), without the host's
    launch gaps that an event pair around back-to-back small launches
    would include.  Each kernel counts its mean duration times its
    launches a call (its records over ``iters``, rounded): now and then a
    session loses a record, which a plain sum over ``iters`` would read
    as a faster call.  A session that lost more than a fifth of some
    kernel's records is run again, three sessions in all."""
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    for attempt in range(3):
        _, rows = profiled(run)
        calls = [max(1, round(count / iters)) for _, count, _ in rows]
        if all(abs(count - k * iters) <= iters // 5
               for (_, count, _), k in zip(rows, calls)):
            return sum(us / count * k for (us, count, _), k
                       in zip(rows, calls)) / 1e3
    raise AssertionError(f"torch.profiler lost kernel records in three "
                         f"sessions of {iters} calls: {rows[:4]}")


def profiled(run, *, cpu=False, record_shapes=False):
    """``run()`` under torch.profiler (CUDA activity, and CPU's if
    ``cpu``); returns ``(prof, kernel rows)``.  Now and then a session
    records no kernel at all, sometimes several in a row: such a session
    is run again after a second's pause, five sessions in all, before
    :func:`_kernel_rows` raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    for attempt in range(5):
        with profile(activities=activities,
                     record_shapes=record_shapes) as prof:
            run()
        try:
            return prof, _kernel_rows(prof)
        except AssertionError:
            if attempt == 4:
                raise
            time.sleep(1.0)


def event_and_device_ms(fn, iters: int = 20):
    """(event ms, device ms) of one call of ``fn``.  The first is
    :func:`time_ms`, CUDA events around back-to-back calls, the measure of
    every kernel's ``ms``: where a call's host cost exceeds its kernels'
    time it reads the host.  The second is :func:`device_ms`, the
    kernels' own time."""
    return time_ms(fn, iters=iters), device_ms(fn, iters=min(iters, 10))


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(what: str, out, ref, dtype_name: str, *, sums=False,
                scaled=False, input_scale=0.0) -> float:
    """Raise unless ``out`` is within the stated tolerance of ``ref``;
    return the largest absolute difference.  ``sums=True`` marks float32
    statistics and sums, held to 1e-4 of max(1, max |ref|) whatever the
    activations' type: their rounding grows with their magnitude.
    ``scaled=True`` (the flash backward's gradients, sums over up to T
    keys or queries) multiplies both absolute limits by s = max(1,
    max |ref|): f32 1e-4 s, bf16 2e-2 s + 2^-7 |ref|.
    ``input_scale`` (GroupNorm: max |x| times max rstd) adds 8 float32 ulps
    of it to the f32 limit: where |mean| >> std, two correct orders of the
    same sums differ by a few ulps of the mean, which the normalisation
    scales by rstd."""
    import torch

    diff = (out.float() - ref.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    s = max(1.0, float(ref.float().abs().max())) if sums or scaled else 1.0
    if sums:
        ok = err <= TOL_F32 * s
    elif dtype_name == "bfloat16":
        ok = bool((diff <= BF16_ATOL * s + BF16_RTOL * ref.float().abs())
                  .all())
    else:
        ok = err <= TOL_F32 * s + 8 * 2.0 ** -23 * input_scale
    ok = ok and bool(torch.isfinite(out.float()).all())
    if not ok:
        raise AssertionError(f"{what}: max_abs_err {err:.3e} outside the "
                             f"tolerance ({dtype_name})")
    return err


def check_lse_f32(what: str, lse, ref) -> float:
    """Raise unless K5's f32 ``lse`` is within 1e-4 max(1, |ref|) of
    ``ref`` elementwise, where ``ref`` comes from f32 scores; return the
    largest absolute difference.  The kernel's scores are f32 sums of
    exact products, so its lse meets an f32 limit whatever the inputs'
    type (K6 and K7 consume it)."""
    import torch

    diff = (lse - ref).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = bool((diff <= TOL_F32 * ref.abs().clamp(min=1.0)).all()
              and torch.isfinite(lse).all())
    if not ok:
        raise AssertionError(f"{what}: max_abs_err {err:.3e} outside "
                             f"1e-4 max(1, |lse|)")
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(device, card):
    """K5 at SMALL's H=12, D=64 for every prompt bucket and a ragged T."""
    import torch

    from cloud_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(5)
    worst = {"bfloat16": 0.0, "float32": 0.0}
    report = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for t in (32, 128, 512, 100):
            q, k, v = (torch.randn((1, t, HEADS, HEAD_DIM), generator=gen,
                                   device=device).to(dtype) for _ in range(3))
            for masked in (False, True):
                mask = None
                if masked:  # right-padded prompt, as the insert sends it
                    n = max(1, (2 * t) // 3)
                    mask = (torch.arange(t, device=device) < n).to(
                        torch.int32)[None]
                out, lse = fa._flash_kernel(q, k, v, causal=True, mask=mask)
                ref_out, ref_lse = fa._reference_with_lse(
                    q, k, v, causal=True, mask=mask)
                torch.cuda.synchronize()
                what = f"K5 flash_fwd {name} T={t} mask={masked}"
                err = max(check_close(what, out, ref_out, name),
                          check_close(what + " lse", lse, ref_lse, name))
                print(f"  {what}: max_abs_err={err:.3e} ok")
                worst[name] = max(worst[name], err)
                if name == "bfloat16" and t == 128 and masked:
                    report = (q, k, v, mask)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "cloud_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "cloud_tpu/ops/flash_attention.py:109",
            "max_abs_err": worst["bfloat16"], "max_abs_err_f32": worst["float32"],
            **time_flash_serving(fa, *report, card)}


def time_flash_serving(fa, q, k, v, mask, card):
    """K5 at the insert shape of a prompt bucket (bf16, causal, masked):
    the kernel, its plain version and SDPA, each in event and device time
    (:func:`event_and_device_ms`), with the bound."""
    import torch
    import torch.nn.functional as F

    t = q.shape[1]
    kernel, kernel_dev = event_and_device_ms(
        lambda: fa._flash_kernel(q, k, v, causal=True, mask=mask))
    plain, plain_dev = event_and_device_ms(
        lambda: fa._reference_with_lse(q, k, v, causal=True, mask=mask))
    allowed = (torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
               & (mask[:, None, None, :] != 0))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library, library_dev = event_and_device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed))
    elems = q.numel()
    nbytes = 4 * elems * 2 + mask.numel() * 4 + HEADS * t * 4
    flops = 4 * HEADS * HEAD_DIM * t * (t + 1) / 2  # causal half, QK and PV
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    print(f"  K5 flash_fwd bf16 B=1 T={t} H={HEADS} D={HEAD_DIM}: kernel "
          f"{kernel:.4f} ms (device {kernel_dev:.4f}), plain {plain:.4f} "
          f"({plain_dev:.4f}), sdpa {library:.4f} ({library_dev:.4f}), "
          f"bound {b_ms:.5f} ms ({b_by}) [{card}]")
    return {"ms": kernel, "device_ms": kernel_dev, "plain_ms": plain,
            "plain_device_ms": plain_dev, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library, "library_device_ms": library_dev,
            "shape": f"B=1 T={t} H={HEADS} D={HEAD_DIM} bf16 masked"}


#: Slot-row lengths of the paged checks: the engine's (a 512 prompt bucket
#: plus 64 new tokens) and a long row.
PAGED_LENGTHS = (BUCKETS[-1] + MAX_NEW, 4096)


def _paged_inputs(device, dtype, s, gen, *, pool: bool):
    """Slot rows of ``s`` positions, ``cur_len`` from 1 to ``s``, and a
    table of all -1 or, with ``pool``, pool pages leading some rows and
    one between slot pages."""
    import torch

    b = NUM_SLOTS
    slot = {n: torch.randn((b, s, HEADS, HEAD_DIM), generator=gen,
                           device=device).to(dtype) for n in ("k", "v")}
    cur_len = torch.tensor([1, 2, 17, 100, 288, 400, s - 1, s],
                           dtype=torch.int32, device=device)
    if not pool:
        table = torch.full((b, -(-s // 16)), -1, dtype=torch.int32,
                           device=device)
        return slot, None, table, cur_len
    nb, bt = 24, 16
    pool_l = {n: torch.randn((nb, bt, HEADS, HEAD_DIM), generator=gen,
                             device=device).to(dtype) for n in ("k", "v")}
    table = torch.full((b, -(-s // bt)), -1, dtype=torch.int32, device=device)
    for row in range(b):  # pool-backed leading pages, slot pages after
        for page in range(row % 4 + 1):
            table[row, page] = (3 * row + page) % nb
    table[5, 10] = 7  # a pool page between slot pages
    return slot, pool_l, table, cur_len


def _check_paged_cases(pa, device, gen, what, quantize):
    """K8 (or K8q with ``quantize``) against its plain version for slot
    rows of every ``PAGED_LENGTHS`` length, Tq 1 and 4, with and without a
    pool, q in bf16 and f32; returns the worst error per type."""
    import torch

    worst = {"bfloat16": 0.0, "float32": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for s in PAGED_LENGTHS:
            for tq in (1, 4):
                for pool in (True, False):
                    slot, pool_l, table, cur_len = _paged_inputs(
                        device, dtype, s, gen, pool=pool)
                    if quantize:
                        slot = _quantize_leaves(slot)
                        if pool_l is not None:
                            pool_l = _quantize_leaves(pool_l)
                    q = torch.randn((NUM_SLOTS, tq, HEADS, HEAD_DIM),
                                    generator=gen, device=device).to(dtype)
                    out = pa._paged_kernel(q, slot, cur_len, pool_l, table)
                    ref = pa._reference(q, slot, cur_len, pool_l, table)
                    torch.cuda.synchronize()
                    case = f"{what} {name} S={s} Tq={tq} pool={pool}"
                    err = check_close(case, out, ref, name)
                    print(f"  {case}: max_abs_err={err:.3e} ok")
                    worst[name] = max(worst[name], err)
    return worst


def _decode_rows(device, gen, s):
    """The engine's decode step at slot rows of ``s`` positions: bf16 K/V,
    a table of all -1, every row live at a length drawn across the row, Tq
    = 1; returns (slot, table, cur_len, live keys, q)."""
    import torch

    slot = {n: torch.randn((NUM_SLOTS, s, HEADS, HEAD_DIM), generator=gen,
                           device=device).to(torch.bfloat16)
            for n in ("k", "v")}
    table = torch.full((NUM_SLOTS, -(-s // 16)), -1, dtype=torch.int32,
                       device=device)
    lens = np.random.default_rng(0).integers(33, s + 1, NUM_SLOTS)
    cur_len = torch.tensor(lens, dtype=torch.int32, device=device)
    q = torch.randn((NUM_SLOTS, 1, HEADS, HEAD_DIM), generator=gen,
                    device=device).to(torch.bfloat16)
    return slot, table, cur_len, int(lens.sum()), q


def _sdpa_decode(q, k, v, cur_len):
    """SDPA over whole slot rows under the decode mask: the library
    yardstick of K8 and K8q."""
    import torch
    import torch.nn.functional as F

    s = k.shape[1]
    valid = (torch.arange(s, device=q.device)[None, :]
             < cur_len[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid)


def check_paged(device, card):
    """K8 against its plain version (``_check_paged_cases``), then timed at
    the engine's decode shape (8 slots, S=576, bf16, Tq=1): the kernel
    (split and combine), its plain version and SDPA, in event and device
    time."""
    import torch

    from cloud_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device=device).manual_seed(8)
    worst = _check_paged_cases(pa, device, gen, "K8 paged_attention", False)
    s = PAGED_LENGTHS[0]
    slot, table, cur_len, keys, q = _decode_rows(device, gen, s)
    kernel, kernel_dev = event_and_device_ms(
        lambda: pa._paged_kernel(q, slot, cur_len, None, table), iters=50)
    plain, plain_dev = event_and_device_ms(
        lambda: pa._reference(q, slot, cur_len, None, table))
    library, library_dev = event_and_device_ms(
        _sdpa_decode(q, slot["k"], slot["v"], cur_len), iters=50)
    nbytes = (2 * keys * HEADS * HEAD_DIM * 2 + 2 * q.numel() * 2
              + NUM_SLOTS * 4 + table.numel() * 4)
    flops = 4 * keys * HEADS * HEAD_DIM
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    print(f"  K8 paged_attention bf16 B={NUM_SLOTS} S={s} Tq=1 live keys "
          f"{keys}: kernel {kernel:.4f} ms (device {kernel_dev:.4f}), plain "
          f"{plain:.4f} ({plain_dev:.4f}), sdpa {library:.4f} "
          f"({library_dev:.4f}), bound {b_ms:.5f} ms ({b_by}) [{card}]")
    return {"name": "paged_attention", "route": "cuda",
            "source": "cloud_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "cloud_tpu/ops/paged_attention.py:181",
            "max_abs_err": worst["bfloat16"],
            "max_abs_err_f32": worst["float32"],
            "ms": kernel, "device_ms": kernel_dev, "plain_ms": plain,
            "plain_device_ms": plain_dev, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library,
            "library_device_ms": library_dev, "live_keys": keys,
            "shape": f"B={NUM_SLOTS} S={s} Tq=1 H={HEADS} D={HEAD_DIM} bf16"}


def _quantize_leaves(tree):
    """int8 K/V with per-(position, head) f32 scales, as the kv_quant cache
    stores them."""
    from cloud_tpu_torch.models import quantization

    out = {}
    for name in ("k", "v"):
        out[name], out[f"{name}_scale"] = quantization.quantize_unchecked(
            tree[name], axis=-1)
    return out


def _time_paged_int8(pa, device, card, gen, s):
    """K8q at B=8 and slot rows of S positions (``_decode_rows``), beside
    K8 on the bf16 K/V it was quantized from, the plain version, and SDPA
    on K/V dequantized to bf16 beforehand (the dequant is outside the
    timed region), each in event and device time."""
    import torch

    slot, table, cur_len, keys, q = _decode_rows(device, gen, s)
    qslot = _quantize_leaves(slot)
    kernel, kernel_dev = event_and_device_ms(
        lambda: pa._paged_kernel(q, qslot, cur_len, None, table), iters=50)
    bf16, bf16_dev = event_and_device_ms(
        lambda: pa._paged_kernel(q, slot, cur_len, None, table), iters=50)
    plain, plain_dev = event_and_device_ms(
        lambda: pa._reference(q, qslot, cur_len, None, table))
    deq = {n: (qslot[n].float() * qslot[f"{n}_scale"]).to(torch.bfloat16)
           for n in ("k", "v")}
    library, library_dev = event_and_device_ms(
        _sdpa_decode(q, deq["k"], deq["v"], cur_len), iters=50)
    # Per live (key, head): 2 * hd int8 and two f32 scales.
    nbytes = (keys * HEADS * (2 * HEAD_DIM + 8) + 2 * q.numel() * 2
              + NUM_SLOTS * 4 + table.numel() * 4)
    flops = 4 * keys * HEADS * HEAD_DIM
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    print(f"  K8q paged_attention_int8 B={NUM_SLOTS} S={s} Tq=1 live keys "
          f"{keys}: kernel {kernel:.4f} ms (device {kernel_dev:.4f}), K8 on "
          f"bf16 K/V {bf16:.4f} ({bf16_dev:.4f}), plain {plain:.4f} "
          f"({plain_dev:.4f}), sdpa on dequantized bf16 {library:.4f} "
          f"({library_dev:.4f}), bound {b_ms:.5f} ms ({b_by}) [{card}]")
    return {"ms": kernel, "device_ms": kernel_dev, "bf16_k8_ms": bf16,
            "bf16_k8_device_ms": bf16_dev, "plain_ms": plain,
            "plain_device_ms": plain_dev, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library, "library_device_ms": library_dev,
            "live_keys": keys,
            "shape": f"B={NUM_SLOTS} S={s} Tq=1 H={HEADS} D={HEAD_DIM} "
                     f"int8 K/V, bf16 q"}


def check_paged_int8(device, card):
    """K8q against its plain version (``_check_paged_cases`` on int8 K/V
    and pool); timed at the engine's decode shape (8 slots, S=576) and at
    S=4096."""
    import torch

    from cloud_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device=device).manual_seed(18)
    worst = _check_paged_cases(pa, device, gen, "K8q paged_attention_int8",
                               True)
    engine_shape = _time_paged_int8(pa, device, card, gen, PAGED_LENGTHS[0])
    long_rows = _time_paged_int8(pa, device, card, gen, PAGED_LENGTHS[1])
    entry = {"name": "paged_attention_int8", "route": "cuda",
             "source": "cloud_tpu_torch/ops/csrc/paged_attention.cu",
             "replaces": "cloud_tpu/ops/paged_attention.py:181 (quantized)",
             "max_abs_err": worst["bfloat16"],
             "max_abs_err_f32": worst["float32"], "at_4096": long_rows}
    entry.update(engine_shape)
    return entry


# ---------------------------------------------------------------------------
# Phase 2b: GroupNorm K1-K4 against their plain versions
# ---------------------------------------------------------------------------

GN_KERNELS = ("gn_fwd", "gn_fwd_res", "gn_bwd", "gn_bwd_res")
GN_REPLACES = {"gn_fwd": "cloud_tpu/ops/group_norm.py:96",
               "gn_fwd_res": "cloud_tpu/ops/group_norm.py:113",
               "gn_bwd": "cloud_tpu/ops/group_norm.py:146",
               "gn_bwd_res": "cloud_tpu/ops/group_norm.py:172"}
GN_GROUPS, GN_EPS = 32, 1e-5
#: Launches of each GroupNorm kernel in one ResNet-50 step: 37 calls
#: without a residual (stem, gn1 and gn2 of 16 blocks, 4 projections) and
#: 16 with one (gn3 of each block), forward and backward.
GN_PER_STEP = {"gn_fwd": 37, "gn_fwd_res": 16, "gn_bwd": 37, "gn_bwd_res": 16}
RESNET50_STAGES, RESNET50_WIDTH = (3, 4, 6, 3), 64
CIFAR_BATCH, IMAGENET_BATCH = 256, 128


def gn_calls(batch: int, image_hw: int):
    """``(shape, residual, relu)`` of every GroupNorm call of one ResNet-50
    forward pass, in order (``cloud_tpu_torch/models/resnet.py``)."""
    calls = []
    hw = -(-image_hw // 2)  # stem, stride 2
    calls.append(((batch, hw, hw, RESNET50_WIDTH), False, True))
    hw = -(-hw // 2)  # max-pool, stride 2
    cin = RESNET50_WIDTH
    for stage, blocks in enumerate(RESNET50_STAGES):
        cmid = RESNET50_WIDTH * 2 ** stage
        cout = 4 * cmid
        for block in range(blocks):
            stride = 2 if (block == 0 and stage > 0) else 1
            out = -(-hw // stride)
            calls.append(((batch, hw, hw, cmid), False, True))    # gn1
            calls.append(((batch, out, out, cmid), False, True))  # gn2
            if stride != 1 or cin != cout:
                calls.append(((batch, out, out, cout), False, False))
            calls.append(((batch, out, out, cout), True, True))   # gn3
            hw, cin = out, cout
    return calls


def _gn_kernel_calls(name, calls):
    """The step's calls that launch kernel ``name``: K1/K3 take every call
    without a residual, K2/K4 every call with one."""
    res = name in ("gn_fwd_res", "gn_bwd_res")
    return [(shape, relu) for shape, r, relu in calls if r == res]


def _gn_inputs(shape, dtype, gen, *, residual, mean=0.0, offset=0):
    """Seeded inputs of one GroupNorm call; ``offset`` > 0 starts every
    activation that many elements into its buffer (a pointer that is not
    16-byte aligned, for the kernels' scalar route)."""
    import torch

    device = gen.device
    c = shape[-1]
    numel = int(np.prod(shape))

    def act(shift=0.0):
        flat = torch.randn((numel + offset,), generator=gen, device=device)
        return (flat[offset:] + shift).to(dtype).view(shape)

    x = act(mean)
    scale = 1.0 + 0.3 * torch.randn((c,), generator=gen, device=device)
    bias = 0.2 * torch.randn((c,), generator=gen, device=device)
    res = act() if residual else None
    dy = act()
    return x, scale, bias, res, dy


def _check_gn_case(gn, shape, dtype, gen, *, residual, relu, mean=0.0,
                   groups=GN_GROUPS, offset=0):
    """K1/K2 then K3/K4 against the plain versions on the same inputs (the
    backward on the forward kernel's own statistics, so both recompute the
    same relu gate; ds and db summed over B, [C]).  Returns {kernel:
    max_abs_err}."""
    import torch

    name = str(dtype).split(".")[1]
    x, scale, bias, res, dy = _gn_inputs(shape, dtype, gen,
                                         residual=residual, mean=mean,
                                         offset=offset)
    y, m, r = gn._fwd_kernel(x, scale, bias, res, groups, GN_EPS, relu)
    ry, rm, rr = gn._fwd_plain(x, scale, bias, res, groups, GN_EPS, relu)
    fwd = "gn_fwd_res" if residual else "gn_fwd"
    what = f"{fwd} {name} {shape} relu={relu} mean={mean:g} G={groups}"
    scale_in = float(x.float().abs().max() * rr.max())
    errs = {fwd: max(check_close(what + " y", y, ry, name,
                                 input_scale=scale_in),
                     check_close(what + " mean", m, rm, name, sums=True),
                     check_close(what + " rstd", r, rr, name, sums=True))}
    dx, ds, db, dres = gn._bwd_kernel(x, dy, m, r, scale, bias, res,
                                      groups, relu)
    rdx, rds, rdb, rdres = gn._bwd_plain(x, dy, m, r, scale, bias, res,
                                         groups, relu)
    bwd = "gn_bwd_res" if residual else "gn_bwd"
    what = f"{bwd} {name} {shape} relu={relu} mean={mean:g} G={groups}"
    if ds.shape != (shape[-1],) or db.shape != (shape[-1],):
        raise AssertionError(f"{what}: ds/db shapes {tuple(ds.shape)}, "
                             f"{tuple(db.shape)}, not [C]")
    err = max(check_close(what + " dx", dx, rdx, name, input_scale=scale_in),
              check_close(what + " ds", ds, rds, name, sums=True),
              check_close(what + " db", db, rdb, name, sums=True))
    if residual:
        err = max(err, check_close(what + " dres", dres, rdres, name))
    errs[bwd] = err
    torch.cuda.synchronize()
    return errs


def _check_gn_repeat(gn, shape, gen, *, residual, relu):
    """Two launches of K1/K2 and of K3/K4 on the same bf16 inputs give the
    same bits (the sums over rows, CTAs and B are taken in fixed orders)."""
    import torch

    x, scale, bias, res, dy = _gn_inputs(shape, torch.bfloat16, gen,
                                         residual=residual)
    runs = []
    for _ in range(2):
        y, m, r = gn._fwd_kernel(x, scale, bias, res, GN_GROUPS, GN_EPS, relu)
        dx, ds, db, dres = gn._bwd_kernel(x, dy, m, r, scale, bias, res,
                                          GN_GROUPS, relu)
        runs.append([y, m, r, dx, ds, db] + ([dres] if residual else []))
    torch.cuda.synchronize()
    names = ["y", "mean", "rstd", "dx", "ds", "db", "dres"]
    for what, a, b in zip(names, *runs):
        if not torch.equal(a, b):
            raise AssertionError(f"group_norm {shape} residual={residual}: "
                                 f"two launches differ in {what}")


def _check_gn_launches(gn, shape, gen):
    """The profiler's kernel rows of one K2 call and of one K4 call: at
    most two GroupNorm kernels a direction.  Returns the row names."""
    import torch

    x, scale, bias, res, dy = _gn_inputs(shape, torch.bfloat16, gen,
                                         residual=True)
    _, m, r = gn._fwd_kernel(x, scale, bias, res, GN_GROUPS, GN_EPS, True)
    out = {}
    for direction, call in (
            ("forward", lambda: gn._fwd_kernel(x, scale, bias, res,
                                               GN_GROUPS, GN_EPS, True)),
            ("backward", lambda: gn._bwd_kernel(x, dy, m, r, scale, bias,
                                                res, GN_GROUPS, True))):
        call()
        torch.cuda.synchronize()

        def run():
            call()
            torch.cuda.synchronize()

        _, rows = profiled(run)
        gn_rows = [(count, key) for _, count, key in rows if _is_gn(key)]
        launches = sum(count for count, _ in gn_rows)
        if not 1 <= launches <= 2 or len(rows) != len(gn_rows):
            raise AssertionError(f"one {direction} call at {shape} launched "
                                 f"{rows} (at most two GroupNorm kernels)")
        out[direction] = [f"{re.search(r'gn_[a-z_]+', key).group(0)} x{count}"
                          for count, key in gn_rows]
    return out


def _gn_bytes_ops(name, shape, dtype_bytes):
    """Bytes one call must move (each input read once, each output written
    once) and its float32 operations, from its shape."""
    b, h, w, c = shape
    n = b * h * w * c
    stats = 2 * b * GN_GROUPS * 4  # mean, rstd
    affine = 2 * c * 4             # scale, bias
    if name == "gn_fwd":
        return 2 * n * dtype_bytes + affine + stats, 8 * n
    if name == "gn_fwd_res":
        return 3 * n * dtype_bytes + affine + stats, 9 * n
    sums = 2 * c * 4               # ds, db (summed over B)
    if name == "gn_bwd":
        return 3 * n * dtype_bytes + affine + stats + sums, 14 * n
    return 5 * n * dtype_bytes + affine + stats + sums, 15 * n


def _time_gn(gn, name, calls, gen, *, plain=True):
    """Kernel, plain (unless ``plain`` is false) and ``F.group_norm`` (+
    add and relu; autograd for the backward) times of the given calls run
    back to back, and their bound."""
    import torch
    import torch.nn.functional as F

    dtype = torch.bfloat16
    fwd = name.startswith("gn_fwd")
    residual = name.endswith("_res")
    setups, nbytes, ops = [], 0.0, 0.0
    for shape, relu in calls:
        x, scale, bias, res, dy = _gn_inputs(shape, dtype, gen,
                                             residual=residual)
        _, m, r = gn._fwd_kernel(x, scale, bias, res, GN_GROUPS, GN_EPS,
                                 relu)
        setups.append((x, scale, bias, res, dy, m, r, relu))
        by, op = _gn_bytes_ops(name, shape, 2)
        nbytes, ops = nbytes + by, ops + op

    def kernel():
        for x, scale, bias, res, dy, m, r, relu in setups:
            if fwd:
                gn._fwd_kernel(x, scale, bias, res, GN_GROUPS, GN_EPS, relu)
            else:
                gn._bwd_kernel(x, dy, m, r, scale, bias, res, GN_GROUPS,
                               relu)

    def plain_fn():
        for x, scale, bias, res, dy, m, r, relu in setups:
            if fwd:
                gn._fwd_plain(x, scale, bias, res, GN_GROUPS, GN_EPS, relu)
            else:
                gn._bwd_plain(x, dy, m, r, scale, bias, res, GN_GROUPS,
                              relu)

    graphs = []
    for x, scale, bias, res, dy, m, r, relu in setups:
        leaves = [t.detach().requires_grad_(not fwd)
                  for t in (x, scale.to(dtype), bias.to(dtype))]
        if res is not None:
            leaves.append(res.detach().requires_grad_(not fwd))
        graphs.append((leaves, relu, dy))

    def library_fwd(leaves, relu):
        y = F.group_norm(leaves[0].permute(0, 3, 1, 2), GN_GROUPS,
                         leaves[1], leaves[2], GN_EPS)
        if len(leaves) == 4:
            y = y + leaves[3].permute(0, 3, 1, 2)
        return F.relu(y) if relu else y

    if fwd:
        def library():
            with torch.no_grad():
                for leaves, relu, _ in graphs:
                    library_fwd(leaves, relu)
    else:
        built = [(library_fwd(leaves, relu), leaves, dy.permute(0, 3, 1, 2))
                 for leaves, relu, dy in graphs]

        def library():
            for y, leaves, dy in built:
                torch.autograd.grad(y, leaves, dy, retain_graph=True)

    with torch.no_grad():
        times = {"kernel": (device_ms(kernel), time_ms(kernel))}
        if plain:
            times["plain"] = (device_ms(plain_fn, iters=3),
                              time_ms(plain_fn, iters=5))
    times["library"] = (device_ms(library, iters=3),
                        time_ms(library, iters=5))
    b_ms, b_by = bound_ms(nbytes, ops, "float32")
    return times, b_ms, b_by


def _gn_step_shapes(name, calls):
    """``{(shape, relu): calls a step}`` of kernel ``name`` in ``calls``."""
    out = {}
    for key in _gn_kernel_calls(name, calls):
        out[key] = out.get(key, 0) + 1
    return out


def time_gn_224(gn, name, gen, card):
    """Kernel ``name`` at every shape of a ResNet-50 224 b128 step, one
    call each (device time beside ``F.group_norm``'s and the bound), and
    the step's sum (each shape's time times its calls a step)."""
    rows, step = [], {"kernel_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for (shape, relu), count in _gn_step_shapes(
            name, gn_calls(IMAGENET_BATCH, 224)).items():
        t, b_ms, _ = _time_gn(gn, name, [(shape, relu)], gen, plain=False)
        row = {"shape": list(shape), "relu": relu, "calls_per_step": count,
               "kernel_ms": t["kernel"][0], "library_ms": t["library"][0],
               "bound_ms": b_ms, "kernel_event_ms": t["kernel"][1]}
        rows.append(row)
        for k in step:
            step[k] += count * row[k]
        print(f"    {name} {shape} relu={relu} x{count}/step, device ms: "
              f"kernel {row['kernel_ms']:.4f}, F.group_norm "
              f"{row['library_ms']:.4f}, bound {b_ms:.5f} "
              f"({b_ms / row['kernel_ms']:.2f} of it) [{card}]")
    print(f"  {name} bf16 over one 224 b128 step's calls, device ms: kernel "
          f"{step['kernel_ms']:.4f}, F.group_norm {step['library_ms']:.4f}, "
          f"bound {step['bound_ms']:.4f} [{card}]")
    return rows, step


def check_group_norm(device, card):
    """K1-K4 at every GroupNorm shape of a ResNet-50 CIFAR b256 step and of
    a 224 b128 step; f32 and bf16, relu and residual on and off, one input
    with mean 1e3 and std 1, channels that are not a multiple of 8 and a
    misaligned pointer (the scalar route); bit-identical repeat launches;
    at most two kernels a call per direction in the profiler's rows.
    Times the 37 or 16 calls of one CIFAR step back to back per kernel,
    one call at the two largest 224 shapes (beside the plain version) and
    every 224 shape."""
    import torch

    from cloud_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device=device).manual_seed(12)
    cifar = gn_calls(CIFAR_BATCH, 32)
    at_224 = gn_calls(IMAGENET_BATCH, 224)
    big = [(IMAGENET_BATCH, 112, 112, 64), (IMAGENET_BATCH, 56, 56, 256)]
    shapes = (sorted({shape for shape, _, _ in cifar})
              + sorted({shape for shape, _, _ in at_224}))
    for shape in sorted({shape for shape, _, _ in at_224}):
        fwd = gn._plan(shape, torch.bfloat16, GN_GROUPS)
        bwd = gn._plan(shape, torch.bfloat16, GN_GROUPS, backward=True)
        print(f"  plan bf16 {shape}: forward cluster {fwd.cluster}, rows "
              f"{fwd.rows}, cached {fwd.cached}, threads {fwd.threads}, "
              f"smem {fwd.smem}; backward cluster {bwd.cluster}, rows "
              f"{bwd.rows}, cached {bwd.cached}, threads {bwd.threads}, "
              f"smem {bwd.smem}")
    worst = {k: {"bfloat16": 0.0, "float32": 0.0} for k in GN_KERNELS}
    cases = 0

    def note(errs, dname):
        for k, e in errs.items():
            worst[k][dname] = max(worst[k][dname], e)

    odd = (CIFAR_BATCH, 14, 14, 30)  # 30 channels in 6 groups
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for shape in shapes:
            for residual in (False, True):
                for relu in (False, True):
                    note(_check_gn_case(gn, shape, dtype, gen,
                                        residual=residual, relu=relu), dname)
                    cases += 1
        for residual, relu in ((True, True), (False, False)):
            note(_check_gn_case(gn, (CIFAR_BATCH, 8, 8, 256), dtype, gen,
                                residual=residual, relu=relu, mean=1e3),
                 dname)
            cases += 1
        if gn._plan(odd, dtype, 6).vec != 1 or gn._plan(
                (CIFAR_BATCH, 8, 8, 64), dtype, GN_GROUPS,
                aligned=False).vec != 1:
            raise AssertionError("the scalar route was not planned")
        for residual in (False, True):
            note(_check_gn_case(gn, odd, dtype, gen, residual=residual,
                                relu=True, groups=6), dname)
            note(_check_gn_case(gn, (CIFAR_BATCH, 8, 8, 64), dtype, gen,
                                residual=residual, relu=True, offset=1),
                 dname)
            cases += 2
        print(f"  K1-K4 group_norm {dname}: {len(shapes)} shapes (CIFAR b256"
              f" and 224 b128) x relu x residual + mean 1e3 + scalar route "
              f"(C=30, misaligned) ok; max_abs_err " + ", ".join(
                  f"{k} {worst[k][dname]:.3e}" for k in GN_KERNELS))
    for shape, residual in ((big[0], False), (big[1], True),
                            ((CIFAR_BATCH, 1, 1, 2048), True)):
        _check_gn_repeat(gn, shape, gen, residual=residual, relu=True)
    print("  two launches on the same inputs: y, mean, rstd, dx, ds, db, "
          "dres bit-identical at " + ", ".join(
              str(s) for s in (big[0], big[1], (CIFAR_BATCH, 1, 1, 2048))))
    launch_rows = _check_gn_launches(gn, big[1], gen)
    print(f"  one call's GroupNorm kernels (profiler rows): {launch_rows}")
    entries = []
    for name in GN_KERNELS:
        calls = _gn_kernel_calls(name, cifar)
        times, b_ms, b_by = _time_gn(gn, name, calls, gen)
        shape_224 = big[1] if name.endswith("_res") else big[0]
        t224, b224, _ = _time_gn(gn, name, [(shape_224, True)], gen)
        print(f"  {name} bf16, its {len(calls)} calls of one CIFAR b256 step,"
              f" device ms: kernel {times['kernel'][0]:.4f}, plain "
              f"{times['plain'][0]:.4f}, F.group_norm "
              f"{times['library'][0]:.4f}, bound {b_ms:.5f} ({b_by}); "
              f"back to back (events): kernel {times['kernel'][1]:.4f}, "
              f"plain {times['plain'][1]:.4f}, F.group_norm "
              f"{times['library'][1]:.4f} [{card}]")
        print(f"  {name} bf16, one call at {shape_224}, device ms: kernel "
              f"{t224['kernel'][0]:.4f}, plain {t224['plain'][0]:.4f}, "
              f"F.group_norm {t224['library'][0]:.4f}, bound {b224:.5f} "
              f"[{card}]")
        shapes_224, step_224 = time_gn_224(gn, name, gen, card)
        entries.append({
            "name": name, "route": "cuda",
            "source": "cloud_tpu_torch/ops/csrc/group_norm.cu",
            "replaces": GN_REPLACES[name],
            "max_abs_err": worst[name]["bfloat16"],
            "max_abs_err_f32": worst[name]["float32"],
            "ms": times["kernel"][0], "plain_ms": times["plain"][0],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": times["library"][0],
            "event_ms": {k: v[1] for k, v in times.items()},
            "shape": f"its {len(calls)} calls of one ResNet-50 CIFAR b256 "
                     f"bf16 step (device time summed)",
            "at_224": {"shape": list(shape_224), "bound_ms": b224,
                       **{f"{k}_ms": v[0] for k, v in t224.items()}},
            "at_224_shapes": shapes_224, "step_224": step_224,
            "kernel_rows": launch_rows})
    print(f"  group_norm: {cases} cases per kernel pair checked")
    return entries


# ---------------------------------------------------------------------------
# Phase 2c: flash backward K6/K7 against their plain version
# ---------------------------------------------------------------------------

FLASH_BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
FLASH_BWD_REPLACES = {"flash_bwd_dq": "cloud_tpu/ops/flash_attention.py:280",
                      "flash_bwd_dkv": "cloud_tpu/ops/flash_attention.py:338"}
TRAIN_ATTN_KERNELS = ("flash_fwd",) + FLASH_BWD_KERNELS
#: The two transformer-training paths: (batch, T, causal).  K5 runs twice
#: per layer in the LM step (forward, and remat's recompute), once in
#: BERT's (no remat); K6 and K7 once per layer in both.
LM_BATCH, LM_SEQ, BERT_BATCH, BERT_SEQ = 4, 1024, 32, 128
TRAIN_SHAPES = {"LM": (LM_BATCH, LM_SEQ, True),
                "BERT": (BERT_BATCH, BERT_SEQ, False)}
LM_PER_STEP = {"flash_fwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
BERT_PER_STEP = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}


def _attn_inputs(b, t, dtype, gen, *, mask_kind, h=HEADS, d=HEAD_DIM):
    import torch

    device = gen.device
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen,
                               device=device).to(dtype) for _ in range(4))
    mask = None
    if mask_kind == "tail":  # right padding, every sample keeps a key
        lens = torch.randint(1, t + 1, (b,), generator=gen, device=device)
        lens[0] = t
        mask = (torch.arange(t, device=device)[None] < lens[:, None]).to(
            torch.int32)
    elif mask_kind == "empty":  # sample 0 has no valid key at all
        mask = torch.ones((b, t), dtype=torch.int32, device=device)
        mask[0] = 0
        mask[1:, t // 2:] = 0
    return q, k, v, do, mask


def _bwd_case(fa, b, t, causal, dtype, gen, *, mask_kind, glse,
              h=HEADS, d=HEAD_DIM):
    """K5 forward against ``_reference_with_lse`` (out and lse; lse also
    against f32 scores), then K6/K7 and the plain version on K5's out and
    lse; returns {kernel: max_abs_err}, and the lse's error against f32
    scores under "flash_fwd lse"."""
    import torch

    name = str(dtype).split(".")[1]
    q, k, v, do, mask = _attn_inputs(b, t, dtype, gen, mask_kind=mask_kind,
                                     h=h, d=d)
    out, lse = fa._flash_kernel(q, k, v, causal=causal, mask=mask)
    ref_out, ref_lse = fa._reference_with_lse(q, k, v, causal=causal,
                                              mask=mask)
    # The plain version rounds bf16 scores to bf16, which bounds the lse
    # check above at bf16's limit; these scores are f32.
    _, lse32 = fa._reference_with_lse(q.float(), k.float(), v.float(),
                                      causal=causal, mask=mask)
    g_lse = (torch.randn((b, h, t), generator=gen, device=gen.device)
             if glse else None)
    got = fa._bwd_kernels(q, k, v, mask, do, out, lse, causal=causal,
                          g_lse=g_lse)
    ref = fa._bwd_reference(q, k, v, mask, do, out, lse, causal=causal,
                            g_lse=g_lse)
    torch.cuda.synchronize()
    what = (f"{name} B={b} T={t} H={h} D={d} causal={causal} "
            f"mask={mask_kind} g_lse={glse}")
    errs = {"flash_fwd": max(
        check_close(f"K5 out {what}", out, ref_out, name),
        check_close(f"K5 lse {what}", lse, ref_lse, name))}
    errs["flash_fwd lse"] = check_lse_f32(f"K5 lse (f32 scores) {what}", lse,
                                          lse32)
    errs["flash_bwd_dq"] = check_close(f"K6 dq {what}", got[0], ref[0],
                                       name, scaled=True)
    errs["flash_bwd_dkv"] = max(
        check_close(f"K7 dk {what}", got[1], ref[1], name, scaled=True),
        check_close(f"K7 dv {what}", got[2], ref[2], name, scaled=True))
    return errs


def _no_valid_key_case(fa, gen, *, h, d):
    """bf16 K6 and K7 against their f32 kernels where causal rows have no
    valid key (left padding: sample 0's first 37 rows, sample 1's first
    150), on the same inputs upcast and the same lse and row terms.  The
    plain version gives such rows p = 1 from all T keys, the kernels from
    the keys of the tiles they walk (``flash_bwd.cu``): the bf16 and f32
    kernels walk one set.  Returns {kernel: max_abs_err}."""
    import torch

    b, t = 2, 200
    q, k, v, do, _ = _attn_inputs(b, t, torch.bfloat16, gen, mask_kind=None,
                                  h=h, d=d)
    mask = torch.ones((b, t), dtype=torch.int32, device=gen.device)
    mask[0, :37] = 0
    mask[1, :150] = 0
    out, lse = fa._flash_kernel(q, k, v, causal=True, mask=mask)
    row = fa._row_term(do, out, None)
    up = [x.float() for x in (q, k, v, do)]
    got, want = {}, {}
    for name in FLASH_BWD_KERNELS:
        got[name] = fa._bwd_launch(name, q, k, v, mask, do, lse, row,
                                   causal=True)
        want[name] = fa._bwd_launch(name, *up[:3], mask, up[3], lse, row,
                                    causal=True)
    torch.cuda.synchronize()
    if not bool((lse[0, :, :37] <= fa.NEG_INF).all()):
        raise AssertionError("K5 lse of rows with no valid key is not "
                             "NEG_INF")
    what = (f"bf16 against the f32 kernel, B={b} T={t} H={h} D={d} causal, "
            f"rows with no valid key")
    return {name: max(check_close(f"{name} {what}", x, y, "bfloat16",
                                  scaled=True)
                      for x, y in zip(got[name], want[name]))
            for name in FLASH_BWD_KERNELS}


def _attn_bound(kernel, b, t, causal):
    """(bound_ms, bound_by) of one bf16 call at [b, t, 12, 64]: each input
    read once and each output written once; 2 B*H*D operations per
    (query, key) pair a product visits (the causal half only under the
    causal skip), times the kernel's products: K5 2, K6 3, K7 4."""
    elems = b * t * HEADS * HEAD_DIM
    rows = b * HEADS * t * 4  # one [B, H, T] f32 vector
    pairs = t * (t + 1) // 2 if causal else t * t
    per_product = 2 * b * HEADS * HEAD_DIM * pairs
    if kernel == "flash_fwd":  # q, k, v -> out, lse
        return bound_ms(4 * elems * 2 + rows, 2 * per_product, "bfloat16")
    if kernel == "flash_bwd_dq":  # q, k, v, dO, lse, rowterm -> dq
        return bound_ms(5 * elems * 2 + 2 * rows, 3 * per_product,
                        "bfloat16")
    # q, k, v, dO, lse, rowterm -> dk, dv
    return bound_ms(6 * elems * 2 + 2 * rows, 4 * per_product, "bfloat16")


def _time_attention(fa, path, card, gen):
    """Kernel, plain and library times of K5, K6 and K7 (bf16, no mask) at
    one training path's shape, with their bounds, each in event and device
    time (:func:`event_and_device_ms`).  The library yardstick is
    ``F.scaled_dot_product_attention``: its forward for K5, its backward
    (forward plus backward, less the forward) for K6 and K7."""
    import torch
    import torch.nn.functional as F

    b, t, causal = TRAIN_SHAPES[path]
    q, k, v, do, _ = _attn_inputs(b, t, torch.bfloat16, gen, mask_kind=None)
    with torch.no_grad():
        out, lse = fa._flash_kernel(q, k, v, causal=causal, mask=None)
        row = fa._row_term(do, out, None)
        calls = {
            "flash_fwd": lambda: fa._flash_kernel(q, k, v, causal=causal,
                                                  mask=None),
            "flash_bwd_dq": lambda: fa._bwd_launch(
                "flash_bwd_dq", q, k, v, None, do, lse, row, causal=causal),
            "flash_bwd_dkv": lambda: fa._bwd_launch(
                "flash_bwd_dkv", q, k, v, None, do, lse, row, causal=causal),
        }
        times = {name: event_and_device_ms(fn) for name, fn in calls.items()}
        plain_fwd = event_and_device_ms(lambda: fa._reference_with_lse(
            q, k, v, causal=causal, mask=None), iters=5)
        plain_bwd = event_and_device_ms(lambda: fa._bwd_reference(
            q, k, v, None, do, out, lse, causal=causal), iters=5)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    sdpa_fwd = event_and_device_ms(sdpa)
    sdpa_both = event_and_device_ms(
        lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
    sdpa_bwd = tuple(x - y for x, y in zip(sdpa_both, sdpa_fwd))
    entries = {}
    for name, (kernel, kernel_dev) in times.items():
        fwd = name == "flash_fwd"
        plain, plain_dev = plain_fwd if fwd else plain_bwd
        library, library_dev = sdpa_fwd if fwd else sdpa_bwd
        b_ms, b_by = _attn_bound(name, b, t, causal)
        entries[name] = {
            "shape": f"B={b} T={t} H={HEADS} D={HEAD_DIM} bf16 "
                     f"{'causal' if causal else 'non-causal'}, no mask",
            "ms": kernel, "device_ms": kernel_dev,
            "plain_ms": plain, "plain_device_ms": plain_dev,
            "library_ms": library, "library_device_ms": library_dev,
            "bound_ms": b_ms, "bound_by": b_by}
        print(f"  {name} {path} {entries[name]['shape']}: kernel "
              f"{kernel:.4f} ms (device {kernel_dev:.4f}), plain "
              f"{plain:.4f} ({plain_dev:.4f})"
              f"{'' if fwd else ' (dq, dk, dv together)'}, sdpa "
              f"{'forward' if fwd else 'backward'} {library:.4f} "
              f"({library_dev:.4f}), bound {b_ms:.5f} ms ({b_by}) [{card}]")
    return entries


def check_flash_bwd(device, card):
    """K5 against ``_reference_with_lse``, and K6 and K7 against
    ``_bwd_reference`` on K5's out and lse, at both training shapes (LM
    B=4 T=1024, BERT B=32 T=128), causal and not x no mask or a padded
    tail x g_lse None or random, f32 and bf16; ragged T (200, 1000)
    causal with a mask, and non-causal with a sample whose keys are all
    masked; in bf16 also at every head dim the kernels take (H=4, T=200
    causal with a mask, T=130 non-causal).  Then times K5, K6 and K7 at
    both shapes.  Returns the K6/K7 entries, K5's timings at both shapes
    and K5's worst errors here."""
    import torch

    from cloud_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(6)
    worst = {k: {"bfloat16": 0.0, "float32": 0.0}
             for k in TRAIN_ATTN_KERNELS + ("flash_fwd lse",)}
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        runs = [(b, t, causal, mask_kind, glse, HEADS, HEAD_DIM)
                for b, t, _ in TRAIN_SHAPES.values()
                for causal in (True, False)
                for mask_kind in (None, "tail")
                for glse in (False, True)]
        runs += [(2, 200, True, "tail", True, HEADS, HEAD_DIM),
                 (3, 200, False, "empty", True, HEADS, HEAD_DIM),
                 (2, 1000, True, "tail", True, HEADS, HEAD_DIM),
                 (2, 1000, False, None, False, HEADS, HEAD_DIM)]
        if dtype == torch.bfloat16:
            runs += [case for d in fa.KERNEL_HEAD_DIMS
                     for case in ((2, 200, True, "tail", True, 4, d),
                                  (2, 130, False, None, False, 4, d))]
        for b, t, causal, mask_kind, glse, h, d in runs:
            errs = _bwd_case(fa, b, t, causal, dtype, gen,
                             mask_kind=mask_kind, glse=glse, h=h, d=d)
            cases += 1
            for k_, e in errs.items():
                worst[k_][dname] = max(worst[k_][dname], e)
        print(f"  K5/K6/K7 {dname}: {len(runs)} cases ok; max_abs_err out/lse"
              f" {worst['flash_fwd'][dname]:.3e} (lse against f32 scores "
              f"{worst['flash_fwd lse'][dname]:.3e}), dq "
              f"{worst['flash_bwd_dq'][dname]:.3e}, dk/dv "
              f"{worst['flash_bwd_dkv'][dname]:.3e} [{card}]")
    no_valid = {name: 0.0 for name in FLASH_BWD_KERNELS}
    for d in fa.KERNEL_HEAD_DIMS:
        for name, e in _no_valid_key_case(fa, gen, h=4, d=d).items():
            no_valid[name] = max(no_valid[name], e)
        cases += 1
    print(f"  K6/K7 bf16 against f32 kernels, causal rows with no valid key, "
          f"every head dim: max_abs_err dq {no_valid['flash_bwd_dq']:.3e}, "
          f"dk/dv {no_valid['flash_bwd_dkv']:.3e} ok [{card}]")
    timed = {path: _time_attention(fa, path, card, gen)
             for path in TRAIN_SHAPES}
    entries = []
    for name in FLASH_BWD_KERNELS:
        lm = timed["LM"][name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "cloud_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": FLASH_BWD_REPLACES[name],
            "max_abs_err": worst[name]["bfloat16"],
            "max_abs_err_f32": worst[name]["float32"],
            "max_abs_err_no_valid_key": no_valid[name],
            **lm,
            "at_bert": timed["BERT"][name]})
    print(f"  flash: {cases} cases checked")
    return (entries, {path: timed[path]["flash_fwd"] for path in TRAIN_SHAPES},
            worst["flash_fwd"])


# ---------------------------------------------------------------------------
# Phases 4 and 5: ResNet-50 training
# ---------------------------------------------------------------------------


def run_steps(card, what, setup, per_step, items_per_step, unit, *,
              warmup, iters):
    """Chain ``warmup + iters`` steps of ``setup() -> (step, state, batch)``
    through ``chain_then_read_throughput``; check finite loss and grad
    norm and exactly ``per_step`` launches of each kernel per step.
    Returns the result (rates, ``{unit}_per_s``, peak memory, launches)
    and ``(step, state, batch)``."""
    import torch

    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.utils import benchmarking

    step, state, batch = setup()
    last = {}

    def tracked(st, b):
        st, metrics = step(st, b)
        last.update(metrics)
        return st, metrics

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    rate = benchmarking.chain_then_read_throughput(tracked, state, batch,
                                                   warmup=warmup, iters=iters)
    launches = dispatch.launch_counts(per_step)
    peak = torch.cuda.max_memory_allocated()
    steps = warmup + iters
    want = {k: n * steps for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} != {want} "
                             f"({steps} steps)")
    values = {k: float(v) for k, v in last.items()}
    if not all(np.isfinite(values[k]) for k in ("loss", "grad_norm")):
        raise AssertionError(f"{what}: non-finite metrics {values}")
    print(f"  {what}: {warmup} + {iters} steps, {rate:.3f} steps/s = "
          f"{rate * items_per_step:.1f} {unit}/s, {1e3 / rate:.2f} ms/step;"
          f" peak memory {peak / 2**30:.3f} GiB; final loss "
          f"{values['loss']:.4f}, grad_norm {values['grad_norm']:.4f}; "
          f"launches {launches} = per step {per_step} [{card}]")
    result = {"steps_per_s": rate, f"{unit}_per_s": rate * items_per_step,
              "ms_per_step": 1e3 / rate, "max_memory_allocated": peak,
              "final_loss": values["loss"],
              "final_grad_norm": values["grad_norm"], "launches": launches}
    return result, (step, state, batch)


def run_training(device, card, *, imagenet: bool, warmup: int, iters: int):
    """Train ResNet-50 through ``resnet_train_setup`` and
    ``run_steps``: finite metrics and the GroupNorm launches per step.
    Returns the result and ``(step, state, batch)``."""
    from cloud_tpu_torch.utils import benchmarking

    batch_size = IMAGENET_BATCH if imagenet else CIFAR_BATCH
    hw = 224 if imagenet else 32
    return run_steps(
        card, f"ResNet-50 {hw}x{hw} b{batch_size} bf16",
        lambda: benchmarking.resnet_train_setup(
            imagenet_shape=imagenet, batch_size=batch_size, device=device),
        GN_PER_STEP, batch_size, "images", warmup=warmup, iters=iters)


def check_train_parity(device, card):
    """One f32 step of ResNet-50 CIFAR at batch 8 on the card (through
    K1-K4) against the same step on the CPU from the same params and batch
    (TF32 off): loss and grad_norm within 1e-4 relative, every updated
    parameter within 1e-4 of max(1, max |p|) of its leaf."""
    import dataclasses

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import resnet
    from cloud_tpu_torch.training import optimizers, train

    cfg = dataclasses.replace(resnet.RESNET50_CIFAR, dtype=torch.float32)
    params = bridge.init_resnet(cfg, torch.Generator().manual_seed(3),
                                device="cpu")
    rng = np.random.default_rng(4)
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, 8))
    images = torch.from_numpy(
        rng.normal(size=(8, 32, 32, 3)).astype(np.float32))
    out = {}
    for dev in ("cpu", device):
        tx = optimizers.sgd(0.1, momentum=0.9)
        state = train.create_sharded_state(
            None, lambda _: bridge.map_leaves(params, torch.clone), tx,
            device=dev)
        step = train.make_train_step(
            lambda p, b: resnet.loss_fn(p, b, cfg, device=dev), tx)
        state, metrics = step(state, {"image": images.to(dev),
                                      "label": labels.to(dev)})
        out[str(dev)] = (state, {k: float(v) for k, v in metrics.items()})
    (cpu_state, cpu_m), (gpu_state, gpu_m) = out["cpu"], out[str(device)]
    errs = {}
    for key in ("loss", "grad_norm"):
        rel = abs(gpu_m[key] - cpu_m[key]) / abs(cpu_m[key])
        errs[key] = rel
        if not rel <= 1e-4:
            raise AssertionError(f"f32 step {key}: card {gpu_m[key]} vs CPU "
                                 f"{cpu_m[key]} (rel {rel:.2e})")
    worst = 0.0
    for a, b in zip(bridge.leaves(gpu_state.params),
                    bridge.leaves(cpu_state.params)):
        worst = max(worst, check_close("f32 step params", a.detach().cpu(),
                                       b.detach(), "float32", sums=True))
    errs["params_max_abs"] = worst
    print(f"  f32 step, ResNet-50 CIFAR b8, card vs CPU: loss "
          f"{gpu_m['loss']:.6f} vs {cpu_m['loss']:.6f}, grad_norm "
          f"{gpu_m['grad_norm']:.5f} vs {cpu_m['grad_norm']:.5f}, params "
          f"max_abs_err {worst:.3e} (tol 1e-4 x max(1, max|p|)) ok [{card}]")
    return errs


def _kernel_rows(prof):
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0 and evt.device_type == DeviceType.CUDA:
            rows.append((dev_us, evt.count, evt.key))
    if not rows:
        raise AssertionError("torch.profiler recorded no device time")
    return sorted(rows, reverse=True)


#: Substrings of the cuDNN and CUTLASS kernel names convolutions run as.
CONV_KEYS = ("conv", "xmma", "cudnn", "implicit", "dgrad", "wgrad", "fprop",
             "cutlass", "nchw", "nhwc")


def _is_gn(key: str) -> bool:
    return "gn_fwd_" in key or "gn_bwd_" in key


def _profiled_step(step, state, batch, *, record_shapes=False):
    """Two warm-up steps, the wall time of one unprofiled step (to the
    host read of its loss) and the host's time to enqueue it (the step
    itself never waits for the device), then one step under torch.profiler
    (CPU and CUDA activity).  Returns ``(wall_ms, enqueue_ms, prof)``."""
    import torch

    for _ in range(2):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    start = time.perf_counter()
    state, metrics = step(state, batch)
    enqueue_ms = (time.perf_counter() - start) * 1e3
    float(metrics["loss"])
    wall_ms = (time.perf_counter() - start) * 1e3

    def run():
        nonlocal state
        state, metrics = step(state, batch)
        float(metrics["loss"])

    prof, _ = profiled(run, cpu=True, record_shapes=record_shapes)
    return wall_ms, enqueue_ms, prof


def _profile_checked(step, state, batch, complaint, *, record_shapes=False):
    """:func:`_profiled_step` until ``complaint(rows)`` finds nothing
    wrong with its kernel rows: now and then a session loses a kernel
    record, so a step is profiled again, three sessions in all, before the
    last complaint is raised.  Returns ``(wall_ms, enqueue_ms, prof,
    rows)``."""
    for _ in range(3):
        wall_ms, enqueue_ms, prof = _profiled_step(
            step, state, batch, record_shapes=record_shapes)
        rows = _kernel_rows(prof)
        problem = complaint(rows)
        if problem is None:
            return wall_ms, enqueue_ms, prof, rows
    raise AssertionError(problem)


def profile_train_step(card, step, state, batch, *, gn_records=None):
    """Where one ResNet-50 training step's time goes: kernel rows of
    torch.profiler split into GroupNorm (K1-K4), convolution (cuDNN and
    CUTLASS kernels) and the rest, against the wall time of an unprofiled
    step; the host's busiest operators; and every copy of an activation
    (an ``aten::copy_`` or ``aten::contiguous`` of a four-dim tensor led
    by the batch that is not a conv weight: the explicit SAME pads and the
    image cast are expected, a layout copy is not)."""
    import torch

    from cloud_tpu_torch.bridge import leaves

    batch_size, hw = batch["image"].shape[:2]
    weights = {(k.shape[3], k.shape[2], k.shape[0], k.shape[1])
               for k in leaves(state.params) if k.dim() == 4}
    # A step launches 53 GroupNorm kernels forward and 2 x 53 backward (the
    # kernel and its sum over B) unless ``gn_records`` says otherwise.
    want = gn_records or 3 * sum(GN_PER_STEP[k]
                                 for k in ("gn_fwd", "gn_fwd_res"))

    def complaint(rows):
        got = sum(count for _, count, key in rows if _is_gn(key))
        return (None if got == want else
                f"the profiled step holds {got} GroupNorm kernel records, "
                f"not {want}")

    wall_ms, enqueue_ms, prof, rows = _profile_checked(
        step, state, batch, complaint, record_shapes=True)
    busy = sum(r[0] for r in rows) / 1e3
    gn = sum(r[0] for r in rows if _is_gn(r[2])) / 1e3
    conv = sum(r[0] for r in rows if not _is_gn(r[2]) and any(
        k in r[2].lower() for k in CONV_KEYS)) / 1e3
    print(f"  ResNet-50 {hw}x{hw} b{batch_size} step: wall {wall_ms:.3f} ms,"
          f" host enqueue {enqueue_ms:.3f} ms, device "
          f"kernels {busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}; "
          f"GroupNorm {gn:.3f} ms ({gn / busy:.3f} of device time), "
          f"convolution {conv:.3f} ms ({conv / busy:.3f}) [{card}]")
    for dev_us, count, key in rows[:20]:
        print(f"    {dev_us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CUDA),
                  reverse=True)
    print("  host: busiest operators by self CPU time")
    for cpu_us, count, key in host[:8]:
        print(f"    {cpu_us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")
    copies = []
    for evt in prof.key_averages(group_by_input_shape=True):
        if evt.key not in ("aten::copy_", "aten::contiguous"):
            continue
        shape = list(evt.input_shapes[0]) if evt.input_shapes else []
        if (len(shape) == 4 and shape[0] == batch_size
                and tuple(shape) not in weights):
            copies.append((evt.key, shape, evt.count))
    print(f"  activation copies in the step: {sum(c[2] for c in copies)}"
          + "".join(f"\n    {k} {s} x{n}" for k, s, n in copies))
    return {"step_wall_ms": wall_ms, "step_enqueue_ms": enqueue_ms,
            "step_device_busy_ms": busy,
            "step_idle_share": 1 - busy / wall_ms,
            "gn_ms": gn, "gn_share": gn / busy,
            "conv_ms": conv, "conv_share": conv / busy,
            "activation_copies": [[k, s, n] for k, s, n in copies]}


# ---------------------------------------------------------------------------
# Phases 6 and 7: transformer training (CloudLM SMALL, BERT-base)
# ---------------------------------------------------------------------------


def run_lm_training(device, card, *, fused_ce: bool, warmup: int,
                    iters: int):
    """CloudLM ``SMALL.scaled(tied_embeddings=True)`` at b4 x T1024, bf16
    compute on f32 master weights, remat "full", ``adamw(1e-4)`` with f32
    moments: one arm of the JAX package's fused-CE A/B."""
    from cloud_tpu_torch.utils import benchmarking

    arm = "fused_ce" if fused_ce else "plain CE"
    return run_steps(
        card, f"CloudLM SMALL b{LM_BATCH}xT{LM_SEQ} bf16, {arm}",
        lambda: benchmarking.lm_train_setup(
            batch_size=LM_BATCH, seq_len=LM_SEQ, fused_ce=fused_ce,
            device=device),
        LM_PER_STEP, LM_BATCH * LM_SEQ, "tokens", warmup=warmup,
        iters=iters)


def run_bert_training(device, card, *, warmup: int, iters: int):
    """BERT-base at b32 x T128, bf16 compute on f32 master weights,
    ``adamw(2e-5)`` with f32 moments, no dropout, no attention mask.
    Returns the result and ``(step, state, batch)``."""
    from cloud_tpu_torch.utils import benchmarking

    return run_steps(
        card, f"BERT-base b{BERT_BATCH}xT{BERT_SEQ} bf16",
        lambda: benchmarking.bert_train_setup(
            batch_size=BERT_BATCH, seq_len=BERT_SEQ, device=device),
        BERT_PER_STEP, BERT_BATCH * BERT_SEQ, "tokens", warmup=warmup,
        iters=iters)


def check_lm_grad_parity(device, card):
    """CloudLM SMALL at full width, 2 layers, f32, b2 x T256 (tied head,
    remat on): loss, grad_norm and every gradient on the card (through K5,
    K6 and K7) against the CPU from the same params and batch (TF32 off):
    loss and grad_norm within 1e-4 relative, each gradient leaf within
    1e-4 of max(1, max |g|).  Gradients, not parameters after an AdamW
    step: AdamW's first update is about lr * sign(g), so a gradient near
    zero that flips sign moves a parameter by 2 lr with no fault.  The
    optimizer is held on its own: one ``adamw(1e-4)`` update from the same
    params and the CPU's gradients on both devices, within 1e-6 of
    max(1, max |p|)."""
    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import transformer
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.training import optimizers, train

    cfg = transformer.SMALL.scaled(tied_embeddings=True, num_layers=2,
                                   dtype=torch.float32)
    params = bridge.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    tokens = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 256))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
    out = {}
    for dev in ("cpu", device):
        leaves = bridge.map_leaves(
            params, lambda t: t.to(dev).requires_grad_(True))
        dispatch.reset_launch_counts()
        loss, _ = transformer.loss_fn(
            leaves, {"tokens": batch["tokens"].to(dev)}, cfg, device=dev)
        grads = torch.autograd.grad(loss, bridge.leaves(leaves))
        out[str(dev)] = (float(loss.detach()),
                         float(train.global_norm(grads)),
                         [g.detach().cpu() for g in grads],
                         dispatch.launch_counts(TRAIN_ATTN_KERNELS))
    (cpu_loss, cpu_norm, cpu_g, _), (loss, norm, gpu_g, launches) = (
        out["cpu"], out[str(device)])
    want = {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    if launches != want:
        raise AssertionError(f"f32 parity: launches {launches} != {want}")
    errs = {}
    for key, a, b in (("loss", loss, cpu_loss), ("grad_norm", norm,
                                                 cpu_norm)):
        errs[key] = abs(a - b) / abs(b)
        if not errs[key] <= 1e-4:
            raise AssertionError(f"f32 parity {key}: card {a} vs CPU {b}")
    errs["grads_max_abs"] = max(
        check_close("f32 gradient", a, b, "float32", sums=True)
        for a, b in zip(gpu_g, cpu_g))
    updated = []
    for dev in ("cpu", device):
        tx = optimizers.adamw(1e-4, mu_dtype=None)
        p = [t.detach().to(dev).clone() for t in bridge.leaves(params)]
        tx.update_(p, [g.to(dev) for g in cpu_g], tx.init(p))
        updated.append([t.cpu() for t in p])
    errs["adamw_params_max_abs"] = 0.0
    for a, b in zip(updated[1], updated[0]):
        err = float((a - b).abs().max())
        if not err <= 1e-6 * max(1.0, float(b.abs().max())):
            raise AssertionError(f"adamw update on identical gradients: card"
                                 f" vs CPU max_abs_err {err:.3e}")
        errs["adamw_params_max_abs"] = max(errs["adamw_params_max_abs"], err)
    print(f"  f32 SMALL 2 layers b2xT256, card vs CPU: loss {loss:.6f} vs "
          f"{cpu_loss:.6f}, grad_norm {norm:.5f} vs {cpu_norm:.5f}, "
          f"gradients max_abs_err {errs['grads_max_abs']:.3e} (tol 1e-4 x "
          f"max(1, max|g|)); adamw on identical gradients max_abs_err "
          f"{errs['adamw_params_max_abs']:.3e}; launches {launches} ok "
          f"[{card}]")
    return errs


#: Substrings of the cuBLAS/cuBLASLt/CUTLASS kernel names matrix products
#: run as (``nvjet`` is cuBLASLt's Hopper GEMM family).
MATMUL_KEYS = ("gemm", "cutlass", "xmma", "matmul", "nvjet", "cublas")
#: Substring of each attention kernel's symbol in the profiler's rows
#: (both instantiations: ``flash_fwd_kernel`` and ``flash_fwd_kernel_tc``).
ATTN_ROWS = {"flash_fwd": "flash_fwd_kernel",
             "flash_bwd_dq": "flash_bwd_dq_kernel",
             "flash_bwd_dkv": "flash_bwd_dkv_kernel"}


def profile_attn_step(card, what, per_step, step, state, batch):
    """Where one transformer training step's device time goes:
    torch.profiler's kernel rows split into K5, K6, K7, matrix products
    and the rest, and the idle share against the wall time of an
    unprofiled step.  Fails if, in three profiled steps, the rows of K5,
    K6 or K7 never hold exactly the step's ``per_step`` launches with
    nonzero time: a kernel whose symbol no longer matches ``ATTN_ROWS``
    would move its time into "rest" unseen."""
    def complaint(rows):
        for name, key in ATTN_ROWS.items():
            mine = [r for r in rows if key in r[2]]
            seen, ms = sum(r[1] for r in mine), sum(r[0] for r in mine) / 1e3
            if seen != per_step[name] or not ms > 0:
                return (f"{what}: profiler rows matching {key!r} hold "
                        f"{seen} launches and {ms} ms; the step launched "
                        f"{per_step[name]}")
        return None

    wall_ms, enqueue_ms, _, rows = _profile_checked(step, state, batch,
                                                    complaint)
    busy = sum(r[0] for r in rows) / 1e3
    split = {name: sum(r[0] for r in rows if key in r[2]) / 1e3
             for name, key in ATTN_ROWS.items()}
    split["matmul"] = sum(
        r[0] for r in rows if not any(k in r[2] for k in ATTN_ROWS.values())
        and any(k in r[2].lower() for k in MATMUL_KEYS)) / 1e3
    split["rest"] = busy - sum(split.values())
    print(f"  {what} step: wall {wall_ms:.3f} ms, host enqueue "
          f"{enqueue_ms:.3f} ms, device "
          f"kernels {busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}; "
          + ", ".join(f"{k} {v:.3f} ms ({v / busy:.3f})"
                      for k, v in split.items()) + f" [{card}]")
    for dev_us, count, key in rows[:15]:
        print(f"    {dev_us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")
    return {"step_wall_ms": wall_ms, "step_enqueue_ms": enqueue_ms,
            "step_device_busy_ms": busy,
            "step_idle_share": 1 - busy / wall_ms,
            "device_ms": split,
            "device_share": {k: v / busy for k, v in split.items()}}


# ---------------------------------------------------------------------------
# Phase 3: the engine at full width
# ---------------------------------------------------------------------------


def _requests(vocab: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    lengths = [5, 20, 31, 48, 90, 128, 200, 300, 400, 512]
    out = []
    for i in range(n):
        length = lengths[i % len(lengths)]
        budget = int(rng.choice([8, 24, 40, 64]))
        out.append((rng.integers(1, vocab, length).astype(np.int32), budget))
    return out


def run_engine(device, card):
    import torch

    from cloud_tpu_torch.models import generation
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.serving import ServeConfig, ServingEngine
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    cfg, params, _, _ = decode_setup(device=device, seed=0)
    serve = ServeConfig(max_new_tokens=MAX_NEW, prompt_buckets=BUCKETS,
                        num_slots=NUM_SLOTS, chunk_tokens=CHUNK)
    requests = _requests(cfg.vocab_size, 16, seed=1)
    with ServingEngine(params, cfg, serve, device=device) as engine:
        # Warm-up (allocator, cuBLAS handles): one short request.
        engine.submit(requests[0][0], max_new_tokens=4).result(timeout=300)
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        stats0 = engine.stats()
        start = time.perf_counter()
        futures = []
        for prompt, budget in requests:
            futures.append(engine.submit(prompt, max_new_tokens=budget))
            time.sleep(0.002)  # staggered arrivals
        results = [f.result(timeout=600) for f in futures]
        wall = time.perf_counter() - start
        launches = dispatch.launch_counts(SERVING_KERNELS)
        stats = engine.stats()
    for (prompt, budget), res in zip(requests, results):
        if res.tokens.shape != (budget,) or res.num_generated != budget:
            raise AssertionError(f"bad result shape {res.tokens.shape} / "
                                 f"{res.num_generated} for budget {budget}")
        if res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
            raise AssertionError("token id outside the vocabulary")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"serving path (count {count})")
    tokens = sum(r.num_generated for r in results)
    lat = np.array([r.latency_seconds for r in results])
    chunks = stats["chunks"] - stats0["chunks"]
    chunk_s = stats["chunk_seconds"] - stats0["chunk_seconds"]
    step_ms = chunk_s / max(chunks * CHUNK, 1) * 1e3
    print(f"  engine SMALL bf16: 16/16 requests, {tokens} tokens in "
          f"{wall:.3f} s = {tokens / wall:.1f} tok/s; latency p50 "
          f"{np.percentile(lat, 50):.3f} s p99 {np.percentile(lat, 99):.3f} s;"
          f" decode step {step_ms:.3f} ms (host wall, {chunks} chunks); "
          f"slot occupancy {stats['mean_slot_occupancy']:.3f}; launches "
          f"{launches} [{card}]")

    # Greedy parity with the port's own generate() on the card.  f32 keeps
    # it exact: in bf16 the engine's 8-row decode matmuls and generate()'s
    # 1-row ones round differently, which can flip near-tied argmaxes.
    cfg32 = cfg.scaled(dtype=torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    picks = [requests[i] for i in (0, 3, 6, 9)]
    with ServingEngine(params, cfg32, serve, device=device) as engine:
        futures = [engine.submit(p, max_new_tokens=b) for p, b in picks]
        served = [f.result(timeout=600) for f in futures]
    for (prompt, budget), res in zip(picks, served):
        want = generation.generate(
            params, torch.from_numpy(prompt)[None],
            torch.tensor([len(prompt)]), cfg32, max_new_tokens=budget,
            device=device)["tokens"][0].cpu().numpy()
        if not np.array_equal(want, res.tokens):
            first = int(np.flatnonzero(want != res.tokens)[0])
            raise AssertionError(f"engine != generate() for a {len(prompt)}-"
                                 f"token prompt at token {first}")
    print(f"  engine == generate(): 4/4 requests token-identical (SMALL f32)")
    return {"tokens_per_s": tokens / wall,
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p99_s": float(np.percentile(lat, 99)),
            "decode_step_ms": step_ms, "launches": launches}


#: Substrings of K8's two kernels in the profiler's rows: the split pass
#: (both instantiations, K8 and K8q) and the combine.
PAGED_ROWS_KEYS = ("paged_attention_kernel", "paged_attention_combine")


def profile_decode_chunk(device, card):
    """Where a decode step's time goes: one chunk of the slot grid at the
    engine's shape (8 slots all active, bf16 SMALL), under torch.profiler.
    Fails if the profiler sees no device time, or if in three profiled
    chunks the rows of K8's split pass or of its combine never hold one
    launch a layer a step."""
    import torch

    from cloud_tpu_torch.models import generation
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    cfg, params, _, _ = decode_setup(device=device, seed=0)
    params = generation.prepare_params(params, cfg)
    s = BUCKETS[-1] + MAX_NEW
    cache = generation.init_slot_cache(cfg, NUM_SLOTS, s, device=device)
    state = generation.init_slot_state(cfg, NUM_SLOTS, device=device)
    rng = np.random.default_rng(2)
    for slot in range(NUM_SLOTS):
        prompt = torch.from_numpy(
            rng.integers(1, cfg.vocab_size, (1, 128)).astype(np.int32))
        cache, state, _ = generation.insert_slot_program(
            params, cache, state, prompt, 128, slot, MAX_NEW, cfg)
    table = torch.full((NUM_SLOTS, -(-s // 16)), -1, dtype=torch.int32,
                       device=device)

    def chunk():
        nonlocal cache, state
        cache, state, toks, _ = generation.decode_chunk_program(
            params, cache, state, cfg, chunk_size=CHUNK, block_table=table)
        return toks

    chunk()
    torch.cuda.synchronize()
    start = time.perf_counter()  # wall time without the profiler's cost
    chunk().cpu()
    wall_ms = (time.perf_counter() - start) * 1e3
    # Kernel rows only: an operator row carries its kernels' time again.
    # A session that lost a record of K8 is run again (the next chunk),
    # three sessions in all.
    for attempt in range(3):
        prof, rows = profiled(lambda: chunk().cpu(), cpu=True)
        seen = {key: sum(r[1] for r in rows if key in r[2])
                for key in PAGED_ROWS_KEYS}
        if all(n == cfg.num_layers * CHUNK for n in seen.values()):
            break
        if attempt == 2:
            raise AssertionError(
                f"decode chunk: profiler rows of {PAGED_ROWS_KEYS} hold "
                f"{seen} launches; the chunk launched "
                f"{cfg.num_layers * CHUNK} of each")
    busy_ms = sum(r[0] for r in rows) / 1e3
    paged_ms = {key: sum(r[0] for r in rows if key in r[2]) / 1e3
                for key in PAGED_ROWS_KEYS}
    print(f"  decode chunk ({CHUNK} steps, {NUM_SLOTS} active slots): wall "
          f"{wall_ms:.3f} ms, device kernels {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; K8 split {paged_ms[PAGED_ROWS_KEYS[0]]:.3f}"
          f" ms, combine {paged_ms[PAGED_ROWS_KEYS[1]]:.3f} ms [{card}]")
    for dev_us, count, key in rows[:8]:
        print(f"    {dev_us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")
    return {"chunk_wall_ms": wall_ms, "chunk_device_busy_ms": busy_ms,
            "chunk_idle_share": 1 - busy_ms / wall_ms,
            "chunk_paged_device_ms": paged_ms}


# ---------------------------------------------------------------------------
# Phase 3q/3d/3e: the quantized inference path (int8 weights, int8 KV cache)
# ---------------------------------------------------------------------------

QUANT_SERVING_KERNELS = ("flash_fwd", "paged_attention",
                         "paged_attention_int8")
#: Smallest top-2 logit gap along the quantized greedy path for a parity
#: prompt: an ulp between an 8-row and a 1-row product can flip one int8
#: rounding of the cache, which moves logits by far more than 1e-3.
QUANT_TIE_GAP = 1e-2
QUANT_PARITY_BUDGET = 16
DECODE_AB = {"batch": 4, "prompt": 128, "new": 128, "warmup": 1, "iters": 2}
BEAM = {"batch": 4, "prompt": 128, "beams": 4, "new": 32}


def _grid_bytes(cache) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in cache.values())


def _quantized_greedy_gaps(generation, params, prompt, budget, cfg, device):
    """Top-2 logit gap at each greedy step of ``generate(kv_quant=True)``,
    read off its own path (``_prefill`` and ``_decode_step`` on an int8
    cache), and the tokens of that path."""
    import torch

    tokens = torch.from_numpy(prompt)[None].to(device)
    lens = torch.tensor([len(prompt)], dtype=torch.int32, device=device)
    cache, logits = generation._prefill(params, tokens, lens, cfg,
                                        len(prompt) + budget, kv_quant=True)
    gaps, out = [], []
    cur_len = lens
    for step in range(budget):
        top2 = torch.topk(logits[0], 2).values
        gaps.append(float(top2[0] - top2[1]))
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(int(token[0]))
        if step + 1 < budget:
            cache, logits = generation._decode_step(params, cache, token,
                                                    cur_len, cfg)
            cur_len = cur_len + 1
    return gaps, out


def run_engine_quant(device, card):
    """16 staggered requests at SMALL width with int8 weights and an int8
    grid; then f32 greedy parity of the engine with the port's quantized
    ``generate`` on four prompts tie-free under quantization."""
    import torch

    from cloud_tpu_torch.models import generation, quantization
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.serving import ServeConfig, ServingEngine
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    cfg, params, _, _ = decode_setup(device=device, seed=0)
    qparams = quantization.quantize_params(params)
    serve = ServeConfig(max_new_tokens=MAX_NEW, prompt_buckets=BUCKETS,
                        num_slots=NUM_SLOTS, chunk_tokens=CHUNK,
                        kv_quant=True)
    requests = _requests(cfg.vocab_size, 16, seed=1)
    with ServingEngine(qparams, cfg, serve, device=device) as engine:
        engine.submit(requests[0][0], max_new_tokens=4).result(timeout=300)
        torch.cuda.synchronize()
        grid_bytes = _grid_bytes(engine._grid_cache)
        dispatch.reset_launch_counts()
        stats0 = engine.stats()
        start = time.perf_counter()
        futures = []
        for prompt, budget in requests:
            futures.append(engine.submit(prompt, max_new_tokens=budget))
            time.sleep(0.002)  # staggered arrivals
        results = [f.result(timeout=600) for f in futures]
        wall = time.perf_counter() - start
        launches = dispatch.launch_counts(QUANT_SERVING_KERNELS)
        stats = engine.stats()
    for (prompt, budget), res in zip(requests, results):
        if res.tokens.shape != (budget,) or res.num_generated != budget:
            raise AssertionError(f"bad result shape {res.tokens.shape} / "
                                 f"{res.num_generated} for budget {budget}")
        if res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
            raise AssertionError("token id outside the vocabulary")
    chunks = stats["chunks"] - stats0["chunks"]
    inserts = stats["inserts"] - stats0["inserts"]
    layers_n = cfg.num_layers
    want = {"flash_fwd": layers_n * inserts, "paged_attention": 0,
            "paged_attention_int8": layers_n * CHUNK * chunks}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want} "
                             f"({inserts} inserts, {chunks} chunks)")
    bf16_grid = 2 * layers_n * NUM_SLOTS * (BUCKETS[-1] + MAX_NEW) * \
        HEADS * HEAD_DIM * 2
    tokens = sum(r.num_generated for r in results)
    lat = np.array([r.latency_seconds for r in results])
    chunk_s = stats["chunk_seconds"] - stats0["chunk_seconds"]
    step_ms = chunk_s / max(chunks * CHUNK, 1) * 1e3
    print(f"  engine SMALL int8 weights + kv_quant: 16/16 requests, {tokens} "
          f"tokens in {wall:.3f} s = {tokens / wall:.1f} tok/s; latency p50 "
          f"{np.percentile(lat, 50):.3f} s p99 {np.percentile(lat, 99):.3f} s;"
          f" decode step {step_ms:.3f} ms (host wall, {chunks} chunks); "
          f"launches {launches} = 12 x {inserts} inserts (K5), "
          f"12 x {CHUNK} x {chunks} chunks (K8q); grid {grid_bytes} bytes "
          f"against {bf16_grid} for bf16 ({grid_bytes / bf16_grid:.4f}) "
          f"[{card}]")

    # Greedy parity on the card in f32, on prompts whose quantized greedy
    # path keeps a top-2 gap of QUANT_TIE_GAP at every step.
    cfg32 = cfg.scaled(dtype=torch.float32)
    qparams32 = generation.prepare_params(qparams, cfg32)
    picks = []
    with torch.no_grad():
        for prompt, budget in _requests(cfg.vocab_size, 40, seed=3):
            budget = min(budget, QUANT_PARITY_BUDGET)
            gaps, path = _quantized_greedy_gaps(generation, qparams32, prompt,
                                                budget, cfg32, device)
            if min(gaps) >= QUANT_TIE_GAP:
                picks.append((prompt, budget, gaps, path))
            if len(picks) == 4:
                break
    if len(picks) < 4:
        raise AssertionError(f"only {len(picks)} of 40 prompts are tie-free "
                             f"at {QUANT_TIE_GAP} under quantization")
    with ServingEngine(qparams, cfg32, serve, device=device) as engine:
        futures = [engine.submit(p, max_new_tokens=b) for p, b, _, _ in picks]
        served = [f.result(timeout=600) for f in futures]
    for (prompt, budget, gaps, path), res in zip(picks, served):
        want_toks = generation.generate(
            qparams, torch.from_numpy(prompt)[None],
            torch.tensor([len(prompt)]), cfg32, max_new_tokens=budget,
            kv_quant=True, device=device)["tokens"][0].cpu().numpy()
        for name, other in (("engine", res.tokens), ("gap path", path)):
            if not np.array_equal(want_toks, other):
                step = int(np.flatnonzero(want_toks != np.asarray(other))[0])
                raise AssertionError(
                    f"{name} != generate(kv_quant=True) for a {len(prompt)}-"
                    f"token prompt at step {step} (top-2 gap there "
                    f"{gaps[step]:.4g})")
    print(f"  engine == generate(kv_quant=True): 4/4 requests "
          f"token-identical (SMALL f32, int8 weights, budgets "
          f"{[b for _, b, _, _ in picks]}, smallest gap "
          f"{min(min(g) for _, _, g, _ in picks):.4g})")
    return {"tokens_per_s": tokens / wall,
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p99_s": float(np.percentile(lat, 99)),
            "decode_step_ms": step_ms, "grid_bytes": grid_bytes,
            "bf16_grid_bytes": bf16_grid, "launches": launches}


def run_decode_ab(device, card):
    """``bench_daemon.py``'s decode_quant_ab on the card: greedy
    ``generate`` at SMALL b4, prompt 128, 128 new tokens, with bf16
    weights, int8 weights, and int8 weights plus an int8 KV cache."""
    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import quantization
    from cloud_tpu_torch.utils.benchmarking import (
        decode_setup,
        decode_tokens_per_sec,
    )

    cfg, params, prompts, lens = decode_setup(
        batch_size=DECODE_AB["batch"], prompt_len=DECODE_AB["prompt"],
        device=device, seed=0)
    qparams = quantization.quantize_params(params)
    variants = {
        "bf16": (bridge.map_leaves(params, lambda w: w.to(torch.bfloat16)),
                 False),
        "int8": (qparams, False),
        "int8_kv": (qparams, True),
    }
    out = {}
    for name, (p, kv_quant) in variants.items():
        rate = decode_tokens_per_sec(
            p, cfg, prompts, lens, max_new_tokens=DECODE_AB["new"],
            warmup=DECODE_AB["warmup"], iters=DECODE_AB["iters"],
            kv_quant=kv_quant, device=device)
        out[name] = {"tokens_per_sec": rate,
                     "param_bytes": quantization.param_bytes(p)}
        print(f"  decode A/B {name}: {rate:.1f} tokens/s, param_bytes "
              f"{out[name]['param_bytes']} (SMALL b{DECODE_AB['batch']} "
              f"prompt {DECODE_AB['prompt']} new {DECODE_AB['new']}, "
              f"{DECODE_AB['warmup']} + {DECODE_AB['iters']} calls) [{card}]")
    return out


def run_beam_search(device, card):
    """``beam_search`` with int8 weights and an int8 cache at SMALL b4,
    prompt 128, 4 beams, 32 new tokens: K5 once per layer, K8q once per
    layer and step, finite scores."""
    import torch

    from cloud_tpu_torch.models import generation, quantization
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    cfg, params, prompts, lens = decode_setup(
        batch_size=BEAM["batch"], prompt_len=BEAM["prompt"], device=device,
        seed=0)
    qparams = quantization.quantize_params(params)

    def run():
        return generation.beam_search(
            qparams, prompts, lens, cfg, num_beams=BEAM["beams"],
            max_new_tokens=BEAM["new"], kv_quant=True, device=device)

    run()
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    start = time.perf_counter()
    out = run()
    scores = out["scores"].cpu()
    wall = time.perf_counter() - start
    launches = dispatch.launch_counts(QUANT_SERVING_KERNELS)
    want = {"flash_fwd": cfg.num_layers, "paged_attention": 0,
            "paged_attention_int8": cfg.num_layers * (BEAM["new"] - 1)}
    if launches != want:
        raise AssertionError(f"beam launches {launches}, expected {want}")
    if not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"non-finite beam scores {scores.tolist()}")
    toks = out["tokens"].cpu()
    if out["tokens"].shape != (BEAM["batch"], BEAM["new"]) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError("beam tokens outside the vocabulary or shape")
    print(f"  beam_search SMALL int8 + kv_quant b{BEAM['batch']} x "
          f"{BEAM['beams']} beams, {BEAM['new']} new: {wall:.3f} s, scores "
          f"{[round(float(x), 4) for x in scores]}, launches {launches} "
          f"[{card}]")
    return {"seconds": wall, "scores": scores.tolist(), "launches": launches}


#: Kernels whose bf16 instantiations must run on the tensor cores, by
#: library.
TENSOR_CORE_KERNELS = {"flash_fwd": ["flash_fwd_kernel_tc"],
                       "flash_bwd": ["flash_bwd_dq_kernel_tc",
                                     "flash_bwd_dkv_kernel_tc"]}


def tensor_core_sass(dispatch):
    """Tensor-core instructions (HMMA, HGMMA) per kernel in the built
    flash libraries, read from ``cuobjdump -sass``; raises unless every
    instantiation of each ``TENSOR_CORE_KERNELS`` symbol has some.
    Returns {symbol: count} for the kernels of those libraries."""
    tool = os.path.join(os.path.dirname(dispatch.nvcc_path()), "cuobjdump")
    counts = {}
    for lib, symbols in TENSOR_CORE_KERNELS.items():
        sass = subprocess.run([tool, "-sass", dispatch.library_path(lib)],
                              capture_output=True, text=True, check=True)
        func = None
        for line in sass.stdout.splitlines():
            if "Function :" in line:
                func = line.split("Function :")[1].strip()
                counts[func] = 0
            elif func is not None and ("HMMA" in line or "HGMMA" in line):
                counts[func] += 1
        for symbol in symbols:
            mine = {f: n for f, n in counts.items() if symbol in f}
            if not mine or not all(mine.values()):
                raise AssertionError(f"{lib}: {symbol} has no tensor-core "
                                     f"instructions in its SASS: {mine}")
    print("  SASS tensor-core instructions per kernel: " + ", ".join(
        f"{f} {n}" for f, n in sorted(counts.items())))
    return counts


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        return fail(f"torch is not installed: {exc}")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this check runs on the card only")
    try:
        from cloud_tpu_torch.ops import dispatch
    except ImportError as exc:
        return fail(f"run from the root of a checkout ({exc})")

    # Phase 1: the card, then the build.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        return fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        start = time.perf_counter()
        per_lib = dispatch.build_all()
        build_s = time.perf_counter() - start
    except Exception as exc:  # noqa: BLE001 — reported, then exit nonzero
        return fail(f"kernel build: {exc}")
    print(f"phase 1: built {sorted(per_lib)} in {build_s:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in per_lib.items())})")
    for name, log in dispatch.build_logs.items():
        regs = [int(w) for line in log.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt.startswith("registers")]
        spills = sum("0 bytes spill stores" not in line
                     for line in log.splitlines() if "spill stores" in line)
        print(f"  ptxas {name}: {len(regs)} instantiations, registers "
              f"{min(regs, default=0)}..{max(regs, default=0)}, "
              f"{spills} with spills")
    try:
        sass = tensor_core_sass(dispatch)
    except Exception as exc:  # noqa: BLE001
        return fail(f"SASS check: {exc}")

    # f32 convolutions and matmuls in full f32 (the parity checks need it).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = [
        ("phase 2: K5, K8 and K8q against their plain versions",
         "kernel check",
         lambda: [check_flash(device, card), check_paged(device, card),
                  check_paged_int8(device, card)],
         True),
        ("phase 2b: K1-K4 (GroupNorm) against their plain versions",
         "group_norm check", lambda: check_group_norm(device, card), False),
        ("phase 2c: K5 and K6/K7 (flash backward) against their plain "
         "versions; K5, K6, K7 timed at the training shapes",
         "flash_bwd check",
         lambda: check_flash_bwd(device, card), False),
        ("phase 3: ServingEngine, CloudLM SMALL, 16 requests", "engine",
         lambda: run_engine(device, card), False),
        ("phase 3b: one decode chunk under torch.profiler",
         "decode breakdown", lambda: profile_decode_chunk(device, card),
         True),
        ("phase 3q: ServingEngine, CloudLM SMALL, int8 weights and "
         "kv_quant, 16 requests", "quantized engine",
         lambda: run_engine_quant(device, card), True),
        ("phase 3d: decode A/B, bf16 / int8 / int8_kv weights",
         "decode A/B", lambda: run_decode_ab(device, card), True),
        ("phase 3e: beam_search, int8 weights and kv_quant", "beam search",
         lambda: run_beam_search(device, card), True),
        ("phase 4: train ResNet-50 CIFAR b256 bf16, 3 + 20 steps",
         "CIFAR training", lambda: run_training(
             device, card, imagenet=False, warmup=3, iters=20), False),
        ("phase 4b: one f32 step, card against CPU", "f32 step parity",
         lambda: check_train_parity(device, card), False),
    ]
    results = {}
    for title, what, fn, no_grad in phases:
        print(title)
        try:
            if no_grad:
                with torch.no_grad():
                    results[what] = fn()
            else:
                results[what] = fn()
        except Exception as exc:  # noqa: BLE001 — reported, exit nonzero
            return fail(f"{what}: {exc!r}")
    cifar, cifar_run = results.pop("CIFAR training")
    try:
        print("phase 4c: one ResNet-50 CIFAR step under torch.profiler")
        cifar.update(profile_train_step(card, *cifar_run))
        del cifar_run
        torch.cuda.empty_cache()
        print("phase 5: train ResNet-50 224 b128 bf16, 3 + 5 steps, then "
              "one step under torch.profiler")
        at_224, run_224 = run_training(device, card, imagenet=True,
                                       warmup=3, iters=5)
        at_224.update(profile_train_step(card, *run_224))
        del run_224
        torch.cuda.empty_cache()
    except Exception as exc:  # noqa: BLE001
        return fail(f"ResNet training: {exc!r}")
    try:
        print(f"phase 6: train CloudLM SMALL b{LM_BATCH}xT{LM_SEQ} bf16, "
              f"plain CE, 3 + 10 steps")
        lm, lm_run = run_lm_training(device, card, fused_ce=False, warmup=3,
                                     iters=10)
        print("phase 6c: one LM step (plain CE) under torch.profiler")
        lm.update(profile_attn_step(card, f"LM b{LM_BATCH}xT{LM_SEQ}",
                                    LM_PER_STEP, *lm_run))
        del lm_run
        torch.cuda.empty_cache()
        print("phase 6 (A/B): the same with fused_ce, 3 + 5 steps")
        lm_fused, _ = run_lm_training(device, card, fused_ce=True, warmup=3,
                                      iters=5)
        torch.cuda.empty_cache()
        print(f"  fused-CE A/B: plain {lm['steps_per_s']:.3f} steps/s, "
              f"{lm['max_memory_allocated'] / 2**30:.3f} GiB; fused_ce "
              f"{lm_fused['steps_per_s']:.3f} steps/s, "
              f"{lm_fused['max_memory_allocated'] / 2**30:.3f} GiB [{card}]")
        print("phase 6b: f32 gradients of SMALL (2 layers), card against CPU")
        lm_parity = check_lm_grad_parity(device, card)
        print(f"phase 7: train BERT-base b{BERT_BATCH}xT{BERT_SEQ} bf16, "
              f"3 + 10 steps, then one step under torch.profiler")
        bert_run, bert_steps = run_bert_training(device, card, warmup=3,
                                                 iters=10)
        bert_run.update(profile_attn_step(
            card, f"BERT b{BERT_BATCH}xT{BERT_SEQ}", BERT_PER_STEP,
            *bert_steps))
        del bert_steps
    except Exception as exc:  # noqa: BLE001
        return fail(f"transformer training: {exc!r}")

    engine = results["engine"]
    engine.update(results["decode breakdown"])
    flash_bwd, k5_training, k5_worst = results["flash_bwd check"]
    kernels = (results["kernel check"] + flash_bwd
               + results["group_norm check"])
    k5 = next(e for e in kernels if e["name"] == "flash_fwd")
    k5["max_abs_err"] = max(k5["max_abs_err"], k5_worst["bfloat16"])
    k5["max_abs_err_f32"] = max(k5["max_abs_err_f32"], k5_worst["float32"])
    engine_q = results["quantized engine"]
    for entry in kernels:
        phase = (engine_q if entry["name"] == "paged_attention_int8"
                 else engine if entry["name"] in SERVING_KERNELS
                 else lm if entry["name"] in FLASH_BWD_KERNELS else cifar)
        entry["launches"] = phase["launches"][entry["name"]]
    k8q = next(e for e in kernels if e["name"] == "paged_attention_int8")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({
        "kernels": [{k: e[k] for k in keys} for e in kernels],
        "card": card,
        "shapes": {e["name"]: e["shape"] for e in kernels},
        "max_abs_err_f32": {e["name"]: e["max_abs_err_f32"] for e in kernels},
        "group_norm_at_224": {e["name"]: e["at_224"] for e in kernels
                              if "at_224" in e},
        "group_norm_224_step": {e["name"]: e["step_224"] for e in kernels
                                if "step_224" in e},
        "group_norm_224_shapes": {e["name"]: e["at_224_shapes"]
                                  for e in kernels if "at_224_shapes" in e},
        "device_ms": {e["name"]: e["device_ms"] for e in kernels
                      if "device_ms" in e},
        "library_device_ms": {e["name"]: e["library_device_ms"]
                              for e in kernels if "library_device_ms" in e},
        "paged_attention_int8_bf16_k8_ms": {
            "S=576": k8q["bf16_k8_ms"], "S=4096": k8q["at_4096"]["bf16_k8_ms"]},
        "paged_attention_int8_bf16_k8_device_ms": {
            "S=576": k8q["bf16_k8_device_ms"],
            "S=4096": k8q["at_4096"]["bf16_k8_device_ms"]},
        "paged_attention_int8_at_4096": k8q["at_4096"],
        "engine": {k: v for k, v in engine.items() if k != "launches"},
        "engine_int8_kv_quant": engine_q,
        "decode_quant_ab": results["decode A/B"],
        "beam_search_int8_kv_quant": results["beam search"],
        "resnet50_cifar_b256": {k: v for k, v in cifar.items()
                                if k != "launches"},
        "resnet50_224_b128": {k: v for k, v in at_224.items()
                              if k != "launches"},
        "f32_step_parity": results["f32 step parity"],
        "flash_bwd_at_bert": {e["name"]: e["at_bert"] for e in flash_bwd},
        "flash_fwd_at_training": k5_training,
        "lm_b4xT1024": {"plain": lm, "fused_ce": lm_fused},
        "lm_f32_grad_parity": lm_parity,
        "bert_base_b32xT128": bert_run,
        "tensor_core_sass": sass}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
