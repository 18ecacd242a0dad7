#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one CUDA card, ``nvcc``
and ``nvidia-smi``.  It imports only ``cloud_tpu_torch`` (never JAX) and:

1. prints the card's name and power limit, then builds every CUDA kernel
   from ``cloud_tpu_torch/ops/csrc`` (one ``nvcc`` per source, in
   parallel) and prints the build time;
2. holds each kernel against its plain PyTorch version on the card at the
   serving path's shapes (f32 within 1e-4 absolute, bf16 within 2e-2),
   and times the kernel, the plain version and one PyTorch library call
   computing the same function (a yardstick only: the port never calls
   it);
3. serves 16 staggered requests of mixed lengths through
   ``ServingEngine`` with CloudLM SMALL in bf16 (random weights from a
   seed), checks that every request resolves with valid tokens and that
   the main path launched both kernels, and checks greedy parity with the
   port's own ``generate()`` at SMALL width in f32; then times one
   decode chunk and splits its device time by kernel (torch.profiler);
4. prints one JSON line describing every kernel, then, as its last line,
   ``{"ok": true, "device": {...}}``.

Any failed phase ends the run with a nonzero exit and no result line.
Without a CUDA card, or without the rest of the repository beside it, it
exits nonzero before doing any work.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

#: Published H100 SXM peaks (NVIDIA data sheet) for the bound column.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

#: The serving path's shapes: bench.py's churn probe on CloudLM SMALL.
NUM_SLOTS, MAX_NEW, CHUNK = 8, 64, 8
BUCKETS = (32, 128, 512)
HEADS, HEAD_DIM = 12, 64


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


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(device, card):
    """K5 at SMALL's H=12, D=64 for every prompt bucket and a ragged T."""
    import torch
    import torch.nn.functional as F

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
                err = max(max_err(out, ref_out), max_err(lse, ref_lse))
                ok = err <= TOL[name] and bool(torch.isfinite(out).all())
                print(f"  K5 flash_fwd {name} T={t} mask={masked}: "
                      f"max_abs_err={err:.3e} (tol {TOL[name]:g}) "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash_fwd {name} T={t} mask={masked}"
                                         f" err {err}")
                worst[name] = max(worst[name], err)
                if name == "bfloat16" and t == 128 and masked:
                    report = (q, k, v, mask)
    # Timing at the insert shape of the middle bucket (bf16, masked).
    q, k, v, mask = report
    t = q.shape[1]
    kernel = time_ms(lambda: fa._flash_kernel(q, k, v, causal=True,
                                              mask=mask))
    plain = time_ms(lambda: fa._reference_with_lse(q, k, v, causal=True,
                                                   mask=mask))
    allowed = (torch.ones((t, t), dtype=torch.bool, device=device).tril()
               & (mask[:, None, None, :] != 0))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=allowed))
    elems = q.numel()
    nbytes = 4 * elems * 2 + mask.numel() * 4 + HEADS * t * 4
    flops = 4 * HEADS * HEAD_DIM * t * (t + 1) / 2  # causal half, QK and PV
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    print(f"  K5 flash_fwd bf16 B=1 T={t} H={HEADS} D={HEAD_DIM}: kernel "
          f"{kernel:.4f} ms, plain {plain:.4f} ms, sdpa {library:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}) [{card}]")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "cloud_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "cloud_tpu/ops/flash_attention.py:109",
            "max_abs_err": worst["bfloat16"], "max_abs_err_f32": worst["float32"],
            "ms": kernel, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library,
            "shape": f"B=1 T={t} H={HEADS} D={HEAD_DIM} bf16 masked"}


def _paged_inputs(device, dtype, tq, gen, *, pool: bool):
    import torch

    s = BUCKETS[-1] + MAX_NEW
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


def check_paged(device, card):
    """K8 for Tq in {1, 4} with a pool and a mixed table, and at the
    engine's decode shape (8 slots, S=576, table of all -1)."""
    import torch
    import torch.nn.functional as F

    from cloud_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device=device).manual_seed(8)
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for tq in (1, 4):
            for pool in (True, False):
                slot, pool_l, table, cur_len = _paged_inputs(
                    device, dtype, tq, gen, pool=pool)
                q = torch.randn((NUM_SLOTS, tq, HEADS, HEAD_DIM),
                                generator=gen, device=device).to(dtype)
                out = pa._paged_kernel(q, slot, cur_len, pool_l, table)
                ref = pa._reference(q, slot, cur_len, pool_l, table)
                torch.cuda.synchronize()
                err = max_err(out, ref)
                ok = err <= TOL[name] and bool(torch.isfinite(out).all())
                print(f"  K8 paged_attention {name} Tq={tq} pool={pool}: "
                      f"max_abs_err={err:.3e} (tol {TOL[name]:g}) "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"paged_attention {name} Tq={tq} "
                                         f"pool={pool} err {err}")
                worst[name] = max(worst[name], err)
    # Timing at the engine's decode step: bf16, Tq=1, every row live at a
    # length drawn across the slot row.
    s = BUCKETS[-1] + MAX_NEW
    slot, _, table, _ = _paged_inputs(device, torch.bfloat16, 1, gen,
                                      pool=False)
    lens = np.random.default_rng(0).integers(33, s + 1, NUM_SLOTS)
    cur_len = torch.tensor(lens, dtype=torch.int32, device=device)
    q = torch.randn((NUM_SLOTS, 1, HEADS, HEAD_DIM), generator=gen,
                    device=device).to(torch.bfloat16)
    kernel = time_ms(lambda: pa._paged_kernel(q, slot, cur_len, None, table),
                     iters=50)
    plain = time_ms(lambda: pa._reference(q, slot, cur_len, None, table))
    valid = (torch.arange(s, device=device)[None, :]
             < cur_len[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), slot["k"].transpose(1, 2), \
        slot["v"].transpose(1, 2)
    library = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=valid), iters=50)
    keys = int(lens.sum())
    nbytes = (2 * keys * HEADS * HEAD_DIM * 2 + 2 * q.numel() * 2
              + NUM_SLOTS * 4 + table.numel() * 4)
    flops = 4 * keys * HEADS * HEAD_DIM
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    print(f"  K8 paged_attention bf16 B={NUM_SLOTS} S={s} Tq=1 live keys "
          f"{keys}: kernel {kernel:.4f} ms, plain {plain:.4f} ms, sdpa "
          f"{library:.4f} ms, bound {b_ms:.5f} ms ({b_by}) [{card}]")
    return {"name": "paged_attention", "route": "cuda",
            "source": "cloud_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "cloud_tpu/ops/paged_attention.py:181",
            "max_abs_err": worst["bfloat16"],
            "max_abs_err_f32": worst["float32"],
            "ms": kernel, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library,
            "shape": f"B={NUM_SLOTS} S={s} Tq=1 H={HEADS} D={HEAD_DIM} bf16"}


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
        launches = dispatch.launch_counts()
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
                                 f"main path (count {count})")
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


def profile_decode_chunk(device, card):
    """Where a decode step's time goes: one chunk of the slot grid at the
    engine's shape (8 slots all active, bf16 SMALL), under torch.profiler.
    Informational: prints "not measured" if the profiler sees no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chunk().cpu()
    # Kernel rows only: an operator row carries its kernels' time again.
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0 and evt.device_type == DeviceType.CUDA:
            rows.append((dev_us, evt.count, evt.key))
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms <= 0:
        print("  decode chunk breakdown: not measured (no device time)")
        return {}
    rows.sort(reverse=True)
    print(f"  decode chunk ({CHUNK} steps, {NUM_SLOTS} active slots): wall "
          f"{wall_ms:.3f} ms, device kernels {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f} [{card}]")
    for dev_us, count, key in rows[:8]:
        print(f"    {dev_us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")
    return {"chunk_wall_ms": wall_ms, "chunk_device_busy_ms": busy_ms,
            "chunk_idle_share": 1 - busy_ms / wall_ms}


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        print("phase 2: kernels against their plain versions")
        with torch.no_grad():
            kernels = [check_flash(device, card), check_paged(device, card)]
    except Exception as exc:  # noqa: BLE001
        return fail(f"kernel check: {exc!r}")
    try:
        print("phase 3: ServingEngine, CloudLM SMALL, 16 requests")
        engine = run_engine(device, card)
    except Exception as exc:  # noqa: BLE001
        return fail(f"engine: {exc!r}")
    try:
        with torch.no_grad():
            engine.update(profile_decode_chunk(device, card))
    except Exception as exc:  # noqa: BLE001 — a breakdown, not a check
        print(f"  decode chunk breakdown: not measured ({exc!r})")
    for entry in kernels:
        entry["launches"] = engine["launches"][entry["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels],
                      "card": card,
                      "shapes": {e["name"]: e["shape"] for e in kernels},
                      "max_abs_err_f32": {e["name"]: e["max_abs_err_f32"]
                                          for e in kernels},
                      "engine": {k: v for k, v in engine.items()
                                 if k != "launches"}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
