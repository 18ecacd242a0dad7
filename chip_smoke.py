#!/usr/bin/env python3
"""Drive the PyTorch port's serving (both schedulers, the prefix cache, speculative decoding, pipelined scheduling, QoS and streaming, full precision and int8, the fleet with disaggregated prefill/decode, an MoE CloudLM with its pretrained bundle, and tensor-parallel serving over two ranks), ResNet (eager, in CUDA-graph windows, through the Trainer with checkpoints and durable resume, compile-ahead, the persistent kernel cache and the record pipeline, through run()'s container, a hyperparameter search over two workers and cloud_fit on two ranks with a sharded checkpoint) and transformer training paths (with dropout, MoE, remat "dots" and ViT-B/16) once on one NVIDIA GPU and check them.

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
   dequantized beforehand), in event and device time, K5, K8 and K8q at
   a tp-2 rank's 6 heads (phase 2 (tp): q/k/v a strided view of a
   full-width projection, a grid born at 6 heads), timed the same way,
   the ring's K5 folds and K6/K7 hops for every rank driven in one
   process (phase 2 (ring): B=2 T=1024 at 12 and 6 heads, bf16 and f32,
   contiguous causal at n=2 and 4 with a left padding that empties whole
   blocks' rows, non-causal at n=2, zig-zag at n=2 and 4), assembled and
   held against one whole-sequence K5 + K6/K7 call and the plain version,
   each rank's launches exact, then K5-K7 timed at the ring's block
   shapes (T=512 causal and not, zig-zag chunks 256 and 128), K5-K7 at
   phase 6pp's call shape (phase 2 (pp): B=2 T=1024 causal, bf16 and
   f32, against the plain version, then timed), K8 and K8q at
   prefill-chunk query counts (Tq 32, 128 and 512, several query tiles,
   chunk-causal, pool pages or not, three chunk starts), each Tq timed
   beside its bound and SDPA over the gathered K/V, K8 and K8q at the
   speculative verify shape (B=8 rows of mixed lengths, Tq 4, S=96),
   timed the same way, K1-K4 (GroupNorm)
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
   there by design), and against the plain version there under the
   ring's contract (out's and lse's cotangents 0 on those rows: dq
   exactly 0 there, dk/dv within the limits; C1), then K5, K6 and K7
   timed at the LM (B=4, T=1024,
   causal), BERT (B=32, T=128) and ViT-B/16 (B=128, T=196, non-causal;
   the plain versions there in event time only) shapes against
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
   4 beams, 32 new tokens, 12 K8q launches per step); then the rest of the
   serving engine at bench.py's configurations: the batch scheduler (3g:
   16 requests, bucket 128, batch buckets (1, 8), ``flush_deadline_s``
   0.05, 64 new tokens), the prefix cache with 32-token chunked prefill on
   the copy and the attach route (3p: 24 requests on 3 system prompts, 64
   blocks of 16 tokens) and its host-DRAM tier off and on (3t: 2 slots, 18
   pool blocks, 0 and 64 host blocks, 6 system prompts, 12 requests).
   Every launch check of a serving phase is derived from the engine's own
   record of what it ran (batches and their decode steps, one-shot
   inserts, prefill chunks, decode chunks), never from how requests
   happened to be grouped; rates, TTFTs and hit rates are printed and
   never asserted.  Each of 3g, 3p and 3t ends with f32 greedy parity
   against ``generate()`` on prompts whose greedy path keeps a top-2 gap
   of 1e-3, 3p on both routes with 32-token chunks and with whole-suffix
   prefill at the prompt's bucket (K8 at Tq 128 and 512), 3p and 3t with
   requests one at a time and their hit, swap-in and demotion counts equal
   to a replay of the same requests through a fresh
   ``PrefixCacheManager``; then speculative decoding at bench.py's
   ``serving_spec`` configuration (3s: 12 staggered requests, SMALL bf16,
   8 slots, bucket 64, spec_k 4, through three engines: no draft, a
   3-layer draft, the target as its own draft; launches from the engine's
   record of rounds and draft prefills; rates, acceptance and bf16
   mismatches printed only), f32 token identity with ``generate()`` with
   either draft, and with ``kv_quant`` (int8 grids for target and draft,
   K8q at Tq 1 and 4, no K8) against ``generate(kv_quant=True)``; 3t also
   serves at ``pipeline_depth=2`` (its whole-stream synchronisations
   printed) and, in f32 one at a time, with ``kv_quant`` (int8 grid, pool
   and host tier; K8q at the 32-token chunk width) against
   ``generate(kv_quant=True)``; then bench.py's churn probe (24 requests,
   buckets (64, 128), up to 64 new tokens, 8 slots, chunk 8, waves of 4):
   ``decode_kernel`` "xla" against "auto" (3k: tokens equal, TTFT and TPOT
   printed), ``pipeline_depth`` 1 against 2, plain, with the 3-layer draft
   and with ``kv_quant`` (3w, on the first 12 of the 24 requests: tokens
   equal between depths, dispatch gaps,
   host bubble and a chunk's idle share printed; f32 depth 2 against
   ``generate()``), the spans of 3w's arms against the engines' counts
   (3n; the plain depth-2 timeline goes to
   ``chiprun_out/serving_pipeline_timeline.json``), and QoS classes with
   streamed requests and ``on_token`` hooks (3o: streams and hooks equal
   the results, f32 against ``generate()``, per-class TTFT printed);
   then the fleet (``cloud_tpu_torch.fleet``, replicas sharing the card,
   each phase's launches held to its replicas' own records summed, and
   no fleet or engine thread left after ``close()``): bench.py's
   ``fleet`` (3f: the churn workload of ``default_rng(2)`` through 2
   replicas with ``admission="reject"``; tokens/s, latency, failovers
   and the TTFT decomposition's p99 shares printed; four f32 requests
   one at a time equal to ``generate()``), ``fleet_qps_sweep`` (3v: open
   loop at QPS 2, 4, 8 and 16, 12 requests of 32 tokens a point, QoS on
   the engines and the fleet, classes alternating; every traced request
   stitches its ``fleet/route`` and ``serve/request`` through the port's
   ``TraceReport``) and ``fleet_disagg`` (3x: a 12-prompt flash crowd of
   120 tokens with a 24-token shared head, colocated on 3 replicas, then
   1 prefill / 2 decode with the KV handoff through the host pool; bf16
   tokens equal across the arms, one handoff a request, none failed
   over, the pool deduplicating; four f32 requests through the
   disaggregated fleet one at a time equal to ``generate()``); then an
   MoE CloudLM (3m: SMALL with the default ``MoeConfig``, 8 experts, top
   2, on the continuous scheduler, bucket 128, 16 staggered requests of
   up to 32 new tokens in bf16 and again with int8 weights and an int8
   grid, K5 and K8 or K8q held to the engine's stats; f32 tokens equal
   ``generate()`` on four prompts padded to the bucket (the same T, so
   the same expert capacity) whose greedy path keeps its top-2 gap, 1e-3,
   or 1e-2 under int8 + kv_quant; the served bf16 params through
   ``save_pretrained``/``load_pretrained`` come back bit for bit and
   serve the same tokens); then tensor-parallel serving (3tp: the mesh
   path at tp 1 token for token as the plain engine,
   ``mesh_shape=(2, 1)`` on one card refused with the JAX engine's
   device-count error; then SMALL at tp 2, rank 0 here and rank 1 in a
   spawned child, both on the one card over gloo: bf16 tokens/s beside
   the one-process engine's, and in f32, on bf16-valued weights, 8
   tie-free requests plain and with kv_quant equal to ``generate()`` and
   the one-process engine, a cold prompt in two prefill chunks and a
   prefix hit equal to ``generate()``; each rank's K5, K8 and K8q
   launches held to rank 0's stats);
4. trains ResNet-50 (CIFAR, batch 256, bf16) for 3 + 20 chained steps
   with SGD momentum, checks finite loss and grad norm and exactly 37 K1,
   16 K2, 37 K3 and 16 K4 launches per step; holds one f32 step on the
   card (batch 8, through the kernels) against the same step on the CPU;
   splits one step's device time (GroupNorm, convolution, idle); then
   multi-step windows (4f): a window of 4 steps replayed from one CUDA
   graph against 4 eager steps from the same state (ResNet-50 f32 b8 with
   SGD momentum, a padded tail ``valid=[1, 1, 0, 0]``, and SMALL at 2
   layers with AdamW, which holds the on-device bias corrections), K1-K4
   replayed bit for bit, and bench.py's ``_measure_fused`` (CIFAR b256,
   windows of 4, 1 + 5 windows) with exact launches per replay, its
   steps/s printed beside phase 4's; then the Trainer (4t:
   ``Trainer.fit`` on CIFAR b256 bf16 with prefetch, validation and
   ``CheckpointCallback(every_n_steps=4, max_to_keep=2)``, one step a
   dispatch, in windows of 4 and with a 2-of-4 tail, and without
   checkpoints: exact K1-K4 launches with the eval steps' forward ones,
   finite History and logged metrics, the checkpointed steps, fit's
   steps/s and the submit-to-first-step gauge printed), save ordering
   (4s: a save followed at once by 4 steps, eager and in a window,
   restores the state at the save bit for bit), bench.py's durability
   probe (4d: save blocking and verified-restore seconds printed, the
   restore equal to the saved state bit for bit) and exactly-once resume
   (4r, f32 b8 with cuDNN's deterministic algorithms: a drain and a
   resume with ``resume_data=True`` against the uninterrupted run, one
   step a dispatch and in windows of 4, a restore into a window's graph
   state, the non-finite guard bit for bit across a poisoned slot, and
   ``python -m cloud_tpu_torch.training.check_durability --device cuda``:
   a stochastic run (input-noise dropout from the rng chain), kill -9,
   both corruptions, the walk-back's fallbacks and quarantine, the
   resumed losses and params digest equal to the control's); then
   compile-ahead (4a: ``Trainer.fit(compile_ahead=True)`` on CIFAR b256
   bf16 one step a dispatch, in windows of 4, again on the same Trainer
   (a registry hit: nothing captured) and with ``batch_spec=``: no
   ``CompileAhead.error``, every train dispatch a graph replay, exact
   K1-K4 launches with the warm-ups and eval steps; ``compile/ahead_wait``,
   submit-to-first-step and steps/s printed beside 4t's; then
   ``aot_compile``'s one-step graph of f32 ResNet-50 b8 against as many
   eager steps), the persistent kernel cache (4k: a cold and a warm child
   process through one ``CLOUD_TPU_COMPILE_CACHE`` directory; the cold one
   probes and builds only ``group_norm``, the warm one builds nothing;
   their first-dispatch and submit-to-first-step seconds printed) and the
   record pipeline (4p: CIFAR b256 as tensor records in 2 files,
   ``fit`` over ``RecordDataset`` with exact launches, records/s decoded,
   and a resumed run consuming exactly the uninterrupted stream's next
   batches); then the front door (9r: ``cloud_tpu_torch.run(dry_run=True)``
   of ``tests/helpers/torch_resnet_cifar_fit.py`` on ``TPU_V5E_1``, its
   build context made by ``containerize``, and the node request's startup
   script executed by ``utils.local_rig.launch_emulated_slice`` with bash,
   a shimmed ``curl`` (worker 0, no project) and a shimmed ``docker`` that
   runs the Dockerfile's own ENTRYPOINT in the context with the ``-e``
   variables, the coordinator's VM name resolving to this host and
   ``CLOUD_TPU_COMPILE_CACHE`` the directory phase 1 built into: the
   container trains ResNet-50 CIFAR b256 bf16 through ``Trainer.fit``
   under the bootstrap's one-rank mesh on the card, with exact K1-K4
   launches, finite losses, parameters that moved and
   ``run/submit_to_first_step_seconds`` > 0 printed), the profiler (9p:
   ``ProfilerCallback`` over 2 steps of a ResNet ``fit`` whose trace
   holds K1-K4, the mirrored ``step/*`` ranges and one ``ProfilerStep``
   marker a traced step; a device-memory snapshot; one capture through
   the profiler server during a step loop holding kernel rows; silent
   sessions retried with back-off) and the exporter (9m: the native
   library built with ``make`` and live (``metrics.backend()`` native),
   its C tests, and ``bootstrap.main`` in-process with monitoring on,
   the Python wire and a recording session, training the MNIST workload
   on the card: ``train/steps`` and ``train/step_time_ms`` exported),
   the tuner (9t: ``tuner.dispatch_search`` of 2 workers of
   ``tests/helpers/torch_tuner_resnet_example.py`` (a dry run), each job's
   context and startup script booted as 9r boots its one, both at once on
   the card; the workers share one ``LocalStudyService`` directory (its
   median stopping off, so every trial runs its epochs; the workers meet
   once each holds a trial, so each runs at least one): 4
   trials of ResNet-50 CIFAR b256 bf16, learning rate and momentum, 2
   epochs of 3 steps each, all COMPLETED with 2 measurements and finite
   losses, K1-K4 launches exactly the workers' steps x 37/16/37/16;
   trials per worker, the best trial, submit-to-first-step, wall times
   and peak memory printed) and ``cloud_fit`` (9f: a dry run of
   ``cloud_tpu_torch.cloud_fit`` of ResNet-50 CIFAR b256 bf16 for 6
   steps on a job of two one-chip hosts, its kernels' output channels on
   ``embed``; the assets, the bootstrap as ENTRYPOINT and the report's
   shim importing the port's ``remote`` checked; the report's startup
   script and ENTRYPOINT as generated (plan ``{dp: 2}``) on two emulated
   hosts, gloo on the one card: both ranks exit 0, ``history.json``,
   a checkpoint written by rank 0 alone that verifies; then two ranks
   under the bootstrap's own plan over them, ``{fsdp: 2}``, restore it
   into their shards bit-equal, train 6 steps and save a sharded
   checkpoint whose manifest covers both ranks' files and verifies; a
   one-process ``remote.run`` restores that bit-equal to the ranks'
   gathered parameters; exact K1-K4 launches on every rank and in the
   restoring run), and the ``gs://`` paths (9g: a storage client backed by
   one local directory (``tests/helpers/torch_gcs_fake.py``), CIFAR
   records written to ``gs://`` in 4 objects, ResNet-50 CIFAR b256 bf16
   ``fit`` for 6 steps from ``RecordDataset("gs://.../train-*.rec")``
   checkpointing to ``gs://`` every 2 steps; a fresh process (no
   ``google.cloud`` importable) lists steps 2, 4 and 6, reads
   ``"unmanifested"`` and no extras and restores the latest step bit for
   bit; two ranks under the bootstrap's ``{fsdp: 2}`` plan take a step and
   save to the same bucket, each its pieces, and this process restores
   that bit for bit; exact K1-K4 launches);
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
   on identical gradients; then the MoE LM (6m: the same step with the
   default ``MoeConfig``, 3 + 5 steps, 24/12/12 launches a step, a finite
   positive aux, one step's device time split into attention, the expert
   products, dispatch and combine, and the rest; one f32 SGD step at 2
   layers, b2 x T128, card against CPU: loss 1e-4 relative, params
   TOL_F32, aux 1e-5) and remat "dots" (6d: the dense step under "none",
   "full" and "dots": f32 loss and grad norm equal across the three; in
   bf16 steps/s, peak memory, device ms and K5 launches, 12 or 24 a
   step, per policy; a K=2 "dots" window as a CUDA graph against 2 eager
   steps within 1e-6); then training under a mesh (6mesh: SMALL at full
   width and depth, b2 x T1024, ``adamw(1e-4)``, remat "full", two ranks
   on the card over gloo, rank 1 a spawned child: ``{sp: 2}`` zig-zag,
   ``{sp: 2}`` Ulysses, ``{tp: 2}`` and ``{fsdp: 2}`` in f32 against one
   process on the same weights and batch (step 1's loss and grad norm
   and step 2's loss within 1e-4 relative, step 1's gradient gathered
   whole within 1e-4 of its largest magnitude), the zig-zag arm in bf16
   on f32 masters within 2e-2 of one process; steps/s of both printed;
   each rank's K5/K6/K7 launches exactly ``mesh_launches_per_layer`` x
   12 layers x steps); then the GPipe pipeline and expert parallelism
   (6pp: the same machinery; ``{pp: 2}`` at b4 x T1024 with M = 2,
   untied and tied head, and the default MoE under ``{ep: 2}`` at b2, in
   f32 against one process with 6mesh's limits (the ep arm's aux within
   1e-5); the MoE under ``{pp: 2}`` with step 1's CE and its gradient's
   norm within 1e-4 relative, its aux (the microbatches' mean) printed
   beside one process's; ``{pp: 2}`` in bf16 within 2e-2; each rank's
   launches exactly ``mesh_launches_per_layer`` x its layers
   (``mesh_layers_held``) x steps); 6mesh's ``tp fused_ce`` arm runs the
   fused CE over the vocabulary split by tp; then the encoders under a
   mesh (6enc: BERT-base b32 x T128 with ragged padding and ViT-B/16 224
   b8 at full width and depth under ``{tp: 2}``, ``{sp: 2}`` and ``{fsdp:
   2}`` in f32 against one process (step 1's loss within 1e-4 relative,
   its gradient gathered whole within 1e-5 of its largest magnitude),
   ``{tp: 2}`` in bf16 for 3 steps within 2e-2; MNIST (hidden units over
   tp) and ResNet-50 CIFAR (replicas) under ``{tp: 2}``; each rank's
   K5-K7 and K1-K4 launches exact; phase 2 (enc) first holds K5-K7 at
   its new call shapes to their plain versions and times them);
7. trains BERT-base at b32 x T128 (``adamw(2e-5)``) for 3 + 10 steps with
   exactly 12 K5, 12 K6 and 12 K7 launches per step, and splits one step's
   device time as phase 6 does; then the stochastic step (7s: dropout
   0.1 from the state's threefry key, ``adamw(2e-5, mask=...)``, 3 + 10
   steps with the same launches, steps/s and dropout's device share
   beside phase 7's; one f32 step at b2 on the card against the CPU,
   masks included; a window of 4 stochastic steps against 4 eager ones);
8. trains ViT-B/16 (8v: 224 px, T=196, GAP, b128 bf16, remat "full",
   ``adamw(3e-4)``) for 3 + 10 steps with 24/12/12 launches a step and
   splits one step's device time as phase 6 does; holds K5, K6 and K7 to
   their plain versions at (128, 196, 12, 64) and (128, 197, 12, 64)
   non-causal, bf16 and f32, off the kernels' 64-row tiles (phase 2c
   times them at T=196 beside SDPA and the bound); one f32 SGD step at
   2 layers, 56 px, patch 8 (T=49), card against CPU; then the golden
   workloads (10g: the port's copy of ``examples/generate_text.py``
   trains CloudLM TINY and decodes greedy, nucleus, with 4 beams, with
   int8 weights and with int8 weights and KV cache, its K5-K7 and K8/K8q
   launches exact (``generate_text_launches``); the long-context ring
   example on 4 ranks over gloo under the bootstrap, ``{sp: 4}`` zig-zag
   with the fused CE and remat "dots", each rank's launches exact; the
   save-and-load and custom-loop MNIST workloads on 2 ranks);
9. prints one JSON line describing every kernel (a serving kernel's
   launches summed over the serving phases (3m included) and 7s, and
   K5's also over 6m, 6d, 6mesh, 6pp, 6enc, 8v and 10g, K6/K7's over 6,
   7s, 6m, 6d, 6mesh, 6pp, 6enc, 8v and 10g, K8/K8q's over 10g too,
   K1-K4's over phases 4, 4t, 4r, 4a, 4p, 9r's container, 9t's workers,
   9f's ranks and restoring run, 9g and 6enc, each
   counted from 0 just before its run), then, as its last
   line, ``{"ok": true, "device": {...}}``.

Each phase prints its wall time.  Once the kernels are timed (after
phase 2c), phases 3tp, 4r, 4k, 9r, 9m, 9t, 9f, 6mesh, 6pp, 6enc, 9g and
10g run in a second process (``python3 chip_smoke.py --side <dir>``,
``SIDE_PHASES``) beside phases 3 to 8v; each counts its launches from 0 in its own
process, and its output is printed after phase 8v.  Any failed phase
ends the run with a nonzero exit and no result line; the phase it
stopped in and the traceback go to stdout.
Without a CUDA card, or without the rest of the repository beside it, it
exits nonzero before doing any work.
"""

from __future__ import annotations

import functools
import json
import os
import re
import subprocess
import sys
import time
import traceback

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
#: Profiler sessions: how many a check that needs every kernel record may
#: take, and how long a session waits, synchronised and idle, before the
#: work it measures: a session now and then misses the first kernels
#: launched right after it starts.
PROFILE_SESSIONS = 5
PROFILE_SETTLE_S = 0.05


def _profile_pause(attempt: int) -> None:
    """The wait after a session that recorded no kernel: 1, 2, 4 and 8 s
    (a silent profiler has been seen to stay silent for several sessions
    in a row)."""
    time.sleep(2.0 ** attempt)


def fail(msg: str, phase: str = "") -> int:
    """Report a failed check on stderr and, with the phase it stopped in
    and the traceback of the exception being handled, on stdout."""
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    if phase:
        print(f"chip_smoke: FAILED in {phase}: {msg}")
        if sys.exc_info()[0] is not None:
            print(traceback.format_exc())
        sys.stdout.flush()
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
    kernel's records is run again, ``PROFILE_SESSIONS`` in all.  Where the
    profiler records no kernel in all of :func:`profiled`'s sessions, the
    call is timed with CUDA events instead (:func:`time_ms`), and a line
    says so."""
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    for attempt in range(PROFILE_SESSIONS):
        try:
            _, rows = profiled(run)
        except ProfilerSilent:
            ms = time_ms(fn, iters=iters)
            print(f"  (torch.profiler recorded no kernel in "
                  f"{PROFILE_SESSIONS} sessions: device time read by CUDA "
                  f"events instead, {ms:.4f} ms)")
            return ms
        calls = [max(1, round(count / iters)) for _, count, _ in rows]
        if all(abs(count - k * iters) <= iters // 5
               for (_, count, _), k in zip(rows, calls)):
            return sum(us / count * k for (us, count, _), k
                       in zip(rows, calls)) / 1e3
    raise AssertionError(f"torch.profiler lost kernel records in "
                         f"{PROFILE_SESSIONS} sessions of {iters} calls: "
                         f"{rows[:4]}")


def profiled(run, *, cpu=False, record_shapes=False):
    """``run()`` under torch.profiler (CUDA activity, and CPU's if
    ``cpu``), after the session has waited ``PROFILE_SETTLE_S`` with the
    card idle, and until every kernel ``run`` launched has finished (a
    kernel still running when the session stops leaves no record);
    returns ``(prof, kernel rows)``.  Now and then a session records no
    kernel at all, sometimes several in a row: such a session is run
    again after a pause (:func:`_profile_pause`), ``PROFILE_SESSIONS`` in
    all, before :func:`_kernel_rows` raises :class:`ProfilerSilent`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    for attempt in range(PROFILE_SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=activities,
                     record_shapes=record_shapes) as prof:
            time.sleep(PROFILE_SETTLE_S)
            run()
            torch.cuda.synchronize()
        try:
            return prof, _kernel_rows(prof)
        except ProfilerSilent:
            if attempt == PROFILE_SESSIONS - 1:
                raise
            _profile_pause(attempt)


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
    call each (device time beside its plain version's, ``F.group_norm``'s
    and the bound), and the step's sum (each shape's time times its calls
    a step)."""
    rows, step = [], {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                      "bound_ms": 0.0}
    for (shape, relu), count in _gn_step_shapes(
            name, gn_calls(IMAGENET_BATCH, 224)).items():
        t, b_ms, _ = _time_gn(gn, name, [(shape, relu)], gen)
        row = {"shape": list(shape), "relu": relu, "calls_per_step": count,
               "kernel_ms": t["kernel"][0], "plain_ms": t["plain"][0],
               "library_ms": t["library"][0], "bound_ms": b_ms,
               "kernel_event_ms": t["kernel"][1]}
        rows.append(row)
        for k in step:
            step[k] += count * row[k]
        print(f"    {name} {shape} relu={relu} x{count}/step, device ms: "
              f"kernel {row['kernel_ms']:.4f}, plain {row['plain_ms']:.4f}, "
              f"F.group_norm {row['library_ms']:.4f}, bound {b_ms:.5f} "
              f"({b_ms / row['kernel_ms']:.2f} of it) [{card}]")
    print(f"  {name} bf16 over one 224 b128 step's calls, device ms: kernel "
          f"{step['kernel_ms']:.4f}, plain {step['plain_ms']:.4f}, "
          f"F.group_norm {step['library_ms']:.4f}, bound "
          f"{step['bound_ms']:.4f} [{card}]")
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


def _ring_contract_case(fa, gen, dtype, *, h, d):
    """C1 under the ring's contract: causal rows with no valid key (left
    padding: sample 0's first 37 rows, sample 1's first 150) reach the
    backward with out's cotangent 0 and the lse's 0 (merge weight 0,
    ``cloud_tpu/parallel/ring_attention.py``).  K6/K7 against the plain
    version on K5's out and lse, and dq exactly 0 on those rows from
    both: what the kernels' tiles give such rows then adds nothing.
    Returns {kernel: max_abs_err}."""
    import torch

    b, t = 2, 200
    q, k, v, do, _ = _attn_inputs(b, t, dtype, gen, mask_kind=None, h=h, d=d)
    mask = torch.ones((b, t), dtype=torch.int32, device=gen.device)
    mask[0, :37] = 0
    mask[1, :150] = 0
    empty = (torch.arange(t, device=gen.device)[None]
             < torch.tensor([37, 150], device=gen.device)[:, None])
    do = do.masked_fill(empty[:, :, None, None], 0)
    g_lse = torch.randn((b, h, t), generator=gen, device=gen.device
                        ).masked_fill(empty[:, None, :], 0)
    out, lse = fa._flash_kernel(q, k, v, causal=True, mask=mask)
    got = fa._bwd_kernels(q, k, v, mask, do, out, lse, causal=True,
                          g_lse=g_lse)
    ref = fa._bwd_reference(q, k, v, mask, do, out, lse, causal=True,
                            g_lse=g_lse)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[1]
    what = (f"{name} B={b} T={t} H={h} D={d} causal, rows with no valid "
            f"key under the ring's contract")
    for label, dq in (("K6", got[0]), ("plain", ref[0])):
        if not bool((dq[empty] == 0).all()):
            raise AssertionError(f"{label} dq of rows with no valid key is "
                                 f"not exactly 0 ({what})")
    return {"flash_bwd_dq": check_close(f"K6 dq {what}", got[0], ref[0],
                                        name, scaled=True),
            "flash_bwd_dkv": max(
                check_close(f"K7 dk {what}", got[1], ref[1], name,
                            scaled=True),
                check_close(f"K7 dv {what}", got[2], ref[2], name,
                            scaled=True))}


def _attn_bound(kernel, b, t, causal, h=HEADS, valid_keys=None):
    """(bound_ms, bound_by) of one bf16 call at [b, t, h, 64]: each input
    read once and each output written once; 2 H*D operations per (query,
    key) pair a product visits (the causal half only under the causal
    skip; under a padding mask the valid keys alone, ``valid_keys`` their
    count over the batch), times the kernel's products: K5 2, K6 3, K7
    4."""
    elems = b * t * h * HEAD_DIM
    rows = b * h * t * 4  # one [B, H, T] f32 vector
    if valid_keys is not None:
        pairs = t * valid_keys
    else:
        pairs = b * (t * (t + 1) // 2 if causal else t * t)
    per_product = 2 * h * HEAD_DIM * pairs
    if kernel == "flash_fwd":  # q, k, v -> out, lse
        return bound_ms(4 * elems * 2 + rows, 2 * per_product, "bfloat16")
    if kernel == "flash_bwd_dq":  # q, k, v, dO, lse, rowterm -> dq
        return bound_ms(5 * elems * 2 + 2 * rows, 3 * per_product,
                        "bfloat16")
    # q, k, v, dO, lse, rowterm -> dk, dv
    return bound_ms(6 * elems * 2 + 2 * rows, 4 * per_product, "bfloat16")


def _time_attention(fa, path, card, gen, shape=None, plain_device=True,
                    h=HEADS, mask_kind=None):
    """Kernel, plain and library times of K5, K6 and K7 (bf16) at one
    training path's shape (``TRAIN_SHAPES[path]``, or ``shape``; ``h``
    heads; a key-padding mask of ``mask_kind``), with their bounds, each
    in event and device time (:func:`event_and_device_ms`); the plain
    versions in event time alone without ``plain_device`` (at ViT's B=128
    the profiler's sessions of the plain forward lost records of its copy
    kernel in five sessions running).  The library yardstick is
    ``F.scaled_dot_product_attention`` (the mask as a boolean
    ``attn_mask``): its forward for K5, its backward (forward plus
    backward, less the forward) for K6 and K7."""
    import torch
    import torch.nn.functional as F

    b, t, causal = shape or TRAIN_SHAPES[path]
    q, k, v, do, mask = _attn_inputs(b, t, torch.bfloat16, gen,
                                     mask_kind=mask_kind, h=h)
    with torch.no_grad():
        out, lse = fa._flash_kernel(q, k, v, causal=causal, mask=mask)
        row = fa._row_term(do, out, None)
        calls = {
            "flash_fwd": lambda: fa._flash_kernel(q, k, v, causal=causal,
                                                  mask=mask),
            "flash_bwd_dq": lambda: fa._bwd_launch(
                "flash_bwd_dq", q, k, v, mask, do, lse, row, causal=causal),
            "flash_bwd_dkv": lambda: fa._bwd_launch(
                "flash_bwd_dkv", q, k, v, mask, do, lse, row, causal=causal),
        }
        times = {name: event_and_device_ms(fn) for name, fn in calls.items()}

        def plain_ms(fn):
            if plain_device:
                return event_and_device_ms(fn, iters=5)
            return time_ms(fn, iters=5), None

        plain_fwd = plain_ms(lambda: fa._reference_with_lse(
            q, k, v, causal=causal, mask=mask))
        plain_bwd = plain_ms(lambda: fa._bwd_reference(
            q, k, v, mask, do, out, lse, causal=causal))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    keep = None if mask is None else mask.bool()[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                              is_causal=causal)

    sdpa_fwd = event_and_device_ms(sdpa)
    sdpa_both = event_and_device_ms(
        lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
    sdpa_bwd = tuple(x - y for x, y in zip(sdpa_both, sdpa_fwd))
    entries = {}
    for name, (kernel, kernel_dev) in times.items():
        fwd = name == "flash_fwd"
        plain, plain_dev = plain_fwd if fwd else plain_bwd
        library, library_dev = sdpa_fwd if fwd else sdpa_bwd
        b_ms, b_by = _attn_bound(
            name, b, t, causal, h=h,
            valid_keys=None if mask is None else int(mask.sum()))
        entries[name] = {
            "shape": f"B={b} T={t} H={h} D={HEAD_DIM} bf16 "
                     f"{'causal' if causal else 'non-causal'}, "
                     f"{'no mask' if mask is None else mask_kind + ' mask'}",
            "ms": kernel, "device_ms": kernel_dev,
            "plain_ms": plain, "plain_device_ms": plain_dev,
            "library_ms": library, "library_device_ms": library_dev,
            "bound_ms": b_ms, "bound_by": b_by}
        plain_dev_s = ("device not measured" if plain_dev is None
                       else f"{plain_dev:.4f}")
        print(f"  {name} {path} {entries[name]['shape']}: kernel "
              f"{kernel:.4f} ms (device {kernel_dev:.4f}), plain "
              f"{plain:.4f} ({plain_dev_s})"
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
    both shapes and at ViT-B/16's (B=128, T=196, non-causal; 8v checks
    them there), early in the run, where the profiler's sessions have
    held.  Returns the K6/K7 entries, K5's timings at the three shapes
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
    ring = {name: 0.0 for name in FLASH_BWD_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        for d in fa.KERNEL_HEAD_DIMS:
            for name, e in _ring_contract_case(fa, gen, dtype, h=4,
                                               d=d).items():
                ring[name] = max(ring[name], e)
            cases += 1
    print(f"  C1: K6/K7 against the plain version where causal rows have no "
          f"valid key, out's and lse's cotangents 0 there (the ring's "
          f"contract), bf16 and f32, every head dim: dq exactly 0 on those "
          f"rows, max_abs_err dq {ring['flash_bwd_dq']:.3e}, dk/dv "
          f"{ring['flash_bwd_dkv']:.3e} ok [{card}]")
    timed = {path: _time_attention(fa, path, card, gen)
             for path in TRAIN_SHAPES}
    timed["ViT"] = _time_attention(fa, "ViT", card, gen,
                                   shape=(VIT_BATCH, 196, False),
                                   plain_device=False)
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
            "max_abs_err_ring_contract": ring[name],
            **lm,
            "at_bert": timed["BERT"][name],
            "at_vit": timed["ViT"][name]})
    print(f"  flash: {cases} cases checked")
    return (entries, {path: timed[path]["flash_fwd"] for path in timed},
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


class ProfilerSilent(AssertionError):
    """A torch.profiler session recorded no kernel at all."""


def _kernel_rows(prof):
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0 and evt.device_type == DeviceType.CUDA:
            rows.append((dev_us, evt.count, evt.key))
    if not rows:
        raise ProfilerSilent("torch.profiler recorded no device time")
    return sorted(rows, reverse=True)


#: Substrings of the cuDNN and CUTLASS kernel names convolutions run as.
CONV_KEYS = ("conv", "xmma", "cudnn", "implicit", "dgrad", "wgrad", "fprop",
             "cutlass", "nchw", "nhwc")


def _is_gn(key: str) -> bool:
    return "gn_fwd_" in key or "gn_bwd_" in key


#: The profiler range around the step a step profile measures.
MEASURED_STEP = "chip_smoke: measured step"


def _profiled_step(step, state, batch, *, record_shapes=False):
    """Two warm-up steps, the wall time of one unprofiled step (to the
    host read of its loss) and the host's time to enqueue it (the step
    itself never waits for the device), then a session of torch.profiler
    (CPU and CUDA activity) that runs a lead step, waits for it, and then
    the measured step inside a ``MEASURED_STEP`` range.  A session now and
    then holds no record of the first launch of one of the port's kernels
    (seen on an H100 as the stem's GroupNorm forward missing from every
    session of a process), so only the second step is read
    (:func:`_measured_events`).  Returns ``(wall_ms, enqueue_ms, prof)``."""
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
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        with torch.profiler.record_function(MEASURED_STEP):
            state, metrics = step(state, batch)
            float(metrics["loss"])

    prof, _ = profiled(run, cpu=True, record_shapes=record_shapes)
    return wall_ms, enqueue_ms, prof


def _measured_events(prof):
    """The profiler events of the measured step: everything that starts
    after its ``MEASURED_STEP`` range does (the lead step's kernels ended
    before it, behind a synchronisation and ``PROFILE_SETTLE_S``), the
    range's own events left out."""
    events = prof.events()
    start = min(e.time_range.start for e in events
                if e.name == MEASURED_STEP)
    return [e for e in events
            if e.name != MEASURED_STEP and e.time_range.start >= start]


def _event_rows(prof, events):
    """:func:`_kernel_rows` of ``events`` of ``prof``: (device us,
    records, kernel) per kernel, largest first.  Only kernels count: the
    device-side copies of annotated ranges (autograd's functions) are
    events on the card too, and :func:`_kernel_rows` leaves them out."""
    from torch.autograd import DeviceType

    kernels = {key for _, _, key in _kernel_rows(prof)} - {MEASURED_STEP}
    totals = {}
    for evt in events:
        if evt.device_type == DeviceType.CUDA and evt.name in kernels:
            us, count = totals.get(evt.name, (0.0, 0))
            totals[evt.name] = (us + evt.time_range.elapsed_us(), count + 1)
    if not totals:
        raise AssertionError("torch.profiler recorded no device time")
    return sorted(((us, count, key) for key, (us, count) in totals.items()),
                  reverse=True)


def _profile_checked(step, state, batch, complaint, *, record_shapes=False):
    """:func:`_profiled_step` until ``complaint(rows)`` finds nothing
    wrong with the measured step's kernel rows: now and then a session
    loses a kernel record, so a step is profiled again,
    ``PROFILE_SESSIONS`` in all, before the last complaint is raised.
    Returns ``(wall_ms, enqueue_ms, events, rows)``, the measured step's
    events and kernel rows."""
    for _ in range(PROFILE_SESSIONS):
        wall_ms, enqueue_ms, prof = _profiled_step(
            step, state, batch, record_shapes=record_shapes)
        events = _measured_events(prof)
        rows = _event_rows(prof, events)
        problem = complaint(rows)
        if problem is None:
            return wall_ms, enqueue_ms, events, rows
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
        kinds = {}
        for _, count, key in rows:
            if _is_gn(key):
                kind = re.search(r"gn_(?:fwd|bwd)_\w+", key).group(0)
                kinds[kind] = kinds.get(kind, 0) + count
        return (None if got == want else
                f"the profiled step holds {got} GroupNorm kernel records, "
                f"not {want} ({kinds})")

    wall_ms, enqueue_ms, events, rows = _profile_checked(
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
    host_totals, copy_counts = {}, {}
    for evt in events:
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            continue
        us, count = host_totals.get(evt.name, (0.0, 0))
        host_totals[evt.name] = (us + evt.self_cpu_time_total, count + 1)
        shape = tuple(evt.input_shapes[0]) if evt.input_shapes else ()
        if (evt.name in ("aten::copy_", "aten::contiguous")
                and len(shape) == 4 and shape[0] == batch_size
                and shape not in weights):
            key = (evt.name, shape)
            copy_counts[key] = copy_counts.get(key, 0) + 1
    host = sorted(((us, count, key) for key, (us, count)
                   in host_totals.items()), reverse=True)
    print("  host: busiest operators by self CPU time")
    for cpu_us, count, key in host[:8]:
        print(f"    {cpu_us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")
    copies = [(key, list(shape), count)
              for (key, shape), count in copy_counts.items()]
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


def _attn_complaint(what, per_step):
    """A :func:`_profile_checked` complaint: the rows of K5, K6 and K7 must
    hold exactly the step's ``per_step`` launches, with nonzero time."""
    def complaint(rows):
        for name, key in ATTN_ROWS.items():
            mine = [r for r in rows if key in r[2]]
            seen, ms = sum(r[1] for r in mine), sum(r[0] for r in mine) / 1e3
            if seen != per_step[name] or not ms > 0:
                return (f"{what}: profiler rows matching {key!r} hold "
                        f"{seen} launches and {ms} ms; the step launched "
                        f"{per_step[name]}")
        return None

    return complaint


def profile_attn_step(card, what, per_step, step, state, batch):
    """Where one transformer training step's device time goes:
    torch.profiler's kernel rows split into K5, K6, K7, matrix products
    and the rest, and the idle share against the wall time of an
    unprofiled step.  Fails if, in ``PROFILE_SESSIONS`` profiled steps,
    the rows of K5, K6 or K7 never hold exactly the step's ``per_step``
    launches with nonzero time: a kernel whose symbol no longer matches
    ``ATTN_ROWS`` would move its time into "rest" unseen."""
    wall_ms, enqueue_ms, _, rows = _profile_checked(
        step, state, batch, _attn_complaint(what, per_step))
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
    engine's shape (8 slots all active, bf16 SMALL), under torch.profiler,
    read from the second chunk of a session (after a lead chunk, as the
    step profiles do).  Fails if the profiler sees no device time, or if
    in ``PROFILE_SESSIONS`` sessions the measured chunk's rows of K8's
    split pass or of its combine never hold one launch a layer a step."""
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
    def run():
        # A lead chunk, waited for, then the measured one: a session now
        # and then loses the record of its first launches (MEASURED_STEP).
        chunk().cpu()
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        with torch.profiler.record_function(MEASURED_STEP):
            chunk().cpu()

    # Kernel rows of the measured chunk only: an operator row carries its
    # kernels' time again.  A session that lost a record of K8 is run
    # again (the next chunks), PROFILE_SESSIONS in all.
    for attempt in range(PROFILE_SESSIONS):
        prof, _ = profiled(run, cpu=True)
        rows = _event_rows(prof, _measured_events(prof))
        seen = {key: sum(r[1] for r in rows if key in r[2])
                for key in PAGED_ROWS_KEYS}
        if all(n == cfg.num_layers * CHUNK for n in seen.values()):
            break
        if attempt == PROFILE_SESSIONS - 1:
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


def _padded(prompt, width):
    """``prompt`` as a ``[1, width]`` row, zeros after it (an engine
    bucket's layout)."""
    row = np.zeros((1, max(width, len(prompt))), np.int32)
    row[0, :len(prompt)] = prompt
    return row


def _greedy_gaps(generation, params, prompt, budget, cfg, device, *,
                 kv_quant, width=0):
    """Top-2 logit gap at each greedy step of ``generate(kv_quant=...)``,
    read off its own path (``_prefill`` and ``_decode_step``, on an int8
    cache with ``kv_quant``), and the tokens of that path; the prompt
    padded to ``width`` (an MoE model routes by the prefill's width)."""
    import torch

    tokens = torch.from_numpy(_padded(prompt, width)).to(device)
    lens = torch.tensor([len(prompt)], dtype=torch.int32, device=device)
    cache, logits = generation._prefill(params, tokens, lens, cfg,
                                        tokens.shape[1] + budget,
                                        kv_quant=kv_quant)
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
            gaps, path = _greedy_gaps(generation, qparams32, prompt, budget,
                                      cfg32, device, kv_quant=True)
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


# ---------------------------------------------------------------------------
# Phase 2 (chunks), 3g, 3p, 3t: the paged kernel at prefill-chunk query
# counts, the batch scheduler, the prefix cache and its host tier
# ---------------------------------------------------------------------------

#: (Tq, S) of the chunk checks: bench.py's 32-token prefill chunks on the
#: slot rows of its prefix config (prompt buckets up to 128 plus 64 new
#: tokens), and a suffix prefilled at its prompt bucket's width (128, 512)
#: on the engine's 576-position rows.
CHUNK_SHAPES = ((32, 192), (128, 576), (512, 576))
#: Pool blocks (16 tokens) of the chunk checks and the hit they attach.
CHUNK_POOL_BLOCKS, CHUNK_HIT_BLOCKS = 64, 6


def _chunk_inputs(device, dtype, s, tq, gen, *, pool: bool, start: int):
    """One slot row of ``s`` positions, a chunk of ``tq`` queries starting
    at ``start`` (``cur_len = start + 1``) and, with ``pool``, a table
    whose first ``CHUNK_HIT_BLOCKS`` pages read pool blocks."""
    import torch

    slot = {n: torch.randn((1, s, HEADS, HEAD_DIM), generator=gen,
                           device=device).to(dtype) for n in ("k", "v")}
    table = torch.full((1, -(-s // 16)), -1, dtype=torch.int32, device=device)
    pool_l = None
    if pool:
        pool_l = {n: torch.randn((CHUNK_POOL_BLOCKS, 16, HEADS, HEAD_DIM),
                                 generator=gen, device=device).to(dtype)
                  for n in ("k", "v")}
        for page in range(CHUNK_HIT_BLOCKS):
            table[0, page] = (7 * page + 3) % CHUNK_POOL_BLOCKS
    cur_len = torch.tensor([start + 1], dtype=torch.int32, device=device)
    q = torch.randn((1, tq, HEADS, HEAD_DIM), generator=gen,
                    device=device).to(dtype)
    return q, slot, pool_l, table, cur_len


def _sdpa_chunk(q, k, v, cur_len):
    """SDPA of a chunk over whole K/V rows under the chunk-causal mask
    (key j valid for query t iff j < cur_len + t): the library yardstick
    of K8 at a prefill chunk."""
    import torch
    import torch.nn.functional as F

    s, tq = k.shape[1], q.shape[1]
    valid = (torch.arange(s, device=q.device)[None, :]
             < cur_len[0] + torch.arange(tq, device=q.device)[:, None])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=valid[None, None])


def check_paged_chunks(device, card):
    """K8 and K8q at prefill-chunk query counts (several query tiles):
    Tq 32, 128 and 512, q in bf16 and f32, with and without pool pages,
    chunks starting at 0, after a 96-token hit, and near the row's end,
    each against the plain version; then each Tq timed in bf16 with pool
    pages after the hit (kernel, plain version and SDPA over the gathered
    K/V, in event and device time) beside its bound."""
    import torch

    from cloud_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device=device).manual_seed(32)
    worst = {}
    for name, quantize in (("paged_attention", False),
                           ("paged_attention_int8", True)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            for tq, s in CHUNK_SHAPES:
                for pool in (False, True):
                    for start in (0, 16 * CHUNK_HIT_BLOCKS, s - tq // 2):
                        q, slot, pool_l, table, cur_len = _chunk_inputs(
                            device, dtype, s, tq, gen, pool=pool,
                            start=start)
                        if quantize:
                            slot = _quantize_leaves(slot)
                            if pool_l is not None:
                                pool_l = _quantize_leaves(pool_l)
                        out = pa._paged_kernel(q, slot, cur_len, pool_l,
                                               table)
                        ref = pa._reference(q, slot, cur_len, pool_l, table)
                        torch.cuda.synchronize()
                        err = check_close(
                            f"{name} {dname} Tq={tq} S={s} pool={pool} "
                            f"start={start}", out, ref, dname)
                        key = (name, dname)
                        worst[key] = max(worst.get(key, 0.0), err)
            print(f"  {name} {dname}: Tq {[t for t, _ in CHUNK_SHAPES]}, "
                  f"pool on/off, 3 starts: max_abs_err "
                  f"{worst[(name, dname)]:.3e} ok")
    timed = {}
    start = 16 * CHUNK_HIT_BLOCKS
    for name, quantize in (("paged_attention", False),
                           ("paged_attention_int8", True)):
        for tq, s in CHUNK_SHAPES:
            q, slot, pool_l, table, cur_len = _chunk_inputs(
                device, torch.bfloat16, s, tq, gen, pool=True, start=start)
            gathered = {n: pa._gather_paged(slot[n], pool_l[n], table)
                        for n in ("k", "v")}
            if quantize:
                slot, pool_l = _quantize_leaves(slot), _quantize_leaves(
                    pool_l)
                gathered = {n: (pa._gather_paged(slot[n], pool_l[n], table)
                                .float() * pa._gather_paged(
                                    slot[f"{n}_scale"], pool_l[f"{n}_scale"],
                                    table)).to(torch.bfloat16)
                            for n in ("k", "v")}
            kernel, kernel_dev = event_and_device_ms(
                lambda: pa._paged_kernel(q, slot, cur_len, pool_l, table))
            plain, plain_dev = event_and_device_ms(
                lambda: pa._reference(q, slot, cur_len, pool_l, table))
            library, library_dev = event_and_device_ms(
                _sdpa_chunk(q, gathered["k"], gathered["v"], cur_len))
            # Keys the chunk reads (the last query's), each once per head;
            # key-query pairs it scores (query t sees start + 1 + t).
            keys = min(start + tq, s)
            pairs = sum(min(start + 1 + t, s) for t in range(tq))
            per_key = 2 * HEAD_DIM + 8 if quantize else 4 * HEAD_DIM
            nbytes = (keys * HEADS * per_key + 2 * q.numel() * 2
                      + table.numel() * 4 + 4)
            b_ms, b_by = bound_ms(nbytes, 4 * pairs * HEADS * HEAD_DIM,
                                  "bfloat16")
            shape = (f"B=1 Tq={tq} S={s} bt=16 pool ({CHUNK_HIT_BLOCKS} "
                     f"pages) cur_len={start + 1} H={HEADS} D={HEAD_DIM} "
                     + ("int8 K/V, bf16 q" if quantize else "bf16"))
            print(f"  {name} {shape}: kernel {kernel:.4f} ms (device "
                  f"{kernel_dev:.4f}), plain {plain:.4f} ({plain_dev:.4f}), "
                  f"sdpa {library:.4f} ({library_dev:.4f}), bound "
                  f"{b_ms:.5f} ms ({b_by}) [{card}]")
            timed[f"{name} Tq={tq}"] = {
                "ms": kernel, "device_ms": kernel_dev, "plain_ms": plain,
                "plain_device_ms": plain_dev, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": library,
                "library_device_ms": library_dev, "shape": shape}
    return {"max_abs_err": {f"{n} {d}": e for (n, d), e in worst.items()},
            "timed": timed}


def _check_launches(what, launches, layers_n, d0, d1, *, draft_layers=0,
                    spec_k=0, quantized=False):
    """Hold a serving run's launches to the engine's own record between two
    ``stats()`` snapshots: K5 once a layer per batch (batch scheduler) and
    per one-shot insert, once a draft layer per draft prefill; the paged
    kernel once a layer per prefill chunk, per decode step of a chunk and
    per decode step of a batch, and per speculative round once a layer
    (the verify) plus ``spec_k`` times a draft layer (the proposals): K8q
    with ``quantized`` (an int8 grid), K8 otherwise, the other never."""
    def delta(key):
        return d1[key] - d0[key]

    paged = layers_n * (
        delta("prefill_chunks") + CHUNK * delta("chunks")
        + delta("batch_decode_steps")) + (
            layers_n + draft_layers * spec_k) * delta("spec_chunks")
    name = "paged_attention_int8" if quantized else "paged_attention"
    expected = {
        "flash_fwd": layers_n * (delta("batches") + delta("oneshot_inserts"))
        + draft_layers * delta("draft_prefills"),
        "paged_attention": 0, "paged_attention_int8": 0}
    expected[name] = paged
    if launches != expected or not paged:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{expected} from the engine's stats")


def _tie_free(generation, params, cfg, device, candidates, n, budget):
    """The first ``n`` candidate prompts whose f32 greedy path under
    ``generate`` keeps a top-2 logit gap of 1e-3 at every step."""
    picks = []
    for prompt in candidates:
        gaps, _ = _greedy_gaps(generation, params, prompt, budget, cfg,
                               device, kv_quant=False)
        if min(gaps) >= 1e-3:
            picks.append(prompt)
        if len(picks) == n:
            return picks
    raise AssertionError(f"only {len(picks)} tie-free prompts among the "
                         f"candidates")


def _replay_prefix(serve, prompts):
    """The prefix counters of ``prompts`` served one after another, from a
    fresh ``PrefixCacheManager`` driven as the engine drives it (match,
    pin or swap in, save the new blocks, release at retire)."""
    from cloud_tpu_torch.serving.prefix_cache import (
        PrefixCacheManager,
        PrefixHit,
    )

    dram = serve.prefix_dram_blocks
    mgr = PrefixCacheManager(serve.prefix_cache_blocks,
                             serve.prefix_block_tokens, dram_blocks=dram,
                             demote_fn=(lambda block: block) if dram else None)
    for prompt in prompts:
        tokens = prompt.tolist()
        hit = mgr.match(tokens)
        if hit and (mgr.acquire_swapin(hit) if dram else
                    ([] if mgr.acquire(hit) else None)) is None:
            hit = PrefixHit(nodes=(), tokens=0)
        held, _, _ = mgr.insert(tokens, hit)
        mgr.release(list(hit.nodes) + held)
    return mgr.stats()


def _serve_in_turn(engine, prompts, budget):
    """Each prompt submitted after the one before has resolved."""
    return [engine.submit(p, max_new_tokens=budget).result(timeout=600)
            for p in prompts]


def _parity(what, generation, params, cfg, device, prompts, served, budget,
            *, kv_quant=False):
    import torch

    for prompt, res in zip(prompts, served):
        want = generation.generate(
            params, torch.from_numpy(prompt)[None], [len(prompt)], cfg,
            max_new_tokens=budget, kv_quant=kv_quant,
            device=device)["tokens"][0].cpu().numpy()
        if not np.array_equal(want, res.tokens):
            first = int(np.flatnonzero(want != res.tokens)[0])
            raise AssertionError(f"{what} != generate(kv_quant={kv_quant}) "
                                 f"for a {len(prompt)}-token prompt at "
                                 f"token {first}")


def _tie_free_quantized(generation, params, cfg, device, candidates, n,
                        budget):
    """The first ``n`` candidate prompts whose f32 greedy path under
    ``generate(kv_quant=True)`` keeps a top-2 logit gap of
    ``QUANT_TIE_GAP`` at every step."""
    picks = []
    for prompt in candidates:
        gaps, _ = _greedy_gaps(generation, params, prompt, budget, cfg,
                               device, kv_quant=True)
        if min(gaps) >= QUANT_TIE_GAP:
            picks.append(prompt)
        if len(picks) == n:
            return picks
    raise AssertionError(f"only {len(picks)} of {len(candidates)} prompts "
                         f"are tie-free at {QUANT_TIE_GAP} under "
                         f"quantization")


def _run_measured(engine, prompts, budgets, *, wave, pause):
    """Submit ``prompts`` in waves of ``wave`` with ``pause`` seconds
    between waves; returns (results, wall seconds)."""
    start = time.perf_counter()
    futures = []
    for i, prompt in enumerate(prompts):
        futures.append(engine.submit(prompt, max_new_tokens=budgets[i]))
        if pause and (i + 1) % wave == 0:
            time.sleep(pause)
    results = [f.result(timeout=600) for f in futures]
    return results, time.perf_counter() - start


#: bench.py's serving configurations (SERVE_* constants there).
BATCH_SERVE = {"requests": 16, "bucket": 128, "new": 64, "max_batch": 8}
PREFIX_SERVE = {"requests": 24, "heads": 3, "blocks": 64, "block_tokens": 16,
                "pchunk": 32, "buckets": (64, 128)}
TIER_SERVE = {"heads": 6, "hbm": 18, "dram": 64, "requests": 12, "new": 8}
PARITY_BUDGET = 16


def run_batch_engine(device, card):
    """3g, bench.py's ``_measure_serving``: 16 requests of 32..128 tokens
    through ``scheduler="batch"`` (bucket 128, batch buckets (1, 8),
    ``flush_deadline_s`` 0.05, 64 new tokens), launches checked against
    the engine's record; then f32 greedy parity of the batch engine with
    ``generate()`` on four tie-free prompts."""
    import torch

    from cloud_tpu_torch.models import generation
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.serving import ServeConfig, ServingEngine
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    b = BATCH_SERVE
    cfg, params, _, _ = decode_setup(device=device, seed=0)
    serve = ServeConfig(max_new_tokens=b["new"], prompt_buckets=(b["bucket"],),
                        batch_buckets=(1, b["max_batch"]),
                        flush_deadline_s=0.05, warmup=True, scheduler="batch")
    rng = np.random.default_rng(0)
    lengths = rng.integers(b["bucket"] // 4, b["bucket"] + 1, b["requests"])
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    with ServingEngine(params, cfg, serve, device=device) as engine:
        engine.wait_ready()
        engine.submit(prompts[0]).result(timeout=300)
        torch.cuda.synchronize()
        d0 = engine.stats()
        dispatch.reset_launch_counts()
        results, wall = _run_measured(engine, prompts,
                                      [b["new"]] * len(prompts), wave=0,
                                      pause=0)
    launches = dispatch.launch_counts(QUANT_SERVING_KERNELS)
    d1 = engine.stats()
    _check_launches("batch engine", launches, cfg.num_layers, d0, d1)
    for res in results:
        if res.tokens.shape != (b["new"],) or res.tokens.min() < 0 or \
                res.tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"bad batch result {res.tokens.shape}")
    batches = d1["batches"] - d0["batches"]
    rows = d1["real_rows"] - d0["real_rows"]
    slots = d1["slots"] - d0["slots"]
    tokens = sum(r.num_generated for r in results)
    lat = sorted(r.latency_seconds for r in results)
    print(f"  batch scheduler SMALL bf16: {len(results)} requests, {tokens} "
          f"tokens in {wall:.3f} s = {tokens / wall:.1f} tok/s; latency p50 "
          f"{np.percentile(lat, 50):.3f} s p99 {np.percentile(lat, 99):.3f} "
          f"s; {batches} batches, occupancy {rows / slots:.3f}; launches "
          f"{launches} [{card}]")

    cfg32 = cfg.scaled(dtype=torch.float32)
    params32 = generation.prepare_params(params, cfg32)
    picks = _tie_free(generation, params32, cfg32, device, prompts, 4,
                      PARITY_BUDGET)
    serve32 = ServeConfig(max_new_tokens=PARITY_BUDGET,
                          prompt_buckets=(b["bucket"],), batch_buckets=(1, 4),
                          flush_deadline_s=0.05, scheduler="batch")
    with ServingEngine(params, cfg32, serve32, device=device) as engine:
        futures = [engine.submit(p) for p in picks]
        served = [f.result(timeout=600) for f in futures]
    _parity("batch engine", generation, params, cfg32, device, picks, served,
            PARITY_BUDGET)
    print(f"  batch engine == generate(): 4/4 requests token-identical "
          f"(SMALL f32, {PARITY_BUDGET} tokens, top-2 gap >= 1e-3)")
    return {"tokens_per_s": tokens / wall,
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p99_s": float(np.percentile(lat, 99)),
            "batches": batches, "mean_batch_occupancy": rows / slots,
            "launches": launches}


def _head_prompts(rng, heads, n, *, cycle, vocab):
    """``n`` prompts of a shared head and a 1..8-token tail: heads drawn at
    random, or in turn with ``cycle``."""
    out = []
    for i in range(n):
        tail = rng.integers(1, vocab, int(rng.integers(1, 9))).astype(
            np.int32)
        head = heads[i % len(heads)] if cycle else heads[
            int(rng.integers(len(heads)))]
        out.append(np.concatenate([head, tail]))
    return out


def _prefix_parity(what, generation, params, cfg32, device, serve, prompts):
    """Serve ``prompts`` one after another through an f32 engine: every
    request token-identical to ``generate()`` (``generate(kv_quant=True)``
    for an int8 grid), the prefix counters equal to ``_replay_prefix``'s,
    the launches equal to the engine's record (K8q for an int8 grid).
    Returns the engine's stats and the launches."""
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.serving import ServingEngine

    with ServingEngine(params, cfg32, serve, device=device) as engine:
        d0 = engine.stats()
        dispatch.reset_launch_counts()
        served = _serve_in_turn(engine, prompts, PARITY_BUDGET)
    launches = dispatch.launch_counts(QUANT_SERVING_KERNELS)
    d1 = engine.stats()
    _check_launches(what, launches, cfg32.num_layers, d0, d1,
                    quantized=serve.kv_quant)
    _parity(what, generation, params, cfg32, device, prompts, served,
            PARITY_BUDGET, kv_quant=serve.kv_quant)
    want = _replay_prefix(serve, prompts)
    got = {"hits": d1["prefix_hits"], "hit_tokens": d1["prefix_hit_tokens"],
           "dram_hits": d1["prefix_dram_hits"],
           "demotions": d1["prefix_dram_demotions"]}
    if got != {k: want[k] for k in got}:
        raise AssertionError(f"{what}: prefix counters {got}, the replay "
                             f"gives {want}")
    gap = QUANT_TIE_GAP if serve.kv_quant else 1e-3
    print(f"  {what} == generate(kv_quant={serve.kv_quant}): "
          f"{len(prompts)}/{len(prompts)} requests token-identical (SMALL "
          f"f32, {PARITY_BUDGET} tokens, top-2 gap >= {gap}, one at a "
          f"time); prefix counters {got} as replayed; launches {launches}")
    return d1, launches


def run_prefix_engine(device, card):
    """3p, bench.py's ``serving_prefix``: 24 requests on 3 system prompts
    of 96 tokens, 64 blocks of 16 tokens, 32-token prefill chunks, through
    the copy route (``decode_kernel="xla"``) and the attach route
    (``"pallas"``), launches checked against the engine's record; then in
    f32, one request at a time, each route with 32-token chunks and with
    whole-suffix prefill at the prompt's bucket (Tq 128 and 512):
    token-identical to ``generate()`` with the replayed prefix counters;
    and on the attach route with whole-suffix prefill and ``kv_quant``
    (K8q at Tq 128 and 512) on prompts tie-free at 1e-2: token-identical
    to ``generate(kv_quant=True)``."""
    import torch

    from cloud_tpu_torch.models import generation
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.serving import ServeConfig, ServingEngine
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    p = PREFIX_SERVE
    cfg, params, _, _ = decode_setup(device=device, seed=0)
    rng = np.random.default_rng(3)
    head_len = p["buckets"][-1] * 3 // 4
    heads = [rng.integers(1, cfg.vocab_size, head_len).astype(np.int32)
             for _ in range(p["heads"])]
    prompts = _head_prompts(rng, heads, p["requests"], cycle=False,
                            vocab=cfg.vocab_size)
    budgets = [int(x) for x in rng.integers(MAX_NEW // 4, MAX_NEW + 1,
                                            p["requests"])]
    out = {"launches": {}}
    for route in ("xla", "pallas"):
        serve = ServeConfig(
            max_new_tokens=MAX_NEW, prompt_buckets=p["buckets"],
            num_slots=NUM_SLOTS, chunk_tokens=CHUNK,
            prefix_cache_blocks=p["blocks"],
            prefix_block_tokens=p["block_tokens"],
            prefill_chunk_tokens=p["pchunk"], decode_kernel=route,
            warmup=True)
        with ServingEngine(params, cfg, serve, device=device) as engine:
            engine.wait_ready()
            engine.submit(prompts[0]).result(timeout=300)
            torch.cuda.synchronize()
            d0 = engine.stats()
            dispatch.reset_launch_counts()
            results, wall = _run_measured(engine, prompts, budgets, wave=4,
                                          pause=0.02)
        launches = dispatch.launch_counts(QUANT_SERVING_KERNELS)
        d1 = engine.stats()
        _check_launches(f"prefix engine ({route})", launches, cfg.num_layers,
                        d0, d1)
        if route == "pallas" and d1["prefix_attaches"] == 0:
            raise AssertionError("attach route attached no hit")
        if route == "xla" and d1["prefix_attaches"]:
            raise AssertionError("copy route attached a hit")
        hits = d1["prefix_hits"] - d0["prefix_hits"]
        lookups = hits + d1["prefix_misses"] - d0["prefix_misses"]
        hit_tokens = d1["prefix_hit_tokens"] - d0["prefix_hit_tokens"]
        ttft = sorted(r.ttft_seconds for r in results)
        tokens = sum(r.num_generated for r in results)
        row = {"hit_tokens_per_s": hit_tokens / wall,
               "hit_rate": hits / lookups if lookups else 0.0,
               "tokens_per_s": tokens / wall,
               "ttft_p50_s": float(np.percentile(ttft, 50)),
               "ttft_p99_s": float(np.percentile(ttft, 99)),
               "evictions": d1["evictions"] - d0["evictions"],
               "prefill_chunks": d1["prefill_chunks"] - d0["prefill_chunks"],
               "decode_chunks": d1["chunks"] - d0["chunks"],
               "hit_tokens": hit_tokens, "launches": launches}
        out[route] = row
        print(f"  prefix cache ({route} route) SMALL bf16: {len(results)} "
              f"requests, {tokens} tokens in {wall:.3f} s = "
              f"{row['tokens_per_s']:.1f} tok/s; hit tokens/s "
              f"{row['hit_tokens_per_s']:.1f}, hit rate {row['hit_rate']:.3f};"
              f" TTFT p50 {row['ttft_p50_s']:.4f} s p99 "
              f"{row['ttft_p99_s']:.4f} s; evictions {row['evictions']}; "
              f"{row['prefill_chunks']} prefill chunks, "
              f"{row['decode_chunks']} decode chunks; launches {launches} "
              f"[{card}]")
        for name, n in launches.items():
            out["launches"][name] = out["launches"].get(name, 0) + n

    cfg32 = cfg.scaled(dtype=torch.float32)
    params32 = generation.prepare_params(params, cfg32)
    # Two prompts on a head that lands in the 128 bucket and two on one
    # that lands in the 512 bucket, alternating.
    long_head = rng.integers(1, cfg.vocab_size, 400).astype(np.int32)
    pairs = [_tie_free(generation, params32, cfg32, device,
                       _head_prompts(rng, [head], 12, cycle=True,
                                     vocab=cfg.vocab_size), 2,
                       PARITY_BUDGET)
             for head in (heads[0], long_head)]
    picks = [pairs[i % 2][i // 2] for i in range(4)]
    by_width = {}
    for route in ("xla", "pallas"):
        for pchunk, buckets in ((p["pchunk"], p["buckets"] + (512,)),
                                (None, BUCKETS)):
            serve = ServeConfig(
                max_new_tokens=PARITY_BUDGET, prompt_buckets=buckets,
                num_slots=2, chunk_tokens=CHUNK,
                prefix_cache_blocks=p["blocks"],
                prefix_block_tokens=p["block_tokens"],
                prefill_chunk_tokens=pchunk, decode_kernel=route)
            d1, launches = _prefix_parity(
                f"prefix engine ({route}, chunk {pchunk})", generation,
                params, cfg32, device, serve, picks)
            for width, n in d1["prefill_chunk_widths"].items():
                by_width[width] = by_width.get(width, 0) + cfg.num_layers * n
            for name, n in launches.items():
                out["launches"][name] = out["launches"].get(name, 0) + n
    out["paged_launches_by_tq"] = by_width
    print(f"  K8 launches of the f32 prefix engines by prefill-chunk width: "
          f"{dict(sorted(by_width.items()))}")

    # kv_quant on the attach route with whole-suffix prefill: K8q at the
    # prompt buckets' widths (Tq 128 and 512), on prompts tie-free at
    # QUANT_TIE_GAP.
    qpairs = [_tie_free_quantized(generation, params32, cfg32, device,
                                  _head_prompts(rng, [head], 24, cycle=True,
                                                vocab=cfg.vocab_size), 2,
                                  PARITY_BUDGET)
              for head in (heads[0], long_head)]
    serve = ServeConfig(
        max_new_tokens=PARITY_BUDGET, prompt_buckets=BUCKETS, num_slots=2,
        chunk_tokens=CHUNK, prefix_cache_blocks=p["blocks"],
        prefix_block_tokens=p["block_tokens"], decode_kernel="pallas",
        kv_quant=True)
    d1, launches = _prefix_parity(
        "prefix engine (pallas, whole suffix, kv_quant)", generation, params,
        cfg32, device, serve, [qpairs[i % 2][i // 2] for i in range(4)])
    out["k8q_launches_by_tq"] = {
        width: cfg.num_layers * n
        for width, n in d1["prefill_chunk_widths"].items()}
    print(f"  K8q launches of the kv_quant prefix engine by prefill-chunk "
          f"width: {out['k8q_launches_by_tq']}")
    for name, n in launches.items():
        out["launches"][name] = out["launches"].get(name, 0) + n
    return out


def run_tier_engine(device, card):
    """3t, bench.py's ``serving_prefix_tier``: 6 system prompts of 96
    tokens cycled through 2 slots and an 18-block pool, the host tier off
    (0 blocks) and on (64), and on at ``pipeline_depth=2`` (its
    whole-stream synchronisations printed), each head seeded once first;
    launches checked against the engine's record.  Then in f32, tier on,
    one request at a time: token-identical to ``generate()`` with the
    replayed hit, swap-in and demotion counts; and the same with
    ``kv_quant`` (int8 grid, pool and host payloads) on prompts tie-free
    at 1e-2: token-identical to ``generate(kv_quant=True)``, K8q (never
    K8) at Tq 1 and at the 32-token chunk width."""
    import torch

    from cloud_tpu_torch.models import generation
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.serving import ServeConfig, ServingEngine
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    t = TIER_SERVE
    cfg, params, _, _ = decode_setup(device=device, seed=0)
    rng = np.random.default_rng(11)
    bucket = PREFIX_SERVE["buckets"][-1]
    heads = [rng.integers(1, cfg.vocab_size, bucket * 3 // 4).astype(np.int32)
             for _ in range(t["heads"])]
    prompts = _head_prompts(rng, heads, t["requests"], cycle=True,
                            vocab=cfg.vocab_size)

    def serve_config(dram, new, warmup, **kw):
        return ServeConfig(
            max_new_tokens=new, prompt_buckets=(bucket,), num_slots=2,
            chunk_tokens=CHUNK, prefix_cache_blocks=t["hbm"],
            prefix_block_tokens=PREFIX_SERVE["block_tokens"],
            prefill_chunk_tokens=PREFIX_SERVE["pchunk"],
            prefix_dram_blocks=dram, warmup=warmup, **kw)

    out = {"launches": {}}
    for arm, dram, depth in (("off", 0, 1), ("on", t["dram"], 1),
                             ("on, depth 2", t["dram"], 2)):
        with ServingEngine(params, cfg, serve_config(
                dram, t["new"], True, pipeline_depth=depth),
                device=device) as engine:
            engine.wait_ready()
            for head in heads:
                engine.submit(np.concatenate([head, head[:1]]),
                              max_new_tokens=2).result(timeout=300)
            torch.cuda.synchronize()
            d0 = engine.stats()
            dispatch.reset_launch_counts()
            results, _ = _run_measured(engine, prompts,
                                       [t["new"]] * len(prompts), wave=4,
                                       pause=0.02)
        launches = dispatch.launch_counts(QUANT_SERVING_KERNELS)
        d1 = engine.stats()
        _check_launches(f"tier {arm}", launches, cfg.num_layers, d0, d1)
        ttft = sorted(r.ttft_seconds for r in results)
        row = {"ttft_p50_s": float(np.percentile(ttft, 50)),
               "ttft_p99_s": float(np.percentile(ttft, 99)),
               "hit_tokens": d1["prefix_hit_tokens"] - d0["prefix_hit_tokens"],
               "swapin_hits": d1["prefix_dram_hits"] - d0["prefix_dram_hits"],
               "demotions": (d1["prefix_dram_demotions"]
                             - d0["prefix_dram_demotions"]),
               "stream_syncs": d1["stream_syncs"] - d0["stream_syncs"],
               "deferred_saves": d1["prefix_deferred_saves"],
               "launches": launches}
        out[arm] = row
        for name, n in launches.items():
            out["launches"][name] = out["launches"].get(name, 0) + n
        print(f"  host tier {arm} (dram {dram}) SMALL bf16: {len(results)} "
              f"requests; TTFT p50 {row['ttft_p50_s']:.4f} s p99 "
              f"{row['ttft_p99_s']:.4f} s; hit tokens {row['hit_tokens']}, "
              f"swap-in hits {row['swapin_hits']}, demotions "
              f"{row['demotions']}, whole-stream syncs "
              f"{row['stream_syncs']}, deferred saves "
              f"{row['deferred_saves']}; launches {launches} [{card}]")

    cfg32 = cfg.scaled(dtype=torch.float32)
    params32 = generation.prepare_params(params, cfg32)
    candidates = _head_prompts(rng, heads * 5, 30, cycle=True,
                               vocab=cfg.vocab_size)
    picks = _tie_free(generation, params32, cfg32, device, candidates, 9,
                      PARITY_BUDGET)
    d1, launches = _prefix_parity(
        "tier engine (on)", generation, params, cfg32, device,
        serve_config(t["dram"], PARITY_BUDGET, False), picks)
    if not d1["prefix_dram_hits"]:
        raise AssertionError("the f32 tier run swapped nothing in")
    for name, n in launches.items():
        out["launches"][name] = out["launches"].get(name, 0) + n

    # kv_quant: an int8 grid and an int8 pool with its host tier, one
    # request at a time, on prompts tie-free at QUANT_TIE_GAP.
    qpicks = _tie_free_quantized(generation, params32, cfg32, device,
                                 candidates, 9, PARITY_BUDGET)
    d1, launches = _prefix_parity(
        "tier engine (on, kv_quant)", generation, params, cfg32, device,
        serve_config(t["dram"], PARITY_BUDGET, False, kv_quant=True),
        qpicks)
    if not d1["prefix_dram_hits"] or not d1["prefill_chunks"]:
        raise AssertionError(f"the kv_quant tier run swapped in "
                             f"{d1['prefix_dram_hits']} hits over "
                             f"{d1['prefill_chunks']} prefill chunks")
    out["k8q_launches_by_tq"] = {
        width: cfg.num_layers * n
        for width, n in d1["prefill_chunk_widths"].items()}
    print(f"  K8q launches of the kv_quant tier engine by prefill-chunk "
          f"width: {out['k8q_launches_by_tq']}")
    for name, n in launches.items():
        out["launches"][name] = out["launches"].get(name, 0) + n
    return out


# ---------------------------------------------------------------------------
# Speculative decoding (phases 2 (verify) and 3s) and fused training
# windows (phase 4f)
# ---------------------------------------------------------------------------

#: bench.py's speculative-decoding configuration (SERVE_SPEC_* there): 12
#: requests of 8..64 prompt tokens with budgets 16..32, spec_k 4, a
#: 3-layer draft.
SPEC_SERVE = {"requests": 12, "bucket": 64, "new": 32, "k": 4,
              "draft_layers": 3}
#: Filled lengths of the 3s grid's eight rows where K8 and K8q are checked
#: and timed at the verify shape (B=8, Tq=spec_k, S=bucket+new).
VERIFY_LENGTHS = (10, 23, 37, 50, 61, 72, 85, 92)


def _verify_inputs(device, dtype, gen):
    """q ``[8, spec_k, H, D]`` and the 3s grid's slot rows, filled to
    ``VERIFY_LENGTHS``, with the engine's all-slot block table."""
    import torch

    b, tq = NUM_SLOTS, SPEC_SERVE["k"]
    s = SPEC_SERVE["bucket"] + SPEC_SERVE["new"]
    slot = {n: torch.randn((b, s, HEADS, HEAD_DIM), generator=gen,
                           device=device).to(dtype) for n in ("k", "v")}
    q = torch.randn((b, tq, HEADS, HEAD_DIM), generator=gen,
                    device=device).to(dtype)
    table = torch.full((b, -(-s // 16)), -1, dtype=torch.int32,
                       device=device)
    cur_len = torch.tensor(VERIFY_LENGTHS, dtype=torch.int32, device=device)
    return q, slot, table, cur_len


def check_paged_verify(device, card):
    """K8 and K8q at the speculative verify shape of phase 3s (B=8 slots,
    Tq = spec_k = 4, S=96, rows of mixed lengths, chunk-causal), q in bf16
    and f32, against the plain version; then each timed in bf16 (kernel,
    plain version and SDPA over the rows, K8q's dequantized beforehand, in
    event and device time) beside its bound."""
    import torch

    from cloud_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device=device).manual_seed(34)
    worst, timed = {}, {}
    for name, quantize in (("paged_attention", False),
                           ("paged_attention_int8", True)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            q, slot, table, cur_len = _verify_inputs(device, dtype, gen)
            if quantize:
                slot = _quantize_leaves(slot)
            out = pa._paged_kernel(q, slot, cur_len, None, table)
            ref = pa._reference(q, slot, cur_len, None, table)
            torch.cuda.synchronize()
            worst[f"{name} {dname}"] = check_close(
                f"{name} {dname} verify shape", out, ref, dname)
        q, slot, table, cur_len = _verify_inputs(device, torch.bfloat16, gen)
        dense = slot
        if quantize:
            slot = _quantize_leaves(slot)
            dense = {n: (slot[n].float() * slot[f"{n}_scale"]).to(
                torch.bfloat16) for n in ("k", "v")}
        kernel, kernel_dev = event_and_device_ms(
            lambda: pa._paged_kernel(q, slot, cur_len, None, table))
        plain, plain_dev = event_and_device_ms(
            lambda: pa._reference(q, slot, cur_len, None, table))
        library, library_dev = event_and_device_ms(
            _sdpa_chunk(q, dense["k"], dense["v"], cur_len))
        b, tq = q.shape[:2]
        s = slot["k"].shape[1]
        # Keys each row's window reads (its last query's), once per head;
        # key-query pairs scored (query t of a row sees cur_len + t keys).
        keys = sum(min(n + tq - 1, s) for n in VERIFY_LENGTHS)
        pairs = sum(min(n + t, s) for n in VERIFY_LENGTHS
                    for t in range(tq))
        per_key = 2 * HEAD_DIM + 8 if quantize else 4 * HEAD_DIM
        nbytes = (keys * HEADS * per_key + 2 * q.numel() * 2
                  + table.numel() * 4 + 4 * b)
        b_ms, b_by = bound_ms(nbytes, 4 * pairs * HEADS * HEAD_DIM,
                              "bfloat16")
        shape = (f"B={b} Tq={tq} S={s} rows {list(VERIFY_LENGTHS)} H={HEADS} "
                 f"D={HEAD_DIM} " + ("int8 K/V, bf16 q" if quantize
                                     else "bf16"))
        print(f"  {name} verify {shape}: max_abs_err bf16 "
              f"{worst[name + ' bfloat16']:.3e} f32 "
              f"{worst[name + ' float32']:.3e} ok; kernel {kernel:.4f} ms "
              f"(device {kernel_dev:.4f}), plain {plain:.4f} "
              f"({plain_dev:.4f}), sdpa {library:.4f} ({library_dev:.4f}), "
              f"bound {b_ms:.5f} ms ({b_by}) [{card}]")
        timed[name] = {
            "ms": kernel, "device_ms": kernel_dev, "plain_ms": plain,
            "plain_device_ms": plain_dev, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library, "library_device_ms": library_dev,
            "shape": shape}
    return {"max_abs_err": worst, "timed": timed}


def run_spec_engine(device, card):
    """3s, bench.py's ``serving_spec``: the same 12 staggered requests
    through three engines (SMALL bf16 target; no draft, a 3-layer draft
    from its own seed, the target as its own draft; spec_k 4, 8 slots,
    bucket 64, chunk 8, warmup): every request resolves with in-vocabulary
    tokens and each run's launches equal what the engine's own record
    implies (K5: 12 a one-shot insert and 3 a draft prefill; K8: 12 a
    layer of a decode chunk's step, and 12 + 3 x spec_k a round); rates,
    acceptance and bf16 mismatches against the run without a draft are
    printed, never asserted.  Then in f32, on prompts whose greedy path
    keeps a top-2 gap of 1e-3: token identity with ``generate()`` with
    the draft and with the target as its own draft; and with
    ``kv_quant`` (int8 grids, target and draft) on prompts tie-free at
    1e-2 under quantization: identity with ``generate(kv_quant=True)``,
    K8q at Tq 1 and 4, no K8."""
    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import generation
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.serving import (
        DraftConfig,
        ServeConfig,
        ServingEngine,
    )
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    sp = SPEC_SERVE
    cfg, params, _, _ = decode_setup(device=device, seed=0)
    dcfg = cfg.scaled(num_layers=sp["draft_layers"])
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    dparams = bridge.init(dcfg, gen, device=device)
    rng = np.random.default_rng(6)
    lengths = rng.integers(8, sp["bucket"] + 1, sp["requests"])
    budgets = [int(x) for x in rng.integers(sp["new"] // 2, sp["new"] + 1,
                                            sp["requests"])]
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]

    def serve_config(draft, new, **kw):
        return ServeConfig(max_new_tokens=new, prompt_buckets=(sp["bucket"],),
                           num_slots=NUM_SLOTS, chunk_tokens=CHUNK,
                           draft=draft, **kw)

    def acceptance(delta):
        return (delta["spec_accepted"] / delta["spec_proposed"]
                if delta["spec_proposed"] else 0.0)

    out = {"launches": {}, "tokens_per_s": {}, "acceptance": {},
           "rolling_acceptance": {}}

    def tally(launches):
        for name, n in launches.items():
            out["launches"][name] = out["launches"].get(name, 0) + n

    runs = {}
    for label, draft in (
            ("no draft", None),
            ("draft", DraftConfig(config=dcfg, params=dparams,
                                  spec_k=sp["k"])),
            ("self", DraftConfig(config=cfg, params=params,
                                 spec_k=sp["k"]))):
        with ServingEngine(params, cfg, serve_config(draft, sp["new"],
                                                     warmup=True),
                           device=device) as engine:
            engine.wait_ready()
            engine.submit(prompts[0]).result(timeout=300)
            torch.cuda.synchronize()
            d0 = engine.stats()
            dispatch.reset_launch_counts()
            results, wall = _run_measured(engine, prompts, budgets,
                                          wave=NUM_SLOTS // 2, pause=0.02)
            launches = dispatch.launch_counts(QUANT_SERVING_KERNELS)
            d1 = engine.stats()
            rolling = engine.health()["spec_acceptance_rate"]
        draft_layers = 0 if draft is None else draft.config.num_layers
        _check_launches(f"spec engine ({label})", launches, cfg.num_layers,
                        d0, d1, draft_layers=draft_layers, spec_k=sp["k"])
        for res, budget in zip(results, budgets):
            if (res.tokens.shape != (budget,) or res.num_generated != budget
                    or res.tokens.min() < 0
                    or res.tokens.max() >= cfg.vocab_size):
                raise AssertionError(f"spec engine ({label}): bad result "
                                     f"{res.tokens.shape} for {budget}")
        tally(launches)
        delta = {k: d1[k] - d0[k] for k in (
            "spec_chunks", "spec_accepted", "spec_proposed", "spec_emitted",
            "draft_prefills", "chunks", "oneshot_inserts")}
        tokens = sum(r.num_generated for r in results)
        runs[label] = results
        out["tokens_per_s"][label] = tokens / wall
        if draft is not None:
            out["acceptance"][label] = acceptance(delta)
            out["rolling_acceptance"][label] = rolling
        print(f"  spec engine SMALL bf16, {label}: {len(results)} requests, "
              f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tok/s;"
              f" {delta}; acceptance {acceptance(delta):.3f} (rolling "
              f"{rolling:.3f}); launches {launches} [{card}]")
    out["bf16_mismatches"] = {
        label: sum(not np.array_equal(a.tokens, b.tokens)
                   for a, b in zip(runs[label], runs["no draft"]))
        for label in ("draft", "self")}
    out["spec_vs_nonspec"] = (out["tokens_per_s"]["draft"]
                              / out["tokens_per_s"]["no draft"])
    print(f"  spec / no draft tokens/s {out['spec_vs_nonspec']:.3f}; "
          f"acceptance {out['acceptance']['draft']:.3f}, self-check "
          f"{out['acceptance']['self']:.3f}; bf16 requests whose tokens "
          f"differ from the run without a draft {out['bf16_mismatches']} of "
          f"{len(prompts)} (printed only) [{card}]")

    cfg32 = cfg.scaled(dtype=torch.float32)
    dcfg32 = dcfg.scaled(dtype=torch.float32)
    params32 = generation.prepare_params(params, cfg32)
    candidates = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                  for n in rng.integers(8, sp["bucket"] + 1, 40)]
    picks = _tie_free(generation, params32, cfg32, device, candidates, 4,
                      PARITY_BUDGET)
    for label, draft in (
            ("draft", DraftConfig(config=dcfg32, params=dparams,
                                  spec_k=sp["k"])),
            ("self", DraftConfig(config=cfg32, params=params,
                                 spec_k=sp["k"]))):
        with ServingEngine(params, cfg32, serve_config(draft, PARITY_BUDGET),
                           device=device) as engine:
            futures = [engine.submit(p) for p in picks]
            served = [f.result(timeout=600) for f in futures]
            rounds = engine.stats()["spec_chunks"]
        if not rounds:
            raise AssertionError(f"f32 spec engine ({label}) ran no round")
        _parity(f"spec engine ({label})", generation, params, cfg32, device,
                picks, served, PARITY_BUDGET)
        print(f"  spec engine ({label}) == generate(): 4/4 requests "
              f"token-identical (SMALL f32, {PARITY_BUDGET} tokens, top-2 "
              f"gap >= 1e-3, {rounds} rounds)")

    qpicks = _tie_free_quantized(generation, params32, cfg32, device,
                                 candidates, 4, PARITY_BUDGET)
    draft = DraftConfig(config=dcfg32, params=dparams, spec_k=sp["k"])
    with ServingEngine(params, cfg32, serve_config(draft, PARITY_BUDGET,
                                                   kv_quant=True),
                       device=device) as engine:
        if engine._draft_cache["k"].dtype != torch.int8:
            raise AssertionError("kv_quant: the draft's grid is not int8")
        d0 = engine.stats()
        dispatch.reset_launch_counts()
        futures = [engine.submit(p) for p in qpicks]
        served = [f.result(timeout=600) for f in futures]
        launches = dispatch.launch_counts(QUANT_SERVING_KERNELS)
        d1 = engine.stats()
    _check_launches("spec engine (kv_quant)", launches, cfg.num_layers, d0,
                    d1, draft_layers=sp["draft_layers"], spec_k=sp["k"],
                    quantized=True)
    tally(launches)
    _parity("spec engine (kv_quant)", generation, params, cfg32, device,
            qpicks, served, PARITY_BUDGET, kv_quant=True)
    print(f"  spec engine (kv_quant, int8 grids) == generate(kv_quant=True):"
          f" 4/4 requests token-identical (SMALL f32, top-2 gap >= "
          f"{QUANT_TIE_GAP}); launches {launches}")
    return out


# ---------------------------------------------------------------------------
# bench.py's serving_decode_kernel and serving_pipeline (phases 3k, 3w and
# 3n) and QoS with streaming (phase 3o)
# ---------------------------------------------------------------------------

#: bench.py's churn probe (SERVE_CHURN_* and SERVE_* there): 24 requests of
#: 8..128 prompt tokens with budgets 16..64, buckets (64, 128), 8 slots,
#: chunk 8, in waves of 4 with 20 ms between.
CHURN_SERVE = {"requests": 24, "bucket": 128, "new": 64, "wave": 4,
               "pause": 0.02}
#: Phase 3w serves the first 12 of the churn requests in each of its six
#: arms (half of them, to keep the whole run within its time limit; every
#: pair is still held token for token, depth 1 against depth 2).
PIPELINE_REQUESTS = 12
#: Where phase 3n leaves the depth-2 arm's timeline (Chrome trace JSON).
PIPELINE_TIMELINE = os.path.join("chiprun_out",
                                 "serving_pipeline_timeline.json")
#: Phase 3o's classes: an interactive tenant against a batch flood.
QOS_SERVE = {"batch": 16, "interactive": 8}


def _churn_workload(vocab, seed):
    """bench.py's churn requests from ``default_rng(seed)``: lengths, then
    budgets, then prompts.  Returns (rng, prompts, budgets)."""
    c = CHURN_SERVE
    rng = np.random.default_rng(seed)
    lengths = rng.integers(8, c["bucket"] + 1, c["requests"])
    budgets = [int(b) for b in rng.integers(c["new"] // 4, c["new"] + 1,
                                            c["requests"])]
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]
    return rng, prompts, budgets


def _churn_config(**kw):
    """The churn probe's engine configuration, fields of ``kw`` on top."""
    from cloud_tpu_torch.serving import ServeConfig

    c = CHURN_SERVE
    return ServeConfig(**dict(dict(
        max_new_tokens=c["new"], prompt_buckets=(c["bucket"] // 2,
                                                 c["bucket"]),
        num_slots=NUM_SLOTS, chunk_tokens=CHUNK), **kw))


def _pct(values, q):
    return float(np.percentile(values, q)) if len(values) else 0.0


def _span_summary(events):
    """Counts of the serving spans a run recorded, and the host bubble's
    total milliseconds."""
    names = [e["name"] for e in events]
    return {"chunk": names.count("serve/chunk"),
            "verify": names.count("serve/verify"),
            "host_bubble": names.count("serve/host_bubble"),
            "dispatch_gap": names.count("serve/dispatch_gap"),
            "host_bubble_ms": sum(e["dur"] for e in events
                                  if e["name"] == "serve/host_bubble") / 1e3}


def _churn_arm(what, params, cfg, serve, prompts, budgets, device, *,
               draft_layers=0, timeline=None):
    """One churn arm: a warmed engine absorbs a first request, then serves
    the workload in waves from launch counts of 0 under a span collector
    (dumped to ``timeline`` if given); launches held to the engine's
    record.  Returns (results, row)."""
    import torch

    from cloud_tpu_torch.monitoring import tracing
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.serving import ServingEngine

    c = CHURN_SERVE
    with ServingEngine(params, cfg, serve, device=device) as engine:
        engine.wait_ready()
        engine.submit(prompts[0]).result(timeout=300)
        torch.cuda.synchronize()
        d0 = engine.stats()
        dispatch.reset_launch_counts()
        with tracing.collecting() as collector:
            results, wall = _run_measured(engine, prompts, budgets,
                                          wave=c["wave"], pause=c["pause"])
            if timeline is not None:
                tracing.dump_timeline(timeline)
        events = collector.events()
    launches = dispatch.launch_counts(QUANT_SERVING_KERNELS)
    d1 = engine.stats()
    _check_launches(what, launches, cfg.num_layers, d0, d1,
                    draft_layers=draft_layers,
                    spec_k=serve.draft.spec_k if serve.draft else 0,
                    quantized=serve.kv_quant)
    for res, budget in zip(results, budgets):
        if (res.tokens.shape != (budget,) or res.tokens.min() < 0
                or res.tokens.max() >= cfg.vocab_size):
            raise AssertionError(f"{what}: bad result {res.tokens.shape} "
                                 f"for budget {budget}")
    tokens = sum(r.num_generated for r in results)
    ttft = [r.ttft_seconds for r in results]
    tpot = [(r.latency_seconds - r.ttft_seconds) / max(r.num_generated - 1, 1)
            for r in results]
    row = {"tokens_per_s": tokens / wall, "wall_s": wall,
           "ttft_p50_s": _pct(ttft, 50), "ttft_p99_s": _pct(ttft, 99),
           "tpot_p50_s": _pct(tpot, 50), "tpot_p99_s": _pct(tpot, 99),
           "dispatch_gap_ms_p50": d1["dispatch_gap_ms_p50"],
           "dispatch_gap_ms_p99": d1["dispatch_gap_ms_p99"],
           "pipeline_depth": d1["pipeline_depth"],
           "stream_syncs": d1["stream_syncs"] - d0["stream_syncs"],
           "chunks": d1["chunks"] - d0["chunks"],
           "spec_chunks": d1["spec_chunks"] - d0["spec_chunks"],
           "spans": _span_summary(events), "launches": launches}
    return results, row


def _mismatches(a, b):
    return sum(not np.array_equal(x.tokens, y.tokens)
               or x.num_generated != y.num_generated for x, y in zip(a, b))


def run_decode_kernel_engine(device, card):
    """3k, bench.py's ``serving_decode_kernel``: the churn requests of
    ``default_rng(6)`` through ``decode_kernel="xla"`` and ``"auto"``
    (SMALL bf16, warmed): tokens equal between the arms, launches held to
    each engine's record; tokens/s, TTFT and TPOT percentiles and
    kernel/xla printed."""
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    cfg, params, _, _ = decode_setup(device=device, seed=0)
    _, prompts, budgets = _churn_workload(cfg.vocab_size, seed=6)
    out = {"launches": {}}
    runs = {}
    for arm in ("xla", "auto"):
        runs[arm], row = _churn_arm(
            f"decode kernel ({arm})", params, cfg,
            _churn_config(decode_kernel=arm, warmup=True), prompts, budgets,
            device)
        out[arm] = row
        for name, n in row["launches"].items():
            out["launches"][name] = out["launches"].get(name, 0) + n
        print(f"  decode_kernel={arm!r} SMALL bf16: {len(prompts)} requests,"
              f" {row['tokens_per_s']:.1f} tok/s; TTFT p50 "
              f"{row['ttft_p50_s']:.4f} s p99 {row['ttft_p99_s']:.4f} s; "
              f"TPOT p50 {row['tpot_p50_s'] * 1e3:.3f} ms p99 "
              f"{row['tpot_p99_s'] * 1e3:.3f} ms; launches {row['launches']}"
              f" [{card}]")
    mismatches = _mismatches(runs["auto"], runs["xla"])
    if mismatches:
        raise AssertionError(f"decode kernel: {mismatches} requests differ "
                             f"between the 'auto' and 'xla' arms")
    out["kernel_vs_xla"] = (out["auto"]["tokens_per_s"]
                            / out["xla"]["tokens_per_s"])
    print(f"  'auto' / 'xla' tokens/s {out['kernel_vs_xla']:.3f}; tokens "
          f"equal in all {len(prompts)} requests [{card}]")
    return out


#: The profiler range around the chunk interval phase 3w measures.
CHUNK_WINDOW = "chip_smoke: one chunk interval"


def _chunk_idle_share(engine, prompts):
    """Device busy and idle share of one decode chunk of a full grid (8
    requests of 64 tokens), after a lead chunk: the host wall between two
    chunk drains, read without the profiler (its CPU tracing slows the
    scheduler's enqueue), and the kernel time of the next chunk interval,
    marked by a ``CHUNK_WINDOW`` range under torch.profiler and clipped to
    it (no synchronisation inside, so the engine's pipeline keeps
    running).  A session that recorded no kernel is run again on a fresh
    grid of requests, ``PROFILE_SESSIONS`` in all; if none did, the wall
    is returned with the device numbers "not measured" (None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def chunks():
        # The counter itself: stats() computes percentiles, and polling it
        # would take the interpreter lock from the scheduler.
        return engine._stats["chunks"]

    def wait_chunks(n, limit=120.0):
        deadline = time.perf_counter() + limit
        while chunks() < n:
            if time.perf_counter() > deadline:
                raise AssertionError("the engine ran no decode chunk")
            time.sleep(1e-3)
        return time.perf_counter()

    for attempt in range(PROFILE_SESSIONS):
        n0 = chunks()
        futures = [engine.submit(p, max_new_tokens=CHURN_SERVE["new"])
                   for p in prompts[:NUM_SLOTS]]
        wait_chunks(n0 + 2)  # every slot filled, a lead chunk drained
        start = wait_chunks(n0 + 3)
        wall_ms = (wait_chunks(n0 + 4) - start) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wait_chunks(n0 + 5)
            with torch.profiler.record_function(CHUNK_WINDOW):
                wait_chunks(n0 + 6)
        for future in futures:
            future.result(timeout=600)
        torch.cuda.synchronize()
        try:
            kernels = {key for _, _, key in _kernel_rows(prof)}
        except ProfilerSilent:
            if attempt == PROFILE_SESSIONS - 1:
                print(f"  (torch.profiler recorded no kernel in "
                      f"{PROFILE_SESSIONS} sessions: the chunk's device "
                      "time and idle share not measured)")
                return {"chunk_wall_ms": wall_ms, "device_busy_ms": None,
                        "profiled_window_ms": None, "idle_share": None}
            _profile_pause(attempt)
            continue
        events = prof.events()
        window = next(e for e in events if e.name == CHUNK_WINDOW
                      and e.device_type == DeviceType.CPU)
        w0, w1 = window.time_range.start, window.time_range.end
        busy_us = sum(max(0.0, min(e.time_range.end, w1)
                          - max(e.time_range.start, w0))
                      for e in events if e.device_type == DeviceType.CUDA
                      and e.name in kernels - {CHUNK_WINDOW})
        return {"chunk_wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
                "profiled_window_ms": (w1 - w0) / 1e3,
                "idle_share": 1 - busy_us / 1e3 / wall_ms}


def run_pipeline_engine(device, card):
    """3w, bench.py's ``serving_pipeline``: the first
    :data:`PIPELINE_REQUESTS` churn requests of ``default_rng(11)`` at
    ``pipeline_depth`` 1 and 2, plain, with phase
    3s's 3-layer draft (spec_k 4) and with ``kv_quant`` (K8q), SMALL bf16,
    warmed, each arm under a span collector: depth 2 token-identical to
    depth 1 in every pair, launches held to each engine's record;
    tokens/s, dispatch-gap p50/p99, the host bubble and the whole-stream
    synchronisations printed, and a chunk's idle share at depth 1 and 2
    (one profiled chunk after a lead chunk).  Then f32 at depth 2, four
    requests at once: token-identical to ``generate()`` (top-2 gap
    1e-3), with the f32 draft, and with ``kv_quant`` to
    ``generate(kv_quant=True)`` (1e-2)."""
    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import generation
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.serving import DraftConfig, ServingEngine
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    sp = SPEC_SERVE
    cfg, params, _, _ = decode_setup(device=device, seed=0)
    rng, prompts, budgets = _churn_workload(cfg.vocab_size, seed=11)
    served_prompts = prompts[:PIPELINE_REQUESTS]
    served_budgets = budgets[:PIPELINE_REQUESTS]
    dcfg = cfg.scaled(num_layers=sp["draft_layers"])
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    dparams = bridge.init(dcfg, gen, device=device)
    arms = (("plain", {}, 0),
            ("draft", {"draft": DraftConfig(config=dcfg, params=dparams,
                                            spec_k=sp["k"])},
             sp["draft_layers"]),
            ("kv_quant", {"kv_quant": True}, 0))
    out = {"launches": {}, "arms": {}}
    for label, kw, draft_layers in arms:
        runs = {}
        for depth in (1, 2):
            name = f"{label}, depth {depth}"
            runs[depth], row = _churn_arm(
                f"pipeline ({name})", params, cfg,
                _churn_config(pipeline_depth=depth, warmup=True, **kw),
                served_prompts, served_budgets, device,
                draft_layers=draft_layers,
                timeline=(PIPELINE_TIMELINE if (label, depth) == ("plain", 2)
                          else None))
            out["arms"][name] = row
            for kernel, n in row["launches"].items():
                out["launches"][kernel] = out["launches"].get(kernel, 0) + n
            print(f"  {name} SMALL bf16: {len(served_prompts)} requests, "
                  f"{row['tokens_per_s']:.1f} tok/s; dispatch gap p50 "
                  f"{row['dispatch_gap_ms_p50']:.3f} ms p99 "
                  f"{row['dispatch_gap_ms_p99']:.3f} ms; host bubble "
                  f"{row['spans']['host_bubble_ms']:.1f} ms over "
                  f"{row['spans']['host_bubble']} drains; stream syncs "
                  f"{row['stream_syncs']}; launches {row['launches']} "
                  f"[{card}]")
        mismatches = _mismatches(runs[2], runs[1])
        if mismatches:
            raise AssertionError(f"pipeline ({label}): {mismatches} requests"
                                 f" differ between depth 1 and depth 2")
        ratio = (out["arms"][f"{label}, depth 2"]["tokens_per_s"]
                 / out["arms"][f"{label}, depth 1"]["tokens_per_s"])
        out[f"{label}_depth2_vs_depth1"] = ratio
        print(f"  {label}: depth 2 / depth 1 tokens/s {ratio:.3f}; tokens "
              f"equal in all {len(served_prompts)} requests [{card}]")

    out["idle_share"] = {}
    for depth in (1, 2):
        with ServingEngine(params, cfg, _churn_config(pipeline_depth=depth,
                                                      warmup=True),
                           device=device) as engine:
            engine.wait_ready()
            engine.submit(prompts[0]).result(timeout=300)
            share = _chunk_idle_share(engine, prompts)
        out["idle_share"][depth] = share
        measured = share["idle_share"] is not None
        print(f"  depth {depth}: one decode chunk of 8 active slots, wall "
              f"{share['chunk_wall_ms']:.3f} ms, " + (
                  f"device kernels {share['device_busy_ms']:.3f} ms (over "
                  f"a profiled chunk interval of "
                  f"{share['profiled_window_ms']:.3f} ms), idle share "
                  f"{share['idle_share']:.3f}" if measured else
                  "device kernels and idle share not measured")
              + f" [{card}]")

    cfg32 = cfg.scaled(dtype=torch.float32)
    dcfg32 = dcfg.scaled(dtype=torch.float32)
    params32 = generation.prepare_params(params, cfg32)
    candidates = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                  for n in rng.integers(8, CHURN_SERVE["bucket"] + 1, 40)]
    picks = _tie_free(generation, params32, cfg32, device, candidates, 4,
                      PARITY_BUDGET)
    qpicks = _tie_free_quantized(generation, params32, cfg32, device,
                                 candidates, 4, PARITY_BUDGET)
    for label, kw, draft_layers, chosen in (
            ("plain", {}, 0, picks),
            ("draft", {"draft": DraftConfig(config=dcfg32, params=dparams,
                                            spec_k=sp["k"])},
             sp["draft_layers"], picks),
            ("kv_quant", {"kv_quant": True}, 0, qpicks)):
        serve = _churn_config(pipeline_depth=2,
                              max_new_tokens=PARITY_BUDGET, **kw)
        with ServingEngine(params, cfg32, serve, device=device) as engine:
            d0 = engine.stats()
            dispatch.reset_launch_counts()
            futures = [engine.submit(p) for p in chosen]
            served = [f.result(timeout=600) for f in futures]
        launches = dispatch.launch_counts(QUANT_SERVING_KERNELS)
        d1 = engine.stats()
        _check_launches(f"pipeline f32 ({label}, depth 2)", launches,
                        cfg.num_layers, d0, d1, draft_layers=draft_layers,
                        spec_k=sp["k"] if draft_layers else 0,
                        quantized=serve.kv_quant)
        _parity(f"pipeline f32 ({label}, depth 2)", generation, params,
                cfg32, device, chosen, served, PARITY_BUDGET,
                kv_quant=serve.kv_quant)
        for name, n in launches.items():
            out["launches"][name] = out["launches"].get(name, 0) + n
        print(f"  depth 2 ({label}) == generate(kv_quant={serve.kv_quant}): "
              f"4/4 requests token-identical (SMALL f32, {PARITY_BUDGET} "
              f"tokens, top-2 gap >= "
              f"{QUANT_TIE_GAP if serve.kv_quant else 1e-3}); launches "
              f"{launches}")
    return out


def check_pipeline_tracing(pipeline, card):
    """3n, the spans of phase 3w's arms (each run under
    ``tracing.collecting()``): ``serve/chunk`` (or ``serve/verify``) spans
    as many as the engine's own count of chunks (rounds);
    ``serve/host_bubble`` and ``serve/dispatch_gap`` at depth 2 only; the
    plain depth-2 arm's timeline left at ``PIPELINE_TIMELINE``."""
    out = {}
    for name, row in pipeline["arms"].items():
        spans, depth = row["spans"], row["pipeline_depth"]
        if spans["chunk"] != row["chunks"] or \
                spans["verify"] != row["spec_chunks"]:
            raise AssertionError(f"{name}: {spans['chunk']} serve/chunk and "
                                 f"{spans['verify']} serve/verify spans for "
                                 f"{row['chunks']} chunks and "
                                 f"{row['spec_chunks']} rounds")
        if (spans["host_bubble"] > 0) != (depth == 2) or \
                (spans["dispatch_gap"] > 0) != (depth == 2):
            raise AssertionError(f"{name}: {spans['host_bubble']} host "
                                 f"bubble and {spans['dispatch_gap']} "
                                 f"dispatch-gap spans at depth {depth}")
        out[name] = spans
    if not os.path.getsize(PIPELINE_TIMELINE):
        raise AssertionError(f"{PIPELINE_TIMELINE} is empty")
    with open(PIPELINE_TIMELINE, encoding="utf-8") as f:
        doc = json.load(f)
    chunks = sum(e.get("name") == "serve/chunk" for e in doc["traceEvents"])
    if chunks != pipeline["arms"]["plain, depth 2"]["chunks"]:
        raise AssertionError(f"the dumped timeline holds {chunks} chunk "
                             f"spans")
    print(f"  spans per arm {out}; timeline of the plain depth-2 arm at "
          f"{PIPELINE_TIMELINE} ({len(doc['traceEvents'])} events) [{card}]")
    return out


def run_qos_engine(device, card):
    """3o, QoS and streaming: SMALL bf16 with ``QosConfig`` (interactive
    weight 8, SLO 0.25 s; batch weight 1, SLO 30 s), a burst of 16 batch
    then 8 interactive requests (churn lengths and budgets), each
    ``stream=True`` with an ``on_token`` hook: every stream's tokens and
    every hook's calls equal the result's row, launches held to the
    engine's record, per-class TTFT printed (never asserted).  Then in
    f32, four requests of both classes streamed: token-identical to
    ``generate()`` (top-2 gap 1e-3)."""
    import torch

    from cloud_tpu_torch.models import generation
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.serving import (
        PriorityClass,
        QosConfig,
        ServingEngine,
    )
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    cfg, params, _, _ = decode_setup(device=device, seed=0)
    rng, prompts, budgets = _churn_workload(cfg.vocab_size, seed=12)
    qos = QosConfig(classes={"interactive": PriorityClass(weight=8.0,
                                                          slo_s=0.25),
                             "batch": PriorityClass(weight=1.0, slo_s=30.0)},
                    default_priority="batch")
    classes = (["batch"] * QOS_SERVE["batch"]
               + ["interactive"] * QOS_SERVE["interactive"])

    def burst(engine, chosen, chosen_budgets):
        streams, hooks = [], []
        for prompt, budget, name in zip(chosen, chosen_budgets, classes):
            seen = []
            hooks.append(seen)
            streams.append(engine.submit(
                prompt, max_new_tokens=budget, priority=name, stream=True,
                on_token=lambda i, t, seen=seen: seen.append((i, t))))
        results = [s.result(timeout=600) for s in streams]
        for stream, seen, res in zip(streams, hooks, results):
            row = res.tokens[:res.num_generated].tolist()
            if list(stream) != row or seen != list(enumerate(row)):
                raise AssertionError("a stream or on_token hook differs "
                                     "from its result's row")
        return results

    with ServingEngine(params, cfg, _churn_config(qos=qos, warmup=True),
                       device=device) as engine:
        engine.wait_ready()
        engine.submit(prompts[0]).result(timeout=300)
        torch.cuda.synchronize()
        d0 = engine.stats()
        dispatch.reset_launch_counts()
        start = time.perf_counter()
        results = burst(engine, prompts, budgets)
        wall = time.perf_counter() - start
    launches = dispatch.launch_counts(QUANT_SERVING_KERNELS)
    d1 = engine.stats()
    _check_launches("qos engine", launches, cfg.num_layers, d0, d1)
    ttft = {name: _pct([r.ttft_seconds for r, c in zip(results, classes)
                        if c == name], 50) for name in ("interactive",
                                                        "batch")}
    tokens = sum(r.num_generated for r in results)
    out = {"tokens_per_s": tokens / wall, "ttft_p50_s": ttft,
           "class_completed": d1["class_completed"], "launches": launches}
    print(f"  QoS SMALL bf16: {len(results)} streamed requests ("
          f"{QOS_SERVE['batch']} batch first, then {QOS_SERVE['interactive']}"
          f" interactive), {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.1f} tok/s; TTFT p50 interactive "
          f"{ttft['interactive']:.4f} s, batch {ttft['batch']:.4f} s "
          f"(printed only); streams and hooks equal the results; launches "
          f"{launches} [{card}]")

    cfg32 = cfg.scaled(dtype=torch.float32)
    params32 = generation.prepare_params(params, cfg32)
    candidates = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                  for n in rng.integers(8, CHURN_SERVE["bucket"] + 1, 40)]
    picks = _tie_free(generation, params32, cfg32, device, candidates, 4,
                      PARITY_BUDGET)
    serve32 = _churn_config(qos=qos, max_new_tokens=PARITY_BUDGET)
    classes = ["batch", "interactive", "batch", "interactive"]
    with ServingEngine(params, cfg32, serve32, device=device) as engine:
        served = burst(engine, picks, [PARITY_BUDGET] * 4)
    _parity("qos engine", generation, params, cfg32, device, picks, served,
            PARITY_BUDGET)
    print(f"  QoS engine == generate(): 4/4 streamed requests "
          f"token-identical (SMALL f32, {PARITY_BUDGET} tokens, top-2 gap "
          f">= 1e-3)")
    return out


#: bench.py's fleet probes (FLEET_*, DISAGG_* there): ``fleet`` on the churn
#: workload, ``fleet_qps_sweep``'s open-loop arrivals and
#: ``fleet_disagg``'s flash crowd, colocated against 1 prefill / 2 decode.
FLEET_SERVE = {"replicas": 2, "poll": 0.1}
SWEEP_SERVE = {"qps": (2, 4, 8, 16), "requests": 12, "prompt": 32, "new": 16,
               "slots": 2}
DISAGG_SERVE = {"replicas": 3, "requests": 12, "prompt": 120, "bucket": 128,
                "head": 24, "new": 16, "blocks": 96, "block_tokens": 8,
                "pchunk": 32, "slots": 2}
#: The serving-engine threads and the fleet's: none may outlive a fleet.
FLEET_THREAD_PREFIXES = ("cloud-tpu-fleet", "cloud-tpu-torch-serve")


def _engine_stats(fleet):
    """Each replica's engine ``stats()``, by replica id (read while the
    fleet is open: a closed or rebuilt engine's counters are gone)."""
    return {r.id: r.engine.stats() for r in fleet.replicas()}


def _summed(stats):
    """The replicas' integer counters, summed."""
    first = next(iter(stats.values()))
    return {key: sum(s[key] for s in stats.values())
            for key, value in first.items() if type(value) is int}


def _check_fleet_launches(what, launches, layers_n, d0, d1):
    """A fleet run's launches held to its replicas' own records: the
    engines of the two snapshots must be the same (no restart), and the
    launch formulas of ``_check_launches`` apply to the summed deltas."""
    if sorted(d0) != sorted(d1):
        raise AssertionError(f"{what}: replicas changed during the run "
                             f"({sorted(d0)} -> {sorted(d1)})")
    _check_launches(what, launches, layers_n, _summed(d0), _summed(d1))


def _no_fleet_threads(what):
    import threading

    left = [t.name for t in threading.enumerate()
            if t.name.startswith(FLEET_THREAD_PREFIXES)]
    if left:
        raise AssertionError(f"{what}: threads outlived the fleet: {left}")


def _check_tokens(what, results, budgets, vocab):
    for res, budget in zip(results, budgets):
        if (res.tokens.shape != (budget,) or res.tokens.min() < 0
                or res.tokens.max() >= vocab):
            raise AssertionError(f"{what}: bad result {res.tokens.shape} "
                                 f"for budget {budget}")


def _latency_row(results, wall):
    ttft = [r.ttft_seconds for r in results]
    tpot = [(r.latency_seconds - r.ttft_seconds) / max(r.num_generated - 1, 1)
            for r in results]
    latency = [r.latency_seconds for r in results]
    tokens = sum(r.num_generated for r in results)
    return {"tokens_per_s": tokens / wall, "wall_s": wall,
            "latency_p50_s": _pct(latency, 50),
            "latency_p99_s": _pct(latency, 99),
            "ttft_p50_s": _pct(ttft, 50), "ttft_p99_s": _pct(ttft, 99),
            "tpot_p50_s": _pct(tpot, 50), "tpot_p99_s": _pct(tpot, 99)}


def _ttft_shares(what, events, results, *, gate):
    """bench.py's ``_emit_ttft_decomposition``: the fleet TTFT's p99 share
    of each component over this run's traced requests, read through the
    port's ``TraceReport``.  With ``gate``, every traced request must
    stitch a complete lifecycle with its ``fleet/route``."""
    from cloud_tpu_torch.monitoring.report import TraceReport

    trace_ids = {r.trace_id for r in results if r.trace_id}
    if len(trace_ids) != len(results):
        raise AssertionError(f"{what}: {len(results) - len(trace_ids)} "
                             f"results carry no trace id")
    report = TraceReport(events)
    summary = report.request_summary() or {}
    mine = {t: summary[t] for t in trace_ids if t in summary}
    if gate:
        incomplete = sorted(t for t in trace_ids
                            if not mine.get(t, {}).get("complete")
                            or not mine.get(t, {}).get("routes"))
        if incomplete:
            raise AssertionError(
                f"{what}: {len(incomplete)}/{len(trace_ids)} traced requests "
                f"did not stitch a complete lifecycle (first: "
                f"{incomplete[0]})")
    decomposition = report.ttft_decomposition(mine)
    if not decomposition:
        return {}
    return {"shares_p99": {name: decomposition["shares"][name]["p99"]
                          for name in TraceReport.TTFT_COMPONENTS},
            "traced_ttft_p99_s": decomposition["ttft_p99_s"],
            "requests": decomposition["requests"]}


def _f32_fleet_parity(what, generation, params, cfg32, device, serve32,
                      picks, budget, *, roles=None):
    """``picks`` through a fleet of f32 engines, one request at a time:
    token-identical to ``generate()``.  Returns the fleet's stats."""
    from cloud_tpu_torch.fleet import Fleet, FleetConfig
    from cloud_tpu_torch.serving import ServingEngine

    n = len(roles) if roles else FLEET_SERVE["replicas"]
    with Fleet(lambda: ServingEngine(params, cfg32, serve32, device=device),
               FleetConfig(min_replicas=n, max_replicas=n,
                           poll_interval_s=FLEET_SERVE["poll"],
                           roles=roles)) as fleet:
        served = [fleet.submit(p, max_new_tokens=budget).result(timeout=600)
                  for p in picks]
        stats = fleet.stats()
    _no_fleet_threads(what)
    _parity(what, generation, params, cfg32, device, picks, served, budget)
    return stats


def run_fleet(device, card):
    """3f, bench.py's ``fleet``: the churn requests of ``default_rng(2)``
    (24 requests of 8-128 tokens, budgets 16-64, waves of 4 with 0.02 s
    pauses) through a 2-replica ``Fleet`` of SMALL bf16 engines (buckets
    (64, 128), 8 slots, chunk 8, ``admission="reject"``, warmed), under a
    span collector: tokens in the vocabulary, K5/K8 launches held to the
    replicas' own records summed; tokens/s, latency p50/p99, failovers and
    the TTFT decomposition's p99 shares printed.  Then four f32 tie-free
    prompts through a 2-replica f32 fleet one at a time: token-identical
    to ``generate()``."""
    import torch

    from cloud_tpu_torch.fleet import Fleet, FleetConfig
    from cloud_tpu_torch.models import generation
    from cloud_tpu_torch.monitoring import tracing
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.serving import ServingEngine
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    c = CHURN_SERVE
    cfg, params, _, _ = decode_setup(device=device, seed=0)
    rng, prompts, budgets = _churn_workload(cfg.vocab_size, seed=2)
    serve = _churn_config(warmup=True, admission="reject",
                          batch_buckets=(1, NUM_SLOTS))
    n = FLEET_SERVE["replicas"]
    with tracing.collecting() as collector:
        with Fleet(lambda: ServingEngine(params, cfg, serve, device=device),
                   FleetConfig(min_replicas=n, max_replicas=n,
                               poll_interval_s=FLEET_SERVE["poll"])) as fleet:
            fleet.wait_ready()
            fleet.submit(prompts[0]).result(timeout=300)
            torch.cuda.synchronize()
            d0 = _engine_stats(fleet)
            before = fleet.stats()
            dispatch.reset_launch_counts()
            results, wall = _run_measured(fleet, prompts, budgets,
                                          wave=c["wave"], pause=c["pause"])
            d1 = _engine_stats(fleet)
            stats = fleet.stats()
        events = collector.events()
    launches = dispatch.launch_counts(QUANT_SERVING_KERNELS)
    _no_fleet_threads("fleet")
    _check_fleet_launches("fleet", launches, cfg.num_layers, d0, d1)
    _check_tokens("fleet", results, budgets, cfg.vocab_size)
    out = _latency_row(results, wall)
    routed = {rid: stats["routed"].get(rid, 0) - before["routed"].get(rid, 0)
              for rid in d1}
    out.update({"failovers": stats["failovers"], "routed": routed,
                "restarts": stats["restarts"],
                "stream_syncs": {rid: d1[rid]["stream_syncs"]
                                 - d0[rid]["stream_syncs"] for rid in d1},
                "ttft": _ttft_shares("fleet", events, results, gate=False),
                "launches": launches})
    shares = out["ttft"].get("shares_p99", {})
    print(f"  fleet SMALL bf16, {n} replicas x {NUM_SLOTS} slots: "
          f"{len(results)} requests, {out['tokens_per_s']:.1f} tok/s; "
          f"latency p50 {out['latency_p50_s']:.4f} s p99 "
          f"{out['latency_p99_s']:.4f} s; failovers {stats['failovers']}; "
          f"routed {routed}; stream syncs {out['stream_syncs']}; TTFT p99 "
          f"shares {', '.join(f'{k} {v:.3f}' for k, v in shares.items())}; "
          f"launches {launches} [{card}]")

    cfg32 = cfg.scaled(dtype=torch.float32)
    params32 = generation.prepare_params(params, cfg32)
    candidates = [rng.integers(1, cfg.vocab_size, k).astype(np.int32)
                  for k in rng.integers(8, c["bucket"] + 1, 40)]
    picks = _tie_free(generation, params32, cfg32, device, candidates, 4,
                      PARITY_BUDGET)
    _f32_fleet_parity("fleet", generation, params, cfg32, device,
                      _churn_config(max_new_tokens=PARITY_BUDGET,
                                    admission="reject"),
                      picks, PARITY_BUDGET)
    print(f"  fleet == generate(): 4/4 requests one at a time "
          f"token-identical (SMALL f32, {n} replicas, {PARITY_BUDGET} "
          f"tokens, top-2 gap >= 1e-3)")
    return out


def run_fleet_qps_sweep(device, card):
    """3v, bench.py's ``fleet_qps_sweep``: a 2-replica QoS ``Fleet`` of
    SMALL bf16 engines (2 slots, bucket 32, 16 new tokens, chunk 8,
    ``QosConfig()`` on the engines and the fleet, warmed); open-loop
    arrivals of 12 requests of 32 tokens from ``default_rng(3)`` at QPS 2,
    4, 8 and 16, classes alternating interactive and batch, under a span
    collector: every traced request stitches one lifecycle with its
    ``fleet/route`` and terminal ``serve/request`` (bench.py's completeness
    gate, through the port's ``TraceReport``), launches held to the
    replicas' records; tokens/s, TTFT and TPOT p50/p99 per point and TTFT
    p99 per class printed."""
    import torch

    from cloud_tpu_torch.fleet import Fleet, FleetConfig
    from cloud_tpu_torch.monitoring import tracing
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.serving import QosConfig, ServeConfig, ServingEngine
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    s = SWEEP_SERVE
    cfg, params, _, _ = decode_setup(device=device, seed=0)
    serve = ServeConfig(max_new_tokens=s["new"], prompt_buckets=(s["prompt"],),
                        batch_buckets=(1, s["slots"]), num_slots=s["slots"],
                        chunk_tokens=CHUNK, warmup=True, qos=QosConfig())
    rng = np.random.default_rng(3)
    n = FLEET_SERVE["replicas"]
    points = {}
    sweep = []
    with tracing.collecting() as collector:
        with Fleet(lambda: ServingEngine(params, cfg, serve, device=device),
                   FleetConfig(min_replicas=n, max_replicas=n,
                               poll_interval_s=FLEET_SERVE["poll"],
                               qos=QosConfig())) as fleet:
            fleet.wait_ready()
            fleet.submit(rng.integers(1, cfg.vocab_size, 4).astype(np.int32),
                         max_new_tokens=2).result(timeout=300)
            torch.cuda.synchronize()
            d0 = _engine_stats(fleet)
            dispatch.reset_launch_counts()
            for qps in s["qps"]:
                prompts = [rng.integers(1, cfg.vocab_size, s["prompt"])
                           .astype(np.int32) for _ in range(s["requests"])]
                classes = ["interactive" if i % 2 == 0 else "batch"
                           for i in range(s["requests"])]
                start = time.perf_counter()
                futures = []
                for i, prompt in enumerate(prompts):
                    delay = start + i / qps - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    futures.append(fleet.submit(
                        prompt, max_new_tokens=s["new"], priority=classes[i]))
                results = [f.result(timeout=600) for f in futures]
                wall = time.perf_counter() - start
                _check_tokens(f"fleet sweep q{qps}", results,
                              [s["new"]] * len(results), cfg.vocab_size)
                row = _latency_row(results, wall)
                for name in ("interactive", "batch"):
                    row[f"{name}_ttft_p99_s"] = _pct(
                        [r.ttft_seconds for r, k in zip(results, classes)
                         if k == name], 99)
                points[qps] = row
                sweep.extend(results)
            d1 = _engine_stats(fleet)
        events = collector.events()
    launches = dispatch.launch_counts(QUANT_SERVING_KERNELS)
    _no_fleet_threads("fleet sweep")
    _check_fleet_launches("fleet sweep", launches, cfg.num_layers, d0, d1)
    ttft = _ttft_shares("fleet sweep", events, sweep, gate=True)
    for qps, row in points.items():
        print(f"  QPS {qps}: {row['tokens_per_s']:.1f} tok/s; TTFT p50 "
              f"{row['ttft_p50_s']:.4f} s p99 {row['ttft_p99_s']:.4f} s "
              f"(interactive {row['interactive_ttft_p99_s']:.4f}, batch "
              f"{row['batch_ttft_p99_s']:.4f}); TPOT p50 "
              f"{row['tpot_p50_s'] * 1e3:.3f} ms p99 "
              f"{row['tpot_p99_s'] * 1e3:.3f} ms [{card}]")
    print(f"  {len(sweep)}/{len(sweep)} traced requests stitched with their "
          f"fleet/route and serve/request; TTFT p99 shares "
          f"{', '.join(f'{k} {v:.3f}' for k, v in ttft['shares_p99'].items())}"
          f"; launches {launches} [{card}]")
    return {"points": points, "ttft": ttft, "launches": launches}


def _disagg_prompts(rng, vocab, n=DISAGG_SERVE["requests"]):
    """bench.py's flash crowd: ``n`` prompts of ``prompt`` tokens sharing
    a ``head``-token head."""
    d = DISAGG_SERVE
    head = rng.integers(1, vocab, d["head"])
    return [np.concatenate([head, rng.integers(1, vocab, d["prompt"]
                                               - d["head"])]).astype(np.int32)
            for _ in range(n)]


def _disagg_config(**kw):
    from cloud_tpu_torch.serving import ServeConfig

    d = DISAGG_SERVE
    return ServeConfig(**dict(dict(
        max_new_tokens=d["new"], prompt_buckets=(d["bucket"],),
        batch_buckets=(1, d["slots"]), num_slots=d["slots"],
        chunk_tokens=CHUNK, prefix_cache_blocks=d["blocks"],
        prefix_block_tokens=d["block_tokens"],
        prefill_chunk_tokens=d["pchunk"]), **kw))


def run_fleet_disagg(device, card):
    """3x, bench.py's ``fleet_disagg``: 12 flash-crowd prompts of 120
    tokens with a 24-token shared head (``default_rng(19)``), 16 new
    tokens, through a colocated 3-replica ``Fleet`` and then through
    ``roles=("prefill", "decode", "decode")`` with the KV handoff across
    the host pool (SMALL bf16, 2 slots, 96 prefix blocks of 8 tokens,
    32-token prefill chunks, warmed), each arm one burst: bf16 tokens equal
    across the arms (bench.py's gate), the disagg arm's handoffs one per
    request (its warm-up's too), no handoff failover, the host pool
    deduplicating, launches held to each arm's replicas' records (K8 at
    Tq 32 for every prefill chunk); TTFT/TPOT p50/p99, tokens/s, pool puts
    and the import and export block counts printed.  Then four f32
    tie-free flash-crowd prompts through a 1 prefill / 2 decode f32 fleet
    one at a time: token-identical to ``generate()``."""
    import torch

    from cloud_tpu_torch.fleet import Fleet, FleetConfig
    from cloud_tpu_torch.models import generation
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.serving import ServingEngine
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    d = DISAGG_SERVE
    cfg, params, _, _ = decode_setup(device=device, seed=0)
    serve = _disagg_config(warmup=True)
    rng = np.random.default_rng(19)
    prompts = _disagg_prompts(rng, cfg.vocab_size)
    disagg_roles = ("prefill", "decode", "decode")
    out = {"launches": {}}
    reference = None
    for arm, roles in (("colocated", None), ("disagg", disagg_roles)):
        with Fleet(lambda: ServingEngine(params, cfg, serve, device=device),
                   FleetConfig(min_replicas=d["replicas"],
                               max_replicas=d["replicas"],
                               poll_interval_s=FLEET_SERVE["poll"],
                               roles=roles)) as fleet:
            fleet.wait_ready()
            fleet.submit(rng.integers(1, cfg.vocab_size, 8).astype(np.int32),
                         max_new_tokens=2).result(timeout=300)
            torch.cuda.synchronize()
            d0 = _engine_stats(fleet)
            dispatch.reset_launch_counts()
            start = time.perf_counter()
            futures = [fleet.submit(p, max_new_tokens=d["new"])
                       for p in prompts]
            results = [f.result(timeout=600) for f in futures]
            wall = time.perf_counter() - start
            d1 = _engine_stats(fleet)
            stats = fleet.stats()
            health = fleet.health()
        launches = dispatch.launch_counts(QUANT_SERVING_KERNELS)
        _no_fleet_threads(f"fleet disagg ({arm})")
        _check_fleet_launches(f"fleet disagg ({arm})", launches,
                              cfg.num_layers, d0, d1)
        _check_tokens(f"fleet disagg ({arm})", results,
                      [d["new"]] * len(results), cfg.vocab_size)
        tokens = [r.tokens.tolist() for r in results]
        if reference is None:
            reference = tokens
        else:
            diverged = sum(a != b for a, b in zip(tokens, reference))
            if diverged:
                raise AssertionError(
                    f"fleet disagg: {diverged}/{len(tokens)} requests "
                    f"decoded different bf16 tokens in the disagg arm")
        row = _latency_row(results, wall)

        def delta(key, d0=d0, d1=d1):
            return {rid: d1[rid][key] - d0[rid][key] for rid in d1}

        widths = {rid: {w: d1[rid]["prefill_chunk_widths"].get(w, 0)
                        - d0[rid]["prefill_chunk_widths"].get(w, 0)
                        for w in d1[rid]["prefill_chunk_widths"]}
                  for rid in d1}
        row.update({"handoffs": stats["handoffs"],
                    "handoff_failovers": stats["handoff_failovers"],
                    "host_pool": stats["host_pool"],
                    "roles": [s["role"] for s in health["replicas"]],
                    "prefill_chunk_widths": widths,
                    "prefix_hits": delta("prefix_hits"),
                    "export_blocks": delta("handoff_export_blocks"),
                    "import_blocks": delta("handoff_import_blocks"),
                    "stream_syncs": delta("stream_syncs"),
                    "launches": launches})
        for name, count in launches.items():
            out["launches"][name] = out["launches"].get(name, 0) + count
        out[arm] = row
        if roles is not None:
            want = len(prompts) + 1  # the warm-up request is handed off too
            if stats["handoffs"] != want:
                raise AssertionError(f"fleet disagg: {stats['handoffs']} "
                                     f"handoffs, expected {want}")
            if stats["handoff_failovers"]:
                raise AssertionError(f"fleet disagg: "
                                     f"{stats['handoff_failovers']} handoff "
                                     f"failovers in a healthy run")
            if stats["host_pool"]["dedup_hits"] <= 0:
                raise AssertionError("fleet disagg: the host pool "
                                     "deduplicated nothing")
            if row["roles"] != list(disagg_roles):
                raise AssertionError(f"fleet disagg: roles {row['roles']}")
        print(f"  {arm}: {len(results)} requests, {row['tokens_per_s']:.1f} "
              f"tok/s; TTFT p50 {row['ttft_p50_s']:.4f} s p99 "
              f"{row['ttft_p99_s']:.4f} s; TPOT p50 "
              f"{row['tpot_p50_s'] * 1e3:.3f} ms p99 "
              f"{row['tpot_p99_s'] * 1e3:.3f} ms; handoffs "
              f"{stats['handoffs']}, host pool {stats['host_pool']}; export "
              f"blocks {row['export_blocks']}, import blocks "
              f"{row['import_blocks']}; prefill chunk widths {widths}; "
              f"stream syncs {row['stream_syncs']}; launches {launches} "
              f"[{card}]")
    print(f"  bf16 tokens equal across the arms in all {len(prompts)} "
          f"requests")

    cfg32 = cfg.scaled(dtype=torch.float32)
    params32 = generation.prepare_params(params, cfg32)
    picks = _tie_free(generation, params32, cfg32, device,
                      _disagg_prompts(rng, cfg.vocab_size, 40), 4, d["new"])
    stats = _f32_fleet_parity("fleet disagg", generation, params, cfg32,
                              device, _disagg_config(), picks, d["new"],
                              roles=disagg_roles)
    if stats["handoffs"] != len(picks):
        raise AssertionError(f"fleet disagg f32: {stats['handoffs']} "
                             f"handoffs for {len(picks)} requests")
    print(f"  disagg fleet == generate(): 4/4 requests one at a time "
          f"token-identical, each handed off (SMALL f32, {d['new']} tokens, "
          f"top-2 gap >= 1e-3)")
    return out


#: The fused window of bench.py's _measure_fused (FUSED_* there).
FUSED_K, FUSED_WARMUP, FUSED_MEASURE = 4, 1, 5
#: K5, K6 and K7 launches of one step of SMALL at 2 layers (remat: K5
#: twice a layer).
LM2_PER_STEP = {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}


def _window_launches(what, launches, window, before, per_step, steps):
    """A window's launches: its warm-up steps and ``steps`` a replay, each
    ``per_step``; nothing for the capture."""
    warm = window.warmup_steps - before[0]
    replays = window.replays - before[1]
    want = {k: n * (warm + steps * replays) for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} != {want} ("
                             f"{warm} warm-up steps, {replays} replays of "
                             f"{steps} steps)")


def _hold(what, got, want, rel):
    """Each leaf of ``got`` within ``rel`` of max(1, max |want|) of
    ``want``'s; returns the largest difference."""
    worst = 0.0
    for a, b in zip(got, want):
        err = max_err(a.detach(), b.detach())
        if not err <= rel * max(1.0, float(b.detach().float().abs().max())):
            raise AssertionError(f"{what}: max_abs_err {err:.3e}")
        worst = max(worst, err)
    return worst


def check_gn_graph(device):
    """K1-K4 captured in a CUDA graph (their cluster launches included):
    a replay's outputs and gradients equal an eager call's bit for bit,
    at a CIFAR b256 shape, with and without residual and relu."""
    import torch

    from cloud_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device=device).manual_seed(35)
    shape = (CIFAR_BATCH, 16, 16, 128)

    def call(x, scale, bias, res, dy, residual):
        y = gn.group_norm(x, scale, bias, num_groups=GN_GROUPS,
                          activation="relu" if residual else None,
                          residual=res if residual else None)
        inputs = (x, scale, bias) + ((res,) if residual else ())
        return (y,) + torch.autograd.grad(y, inputs, dy)

    for residual in (False, True):
        x, res = (torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16).requires_grad_(True) for _ in range(2))
        dy = torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16)
        scale, bias = (torch.randn(shape[-1], generator=gen, device=device)
                       .requires_grad_(True) for _ in range(2))
        # Detached: no autograd node of the eager call may outlive it (a
        # leaf's gradient node made on the default stream cannot join a
        # capture).
        eager = [t.detach() for t in call(x, scale, bias, res, dy, residual)]
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            call(x, scale, bias, res, dy, residual)
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            captured = call(x, scale, bias, res, dy, residual)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, eager):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"GroupNorm replayed from a CUDA graph (residual="
                    f"{residual}) differs from the eager call by "
                    f"{max_err(a, b):.3e}")
    print(f"  K1-K4 replayed from a CUDA graph == eager, bit for bit "
          f"({shape}, bf16, with and without residual)")


def check_fused_windows(device, card):
    """The window's CUDA graph against eager steps from the same state,
    on the card: (1) ResNet-50 CIFAR f32 b8, SGD momentum, a K=4 window
    against 4 ``make_train_step`` steps, cuDNN's deterministic algorithms
    on both sides: parameters and momentum within 1e-4 of max(1, max
    |p|), the step count exact; (2) the same window
    with ``valid=[1, 1, 0, 0]`` against 2 steps; (3) SMALL at 2 layers in
    f32 (b2 x T256, remat, tied head) with ``adamw(1e-4)``: parameters and
    both moments within 1e-6 of max(1, max |p|) (the rule of 6b's AdamW
    check on identical gradients: graph and eager run the same kernels)
    and the count K on both (a bias correction frozen at capture moves
    the parameters by ~lr); each with its exact graph launches.  Then K1-K4
    alone: a replay equals an eager call bit for bit."""
    import dataclasses
    import functools

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import resnet, transformer
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.training import optimizers, train

    k = FUSED_K
    errs = {}
    cfg = dataclasses.replace(resnet.RESNET50_CIFAR, dtype=torch.float32)
    params = bridge.init_resnet(cfg, torch.Generator().manual_seed(3),
                                device="cpu")
    rng = np.random.default_rng(4)
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, (k, 8)))
    images = torch.from_numpy(rng.normal(size=(k, 8, 32, 32, 3)).astype(
        np.float32))
    batch = {"image": images.to(device), "label": labels.to(device)}
    loss = functools.partial(resnet.loss_fn, config=cfg, device=device)
    tx = optimizers.sgd(0.1, momentum=0.9)

    def fresh(p, opt):
        return train.create_sharded_state(
            None, lambda _: bridge.map_leaves(p, torch.clone), opt,
            device=device)

    window = train.make_multi_step(loss, tx, steps_per_dispatch=k)
    step = train.make_train_step(loss, tx)
    # cuDNN's f32 convolutions are not deterministic by default: two eager
    # runs of these steps differ by ~7e-7, which a run's relu and max-pool
    # gates once amplified past the limit on an H100.  With deterministic
    # algorithms the graph and the eager steps compute the same sums.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for what, valid in (("window", None), ("tail [1, 1, 0, 0]",
                                           [1.0, 1.0, 0.0, 0.0])):
        run = [i for i in range(k) if valid is None or valid[i] > 0]
        before = (window.warmup_steps, window.replays)
        dispatch.reset_launch_counts()
        got, metrics = window(fresh(params, tx), batch, None if valid is None
                              else torch.tensor(valid))
        torch.cuda.synchronize()
        _window_launches(f"f32 ResNet {what}", dispatch.launch_counts(
            GN_KERNELS), window, before, GN_PER_STEP, len(run))
        want = fresh(params, tx)
        for i in run:
            want, _ = step(want, {n: t[i] for n, t in batch.items()})
        if not int(got.step) == int(want.step) == len(run):
            raise AssertionError(f"f32 ResNet {what}: step {int(got.step)} "
                                 f"!= {int(want.step)}")
        errs[f"resnet {what} params"] = _hold(
            f"f32 ResNet {what} params", bridge.leaves(got.params),
            bridge.leaves(want.params), TOL_F32)
        errs[f"resnet {what} momentum"] = _hold(
            f"f32 ResNet {what} momentum", bridge.leaves(got.opt_state),
            bridge.leaves(want.opt_state), TOL_F32)
        print(f"  f32 ResNet-50 CIFAR b8 {what} (CUDA graph) vs {len(run)} "
              f"eager steps: params max_abs_err "
              f"{errs[f'resnet {what} params']:.3e}, momentum "
              f"{errs[f'resnet {what} momentum']:.3e} (tol 1e-4 x max(1, "
              f"max|p|)), step {int(got.step)}, loss "
              f"{float(metrics['loss']):.5f} ok [{card}]")
    torch.backends.cudnn.deterministic = deterministic
    del window, step
    torch.cuda.empty_cache()

    lm_cfg = transformer.SMALL.scaled(tied_embeddings=True, num_layers=2,
                                      dtype=torch.float32)
    lm_params = bridge.init(lm_cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    tokens = np.random.default_rng(4).integers(1, lm_cfg.vocab_size,
                                               (k, 2, 256))
    lm_batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(
        device)}
    adamw = optimizers.adamw(1e-4, mu_dtype=None)
    lm_loss = functools.partial(transformer.loss_fn, config=lm_cfg,
                                device=device)
    window = train.make_multi_step(lm_loss, adamw, steps_per_dispatch=k)
    before = (window.warmup_steps, window.replays)
    dispatch.reset_launch_counts()
    got, _ = window(fresh(lm_params, adamw), lm_batch)
    torch.cuda.synchronize()
    _window_launches("f32 LM AdamW window", dispatch.launch_counts(
        TRAIN_ATTN_KERNELS), window, before, LM2_PER_STEP, k)
    want = fresh(lm_params, adamw)
    step = train.make_train_step(lm_loss, adamw)
    for i in range(k):
        want, _ = step(want, {"tokens": lm_batch["tokens"][i]})
    counts = (int(got.opt_state["count"]), int(want.opt_state["count"]))
    if counts != (k, k) or int(got.step) != k:
        raise AssertionError(f"AdamW window: count {counts}, step "
                             f"{int(got.step)}, expected {k}")
    for name, a, b in (("params", got.params, want.params),
                       ("mu", got.opt_state["mu"], want.opt_state["mu"]),
                       ("nu", got.opt_state["nu"], want.opt_state["nu"])):
        errs[f"adamw {name}"] = _hold(f"f32 LM AdamW window {name}",
                                      bridge.leaves(a), bridge.leaves(b),
                                      1e-6)
    print(f"  f32 SMALL 2 layers b2xT256 AdamW window (CUDA graph, K5/K6/K7 "
          f"inside) vs {k} eager steps: params {errs['adamw params']:.3e}, "
          f"mu {errs['adamw mu']:.3e}, nu {errs['adamw nu']:.3e} (tol 1e-6 "
          f"x max(1, max|p|)), count {counts[0]} ok [{card}]")
    del window, step, got, want
    torch.cuda.empty_cache()
    check_gn_graph(device)
    return errs


def run_fused_training(device, card, unfused):
    """4f, bench.py's ``_measure_fused``: ResNet-50 CIFAR b256 bf16 in
    windows of 4 steps, ``fused_throughput(warmup=1, iters=5)``: finite
    window metrics, one capture, six replays and exactly (warm-up steps +
    4 x replays) x (37, 16, 37, 16) K1-K4 launches.  Printed beside phase
    4's unfused steps/s (``unfused``): fused steps/s, one replay's time on
    the stream (CUDA events around a window call), the idle share of a
    chained window and the host's time to issue one."""
    import torch

    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.utils import benchmarking

    window, state, batch = benchmarking.resnet_train_setup(
        imagenet_shape=False, batch_size=CIFAR_BATCH,
        steps_per_dispatch=FUSED_K, device=device)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    rate = benchmarking.fused_throughput(
        window, state, batch, steps_per_dispatch=FUSED_K,
        warmup=FUSED_WARMUP, iters=FUSED_MEASURE)
    launches = dispatch.launch_counts(GN_KERNELS)
    replays, warm = window.replays, window.warmup_steps
    if window.captures != 1 or replays != FUSED_WARMUP + FUSED_MEASURE:
        raise AssertionError(f"fused: {window.captures} captures, "
                             f"{replays} replays")
    _window_launches("fused CIFAR b256", launches, window, (0, 0),
                     GN_PER_STEP, FUSED_K)
    state, metrics = window(state, batch)
    values = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(values[k]) for k in ("loss", "grad_norm")):
        raise AssertionError(f"fused: non-finite window metrics {values}")
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        start = time.perf_counter()
        state, metrics = window(state, batch)
        host.append((time.perf_counter() - start) * 1e3)
        torch.cuda.synchronize()
    replay_ms = time_ms(lambda: window(state, batch), iters=3, warmup=1)
    window_ms = FUSED_K / rate * 1e3
    idle = max(0.0, 1.0 - replay_ms / window_ms)
    out = {"steps_per_s": rate, "unfused_steps_per_s": unfused,
           "replay_ms": replay_ms, "window_wall_ms": window_ms,
           "idle_share": idle, "host_ms_per_window": float(np.median(host)),
           "launches": launches, "final_metrics": values}
    print(f"  fused ResNet-50 CIFAR b{CIFAR_BATCH} bf16, K={FUSED_K}: "
          f"{rate:.3f} steps/s against {unfused:.3f} unfused (phase 4) = "
          f"{rate / unfused:.2f}x; one replay {replay_ms:.3f} ms on the "
          f"stream (CUDA events), window wall {window_ms:.3f} ms, idle "
          f"share {idle:.3f}, host {out['host_ms_per_window']:.3f} ms to "
          f"issue a window; launches {launches} = ({warm} warm-up + "
          f"{FUSED_K} x {replays} replays) x {GN_PER_STEP} [{card}]")
    return out


#: The Trainer phases (4t, 4r): GroupNorm launches of one eval step (the
#: forward only), the fit arms of 4t (batches, steps a dispatch), and
#: 4r's f32 workload (ResNet-50 CIFAR at batch 8, 6 batches an epoch).
GN_EVAL_PER_STEP = {"gn_fwd": 37, "gn_fwd_res": 16, "gn_bwd": 0,
                    "gn_bwd_res": 0}
FIT_ARMS = ((12, 1, True), (12, 4, True), (10, 4, True), (12, 1, False))
FIT_VAL_BATCHES, FIT_EVERY, FIT_KEEP = 2, 4, 2
EXACT_BATCH, EXACT_BATCHES, EXACT_STOP = 8, 6, 4


def _gn_sum(*counts):
    return {k: sum(c.get(k, 0) for c in counts) for k in GN_KERNELS}


def _gn_times(per_step, n):
    return {k: v * n for k, v in per_step.items()}


def _cifar_arrays(n, seed, dtype=np.float32):
    """n CIFAR-shaped examples from a numpy seed (labels first, then the
    images, as resnet_train_setup draws them)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int64)
    images = rng.normal(size=(n, 32, 32, 3)).astype(dtype)
    return {"image": images, "label": labels}


def _state_bytes(state):
    from cloud_tpu_torch import bridge

    return sum(t.numel() * t.element_size() for t in
               [state.step] + bridge.leaves(state.params)
               + bridge.leaves(state.opt_state))


def _state_equal(what, got, want):
    """Every leaf of two states (step, params, optimizer state) equal bit
    for bit; raises naming the first that is not."""
    import torch

    from cloud_tpu_torch import bridge

    rng = [] if want.rng is None else [("rng", got.rng, want.rng)]
    pairs = ([("step", got.step, want.step)] + rng
             + [("params", a, b) for a, b in zip(
                 bridge.leaves(got.params), bridge.leaves(want.params))]
             + [("opt_state", a, b) for a, b in zip(
                 bridge.leaves(got.opt_state), bridge.leaves(want.opt_state))])
    for part, a, b in pairs:
        if a.dtype != b.dtype or not torch.equal(a.detach(), b.detach()):
            raise AssertionError(f"{what}: {part} differs (max_abs_err "
                                 f"{max_err(a.detach(), b.detach()):.3e})")
    return 0.0


def run_trainer_fit(device, card, bare_rate, fused_rate):
    """4t: ``Trainer.fit`` on ResNet-50 CIFAR b256 bf16 with SGD momentum:
    a shuffled ``ArrayDataset`` (numpy seed 0), ``prefetch=2``, 2
    validation batches and ``CheckpointCallback(every_n_steps=4,
    max_to_keep=2)``, in three arms on one Trainer: 12 batches one step a
    dispatch, 12 batches in windows of 4, 10 batches in windows of 4 (4,
    4 and a 2-of-4 tail, a second graph), and 12 batches one step a
    dispatch without the checkpoint callback (what the saves cost).
    Exact K1-K4 launches (37/16/37/16
    a train step, 37/16 an eval step, a window's warm-up steps included),
    finite History and logged metrics, the checkpointed steps expected;
    fit's steps/s (train steps over the epoch's seconds) printed beside
    phase 4's bare loop and 4f's windows, and the submit-to-first-step
    gauge."""
    import shutil
    import tempfile

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import resnet
    from cloud_tpu_torch.monitoring import metrics, tracing
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.training import data, optimizers, trainer
    from cloud_tpu_torch.training.checkpoint import (CheckpointCallback,
                                                     CheckpointManager)

    import functools

    tracing.mark_submit()
    cfg = resnet.RESNET50_CIFAR
    tr = trainer.Trainer(
        functools.partial(resnet.loss_fn, config=cfg, device=device),
        optimizers.sgd(0.1, momentum=0.9),
        init_fn=lambda gen: bridge.init_resnet(cfg, gen, device=device),
        device=device)
    tr.init_state(torch.Generator(device=device).manual_seed(0))
    arrays = _cifar_arrays(max(arm[0] for arm in FIT_ARMS) * CIFAR_BATCH, 0)
    val = data.ArrayDataset(_cifar_arrays(FIT_VAL_BATCHES * CIFAR_BATCH, 1),
                            CIFAR_BATCH)
    out = {"arms": [], "launches": {}}
    root = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        for batches, k, saving in FIT_ARMS:
            what = (f"fit {batches} batches, steps_per_dispatch={k}"
                    + ("" if saving else ", no checkpoints"))
            ds = data.ArrayDataset({n: a[:batches * CIFAR_BATCH]
                                    for n, a in arrays.items()},
                                   CIFAR_BATCH, shuffle=True, seed=0)
            ckpt = os.path.join(root, f"{batches}x{k}")
            cb = CheckpointCallback(ckpt, every_n_steps=FIT_EVERY,
                                    max_to_keep=FIT_KEEP, device=device)
            window = tr._multi_steps.get(k)
            before = (window.warmup_steps if window else 0)
            start_step = int(tr.state.step)
            torch.cuda.synchronize()
            dispatch.reset_launch_counts()
            start = time.perf_counter()
            history = tr.fit(ds, epochs=1, prefetch=2, steps_per_dispatch=k,
                             validation_data=val,
                             callbacks=[cb] if saving else [])
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launches = dispatch.launch_counts(GN_KERNELS)
            steps = int(tr.state.step) - start_step
            warm = (tr._multi_steps[k].warmup_steps - before) if k > 1 else 0
            want = _gn_sum(_gn_times(GN_PER_STEP, steps + warm),
                           _gn_times(GN_EVAL_PER_STEP, FIT_VAL_BATCHES))
            if steps != batches or launches != want:
                raise AssertionError(
                    f"{what}: {steps} steps, launches {launches} != {want} "
                    f"({warm} warm-up steps, {FIT_VAL_BATCHES} eval steps)")
            logs = {key: v[-1] for key, v in history.history.items()}
            if not all(np.isfinite(v) for v in logs.values()) or not {
                    "loss", "grad_norm", "val_loss"} <= set(logs):
                raise AssertionError(f"{what}: History {logs}")
            gauges = metrics.snapshot()["gauges"]
            logged = {key: gauges[key] for key in gauges
                      if key.startswith("train/")}
            if not logged or not all(np.isfinite(v) for v in logged.values()):
                raise AssertionError(f"{what}: logged metrics {logged}")
            end = int(tr.state.step)
            crossings = [s for s in range(start_step + k, end + 1, k)
                         if s // FIT_EVERY > (s - k) // FIT_EVERY]
            want_steps = sorted(set(crossings + [end]))[-FIT_KEEP:]
            if not saving:
                want_steps = []
            saved = CheckpointManager(ckpt, device=device)
            got_steps = saved.steps()
            if got_steps != want_steps or not all(
                    saved.verify(s) == "verified" for s in got_steps):
                raise AssertionError(f"{what}: checkpoints {got_steps} != "
                                     f"{want_steps}, or not verified")
            rate = steps / logs["epoch_seconds"]
            captures = tr._multi_steps[k].captures if k > 1 else 0
            arm = {"batches": batches, "steps_per_dispatch": k,
                   "checkpoints_on": saving,
                   "steps_per_s": rate, "wall_s": wall,
                   "epoch_seconds": logs["epoch_seconds"],
                   "gauge_steps_per_sec": gauges.get("train/steps_per_sec"),
                   "checkpoints": got_steps, "captures": captures,
                   "history": logs, "launches": launches}
            out["arms"].append(arm)
            out["launches"] = _gn_sum(out["launches"], launches)
            print(f"  {what}: {rate:.3f} steps/s over the epoch "
                  f"({logs['epoch_seconds']:.3f} s, capture and saves "
                  f"included; fit wall {wall:.3f} s with validation), loss "
                  f"{logs['loss']:.4f}, val_loss {logs['val_loss']:.4f}; "
                  f"checkpoints {got_steps} verified; graphs captured "
                  f"{captures}; launches {launches} [{card}]")
            shutil.rmtree(ckpt, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gauge = metrics.snapshot()["gauges"].get(
        tracing.SUBMIT_TO_FIRST_STEP_GAUGE)
    if gauge is None or not np.isfinite(gauge):
        raise AssertionError(f"fit: no submit-to-first-step gauge ({gauge})")
    out.update({"submit_to_first_step_seconds": gauge,
                "bare_steps_per_s": bare_rate,
                "fused_steps_per_s": fused_rate,
                "state_bytes": _state_bytes(tr.state)})
    print(f"  fit steps/s: {out['arms'][0]['steps_per_s']:.3f} (K=1), "
          f"{out['arms'][1]['steps_per_s']:.3f} (K=4), "
          f"{out['arms'][3]['steps_per_s']:.3f} (K=1, no checkpoints), "
          f"beside phase 4's bare "
          f"loop {bare_rate:.3f} and 4f's windows {fused_rate:.3f}; "
          f"run/submit_to_first_step_seconds {gauge:.3f} (Trainer built, "
          f"state initialised, first step dispatched); state "
          f"{out['state_bytes'] / 2**20:.1f} MiB [{card}]")
    del tr
    torch.cuda.empty_cache()
    return out


def check_save_ordering(device, card):
    """4s: a save at step N followed at once by 4 more steps, with no
    wait: after ``wait()`` the restore into a fresh state equals, bit for
    bit, a clone taken at step N before the save.  ResNet-50 CIFAR b256
    bf16, once with the eager step (N=2) and once in a window of 4 (N=4,
    the next window a replay of its graph)."""
    import shutil
    import tempfile

    import torch

    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.training.checkpoint import CheckpointManager
    from cloud_tpu_torch.training.trainer import _copy_state
    from cloud_tpu_torch.utils import benchmarking

    out = {"launches": {}}
    root = tempfile.mkdtemp(prefix="chip_smoke_order_")
    try:
        for what, k in (("eager", 1), ("window", FUSED_K)):
            step, state, batch = benchmarking.resnet_train_setup(
                imagenet_shape=False, batch_size=CIFAR_BATCH,
                steps_per_dispatch=k, device=device)
            for _ in range(2 if k == 1 else 1):
                state, _ = step(state, batch)
            n = int(state.step)
            clone = _copy_state(state, device)
            manager = CheckpointManager(os.path.join(root, what),
                                        device=device)
            torch.cuda.synchronize()
            dispatch.reset_launch_counts()
            start = time.perf_counter()
            manager.save(n, state)
            for _ in range(4 if k == 1 else 1):
                state, _ = step(state, batch)
            issue_s = time.perf_counter() - start
            launches = dispatch.launch_counts(GN_KERNELS)
            want = _gn_times(GN_PER_STEP, 4)
            if launches != want or int(state.step) != n + 4:
                raise AssertionError(f"save ordering ({what}): launches "
                                     f"{launches} != {want} or step "
                                     f"{int(state.step)} != {n + 4}")
            manager.wait()
            restored = manager.restore(n, template=clone)
            _state_equal(f"save ordering ({what})", restored, clone)
            if torch.equal(_first_param(state), _first_param(clone)):
                raise AssertionError(f"save ordering ({what}): the 4 steps "
                                     f"after the save changed nothing")
            manager.close()
            out[what] = {"step": n, "issue_s": issue_s}
            print(f"  {what}: save at step {n}, then 4 steps issued in "
                  f"{issue_s * 1e3:.1f} ms with no wait; restored == the "
                  f"step-{n} clone bit for bit (params, momentum, step) "
                  f"[{card}]")
            del step, state, batch, clone, restored
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _first_param(state):
    from cloud_tpu_torch import bridge

    return bridge.leaves(state.params)[0].detach()


def run_durability_probe(device, card):
    """4d, bench.py's ``_measure_durability`` on the CIFAR b256 state: save
    1 primes the pipeline, save 2 is timed (``checkpoint_save_blocking_
    seconds``: the host's time in ``save``; also with its snapshot copies
    finished), then ``wait`` and a verified walk-back restore into a fresh
    state (``quarantine=False``), timed until the restored state is on the
    card (``resume_restore_seconds``).  The restored state equals the
    saved one bit for bit; both seconds are printed, never asserted."""
    import shutil
    import tempfile
    import types

    import torch

    from cloud_tpu_torch.training.checkpoint import (CheckpointManager,
                                                     resume_trainer_state)
    from cloud_tpu_torch.training.trainer import _copy_state
    from cloud_tpu_torch.utils import benchmarking

    _, state, _ = benchmarking.resnet_train_setup(
        imagenet_shape=False, batch_size=CIFAR_BATCH, device=device)
    saved = _copy_state(state, device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        manager = CheckpointManager(tmp, max_to_keep=2, device=device)
        manager.save(1, state)
        torch.cuda.synchronize()
        start = time.perf_counter()
        manager.save(2, state)
        blocking = time.perf_counter() - start
        torch.cuda.synchronize()
        with_copies = time.perf_counter() - start
        manager.wait()
        manager.close()
        holder = types.SimpleNamespace(state=state)
        restore_manager = CheckpointManager(tmp, device=device)
        start = time.perf_counter()
        ok = resume_trainer_state(holder, restore_manager,
                                  only_if_ahead=False, quarantine=False)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - start
        restore_manager.close()
        if not ok:
            raise AssertionError("durability probe: could not restore the "
                                 "checkpoint it just wrote")
        if holder.state is state:
            raise AssertionError("durability probe: the state was not "
                                 "replaced")
        _state_equal("durability probe", holder.state, saved)
        nbytes = _state_bytes(state)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"checkpoint_save_blocking_seconds": blocking,
           "checkpoint_save_with_copies_seconds": with_copies,
           "resume_restore_seconds": restore_s, "state_bytes": nbytes}
    print(f"  CIFAR b{CIFAR_BATCH} state ({nbytes / 2**20:.1f} MiB): "
          f"checkpoint_save_blocking_seconds {blocking:.4f} "
          f"({with_copies:.4f} with the snapshot's copies done), "
          f"resume_restore_seconds {restore_s:.4f}; restored == saved bit "
          f"for bit [{card}]")
    del state, saved, holder
    torch.cuda.empty_cache()
    return out


def _exact_trainer(device, cfg, **kw):
    import functools

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import resnet
    from cloud_tpu_torch.training import optimizers, trainer

    tr = trainer.Trainer(
        functools.partial(resnet.loss_fn, config=cfg, device=device),
        optimizers.sgd(0.1, momentum=0.9), device=device,
        init_fn=lambda gen: bridge.init_resnet(cfg, gen, device=device),
        **kw)
    tr.init_state(torch.Generator(device=device).manual_seed(3))
    return tr


def _run_drill(device, card):
    """``python -m cloud_tpu_torch.training.check_durability --device cuda
    --model resnet50_cifar`` in a child: its phase lines, checked."""
    proc = subprocess.run(
        [sys.executable, "-m", "cloud_tpu_torch.training.check_durability",
         "--device", device.type, "--model", "resnet50_cifar"],
        capture_output=True, text=True, timeout=600)
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    phases = {p["phase"]: p for p in lines}
    summary, corrupt = phases.get("summary", {}), phases.get("corrupt", {})
    resume = phases.get("resume", {})
    if proc.returncode != 0 or not (summary.get("ok")
                                    and summary.get("digest_match")):
        raise AssertionError(f"check_durability: exit {proc.returncode}, "
                             f"{lines}, stderr {proc.stderr[-2000:]}")
    # The walk-back's prediction: the garbled newest step fails its
    # restore, the bit-flipped one its manifest, both quarantined, and
    # the restart lands on the newest intact step.
    damaged = sorted(f"step-{corrupt[k]}" for k in ("garbled_step",
                                                     "bitflipped_step"))
    quarantined = sorted(q.rsplit("-", 1)[0] for q in resume["quarantined"])
    if (resume["fallbacks"] != 2 or quarantined != damaged
            or resume["resumed_step"] != corrupt["expect_resume_at"]):
        raise AssertionError(f"check_durability walk-back: {resume} against "
                             f"{corrupt}")
    print(f"  check_durability --device {device.type} (ResNet-50 CIFAR f32 b8, kill "
          f"-9 at step 34, step {corrupt['garbled_step']} garbled, step "
          f"{corrupt['bitflipped_step']} bit-flipped): ok, digest_match, "
          f"resumed at {resume['resumed_step']}, fallbacks "
          f"{resume['fallbacks']}, quarantined {quarantined}, max loss err "
          f"{summary['max_loss_err']:.3e} (exact: every resumed loss equal, "
          f"params digest equal), "
          f"{summary['wall_seconds']:.1f} s [{card}]")
    return {"summary": summary, "corrupt": corrupt,
            "fallbacks": resume["fallbacks"], "quarantined": quarantined}


def check_exactly_once(device, card):
    """4r, f32 ResNet-50 CIFAR b8 with cuDNN's deterministic algorithms (TF32
    is off for the whole run): (1) a drain (``preemption.request_stop``
    from a callback at step 4) and a resume with
    ``CheckpointCallback(resume_data=True)`` against the uninterrupted
    run, one step a dispatch and in windows of 4 (the tails 2-of-4):
    per-dispatch losses and final params and momentum within TOL_F32 of
    max(1, max |p|), the error printed (expected 0); then the window arm's
    state restored from its last checkpoint into the Trainer (its graph's
    static buffers take the values) and one more epoch on both, equal
    again; (2) ``check_durability --device cuda``; (3) the non-finite
    guard: a window of 4 whose last slot has NaN images leaves params and
    momentum bit for bit where a window of the 3 good slots leaves them,
    with ``train/nonfinite_skips`` counting it.  Exact K1-K4 launches of
    the in-process fits."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import resnet
    from cloud_tpu_torch.monitoring import metrics
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.training import data, preemption, trainer
    from cloud_tpu_torch.training.checkpoint import (CheckpointCallback,
                                                     CheckpointManager,
                                                     resume_trainer_state)

    class _Dispatched(trainer.Callback):
        """Trainer callback: train steps dispatched over every fit it joins
        (the step count's advance at each dispatch, counted after a
        restore)."""

        def __init__(self):
            self.steps = 0
            self._prev = 0

        def on_train_begin(self, trainer):
            self._prev = int(trainer.state.step)

        def on_step_end(self, step, logs, trainer):
            self.steps += step - self._prev
            self._prev = step

    cfg = dataclasses.replace(resnet.RESNET50_CIFAR, dtype=torch.float32)
    arrays = _cifar_arrays(EXACT_BATCHES * EXACT_BATCH, 4)

    def dataset(batches=EXACT_BATCHES, src=None):
        src = arrays if src is None else src
        return data.ArrayDataset({n: a[:batches * EXACT_BATCH]
                                  for n, a in src.items()}, EXACT_BATCH,
                                 shuffle=src is arrays, seed=3)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {"errors": {}}
    trainers = []
    root = tempfile.mkdtemp(prefix="chip_smoke_exact_")
    try:
        counted = _Dispatched()
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        for k in (1, FUSED_K):
            what = f"drain/resume K={k}"
            losses = {"control": {}, "resumed": {}}

            def spy(name):
                return trainer.LambdaCallback(
                    on_step_end=lambda s, logs, t: losses[name].update(
                        {s: float(logs["loss"])}))

            control = _exact_trainer(device, cfg)
            control.fit(dataset(), epochs=2, steps_per_dispatch=k,
                        callbacks=[spy("control"), counted])
            ckpt = os.path.join(root, f"drain{k}")
            preemption._reset_for_tests()
            try:
                first = _exact_trainer(device, cfg)
                stopper = trainer.LambdaCallback(
                    on_step_end=lambda s, logs, t: preemption.request_stop(
                        "chip_smoke") if s == EXACT_STOP else None)
                first.fit(dataset(), epochs=2, steps_per_dispatch=k,
                          callbacks=[CheckpointCallback(
                              ckpt, every_n_steps=100, resume_data=True,
                              device=device), stopper, counted])
            finally:
                preemption._reset_for_tests()
            if not first.drained or int(first.state.step) != EXACT_STOP:
                raise AssertionError(f"{what}: drained {first.drained} at "
                                     f"step {int(first.state.step)}")
            resumed = _exact_trainer(device, cfg)
            resumed.fit(dataset(), epochs=2, steps_per_dispatch=k,
                        callbacks=[CheckpointCallback(
                            ckpt, every_n_steps=100, resume_data=True,
                            device=device), spy("resumed"), counted])
            trainers += [control, first, resumed]
            got = losses["resumed"]
            if not got or min(got) != EXACT_STOP + min(k, 2) or int(
                    resumed.state.step) != 2 * EXACT_BATCHES:
                raise AssertionError(f"{what}: resumed steps {sorted(got)}, "
                                     f"final {int(resumed.state.step)}")
            loss_err = max(abs(got[s] - losses["control"][s]) for s in got)
            if not loss_err <= TOL_F32:
                raise AssertionError(f"{what}: loss max_abs_err "
                                     f"{loss_err:.3e}")
            err = max(_hold(f"{what} params",
                            bridge.leaves(resumed.state.params),
                            bridge.leaves(control.state.params), TOL_F32),
                      _hold(f"{what} momentum",
                            bridge.leaves(resumed.state.opt_state),
                            bridge.leaves(control.state.opt_state), TOL_F32))
            out["errors"][what] = {"loss": loss_err, "params": err}
            print(f"  {what} (drained at step {EXACT_STOP}, resumed from "
                  f"it): per-dispatch losses max_abs_err {loss_err:.3e}, "
                  f"params and momentum {err:.3e} (tol {TOL_F32} x max(1, "
                  f"max|p|)) against the uninterrupted run [{card}]")
            if k > 1:
                # Restore into a state a window's graph holds: the graph's
                # static buffers (the live state, perturbed here) must
                # take the restored values at the next replay.
                held = resumed.state
                with torch.no_grad():
                    for p in bridge.leaves(held.params):
                        p.add_(1.0)
                manager = CheckpointManager(ckpt, device=device)
                if not resume_trainer_state(resumed, manager,
                                            only_if_ahead=False):
                    raise AssertionError(f"{what}: no checkpoint to restore")
                if resumed.state is held:
                    raise AssertionError(f"{what}: the state was not "
                                         f"replaced")
                for tr in (resumed, control):
                    tr.fit(dataset(), epochs=1, steps_per_dispatch=k,
                           callbacks=[counted])
                err = _hold(f"{what} after a restore into the graph's state",
                            bridge.leaves(resumed.state.params),
                            bridge.leaves(control.state.params), TOL_F32)
                out["errors"][f"{what} restored into the graph"] = err
                print(f"  the resumed Trainer restored from its step-"
                      f"{manager.latest_step()} checkpoint (values copied "
                      f"into the window graph's buffers), one more epoch "
                      f"on both: params max_abs_err {err:.3e} [{card}]")

        # The non-finite guard in a window of 4, the last slot poisoned,
        # against the same window's graph of the 3 good slots (the tail
        # graph, captured on the same stream) from the same start.
        poisoned = {n: a[:FUSED_K * EXACT_BATCH].copy()
                    for n, a in arrays.items()}
        poisoned["image"][(FUSED_K - 1) * EXACT_BATCH:] = np.nan
        before = metrics.snapshot()["counters"].get("train/nonfinite_skips",
                                                    0)
        guarded = _exact_trainer(device, cfg, nonfinite_guard=True)
        start = trainer._copy_state(guarded.state, device)
        guarded.fit(dataset(FUSED_K, poisoned), epochs=1,
                    steps_per_dispatch=FUSED_K, callbacks=[counted])
        skips = metrics.snapshot()["counters"].get("train/nonfinite_skips",
                                                   0) - before
        bad = guarded.state
        if skips != 1 or int(bad.step) != FUSED_K:
            raise AssertionError(f"guard: {skips} skips, step "
                                 f"{int(bad.step)}")
        bad = trainer._copy_state(bad, device)
        guarded.state = start
        guarded.fit(dataset(FUSED_K - 1, poisoned), epochs=1,
                    steps_per_dispatch=FUSED_K, callbacks=[counted])
        trainers.append(guarded)
        for part in ("params", "opt_state"):
            for a, b in zip(bridge.leaves(getattr(bad, part)),
                            bridge.leaves(getattr(guarded.state, part))):
                if not torch.equal(a.detach(), b.detach()):
                    raise AssertionError(
                        f"guard: {part} moved across the poisoned slot "
                        f"(max_abs_err {max_err(a.detach(), b.detach()):.3e})")
        print(f"  guard: a window of {FUSED_K} with NaN images in its last "
              f"slot == the same window's graph of its {FUSED_K - 1} good "
              f"slots from the same start, params and momentum bit for "
              f"bit; train/nonfinite_skips +{skips}, step {FUSED_K} "
              f"[{card}]")
        torch.cuda.synchronize()
        launches = dispatch.launch_counts(GN_KERNELS)
        steps = counted.steps
        warm = sum(w.warmup_steps for t in trainers
                   for w in t._multi_steps.values())
        want = _gn_times(GN_PER_STEP, steps + warm)
        if launches != want:
            raise AssertionError(f"exactly-once launches {launches} != "
                                 f"{want} ({steps} steps, {warm} warm-up)")
        out["launches"] = launches
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
    del trainers
    torch.cuda.empty_cache()
    out["drill"] = _run_drill(device, card)
    return out


# ---------------------------------------------------------------------------
# Phases 4a, 4k, 4p: compile-ahead, the persistent kernel cache, records
# ---------------------------------------------------------------------------

#: 4a's arms: (label, steps a dispatch, batch_spec given, fresh Trainer).
AHEAD_ARMS = (("K=1", 1, False, True), ("K=4", FUSED_K, False, False),
              ("K=1 again (registry)", 1, False, False),
              ("K=1 batch_spec", 1, True, True))
AHEAD_BATCHES, ONE_STEP_GRAPH_STEPS = 12, 4


def _span_total(events, name):
    return sum(e["dur"] for e in events if e["name"] == name) / 1e6


def _cifar_trainer(device, cfg=None, seed=0, **kw):
    import functools

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import resnet
    from cloud_tpu_torch.training import optimizers, trainer

    cfg = cfg or resnet.RESNET50_CIFAR
    tr = trainer.Trainer(
        functools.partial(resnet.loss_fn, config=cfg, device=device),
        optimizers.sgd(0.1, momentum=0.9),
        init_fn=lambda gen: bridge.init_resnet(cfg, gen, device=device),
        device=device, **kw)
    tr.init_state(torch.Generator(device=device).manual_seed(seed))
    return tr


class _ArtifactCounts:
    """The graph work of plan steps' artifacts since the last read: an
    artifact served again from the registry carries its earlier counts."""

    def __init__(self):
        self._seen = {}

    def read(self, plan, label):
        """(warm-ups, replays, captures) of ``label``'s artifact since
        this object last read it."""
        compiled = plan.steps[label].compiled
        graphed = getattr(compiled, "graphed", None) or compiled._graphed
        now = (graphed.warmup_steps, graphed.replays, graphed.captures)
        before = self._seen.get(id(graphed), (0, 0, 0))
        self._seen[id(graphed)] = now
        return tuple(a - b for a, b in zip(now, before))


def check_one_step_graph(device, card):
    """``compile_cache.aot_compile`` of ``make_train_step`` (f32
    ResNet-50 CIFAR b8, SGD momentum, cuDNN deterministic) from specs:
    4 replays of the one-step graph, each batch copied into its static
    buffers, against 4 eager steps from the same state: params and
    momentum within TOL_F32 of max(1, max |p|), the step count exact,
    launches (1 warm-up + 4 replays) x 37/16/37/16."""
    import dataclasses
    import functools

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import resnet
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.training import compile_cache, optimizers, train

    n = ONE_STEP_GRAPH_STEPS
    cfg = dataclasses.replace(resnet.RESNET50_CIFAR, dtype=torch.float32)
    params = bridge.init_resnet(cfg, torch.Generator().manual_seed(5),
                                device="cpu")
    arrays = _cifar_arrays(n * 8, 6)
    batches = [{k: torch.from_numpy(v[i * 8:(i + 1) * 8]).to(device)
                for k, v in arrays.items()} for i in range(n)]
    tx = optimizers.sgd(0.1, momentum=0.9)
    loss = functools.partial(resnet.loss_fn, config=cfg, device=device)

    def fresh():
        return train.create_sharded_state(
            None, lambda _: bridge.map_leaves(params, torch.clone), tx,
            device=device)

    step = train.make_train_step(loss, tx)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        state = fresh()
        artifact = compile_cache.aot_compile(
            step, compile_cache.abstract_state(state),
            compile_cache.abstract_batch(batches[0], device=device),
            label="train_step")
        graphed = artifact.graphed
        for b in batches:
            state, _ = artifact(state, b)
        torch.cuda.synchronize()
        launches = dispatch.launch_counts(GN_KERNELS)
        want_launches = _gn_times(GN_PER_STEP, graphed.warmup_steps
                                  + graphed.replays)
        if (graphed.captures, graphed.replays) != (1, n) or (
                launches != want_launches):
            raise AssertionError(
                f"one-step graph: {graphed.captures} captures, "
                f"{graphed.replays} replays, launches {launches} != "
                f"{want_launches}")
        want = fresh()
        for b in batches:
            want, _ = step(want, b)
        if not int(state.step) == int(want.step) == n:
            raise AssertionError(f"one-step graph: step {int(state.step)}")
        errs = {"launches": launches, "params": _hold("one-step graph params",
                                bridge.leaves(state.params),
                                bridge.leaves(want.params), TOL_F32),
                "momentum": _hold("one-step graph momentum",
                                  bridge.leaves(state.opt_state),
                                  bridge.leaves(want.opt_state), TOL_F32)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"  aot_compile(make_train_step) from specs, f32 ResNet-50 CIFAR "
          f"b8: {n} replays of the one-step graph vs {n} eager steps: "
          f"params max_abs_err {errs['params']:.3e}, momentum "
          f"{errs['momentum']:.3e} (tol {TOL_F32} x max(1, max|p|)), "
          f"launches {launches} ok [{card}]")
    del artifact, graphed, state, want
    torch.cuda.empty_cache()
    return errs


def run_compile_ahead(device, card, fit):
    """4a: ``Trainer.fit(compile_ahead=True)`` on ResNet-50 CIFAR b256
    bf16 (12 shuffled batches, 2 validation batches, prefetch 2): one step
    a dispatch, in windows of 4, one step a dispatch again on the same
    Trainer (a registry hit: no capture, no ``compile/backend_compile``
    span), and with ``batch_spec=`` on a fresh Trainer.  Each arm: no
    ``CompileAhead.error``, every train dispatch a replay of the
    artifact's graph, the eval graph attached, exact K1-K4 launches
    ((train warm-ups + replayed steps) x 37/16/37/16, (eval warm-ups +
    eval steps) x 37/16/0/0); ``compile/ahead_wait``, the
    submit-to-first-step gauge and fit's steps/s printed beside 4t's
    eager and K=4 arms (``fit``).  Then the one-step graph against eager
    steps (:func:`check_one_step_graph`)."""
    import torch

    from cloud_tpu_torch.monitoring import metrics, tracing
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.training import compile_cache, data

    arrays = _cifar_arrays(AHEAD_BATCHES * CIFAR_BATCH, 0)
    val = data.ArrayDataset(_cifar_arrays(FIT_VAL_BATCHES * CIFAR_BATCH, 1),
                            CIFAR_BATCH)
    spec = {"image": np.zeros((CIFAR_BATCH, 32, 32, 3), np.float32),
            "label": np.zeros((CIFAR_BATCH,), np.int64)}
    out = {"arms": [], "launches": {}}
    tr = None
    counts = _ArtifactCounts()
    compile_cache.clear_registry()
    for label, k, with_spec, fresh in AHEAD_ARMS:
        if fresh:
            tr = _cifar_trainer(device)
        ds = data.ArrayDataset(arrays, CIFAR_BATCH, shuffle=True, seed=0)
        counters = metrics.snapshot()["counters"]
        hits = counters.get("compile/registry_hit", 0)
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        tracing.mark_submit()
        start_step = int(tr.state.step)
        train_label = "train_step" if k == 1 else "multi_step"
        with tracing.collecting() as collector:
            history = tr.fit(ds, epochs=1, prefetch=2, steps_per_dispatch=k,
                             validation_data=val, compile_ahead=True,
                             batch_spec=spec if with_spec else None)
            plan = tr.compile_plan
            plan.wait()
            torch.cuda.synchronize()
        events = collector.events()
        launches = dispatch.launch_counts(GN_KERNELS)
        what = f"fit(compile_ahead=True) {label}"
        if plan.error is not None:
            raise AssertionError(f"{what}: CompileAhead.error "
                                 f"{plan.error!r}")
        steps = int(tr.state.step) - start_step
        t_warm, t_replays, t_caps = counts.read(plan, train_label)
        e_warm, e_replays, _ = counts.read(plan, "eval_step")
        dispatches = steps // k
        if steps != AHEAD_BATCHES or t_replays != dispatches:
            raise AssertionError(f"{what}: {steps} steps, {t_replays} "
                                 f"replays for {dispatches} dispatches")
        want = _gn_sum(_gn_times(GN_PER_STEP, t_warm + steps),
                       _gn_times(GN_EVAL_PER_STEP,
                                 e_warm + FIT_VAL_BATCHES))
        if launches != want:
            raise AssertionError(
                f"{what}: launches {launches} != {want} ({t_warm} train "
                f"warm-ups, {steps} steps, {e_warm} eval warm-ups, "
                f"{e_replays} eval replays)")
        compiles = [e for e in events
                    if e["name"] == "compile/backend_compile"]
        new_hits = metrics.snapshot()["counters"].get(
            "compile/registry_hit", 0) - hits
        if "registry" in label and (compiles or t_caps or new_hits != 2):
            raise AssertionError(f"{what}: {len(compiles)} captures, "
                                 f"{new_hits} registry hits (want 0, 2)")
        logs = {key: v[-1] for key, v in history.history.items()}
        if not all(np.isfinite(v) for v in logs.values()):
            raise AssertionError(f"{what}: History {logs}")
        gauge = metrics.snapshot()["gauges"].get(
            tracing.SUBMIT_TO_FIRST_STEP_GAUGE)
        arm = {"label": label, "steps_per_dispatch": k,
               "batch_spec": with_spec,
               "steps_per_s": steps / logs["epoch_seconds"],
               "epoch_seconds": logs["epoch_seconds"],
               "ahead_wait_s": _span_total(events, "compile/ahead_wait"),
               "lower_s": _span_total(events, "compile/lower"),
               "backend_compile_s": _span_total(
                   events, "compile/backend_compile"),
               "first_dispatch_s": _span_total(events, "step/first_compile"),
               "submit_to_first_step_seconds": gauge,
               "train_warmups": t_warm, "train_replays": t_replays,
               "eval_warmups": e_warm, "eval_replays": e_replays,
               "captures": len(compiles), "registry_hits": new_hits,
               "launches": launches, "history": logs}
        out["arms"].append(arm)
        out["launches"] = _gn_sum(out["launches"], launches)
        print(f"  {what}: {arm['steps_per_s']:.3f} steps/s over the epoch "
              f"({logs['epoch_seconds']:.3f} s); compile/ahead_wait "
              f"{arm['ahead_wait_s']:.4f} s, compile/lower "
              f"{arm['lower_s']:.3f} s, compile/backend_compile "
              f"{arm['backend_compile_s']:.3f} s, first dispatch "
              f"{arm['first_dispatch_s']:.4f} s, submit to first step "
              f"{gauge:.3f} s; {t_replays} train replays of {dispatches} "
              f"dispatches, {e_replays} eval replays, captures "
              f"{len(compiles)}, registry hits {new_hits}; launches "
              f"{launches} ok [{card}]")
    eager_k1 = fit["arms"][3]["steps_per_s"]
    eager_k4 = fit["arms"][1]["steps_per_s"]
    print(f"  fit steps/s, compile-ahead: {out['arms'][0]['steps_per_s']:.3f}"
          f" (K=1, one-step graph), {out['arms'][1]['steps_per_s']:.3f} "
          f"(K=4), {out['arms'][2]['steps_per_s']:.3f} (K=1, registry); 4t "
          f"eager K=1 (no checkpoints) {eager_k1:.3f}, K=4 {eager_k4:.3f} "
          f"[{card}]")
    out.update({"fit_eager_k1_steps_per_s": eager_k1,
                "fit_k4_steps_per_s": eager_k4})
    del tr
    compile_cache.clear_registry()
    torch.cuda.empty_cache()
    out["one_step_graph"] = check_one_step_graph(device, card)
    out["launches"] = _gn_sum(out["launches"],
                              out["one_step_graph"]["launches"])
    return out


#: 4k's child: a fresh process that times ResNet-50 CIFAR b256 bf16
#: ``fit(compile_ahead=True)`` (4 batches) under the cache directory the
#: environment names, and prints one JSON line.
COLD_START_CHILD = r"""
import functools, json, sys, time
import numpy as np
import torch
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import resnet
from cloud_tpu_torch.monitoring import metrics, tracing
from cloud_tpu_torch.ops import dispatch
from cloud_tpu_torch.training import compile_cache, data, optimizers, trainer

device = torch.device("cuda", 0)
torch.cuda.set_device(device)
cfg = resnet.RESNET50_CIFAR
tr = trainer.Trainer(
    functools.partial(resnet.loss_fn, config=cfg, device=device),
    optimizers.sgd(0.1, momentum=0.9),
    init_fn=lambda gen: bridge.init_resnet(cfg, gen, device=device),
    device=device)
tr.init_state(torch.Generator(device=device).manual_seed(0))
rng = np.random.default_rng(0)
n = 4 * 256
ds = data.ArrayDataset({"image": rng.normal(size=(n, 32, 32, 3)).astype(
    np.float32), "label": rng.integers(0, 10, n).astype(np.int64)}, 256)
with tracing.collecting() as col:
    tr.fit(ds, epochs=1, compile_ahead=True)
    torch.cuda.synchronize()
total = lambda name: sum(e["dur"] for e in col.events()
                         if e["name"] == name) / 1e6
print(json.dumps({
    "cache_enabled": compile_cache.persistent_cache_enabled(),
    "build_dir": dispatch.build_dir(),
    "build_seconds": dispatch.build_seconds,
    "libs": sorted(dispatch._libs),
    "probe_seconds": total("compile/cache_probe"),
    "ahead_wait_seconds": total("compile/ahead_wait"),
    "lower_seconds": total("compile/lower"),
    "first_dispatch_seconds": total("compile/ahead_wait")
                              + total("step/first_compile"),
    "submit_to_first_step_seconds": metrics.snapshot()["gauges"].get(
        tracing.SUBMIT_TO_FIRST_STEP_GAUGE),
    "plan_error": repr(tr.compile_plan.error),
    "steps": int(tr.state.step)}))
"""


def run_cold_start(device, card):
    """4k, the counterpart of ``scripts/check_cold_start.py``: two fresh
    child processes share one empty ``CLOUD_TPU_COMPILE_CACHE`` directory
    and each times a ResNet-50 CIFAR b256 ``fit(compile_ahead=True)``
    from its submit (``CLOUD_TPU_SUBMIT_TS``, set at spawn).  The cold
    child probes the directory (a grandchild builds K5's library there
    and holds it to its plain version) and builds only what its step
    needs (``group_norm``); the warm child finds the probe's marker and
    the library and builds nothing (every ``dispatch.build_seconds`` 0).
    First-dispatch and submit-to-first-step seconds of each printed."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_cold_")
    cache = os.path.join(root, "kernel-cache")
    repo = os.path.dirname(os.path.abspath(__file__))
    out = {}
    try:
        for arm in ("cold", "warm"):
            env = dict(os.environ, CLOUD_TPU_COMPILE_CACHE=cache,
                       CLOUD_TPU_SUBMIT_TS=repr(time.time()))
            env["PYTHONPATH"] = os.pathsep.join(
                [repo] + [p for p in env.get("PYTHONPATH", "").split(
                    os.pathsep) if p])
            start = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", COLD_START_CHILD],
                                  capture_output=True, text=True,
                                  timeout=400, cwd=root, env=env)
            wall = time.perf_counter() - start
            lines = [line for line in proc.stdout.splitlines()
                     if line.startswith("{")]
            if proc.returncode != 0 or not lines:
                raise AssertionError(f"{arm} child: exit {proc.returncode}, "
                                     f"stderr {proc.stderr[-2000:]}")
            got = json.loads(lines[-1])
            got["process_wall_seconds"] = wall
            built = sorted(k for k, v in got["build_seconds"].items() if v > 0)
            want_built = ["group_norm"] if arm == "cold" else []
            if (not got["cache_enabled"] or got["plan_error"] != "None"
                    or os.path.realpath(got["build_dir"])
                    != os.path.realpath(cache)
                    or got["libs"] != ["group_norm"] or built != want_built
                    or got["steps"] != 4
                    or (arm == "warm") != (got["probe_seconds"] == 0)):
                raise AssertionError(f"{arm} child: {got}")
            out[arm] = got
            print(f"  {arm} child: built {built or 'nothing'} "
                  f"({', '.join(f'{k} {v:.1f} s' for k, v in got['build_seconds'].items())}), "
                  f"probe {got['probe_seconds']:.2f} s, compile/ahead_wait "
                  f"{got['ahead_wait_seconds']:.3f} s, first dispatch "
                  f"{got['first_dispatch_seconds']:.3f} s, submit to first "
                  f"step {got['submit_to_first_step_seconds']:.3f} s, "
                  f"process {wall:.1f} s [{card}]")
        libs = sorted(f for f in os.listdir(cache) if f.endswith(".so"))
        if not (any(f.startswith("libflash_fwd_") for f in libs)
                and any(f.startswith("libgroup_norm_") for f in libs)):
            raise AssertionError(f"cache directory holds {libs}")
        out["cache_files"] = libs
        print(f"  warm against cold: first dispatch "
              f"{out['warm']['first_dispatch_seconds']:.3f} vs "
              f"{out['cold']['first_dispatch_seconds']:.3f} s, submit to "
              f"first step {out['warm']['submit_to_first_step_seconds']:.3f}"
              f" vs {out['cold']['submit_to_first_step_seconds']:.3f} s; "
              f"cache holds {libs} [{card}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


RECORD_FILES, RECORD_BATCHES, RECORD_STOP = 2, 12, 6


class _Fingerprinted:
    """A dataset wrapper that records a digest of every batch it yields,
    in order (the resume hooks pass through)."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.seen = []

    def state_dict(self):
        return self.dataset.state_dict()

    def load_state_dict(self, state):
        self.dataset.load_state_dict(state)

    def __call__(self):
        import hashlib

        for batch in self.dataset():
            self.seen.append(hashlib.sha256(
                batch["label"].tobytes() + batch["image"].tobytes()
            ).hexdigest())
            yield batch


def run_records_fit(device, card, fit):
    """4p: CIFAR b256 arrays (numpy seed 7) written as tensor records
    into 2 files, read by ``RecordDataset`` (shuffle buffer 512, seed 3):
    records/s decoded on the host; ``Trainer.fit`` over it with prefetch
    (12 batches, one step a dispatch, bf16) with exact K1-K4 launches and
    its steps/s beside 4t's in-memory arm; then a run stopped after step 6
    with ``CheckpointCallback(every_n_steps=6, resume_data=True)`` and a
    fresh Trainer resumed from that checkpoint: the batches the resumed
    run consumes are exactly the uninterrupted stream's 7th to 12th
    (sha256 of each), and it ends at step 12."""
    import shutil
    import tempfile

    import torch

    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.training import records, trainer
    from cloud_tpu_torch.training.checkpoint import CheckpointCallback

    root = tempfile.mkdtemp(prefix="chip_smoke_records_")
    out = {}
    try:
        arrays = _cifar_arrays(RECORD_BATCHES * CIFAR_BATCH, 7)
        start = time.perf_counter()
        paths = records.write_records(
            os.path.join(root, "cifar-{shard}.rec"),
            ({k: v[i] for k, v in arrays.items()}
             for i in range(len(arrays["label"]))), num_shards=RECORD_FILES)
        write_s = time.perf_counter() - start

        def dataset():
            return records.RecordDataset(paths, batch_size=CIFAR_BATCH,
                                         shuffle_buffer=512, seed=3,
                                         verify=True)

        start = time.perf_counter()
        want = _Fingerprinted(dataset())
        n = sum(len(b["label"]) for b in want())
        decode_s = time.perf_counter() - start
        if n != RECORD_BATCHES * CIFAR_BATCH or len(want.seen) != (
                RECORD_BATCHES):
            raise AssertionError(f"records: {n} examples decoded")
        steps_total = 0
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        tr = _cifar_trainer(device)
        history = tr.fit(dataset(), epochs=1, prefetch=2)
        steps = int(tr.state.step)
        logs = {k: v[-1] for k, v in history.history.items()}
        rate = steps / logs["epoch_seconds"]
        steps_total += steps
        ckpt = os.path.join(root, "ckpt")
        first = _cifar_trainer(device)
        first_data = _Fingerprinted(dataset())
        first.fit(first_data, epochs=1, prefetch=2, callbacks=[
            CheckpointCallback(ckpt, every_n_steps=RECORD_STOP,
                               resume_data=True, device=device),
            trainer.LambdaCallback(on_step_end=lambda s, l, t: setattr(
                t, "stop_training", s >= RECORD_STOP))])
        steps_total += int(first.state.step)
        resumed = _cifar_trainer(device)
        resumed_data = _Fingerprinted(dataset())
        resumed.fit(resumed_data, epochs=1, prefetch=2, callbacks=[
            CheckpointCallback(ckpt, every_n_steps=100, resume_data=True,
                               device=device)])
        steps_total += int(resumed.state.step) - RECORD_STOP
        torch.cuda.synchronize()
        launches = dispatch.launch_counts(GN_KERNELS)
        want_launches = _gn_times(GN_PER_STEP, steps_total)
        consumed = resumed_data.seen[:RECORD_BATCHES - RECORD_STOP]
        if (steps != RECORD_BATCHES or int(first.state.step) != RECORD_STOP
                or int(resumed.state.step) != RECORD_BATCHES
                or first_data.seen[:RECORD_STOP] != want.seen[:RECORD_STOP]
                or consumed != want.seen[RECORD_STOP:]
                or launches != want_launches):
            raise AssertionError(
                f"records fit: steps {steps}/{int(first.state.step)}/"
                f"{int(resumed.state.step)}, resumed batches equal "
                f"{[a == b for a, b in zip(consumed, want.seen[RECORD_STOP:])]}"
                f", launches {launches} != {want_launches}")
        if not all(np.isfinite(v) for v in logs.values()):
            raise AssertionError(f"records fit: History {logs}")
        in_memory = fit["arms"][3]["steps_per_s"]
        out = {"write_seconds": write_s,
               "records_per_s_decoded": n / decode_s,
               "steps_per_s": rate, "in_memory_steps_per_s": in_memory,
               "resumed_at": RECORD_STOP, "launches": launches,
               "files": [os.path.getsize(p) for p in paths]}
        print(f"  {n} CIFAR records in {RECORD_FILES} files "
              f"({sum(out['files']) / 2**20:.1f} MiB, written in "
              f"{write_s:.2f} s): {out['records_per_s_decoded']:.0f} "
              f"records/s read, crc-verified and decoded (shuffle buffer "
              f"512); fit over RecordDataset {rate:.3f} steps/s against "
              f"4t's in-memory {in_memory:.3f} (K=1, no checkpoints); a run "
              f"stopped at step {RECORD_STOP} resumed on exactly the "
              f"uninterrupted stream's batches {RECORD_STOP + 1}-"
              f"{RECORD_BATCHES} (sha256); launches {launches} = "
              f"{steps_total} steps x {GN_PER_STEP} [{card}]")
        del tr, first, resumed
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 7s: stochastic BERT-base
# ---------------------------------------------------------------------------

BERT_DROPOUT = 0.1
STOCH_WINDOW_LAYERS = 2


def _bert_decay_mask(params):
    """No weight decay on biases, LayerNorm parameters or embedding
    tables (the usual BERT fine-tune mask)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        return not ({"bias", "scale", "table"} & set(path))
    return walk(params, ())


def _stochastic_bert(device, cfg, tx, batch_size, seq, *, seed=0):
    """(step, state, batch): BERT ``cfg`` with dropout, f32 master weights
    random from ``seed``, the state's key ``PRNGKey(7)``; tokens and
    labels from numpy seed 0 (bench.py's BERT batch)."""
    import functools

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch import random as random_lib
    from cloud_tpu_torch.models import bert
    from cloud_tpu_torch.training import train

    params = bridge.init_bert(cfg, torch.Generator().manual_seed(seed),
                              device="cpu")
    state = train.create_sharded_state(
        None, lambda _: bridge.map_leaves(params, torch.clone), tx,
        train_rng=random_lib.PRNGKey(7), device=device)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (batch_size, seq))
    label = rng.integers(0, 2, batch_size)
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(device),
             "label": torch.from_numpy(label.astype(np.int64)).to(device)}
    loss = functools.partial(bert.loss_fn, cfg=cfg, device=device)
    return loss, state, batch


def check_stochastic_bert(device, card):
    """7s's checks: (1) one f32 stochastic step of BERT-base (12 layers)
    at b2 x T128 on the card against the same step on the CPU (SGD 0.1,
    the same key): loss within 1e-4 relative (another dropout mask moves
    it far more), grad_norm within 1e-3 relative (an f32 sum of 1.1e8
    squared gradients, reduced in another order on each device), every
    parameter (the gradients, through the update) within TOL_F32 of
    max(1, max |p|), the next key equal; (2) a K=4 window (CUDA graph)
    of stochastic steps of BERT-base at 2 layers, f32, b4 x T128, masked
    AdamW, against 4 eager stochastic steps: params and both moments
    within 1e-6 of max(1, max |p|), the key equal, launches exact."""
    import dataclasses

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import bert
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.training import optimizers, train

    out = {}
    cfg = dataclasses.replace(bert.BERT_BASE, dtype=torch.float32,
                              dropout_rate=BERT_DROPOUT)
    res = {}
    for dev in ("cpu", device):
        tx = optimizers.sgd(0.1)
        loss, state, batch = _stochastic_bert(dev, cfg, tx, 2, BERT_SEQ)
        step = train.make_train_step(loss, tx, stochastic=True)
        state, m = step(state, batch)
        res[str(dev)] = (state, {k: float(v) for k, v in m.items()})
    (cpu_state, cpu_m), (gpu_state, gpu_m) = res["cpu"], res[str(device)]
    for key, tol in (("loss", 1e-4), ("grad_norm", 1e-3)):
        rel = abs(gpu_m[key] - cpu_m[key]) / abs(cpu_m[key])
        out[f"b2 {key} rel"] = rel
        if not rel <= tol:
            raise AssertionError(f"stochastic BERT b2 {key}: card "
                                 f"{gpu_m[key]} vs CPU {cpu_m[key]}")
    if not torch.equal(gpu_state.rng.cpu(), cpu_state.rng):
        raise AssertionError("stochastic BERT b2: the keys differ")
    out["b2 params"] = _hold("stochastic BERT b2 params",
                             [p.cpu() for p in bridge.leaves(
                                 gpu_state.params)],
                             bridge.leaves(cpu_state.params), TOL_F32)
    print(f"  f32 stochastic BERT-base b2xT{BERT_SEQ} (dropout "
          f"{BERT_DROPOUT}), card vs CPU: loss {gpu_m['loss']:.6f} vs "
          f"{cpu_m['loss']:.6f}, grad_norm {gpu_m['grad_norm']:.5f} vs "
          f"{cpu_m['grad_norm']:.5f} (rel {out['b2 grad_norm rel']:.1e}), "
          f"params max_abs_err "
          f"{out['b2 params']:.3e}, next key equal ok [{card}]")
    del res, cpu_state, gpu_state
    torch.cuda.empty_cache()

    k = FUSED_K
    cfg2 = dataclasses.replace(cfg, num_layers=STOCH_WINDOW_LAYERS)
    tx = optimizers.adamw(1e-4, mu_dtype=None, mask=_bert_decay_mask)
    loss, state0, batch = _stochastic_bert(device, cfg2, tx, 4, BERT_SEQ)
    super_batch = {n: torch.stack([t.roll(i, 0) for i in range(k)])
                   for n, t in batch.items()}
    window = train.make_multi_step(loss, tx, steps_per_dispatch=k,
                                   stochastic=True)

    def fresh():
        from cloud_tpu_torch.training import trainer
        return trainer._copy_state(state0, device)

    dispatch.reset_launch_counts()
    got, _ = window(fresh(), super_batch)
    torch.cuda.synchronize()
    per_step = {n: STOCH_WINDOW_LAYERS for n in TRAIN_ATTN_KERNELS}
    _window_launches("stochastic BERT window", dispatch.launch_counts(
        TRAIN_ATTN_KERNELS), window, (0, 0), per_step, k)
    want = fresh()
    step = train.make_train_step(loss, tx, stochastic=True)
    for i in range(k):
        want, _ = step(want, {n: t[i] for n, t in super_batch.items()})
    if not torch.equal(got.rng, want.rng) or int(got.step) != k:
        raise AssertionError("stochastic BERT window: the key or the step "
                             "count differs from the eager steps'")
    for name, a, b in (("params", got.params, want.params),
                       ("mu", got.opt_state["mu"], want.opt_state["mu"]),
                       ("nu", got.opt_state["nu"], want.opt_state["nu"])):
        out[f"window {name}"] = _hold(f"stochastic BERT window {name}",
                                      bridge.leaves(a), bridge.leaves(b),
                                      1e-6)
    print(f"  f32 stochastic BERT {STOCH_WINDOW_LAYERS} layers b4xT"
          f"{BERT_SEQ}, masked AdamW: window of {k} (CUDA graph) vs {k} "
          f"eager steps: params {out['window params']:.3e}, mu "
          f"{out['window mu']:.3e}, nu {out['window nu']:.3e} (tol 1e-6 x "
          f"max(1, max|p|)), key equal ok [{card}]")
    del window, got, want, state0
    torch.cuda.empty_cache()
    return out


def run_stochastic_bert(device, card, plain):
    """7s: BERT-base b32 x T128 bf16 with dropout 0.1, ``stochastic=True``
    and ``adamw(2e-5, mask=...)`` for 3 + 10 steps (exactly 12 K5, 12 K6
    and 12 K7 launches a step), steps/s beside phase 7's dropout-free arm
    (``plain``), one step profiled (dropout's device share: the step's
    device time over phase 7's, less one), then :func:`check_stochastic_bert`."""
    import dataclasses

    import torch

    from cloud_tpu_torch.models import bert
    from cloud_tpu_torch.training import optimizers, train

    cfg = dataclasses.replace(bert.BERT_BASE, dropout_rate=BERT_DROPOUT)
    tx = optimizers.adamw(2e-5, mu_dtype=None, mask=_bert_decay_mask)

    def setup():
        loss, state, batch = _stochastic_bert(device, cfg, tx, BERT_BATCH,
                                              BERT_SEQ)
        return train.make_train_step(loss, tx, stochastic=True), state, batch

    result, run = run_steps(
        card, f"stochastic BERT-base b{BERT_BATCH}xT{BERT_SEQ} bf16, "
        f"dropout {BERT_DROPOUT}, masked AdamW", setup, BERT_PER_STEP,
        BERT_BATCH * BERT_SEQ, "tokens", warmup=3, iters=10)
    result.update(profile_attn_step(
        card, f"stochastic BERT b{BERT_BATCH}xT{BERT_SEQ}", BERT_PER_STEP,
        *run))
    del run
    torch.cuda.empty_cache()
    busy, base = result["step_device_busy_ms"], plain["step_device_busy_ms"]
    result["dropout_device_ms"] = busy - base
    result["dropout_device_share"] = (busy - base) / busy
    result["plain_steps_per_s"] = plain["steps_per_s"]
    print(f"  stochastic BERT {result['steps_per_s']:.3f} steps/s against "
          f"phase 7's {plain['steps_per_s']:.3f} without dropout; device "
          f"{busy:.3f} ms a step against {base:.3f}: dropout (threefry "
          f"masks, splits, selects) {busy - base:.3f} ms, "
          f"{result['dropout_device_share']:.3f} of the step [{card}]")
    result["checks"] = check_stochastic_bert(device, card)
    return result


#: Kernels whose bf16 instantiations must run on the tensor cores, by
#: library.
# ---------------------------------------------------------------------------
# The rest of the model zoo: MoE CloudLM served (3m) and trained (6m),
# remat "dots" (6d) and ViT-B/16 trained (8v)
# ---------------------------------------------------------------------------

#: 3m: CloudLM SMALL with the repo's default MoE (8 experts, top 2,
#: capacity 1.25, expert hidden 3072) on the continuous scheduler.
MOE_SERVE = {"requests": 16, "bucket": 128, "new": 32, "parity": 4}
#: 8v: ViT-B/16 at 224 px (T=196, GAP), remat "full".
VIT_BATCH = 128
VIT_PER_STEP = {"flash_fwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
VIT_SHAPES = ((VIT_BATCH, 196), (VIT_BATCH, 197))


def _moe_small(**kw):
    from cloud_tpu_torch.models import transformer
    from cloud_tpu_torch.models.moe import MoeConfig

    return transformer.SMALL.scaled(moe=MoeConfig(), **kw)


def _moe_requests(vocab: int, n: int, seed: int):
    """``n`` prompts no longer than the bucket, with budgets up to
    ``MOE_SERVE["new"]``."""
    rng = np.random.default_rng(seed)
    lengths = [5, 20, 31, 48, 90, 128]
    return [(rng.integers(1, vocab, lengths[i % len(lengths)]).astype(
        np.int32), int(rng.choice([8, 16, 24, MOE_SERVE["new"]])))
        for i in range(n)]


def _moe_picks(generation, params, cfg, device, candidates, *, kv_quant):
    """The first ``MOE_SERVE["parity"]`` candidates whose greedy path,
    prefilled at the bucket's width, keeps its top-2 gap (1e-3, or
    ``QUANT_TIE_GAP`` under ``kv_quant``) at every step."""
    limit = QUANT_TIE_GAP if kv_quant else 1e-3
    picks = []
    for prompt, budget in candidates:
        gaps, _ = _greedy_gaps(generation, params, prompt, budget, cfg,
                               device, kv_quant=kv_quant,
                               width=MOE_SERVE["bucket"])
        if min(gaps) >= limit:
            picks.append((prompt, budget))
        if len(picks) == MOE_SERVE["parity"]:
            return picks
    raise AssertionError(f"only {len(picks)} of {len(candidates)} prompts "
                         f"are tie-free at {limit} (MoE, bucket width)")


def _moe_parity(what, generation, params, cfg, device, engine_params, serve,
                picks, *, kv_quant):
    """``picks`` served one at a time equal ``generate()`` on each prompt
    padded to the bucket (the same T, so the same expert capacity)."""
    import torch

    from cloud_tpu_torch.serving import ServingEngine

    with ServingEngine(engine_params, cfg, serve, device=device) as engine:
        served = [engine.submit(p, max_new_tokens=b).result(timeout=600)
                  for p, b in picks]
    for (prompt, budget), res in zip(picks, served):
        want = generation.generate(
            params, torch.from_numpy(_padded(prompt, MOE_SERVE["bucket"])),
            torch.tensor([len(prompt)]), cfg, max_new_tokens=budget,
            kv_quant=kv_quant, device=device)["tokens"][0].cpu().numpy()
        if not np.array_equal(want, res.tokens):
            first = int(np.flatnonzero(want != res.tokens)[0])
            raise AssertionError(f"{what}: engine != generate() for a "
                                 f"{len(prompt)}-token prompt at token "
                                 f"{first}")


def _moe_measured(engine, requests, kernels):
    """One measured run of ``requests`` (staggered), launches counted from
    0 just before and read just after; returns (results, wall, launches,
    stats before, stats after)."""
    import torch

    from cloud_tpu_torch.ops import dispatch

    engine.submit(requests[0][0], max_new_tokens=4).result(timeout=600)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    stats0 = engine.stats()
    start = time.perf_counter()
    futures = []
    for prompt, budget in requests:
        futures.append(engine.submit(prompt, max_new_tokens=budget))
        time.sleep(0.002)
    results = [f.result(timeout=600) for f in futures]
    wall = time.perf_counter() - start
    return (results, wall, dispatch.launch_counts(kernels), stats0,
            engine.stats())


def run_moe_engine(device, card):
    """3m: CloudLM SMALL with the default MoE through ``ServingEngine`` on
    the continuous scheduler: 16 staggered requests (bucket 128, up to 32
    new tokens) in bf16 and again with int8 weights and an int8 grid, K5
    and K8 (or K8q) launches held to the engine's stats; f32 tokens equal
    ``generate()`` on tie-free prompts padded to the bucket, with and
    without int8 + kv_quant; the served bf16 params through
    ``save_pretrained``/``load_pretrained`` come back bit for bit and
    serve the same tokens."""
    import tempfile

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import export, generation, quantization
    from cloud_tpu_torch.serving import ServeConfig, ServingEngine
    from cloud_tpu_torch.utils.benchmarking import decode_setup

    cfg, params, _, _ = decode_setup(config=_moe_small(), device=device,
                                     seed=0)
    pparams = generation.prepare_params(params, cfg)
    serve = ServeConfig(max_new_tokens=MOE_SERVE["new"],
                        prompt_buckets=(MOE_SERVE["bucket"],),
                        num_slots=NUM_SLOTS, chunk_tokens=CHUNK)
    qserve = ServeConfig(max_new_tokens=MOE_SERVE["new"],
                         prompt_buckets=(MOE_SERVE["bucket"],),
                         num_slots=NUM_SLOTS, chunk_tokens=CHUNK,
                         kv_quant=True)
    requests = _moe_requests(cfg.vocab_size, MOE_SERVE["requests"], seed=1)
    layers_n = cfg.num_layers
    out = {"param_bytes": quantization.param_bytes(pparams)}
    launches = {}
    for arm, engine_params, arm_serve in (
            ("bf16", pparams, serve),
            ("int8_kv_quant", quantization.quantize_params(params), qserve)):
        with ServingEngine(engine_params, cfg, arm_serve,
                           device=device) as engine:
            results, wall, got, d0, d1 = _moe_measured(
                engine, requests, QUANT_SERVING_KERNELS)
        _check_launches(f"3m {arm}", got, layers_n, d0, d1,
                        quantized=arm_serve.kv_quant)
        for (prompt, budget), res in zip(requests, results):
            if (res.tokens.shape != (budget,) or res.tokens.min() < 0
                    or res.tokens.max() >= cfg.vocab_size):
                raise AssertionError(f"3m {arm}: bad result {res.tokens} "
                                     f"for budget {budget}")
        tokens = sum(r.num_generated for r in results)
        tpot = [(r.latency_seconds - r.ttft_seconds)
                / max(r.num_generated - 1, 1) for r in results]
        ttft = [r.ttft_seconds for r in results]
        row = {"tokens_per_s": tokens / wall, "tpot_p50_s": _pct(tpot, 50),
               "ttft_p50_s": _pct(ttft, 50),
               "param_bytes": quantization.param_bytes(engine_params),
               "launches": got}
        out[arm] = row
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        print(f"  3m MoE SMALL ({cfg.moe.num_experts} experts, top "
              f"{cfg.moe.top_k}) {arm}: {len(results)} requests, {tokens} "
              f"tokens in {wall:.3f} s = {row['tokens_per_s']:.1f} tok/s; "
              f"TPOT p50 {row['tpot_p50_s'] * 1e3:.3f} ms, TTFT p50 "
              f"{row['ttft_p50_s'] * 1e3:.3f} ms; param_bytes "
              f"{row['param_bytes']}; launches {got} ok [{card}]")
        del engine_params

    cfg32 = cfg.scaled(dtype=torch.float32)
    candidates = _moe_requests(cfg.vocab_size, 24, seed=3)
    picks = _moe_picks(generation, params, cfg32, device, candidates,
                       kv_quant=False)
    _moe_parity("3m f32", generation, params, cfg32, device, params, serve,
                picks, kv_quant=False)
    qparams = quantization.quantize_params(params)
    qpicks = _moe_picks(generation, qparams, cfg32, device, candidates,
                        kv_quant=True)
    _moe_parity("3m f32 int8 + kv_quant", generation, qparams, cfg32,
                device, qparams, qserve, qpicks, kv_quant=True)
    del qparams
    print(f"  3m f32: engine == generate() at the bucket's width on "
          f"{len(picks)} tie-free prompts (gap 1e-3), and with int8 weights "
          f"+ kv_quant on {len(qpicks)} (gap {QUANT_TIE_GAP}) ok [{card}]")

    with tempfile.TemporaryDirectory() as tmp:
        start = time.perf_counter()
        export.save_pretrained(tmp, pparams, cfg)
        save_s = time.perf_counter() - start
        loaded, cfg2 = export.load_pretrained(tmp, device=device)
        load_s = time.perf_counter() - start - save_s
    if cfg2 != cfg:
        raise AssertionError(f"3m export: config {cfg2} != {cfg}")
    for a, b in zip(bridge.leaves(loaded), bridge.leaves(pparams)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError("3m export: a loaded leaf differs")
    served = []
    for engine_params in (pparams, loaded):
        with ServingEngine(engine_params, cfg, serve,
                           device=device) as engine:
            served.append([engine.submit(p, max_new_tokens=b).result(
                timeout=600).tokens for p, b in requests[:4]])
    if not all(np.array_equal(a, b) for a, b in zip(*served)):
        raise AssertionError("3m export: the loaded bundle serves other "
                             "tokens")
    out["export"] = {"save_s": save_s, "load_s": load_s}
    print(f"  3m export: bf16 bundle of {out['param_bytes']} bytes saved in "
          f"{save_s:.2f} s, loaded in {load_s:.2f} s, bit for bit; 4 "
          f"requests one at a time serve the same tokens ok [{card}]")
    del loaded, pparams, params
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def _bmm_split(events, experts: int, batch: int):
    """Device ms of the measured step's batched products (``aten::bmm``,
    read through ``record_shapes``) by their batch dimension: the expert
    products batch over experts, dispatch and combine over the batch."""
    from torch.autograd import DeviceType

    if experts == batch:
        raise ValueError("the split needs experts != batch")
    split = {"experts": 0.0, "dispatch_combine": 0.0}
    for evt in events:
        if evt.device_type != DeviceType.CPU or evt.name != "aten::bmm":
            continue
        lead = evt.input_shapes[0][0] if evt.input_shapes else None
        key = {experts: "experts", batch: "dispatch_combine"}.get(lead)
        if key is not None:
            split[key] += sum(k.duration for k in evt.kernels) / 1e3
    return split


def profile_moe_step(card, what, step, state, batch, cfg):
    """One MoE LM step after a lead step, its device time by family:
    attention kernels (K5, K6, K7), expert products, dispatch and combine,
    the rest; and the idle share."""
    wall_ms, enqueue_ms, events, rows = _profile_checked(
        step, state, batch, _attn_complaint(what, LM_PER_STEP),
        record_shapes=True)
    busy = sum(r[0] for r in rows) / 1e3
    split = {"attention": sum(r[0] for r in rows if any(
        k in r[2] for k in ATTN_ROWS.values())) / 1e3}
    split.update(_bmm_split(events, cfg.moe.num_experts, LM_BATCH))
    split["rest"] = busy - sum(split.values())
    if not split["experts"] > 0 or not split["dispatch_combine"] > 0:
        raise AssertionError(f"{what}: no expert or dispatch products in "
                             f"the profile: {split}")
    print(f"  {what} step: wall {wall_ms:.3f} ms, host enqueue "
          f"{enqueue_ms:.3f} ms, device kernels {busy:.3f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}; " + ", ".join(
              f"{k} {v:.3f} ms ({v / busy:.3f})" for k, v in split.items())
          + f" [{card}]")
    return {"step_wall_ms": wall_ms, "step_enqueue_ms": enqueue_ms,
            "step_device_busy_ms": busy,
            "step_idle_share": 1 - busy / wall_ms, "device_ms": split}


def _f32_step_on_both(what, device, card, cfg, params, loss_fn, batch,
                      per_step):
    """One SGD(0.1) step of ``loss_fn`` in f32 on the CPU and on the card
    from the same params and batch: loss within 1e-4 relative, every
    parameter within TOL_F32 of max(1, max |p|); the card's launches
    exactly ``per_step``.  Returns (errors, card metrics, CPU metrics)."""
    import functools

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.training import optimizers, train

    res = {}
    for dev in ("cpu", device):
        tx = optimizers.sgd(0.1)
        state = train.create_sharded_state(
            None, lambda _: bridge.map_leaves(params, torch.clone), tx,
            device=dev)
        step = train.make_train_step(
            functools.partial(loss_fn, device=dev), tx)
        dispatch.reset_launch_counts()
        state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
        res[str(dev)] = (state, {k: float(v) for k, v in m.items()},
                         dispatch.launch_counts(per_step))
    (cpu_state, cpu_m, _), (gpu_state, gpu_m, launches) = (
        res["cpu"], res[str(device)])
    if launches != per_step:
        raise AssertionError(f"{what}: launches {launches} != {per_step}")
    errs = {"loss_rel": abs(gpu_m["loss"] - cpu_m["loss"])
            / abs(cpu_m["loss"])}
    if not errs["loss_rel"] <= 1e-4:
        raise AssertionError(f"{what} loss: card {gpu_m['loss']} vs CPU "
                             f"{cpu_m['loss']}")
    errs["params"] = _hold(f"{what} params",
                           [p.cpu() for p in bridge.leaves(gpu_state.params)],
                           bridge.leaves(cpu_state.params), TOL_F32)
    print(f"  {what}, card vs CPU: loss {gpu_m['loss']:.6f} vs "
          f"{cpu_m['loss']:.6f}, params max_abs_err {errs['params']:.3e} "
          f"(tol 1e-4 x max(1, max|p|)); launches {launches} ok [{card}]")
    return errs, gpu_m, cpu_m


def run_moe_training(device, card):
    """6m: CloudLM SMALL-MoE b4 x T1024, bf16 on f32 masters, remat
    "full", ``adamw(1e-4)``, 3 + 5 chained steps with 24/12/12 K5/K6/K7
    launches a step and a finite positive aux; a profiled step by family;
    then one f32 step at 2 layers, b2 x T128, on the card against the
    CPU (aux within 1e-5)."""
    import functools

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import transformer
    from cloud_tpu_torch.utils import benchmarking

    cfg = _moe_small(tied_embeddings=True)
    result, (step, state, batch) = run_steps(
        card, f"MoE SMALL b{LM_BATCH}xT{LM_SEQ} bf16",
        lambda: benchmarking.lm_train_setup(
            batch_size=LM_BATCH, seq_len=LM_SEQ, config=cfg, device=device),
        LM_PER_STEP, LM_BATCH * LM_SEQ, "tokens", warmup=3, iters=5)
    state, metrics = step(state, batch)
    aux = float(metrics["aux"])
    if not (np.isfinite(aux) and aux > 0):
        raise AssertionError(f"6m: aux {aux} is not finite and positive")
    result["aux"] = aux
    result.update(profile_moe_step(card, "MoE SMALL b4xT1024", step, state,
                                   batch, cfg))
    del step, state, batch
    torch.cuda.empty_cache()

    cfg32 = cfg.scaled(num_layers=2, dtype=torch.float32)
    params = bridge.init(cfg32, torch.Generator().manual_seed(3),
                         device="cpu")
    tokens = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 128))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
    errs, gpu_m, cpu_m = _f32_step_on_both(
        "6m f32 MoE SMALL 2 layers b2xT128", device, card, cfg32, params,
        functools.partial(transformer.loss_fn, config=cfg32), batch,
        LM2_PER_STEP)
    errs["aux_abs"] = abs(gpu_m["aux"] - cpu_m["aux"])
    if not errs["aux_abs"] <= 1e-5:
        raise AssertionError(f"6m f32 aux: card {gpu_m['aux']} vs CPU "
                             f"{cpu_m['aux']}")
    print(f"  6m f32 aux: card {gpu_m['aux']:.7f} vs CPU {cpu_m['aux']:.7f}"
          f" (tol 1e-5) ok [{card}]")
    result["f32_step_parity"] = errs
    return result


REMAT_POLICIES = (("none", False, "full"), ("full", True, "full"),
                  ("dots", True, "dots"))


def run_remat_dots(device, card):
    """6d: the dense SMALL LM step of phase 6 (b4 x T1024) under remat
    "none", "full" and "dots": in f32 (TF32 off, cuDNN deterministic)
    loss and grad norm equal across the three; in bf16 each policy's
    steps/s, peak memory, device ms and K5 launches (12 a step without
    remat, 24 with it: "dots" recomputes the flash forward as JAX
    recomputes the ``pallas_call``); then a K=2 window of "dots" steps
    (CUDA graph) against 2 eager "dots" steps."""
    import functools

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import transformer
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.training import optimizers, train
    from cloud_tpu_torch.utils import benchmarking

    base = transformer.SMALL.scaled(tied_embeddings=True)
    cfg32 = base.scaled(dtype=torch.float32)
    params = bridge.init(cfg32, torch.Generator(device=device).manual_seed(0),
                         device=device)
    tokens = np.random.default_rng(0).integers(1, base.vocab_size,
                                               (LM_BATCH, LM_SEQ))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(device)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    f32 = {}
    for name, remat, policy in REMAT_POLICIES:
        cfg = cfg32.scaled(remat=remat, remat_policy=policy)
        leaves = bridge.map_leaves(params,
                                   lambda t: t.detach().requires_grad_(True))
        dispatch.reset_launch_counts()
        loss, _ = transformer.loss_fn(leaves, batch, cfg, device=device)
        grads = torch.autograd.grad(loss, bridge.leaves(leaves))
        f32[name] = (float(loss.detach()), float(train.global_norm(grads)),
                     dispatch.launch_counts(("flash_fwd",))["flash_fwd"])
        del leaves, loss, grads
    torch.backends.cudnn.deterministic = deterministic
    want_k5 = {name: base.num_layers * (2 if remat else 1)
               for name, remat, _ in REMAT_POLICIES}
    if {n: v[2] for n, v in f32.items()} != want_k5:
        raise AssertionError(f"6d f32: K5 launches "
                             f"{ {n: v[2] for n, v in f32.items()} } != "
                             f"{want_k5}")
    if len({v[:2] for v in f32.values()}) != 1:
        raise AssertionError(f"6d f32: loss and grad norm differ across "
                             f"policies: {f32}")
    print(f"  6d f32 SMALL b{LM_BATCH}xT{LM_SEQ}: loss "
          f"{f32['none'][0]!r}, grad_norm {f32['none'][1]!r}, equal under "
          f"none, full and dots; K5 launches {want_k5} ok [{card}]")
    del params
    torch.cuda.empty_cache()

    out = {"f32_loss": f32["none"][0], "f32_grad_norm": f32["none"][1]}
    for name, remat, policy in REMAT_POLICIES:
        per_step = dict(LM_PER_STEP, flash_fwd=want_k5[name])
        cfg = base.scaled(remat=remat, remat_policy=policy)
        row, run = run_steps(
            card, f"6d SMALL b{LM_BATCH}xT{LM_SEQ} bf16 remat {name}",
            lambda: benchmarking.lm_train_setup(
                batch_size=LM_BATCH, seq_len=LM_SEQ, config=cfg,
                device=device),
            per_step, LM_BATCH * LM_SEQ, "tokens", warmup=2, iters=5)
        wall_ms, _, _, rows = _profile_checked(
            *run, _attn_complaint(f"6d remat {name}", per_step))
        row["step_device_busy_ms"] = sum(r[0] for r in rows) / 1e3
        row["step_wall_ms"] = wall_ms
        print(f"    remat {name}: device {row['step_device_busy_ms']:.3f} "
              f"ms a step, peak memory "
              f"{row['max_memory_allocated'] / 2**30:.3f} GiB [{card}]")
        out[name] = row
        del run
        torch.cuda.empty_cache()

    k = 2
    cfg = base.scaled(num_layers=2, dtype=torch.float32, remat_policy="dots")
    lm_params = bridge.init(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    tokens = np.random.default_rng(4).integers(1, cfg.vocab_size, (k, 2, 256))
    win_batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(
        device)}
    adamw = optimizers.adamw(1e-4, mu_dtype=None)
    loss_fn = functools.partial(transformer.loss_fn, config=cfg,
                                device=device)

    def fresh():
        return train.create_sharded_state(
            None, lambda _: bridge.map_leaves(lm_params, torch.clone), adamw,
            device=device)

    window = train.make_multi_step(loss_fn, adamw, steps_per_dispatch=k)
    dispatch.reset_launch_counts()
    got, _ = window(fresh(), win_batch)
    torch.cuda.synchronize()
    _window_launches("6d dots window", dispatch.launch_counts(
        TRAIN_ATTN_KERNELS), window, (0, 0), LM2_PER_STEP, k)
    want = fresh()
    step = train.make_train_step(loss_fn, adamw)
    for i in range(k):
        want, _ = step(want, {"tokens": win_batch["tokens"][i]})
    errs = {name: _hold(f"6d dots window {name}", bridge.leaves(a),
                        bridge.leaves(b), 1e-6)
            for name, a, b in (("params", got.params, want.params),
                               ("mu", got.opt_state["mu"],
                                want.opt_state["mu"]),
                               ("nu", got.opt_state["nu"],
                                want.opt_state["nu"]))}
    print(f"  6d f32 SMALL 2 layers b2xT256, remat dots: window of {k} "
          f"(CUDA graph) vs {k} eager steps: params {errs['params']:.3e}, "
          f"mu {errs['mu']:.3e}, nu {errs['nu']:.3e} (tol 1e-6 x max(1, "
          f"max|p|)) ok [{card}]")
    out["window"] = errs
    out["launches"] = {n: sum(out[p]["launches"][n] for p, _, _ in
                              REMAT_POLICIES) for n in TRAIN_ATTN_KERNELS}
    del window, step, got, want
    torch.cuda.empty_cache()
    return out


def check_flash_at_vit(device, card):
    """K5 against its plain version, and K6/K7 against theirs on K5's out
    and lse, at ViT-B/16's (128, 196, 12, 64) and (128, 197, 12, 64)
    (CLS) non-causal, bf16 and f32 (phase 2c times them at T=196).
    Returns the worst errors by kernel and type."""
    import torch

    from cloud_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(8)
    worst = {k: {"bfloat16": 0.0, "float32": 0.0} for k in TRAIN_ATTN_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for b, t in VIT_SHAPES:
            errs = _bwd_case(fa, b, t, False, dtype, gen, mask_kind=None,
                             glse=False)
            for name in TRAIN_ATTN_KERNELS:
                worst[name][dname] = max(worst[name][dname], errs[name])
        torch.cuda.empty_cache()
    print(f"  K5/K6/K7 at ViT's B={VIT_BATCH} T=196/197 non-causal, bf16 and "
          f"f32: max_abs_err " + ", ".join(
              f"{n} {w['bfloat16']:.3e}/{w['float32']:.3e}"
              for n, w in worst.items()) + f" ok [{card}]")
    return worst


def run_vit_training(device, card):
    """8v: ViT-B/16 at 224 px (T=196, GAP), b128 bf16 on f32 masters,
    remat "full", ``adamw(3e-4)``, 3 + 10 chained steps with 24/12/12
    K5/K6/K7 launches a step, a profiled step by family, the flash kernels
    at ViT's shapes, and one f32 step at 2 layers, 56 px, patch 8 (T=49),
    on the card against the CPU."""
    import functools

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import vit
    from cloud_tpu_torch.utils import benchmarking

    result, run = run_steps(
        card, f"ViT-B/16 224 b{VIT_BATCH} bf16",
        lambda: benchmarking.vit_train_setup(batch_size=VIT_BATCH,
                                             device=device),
        VIT_PER_STEP, VIT_BATCH, "images", warmup=3, iters=10)
    result.update(profile_attn_step(card, f"ViT-B/16 b{VIT_BATCH}",
                                    VIT_PER_STEP, *run))
    del run
    torch.cuda.empty_cache()
    worst = check_flash_at_vit(device, card)
    cfg = vit.VIT_BASE_16.scaled(num_layers=2, image_size=56, patch_size=8,
                                 dtype=torch.float32)
    params = bridge.init_vit(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
    rng = np.random.default_rng(4)
    label = rng.integers(0, cfg.num_classes, 4)
    image = rng.normal(size=(4, 56, 56, 3)).astype(np.float32)
    batch = {"image": torch.from_numpy(image),
             "label": torch.from_numpy(label)}
    errs, _, _ = _f32_step_on_both(
        "8v f32 ViT 2 layers 56 px patch 8 (T=49) b4", device, card, cfg,
        params, functools.partial(vit.loss_fn, cfg=cfg), batch,
        {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2})
    result.update({"f32_step_parity": errs, "flash_worst": worst})
    return result


TENSOR_CORE_KERNELS = {"flash_fwd": ["flash_fwd_kernel_tc"],
                       "flash_bwd": ["flash_bwd_dq_kernel_tc",
                                     "flash_bwd_dkv_kernel_tc"]}


# ---------------------------------------------------------------------------
# Phases 2 (tp) and 3tp: tensor-parallel serving, two ranks on the card
# ---------------------------------------------------------------------------

#: The slice of phase 3tp: SMALL at tp 2 (6 of its 12 heads a rank), both
#: ranks on the one card over gloo (NCCL refuses two ranks on a device).
TP = 2
TP_HEADS = HEADS // TP
#: Its requests: 8 prompts of 5..128 tokens, 12 new tokens each.  Token
#: identity is held in f32 (as phase 3 holds it) on the same bf16-valued
#: weights: on prompts whose f32 greedy path keeps a top-2 gap of 1e-3
#: (QUANT_TIE_GAP with an int8 KV cache) at every step.  In bf16 the two
#: ranks' sums of a row-split product round apart from one card's product
#: (a CPU run of SMALL moved logits by up to 0.05, about what bf16 against
#: f32 moves them), so the bf16 arm's matches are counted, not asserted.
TP_REQUESTS, TP_BUDGET = 8, 12
TP_SERVE = {"max_new_tokens": 16, "prompt_buckets": (32, 128),
            "num_slots": NUM_SLOTS, "chunk_tokens": CHUNK}
#: The prefix arm: 16-token blocks, 32-token prefill chunks, pages
#: attached through K8's block table.
TP_PREFIX = {"prefix_cache_blocks": 16, "prefix_block_tokens": 16,
             "prefill_chunk_tokens": 32, "decode_kernel": "auto"}
#: How long rank 0 waits for its follower to start, join and report.
TP_TIMEOUT_S = 180
#: Model of the TP phases (SMALL, or a narrower config in a CPU rehearsal).
TP_MODEL = None


def _split_heads(full, rank):
    """Rank ``rank``'s heads of a full-width ``[..., H, D]`` projection: a
    strided view, as a column-split of the full projection gives them."""
    return full[..., rank * TP_HEADS:(rank + 1) * TP_HEADS, :]


def check_tp_kernels(device, card):
    """K5, K8 and K8q at a tp-2 rank's head count: q/k/v (or q) from a
    column-split of a full-width SMALL projection (``[B, T, 768] @ [768,
    768]``, rank 1's 6 heads as a strided view), K8/K8q over a grid born
    at 6 heads.  Each held against its plain version (``check_close``),
    then timed beside the plain version, SDPA and the bound, in event and
    device time.  Returns one row per kernel."""
    import torch
    import torch.nn.functional as F

    from cloud_tpu_torch.ops import flash_attention as fa
    from cloud_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device=device).manual_seed(26)
    dim = HEADS * HEAD_DIM

    def projected(b, t, dtype):
        x = torch.randn((b, t, dim), generator=gen, device=device).to(dtype)
        out = []
        for _ in range(3):
            w = (torch.randn((dim, dim), generator=gen, device=device)
                 / dim ** 0.5).to(dtype)
            out.append(_split_heads((x @ w).reshape(b, t, HEADS, HEAD_DIM),
                                    1))
        return out

    rows, errs = {}, {}
    t = 128
    mask = (torch.arange(t, device=device) < 100).to(torch.int32)[None]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        q, k, v = projected(1, t, dtype)
        if q.is_contiguous():
            raise AssertionError("the split heads are not a strided view")
        out, lse = fa._flash_kernel(q, k, v, causal=True, mask=mask)
        ref_out, ref_lse = fa._reference_with_lse(q, k, v, causal=True,
                                                  mask=mask)
        torch.cuda.synchronize()
        what = f"K5 flash_fwd {name} T={t} H={TP_HEADS} (strided heads)"
        errs[f"flash_fwd {name}"] = max(
            check_close(what, out, ref_out, name),
            check_close(what + " lse", lse, ref_lse, name))
        print(f"  {what}: max_abs_err={errs[f'flash_fwd {name}']:.3e} ok")
        if dtype == torch.bfloat16:
            kernel, kernel_dev = event_and_device_ms(
                lambda: fa._flash_kernel(q, k, v, causal=True, mask=mask))
            plain, plain_dev = event_and_device_ms(
                lambda: fa._reference_with_lse(q, k, v, causal=True,
                                               mask=mask))
            allowed = (torch.ones((t, t), dtype=torch.bool,
                                  device=device).tril()
                       & (mask[:, None, None, :] != 0))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library, library_dev = event_and_device_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=allowed))
            nbytes = (4 * q.numel() * 2 + mask.numel() * 4
                      + TP_HEADS * t * 4)
            flops = 4 * TP_HEADS * HEAD_DIM * t * (t + 1) / 2
            b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
            rows["flash_fwd"] = {
                "ms": kernel, "device_ms": kernel_dev, "plain_ms": plain,
                "plain_device_ms": plain_dev, "library_ms": library,
                "library_device_ms": library_dev, "bound_ms": b_ms,
                "bound_by": b_by,
                "shape": f"B=1 T={t} H={TP_HEADS} D={HEAD_DIM} bf16 masked, "
                         f"heads a strided view"}

    s = PAGED_LENGTHS[0]
    lens = np.random.default_rng(1).integers(33, s + 1, NUM_SLOTS)
    cur_len = torch.tensor(lens, dtype=torch.int32, device=device)
    keys = int(lens.sum())
    table = torch.full((NUM_SLOTS, -(-s // 16)), -1, dtype=torch.int32,
                       device=device)
    pool_table = table.clone()
    pool_table[:, :2] = torch.arange(2 * NUM_SLOTS, dtype=torch.int32,
                                     device=device).reshape(NUM_SLOTS, 2)
    for quantized, kname in ((False, "paged_attention"),
                             (True, "paged_attention_int8")):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            slot = {n: torch.randn((NUM_SLOTS, s, TP_HEADS, HEAD_DIM),
                                   generator=gen, device=device).to(dtype)
                    for n in ("k", "v")}
            pool_l = {n: torch.randn((2 * NUM_SLOTS, 16, TP_HEADS, HEAD_DIM),
                                     generator=gen, device=device).to(dtype)
                      for n in ("k", "v")}
            if quantized:
                slot, pool_l = _quantize_leaves(slot), _quantize_leaves(pool_l)
            worst = 0.0
            for tq in (1, 4):
                q = _split_heads(torch.randn(
                    (NUM_SLOTS, tq, HEADS, HEAD_DIM), generator=gen,
                    device=device).to(dtype), 1)
                for pool in (False, True):
                    args = ((q, slot, cur_len, pool_l, pool_table) if pool
                            else (q, slot, cur_len, None, table))
                    out = pa._paged_kernel(*args)
                    ref = pa._reference(*args)
                    torch.cuda.synchronize()
                    worst = max(worst, check_close(
                        f"{kname} {name} H={TP_HEADS} Tq={tq} pool={pool}",
                        out, ref, name))
            errs[f"{kname} {name}"] = worst
            print(f"  {kname} {name} B={NUM_SLOTS} S={s} H={TP_HEADS} (q a "
                  f"strided view), Tq 1 and 4, pool or not: max_abs_err="
                  f"{worst:.3e} ok")
            if dtype != torch.bfloat16:
                continue
            q = _split_heads(torch.randn((NUM_SLOTS, 1, HEADS, HEAD_DIM),
                                         generator=gen, device=device).to(
                                             dtype), 1)
            kernel, kernel_dev = event_and_device_ms(
                lambda: pa._paged_kernel(q, slot, cur_len, None, table),
                iters=50)
            plain, plain_dev = event_and_device_ms(
                lambda: pa._reference(q, slot, cur_len, None, table))
            if quantized:
                kv = {n: (slot[n].float() * slot[f"{n}_scale"]).to(dtype)
                      for n in ("k", "v")}
                per_key = TP_HEADS * (2 * HEAD_DIM + 8)
            else:
                kv = slot
                per_key = 2 * TP_HEADS * HEAD_DIM * 2
            library, library_dev = event_and_device_ms(
                _sdpa_decode(q.contiguous(), kv["k"], kv["v"], cur_len),
                iters=50)
            nbytes = (keys * per_key + 2 * q.numel() * 2 + NUM_SLOTS * 4
                      + table.numel() * 4)
            b_ms, b_by = bound_ms(nbytes, 4 * keys * TP_HEADS * HEAD_DIM,
                                  "bfloat16")
            rows[kname] = {
                "ms": kernel, "device_ms": kernel_dev, "plain_ms": plain,
                "plain_device_ms": plain_dev, "library_ms": library,
                "library_device_ms": library_dev, "bound_ms": b_ms,
                "bound_by": b_by, "live_keys": keys,
                "shape": f"B={NUM_SLOTS} S={s} Tq=1 H={TP_HEADS} "
                         f"D={HEAD_DIM} {'int8' if quantized else 'bf16'} "
                         f"K/V, q a strided view"}
    for kname, row in rows.items():
        print(f"  {kname} at H={TP_HEADS} ({row['shape']}): kernel "
              f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
              f"{row['plain_ms']:.4f} ({row['plain_device_ms']:.4f}), sdpa "
              f"{row['library_ms']:.4f} ({row['library_device_ms']:.4f}), "
              f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}) [{card}]")
    return {"rows": rows, "max_abs_err": errs}


def _tp_model(device, model=None):
    """Phase 3tp's model on ``device``: SMALL (or ``model``) with
    random weights from seed 0 rounded to bf16 values (f32 leaves), made
    alike in every rank's process.  Returns ``(cfg, params)``, ``cfg`` in
    bf16."""
    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import transformer

    cfg = model or transformer.SMALL
    gen = torch.Generator(device=device).manual_seed(0)
    params = bridge.init(cfg, gen, device=device)
    return cfg, bridge.map_leaves(
        params, lambda t: t.to(torch.bfloat16).float())


#: Phase 3tp's engines, in the order every rank builds them: (name,
#: compute dtype, ServeConfig fields).
TP_ARMS = (("bf16", "bfloat16", {}),
           ("f32", "float32", {}),
           ("f32 kv_quant", "float32", {"kv_quant": True}),
           ("f32 prefix", "float32", TP_PREFIX))


def _tp_config(cfg, dtype_name):
    import torch

    return cfg.scaled(dtype=getattr(torch, dtype_name))


def _tp_follower(port, device_name, model, queue):
    """Rank 1 of phase 3tp's slice, in a child process: the same weights,
    the same engines in the same order as rank 0, each running
    ``follow()`` until rank 0 closes it; after each, its own launch
    counts on ``queue`` (an error's repr if it fails)."""
    import datetime

    import torch
    import torch.distributed as dist

    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.parallel import MeshSpec
    from cloud_tpu_torch.serving import ServeConfig, ServingEngine

    device = torch.device(device_name)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.TCPStore("127.0.0.1", port, TP, False,
                          timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    dist.init_process_group("gloo", store=store, rank=1, world_size=TP,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = MeshSpec({"tp": TP}).build(devices=[device] * TP,
                                          backend="gloo")
        cfg, params = _tp_model(device, model)
        for _, dtype_name, fields in TP_ARMS:
            dispatch.reset_launch_counts()
            engine = ServingEngine(params, _tp_config(cfg, dtype_name),
                                   ServeConfig(**TP_SERVE, **fields),
                                   mesh=mesh, device=device)
            engine.follow()
            queue.put(dispatch.launch_counts(QUANT_SERVING_KERNELS))
    except BaseException as exc:  # noqa: BLE001 — reported to rank 0
        queue.put(repr(exc))
        raise
    finally:
        dist.destroy_process_group()


def _tp_prompts(generation, params, cfg32, device):
    """TP_REQUESTS prompts of 5..128 tokens whose f32 greedy paths keep a
    top-2 gap of 1e-3 (and QUANT_TIE_GAP with an int8 KV cache) for
    TP_BUDGET tokens, and the prefix arm's pair: a cold 40-token prompt
    and one sharing its first 32 tokens, tie-free the same way."""
    def tie_free(prompt):
        return all(
            min(_greedy_gaps(generation, params, prompt, TP_BUDGET, cfg32,
                             device, kv_quant=kv_quant)[0]) >= gap
            for kv_quant, gap in ((False, 1e-3), (True, QUANT_TIE_GAP)))

    picks = [p for p, _ in _requests(cfg32.vocab_size, 40, seed=21)
             if len(p) <= TP_SERVE["prompt_buckets"][-1]]
    picks = [p for p in picks if tie_free(p)][:TP_REQUESTS]
    if len(picks) < TP_REQUESTS:
        raise AssertionError(f"only {len(picks)} tie-free prompts")
    rng = np.random.default_rng(22)
    for _ in range(40):
        head = rng.integers(1, cfg32.vocab_size, 32).astype(np.int32)
        pair = [np.concatenate([head, rng.integers(
            1, cfg32.vocab_size, 8).astype(np.int32)]) for _ in range(2)]
        if all(tie_free(p) for p in pair):
            return picks, pair
    raise AssertionError("no tie-free prefix pair in 40 tries")


def _serve_tp_arm(engine, prompts):
    """One warm-up request, then ``prompts`` submitted at once; returns
    (results, wall seconds of the measured ones)."""
    engine.submit(prompts[0], max_new_tokens=4).result(timeout=600)
    start = time.perf_counter()
    futures = [engine.submit(p, max_new_tokens=TP_BUDGET) for p in prompts]
    results = [f.result(timeout=600) for f in futures]
    return results, time.perf_counter() - start


def _tp_counts_check(what, counts, layers_n, stats, quantized):
    """A rank's launches against rank 0's engine record (counted from the
    engine's construction)."""
    import collections

    _check_launches(what, counts, layers_n, collections.defaultdict(int),
                    stats, quantized=quantized)


def run_tp_engine(device, card):
    """3tp: the tensor-parallel engine at tp 2, rank 0 here and rank 1 in a
    spawned child, both on ``device`` over gloo (``mesh=`` a MeshSpec
    built over ``[device, device]``).  First, without the slice: the
    mesh path at tp 1 (``mesh=`` a one-rank mesh) serves 8 requests token
    for token as the plain engine in bf16, and ``mesh_shape=(2, 1)`` on
    the one card raises the JAX engine's device-count error.  Then four
    engines on both ranks, SMALL on bf16-valued weights: in bf16 (8
    requests at once after a warm-up one: tokens/s beside the
    single-process engine's, matches with it counted), and in f32 the
    same 8 (tie-free) requests plain and with ``kv_quant``, each request
    equal to the single-process engine's and ``generate``'s tokens, and
    the prefix cache with chunked prefill (a cold 40-token prompt in two
    chunks, then one sharing its first 32 tokens: one hit), equal to
    ``generate``.  Each rank's K5, K8 and K8q launches equal what rank 0's
    ``stats()`` implies."""
    import datetime
    import multiprocessing
    import queue as queue_lib

    import torch
    import torch.distributed as dist

    from cloud_tpu_torch.models import generation
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.parallel import MeshSpec
    from cloud_tpu_torch.serving import ServeConfig, ServingEngine

    cfg, params = _tp_model(device, TP_MODEL)
    cfg32 = _tp_config(cfg, "float32")
    prompts, pair = _tp_prompts(generation, params, cfg32, device)
    out = {}

    # Without the slice: the one-process engines, the tp-1 mesh path
    # against the plain engine, and the device-count error on one card.
    single = {}
    for what, dtype_name, fields in TP_ARMS[:3]:
        with ServingEngine(params, _tp_config(cfg, dtype_name),
                           ServeConfig(**TP_SERVE, **fields),
                           device=device) as engine:
            results, wall = _serve_tp_arm(engine, prompts)
        single[what] = results
        out[f"single {what} tokens_per_s"] = (
            sum(r.num_generated for r in results) / wall)
    one_rank = MeshSpec({"tp": 1}).build(devices=[device])
    with ServingEngine(params, cfg, ServeConfig(**TP_SERVE), mesh=one_rank,
                       device=device) as engine:
        results, _ = _serve_tp_arm(engine, prompts)
    for prompt, got, want in zip(prompts, results, single["bf16"]):
        if not np.array_equal(got.tokens, want.tokens):
            raise AssertionError(f"the tp-1 mesh engine != the plain engine "
                                 f"for a {len(prompt)}-token prompt")
    print(f"  mesh path at tp 1: {len(prompts)}/{len(prompts)} requests "
          f"token-identical to the plain engine (SMALL bf16)")
    try:
        ServingEngine(params, cfg, ServeConfig(**TP_SERVE, mesh_shape=(TP, 1)),
                      device=device, start=False)
    except ValueError as exc:
        if "device(s); only" not in str(exc):
            raise
        print(f"  ServeConfig(mesh_shape=(2, 1)) on one card: {exc}")
    else:
        raise AssertionError("mesh_shape=(2, 1) on one card did not raise")

    # The slice: rank 1 in a spawned child.
    store = dist.TCPStore("127.0.0.1", 0, TP, True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    ctx = multiprocessing.get_context("spawn")
    reports = ctx.Queue()
    child = ctx.Process(target=_tp_follower,
                        args=(store.port, str(device), TP_MODEL, reports),
                        daemon=True)
    child.start()
    launches = {}
    try:
        dist.init_process_group(
            "gloo", store=store, rank=0, world_size=TP,
            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
        mesh = MeshSpec({"tp": TP}).build(devices=[device] * TP,
                                          backend="gloo")
        for what, dtype_name, fields in TP_ARMS:
            quantized = bool(fields.get("kv_quant"))
            arm_cfg = _tp_config(cfg, dtype_name)
            dispatch.reset_launch_counts()
            with ServingEngine(params, arm_cfg,
                               ServeConfig(**TP_SERVE, **fields), mesh=mesh,
                               device=device) as engine:
                health = engine.health()
                if what == "f32 prefix":
                    served = pair
                    results = [engine.submit(p, max_new_tokens=TP_BUDGET
                                             ).result(timeout=600)
                               for p in pair]
                else:
                    served = prompts
                    results, wall = _serve_tp_arm(engine, prompts)
                    out[f"tp2 {what} tokens_per_s"] = (
                        sum(r.num_generated for r in results) / wall)
            stats = engine.stats()
            mine = dispatch.launch_counts(QUANT_SERVING_KERNELS)
            try:
                theirs = reports.get(timeout=TP_TIMEOUT_S)
            except queue_lib.Empty:
                raise AssertionError(f"rank 1 sent no launch counts for "
                                     f"{what} in {TP_TIMEOUT_S} s") from None
            if isinstance(theirs, str):
                raise AssertionError(f"rank 1 failed in {what}: {theirs}")
            for rank, counts in ((0, mine), (1, theirs)):
                _tp_counts_check(f"3tp {what} rank {rank}", counts,
                                 cfg.num_layers, stats, quantized)
            launches[what] = {n: mine[n] + theirs[n] for n in mine}
            if health["slice_shape"] != (TP, 1) or stats["slice_chips"] != TP:
                raise AssertionError(f"{what}: slice {health['slice_shape']}"
                                     f" / {stats['slice_chips']} chips")
            for res in results:
                if (res.tokens.min() < 0
                        or res.tokens.max() >= cfg.vocab_size):
                    raise AssertionError("token id outside the vocabulary")
            if what == "bf16":
                same = sum(np.array_equal(r.tokens, w.tokens) for r, w in
                           zip(results, single["bf16"]))
                out["bf16 matches"] = int(same)
                print(f"  tp 2 bf16: {same}/{len(prompts)} requests "
                      f"token-identical to the single-process engine "
                      f"(counted, not held: bf16 rounding); launches per "
                      f"rank {mine} (rank 1 {theirs}) as rank 0's stats "
                      f"imply")
                continue
            if what == "f32 prefix" and (stats["prefix_hits"] != 1
                                         or stats["prefill_chunks"] != 3):
                raise AssertionError(
                    f"prefix arm: {stats['prefix_hits']} hits, "
                    f"{stats['prefill_chunks']} prefill chunks (1 and 3 "
                    f"expected)")
            for i, (prompt, res) in enumerate(zip(served, results)):
                want = generation.generate(
                    params, torch.from_numpy(prompt)[None], [len(prompt)],
                    arm_cfg, max_new_tokens=TP_BUDGET, kv_quant=quantized,
                    device=device)["tokens"][0].cpu().numpy()
                if not np.array_equal(res.tokens, want):
                    raise AssertionError(
                        f"3tp {what}: the tp-2 engine != generate() for a "
                        f"{len(prompt)}-token prompt")
                if what in single and not np.array_equal(
                        res.tokens, single[what][i].tokens):
                    raise AssertionError(
                        f"3tp {what}: the tp-2 engine != the single-process "
                        f"engine for a {len(prompt)}-token prompt")
            print(f"  tp 2 {what}: {len(served)}/{len(served)} requests "
                  f"token-identical to generate()"
                  + (" and the single-process engine" if what in single
                     else f" ({stats['prefix_hits']} prefix hit, "
                          f"{stats['prefill_chunks']} prefill chunks)")
                  + f"; launches per rank {mine} (rank 1 {theirs}) as rank "
                  f"0's stats imply; slice {health['slice_shape']}")
        child.join(TP_TIMEOUT_S)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if child.is_alive():
            child.kill()
            child.join(10)
    if child.exitcode != 0:
        raise AssertionError(f"rank 1 exited with code {child.exitcode}")
    for what in ("bf16", "f32"):
        print(f"  {what}: tp 2 (two ranks on one card, gloo) "
              f"{out[f'tp2 {what} tokens_per_s']:.1f} tok/s against one "
              f"process {out[f'single {what} tokens_per_s']:.1f} tok/s "
              f"({TP_REQUESTS} requests x {TP_BUDGET} tokens) [{card}]")
    out["launches_by_arm"] = launches
    out["launches"] = {n: sum(arm[n] for arm in launches.values())
                       for n in QUANT_SERVING_KERNELS}
    return out


# ---------------------------------------------------------------------------
# Phases 2 (ring) and 6mesh: training under a mesh
# ---------------------------------------------------------------------------

#: Phase 2 (ring): B=2, T=1024 at SMALL's 12 heads and a tp-2 rank's 6,
#: head dim 64.  The contiguous causal cases pad sample 0's first
#: RING_PAD keys: at n=4 (256-token blocks) block 0 has no valid key for
#: any of its rows, and block 1's first 44 rows have none either.
RING_B, RING_T, RING_PAD = 2, 1024, 300
#: (name, n, causal, zigzag, masked)
RING_CASES = (("causal", 2, True, False, True),
              ("causal", 4, True, False, True),
              ("non-causal", 2, False, False, False),
              ("zigzag", 2, True, True, False),
              ("zigzag", 4, True, True, False))
#: The ring's per-block shapes timed: (B, T, causal) of one call.  T=512
#: is a block at sp 2 (past blocks non-causal, the diagonal causal); 256
#: and 128 the zig-zag chunk c = T/(2 sp) at sp 2 and 4.
RING_TIMED = ((2, 512, False), (2, 512, True), (2, 256, False),
              (2, 128, False))


def ring_launches(n: int, rank: int, *, causal: bool, zigzag: bool) -> int:
    """K5 launches of one ring forward on ``rank`` (and K6's, and K7's, in
    its backward): every block of the causal contiguous ring up to the
    diagonal, every block without causality, 2n+1 on the zig-zag
    (three calls on the diagonal hop, two on every other)."""
    if zigzag:
        return 2 * n + 1
    return rank + 1 if causal else n


def _ring_case(fa, ring, dispatch, gen, dtype, h, case):
    """One case of phase 2 (ring): every rank's hops driven in this
    process through ``fold_hop`` and ``hop_grads``, the blocks assembled
    and held against one whole-sequence K5 + K6/K7 call and against the
    plain version; each rank's launches counted.  Returns the worst
    errors by kernel."""
    import torch

    name, n, causal, zigzag, masked = case
    dname = str(dtype).split(".")[1]
    q, k, v, do = (torch.randn((RING_B, RING_T, h, HEAD_DIM), generator=gen,
                               device=gen.device).to(dtype)
                   for _ in range(4))
    mask = None
    valid = torch.ones((RING_B, RING_T), dtype=torch.bool, device=q.device)
    if masked:
        mask = torch.ones((RING_B, RING_T), dtype=torch.int32,
                          device=q.device)
        mask[0, :RING_PAD] = 0
        if causal:  # rows with no valid key: the loss drops them (C1)
            valid[0, :RING_PAD] = False
    do = do * valid[..., None, None].to(dtype)
    out_k, lse_k = fa._flash_kernel(q, k, v, causal=causal, mask=mask)
    grads_k = fa._bwd_kernels(q, k, v, mask, do, out_k, lse_k, causal=causal)
    out_p, lse_p = fa._reference_with_lse(q, k, v, causal=causal, mask=mask)
    grads_p = fa._bwd_reference(q, k, v, mask, do, out_p, lse_p,
                                causal=causal)
    perm = (ring.zigzag_indices(RING_T, n, device=q.device) if zigzag
            else torch.arange(RING_T, device=q.device))
    qz, kz, vz, doz = (x[:, perm] for x in (q, k, v, do))
    mz = None if mask is None else mask[:, perm]
    tl = RING_T // n

    def blk(x, r):
        return None if x is None else x[:, r * tl:(r + 1) * tl]

    outs, dqs = [], []
    dk = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for r in range(n):
        dispatch.reset_launch_counts()
        parts = ring.new_partials(blk(qz, r), zigzag=zigzag)
        for i in range(n):
            src = (r - i) % n
            parts = ring.fold_hop(parts, blk(qz, r), blk(kz, src),
                                  blk(vz, src), blk(mz, src), src, r,
                                  causal=causal, zigzag=zigzag)
        out, lse = ring.merged(parts)
        dq = torch.zeros(blk(q, r).shape, dtype=torch.float32,
                         device=q.device)
        for i in range(n):
            src = (r - i) % n
            gk, gv = ring.hop_grads(dq, blk(qz, r), blk(kz, src),
                                    blk(vz, src), blk(mz, src), blk(doz, r),
                                    out, lse, src, r, causal=causal,
                                    zigzag=zigzag)
            dk[:, src * tl:(src + 1) * tl] += gk
            dv[:, src * tl:(src + 1) * tl] += gv
        counts = dispatch.launch_counts(TRAIN_ATTN_KERNELS)
        want = ring_launches(n, r, causal=causal, zigzag=zigzag)
        if any(c != want for c in counts.values()):
            raise AssertionError(
                f"ring {name} n={n} rank {r}: launches {counts}, want "
                f"{want} of each of K5, K6 and K7")
        outs.append(out.to(dtype))
        dqs.append(dq)
    inv = torch.argsort(perm)
    got = (torch.cat(outs, 1)[:, inv], torch.cat(dqs, 1)[:, inv].to(dtype),
           dk[:, inv].to(dtype), dv[:, inv].to(dtype))
    rows = valid[..., None, None]
    worst = {kname: 0.0 for kname in TRAIN_ATTN_KERNELS}
    what = f"ring {name} n={n} H={h} {dname}"
    for ref_name, ref_out, ref_grads in (("K5/K6/K7", out_k, grads_k),
                                         ("plain", out_p, grads_p)):
        worst["flash_fwd"] = max(worst["flash_fwd"], check_close(
            f"{what} out against {ref_name}", got[0] * rows,
            ref_out * rows, dname))
        for i, gname in enumerate(("dq", "dk", "dv")):
            kname = "flash_bwd_dq" if gname == "dq" else "flash_bwd_dkv"
            worst[kname] = max(worst[kname], check_close(
                f"{what} {gname} against {ref_name}", got[1 + i],
                ref_grads[i], dname, scaled=True))
    if masked and causal and bool((got[1][~valid] != 0).any()):
        raise AssertionError(f"{what}: dq not 0 on rows with no valid key")
    return worst


def check_ring(device, card):
    """Phase 2 (ring): the ring's per-block K5 folds and K6/K7 hops
    (``parallel/ring_attention.py``'s ``fold_hop`` and ``hop_grads``)
    for every rank of the contiguous causal ring at n=2 and 4 with a
    left padding that empties whole blocks' rows, the non-causal ring at
    n=2 and the zig-zag ring at n=2 and 4, in bf16 and f32 at 12 and 6
    heads: the assembled out, dq, dk and dv against one whole-sequence K5
    + K6/K7 call and against the plain version (``check_close``; the
    gradients' limits scaled), with each rank's exact launches.  Then K5,
    K6 and K7 timed at the ring's block shapes beside the plain version,
    SDPA and their bounds."""
    import torch

    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.ops import flash_attention as fa
    from cloud_tpu_torch.parallel import ring_attention as ring

    gen = torch.Generator(device=device).manual_seed(17)
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for h in (HEADS, HEADS // 2):
            for case in RING_CASES:
                for kname, e in _ring_case(fa, ring, dispatch, gen, dtype, h,
                                           case).items():
                    key = f"{kname} {dname}"
                    worst[key] = max(worst.get(key, 0.0), e)
        print(f"  {dname}: {2 * len(RING_CASES)} ring cases (n=2/4, causal "
              f"masked, non-causal, zig-zag; 12 and 6 heads) ok, launches "
              f"exact; max_abs_err out {worst['flash_fwd ' + dname]:.3e}, dq "
              f"{worst['flash_bwd_dq ' + dname]:.3e}, dk/dv "
              f"{worst['flash_bwd_dkv ' + dname]:.3e} [{card}]")
    dispatch.reset_launch_counts()
    rows = {}
    for b, t, causal in RING_TIMED:
        label = f"B={b} T={t} {'causal' if causal else 'non-causal'}"
        rows[label] = _time_attention(fa, "ring block", card, gen,
                                      shape=(b, t, causal),
                                      plain_device=False)
    return {"max_abs_err": worst, "rows": rows}


#: Phase 6mesh: CloudLM SMALL (12 layers, dim 768, 12 heads, tied head)
#: trained under a 2-rank mesh, both ranks on the one card over gloo:
#: b2 x T1024, adamw(1e-4) with f32 moments, remat "full".  Arms, in the
#: order both ranks run them: (name, mesh sizes, config fields, dtype).
MESH_ARMS = (("sp zigzag", {"sp": 2}, {"zigzag_sp": True}, "float32"),
             ("sp ulysses", {"sp": 2}, {"ulysses_sp": True}, "float32"),
             ("tp", {"tp": 2}, {}, "float32"),
             # The fused cross-entropy over the vocabulary split by tp.
             ("tp fused_ce", {"tp": 2}, {"fused_ce": True}, "float32"),
             ("fsdp", {"fsdp": 2}, {}, "float32"),
             ("bf16 sp zigzag", {"sp": 2}, {"zigzag_sp": True},
              "bfloat16"))
MESH_BATCH, MESH_SEQ, MESH_STEPS = 2, 1024, 2
#: The bf16 arm's steps: one warm-up, then the timed ones.
MESH_BF16_STEPS = 4
#: How long rank 0 waits for its follower to start, join and report.
MESH_TIMEOUT_S = 300
#: Model of phases 6mesh and 6pp (SMALL, or a narrower config in a CPU
#: rehearsal).
MESH_MODEL = None

#: Phase 6pp: SMALL at full width and depth (12 layers; the pp arms'
#: stages hold 6 each) under the pipeline and expert parallelism, two
#: ranks on the card over gloo, as 6mesh: b4 x T1024 with M = 2
#: microbatches under pp (rules ``layers`` -> ``pp``), b2 under ep, the
#: default ``MoeConfig()`` (8 experts, top 2; ``"moe"`` holds its
#: keywords).  Arms: (name, mesh sizes, config fields, dtype, batch
#: rows).
PP_ARMS = (("pp", {"pp": 2}, {"tied_embeddings": False}, "float32", 4),
           ("pp tied", {"pp": 2}, {"tied_embeddings": True}, "float32", 4),
           ("ep moe", {"ep": 2}, {"tied_embeddings": False, "moe": {}},
            "float32", 2),
           ("pp moe", {"pp": 2}, {"tied_embeddings": False, "moe": {}},
            "float32", 4),
           ("bf16 pp", {"pp": 2}, {"tied_embeddings": False}, "bfloat16", 4))
#: The MoE arms' aux limit against one process (absolute).
PP_AUX_TOL = 1e-5


def _arm_parts(arm):
    """(name, sizes, fields, dtype name, batch rows, pipelined) of a 6mesh
    (batch MESH_BATCH) or 6pp arm; ``fields["moe"]`` holds
    ``MoeConfig``'s keywords."""
    name, sizes, fields, dtype_name, *rest = arm
    if "moe" in fields:
        from cloud_tpu_torch.models.moe import MoeConfig

        fields = dict(fields, moe=MoeConfig(**fields["moe"]))
    return (name, sizes, fields, dtype_name, rest[0] if rest else MESH_BATCH,
            sizes.get("pp", 1) > 1)


def _arm_rules(pipelined: bool):
    from cloud_tpu_torch.parallel import sharding

    return (sharding.DEFAULT_RULES.extended(layers="pp") if pipelined
            else sharding.DEFAULT_RULES)


def _ref_key(arm):
    """Arms whose one-process steps are the same share a reference: the
    sequence-parallel layouts change no number."""
    _, _, fields, dtype_name, batch, _ = _arm_parts(arm)
    return (dtype_name, batch, tuple(sorted(
        (k, repr(v)) for k, v in fields.items()
        if k not in ("zigzag_sp", "ulysses_sp"))))


def mesh_launches_per_layer(sizes, fields, pipelined=False):
    """K5, K6 and K7 launches of one rank a layer it holds a step under
    remat "full" (K5 runs again in the recompute): the zig-zag ring's
    2n+1 calls each way, else one (Ulysses, tp, fsdp, ep), each once a
    microbatch under a pipeline (``num_microbatches``, default the pp
    size).  A pipeline stage holds ``num_layers / pp`` layers
    (:func:`mesh_layers_held`)."""
    n = sizes.get("sp", 1)
    calls = 2 * n + 1 if fields.get("zigzag_sp") and n > 1 else 1
    if pipelined:
        calls *= fields.get("num_microbatches") or sizes["pp"]
    return {"flash_fwd": 2 * calls, "flash_bwd_dq": calls,
            "flash_bwd_dkv": calls}


def mesh_layers_held(num_layers, sizes, pipelined=False):
    """The layers one rank runs: its stage's block under a pipeline, else
    every layer (an ep rank runs every layer on its rows)."""
    return num_layers // sizes["pp"] if pipelined else num_layers


def _mesh_setup(device, dtype_name, fields, batch=MESH_BATCH):
    """The arm's config, f32 master weights from seed 0 (the same in every
    rank's process) and the batch's tokens (numpy seed 0, in [1, V))."""
    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import transformer

    cfg = (MESH_MODEL or transformer.SMALL).scaled(**{
        "tied_embeddings": True, "remat": True, "remat_policy": "full",
        "dtype": getattr(torch, dtype_name), **fields})
    gen = torch.Generator(device=device).manual_seed(0)
    params = bridge.init(cfg, gen, device=device)
    tokens = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (batch, MESH_SEQ)).astype(np.int64)
    return cfg, params, torch.from_numpy(tokens).to(device)


def _ce_only(loss):
    """``loss`` with the MoE aux taken out of what it differentiates (the
    metrics are the loss's own)."""
    from cloud_tpu_torch.training import train

    def wrapped(params, batch):
        value, metrics = loss(params, batch)
        return value - metrics["aux"], metrics

    return train.mesh_loss(wrapped)


def _mesh_reference(device, dtype_name, fields, steps, batch=MESH_BATCH):
    """One process, no mesh: the arm's steps on the whole batch.  Returns
    (per-step metrics, steps/s over the steps after the first, step 1's
    gradient leaves (f32 arms), the final params' leaves, the norm of
    step 1's CE-only gradient (f32 MoE arms))."""
    import functools

    import torch

    from cloud_tpu_torch.bridge import leaves
    from cloud_tpu_torch.models import transformer
    from cloud_tpu_torch.training import optimizers, train

    cfg, params, tokens = _mesh_setup(device, dtype_name, fields, batch)
    tx = optimizers.adamw(1e-4, mu_dtype=None)
    state = train.create_sharded_state(None, lambda _: params, tx,
                                       device=device)
    loss = functools.partial(transformer.loss_fn, config=cfg, device=device)
    grads, ce_norm = None, None
    if dtype_name == "float32":
        _, grads = train._grads(loss, state.params, {"tokens": tokens})
        if cfg.moe is not None:
            _, ce_grads = train._grads(_ce_only(loss), state.params,
                                       {"tokens": tokens})
            ce_norm = float(train.global_norm(ce_grads))
            del ce_grads
    step = train.make_train_step(loss, tx)
    metrics, start = [], None
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            start = time.perf_counter()
        state, m = step(state, {"tokens": tokens})
        metrics.append({key: float(v) for key, v in m.items()})
    torch.cuda.synchronize()
    rate = (steps - 1) / (time.perf_counter() - start)
    return (metrics, rate, grads, [p.detach() for p in leaves(state.params)],
            ce_norm)


def _mesh_arm(rank, device, arm, ref=None, phase="6mesh"):
    """One arm of phase 6mesh or 6pp on this rank: the mesh built over the
    default group, the state cut from the full weights, step 1's gradient
    computed through the step's own gather and sync and gathered whole,
    then the steps (launches counted from 0 before them), and the final
    params gathered whole.  The rank's rows are its data slice, or under
    a pipeline its share of every global microbatch.  Every rank runs the
    same collectives; rank 0 holds the results to ``ref``
    (:func:`_mesh_reference`).  An f32 MoE arm under a pipeline holds
    step 1's CE and its gradient's norm (its aux is the microbatches'
    mean, by design); other f32 MoE arms hold the aux too.  Returns the
    rank's report."""
    import functools

    import torch

    from cloud_tpu_torch.bridge import leaves, map_leaves
    from cloud_tpu_torch.models import transformer
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.parallel import MeshSpec, pipeline, sharding
    from cloud_tpu_torch.training import optimizers, train

    name, sizes, fields, dtype_name, batch_n, pipelined = _arm_parts(arm)
    rules = _arm_rules(pipelined)
    mesh = MeshSpec(sizes).build(devices=[device] * 2, backend="gloo")
    cfg, params, tokens = _mesh_setup(device, dtype_name, fields, batch_n)
    axes = transformer.param_logical_axes(cfg)
    tx = optimizers.adamw(1e-4, mu_dtype=None)
    state = train.create_sharded_state(
        None, lambda _: map_leaves(params, torch.clone), tx, mesh=mesh,
        logical_axes=axes, rules=rules)
    del params
    loss = functools.partial(transformer.loss_fn, config=cfg, mesh=mesh,
                             rules=rules)
    rows = pipeline.microbatch_rows(
        mesh, batch_n,
        transformer.num_microbatches(cfg, mesh) if pipelined else 1)
    batch = train.shard_batch(
        {"tokens": tokens[torch.as_tensor(rows, device=tokens.device)]},
        mesh)
    report = {"arm": name}
    f32 = dtype_name == "float32"
    moe_pp = cfg.moe is not None and pipelined
    if f32:
        layout = train._MeshLayout(mesh, rules, axes, state.params)
        _, grads = train._grads(_ce_only(loss) if moe_pp else loss,
                                layout.gather(state.params), batch)
        whole = sharding.gather_tree(
            train._with_leaves(state.params, iter(layout.sync(grads))),
            axes, mesh, rules)
        if ref is not None and moe_pp:
            got = float(train.global_norm(leaves(whole)))
            report["ce_grad_norm"] = [got, ref[4]]
            if abs(got - ref[4]) > TOL_F32 * ref[4]:
                raise AssertionError(
                    f"{phase} {name}: step 1's CE gradient norm {got!r} "
                    f"against one process's {ref[4]!r}")
        elif ref is not None:
            want = ref[2]
            scale = max(float(g.abs().max()) for g in want)
            err = max(float((a - b).abs().max())
                      for a, b in zip(leaves(whole), want))
            report["grad_err_rel"] = err / scale
            if err > TOL_F32 * scale:
                raise AssertionError(
                    f"{phase} {name}: step 1's gradient differs from one "
                    f"process's by {err:.3e} (> 1e-4 of {scale:.3e})")
        del whole, grads
    step = train.make_train_step(loss, tx, mesh=mesh, logical_axes=axes,
                                 rules=rules)
    steps = MESH_STEPS if f32 else MESH_BF16_STEPS
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    metrics, start = [], None
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            start = time.perf_counter()
        state, m = step(state, batch)
        metrics.append({key: float(v) for key, v in m.items()})
    torch.cuda.synchronize()
    report["steps_per_s"] = (steps - 1) / (time.perf_counter() - start)
    report["launches"] = dispatch.launch_counts(TRAIN_ATTN_KERNELS)
    report["metrics"] = metrics
    per_layer = mesh_launches_per_layer(sizes, fields, pipelined)
    held = mesh_layers_held(cfg.num_layers, sizes, pipelined)
    want = {k: v * held * steps for k, v in per_layer.items()}
    if report["launches"] != want:
        raise AssertionError(f"{phase} {name} rank {rank}: launches "
                             f"{report['launches']}, want {want}")
    final = sharding.gather_tree(state.params, axes, mesh, rules)
    if ref is not None:
        ref_metrics = ref[0]
        if f32 and moe_pp:
            checks = (("step 1 ce", metrics[0]["ce"], ref_metrics[0]["ce"]),)
            rel = TOL_F32
        elif f32:
            checks = (("step 1 loss", metrics[0]["loss"],
                       ref_metrics[0]["loss"]),
                      ("step 1 grad_norm", metrics[0]["grad_norm"],
                       ref_metrics[0]["grad_norm"]),
                      ("step 2 loss", metrics[1]["loss"],
                       ref_metrics[1]["loss"]))
            rel = TOL_F32
        else:
            checks = tuple((f"step {i + 1} loss", m["loss"], r["loss"])
                           for i, (m, r) in enumerate(zip(metrics,
                                                          ref_metrics)))
            rel = 2e-2
        for what, got, want_v in checks:
            if not np.isfinite(got) or abs(got - want_v) > rel * abs(want_v):
                raise AssertionError(
                    f"{phase} {name}: {what} {got!r} against one process's "
                    f"{want_v!r} (limit {rel} relative)")
        if cfg.moe is not None:
            report["aux"] = [metrics[0]["aux"], ref_metrics[0]["aux"]]
            if not moe_pp and abs(metrics[0]["aux"] - ref_metrics[0]["aux"]
                                  ) > PP_AUX_TOL:
                raise AssertionError(
                    f"{phase} {name}: aux {metrics[0]['aux']!r} against one "
                    f"process's {ref_metrics[0]['aux']!r}")
        report["param_diff"] = max(float((a.detach() - b).abs().max())
                                   for a, b in zip(leaves(final), ref[3]))
        report["one_process_steps_per_s"] = ref[1]
    del state, final
    torch.cuda.empty_cache()
    return report


def _mesh_follower(port, device_name, model, queue, setup=None,
                   arms=MESH_ARMS, phase="6mesh", arm_fn=None, arm_kw=None):
    """Rank 1 of phase 6mesh, 6pp or 6enc, in a spawned child: every arm
    in order, as rank 0 runs them (``arm_fn``, :func:`_mesh_arm` by
    default, with ``arm_kw``); after each, its report on ``queue`` (an
    error's repr if it fails).  ``setup``, a module-level function, runs
    first (a CPU rehearsal patches the kernels with it)."""
    import datetime

    import torch
    import torch.distributed as dist

    global MESH_MODEL
    MESH_MODEL = model
    if setup is not None:
        setup()
    device = torch.device(device_name)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    store = dist.TCPStore("127.0.0.1", port, 2, False,
                          timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    dist.init_process_group("gloo", store=store, rank=1, world_size=2,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        for arm in arms:
            queue.put((arm_fn or _mesh_arm)(1, device, arm, phase=phase,
                                            **(arm_kw or {})))
    except BaseException as exc:  # noqa: BLE001 — reported to rank 0
        queue.put(repr(exc))
        raise
    finally:
        dist.destroy_process_group()


def _run_mesh_arms(device, card, phase, arms, setup=None):
    """6mesh's and 6pp's arms (:func:`_mesh_arm`) on two ranks
    (:func:`_two_rank_arms`), each held to one process's steps
    (:func:`_mesh_reference`, one a :func:`_ref_key`), which run first."""
    import torch

    refs, by_key = {}, {}
    for arm in arms:
        key = _ref_key(arm)
        if key not in by_key:
            _, _, fields, dtype_name, batch_n, _ = _arm_parts(arm)
            by_key[key] = _mesh_reference(
                device, dtype_name, fields,
                MESH_STEPS if dtype_name == "float32" else MESH_BF16_STEPS,
                batch_n)
            torch.cuda.empty_cache()
        refs[arm[0]] = by_key[key]

    def describe(arm, mine, theirs, ref):
        m0, r0 = mine["metrics"], ref[0]
        extra = (f"gradient within {mine['grad_err_rel']:.2e} of its "
                 f"largest magnitude, " if "grad_err_rel" in mine else "")
        if "ce_grad_norm" in mine:
            extra += ("CE {:.6f} ({:.6f}), CE gradient norm {:.6f} "
                      "({:.6f}), ").format(m0[0]["ce"], r0[0]["ce"],
                                           *mine["ce_grad_norm"])
        if "aux" in mine:
            extra += "aux {:.6e} ({:.6e}), ".format(*mine["aux"])
        print(f"  {arm[0]} {arm[3]}: loss {m0[0]['loss']:.6f} / "
              f"{m0[1]['loss']:.6f} against one process's "
              f"{r0[0]['loss']:.6f} / {r0[1]['loss']:.6f}, grad_norm "
              f"{m0[0]['grad_norm']:.6f} ({r0[0]['grad_norm']:.6f}), "
              f"{extra}largest param difference "
              f"{mine['param_diff']:.3e}; {mine['steps_per_s']:.3f} "
              f"steps/s on 2 ranks against "
              f"{mine['one_process_steps_per_s']:.3f} in one process; "
              f"launches rank 0 {mine['launches']}, rank 1 "
              f"{theirs['launches']} [{card}]")

    return _two_rank_arms(device, phase, arms, refs, _mesh_arm, describe,
                          setup=setup, model=MESH_MODEL)


def _two_rank_arms(device, phase, arms, refs, arm_fn, describe, *,
                   setup=None, model=None, arm_kw=None):
    """Rank 0 here and rank 1 in a spawned child (:func:`_mesh_follower`),
    both on ``device`` over gloo, run ``arms`` in order:
    ``arm_fn(rank, device, arm, ref, phase=, **arm_kw)``, rank 0 given
    ``refs[arm[0]]`` to hold its results to; ``describe(arm, rank 0's
    report, rank 1's, ref)`` prints each.  Returns {"arms": {name:
    {"rank0", "rank1"}}, "launches": every kernel's launches summed over
    both ranks and every arm}."""
    import datetime
    import multiprocessing
    import queue as queue_lib

    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, 2, True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    ctx = multiprocessing.get_context("spawn")
    reports = ctx.Queue()
    child = ctx.Process(target=_mesh_follower,
                        args=(store.port, str(device), model, reports,
                              setup, arms, phase, arm_fn, arm_kw),
                        daemon=True)
    child.start()
    out = {"arms": {}}
    try:
        dist.init_process_group(
            "gloo", store=store, rank=0, world_size=2,
            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        for arm in arms:
            ref = refs[arm[0]]
            mine = arm_fn(0, device, arm, ref, phase=phase, **(arm_kw or {}))
            try:
                theirs = reports.get(timeout=MESH_TIMEOUT_S)
            except queue_lib.Empty:
                raise AssertionError(f"{phase} {arm[0]}: rank 1 did not "
                                     f"report within {MESH_TIMEOUT_S} s"
                                     ) from None
            if isinstance(theirs, str):
                raise AssertionError(f"{phase} {arm[0]}: rank 1 failed: "
                                     f"{theirs}")
            describe(arm, mine, theirs, ref)
            out["arms"][arm[0]] = {"rank0": mine, "rank1": theirs}
        child.join(timeout=MESH_TIMEOUT_S)
        if child.exitcode != 0:
            raise AssertionError(f"{phase}: rank 1 exited {child.exitcode}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if child.is_alive():
            child.kill()
            child.join()
    names = sorted({k for a in out["arms"].values()
                    for k in a["rank0"]["launches"]})
    out["launches"] = {
        k: sum(a["rank0"]["launches"].get(k, 0)
               + a["rank1"]["launches"].get(k, 0)
               for a in out["arms"].values()) for k in names}
    return out


def run_mesh_training(device, card, setup=None):
    """6mesh: CloudLM SMALL at full width and depth trained under a 2-rank
    mesh, rank 0 here and rank 1 in a spawned child, both on ``device``
    over gloo: ``{sp: 2}`` zig-zag, ``{sp: 2}`` Ulysses, ``{tp: 2}`` (with
    the plain CE, and with the fused CE over the tp-split vocabulary) and
    ``{fsdp: 2}`` in f32 (TF32 off), each held to one process running the
    same steps on the same weights and batch (step 1's loss and
    ``grad_norm`` and step 2's loss within 1e-4 relative; step 1's
    gradient, gathered whole, within 1e-4 of its largest magnitude; the
    largest param difference printed, not held: AdamW's first update is
    about +-lr wherever a gradient is tiny), then the zig-zag arm in bf16
    on f32 masters (finite, every step's loss within 2e-2 relative of one
    process's; steps/s beside one process's, not held).  Each rank's K5,
    K6 and K7 launches equal :func:`mesh_launches_per_layer` x 12 layers
    x steps.  Two ranks over gloo on one card measure the lockstep's
    overhead, not NCCL between cards."""
    return _run_mesh_arms(device, card, "6mesh", MESH_ARMS, setup)


#: The batch of 6pp's one K5-K7 call shape ([2, MESH_SEQ, 12, 64],
#: causal): a pipeline microbatch (b4 / M = 2) and an ep rank's rows
#: (b2), every head.
PP_KERNEL_BATCH = 2


def check_pp_kernels(device, card):
    """K5, K6 and K7 at 6pp's call shape, bf16 and f32 causal, against
    their plain versions (:func:`_bwd_case`); then timed in bf16 beside
    the plain version, SDPA and the bound (:func:`_time_attention`).
    Returns {"max_abs_err": {"<kernel> <dtype>": err}, "rows": {...}}."""
    import torch

    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(19)
    b, t, causal = PP_KERNEL_BATCH, MESH_SEQ, True
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        errs = _bwd_case(fa, b, t, causal, dtype, gen, mask_kind=None,
                         glse=False)
        for kname in TRAIN_ATTN_KERNELS:
            worst[f"{kname} {dname}"] = errs[kname]
        print(f"  K5/K6/K7 at B={b} T={t} H={HEADS} {dname} causal: "
              f"max_abs_err out {errs['flash_fwd']:.3e}, dq "
              f"{errs['flash_bwd_dq']:.3e}, dk/dv "
              f"{errs['flash_bwd_dkv']:.3e} [{card}]")
    rows = _time_attention(fa, "pp microbatch", card, gen,
                           shape=(b, t, causal), plain_device=False)
    dispatch.reset_launch_counts()
    return {"max_abs_err": worst, "rows": rows}


def run_pipeline_training(device, card, setup=None):
    """6pp: CloudLM SMALL at full width and depth under the GPipe pipeline
    and expert parallelism, two ranks on ``device`` over gloo as 6mesh
    (:data:`PP_ARMS`), in f32 (TF32 off) against one process on the same
    weights and batch: ``{pp: 2}`` (b4, M = 2) with an untied and a tied
    head (6mesh's limits: a tied table's gradient summed over pp would
    count its head part twice); the default MoE under ``{ep: 2}`` (b2;
    the same limits, aux within 1e-5); the MoE under ``{pp: 2}`` (step
    1's CE and its gradient's norm within 1e-4 relative; aux printed
    beside one process's whole-batch aux, not held: it is the
    microbatches' mean by design); then ``{pp: 2}`` in bf16 on f32
    masters (every step's loss within 2e-2 relative; steps/s printed
    beside one process's).  Each rank's K5/K6/K7 launches equal
    :func:`mesh_launches_per_layer` x :func:`mesh_layers_held` x steps:
    a stage runs its 6 layers once a microbatch, an ep rank all 12
    (phase 2 (pp), :func:`check_pp_kernels`, holds K5-K7 at the arms'
    call shape)."""
    return _run_mesh_arms(device, card, "6pp", PP_ARMS, setup)


# Phases 9r, 9p, 9m: the front door (run, the container bootstrap), the
# profiler and the exporter.

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
#: The container workload of 9r: ResNet-50 CIFAR through Trainer.fit.
FRONT_DOOR_ENTRY = os.path.join(REPO_ROOT, "tests", "helpers",
                                "torch_resnet_cifar_fit.py")
FRONT_DOOR_TIMEOUT_S = 300
#: 9p: the traced window of the ResNet fit and the on-demand capture.
PROFILE_FIT = {"batches": 6, "start_step": 3, "num_steps": 2,
               "capture_ms": 400}
#: 9m: the MNIST workload the bootstrap runs with monitoring on.
MONITORED_ENTRY = os.path.join(REPO_ROOT, "tests", "helpers",
                               "torch_mnist_example.py")


def _front_door_workload():
    """The module of :data:`FRONT_DOOR_ENTRY` (its STEPS and BATCH)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_resnet_cifar_fit",
                                                  FRONT_DOOR_ENTRY)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_front_door(device, card):
    """9r: submit to first step through deploy's real startup script."""
    import shutil
    import tempfile

    import torch

    import cloud_tpu_torch
    from cloud_tpu_torch.core import containerize
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.utils import local_rig

    del device  # the container's bootstrap takes the card by default
    workload = _front_door_workload()
    root = tempfile.mkdtemp(prefix="chip_smoke_front_door_")
    saved = os.environ.get("CLOUD_TPU_COMPILE_CACHE")
    try:
        # deploy forwards the submitting process's cache directory.
        os.environ["CLOUD_TPU_COMPILE_CACHE"] = dispatch.build_dir()
        start = time.perf_counter()
        report = cloud_tpu_torch.run(
            entry_point=FRONT_DOOR_ENTRY,
            chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS["TPU_V5E_1"],
            docker_config=containerize.DockerConfig(
                image="gcr.io/chip-smoke/resnet50-cifar-fit:0"),
            entry_point_args=[],
            dry_run=True)
        submit_s = time.perf_counter() - start
        context = containerize.build_context(
            report.dockerfile, FRONT_DOOR_ENTRY, None,
            dst_dir=os.path.join(root, "context"))
        (node,) = report.node_requests.values()
        script = node["metadata"]["startup-script"]
        if f"CLOUD_TPU_COMPILE_CACHE={dispatch.build_dir()}" not in script:
            raise AssertionError("the startup script does not forward "
                                 "CLOUD_TPU_COMPILE_CACHE")
        start = time.perf_counter()
        (proc,) = local_rig.launch_emulated_slice(
            1, device="cuda", startup_script=script,
            entrypoint=containerize.entrypoint_argv(report.dockerfile),
            context_dir=context, timeout=FRONT_DOOR_TIMEOUT_S)
        wall = time.perf_counter() - start
    finally:
        if saved is None:
            os.environ.pop("CLOUD_TPU_COMPILE_CACHE", None)
        else:
            os.environ["CLOUD_TPU_COMPILE_CACHE"] = saved
        shutil.rmtree(root, ignore_errors=True)
    if proc.returncode != 0:
        raise AssertionError(
            f"the container exited {proc.returncode}:\n{proc.stdout[-3000:]}"
            f"\n{proc.stderr[-5000:]}")
    out = json.loads([line for line in proc.stdout.splitlines()
                      if line.startswith("{")][-1])
    steps = workload.STEPS
    want = _gn_times(GN_PER_STEP, steps)
    gauge = out["submit_to_first_step_seconds"]
    if out["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"the container ran on {out['device']}")
    if out["steps"] != steps or out["launches"] != want:
        raise AssertionError(f"{out['steps']} steps, launches "
                             f"{out['launches']} != {want}")
    if len(out["losses"]) != steps or not all(
            np.isfinite(v) for v in out["losses"]):
        raise AssertionError(f"losses {out['losses']}")
    if not (np.isfinite(out["param_change"]) and out["param_change"] > 0):
        raise AssertionError(f"the fit did not move the parameters: "
                             f"relative change {out['param_change']}")
    if gauge is None or not gauge > 0:
        raise AssertionError(f"run/submit_to_first_step_seconds {gauge}")
    out.update(container_wall_s=wall, run_dry_s=submit_s)
    print(f"  run/submit_to_first_step_seconds {gauge:.3f} (run() to the "
          f"container's first step, the startup script, the bootstrap's "
          f"cache probe, the native metrics library's build and the "
          f"Trainer's set-up included); fit {out['steps_per_s']:.3f} "
          f"steps/s over {steps} steps of {workload.BATCH} (the first "
          f"included); losses {[round(v, 4) for v in out['losses']]}; "
          f"parameters moved {out['param_change']:.3e} of their norm; "
          f"launches {out['launches']}; container wall {wall:.1f} s "
          f"[{card}]")
    return out


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _gn_trace_names(events):
    """The K1-K4 kernels a trace's kernel rows hold, by the residual flag
    of their template (``gn_fwd_kernel<T, V, RES, RELU>``)."""
    found = set()
    for e in events:
        if e.get("cat") != "kernel":
            continue
        m = re.search(r"gn_(fwd|bwd)_kernel<[^,]*,\s*\d+,\s*([^,>]+)",
                      e.get("name", ""))
        if m:
            res = m.group(2).strip() in ("true", "1", "(bool)1")
            found.add(f"gn_{m.group(1)}" + ("_res" if res else ""))
    return found


def run_profiler_phase(device, card):
    """9p: ProfilerCallback over a window of a ResNet fit, a device-memory
    snapshot, and one capture through the profiler server."""
    import shutil
    import tempfile
    import threading

    import torch

    from cloud_tpu_torch.monitoring import profiler, tracing
    from cloud_tpu_torch.training import data
    from cloud_tpu_torch.utils import benchmarking

    root = tempfile.mkdtemp(prefix="chip_smoke_profiler_")
    out = {}
    try:
        tr = _cifar_trainer(device)
        arrays = _cifar_arrays(PROFILE_FIT["batches"] * CIFAR_BATCH, 0)
        want_steps = list(range(
            PROFILE_FIT["start_step"],
            PROFILE_FIT["start_step"] + PROFILE_FIT["num_steps"]))
        problem = None
        for attempt in range(PROFILE_SESSIONS):
            cb = profiler.ProfilerCallback(
                os.path.join(root, f"fit{attempt}"),
                start_step=PROFILE_FIT["start_step"] + int(tr.state.step),
                num_steps=PROFILE_FIT["num_steps"])
            start = time.perf_counter()
            with tracing.collecting():
                tr.fit(data.ArrayDataset(arrays, CIFAR_BATCH, shuffle=True),
                       epochs=1, callbacks=[cb])
            fit_s = time.perf_counter() - start
            events = _trace_events(cb.trace_path)
            names = [e.get("name", "") for e in events]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            # A range shows on the host's and the card's timelines.
            markers = sorted({int(n.split("#")[1]) - int(tr.state.step)
                              + PROFILE_FIT["batches"] for n in names
                              if n.startswith("ProfilerStep#")})
            spans = sorted({n for n in names if n.startswith("step/")})
            gn = _gn_trace_names(events)
            problem = None
            if not kernels:
                problem = "the trace holds no kernel"
            elif gn != set(GN_KERNELS):
                problem = f"the trace's GroupNorm kernels {sorted(gn)}"
            elif markers != want_steps:
                problem = f"step markers {markers} != {want_steps}"
            elif "step/compute" not in spans:
                problem = f"the trace's step ranges {spans}"
            if problem is None:
                break
            _profile_pause(attempt)
        if problem is not None:
            raise AssertionError(f"ProfilerCallback: {problem} after "
                                 f"{PROFILE_SESSIONS} sessions")
        out["callback"] = {"trace_mb": os.path.getsize(cb.trace_path) / 2**20,
                           "kernel_rows": len(kernels), "markers": markers,
                           "step_ranges": spans, "fit_s": fit_s,
                           "sessions": attempt + 1}
        mem = profiler.save_device_memory_profile(
            os.path.join(root, "memory.pickle"))
        if os.path.getsize(mem) <= 0:
            raise AssertionError("empty device-memory snapshot")
        out["memory_snapshot_bytes"] = os.path.getsize(mem)
        del tr
        torch.cuda.empty_cache()

        step, state, batch = benchmarking.resnet_train_setup(
            imagenet_shape=False, batch_size=CIFAR_BATCH, device=device)
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        saved = os.environ.get(profiler.ENV_PROFILER_LOGDIR)
        os.environ[profiler.ENV_PROFILER_LOGDIR] = os.path.join(root, "srv")
        _, port = profiler.start_server(0)
        try:
            for attempt in range(PROFILE_SESSIONS):
                answer = {}
                thread = threading.Thread(target=lambda: answer.update(
                    profiler.request_capture(port,
                                             PROFILE_FIT["capture_ms"])))
                thread.start()
                steps = 0
                while thread.is_alive():
                    state, metrics = step(state, batch)
                    steps += 1
                    if steps % 4 == 0:
                        torch.cuda.synchronize()
                thread.join()
                kernels = [e for e in _trace_events(answer["trace"])
                           if e.get("cat") == "kernel"]
                if kernels:
                    break
                _profile_pause(attempt)
        finally:
            profiler.stop_server()
            if saved is None:
                os.environ.pop(profiler.ENV_PROFILER_LOGDIR, None)
            else:
                os.environ[profiler.ENV_PROFILER_LOGDIR] = saved
        if not kernels:
            raise AssertionError(
                f"the server's capture held no kernel in {PROFILE_SESSIONS} "
                "sessions")
        out["server_capture"] = {"kernel_rows": len(kernels),
                                 "steps_during": steps,
                                 "sessions": attempt + 1,
                                 "gn_kernels": sorted(_gn_trace_names(
                                     _trace_events(answer["trace"])))}
        del state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  ProfilerCallback: {out['callback']['kernel_rows']} kernel rows, "
          f"markers {out['callback']['markers']}, ranges "
          f"{out['callback']['step_ranges']}, trace "
          f"{out['callback']['trace_mb']:.1f} MiB; memory snapshot "
          f"{out['memory_snapshot_bytes']} bytes; server capture of "
          f"{PROFILE_FIT['capture_ms']} ms: "
          f"{out['server_capture']['kernel_rows']} kernel rows over "
          f"{out['server_capture']['steps_during']} steps [{card}]")
    return out


class RecordingSession:
    """A stand-in for the Cloud Monitoring REST session (the exporter only
    posts): records each request, sends nothing."""

    def __init__(self):
        self.calls = []

    def post(self, url, body=None, params=None):
        self.calls.append(("POST", url, body, params))
        return {}


def run_exporter_phase(device, card):
    """9m: the native library on this machine, its C tests, and the
    bootstrap exporting a training run's time series."""
    import shutil
    import tempfile

    from cloud_tpu_torch import monitoring
    from cloud_tpu_torch.core import bootstrap
    from cloud_tpu_torch.monitoring import metrics
    from cloud_tpu_torch.utils import api_client

    del device  # the bootstrap runs on the card by default
    cpp = os.path.join(REPO_ROOT, "cloud_tpu_torch", "monitoring", "cpp")
    root = tempfile.mkdtemp(prefix="chip_smoke_exporter_")
    try:
        start = time.perf_counter()
        built = subprocess.run(
            ["make", "-j4", "-C", cpp, metrics.LIB_NAME],
            capture_output=True, text=True, timeout=300)
        if built.returncode != 0:
            raise AssertionError(f"make: {built.stdout[-2000:]}"
                                 f"{built.stderr[-2000:]}")
        if metrics.backend() != "native":
            raise AssertionError(f"metrics.backend() is {metrics.backend()}")
        # A copy without build outputs, as the build context vendors it:
        # the library's build there is what a container pays at first use.
        tests_dir = os.path.join(root, "cpp")
        shutil.copytree(cpp, tests_dir, ignore=shutil.ignore_patterns(
            "*.so", "*_test"))
        lib_start = time.perf_counter()
        clean = subprocess.run(
            ["make", "-C", tests_dir, metrics.LIB_NAME],
            capture_output=True, text=True, timeout=300)
        lib_s = time.perf_counter() - lib_start
        if clean.returncode != 0:
            raise AssertionError(f"make (clean copy): {clean.stderr[-2000:]}")
        ctests = subprocess.run(
            ["make", "-j4", "-C", tests_dir, "test"],
            capture_output=True, text=True, timeout=300)
        if ctests.returncode != 0 or "all tests passed" not in ctests.stdout:
            raise AssertionError(f"C tests: {ctests.stdout[-2000:]}"
                                 f"{ctests.stderr[-2000:]}")
        build_s = time.perf_counter() - start
    finally:
        shutil.rmtree(root, ignore_errors=True)

    session = RecordingSession()
    env = {"CLOUD_TPU_MONITORING_ENABLED": "1",
           "CLOUD_TPU_MONITORING_PROJECT_ID": "chip-smoke-proj",
           "CLOUD_TPU_MONITORING_WIRE": "python",
           "CLOUD_TPU_MONITORING_INTERVAL": "3600",
           "MNIST_EXAMPLE_EPOCHS": "2", "MNIST_EXAMPLE_STEPS": "4"}
    saved_env = {k: os.environ.get(k) for k in env}
    saved_argv, saved_session = list(sys.argv), api_client.default_session
    os.environ.update(env)
    api_client.default_session = lambda: session
    start = time.perf_counter()
    try:
        bootstrap.main([f"--entry-point={MONITORED_ENTRY}"])
    finally:
        monitoring.stop_exporter()
        api_client.default_session = saved_session
        sys.argv[:] = saved_argv
        os.environ.pop(bootstrap.ENV_RUNNING_REMOTELY, None)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    run_s = time.perf_counter() - start
    posted = [body for method, url, body, _ in session.calls
              if url.endswith("/projects/chip-smoke-proj/timeSeries")]
    types = {s["metric"]["type"] for body in posted
             for s in body["timeSeries"]}
    for name in ("train/steps", "train/step_time_ms"):
        if f"custom.googleapis.com/cloud_tpu/{name}" not in types:
            raise AssertionError(f"no {name} time series: {sorted(types)}")
    print(f"  native library: make of a clean copy {lib_s:.2f} s (9r's "
          f"container builds it so before its first step); with its C "
          f"tests {build_s:.1f} s;"
          f" metrics.backend() {metrics.backend()}; bootstrapped MNIST "
          f"exported {len(types)} time series in {len(posted)} posts "
          f"({run_s:.1f} s) [{card}]")
    return {"backend": metrics.backend(), "lib_make_s": lib_s,
            "build_and_ctests_s": build_s,
            "run_s": run_s, "series": sorted(types), "posts": len(posted)}


# Phases 9t and 9f: trials of a search dispatched onto workers, and
# cloud_fit through the front door with a sharded checkpoint.

#: 9t: the tuner worker the dispatched jobs run, its study and its trials.
TUNER_ENTRY = os.path.join(REPO_ROOT, "tests", "helpers",
                           "torch_tuner_resnet_example.py")
TUNER_SEARCH = {"workers": 2, "max_trials": 4, "epochs": 2, "steps": 3}
#: 9f: the steps of the two-rank fit (one epoch) and of the one-process
#: run that restores its checkpoint.
CLOUD_FIT = {"steps": 6, "restore_steps": 1, "ranks": 2}
PHASE_9_TIMEOUT_S = 420


def _resnet_fsdp_axes(config):
    """ResNet's logical axes with every kernel's output channels (the head's
    input features) on ``embed``, which the default rules cut over fsdp:
    under ``{fsdp: 2}`` each rank holds half of every kernel and of its
    momentum, where the model's own axes replicate every parameter."""
    from cloud_tpu_torch.models import resnet

    def cut(node, name=""):
        if isinstance(node, dict):
            return {k: cut(v, k) for k, v in node.items()}
        if name == "kernel" and len(node) == 4:
            return (None, None, None, "embed")
        if name == "kernel" and len(node) == 2:
            return ("embed", None)
        return node

    return cut(resnet.param_logical_axes(config))


def _resnet_on(config, generator):
    """ResNet's init on the generator's device (cloud_fit's init_fn)."""
    from cloud_tpu_torch import bridge

    return bridge.init_resnet(config, generator, device=generator.device)


class FitProbe:
    """A cloud_fit callback (cloudpickled with the spec): at train begin
    (``"begin"`` in ``modes``) and end (``"end"``) it writes this rank's
    report (``rank<r>.json``: the mesh, steps, per-step losses, K1-K4
    launches, the device) and, from every rank's gathered state, rank 0's
    parameters (``params-<mode>.npz``, bf16 leaves as their int16 bits)
    into ``out_dir``."""

    def __init__(self, out_dir, modes):
        self.out_dir = out_dir
        self.modes = tuple(modes)
        self.losses = []

    def on_train_begin(self, trainer):
        if "begin" in self.modes:
            self._dump(trainer, "begin")

    def on_epoch_begin(self, epoch, trainer): ...

    def on_epoch_end(self, epoch, logs, trainer): ...

    def on_step_end(self, step, logs, trainer):
        self.losses.append(float(logs["loss"]))

    def on_train_end(self, trainer):
        if "end" in self.modes:
            self._dump(trainer, "end")

    def _dump(self, trainer, mode):
        import torch

        from cloud_tpu_torch import bridge
        from cloud_tpu_torch.ops import dispatch
        from cloud_tpu_torch.parallel import distributed, sharding

        rank = distributed.process_index()
        params = trainer.state.params
        if trainer._mesh is not None:
            params = sharding.gather_tree(params, trainer.logical_axes,
                                          trainer._mesh, trainer.rules)
        os.makedirs(self.out_dir, exist_ok=True)
        mesh = trainer.mesh
        with open(os.path.join(self.out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({
                "rank": rank,
                "mesh": None if mesh is None else {
                    k: v for k, v in mesh.shape.items() if v > 1},
                "steps": int(trainer.state.step), "losses": self.losses,
                "launches": dispatch.launch_counts(GN_KERNELS),
                "local_bytes": sum(t.numel() * t.element_size() for t in
                                   bridge.leaves(trainer.state.params)),
                "device": (torch.cuda.get_device_name(trainer.device)
                           if trainer.device.type == "cuda" else "cpu"),
            }, f)
        if rank == 0:
            flat = {}
            for i, t in enumerate(bridge.leaves(params)):
                t = t.detach().cpu()
                flat[str(i)] = (t.view(torch.int16) if t.dtype ==
                                torch.bfloat16 else t).numpy()
            np.savez(os.path.join(self.out_dir, f"params-{mode}.npz"),
                     **flat)


def run_tuner_phase(device, card, *, batch=CIFAR_BATCH, rig="cuda",
                    worker_args=()):
    """9t: ``tuner.dispatch_search`` of two workers, each job's context
    and startup script booted on the card at once; the workers share one
    local study of ResNet-50 CIFAR b256 bf16 trials.  ``batch``,
    ``rig="cpu"`` and ``worker_args`` (``--config tiny``) rehearse it on
    the CPU."""
    import shutil
    import tempfile
    import threading

    import torch

    import cloud_tpu_torch
    from cloud_tpu_torch import tuner
    from cloud_tpu_torch.core import containerize
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.utils import local_rig

    del device  # each container's bootstrap takes the card by default
    search = TUNER_SEARCH
    root = tempfile.mkdtemp(prefix="chip_smoke_tuner_")
    study_dir = os.path.join(root, "study")
    saved = os.environ.get("CLOUD_TPU_COMPILE_CACHE")
    runs = {}
    try:
        os.environ["CLOUD_TPU_COMPILE_CACHE"] = dispatch.build_dir()
        start = time.perf_counter()
        study_id, reports = tuner.dispatch_search(
            search["workers"], entry_point=TUNER_ENTRY,
            entry_point_args=["--study-dir", study_dir,
                              "--meet-dir", os.path.join(root, "meet"),
                              "--workers", str(search["workers"]),
                              "--max-trials", str(search["max_trials"]),
                              "--epochs", str(search["epochs"]),
                              "--steps", str(search["steps"]),
                              "--batch", str(batch), *worker_args],
            chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS["TPU_V5E_1"],
            docker_config=containerize.DockerConfig(
                image="gcr.io/chip-smoke/resnet50-cifar-tuner:0"),
            dry_run=True)
        dispatch_s = time.perf_counter() - start

        def boot(i, report):
            context = containerize.build_context(
                report.dockerfile, TUNER_ENTRY, None,
                dst_dir=os.path.join(root, f"context{i}"))
            (node,) = report.node_requests.values()
            argv = containerize.entrypoint_argv(report.dockerfile)
            if rig == "cpu":
                argv.insert(argv.index("--"), "--device=cpu")
            begin = time.perf_counter()
            (proc,) = local_rig.launch_emulated_slice(
                1, device=rig,
                startup_script=node["metadata"]["startup-script"],
                entrypoint=argv, context_dir=context,
                timeout=PHASE_9_TIMEOUT_S)
            runs[i] = (proc, time.perf_counter() - begin)

        threads = [threading.Thread(target=boot, args=(i, r))
                   for i, r in enumerate(reports)]
        start = time.perf_counter()
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        wall = time.perf_counter() - start
        trials = tuner.LocalStudyService(study_id, study_dir).list_trials()
    finally:
        if saved is None:
            os.environ.pop("CLOUD_TPU_COMPILE_CACHE", None)
        else:
            os.environ["CLOUD_TPU_COMPILE_CACHE"] = saved
        shutil.rmtree(root, ignore_errors=True)
    outs = []
    for i in range(search["workers"]):
        if i not in runs:
            raise AssertionError(f"worker {i} was not booted")
        proc, worker_wall = runs[i]
        if proc.returncode != 0:
            raise AssertionError(
                f"worker {i} exited {proc.returncode}:\n"
                f"{proc.stdout[-3000:]}\n{proc.stderr[-5000:]}")
        out = json.loads([line for line in proc.stdout.splitlines()
                          if line.startswith("{")][-1])
        out["container_wall_s"] = worker_wall
        outs.append(out)
    statuses = sorted(t["status"] for t in trials)
    if statuses != ["COMPLETED"] * search["max_trials"]:
        raise AssertionError(f"the study's trials ended {statuses}")
    for t in trials:
        if len(t["measurements"]) != search["epochs"] or not all(
                np.isfinite(m["value"]) for m in t["measurements"]):
            raise AssertionError(f"trial {t['id']}: measurements "
                                 f"{t['measurements']}")
        if t["final"] is None or not np.isfinite(t["final"]):
            raise AssertionError(f"trial {t['id']}: final {t['final']}")
    steps = 0
    for out in outs:
        if out["devices"] != [torch.cuda.get_device_name(0)
                              if rig == "cuda" else "cpu"]:
            raise AssertionError(f"{out['tuner_id']}'s trials ran on "
                                 f"{out['devices']}")
        if any(t["status"] != "COMPLETED" for t in out["trials"]):
            raise AssertionError(f"{out['tuner_id']}: {out['trials']}")
        for fit in out["fits"]:
            if not all(np.isfinite(v) for v in fit["losses"]):
                raise AssertionError(f"{out['tuner_id']}: losses "
                                     f"{fit['losses']}")
        steps += out["steps"]
    want_steps = (search["max_trials"] * search["epochs"]
                  * search["steps"])
    launches = _gn_sum(*(out["launches"] for out in outs))
    if steps != want_steps or (rig == "cuda" and launches
                               != _gn_times(GN_PER_STEP, steps)):
        raise AssertionError(f"{steps} steps (want {want_steps}), launches "
                             f"{launches} != {_gn_times(GN_PER_STEP, steps)}")
    best = min(trials, key=lambda t: t["final"])
    per_worker = {out["tuner_id"]: len(out["trials"]) for out in outs}
    print(f"  study {study_id!r}: {len(trials)} trials COMPLETED, "
          f"{search['epochs']} measurements each; trials per worker "
          f"{per_worker}; best {best['params']} (loss {best['final']:.4f}); "
          f"dispatch_search dry run {dispatch_s:.3f} s; both containers "
          f"{wall:.1f} s of wall [{card}]")
    for out in outs:
        gauge = out["submit_to_first_step_seconds"]
        print(f"  {out['tuner_id']}: submit-to-first-step "
              f"{'not measured' if gauge is None else f'{gauge:.3f} s'}, "
              f"search {out['wall_s']:.2f} s, container "
              f"{out['container_wall_s']:.1f} s; per trial: "
              + "; ".join(
                  f"{fit['wall_s']:.2f} s, max memory "
                  f"{(fit['max_memory_allocated'] or 0) / 2**30:.3f} GiB, "
                  f"losses "
                  f"{[round(v, 4) for v in fit['losses']]}"
                  for fit in out["fits"]))
    return {"study_id": study_id, "trials": trials, "workers": outs,
            "trials_per_worker": per_worker, "best": best,
            "dispatch_s": dispatch_s, "wall_s": wall, "steps": steps,
            "launches": launches}


def _ranks_reports(probe, ranks):
    """Every rank's ``FitProbe`` report from ``probe``."""
    outs = []
    for rank in range(ranks):
        with open(os.path.join(probe, f"rank{rank}.json")) as f:
            outs.append(json.load(f))
    return outs


def _same_params(path_a, path_b):
    """Whether two ``FitProbe`` parameter dumps are equal bit for bit."""
    with np.load(path_a) as a, np.load(path_b) as b:
        return sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) for k in a.files)


def _checked_checkpoint(ckpt_dir, step, ranks):
    """The checkpoint in ``ckpt_dir`` holds ``step`` alone and verifies;
    returns (its manifest's files by writing rank, its bytes)."""
    from cloud_tpu_torch.training import checkpoint

    manager = checkpoint.CheckpointManager(ckpt_dir, device="cpu")
    if manager.steps() != [step] or manager.verify(step) != "verified":
        raise AssertionError(f"{ckpt_dir}: steps {manager.steps()}, verify "
                             f"{manager.verify(step)}")
    with open(os.path.join(ckpt_dir, str(step),
                           checkpoint.MANIFEST_NAME)) as f:
        files = json.load(f)["entries"]
    by_rank = {r: sum(1 for name in files if name.endswith(f".r{r}.bin"))
               for r in range(ranks)}
    return by_rank, sum(e["bytes"] for e in files.values())


def run_cloud_fit_phase(device, card, *, config=None, batch=CIFAR_BATCH,
                        rig="cuda"):
    """9f: ``cloud_tpu_torch.cloud_fit`` of ResNet-50 CIFAR b256 bf16 (a
    dry run) for a job of two one-chip hosts, then the image's ENTRYPOINT
    as ``run()`` generated it (its plan ``{dp: 2}``) on two emulated hosts
    over gloo: every leaf replicated, so rank 0 alone writes the
    checkpoint.  That checkpoint is the ``state/`` of a second two-rank
    run booted through the bootstrap's own plan over its processes,
    ``{fsdp: 2}`` (no catalog job of two hosts plans fsdp: ROADMAP C10),
    which restores it straight into the shards and saves them per rank;
    a one-process ``remote.run`` in this process restores that sharded
    checkpoint.  Each restore is bit-equal to the parameters saved.
    ``config``, ``batch`` and ``rig="cpu"`` rehearse it on the CPU."""
    import shutil
    import sys as sys_lib
    import tempfile

    import cloudpickle
    import torch

    import cloud_tpu_torch
    from cloud_tpu_torch.cloud_fit import client, remote, serialization
    from cloud_tpu_torch.core import containerize
    from cloud_tpu_torch.core import run as run_lib
    from cloud_tpu_torch.models import resnet
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.training import checkpoint, optimizers
    from cloud_tpu_torch.utils import local_rig

    config = config or resnet.RESNET50_CIFAR
    if __name__ != "__main__":
        # A rehearsal imports this file: its callback travels by value.
        cloudpickle.register_pickle_by_value(sys_lib.modules[__name__])
    workload = _front_door_workload()
    steps, ranks = CLOUD_FIT["steps"], CLOUD_FIT["ranks"]
    root = tempfile.mkdtemp(prefix="chip_smoke_cloud_fit_")
    remote_dir = os.path.join(root, "remote")
    probes = {k: os.path.join(root, f"probe-{k}")
              for k in ("dp", "fsdp", "one")}
    arrays = workload.cifar_arrays(steps * batch, config.num_classes)
    loss_device = None if rig == "cuda" else "cpu"
    spec = serialization.TrainerSpec(
        loss_fn=functools.partial(resnet.loss_fn, config=config,
                                  device=loss_device),
        optimizer=optimizers.sgd(workload.LEARNING_RATE, momentum=0.9),
        init_fn=functools.partial(_resnet_on, config),
        logical_axes=_resnet_fsdp_axes(config))

    def assets(name, state, modes, fit_kwargs):
        """A remote dir whose ``state/`` is the checkpoint ``state``."""
        where = os.path.join(root, name)
        serialization.serialize_assets(
            where, spec, arrays, callbacks=[FitProbe(probes[name], modes)],
            fit_kwargs={"batch_size": batch, **fit_kwargs})
        shutil.copytree(state, os.path.join(where, "state"))
        return where

    def output(where):
        return os.path.join(where, remote.OUTPUT_DIR, "checkpoint")

    saved = os.environ.get("CLOUD_TPU_COMPILE_CACHE")
    root_dirs = [root]
    # What cloud_fit hands run(): the shim it generated, the hints.
    submitted, real_run = {}, run_lib.run

    def recording_run(**kw):
        submitted.update(kw)
        return real_run(**kw)

    try:
        os.environ["CLOUD_TPU_COMPILE_CACHE"] = dispatch.build_dir()
        run_lib.run = recording_run
        start = time.perf_counter()
        report = cloud_tpu_torch.cloud_fit(
            spec, remote_dir, train_data=arrays, batch_size=batch, epochs=1,
            callbacks=[FitProbe(probes["dp"], ("end",))],
            chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS["TPU_V5E_1"],
            worker_count=ranks - 1,
            docker_config=containerize.DockerConfig(
                image="gcr.io/chip-smoke/resnet50-cifar-cloud-fit:0"),
            dry_run=True)
        client_s = time.perf_counter() - start
        run_lib.run = real_run
        shim = submitted["entry_point"]
        root_dirs.append(os.path.dirname(shim))
        assets_written = sorted(os.listdir(os.path.join(
            remote_dir, serialization.ASSET_DIR)))
        if assets_written != ["callbacks.pkl", "fit_kwargs.json",
                              "train_data.npz", "trainer.pkl"]:
            raise AssertionError(f"assets {assets_written}")
        plan = {k: v for k, v in report.mesh_plan.spec.sizes.items()
                if v > 1}
        argv = containerize.entrypoint_argv(report.dockerfile)
        if argv[:3] != ["python", "-m", "cloud_tpu_torch.core.bootstrap"]:
            raise AssertionError(f"ENTRYPOINT {argv}")
        if submitted["parallelism_hints"] is not spec.parallelism_hints:
            raise AssertionError("cloud_fit did not pass the spec's "
                                 "parallelism_hints to run()")
        if (os.path.basename(shim) != "cloud_fit_entry.py"
                or os.path.basename(shim) not in report.dockerfile):
            raise AssertionError(f"the Dockerfile does not run {shim}")
        with open(shim) as f:
            if "from cloud_tpu_torch.cloud_fit import remote" not in f.read():
                raise AssertionError("the shim does not import the port's "
                                     "remote")
        context = containerize.build_context(
            report.dockerfile, shim, None,
            dst_dir=os.path.join(root, "context"))
        (node,) = [n for n in report.node_requests.values()
                   if "CLOUD_TPU_PROCESS_ID=$((0 + LOCAL_ID))"
                   in n["metadata"]["startup-script"]]
        # The ENTRYPOINT as generated, its mesh plan included; the two
        # ranks share the one card, so over gloo.
        argv = argv + ["--backend=gloo"]
        if rig == "cpu":
            argv.append("--device=cpu")
        start = time.perf_counter()
        procs = local_rig.launch_emulated_slice(
            ranks, device=rig,
            startup_script=node["metadata"]["startup-script"],
            entrypoint=argv, context_dir=context,
            timeout=PHASE_9_TIMEOUT_S)
        dp_wall = time.perf_counter() - start
        for rank, proc in enumerate(procs):
            if proc.returncode != 0:
                raise AssertionError(
                    f"rank {rank} exited {proc.returncode}:\n"
                    f"{proc.stdout[-3000:]}\n{proc.stderr[-5000:]}")
        dp_outs = _ranks_reports(probes["dp"], ranks)
        out_dir = os.path.join(remote_dir, remote.OUTPUT_DIR)
        if sorted(os.listdir(out_dir)) != ["checkpoint", "history.json"]:
            raise AssertionError(f"output {sorted(os.listdir(out_dir))}")
        with open(os.path.join(out_dir, "history.json")) as f:
            history = json.load(f)
        dp_files, dp_bytes = _checked_checkpoint(output(remote_dir), steps,
                                                 ranks)

        # Two ranks under the bootstrap's own plan restore it into shards.
        fsdp_dir = assets("fsdp", output(remote_dir), ("begin", "end"),
                          {"epochs": 1})
        fsdp_shim = client.write_entry_shim(fsdp_dir)
        root_dirs.append(os.path.dirname(fsdp_shim))
        start = time.perf_counter()
        proc = local_rig.run_bootstrap(
            fsdp_shim, device=rig,
            num_processes=ranks, timeout=PHASE_9_TIMEOUT_S)
        fsdp_wall = time.perf_counter() - start
        for rank, one in enumerate(proc.ranks):
            if one.returncode != 0:
                raise AssertionError(
                    f"{{fsdp: 2}} rank {rank} exited {one.returncode}:\n"
                    f"{one.stdout[-3000:]}\n{one.stderr[-5000:]}")
        fsdp_outs = _ranks_reports(probes["fsdp"], ranks)
        if not _same_params(os.path.join(probes["dp"], "params-end.npz"),
                            os.path.join(probes["fsdp"],
                                         "params-begin.npz")):
            raise AssertionError("the {fsdp: 2} ranks' restored parameters "
                                 "differ from the {dp: 2} run's")
        fsdp_files, fsdp_bytes = _checked_checkpoint(output(fsdp_dir),
                                                     2 * steps, ranks)

        # One process restores the two ranks' sharded checkpoint.
        one_dir = assets("one", output(fsdp_dir), ("begin",),
                         {"epochs": 1,
                          "steps_per_epoch": CLOUD_FIT["restore_steps"]})
        dispatch.reset_launch_counts()
        start = time.perf_counter()
        remote.run(one_dir, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        restore_run_s = time.perf_counter() - start
        one_launches = dispatch.launch_counts(GN_KERNELS)
        (one,) = _ranks_reports(probes["one"], 1)
        if not _same_params(os.path.join(probes["fsdp"], "params-end.npz"),
                            os.path.join(probes["one"], "params-begin.npz")):
            raise AssertionError("the restored parameters differ from the "
                                 "{fsdp: 2} ranks' gathered parameters")
        restored = checkpoint.CheckpointManager(output(one_dir),
                                                device="cpu").steps()
    finally:
        if saved is None:
            os.environ.pop("CLOUD_TPU_COMPILE_CACHE", None)
        else:
            os.environ["CLOUD_TPU_COMPILE_CACHE"] = saved
        run_lib.run = real_run
        for d in root_dirs:
            shutil.rmtree(d, ignore_errors=True)
    if plan != {"dp": ranks}:
        raise AssertionError(f"run() planned {plan}")
    if dp_files[0] == 0 or any(dp_files[r] for r in range(1, ranks)):
        raise AssertionError(f"{{dp: 2}} checkpoint files by rank {dp_files}")
    if not all(fsdp_files.values()):
        raise AssertionError(f"{{fsdp: 2}} checkpoint files by rank "
                             f"{fsdp_files}")
    for mesh, outs, first in ((plan, dp_outs, 0),
                              ({"fsdp": ranks}, fsdp_outs, steps)):
        for out in outs:
            if out["mesh"] != mesh:
                raise AssertionError(f"rank {out['rank']} ran under "
                                     f"{out['mesh']}, not {mesh}")
            if (out["steps"] != first + steps
                    or len(out["losses"]) != steps
                    or not all(np.isfinite(out["losses"]))):
                raise AssertionError(f"rank {out['rank']}: {out['steps']} "
                                     f"steps, losses {out['losses']}")
            if rig == "cuda" and (
                    out["device"] != torch.cuda.get_device_name(0)
                    or out["launches"] != _gn_times(GN_PER_STEP, steps)):
                raise AssertionError(f"rank {out['rank']} on "
                                     f"{out['device']}: launches "
                                     f"{out['launches']}")
    if fsdp_outs[0]["local_bytes"] >= dp_outs[0]["local_bytes"]:
        raise AssertionError("the {fsdp: 2} ranks hold whole parameters")
    if one["steps"] != 2 * steps or restored != [
            2 * steps + CLOUD_FIT["restore_steps"]]:
        raise AssertionError(f"the restoring run began at {one['steps']} and "
                             f"saved {restored}")
    if rig == "cuda" and one_launches != _gn_times(
            GN_PER_STEP, CLOUD_FIT["restore_steps"]):
        raise AssertionError(f"restoring run launches {one_launches}")
    launches = _gn_sum(*(out["launches"] for out in dp_outs + fsdp_outs),
                       one_launches)
    print(f"  cloud_fit dry run {client_s:.3f} s, plan {plan}; the "
          f"ENTRYPOINT on two hosts: {dp_wall:.1f} s of wall for {steps} "
          f"steps of {batch} rows (each rank {batch // ranks}), losses "
          f"{[round(v, 4) for v in dp_outs[0]['losses']]}; history.json "
          f"{sorted(history)}; checkpoint {dp_bytes / 2**20:.1f} MiB, files "
          f"by rank {dp_files}, verified [{card}]")
    print(f"  {{fsdp: 2}} from the bootstrap's plan: restored it into the "
          f"shards bit-equal, {fsdp_wall:.1f} s of wall for {steps} steps, "
          f"losses {[round(v, 4) for v in fsdp_outs[0]['losses']]}; each "
          f"rank holds {fsdp_outs[0]['local_bytes'] / 2**20:.1f} MiB of "
          f"parameters ({dp_outs[0]['local_bytes'] / 2**20:.1f} under dp); "
          f"sharded checkpoint {fsdp_bytes / 2**20:.1f} MiB, files by rank "
          f"{fsdp_files}, verified; a one-process remote.run restored it "
          f"bit-equal and took {CLOUD_FIT['restore_steps']} step in "
          f"{restore_run_s:.2f} s (its set-up and save included) [{card}]")
    return {"plan": plan, "dp_ranks": dp_outs, "fsdp_ranks": fsdp_outs,
            "client_s": client_s, "dp_wall_s": dp_wall,
            "fsdp_wall_s": fsdp_wall, "dp_checkpoint_bytes": dp_bytes,
            "fsdp_checkpoint_bytes": fsdp_bytes, "dp_files_by_rank": dp_files,
            "fsdp_files_by_rank": fsdp_files, "restore_run_s": restore_run_s,
            "history": history, "launches": launches}


# ---------------------------------------------------------------------------
# Phase 2 (enc) and 6enc: BERT-base and ViT-B/16 trained under a mesh
# ---------------------------------------------------------------------------

#: 6enc's batches: BERT-base b32 x T128 with ragged padding (bench.py's
#: BERT shape), ViT-B/16 at 224 px with a small batch, MNIST and ResNet-50
#: CIFAR rows.
ENC_VIT_BATCH, ENC_MNIST_BATCH, ENC_RESNET_BATCH = 8, 64, 32
#: 6enc's arms, in the order both ranks run them: (name, model, mesh
#: sizes, dtype name, steps).  The f32 arms hold step 1's loss, its
#: gradient and the parameters after the steps to one process; the bf16
#: arms take 3 steps.
ENC_ARMS = (
    ("bert tp", "bert", {"tp": 2}, "float32", 1),
    ("bert sp", "bert", {"sp": 2}, "float32", 1),
    ("bert fsdp", "bert", {"fsdp": 2}, "float32", 1),
    ("bert tp bf16", "bert", {"tp": 2}, "bfloat16", 3),
    ("vit tp", "vit", {"tp": 2}, "float32", 1),
    ("vit sp", "vit", {"sp": 2}, "float32", 1),
    ("vit fsdp", "vit", {"fsdp": 2}, "float32", 1),
    ("vit tp bf16", "vit", {"tp": 2}, "bfloat16", 3),
    ("mnist tp", "mnist", {"tp": 2}, "float32", 2),
    ("resnet tp", "resnet", {"tp": 2}, "float32", 2),
)
#: 6enc's SGD learning rate, its gradient limit (a fraction of the
#: gradient's largest magnitude) against one process, and its limit on
#: the parameters after the steps (a fraction of one process's largest
#: change of a parameter, plus two f32 ulps of the largest parameter).
ENC_LR, ENC_GRAD_TOL, ENC_PARAM_TOL = 1e-3, 1e-5, 1e-3
#: The K5-K7 shapes 6enc adds, timed by phase 2 (enc): (label, batch,
#: T, heads, mask kind).
ENC_KERNEL_SHAPES = (
    ("BERT tp rank", BERT_BATCH, BERT_SEQ, HEADS // 2, "tail"),
    ("BERT sp block", BERT_BATCH, BERT_SEQ // 2, HEADS, "tail"),
    ("ViT tp rank", ENC_VIT_BATCH, 196, HEADS // 2, None),
    ("ViT sp block", ENC_VIT_BATCH, 196 // 2, HEADS, None),
)


def check_enc_kernels(device, card):
    """K5, K6 and K7 at 6enc's new call shapes (a BERT tp rank's 6 heads,
    masked; a BERT sp block of 64 positions, masked; a ViT tp rank's 6
    heads at T=196; a ViT sp block of 98 positions, off the 64-row
    tiles), bf16 and f32, against their plain versions
    (:func:`_bwd_case`); then each timed in bf16 beside the plain version,
    SDPA and the bound (:func:`_time_attention`).  Returns {"max_abs_err":
    {"<kernel> <dtype>": err}, "rows": {label: {kernel: entry}}}."""
    import torch

    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(23)
    worst, rows = {}, {}
    for label, b, t, h, mask_kind in ENC_KERNEL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            errs = _bwd_case(fa, b, t, False, dtype, gen,
                             mask_kind=mask_kind, glse=False, h=h)
            for kname in TRAIN_ATTN_KERNELS:
                key = f"{kname} {dname}"
                worst[key] = max(worst.get(key, 0.0), errs[kname])
            print(f"  K5/K6/K7 {label} B={b} T={t} H={h} {dname} "
                  f"mask={mask_kind}: max_abs_err out "
                  f"{errs['flash_fwd']:.3e}, dq {errs['flash_bwd_dq']:.3e}, "
                  f"dk/dv {errs['flash_bwd_dkv']:.3e} [{card}]")
        rows[label] = _time_attention(fa, label, card, gen,
                                      shape=(b, t, False), h=h,
                                      mask_kind=mask_kind)
    dispatch.reset_launch_counts()
    return {"max_abs_err": worst, "rows": rows}


def _enc_setup(device, model, dtype_name, configs=None):
    """The arm's model at full width (``configs[model]`` overrides it in a
    rehearsal): (config, full params from seed 0 on ``device``, the global
    batch, logical axes, its loss_fn with the config bound, the
    kernels' launches one step of one rank makes as a function of the mesh
    sizes)."""
    import dataclasses

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import bert, mnist, resnet, vit

    configs = configs or {}
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device=device).manual_seed(0)
    rng = np.random.default_rng(0)

    def attention(layers_n, remat):
        def per_step(sizes):
            calls = sizes.get("sp", 1)  # the non-causal ring's hops
            return {"flash_fwd": calls * (2 if remat else 1) * layers_n,
                    "flash_bwd_dq": calls * layers_n,
                    "flash_bwd_dkv": calls * layers_n}
        return per_step

    def on(batch):
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    if model == "bert":
        cfg = dataclasses.replace(configs.get("bert", bert.BERT_BASE),
                                  dtype=dtype)
        b, t = BERT_BATCH, min(BERT_SEQ, cfg.max_seq_len)
        lengths = rng.integers(t // 4, t + 1, b)
        lengths[0] = t
        batch = {"tokens": rng.integers(1, cfg.vocab_size, (b, t)),
                 "attention_mask": (np.arange(t)[None] < lengths[:, None]
                                    ).astype(np.int32),
                 "label": rng.integers(0, cfg.num_classes, b)}
        return (cfg, bridge.init_bert(cfg, gen, device=device), on(batch),
                bert.param_logical_axes(cfg),
                functools.partial(bert.loss_fn, cfg=cfg),
                attention(cfg.num_layers, cfg.remat != "none"))
    if model == "vit":
        cfg = configs.get("vit", vit.VIT_BASE_16).scaled(dtype=dtype)
        size = cfg.image_size
        batch = {"image": rng.normal(size=(ENC_VIT_BATCH, size, size,
                                           cfg.channels)).astype(np.float32),
                 "label": rng.integers(0, cfg.num_classes, ENC_VIT_BATCH)}
        return (cfg, bridge.init_vit(cfg, gen, device=device), on(batch),
                vit.param_logical_axes(cfg),
                functools.partial(vit.loss_fn, cfg=cfg),
                attention(cfg.num_layers, cfg.remat))
    if model == "mnist":
        cfg = configs.get("mnist", mnist.MnistConfig())
        batch = {"image": rng.normal(size=(ENC_MNIST_BATCH, 784)).astype(
            np.float32), "label": rng.integers(0, 10, ENC_MNIST_BATCH)}
        return (cfg, bridge.init_mnist(cfg, gen, device=device), on(batch),
                mnist.param_logical_axes(cfg),
                functools.partial(mnist.loss_fn, config=cfg),
                lambda sizes: {})
    cfg = dataclasses.replace(configs.get("resnet", resnet.RESNET50_CIFAR),
                              dtype=dtype)
    return (cfg, bridge.init_resnet(cfg, gen, device=device),
            on(_cifar_arrays(ENC_RESNET_BATCH, 5)),
            resnet.param_logical_axes(cfg),
            functools.partial(resnet.loss_fn, config=cfg),
            lambda sizes: dict(GN_PER_STEP))


def _enc_reference(device, arm, configs=None):
    """One process, no mesh, on the whole batch: (per-step metrics, steps/s
    over the steps, and in f32 arms step 1's gradient leaves, the
    parameter leaves after the steps and their largest change)."""
    import torch

    from cloud_tpu_torch.bridge import leaves
    from cloud_tpu_torch.training import optimizers, train

    _, model, _, dtype_name, steps = arm
    cfg, params, batch, _, loss, _ = _enc_setup(device, model, dtype_name,
                                                configs)
    initial = [p.detach().clone() for p in leaves(params)]
    tx = optimizers.sgd(ENC_LR)
    state = train.create_sharded_state(None, lambda _: params, tx,
                                       device=device)
    loss = functools.partial(loss, device=device)
    grads = None
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as the arm's (C3)
    try:
        if dtype_name == "float32":
            _, grads = train._grads(loss, state.params, batch)
            grads = [g.detach() for g in grads]
        step = train.make_train_step(loss, tx)
        metrics = []
        _sync(device)
        start = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        _sync(device)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rate = steps / (time.perf_counter() - start)
    if grads is None:
        return metrics, rate, None
    final = [p.detach().clone() for p in leaves(state.params)]
    change = max(float((a - b).abs().max()) for a, b in zip(final, initial))
    return metrics, rate, grads, final, change


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _enc_arm(rank, device, arm, ref=None, phase="6enc", configs=None):
    """One arm of 6enc on this rank: the mesh over the default group, the
    state cut from the full weights by the model's logical axes, this
    rank's rows (its data coordinate's), step 1's gradient through the
    step's own gather and sync gathered whole and held to one process's
    (f32: within ``ENC_GRAD_TOL`` of its largest magnitude), then the
    steps with the kernels' launches counted from 0 (exact on the card),
    each step's loss held to one process's (f32: 1e-4, bf16: 2e-2
    relative) and, in f32, the parameters after the steps gathered whole
    and held to one process's (``ENC_PARAM_TOL``).  Returns the rank's
    report."""
    import torch

    from cloud_tpu_torch.bridge import leaves, map_leaves
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.parallel import MeshSpec, sharding
    from cloud_tpu_torch.training import optimizers, train

    name, model, sizes, dtype_name, steps = arm
    mesh = MeshSpec(sizes).build(devices=[device] * 2, backend="gloo")
    cfg, params, batch, axes, loss, per_step = _enc_setup(
        device, model, dtype_name, configs)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # ResNet's convolutions (C3)
    tx = optimizers.sgd(ENC_LR)
    state = train.create_sharded_state(
        None, lambda _: map_leaves(params, torch.clone), tx, mesh=mesh,
        logical_axes=axes)
    del params
    loss = functools.partial(loss, mesh=mesh)
    data = mesh.axis_size("dp") * mesh.axis_size("fsdp")
    index = (mesh.axis_index("dp") * mesh.axis_size("fsdp")
             + mesh.axis_index("fsdp"))
    local = {k: v[index * len(v) // data:(index + 1) * len(v) // data]
             for k, v in batch.items()}
    f32 = dtype_name == "float32"
    report = {"arm": name}
    try:
        if f32:
            layout = train._MeshLayout(mesh, None, axes, state.params)
            _, grads = train._grads(loss, layout.gather(state.params), local)
            whole = leaves(sharding.gather_tree(
                train._with_leaves(state.params, iter(layout.sync(grads))),
                axes, mesh))
            if ref is not None:
                scale = max(float(g.abs().max()) for g in ref[2])
                err = max(float((a - b).abs().max())
                          for a, b in zip(whole, ref[2]))
                report["grad_err_rel"] = err / scale
                if err > ENC_GRAD_TOL * scale:
                    raise AssertionError(
                        f"{phase} {name}: step 1's gradient differs from one "
                        f"process's by {err:.3e} (> {ENC_GRAD_TOL} of "
                        f"{scale:.3e})")
            del whole, grads
        step = train.make_train_step(loss, tx, mesh=mesh, logical_axes=axes)
        _sync(device)
        dispatch.reset_launch_counts()
        metrics = []
        start = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
        _sync(device)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    report["steps_per_s"] = steps / (time.perf_counter() - start)
    report["metrics"] = metrics
    want = {k: v * steps for k, v in per_step(sizes).items()}
    report["launches"] = dispatch.launch_counts(tuple(want))
    if device.type == "cuda" and report["launches"] != want:
        raise AssertionError(f"{phase} {name} rank {rank}: launches "
                             f"{report['launches']}, want {want}")
    if ref is not None:
        rel = TOL_F32 if f32 else 2e-2
        for i, (m, r) in enumerate(zip(metrics, ref[0])):
            if not np.isfinite(m["loss"]) or abs(
                    m["loss"] - r["loss"]) > rel * abs(r["loss"]):
                raise AssertionError(
                    f"{phase} {name}: step {i + 1}'s loss {m['loss']!r} "
                    f"against one process's {r['loss']!r} (limit {rel} "
                    "relative)")
        report["one_process_steps_per_s"] = ref[1]
    if f32:
        final = leaves(sharding.gather_tree(state.params, axes, mesh))
        if ref is not None:
            err = max(float((a.detach() - b).abs().max())
                      for a, b in zip(final, ref[3]))
            top = max(float(b.abs().max()) for b in ref[3])
            limit = (ENC_PARAM_TOL * ref[4]
                     + 2 * float(torch.finfo(torch.float32).eps) * top)
            report["param_err_rel"] = err / ref[4]
            if not err <= limit:
                raise AssertionError(
                    f"{phase} {name}: the parameters after {steps} step(s) "
                    f"differ from one process's by {err:.3e} (limit "
                    f"{limit:.3e}; one process's largest change "
                    f"{ref[4]:.3e})")
        del final
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return report


def run_encoder_mesh(device, card, configs=None):
    """6enc: BERT-base (b32 x T128, ragged padding) and ViT-B/16 (224 px,
    b8) at full width and depth trained under 2-rank meshes, rank 0 here
    and rank 1 in a spawned child, both on ``device`` over gloo: ``{tp:
    2}``, ``{sp: 2}`` and ``{fsdp: 2}`` in f32 (TF32 off), each held to one
    process on the same weights and batch (step 1's loss within 1e-4
    relative, its gradient gathered whole within 1e-5 of its largest
    magnitude, the parameters after the step gathered whole within 1e-3
    of one process's largest change of a parameter), then 3 steps under ``{tp: 2}`` in bf16 (each loss within
    2e-2 relative of one process's); MNIST (hidden units split over tp)
    and ResNet-50 CIFAR (replicas, deterministic cuDNN) under ``{tp: 2}``,
    2 steps each held to one process.  Each rank's K5-K7 launches are the
    ring's hops (``sp``, else 1) x layers (K5 twice under ViT's remat) x
    steps, K1-K4 ResNet's 37/16/37/16 a step.  ``configs`` ({model:
    config}) shrinks the models for a CPU rehearsal.  CloudLM SMALL's
    fused CE over a tp-split vocabulary runs in 6mesh's ``tp fused_ce``
    arm."""
    import torch

    refs = {}
    for arm in ENC_ARMS:
        refs[arm[0]] = _enc_reference(device, arm, configs)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def describe(arm, mine, theirs, ref):
        got = [round(m["loss"], 6) for m in mine["metrics"]]
        want = [round(r["loss"], 6) for r in ref[0]]
        extra = (f", gradient within {mine['grad_err_rel']:.2e} of its "
                 "largest magnitude, parameters after the steps within "
                 f"{mine['param_err_rel']:.2e} of one process's largest "
                 "change" if "grad_err_rel" in mine else "")
        print(f"  {arm[0]} {arm[3]} {arm[2]}: losses {got} against one "
              f"process's {want}{extra}; {mine['steps_per_s']:.3f} steps/s "
              f"on 2 ranks against {mine['one_process_steps_per_s']:.3f} in "
              f"one process; launches rank 0 {mine['launches']}, rank 1 "
              f"{theirs['launches']} [{card}]")

    return _two_rank_arms(device, "6enc", ENC_ARMS, refs, _enc_arm,
                          describe, arm_kw={"configs": configs})


# ---------------------------------------------------------------------------
# Phase 9g: the gs:// paths on a directory-backed storage client
# ---------------------------------------------------------------------------

#: 9g: records in 4 shards, a fit of 6 steps checkpointing every 2, one
#: step of the two {fsdp: 2} ranks before their save.
GCS_FIT = {"steps": 6, "every": 2, "shards": 4, "ranks": 2}

#: The {fsdp: 2} ranks of 9g (a bootstrap entry point; its argument is the
#: phase's directory): one step of ResNet from seed 0 with the kernels'
#: output channels on ``embed``, a sharded save to the bucket, rank 0's
#: gathered parameters dumped; each rank's report a JSON file.
GCS_RANK = """
import json, os, pickle, sys
import numpy as np
import torch
root = sys.argv[1]
sys.path.insert(0, os.path.join(REPO_ROOT, "tests"))
sys.path.insert(0, REPO_ROOT)
import chip_smoke
from helpers.torch_gcs_fake import DirectoryStorage
from cloud_tpu_torch import bridge, parallel
from cloud_tpu_torch.models import resnet
from cloud_tpu_torch.ops import dispatch
from cloud_tpu_torch.parallel import distributed, sharding
from cloud_tpu_torch.training import checkpoint, optimizers, train
import functools

with open(os.path.join(root, "config.pkl"), "rb") as f:
    config, batch = pickle.load(f)
mesh = parallel.get_global_mesh()
axes = chip_smoke._resnet_fsdp_axes(config)
tx = optimizers.sgd(0.1, momentum=0.9)
state = train.create_sharded_state(
    None, lambda _: bridge.init_resnet(
        config, torch.Generator(device=mesh.device).manual_seed(0),
        device=mesh.device), tx, mesh=mesh, logical_axes=axes)
rank = distributed.process_index()
arrays = chip_smoke._cifar_arrays(batch, 13)
half = batch // 2
local = train.shard_batch({k: v[rank * half:(rank + 1) * half]
                           for k, v in arrays.items()}, mesh)
step = train.make_train_step(functools.partial(resnet.loss_fn, config=config,
                                               mesh=mesh), tx, mesh=mesh,
                             logical_axes=axes)
dispatch.reset_launch_counts()
state, metrics = step(state, local)
if mesh.device.type == "cuda":
    torch.cuda.synchronize()
launches = dispatch.launch_counts(chip_smoke.GN_KERNELS)
manager = checkpoint.CheckpointManager(
    "gs://chip-smoke/fsdp", device=mesh.device,
    storage_client=DirectoryStorage(os.path.join(root, "buckets")),
    layout=checkpoint.StateLayout(mesh, axes))
manager.save(1, state)
manager.wait()
manager.close()
whole = sharding.gather_tree(state.params, axes, mesh)
if rank == 0:
    np.savez(os.path.join(root, "fsdp-params.npz"),
             **chip_smoke._bits(bridge.leaves(whole)))
with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
    json.dump({"mesh": {k: v for k, v in mesh.shape.items() if v > 1},
               "loss": float(metrics["loss"]), "launches": launches,
               "local_bytes": sum(t.numel() * t.element_size()
                                  for t in bridge.leaves(state.params))}, f)
"""

#: 9g's fresh process: restores the fit's latest step from the bucket and
#: dumps it (argument: the phase's directory).
GCS_RESTORE = """
import json, os, sys
import numpy as np
root = sys.argv[1]
sys.path.insert(0, os.path.join(REPO_ROOT, "tests"))
sys.path.insert(0, REPO_ROOT)
sys.modules["google.cloud"] = None  # never imported with a client given
import chip_smoke
from helpers.torch_gcs_fake import DirectoryStorage
from cloud_tpu_torch import bridge
from cloud_tpu_torch.training import checkpoint
manager = checkpoint.CheckpointManager(
    "gs://chip-smoke/ckpt", device="cpu",
    storage_client=DirectoryStorage(os.path.join(root, "buckets")))
step = manager.latest_step()
state = manager.restore(step)
np.savez(os.path.join(root, "restored.npz"), **chip_smoke._bits(
    [state.step] + bridge.leaves(state.params)
    + bridge.leaves(state.opt_state)))
print(json.dumps({"steps": manager.steps(), "verify": manager.verify(step),
                  "extras": manager.read_extras(step)}))
"""


def _bits(tensors):
    """``{str(i): array}`` of tensors, bf16 as their int16 bits."""
    import torch

    out = {}
    for i, t in enumerate(tensors):
        t = t.detach().cpu()
        out[str(i)] = (t.view(torch.int16) if t.dtype == torch.bfloat16
                       else t).numpy()
    return out


def _same_bits(path, tensors):
    """Whether an ``.npz`` of :func:`_bits` holds ``tensors`` bit for bit."""
    want = _bits(tensors)
    with np.load(path) as got:
        return sorted(got.files) == sorted(want) and all(
            got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
            for k in want)


def _script(root, name, code):
    """``code`` as a script file under ``root`` (``REPO_ROOT`` defined)."""
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write(f"REPO_ROOT = {REPO_ROOT!r}\n" + code)
    return path


def run_gcs_phase(device, card, *, config=None, batch=CIFAR_BATCH,
                  rig="cuda"):
    """9g: the ``gs://`` paths through a storage client backed by a local
    directory (``tests/helpers/torch_gcs_fake.py``; every process builds
    one on the same directory, so they share the buckets).  CIFAR-shaped
    records written to ``gs://`` by ``write_records`` in 4 shards, then
    ResNet-50 CIFAR b256 bf16 ``Trainer.fit`` for 6 steps from
    ``RecordDataset("gs://.../train-*.rec")`` with a ``gs://`` checkpoint
    every 2 steps (K1-K4 37/16/37/16 a step); a fresh process (no
    ``google.cloud`` importable) lists steps 2, 4 and 6, restores the
    latest bit for bit, ``verify()`` reads ``"unmanifested"`` and there are
    no extras; two ranks under the bootstrap's own ``{fsdp: 2}`` plan take
    one step each (kernels' output channels on ``embed``) and save to the
    same bucket, each rank its pieces, and this process restores that
    checkpoint bit for bit.  ``config``, ``batch`` and ``rig="cpu"``
    rehearse it on the CPU."""
    import pickle
    import shutil
    import subprocess as subprocess_lib
    import sys as sys_lib
    import tempfile

    import torch

    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import resnet
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.training import checkpoint, records
    from cloud_tpu_torch.utils import local_rig

    # Every process of the phase builds this client on the same directory.
    fake = _load_helper("torch_gcs_fake")
    config = config or resnet.RESNET50_CIFAR
    steps, every = GCS_FIT["steps"], GCS_FIT["every"]
    root = tempfile.mkdtemp(prefix="chip_smoke_gcs_")
    storage = fake.DirectoryStorage(os.path.join(root, "buckets"))
    try:
        arrays = _cifar_arrays(steps * batch, 11)
        start = time.perf_counter()
        records.write_records(
            "gs://chip-smoke/cifar/train-{shard}.rec",
            ({k: v[i] for k, v in arrays.items()}
             for i in range(len(arrays["label"]))),
            num_shards=GCS_FIT["shards"], storage_client=storage)
        write_s = time.perf_counter() - start
        # A sidecar under the prefix the glob must not read.
        storage.bucket("chip-smoke").blob(
            "cifar/train-index.json").upload_from_string(b"{}")
        dataset = records.RecordDataset(
            "gs://chip-smoke/cifar/train-*.rec", batch_size=batch,
            shuffle_buffer=512, seed=3, verify=True, storage_client=storage)
        if len(dataset.files) != GCS_FIT["shards"]:
            raise AssertionError(f"9g: the glob listed {dataset.files}")
        _sync(device)
        dispatch.reset_launch_counts()
        tr = _cifar_trainer(device, cfg=config)
        start = time.perf_counter()
        tr.fit(dataset, epochs=1, prefetch=2, callbacks=[
            checkpoint.CheckpointCallback(
                "gs://chip-smoke/ckpt", every_n_steps=every, max_to_keep=3,
                device=device, storage_client=storage)])
        _sync(device)
        fit_s = time.perf_counter() - start
        launches = dispatch.launch_counts(GN_KERNELS)
        if int(tr.state.step) != steps:
            raise AssertionError(f"9g: the fit took {int(tr.state.step)} "
                                 f"steps of {steps}")
        want = [tr.state.step] + bridge.leaves(tr.state.params) + \
            bridge.leaves(tr.state.opt_state)
        start = time.perf_counter()
        proc = subprocess_lib.run(
            [sys_lib.executable, _script(root, "restore.py", GCS_RESTORE),
             root], capture_output=True, text=True, cwd=REPO_ROOT,
            timeout=PHASE_9_TIMEOUT_S)
        restore_s = time.perf_counter() - start
        if proc.returncode != 0:
            raise AssertionError(f"9g's restoring process exited "
                                 f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        listed = json.loads(proc.stdout.strip().splitlines()[-1])
        if listed != {"steps": list(range(every, steps + 1, every)),
                      "verify": "unmanifested", "extras": None}:
            raise AssertionError(f"9g: the fresh process read {listed}")
        if not _same_bits(os.path.join(root, "restored.npz"), want):
            raise AssertionError("9g: the restored state differs from the "
                                 "fit's")
        ckpt_bytes = sum(
            len(storage.bucket("chip-smoke").blob(name).download_as_bytes())
            for name in storage.objects("chip-smoke")
            if name.startswith(f"ckpt/{steps}/"))
        del tr, want

        with open(os.path.join(root, "config.pkl"), "wb") as f:
            pickle.dump((config, batch), f)
        start = time.perf_counter()
        result = local_rig.run_bootstrap(
            _script(root, "fsdp_rank.py", GCS_RANK), device=rig,
            num_processes=GCS_FIT["ranks"], args=[root],
            timeout=PHASE_9_TIMEOUT_S)
        ranks_s = time.perf_counter() - start
        for rank, one in enumerate(result.ranks):
            if one.returncode != 0:
                raise AssertionError(
                    f"9g {{fsdp: 2}} rank {rank} exited {one.returncode}:\n"
                    f"{one.stdout[-2000:]}\n{one.stderr[-4000:]}")
        outs = []
        for rank in range(GCS_FIT["ranks"]):
            with open(os.path.join(root, f"rank{rank}.json")) as f:
                outs.append(json.load(f))
        objects = storage.objects("chip-smoke")
        by_rank = {r: sum(1 for o in objects if o.startswith("fsdp/1/")
                          and o.endswith(f".r{r}.bin"))
                   for r in range(GCS_FIT["ranks"])}
        manager = checkpoint.CheckpointManager(
            "gs://chip-smoke/fsdp", device="cpu", storage_client=storage)
        restored = manager.restore(1)
        if manager.steps() != [1] or not _same_bits(
                os.path.join(root, "fsdp-params.npz"),
                bridge.leaves(restored.params)):
            raise AssertionError("9g: the one-process restore of the "
                                 "{fsdp: 2} checkpoint differs from the "
                                 "ranks' gathered parameters")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for out in outs:
        if out["mesh"] != {"fsdp": GCS_FIT["ranks"]} or not np.isfinite(
                out["loss"]):
            raise AssertionError(f"9g {{fsdp: 2}} rank: {out}")
    if not all(by_rank.values()):
        raise AssertionError(f"9g: {{fsdp: 2}} pieces by rank {by_rank}")
    launches = _gn_sum(launches, *(o["launches"] for o in outs))
    want = _gn_times(GN_PER_STEP, steps + GCS_FIT["ranks"])
    if rig == "cuda" and launches != want:
        raise AssertionError(f"9g: launches {launches}, want {want}")
    print(f"  {steps * batch} CIFAR records to gs:// in {GCS_FIT['shards']} "
          f"objects in {write_s:.2f} s; fit from RecordDataset(gs://) with a "
          f"gs:// checkpoint every {every} steps: {steps} steps in "
          f"{fit_s:.2f} s; a fresh process listed steps {listed['steps']}, "
          f"verify {listed['verify']!r}, restored step {steps} "
          f"({ckpt_bytes / 2**20:.1f} MiB) bit-equal in {restore_s:.2f} s; "
          f"{{fsdp: 2}} ranks: one step each, pieces by rank {by_rank}, "
          f"{ranks_s:.1f} s of wall, one process restored them bit-equal; "
          f"launches {launches} [{card}]")
    return {"write_s": write_s, "fit_s": fit_s, "restore_s": restore_s,
            "fsdp_wall_s": ranks_s, "checkpoint_bytes": ckpt_bytes,
            "fsdp_pieces_by_rank": by_rank, "launches": launches}


# ---------------------------------------------------------------------------
# Phase 10g: the golden workloads on the card
# ---------------------------------------------------------------------------

HELPERS = os.path.join(REPO_ROOT, "tests", "helpers")
#: 10g's ranks: the ring example over 4 (sp: 4), save_and_load and the
#: custom loop over 2.
GOLDEN_RANKS = {"ring": 4, "pair": 2}

#: Runs the ring example's copy as a bootstrap entry point and writes the
#: rank's launches (argument: the output directory).
GOLDEN_RING = """
import json, os, sys
import torch
from cloud_tpu_torch.ops import dispatch
from cloud_tpu_torch.parallel import distributed
sys.path.insert(0, os.path.join(REPO_ROOT, "tests", "helpers"))
import torch_long_context_ring_attention as example
dispatch.reset_launch_counts()
trainer = example.main()
if torch.cuda.is_available():
    torch.cuda.synchronize()
with open(os.path.join(sys.argv[1],
                       f"ring{distributed.process_index()}.json"), "w") as f:
    json.dump({"launches": dispatch.launch_counts(
                   ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
               "losses": trainer.history.history["loss"],
               "steps": int(trainer.state.step)}, f)
"""


def _load_helper(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HELPERS, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generate_text_launches(train_steps, layers_n, new_tokens):
    """K5-K7 and K8/K8q launches of the generate_text copy: K5 once a
    layer a training step (TINY runs no remat) and once a layer a prefill
    (four ``generate`` calls and the beam search's one, every prompt in
    one call), K6 and K7 once a layer a training step; K8 once a layer a
    decode step (the first token comes from the prefill) of the greedy,
    nucleus and int8-weights generations and of the beam search (every
    beam in one call), K8q of the int8 + kv_quant generation."""
    decode = new_tokens - 1
    return {"flash_fwd": layers_n * (train_steps + 5),
            "flash_bwd_dq": layers_n * train_steps,
            "flash_bwd_dkv": layers_n * train_steps,
            "paged_attention": layers_n * decode * 4,
            "paged_attention_int8": layers_n * decode}


def run_golden_phase(device, card, rig="cuda"):
    """10g: the port's copies of the golden workloads on the card.  The
    generate_text copy in this process (CloudLM TINY trained 3 epochs, then
    greedy, nucleus, a 4-beam search, int8 weights, and int8 weights with
    the int8 KV cache), its K5-K7 and K8/K8q launches exact
    (:func:`generate_text_launches`); the long-context ring example on 4
    ranks over gloo under the bootstrap (``{sp: 4}``, zig-zag, fused CE,
    remat "dots": each rank's K5 launches 2 x (2n+1) a layer a step, K6
    and K7 2n+1); ``torch_save_and_load.py`` and the custom loop
    ``torch_mnist_example_using_ctl.py`` on 2 ranks (MNIST runs no kernel
    of the port)."""
    import shutil
    import tempfile

    import torch

    from cloud_tpu_torch.models import transformer
    from cloud_tpu_torch.ops import dispatch
    from cloud_tpu_torch.utils import local_rig

    root = tempfile.mkdtemp(prefix="chip_smoke_golden_")
    out = {}
    try:
        example = _load_helper("torch_generate_text")
        _sync(device)
        dispatch.reset_launch_counts()
        start = time.perf_counter()
        trainer = example.main(device=device)
        _sync(device)
        out["generate_text_s"] = time.perf_counter() - start
        names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "paged_attention", "paged_attention_int8")
        gen_launches = dispatch.launch_counts(names)
        want = generate_text_launches(int(trainer.state.step),
                                      transformer.TINY.num_layers,
                                      new_tokens=24)
        if device.type == "cuda" and gen_launches != want:
            raise AssertionError(f"10g generate_text: launches "
                                 f"{gen_launches}, want {want}")
        out["generate_text"] = {"texts": trainer.texts,
                                "steps": int(trainer.state.step),
                                "launches": gen_launches}
        print(f"  generate_text: {int(trainer.state.step)} steps, greedy "
              f"{trainer.texts['greedy'][0]!r}, int8+kv "
              f"{trainer.texts['int8+kv'][0]!r}; launches {gen_launches} in "
              f"{out['generate_text_s']:.1f} s [{card}]")
        del trainer

        start = time.perf_counter()
        ranks = GOLDEN_RANKS["ring"]
        result = local_rig.run_bootstrap(
            _script(root, "ring.py", GOLDEN_RING), device=rig,
            num_processes=ranks, args=[root], timeout=PHASE_9_TIMEOUT_S)
        out["ring_s"] = time.perf_counter() - start
        _ranks_ok("10g ring", result)
        rings = []
        for rank in range(ranks):
            with open(os.path.join(root, f"ring{rank}.json")) as f:
                rings.append(json.load(f))
        calls = 2 * ranks + 1  # the zig-zag ring's hops, each way
        per = {"flash_fwd": 2 * calls, "flash_bwd_dq": calls,
               "flash_bwd_dkv": calls}
        for rank, ring in enumerate(rings):
            want_ring = {k: v * transformer.TINY.num_layers * ring["steps"]
                         for k, v in per.items()}
            if rig == "cuda" and ring["launches"] != want_ring:
                raise AssertionError(f"10g ring rank {rank}: launches "
                                     f"{ring['launches']}, want {want_ring}")
        out["ring"] = rings
        print(f"  long-context ring example on {ranks} ranks ({{sp: "
              f"{ranks}}}): losses {[round(v, 4) for v in rings[0]['losses']]}"
              f", {out['ring_s']:.1f} s of wall; launches a rank "
              f"{rings[0]['launches']} [{card}]")

        for name, env in (
                ("torch_save_and_load",
                 {"SAVE_AND_LOAD_DIR": os.path.join(root, "ckpt")}),
                ("torch_mnist_example_using_ctl",
                 {"MNIST_CTL_EPOCHS": "1",
                  "MNIST_CTL_SAVE_DIR": os.path.join(root, "ctl")})):
            start = time.perf_counter()
            result = local_rig.run_bootstrap(
                os.path.join(HELPERS, name + ".py"), device=rig,
                num_processes=GOLDEN_RANKS["pair"], extra_env=env,
                timeout=PHASE_9_TIMEOUT_S)
            _ranks_ok(f"10g {name}", result)
            out[name + "_s"] = time.perf_counter() - start
            tail = result.stdout.strip().splitlines()[-1:]
            print(f"  {name} on {GOLDEN_RANKS['pair']} ranks: {tail} "
                  f"({out[name + '_s']:.1f} s of wall) [{card}]")
        with np.load(os.path.join(root, "ctl", "params.npz")) as saved:
            if sorted(saved.files) != ["hidden/bias", "hidden/kernel",
                                       "out/bias", "out/kernel"]:
                raise AssertionError(f"10g ctl saved {saved.files}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {k: gen_launches.get(k, 0) + sum(
        r["launches"].get(k, 0) for r in rings)
        for k in set(gen_launches) | set(rings[0]["launches"])}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _ranks_ok(what, result):
    for rank, one in enumerate(result.ranks):
        if one.returncode != 0:
            raise AssertionError(f"{what} rank {rank} exited "
                                 f"{one.returncode}:\n{one.stdout[-2000:]}\n"
                                 f"{one.stderr[-4000:]}")


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


#: Phases run in a second process, started once the kernels are built and
#: timed (after phase 2c), beside the main process's phases 3 to 8v: each
#: drives its path through processes of its own (gloo ranks, containers,
#: workers, cold and warm children) or counts its launches from 0 in this
#: process, so neither process reads the other's counts.  (title, name,
#: function of (device, card), run under no_grad)
SIDE_PHASES = (
    ("phase 3tp: tensor-parallel serving at tp 2, two ranks on the card "
     "over gloo (SMALL bf16 and f32, kv_quant, prefix hit and chunked "
     "prefill); the mesh path at tp 1", "tp engine", "run_tp_engine", True),
    ("phase 4r: exactly-once resume, the kill -9 drill and the non-finite "
     "guard, f32 ResNet-50 CIFAR b8", "exactly-once", "check_exactly_once",
     False),
    ("phase 4k: a cold and a warm process through one "
     "CLOUD_TPU_COMPILE_CACHE directory", "cold start", "run_cold_start",
     False),
    ("phase 9r: cloud_tpu_torch.run() -> the build context -> deploy's "
     "startup script -> the image's ENTRYPOINT (the bootstrap) -> "
     "Trainer.fit of ResNet-50 CIFAR b256 bf16 on the card", "front door",
     "run_front_door", False),
    ("phase 9m: the exporter: the native library and its C tests, the "
     "bootstrap exporting a training run", "exporter", "run_exporter_phase",
     False),
    ("phase 9t: tuner.dispatch_search of 2 workers -> each job's build "
     "context and startup script, booted together on the card -> one local "
     "study of 4 ResNet-50 CIFAR b256 bf16 trials (2 epochs x 3 steps)",
     "tuner", "run_tuner_phase", False),
    ("phase 9f: cloud_tpu_torch.cloud_fit of ResNet-50 CIFAR b256 bf16 -> "
     "its ENTRYPOINT on two emulated hosts under run()'s {dp: 2} over gloo "
     "-> that checkpoint restored into {fsdp: 2} shards -> the sharded "
     "checkpoint restored by a one-process remote.run", "cloud_fit",
     "run_cloud_fit_phase", False),
    (f"phase 6mesh: train CloudLM SMALL b{MESH_BATCH}xT{MESH_SEQ} under "
     "2-rank meshes on the card over gloo ({sp: 2} zig-zag and Ulysses, "
     "{tp: 2}, {fsdp: 2} in f32 against one process; zig-zag in bf16)",
     "mesh training", "run_mesh_training", False),
    ("phase 6pp: train CloudLM SMALL under the GPipe pipeline and expert "
     "parallelism, 2 ranks on the card over gloo ({pp: 2} b4 M=2 untied "
     "and tied, the default MoE under {ep: 2} b2 and {pp: 2} b4, in f32 "
     "against one process; {pp: 2} in bf16)", "pipeline training",
     "run_pipeline_training", False),
    ("phase 6enc: BERT-base b32xT128 (ragged padding) and ViT-B/16 224 b8 "
     "under {tp: 2}, {sp: 2} and {fsdp: 2} in f32 against one process, "
     "{tp: 2} in bf16; MNIST and ResNet-50 CIFAR under {tp: 2}; 2 ranks on "
     "the card over gloo", "encoder mesh", "run_encoder_mesh", False),
    ("phase 9g: the gs:// paths on a directory-backed storage client: "
     "records written to gs://, ResNet-50 CIFAR b256 bf16 fit from "
     "RecordDataset(gs://) checkpointing to gs:// every 2 steps, a fresh "
     "process's restore, two {fsdp: 2} ranks saving to the same bucket",
     "gcs", "run_gcs_phase", False),
    ("phase 10g: the golden workloads on the card: the generate_text copy "
     "(TINY trained, then greedy, nucleus, beam 4, int8, int8 + kv_quant), "
     "the long-context ring example on 4 ranks ({sp: 4}), save_and_load and "
     "the custom loop on 2 ranks", "golden", "run_golden_phase", False),
)

#: The second process must have ended this many seconds after the script
#: started (the whole run's limit is 1200 s).
SIDE_DEADLINE_S = 1080


def _on_host(obj):
    """``obj`` with every tensor in it moved to the CPU (for the pickle the
    second process hands back)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _on_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_on_host(v) for v in obj)
    return obj


def side_main(out_dir: str) -> int:
    """The second process: run ``SIDE_PHASES`` in order on the card and
    pickle their results to ``out_dir/results.pkl``."""
    import contextlib
    import pickle

    import torch

    from cloud_tpu_torch.ops import dispatch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dispatch.build_all()  # built by the main process: loaded, not rebuilt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for title, what, name, no_grad in SIDE_PHASES:
        print(title, flush=True)
        start = time.perf_counter()
        try:
            with torch.no_grad() if no_grad else contextlib.nullcontext():
                results[what] = globals()[name](device, card)
        except Exception as exc:  # noqa: BLE001 — reported, exit nonzero
            return fail(f"{what}: {exc!r}", title)
        torch.cuda.empty_cache()
        print(f"  ({what}: {time.perf_counter() - start:.1f} s wall)",
              flush=True)
    with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
        pickle.dump(_on_host(results), f)
    return 0


class SidePhases:
    """The second process of ``SIDE_PHASES``: started beside the main
    phases, waited for at the end, its output printed then; stopped, with
    every process of its session, if the main process ends first."""

    def __init__(self):
        self.proc = None
        self.dir = None
        self.log = None

    def start(self) -> None:
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_side_")
        self.log = open(os.path.join(self.dir, "side.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--side", self.dir],
            stdout=self.log, stderr=subprocess.STDOUT, cwd=REPO_ROOT,
            start_new_session=True)
        print(f"  (phases {', '.join(t.split(':')[0][6:] for t, *_ in SIDE_PHASES)}"
              f" run in a second process beside phases 3-8v, pid "
              f"{self.proc.pid})", flush=True)

    def _print_log(self, heading: str) -> None:
        self.log.flush()
        with open(self.log.name) as f:
            text = f.read()
        print(heading)
        print(text, end="" if text.endswith("\n") else "\n", flush=True)

    def finish(self, deadline: float) -> dict:
        """Wait for the process until ``deadline`` (``time.perf_counter``),
        print its output and return its phases' results."""
        import pickle

        start = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=max(1.0, deadline - start))
        except subprocess.TimeoutExpired:
            self.stop()
            raise AssertionError(
                f"the second process had not ended {SIDE_DEADLINE_S} s "
                "after the start") from None
        self._print_log(f"second process (phases run beside 3-8v; waited "
                        f"{time.perf_counter() - start:.1f} s for it at the "
                        "end):")
        if rc != 0:
            raise AssertionError(f"the second process exited {rc}")
        with open(os.path.join(self.dir, "results.pkl"), "rb") as f:
            return pickle.load(f)

    def stop(self) -> None:
        import shutil
        import signal

        if self.proc is None:
            return
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.proc.wait()
            self._print_log("second process stopped; its output:")
        self.proc = None
        self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


_SIDE = SidePhases()


def main() -> int:
    try:
        return _main()
    finally:
        _SIDE.stop()


def _main() -> int:
    script_start = time.perf_counter()
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
        ("phase 2 (chunks): K8 and K8q at prefill-chunk query counts "
         "(several query tiles)", "paged chunk check",
         lambda: check_paged_chunks(device, card), True),
        ("phase 2 (verify): K8 and K8q at the speculative verify shape "
         "(B=8, Tq=4)", "paged verify check",
         lambda: check_paged_verify(device, card), True),
        ("phase 2 (tp): K5, K8 and K8q at a tp-2 rank's head count (6 of "
         "SMALL's 12, heads a strided view of a full-width projection)",
         "tp kernel check", lambda: check_tp_kernels(device, card), True),
        ("phase 2 (ring): the ring's K5 folds and K6/K7 hops for every "
         "rank (n=2/4: causal with empty blocks, non-causal, zig-zag), "
         "assembled, against one whole-sequence call and the plain version",
         "ring check", lambda: check_ring(device, card), False),
        ("phase 2 (pp): K5, K6 and K7 at phase 6pp's call shape (a "
         "pipeline microbatch and an ep rank's rows, B=2 T=1024, 12 heads) "
         "against their plain versions, then timed", "pp kernel check",
         lambda: check_pp_kernels(device, card), False),
        ("phase 2 (enc): K5, K6 and K7 at phase 6enc's new call shapes (a "
         "BERT-base tp rank's 6 heads and an sp block of 64 positions, both "
         "masked; a ViT-B/16 tp rank's 6 heads at T=196) against their plain "
         "versions, then timed", "enc kernel check",
         lambda: check_enc_kernels(device, card), False),
        ("phase 2b: K1-K4 (GroupNorm) against their plain versions",
         "group_norm check", lambda: check_group_norm(device, card), False),
        ("phase 2c: K5 and K6/K7 (flash backward) against their plain "
         "versions; K5, K6, K7 timed at the training shapes",
         "flash_bwd check",
         lambda: check_flash_bwd(device, card), False),
        # The kernels are timed: the second process starts here.
        (None, None, _SIDE.start, False),
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
        ("phase 3g: ServingEngine scheduler='batch', bench.py's "
         "_measure_serving config", "batch engine",
         lambda: run_batch_engine(device, card), True),
        ("phase 3p: prefix cache + chunked prefill, copy and attach routes, "
         "bench.py's serving_prefix config", "prefix engine",
         lambda: run_prefix_engine(device, card), True),
        ("phase 3t: the prefix cache's host-DRAM tier off and on, "
         "bench.py's serving_prefix_tier config", "tier engine",
         lambda: run_tier_engine(device, card), True),
        ("phase 3s: speculative decoding (no draft, a 3-layer draft, the "
         "target as its own draft), bench.py's serving_spec config",
         "spec engine", lambda: run_spec_engine(device, card), True),
        ("phase 3k: decode_kernel 'xla' against 'auto', bench.py's "
         "serving_decode_kernel config", "decode kernel engine",
         lambda: run_decode_kernel_engine(device, card), True),
        ("phase 3w: pipeline_depth 1 against 2 (plain, with a 3-layer "
         "draft, with kv_quant), bench.py's serving_pipeline config",
         "pipeline engine", lambda: run_pipeline_engine(device, card), True),
        ("phase 3n: the serving spans of phase 3w's arms against their "
         "engines' counts", "pipeline tracing",
         lambda: check_pipeline_tracing(results["pipeline engine"], card),
         True),
        ("phase 3o: QoS classes with streaming and on_token hooks",
         "qos engine", lambda: run_qos_engine(device, card), True),
        ("phase 3f: a 2-replica Fleet on the churn workload, bench.py's "
         "fleet config", "fleet", lambda: run_fleet(device, card), True),
        ("phase 3v: open-loop QPS sweep through a 2-replica QoS Fleet, "
         "bench.py's fleet_qps_sweep config", "fleet sweep",
         lambda: run_fleet_qps_sweep(device, card), True),
        ("phase 3x: colocated against disaggregated prefill/decode with the "
         "KV handoff, bench.py's fleet_disagg config", "fleet disagg",
         lambda: run_fleet_disagg(device, card), True),
        ("phase 3m: ServingEngine, CloudLM SMALL with MoE (8 experts, top "
         "2), 16 requests in bf16 and in int8 + kv_quant, f32 parity, a "
         "pretrained bundle", "moe engine",
         lambda: run_moe_engine(device, card), True),
        ("phase 4: train ResNet-50 CIFAR b256 bf16, 3 + 20 steps",
         "CIFAR training", lambda: run_training(
             device, card, imagenet=False, warmup=3, iters=20), False),
        ("phase 4b: one f32 step, card against CPU", "f32 step parity",
         lambda: check_train_parity(device, card), False),
    ]
    results = {}
    for title, what, fn, no_grad in phases:
        if title is None:
            fn()
            continue
        print(title)
        start = time.perf_counter()
        try:
            if no_grad:
                with torch.no_grad():
                    results[what] = fn()
            else:
                results[what] = fn()
        except Exception as exc:  # noqa: BLE001 — reported, exit nonzero
            return fail(f"{what}: {exc!r}", title)
        print(f"  ({what}: {time.perf_counter() - start:.1f} s wall)")
    cifar, cifar_run = results.pop("CIFAR training")
    title = "phase 4c: one ResNet-50 CIFAR step under torch.profiler"
    try:
        print(title)
        cifar.update(profile_train_step(card, *cifar_run))
        del cifar_run
        torch.cuda.empty_cache()
        title = ("phase 4f: multi-step windows as CUDA graphs against eager "
                 "steps, then ResNet-50 CIFAR b256 bf16 in windows of "
                 f"{FUSED_K}, {FUSED_WARMUP} + {FUSED_MEASURE} windows")
        print(title)
        start = time.perf_counter()
        fused_checks = check_fused_windows(device, card)
        fused = run_fused_training(device, card, cifar["steps_per_s"])
        torch.cuda.empty_cache()
        print(f"  (fused windows: {time.perf_counter() - start:.1f} s wall)")
        title = ("phase 4t: Trainer.fit, ResNet-50 CIFAR b256 bf16, 12 "
                 "batches one step a dispatch, 12 and 10 in windows of "
                 f"{FUSED_K}, with validation, prefetch and checkpoints")
        print(title)
        start = time.perf_counter()
        fit = run_trainer_fit(device, card, cifar["steps_per_s"],
                              fused["steps_per_s"])
        print(f"  (fit: {time.perf_counter() - start:.1f} s wall)")
        title = ("phase 4s: a save followed at once by 4 steps restores the "
                 "state at the save, eager and in a window")
        print(title)
        start = time.perf_counter()
        ordering = check_save_ordering(device, card)
        print(f"  (save ordering: {time.perf_counter() - start:.1f} s wall)")
        title = ("phase 4d: bench.py's durability probe on the CIFAR b256 "
                 "state")
        print(title)
        start = time.perf_counter()
        durability = run_durability_probe(device, card)
        print(f"  (durability: {time.perf_counter() - start:.1f} s wall)")
        title = ("phase 4a: Trainer.fit(compile_ahead=True), ResNet-50 "
                 "CIFAR b256 bf16: one step a dispatch, windows of "
                 f"{FUSED_K}, a registry hit, batch_spec=; then a one-step "
                 "graph against eager steps")
        print(title)
        start = time.perf_counter()
        ahead = run_compile_ahead(device, card, fit)
        print(f"  (compile-ahead: {time.perf_counter() - start:.1f} s wall)")
        title = ("phase 4p: the record pipeline: CIFAR b256 as tensor "
                 "records, fit over RecordDataset, exactly-once resume")
        print(title)
        start = time.perf_counter()
        recs = run_records_fit(device, card, fit)
        print(f"  (records: {time.perf_counter() - start:.1f} s wall)")
        title = ("phase 9p: the profiler: ProfilerCallback over a ResNet "
                 "fit, a memory snapshot, one on-demand server capture")
        print(title)
        start = time.perf_counter()
        prof_run = run_profiler_phase(device, card)
        print(f"  (profiler: {time.perf_counter() - start:.1f} s wall)")
        title = ("phase 5: train ResNet-50 224 b128 bf16, 3 + 5 steps, then "
                 "one step under torch.profiler")
        print(title)
        at_224, run_224 = run_training(device, card, imagenet=True,
                                       warmup=3, iters=5)
        at_224.update(profile_train_step(card, *run_224))
        del run_224
        torch.cuda.empty_cache()
    except Exception as exc:  # noqa: BLE001
        return fail(f"ResNet training: {exc!r}", title)
    try:
        title = (f"phase 6: train CloudLM SMALL b{LM_BATCH}xT{LM_SEQ} bf16, "
                 f"plain CE, 3 + 10 steps")
        print(title)
        lm, lm_run = run_lm_training(device, card, fused_ce=False, warmup=3,
                                     iters=10)
        title = "phase 6c: one LM step (plain CE) under torch.profiler"
        print(title)
        lm.update(profile_attn_step(card, f"LM b{LM_BATCH}xT{LM_SEQ}",
                                    LM_PER_STEP, *lm_run))
        del lm_run
        torch.cuda.empty_cache()
        title = "phase 6 (A/B): the same with fused_ce, 3 + 5 steps"
        print(title)
        lm_fused, _ = run_lm_training(device, card, fused_ce=True, warmup=3,
                                      iters=5)
        torch.cuda.empty_cache()
        print(f"  fused-CE A/B: plain {lm['steps_per_s']:.3f} steps/s, "
              f"{lm['max_memory_allocated'] / 2**30:.3f} GiB; fused_ce "
              f"{lm_fused['steps_per_s']:.3f} steps/s, "
              f"{lm_fused['max_memory_allocated'] / 2**30:.3f} GiB [{card}]")
        title = "phase 6b: f32 gradients of SMALL (2 layers), card against CPU"
        print(title)
        lm_parity = check_lm_grad_parity(device, card)
        title = (f"phase 6m: train CloudLM SMALL with MoE b{LM_BATCH}xT"
                 f"{LM_SEQ} bf16, 3 + 5 steps, one profiled; an f32 step "
                 "card against CPU")
        print(title)
        start = time.perf_counter()
        moe_lm = run_moe_training(device, card)
        print(f"  (MoE LM: {time.perf_counter() - start:.1f} s wall)")
        title = (f"phase 6d: SMALL b{LM_BATCH}xT{LM_SEQ} under remat none, "
                 "full and dots; a dots window against eager steps")
        print(title)
        start = time.perf_counter()
        dots = run_remat_dots(device, card)
        print(f"  (remat dots: {time.perf_counter() - start:.1f} s wall)")
        title = (f"phase 7: train BERT-base b{BERT_BATCH}xT{BERT_SEQ} bf16, "
                 f"3 + 10 steps, then one step under torch.profiler")
        print(title)
        bert_run, bert_steps = run_bert_training(device, card, warmup=3,
                                                 iters=10)
        bert_run.update(profile_attn_step(
            card, f"BERT b{BERT_BATCH}xT{BERT_SEQ}", BERT_PER_STEP,
            *bert_steps))
        del bert_steps
        torch.cuda.empty_cache()
        title = (f"phase 7s: stochastic BERT-base b{BERT_BATCH}xT{BERT_SEQ} "
                 f"bf16, dropout {BERT_DROPOUT}, masked AdamW, 3 + 10 steps "
                 "and one profiled; card against CPU at b2, a window "
                 "against eager steps")
        print(title)
        start = time.perf_counter()
        stoch = run_stochastic_bert(device, card, bert_run)
        print(f"  (stochastic BERT: {time.perf_counter() - start:.1f} s "
              "wall)")
        title = (f"phase 8v: train ViT-B/16 224 b{VIT_BATCH} bf16, 3 + 10 "
                 "steps, one profiled; K5-K7 at T=196/197; an f32 step card "
                 "against CPU")
        print(title)
        start = time.perf_counter()
        vit_run = run_vit_training(device, card)
        print(f"  (ViT: {time.perf_counter() - start:.1f} s wall)")
    except Exception as exc:  # noqa: BLE001
        return fail(f"transformer training: {exc!r}", title)
    try:
        side = _SIDE.finish(script_start + SIDE_DEADLINE_S)
    except Exception as exc:  # noqa: BLE001
        return fail(f"second process: {exc!r}", "the second process")
    results["tp engine"] = side["tp engine"]
    exact, cold = side["exactly-once"], side["cold start"]
    front_door, exporter_run = side["front door"], side["exporter"]
    tuner_run, fit_run = side["tuner"], side["cloud_fit"]
    mesh_run, pp_run = side["mesh training"], side["pipeline training"]
    enc_run, gcs_run, golden = (side["encoder mesh"], side["gcs"],
                                side["golden"])

    engine = results["engine"]
    engine.update(results["decode breakdown"])
    flash_bwd, k5_training, k5_worst = results["flash_bwd check"]
    kernels = (results["kernel check"] + flash_bwd
               + results["group_norm check"])
    k5 = next(e for e in kernels if e["name"] == "flash_fwd")
    k5["max_abs_err"] = max(k5["max_abs_err"], k5_worst["bfloat16"])
    k5["max_abs_err_f32"] = max(k5["max_abs_err_f32"], k5_worst["float32"])
    for entry in kernels:
        vit_worst = vit_run["flash_worst"].get(entry["name"])
        if vit_worst is not None:
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       vit_worst["bfloat16"])
            entry["max_abs_err_f32"] = max(entry["max_abs_err_f32"],
                                           vit_worst["float32"])
    engine_q = results["quantized engine"]
    chunks = results["paged chunk check"]
    verify = results["paged verify check"]
    tp_kernels = results["tp kernel check"]
    ring_check = results["ring check"]
    pp_kernels = results["pp kernel check"]
    enc_kernels = results["enc kernel check"]
    for entry in kernels:
        for dname, key in (("bfloat16", "max_abs_err"),
                           ("float32", "max_abs_err_f32")):
            for errs in (chunks["max_abs_err"], verify["max_abs_err"],
                         tp_kernels["max_abs_err"],
                         ring_check["max_abs_err"],
                         pp_kernels["max_abs_err"],
                         enc_kernels["max_abs_err"]):
                err = errs.get(f"{entry['name']} {dname}")
                if err is not None:
                    entry[key] = max(entry[key], err)
    # A serving kernel's launches: the sum over the serving phases, each
    # counted from 0 just before its run and read just after.
    serving = {"engine": engine, "quantized engine": engine_q,
               "batch engine": results["batch engine"],
               "prefix engine": results["prefix engine"],
               "tier engine": results["tier engine"],
               "spec engine": results["spec engine"],
               "decode kernel engine": results["decode kernel engine"],
               "pipeline engine": results["pipeline engine"],
               "qos engine": results["qos engine"],
               "fleet": results["fleet"],
               "fleet sweep": results["fleet sweep"],
               "fleet disagg": results["fleet disagg"],
               "moe engine": results["moe engine"],
               # Both ranks of the tp-2 slice.
               "tp engine": results["tp engine"]}
    # K5-K7 also run in the training phases of the model zoo (6m, 6d, 8v),
    # under a mesh (6mesh, 6pp and 6enc, both ranks) and in the golden
    # workloads (10g: generate_text's training and decoding, K8 and K8q
    # too, and the ring example's 4 ranks).
    zoo_training = (moe_lm, dots, vit_run, mesh_run, pp_run, enc_run,
                    golden)
    by_phase = {name: {what: phase["launches"].get(name, 0)
                       for what, phase in serving.items()}
                for name in QUANT_SERVING_KERNELS}
    for entry in kernels:
        name = entry["name"]
        if name in by_phase:
            # K5 also runs in 7s's stochastic BERT steps and the zoo's
            # training phases.
            entry["launches"] = (sum(by_phase[name].values())
                                 + stoch["launches"].get(name, 0)
                                 + sum(r["launches"].get(name, 0)
                                       for r in zoo_training))
        elif name in FLASH_BWD_KERNELS:
            entry["launches"] = (lm["launches"][name]
                                 + stoch["launches"][name]
                                 + sum(r["launches"][name]
                                       for r in zoo_training))
        else:
            # K1-K4: the bare loop (4), Trainer.fit (4t), the
            # exactly-once fits (4r), compile-ahead (4a), the records
            # fits (4p), the container of the front door (9r), the
            # tuner's workers (9t), cloud_fit's ranks and restoring run
            # (9f), the gs:// fit and ranks (9g) and ResNet's tp arm
            # (6enc), each counted from 0.
            entry["launches"] = (cifar["launches"][name]
                                 + fit["launches"][name]
                                 + exact["launches"][name]
                                 + ahead["launches"][name]
                                 + recs["launches"][name]
                                 + front_door["launches"][name]
                                 + tuner_run["launches"][name]
                                 + fit_run["launches"][name]
                                 + gcs_run["launches"][name]
                                 + enc_run["launches"][name])
        if entry["launches"] <= 0:
            return fail(f"kernel {name} was not launched on its path",
                        "kernel line")
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
        "serving_launches_by_phase": by_phase,
        "paged_chunks": chunks,
        "paged_verify": verify,
        "engine": {k: v for k, v in engine.items() if k != "launches"},
        "engine_int8_kv_quant": engine_q,
        "engine_batch": results["batch engine"],
        "engine_prefix": results["prefix engine"],
        "engine_prefix_tier": results["tier engine"],
        "engine_spec": {k: v for k, v in results["spec engine"].items()
                        if k != "launches"},
        "engine_decode_kernel": results["decode kernel engine"],
        "engine_pipeline": results["pipeline engine"],
        "pipeline_spans": results["pipeline tracing"],
        "engine_qos": results["qos engine"],
        "fleet": results["fleet"],
        "fleet_qps_sweep": results["fleet sweep"],
        "fleet_disagg": results["fleet disagg"],
        "decode_quant_ab": results["decode A/B"],
        "beam_search_int8_kv_quant": results["beam search"],
        "resnet50_cifar_b256": {k: v for k, v in cifar.items()
                                if k != "launches"},
        "resnet50_224_b128": {k: v for k, v in at_224.items()
                              if k != "launches"},
        "f32_step_parity": results["f32 step parity"],
        "fused_cifar_b256": fused,
        "fused_window_checks": fused_checks,
        "trainer_fit_cifar_b256": fit,
        "save_ordering": ordering,
        "durability": durability,
        "exactly_once": exact,
        "compile_ahead": ahead,
        "cold_start": cold,
        "records_fit": recs,
        "front_door": front_door,
        "profiler": prof_run,
        "exporter": exporter_run,
        "tuner": {k: v for k, v in tuner_run.items() if k != "launches"},
        "cloud_fit": {k: v for k, v in fit_run.items() if k != "launches"},
        "stochastic_bert_b32xT128": stoch,
        "flash_bwd_at_bert": {e["name"]: e["at_bert"] for e in flash_bwd},
        "flash_fwd_at_training": k5_training,
        "lm_b4xT1024": {"plain": lm, "fused_ce": lm_fused},
        "lm_f32_grad_parity": lm_parity,
        "moe_engine": {k: v for k, v in results["moe engine"].items()
                       if k != "launches"},
        "tp_rank_kernels": tp_kernels["rows"],
        "ring_block_kernels": ring_check["rows"],
        "pp_microbatch_kernels": pp_kernels["rows"],
        "encoder_rank_kernels": enc_kernels["rows"],
        "encoder_mesh_training": {
            name: {rank: {k: v for k, v in r.items() if k != "metrics"}
                   for rank, r in arm.items()}
            for name, arm in enc_run["arms"].items()},
        "gcs": gcs_run,
        "golden": {k: v for k, v in golden.items() if k != "launches"},
        "mesh_training": {name: {rank: {k: v for k, v in r.items()
                                        if k != "metrics"}
                                 for rank, r in arm.items()}
                          for name, arm in mesh_run["arms"].items()},
        "pipeline_training": {name: {rank: {k: v for k, v in r.items()
                                            if k != "metrics"}
                                     for rank, r in arm.items()}
                              for name, arm in pp_run["arms"].items()},
        "engine_tp2": {k: v for k, v in results["tp engine"].items()
                       if k != "launches"},
        "moe_lm_b4xT1024": moe_lm,
        "remat_dots": dots,
        "vit_b16_b128": {k: v for k, v in vit_run.items()
                         if k != "flash_worst"},
        "flash_bwd_at_vit": {e["name"]: e["at_vit"] for e in flash_bwd},
        "bert_base_b32xT128": bert_run,
        "tensor_core_sass": sass}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--side"]:
        sys.exit(side_main(sys.argv[2]))
    sys.exit(main())
