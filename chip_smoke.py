#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card, a few minutes
    python3 chip_smoke.py --zoo-grads 6   # the train phases' gradient
                                          # check on 6 seeds, ungated

Phases, each printing JSON lines:

1. env        card name and power limit (nvidia-smi), torch and CUDA versions;
              TF32 off so float32 products are float32.
2. build      every CUDA source of the port compiled with nvcc for sm_90a,
              all at once (``repro_torch.kernels._build``), with ptxas's
              registers, spills and C75xx notes per library.
2b. examples the reference's examples as ported (``examples_torch/``), on
              the card at their reduced sizes with attention through the
              kernels (``flash``, as they take on a card), before any
              other phase allocates (their Chameleon budget is 30 MiB):
              quickstart (the loss falls, the stages go WarmUp ->
              GenPolicy -> Stable), adaptive_swap_demo (a seq-change
              transition, no failures) and serve_batched (every request
              finishes), each making its own assertions; K1 (forward and
              backward) and K3 launched.  Line ``examples``.  Then (12d,
              each on an emptied card) train_e2e at its full deliverable
              preset (E2E_ARGS: 100m, 12 layers, d 768, f32, 8 x 256
              tokens) under the lowest budget a policy meets for its grad
              dispatch + CHAM_EXEC_MARGIN: E2E_STEPS steps with an eval
              and a checkpoint every E2E_EVERY, the over-subscribed
              serving burst, ``--trace-out`` / ``--metrics-out`` through
              the validators; then ``--resume`` for E2E_RESUME_STEPS more
              (it must print "resumed at step 12" and end at 18), held to
              what tests/test_torch_examples.py holds on the CPU, with a
              policy of entries run under the budget; then
              elastic_restart (its own rtol 1e-5, and the largest
              relative difference it leaves).  Line ``examples_12d`` with
              each run's seconds and K1 / K3 / K2a / K2b launches, then
              a ``seconds`` line.
3. kernel     the flash-attention kernel (K1) against its plain PyTorch
              version on the card, on inputs whose softmax is peaked: the
              reference kernel test sweep, a GQA case, kv_lens cases and
              llama2-paper's prefill shapes (every prompt length the serve
              phase sends, in bf16, and three timed lengths in both
              dtypes), held to the limits at TOL / FRO_TOL / MAX_TOL below;
              device times (CUDA graphs) of the kernel, the plain version
              and SDPA as a yardstick, K1 / SDPA, and the bound; then K1
              and SDPA cold (``k1_cold_ms``: one launch per layer's own q,
              k, v) at S 901 over 32 layers and at the training shape.
3b. kernel_bwd  K1's backward against its plain version on the card, dq,
              dk and dv each held to BWD_FRO_TOL / BWD_MAX_TOL and the
              forward's lse to BWD_LSE_TOL: the reference sweep, causal
              with Sq != Sk both ways, kv_lens with a batch row of no valid
              key, GQA, head dims 16 to 128, both dtypes, and the training
              shape (2 x 2048 tokens, 32 heads of 128, causal, bf16); every
              case launched twice, and the two results must be bit-equal
              (the kernels use no atomics).  Timed at the training shape
              warm and cold beside its plain version, SDPA's backward (its
              kernels' device time, ``profiled_device_ms``) and the bound
              (``attention_bwd_bound``), with the TFLOP/s attained.
4. quant      the int8 quantize (K2a) and dequantize (K2b) kernels against
              their plain versions, bit for bit (``torch.equal`` on payload,
              scales and output): the reference sweep shapes, ragged row
              counts, and the KV spill's own case, a strided slot row of a
              (32, 4, 1024, 32, 128) bf16 cache, which must take K2a's
              vector kernel (``quant_path``); device times (CUDA graphs)
              of each kernel and its plain version there, the bound, and
              for K2b a library yardstick (``torch.mul`` into the row).
5. decode_kernel  the flash-decode kernel (K3) against its plain version in
              both dtypes, K1's limits: the reference sweep, GQA, a zero
              length, split boundaries, and llama2-paper's decode shape (a
              (4, 1024, 32, 128) layer cache) at ragged lens and at the
              serve phase's first tick, timed there beside its plain
              version, SDPA with a length mask, and the bound, warm (one
              layer's cache replayed) and cold (``decode_cold_ms``: one
              launch per layer of a 32-layer cache).  Every case also with
              the row's log-sum-exp (``return_lse``, the ``kv_seq`` cache's
              merge): the output equal to the call without it and the lse
              against the plain version's (BWD_LSE_TOL, -inf on the empty
              rows); its time (``lse_ms``) at the timed shape.
6. ssd_kernel the SSD-scan kernel (K4) against its plain version, y and the
              final state, at mamba2-780m's widths for prefill lengths 77,
              384 and 901 in both dtypes (SSD_TOL); bf16 timed beside its
              plain version, with the tensor-core bound (``ssd_bound``),
              the f32-FMA bound (``bound_f32_ms``) and the device kernels
              one call launches (``passes``, torch.profiler).
6b. ssd_bwd_kernel  K4's backward (``ssd_scan_bwd``) against its plain
              version (``ssd_scan_bwd_plain``, f32 on the same inputs) at
              mamba2-780m's and zamba2-1.2b's train shapes (2 x 2048, bf16),
              a ragged length, one chunk, and f32 cases (SSD_BWD_CASES,
              SSD_BWD_TOL); every case launched twice and the two results
              bit-equal; the forward that saved the states (the saved
              layout a train step launches) held to its plain version on
              the same inputs (SSD_TOL); the train shapes timed warm and
              cold beside the
              plain version and the bound (``ssd_bwd_bound``), with each
              pass's device time, and the forward that keeps the states
              timed there warm and cold beside its bound (``ssd_bound``).
6c. kernel_d64  K1's forward and backward and K3 at head dim 64 against
              their plain versions (K1's limits): granite-moe's prefill
              shapes, the zoo's train shapes (32 x 32 and 16 over 8 heads,
              timed, both dtypes) and granite's decode shape (timed warm
              and cold).
7. serve      ``repro_torch.launch.serve.main`` on full-width llama2-paper
              (bf16, random weights from a seed) with ``--attn-impl flash``:
              8 requests, 4 slots, prompts of 65..900 tokens, 32 new tokens
              each.  K1's and K3's launch counts are reset just before and
              must equal prefills x layers and decode ticks x layers just
              after.
8. serve_spill the same run with ``--max-active 8``: 8 requests over the 4
              slots, preempted slots parked in pinned host memory and
              rotated back every tick.  Raw spill (``--spill-compression
              none``) must emit exactly the resident run's tokens; the int8
              run must complete every request with K2a launched twice per
              spill and K2b twice per restore (counts reset just before).
9. crosscheck prefill of two of those prompts with ``flash`` and ``chunked``
              attention on the same weights, then 4 decode ticks of each
              from one prefill state; logits must agree within the bf16
              tolerance below.
10. profile   ``torch.profiler`` over 4 prefills and 8 decode ticks of the
              same server, then 8 more ticks with the chunked decode of the
              reference (the path before K3): device busy time, idle
              share, top kernels, and K3's device time per call in situ.
11. spill     on a full-width server, one slot spilled (raw, then int8) and
              overwritten on the compute stream at once, then restored into
              another slot: raw must come back ``torch.equal`` (K/V rows and
              pos), int8 within half a quantization step plus one bf16
              rounding of every element.
12. calibrate ``HostMemTier.calibrate`` on the card: the host link's curve,
              size -> GB/s in each direction.
13. serve_ssm ``serve.main`` on full-width mamba2-780m (bf16, random weights
              from a seed), 8 requests as in serve; K4's launch count must
              equal prefills x 48 layers.
14. ssm_crosscheck  mamba2-780m prefill logits of a 64-token prompt against
              token-by-token decode, in f32 and in bf16 (limits below), and
              a profile of its serving loop.
14b. serve_moe ``serve.main`` on full-width granite-moe-1b-a400m (flash),
              the serve phase's traffic; K1 launches = prefills x 24, K3 =
              ticks x 24.
14c. serve_zoo  (run after 18c) ``serve.main`` on each of the five
              configurations no other phase serves, at full width and depth
              (SERVE_ZOO: llama3.2-1b through the CLI's default, with no
              ``--arch``; qwen1.5-0.5b, stablelm-1.6b, qwen2-7b, then
              qwen3-moe-30b-a3b, 61.1 GB of bf16 weights, on a card emptied
              first), the serve phase's traffic: every request completes
              with 32 tokens, K1 = prefills x layers, K3 = ticks x layers;
              then flash against chunked logits on the same weights at two
              prefills and CROSSCHECK_TICKS decode ticks
              (``phase_crosscheck``, CROSSCHECK_TOL).  Lines ``serve_zoo``
              (tokens/s, tick and prefill ms, peak memory),
              ``crosscheck`` / ``crosscheck_decode`` (with ``arch``),
              ``serve_zoo_seconds``.
15. train     ``Trainer`` on full-width llama2-paper cut to 8 layers (bf16,
              AdamW with f32 master, flash attention, Chameleon off), 2 x
              2048 synthetic tokens, 6 steps: finite losses that fall, K1's
              forward and backward launched 6 x 8 times each (counts reset
              just before); step ms, tokens/s, peak memory; a profile of 2
              more steps (device idle share, K1's shares); and one grad
              step with flash against one with chunked attention
              (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL).
15b. distributed  (run after 15) the train phase's model on a one-rank NCCL
              group and a (1, 1) ("data", "model") mesh: DIST_STEPS steps
              of the sharded train step (``distributed.steps``: ZeRO 2
              placements, the TP plan) against the unsharded step from the
              same weights and batches (losses bit-equal, K1 launched
              DIST_STEPS x 8 times each way, step ms, and the peak equal
              both ways and to DIST_PEAK: on one rank nothing is gathered
              at use or hooked); the sharded step under the
              executor's conservative policy (losses equal, policy_swap
              D2H = H2D > 0); the int8 compressed gradient sync over a
              one-rank pod dim on one grad step's f32 gradients (K2a / K2b
              launches per leaf, an int8 payload on the wire, synced and
              residuals bit-equal to the plain path's); apply_moe_auto
              against apply_moe on one full-width granite-moe layer (bit
              equal); and the dry run (``launch.dryrun``) of the unsharded
              run's cell on fake cuda tensors: its peak within
              CHAM_PEAK_TOL of the allocator's, its roofline terms and the
              step's MFU against the measured p50; then the production
              dry-run cells DIST_DRYRUN_CELLS (llama2_paper, qwen2_7b and
              mamba2_780m x train_4k x single: 16 x 16, the default rules)
              on fake cuda tensors: each one's peak and flops per chip,
              gathered weight bytes, collective bytes and departures
              printed, each comparable to the reference's (qwen2_7b's 28
              heads in runs of 2 and 1, mamba2's B / C split).  Lines
              ``distributed_*``.
16. train_cli ``repro_torch.launch.train.main`` on the card, reduced
              llama2-paper (f32: the f32 paths of both K1 kernels), 3 steps;
              then (``train_cli_store``) 30 steps under the async worker
              with a policy store, ``--trace-out`` / ``--metrics-out`` /
              ``--audit-out`` through ``python -m repro_torch.obs.validate``
              and ``python -m repro_torch.obs.report``, and the serve CLI
              on that store (a background re-scan, the train run's
              records).
17. chameleon Chameleon's monitoring and planning (``repro_torch.core``) on
              the train phase's model with an eval every 6 steps: 10
              ``Trainer.train(1)`` steps inside the op-stream recorder,
              their signatures fed to Algo 1 (the stage list must be
              CHAM_STAGES); the step time with the recorder on and off in
              turns; one grad step with and without it (bit-equal); a
              detailed profile of one step (``profile_step``: K1's 8 + 8
              tokens and launches, every layer's sites at their bytes, the
              ffn_pre sawtooth, products on both sides of K1's first
              backward, the timeline's peak within CHAM_PEAK_TOL of
              ``max_memory_allocated``); policies (``generate_policy`` with
              the calibrate phase's link and engine) at the lowest budget a
              policy meets over that step and over its forward and
              backward alone, and below the floor (must raise
              ``ChameleonOOMError``); P2: the engine's ``queued_delay``
              against the measured time of four 256 MiB checkpoint copies,
              and 0 once they are done; K1's host cost per call through
              its custom op.
18. chameleon_exec  Chameleon executing its policies in the trainer
              (``core.runtime``, ``core.executor``): the train phase's
              model with an eval every CHAM_EXEC_EVAL_EVERY steps.  The
              budget B is the lowest one a policy meets for the grad
              dispatch's profile (bisection between its floor and peak)
              plus CHAM_EXEC_MARGIN; CHAM_EXEC_STEPS steps of
              ``Trainer(..., ChameleonConfig(enabled=True,
              hbm_budget_bytes=B))``, then, after freeing it, of the same
              trainer with Chameleon off.  Checks: the stages hold WarmUp,
              GenPolicy and Stable; a seq-change at an eval step; the
              Stable steps' policy swaps (its offloaded sites or its
              entries, ``core.executor``); losses bit-equal to
              Chameleon off's; the ``policy_swap`` D2H bytes equal the H2D
              bytes and are > 0 in every Stable step; K1's launches; the
              grad dispatch's ``max_memory_allocated`` under the applied
              policy falls by at least half the projected reduction
              against the baseline policy (both through the runtime, in
              turns, timed too); P4: the installed policy's projected
              stall within max(P4_ABS_MS, P4_REL x measured) of the copy
              stall its Stable steps measure on the card; P4's remainder:
              no host wait on a policy copy inside a Stable step's grad
              dispatch, no more allocator retries than Chameleon off's on
              the same steps, and the grad dispatch's reserved peak under
              the installed policy below the baseline's, each from an
              empty cache (``reserved_probe``).  Printed per
              step: dt, the grad dispatch's time less its copy stall
              (``t_grad``, what the profile is priced at), the projected
              and the measured copy stall with its worst P4_WORST entries,
              recompute and hook ms, the recorder's ms; per installed
              policy (``chameleon_exec_p4``) those medians, the on - off
              step difference, the host waits, the release ops that found
              their copy running, the books' ms after the step, the pinned
              slabs allocated, the retries and the reserved peaks.

18b. chameleon_async  adaptation off the training thread
              (``repro_torch.adapt``): the budget is the lowest a policy
              meets for the 2 x 3072 grad dispatch + CHAM_EXEC_MARGIN; 48
              steps of 2 x 2048 and 2 x 3072 tokens alternating every 12
              (ASYNC_*) under inline, async and speculative, then Chameleon
              off on the same batches.  Checks, in steps 24-47: async's
              worst step within ASYNC_RATIO of its bucket's Stable median,
              inline's over it; a speculative hit with no GenPolicy step;
              in every placement no failed job or watchdog fire, every
              visit after the first ending in an install, losses bit-equal
              to Chameleon off's, K1 (steps + replays) x 8 each way; the
              async run's trace (lanes compute, policy_swap, adapt),
              metrics and audit through the validators and the report (at
              least one scored iteration); P4 in every placement's
              every bucket: the installed policy's projected stall within
              max(P4_ABS_MS, P4_REL x measured) of its measured copy
              stall, and P4's remainder where the bucket's last policy
              moves bytes, as in chameleon_exec.  Printed: kickoff-to-install
              latency, ADAPTING p50 over Stable, first-visit spikes, P4
              per bucket (dt, t_grad, projected and measured copy stall,
              the worst entries, recompute ms, the on - off step
              difference), the worker's ms per job.

18c. chaos  the robustness drill of ``benchmarks/chaos_bench.py`` on the
              card (``repro_torch.faults``): the chameleon_exec phase's model
              and its lowest policy budget + CHAM_EXEC_MARGIN, no eval, the
              ladder shortened as tests/test_torch_faults.py shortens it
              (CHAOS_RESILIENCE).  A fault-free twin of CHAOS_STEPS steps
              must move the ladder never and keep every health class
              (``memory`` too) healthy at every step.  The engine's two
              terminal-failure paths on a fresh engine (chaos_fallbacks).
              Then, from CHAOS_LEAD steps after the
              twin's first Stable step for CHAOS_WINDOW steps:
              ``engine_window`` (``engine.transfer_error`` every copy,
              CHAOS_STEPS steps) and ``drop_and_stall`` (drops 0.3, 2 ms
              stalls 0.2, CHAOS_DROP_STEPS steps).  Each prints one line and
              is held as the reference's ``_compare`` holds it: no crash,
              faults fired, every loss equal to the twin's, no live slab,
              median step within CHAOS_INFLATION_CAP of the twin's, and
              the allocator's peak within CHAM_PEAK_TOL of it;
              engine_window also retries, descends and ascends, and ends
              healthy; K1 (steps + replays) x 8 each way in it.  Then the
              train CLI at the reduced size with a policy store, a
              checkpoint cadence and CHAOS_CLI_PLAN (store and checkpoint
              faults), and again with ``--resume``: both exit normally,
              faults fire, and the second resumes from the first's newest
              checkpoint.  Then (12d; line ``chaos_12d``)
              ``swap_in_terminal``: every swap-in of the window's first
              (Stable) step fails for good after its swap-out staged
              (``terminal_swap_ins``, max_retries 1), each must be served
              by the synchronous fallback through ``fence``; that step's
              ms and peak beside the twin's and the ladder's answer;
              ``copy_timeout``: copies stalled CHAOS_STALL_S (twice the
              timeout floor) at 0.3 over CHAOS_TIMEOUT_WINDOW steps, the
              engine must count timeouts, each a stalled copy, and end
              healthy on the full rung; both held as the runs above
              (no crash, losses equal to the twin's, no live slab, the
              peak); ``adapt_hang``: chameleon_async's drift run for
              HANG_STEPS steps with its first job hung HANG_S past a
              HANG_TIMEOUT_S watchdog (the pacing off): the watchdog
              fires once, the next visit installs, losses equal
              Chameleon off's.  A ``seconds`` line follows.
18d. ckpt_full  (run after 18c) checkpoints at full width (12d):
              llama2-paper at full width cut to CKPT_LAYERS, 2 x 2048
              tokens, Chameleon on with a policy store at the lowest
              budget a policy meets at that depth + CHAM_EXEC_MARGIN, the
              host's free disk and available memory printed first
              (``ckpt_full_host``).  A: CKPT_STEPS + 1 steps, no
              checkpoint (the twin); B: CKPT_STEPS with a checkpoint every
              CKPT_EVERY (two saves through the host tier's checkpoint
              class); C: a fresh trainer resumed from B's step-CKPT_EVERY
              checkpoint for the rest; D: as B under CHAOS_CLI_PLAN with
              its own store, then a fresh trainer resumed from D's newest
              checkpoint for one step.  Gates: C's, D's and the resume's
              losses equal A's at the same steps, C's state B's and the
              resumed state D's, bit for bit; D never crashes and its
              plan fires; every run's pinned pool ends with no live slab.
              Per save: the training thread's seconds in the reference-
              layout snapshot (``_numpy``, ``np.stack``) and in the submit
              (``_stage``), the writer's (``ckpt.write``, ``ckpt.collect``
              spans), the bytes on disk; per run the overlapped steps' p50
              against A's, ``max_memory_allocated`` against A's, the
              restore's seconds.  Line ``ckpt_full``, then ``seconds``.

21b. train_qwen2, train_qwen3_moe  (run after 22) the zoo's train phase
              on qwen2-7b cut to 8 layers and qwen3-moe-30b-a3b cut to 4
              (ZOO_LAYERS: full depth's AdamW state is 122 and 489 GB), at
              full width, with its gates and its gradient check (the group
              of 7 and H x D != d_model through K1 both ways).  Then
              (``phase_zoo_grads``) the gradient check alone at full width
              and ZOO_GRAD_LAYERS for llama3.2-1b (tied embeddings),
              qwen1.5-0.5b (QKV bias) and stablelm-1.6b (LayerNorm):
              ZOO_GRADS, lines ``<name>_grads``.  A ``seconds`` line
              follows each of the phases 6e, 14c, 19-22 and 21b.
19-21. train_ssm, train_hybrid, train_moe  ``Trainer`` at full width and
              full depth on mamba2-780m (48 layers), zamba2-1.2b (38, the
              shared attention block 6 times) and granite-moe-1b-a400m (24),
              2 x 2048 tokens, bf16, ZOO_STEPS steps: finite losses, K1's
              and K4's launches each way = steps x the step's attention
              applications / ssm layers; step ms, tokens/s, peak memory; a
              profile of 2 more steps; then the kernel path's gradients at
              full width and 2 layers against the plain path's (f32, the
              plain SSD scan, chunked attention; moe routes replayed), on
              ZOO_GRAD_SEEDS, beside a bf16 control through the plain
              versions (ZOO_LOSS_TOL, ZOO_GRAD_TOL).
6e. kernel_configs  (run after 6d) K1's forward and backward and K3 at the
              attention shapes of the five configurations serve_zoo runs
              that no other case launches (CONFIG_K1_CASES,
              CONFIG_K3_CASES; bf16): qwen2-7b's GQA group of 7 (28 over 4
              heads of 128) at the train shape (2 x 2048, both ways) and a
              901-token prefill, K3 at its decode shape with ragged lens
              (a partial last block of query heads); qwen3-moe-30b-a3b's 32
              over 4 heads of 128 (both ways; K3); llama3.2-1b's 32 over 8
              of 64 (a 901-token prefill; K3); then K1 both ways at one
              rank's heads where the production model dim (16) does not
              divide them (LOCAL_K1_CASES: qwen2-7b's runs of 2 heads over
              1 or 2 KV heads and of 1 over 1 at 2 x 2048, causal;
              whisper's encoder's runs of 2 and 1 heads at 8 x 1500,
              non-causal).  Each launched twice (bit-equal; phases kernel,
              kernel_bwd and decode_kernel launch every case twice) and
              held to K1's limits, timed warm and cold beside SDPA (its
              backward for the backward) and the bound.  Lines
              ``kernel``, ``kernel_cold``, ``kernel_bwd``,
              ``decode_kernel``.
6d. kernel_cross  (run after 6c) K1's forward and backward at the second
              input path's shapes (CROSS_CASES: whisper's encoder and
              cross-attention, the vision model's cross- and
              self-attention; bf16, each launched twice and bit-equal, K1's
              limits), timed warm and cold beside SDPA and the bound; K3
              over a whole memory (DECODE_CROSS_CASES).
22. train_encdec  the zoo's train phase on whisper-large-v3 (32 + 32
              layers), 8 x 448 tokens and 8 x 1500 zero frames a step
              (ZOO_TRAFFIC): K1 96 launches a step each way; a profile; the
              gradient check at 2 + 2 layers with random memory and every
              xgate at OPEN_XGATE (the key biases' gradients, 0 in exact
              arithmetic, reported, not gated: SHIFT_FREE).
23. decode_encdec  whisper at full width and depth through the model API:
              4 requests of 1500 random frames encoded by
              ``init_decode_state(memory=)`` (K1 x 32), a 4-token prompt
              and 32 new tokens through ``decode_step`` (K3 x 64 a tick);
              the first 4 ticks' logits against chunked attention.
24. decode_vlm  llama-3.2-vision-90b at full width cut to VLM_LAYERS: a
              512-token prompt into 6404 random image tokens, 4 requests,
              ``prefill`` (K1 x 12) and 31 ticks (K3 x 12 a tick); the
              prefill's and the first 4 ticks' logits against chunked
              attention.
25. autotune  the kernel autotuner (``repro_torch.kernels.autotune``):
              ``HostMemTier.autotune`` tunes K2a, K2b, K1 and K4 in f32 at
              the reference's default shapes into a fresh cache directory,
              then bf16 there and at AUTOTUNE_SHAPES (K1 at the training
              shape, K2a / K2b at the spill's row); each entry's winner,
              achieved GB/s, efficiency against ``h100_sxm``'s HBM rate and
              variants measured, every variant held to its plain version
              (K2a / K2b bit for bit, K1 ``k1_check``, K4 ``ssd_check``); a
              second tier on the directory must measure nothing (one cache
              hit per kernel); with its table installed, K1 at the training
              shape cold beside the default rows (in turns) and K4 through
              ``chunk=None``; the link's efficiency from the calibrate
              phase's curve and the Eq-3 bandwidth it leaves, which must
              not fall below the measured link (up to the spec's
              ``host_bw``); then serve_spill's run through ``--autotune
              --spill-compression auto`` on the warm directory: the
              advisor's int8 / raw rows, tokens equal to the int8 (or raw)
              run's when every row took int8 (or raw), spills = restores,
              the pool empty, K2a / K2b launched once per int8 row.  Runs
              last, and clears the table: no earlier phase runs with one.

Any failure raises, so the exit code is non-zero and no result line is
printed.  The last lines are the kernels summary, the nvidia-smi line and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

H100_BF16_FLOPS = 989e12      # dense tensor-core peak, SXM data sheet
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores
H100_HBM_BYTES_S = 3.35e12
# K1's inputs: q and k are unit normals times QK_SCALE and v a unit normal,
# so the scores q.k/sqrt(D) have a std of QK_SCALE**2 = 4 and every row's
# softmax is peaked.  A dropped KV tile or a wrong running-max rescale then
# moves an output by about the size of v.  (At 0.3 x randn the softmax is
# near uniform and each output is about the mean of v, smaller than a bf16
# tolerance: such faults would pass.)
QK_SCALE = 2.0
# A case passes when all three hold:
#   |out - ref| <= TOL + TOL |ref| in every element;
#   ||out - ref||_F <= FRO_TOL ||ref||_F;
#   max |out - ref| <= MAX_TOL max |ref|.
# bf16: P is rounded to bf16 for the P V product (2^-9 relative) and the
# output to bf16 (half an ulp), so the kernel stays within an ulp or two of
# the plain version; 2^-6 of max |ref| is 2 to 4 bf16 ulps of the largest
# output.  f32: the two differ only in summation order, ~1e-6 relative.
TOL = {"float32": 2e-3, "bfloat16": 2e-2}
FRO_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
MAX_TOL = {"float32": 2.0 ** -14, "bfloat16": 2.0 ** -6}
# The two attention paths of the cross-check differ only in summation order
# inside each attention, then round the context to bf16 (a relative step of
# 2^-8 = 3.9e-3).  Those roundings differ in some elements of each of the
# 32 layers and propagate through random (untrained) weights, so the
# logits are held to 5e-2 of their largest magnitude.
CROSSCHECK_TOL = 5e-2

# K1 backward (``flash_attention_bwd``) against ``flash_attention_bwd_plain``
# on the same q, k, v, o, lse and dO (o and lse from the forward kernel), q
# and k peaked as for K1, dO a unit normal.  dq, dk and dv are each held to
#   ||out - ref||_F <= BWD_FRO_TOL ||ref||_F  and
#   max |out - ref| <= BWD_MAX_TOL max |ref|.
# bf16: the kernel rounds P to bf16 for dV and dS for dK and dQ (2^-9
# relative each, as the forward rounds P) and its outputs to bf16 (2^-9);
# the plain version keeps f32 throughout, so ~3e-3 relative Frobenius is
# expected, and 2^-5 of max |ref| allows two to four bf16 ulps of the
# largest gradient plus the rounded P and dS terms under it.  f32: the two
# differ in summation order only, and dS = P (dP - delta) cancels where the
# softmax is peaked (dP of the peak key ~ delta), so 1e-4 and 2^-12.  The
# forward's lse is held to BWD_LSE_TOL (absolute, natural log) where finite
# and must be -inf exactly where the plain lse is (a row with no valid key).
BWD_FRO_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
BWD_MAX_TOL = {"float32": 2.0 ** -12, "bfloat16": 2.0 ** -5}
BWD_LSE_TOL = 1e-3
BOTH = ("float32", "bfloat16")
# (B, Sq, Sk, H, Kh, D, causal, kv_lens, dtypes, timed): the reference
# kernel-test sweep, causal with Sq != Sk both ways (the top-left mask),
# kv_lens with a zero length (every row of that batch row has no valid
# key) and ragged ones, GQA groups of 2, 4 and 8, head dims 16 to 128; then
# the training shape (llama2-paper at full width, 2 x 2048 tokens), timed.
BWD_CASES = [
    (2, 256, 256, 4, 2, 64, True, None, BOTH, False),
    (1, 128, 384, 4, 4, 32, False, None, BOTH, False),
    (2, 100, 100, 2, 1, 64, True, None, BOTH, False),
    (1, 512, 512, 8, 1, 128, True, None, BOTH, False),
    (1, 64, 192, 6, 3, 16, False, None, BOTH, False),
    (2, 200, 328, 4, 2, 64, True, None, BOTH, False),
    (1, 300, 130, 4, 4, 32, True, None, BOTH, False),
    (2, 300, 300, 8, 2, 64, False, (300, 0), BOTH, False),
    (2, 256, 256, 8, 8, 128, True, (256, 100), BOTH, False),
    (2, 130, 330, 4, 4, 32, False, (330, 201), BOTH, False),
    (1, 384, 384, 32, 8, 128, True, None, BOTH, False),
]
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
# K1 forward and backward cold: one launch per layer's own tensors, as K3's
# decode_cold_ms does; the forward also at S 901 over 32 layers.
TRAIN_LAYERS = 8
K1_COLD_LAYERS = 32
# The train phase: full-width llama2-paper (bf16 params, f32 AdamW master)
# with the depth cut to TRAIN_LAYERS (full depth's AdamW state alone is
# ~108 GB, past the card's 80 GB), flash attention, Chameleon off,
# synthetic tokens TRAIN_BATCH x TRAIN_SEQ, no eval, no checkpoints; lr
# 1e-4 after 1 warmup step (the reference's trainer tests' 1e-3, sized for
# d 128, made this 4096-wide model's loss jump from 10.9 to 19.2 at its
# third update on the H100).
TRAIN_STEPS = 6
TRAIN_LR, TRAIN_WARMUP = 1e-4, 1
# Its crosscheck: one grad step with flash and with chunked attention on
# the same weights and batch.  Both run the bf16 model, which rounds every
# activation to bf16; they differ in the attention only (flash rounds P and
# dS to bf16 in its products, chunked keeps them in f32 and rounds its
# output), and those roundings pass through 8 layers of bf16 backward.  So
# the losses are held to 2e-2 (absolute, ~2e-3 relative at a loss of ~10)
# and every parameter's gradient to 5e-2 relative Frobenius.
TRAIN_LOSS_TOL = 2e-2
TRAIN_GRAD_TOL = 5e-2
TRAIN_CLI_ARGS = ["--arch", "llama2-paper", "--reduced", "--steps", "3",
                  "--no-chameleon", "--attn-impl", "flash"]

# The distributed phase: the train phase's width (llama2-paper, TRAIN_LAYERS,
# TRAIN_BATCH x TRAIN_SEQ, bf16, flash) on a one-rank NCCL group and a
# (1, 1) ("data", "model") mesh: DIST_STEPS steps of the sharded train step
# (ZeRO 2 placements, the TP plan) against the unsharded one from the same
# weights and batches; the sharded step under the executor's conservative
# policy; the int8 compressed gradient sync (K2a / K2b) over a one-rank pod
# dim, bit for bit against its plain path; apply_moe_auto (expert
# parallelism) against apply_moe on one full-width granite-moe layer
# (DIST_MOE_TOKENS tokens); and the dry run of the unsharded run's cell on
# fake cuda tensors, whose peak must lie within CHAM_PEAK_TOL of the
# allocator's.
DIST_STEPS = 3
DIST_MOE_TOKENS = (2, 1024)
# The sharded and unsharded runs' allocator peak as first measured on the
# H100 (PERF.md §6): the (1, 1) mesh hooks nothing, so both stay at it.
DIST_PEAK = 35_858_673_152
# The production dry-run cells the phase traces on fake cuda tensors: the
# paper's model, a model dim that does not divide the query heads
# (qwen2-7b's 28 over 16) and Mamba-2's B / C split over it.
DIST_DRYRUN_CELLS = [("llama2_paper", "train_4k", False),
                     ("qwen2_7b", "train_4k", False),
                     ("mamba2_780m", "train_4k", False)]

# The chameleon phase: the train phase's configuration (TRAIN_LAYERS,
# TRAIN_BATCH x TRAIN_SEQ, TRAIN_LR), with an eval every CHAM_EVAL_EVERY
# steps.  CHAM_STEPS monitored steps under the default Algo 1 (m = 2, n = 5)
# must give CHAM_STAGES, the list tests/test_torch_monitor.py::STAGES_10
# pins for the same schedule on the reduced config, where the port's
# recorder and the reference's jaxpr tokenizer agree: the eval of step 6
# lengthens the op sequence past Algo 1's 5% and sends GenPolicy back to
# WarmUp.
CHAM_STEPS, CHAM_EVAL_EVERY = 10, 6
CHAM_STAGES = ["WarmUp"] * 3 + ["GenPolicy"] * 3 + ["WarmUp"] * 4
CHAM_ONOFF_PAIRS = 5           # steps with the recorder on / off, in turns
# The detailed profile's timeline (storages of >= 1 KiB that the step
# allocates, on top of what was allocated when it began) against the
# allocator's own peak for the same step: the allocator also counts its
# 512-byte rounding, allocations below 1 KiB and what ops allocate inside
# themselves (the custom ops' workspaces), so the two agree within 10%.
CHAM_PEAK_TOL = 0.10
# The sites every layer's profile must hold (with bytes = elements x 2).
CHAM_SITES = ("qkv_proj", "attn_ctx", "attn_out", "ffn_pre", "resid_post")
# P2: four checkpoint-class copies of 256 MiB, queued at once.  The
# engine's estimate of their link time right after the submission is held
# within a factor of P2_RATIO of the time their CUDA events measure.
P2_COPIES, P2_BYTES, P2_RATIO = 4, 256 << 20, 2.0
# The chameleon_exec phase: the train phase's configuration with an eval
# every CHAM_EXEC_EVAL_EVERY steps.  An eval every 6 steps (the chameleon
# phase's) interrupts every GenPolicy (m = 2 stable steps, then n = 5
# variants and a selection: CHAM_STAGES shows it), so no policy would ever
# be selected; 13 (tests/test_torch_runtime.py's cadence) leaves one full
# adaptation before the first eval.  CHAM_EXEC_MARGIN over the lowest
# budget a policy meets; CHAM_EXEC_TURNS grad dispatches under the applied
# policy and under the baseline, in turns.
CHAM_EXEC_STEPS, CHAM_EXEC_EVAL_EVERY = 18, 13
CHAM_EXEC_MARGIN = 1.01
CHAM_EXEC_TURNS = 3
# P4: an installed policy's projected stall (the simulator's, from the
# profile priced at the grad dispatch's time) is held to the copy stall its
# executions measure on the card (the p50 over its Stable steps; each
# fence's wait, ``core.executor``): |projected - measured| at most
# P4_ABS_MS or P4_REL of the measured, whichever is larger, a step.  Rows
# print the P4_WORST entries that stalled longest.
P4_ABS_MS, P4_REL, P4_WORST = 15.0, 2.0 / 3.0, 5
# P4's remainder: on the card no Stable step's grad dispatch blocks the host
# on a policy copy (``Execution.last["host_waits"]``: release ops retire
# only copies already done, swap-ins chain on the device, the books close
# after the step's sync in ``Execution.settle``), its steps
# take no more caching-allocator retries than Chameleon off's on the same
# steps, and the grad dispatch's reserved peak under an installed policy
# that moves bytes is below off's (``reserved_probe``: each from an empty
# cache, since the caching allocator keeps every step's high-water mark).
# The chameleon_async phase (the drift-stall suite of
# benchmarks/adapt_bench.py at the train phase's width): two buckets of
# TRAIN_BATCH x ASYNC_SEQS tokens (the reference's 64 : 96) alternate every
# ASYNC_PERIOD steps, ASYNC_STEPS steps a placement, the policy store off,
# no eval.  The budget is the lowest a policy meets for the longer bucket's
# grad dispatch + CHAM_EXEC_MARGIN.  The guard window starts at
# ASYNC_SKIP, where both buckets have had their first visit (first replay,
# first K1 launches at a new shape).  ASYNC_RATIO is the reference's bar:
# async's worst step within 1.5x its bucket's Stable median, inline's over.
ASYNC_SEQS = (2048, 3072)
ASYNC_PERIOD, ASYNC_STEPS, ASYNC_SKIP = 12, 48, 24
ASYNC_RATIO = 1.5
ASYNC_MODES = ("inline", "async", "speculative")
ASYNC_LANES = ("compute", "policy_swap", "adapt")
# The chaos phase (benchmarks/chaos_bench.py's scenarios at the train
# phase's width, the chameleon_exec budget): a fault-free twin, then each
# scenario from the same seed, its fault window CHAOS_WINDOW steps long and
# starting CHAOS_LEAD steps after the twin's first Stable step (the
# reference's sits at steps // 4 of its own run).  CHAOS_RESILIENCE is
# tests/test_torch_faults.py's: probes every 4 steps and a one-step hold,
# so no_swap climbs back to full inside the run.  CHAOS_INFLATION_CAP is
# chaos_bench.INFLATION_CAP.
CHAOS_STEPS, CHAOS_DROP_STEPS = 48, 16
CHAOS_WINDOW, CHAOS_LEAD = 10, 2
CHAOS_RESILIENCE = {"probe_interval": 4, "ladder_hold_iterations": 1}
CHAOS_INFLATION_CAP = 5.0
# chaos_fallbacks' payload: one of the policy's entries' order of size
CHAOS_FALLBACK_BYTES = 64 << 20
# The drill's 12d scenarios, cut to the script's time.  swap_in_terminal:
# every swap-in of the window's first step fails for good (max_retries
# 1), CHAOS_TERMINAL_STEPS steps so the ladder's answer shows (down the
# next step, back at the next probe).  copy_timeout: copies stalled
# CHAOS_STALL_S (twice ResilienceConfig.timeout_floor_s) at 0.3 over the
# window's first CHAOS_TIMEOUT_WINDOW steps (a stall sleeps on the
# thread that issues the copy, the training thread), CHAOS_TIMEOUT_STEPS
# steps.
# adapt_hang: chameleon_async's drift run, HANG_STEPS steps (the first
# visit and most of the second, whose job installs by step 17), the first
# job hung HANG_S past a watchdog of HANG_TIMEOUT_S (the default's 30 s
# would outlast the run).
CHAOS_TERMINAL_STEPS, CHAOS_TIMEOUT_STEPS = 16, 16
CHAOS_TIMEOUT_WINDOW, CHAOS_STALL_S = 4, 0.1
HANG_STEPS, HANG_S, HANG_TIMEOUT_S = 20, 2.0, 1.0
# The chaos phase's CLI drill: the reduced config, so that a checkpoint of
# the parameters and AdamW state is small (one of the full-width model is
# ~26 GB); the chaos bench's storage scenario as a plan file.
# The first run takes CHAOS_CLI_STEPS (evals every 10, so GenPolicy ends in
# an install and a store record), the resumed one CHAOS_CLI_RESUME_STEPS.
CHAOS_CLI_ARGS = ["--arch", "llama2-paper", "--reduced", "--seq", "64",
                  "--global-batch", "4", "--attn-impl", "flash",
                  "--budget-gib", "0.016"]
CHAOS_CLI_STEPS, CHAOS_CLI_RESUME_STEPS = 30, 6
CHAOS_CLI_PLAN = {"seed": 0, "specs": [
    {"site": "store.put", "prob": 0.5},
    {"site": "store.load", "prob": 0.5},
    {"site": "ckpt.write", "prob": 0.5, "max_fires": 2}]}
# The ckpt_full phase (12d): llama2-paper at full width cut to
# CKPT_LAYERS, a checkpoint every CKPT_EVERY of CKPT_STEPS steps.  A save
# writes CKPT_BYTES_PER_PARAM bytes a parameter (the parameters widened to
# f32, AdamW's m, v and f32 master): 7.43 GB at one layer (464.5 M
# parameters, two thirds of them the embeddings).  Two layers (10.67 GB a
# save) took 229 s for the phase's four saves and two restores on an
# NVIDIA H100 80GB HBM3 at 700 W, past what the whole script may take.
# The temporary directory's disk must hold CKPT_DISK_SAVES saves and the
# host's available memory CKPT_HOST_SAVES (the snapshot, the pinned
# staging and the writer's copy of one save).
CKPT_LAYERS, CKPT_STEPS, CKPT_EVERY = 1, 12, 6
CKPT_BYTES_PER_PARAM, CKPT_DISK_SAVES, CKPT_HOST_SAVES = 16, 3, 4
# The examples phase's 12d runs: train_e2e at the preset its doc calls the
# full deliverable configuration (12 layers, d 768, 12 over 4 heads of 64,
# vocab 32000, f32), E2E_STEPS steps with an eval and a checkpoint every
# E2E_EVERY and the serving burst, then E2E_RESUME_STEPS more with
# --resume; then elastic_restart.
E2E_STEPS, E2E_RESUME_STEPS, E2E_EVERY = 12, 6, 6
E2E_ARGS = ["--preset", "100m", "--seq", "256", "--batch", "8",
            "--eval-every", str(E2E_EVERY),
            "--checkpoint-every", str(E2E_EVERY)]
# The train_cli phase's async run: reduced llama2-paper under Chameleon
# with the background worker, a policy store, and its trace, metrics and
# audit; then the serve CLI on that store, long enough (> 256 ticks) for
# one background re-scan.
TRAIN_CLI_ASYNC_ARGS = ["--arch", "llama2-paper", "--reduced", "--steps",
                        "30", "--seq", "64", "--global-batch", "4",
                        "--attn-impl", "flash", "--adapt-mode", "async",
                        "--metrics-every", "5"]
SERVE_CLI_STORE_ARGS = ["--arch", "llama2-paper", "--reduced", "--requests",
                        "2", "--max-batch", "2", "--new-tokens", "260",
                        "--max-len", "300", "--adapt-mode", "async"]
# K1 forward's host cost per call through the custom op: back-to-back calls
# at a shape whose kernel is shorter than the host's work.
OP_COST_SHAPE, OP_COST_CALLS = (1, 64, 32, 128), 2000

SERVE_ARGS = ["--arch", "llama2-paper", "--attn-impl", "flash",
              "--requests", "8", "--max-batch", "4", "--max-len", "1024",
              "--min-prompt-len", "65", "--max-prompt-len", "900",
              "--new-tokens", "32"]
SPILL_ARGS = ["--max-active", "8"]

# The autotune phase: every kernel the tuner has a space for, in both
# dtypes at the reference's default shapes, and in bf16 at the main path's
# own shapes: K1 at the train phase's (TRAIN_BATCH x TRAIN_SEQ, 32 heads of
# 128) and K2a / K2b at the KV spill's slot row (KV_CACHE_SHAPE's layers x
# positions x heads rows of 128).  The serve run then spills through
# ``--spill-compression auto`` on that warm cache.
AUTOTUNE_KERNELS = ("quantize", "dequantize", "flash_attention", "ssd_scan")
AUTOTUNE_SHAPES = [("flash_attention", (TRAIN_BATCH, TRAIN_SEQ, 32, 128)),
                   ("quantize", (32 * 1024 * 32, 128)),
                   ("dequantize", (32 * 1024 * 32, 128))]
AUTO_SPILL_ARGS = ["--autotune", "--spill-compression", "auto"]

# (B, Sq, Sk, H, Kh, D, causal, kv_lens, dtypes, timed)
SWEEP_CASES = [
    # tests/test_kernels.py::test_flash_attention_sweep
    (2, 256, 256, 4, 2, 64, True, None, BOTH, False),
    (1, 128, 384, 4, 4, 32, False, None, BOTH, False),
    (2, 100, 100, 2, 1, 64, True, None, BOTH, False),
    (1, 512, 512, 8, 1, 128, True, None, BOTH, False),
    (1, 64, 192, 6, 3, 16, False, None, BOTH, False),
    # GQA and kv_lens
    (1, 384, 384, 32, 8, 128, True, None, BOTH, False),
    (2, 300, 300, 8, 2, 64, False, (300, 137), BOTH, False),
    (2, 256, 256, 8, 8, 128, True, (256, 100), BOTH, False),
]
TIMED_LENS = (77, 384, 901)      # llama2-paper prefill lengths that are timed
SUMMARY_LEN = 901

# K2a / K2b inputs, every shape in both dtypes: the reference sweep of
# tests/test_kernels.py::test_quant_matches_ref, then ragged row counts (not
# a multiple of the kernels' 8 rows per block).
QUANT_SHAPES = [(4, 96, 128), (256, 64), (3, 7, 33), (1001, 128), (13, 96)]
# The KV spill's case: slot row 1 of the full-width (L, B, Smax, Kh, D)
# cache, written up to position KV_FILLED and zero past it, as a served
# slot is.
KV_CACHE_SHAPE = (32, 4, 1024, 32, 128)
KV_FILLED = 749

# K3 (flash-decode) cases: (B, Sk, H, Kh, D, lens, timed).  Every case runs
# in both dtypes and is held to K1's limits (TOL, FRO_TOL, MAX_TOL): the
# kernel keeps P in f32, so in bf16 only the output's rounding differs.
# The reference sweep (tests/test_kernels.py::test_flash_decode_sweep), GQA
# groups of 4 and 8, a zero length (zeros, by the kernel's contract), then
# llama2-paper's decode shape: one layer's (4, 1024, 32, 128) cache with the
# lens of the serve phase's first decode tick (its four resident prompts'
# lengths + 1), and ragged lens.  q and k are peaked (QK_SCALE) and the
# cache is random past lens too, so a kernel that reads those rows differs.
# The last three are the split-KV kernel's edges (``kernel.split_keys``
# picks 256 keys per split for the first two shapes, 128 for the third):
# lens on a split boundary, one past and one short of it, and Smax; B 1 with
# Smax 4096 and 16 splits with keys; B 8 with one long row and seven short.
DECODE_CASES = [
    (2, 160, 4, 2, 32, (100, 37), False),
    (2, 128, 4, 2, 32, (128, 1), False),
    (2, 512, 4, 2, 32, (512, 300), False),
    (2, 256, 16, 4, 64, (200, 3), False),
    (1, 300, 8, 1, 128, (299,), False),
    (2, 64, 4, 2, 32, (0, 5), False),
    (4, 1024, 32, 32, 128, (1, 37, 1000, 1024), False),
    (4, 1024, 32, 32, 128, (256, 512, 257, 255), False),
    (1, 4096, 32, 32, 128, (4000,), False),
    (8, 1024, 32, 8, 128, (1000, 1, 2, 3, 5, 9, 17, 33), False),
]
# K3's cold-L2 yardstick: one CUDA-graph replay launches the kernel once per
# layer over the layer slices of a (DECODE_COLD_LAYERS, B, Smax, Kh, D) K and
# V cache, as a decode step does.  Each layer's valid rows (38.1 MB at the
# serve decode shape, in bf16) were last read DECODE_COLD_LAYERS - 1 launches
# earlier, so a replay reads 1.2 GB, 24 times the card's 50 MB L2: every
# launch finds its cache rows cold, as served.  (``graph_ms`` replays one
# layer's cache, whose valid rows fit in L2.)
DECODE_COLD_LAYERS = 32
# K4 (SSD scan) at mamba2-780m's widths (48 heads of P 64, N 128, chunk 256):
# prefill lengths with a ragged tail and 1, 2 and 4 chunks; x, Bm and Cm are
# views into one convolution output as the model passes them, dt in
# [0.01, 1] and A = -(1..48) as the model's A_log gives, so decay and the
# carried state both matter.  Limits (elementwise, relative Frobenius) for
# y: f32 arithmetic in both in another order (the running sum of dt * A
# reaches ~6e3 in a chunk, so exp(cs_i - cs_j) carries ~1e-4 relative error
# in the terms that count); bf16 adds the rounding of y (2^-9).  The final
# state is f32 in both: (2e-3, 1e-4).
SSD_LENS = (77, 384, 901)
SSD_TOL = {"float32": (2e-3, 1e-4), "bfloat16": (2e-2, 1e-2)}
SSD_STATE_TOL = (2e-3, 1e-4)
# K4's backward (``ssd_scan_bwd``) against ``ssd_scan_bwd_plain`` (f32 on
# the same inputs): (arch, B, S, H, P, N, chunk, dtype, timed).  The train
# phases' shapes, 2 x 2048 tokens of mamba2-780m (48 heads, N 128) and of
# zamba2-1.2b (64 heads, N 64), timed; mamba2's widths at a ragged length
# (the last chunk 232 of 256 tokens) and with one chunk; and f32 cases,
# ragged, with a chunk that is not a multiple of the kernel's 64-token
# tiles.  Each of dx, ddt, dA, dB and dC is held to (relative Frobenius,
# max |err| / max |ref|).  bf16: dx, dB and dC are rounded to bf16 (2^-9
# relative), and the running sums of dt * A (|cs| up to ~6e3 over a chunk
# at A = -(1..H)) are summed in another order by the plain version on the
# card than by the forward kernel, which moves exp(cs_i - cs_j) by ~1e-4
# relative where it matters; dcs cancels (row sums of dM o M minus column
# sums) before its running sum, so ddt and dA carry more of it.  So 1e-2
# and 2^-5, K1 backward's bf16 limits.  f32: the same inputs, the same
# cs order question and summation order only: 1e-3 and 2^-8.
SSD_BWD_CASES = [
    ("mamba2-780m", 2, 2048, 48, 64, 128, 256, "bfloat16", True),
    ("zamba2-1.2b", 2, 2048, 64, 64, 64, 256, "bfloat16", True),
    ("mamba2-780m", 2, 1000, 48, 64, 128, 256, "bfloat16", False),
    ("mamba2-780m", 1, 200, 48, 64, 128, 256, "bfloat16", False),
    ("mamba2-780m", 1, 300, 8, 64, 128, 256, "float32", False),
    ("reduced", 2, 77, 4, 16, 16, 32, "float32", False),
    ("reduced", 1, 130, 3, 40, 8, 100, "float32", False),
]
SSD_BWD_TOL = {"bfloat16": (1e-2, 2.0 ** -5), "float32": (1e-3, 2.0 ** -8)}
SSD_BWD_COLD_LAYERS = 8
# The decoder zoo's train phases: phase -> arch, each at full width and full
# depth (AdamW state at 16 B a parameter: 12.5, 18.7 and 21.4 GB) but for
# the two whose depth ZOO_LAYERS cuts (qwen2-7b, qwen3-moe), Trainer
# with Chameleon off, TRAIN_BATCH x TRAIN_SEQ synthetic tokens, bf16, flash
# attention, ZOO_STEPS steps (the first pays the kernels' first launches
# and is left out of the p50).  Each checks finite losses and the launch
# counts of K1 (forward, backward) and K4 (forward, backward) against
# steps x (attention applications, ssm layers) of one step, then holds the
# kernel path's gradients against the plain path's (``zoo_grad_check``):
# the same module at full width cut to ZOO_GRAD_LAYERS layers (zamba2's
# shared block after each, so both applications share it), for each seed
# of ZOO_GRAD_SEEDS (weights and batch), bf16 through the kernels against
# f32 through the plain versions (``ssd_scan_plain`` swapped in for
# ``ssd_scan``, chunked attention for flash).  A control runs the bf16
# weights through the plain versions: its distance from f32 is what bf16
# rounding alone does to each gradient.  The moe family's plain sides
# route every token to the experts the kernel side chose (``RouteReplay``):
# top-k routing is discontinuous, and without it bf16's rounding sends some
# tokens to other experts than f32 does (a 9% median per gradient on the
# card), which says nothing of the kernels.  Both losses within
# ZOO_LOSS_TOL and every gradient of the kernel side within ZOO_GRAD_TOL
# relative Frobenius on every seed.  ZOO_GRAD_TOL is set from the readings
# of ``python3 chip_smoke.py --zoo-grads 6`` (six seeds a family, kernel
# and control; PERF.md): twice the largest of either (0.039, A_log of a
# mamba2 layer, the kernel's and the control's alike; the gated seeds read
# 0.025 at most), which a kernel fault (that moves a gradient by its own
# size) still exceeds by an order of magnitude.
ZOO_TRAIN = {"train_ssm": "mamba2-780m", "train_hybrid": "zamba2-1.2b",
             "train_moe": "granite-moe-1b-a400m",
             "train_encdec": "whisper-large-v3",
             "train_qwen2": "qwen2-7b", "train_qwen3_moe": "qwen3-moe-30b-a3b"}
ZOO_STEPS = 4
ZOO_GRAD_LAYERS = 2
ZOO_GRAD_SEEDS = (1, 2, 3)
ZOO_LOSS_TOL = 5e-2
ZOO_GRAD_TOL = 8e-2
MOE_SERVE_ARGS = ["--arch", "granite-moe-1b-a400m", "--attn-impl", "flash",
                  "--requests", "8", "--max-batch", "4", "--max-len", "1024",
                  "--min-prompt-len", "65", "--max-prompt-len", "900",
                  "--new-tokens", "32"]
SSM_SERVE_ARGS = ["--arch", "mamba2-780m", "--requests", "8",
                  "--max-batch", "4", "--max-len", "1024",
                  "--min-prompt-len", "65", "--max-prompt-len", "900",
                  "--new-tokens", "32"]
# Prefill (K4) against token-by-token decode (the recurrence) of one
# 64-token prompt on full-width mamba2-780m.  In f32 the two paths differ
# only in summation order: the logits are held to 5e-3 of their largest
# magnitude, the tolerance of the reference's own decode-vs-forward test.
# In bf16, as served, prefill rounds the convolution and y to bf16 where
# decode keeps them in f32 (the reference does the same: its own bf16
# prefill and decode differ by 1.7e-2 of max |logit| at 6 narrow layers on
# the CPU, and 48 full-width layers compound it), so the bf16 run is held
# to finite logits and to the same greedy token wherever the top-2 margin
# exceeds twice the largest logit difference.
SSM_CROSSCHECK_LEN = 64
SSM_CROSSCHECK_TOL = 5e-3
# The second input path (cross-attention; vlm and encdec).  K1 forward and
# backward at the shapes its phases give them, bf16, each launched twice
# (bit-equal) and held to K1's limits (TOL / FRO_TOL / MAX_TOL, and
# BWD_FRO_TOL / BWD_MAX_TOL): (B, Sq, Sk, H, Kh, D, causal, name).
# Whisper's encoder (8 windows of 1500 frames, non-causal) and its decoder's
# cross-attention (448 text tokens into 1500 frames); the vision model's
# cross-attention (a 512-token prompt into 6404 image tokens, 64 heads over
# 8) and its prefill self-attention.  1500 and 6404 are multiples of no
# tile, 448 of 64 rows but not of 128.
CROSS_CASES = [
    (8, 1500, 1500, 20, 20, 64, False, "whisper_encoder"),
    (8, 448, 1500, 20, 20, 64, False, "whisper_cross"),
    (4, 512, 6404, 64, 8, 128, False, "vlm_cross"),
    (4, 512, 512, 64, 8, 128, True, "vlm_self"),
]
# K3 over a whole memory (lens = its length): a cross-attention decode step
# of whisper (1500 frames, 20 heads, 6 splits of 256 keys) and of the vision
# model (6404 image tokens, 64 over 8 heads, 26 splits).
DECODE_CROSS_CASES = [
    (4, 1500, 20, 20, 64, (1500,) * 4, True),
    (4, 6404, 64, 8, 128, (6404,) * 4, True),
]
# train_encdec's traffic: Whisper's own training window (arXiv:2212.04356),
# 30 s of audio (1500 frames, fed as zeros as the reference's trainer
# feeds its stub frontend) and a 448-token text context, 8 windows a step.
ZOO_TRAFFIC = {"train_encdec": (8, 448)}
# Every cross block's gate in the encdec gradient check and the decode
# phases: at the init's 0, tanh(0) multiplies the cross-attention away and
# with it every gradient into the cross K/V and the encoder.
OPEN_XGATE = 0.5
# decode_encdec: full-width whisper, DECODE_REQUESTS requests of 1500 random
# frames, a DECODE_PROMPT-token prompt fed through decode_step, DECODE_NEW
# new tokens (greedy), max_len 448.  decode_vlm: the vision model at full
# width with its depth cut to VLM_LAYERS (two groups of 4 self blocks + 1
# cross block; its 100 layers are 176 GB of bf16 weights), DECODE_REQUESTS
# requests sharing one VLM_PROMPT-token prompt, 6404 random image tokens
# each, max_len 1024, DECODE_NEW new tokens (the first from the prefill).
# Both cross-check their first CROSSCHECK_TICKS ticks' logits (and vlm's
# prefill) against the same model with chunked attention (CROSSCHECK_TOL).
DECODE_REQUESTS, DECODE_PROMPT, DECODE_NEW = 4, 4, 32
ENCDEC_MAX_LEN = 448
VLM_LAYERS, VLM_PROMPT, VLM_MAX_LEN = 10, 512, 1024
CROSSCHECK_TICKS = 4
# The five shipped configurations no earlier phase ran, in serve_zoo's
# order: the serve CLI's default (llama3.2-1b, tied embeddings, 32 over 8
# heads of 64), qwen1.5-0.5b (MHA, QKV bias), stablelm-1.6b (LayerNorm),
# qwen2-7b (28 over 4 heads of 128: a GQA group of 7) and, last, on a card
# emptied first, qwen3-moe-30b-a3b (61.1 GB of bf16 weights; 32 over 4
# heads of 128, so heads x head dim 4096 against d_model 2048; 128 experts
# top-8).  Each serves SERVE_ARGS' traffic at full width and depth (the
# default through no --arch at all), then holds flash against chunked
# attention on the same weights (``phase_crosscheck``).
SERVE_ZOO = ("llama3.2-1b", "qwen1.5-0.5b", "stablelm-1.6b", "qwen2-7b",
             "qwen3-moe-30b-a3b")
# K1 both ways and K3 at those configurations' attention shapes that no
# earlier case launched (heads and head dim from each config), bf16, each
# launched twice (bit-equal) and held to K1's limits, timed warm and cold
# beside SDPA and the bound.  K1: (arch, B, S, backward too), causal: the
# train shapes (2 x 2048) cold over TRAIN_LAYERS layers' own tensors, the
# 901-token prefills over K1_COLD_LAYERS.  K3: (arch, lens) on serve_zoo's
# (4, 1024) cache: qwen2-7b's group of 7 splits into blocks of 4 and 3
# query heads, at ragged lens with one inside the first 256-key split;
# None takes the lens of serve_zoo's first decode tick (``decode_cases``'s
# rule).
CONFIG_K1_CASES = [("qwen2-7b", TRAIN_BATCH, TRAIN_SEQ, True),
                   ("qwen2-7b", 1, 901, False),
                   ("qwen3-moe-30b-a3b", TRAIN_BATCH, TRAIN_SEQ, True),
                   ("llama3.2-1b", 1, 901, False)]
CONFIG_K3_CASES = [("qwen2-7b", (900, 101, 1024, 513)),
                   ("qwen3-moe-30b-a3b", None), ("llama3.2-1b", None)]
# K1 both ways at the shapes one rank of the production mesh's model dim
# (16) gives it where that dim does not divide the query heads: each
# distinct (query heads, KV heads) of ``sharding.head_runs`` but the empty
# run (a rank with no heads launches nothing).  qwen2-7b (28 over 4 heads of
# 128: runs of 2 heads over 1 or 2 KV heads, and of 1 over 1) at the train
# shape, causal; whisper's encoder (20 heads of 64: runs of 2 and 1) at its
# 8 x 1500 frames, non-causal.  (arch, B, S, causal)
LOCAL_K1_CASES = [("qwen2-7b", TRAIN_BATCH, TRAIN_SEQ, True),
                  ("whisper-large-v3", 8, 1500, False)]
# The config train phases: ZOO_TRAIN entries whose depth is cut (their
# AdamW state at 16 B a parameter does not fit the card at full depth:
# qwen2-7b's 7.6 B parameters would need 122 GB, qwen3-moe's 30.5 B 489
# GB).  qwen2-7b runs 8 layers as train runs llama2-paper (2.96 B, 47 GB
# of state); qwen3-moe 4 (3.11 B, 50 GB).
ZOO_LAYERS = {"train_qwen2": 8, "train_qwen3_moe": 4}
# The gradient check alone (``zoo_grad_check`` at full width and
# ZOO_GRAD_LAYERS) for the dense configurations whose train step adds
# nothing the check does not: tied embeddings, QKV bias, LayerNorm.
ZOO_GRADS = {"llama3_2_1b": "llama3.2-1b", "qwen1_5": "qwen1.5-0.5b",
             "stablelm": "stablelm-1.6b"}


def decode_cases(cfg):
    """K3's cases: DECODE_CASES, then llama2-paper's decode shape at the
    lens of the serve phase's first decode tick (timed)."""
    lens = tuple(len(p) + 1 for p in serve_prompts(4, cfg.vocab_size))
    return DECODE_CASES + [(4, 1024, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim, lens, True)]


def llama2_cases(cfg):
    """K1 at llama2-paper's prefill shapes: the timed lengths in both dtypes,
    and every prompt length of the serve phase in bf16, as served."""
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cases = [(1, S, S, H, Kh, D, True, None, BOTH, True) for S in TIMED_LENS]
    cases += [(1, S, S, H, Kh, D, True, None, ("bfloat16",), False)
              for S in map(len, serve_prompts(8, cfg.vocab_size))]
    return cases


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time per call of ``fn`` called back to back (CUDA events): the device
    time, or the host's dispatch time where that is longer."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, so the host's
    dispatch (Python, ctypes) is not in the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del graph
    return ms


def k1_inputs(gen, B, Sq, Sk, H, Kh, D, dtype, device, qk_scale=QK_SCALE,
              v_scale=1.0):
    """q (B,Sq,H,D), k and v (B,Sk,Kh,D) from ``gen``, in ``dtype``."""
    import torch

    def rand(scale, *shape):
        return (torch.randn(*shape, generator=gen, device=device)
                * scale).to(dtype)
    return (rand(qk_scale, B, Sq, H, D), rand(qk_scale, B, Sk, Kh, D),
            rand(v_scale, B, Sk, Kh, D))


def k1_check(out, ref, dname: str) -> dict:
    """K1's output against its plain version: the errors and whether they
    are inside every limit (TOL, FRO_TOL, MAX_TOL above)."""
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    err, scale = float(diff.max()), float(r.abs().max())
    rel_fro = float(diff.norm() / r.norm())
    tol = TOL[dname]
    ok = (bool((diff <= tol + tol * r.abs()).all())
          and rel_fro <= FRO_TOL[dname] and err <= MAX_TOL[dname] * scale)
    return {"max_abs_err": err, "max_abs_ref": scale, "rel_fro": rel_fro,
            "tol": tol, "fro_tol": FRO_TOL[dname],
            "max_tol": MAX_TOL[dname] * scale, "ok": ok}


def attention_bound(B, Sq, Sk, H, Kh, D, causal, kv_lens, dtype):
    """Least time for the work these inputs need: q, the valid rows of k
    and v (all Sk without kv_lens) read once and o written once over HBM
    bandwidth, against 4*D flops per unmasked (query, key) pair per head
    over the peak rate of the input type."""
    import torch
    esize = torch.finfo(dtype).bits // 8
    lens = kv_lens or (Sk,) * B
    nbytes = esize * (2 * B * Sq * H * D
                      + 2 * Kh * D * sum(min(max(n, 0), Sk) for n in lens))
    pairs = 0
    for n in lens:
        n = min(max(n, 0), Sk)
        pairs += (sum(min(q + 1, n) for q in range(Sq)) if causal
                  else Sq * n)
    flops = 4.0 * H * D * pairs
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_bytes, t_ops = nbytes / H100_HBM_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_bwd_flops(B, Sq, Sk, H, Kh, D, causal, kv_lens) -> float:
    """The backward's work: five products (S, dP, dV, dK, dQ) of 2*D flops
    per unmasked (query, key) pair and head."""
    lens = kv_lens or (Sk,) * B
    pairs = 0
    for n in lens:
        n = min(max(n, 0), Sk)
        pairs += (sum(min(q + 1, n) for q in range(Sq)) if causal
                  else Sq * n)
    return 10.0 * H * D * pairs


def attention_bwd_bound(B, Sq, Sk, H, Kh, D, causal, kv_lens, dtype):
    """Least time for the backward's work (``attention_bwd_flops``) over
    the peak rate of the input type, against q, k, v, o, dO and lse read
    once and dq, dk, dv written once over HBM bandwidth."""
    import torch
    esize = torch.finfo(dtype).bits // 8
    flops = attention_bwd_flops(B, Sq, Sk, H, Kh, D, causal, kv_lens)
    nbytes = (esize * (3 * 2 * B * Sq * H * D + 2 * 2 * B * Sk * Kh * D)
              + 4 * B * H * Sq)
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_bytes, t_ops = nbytes / H100_HBM_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bwd_check(got, ref, dname: str) -> dict:
    """One of dq / dk / dv against its plain version: the errors and whether
    they are inside BWD_FRO_TOL and BWD_MAX_TOL."""
    o, r = got.float(), ref.float()
    diff = (o - r).abs()
    err, scale = float(diff.max()), float(r.abs().max())
    rel_fro = float(diff.norm() / r.norm()) if float(r.norm()) > 0 else float(diff.norm())
    ok = (rel_fro <= BWD_FRO_TOL[dname]
          and err <= BWD_MAX_TOL[dname] * scale)
    return {"max_abs_err": err, "max_abs_ref": scale, "rel_fro": rel_fro,
            "ok": ok}


def lse_check(lse, ref) -> dict:
    """The forward kernel's lse against the plain one."""
    import torch
    inf = torch.isinf(ref)
    same_inf = bool(torch.equal(torch.isinf(lse), inf)
                    and (lse[inf] < 0).all())
    fin = ~inf
    err = float((lse[fin] - ref[fin]).abs().max()) if fin.any() else 0.0
    return {"lse_max_abs_err": err, "lse_empty_rows": int(inf.sum()),
            "lse_ok": same_inf and err <= BWD_LSE_TOL}


def k1_cold_ms(B, S, H, Kh, D, layers, device, Sk=None, causal=True
               ) -> dict:
    """Cold-L2 device time per launch of K1's forward and of SDPA (causal
    unless asked, Sq = S, Sk = ``Sk`` or S): one CUDA graph launches each
    once per layer over its own q, k and v, as a prefill or a train forward
    does (``graph_ms`` replays one input, which stays in L2 when it
    fits)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=device).manual_seed(2)
    qkv = [k1_inputs(gen, B, S, Sk or S, H, Kh, D, torch.bfloat16, device)
           for _ in range(layers)]
    out = {"cold_ms": graph_ms(lambda: [ops.flash_attention(q, k, v,
                                                            causal=causal)
                                        for q, k, v in qkv],
                               iters=1, reps=10) / layers}
    qkv = [tuple(t.transpose(1, 2).contiguous() for t in x) for x in qkv]
    gqa = {"enable_gqa": True} if H != Kh else {}
    out["library_cold_ms"] = graph_ms(
        lambda: [F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                **gqa)
                 for q, k, v in qkv], iters=1, reps=10) / layers
    out["cold_layers"] = layers
    return out


def profiled_device_ms(fn, calls: int = 10, windows: int = 2) -> float:
    """Device time per call of ``fn``: the summed time of the device
    kernels and memsets its ``calls`` calls launch in a torch.profiler
    window, over ``calls``; the largest of ``windows`` windows (a window in
    which the profiler missed a kernel record only reads low)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    best = 0.0
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
        best = max(best, busy / 1e3 / calls)
    return best


def phase_kernel_bwd(device, cases):
    """K1's backward against its plain version on every case (and the
    forward's lse against the plain lse), launched twice per case: the two
    results must be bit-equal.  At the training shape also device times of
    the kernel warm (one input replayed, CUDA graph) and cold
    (``TRAIN_LAYERS`` layers' own tensors in one graph), of the plain
    version, of SDPA's backward (autograd of ``scaled_dot_product_attention``
    on the same tensors, the backward alone: its kernels' device time in a
    profiler window, and the host-clock time of back-to-back calls), the
    bound and the TFLOP/s attained.  Returns the timed row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=device).manual_seed(3)
    timed_row = None
    for case in cases:
        B, Sq, Sk, H, Kh, D, causal, kv_lens, dtypes, timed = case
        for dname in dtypes:
            dtype = getattr(torch, dname)
            q, k, v = k1_inputs(gen, B, Sq, Sk, H, Kh, D, dtype, device)
            do = torch.randn(B, Sq, H, D, generator=gen,
                             device=device).to(dtype)
            lens = (None if kv_lens is None else
                    torch.tensor(kv_lens, dtype=torch.int32, device=device))
            sm = 1.0 / math.sqrt(D)
            o, lse = ops._forward(q, k, v, causal=causal, sm_scale=sm,
                                  kv_lens=lens, with_lse=True)
            got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                          kv_lens=lens)
            again = ops.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=causal, kv_lens=lens)
            torch.cuda.synchronize()
            bit_repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
            _, lse_ref = ops.flash_attention_plain(
                q, k, v, causal=causal, kv_lens=lens, return_lse=True)
            ref = ops.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                causal=causal, kv_lens=lens)
            row = {"shape": [B, Sq, Sk, H, Kh, D], "causal": causal,
                   "kv_lens": kv_lens, "dtype": dname,
                   "bit_repeat": bit_repeat}
            ok = bit_repeat
            for name, g, r in zip(("dq", "dk", "dv"), got, ref):
                c = bwd_check(g, r, dname)
                row.update({f"{name}_{key}": val for key, val in c.items()})
                ok = ok and c["ok"]
            row.update(lse_check(lse, lse_ref))
            row["fro_tol"], row["max_tol"] = BWD_FRO_TOL[dname], BWD_MAX_TOL[dname]
            row["ok"] = ok and row["lse_ok"]
            del ref, lse_ref
            if timed:
                def run():
                    return ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                   causal=causal, kv_lens=lens)
                row["ms"] = graph_ms(run, iters=5)
                row["plain_ms"] = cuda_ms(lambda: ops.flash_attention_bwd_plain(
                    q, k, v, o, lse, do, causal=causal, kv_lens=lens),
                    iters=3, warmup=1)
                qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                              for t in (q, k, v))
                ot = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal,
                    **({"enable_gqa": True} if H != Kh else {}))
                dot = do.transpose(1, 2).contiguous()

                def sdpa_bwd():
                    return torch.autograd.grad(ot, (qt, kt, vt), dot,
                                               retain_graph=True)
                row["library_ms"] = profiled_device_ms(sdpa_bwd)
                row["library_host_ms"] = cuda_ms(sdpa_bwd)
                del qt, kt, vt, ot, dot
                row["bound_ms"], row["bound_by"] = attention_bwd_bound(
                    B, Sq, Sk, H, Kh, D, causal, kv_lens, dtype)
                # TFLOP/s over the five products the bound counts
                row["tflops"] = attention_bwd_flops(
                    B, Sq, Sk, H, Kh, D, causal, kv_lens) / row["ms"] / 1e9
                row["sdpa_ratio"] = row["ms"] / row["library_ms"]
                if dname == "bfloat16":
                    row.update(bwd_cold_ms(q, k, v, o, lse, do, causal,
                                           TRAIN_LAYERS))
                    timed_row = row
            emit("kernel_bwd", name="flash_attention_bwd", **row)
            if not row["ok"]:
                raise AssertionError(f"flash_attention_bwd disagrees with "
                                     f"its plain version: {row}")
    return timed_row


def bwd_cold_ms(q, k, v, o, lse, do, causal, layers) -> dict:
    """Cold-L2 device time per launch of K1's backward: one CUDA graph
    launches it once per layer over ``layers`` copies of the inputs (each
    layer's tensors last read ``layers`` - 1 launches earlier)."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    sets = [tuple(t.clone() for t in (q, k, v, o, lse, do))
            for _ in range(layers)]
    ms = graph_ms(lambda: [ops.flash_attention_bwd(*x[:5], x[5],
                                                   causal=causal)
                           for x in sets], iters=1, reps=5) / layers
    del sets
    torch.cuda.empty_cache()
    return {"cold_ms": ms, "cold_layers": layers}


def phase_kernel(device, cases):
    """K1 against its plain version on every case, launched twice (the two
    outputs must be bit-equal: the kernel uses no atomics); the timed cases
    also get device times (CUDA graphs) of the kernel, the plain version
    and SDPA, the kernel's back-to-back eager time, and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=device).manual_seed(0)
    rows = {}
    for case in cases:
        B, Sq, Sk, H, Kh, D, causal, kv_lens, dtypes, timed = case
        for dname in dtypes:
            dtype = getattr(torch, dname)
            q, k, v = k1_inputs(gen, B, Sq, Sk, H, Kh, D, dtype, device)
            lens = (None if kv_lens is None else
                    torch.tensor(kv_lens, dtype=torch.int32, device=device))
            out = ops.flash_attention(q, k, v, causal=causal, kv_lens=lens)
            again = ops.flash_attention(q, k, v, causal=causal, kv_lens=lens)
            torch.cuda.synchronize()
            bit_repeat = torch.equal(out, again)
            del again
            ref = ops.flash_attention_plain(q, k, v, causal=causal,
                                            kv_lens=lens)
            row = {"shape": [B, Sq, Sk, H, Kh, D], "causal": causal,
                   "kv_lens": kv_lens, "dtype": dname,
                   "bit_repeat": bit_repeat, **k1_check(out, ref, dname)}
            row["ok"] = row["ok"] and bit_repeat
            del out, ref
            if timed:
                sm = 1.0 / math.sqrt(D)
                row["ms"] = graph_ms(lambda: ops.flash_attention(
                    q, k, v, causal=causal, kv_lens=lens))
                row["eager_ms"] = cuda_ms(lambda: ops.flash_attention(
                    q, k, v, causal=causal, kv_lens=lens))
                row["plain_ms"] = graph_ms(lambda: ops.flash_attention_plain(
                    q, k, v, causal=causal, kv_lens=lens), iters=5)
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                row["library_ms"] = graph_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, scale=sm,
                        **({"enable_gqa": True} if H != Kh else {})))
                row["bound_ms"], row["bound_by"] = attention_bound(
                    B, Sq, Sk, H, Kh, D, causal, kv_lens, dtype)
                row["sdpa_ratio"] = row["ms"] / row["library_ms"]
            emit("kernel", name="flash_attention_fwd", **row)
            if not row["ok"]:
                raise AssertionError(f"flash_attention disagrees with its "
                                     f"plain version: {row}")
            rows[(case, dname)] = row
    return rows


def quant_bound(rows, features, in_bytes, out_bytes, flops_per_elem):
    """Least time for K2a (in = x, out = q) or K2b (in = q, out = x): x and
    q read or written once, 4 bytes of scale per row, against
    ``flops_per_elem`` f32 operations per element over the f32 peak."""
    nbytes = rows * features * (in_bytes + out_bytes) + 4 * rows
    t_bytes = nbytes / H100_HBM_BYTES_S
    t_ops = flops_per_elem * rows * features / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def quant_check(x, out_like=None, strict=True) -> dict:
    """K2a and K2b against their plain versions on ``x``, bit for bit.  K2b
    writes into ``out_like`` when given (a strided slot row), else into a
    new tensor.  With ``strict``, raises on any difference; ``ok`` says
    whether there was none."""
    import torch
    from repro_torch.kernels.quant_offload import ops as Q

    q, s = Q.quantize(x)
    torch.cuda.synchronize()
    qp, sp = Q.quantize_plain(x)
    out = Q.dequantize(q, s, x.dtype, out=out_like)
    torch.cuda.synchronize()
    xp = Q.dequantize_plain(q, s, x.dtype)
    row = {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
           "strided": not x.is_contiguous(),
           "q_equal": torch.equal(q, qp), "scales_equal": torch.equal(s, sp),
           "out_equal": torch.equal(out, xp),
           "q_max_abs_diff": int((q.int() - qp.int()).abs().max()),
           "out_max_abs_diff": float((out.float() - xp.float()).abs().max())}
    row["ok"] = row["q_equal"] and row["scales_equal"] and row["out_equal"]
    emit("quant", **row)
    if strict and not row["ok"]:
        raise AssertionError(f"int8 kernels differ from their plain "
                             f"versions: {row}")
    return row


def quant_rows(device, strict=True):
    """``quant_check`` on every QUANT_SHAPES case in both dtypes, then on the
    KV spill's strided slot row, with no timing.  Returns the rows and the
    slot row's (x, dst), views of two (32, 4, 1024, 32, 128) bf16 caches.
    The K2a/K2b check of this script and of the mutation tool."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for shape in QUANT_SHAPES:
        for dname in BOTH:
            x = torch.randn(*shape, generator=gen, device=device).to(
                getattr(torch, dname))
            rows.append(quant_check(x, strict=strict))
    cache = torch.randn(*KV_CACHE_SHAPE, generator=gen, device=device,
                        dtype=torch.bfloat16)
    cache[:, :, KV_FILLED:] = 0
    restored = torch.zeros_like(cache)
    x, dst = cache[:, 1], restored[:, 1]
    rows.append(quant_check(x, out_like=dst, strict=strict))
    return rows, (x, dst)


def quant_path(x) -> str:
    """The K2a kernel that quantizes ``x``, by the name torch.profiler
    records: "vector" (``quant_vec_rows``) or "scalar" (``quant_rows``).
    The profiler can miss a kernel in a process's first sessions (on an
    H100, 3 of the first 40 missed it), so a session that recorded neither
    kernel is run again."""
    from repro_torch.kernels.quant_offload import ops as Q
    for _ in range(5):
        counts = device_kernel_counts(lambda: Q.quantize(x))
        vec = sum(n for k, n in counts.items() if "quant_vec_rows" in k)
        scalar = sum(n for k, n in counts.items()
                     if "quant_rows" in k and "dequant_rows" not in k)
        if vec or scalar:
            return "vector" if vec else "scalar"
    raise AssertionError("torch.profiler recorded no K2a kernel in 5 "
                         "sessions")


def phase_quant(device):
    """K2a and K2b against their plain versions on every case, then device
    times (CUDA graphs) at the KV spill's strided slot row, with the bound;
    the slot row must take K2a's vector kernel."""
    import torch
    from repro_torch.kernels.quant_offload import ops as Q

    rows, (x, dst) = quant_rows(device)
    main = rows[-1]
    path = quant_path(x)
    if path != "vector":
        raise AssertionError("the KV spill's slot row did not take K2a's "
                             "vector kernel (quant_vec_rows)")
    q, s = Q.quantize(x)
    L, S, Kh, F = x.shape
    R = L * S * Kh
    # K2b's library yardstick: one broadcast multiply, computed in f32 and
    # rounded to bf16 as it is stored into the strided row
    torch.mul(q, s, out=dst)
    library_equal = torch.equal(dst, Q.dequantize_plain(q, s, torch.bfloat16))
    timed = {
        "quantize_rows": {
            "path": path,
            "ms": graph_ms(lambda: Q.quantize(x)),
            "plain_ms": graph_ms(lambda: Q.quantize_plain(x), iters=5),
            "bound": quant_bound(R, F, 2, 1, 5),
            "library_ms": None,
            "library": "none: no single PyTorch call computes row-wise "
                       "absmax int8 quantization"},
        "dequantize_rows": {
            "ms": graph_ms(lambda: Q.dequantize(q, s, out=dst)),
            "plain_ms": graph_ms(
                lambda: dst.copy_(Q.dequantize_plain(q, s, torch.bfloat16)),
                iters=5),
            "bound": quant_bound(R, F, 1, 2, 2),
            "library_ms": graph_ms(lambda: torch.mul(q, s, out=dst)),
            "library": "torch.mul(q, s, out=row)",
            "library_equal": library_equal},
    }
    for name, t in timed.items():
        t["bound_ms"], t["bound_by"] = t.pop("bound")
        emit("quant_time", name=name, shape=main["shape"], rows=R,
             features=F, dtype="bfloat16", strided=True, **t)
    del x, dst, q, s
    max_q = max(r["q_max_abs_diff"] for r in rows)
    max_out = max(r["out_max_abs_diff"] for r in rows)
    return timed, max_q, max_out


def decode_rows(device, cases):
    """K3 against its plain version on every case in both dtypes, with no
    timing, launched twice (bit-equal) and once more writing the lse;
    returns the rows (``ok`` says whether a row is inside every limit).
    The K3 check of this script and of the mutation tool."""
    import torch
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for B, Sk, H, Kh, D, lens, timed in cases:
        for dname in BOTH:
            dtype = getattr(torch, dname)
            q, k, v = k1_inputs(gen, B, 1, Sk, H, Kh, D, dtype, device)
            lens_t = torch.tensor(lens, dtype=torch.int32, device=device)
            out = ops.flash_decode(q, k, v, lens_t)
            again = ops.flash_decode(q, k, v, lens_t)
            out2, lse = ops.flash_decode(q, k, v, lens_t, return_lse=True)
            torch.cuda.synchronize()
            ref, ref_lse = ops.flash_decode_plain(q, k, v, lens_t,
                                                  return_lse=True)
            row = {"shape": [B, Sk, H, Kh, D], "lens": list(lens),
                   "dtype": dname, **k1_check(out, ref, dname),
                   **lse_check(lse, ref_lse),
                   "bit_repeat": bool(torch.equal(out, again)),
                   "lse_out_equal": bool(torch.equal(out, out2))}
            zero = [b for b, n in enumerate(lens) if n <= 0]
            row["zero_rows_zero"] = all(not out[b].any() for b in zero)
            row["ok"] = (row["ok"] and row["zero_rows_zero"]
                         and row["lse_ok"] and row["lse_out_equal"]
                         and row["bit_repeat"])
            rows.append((row, (q, k, v, lens_t) if timed else None))
    return rows


def decode_cold_ms(q, lens, Sk, Kh, layers, fns=None) -> dict:
    """Cold-L2 device time per launch of K3 and of SDPA (``cold_ms``,
    ``library_cold_ms``): one CUDA graph launches each once per layer over
    the slices of a (layers, B, Smax, Kh, D) K and V cache drawn here (q
    and k peaked as in ``k1_inputs``), SDPA over per-layer (B, H, Smax, D)
    copies made before capture.  ``fns`` maps more names to ``fn(q, k, v,
    lens)`` to time the same way (``tools/k3_splits.py``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops

    B, _, H, D = q.shape
    gen = torch.Generator(device=q.device).manual_seed(1)
    shape = (B, Sk, Kh, D)
    kc = torch.empty((layers,) + shape, dtype=q.dtype, device=q.device)
    vc = torch.empty_like(kc)
    for l in range(layers):
        kc[l] = torch.randn(shape, generator=gen, device=q.device) * QK_SCALE
        vc[l] = torch.randn(shape, generator=gen, device=q.device)
    fns = {"cold_ms": lambda q, k, v, n: ops.flash_decode(q, k, v, n),
           **(fns or {})}
    out = {}
    for name, fn in fns.items():
        out[name] = graph_ms(lambda: [fn(q, kc[l], vc[l], lens)
                                      for l in range(layers)],
                             iters=1, reps=10) / layers
    qt = q.transpose(1, 2).contiguous()
    kt = [kc[l].transpose(1, 2).contiguous() for l in range(layers)]
    vt = [vc[l].transpose(1, 2).contiguous() for l in range(layers)]
    del kc, vc
    mask = (torch.arange(Sk, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    gqa = {"enable_gqa": True} if H != Kh else {}
    out["library_cold_ms"] = graph_ms(
        lambda: [F.scaled_dot_product_attention(qt, kt[l], vt[l],
                                                attn_mask=mask, **gqa)
                 for l in range(layers)], iters=1, reps=10) / layers
    out["cold_layers"] = layers
    return out


def phase_decode_kernel(device, cases):
    """K3 against its plain version on every case; at the serve decode
    shape also device times (CUDA graphs) of the kernel, the plain version
    and SDPA over all Smax slots with a boolean length mask, and the
    bound; in bf16 also both cold (``decode_cold_ms``).  Returns the timed
    bf16 row and the largest bf16 error at the serve decode shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops

    timed_row, main_err = None, 0.0
    for row, inputs in decode_rows(device, cases):
        if inputs is not None:
            q, k, v, lens = inputs
            B, Sk, H, Kh, D = row["shape"]
            row["ms"] = graph_ms(lambda: ops.flash_decode(q, k, v, lens))
            row["eager_ms"] = cuda_ms(lambda: ops.flash_decode(q, k, v, lens))
            # the kv_seq cache's call: the same launch writing each row's lse
            row["lse_ms"] = graph_ms(lambda: ops.flash_decode(
                q, k, v, lens, return_lse=True))
            row["plain_ms"] = graph_ms(
                lambda: ops.flash_decode_plain(q, k, v, lens), iters=5)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            mask = (torch.arange(Sk, device=device)[None, :]
                    < lens[:, None])[:, None, None, :]
            row["library_ms"] = graph_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    **({"enable_gqa": True} if H != Kh else {})))
            row["bound_ms"], row["bound_by"] = attention_bound(
                B, 1, Sk, H, Kh, D, False, row["lens"], q.dtype)
            if row["dtype"] == "bfloat16":
                row.update(decode_cold_ms(q, lens, Sk, Kh,
                                          DECODE_COLD_LAYERS))
                timed_row = row
        if row["shape"][1:] == [1024, 32, 32, 128] and row["dtype"] == "bfloat16":
            main_err = max(main_err, row["max_abs_err"])
        emit("decode_kernel", name="flash_decode_fwd", **row)
        if not row["ok"]:
            raise AssertionError(f"flash_decode disagrees with its plain "
                                 f"version: {row}")
    return timed_row, main_err


def phase_kernel_cross(device) -> dict:
    """K1's forward and backward at CROSS_CASES, bf16.  The forward is
    launched twice (the two outputs bit-equal) and held to its plain
    version, then timed warm (CUDA graph), cold (``k1_cold_ms``, one launch
    per layer's own q, k, v over TRAIN_LAYERS layers) and beside its plain
    version, SDPA and the bound; the backward goes through
    ``phase_kernel_bwd`` (two bit-equal launches, its plain version, timed
    warm and cold beside SDPA's backward and the bound).  Returns
    {name: {"fwd": row, "bwd": row}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=device).manual_seed(4)
    out = {}
    for B, Sq, Sk, H, Kh, D, causal, name in CROSS_CASES:
        dtype = torch.bfloat16
        q, k, v = k1_inputs(gen, B, Sq, Sk, H, Kh, D, dtype, device)
        got = ops.flash_attention(q, k, v, causal=causal)
        again = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        bit_repeat = torch.equal(got, again)
        del again
        ref = ops.flash_attention_plain(q, k, v, causal=causal)
        row = {"case": name, "shape": [B, Sq, Sk, H, Kh, D],
               "causal": causal, "dtype": "bfloat16",
               "bit_repeat": bit_repeat, **k1_check(got, ref, "bfloat16")}
        row["ok"] = row["ok"] and bit_repeat
        del got, ref
        row["ms"] = graph_ms(lambda: ops.flash_attention(q, k, v,
                                                         causal=causal))
        row["plain_ms"] = cuda_ms(lambda: ops.flash_attention_plain(
            q, k, v, causal=causal), iters=3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row["library_ms"] = graph_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal,
                **({"enable_gqa": True} if H != Kh else {})))
        del q, k, v, qt, kt, vt
        row["sdpa_ratio"] = row["ms"] / row["library_ms"]
        row["bound_ms"], row["bound_by"] = attention_bound(
            B, Sq, Sk, H, Kh, D, causal, None, dtype)
        row.update(k1_cold_ms(B, Sq, H, Kh, D, TRAIN_LAYERS, device, Sk=Sk,
                              causal=causal))
        emit("kernel_cross", name="flash_attention_fwd", **row)
        if not row["ok"]:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version or with itself at {name}: {row}")
        torch.cuda.empty_cache()
        bwd = phase_kernel_bwd(device, [(B, Sq, Sk, H, Kh, D, causal, None,
                                         ("bfloat16",), True)])
        out[name] = {"fwd": row, "bwd": bwd}
        torch.cuda.empty_cache()
    return out


def phase_decode_cross(device) -> dict:
    """K3 over a whole memory at DECODE_CROSS_CASES (``phase_decode_kernel``:
    both dtypes against the plain version, bf16 timed warm and cold beside
    SDPA and the byte bound).  Returns {"T_mem x H/Kh": bf16 row}."""
    import torch
    out = {}
    for case in DECODE_CROSS_CASES:
        row, _ = phase_decode_kernel(device, [case])
        out[f"{case[1]}x{case[2]}/{case[3]}"] = row
        torch.cuda.empty_cache()
    return out


def cross_summary(row) -> dict:
    """The timing fields of a cross-path row for the kernels line."""
    return {k: row.get(k) for k in (
        "shape", "causal", "lens", "ms", "cold_ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "library_cold_ms", "max_abs_err",
        "bit_repeat")}


def ssd_inputs(gen, B, S, H, P, N, dtype, device):
    """x (B,S,H,P), dt (B,S,H) f32 in [0.01, 1], A = -(1..H), and Bm/Cm
    (B,S,N): x, Bm and Cm are views into one (B, S, H*P + 2N) tensor, as
    the model's convolution output gives them."""
    import torch
    xbc = torch.cat([torch.randn(B, S, H * P, generator=gen, device=device)
                     * 0.5,
                     torch.randn(B, S, 2 * N, generator=gen, device=device)
                     * 0.3], dim=-1).to(dtype)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    dt = 0.01 + 0.99 * torch.rand(B, S, H, generator=gen, device=device)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=device)
    return x, dt, A, xbc[..., H * P:H * P + N], xbc[..., H * P + N:]


def ssd_check(y, yr, st, sr, dname) -> dict:
    """K4's y and final state against its plain version: finite, and inside
    the elementwise and relative Frobenius limits of SSD_TOL and
    SSD_STATE_TOL."""
    import torch
    row, ok = {}, True
    for key, got, want, (tol, fro) in (("y", y, yr, SSD_TOL[dname]),
                                       ("state", st, sr, SSD_STATE_TOL)):
        g, w = got.float(), want.float()
        diff = (g - w).abs()
        rel_fro = float(diff.norm() / w.norm())
        row[f"{key}_max_abs_err"] = float(diff.max())
        row[f"{key}_max_abs_ref"] = float(w.abs().max())
        row[f"{key}_rel_fro"] = rel_fro
        ok = (ok and bool(torch.isfinite(g).all()) and rel_fro <= fro
              and bool((diff <= tol + tol * w.abs()).all()))
    row["ok"] = ok
    return row


def ssd_bytes(B, S, H, P, N, esize):
    """Bytes the SSD scan must move: x, Bm, Cm, dt and A read once, y and
    the f32 state written once."""
    return (2 * B * S * H * P * esize + 2 * B * S * N * esize
            + 4 * B * S * H + 4 * H + 4 * B * H * P * N)


def ssd_bound_f32(B, S, H, P, N, chunk, esize):
    """The SSD scan's bound with every product an f32 FMA (kept beside
    ``ssd_bound`` so earlier measurements compare): the bytes over HBM
    bandwidth against the f32 multiply-adds of the chunked algorithm (C B^T
    once per chunk over its causal pairs, and per head the masked product
    with x, the carried state's term and the state update) over the f32
    peak.  Returns ms."""
    macs = 0
    for c0 in range(0, S, chunk):
        c = min(chunk, S - c0)
        pairs = c * (c + 1) // 2
        macs += B * (pairs * N + H * (pairs * P + 2 * c * P * N))
    t_bytes = ssd_bytes(B, S, H, P, N, esize) / H100_HBM_BYTES_S
    return max(t_bytes, 2 * macs / H100_F32_FLOPS) * 1e3


def ssd_bound(B, S, H, P, N, chunk, esize):
    """Least time for the bf16 SSD scan on these inputs, with its products
    on the tensor cores: the bytes over HBM bandwidth against the larger of
    (a) the tensor-core work at the dense bf16 peak, C B^T once per chunk
    over its causal pairs, and per head the masked product with x, the
    carried state's term (chunks after the first: the first has no state)
    and the state update, each twice (its f32 operand split into two bf16
    halves), and (b) the work on the f32 units at the f32 peak, one
    operation per exp (exp(cs_i - cs_j) per causal pair, exp(cs) and the
    state-update weight per token) and per multiply of M = CB L dt (two per
    pair).  The two units run at once.  Returns (ms, "bytes" or
    "operations")."""
    tc_macs = f32_ops = 0
    for c0 in range(0, S, chunk):
        c = min(chunk, S - c0)
        pairs = c * (c + 1) // 2
        inter = c * P * N if c0 else 0
        tc_macs += B * (pairs * N + 2 * H * (pairs * P + inter + c * P * N))
        f32_ops += B * H * (3 * pairs + 2 * c)
    t_bytes = ssd_bytes(B, S, H, P, N, esize) / H100_HBM_BYTES_S
    t_ops = max(2 * tc_macs / H100_BF16_FLOPS, f32_ops / H100_F32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_kernel_counts(fn) -> dict:
    """Device kernel name -> launches of one call of ``fn``
    (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def device_kernel_ms(fn, key: str, calls: int = 5) -> dict:
    """Device ms per call of each kernel whose name contains ``key`` over
    ``calls`` calls of ``fn`` (torch.profiler), by the kernel's name up to
    its template arguments."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and key in e.key:
            name = re.search(rf"\w*{key}\w*", e.key).group(0)
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / calls
    return out


def device_kernels(fn, key: str) -> int:
    """Device kernels whose name contains ``key`` that one call of ``fn``
    launches (torch.profiler)."""
    return sum(n for k, n in device_kernel_counts(fn).items() if key in k)


def ssd_rows(device, cfg, lens, dtypes):
    """K4 against its plain version at mamba2-780m's widths for every
    prefill length and dtype, with no timing; returns (row, inputs)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as SSD

    gen = torch.Generator(device=device).manual_seed(0)
    H, P, N, chunk = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.ssm_chunk)
    rows = []
    for S in lens:
        for dname in dtypes:
            ins = ssd_inputs(gen, 1, S, H, P, N, getattr(torch, dname), device)
            y, st = SSD.ssd_scan(*ins, chunk=chunk)
            torch.cuda.synchronize()
            yr, sr = SSD.ssd_scan_plain(*ins, chunk=chunk)
            row = {"shape": [1, S, H, P, N], "chunk": chunk, "dtype": dname,
                   **ssd_check(y, yr, st, sr, dname)}
            rows.append((row, ins))
    return rows


def phase_ssd_kernel(device, cfg):
    """K4 against its plain version (y and final state) at every prefill
    length, bf16 as served and f32; device times (CUDA graphs) of the
    kernel and its plain version in bf16, and the bound.  Returns the bf16
    rows by length."""
    from repro_torch.kernels.ssd_scan import ops as SSD

    timed = {}
    for row, ins in ssd_rows(device, cfg, SSD_LENS, BOTH):
        if row["dtype"] == "bfloat16":
            chunk = row["chunk"]
            row["ms"] = graph_ms(lambda: SSD.ssd_scan(*ins, chunk=chunk))
            row["plain_ms"] = graph_ms(
                lambda: SSD.ssd_scan_plain(*ins, chunk=chunk), iters=3)
            row["bound_ms"], row["bound_by"] = ssd_bound(*row["shape"],
                                                         chunk, 2)
            row["bound_f32_ms"] = ssd_bound_f32(*row["shape"], chunk, 2)
            row["passes"] = device_kernels(
                lambda: SSD.ssd_scan(*ins, chunk=chunk), "ssd_scan")
            row["library_ms"] = None
            row["library"] = ("none: no single PyTorch call computes the "
                              "SSD chunked scan")
            timed[row["shape"][1]] = row
        emit("ssd_kernel", name="ssd_scan_fwd", **row)
        if not row["ok"]:
            raise AssertionError(f"ssd_scan disagrees with its plain "
                                 f"version: {row}")
    return timed


def ssd_bwd_bytes(B, S, H, P, N, chunk, esize):
    """Bytes K4's backward must move: x, dy, Bm, Cm, dt, A and the forward's
    saved incoming states, CB and cs read once, dx, ddt, dA, dB and dC
    written once."""
    nc = -(-S // chunk)
    saved = 4 * (B * nc * H * P * N + B * nc * chunk * chunk
                 + B * nc * H * chunk)
    return (3 * B * S * H * P * esize + 4 * B * S * N * esize
            + 2 * 4 * B * S * H + 2 * 4 * H + saved)


def ssd_bwd_macs(B, S, H, P, N, chunk):
    """Multiply-adds of the chunked SSD backward, as (bf16 x bf16 products,
    products with one f32 operand, f32 element operations): per head dM =
    dy x^T over the causal pairs (both operands exact in bf16), and M^T dy,
    D B^T, exp(cs) dy C^T (Q), S_0 C^T and S_0^T dy (chunks after the first)
    and D^T x w (f32 on one side); per chunk dG B and dG^T C; per head and
    pair the exp of L and about eight multiplies of M, dM o L o dt and
    their sums."""
    exact = f32_side = elem = 0
    for c0 in range(0, S, chunk):
        c = min(chunk, S - c0)
        pairs = c * (c + 1) // 2
        inter = c * P * N if c0 else 0
        exact += B * H * pairs * P
        f32_side += B * (2 * pairs * N
                         + H * (pairs * P + 3 * c * P * N + 2 * inter))
        elem += B * H * (9 * pairs + 8 * c)
    return exact, f32_side, elem


def ssd_bwd_bound(B, S, H, P, N, chunk, esize):
    """Least time for K4's backward on these inputs: the bytes over HBM
    bandwidth against the larger of the tensor-core work at the dense bf16
    peak (a product with an f32 operand twice, that operand split into two
    bf16 halves, as the forward's bound counts it) and the element
    operations at the f32 peak.  Returns (ms, "bytes" or "operations",
    f32_ms): f32_ms counts every multiply-add as an f32 FMA at the f32 peak,
    the bound of a kernel that runs its products off the tensor cores."""
    exact, f32_side, elem = ssd_bwd_macs(B, S, H, P, N, chunk)
    t_bytes = ssd_bwd_bytes(B, S, H, P, N, chunk, esize) / H100_HBM_BYTES_S
    t_ops = max(2 * (exact + 2 * f32_side) / H100_BF16_FLOPS,
                elem / H100_F32_FLOPS)
    f32 = max(t_bytes, (2 * (exact + f32_side) + elem) / H100_F32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", f32 * 1e3)


def ssd_bwd_check(got, want, dname) -> dict:
    """K4 backward's dx, ddt, dA, dB and dC against its plain version (f32
    on the same inputs): finite, and each inside SSD_BWD_TOL[dname]."""
    import torch
    fro_tol, max_tol = SSD_BWD_TOL[dname]
    row, ok = {}, True
    for key, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        scale = float(w.abs().max())
        row[f"{key}_max_abs_err"] = float(diff.max())
        row[f"{key}_max_abs_ref"] = scale
        row[f"{key}_rel_fro"] = float(diff.norm() / w.norm())
        ok = (ok and bool(torch.isfinite(g).all())
              and row[f"{key}_rel_fro"] <= fro_tol
              and row[f"{key}_max_abs_err"] <= max_tol * scale)
    row["ok"] = ok
    return row


def ssd_bwd_cold_ms(ins, dy, dst, chunk, layers) -> float:
    """Cold-L2 device time per launch of K4's backward: one CUDA graph
    launches it once per layer over ``layers`` copies of the inputs and
    saved states, as a train step's backward does."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as SSD
    sets = []
    for _ in range(layers):
        x, dt, A, Bm, Cm = (t.clone() for t in ins)
        sets.append((x, dt, A, Bm, Cm, dy.clone(), dst.clone(),
                     SSD.ssd_scan_saved(x, dt, A, Bm, Cm, chunk=chunk)[2]))
    ms = graph_ms(lambda: [SSD.ssd_scan_bwd(*z[:7], saved=z[7], chunk=chunk)
                           for z in sets], iters=1, reps=5) / layers
    del sets
    torch.cuda.empty_cache()
    return ms


def ssd_fwd_cold_ms(ins, chunk, layers) -> float:
    """Cold-L2 device time per launch of K4's forward as a train step
    launches it (keeping the states its backward reads): one CUDA graph
    launches it once per layer over ``layers`` copies of the inputs."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as SSD
    sets = [tuple(t.clone() for t in ins) for _ in range(layers)]
    ms = graph_ms(lambda: [SSD.ssd_scan_saved(*z, chunk=chunk) for z in sets],
                  iters=1, reps=5) / layers
    del sets
    torch.cuda.empty_cache()
    return ms


def ssd_bwd_rows(device, cases):
    """K4's backward against ``ssd_scan_bwd_plain`` (f32 on the same
    inputs) on every case of ``cases`` (SSD_BWD_CASES' layout): x, Bm, Cm
    as for K4's forward (views into one tensor), dy and the final state's
    cotangent unit normals; each case launched twice on the same saved
    states, and ``bit_equal`` says whether the two agree.  The forward
    that saved them (``ssd_scan_saved``, as a train step launches it) is
    held to ``ssd_scan_plain`` on the same inputs (``ssd_check``).  No
    timing; yields (backward row, forward row, inputs of the timed cases
    or None)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as SSD

    gen = torch.Generator(device=device).manual_seed(5)
    for arch, B, S, H, P, N, chunk, dname, is_timed in cases:
        dtype = getattr(torch, dname)
        ins = ssd_inputs(gen, B, S, H, P, N, dtype, device)
        dy = torch.randn(B, S, H, P, generator=gen, device=device).to(dtype)
        dst = torch.randn(B, H, P, N, generator=gen, device=device)
        y, st, saved = SSD.ssd_scan_saved(*ins, chunk=chunk)
        torch.cuda.synchronize()
        yr, sr = SSD.ssd_scan_plain(*ins, chunk=chunk)
        fwd = {"arch": arch, "shape": [B, S, H, P, N], "chunk": chunk,
               "dtype": dname, "layout": "saved",
               **ssd_check(y, yr, st, sr, dname)}
        del y, st, yr, sr
        got = SSD.ssd_scan_bwd(*ins, dy, dst, saved=saved, chunk=chunk)
        again = SSD.ssd_scan_bwd(*ins, dy, dst, saved=saved, chunk=chunk)
        torch.cuda.synchronize()
        want = SSD.ssd_scan_bwd_plain(*(t.float() for t in ins), dy.float(),
                                      dst, chunk=chunk)
        row = {"arch": arch, "shape": [B, S, H, P, N], "chunk": chunk,
               "dtype": dname, **ssd_bwd_check(got, want, dname),
               "bit_equal": all(torch.equal(a, b) for a, b in zip(got, again)),
               "tol": SSD_BWD_TOL[dname]}
        del got, again, want
        yield row, fwd, ((ins, dy, dst, saved) if is_timed else None)
        torch.cuda.empty_cache()


def phase_ssd_bwd_kernel(device, cases):
    """K4's backward on every case of ``ssd_bwd_rows``; each must be inside
    SSD_BWD_TOL and bit-equal over its two launches, and the forward that
    saved its states inside SSD_TOL and SSD_STATE_TOL.  The timed cases (the
    train phases' shapes) also give the device time warm (CUDA graph, one
    input replayed) and cold (SSD_BWD_COLD_LAYERS layers' own inputs),
    each pass's device time, the plain version's time, and the bound, and
    their forward (``ssd_scan_saved``) warm, cold and its bound.
    Returns the timed rows, each with its forward row under ``fwd``."""
    from repro_torch.kernels.ssd_scan import ops as SSD

    timed = []
    for row, fwd, inputs in ssd_bwd_rows(device, cases):
        if inputs is not None:       # the forward at the train shape, timed
            ins, _, _, _ = inputs
            B, S, H, P, N = fwd["shape"]
            fwd["ms"] = graph_ms(lambda: SSD.ssd_scan_saved(
                *ins, chunk=fwd["chunk"]), iters=5)
            fwd["cold_ms"] = ssd_fwd_cold_ms(ins, fwd["chunk"],
                                             SSD_BWD_COLD_LAYERS)
            fwd["bound_ms"], fwd["bound_by"] = ssd_bound(
                B, S, H, P, N, fwd["chunk"], ins[0].dtype.itemsize)
        emit("ssd_kernel", name="ssd_scan_fwd", **fwd)
        if not fwd["ok"]:
            raise AssertionError(f"ssd_scan (saved layout) disagrees with "
                                 f"its plain version: {fwd}")
        if inputs is not None:
            ins, dy, dst, saved = inputs
            B, S, H, P, N = row["shape"]
            chunk = row["chunk"]
            row["ms"] = graph_ms(lambda: SSD.ssd_scan_bwd(
                *ins, dy, dst, saved=saved, chunk=chunk), iters=5)
            row["cold_ms"] = ssd_bwd_cold_ms(ins, dy, dst, chunk,
                                             SSD_BWD_COLD_LAYERS)
            row["cold_layers"] = SSD_BWD_COLD_LAYERS
            row["plain_ms"] = graph_ms(lambda: SSD.ssd_scan_bwd_plain(
                *ins, dy, dst, chunk=chunk), iters=1, reps=3)
            (row["bound_ms"], row["bound_by"],
             row["bound_f32_ms"]) = ssd_bwd_bound(B, S, H, P, N, chunk,
                                                  ins[0].dtype.itemsize)
            row["pass_ms"] = device_kernel_ms(lambda: SSD.ssd_scan_bwd(
                *ins, dy, dst, saved=saved, chunk=chunk), "ssd_bwd")
            row["passes"] = len(row["pass_ms"])
            row["library_ms"] = None
            row["library"] = ("none: no single PyTorch call computes the "
                              "SSD backward")
            row["fwd"] = fwd
            timed.append(row)
            del inputs, ins, dy, dst, saved
        emit("ssd_bwd_kernel", name="ssd_scan_bwd", **row)
        if not (row["ok"] and row["bit_equal"]):
            raise AssertionError(f"ssd_scan_bwd disagrees with its plain "
                                 f"version or with itself: {row}")
    return timed


def phase_serve(device):
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve

    allocated_before = release_device_memory(device)
    ops.flash_attention.launches = 0                  # count the main path only
    ops.flash_decode.launches = 0
    stats = serve.main(SERVE_ARGS)
    launches = ops.flash_attention.launches
    decode_launches = ops.flash_decode.launches
    n_req, n_new, n_layers = 8, 32, 32
    lengths = {rid: len(toks) for rid, toks in stats["results"].items()}
    if stats["completed"] != n_req or set(lengths.values()) != {n_new}:
        raise AssertionError(f"serve: want {n_req} requests of {n_new} "
                             f"tokens, got {lengths}")
    prefills = stats["latency"]["prefill_ms"]["n"]
    if prefills != n_req or launches != prefills * n_layers:
        raise AssertionError(f"serve: flash_attention launched {launches} "
                             f"times for {prefills} prefills x {n_layers} "
                             "layers")
    if decode_launches != stats["ticks"] * n_layers:
        raise AssertionError(f"serve: flash_decode launched "
                             f"{decode_launches} times for {stats['ticks']} "
                             f"decode ticks x {n_layers} layers")
    emit("serve", launches=launches, decode_launches=decode_launches,
         prefills=prefills,
         prompt_lens=stats["prompt_lens"], tokens=stats["tokens"],
         wall_s=stats["wall_s"], tokens_per_s=stats["tokens_per_s"],
         ticks=stats["ticks"], tick_ms=stats["latency"]["tick_ms"],
         prefill_ms=stats["latency"]["prefill_ms"],
         max_memory_allocated=stats["max_memory_allocated"],
         allocated_before=allocated_before)
    return launches, decode_launches, stats["results"]


def release_device_memory(device) -> int:
    """Free what earlier phases left allocated before a serve run, and
    return what is still allocated.  Besides garbage and the caching
    allocator's free blocks, that is one cuBLAS workspace for each stream
    that ran a matrix product (the kernel phase's CUDA-graph timing runs
    the plain versions on side streams)."""
    import torch
    gc.collect()
    after_gc = torch.cuda.memory_allocated(device)
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    allocated = torch.cuda.memory_allocated(device)
    emit("memory", allocated_after_gc=after_gc,
         cublas_workspaces_cleared=clear is not None,
         allocated_after=allocated)
    torch.cuda.reset_peak_memory_stats(device)
    return allocated


def spill_metrics(stats: dict) -> dict:
    """The host tier's end-to-end numbers of one serve run."""
    kv = stats["kv_spill_class"]
    pool = stats["hostmem"]["pool"]
    gbps = lambda b, t: b / t / 1e9 if t > 0 else None   # noqa: E731
    return {
        "preemptions": stats["preemptions"],
        "spills": stats["kvspill"]["n_spills"],
        "restores": stats["kvspill"]["n_restores"],
        "bytes_raw": stats["kvspill"]["bytes_raw"],
        "bytes_spilled": stats["kvspill"]["bytes_spilled"],
        "compression_ratio": stats["kvspill"]["compression_ratio"],
        "kv_spill_d2h_bytes": kv["bytes_out"], "kv_spill_d2h_s": kv["time_out_s"],
        "kv_spill_h2d_bytes": kv["bytes_in"], "kv_spill_h2d_s": kv["time_in_s"],
        "link_d2h_gbps": gbps(kv["bytes_out"], kv["time_out_s"]),
        "link_h2d_gbps": gbps(kv["bytes_in"], kv["time_in_s"]),
        "pool_peak_reserved": pool["peak_reserved"],
        "pool_bytes_in_use": pool["bytes_in_use"],
        "pool_hit_rate": pool["hit_rate"],
    }


def phase_serve_spill(device, resident):
    """The serve run over-subscribed (8 requests admitted over 4 slots):
    raw spill must reproduce the resident run's tokens exactly; int8 spill
    must complete every request through K2a / K2b.  Returns the int8 run's
    launch counts of K2a and K2b, and each run's tokens by compression."""
    from repro_torch.kernels.quant_offload import ops as Q
    from repro_torch.launch import serve

    n_req, n_new = 8, 32
    launches, runs = {}, {}
    for comp in ("none", "int8"):
        allocated_before = release_device_memory(device)
        Q.quantize.launches = Q.dequantize.launches = 0   # this run only
        stats = serve.main(SERVE_ARGS + SPILL_ARGS
                           + ["--spill-compression", comp])
        launches = {"quantize_rows": Q.quantize.launches,
                    "dequantize_rows": Q.dequantize.launches}
        m = spill_metrics(stats)
        got = runs[comp] = stats["results"]
        lengths = {rid: len(t) for rid, t in got.items()}
        agree = [a == b for rid in resident
                 for a, b in zip(got.get(rid, []), resident[rid])]
        emit("serve_spill", compression=comp, tokens=stats["tokens"],
             wall_s=stats["wall_s"], tokens_per_s=stats["tokens_per_s"],
             ticks=stats["ticks"], tick_ms=stats["latency"]["tick_ms"],
             prefill_ms=stats["latency"]["prefill_ms"],
             max_memory_allocated=stats["max_memory_allocated"],
             allocated_before=allocated_before,
             tokens_agree_with_resident=sum(agree) / max(len(agree), 1),
             requests_equal_to_resident=sum(got.get(r) == t
                                            for r, t in resident.items()),
             launches=launches, **m)
        if stats["completed"] != n_req or set(lengths.values()) != {n_new}:
            raise AssertionError(f"serve_spill ({comp}): want {n_req} "
                                 f"requests of {n_new} tokens, got {lengths}")
        if m["preemptions"] <= 0 or m["spills"] != m["restores"]:
            raise AssertionError(f"serve_spill ({comp}): want preemptions "
                                 f"and spills == restores, got {m}")
        if m["pool_bytes_in_use"] != 0:
            raise AssertionError(f"serve_spill ({comp}): pool still holds "
                                 f"{m['pool_bytes_in_use']} bytes")
        if comp == "none":
            if got != resident:
                raise AssertionError("serve_spill (raw): tokens differ from "
                                     "the resident serve run")
            if launches != {"quantize_rows": 0, "dequantize_rows": 0}:
                raise AssertionError(f"raw spill launched the int8 kernels: "
                                     f"{launches}")
        elif (launches["quantize_rows"] != 2 * m["spills"]
              or launches["dequantize_rows"] != 2 * m["restores"]):
            raise AssertionError(f"serve_spill (int8): launches {launches} "
                                 f"for {m['spills']} spills and "
                                 f"{m['restores']} restores")
    return launches, runs


def serve_prompts(n: int, vocab: int):
    """The first ``n`` prompts of the serve phase (RandomState(0) draws)."""
    import numpy as np
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        size = rng.randint(65, 901)
        out.append(rng.randint(0, vocab, size=size))
    return out


def same_routes(first, second):
    """``first()``, then ``second()`` routing every moe token to the
    experts ``first`` chose (``RouteReplay``; nothing to replay for the
    other families).  Top-k routing is discontinuous: where the two
    attention paths' bf16 roundings move a token's router logits across a
    top-k boundary, it reaches other experts, and the logits differ by an
    expert's output, which says nothing of the attention.  Returns (the
    two results, routes whose own top-k differed, routes replayed)."""
    replay = RouteReplay()
    try:
        replay.record()
        a = first()
        replay.replay()
        b = second()
    finally:
        replay.restore()
    return a, b, replay.flips, replay.routed


def phase_crosscheck(device, cfg, model):
    """Flash (K1) against chunked prefill logits of two serve prompts on
    the same weights, moe routes replayed (``same_routes``), within
    CROSSCHECK_TOL; then ``crosscheck_decode``."""
    import torch
    from repro_torch.models import transformer as T

    for prompt in serve_prompts(2, cfg.vocab_size):
        toks = torch.as_tensor(prompt[None], dtype=torch.int64, device=device)
        with torch.no_grad():
            (lf, _), (lc, _), flips, routed = same_routes(
                lambda: T.prefill(cfg.replace(attn_impl="flash"), model,
                                  toks, 1024),
                lambda: T.prefill(cfg.replace(attn_impl="chunked"), model,
                                  toks, 1024))
        lf, lc = lf[0].float(), lc[0].float()
        dmax = float((lf - lc).abs().max())
        rel = dmax / float(lc.abs().max())
        top2 = lc.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * dmax   # argmax can't flip here
        agree = lf.argmax(-1) == lc.argmax(-1)
        row = {"prompt_len": len(prompt), "max_abs_dlogit": dmax,
               "rel_dlogit": rel, "tol": CROSSCHECK_TOL,
               "argmax_agree_last": bool(agree[-1]),
               "argmax_agree_frac": float(agree.float().mean()),
               "decided_positions": int(decided.sum()),
               "decided_agree": bool(agree[decided].all()),
               "route_flips": flips, "routes": routed}
        emit("crosscheck", arch=cfg.name, **row)
        if rel > CROSSCHECK_TOL or not row["decided_agree"]:
            raise AssertionError(f"flash and chunked prefill disagree: {row}")
    crosscheck_decode(device, cfg, model)


def crosscheck_decode(device, cfg, model, ticks: int = 4):
    """Decode under ``flash`` (K3) and ``chunked`` from one prefill state
    (cloned), feeding both the chunked path's greedy tokens, moe routes
    replayed each tick (``same_routes``): the logits of each tick must
    agree within CROSSCHECK_TOL of their largest magnitude."""
    import torch
    from repro_torch.models import transformer as T

    fcfg, ccfg = cfg.replace(attn_impl="flash"), cfg.replace(attn_impl="chunked")
    prompt = serve_prompts(1, cfg.vocab_size)[0]
    toks = torch.as_tensor(prompt[None], dtype=torch.int64, device=device)
    with torch.no_grad():
        logits, sf = T.prefill(fcfg, model, toks, 1024)
        sc = sf._replace(attn_k=sf.attn_k.clone(), attn_v=sf.attn_v.clone(),
                         pos=sf.pos.clone())
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        for t in range(ticks):
            (lf, sf), (lc, sc), flips, routed = same_routes(
                lambda: T.decode_step(fcfg, model, nxt, sf),
                lambda: T.decode_step(ccfg, model, nxt, sc))
            lf, lc = lf[0, 0].float(), lc[0, 0].float()
            dmax = float((lf - lc).abs().max())
            rel = dmax / float(lc.abs().max())
            row = {"decode_tick": t, "pos": int(sc.pos[0]) - 1,
                   "max_abs_dlogit": dmax, "rel_dlogit": rel,
                   "tol": CROSSCHECK_TOL,
                   "argmax_agree": bool(lf.argmax() == lc.argmax()),
                   "route_flips": flips, "routes": routed}
            emit("crosscheck_decode", arch=cfg.name, **row)
            if rel > CROSSCHECK_TOL:
                raise AssertionError(f"flash and chunked decode disagree: "
                                     f"{row}")
            nxt = lc.argmax().reshape(1, 1)


def phase_profile(device, cfg, model):
    """torch.profiler over two windows of the serving loop of ``cfg`` (4
    prefills into the 4 slots, then 8 decode ticks): device busy time is the
    sum of CUDA kernel times (one stream, so kernels do not overlap), idle
    share is 1 - busy / wall, with wall on the host clock under the
    profiler; the port's kernels' device times by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.runtime.server import Server

    srv = Server(cfg.replace(attn_impl="flash"), model, max_batch=4,
                 max_len=1024)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def window(name, fn, n_steps):
        torch.cuda.synchronize()
        calls = ops.flash_decode.launches
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        calls = ops.flash_decode.launches - calls
        kern = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(ms for _, ms, _ in kern)
        kern.sort(key=lambda x: -x[1])
        ours = {name: sum(ms for k, ms, _ in kern if key in k)
                for name, key in (("flash_ms", "flash_fwd"),
                                  ("flash_decode_ms", "flash_decode"),
                                  ("ssd_scan_ms", "ssd_scan"))}
        # K3 in situ: its kernels' device time per ops.flash_decode call
        # (every layer reads its own cache, as the cold yardstick does)
        ours["flash_decode_calls"] = calls
        ours["flash_decode_ms_per_call"] = (ours["flash_decode_ms"] / calls
                                            if calls else None)
        emit("profile", model=cfg.name, window=name, steps=n_steps,
             wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall,
             kernel_launches=sum(n for _, _, n in kern), **ours,
             top=[{"kernel": k[:80], "ms": ms, "n": n}
                  for k, ms, n in kern[:8]])

    prompts = serve_prompts(4, cfg.vocab_size)
    window("prefill", lambda: [srv.submit(p, max_new_tokens=32)
                               for p in prompts], len(prompts))
    window("decode", lambda: [srv.tick() for _ in range(8)], 8)
    if cfg.family == "dense":
        # the decode path before K3, on the same server 8 positions later
        srv.cfg = cfg.replace(attn_impl="chunked")
        window("decode_chunked", lambda: [srv.tick() for _ in range(8)], 8)
    obs.metrics().unregister_provider("server")


def phase_spill(device, cfg, model):
    """One slot of a full-width server spilled, overwritten on the compute
    stream at once (zeroed, then given a new request's prefill), and
    restored into the free slot: raw must come back bit for bit, int8
    within half a quantization step of its row plus one bf16 rounding."""
    import torch
    from repro_torch import obs
    from repro_torch.common.config import HostMemConfig
    from repro_torch.hostmem import HostMemTier
    from repro_torch.models import transformer as T
    from repro_torch.runtime.server import Server

    fcfg = cfg.replace(attn_impl="flash")
    first, second = serve_prompts(2, cfg.vocab_size)
    for comp in ("none", "int8"):
        tier = HostMemTier(HostMemConfig(spill_compression=comp),
                           device=device)
        srv = Server(fcfg, model, max_batch=2, max_len=1024)
        rid = srv.submit(first, max_new_tokens=32)
        srv.tick()
        slot = srv.active[rid].slot
        free = 1 - slot
        st = srv.state
        k0, v0 = st.attn_k[:, slot].clone(), st.attn_v[:, slot].clone()
        pos0 = int(st.pos[slot])
        sp = tier.kvspill.spill(st, slot, tag="smoke")
        st.attn_k[:, slot].zero_()           # the compute stream, at once
        st.attn_v[:, slot].zero_()
        toks = torch.as_tensor(second[None], dtype=torch.int64, device=device)
        with torch.no_grad():
            _, pst = T.prefill(fcfg, model, toks, 1024)
        st.attn_k[:, slot] = pst.attn_k[:, 0]
        st.attn_v[:, slot] = pst.attn_v[:, 0]
        st.pos[slot] = len(second)
        srv.state = tier.kvspill.restore(st, sp, free)
        torch.cuda.synchronize()
        k1, v1 = st.attn_k[:, free], st.attn_v[:, free]
        row = {"compression": comp, "nbytes": sp.nbytes,
               "pos_equal": int(st.pos[free]) == pos0,
               "overwritten_row_is_new_prefill":
                   torch.equal(st.attn_k[:, slot], pst.attn_k[:, 0])}
        if comp == "none":
            row["k_equal"] = torch.equal(k1, k0)
            row["v_equal"] = torch.equal(v1, v0)
            ok = row["k_equal"] and row["v_equal"]
        else:
            worst = 0.0
            for got, ref in ((k1, k0), (v1, v0)):
                r = ref.float()
                amax = r.abs().amax(dim=-1, keepdim=True)
                # half a quantization step (with 2^-12 of it for the f32
                # quotient and product), plus one bf16 rounding of the
                # result: half an ulp, at most 2^-8 of the value before
                # rounding, which is within 2^-7 of the rounded one
                lim = (amax / 254 * (1 + 2.0 ** -12)
                       + got.float().abs() * 2.0 ** -8 * (1 + 2.0 ** -7)
                       + 1e-30)
                worst = max(worst, float(((got.float() - r).abs()
                                          / lim).max()))
            row["worst_err_over_limit"] = worst
            ok = worst <= 1.0
        ok = ok and row["pos_equal"] and row["overwritten_row_is_new_prefill"]
        row["pool_bytes_in_use"] = tier.pool.bytes_in_use
        emit("spill", **row)
        obs.metrics().unregister_provider("server")
        if not ok or tier.pool.bytes_in_use:
            raise AssertionError(f"spill round trip ({comp}) failed: {row}")
        del srv, st, k0, v0, k1, v1, pst, tier


def train_config():
    """The train phase's TrainConfig; checkpoints off, but the trainer's
    checkpoint manager still makes its directory, so a temporary one."""
    import tempfile
    from repro_torch.common.config import TrainConfig
    return TrainConfig(steps=TRAIN_STEPS, learning_rate=TRAIN_LR,
                       warmup_steps=TRAIN_WARMUP, eval_every=0,
                       checkpoint_every=0,
                       checkpoint_dir=tempfile.mkdtemp(prefix="chip_smoke_"))


def phase_train(device):
    """``Trainer`` on full-width llama2-paper cut to TRAIN_LAYERS layers
    (see TRAIN_STEPS).  K1's forward and backward launch counts are reset
    just before and must each equal steps x layers just after; every loss
    finite and the last two below the first two on average.  Then a
    torch.profiler window over 2 more steps (device busy, idle share, K1's
    shares) and the flash-vs-chunked grad-step crosscheck.  Returns the
    launches (forward, backward)."""
    import shutil
    import torch
    import repro_torch.configs as C
    from repro_torch.common.config import ChameleonConfig
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.runtime.trainer import Trainer

    allocated_before = release_device_memory(device)
    cfg = C.get_config("llama2-paper").replace(num_layers=TRAIN_LAYERS,
                                               attn_impl="flash")
    tcfg = train_config()
    data = SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    tr = Trainer(cfg, tcfg, ChameleonConfig(enabled=False), data=data,
                 device=device)
    n_params = sum(p.numel() for p in tr.model.parameters())
    torch.cuda.synchronize()
    ops.flash_attention.launches = 0                  # count the main path only
    ops.flash_attention_bwd.launches = 0
    rep = tr.train(TRAIN_STEPS)
    fwd, bwd = ops.flash_attention.launches, ops.flash_attention_bwd.launches
    losses = rep.losses
    step_ms = sorted(rep.times[1:])[len(rep.times[1:]) // 2] * 1e3
    row = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "losses": losses, "step_ms": [t * 1e3 for t in rep.times],
           "step_ms_p50": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "max_memory_allocated": torch.cuda.max_memory_allocated(device),
           "allocated_before": allocated_before,
           "launches": fwd, "bwd_launches": bwd,
           "skipped_steps": rep.skipped_steps}
    want = TRAIN_STEPS * TRAIN_LAYERS
    ok = (all(math.isfinite(x) for x in losses)
          and sum(losses[-2:]) < sum(losses[:2])
          and fwd == want and bwd == want and not rep.skipped_steps)
    emit("train", ok=ok, **row)
    if not ok:
        raise AssertionError(f"train: want {TRAIN_STEPS} finite, falling "
                             f"losses and {want} launches of K1's forward "
                             f"and backward: {row}")
    train_profile(tr)
    train_crosscheck(tr)
    shutil.rmtree(tcfg.checkpoint_dir, ignore_errors=True)
    return fwd, bwd


def train_profile(tr, n_steps: int = 2, phase: str = "train_profile"):
    """torch.profiler over ``n_steps`` more train steps: device busy time
    (sum of CUDA kernel times, one stream), idle share 1 - busy / wall, and
    K1's forward and backward device time and share of busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train(n_steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(ms for _, ms, _ in kern)
    kern.sort(key=lambda x: -x[1])
    fwd = sum(ms for k, ms, _ in kern if "flash_fwd" in k)
    # K1 backward's three kernels: bwd_delta, bwd_dkdv_{bf16,f32} and
    # bwd_dq_{bf16,f32} (csrc/flash_attention_bwd.cu)
    bwd = sum(ms for k, ms, _ in kern if "bwd_dkdv" in k or "bwd_dq" in k
              or "bwd_delta" in k)
    bwd_calls = sum(n for k, _, n in kern if "bwd_dkdv" in k)
    # K4's forward passes (ssd_scan_chunk / _state / _output, or the f32
    # ssd_scan_f32) and its backward's (ssd_bwd_*)
    ssd_fwd = sum(ms for k, ms, _ in kern if "ssd_scan_" in k)
    ssd_bwd = sum(ms for k, ms, _ in kern if "ssd_bwd_" in k)
    # device time by kind: cuBLAS products (nvjet / gemm kernels), PyTorch's
    # elementwise and reduction kernels, and the rest
    kinds = {"gemm": ("nvjet", "gemm", "cutlass", "xmma"),
             "elementwise": ("elementwise",), "reduce": ("reduce",)}
    by_kind = {name: sum(ms for k, ms, _ in kern
                         if any(w in k.lower() for w in words))
               for name, words in kinds.items()}
    by_kind["other"] = (busy - fwd - bwd - ssd_fwd - ssd_bwd
                        - sum(by_kind.values()))
    emit(phase, steps=n_steps, wall_ms=wall, device_busy_ms=busy,
         idle_share=1 - busy / wall if wall else None,
         k1_fwd_ms=fwd, k1_bwd_ms=bwd, k1_bwd_calls=bwd_calls,
         k4_fwd_ms=ssd_fwd, k4_bwd_ms=ssd_bwd, by_kind_ms=by_kind,
         k1_fwd_share=fwd / busy if busy else None,
         k1_bwd_share=bwd / busy if busy else None,
         kernel_launches=sum(n for _, _, n in kern),
         top=[{"kernel": k[:80], "ms": ms, "n": n} for k, ms, n in kern[:10]])


def train_crosscheck(tr):
    """One grad step with flash attention and one with chunked attention on
    the trainer's weights and one batch: losses within TRAIN_LOSS_TOL and
    every parameter's gradient within TRAIN_GRAD_TOL relative Frobenius."""
    import torch
    from repro_torch.distributed import steps as S
    batch = tr._device_batch(tr.data.batch_at(0))
    lf, gf, ff = S.make_grad_step(tr.cfg, tr.tcfg)(tr.model, batch, 1.0)
    lc, gc, fc = S.make_grad_step(tr.cfg.replace(attn_impl="chunked"),
                                  tr.tcfg)(tr.model, batch, 1.0)
    rel = {}
    for n in gf:
        d = float((gf[n] - gc[n]).norm() / gc[n].norm().clamp(min=1e-30))
        rel[n] = d
    del gf, gc
    worst = max(rel, key=rel.get)
    row = {"loss_flash": float(lf), "loss_chunked": float(lc),
           "loss_diff": abs(float(lf) - float(lc)),
           "grad_rel_fro_max": rel[worst], "grad_rel_fro_max_at": worst,
           "grad_rel_fro_median": sorted(rel.values())[len(rel) // 2],
           "finite": bool(ff) and bool(fc),
           "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL}
    row["ok"] = (row["finite"] and row["loss_diff"] <= TRAIN_LOSS_TOL
                 and rel[worst] <= TRAIN_GRAD_TOL)
    emit("train_crosscheck", **row)
    torch.cuda.empty_cache()
    if not row["ok"]:
        raise AssertionError(f"flash and chunked training disagree: {row}")


def zoo_counts():
    """The kernel launch counters of K1 (forward, backward) and K4
    (forward, backward), as a dict."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.ssd_scan import ops as SSD
    return {"k1_fwd": ops.flash_attention.launches,
            "k1_bwd": ops.flash_attention_bwd.launches,
            "k4_fwd": SSD.ssd_scan.launches,
            "k4_bwd": SSD.ssd_scan_bwd.launches}


def zero_zoo_counts() -> None:
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.ssd_scan import ops as SSD
    ops.flash_attention.launches = ops.flash_attention_bwd.launches = 0
    SSD.ssd_scan.launches = SSD.ssd_scan_bwd.launches = 0


def zoo_per_step(cfg) -> dict:
    """Launches of each kernel one train step of ``cfg`` makes: K1 once per
    attention application each way (encdec: each encoder block, and each
    decoder block's self- and cross-attention), K4 once per ssm layer each
    way."""
    ssm = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    attn = {"dense": cfg.num_layers, "moe": cfg.num_layers, "ssm": 0,
            "hybrid": cfg.num_layers // max(cfg.hybrid_attn_every, 1),
            "encdec": cfg.encoder_layers + 2 * cfg.num_layers}[cfg.family]
    return {"k1_fwd": attn, "k1_bwd": attn, "k4_fwd": ssm, "k4_bwd": ssm}


def open_gates(model) -> None:
    """Every cross block's ``xgate`` to OPEN_XGATE (see there)."""
    import torch
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("xgate"):
                p.fill_(OPEN_XGATE)


def memory_input(cfg, B, device, seed):
    """Random stub-frontend embeddings (B, T_mem, d) in the activation
    dtype for the families with a second input, else None."""
    import torch
    T = {"vlm": cfg.image_tokens, "encdec": cfg.encoder_seq}.get(cfg.family)
    if T is None:
        return None
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(B, T, cfg.d_model, generator=gen, device=device).to(
        getattr(torch, cfg.dtype))


class RouteReplay:
    """Records the moe family's top-k choices on the kernel side and makes
    the plain sides route the same tokens to the same experts (each gate
    value taken from its own probabilities), so a routing flip under
    another rounding does not hide or fake a kernel fault.  A no-op for
    the other families."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.route, self.seen, self.at = moe, moe.route, [], 0
        # replayed (token, layer) routes whose own top-k chose another set
        self.flips = self.routed = 0

    def record(self):
        def route(probs, k):
            gates, idx = self.route(probs, k)
            self.seen.append(idx)
            return gates, idx
        self.moe.route = route

    def replay(self):
        self.at = 0

        def route(probs, k):
            idx = self.seen[self.at]
            self.at += 1
            own = self.route(probs, k)[1]
            self.flips += int((own.sort(-1).values != idx.sort(-1).values)
                              .any(-1).sum())
            self.routed += idx.shape[0]
            gates = probs.gather(-1, idx)
            return gates / gates.sum(-1, keepdim=True), idx
        self.moe.route = route

    def restore(self):
        self.moe.route = self.route


def zoo_grads_once(device, small, seed: int, traffic=(TRAIN_BATCH,
                                                      TRAIN_SEQ)) -> dict:
    """One batch and one set of weights (``seed``): one grad step of the
    bf16 model through K1 / K4 (the kernel side), of the same weights in
    f32 through the plain versions (``ssd_scan_plain`` swapped in for
    ``ssd_scan``, chunked attention), and of the bf16 weights through the
    plain versions (the control); moe routes replayed (``RouteReplay``).
    ``traffic`` is (batch, tokens); a family with a second input also gets
    random memory (``memory_input``) and open cross gates (``open_gates``).
    Returns each side's loss, finite flag, launches and the kernel side's
    and the control's relative Frobenius error per gradient against f32."""
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.distributed import steps as S
    from repro_torch.kernels.ssd_scan import ops as SSD
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.registry import get_api

    B, seq = traffic
    b = SyntheticTokens(small.vocab_size, seq, B, seed=seed).next_batch()
    batch = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
             for k, v in b.items()}
    memory = memory_input(small, B, device, seed)
    if memory is not None:
        batch["memory"] = memory
    sides = {"kernel": small,
             "plain": small.replace(dtype="float32", param_dtype="float32",
                                    attn_impl="chunked"),
             "control": small.replace(attn_impl="chunked")}
    init = get_api(small).init
    model = init(small, seed=seed, device=device)
    open_gates(model)
    replay = RouteReplay()
    ops_module = ssm_lib.ssd_ops
    out = {}
    try:
        for side, cfg in sides.items():      # the kernel side first
            m = model
            if side != "kernel":
                m = init(cfg, seed=seed, device=device)
                with torch.no_grad():
                    for q, p in zip(m.parameters(), model.parameters()):
                        q.copy_(p)
                # the model's SSD scan -> the plain one
                ssm_lib.ssd_ops = types.SimpleNamespace(
                    ssd_scan=SSD.ssd_scan_plain)
                replay.replay()
            else:
                replay.record()
            counts = zoo_counts()
            loss, grads, finite = S.make_grad_step(cfg, TrainConfig())(
                m, batch, 1.0)
            out[side] = {"loss": float(loss), "finite": bool(finite),
                         "launched": {k: v - counts[k]
                                      for k, v in zoo_counts().items()},
                         "grads": grads}
            del m
    finally:
        ssm_lib.ssd_ops = ops_module
        replay.restore()
    ref = out["plain"].pop("grads")
    for side in ("kernel", "control"):
        g = out[side].pop("grads")
        out[side]["rel"] = {
            n: float((g[n].float() - ref[n]).norm()
                     / ref[n].norm().clamp(min=1e-30))
            for n in ref if not n.endswith(SHIFT_FREE)}
        # the key biases' gradients, 0 in exact arithmetic: their size
        # beside the value biases' (reported, not gated)
        out[side]["key_bias"] = max(
            (float(g[n].float().norm()
                   / g[n[:-1] + "v"].float().norm().clamp(min=1e-30))
             for n in ref if n.endswith(SHIFT_FREE)), default=None)
        del g
    del ref, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# The attention key biases (whisper's ``bk``): softmax ignores a shift
# shared by every key, so their gradient is 0 in exact arithmetic and a
# relative error of its rounding noise says nothing; a fault in dK shows in
# ``wk``'s gradient, which is gated.
SHIFT_FREE = ("attn.bk",)


def worst_of(rel: dict) -> dict:
    n = max(rel, key=rel.get)
    return {"max": rel[n], "max_at": n,
            "median": sorted(rel.values())[len(rel) // 2]}


def zoo_grad_check(device, cfg, phase: str, seeds=None, gate: bool = True
                   ) -> dict:
    """The kernel path's gradients against the plain path's at full width
    and ZOO_GRAD_LAYERS layers (see ZOO_TRAIN), for each seed of ``seeds``
    (default ZOO_GRAD_SEEDS): ``zoo_grads_once``.  With ``gate``, fails
    unless on every seed both losses are finite and within ZOO_LOSS_TOL,
    every gradient of the kernel side is within ZOO_GRAD_TOL, the kernel
    side launched K1 / K4 once per application each way and the plain
    sides launched nothing."""
    small = cfg.replace(num_layers=ZOO_GRAD_LAYERS, attn_impl="flash")
    if cfg.family == "hybrid":
        small = small.replace(hybrid_attn_every=1)
    if cfg.family == "encdec":
        small = small.replace(encoder_layers=ZOO_GRAD_LAYERS)
    want = zoo_per_step(small)
    nothing = {k: 0 for k in want}
    readings, ok = [], True
    for seed in (ZOO_GRAD_SEEDS if seeds is None else seeds):
        r = zoo_grads_once(device, small, seed,
                           ZOO_TRAFFIC.get(phase, (TRAIN_BATCH, TRAIN_SEQ)))
        row = {"seed": seed,
               "loss_kernel": r["kernel"]["loss"],
               "loss_plain": r["plain"]["loss"],
               "loss_control": r["control"]["loss"],
               "loss_diff": abs(r["kernel"]["loss"] - r["plain"]["loss"]),
               "kernel": worst_of(r["kernel"]["rel"]),
               "control": worst_of(r["control"]["rel"]),
               "key_bias": [r["kernel"]["key_bias"],
                            r["control"]["key_bias"]],
               "finite": all(r[s]["finite"] for s in r),
               "kernel_launches": r["kernel"]["launched"],
               "plain_launches": [r["plain"]["launched"],
                                  r["control"]["launched"]]}
        row["ok"] = (row["finite"] and row["loss_diff"] <= ZOO_LOSS_TOL
                     and row["kernel"]["max"] <= ZOO_GRAD_TOL
                     and row["kernel_launches"] == want
                     and row["plain_launches"] == [nothing, nothing])
        ok = ok and row["ok"]
        readings.append(row)
    out = {"arch": cfg.name, "layers": ZOO_GRAD_LAYERS,
           "kernel_dtype": small.dtype, "seeds": readings,
           "kernel_max": max(r["kernel"]["max"] for r in readings),
           "control_max": max(r["control"]["max"] for r in readings),
           "loss_tol": ZOO_LOSS_TOL, "grad_tol": ZOO_GRAD_TOL,
           "gated": gate, "ok": ok}
    emit(f"{phase}_grads", **out)
    if gate and not ok:
        raise AssertionError(f"{phase}: the kernel path's gradients disagree "
                             f"with the plain path's: {out}")
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_batches(cfg, device):
    import torch
    from repro_torch.data.synthetic import SyntheticTokens
    data = SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    return [{k: torch.as_tensor(v, dtype=torch.int64).to(device)
             for k, v in data.batch_at(i).items()} for i in range(DIST_STEPS)]


def dist_run(device, cfg, batches, mesh=None, policy=None):
    """DIST_STEPS fused steps from seed-0 weights: the sharded step when a
    mesh is given (ZeRO 2, grads reduce-scattered to the state's layout),
    else the unsharded one.  Returns (losses, step ms, peak bytes, K1
    (forward, backward) launches); the peak is the allocator's over the
    steps less what was allocated before the model was made."""
    import torch
    from repro_torch.distributed import steps as S
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    base = release_device_memory(device)
    tcfg = train_config()
    model = T.init_model(cfg, seed=0, device=device)
    opt = adamw_init(model)
    if mesh is not None:
        model, opt = S.shard_model(cfg, model, mesh, opt, zero_stage=2)
        gsh = S.to_shardings({n: lay.opt for n, lay in model.layouts.items()},
                             mesh)
        step = S.make_train_step(cfg, tcfg, policy, grad_shardings=gsh)
    else:
        step = S.make_train_step(cfg, tcfg, policy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    ops.flash_attention.launches = 0                  # count the main path only
    ops.flash_attention_bwd.launches = 0
    losses, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, b, 1.0)
        losses.append(float(m["loss"]))
        if policy is not None:
            policy.settle()              # after the sync, as the trainer
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(device) - base
    launches = (ops.flash_attention.launches,
                ops.flash_attention_bwd.launches)
    import shutil
    shutil.rmtree(tcfg.checkpoint_dir, ignore_errors=True)
    del model, opt, step
    return losses, times, peak, launches


def phase_distributed(device) -> dict:
    """Phase distributed (module doc).  Every check raises.  Returns the
    launches of K1 (forward, backward) in the sharded run and of K2a / K2b
    in the compressed sync."""
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import repro_torch.configs as C
    from repro_torch.common.config import MeshConfig, ShapeConfig
    from repro_torch.core.executor import Executor
    from repro_torch.common.config import ChameleonConfig
    from repro_torch.distributed import compression
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import steps as S
    from repro_torch.hostmem import HostMemTier
    from repro_torch.kernels.quant_offload import ops as qops
    from repro_torch.launch import dryrun, roofline as R
    from repro_torch import obs
    from repro_torch.models import moe as moe_lib

    for name in ("runtime", "hostmem"):      # the train phase's trainer
        obs.metrics().unregister_provider(name)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    problems = []
    try:
        mesh = init_device_mesh(device.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = C.get_config("llama2-paper").replace(num_layers=TRAIN_LAYERS,
                                                   attn_impl="flash")
        batches = dist_batches(cfg, device)
        want = DIST_STEPS * TRAIN_LAYERS
        # ---- sharded against unsharded
        sl, st, sp, sk = dist_run(device, cfg, batches, mesh)
        ul, ut, up, uk = dist_run(device, cfg, batches)
        row = {"arch": cfg.name, "layers": cfg.num_layers,
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": DIST_STEPS,
               "mesh": [1, 1], "zero_stage": 2,
               "sharded": {"losses": sl, "step_ms": st,
                           "step_ms_p50": p50(st),
                           "max_memory_allocated": sp, "k1_launches": sk},
               "unsharded": {"losses": ul, "step_ms": ut,
                             "step_ms_p50": p50(ut),
                             "max_memory_allocated": up, "k1_launches": uk},
               "max_loss_diff": max(abs(a - b) for a, b in zip(sl, ul)),
               "bit_equal": sl == ul, "k1_want": want}
        row["peak_equal"] = sp == up == DIST_PEAK
        emit("distributed_steps", **row)
        if sl != ul:
            problems.append(f"sharded losses {sl} != unsharded {ul}")
        if not row["peak_equal"]:
            problems.append(f"peaks {sp} sharded, {up} unsharded; want "
                            f"{DIST_PEAK} both")
        if sk != (want, want):
            problems.append(f"K1 launches {sk} in the sharded run, want "
                            f"{want} each way")
        if not all(math.isfinite(x) for x in sl + ul):
            problems.append("a loss is not finite")

        # ---- the sharded step under the conservative policy
        tier = HostMemTier(device=device)
        eng = tier.engine
        x = Executor(ChameleonConfig())
        pol = x.execution(x.conservative(None), eng, None)
        c0 = eng.by_class["policy_swap"].as_dict()
        pl, pt, pp, pk = dist_run(device, cfg, batches, mesh, policy=pol)
        c1 = eng.by_class["policy_swap"].as_dict()
        d2h = c1["bytes_out"] - c0["bytes_out"]
        h2d = c1["bytes_in"] - c0["bytes_in"]
        emit("distributed_policy", losses=pl, losses_without=sl,
             equal=pl == sl, step_ms=pt, step_ms_p50=p50(pt),
             max_memory_allocated=pp, d2h_bytes=d2h, h2d_bytes=h2d,
             k1_launches=pk, pool_bytes_in_use=eng.pool.bytes_in_use)
        if pl != sl:
            problems.append(f"losses under the conservative policy {pl} != "
                            f"{sl} without it")
        if not (d2h == h2d > 0):
            problems.append(f"policy_swap D2H {d2h} != H2D {h2d} or 0")
        del pol, x, eng, tier

        # ---- the compressed sync over a one-rank pod dim
        release_device_memory(device)
        from repro_torch.models import transformer as T
        model = T.init_model(cfg, seed=0, device=device)
        grad_step = S.make_grad_step(cfg, train_config())
        _, grads, _ = grad_step(model, batches[0], 1.0)
        del model
        pod = init_device_mesh(device.type, (1,), mesh_dim_names=("pod",))
        sync = compression.make_compressed_grad_sync(pod, "pod")
        plain = compression.make_compressed_grad_sync(pod, "pod", plain=True)
        compression.reset_stats()
        qops.quantize.launches = qops.dequantize.launches = 0
        equal, n_leaves, elems = True, 0, 0
        t_sync = 0.0
        for k in list(grads):
            g = grads.pop(k)
            e = torch.zeros_like(g, dtype=torch.float32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s1, e1 = sync({k: g}, {k: e})
            torch.cuda.synchronize()
            t_sync += time.perf_counter() - t0
            snap = dict(compression.stats)     # the kernels' path only
            s2, e2 = plain({k: g}, {k: e})
            compression.stats.update(snap)
            equal &= (torch.equal(s1[k], s2[k]) and torch.equal(e1[k], e2[k]))
            n_leaves += 1
            elems += g.numel()
            del g, e, s1, e1, s2, e2
        k2 = (qops.quantize.launches, qops.dequantize.launches)
        wire = {"payload_bytes": compression.stats["payload_bytes"],
                "scale_bytes": compression.stats["scale_bytes"],
                "payload_dtype": str(compression.stats["payload_dtype"]),
                "f32_bytes": 4 * elems}
        emit("distributed_compression", leaves=n_leaves, elements=elems,
             bit_equal=equal, k2a_launches=k2[0], k2b_launches=k2[1],
             k2_want=(n_leaves, 2 * n_leaves), sync_ms=t_sync * 1e3, **wire)
        if not equal:
            problems.append("compressed sync != its plain path")
        if compression.stats["payload_dtype"] != torch.int8:
            problems.append(f"gathered payload {wire['payload_dtype']}")
        if k2 != (n_leaves, 2 * n_leaves):
            problems.append(f"K2a/K2b launches {k2}, want {n_leaves} / "
                            f"{2 * n_leaves}")
        del grads

        # ---- apply_moe_auto (expert parallelism) against apply_moe
        mcfg = C.get_config("granite-moe-1b-a400m")
        gen = torch.Generator(device=device).manual_seed(0)
        layer = moe_lib.Moe(mcfg, generator=gen, device=device)
        x = torch.randn(DIST_MOE_TOKENS + (mcfg.d_model,), generator=gen,
                        device=device).to(layer.router.dtype)
        with torch.no_grad():
            out_p, aux_p = moe_lib.apply_moe(mcfg, layer, x)
            with shd.use_mesh(mesh):
                out_a, aux_a = moe_lib.apply_moe_auto(mcfg, layer, x)
        moe_equal = torch.equal(out_a, out_p) and torch.equal(aux_a, aux_p)
        emit("distributed_moe", arch=mcfg.name, tokens=list(DIST_MOE_TOKENS),
             experts=mcfg.num_experts, bit_equal=moe_equal,
             aux=float(aux_a))
        if not moe_equal:
            problems.append("apply_moe_auto != apply_moe on one rank")
        del layer, x, out_a, out_p
    finally:
        shd.clear_groups()
        dist.destroy_process_group()

    # ---- the dry run of the unsharded run's cell, on fake cuda tensors
    release_device_memory(device)
    shape = ShapeConfig("train", "train", TRAIN_SEQ, TRAIN_BATCH)
    t0 = time.perf_counter()
    rec = dryrun.run_cell("llama2_paper", "train", False, "none", None,
                          verbose=False, cfg=cfg, shape=shape,
                          mesh_shape=MeshConfig((1, 1), ("data", "model")),
                          device=device.type, device_kind="h100_sxm")
    wall = time.perf_counter() - t0
    r = rec["roofline"]
    peak = rec["memory"]["peak_per_chip"]
    peak_err = abs(peak - up) / up
    step_s = p50(ut) / 1e3
    mfu = R.mfu(r["model_flops"], 1, step_s)
    emit("distributed_dryrun", wall_s=wall, device=rec["device"],
         peak_per_chip=peak, measured_peak=up, peak_err=peak_err,
         static_bytes=rec["memory"]["static_bytes"],
         compute_ms=r["compute_s"] * 1e3, memory_ms=r["memory_s"] * 1e3,
         collective_ms=r["collective_s"] * 1e3,
         bound_ms=r["step_time_bound_s"] * 1e3, bottleneck=r["bottleneck"],
         measured_p50_ms=p50(ut), flops_per_chip=r["flops_per_chip"],
         bytes_per_chip=r["bytes_per_chip"], model_flops=r["model_flops"],
         mfu=mfu, bound_share=r["step_time_bound_s"] / step_s)
    if peak_err > CHAM_PEAK_TOL:
        problems.append(f"dry-run peak {peak} vs measured {up}: "
                        f"{peak_err:.3f} > {CHAM_PEAK_TOL}")

    # ---- the production cells of the dry run, on fake cuda tensors
    for arch, shape_name, multi in DIST_DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape_name, multi, "none", None,
                              verbose=False, device=device.type,
                              device_kind="h100_sxm")
        dep, r = rec["departures"], rec["roofline"]
        emit("distributed_dryrun_production", arch=arch, shape=shape_name,
             mesh=rec["mesh_shape"], device=rec["device"],
             wall_s=time.perf_counter() - t0, **rec["memory"],
             flops_per_chip=r["flops_per_chip"],
             bytes_per_chip=r["bytes_per_chip"],
             collectives=r["collectives"], departures=dep,
             bottleneck=r["bottleneck"],
             step_time_bound_ms=r["step_time_bound_s"] * 1e3)
        if not dep["comparable_to_reference"]:
            problems.append(f"the {arch} x {shape_name} dry run departs "
                            f"from the reference: {dep}")
    emit("distributed", ok=not problems, problems=problems)
    if problems:
        raise AssertionError(f"distributed: {problems}")
    return {"k1": sk, "k2": k2}


def kernel_launches() -> dict:
    """The launch counters of K1 (forward, backward), K3 and K2a / K2b."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.quant_offload import ops as Q
    return {"k1_fwd": ops.flash_attention.launches,
            "k1_bwd": ops.flash_attention_bwd.launches,
            "k3": ops.flash_decode.launches,
            "k2a": Q.quantize.launches, "k2b": Q.dequantize.launches}


def zero_kernel_launches() -> None:
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.quant_offload import ops as Q
    ops.flash_attention.launches = ops.flash_attention_bwd.launches = 0
    ops.flash_decode.launches = 0
    Q.quantize.launches = Q.dequantize.launches = 0


def recording_trainer(base, made: list):
    """``base`` (the Trainer class) with each instance appended to
    ``made`` and, per step, its stage and the entries of the policy its
    grad dispatch ran (``ran``)."""
    class Recorded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.ran = []
            made.append(self)

        def _one_step(self, *a, **k):
            out = super()._one_step(*a, **k)
            self.ran.append((self.report.stages[-1] if self.report.stages
                             else None,
                             policy_entries(self.rt) if self.rt else 0))
            return out
    return Recorded


def example_e2e(device, budget: int, workdir: str) -> dict:
    """``examples_torch/train_e2e.py`` at its full deliverable preset
    (E2E_ARGS, E2E_STEPS with ``--with-serve``, ``--trace-out`` and
    ``--metrics-out``), then ``--resume`` for E2E_RESUME_STEPS more, under
    ``budget``; each held to what tests/test_torch_examples.py holds on the
    CPU.  The example keeps its checkpoints under the temporary directory,
    here ``workdir``.  Returns each run's row with its launches."""
    import contextlib
    import io
    import tempfile
    from examples_torch import train_e2e
    from repro_torch import obs
    from repro_torch.obs.validate import (validate_chrome_trace,
                                          validate_metrics_jsonl)

    trace = os.path.join(workdir, "trace.json")
    metrics = os.path.join(workdir, "metrics.jsonl")
    common = E2E_ARGS + ["--device", device.type,
                         "--budget-gib", repr(budget / 2 ** 30)]
    rows, problems = {}, []
    made, base, old_tmp = [], train_e2e.Trainer, tempfile.tempdir
    train_e2e.Trainer = recording_trainer(base, made)
    tempfile.tempdir = workdir
    try:
        for name, extra in (
                ("train_e2e", ["--steps", str(E2E_STEPS), "--with-serve",
                               "--trace-out", trace,
                               "--metrics-out", metrics]),
                ("train_e2e_resume", ["--steps", str(E2E_RESUME_STEPS),
                                      "--resume"])):
            zero_kernel_launches()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                out = train_e2e.main(common + extra)
            seconds = time.perf_counter() - t0
            sys.stdout.write(buf.getvalue())
            tr = made.pop()
            rows[name] = {
                "seconds": seconds, "launches": kernel_launches(),
                "start_step": out["start_step"], "step": out["step"],
                "first_loss": out["losses"][0],
                "last_loss": out["losses"][-1],
                "evals": sorted(out["evals"]),
                "checkpoints": [os.path.basename(c)
                                for c in out["checkpoints"]],
                "stages": tr.report.stages,
                "entries": [n for _, n in tr.ran],
                "max_entries": max(n for _, n in tr.ran),
                "serve": out.get("serve"),
                "printed": [ln for ln in buf.getvalue().splitlines()
                            if ln.startswith(("resumed at", "serve burst",
                                              "loss:"))]}
            for pname in ("runtime", "hostmem", "memory"):
                obs.metrics().unregister_provider(pname)
            if not all(math.isfinite(x) for x in out["losses"]):
                problems.append(f"{name}: a loss is not finite")
            del tr, out
            gc.collect()
            release_device_memory(device)
        with open(trace) as f:
            n_spans = validate_chrome_trace(json.load(f))["n_spans"]
        validate_metrics_jsonl(metrics)
    finally:
        train_e2e.Trainer = base
        tempfile.tempdir = old_tmp
    first, again = rows["train_e2e"], rows["train_e2e_resume"]
    first["trace_spans"] = n_spans
    end = E2E_STEPS + E2E_RESUME_STEPS
    if (first["start_step"], first["step"]) != (0, E2E_STEPS):
        problems.append(f"train_e2e: steps {first['start_step']} .. "
                        f"{first['step']}, not 0 .. {E2E_STEPS}")
    if len(first["checkpoints"]) != E2E_STEPS // E2E_EVERY:
        problems.append(f"train_e2e: checkpoints {first['checkpoints']}")
    if first["evals"] != list(range(E2E_EVERY, E2E_STEPS, E2E_EVERY)):
        problems.append(f"train_e2e: evals at {first['evals']}")
    srv = first["serve"] or {}
    if srv.get("requests") != 4 or not srv.get("spills"):
        problems.append(f"train_e2e: serve burst {srv}")
    if not n_spans:
        problems.append("train_e2e: the trace holds no span")
    if first["max_entries"] < 1:
        problems.append("train_e2e: no policy with entries ran under the "
                        "budget")
    if (f"resumed at step {E2E_STEPS}" not in again["printed"]
            or (again["start_step"], again["step"]) != (E2E_STEPS, end)):
        problems.append(f"train_e2e --resume: {again['printed']}, steps "
                        f"{again['start_step']} .. {again['step']}")
    for name, r in rows.items():
        if not (r["launches"]["k1_fwd"] and r["launches"]["k1_bwd"]):
            problems.append(f"{name}: K1 was not launched both ways")
    if not first["launches"]["k3"]:
        problems.append("train_e2e: the serve burst launched no K3")
    return {"rows": rows, "budget": budget, "problems": problems}


def example_elastic(device) -> dict:
    """``examples_torch/elastic_restart.py`` (its own assertion: rtol 1e-5
    between the resumed and the uninterrupted losses), with the largest
    relative difference it leaves and its launches."""
    from examples_torch import elastic_restart
    zero_kernel_launches()
    t0 = time.perf_counter()
    out = elastic_restart.main(["--device", device.type])
    seconds = time.perf_counter() - t0
    n = len(out["resumed"])
    ref = out["reference"][-n:]
    rel = max(abs(a - b) / abs(a) for a, b in zip(ref, out["resumed"]))
    return {"seconds": seconds, "launches": kernel_launches(),
            "resumed_at": out["resumed_at"], "steps_after": n,
            "max_rel_diff": rel}


def phase_examples(device) -> dict:
    """Phase examples (module doc): the examples' own assertions raise.
    Returns K1's (forward, backward) and K3's launches over the three, and
    each later run's launches (``runs``)."""
    import shutil
    import tempfile
    from examples_torch import adaptive_swap_demo, quickstart, serve_batched
    from examples_torch.train_e2e import PRESETS

    argv = ["--device", device.type]
    zero_kernel_launches()                    # count the examples only
    row = {}
    for name, mod in (("quickstart", quickstart),
                      ("adaptive_swap_demo", adaptive_swap_demo),
                      ("serve_batched", serve_batched)):
        t0 = time.perf_counter()
        out = mod.main(argv)
        row[name] = {"seconds": time.perf_counter() - t0}
        if "losses" in out:
            row[name].update(first_loss=out["losses"][0],
                             last_loss=out["losses"][-1])
        if "stages" in out:
            row[name]["stages"] = sorted(set(out["stages"]),
                                         key=out["stages"].index)
        if "transitions" in out:
            row[name]["transitions"] = [w for _, w, _ in out["transitions"]]
        if "results" in out:
            row[name].update(requests=len(out["results"]),
                             ticks=out["ticks"])
        gc.collect()
        release_device_memory(device)
    k = kernel_launches()
    emit("examples", **row, launches=k)
    if not (k["k1_fwd"] and k["k1_bwd"] and k["k3"]):
        raise AssertionError(f"examples: a kernel was not launched: {k}")
    # 12d: train_e2e at its full deliverable preset, under the lowest
    # budget a policy meets for its grad dispatch, then its resume; then
    # elastic_restart, each on an emptied card
    t0 = time.perf_counter()
    cfg = PRESETS[E2E_ARGS[E2E_ARGS.index("--preset") + 1]]
    if device.type == "cuda":
        cfg = cfg.replace(attn_impl="flash")
    budget, brow = exec_budget(
        device, cfg, seq=int(E2E_ARGS[E2E_ARGS.index("--seq") + 1]),
        batch=int(E2E_ARGS[E2E_ARGS.index("--batch") + 1]),
        phase="examples_e2e")
    release_device_memory(device)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_e2e_")
    try:
        e2e = example_e2e(device, budget, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    elastic = example_elastic(device)
    release_device_memory(device)
    problems = e2e["problems"]
    if elastic["max_rel_diff"] > 1e-5:     # the example asserts it too
        problems.append(f"elastic_restart: {elastic['max_rel_diff']}")
    runs = {**{n: r["launches"] for n, r in e2e["rows"].items()},
            "elastic_restart": elastic["launches"]}
    emit("examples_12d", ok=not problems, problems=problems,
         budget=budget, budget_row={kk: brow[kk] for kk in (
             "floor", "peak", "static_bytes", "t_iter_s", "dt_s")},
         **e2e["rows"], elastic_restart=elastic)
    emit("seconds", of="examples_12d", seconds=time.perf_counter() - t0)
    if problems:
        raise AssertionError(f"examples: {problems}")
    k["runs"] = runs
    return k


def phase_train_zoo(device, phase: str) -> dict:
    """``Trainer`` on ZOO_TRAIN[phase] at full width and depth, or the
    depth ZOO_LAYERS gives (see ZOO_TRAIN): K1's and K4's launch counts
    reset just before the steps and equal to steps x their per-step
    launches just after; finite losses;
    step ms p50, tokens/s, peak memory; a profile of 2 more steps; then the
    gradient check.  Returns the launches."""
    import torch
    import repro_torch.configs as C
    from repro_torch.common.config import ChameleonConfig
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.runtime.trainer import Trainer

    allocated_before = release_device_memory(device)
    cfg = C.get_config(ZOO_TRAIN[phase]).replace(attn_impl="flash")
    if phase in ZOO_LAYERS:
        cfg = cfg.replace(num_layers=ZOO_LAYERS[phase])
    tcfg = train_config()
    B, seq = ZOO_TRAFFIC.get(phase, (TRAIN_BATCH, TRAIN_SEQ))
    data = SyntheticTokens(cfg.vocab_size, seq, B, seed=0)
    tr = Trainer(cfg, tcfg, ChameleonConfig(enabled=False), data=data,
                 device=device)
    n_params = sum(p.numel() for p in tr.model.parameters())
    torch.cuda.synchronize()
    zero_zoo_counts()                                 # count the main path only
    rep = tr.train(ZOO_STEPS)
    launches = zoo_counts()
    want = {k: ZOO_STEPS * v for k, v in zoo_per_step(cfg).items()}
    times = rep.times[1:]
    step_ms = sorted(times)[len(times) // 2] * 1e3
    row = {"arch": cfg.name, "family": cfg.family, "layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers,
           "params": n_params, "batch": B, "seq": seq,
           "steps": ZOO_STEPS, "losses": rep.losses, "xent": rep.xent,
           "aux": rep.aux, "step_ms": [t * 1e3 for t in rep.times],
           "step_ms_p50": step_ms,
           "tokens_per_s": B * seq / (step_ms / 1e3),
           "max_memory_allocated": torch.cuda.max_memory_allocated(device),
           "allocated_before": allocated_before, "launches": launches,
           "want_launches": want, "skipped_steps": rep.skipped_steps}
    ok = (all(math.isfinite(x) for x in rep.losses) and launches == want
          and not rep.skipped_steps)
    emit(phase, ok=ok, **row)
    if not ok:
        raise AssertionError(f"{phase}: want {ZOO_STEPS} finite losses and "
                             f"{want} launches: {row}")
    train_profile(tr, phase=f"{phase}_profile")
    drop_trainer(tr)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    zoo_grad_check(device, cfg, phase)
    return launches


def logit_check(lf, lc) -> dict:
    """Flash logits against chunked ones: finite, and the largest
    difference over the largest chunked logit within CROSSCHECK_TOL; with
    greedy agreement reported."""
    import torch
    lf, lc = lf.float(), lc.float()
    dmax = float((lf - lc).abs().max())
    rel = dmax / float(lc.abs().max())
    finite = bool(torch.isfinite(lf).all())
    return {"max_abs_dlogit": dmax, "rel_dlogit": rel,
            "argmax_agree": bool((lf.argmax(-1) == lc.argmax(-1)).all()),
            "finite": finite, "ok": finite and rel <= CROSSCHECK_TOL}


def decode_ticks(cfg, api, model, state, tokens, n_ticks, feed=None):
    """``n_ticks`` greedy decode steps from ``tokens`` (B,1), each synced
    and timed; ``feed`` (B,P) replaces the greedy token while it lasts (a
    prompt fed through decode_step).  Returns (tick seconds, logits of the
    first CROSSCHECK_TICKS ticks, the tokens fed, the state)."""
    import torch
    times, first, fed = [], [], []
    tok = tokens
    with torch.no_grad():
        for t in range(n_ticks):
            fed.append(tok)
            t0 = time.perf_counter()
            logits, state = api.decode_step(cfg, model, tok, state)
            nxt = logits[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if t < CROSSCHECK_TICKS:
                first.append(logits.float())
            tok = (feed[:, t + 1:t + 2] if feed is not None
                   and t + 1 < feed.shape[1] else nxt)
    return times, first, fed, state


def crosscheck_ticks(cfg, api, model, state, fed, first) -> dict:
    """The first CROSSCHECK_TICKS ticks of ``first`` replayed under chunked
    attention from ``state`` (a chunked path's state) with the same tokens
    (``fed``): the worst tick's ``logit_check``, ``ok`` over all."""
    import torch
    ccfg = cfg.replace(attn_impl="chunked")
    checks = []
    with torch.no_grad():
        for t in range(CROSSCHECK_TICKS):
            logits, state = api.decode_step(ccfg, model, fed[t], state)
            checks.append(dict(logit_check(first[t], logits), tick=t))
    worst = max(checks, key=lambda c: c["rel_dlogit"])
    return dict(worst, ok=all(c["ok"] for c in checks))


def tick_stats(times) -> dict:
    xs = sorted(t * 1e3 for t in times)
    return {"n": len(xs), "p50": xs[len(xs) // 2],
            "p95": xs[min(int(0.95 * len(xs)), len(xs) - 1)], "max": xs[-1]}


def phase_decode_encdec(device) -> dict:
    """Full-width, full-depth whisper-large-v3 (bf16, random weights from a
    seed, every xgate at OPEN_XGATE, flash attention) decoding through the
    model API: DECODE_REQUESTS requests of 1500 random frames;
    ``init_decode_state(memory=)`` encodes them (K1 once per encoder layer,
    non-causal over 1500 frames) and projects every decoder block's cross
    K/V; a DECODE_PROMPT-token prompt and DECODE_NEW greedy tokens through
    ``decode_step`` (K3 for each block's self- and cross-attention a tick).
    Counts reset just before; the first CROSSCHECK_TICKS ticks' logits held
    against the same model and inputs with chunked attention.  Returns the
    launches (K1, K3)."""
    import torch
    import repro_torch.configs as C
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.registry import get_api

    allocated_before = release_device_memory(device)
    cfg = C.get_config("whisper-large-v3").replace(attn_impl="flash")
    api = get_api(cfg)
    model = api.init(cfg, seed=0, device=device)
    open_gates(model)
    B = DECODE_REQUESTS
    memory = memory_input(cfg, B, device, seed=1)
    gen = torch.Generator(device=device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, DECODE_PROMPT),
                           generator=gen, device=device)
    torch.cuda.synchronize()
    ops.flash_attention.launches = ops.flash_decode.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        state = api.init_decode_state(cfg, B, ENCDEC_MAX_LEN, params=model,
                                      memory=memory)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    enc_launches = ops.flash_attention.launches
    n_ticks = DECODE_PROMPT + DECODE_NEW - 1
    times, first, fed, state = decode_ticks(cfg, api, model, state,
                                            prompt[:, :1], n_ticks, prompt)
    k1, k3 = ops.flash_attention.launches, ops.flash_decode.launches
    del state
    with torch.no_grad():       # the encoder through chunked attention too
        start = api.init_decode_state(cfg.replace(attn_impl="chunked"), B,
                                      ENCDEC_MAX_LEN, params=model,
                                      memory=memory)
    check = crosscheck_ticks(cfg, api, model, start, fed, first)
    want_k3 = 2 * cfg.num_layers * n_ticks
    row = {"arch": cfg.name, "requests": B, "frames": cfg.encoder_seq,
           "prompt": DECODE_PROMPT, "new_tokens": DECODE_NEW,
           "ticks": n_ticks, "max_len": ENCDEC_MAX_LEN,
           "params": sum(p.numel() for p in model.parameters()),
           "encode_ms": encode_ms, "tick_ms": tick_stats(times),
           "k1_launches": k1, "k1_encode_launches": enc_launches,
           "k3_launches": k3, "want_k3": want_k3, "crosscheck": check,
           "max_memory_allocated": torch.cuda.max_memory_allocated(device),
           "allocated_before": allocated_before}
    row["ok"] = (k1 == enc_launches == cfg.encoder_layers and k3 == want_k3
                 and check["ok"])
    emit("decode_encdec", **row)
    del model, start, memory
    if not row["ok"]:
        raise AssertionError(f"decode_encdec: want K1 x {cfg.encoder_layers} "
                             f"in the encode, K3 x {want_k3} and the chunked "
                             f"path's logits: {row}")
    return k1, k3


def phase_decode_vlm(device) -> dict:
    """llama-3.2-vision-90b at full width with its depth cut to VLM_LAYERS
    (bf16, random weights from a seed, every xgate at OPEN_XGATE, flash
    attention): DECODE_REQUESTS requests sharing a VLM_PROMPT-token prompt,
    6404 random image tokens each, through ``prefill`` (K1 for every
    layer's self-attention and every cross block's cross-attention) and
    DECODE_NEW - 1 greedy ``decode_step`` ticks (K3 the same way).  Counts
    reset just before; the prefill's logits and the first CROSSCHECK_TICKS
    ticks' held against the same model and inputs with chunked attention.
    Returns the launches (K1, K3)."""
    import torch
    import repro_torch.configs as C
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.registry import get_api

    allocated_before = release_device_memory(device)
    cfg = C.get_config("llama-3.2-vision-90b").replace(
        num_layers=VLM_LAYERS, attn_impl="flash")
    api = get_api(cfg)
    model = api.init(cfg, seed=0, device=device)
    open_gates(model)
    n_cross = len(model.cross_blocks)
    B = DECODE_REQUESTS
    memory = memory_input(cfg, B, device, seed=2)
    gen = torch.Generator(device=device).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (1, VLM_PROMPT), generator=gen,
                           device=device).expand(B, VLM_PROMPT)
    torch.cuda.synchronize()
    ops.flash_attention.launches = ops.flash_decode.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, state = api.prefill(cfg, model, prompt, VLM_MAX_LEN,
                                    memory=memory)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    k1 = ops.flash_attention.launches
    with torch.no_grad():
        clog, cstate = api.prefill(cfg.replace(attn_impl="chunked"), model,
                                   prompt, VLM_MAX_LEN, memory=memory)
    pre_check = logit_check(logits[:, -1], clog[:, -1])
    del clog
    first_tok = logits[:, -1].argmax(-1)[:, None]
    n_ticks = DECODE_NEW - 1
    k3_before = ops.flash_decode.launches
    times, first, fed, state = decode_ticks(cfg, api, model, state,
                                            first_tok, n_ticks)
    k3 = ops.flash_decode.launches - k3_before
    check = crosscheck_ticks(cfg, api, model, cstate, fed, first)
    per_tick = cfg.num_layers + n_cross
    row = {"arch": cfg.name, "layers": cfg.num_layers, "cut_from": 100,
           "cross_blocks": n_cross, "requests": B,
           "image_tokens": cfg.image_tokens, "prompt": VLM_PROMPT,
           "new_tokens": DECODE_NEW, "ticks": n_ticks,
           "max_len": VLM_MAX_LEN,
           "params": sum(p.numel() for p in model.parameters()),
           "prefill_ms": prefill_ms, "tick_ms": tick_stats(times),
           "k1_launches": k1, "want_k1": per_tick,
           "k3_launches": k3, "want_k3": per_tick * n_ticks,
           "prefill_crosscheck": pre_check, "crosscheck": check,
           "max_memory_allocated": torch.cuda.max_memory_allocated(device),
           "allocated_before": allocated_before}
    row["ok"] = (k1 == per_tick and k3 == per_tick * n_ticks
                 and pre_check["ok"] and check["ok"])
    emit("decode_vlm", **row)
    del model, state, cstate, memory, logits
    if not row["ok"]:
        raise AssertionError(f"decode_vlm: want K1 x {per_tick} in the "
                             f"prefill, K3 x {per_tick} a tick and the "
                             f"chunked path's logits: {row}")
    return k1, k3


def phase_serve_moe(device):
    """``serve.main`` on full-width granite-moe-1b-a400m (bf16, random
    weights from a seed, flash attention): the serve phase's traffic, 8
    requests over 4 slots.  K1's launches must equal prefills x 24 layers
    and K3's decode ticks x 24 (counts reset just before).  Returns (K1,
    K3) launches."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve

    allocated_before = release_device_memory(device)
    ops.flash_attention.launches = 0                  # count the main path only
    ops.flash_decode.launches = 0
    stats = serve.main(MOE_SERVE_ARGS)
    launches, decode_launches = (ops.flash_attention.launches,
                                 ops.flash_decode.launches)
    n_req, n_new, n_layers = 8, 32, 24
    lengths = {rid: len(toks) for rid, toks in stats["results"].items()}
    prefills = stats["latency"]["prefill_ms"]["n"]
    ok = (stats["completed"] == n_req and set(lengths.values()) == {n_new}
          and prefills == n_req and launches == prefills * n_layers
          and decode_launches == stats["ticks"] * n_layers)
    emit("serve_moe", ok=ok, arch=stats["arch"], launches=launches,
         decode_launches=decode_launches, prefills=prefills,
         prompt_lens=stats["prompt_lens"], tokens=stats["tokens"],
         wall_s=stats["wall_s"], tokens_per_s=stats["tokens_per_s"],
         ticks=stats["ticks"], tick_ms=stats["latency"]["tick_ms"],
         prefill_ms=stats["latency"]["prefill_ms"],
         max_memory_allocated=stats["max_memory_allocated"],
         allocated_before=allocated_before)
    if not ok:
        raise AssertionError(f"serve_moe: want {n_req} requests of {n_new} "
                             f"tokens and K1 / K3 launched per prefill / "
                             f"tick x {n_layers} layers: {lengths}, "
                             f"{launches}, {decode_launches}")
    return launches, decode_launches


def phase_serve_zoo(device) -> dict:
    """``serve.main`` on each of SERVE_ZOO at full width and depth (bf16,
    random weights from seed 0, flash attention), SERVE_ARGS' traffic: 8
    requests over 4 slots, 32 new tokens each; the CLI's default
    configuration with no ``--arch``.  Each on a card emptied first
    (``release_device_memory``), so its ``max_memory_allocated`` is its
    own.  Gates: every request completes with 32 tokens, K1's launches
    equal prefills x layers and K3's decode ticks x layers (counts reset
    just before); then ``phase_crosscheck`` on the same weights (drawn
    again from seed 0): flash against chunked logits at two prefills and
    CROSSCHECK_TICKS decode ticks.  Returns {arch: {"k1", "k3"}}."""
    import repro_torch.configs as C
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_api

    at = SERVE_ARGS.index("--arch")
    traffic = SERVE_ARGS[:at] + SERVE_ARGS[at + 2:]
    default = serve._parser().get_default("arch")
    out = {}
    for arch in SERVE_ZOO:
        t0 = time.perf_counter()
        cfg = C.get_config(arch)
        allocated_before = release_device_memory(device)
        ops.flash_attention.launches = 0              # count the main path only
        ops.flash_decode.launches = 0
        stats = serve.main(traffic if arch == default
                           else ["--arch", arch] + traffic)
        launches, decode_launches = (ops.flash_attention.launches,
                                     ops.flash_decode.launches)
        n_req, n_new, n_layers = 8, 32, cfg.num_layers
        lengths = {rid: len(toks) for rid, toks in stats["results"].items()}
        prefills = stats["latency"]["prefill_ms"]["n"]
        ok = (stats["arch"] == cfg.name and stats["attn_impl"] == "flash"
              and stats["completed"] == n_req
              and set(lengths.values()) == {n_new} and prefills == n_req
              and launches == prefills * n_layers
              and decode_launches == stats["ticks"] * n_layers)
        emit("serve_zoo", ok=ok, arch=stats["arch"],
             default_arch=arch == default, layers=n_layers,
             launches=launches, decode_launches=decode_launches,
             prefills=prefills, prompt_lens=stats["prompt_lens"],
             tokens=stats["tokens"], wall_s=stats["wall_s"],
             tokens_per_s=stats["tokens_per_s"], ticks=stats["ticks"],
             tick_ms=stats["latency"]["tick_ms"],
             prefill_ms=stats["latency"]["prefill_ms"],
             max_memory_allocated=stats["max_memory_allocated"],
             allocated_before=allocated_before)
        if not ok:
            raise AssertionError(
                f"serve_zoo {arch}: want {n_req} requests of {n_new} tokens "
                f"and K1 / K3 launched per prefill / tick x {n_layers} "
                f"layers: {lengths}, {launches}, {decode_launches}, "
                f"{stats['ticks']} ticks")
        del stats
        release_device_memory(device)                 # the served model
        model = get_api(cfg).init(cfg, seed=0, device=device)
        phase_crosscheck(device, cfg, model)
        del model
        out[arch] = {"k1": launches, "k3": decode_launches}
        emit("serve_zoo_seconds", arch=arch, seconds=time.perf_counter() - t0)
    return out


def phase_kernel_configs(device) -> dict:
    """K1 forward and backward and K3 at CONFIG_K1_CASES / CONFIG_K3_CASES,
    bf16: the forward through ``phase_kernel`` (two bit-equal launches,
    its plain version, timed warm beside the plain version, SDPA and the
    bound) and cold (``k1_cold_ms``); the backward of the train shapes
    through ``phase_kernel_bwd`` (two bit-equal launches, timed warm and
    cold beside SDPA's backward and the bound); K3 through
    ``phase_decode_kernel`` (both dtypes, two bit-equal launches, bf16
    timed warm and cold).  Returns {"fwd" | "bwd" | "decode": {name: bf16
    row}}."""
    import torch
    import repro_torch.configs as C

    out = {"fwd": {}, "bwd": {}, "decode": {}}
    for arch, B, S, bwd in CONFIG_K1_CASES:
        cfg = C.get_config(arch)
        H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        name = f"{arch} {B}x{S}"
        case = (B, S, S, H, Kh, D, True, None, ("bfloat16",), True)
        row = phase_kernel(device, [case])[(case, "bfloat16")]
        cold = k1_cold_ms(B, S, H, Kh, D,
                          TRAIN_LAYERS if bwd else K1_COLD_LAYERS, device)
        emit("kernel_cold", name="flash_attention_fwd", at=name, **cold)
        out["fwd"][name] = dict(row, **cold)
        torch.cuda.empty_cache()
        if bwd:
            out["bwd"][name] = phase_kernel_bwd(device, [case])
            torch.cuda.empty_cache()
    for arch, lens in CONFIG_K3_CASES:
        cfg = C.get_config(arch)
        if lens is None:                # serve_zoo's first decode tick
            lens = tuple(len(p) + 1 for p in serve_prompts(4, cfg.vocab_size))
        out["decode"][arch], _ = phase_decode_kernel(device, [(
            len(lens), 1024, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            lens, True)])
        torch.cuda.empty_cache()
    out["local"] = phase_kernel_local(device)
    return out


def local_head_cases():
    """LOCAL_K1_CASES as (name, B, S, H, Kh, D, causal): every distinct
    (query heads, KV heads) of a non-empty run of ``sharding.head_runs`` on
    the production mesh's model dim."""
    import repro_torch.configs as C
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import mesh_config
    mc = mesh_config(False)
    tp = dict(zip(mc.axes, mc.shape))["model"]
    out = []
    for arch, B, S, causal in LOCAL_K1_CASES:
        cfg = C.get_config(arch)
        shapes = sorted({(r.count, len(r.kv)) for r in shd.head_runs(
            cfg.num_heads, cfg.num_kv_heads, tp) if r.count}, reverse=True)
        out += [(f"{arch} {H}/{Kh} {B}x{S}", B, S, H, Kh, cfg.head_dim,
                 causal) for H, Kh in shapes]
    return out


def phase_kernel_local(device) -> dict:
    """K1 forward and backward at ``local_head_cases``, bf16: the forward
    through ``phase_kernel`` (two bit-equal launches against its plain
    version, timed warm beside the plain version, SDPA and the bound) and
    cold (``k1_cold_ms``), the backward through ``phase_kernel_bwd`` (two
    bit-equal launches, timed warm and cold beside SDPA's backward and the
    bound).  Returns {"fwd" | "bwd": {name: bf16 row}, "launches": the
    forward's and the backward's launches in these checks}."""
    import torch
    from repro_torch.kernels.flash_attention import ops

    out = {"fwd": {}, "bwd": {}}
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    for name, B, S, H, Kh, D, causal in local_head_cases():
        case = (B, S, S, H, Kh, D, causal, None, ("bfloat16",), True)
        row = phase_kernel(device, [case])[(case, "bfloat16")]
        cold = k1_cold_ms(B, S, H, Kh, D, TRAIN_LAYERS, device,
                          causal=causal)
        emit("kernel_cold", name="flash_attention_fwd", at=name, **cold)
        out["fwd"][name] = dict(row, **cold)
        torch.cuda.empty_cache()
        out["bwd"][name] = phase_kernel_bwd(device, [case])
        torch.cuda.empty_cache()
    out["launches"] = (ops.flash_attention.launches - before[0],
                       ops.flash_attention_bwd.launches - before[1])
    return out


def phase_zoo_grads(device, phase: str) -> dict:
    """``zoo_grad_check`` alone for ZOO_GRADS[phase], at full width and
    ZOO_GRAD_LAYERS, on a card emptied first."""
    import repro_torch.configs as C
    release_device_memory(device)
    return zoo_grad_check(device, C.get_config(ZOO_GRADS[phase]), phase)


def phase_kernel_d64(device) -> dict:
    """K1 forward and backward and K3 at head dim 64, the decoder zoo's:
    K1's forward at granite-moe's prefill shapes (every serve_moe prompt
    length, bf16) and at the train phases' shapes (zamba2's 32 heads, MHA;
    granite's 16 over 8 KV heads; both dtypes, timed); K1's backward at the
    train shapes (both dtypes, timed: GQA G = 2 in the dK/dV pass); K3 at
    granite's decode shape (4, 1024, 8 KV heads of 64), timed warm and
    cold.  Returns the timed bf16 rows."""
    import repro_torch.configs as C
    g = C.get_config("granite-moe-1b-a400m")
    z = C.get_config("zamba2-1.2b")
    trains = [(z.num_heads, z.num_kv_heads), (g.num_heads, g.num_kv_heads)]
    fwd_cases = [(1, S, S, g.num_heads, g.num_kv_heads, 64, True, None,
                  ("bfloat16",), False)
                 for S in map(len, serve_prompts(8, g.vocab_size))]
    fwd_cases += [(TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, H, Kh, 64, True, None,
                   BOTH, True) for H, Kh in trains]
    rows = phase_kernel(device, fwd_cases)
    out = {"fwd": {f"{H}x{Kh}": rows[(c, "bfloat16")]
                   for c, (H, Kh) in zip(fwd_cases[-2:], trains)}}
    out["fwd_max_abs_err"] = max(rows[(c, "bfloat16")]["max_abs_err"]
                                 for c in fwd_cases)
    out["bwd"] = {f"{H}x{Kh}": phase_kernel_bwd(device, [
        (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, H, Kh, 64, True, None, BOTH,
         True)]) for H, Kh in trains}
    lens = tuple(len(p) + 1 for p in serve_prompts(4, g.vocab_size))
    out["decode"], _ = phase_decode_kernel(
        device, [(4, 1024, g.num_heads, g.num_kv_heads, 64, lens, True)])
    return out


def d64_summary(row) -> dict:
    """The timing fields of a D 64 row for the kernels line."""
    return {k: row.get(k) for k in ("shape", "ms", "cold_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "max_abs_err")}


def phase_train_cli(device):
    """``repro_torch.launch.train.main`` on the card with the reduced
    llama2-paper (f32, so the f32 kernels of K1's forward and backward run
    through the normal entry point): finite losses, and K1's backward
    launched steps x layers times, its forward also for each eval."""
    import shutil
    import tempfile
    import repro_torch.configs as C
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import train

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    ops.flash_attention.launches = 0
    ops.flash_attention_bwd.launches = 0
    try:
        stats = train.main(TRAIN_CLI_ARGS + ["--ckpt-dir", ckpt])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    fwd, bwd = ops.flash_attention.launches, ops.flash_attention_bwd.launches
    layers = C.get_reduced("llama2-paper").num_layers
    steps, evals = stats["steps"], len(stats["eval_losses"])
    ok = (all(math.isfinite(x) for x in stats["losses"])
          and bwd == steps * layers and fwd == (steps + evals) * layers
          and stats["device"].startswith("cuda"))
    emit("train_cli", ok=ok, device=stats["device"], steps=steps,
         losses=stats["losses"], eval_losses=stats["eval_losses"],
         step_ms=[t * 1e3 for t in stats["times"]], launches=fwd,
         bwd_launches=bwd)
    if not ok:
        raise AssertionError(f"train_cli: {stats}")
    train_cli_store(device)


def train_cli_store(device):
    """The train CLI under Chameleon with the background worker and a
    policy store (TRAIN_CLI_ASYNC_ARGS), its trace, metrics and audit
    through ``python -m repro_torch.obs.validate`` and ``python -m
    repro_torch.obs.report``, then the serve CLI on that store
    (SERVE_CLI_STORE_ARGS): at least one background re-scan, and the
    records the training run wrote."""
    import shutil
    import tempfile
    from repro_torch import obs
    from repro_torch.launch import serve, train

    d = tempfile.mkdtemp(prefix="chip_smoke_store_")
    f = {k: os.path.join(d, k) for k in ("store", "ckpt", "trace.json",
                                         "metrics.jsonl", "audit.jsonl",
                                         "report.md")}
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    try:
        stats = train.main(TRAIN_CLI_ASYNC_ARGS + [
            "--device", str(device),
            "--policy-store-dir", f["store"], "--ckpt-dir", f["ckpt"],
            "--trace-out", f["trace.json"], "--metrics-out",
            f["metrics.jsonl"], "--audit-out", f["audit.jsonl"]])
        for name in ("runtime", "hostmem", "memory"):
            obs.metrics().unregister_provider(name)
        tools = {
            "validate": subprocess.run(
                [sys.executable, "-m", "repro_torch.obs.validate",
                 f["trace.json"], "--require-lanes", "compute,adapt",
                 "--metrics", f["metrics.jsonl"], "--require-providers",
                 "memory,runtime"], capture_output=True, text=True, env=env,
                timeout=120),
            "report": subprocess.run(
                [sys.executable, "-m", "repro_torch.obs.report", "--trace",
                 f["trace.json"], "--metrics", f["metrics.jsonl"], "--audit",
                 f["audit.jsonl"], "--out", f["report.md"]],
                capture_output=True, text=True, env=env, timeout=120)}
        with open(f["report.md"]) as fh:
            report_md = fh.read()
        srv = serve.main(SERVE_CLI_STORE_ARGS + [
            "--device", str(device), "--policy-store-dir", f["store"]])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    ad, ps = stats["adapt"], srv["policystore"]
    problems = [k for k, r in tools.items() if r.returncode != 0]
    if not ad or ad["installed"] < 1 or ad["failed"]:
        problems.append("train: no install, or a failed job")
    if stats["policystore"]["store"]["records"] < 1:
        problems.append("train: no store record")
    if "adaptation:" not in report_md:
        problems.append("report: no adaptation events")
    if srv["adapt"]["store_refreshes"] < 1:
        problems.append("serve: no store refresh")
    if ps["records"] != stats["policystore"]["store"]["records"]:
        problems.append("serve: the store's records differ from the train "
                        "run's")
    emit("train_cli_store", ok=not problems, problems=problems,
         stages=stats["stages"], adapt=ad,
         store=stats["policystore"]["store"],
         validate=tools["validate"].stdout.strip().splitlines(),
         report_rc=tools["report"].returncode,
         report=[ln for ln in report_md.splitlines() if ln.startswith("- ")],
         serve_ticks=srv["ticks"], serve_adapt=srv["adapt"],
         serve_store=ps)
    if problems:
        raise AssertionError(f"train_cli_store: {problems}; "
                             f"{tools['validate'].stderr[-2000:]} "
                             f"{tools['report'].stderr[-2000:]}")


def phase_serve_ssm(device):
    """``repro_torch.launch.serve.main`` on full-width mamba2-780m (bf16,
    random weights from a seed): 8 requests, 4 slots, prompts of 65..900
    tokens, 32 new tokens each.  K4's launch count is reset just before and
    must equal prefills x layers just after.  Returns the launches."""
    from repro_torch.kernels.ssd_scan import ops as SSD
    from repro_torch.launch import serve

    allocated_before = release_device_memory(device)
    SSD.ssd_scan.launches = 0                       # count the main path only
    stats = serve.main(SSM_SERVE_ARGS)
    launches = SSD.ssd_scan.launches
    n_req, n_new, n_layers = 8, 32, 48
    lengths = {rid: len(toks) for rid, toks in stats["results"].items()}
    if stats["completed"] != n_req or set(lengths.values()) != {n_new}:
        raise AssertionError(f"serve_ssm: want {n_req} requests of {n_new} "
                             f"tokens, got {lengths}")
    prefills = stats["latency"]["prefill_ms"]["n"]
    if prefills != n_req or launches != n_req * n_layers:
        raise AssertionError(f"serve_ssm: ssd_scan launched {launches} "
                             f"times for {prefills} prefills x {n_layers} "
                             "layers")
    emit("serve_ssm", arch=stats["arch"], launches=launches,
         prefills=prefills, prompt_lens=stats["prompt_lens"],
         tokens=stats["tokens"], wall_s=stats["wall_s"],
         tokens_per_s=stats["tokens_per_s"], ticks=stats["ticks"],
         tick_ms=stats["latency"]["tick_ms"],
         prefill_ms=stats["latency"]["prefill_ms"],
         max_memory_allocated=stats["max_memory_allocated"],
         allocated_before=allocated_before)
    return launches


def ssm_prefill_vs_decode(device, cfg, model) -> dict:
    """Prefill logits of one SSM_CROSSCHECK_LEN-token prompt (K4) against
    token-by-token decode from an empty state (the recurrence)."""
    import torch
    from repro_torch.models import transformer as T

    prompt = serve_prompts(1, cfg.vocab_size)[0][:SSM_CROSSCHECK_LEN]
    toks = torch.as_tensor(prompt[None], dtype=torch.int64, device=device)
    with torch.no_grad():
        lp, _ = T.prefill(cfg, model, toks, SSM_CROSSCHECK_LEN)
        state = T.init_decode_state(cfg, 1, SSM_CROSSCHECK_LEN, params=model)
        steps = []
        for t in range(SSM_CROSSCHECK_LEN):
            lg, state = T.decode_step(cfg, model, toks[:, t:t + 1], state)
            steps.append(lg[0, 0].float())
    lp, ld = lp[0].float(), torch.stack(steps)
    dmax = float((lp - ld).abs().max())
    top2 = ld.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * dmax
    agree = lp.argmax(-1) == ld.argmax(-1)
    return {"dtype": cfg.dtype, "prompt_len": SSM_CROSSCHECK_LEN,
            "max_abs_dlogit": dmax, "max_abs_logit": float(lp.abs().max()),
            "rel_dlogit": dmax / float(lp.abs().max()),
            "finite": bool(torch.isfinite(lp).all()
                           and torch.isfinite(ld).all()),
            "argmax_agree_frac": float(agree.float().mean()),
            "decided_positions": int(decided.sum()),
            "decided_agree": bool(agree[decided].all())}


def phase_ssm_crosscheck(device, cfg, model):
    """Full-width mamba2-780m, prefill against token-by-token decode: in
    f32 (weights drawn from the same seed) within SSM_CROSSCHECK_TOL of the
    largest |logit|; in bf16, as served, finite and with the same greedy
    token at every decided position."""
    import torch
    from repro_torch.models import transformer as T

    f32 = cfg.replace(dtype="float32", param_dtype="float32")
    row = ssm_prefill_vs_decode(device, f32,
                                T.init_model(f32, seed=0, device=device))
    row["tol"] = SSM_CROSSCHECK_TOL
    emit("ssm_crosscheck", **row)
    gc.collect()                       # the f32 model is gone
    torch.cuda.empty_cache()
    if not row["finite"] or row["rel_dlogit"] > SSM_CROSSCHECK_TOL:
        raise AssertionError(f"mamba2 prefill and decode disagree: {row}")
    row = ssm_prefill_vs_decode(device, cfg, model)
    emit("ssm_crosscheck", **row)
    if not row["finite"] or not row["decided_agree"]:
        raise AssertionError(f"mamba2 prefill and decode disagree: {row}")


def phase_calibrate(device):
    """The host link, swap-out and swap-in round trips through the engine
    at each size: the per-direction minima as GB/s.  Returns the tier,
    whose calibrated link the chameleon phase plans with."""
    from repro_torch.common.config import HOSTMEM_CALIBRATION_SIZES
    from repro_torch.hostmem import HostMemTier

    tier = HostMemTier(device=device)
    tier.calibrate(sizes=HOSTMEM_CALIBRATION_SIZES + (1 << 27, 1 << 29))
    curve = [{"bytes": n, "d2h_s": d2h, "h2d_s": h2d,
              "d2h_gbps": n / d2h / 1e9, "h2d_gbps": n / h2d / 1e9}
             for n, (d2h, h2d) in sorted(tier.link_curve.items())]
    emit("calibrate", curve=curve,
         pool_peak_reserved=tier.pool.peak_reserved)
    return tier


def p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def exec_row(last) -> dict:
    """An execution's counters (``Execution.last``) for a printed row:
    its measured copy stall, recompute, hook, host-wait and settle time in
    ms, and the P4_WORST entries that stalled longest, each [tag, bytes,
    stall ms, copy ms, lead ms] (the copy began ``lead`` ms before it was
    needed)."""
    if last is None:
        return None
    row = {k: v for k, v in last.items() if k != "stall_entries"}
    ents = sorted(last["stall_entries"], key=lambda e: -e[2])
    row.update(fences=len(ents),
               worst=[list(e) for e in ents[:P4_WORST]],
               copy_stall_ms=last["copy_stall_s"] * 1e3,
               recompute_ms=last["recompute_s"] * 1e3,
               hook_ms=last["hook_s"] * 1e3,
               host_wait_ms=last["host_wait_s"] * 1e3,
               settle_ms=last["settle_s"] * 1e3)
    return row


def alloc_retries(device) -> int:
    """The caching allocator's retries so far (each frees the cache and
    synchronises the device)."""
    import torch
    return torch.cuda.memory_stats(device).get("num_alloc_retries", 0)


def step_retries(readings) -> list:
    """Per step, from a reading before the first and one after each step:
    the allocator retries the step took."""
    return [{"alloc_retries": b - a} for a, b in zip(readings, readings[1:])]


def reserved_probe(device, fns, args) -> dict:
    """The caching allocator's reserved peak of each grad dispatch in
    ``fns`` (name -> callable) on ``args``, each from an empty cache; an
    execution's books are closed after its run."""
    import torch
    out = {}
    for name, fn in fns.items():
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        res = fn(*args)
        torch.cuda.synchronize()
        out[name] = torch.cuda.max_memory_reserved(device)
        del res
        ex = getattr(fn, "execution", None)
        if ex is not None:
            ex.settle()
    return out


def p4_check(projected_ms, measured_ms) -> bool:
    """P4's gate: the projected stall against the measured copy stall."""
    return abs(projected_ms - measured_ms) <= max(P4_ABS_MS,
                                                  P4_REL * measured_ms)


def p4_policy(rows, off_ms, off_grad_ms, off_alloc=None,
              reserved=None) -> dict:
    """P4's readings of the steps one installed policy ran (``rows``: dicts
    with ``step_ms``, ``t_grad_ms``, ``projected_stall_s`` and ``exec``,
    on the card also ``slab_allocs`` and ``alloc_retries``), against
    Chameleon off's step and grad ms (and ``off_alloc``, its allocator
    readings) on the same steps, and ``reserved``, the grad dispatch's
    reserved peak under the policy and off (``reserved_probe``): the medians
    of dt, t_grad, the measured copy stall, recompute and hook ms (with its parts: the release ops, the
    prefetches, the pack hooks), the books after the step and the release
    ops that found their copy running; the projected stall, the worst
    entries of the step whose copy stall is the median, the on - off
    differences of the step and of the grad dispatch; the host's waits on
    the policy's copies inside the grad dispatch (count and ms over the
    steps), the pinned slabs allocated, the allocator's retries on and off
    and the reserved peaks."""
    ex = [r["exec"] for r in rows if r["exec"] is not None]
    stall = [e["copy_stall_ms"] for e in ex] or [0.0]
    mid = p50(stall)
    worst = next((e["worst"] for e in ex if e["copy_stall_ms"] == mid), [])
    on, grad = p50([r["step_ms"] for r in rows]), p50(
        [r["t_grad_ms"] for r in rows])
    med = {k: p50([e[k] for e in ex] or [0.0])
           for k in ("recompute_ms", "hook_ms", "settle_ms",
                     "released_late")}
    hook = {k: p50([e[k] * 1e3 for e in ex] or [0.0])
            for k in ("release_s", "prefetch_s", "pack_s")}
    out = {"steps": len(rows), "dt_ms": on, "t_grad_ms": grad,
           "projected_stall_ms": (rows[-1]["projected_stall_s"] or 0.0) * 1e3,
           "copy_stall_ms": mid, "copy_stall_ms_range": [min(stall),
                                                         max(stall)],
           "worst": worst, **med,
           "release_ms": hook["release_s"], "prefetch_ms": hook["prefetch_s"],
           "pack_ms": hook["pack_s"],
           "on_minus_off_ms": on - p50(off_ms) if off_ms else None,
           "grad_on_minus_off_ms": (grad - p50(off_grad_ms)
                                    if off_grad_ms else None),
           "host_waits": sum(e["host_waits"] for e in ex),
           "host_wait_ms": sum(e["host_wait_ms"] for e in ex)}
    if rows and "alloc_retries" in rows[0]:
        out.update(
            slab_allocs=sum(r["slab_allocs"] for r in rows),
            alloc_retries=sum(r["alloc_retries"] for r in rows),
            alloc_retries_off=sum(a["alloc_retries"] for a in off_alloc))
    if reserved is not None:
        out.update(reserved_peak=reserved["policy"],
                   reserved_peak_off=reserved["baseline"])
    return out


def p4_host_checks(label, rows, q) -> list:
    """P4's remainder (above) over a policy's Stable ``rows`` and its
    readings ``q`` (``p4_policy``): the problems found."""
    problems = []
    waits = [r["exec"]["host_waits"] for r in rows if r["exec"] is not None]
    if any(waits):
        problems.append(f"{label}: {sum(waits)} host waits on policy "
                        "copies inside Stable grad dispatches")
    if "alloc_retries" in q and q["alloc_retries"] > q["alloc_retries_off"]:
        problems.append(f"{label}: {q['alloc_retries']} allocator retries "
                        f"against off's {q['alloc_retries_off']}")
    if "reserved_peak" in q and q["reserved_peak"] >= q["reserved_peak_off"]:
        problems.append(f"{label}: reserved peak {q['reserved_peak']} not "
                        f"below off's {q['reserved_peak_off']}")
    return problems


def timeline_floor(prof) -> int:
    """The profile's peak with every candidate absent for its whole life:
    no swap policy of these candidates can go below it."""
    import numpy as np
    n = prof.n_ops
    delta = np.zeros(n + 2, np.int64)
    for t in prof.tensors:
        if t.site is None:
            b = min(max(t.birth, 0), n)
            delta[b] += t.nbytes
            delta[min(max(t.death, b), n + 1)] -= t.nbytes
    return int(np.cumsum(delta)[: n + 1].max(initial=0)) + prof.static_bytes


def plan(prof, tier, budget):
    """generate_policy at ``budget`` with the calibrated link and the live
    engine (``tier`` None: the constant link of ``ChameleonConfig`` and an
    idle engine, as a runtime's uncalibrated tier prices): the policy, or
    the ChameleonOOMError's message."""
    from repro_torch.common.config import ChameleonConfig
    from repro_torch.core.policy import ChameleonOOMError, generate_policy
    t0 = time.perf_counter()
    try:
        pol = generate_policy(prof, ChameleonConfig(), budget,
                              bwmodel=tier.bwmodel if tier else None,
                              engine=tier.engine if tier else None)
    except ChameleonOOMError as e:
        return None, {"budget": budget, "oom": str(e),
                      "ms": (time.perf_counter() - t0) * 1e3}
    return pol, {
        "budget": budget, "ms": (time.perf_counter() - t0) * 1e3,
        "entries": len(pol.entries), "swapped_bytes": pol.swapped_bytes,
        "stalled": sum(e.stalled for e in pol.entries),
        "stall_s": pol.stall_time, "projected_peak": pol.projected_peak,
        "baseline_peak": pol.baseline_peak,
        "contention_s": pol.contention_s, "occupancy": pol.occupancy,
        "sites": sorted({f"{e.site}:{e.layer}" for e in pol.entries})}


def tightest_plan(prof, tier, floor, peak, rounds: int = 10):
    """Bisect the budget between the floor (no policy reaches it) and the
    peak (the empty policy meets it) for the lowest one that a policy
    meets: ``generate_policy`` returns, and the policy's projected peak
    (the timeline replayed with its swaps) is at or below the budget.
    Algo 2 stops when its MRL is cleared, and the MRL counts a swapped
    tensor absent from its birth, while the replay counts it absent only
    once its swap-out is done, so the first can hold where the second does
    not.  Returns (policy, its row, the rows of every budget tried)."""
    lo, hi = floor, peak
    best, best_row = plan(prof, tier, hi)
    tried = []
    for _ in range(rounds if peak - floor > (1 << 20) else 0):
        mid = (lo + hi) // 2
        pol, row = plan(prof, tier, mid)
        tried.append({k: row.get(k) for k in ("budget", "entries", "oom",
                                              "projected_peak", "ms")})
        if pol is None or pol.projected_peak > mid:
            lo = mid
        else:
            hi, best, best_row = mid, pol, row
    return best, best_row, tried


def op_names():
    from repro_torch.core.tokenizer import GLOBAL_VOCAB
    return {tok: name for name, tok in GLOBAL_VOCAB._ids.items()}


def phase_chameleon(device, tier):
    """Chameleon's monitoring and planning on the train phase's model:
    the op-stream recorder and Algo 1 over CHAM_STEPS trainer steps, the
    recorder's cost, one detailed profile, policies from it, and the P2
    check of the engine's link signals.  Every check raises."""
    import shutil
    import tempfile
    import torch
    import repro_torch.configs as C
    from repro_torch.common.config import ChameleonConfig, TrainConfig
    from repro_torch.core.memtrace import build_timeline
    from repro_torch.core.policy import ChameleonOOMError
    from repro_torch.core.profiler import profile_step
    from repro_torch.core.stages import StageMachine
    from repro_torch.core.tokenizer import (OpStreamRecorder,
                                            SignatureAccumulator,
                                            sig_similarity)
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.distributed import steps as S
    from repro_torch.hostmem import TC_CHECKPOINT
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainer import Trainer

    allocated_before = release_device_memory(device)
    cfg = C.get_config("llama2-paper").replace(num_layers=TRAIN_LAYERS,
                                               attn_impl="flash")
    tcfg = TrainConfig(steps=100, learning_rate=TRAIN_LR,
                       warmup_steps=TRAIN_WARMUP, eval_every=CHAM_EVAL_EVERY,
                       checkpoint_every=0,
                       checkpoint_dir=tempfile.mkdtemp(prefix="chip_smoke_"))
    tr = Trainer(cfg, tcfg, ChameleonConfig(enabled=False),
                 data=SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                      seed=0), device=device)

    # ---- 1. Lightweight monitoring and Algo 1 over the trainer's steps
    rec, acc = OpStreamRecorder(), SignatureAccumulator()
    sm = StageMachine(ChameleonConfig())
    steps = []
    for i in range(CHAM_STEPS):
        ov = rec.overhead_s
        with rec.iteration() as it:
            tr.train(1)
        sig = acc.update([it.stream])
        ld, cos = ((0.0, 1.0) if sm.prev_seq is None
                   else sig_similarity(sig, sm.prev_seq))
        steps.append({"step": i, "ops": len(sig), "len_diff": ld, "cos": cos,
                      "stage": sm.observe(sig, i).value,
                      "overhead_ms": (rec.overhead_s - ov) * 1e3,
                      "step_ms": tr.report.times[-1] * 1e3})
    stages = [r["stage"] for r in steps]
    emit("chameleon_monitor", steps=steps, stages=stages,
         transitions=sm.transitions, want=CHAM_STAGES,
         overhead_ms_per_step=rec.overhead_s * 1e3 / CHAM_STEPS)
    if stages != CHAM_STAGES:
        raise AssertionError(f"chameleon: stages {stages}, want "
                             f"{CHAM_STAGES}")

    # the step time with the recorder on and off, in turns; steps that ran
    # an eval are left out of both
    times = {"on": [], "off": []}
    for j in range(CHAM_ONOFF_PAIRS):
        for mode in (("on", "off") if j % 2 == 0 else ("off", "on")):
            evaluates = tr.step > 0 and tr.step % CHAM_EVAL_EVERY == 0
            if mode == "on":
                with rec.iteration():
                    tr.train(1)
            else:
                tr.train(1)
            if not evaluates:
                times[mode].append(tr.report.times[-1] * 1e3)

    # one grad step on a fixed batch without the recorder, twice, and with
    # it: the monitor observes and changes nothing.  Every value the two
    # runs without it agree on bit for bit must come out bit for bit under
    # it (a value two plain runs disagree on is named, not compared)
    batch = tr._device_batch(tr.data.batch_at(0))
    grad = S.make_grad_step(cfg, tcfg)
    loss0, g0, _ = grad(tr.model, batch, 1.0)
    loss2, g2, _ = grad(tr.model, batch, 1.0)
    with rec.iteration() as it:
        loss1, g1, _ = grad(tr.model, batch, 1.0)
    n_grad_ops = len(it.stream)
    g0["loss"], g1["loss"], g2["loss"] = loss0, loss1, loss2
    unrepeatable = [n for n in g0 if not torch.equal(g0[n], g2[n])]
    changed = [n for n in g0 if n not in unrepeatable
               and not torch.equal(g0[n], g1[n])]
    bit_equal = not changed
    del g0, g1, g2
    emit("chameleon_overhead", step_ms_on=times["on"],
         step_ms_off=times["off"], step_ms_on_p50=p50(times["on"]),
         step_ms_off_p50=p50(times["off"]),
         on_over_off=p50(times["on"]) / p50(times["off"]),
         recorder_overhead_ms_per_step=rec.overhead_s * 1e3 / rec.iterations,
         grad_step_ops=n_grad_ops, grads_bit_equal=bit_equal,
         changed_under_recorder=changed,
         unrepeatable_without_recorder=unrepeatable)
    if not bit_equal:
        raise AssertionError(f"chameleon: {changed} changed under the "
                             "recorder")

    # ---- 2. Detailed profile of one step (not an eval step)
    if (tr.step + 1) % CHAM_EVAL_EVERY == 0 or tr.step % CHAM_EVAL_EVERY == 0:
        tr.train(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    fwd0, bwd0 = ops.flash_attention.launches, ops.flash_attention_bwd.launches
    t0 = time.perf_counter()
    prof = profile_step(lambda: tr.train(1), device=device)
    profile_wall_ms = (time.perf_counter() - t0) * 1e3
    measured_peak = torch.cuda.max_memory_allocated(device)
    fwd, bwd = (ops.flash_attention.launches - fwd0,
                ops.flash_attention_bwd.launches - bwd0)
    tl = build_timeline(prof)
    names = op_names()
    op_list = [names[t] for t in prof.op_tokens]
    pairs = {}
    for t in prof.candidates:
        p = pairs.setdefault(f"{t.site}:{t.layer}", [0, 0])
        p[0] += 1
        p[1] += t.nbytes
    missing = [f"{s}:{i}" for i in range(TRAIN_LAYERS) for s in CHAM_SITES
               if f"{s}:{i}" not in pairs]
    esize = torch.finfo(getattr(torch, cfg.dtype)).bits // 8   # bf16: 2
    wrong_bytes = [(t.site, t.layer, t.nbytes, t.shape)
                   for t in prof.candidates if t.site in CHAM_SITES
                   and t.nbytes != math.prod(t.shape) * esize]
    ffn = {}
    for t in sorted(prof.candidates, key=lambda t: t.birth):
        if t.site == "ffn_pre":
            ffn.setdefault(t.layer, t)
    births = [ffn[i].birth for i in sorted(ffn)]
    deaths = [ffn[i].death for i in sorted(ffn)]
    k1 = (op_list.count("repro_torch::flash_attention_fwd"),
          op_list.count("repro_torch::flash_attention_bwd"))
    # the backward, which the autograd engine runs on its device thread,
    # is in the stream: products before K1's first backward and after it
    first_bwd = (op_list.index("repro_torch::flash_attention_bwd")
                 if k1[1] else prof.n_ops)
    mm = [i for i, n in enumerate(op_list) if n == "aten::mm"]
    peak_err = abs(tl.peak - measured_peak) / measured_peak
    row = {"n_ops": prof.n_ops, "storages": len(prof.tensors),
           "candidates": len(prof.candidates), "site_bytes": pairs,
           "static_bytes": prof.static_bytes, "t_iter_s": prof.t_iter,
           "profile_wall_ms": profile_wall_ms,
           "plain_step_ms_p50": p50(times["off"]),
           "k1_tokens": k1, "k1_launches": (fwd, bwd),
           "timeline_peak": tl.peak, "peak_op": tl.peak_op,
           "max_memory_allocated": measured_peak, "peak_rel_err": peak_err,
           "mm_before_k1_bwd": sum(i < first_bwd for i in mm),
           "mm_after_k1_bwd": sum(i > first_bwd for i in mm),
           # the peak of the grad step (forward, backward, unscale) alone
           "grad_step_peak_op": int(tl.usage[:n_grad_ops].argmax()),
           "grad_step_peak": int(tl.usage[:n_grad_ops].max())
           + prof.static_bytes,
           # Eq. 1 gives every op the same share of t_iter: where the ops
           # fall, the grad step's (forward, backward, unscale) and the
           # rest of the step's (the optimizer, which follows)
           "grad_step_ops": n_grad_ops,
           "tail_ops": prof.n_ops - n_grad_ops,
           "ffn_pre_births": births, "ffn_pre_deaths": deaths,
           "missing_sites": missing, "wrong_bytes": wrong_bytes[:8]}
    emit("chameleon_profile", **row)
    problems = []
    if k1 != (TRAIN_LAYERS, TRAIN_LAYERS) or (
            device.type == "cuda" and (fwd, bwd) != k1):
        problems.append("K1 tokens / launches")
    if missing or wrong_bytes:
        problems.append("site bytes")
    if births != sorted(births) or deaths != sorted(deaths, reverse=True) \
            or len(births) != TRAIN_LAYERS:
        problems.append("sawtooth")
    if peak_err > CHAM_PEAK_TOL:
        problems.append("timeline peak")
    if not row["mm_before_k1_bwd"] or not row["mm_after_k1_bwd"]:
        problems.append("backward ops")
    if problems:
        raise AssertionError(f"chameleon profile: {problems}")

    # ---- 3. Planning on that profile: the lowest budget between the floor
    # (every candidate absent for its whole life) and the peak that a
    # policy meets, and a budget below the floor, which must raise
    floor = timeline_floor(prof)
    pol, got, tried = tightest_plan(prof, tier, floor, tl.peak)
    _, below = plan(prof, tier, floor - (1 << 20))
    _, at_half = plan(prof, tier, prof.static_bytes
                      + (tl.peak - prof.static_bytes) // 2)

    # the same planning over the forward and backward alone, where the
    # activations the candidates are live
    def fwd_bwd():
        loss, _ = T.loss_fn(cfg, tr.model, batch)
        loss.backward()
    fb = profile_step(fwd_bwd, device=device)
    for p in tr.model.parameters():
        p.grad = None
    fb_tl = build_timeline(fb)
    fb_floor = timeline_floor(fb)
    fb_pol, fb_got, fb_tried = tightest_plan(fb, tier, fb_floor, fb_tl.peak)
    _, fb_half = plan(fb, tier,
                      fb.static_bytes + (fb_tl.peak - fb.static_bytes) // 2)

    def gap(peak, floor, row):
        return (peak - row["projected_peak"]) / max(peak - floor, 1)

    emit("chameleon_plan",
         step={"floor": floor, "peak": tl.peak, "tightest": got,
               "gap_closed": gap(tl.peak, floor, got), "tried": tried,
               "below_floor": below, "half_dynamic": at_half},
         fwd_bwd={"n_ops": fb.n_ops, "static_bytes": fb.static_bytes,
                  "peak": fb_tl.peak, "peak_op": fb_tl.peak_op,
                  "floor": fb_floor, "tightest": fb_got,
                  "gap_closed": gap(fb_tl.peak, fb_floor, fb_got),
                  "tried": fb_tried, "half_dynamic": fb_half})
    for p_, row in ((pol, got), (fb_pol, fb_got)):
        if p_ is None or p_.projected_peak > row["budget"]:
            raise AssertionError(f"chameleon: no policy under its budget: "
                                 f"{row}")
    if not fb_pol.entries:
        raise AssertionError("chameleon: no swap planned over the forward "
                             f"and backward: {fb_got}")
    if "oom" not in below:
        raise AssertionError(f"chameleon: a budget below the floor planned: "
                             f"{below}")
    del prof, fb, pol, fb_pol

    # ---- P2: the engine's backlog of checkpoint copies on the card
    eng = tier.engine
    eng.set_class_depth(TC_CHECKPOINT, P2_COPIES)
    srcs = [torch.full((P2_BYTES,), i, dtype=torch.uint8, device=device)
            for i in range(P2_COPIES)]
    for warm in (True, False):
        torch.cuda.synchronize()
        evs = [eng.submit_swap_out(x, f"p2-{i}", cls=TC_CHECKPOINT)
               for i, x in enumerate(srcs)]
        delay = eng.queued_delay(TC_CHECKPOINT)
        torch.cuda.synchronize()
        delay_done = eng.queued_delay(TC_CHECKPOINT)
        eng.synchronize()
        link_s = sum(e.seconds for e in evs)
        for e in evs:
            tier.pool.free(e.block)
    ratio = delay / link_s if link_s else None
    p2 = {"copies": P2_COPIES, "bytes": P2_BYTES, "queued_delay_s": delay,
          "measured_link_s": link_s, "ratio": ratio,
          "queued_delay_after_s": delay_done,
          "link_gbps": P2_COPIES * P2_BYTES / link_s / 1e9}
    emit("chameleon_p2", **p2)
    if not (delay > 0 and 1 / P2_RATIO <= ratio <= P2_RATIO
            and delay_done == 0.0):
        raise AssertionError(f"chameleon: P2 {p2}")
    del srcs

    # ---- K1's host cost per call through the custom op
    B, Sq, H, D = OP_COST_SHAPE
    q = torch.randn(B, Sq, H, D, device=device, dtype=torch.bfloat16)
    scale = D ** -0.5

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OP_COST_CALLS):
            fn()
        us = (time.perf_counter() - t0) / OP_COST_CALLS * 1e6
        torch.cuda.synchronize()
        return us

    def direct():
        ops._forward(q, q, q, causal=True, sm_scale=scale, kv_lens=None,
                     with_lse=False)

    def custom_op():
        torch.ops.repro_torch.flash_attention_fwd(q, q, q, None, True, scale,
                                                  False)

    cost = {"direct": [], "custom_op": []}
    for name in ("direct", "custom_op", "custom_op", "direct"):
        cost[name].append(host_us(direct if name == "direct" else custom_op))
    emit("chameleon_op_cost", shape=list(OP_COST_SHAPE),
         calls=OP_COST_CALLS, host_us=cost,
         custom_op_extra_us=min(cost["custom_op"]) - min(cost["direct"]))
    shutil.rmtree(tcfg.checkpoint_dir, ignore_errors=True)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    emit("chameleon", ok=True, allocated_before=allocated_before,
         total_memory=torch.cuda.get_device_properties(device).total_memory)


def exec_train(device, cfg, cham, seq=TRAIN_SEQ,
               eval_every=CHAM_EXEC_EVAL_EVERY, data=None, adapt_mode=None,
               batch=TRAIN_BATCH):
    """A trainer of the chameleon_exec phase (a fresh checkpoint dir); the
    chameleon_async phase's with its own sequence length, no eval, its
    bucket's data and a placement."""
    import tempfile
    from repro_torch.common.config import TrainConfig
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.runtime.trainer import Trainer
    tcfg = TrainConfig(steps=100, learning_rate=TRAIN_LR,
                       warmup_steps=TRAIN_WARMUP,
                       eval_every=eval_every, checkpoint_every=0,
                       checkpoint_dir=tempfile.mkdtemp(prefix="chip_smoke_"))
    if data is None:
        data = SyntheticTokens(cfg.vocab_size, seq, batch, seed=0)
    return Trainer(cfg, tcfg, cham, data=data, device=device,
                   adapt_mode=adapt_mode)


def drop_trainer(tr, keep_dir: bool = False) -> None:
    """Let a trainer go: the metrics registry's providers hold it (and its
    parameters and optimizer state on the card) until they are
    unregistered; then its runtime's service and, unless ``keep_dir``,
    its checkpoint directory."""
    import shutil
    from repro_torch import obs
    for name in ("runtime", "hostmem"):
        obs.metrics().unregister_provider(name)
    if getattr(tr, "rt", None) is not None:
        tr.rt.close()
    if not keep_dir:
        shutil.rmtree(tr.tcfg.checkpoint_dir, ignore_errors=True)


def exec_budget(device, cfg, seq=TRAIN_SEQ, phase="chameleon_exec",
                batch=TRAIN_BATCH):
    """B for the chameleon_exec phase: after two steps of a Chameleon-on
    trainer with no budget to meet (the baseline policy runs), its
    runtime's detailed profile of the grad dispatch (``profile_step`` over
    a replay, the profile its GenPolicy steps take), priced as the runtime
    prices it, at the second step's grad dispatch time
    (``report.grad_times``), and bisected between its floor and its peak.
    Returns
    (B, row).  The chameleon_async phase takes it at its longer bucket,
    the examples phase at train_e2e's preset and traffic, ckpt_full at
    its depth."""
    import torch
    from repro_torch.common.config import ChameleonConfig
    from repro_torch.core.memtrace import build_timeline

    tr = exec_train(device, cfg, ChameleonConfig(enabled=True,
                                                 hbm_budget_bytes=1 << 62),
                    seq=seq, batch=batch)
    for _ in range(2):
        tr.train(1)
    prof = tr.rt._baseline_profile(tr.rt._last_train_args,
                                   tr.report.grad_times[-1])
    tl = build_timeline(prof)
    floor = timeline_floor(prof)
    pol, got, tried = tightest_plan(prof, None, floor, tl.peak)
    if pol is None or pol.projected_peak > got["budget"]:
        raise AssertionError(f"{phase}: no policy under a budget: {got}")
    budget = int(got["budget"] * CHAM_EXEC_MARGIN)
    row = {"budget": budget, "floor": floor, "peak": tl.peak,
           "peak_op": tl.peak_op, "n_ops": prof.n_ops,
           "static_bytes": prof.static_bytes, "t_iter_s": prof.t_iter,
           "dt_s": tr.report.times[-1], "tightest": got, "tried": tried}
    drop_trainer(tr)
    del tr, prof, pol
    gc.collect()
    torch.cuda.empty_cache()
    return budget, row


def grad_turns(device, tr):
    """The grad dispatch through the runtime under the applied policy and
    under the baseline policy, CHAM_EXEC_TURNS times each in turns on one
    batch: ``max_memory_allocated`` (reset before each) and ms."""
    import torch
    rt = tr.rt
    batch = tr._device_batch(tr.data.batch_at(0))
    args = (tr.model, batch, tr.loss_scale.scale)
    fns = {"policy": rt.step_fn(),
           "baseline": rt._get_step(rt.executor.baseline())}
    out = {k: {"peak": [], "ms": []} for k in fns}
    for j in range(CHAM_EXEC_TURNS):
        for name in (("policy", "baseline") if j % 2 == 0
                     else ("baseline", "policy")):
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            res = fns[name](*args)
            torch.cuda.synchronize()
            out[name]["ms"].append((time.perf_counter() - t0) * 1e3)
            out[name]["peak"].append(torch.cuda.max_memory_allocated(device))
            del res
            ex = getattr(fns[name], "execution", None)
            if ex is not None:
                ex.settle()              # after the sync, untimed
    ex = fns["policy"].execution
    out["policy_exec"] = exec_row(ex.last) if ex is not None else None
    out["reserved"] = reserved_probe(device, fns, args)
    return out


def phase_chameleon_exec(device):
    """Chameleon in the trainer on the train phase's model (phase 18 of the
    module doc).  Every check raises.  Returns K1's launches in the
    Chameleon-on run (forward, backward) and its budget."""
    import torch
    import repro_torch.configs as C
    from repro_torch import obs
    from repro_torch.common.config import ChameleonConfig
    from repro_torch.core.memtrace import build_timeline
    from repro_torch.kernels.flash_attention import ops

    for name in ("runtime", "hostmem"):      # earlier phases' trainers
        obs.metrics().unregister_provider(name)
    allocated_before = release_device_memory(device)
    cfg = C.get_config("llama2-paper").replace(num_layers=TRAIN_LAYERS,
                                               attn_impl="flash")
    budget, brow = exec_budget(device, cfg)
    emit("chameleon_exec_budget", **brow)

    # ---- Chameleon on, step by step
    obs.ledger().clear()
    tr = exec_train(device, cfg, ChameleonConfig(enabled=True,
                                                 hbm_budget_bytes=budget))
    rt = tr.rt
    eng = rt.hostmem.engine
    torch.cuda.synchronize()
    ops.flash_attention.launches = 0                # count the main path only
    ops.flash_attention_bwd.launches = 0
    rows, alloc = [], [alloc_retries(device)]
    for i in range(CHAM_EXEC_STEPS):
        c0 = eng.by_class["policy_swap"].as_dict()
        r0 = rt.recorder.overhead_s
        s0 = rt.hostmem.pool.slab_allocs
        tr.train(1)
        alloc.append(alloc_retries(device))
        c1 = eng.by_class["policy_swap"].as_dict()
        ex = rt._last_dispatch.execution         # None: a plain policy ran
        ran = ex.applied if ex is not None else rt.executor.baseline()
        swap = ran.swap
        rows.append({
            "step": i, "stage": tr.report.stages[-1],
            "step_ms": tr.report.times[-1] * 1e3,
            "t_grad_ms": tr.report.grad_times[-1] * 1e3,
            "recorder_ms": (rt.recorder.overhead_s - r0) * 1e3,
            "loss": tr.report.losses[-1],
            "eval": i in tr.report.eval_losses,
            "policy": ran.fingerprint, "offload": sorted(ran.offload),
            "remat": sorted(ran.remat),
            "entries": len(swap.entries) if swap else 0,
            "projected_swapped_bytes": swap.swapped_bytes if swap else 0,
            "projected_stall_s": swap.stall_time if swap else None,
            "projected_peak": swap.projected_peak if swap else None,
            "d2h_bytes": c1["bytes_out"] - c0["bytes_out"],
            "h2d_bytes": c1["bytes_in"] - c0["bytes_in"],
            "d2h_ms": (c1["time_out_s"] - c0["time_out_s"]) * 1e3,
            "h2d_ms": (c1["time_in_s"] - c0["time_in_s"]) * 1e3,
            "forced_retires": c1["forced_retires"] - c0["forced_retires"],
            "released_at_op": c1["released_at_op"] - c0["released_at_op"],
            "slab_allocs": rt.hostmem.pool.slab_allocs - s0,
            **step_retries(alloc[-2:])[0],
            "exec": exec_row(ex.last) if ex is not None else None})
    fwd, bwd = ops.flash_attention.launches, ops.flash_attention_bwd.launches
    rep = tr.report
    stages = rep.stages
    transitions = [tuple(t) for t in rt.machine.transitions]
    evals = len(rep.eval_losses)
    want_fwd = (CHAM_EXEC_STEPS + evals + rt.replays) * TRAIN_LAYERS
    want_bwd = (CHAM_EXEC_STEPS + rt.replays) * TRAIN_LAYERS
    stable = [r for r in rows if r["stage"] == "Stable"]
    applied = rt.applied
    emit("chameleon_exec_steps", budget=budget, stages=stages,
         transitions=transitions, steps=rows,
         lowered={"offload": sorted(applied.offload),
                  "save": sorted(applied.save),
                  "remat": sorted(applied.remat),
                  "fingerprint": applied.fingerprint,
                  "release_plan": len(applied.release_plan)},
         variants=[{"knob": v.knob, "measured_ms": (v.measured_t or 0) * 1e3,
                    "policy": v.applied.fingerprint} for v in rt.variants],
         adaptations=rt.adaptations, replays=rt.replays,
         k1_launches=(fwd, bwd), k1_want=(want_fwd, want_bwd),
         profiling_overhead_s=rt.profiling_overhead_s,
         adaptation_overhead_s=rt.adaptation_overhead_s,
         ledger=obs.ledger().scoreboard(),
         overlap=rt.obs_stats()["overlap"],
         engine=eng.stats()["classes"]["policy_swap"])

    # ---- the grad dispatch's peak and time, applied policy vs baseline
    turns = grad_turns(device, tr)
    tl_peak = build_timeline(rt.profile).peak if rt.profile else None
    projected = applied.swap.projected_peak if applied.swap else None
    peak_pol, peak_base = min(turns["policy"]["peak"]), min(
        turns["baseline"]["peak"])
    ms_pol, ms_base = p50(turns["policy"]["ms"]), p50(turns["baseline"]["ms"])
    mem = {"baseline_timeline_peak": tl_peak, "projected_peak": projected,
           "projected_reduction": (tl_peak - projected
                                   if projected and tl_peak else None),
           "realized_peak_policy": peak_pol,
           "realized_peak_baseline": peak_base,
           "realized_reduction": peak_base - peak_pol,
           "reserved_peak_policy": turns["reserved"]["policy"],
           "reserved_peak_baseline": turns["reserved"]["baseline"],
           "grad_ms_policy": turns["policy"]["ms"],
           "grad_ms_baseline": turns["baseline"]["ms"],
           "policy_minus_baseline_ms": ms_pol - ms_base,
           "projected_stall_ms": (applied.swap.stall_time * 1e3
                                  if applied.swap else None),
           "policy_exec": turns["policy_exec"]}
    emit("chameleon_exec_memory", **mem)
    losses_on = list(rep.losses)
    on_ms = {r["step"]: r["step_ms"] for r in stable if not r["eval"]}
    installed = applied.fingerprint
    drop_trainer(tr)
    del tr, rt, eng, applied, turns
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the same trainer with Chameleon off, driven the same way (each
    # train() call draws its first batch afresh)
    off = exec_train(device, cfg, ChameleonConfig(enabled=False))
    alloc = [alloc_retries(device)]
    for _ in range(CHAM_EXEC_STEPS):
        off.train(1)
        alloc.append(alloc_retries(device))
    off_alloc = step_retries(alloc)
    losses_off = list(off.report.losses)
    off_ms = {i: off.report.times[i] * 1e3 for i in on_ms}
    off_grad_ms = {i: off.report.grad_times[i] * 1e3 for i in on_ms}
    drop_trainer(off)
    del off
    gc.collect()
    torch.cuda.empty_cache()

    # ---- P4: each installed policy's projected stall against the copy
    # stall its Stable steps measured
    p4 = {}
    for r in stable:
        if not r["eval"]:
            p4.setdefault(r["policy"], []).append(r)
    p4_rows = p4
    p4 = {pol: p4_policy(rs, [off_ms[r["step"]] for r in rs],
                         [off_grad_ms[r["step"]] for r in rs],
                         [off_alloc[r["step"]] for r in rs],
                         {"policy": mem["reserved_peak_policy"],
                          "baseline": mem["reserved_peak_baseline"]}
                         if pol == installed and (rs[0]["offload"]
                                                  or rs[0]["entries"])
                         else None)
          for pol, rs in p4.items()}
    emit("chameleon_exec_p4", policies=p4)

    problems = []
    if not {"WarmUp", "GenPolicy", "Stable"} <= set(stages):
        problems.append("stages")
    if not any(why == "seq-change" and s % CHAM_EXEC_EVAL_EVERY == 0
               for s, why, _ in transitions):
        problems.append("no seq-change at an eval step")
    if not stable or not all(r["offload"] or r["entries"] for r in stable):
        problems.append("a Stable step's policy swaps nothing")
    if losses_on != losses_off:
        problems.append("losses differ from Chameleon off's")
    if not all(r["d2h_bytes"] == r["h2d_bytes"] > 0 for r in stable):
        problems.append("policy_swap D2H != H2D or 0 in a Stable step")
    if (fwd, bwd) != (want_fwd, want_bwd):
        problems.append("K1 launches")
    if mem["projected_reduction"] is None or (
            mem["realized_reduction"] < 0.5 * mem["projected_reduction"]):
        problems.append("realized peak reduction under half the projected")
    for pol, q in p4.items():
        if not p4_check(q["projected_stall_ms"], q["copy_stall_ms"]):
            problems.append(f"P4: {pol[:40]} projects "
                            f"{q['projected_stall_ms']:.1f} ms, measures "
                            f"{q['copy_stall_ms']:.1f}")
        problems += p4_host_checks(f"P4: {pol[:40]}", p4_rows[pol], q)
    summary = {
        "ok": not problems, "problems": problems, "budget": budget,
        "losses_on": losses_on, "losses_off": losses_off,
        "bit_equal": losses_on == losses_off,
        "stable_step_ms_on": on_ms, "stable_step_ms_off": off_ms,
        "stable_p50_on": p50(list(on_ms.values())),
        "stable_p50_off": p50(list(off_ms.values())),
        "on_over_off": (p50(list(on_ms.values()))
                        / p50(list(off_ms.values())) if on_ms else None),
        "allocated_before": allocated_before,
        "p4": {pol: {k: q.get(k) for k in (
            "projected_stall_ms", "copy_stall_ms", "t_grad_ms", "dt_ms",
            "host_waits", "alloc_retries", "alloc_retries_off",
            "reserved_peak", "reserved_peak_off")}
               for pol, q in p4.items()},
        "k1_launches": (fwd, bwd)}
    emit("chameleon_exec", **summary)
    if problems:
        raise AssertionError(f"chameleon_exec: {problems}")
    return fwd, bwd, budget


def async_bucket(step: int) -> int:
    """The chameleon_async bucket a step trains on."""
    return (step // ASYNC_PERIOD) % 2


def async_run(device, cfg, budget, mode, out_dir=None, steps=ASYNC_STEPS,
              resilience=None, adapt=None, specs=None) -> dict:
    """One run of the chameleon_async phase: the placement ``mode``, or
    Chameleon off (None), on the same batches (the step hook switches the
    bucket every ASYNC_PERIOD steps), ``steps`` steps.  ``out_dir``:
    export the run's Chrome trace, metrics JSONL and audit JSONL there.
    ``resilience`` / ``adapt``: ResilienceConfig / AdaptConfig fields
    (the placement is ``mode``); ``specs``: a fault plan (seed
    1) armed over the run (then the grad dispatch's reserved peaks are not
    probed).  Counts K1's launches over the run alone."""
    import torch
    from repro_torch import faults, obs
    from repro_torch.common.config import (AdaptConfig, ChameleonConfig,
                                           PolicyStoreConfig,
                                           ResilienceConfig)
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.kernels.flash_attention import ops

    for o in (obs.tracer(), obs.ledger(), obs.metrics()):
        o.clear()                        # this run's records only
    buckets = [SyntheticTokens(cfg.vocab_size, seq, TRAIN_BATCH, seed=i)
               for i, seq in enumerate(ASYNC_SEQS)]
    cham = ChameleonConfig(enabled=mode is not None, hbm_budget_bytes=budget,
                           policystore=PolicyStoreConfig(enabled=False),
                           resilience=ResilienceConfig(**(resilience or {})),
                           adapt=AdaptConfig(**(adapt or {})))
    tr = exec_train(device, cfg, cham, eval_every=0, data=buckets[0],
                    adapt_mode=mode)
    rt = tr.rt
    ran, hook_t, installs, machine = [], [], [], ["WarmUp"]
    gcs, gc_t0, allocator, paces = [], [], [], []
    last_disp = {}                       # bucket -> its last grad dispatch
    if rt is not None:                   # the worker's pace between variants
        pipe_run = rt.service.pipeline.run

        def paced(snap, **kw):
            paces.append({"step": snap.step, "t_iter_s": snap.t_iter,
                          "t_price_s": snap.profile.t_iter,
                          "pace_s": kw.get("pace_s", 0.0)})
            return pipe_run(snap, **kw)
        rt.service.pipeline.run = paced

    def on_gc(phase, info):              # the collector's pauses, by step
        if phase == "start":
            gc_t0.append(time.perf_counter())
        elif gc_t0:
            gcs.append({"step": len(hook_t), "gen": info["generation"],
                        "ms": (time.perf_counter() - gc_t0.pop()) * 1e3})

    def hook(step):
        hook_t.append(time.perf_counter())
        if rt is not None:
            d = rt._last_dispatch                # the policy this step ran
            last_disp[async_bucket(step)] = d
            pol = d.applied
            ran.append({"policy": pol.fingerprint[:60],
                        "entries": len(pol.swap.entries) if pol.swap else 0,
                        "projected_stall_s": (pol.swap.stall_time
                                              if pol.swap else 0.0),
                        "exec": (exec_row(d.execution.last)
                                 if d.execution is not None else None),
                        "slab_allocs": rt.hostmem.pool.slab_allocs})
            now = rt.machine.stage.value
            if now == "Stable" and machine[-1] != "Stable":
                installs.append(step)            # installed at this boundary
            machine.append(now)
        if device.type == "cuda":        # the caching allocator's work
            m = torch.cuda.memory_stats(device)
            allocator.append({k: m.get(k) for k in (
                "num_alloc_retries", "num_device_alloc", "num_device_free",
                "reserved_bytes.all.current")})
        if (step + 1) % ASYNC_PERIOD == 0:
            tr.data = buckets[async_bucket(step + 1)]

    paths = ({k: os.path.join(out_dir, f"async.{k}")
              for k in ("trace.json", "metrics.jsonl", "audit.jsonl")}
             if out_dir else None)
    if paths:
        obs.audit().attach_file(paths["audit.jsonl"])
    torch.cuda.synchronize()
    ops.flash_attention.launches = 0             # count the main path only
    ops.flash_attention_bwd.launches = 0
    retries0 = alloc_retries(device)
    gc.callbacks.append(on_gc)
    plan = faults.arm(faults.FaultPlan(specs, seed=1)) if specs else None
    try:
        rep = tr.train(steps, fault_hook=hook)
    finally:
        gc.callbacks.remove(on_gc)
        if plan is not None:
            faults.disarm()
        if paths:
            obs.audit().detach_file()
    k1 = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    if paths:
        obs.metrics().write_jsonl(paths["metrics.jsonl"])
        counters = {"overlap_efficiency": [
            (h["t"], h["efficiency"]) for h in rt.overlap_history
            if h["efficiency"] is not None]}
        counters.update(obs.ledger().counter_tracks())
        obs.export_chrome_trace(paths["trace.json"], obs.tracer(),
                                counters=counters,
                                meta={"phase": "chameleon_async"})
    out = {"mode": mode or "off", "losses": list(rep.losses),
           "wall_s": list(rep.wall_times), "step_s": list(rep.times),
           "grad_s": list(rep.grad_times), "stages": list(rep.stages),
           "gc": [g for g in gcs if g["gen"] == 2 or g["ms"] > 5],
           "allocator": allocator, "alloc_retries0": retries0,
           "k1_launches": k1, "ran": ran, "installs": installs,
           "hook_t": hook_t, "paths": paths}
    if rt is not None:
        # the worker's and the inline search's spans: ms per job and per
        # variant (its host work, which contends with the training thread)
        adapt_ms = {}
        for sp in obs.tracer().records():
            if sp["lane"] == obs.LANE_ADAPT and sp["kind"] == "span":
                adapt_ms.setdefault(sp["name"], []).append(
                    (sp["t1"] - sp["t0"]) * 1e3)
        out.update(replays=rt.replays, adapt=rep.adapt, adapt_ms=adapt_ms,
                   paces=paces,
                   adaptations=list(rt.adaptations),
                   genpolicy_steps=rep.genpolicy_steps,
                   transitions=[tuple(t) for t in rt.machine.transitions],
                   adaptation_overhead_s=rt.adaptation_overhead_s,
                   ledger=obs.ledger().scoreboard())
        # each bucket's last policy against the baseline: the grad
        # dispatch's reserved peak (P4's remainder, module doc)
        if plan is None:
            out["reserved"] = bucket_reserved(device, tr, buckets,
                                              last_disp)
        else:
            out["fired"] = plan.stats()["fired"]
    last_disp.clear()                    # its dispatches hold the trainer
    drop_trainer(tr)
    del tr, rt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def bucket_reserved(device, tr, buckets, last_disp) -> dict:
    """Per bucket whose last step ran a policy that moves bytes: the grad
    dispatch's reserved peak under it and under the baseline on the
    bucket's first batch (``reserved_probe``), with its fingerprint."""
    rt, out = tr.rt, {}
    if device.type != "cuda":
        return out
    for b, d in last_disp.items():
        if d.execution is None:
            continue
        args = (tr.model, tr._device_batch(buckets[b].batch_at(0)),
                tr.loss_scale.scale)
        out[b] = dict(reserved_probe(device, {
            "policy": d, "baseline": rt._get_step(rt.executor.baseline())},
            args), fingerprint=d.applied.fingerprint[:60])
    return out


def async_steps(run: dict) -> list:
    """Per step of an async run: the allocator's retries and the pinned
    slabs the host tier allocated."""
    alloc = run["allocator"]
    if not alloc:                        # not on a card
        return [{} for _ in run["step_s"]]
    per = step_retries([run["alloc_retries0"]] + [
        a["num_alloc_retries"] or 0 for a in alloc])
    slabs = [0] + [r["slab_allocs"] for r in run.get("ran", [])]
    for i, row in enumerate(per):
        row["slab_allocs"] = (slabs[i + 1] - slabs[i] if i + 1 < len(slabs)
                              else 0)
    return per


def async_window(run: dict, off: dict) -> dict:
    """The guard window's readings of one placement: each step against
    its own bucket's Stable median, the ADAPTING steps' p50 against it,
    the first-visit spikes, kickoff-to-install latency, and (P4) each
    bucket's installed policy: its projected stall beside the copy stall
    its Stable steps measured, its host waits and allocator readings
    against off's (``p4_policy``, ``p4_host_checks``)."""
    wall, stages = run["wall_s"], run["stages"]
    window = range(ASYNC_SKIP, ASYNC_STEPS)
    med, adapting, p4 = {}, {}, {}
    on_alloc, off_alloc = async_steps(run), async_steps(off)
    problems = []
    for b in (0, 1):
        steps = [i for i in window if async_bucket(i) == b]
        stable = [i for i in steps if stages[i] == "Stable"]
        med[b] = p50([wall[i] for i in stable or steps])
        ad = [wall[i] for i in steps if stages[i] == "Adapting"]
        adapting[b] = {"p50_ms": p50(ad) * 1e3 if ad else None,
                       "over_stable": p50(ad) / med[b] if ad else None}
        last = run["ran"][steps[-1]]
        inst = [i for i in (stable or steps)
                if run["ran"][i]["policy"] == last["policy"]] or steps[-1:]
        rows = [dict(on_alloc[i], step_ms=run["step_s"][i] * 1e3,
                     t_grad_ms=run["grad_s"][i] * 1e3,
                     projected_stall_s=run["ran"][i]["projected_stall_s"],
                     exec=run["ran"][i]["exec"]) for i in inst]
        res = run.get("reserved", {}).get(b)
        if res is not None and res["fingerprint"] != last["policy"]:
            res = None
        q = p4[ASYNC_SEQS[b]] = dict(
            p4_policy(rows, [off["step_s"][i] * 1e3 for i in inst],
                      [off["grad_s"][i] * 1e3 for i in inst],
                      [off_alloc[i] for i in inst], res),
            policy=last["policy"], entries=last["entries"],
            wall_on_minus_off_ms=(med[b] - p50(
                [off["wall_s"][i] for i in stable or steps])) * 1e3)
        problems += p4_host_checks(
            f"{run['mode']} at {ASYNC_SEQS[b]}",
            [{"exec": run["ran"][i]["exec"]} for i in stable], q)
    ratios = {i: wall[i] / med[async_bucket(i)] for i in window}
    worst = max(ratios, key=ratios.get)
    spikes = {}
    for v in range(ASYNC_SKIP // ASYNC_PERIOD):
        vis = range(v * ASYNC_PERIOD, (v + 1) * ASYNC_PERIOD)
        i = max(vis, key=lambda j: wall[j])
        spikes[ASYNC_SEQS[async_bucket(i)]] = {
            "step": i, "stage": stages[i], "ms": wall[i] * 1e3,
            "over_stable": wall[i] / med[async_bucket(i)]}
    latency = []
    for v in range(ASYNC_STEPS // ASYNC_PERIOD):
        vis = range(v * ASYNC_PERIOD, (v + 1) * ASYNC_PERIOD)
        kick = next((i for i in vis if stages[i] in ("Adapting",
                                                     "GenPolicy")), None)
        inst = next((i for i in run["installs"] if i in vis), None)
        if kick is not None and inst is not None:
            latency.append({"visit": v, "kickoff": kick, "install": inst,
                            "steps": inst - kick,
                            "s": run["hook_t"][inst] - run["hook_t"][kick]})
    return {"stable_ms": {ASYNC_SEQS[b]: m * 1e3 for b, m in med.items()},
            "worst": {"step": worst, "stage": stages[worst],
                      "ms": wall[worst] * 1e3, "ratio": ratios[worst]},
            "adapting": {ASYNC_SEQS[b]: a for b, a in adapting.items()},
            "first_visit": spikes, "latency": latency, "p4": p4,
            "problems": problems}


def async_artifacts(run: dict) -> dict:
    """The async run's trace, metrics and audit through the port's
    validators and post-mortem report: the trace's lanes, the metrics'
    providers, and at least one iteration scored against a projected
    peak (the peak error is printed, not gated)."""
    from repro_torch import obs
    from repro_torch.obs import report
    p = run["paths"]
    with open(p["trace.json"]) as f:
        tsum = obs.validate_chrome_trace(json.load(f),
                                         require_lanes=ASYNC_LANES)
    msum = obs.validate_metrics_jsonl(p["metrics.jsonl"],
                                      require_providers=("memory",
                                                         "runtime"))
    out_json = os.path.join(os.path.dirname(p["trace.json"]), "report.json")
    rc = report.main(["--trace", p["trace.json"],
                      "--metrics", p["metrics.jsonl"],
                      "--audit", p["audit.jsonl"],
                      "--out", out_json[:-4] + "md", "--json", out_json])
    with open(out_json) as f:
        rj = json.load(f)
    mem = rj["memory"] or {}
    return {"report_rc": rc, "span_lanes": tsum["span_lanes"],
            "counters": tsum["counters"], "snapshots": msum["snapshots"],
            "scored": (mem.get("scoreboard") or {}).get("n", 0),
            "max_abs_peak_error": mem.get("max_abs_peak_error"),
            "adaptation_events": (rj["audit"] or {}).get("adaptation")}


def phase_chameleon_async(device) -> dict:
    """Adaptation off the training thread (``repro_torch.adapt``) on the
    train phase's model: the lowest budget a policy meets for the longer
    bucket (+ CHAM_EXEC_MARGIN), then ASYNC_STEPS steps under each of
    ASYNC_MODES and with Chameleon off, on the same batches.  Every check
    raises.  Returns K1's launches in the async run (forward, backward)."""
    import shutil
    import tempfile
    import torch
    import repro_torch.configs as C
    from repro_torch import obs

    for name in ("runtime", "hostmem"):      # earlier phases' trainers
        obs.metrics().unregister_provider(name)
    release_device_memory(device)
    cfg = C.get_config("llama2-paper").replace(num_layers=TRAIN_LAYERS,
                                               attn_impl="flash")
    budget, brow = exec_budget(device, cfg, seq=ASYNC_SEQS[1],
                               phase="chameleon_async")
    emit("chameleon_async_budget", seq=ASYNC_SEQS[1], **brow)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_async_")
    try:
        runs = {m: async_run(device, cfg, budget, m,
                             out_dir if m == "async" else None)
                for m in ASYNC_MODES}
        off = async_run(device, cfg, budget, None)
        arts = async_artifacts(runs["async"])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    problems, rows = [], {}
    for m, r in runs.items():
        w = async_window(r, off)
        ad = r["adapt"]
        rows[m] = dict(w, stages=r["stages"],
                       wall_ms=[t * 1e3 for t in r["wall_s"]],
                       step_ms=[t * 1e3 for t in r["step_s"]], gc=r["gc"],
                       allocator=r["allocator"],
                       replays=r["replays"], adapt=ad,
                       adaptations=r["adaptations"],
                       genpolicy_steps=r["genpolicy_steps"],
                       transitions=r["transitions"], ran=r["ran"],
                       k1_launches=r["k1_launches"], ledger=r["ledger"],
                       adapt_ms=r["adapt_ms"], paces=r["paces"],
                       adaptation_overhead_s=r["adaptation_overhead_s"])
        emit("chameleon_async_run", mode=m, **rows[m])
        if ad["failed"] or ad["watchdog_fired"]:
            problems.append(f"{m}: failed / watchdog")
        for v in range(1, ASYNC_STEPS // ASYNC_PERIOD):
            lo, hi = v * ASYNC_PERIOD, (v + 1) * ASYNC_PERIOD
            if not any(lo <= a["trigger_step"] < hi and a["end_step"] < hi
                       and a["tier"] != "timeout" for a in r["adaptations"]):
                problems.append(f"{m}: visit {v} ends in no install")
        if r["losses"] != off["losses"]:
            problems.append(f"{m}: losses differ from Chameleon off's")
        for seq, q in rows[m]["p4"].items():
            if not p4_check(q["projected_stall_ms"], q["copy_stall_ms"]):
                problems.append(
                    f"{m}: P4 at {seq} projects "
                    f"{q['projected_stall_ms']:.1f} ms, measures "
                    f"{q['copy_stall_ms']:.1f}")
        problems += rows[m]["problems"]
        want = (ASYNC_STEPS + r["replays"]) * TRAIN_LAYERS
        if r["k1_launches"] != (want, want):
            problems.append(f"{m}: K1 launches {r['k1_launches']} != {want}")
    if rows["async"]["worst"]["ratio"] > ASYNC_RATIO:
        problems.append("async: worst step over 1.5x its bucket's Stable")
    if rows["inline"]["worst"]["ratio"] <= ASYNC_RATIO:
        problems.append("inline: worst step within 1.5x (no stall shown)")
    sp = runs["speculative"]
    if sp["adapt"]["speculative_hits"] < 1 or sp["genpolicy_steps"] != 0:
        problems.append("speculative: no hit, or GenPolicy steps")
    if arts["report_rc"] != 0 or arts["scored"] < 1:
        problems.append("async artifacts: report failed or nothing scored")
    summary = {
        "ok": not problems, "problems": problems, "budget": budget,
        "worst_ratio": {m: r["worst"]["ratio"] for m, r in rows.items()},
        "stable_ms": {m: r["stable_ms"] for m, r in rows.items()},
        "off_stable_ms": {ASYNC_SEQS[b]: p50([
            off["wall_s"][i] for i in range(ASYNC_SKIP, ASYNC_STEPS)
            if async_bucket(i) == b]) * 1e3 for b in (0, 1)},
        "latency": {m: r["latency"] for m, r in rows.items()},
        "adapting": {m: r["adapting"] for m, r in rows.items()},
        "first_visit": {m: r["first_visit"] for m, r in rows.items()},
        "p4": {m: r["p4"] for m, r in rows.items()},
        "replays": {m: r["replays"] for m, r in rows.items()},
        "speculative_hits": sp["adapt"]["speculative_hits"],
        "genpolicy_steps": {m: r["genpolicy_steps"] for m, r in rows.items()},
        "bit_equal": {m: r["losses"] == off["losses"]
                      for m, r in runs.items()},
        "k1_launches": {m: r["k1_launches"] for m, r in runs.items()},
        "artifacts": arts}
    emit("chameleon_async", **summary)
    if problems:
        raise AssertionError(f"chameleon_async: {problems}")
    return runs["async"]["k1_launches"], {"budget": budget, "off": off}


def policy_entries(rt) -> int:
    """The entries of the policy the runtime's last grad dispatch ran (a
    function, so that no caller keeps the execution, which holds the
    trainer, past its run)."""
    ex = rt._last_dispatch.execution
    swap = ex.applied.swap if ex is not None else None
    return len(swap.entries) if swap else 0


def terminal_swap_ins(tr, step: int) -> dict:
    """Make every swap-in the trainer submits in ``step`` fail for good
    after its swap-out has staged: the engine's ``submit_swap_in`` is
    wrapped to arm, for that call alone, a plan that drops the copy
    (``transfer_drop`` at 1.0; the fault plan has no direction filter, as
    the reference's has none, so the swap-outs are left out by arming
    around the swap-ins only).  ``fence`` must then serve each through the
    synchronous fallback (P9).  Returns the record it fills (the plan, the
    swap-ins submitted in the step)."""
    from repro_torch import faults
    eng = tr.rt.hostmem.engine
    inner = eng.submit_swap_in
    rec = {"step": step, "swap_ins": 0, "plan": faults.FaultPlan(
        [faults.FaultSpec("engine.transfer_drop", prob=1.0)], seed=1)}

    def submit_swap_in(*a, **k):
        if tr.step != step:
            return inner(*a, **k)
        rec["swap_ins"] += 1
        faults.arm(rec["plan"]).set_iteration(step)
        try:
            return inner(*a, **k)
        finally:
            faults.disarm()
    eng.submit_swap_in = submit_swap_in
    return rec


def chaos_run(device, cfg, budget, steps, specs=None, resilience=None,
              terminal_at=None) -> dict:
    """One run of the chaos phase: the chameleon_exec phase's trainer at
    ``budget`` with no eval and CHAOS_RESILIENCE (updated by
    ``resilience``), ``steps`` steps of one ``train(1)`` each (as the twin
    is driven), under a fault plan of ``specs`` (seed 1, the reference
    test's) when given, and with every swap-in of step ``terminal_at``
    failing for good (``terminal_swap_ins``) when given.  Returns what
    chaos_bench's ``_train`` reads, and besides per step the ladder's rung,
    the health classes, the engine's fallback, timeout and retry counts,
    the policy's entries and the allocator's peak; K1's launches, the
    engine's health and its bandwidth curve."""
    import torch
    from repro_torch import faults, obs
    from repro_torch.common.config import ChameleonConfig, ResilienceConfig
    from repro_torch.faults.health import MEM_CLASS
    from repro_torch.kernels.flash_attention import ops

    cham = ChameleonConfig(enabled=True, hbm_budget_bytes=budget,
                           resilience=ResilienceConfig(
                               **{**CHAOS_RESILIENCE, **(resilience or {})}))
    obs.ledger().clear()
    tr = exec_train(device, cfg, cham, eval_every=0)
    rt = tr.rt
    eng, lad = rt.hostmem.engine, rt.ladder
    plan = faults.FaultPlan(specs, seed=1) if specs else None
    terminal = (terminal_swap_ins(tr, terminal_at)
                if terminal_at is not None else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    ops.flash_attention.launches = 0
    ops.flash_attention_bwd.launches = 0
    per_step, peak = [], 0
    if plan is not None:
        faults.arm(plan)
    try:
        for _ in range(steps):
            torch.cuda.reset_peak_memory_stats(device)
            tr.train(1)
            per_step.append({"rung": lad.name, "worst": eng.health.worst(),
                             "memory": eng.health.state(MEM_CLASS),
                             "sync_fallback_in": eng.n_sync_fallback_in,
                             "hbm_fallback_in": eng.n_hbm_fallback_in,
                             "timeouts": eng.n_timeouts,
                             "retries": eng.n_retries,
                             "entries": policy_entries(rt),
                             "peak": torch.cuda.max_memory_allocated(device)})
            peak = max(peak, per_step[-1]["peak"])
    finally:
        if plan is not None:
            faults.disarm()
    torch.cuda.synchronize()
    rep = tr.report
    eng.pool.check()
    if terminal is not None:
        plan = terminal.pop("plan")
    out = {
        "steps": steps, "stages": rep.stages, "losses": list(rep.losses),
        "wall_ms": [t * 1e3 for t in rep.wall_times],
        "failures": list(rep.failures), "per_step": per_step,
        "fired": plan.total_fired() if plan is not None else 0,
        "fired_by_site": plan.stats()["fired"] if plan is not None else {},
        "retries": eng.n_retries, "failed_out": eng.n_failed_out,
        "hbm_fallback_in": eng.n_hbm_fallback_in,
        "sync_fallback_in": eng.n_sync_fallback_in,
        "timeouts": eng.n_timeouts,
        "transitions": [(t["step"], t["to"], t["why"])
                        for t in lad.transitions],
        "descents": lad.n_descents, "ascents": lad.n_ascents,
        "rung": lad.name, "worst_health": eng.health.worst(),
        "health": eng.health.stats(), "live_blocks": eng.pool.live_blocks,
        "peak": peak, "terminal": terminal,
        "k1": (ops.flash_attention.launches,
               ops.flash_attention_bwd.launches),
        "replays": rt.replays,
        "policy_swap": eng.by_class["policy_swap"].as_dict(),
        "ledger": obs.ledger().scoreboard(),
        "bw_curve": rt.hostmem.bwmodel.curve()}
    drop_trainer(tr)
    del tr, rt, eng, lad
    gc.collect()
    torch.cuda.empty_cache()
    return out


def chaos_compare(name: str, twin: dict, run: dict, ladder: bool) -> list:
    """Print one chaos run's line beside its twin and return its problems,
    the assertions of the reference's ``_compare``
    (benchmarks/chaos_bench.py): no crash, the plan fired, every loss
    equal to the twin's, no live slab, the median step within
    CHAOS_INFLATION_CAP of the twin's over the same steps; besides, the
    allocator's peak within CHAM_PEAK_TOL of the twin's (P10); with ``ladder``
    also retries, a descent, an ascent and a healthy end."""
    import statistics
    n = run["steps"]
    n_diff = sum(a != b for a, b in zip(twin["losses"][:n], run["losses"]))
    ratio = (statistics.median(run["wall_ms"])
             / statistics.median(twin["wall_ms"][:n]))
    problems = []
    if run["failures"]:
        problems.append(f"{name}: crashed {run['failures']}")
    if run["fired"] <= 0:
        problems.append(f"{name}: the plan never fired")
    if n_diff or len(run["losses"]) != n:
        problems.append(f"{name}: {n_diff} losses differ from the twin's")
    if run["live_blocks"]:
        problems.append(f"{name}: {run['live_blocks']} live slabs")
    if ratio > CHAOS_INFLATION_CAP:
        problems.append(f"{name}: median step {ratio:.2f}x the twin's")
    if run["peak"] > twin["peak"] * (1 + CHAM_PEAK_TOL):
        problems.append(f"{name}: allocator peak {run['peak']} over the "
                        f"twin's {twin['peak']} by more than CHAM_PEAK_TOL")
    if ladder and (run["retries"] <= 0 or run["descents"] < 1
                   or run["ascents"] < 1
                   or run["worst_health"] != "healthy"):
        problems.append(f"{name}: no retry, descent or ascent, or health "
                        f"{run['worst_health']} at the end")
    emit("chaos_run", scenario=name, ok=not problems, problems=problems,
         n_diff=n_diff, step_ratio=ratio, twin_peak=twin["peak"],
         peak_over_twin=run["peak"] - twin["peak"],
         **{k: v for k, v in run.items() if k != "losses"})
    return problems


def chaos_cli(device) -> dict:
    """The train CLI's drill (CHAOS_CLI_ARGS with a policy store, a
    checkpoint directory, CHAOS_CLI_PLAN and an audit file): CHAOS_CLI_STEPS
    steps, then CHAOS_CLI_RESUME_STEPS more with ``--resume``; both must
    exit normally and print the plan's fired count, faults must fire, and
    the second run must start from the first's newest checkpoint."""
    import contextlib
    import io
    import shutil
    import tempfile
    from repro_torch import obs
    from repro_torch.launch import train

    d = tempfile.mkdtemp(prefix="chip_smoke_chaos_cli_")
    plan, audit = os.path.join(d, "plan.json"), os.path.join(d, "audit.jsonl")
    with open(plan, "w") as f:
        json.dump(CHAOS_CLI_PLAN, f)
    common = CHAOS_CLI_ARGS + [
        "--device", str(device), "--policy-store-dir",
        os.path.join(d, "store"), "--ckpt-dir", os.path.join(d, "ckpt"),
        "--fault-plan", plan, "--audit-out", audit]
    runs = []
    try:
        for extra in (["--steps", str(CHAOS_CLI_STEPS)],
                      ["--steps", str(CHAOS_CLI_RESUME_STEPS), "--resume"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                stats = train.main(common + extra)
            for name in ("runtime", "hostmem", "memory"):
                obs.metrics().unregister_provider(name)
            text = buf.getvalue()
            sys.stdout.write(text)
            runs.append({
                "args": extra, "steps": stats["steps"],
                "fault_fired": stats["fault_fired"],
                "printed": [ln for ln in text.splitlines()
                            if ln.startswith(("fault plan:", "ladder:",
                                              "policystore:", "done:"))],
                "checkpoints": [os.path.basename(p)
                                for p in stats["checkpoints"]],
                "losses": stats["losses"], "stages": stats["stages"],
                "store": stats["policystore"]["store"],
                "ladder": stats["ladder"]})
        with open(audit) as f:
            kinds = collections.Counter(json.loads(ln)["kind"] for ln in f)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    first, second = runs
    resumed_from = int(first["checkpoints"][-1].split("_")[1])
    problems = []
    for r in runs:
        if r["fault_fired"] <= 0 or not any(
                ln == f"fault plan: fired={r['fault_fired']}"
                for ln in r["printed"]):
            problems.append(f"cli {r['args']}: no fault fired or printed")
        if not all(math.isfinite(x) for x in r["losses"]):
            problems.append(f"cli {r['args']}: a loss is not finite")
    if second["steps"] != resumed_from + CHAOS_CLI_RESUME_STEPS:
        problems.append(f"cli: resumed run ends at {second['steps']}, not "
                        f"{resumed_from} + {CHAOS_CLI_RESUME_STEPS}")
    out = {"ok": not problems, "problems": problems, "runs": runs,
           "resumed_from": resumed_from, "audit": dict(kinds)}
    emit("chaos_cli", **out)
    return out


def chaos_fallbacks(device) -> dict:
    """The engine's two terminal-failure paths on the card, on a fresh
    engine with ``max_retries`` 1 and a CHAOS_FALLBACK_BYTES payload (the
    reference tests of them, tests/test_faults.py): a swap-out that fails
    for good keeps its source on the device and its swap-in returns that
    tensor; a swap-in whose copy is dropped every time is served by the
    synchronous fallback, reached through ``fence`` (P9) and read on the
    current stream.  Both bit for bit, and every slab released once."""
    import torch
    from repro_torch import faults
    from repro_torch.common.config import ResilienceConfig
    from repro_torch.hostmem import PinnedSlabPool, TransferEngine

    eng = TransferEngine(PinnedSlabPool(pinned=device.type == "cuda"),
                         device=device,
                         resilience=ResilienceConfig(max_retries=1))
    x = torch.randn(CHAOS_FALLBACK_BYTES // 4, device=device)
    want = x.clone()
    with faults.injected(faults.FaultPlan([faults.FaultSpec(
            "engine.transfer_error", prob=1.0)])):
        out = eng.wait(eng.submit_swap_out(x, "chaos/retained"))
        back = eng.submit_swap_in(out, "chaos/retained")
    retained = (out.failed and back.result is x
                and torch.equal(back.result, want))
    staged = eng.wait(eng.submit_swap_out(x, "chaos/sync"))
    with faults.injected(faults.FaultPlan([faults.FaultSpec(
            "engine.transfer_drop", prob=1.0)])):
        ev = eng.submit_swap_in(staged, "chaos/sync")
        eng.fence(ev)
        got = ev.result * 1.0          # read on the current stream
    torch.cuda.synchronize(device)
    eng.pool.check()
    row = {"retained_bit_equal": retained,
           "sync_fallback_bit_equal": bool(torch.equal(got, want)),
           "failed_out": eng.n_failed_out,
           "hbm_fallback_in": eng.n_hbm_fallback_in,
           "sync_fallback_in": eng.n_sync_fallback_in,
           "retries": eng.n_retries, "live_blocks": eng.pool.live_blocks,
           "nbytes": CHAOS_FALLBACK_BYTES}
    row["ok"] = (retained and row["sync_fallback_bit_equal"]
                 and (row["failed_out"], row["hbm_fallback_in"],
                      row["sync_fallback_in"], row["live_blocks"])
                 == (1, 1, 1, 0))
    emit("chaos_fallbacks", **row)
    return row


def terminal_checks(run: dict, twin: dict) -> tuple:
    """swap_in_terminal's row and problems: its terminal step is a Stable
    one with a policy of entries, completes, and serves every swap-in it
    submitted through the synchronous fallback, none from a retained
    source; that step's ms and allocator peak beside the twin's.  The
    swap-ins are counted, not the entries: a transfer may carry several
    entries' storages staged back to back (3-4 swap-ins for 4-5 entries on
    an NVIDIA H100 80GB HBM3), and on the CPU the non-entry storages of an
    offloaded site are staged too."""
    t, ps = run["terminal"], run["per_step"]
    k = t["step"]

    def delta(key):
        return ps[k][key] - (ps[k - 1][key] if k else 0)
    row = {"step": k, "stage": run["stages"][k], "swap_ins": t["swap_ins"],
           "entries": ps[k]["entries"],
           "sync_fallback_in": delta("sync_fallback_in"),
           "hbm_fallback_in": delta("hbm_fallback_in"),
           "retries": delta("retries"),
           "step_ms": run["wall_ms"][k], "twin_step_ms": twin["wall_ms"][k],
           "peak": ps[k]["peak"], "twin_peak": twin["per_step"][k]["peak"],
           "transitions": run["transitions"]}
    problems = []
    if row["stage"] != "Stable":
        problems.append(f"swap_in_terminal: step {k} is {row['stage']}")
    if not (row["sync_fallback_in"] == row["swap_ins"] >= 1
            and row["entries"] >= 1) or row["hbm_fallback_in"]:
        problems.append(f"swap_in_terminal: {row['sync_fallback_in']} "
                        f"synchronous fallbacks for {row['swap_ins']} "
                        f"swap-ins and {row['entries']} entries, "
                        f"{row['hbm_fallback_in']} from retained sources")
    return row, problems


def timeout_checks(run: dict) -> tuple:
    """copy_timeout's row and problems: stalls (CHAOS_STALL_S, twice the
    health monitor's timeout floor) fired on copies and counted as
    timeouts, each timeout a stalled copy; the run ends on a healthy full
    rung.  Not every stall is a timeout: a copy's limit is the larger of
    the floor and ``timeout_factor`` times the bandwidth model's
    prediction, and the model's curve takes in each stalled copy's time,
    as the reference's does (tests/test_torch_faults.py holds the counts
    and the ladder's moves to the reference's engine and ladder)."""
    stalls = run["fired_by_site"].get("engine.transfer_stall", 0)
    row = {"stalls": stalls, "timeouts": run["timeouts"],
           "descents": run["descents"], "ascents": run["ascents"],
           "transitions": run["transitions"], "rung": run["rung"],
           "worst_health": run["worst_health"],
           "per_step_timeouts": [p["timeouts"] for p in run["per_step"]],
           "per_step_health": [p["worst"] for p in run["per_step"]]}
    problems = []
    if not 0 < run["timeouts"] <= stalls:
        problems.append(f"copy_timeout: {run['timeouts']} timeouts for "
                        f"{stalls} stalls")
    if run["rung"] != "full" or run["worst_health"] != "healthy":
        problems.append(f"copy_timeout: ladder {run['transitions']}, "
                        f"health {run['worst_health']} at the end")
    return row, problems


def adapt_hang(device, cfg, ctx: dict) -> tuple:
    """chameleon_async's drift run (async, HANG_STEPS steps, its budget)
    with the first adaptation job hung for HANG_S, past the watchdog's
    HANG_TIMEOUT_S (``adapt_timeout_s``, set through the ResilienceConfig
    the reference has too), and the worker's pacing off (``pace_s``, the
    AdaptConfig's): a paced job at 3072 takes 1.0-1.7 s on an NVIDIA H100
    80GB HBM3 since P11, past that watchdog, which must time the hang
    alone.  As
    tests/test_faults.py requires of the
    reference: the watchdog fires once, the hung job's late result never
    installs, and the run goes on: the next visit installs; no job fails;
    losses equal Chameleon off's on the same batches.  Returns (row,
    problems)."""
    from repro_torch.faults import FaultSpec
    off = ctx["off"]
    run = async_run(device, cfg, ctx["budget"], "async", steps=HANG_STEPS,
                    resilience={"adapt_timeout_s": HANG_TIMEOUT_S},
                    adapt={"pace_s": 0.0},
                    specs=[FaultSpec("adapt.hang", prob=1.0, seconds=HANG_S,
                                     max_fires=1)])
    wall = run["wall_s"]
    med = {b: p50([off["wall_s"][i] for i in range(HANG_STEPS)
                   if async_bucket(i) == b]) for b in (0, 1)}
    ratios = [w / med[async_bucket(i)] for i, w in enumerate(wall)]
    worst = max(range(len(ratios)), key=ratios.__getitem__)
    ad = run["adapt"]
    row = {"fired": run["fired"], "watchdog_fired": ad["watchdog_fired"],
           "failed": ad["failed"], "discarded": ad["discarded"],
           "installs": run["installs"], "transitions": run["transitions"],
           "adaptations": [(a["trigger_step"], a["end_step"], a["tier"])
                           for a in run["adaptations"]],
           "stages": run["stages"], "wall_ms": [w * 1e3 for w in wall],
           "worst": {"step": worst, "stage": run["stages"][worst],
                     "ms": wall[worst] * 1e3, "ratio_over_off": ratios[worst]},
           "k1_launches": run["k1_launches"], "replays": run["replays"]}
    problems = []
    if run["fired"].get("adapt.hang") != 1 or ad["watchdog_fired"] != 1:
        problems.append(f"adapt_hang: hang fired {run['fired']}, watchdog "
                        f"{ad['watchdog_fired']}")
    if not any(why == "adapt-timeout" for _, why, _s in
               run["transitions"]):
        problems.append("adapt_hang: no adapt-timeout transition")
    if ad["failed"] or not any(
            ASYNC_PERIOD <= a["trigger_step"] and a["tier"] != "timeout"
            for a in run["adaptations"]):
        problems.append(f"adapt_hang: a failed job, or no install after "
                        f"the timeout: {row['adaptations']}")
    if run["losses"] != off["losses"][:HANG_STEPS]:
        problems.append("adapt_hang: losses differ from Chameleon off's")
    want = (HANG_STEPS + run["replays"]) * TRAIN_LAYERS
    if run["k1_launches"] != (want, want):
        problems.append(f"adapt_hang: K1 launches {run['k1_launches']} != "
                        f"{want}")
    return row, problems


def phase_chaos(device, budget: int, hang_ctx: dict) -> tuple:
    """The robustness drill on the card (phase 18c of the module doc) at
    the chameleon_exec phase's ``budget``; its adapt_hang run on the
    chameleon_async phase's drift run (``hang_ctx``: its budget and its
    Chameleon-off run).  Every check raises.  Returns K1's launches in the
    engine_window run (forward, backward) and in the 12d runs."""
    import torch
    import repro_torch.configs as C
    from repro_torch import obs
    from repro_torch.faults import FaultSpec

    t0 = time.perf_counter()
    for name in ("runtime", "hostmem"):      # earlier phases' trainers
        obs.metrics().unregister_provider(name)
    release_device_memory(device)
    cfg = C.get_config("llama2-paper").replace(num_layers=TRAIN_LAYERS,
                                               attn_impl="flash")
    twin = chaos_run(device, cfg, budget, CHAOS_STEPS)
    # the ladder holds still and every class (memory too) stays healthy
    clean = not twin["transitions"] and all(
        s["worst"] == "healthy" for s in twin["per_step"])
    emit("chaos_twin", budget=budget, clean=clean, **twin)
    problems = [] if clean else ["twin: a ladder move or an unhealthy "
                                 "class without faults"]
    start = twin["stages"].index("Stable") + CHAOS_LEAD
    win = {"start": start, "stop": start + CHAOS_WINDOW}
    scenarios = {
        "engine_window": (CHAOS_STEPS, [FaultSpec(
            "engine.transfer_error", prob=1.0, **win)], True),
        "drop_and_stall": (CHAOS_DROP_STEPS, [
            FaultSpec("engine.transfer_drop", prob=0.3, **win),
            FaultSpec("engine.transfer_stall", prob=0.2, seconds=0.002,
                      **win)], False)}
    runs = {}
    if not chaos_fallbacks(device)["ok"]:
        problems.append("fallbacks: a terminal-failure path on the card")
    for name, (steps, specs, ladder) in scenarios.items():
        runs[name] = chaos_run(device, cfg, budget, steps, specs)
        problems += chaos_compare(name, twin, runs[name], ladder)
    ew = runs["engine_window"]
    want = (CHAOS_STEPS + ew["replays"]) * TRAIN_LAYERS
    if ew["k1"] != (want, want):
        problems.append(f"engine_window: K1 launches {ew['k1']} != {want}")
    cli = chaos_cli(device)
    problems += cli["problems"]
    # 12d: every swap-in of one Stable step failing for good, copies
    # stalled past the timeout floor, a hung adaptation job
    t1 = time.perf_counter()
    runs["swap_in_terminal"] = chaos_run(
        device, cfg, budget, CHAOS_TERMINAL_STEPS,
        resilience={"max_retries": 1}, terminal_at=start)
    problems += chaos_compare("swap_in_terminal", twin,
                              runs["swap_in_terminal"], False)
    terminal, more = terminal_checks(runs["swap_in_terminal"], twin)
    problems += more
    runs["copy_timeout"] = chaos_run(
        device, cfg, budget, CHAOS_TIMEOUT_STEPS, [FaultSpec(
            "engine.transfer_stall", prob=0.3, seconds=CHAOS_STALL_S,
            start=start, stop=start + CHAOS_TIMEOUT_WINDOW)])
    problems += chaos_compare("copy_timeout", twin, runs["copy_timeout"],
                              False)
    timeouts, more = timeout_checks(runs["copy_timeout"])
    problems += more
    hang, more = adapt_hang(device, cfg, hang_ctx)
    problems += more
    emit("chaos_12d", swap_in_terminal=terminal, copy_timeout=timeouts,
         adapt_hang=hang, seconds=time.perf_counter() - t1)
    summary = {
        "ok": not problems, "problems": problems, "budget": budget,
        "window": win,
        **{f"{k}_{name}": runs[name][k] for name in runs
           for k in ("fired", "retries", "transitions")},
        "k1_launches": ew["k1"], "k1_want": (want, want),
        "cli_resumed_from": cli["resumed_from"],
        "seconds": time.perf_counter() - t0}
    emit("chaos", **summary)
    if problems:
        raise AssertionError(f"chaos: {problems}")
    gc.collect()
    torch.cuda.empty_cache()
    return ew["k1"], {
        "swap_in_terminal": runs["swap_in_terminal"]["k1"],
        "copy_timeout": runs["copy_timeout"]["k1"],
        "adapt_hang": hang["k1_launches"]}


@contextlib.contextmanager
def timed_checkpoints():
    """Time the checkpoint path on the training thread while the block
    runs: convert's ``_numpy`` (bf16 widened on the device, a pageable
    ``.cpu()``), the whole reference-layout conversion (``_numpy`` and the
    host's ``np.stack``), ``CheckpointManager.save`` with its ``_stage``
    (the submit to the host tier's checkpoint class) and its ``wait`` for
    the previous write.  Yields the running sums (seconds)."""
    from repro_torch.checkpointing import manager as M
    from repro_torch.models import convert
    acc = collections.Counter()
    saved = []

    def wrap(owner, name, key):
        fn = getattr(owner, name)
        saved.append((owner, name, fn))

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[key] += time.perf_counter() - t0
        setattr(owner, name, timed)
    wrap(convert, "_numpy", "numpy_s")
    wrap(convert, "params_to_reference", "convert_s")
    wrap(convert, "opt_state_to_reference", "convert_s")
    wrap(M.CheckpointManager, "_stage", "stage_s")
    wrap(M.CheckpointManager, "save", "save_s")
    wrap(M.CheckpointManager, "wait", "wait_s")
    try:
        yield acc
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def state_clone(tr) -> dict:
    """The trainer's parameters and AdamW master, cloned on the device."""
    out = {f"p/{n}": p.detach().clone()
           for n, p in tr.model.named_parameters()}
    for n, t in (tr.opt_state.master or {}).items():
        out[f"master/{n}"] = t.detach().clone()
    return out


def state_differs(tr, want: dict) -> list:
    """The names of ``want``'s tensors the trainer's state does not equal
    bit for bit."""
    import torch
    got = state_clone(tr)
    return [k for k, v in want.items()
            if k not in got or not torch.equal(got[k], v)]


def link_checkpoint(src_dir: str, step: int, dst_dir: str) -> None:
    """``src_dir``'s checkpoint of ``step`` into ``dst_dir`` (hard links:
    the same files, no copy)."""
    import shutil
    name = f"step_{step:08d}"
    os.makedirs(os.path.join(dst_dir, name))
    for f in os.listdir(os.path.join(src_dir, name)):
        a, b = (os.path.join(src_dir, name, f),
                os.path.join(dst_dir, name, f))
        try:
            os.link(a, b)
        except OSError:
            shutil.copy2(a, b)


def ckpt_run(device, cfg, budget, store_dir, steps, every=0, specs=None,
             resume_from=None, resumed_state=None, final_state=None,
             keep_state=False) -> tuple:
    """One run of the ckpt_full phase: a fresh trainer (a fresh checkpoint
    directory, holding ``resume_from``'s (dir, step) checkpoint, which
    ``resume()`` then restores, timed, and whose state is held to
    ``resumed_state`` when given), ``steps`` steps in one
    ``train()`` call (so a write overlaps the steps after its save) under
    a fault plan of ``specs`` (seed 0, CHAOS_CLI_PLAN's) when given; its
    state at the end held to ``final_state`` when given.  Returns (row,
    the state cloned at the end with ``keep_state``), the trainer let go:
    per save the training thread's seconds (``timed_checkpoints``) and
    the writer's (the ``ckpt.write`` and ``ckpt.collect`` spans) with the
    bytes on disk; per step its wall time and whether it overlapped a
    write; the allocator's peak; K1's launches; the plan's fires, failed
    writes and the store's counters; the checkpoint directory (``dir``),
    which stays."""
    import tempfile
    import torch
    from repro_torch import faults, obs
    from repro_torch.common.config import (ChameleonConfig,
                                           PolicyStoreConfig, TrainConfig)
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.runtime.trainer import Trainer

    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    if resume_from is not None:
        link_checkpoint(resume_from[0], resume_from[1], d)
    obs.tracer().clear()
    obs.ledger().clear()
    # armed before the trainer opens its policy store (store.load)
    plan = faults.arm(faults.FaultPlan(specs, seed=0)) if specs else None
    try:                         # the train phase's traffic and rate, no eval
        tr = Trainer(cfg, TrainConfig(
            steps=100, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
            eval_every=0, checkpoint_every=every, checkpoint_dir=d),
            ChameleonConfig(enabled=True, hbm_budget_bytes=budget,
                            policystore=PolicyStoreConfig(enabled=True,
                                                          dir=store_dir)),
            data=SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                 seed=0), device=device)
    except BaseException:
        if plan is not None:
            faults.disarm()
        raise
    spans, saves, restore_s = [], [], None
    with timed_checkpoints() as acc:
        inner_ck, inner_step = tr._checkpoint, tr._one_step

        def checkpoint(block=False):
            a0, t0 = dict(acc), time.perf_counter()
            inner_ck(block=block)
            row = {k: acc[k] - a0.get(k, 0.0) for k in acc}
            row.update(step=tr.step, total_s=time.perf_counter() - t0)
            saves.append(row)

        def one_step(*a, **k):
            t0 = time.perf_counter()
            try:
                return inner_step(*a, **k)
            finally:
                spans.append((t0, time.perf_counter()))
        tr._checkpoint, tr._one_step = checkpoint, one_step
        if resume_from is not None:
            t0 = time.perf_counter()
            if not tr.resume():
                if plan is not None:
                    faults.disarm()
                raise AssertionError(f"ckpt_full: no checkpoint in {d}")
            restore_s = time.perf_counter() - t0
        differs = (state_differs(tr, resumed_state)
                   if resumed_state is not None else None)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats(device)
        ops.flash_attention.launches = 0
        ops.flash_attention_bwd.launches = 0
        try:
            rep = tr.train(steps)
        finally:
            if plan is not None:
                faults.disarm()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    pool = tr.rt.hostmem.pool
    pool.check()
    writes = {}
    recs = [r for r in obs.tracer().records()
            if r["lane"] == obs.LANE_CHECKPOINT and r["kind"] == "span"]
    for r in recs:
        if r["name"] == "ckpt.write":
            writes[int(r["arg"])] = {"t0": r["t0"], "t1": r["t1"],
                                     "write_s": r["t1"] - r["t0"]}
    for step, w in writes.items():
        w["collect_s"] = sum(r["t1"] - r["t0"] for r in recs
                             if r["name"] == "ckpt.collect"
                             and w["t0"] <= r["t0"] <= w["t1"])
        sd = os.path.join(d, f"step_{step:08d}")
        w["bytes"] = (sum(os.path.getsize(os.path.join(sd, f))
                          for f in os.listdir(sd))
                      if os.path.isdir(sd) else None)
    for row in saves:
        row.update(writes.get(row["step"], {}))
        row["stack_s"] = row.get("convert_s", 0.0) - row.get("numpy_s", 0.0)
    # a step's own wall time (its checkpoint, after it, is not in it)
    walls = rep.wall_times[-len(spans):]
    overlapped = [i for i, ((a, _), t) in enumerate(zip(spans, walls))
                  if any(w["t0"] < a + t and a < w["t1"]
                         for w in writes.values())]
    start = tr.step - len(spans)
    row = {"dir": d, "start": start, "steps": steps,
           "resumed_state_differs": differs,
           "losses": list(rep.losses)[-len(spans):],
           "wall_ms": [t * 1e3 for t in rep.wall_times[-len(spans):]],
           "overlapped": [start + i for i in overlapped],
           "failures": list(rep.failures), "saves": saves,
           "restore_s": restore_s, "peak": peak,
           "live_blocks": pool.live_blocks,
           "write_failures": tr.ckpt.n_write_failures,
           "restore_fallbacks": tr.ckpt.n_restore_fallbacks,
           "checkpoints": tr.ckpt.all_steps(),
           "fired": plan.stats()["fired"] if plan is not None else {},
           "store": (rep.policystore or {}).get("store"),
           "stages": rep.stages[-len(spans):],
           "k1": (ops.flash_attention.launches,
                  ops.flash_attention_bwd.launches),
           "final_state_differs": (state_differs(tr, final_state)
                                   if final_state is not None else None),
           "newest": tr.ckpt.latest_step()}
    state = state_clone(tr) if keep_state else None
    drop_trainer(tr, keep_dir=True)
    del tr, rep, pool
    gc.collect()
    torch.cuda.empty_cache()
    return row, state


def ckpt_host(cfg, tmp: str) -> dict:
    """The temporary directory's free disk, the host's available memory
    and a save's bytes at ``cfg``'s depth; ``fits`` when they hold
    CKPT_DISK_SAVES and CKPT_HOST_SAVES saves."""
    import shutil
    with open("/proc/meminfo") as f:
        mem = {ln.split(":")[0]: int(ln.split()[1]) * 1024 for ln in f}
    free = shutil.disk_usage(tmp).free
    n = cfg.param_count()
    save = n * CKPT_BYTES_PER_PARAM
    return {"tmp": tmp, "disk_free": free,
            "mem_available": mem["MemAvailable"], "params": n,
            "save_bytes": save,
            "fits": (free >= CKPT_DISK_SAVES * save
                     and mem["MemAvailable"] >= CKPT_HOST_SAVES * save)}


def phase_ckpt_full(device) -> dict:
    """Checkpoints at full width (12d; module doc): runs A-D and D's
    resume.  Every check raises.  Returns each run's K1 launches."""
    import shutil
    import tempfile
    import torch
    import repro_torch.configs as C
    from repro_torch import faults, obs

    for name in ("runtime", "hostmem"):      # earlier phases' trainers
        obs.metrics().unregister_provider(name)
    release_device_memory(device)
    cfg = C.get_config("llama2-paper").replace(num_layers=CKPT_LAYERS,
                                               attn_impl="flash")
    host = ckpt_host(cfg, tempfile.gettempdir())
    emit("ckpt_full_host", layers=CKPT_LAYERS, **host)
    if not host["fits"]:
        raise AssertionError(f"ckpt_full: the host cannot hold the saves "
                             f"{host}")
    budget, brow = exec_budget(device, cfg, phase="ckpt_full")
    # A-C share one store (B and C reuse A's policy); D adapts into its
    # own (store.put faults) and its resume opens it (store.load faults),
    # as chaos_cli's two runs do
    stores = [tempfile.mkdtemp(prefix="chip_smoke_ckpt_store_")
              for _ in range(2)]
    specs = [faults.FaultSpec.from_json(x) for x in CHAOS_CLI_PLAN["specs"]]
    runs, dirs, problems = {}, [], []

    def run(name, *a, **k):
        """One run; its checkpoint directory stays in ``dirs`` until
        ``drop_dirs``, so at most two saves are on the disk at once."""
        row, state = ckpt_run(device, cfg, budget, *a, **k)
        dirs.append(row.pop("dir"))
        runs[name] = row
        return state

    def drop_dirs():
        while dirs:
            shutil.rmtree(dirs.pop(), ignore_errors=True)

    try:
        run("A", stores[0], CKPT_STEPS + 1)
        b_state = run("B", stores[0], CKPT_STEPS, every=CKPT_EVERY,
                      keep_state=True)
        run("C", stores[0], CKPT_STEPS - CKPT_EVERY,
            resume_from=(dirs[-1], CKPT_EVERY), final_state=b_state)
        del b_state
        drop_dirs()
        d_state = run("D", stores[1], CKPT_STEPS, every=CKPT_EVERY,
                      specs=specs, keep_state=True)
        newest = runs["D"]["newest"]
        if newest is None:
            problems.append("D: no checkpoint that restore accepts")
        else:
            # one step from D's newest checkpoint; where that is D's last
            # save, the restored state must be D's at its end
            run("D_resume", stores[1], 1, specs=specs,
                resume_from=(dirs[-1], newest),
                resumed_state=d_state if newest == CKPT_STEPS else None)
        del d_state
    finally:
        drop_dirs()
        for d in stores:
            shutil.rmtree(d, ignore_errors=True)
    a = runs["A"]
    problems += ckpt_checks(runs, a)
    summary = {"ok": not problems, "problems": problems,
               "layers": CKPT_LAYERS,
               "budget": budget, "budget_row": {k: brow[k] for k in (
                   "floor", "peak", "static_bytes", "t_iter_s", "dt_s")},
               **{f"run_{k}": ckpt_summary(r, a) for k, r in runs.items()}}
    emit("ckpt_full", **summary)
    if problems:
        raise AssertionError(f"ckpt_full: {problems}")
    return {k: r["k1"] for k, r in runs.items()}


def ckpt_summary(run: dict, a: dict) -> dict:
    """A ckpt_full run's printed row: its saves, the overlapped steps' p50
    against A's same steps, the peak against A's."""
    over = run["overlapped"]
    row = {k: v for k, v in run.items() if k not in ("losses", "wall_ms")}
    row["step_p50_ms"] = p50(run["wall_ms"])
    if over:
        row["overlapped_p50_ms"] = p50([run["wall_ms"][i - run["start"]]
                                        for i in over])
        row["twin_overlapped_p50_ms"] = p50([a["wall_ms"][i] for i in over])
    row["peak_over_A"] = run["peak"] - a["peak"]
    return row


def ckpt_checks(runs: dict, a: dict) -> list:
    """ckpt_full's gates: B writes its saves; C's and D's losses (and
    D_resume's one step) equal A's at the same steps, bit for bit, and C's
    state B's; D survives its plan; no run crashes or leaves a live
    slab."""
    problems = []
    for name, r in runs.items():
        if r["failures"]:
            problems.append(f"{name}: crashed {r['failures']}")
        if r["live_blocks"]:
            problems.append(f"{name}: {r['live_blocks']} live slabs")
        want = a["losses"][r["start"]:r["start"] + len(r["losses"])]
        if name != "A" and r["losses"] != want:
            problems.append(f"{name}: losses differ from A's at steps "
                            f"{r['start']}..")
    b = runs["B"]
    if len([s for s in b["saves"] if s.get("bytes")]) != (
            CKPT_STEPS // CKPT_EVERY):
        problems.append(f"B: saves {b['checkpoints']}")
    if runs["C"]["start"] != CKPT_EVERY:
        problems.append(f"C: resumed at {runs['C']['start']}")
    if runs["C"]["final_state_differs"]:
        problems.append(f"C: state differs from B's "
                        f"{runs['C']['final_state_differs'][:4]}")
    if not sum(runs["D"]["fired"].values()):
        problems.append("D: the plan never fired")
    dr = runs.get("D_resume")
    if dr is not None and dr["resumed_state_differs"]:
        problems.append(f"D_resume: restored state differs from D's "
                        f"{dr['resumed_state_differs'][:4]}")
    return problems


def autotune_check(kernel, args, config, out, dname) -> dict:
    """One tuned variant's output against its plain version on the same
    inputs, with the limits this script holds that kernel to: K2a and K2b
    bit for bit, K1 ``k1_check``, K4 ``ssd_check`` at the variant's chunk."""
    import torch
    from repro_torch.kernels.autotune.space import SPACES
    from repro_torch.kernels.ssd_scan import ops as SSD
    if kernel == "quantize":
        qp, sp = SPACES[kernel].ref(args)
        return {"ok": torch.equal(out[0], qp) and torch.equal(out[1], sp)}
    if kernel == "dequantize":
        return {"ok": torch.equal(out, SPACES[kernel].ref(args))}
    if kernel == "flash_attention":
        return k1_check(out, SPACES[kernel].ref(args), dname)
    yr, sr = SSD.ssd_scan_plain(*args, chunk=config["chunk"])
    return ssd_check(out[0], yr, out[1], sr, dname)


def tuned_summary(row: dict) -> dict:
    return {k: row[k] for k in ("shape", "dtype", "winner", "achieved_gbps",
                                "efficiency")}


def phase_autotune(device, cal_tier, spill_runs) -> dict:
    """The kernel autotuner on the card (``repro_torch.kernels.autotune``).
    Tunes AUTOTUNE_KERNELS through ``HostMemTier.autotune`` into a fresh
    cache directory (f32, default shapes), then bf16 at the default shapes
    and at AUTOTUNE_SHAPES; holds every variant to its plain version; a
    second tier on that directory must measure nothing; with its table
    installed, K1 at the training shape cold (tuned, default, default,
    tuned) and K4 through ``chunk=None``; the link's efficiency from the
    calibrate phase's curve and the Eq-3 bandwidth it leaves; then the
    serve_spill run through ``--autotune --spill-compression auto`` on the
    warm directory: its tokens must equal the int8 run's when the advisor
    chose int8 for every row, the raw run's when raw for every row.
    Returns each kernel's entry for the kernels line."""
    import tempfile

    import torch
    from repro_torch.common.config import AutotuneConfig, ChameleonConfig
    from repro_torch.hostmem import HostMemTier
    from repro_torch.hostmem.bwmodel import BandwidthModel
    from repro_torch.kernels.autotune import table as T
    from repro_torch.kernels.autotune.space import SPACES
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.quant_offload import ops as Q
    from repro_torch.kernels.ssd_scan import ops as SSD
    from repro_torch.launch import serve

    with tempfile.TemporaryDirectory() as cache_dir:
        atcfg = AutotuneConfig(enabled=True, cache_dir=cache_dir,
                               kernels=AUTOTUNE_KERNELS)
        t0 = time.perf_counter()
        tuner = HostMemTier(device=device).autotune(atcfg)
        jobs = [(k, SPACES[k].default_shape, "float32")
                for k in AUTOTUNE_KERNELS]
        measured = {j: len(SPACES[j[0]].variants_for(j[2])) for j in jobs}
        for job in ([(k, SPACES[k].default_shape, "bfloat16")
                     for k in AUTOTUNE_KERNELS]
                    + [(k, shape, "bfloat16") for k, shape in AUTOTUNE_SHAPES]):
            before = tuner.n_measured
            tuner.tune(job[0], job[1], getattr(torch, job[2]))
            measured[job] = tuner.n_measured - before
            jobs.append(job)
        tuner.cache.save()
        tune_s = time.perf_counter() - t0
        if (tuner.spec.kind != "h100_sxm"
                or tuner.n_measured != sum(measured.values())):
            raise AssertionError(f"autotune: {tuner.stats()}, {measured}")
        rows, failed = {}, []
        for job in jobs:
            kernel, shape, dname = job
            space = SPACES[kernel]
            e = tuner.cache.get(kernel, shape, dname)
            args = space.make_args(shape, getattr(torch, dname), device)
            checks = {}
            for config in space.variants_for(dname):
                res = autotune_check(kernel, args, config,
                                     space.run(args, config), dname)
                checks[json.dumps(config, sort_keys=True)] = res
                if not res["ok"]:
                    failed.append((kernel, list(shape), dname, config))
            del args
            rows[job] = {"kernel": kernel, "shape": list(shape),
                         "dtype": dname, "winner": e["config"],
                         "achieved_gbps": e["achieved_bps"] / 1e9,
                         "efficiency": e["efficiency"],
                         "measured_s": e["measured_s"],
                         "bytes_moved": e["bytes_moved"],
                         "n_measured": measured[job], "checks": checks}
            emit("autotune", **rows[job])
        emit("autotune_tuned", seconds=tune_s, **tuner.stats())
        if failed:
            raise AssertionError(f"autotune: variants differ from their "
                                 f"plain versions: {failed}")

        # a cold process on the warm directory
        t2 = HostMemTier(device=device).autotune(atcfg)
        entries = t2.cache.table_entries()
        emit("autotune_restart", installed=T.installed_count(), **t2.stats())
        if t2.n_measured != 0 or t2.n_cache_hits != len(AUTOTUNE_KERNELS):
            raise AssertionError(f"autotune restart: {t2.stats()}")

        # K1 at the training shape (llama2-paper's heads, MHA), cold, with
        # the table and without
        shape = AUTOTUNE_SHAPES[0][1]
        B, S, H, D = shape
        block_q = T.tuned_config("flash_attention", shape,
                                 torch.bfloat16)["block_q"]
        gen = torch.Generator(device=device).manual_seed(2)
        qkv = [k1_inputs(gen, B, S, S, H, H, D, torch.bfloat16, device)
               for _ in range(TRAIN_LAYERS)]

        def run():
            return [ops.flash_attention(q, k, v, causal=True)
                    for q, k, v in qkv]
        cold = {"tuned": [], "default": []}
        ops.flash_attention.tuned_launches = 0
        for which in ("tuned", "default", "default", "tuned"):
            if which == "tuned":
                T.install(entries)
            else:
                T.clear()
            cold[which].append(graph_ms(run, iters=1, reps=10) / TRAIN_LAYERS)
        k1_tuned = ops.flash_attention.tuned_launches
        T.install(entries)
        a = run()
        T.clear()
        b = run()
        T.install(entries)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        del qkv, a, b
        # K4 through chunk=None
        ssd_shape = SPACES["ssd_scan"].default_shape
        ins = SPACES["ssd_scan"].make_args(ssd_shape, torch.bfloat16, device)
        chunk = T.tuned_config("ssd_scan", ssd_shape, torch.bfloat16)["chunk"]
        SSD.ssd_scan.tuned_launches = 0
        y, st = SSD.ssd_scan(*ins)
        y2, st2 = SSD.ssd_scan(*ins, chunk=chunk)
        torch.cuda.synchronize()
        k4_tuned = SSD.ssd_scan.tuned_launches
        k4_same = torch.equal(y, y2) and torch.equal(st, st2)
        emit("autotune_table", k1_shape=list(shape), k1_block_q=block_q,
             k1_default_block_q=128, k1_tuned_cold_ms=cold["tuned"],
             k1_default_cold_ms=cold["default"], k1_cold_layers=TRAIN_LAYERS,
             k1_tuned_launches=k1_tuned, k1_equal_to_default=same,
             k4_shape=list(ssd_shape), k4_chunk=chunk,
             k4_tuned_launches=k4_tuned, k4_equal_to_explicit=k4_same)
        # graph_ms calls ``run`` 3 times to warm up and once to capture
        if k1_tuned != 2 * 4 * TRAIN_LAYERS or k4_tuned != 1 or not k4_same:
            raise AssertionError(f"autotune: table launches K1 {k1_tuned}, "
                                 f"K4 {k4_tuned} (equal {k4_same})")

        # the link: the calibrate phase's curve against the spec's host_bw
        eff = t2.link_efficiency(cal_tier.bwmodel)
        size, _, link_gbps = cal_tier.bwmodel.curve()[-1]
        host_gbps = ChameleonConfig().host_link_gbps
        eq3 = BandwidthModel(host_gbps, link_efficiency=eff)
        eq3_gbps = size / eq3.transfer_time(size) / 1e9
        spec_gbps = t2.spec.host_bw / 1e9
        emit("autotune_link", efficiency=eff, measured_gbps=link_gbps,
             at_bytes=size, spec_host_gbps=spec_gbps,
             eq3_gbps_untuned=host_gbps, eq3_gbps=eq3_gbps)
        # the efficiency is capped at 1 (the reference's rule): the Eq-3
        # bandwidth must not fall below the measured link up to host_bw
        if eq3_gbps < min(link_gbps, spec_gbps) * (1 - 1e-9):
            raise AssertionError(f"autotune: Eq-3 bandwidth {eq3_gbps} GB/s "
                                 f"under the measured link {link_gbps}")

        # serve_spill through --spill-compression auto on the warm cache
        allocated_before = release_device_memory(device)
        for f in (Q.quantize, Q.dequantize):
            f.launches = f.tuned_launches = 0
        stats = serve.main(SERVE_ARGS + SPILL_ARGS + AUTO_SPILL_ARGS
                           + ["--autotune-cache-dir", cache_dir])
        T.clear()
    launches = {"quantize_rows": Q.quantize.launches,
                "dequantize_rows": Q.dequantize.launches}
    tuned_launches = {"quantize_rows": Q.quantize.tuned_launches,
                      "dequantize_rows": Q.dequantize.tuned_launches}
    adv, m = stats["kvspill"]["advisor"], spill_metrics(stats)
    want = (spill_runs["int8"] if adv["n_raw"] == 0 else
            spill_runs["none"] if adv["n_int8"] == 0 else None)
    got = stats["results"]
    lengths = {rid: len(t) for rid, t in got.items()}
    emit("autotune_serve", advisor=adv, autotune=stats["autotune"],
         tokens_equal_to=("int8" if adv["n_raw"] == 0 else "none"
                          if adv["n_int8"] == 0 else None),
         tokens_equal=got == want if want is not None else None,
         launches=launches, tuned_launches=tuned_launches,
         tokens=stats["tokens"], wall_s=stats["wall_s"],
         tokens_per_s=stats["tokens_per_s"], ticks=stats["ticks"],
         tick_ms=stats["latency"]["tick_ms"],
         max_memory_allocated=stats["max_memory_allocated"],
         allocated_before=allocated_before, **m)
    if stats["completed"] != 8 or set(lengths.values()) != {32}:
        raise AssertionError(f"autotune serve: {lengths}")
    if (m["preemptions"] <= 0 or m["spills"] != m["restores"]
            or m["pool_bytes_in_use"] != 0):
        raise AssertionError(f"autotune serve: {m}")
    if want is not None and got != want:
        raise AssertionError("autotune serve: tokens differ from the "
                             "static run of the advisor's choice")
    if (stats["autotune"]["n_measured"] != 0
            or launches != {k: adv["n_int8"] for k in launches}):
        raise AssertionError(f"autotune serve: {stats['autotune']}, "
                             f"launches {launches}, advisor {adv}")
    return {
        "flash_attention_fwd": dict(
            tuned_summary(rows[("flash_attention", AUTOTUNE_SHAPES[0][1],
                                "bfloat16")]),
            tuned_launches=k1_tuned, block_q=block_q,
            tuned_cold_ms=min(cold["tuned"]),
            default_cold_ms=min(cold["default"])),
        **{name: dict(tuned_summary(rows[(kernel, AUTOTUNE_SHAPES[i][1],
                                          "bfloat16")]),
                      tuned_launches=tuned_launches[name], advisor=adv)
           for i, (name, kernel) in enumerate(
               (("quantize_rows", "quantize"),
                ("dequantize_rows", "dequantize")), 1)},
        "ssd_scan_fwd": dict(
            tuned_summary(rows[("ssd_scan", ssd_shape, "bfloat16")]),
            tuned_launches=k4_tuned)}


def zoo_grad_readings(device, n_seeds: int) -> None:
    """``--zoo-grads N``: the gradient check of every ZOO_TRAIN and
    ZOO_GRADS phase on seeds 1..N with no gate (the readings that set
    ZOO_GRAD_TOL)."""
    import repro_torch.configs as C
    for phase, arch in {**ZOO_TRAIN, **ZOO_GRADS}.items():
        zoo_grad_check(device, C.get_config(arch), phase,
                       seeds=range(1, n_seeds + 1), gate=False)


def timed(name: str, fn, *args):
    """``fn(*args)``, then a ``seconds`` line with its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit("seconds", of=name, seconds=time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    paths = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         libraries={n: os.path.relpath(p, ROOT) for n, p in paths.items()},
         ptxas={n: [ln.strip() for ln in
                    p.with_suffix(".log").read_text().splitlines()
                    if any(k in ln for k in ("entry function", "registers",
                                             "spill", "C75"))]
                for n, p in paths.items()})

    if argv[:1] == ["--zoo-grads"]:
        zoo_grad_readings(device, int(argv[1]))
        return 0
    example_launches = phase_examples(device)

    import repro_torch.configs as C
    from repro_torch.models import transformer as T
    cfg = C.get_config("llama2-paper")
    scfg = C.get_config("mamba2-780m")
    main_path = llama2_cases(cfg)
    rows = phase_kernel(device, SWEEP_CASES + main_path)
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k1_cold = {"serve": k1_cold_ms(1, SUMMARY_LEN, H, Kh, D, K1_COLD_LAYERS,
                                   device),
               "train": k1_cold_ms(TRAIN_BATCH, TRAIN_SEQ, H, Kh, D,
                                   TRAIN_LAYERS, device)}
    for where, row in k1_cold.items():
        emit("kernel_cold", name="flash_attention_fwd", at=where, **row)
    bwd_row = phase_kernel_bwd(device, BWD_CASES + [
        (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, H, Kh, D, True, None,
         ("bfloat16",), True)])
    quant_times, quant_q_err, quant_out_err = phase_quant(device)
    decode_row, decode_err = phase_decode_kernel(device, decode_cases(cfg))
    ssd_times = phase_ssd_kernel(device, scfg)
    ssd_bwd_rows = phase_ssd_bwd_kernel(device, SSD_BWD_CASES)
    d64 = phase_kernel_d64(device)
    cross = phase_kernel_cross(device)
    decode_cross = phase_decode_cross(device)
    configs = timed("kernel_configs", phase_kernel_configs, device)
    launches, decode_launches, resident = phase_serve(device)
    quant_launches, spill_runs = phase_serve_spill(device, resident)
    gc.collect()                       # the serve phases' models are gone
    torch.cuda.empty_cache()
    model = T.init_model(cfg, seed=0, device=device)
    phase_crosscheck(device, cfg, model)
    phase_profile(device, cfg, model)
    phase_spill(device, cfg, model)
    tier = phase_calibrate(device)
    del model
    ssd_launches = phase_serve_ssm(device)
    gc.collect()
    torch.cuda.empty_cache()
    model = T.init_model(scfg, seed=0, device=device)
    phase_ssm_crosscheck(device, scfg, model)
    phase_profile(device, scfg, model)
    del model
    moe_launches = phase_serve_moe(device)
    gc.collect()                       # the serve phases' models are gone
    torch.cuda.empty_cache()
    train_launches, bwd_launches = phase_train(device)
    dist_launches = phase_distributed(device)
    phase_train_cli(device)
    phase_chameleon(device, tier)
    exec_launches = phase_chameleon_exec(device)
    async_launches, hang_ctx = phase_chameleon_async(device)
    chaos_launches, chaos_12d = timed("chaos", phase_chaos, device,
                                      exec_launches[2], hang_ctx)
    del hang_ctx
    ckpt_launches = timed("ckpt_full", phase_ckpt_full, device)
    serve_zoo = timed("serve_zoo", phase_serve_zoo, device)
    zoo = {phase: timed(phase, phase_train_zoo, device, phase)
           for phase in ZOO_TRAIN}
    for phase in ZOO_GRADS:
        timed(phase, phase_zoo_grads, device, phase)
    second = {"decode_encdec": phase_decode_encdec(device),
              "decode_vlm": phase_decode_vlm(device)}
    tuned = phase_autotune(device, tier, spill_runs)

    summary = next(rows[(c, "bfloat16")] for c in main_path
                   if c[1] == SUMMARY_LEN)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
        "launches": launches,
        # the largest error over every bf16 prefill shape of the main path
        "max_abs_err": max(rows[(c, "bfloat16")]["max_abs_err"]
                           for c in main_path),
        "ms": summary["ms"], "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"], "bound_by": summary["bound_by"],
        "library_ms": summary["library_ms"],
        "at": {"shape": summary["shape"], "dtype": "bfloat16"},
        # cold L2, one launch per layer's own q, k, v (k1_cold_ms)
        "cold_ms": k1_cold["serve"]["cold_ms"],
        "library_cold_ms": k1_cold["serve"]["library_cold_ms"],
        # the train phase: steps x layers launches, and the cold time at
        # its shape
        "train_launches": train_launches,
        # the distributed phase's sharded run: steps x layers
        "distributed_launches": dist_launches["k1"][0],
        # the examples phase (quickstart, adaptive_swap_demo, serve_batched)
        "examples_launches": example_launches["k1_fwd"],
        # chameleon_exec: the trainer under Chameleon's applied policies
        "chameleon_exec_launches": exec_launches[0],
        # chameleon_async: the async placement's run, (steps + replays) x 8
        "chameleon_async_launches": async_launches[0],
        # chaos: the engine_window run, (steps + replays) x 8
        "chaos_launches": chaos_launches[0],
        # 12d: the examples phase's train_e2e runs and elastic_restart,
        # the drill's new scenarios, ckpt_full's runs
        "examples_runs": {n: r["k1_fwd"]
                          for n, r in example_launches["runs"].items()},
        "chaos_12d_launches": {n: k[0] for n, k in chaos_12d.items()},
        "ckpt_full_launches": {n: k[0] for n, k in ckpt_launches.items()},
        "train_cold_ms": k1_cold["train"]["cold_ms"],
        "train_library_cold_ms": k1_cold["train"]["library_cold_ms"],
        # the decoder zoo: serve_moe's prefills, the train phases' steps
        "zoo_launches": {"serve_moe": moe_launches[0],
                         **{p: zoo[p]["k1_fwd"] for p in zoo},
                         **{p: n[0] for p, n in second.items()},
                         **{f"serve_zoo:{a}": n["k1"]
                            for a, n in serve_zoo.items()}},
        # the configurations' own shapes (CONFIG_K1_CASES), bf16
        "configs": {k: cross_summary(r) for k, r in configs["fwd"].items()},
        # one rank's heads where the model dim does not divide them
        # (LOCAL_K1_CASES), bf16, and the launches of those checks
        "local_heads": {k: cross_summary(r)
                        for k, r in configs["local"]["fwd"].items()},
        "local_heads_check_launches": configs["local"]["launches"][0],
        # head dim 64 (zamba2 32 x 32 heads, granite 16 over 8), bf16
        "d64": {k: d64_summary(r) for k, r in d64["fwd"].items()},
        "d64_max_abs_err": d64["fwd_max_abs_err"],
        # the second input path's shapes (CROSS_CASES), bf16
        "cross": {k: cross_summary(r["fwd"]) for k, r in cross.items()},
        # the autotune phase: the tuned entry at the training shape and the
        # launches that read it from the installed table
        "autotune": tuned["flash_attention_fwd"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/ops.py:54",
        "launches": bwd_launches,
        "distributed_launches": dist_launches["k1"][1],
        "examples_launches": example_launches["k1_bwd"],
        "chameleon_exec_launches": exec_launches[1],
        "chameleon_async_launches": async_launches[1],
        "chaos_launches": chaos_launches[1],
        "examples_runs": {n: r["k1_bwd"]
                          for n, r in example_launches["runs"].items()},
        "chaos_12d_launches": {n: k[1] for n, k in chaos_12d.items()},
        "ckpt_full_launches": {n: k[1] for n, k in ckpt_launches.items()},
        # the largest bf16 error of dq, dk, dv at the training shape
        "max_abs_err": max(bwd_row[f"{g}_max_abs_err"]
                           for g in ("dq", "dk", "dv")),
        "ms": bwd_row["ms"], "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"], "bound_by": bwd_row["bound_by"],
        "tflops": bwd_row["tflops"],
        # the backward of scaled_dot_product_attention alone, device time
        "library_ms": bwd_row["library_ms"],
        "sdpa_ratio": bwd_row["sdpa_ratio"],
        "cold_ms": bwd_row["cold_ms"],
        "zoo_launches": {p: zoo[p]["k1_bwd"] for p in zoo},
        "d64": {k: d64_summary(r) for k, r in d64["bwd"].items()},
        "configs": {k: dict(cross_summary(r), max_abs_err=max(
            r[f"{g}_max_abs_err"] for g in ("dq", "dk", "dv")))
            for k, r in configs["bwd"].items()},
        "local_heads": {k: dict(cross_summary(r), max_abs_err=max(
            r[f"{g}_max_abs_err"] for g in ("dq", "dk", "dv")))
            for k, r in configs["local"]["bwd"].items()},
        "local_heads_check_launches": configs["local"]["launches"][1],
        "cross": {k: dict(cross_summary(r["bwd"]), max_abs_err=max(
            r["bwd"][f"{g}_max_abs_err"] for g in ("dq", "dk", "dv")))
            for k, r in cross.items()},
        "at": {"shape": bwd_row["shape"], "causal": True,
               "dtype": "bfloat16"}}] + [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/quant_offload/csrc/"
                  "quant_offload.cu",
        "replaces": f"src/repro/kernels/quant_offload/kernel.py:{line}",
        "launches": quant_launches[name],
        # the distributed phase's compressed sync: per leaf, K2a once and
        # K2b twice (the residual and the one gathered slab)
        "distributed_launches": dist_launches["k2"][i],
        # the examples phase's 12d runs (train_e2e's burst spills raw)
        "examples_runs": {n: r[("k2a", "k2b")[i]]
                          for n, r in example_launches["runs"].items()},
        # over every quant case: int8 steps for K2a, output for K2b (0 = the
        # kernel is bit-identical to its plain version)
        "max_abs_err": err,
        "ms": quant_times[name]["ms"], "plain_ms": quant_times[name]["plain_ms"],
        "bound_ms": quant_times[name]["bound_ms"],
        "bound_by": quant_times[name]["bound_by"],
        "library_ms": quant_times[name]["library_ms"],
        "at": {"shape": list(KV_CACHE_SHAPE[:1] + KV_CACHE_SHAPE[2:]),
               "dtype": "bfloat16", "strided": True},
        # the autotune phase: the tuned entry at the spill's row shape and
        # the auto serve run's launches under it
        "autotune": tuned[name]}
        for i, (name, line, err) in enumerate((
            ("quantize_rows", 43, quant_q_err),
            ("dequantize_rows", 61, quant_out_err)))] + [{
        "name": "flash_decode_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_decode_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:147",
        "launches": decode_launches,
        # the largest bf16 error at llama2-paper's decode shape
        "max_abs_err": decode_err,
        "ms": decode_row["ms"], "plain_ms": decode_row["plain_ms"],
        "bound_ms": decode_row["bound_ms"],
        "bound_by": decode_row["bound_by"],
        "library_ms": decode_row["library_ms"],
        # cold L2, one launch per layer of a 32-layer cache (decode_cold_ms)
        "cold_ms": decode_row["cold_ms"],
        "library_cold_ms": decode_row["library_cold_ms"],
        "zoo_launches": {"serve_moe": moe_launches[1],
                         **{p: n[1] for p, n in second.items()},
                         **{f"serve_zoo:{a}": n["k3"]
                            for a, n in serve_zoo.items()}},
        "configs": {k: cross_summary(r)
                    for k, r in configs["decode"].items()},
        "examples_launches": example_launches["k3"],
        "examples_runs": {n: r["k3"]
                          for n, r in example_launches["runs"].items()},
        # the same call writing each row's log-sum-exp (the kv_seq cache's
        # merge), at the timed shape
        "lse_ms": decode_row["lse_ms"],
        "lse_max_abs_err": decode_row["lse_max_abs_err"],
        "d64": d64_summary(d64["decode"]),
        # a whole memory as lens (DECODE_CROSS_CASES), bf16
        "cross": {k: cross_summary(r) for k, r in decode_cross.items()},
        "at": {"shape": decode_row["shape"], "lens": decode_row["lens"],
               "dtype": "bfloat16"}}, {
        "name": "ssd_scan_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_fwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:64",
        "launches": ssd_launches,
        # the largest bf16 error of y over mamba2-780m's prefill lengths
        "max_abs_err": max(r["y_max_abs_err"] for r in ssd_times.values()),
        # ... and at the train phases' shapes, the saved layout
        "train_max_abs_err": max(r["fwd"]["y_max_abs_err"]
                                 for r in ssd_bwd_rows),
        "ms": ssd_times[max(SSD_LENS)]["ms"],
        "plain_ms": ssd_times[max(SSD_LENS)]["plain_ms"],
        "bound_ms": ssd_times[max(SSD_LENS)]["bound_ms"],
        "bound_by": ssd_times[max(SSD_LENS)]["bound_by"],
        "library_ms": None,
        "zoo_launches": {p: zoo[p]["k4_fwd"] for p in zoo},
        # the autotune phase: the tuned chunk and its table launch
        "autotune": tuned["ssd_scan_fwd"],
        "at": {"shape": ssd_times[max(SSD_LENS)]["shape"],
               "chunk": scfg.ssm_chunk, "dtype": "bfloat16"},
        # at the train phases' shapes, keeping the states for the backward
        "train": {r["arch"]: {k: r["fwd"][k] for k in (
            "shape", "ms", "cold_ms", "bound_ms", "bound_by")}
            for r in ssd_bwd_rows}}, {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:73",
        # the train phases' backward steps: steps x ssm layers each
        "launches": sum(zoo[p]["k4_bwd"] for p in zoo),
        "zoo_launches": {p: zoo[p]["k4_bwd"] for p in zoo},
        # the largest bf16 error over dx, dB, dC at the train shapes
        "max_abs_err": max(r[f"{g}_max_abs_err"] for r in ssd_bwd_rows
                           for g in ("dx", "dB", "dC")),
        "ms": ssd_bwd_rows[0]["ms"], "plain_ms": ssd_bwd_rows[0]["plain_ms"],
        "bound_ms": ssd_bwd_rows[0]["bound_ms"],
        "bound_by": ssd_bwd_rows[0]["bound_by"],
        "bound_f32_ms": ssd_bwd_rows[0]["bound_f32_ms"],
        "cold_ms": ssd_bwd_rows[0]["cold_ms"],
        "library_ms": None,
        "at": {"shape": ssd_bwd_rows[0]["shape"], "chunk": 256,
               "dtype": "bfloat16"},
        "zamba2": {k: ssd_bwd_rows[1][k] for k in (
            "shape", "ms", "cold_ms", "plain_ms", "bound_ms", "bound_by")}}]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
