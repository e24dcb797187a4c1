#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when its
check does not hold:

1. build every CUDA source of the port for sm_90a (one nvcc per source, all
   started together) and print the build seconds and ptxas resource use;
2. hold every kernel against its plain PyTorch version on the card: the
   assignment kernel at the engine shape and at the kernel-test shapes
   (idx/admit/pos exact, gate rtol 1e-5 atol 1e-6), the segment sum on
   seventeen id mixes (bit for bit the CPU's row-order sums: uniform, 95%
   padding, one segment, out-of-range ids, signed zeros, F = 1..4, J = 0,
   and S*S + 1 = 90001 segments in f32 and i32, F = 1 and 3), the fused
   candidate-set assignment at the sparse engine shape (N=100000, K=16,
   E=300) and at nineteen other shapes (site/admit exact: N = 1, ragged
   tiles, one site for every row, a tile of sentinel rows, K = 1, 3, 8,
   48, 50, E = 512, 6000, 20000, sizes at the caps' boundary); time each
   at its engine shape two ways, a call between CUDA events (host launch
   work included) and the kernels' device time from ``torch.profiler``,
   with the launches a call (the segment sum on a uniform id mix, on one
   where 95% of rows carry the padding id, and at 90001 segments); and the
   assignment kernel and the fused kernel with a lane axis (one call for K
   problems) against their plain versions and against K unbatched launches
   at K = 3 and at the ensemble shapes [16, 100000, 300] and [16, 100000,
   16], where they are timed;
3. drive the dense path at WLCG scale: ``simulate`` on 300 sites and 100000
   jobs with ``panda_dispatch`` plus capacity dispatch, twice, with the
   launch counters set to 0 just before the first run; require every round
   with work to launch the assignment kernel once, and the two runs to agree
   bit for bit; print rounds/s, the assignment's call time between CUDA
   events in the second run, and its kernels' device time per launch in a
   profile of PROFILE_ROUNDS rounds;
4. drive the sparse top-k path at the same scale, cut to SPARSE_FULL_ROUNDS
   rounds: ``data_locality`` with the
   fused capacity assigner and ``topk=16``, twice, counters set to 0 just
   before the first run; require every round with work to launch the fused
   kernel once and never call its plain version, and the two runs to agree
   bit for bit; print rounds/s (and the same policy's dense rate), the
   candidate build's seconds, the fused call's time between CUDA events in
   the second run, and the fused kernels' device time per launch in a
   profile of SHORT_PROFILE_ROUNDS rounds;
5. run a 50-site, 5000-job scenario with failures on the card and on the
   CPU, cut to its first DRAIN_ROUNDS rounds (of the 10103 that drain it,
   to keep the smoke's time with phases 9 to 12), and require the same
   rounds, makespan, per-job outcomes and site counters;
6. on the same scenario, cut to its first SPARSE_DRAIN_ROUNDS rounds: the
   fused sparse path at ``topk=S`` must equal the dense capacity dispatch on
   the card, and ``topk=8`` on the card must equal ``topk=8`` on the CPU;
7. hold the flash-attention kernel against ``attention_ref`` on the card
   (max abs error 2e-5 in f32, 2e-2 in bf16) on ``tests/test_kernels.py``'s
   six shapes, a non-causal ragged one, a right-aligned one (Skv > S), one
   each for the mma.sync and bf16 CUDA-core paths, seven for the wgmma/TMA
   path (ragged tails, right-aligned q, a window, GQA 40/8, non-causal,
   D = 64), four for it at D = 256 (ragged 64-key tiles, right-aligned q,
   a window on one KV head, non-causal), rows that keep no key (S > Skv
   under causality) on three paths, and the deepseek-7b prefill shape; each
   also with its log-sum-exp (within 1e-4 of the plain one's, +inf where a
   row keeps no key) and the same output bits as without it; the prefill
   shape is timed beside its plain version and
   ``scaled_dot_product_attention`` and the profiler must show
   ``flash_fwd_kernel_wgmma`` and no other flash kernel;
8. serve deepseek-7b at full width (bf16, random weights from seed 0):
   ``generate`` over 4 prompts of 4096 tokens with 32 new tokens, twice,
   launch counters set to 0 just before the first run; require 30 flash
   launches (one a layer, all of ``flash_fwd_kernel_wgmma`` in the profiled
   prefill), bit-identical tokens, and prefill logits within
   2e-2 of the largest logit of the same prefill through the plain
   ``chunked_attention``; print prefill and decode tokens/s and peak memory.

9. drive the subsystem pipeline at WLCG scale (run after phase 4): 300 sites
   under the flaky-site outage calendar (availability, ``mtbf`` 4 h), 100000
   jobs in 25000 4-stage ATLAS MC workflow DAGs, ``critical_path_first``
   with capacity dispatch and a 256-row event log with its ``site_avail``
   column, SUB_FULL_ROUNDS rounds twice, counters set to 0 just before the
   first run;
   require the assignment kernel once in every round with work, a preempted
   job, and the two runs bit-identical (subsystem states and log included);
   print rounds/s beside phase 3's, segment sums a round, the device busy
   share over SHORT_PROFILE_ROUNDS profiled rounds, and the host seconds of
   ``transition_rows`` and ``ml_dataset``;
10. the same pipeline at 50 sites and 1250 workflows, with the flaky-site
   windows and a rolling brown-out's in one calendar, cut to CROSS_ROUNDS
   rounds, every round logged: dense capacity dispatch and fused ``topk=8``
   on the card each equal the CPU (log included), and their transition CSV,
   availability CSV and ML NDJSON exports are byte-identical.

11. data movement at WLCG scale (run after phase 10): 300 sites, 100000 jobs
   reading a 1024-dataset Zipf catalog (``make_replicas`` of
   ``zipf_dataset_sizes(1024)``, disks of ``memory * 1e9`` bytes) over
   ``atlas_like_network(300)``, ``cache_on_read``; counters set to 0 just
   before each run: (a) ``panda_dispatch`` with capacity dispatch,
   DATA_FULL_ROUNDS rounds twice, bit-identical (jobs, catalog, log), with
   WAN transfers and
   cache hits, the catalog invariants, the assignment kernel once in every
   round with work; print rounds/s beside phase 3's, segment sums and
   kernels a round, the device busy share over SHORT_PROFILE_ROUNDS profiled rounds,
   and the calls of ``insert_mask`` under storage pressure; (b) the same with the
   FTS transfer queues (``max_active=4``, ``queue_slots=256``), cut to
   DATA_TR_ROUNDS rounds: the ledger ``n_enq = n_done + n_cancel + in
   flight`` must balance; print ``n_overflow`` and rounds/s; (c)
   ``data_locality`` with the fused kernel at ``topk=16`` and the catalog
   (the candidate index's data branch), cut to DATA_SPARSE_ROUNDS rounds;
12. card against CPU at S=50, cut to XDATA_ROUNDS rounds, every round
   logged: 1250 ATLAS MC workflows with ``scenario_replicas``, flaky-site
   outages, ``cache_on_read`` and the transfer queues under dense capacity
   dispatch; and 5000 synthetic jobs on the 1024-dataset catalog with
   ``data_locality`` and the fused kernel at ``topk=8``.  Each must go under
   storage pressure, equal the CPU (catalog and transfer rings included),
   and export the same transfer rows, transition rows and ML NDJSON byte
   for byte.

13. fault injection at WLCG scale (run after phase 3): ``flaky_grid(300,
   n_flaky=3)``, the 100000 jobs, ``panda_dispatch`` with capacity dispatch
   and a 256-row log, resubmission backoff (60 s), walltime kills (at
   FAULT_WALLTIME), the circuit breaker (0.7), ``max_retries=4``;
   FULL_MAX_ROUNDS rounds through ``simulate`` with a recorder and again through
   ``monitor.watch`` in FAULT_SEGMENTS segments with an NDJSON sink and a
   recorder, counters set to 0 just before the first: the two must be
   bit-identical, with kills, breaker trips and backoff, the assignment
   kernel once in every round with work, the stream rendered by
   ``follow_stream``; print rounds/s beside phase 3's, segment sums and
   kernels a round, the device busy share over SHORT_PROFILE_ROUNDS profiled rounds,
   the recorder's spans and the packed against the general start order;
14. transfer failures at WLCG scale: phase 11(b)'s data path with
   ``lossy_links(300, p=0.05, hot=3)``, ``xfer_backoff=30`` and a
   replica-loss calendar over the 1024 datasets, DATA_TR_ROUNDS rounds: the
   ledger ``n_enq = n_done + n_cancel + n_xfer_fail + in flight`` must
   balance, with failed transfers, lost replicas and the catalog invariants;
15. card against CPU at S=50, cut to XFAULT_MATRIX_ROUNDS and XFAULT_ROUNDS
   rounds, every round logged: phase 12's workflow run with the golden
   matrix's fault state,
   and the blackhole-site scenario under dense capacity dispatch and the
   fused kernel at ``topk=8``; states, the log, ``fault_rows``, the
   transition rows and the ML NDJSON byte for byte.

16. scenario ensembles (run after phase 15): (a) 16 ragged lanes at WLCG
   scale (lane i: the 300 sites at speed x (0.7 + 0.04 i), 62500 + 2500 i
   jobs, padded to 100000), ``panda_dispatch`` with capacity dispatch,
   ENS_ROUNDS rounds through ``simulate_many`` twice, counters set to 0 just
   before the first run: bit-identical, one assign launch a round with work
   for all 16 lanes; print lane-rounds/s beside phase 3's solo rounds/s,
   segment sums a round, kernels a round and the device busy share over
   SHORT_PROFILE_ROUNDS profiled rounds, the batched assign call's time and
   peak memory; then the same lanes in ENS_BUCKETS buckets, ENS_BUCKET_ROUNDS
   rounds (equal to the flat run of as many rounds) and lanes 0 and 15 alone through ``simulate`` (each equal to its
   lane); (b) four lanes of phase 9's configuration, each its own outage
   seed, ENS_SUB_ROUNDS rounds, lane-rounds/s beside phase 9's rate; (c)
   four ragged lanes at S=50 (3000 to 5000 jobs in workflows, flaky-site
   outages), XENS_ROUNDS rounds on the card and on the CPU: every array
   equal, one lane's transition CSV and ML NDJSON byte for byte; then four
   lanes at S=50 with data, transfer queues and faults at ``topk=8``,
   draining at different rounds, the same way; (d) the 16 lanes of (a)
   with ``data_locality`` and the fused capacity assign at ``topk=16``, one
   fused launch a round for all lanes, lane 15 alone; (e) four lanes of
   phase 11(b)'s data and transfer-queue configuration, traced, with the
   catalog column sum timed, then four lanes of phase 13's fault channels
   (lane 0 alone too), each beside its solo rate.

17. calibration (run after phase 16): (a) Fig. 3 at the paper's scale (3000
   jobs over 30 days on 50 sites, misconfigured at sigma 1.05): ``grid``,
   ``random``, ``cma_es`` and ``gp_bo`` at seed 3, each below err0, ``grid``
   on the card equal to the CPU's; (b) ``calibrate_platform`` at
   ``bench_calibration.run_platform``'s configuration (400 jobs, 6 sites,
   engine trace, speeds and WAN links): SPSA, Adam through
   ``torch.autograd`` (the segment sum's backward on the card, the loss
   curve equal to the CPU's within rtol 1e-5) and CMA-ES with their
   recovery errors, then the 8-lane engine population as one call against
   a loop of 8 solo calls, cut to CAL_POP_ROUNDS rounds (lanes = solo bit
   for bit); (c) SPSA on the engine objective at WLCG scale (300 sites,
   100000 jobs, 50000 single-replica WAN datasets, D = 90300 knobs): one
   ``simulate_many`` call of 9 lanes an iteration, cut to CAL_WLCG_ROUNDS
   rounds, with lane-rounds/s, segment sums and kernels a round, the busy
   share over SHORT_PROFILE_ROUNDS rounds and peak memory; (d) the segment
   sum's backward bit for bit the plain version's gradient, timed at the
   engine shape and at 90001 segments, and the forward without a gradient
   against the kernel's wrapper alone.

18. serving families (run after phase 8, whose model is freed first), bf16,
   seed-0 weights, 4 prompts of 4096 seeded tokens and 32 new, ``generate``
   greedy and then sampled (temperature 1.0, ``PRNGKey(0)``), counters set to
   0 just before the greedy run; prefill tokens/s, decode ms a step, peak
   memory and each kernel's launches a prefill and a decode step: (a)
   granite-moe-1b-a400m at full width and depth (the router launches the
   assign kernel once a layer, prefill and decode), the dropped share of
   one ``forward`` at the prompt, and ``moe_route`` on layer 0's router
   logits through the kernel against ``moe_route_ref`` on the card at the
   prefill's ``[32, 512, 32]`` and a decode step's ``[1, 4, 32]`` (idx, slot
   and keep exact, combine within 1e-6, the same bits on two calls), timed,
   with the assign kernel's form there (a thread-block cluster a routing
   group: one launch of ``assign_cluster_kernel``), its tile rows and the
   kernels it launches; (b) kimi-k2-1t-a32b at full
   width cut to KIMI_LAYERS layer, the same routing check at E = 384; (c)
   mamba2-130m at full width and depth; (d) recurrentgemma-2b at full width
   and depth, then a decode from a rolling cache of ``window`` slots (the
   ``long_500k`` plan) within 2e-2 of the largest logit of the full cache's;
   then the flash kernel at each family's prefill attention (granite 16/8
   heads D = 64, kimi 64/8 D = 128, recurrentgemma 10/1 D = 256 window
   2048) against its plain version, each error within FLASH_REL_TOL of its
   row's largest output, timed beside SDPA with the same mask; then, for each
   family, a sampled ``generate`` at full width, depth cut to
   CPU_CHECK_LAYERS, on the card and with the same weights on the CPU port:
   the tokens must agree, or differ only at a printed near-tie.

19. scenario ensembles over a device mesh (run after phase 16(d)): phase
   16(a)'s 16 dense lanes and 16(d)'s 16 sparse lanes (``topk=16``, the fused
   kernel) through ``distributed.simulate_many_sharded`` on a 1-rank NCCL
   mesh, counters set to 0 just before each run: bit for bit the phase-16
   lanes over the same rounds, one assign (fused) launch a round with work
   for all lanes, lane-rounds/s.  With more than one card, one spawned rank a
   card (``distributed.run_ranks``): lane-rounds/s of the 16 dense lanes at
   1, 2, ... N ranks, every rank's gathered result equal to the 1-rank run
   (by digest), then 64 lanes (16 a card) on N ranks.

20. the encoder-decoder and VLM families (run after phase 18), bf16, seed-0
   weights, greedy then sampled, counters set to 0 just before the greedy
   run: (a) whisper-small at full width and depth (12 + 12 layers), 4
   utterances of 1500 stub frame embeddings, 32-token prompts, 32 new
   tokens: 36 flash launches a prefill (encoder, causal self, cross) and 12
   a decode step (the cross-attention, Sq = 1 against 1500 frames); (b)
   internvl2-26b at VLM_LAYERS layers, 4 prompts of 4096 tokens with 256
   stub patch embeddings over their first positions, 32 new tokens: one
   flash launch a layer a prefill; prefill tokens/s, decode ms a step, peak
   memory; then the flash kernel against its plain version (FLASH_REL_TOL of
   each row's largest output), timed beside SDPA, at whisper's encoder
   ``[4, 12, 1500, 64]`` and cross-attention (Sq = 32 and 1 against 1500),
   non-causal, and at internvl2's ``[4, 48, 4096, 128]`` on 8 KV heads,
   causal; then a sampled ``generate`` card = CPU at full width, depth cut
   to ENCDEC_CPU_CHECK_LAYERS (internvl2 with 8 patches in 16-token prompts).

21. training (run after phase 20): (a) granite-moe-1b-a400m at full width and
   depth, bf16, seed-0 weights, ``make_train_step`` on ``TokenPipeline``
   batches of 8 x 4096 tokens in 2 microbatches with remat and AdamW
   (warmup cut to 1 step), 6 steps, the counters set to 0 just before:
   tokens/s of steps 2-6, the loss each step (it must fall), peak memory,
   the busy share of one more step, launches a step of the flash forward
   and backward, assign and gate backward kernels (one backward a layer a
   microbatch); a second run of 2 steps from seed 0 with the same losses
   and parameter checksum bit for bit; 2 steps each with 8-bit moments and
   with int8 gradient compression at TRAIN_VARIANT_LAYERS layers; (b) the
   flash backward kernel against its plain version (2^-6 of each row's
   largest gradient) at granite's ``[4, 16, 4096, 64]`` on 8 kv heads,
   deepseek's ``[1, 32, 4096, 128]``, recurrentgemma's ``[1, 10, 4096,
   256]`` on 1 (window 2048) and whisper's encoder ``[4, 12, 1500, 64]``
   (non-causal), timed beside the plain version and SDPA's backward with
   the same mask; the gate backward (1e-6 of each row's largest) at
   granite's ``[32, 512, 32]`` and kimi's ``[32, 512, 384]`` routers, k =
   8; bad inputs raise; (b) takes o and the log-sum-exp from the forward
   kernel (the LSE within 1e-4 of the plain one's) and requires the wgmma
   kernels; (c) every family's smoke config in f32: the loss
   and every gradient on the card (both backward kernels) against the
   port on the CPU.

22. checkpoints and restart-safe training (run after phase 21):
   granite-moe-1b-a400m at full width, depth cut to FT_LAYERS, phase 21's
   configuration; (a) ``ft.train_with_restarts`` for FT_STEPS steps with a
   checkpoint every FT_EVERY, clean and with a failure injected at step
   FT_FAIL, each in a fresh directory (the free disk checked first), the
   counters set to 0 just before: one restart, the replayed losses and the
   final parameters' checksum equal to the clean run's bit for bit, three checkpoints and no ``.tmp``
   left, the flash forward and backward, assign and gate backward kernels
   launched; the bytes a checkpoint, the host copy's ms on the training
   thread, the writer thread's seconds, restore seconds, step ms with a
   save in flight and without, both runs' tokens/s; (c) the faulty run's
   last checkpoint restored with ``shardings=params_shardings(...)`` as
   DTensors on a 1-rank NCCL ``("data", "model")`` mesh, each leaf bit for
   bit the checkpoint's (and on N // 2 x 2 spawned ranks with an even N >= 2
   of cards, each rank's shard its slice); (b) with 8-bit moments and int8
   error feedback: a step, a save, a restore into a fresh state and a step
   equal to two steps without, bit for bit; (d) ``python -m repro_torch.ft
   --small --steps 10 --inject 5``, in a process started beside (c) and
   (b), exits 0 with ``restarts=1``.

23. ``launch/`` (run after phase 22): granite's ``train_4k`` step and
   deepseek's prefill counted on the card against their meta traces, the
   dry-run CLI in two processes beside them.

24. job-parallel simulation (run after phase 23), on a 1-rank NCCL mesh,
   counters and the all-gather count set to 0 just before each run, the
   plain assignments refused: (a) phase 3's run through
   ``distributed.simulate_distributed``, bit for bit phase 3's snapshot,
   one assign launch and two all-gathers a round with work, every call on
   a job block, rounds/s beside phase 3's, peak memory above the inputs
   beside ``simulate``'s over JP_MEM_ROUNDS rounds; (b) phase 4's run the
   same way (the fused kernel with its ``pos`` output); (c) phase 9's
   configuration cut to JP_SUB_ROUNDS rounds, equal to ``simulate`` over
   as many (subsystem states and log included); (d) with two or more
   cards, (a) on 2..N spawned NCCL ranks, each rank's result equal to
   phase 3's, rounds/s over the slowest rank and each rank's peak memory
   (one card: skipped, said so); (e) ``lower_distributed`` at (a)'s shapes
   on a fake JP_DRYRUN_RANKS-rank mesh in a process started beside (c):
   two all-gathers of the bytes the formula gives, CUDA never started;
   (f) the fused kernel's ``pos`` against ``fused_ref`` at the engine shape
   and at the blocks of JP_BLOCKS ranks (site, admit and pos exact), those
   blocks with ``block_admit`` equal to one call, device ms with and
   without ``pos``.

It prints one JSON line of per-kernel numbers, then the card's name and power
limit, then the result line ``{"ok": true, "device": {...}}``.  It needs the
repository's ``src/`` beside it and a CUDA device, and exits non-zero without
either.
"""
from __future__ import annotations

import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

PEAK_HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
PEAK_FP32_OPS_PER_S = 67e12      # H100 SXM, non-tensor-core float32
PEAK_BF16_OPS_PER_S = 989e12     # H100 SXM, dense bf16 tensor cores

ENGINE_J, ENGINE_S = 100_000, 300
ENGINE_K = 16                  # bench_wlcg_scale.py's top-k
ENS_K = 16                     # phase 16's lanes
MANY_SEGMENTS = ENGINE_S * ENGINE_S + 1   # the link sums' segments at S=300
FULL_MAX_ROUNDS = 1200         # depth cut of phase 13: its walltime kills start
                               # ~1150 rounds in (300 simulated seconds)
DENSE_FULL_ROUNDS = 300        # depth cut of phase 3
# rounds in phase 3's profile (the solo path's kernels a round) and in every
# other engine profile: reading the profiler's events back takes ~0.5 ms a
# kernel on the host, and a round launches 800-2800 kernels
PROFILE_ROUNDS = 30
SHORT_PROFILE_ROUNDS = 10
SPARSE_FULL_ROUNDS = 300       # depth cut of phase 4
SUB_FULL_ROUNDS = 600          # depth cut of phase 9
DATA_FULL_ROUNDS = 300         # depth cut of phase 11(a)
DRAIN_ROUNDS = 200             # depth cut of phase 5 (the whole drain takes 10103)
SPARSE_DRAIN_ROUNDS = 200      # depth cut of phase 6 (topk=8 binds by round 150)
CROSS_ROUNDS = 300             # depth cut of phase 10
ASSIGN_CASES = [  # (N, E, k, block_n)
    (ENGINE_J, ENGINE_S, 1, 256),   # the engine shape
    (64, 8, 1, 32),
    (33, 7, 3, 16),
    (512, 32, 8, 128),
    (256, 384, 8, 256),
    (1000, 301, 1, 256),            # E % 4 != 0: rows not 16-byte aligned
    (2000, 512, 8, 256),            # the widest MoE router, k = 8
    (600, 700, 2, 128),             # E above the 512 bins kept in registers
    (5000, 64, 4, 300),             # block_n dividing neither N nor the 256-row tile
]
JOB_FIELDS = ("state", "site", "retries", "will_fail", "t_assign", "t_start", "t_finish")
SNAPSHOTS: dict = {}           # phases 3's and 4's results, which phase 24 must equal
SITE_FIELDS = ("free_cores", "free_memory", "n_assigned", "n_finished", "n_failed")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median device milliseconds of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


PROFILE_FILLER = (256, 2048, 8192)   # cheap launches ahead of a profile's timed calls, by try
TIMED_RANGE = "device_ms: timed calls"


def device_ms(fn, kernel_names, iters: int, forbid=(), counts=None, per_call=None) -> dict:
    """Device milliseconds per call of ``fn`` for each named kernel, from
    ``torch.profiler`` over ``iters`` calls: the kernels' own time, without
    the host time between launches that CUDA events around a short call
    would include.  Fails if a kernel whose name holds one of ``forbid`` ran.
    ``counts``, when given, receives each named kernel's launches per call;
    ``per_call``, when given, is the launches of each named kernel a call
    must make.

    Late in a long process the profiler has kept no device record for the
    first few dozen launches of a profile (48 of 650 in phase 18, however
    long the window first stayed idle; once every one of 650).  So a profile
    starts with ``PROFILE_FILLER`` cheap launches, and only the launches made
    inside the timed calls' range count: each must have its device record,
    else the profile is taken again with more filler, and the run fails after
    the last try.  A recorded launch carries its own start and end from the
    device, so a complete profile cannot read a kernel short.  CUDA events
    recorded around the same timed calls bound the named kernels' time a
    call from above: more fails the run.  (A time taken by other calls, at
    another moment, is no bound: the card's clock moves between them.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    filler = torch.zeros(1, device=torch.device("cuda", torch.cuda.current_device()))
    for n_fill in PROFILE_FILLER:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_fill):
                filler.add_(1)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with record_function(TIMED_RANGE):
                start.record()
                for _ in range(iters):
                    fn()
                end.record()
                torch.cuda.synchronize()
        for e in prof.key_averages():
            bad = [f for f in forbid if f in e.key]
            check(not bad, f"the profiled calls ran {e.key[:120]}")
        launches = timed_launches(prof)
        lost = [i for i, (name, _) in enumerate(launches) if name is None]
        if not lost:
            break
        print(f"[profile] after {n_fill} filler launches, {len(lost)} of the timed calls' "
              f"{len(launches)} launches have no device record (launches {lost[:8]}"
              f"{'...' if len(lost) > 8 else ''})")
    check(launches and not lost, f"{len(lost)} of {len(launches)} launches of the timed calls "
                                 f"have no device record in each of {len(PROFILE_FILLER)} profiles")
    seen = {name: sum(1 for k, _ in launches if name in k) for name in kernel_names}
    total = {name: sum(t for k, t in launches if name in k) for name in kernel_names}
    check(all(n > 0 and (per_call is None or n == per_call * iters) for n in seen.values()),
          f"the timed calls launched {json.dumps(seen)} of the named kernels in {iters} calls")
    if counts is not None:
        counts.update({name: n / iters for name, n in seen.items()})
    ms = {name: t / iters for name, t in total.items()}
    window_ms = start.elapsed_time(end) / iters
    check(sum(ms.values()) <= 1.1 * window_ms + 2e-3,
          f"the profiler put {json.dumps(ms)} ms of device time in a call that takes "
          f"{window_ms:.4f} ms between CUDA events around the same calls")
    return ms


def timed_launches(prof) -> list:
    """Each kernel launch (``cudaLaunchKernel``, ``cudaLaunchCooperativeKernel``,
    ...) made on the host inside ``TIMED_RANGE``, in order,
    as (kernel name, device ms) from its device record, found by the
    launch's correlation id, or (None, 0.0) where the profile has none."""
    events = prof.profiler.kineto_results.events()
    on_device = [e for e in events if str(e.device_type()).endswith("CUDA")]
    mark = next(e for e in events
                if e.name() == TIMED_RANGE and not str(e.device_type()).endswith("CUDA"))
    lo, hi = mark.start_ns(), mark.start_ns() + mark.duration_ns()
    ran = {e.correlation_id(): e for e in on_device if e.name() != TIMED_RANGE}
    launches = sorted((e for e in events if "Launch" in e.name() and "Kernel" in e.name()
                       and lo <= e.start_ns() <= hi), key=lambda e: e.start_ns())
    return [(ran[e.correlation_id()].name(), ran[e.correlation_id()].duration_ns() / 1e6)
            if e.correlation_id() in ran else (None, 0.0) for e in launches]


def kernel_label(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name:
    ``_ZN..22flash_fwd_kernel_wgmmaILi128EEEv..`` gives
    ``flash_fwd_kernel_wgmma<Li128>``."""
    rest, name = mangled[3:] if mangled.startswith("_ZN") else mangled[2:], mangled
    while (m := re.match(r"(\d+)", rest)):  # length-prefixed scopes, then the name
        n = int(m.group(1))
        name, rest = rest[len(m.group(1)):len(m.group(1)) + n], rest[len(m.group(1)) + n:]
    args = re.match(r"I(\w*?)EE", rest)
    return f"{name}<{args.group(1)}>" if args else name


def phase_build() -> None:
    from repro_torch import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"[build] {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"wall={time.perf_counter() - t0:.2f}s")
    for name in _build.SOURCES:
        kernel = ""
        for line in _build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = kernel_label(m.group(1))
            elif "registers" in line or "spill" in line:
                print(f"[build] {name} {kernel}: {line.replace('ptxas info    :', '').strip()}")


def assign_inputs(N, E, seed, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(N, E)).astype(np.float32)
    scores[rng.random((N, E)) < 0.1] = -1e30     # about 10% infeasible
    sizes = rng.choice([1.0, 8.0] if N == ENGINE_J else [1.0, 2.0, 8.0], size=N)
    caps = rng.uniform(2, 40, size=E) * (N / max(E, 1)) if N == ENGINE_J else \
        rng.uniform(2, 40, size=E)
    return (torch.from_numpy(scores).to(device),
            torch.from_numpy(sizes.astype(np.float32)).to(device),
            torch.from_numpy(caps.astype(np.float32)).to(device))


SEGSUM_CASES = [  # (id mix, J, S, F, dtype, id dtype)
    ("uniform", ENGINE_J, ENGINE_S, 1, "float32", "int32"),    # the engine shape
    ("uniform", ENGINE_J, ENGINE_S, 3, "int32", "int32"),      # stacked int columns
    ("padding95", ENGINE_J, ENGINE_S, 1, "float32", "int32"),
    ("padding95", ENGINE_J, ENGINE_S, 2, "int32", "int64"),
    ("one_segment", ENGINE_J, ENGINE_S, 1, "float32", "int32"),
    ("out_of_range", 10_007, 37, 4, "float32", "int64"),
    ("uniform", 100_003, 301, 4, "float32", "int32"),          # J not a multiple of the chunk
    ("uniform", 0, 5, 2, "float32", "int32"),                  # J = 0
    ("signed_zeros", 3000, 20, 3, "float32", "int32"),
    # S*S + 1 segments at S=300 (the link sums of the network and transfers
    # subsystems): past the one-launch cap, in windows (f32) or added directly (i32)
    *[(mix, ENGINE_J, MANY_SEGMENTS, F, dtype, "int32") for mix in ("uniform", "padding95")
      for F in (1, 3) for dtype in ("float32", "int32")],
]
# the assign kernel's launches in its rows form (the engine's shapes), and the
# kernels of its routing forms (the MoE router's groups): one launch of
# assign_cluster_kernel a call, or assign_tile_kernel with the base and place
# launches where a group is too large for one cluster
ASSIGN_KERNELS = ("assign_rows_kernel", "assign_base_kernel", "assign_place_kernel")
ROUTE_KERNELS = ("assign_cluster_kernel", "assign_tile_kernel")


def segsum_inputs(mix, J, S, F, dtype, id_dtype, seed):
    """Values ``[J]`` (F = 1) or ``[J, F]`` and ids on the CPU.  Id ``S`` is
    the padding segment; ``padding95`` gives it 95% of rows, ``one_segment``
    gives segment S // 2 99.9%, ``out_of_range`` draws ids in [-3S, 3S), and
    ``signed_zeros`` leaves segments 0, 4, ... empty and fills 1, 5, ... with
    -0.0 rows only (their sums are +0.0)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, S + 1, J)
    if mix == "padding95":
        ids = np.where(rng.random(J) < 0.95, S, ids)
    elif mix == "one_segment":
        ids = np.where(rng.random(J) < 0.999, S // 2, ids)
    elif mix == "out_of_range":
        ids = rng.integers(-3 * S, 3 * S, J)
    if dtype == "float32":
        v = rng.lognormal(1.0, 1.0, (J, F)).astype(np.float32)
        if mix == "signed_zeros":
            ids = np.where(ids % 4 == 0, S, ids)
            v[ids % 4 == 1] = -0.0
    else:
        v = rng.integers(-(2**20), 2**20, (J, F)).astype(np.int32)
    return (torch.from_numpy(v if F > 1 else v[:, 0].copy()),
            torch.from_numpy(ids).to(getattr(torch, id_dtype)))


def phase_kernels(device) -> dict:
    import torch

    from repro_torch.kernels.assign.assign_cuda import assign_cuda
    from repro_torch.kernels.assign.ref import assign_ref
    from repro_torch.kernels.segment_sum.ops import segment_sum_ref
    from repro_torch.kernels.segment_sum.segment_sum_cuda import segment_sum_cuda

    rows = {}
    gate_err = 0.0
    for N, E, k, bn in ASSIGN_CASES:
        scores, sizes, caps = assign_inputs(N, E, N * 31 + E, device)
        want = assign_ref(scores, sizes, caps, k=k, block_n=bn)
        got = assign_cuda(scores, sizes, caps, k=k, block_n=bn)
        torch.cuda.synchronize()
        for name, w, g in zip(("idx", "admit", "pos"), (want[0], want[2], want[3]),
                              (got[0], got[2], got[3])):
            bad = int((w != g).sum())
            check(bad == 0, f"assign {N}x{E} k={k} bn={bn}: {bad} {name} entries differ")
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
        err = float((got[1] - want[1]).abs().max()) if got[1].numel() else 0.0
        gate_err = max(gate_err, err)
        print(f"[kernels] assign N={N} E={E} k={k} block_n={bn}: idx/admit/pos exact, "
              f"gate max_abs_err={err:.3e}, admitted={int(got[2].sum())}")

    N, E = ENGINE_J, ENGINE_S
    scores, sizes, caps = assign_inputs(N, E, N * 31 + E, device)
    call_ms = cuda_ms(lambda: assign_cuda(scores, sizes, caps, k=1), iters=200)
    per_call = {}
    parts = device_ms(lambda: assign_cuda(scores, sizes, caps, k=1), ASSIGN_KERNELS, iters=200,
                      counts=per_call, per_call=1)
    ms = sum(parts.values())
    plain_ms = cuda_ms(lambda: assign_ref(scores, sizes, caps, k=1), iters=5)
    bytes_moved = N * E * 4 + N * 4 + E * 4 + N * (4 + 4 + 1 + 4)
    ops = N * E * 7          # mask, max, sub, exp, add, argmax compare and select
    bound_ms = max(bytes_moved / PEAK_HBM_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S) * 1e3
    print(f"[kernels] assign at the engine shape N={N} E={E} k=1: kernel {ms:.4f} ms of device "
          f"time ({', '.join(f'{k} {v:.4f}' for k, v in parts.items())}; launches a call "
          f"{json.dumps(per_call)}), {call_ms:.4f} ms a call between CUDA events; "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), "
          "library: no single PyTorch call computes this function")
    rows["assign"] = dict(
        name="assign", route="cuda", source="src/repro_torch/kernels/assign/csrc/assign.cu",
        replaces="src/repro/kernels/assign/assign.py:31", launches=None,
        max_abs_err=gate_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=None, cuda_ms=call_ms, device_ms=ms,
        kernels_per_call=sum(per_call.values()),
        lanes=phase_assign_lanes(device),
    )

    # the segment sum: bit for bit the CPU's row-order sums on the engine's
    # id mixes, then timed at the engine shape (J rows, S sites plus the
    # padding segment S) on a uniform mix and on one where 95% of rows pad
    err = 0.0
    for mix, J, S, F, dtype, id_dtype in SEGSUM_CASES:
        values, seg = segsum_inputs(mix, J, S, F, dtype, id_dtype, J + S + F)
        want = segment_sum_ref(values, seg, S)          # row-order sums on the CPU
        got = segment_sum_cuda(values.to(device), seg.to(device), S).cpu()
        bits = (lambda t: t.view(torch.int32)) if dtype == "float32" else (lambda t: t)
        bad = int((bits(want) != bits(got)).sum())
        check(bad == 0, f"segment_sum {mix} J={J} S={S} F={F} {dtype} {id_dtype}: {bad} sums "
                        "differ from row order")
        if mix == "uniform" and J == ENGINE_J and S == ENGINE_S:
            on_card = segment_sum_ref(values.to(device), seg.to(device), S).cpu()
            err = max(err, float((got.double() - on_card.double()).abs().max()))
    print(f"[kernels] segment_sum: {len(SEGSUM_CASES)} id mixes bit for bit the CPU's row-order "
          f"sums; max_abs_err of the card's index_add_ atomics against them {err:.3e}")
    timed = {}
    for mix in ("uniform", "padding95"):
        vals, seg_d = (t.to(device) for t in segsum_inputs(mix, ENGINE_J, ENGINE_S, 1,
                                                            "float32", "int32", 1))
        call = cuda_ms(lambda: segment_sum_cuda(vals, seg_d, ENGINE_S), iters=200)
        per_call = {}
        dev = device_ms(lambda: segment_sum_cuda(vals, seg_d, ENGINE_S), ("segment_sum_kernel",),
                        iters=200, counts=per_call)["segment_sum_kernel"]
        plain = cuda_ms(lambda: segment_sum_ref(vals, seg_d, ENGINE_S), iters=200)
        idx64 = seg_d.long()
        acc = torch.zeros(ENGINE_S + 1, device=device)
        library = cuda_ms(lambda: acc.index_add_(0, idx64, vals), iters=200)
        timed[mix] = dict(cuda_ms=call, device_ms=dev, plain_ms=plain, library_ms=library,
                          kernels_per_call=per_call["segment_sum_kernel"])
        print(f"[kernels] segment_sum {mix} J={ENGINE_J} S={ENGINE_S} f32: {call:.4f} ms a call "
              f"between CUDA events, {dev:.4f} ms device time, "
              f"{per_call['segment_sum_kernel']:g} launches a call; plain {plain:.4f} ms, "
              f"index_add_ {library:.4f} ms")
    many = {}
    for dtype, kernel in (("float32", "segment_sum_kernel"), ("int32", "segment_add_kernel")):
        vals, seg_d = (t.to(device) for t in segsum_inputs("uniform", ENGINE_J, MANY_SEGMENTS, 1,
                                                            dtype, "int32", 2))
        call = cuda_ms(lambda: segment_sum_cuda(vals, seg_d, MANY_SEGMENTS), iters=50)
        per_call = {}
        dev = device_ms(lambda: segment_sum_cuda(vals, seg_d, MANY_SEGMENTS), (kernel,), iters=50,
                        counts=per_call)[kernel]
        plain = cuda_ms(lambda: segment_sum_ref(vals, seg_d, MANY_SEGMENTS), iters=50)
        idx64 = seg_d.long()
        acc = torch.zeros(MANY_SEGMENTS + 1, dtype=vals.dtype, device=device)
        library = cuda_ms(lambda: acc.index_add_(0, idx64, vals), iters=50)
        # the link sums' shape: J values and ids read once, S*S + 1 sums written
        many_bytes = ENGINE_J * (4 + 4) + MANY_SEGMENTS * 4
        many_bound = max(many_bytes / PEAK_HBM_BYTES_PER_S, ENGINE_J / PEAK_FP32_OPS_PER_S) * 1e3
        many[dtype] = dict(cuda_ms=call, device_ms=dev, launches_per_call=per_call[kernel],
                           plain_ms=plain, library_ms=library, bound_ms=many_bound,
                           bound_by="bytes")
        print(f"[kernels] segment_sum uniform J={ENGINE_J} S={MANY_SEGMENTS} {dtype}: {call:.4f} "
              f"ms a call between CUDA events, {dev:.4f} ms device time in {per_call[kernel]:g} "
              f"launches of {kernel} a call; plain {plain:.4f} ms, index_add_ {library:.4f} ms; "
              f"bound {many_bound:.6f} ms (bytes, {many_bytes} B)")
    bytes_moved = ENGINE_J * (4 + 4) + ENGINE_S * 4
    bound_ms = max(bytes_moved / PEAK_HBM_BYTES_PER_S, ENGINE_J / PEAK_FP32_OPS_PER_S) * 1e3
    print(f"[kernels] segment_sum bound {bound_ms:.6f} ms (bytes, {bytes_moved} B)")
    u = timed["uniform"]
    rows["segment_sum"] = dict(
        name="segment_sum", route="cuda",
        source="src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu",
        replaces="src/repro/core/engine.py:142", launches=None, max_abs_err=err,
        ms=u["device_ms"], plain_ms=u["plain_ms"], bound_ms=bound_ms, bound_by="bytes",
        library_ms=u["library_ms"], cuda_ms=u["cuda_ms"], device_ms=u["device_ms"],
        kernels_per_call=u["kernels_per_call"], padding95=timed["padding95"],
        many_segments=many,
    )
    return rows


def assign_lane_inputs(K, N, E, seed, device):
    """``assign_inputs`` for K lanes, drawn on the card (1.92 GB of scores
    at the ensemble shape)."""
    import torch

    g = torch.Generator(device).manual_seed(seed)
    scores = torch.randn((K, N, E), generator=g, device=device)
    scores.masked_fill_(torch.rand((K, N, E), generator=g, device=device) < 0.1, -1e30)
    sizes = torch.where(torch.rand((K, N), generator=g, device=device) < 0.5, 1.0, 8.0)
    caps = (2 + 38 * torch.rand((K, E), generator=g, device=device)) * (N / E)
    return scores, sizes, caps


def phase_assign_lanes(device) -> dict:
    """The assign kernel with a lane axis: one call for K problems, against
    its plain version (K unbatched plain calls) and against K unbatched
    launches, at K = 3 and at the ensemble shape [16, 100000, 300], where it
    is timed."""
    import torch

    from repro_torch.kernels.assign.assign_cuda import assign_cuda
    from repro_torch.kernels.assign.ref import assign_ref

    err = 0.0
    for K, N, E, k, bn in ((3, 777, 64, 3, 100), (3, 5000, 301, 1, 256),
                           (ENS_K, ENGINE_J, ENGINE_S, 1, 256)):
        scores, sizes, caps = assign_lane_inputs(K, N, E, K * N + E, device)
        got = assign_cuda(scores, sizes, caps, k=k, block_n=bn)
        want = assign_ref(scores, sizes, caps, k=k, block_n=bn)
        torch.cuda.synchronize()
        for name, w, g in zip(("idx", "admit", "pos"), (want[0], want[2], want[3]),
                              (got[0], got[2], got[3])):
            bad = int((w != g).sum())
            check(bad == 0, f"assign lanes K={K} {N}x{E} k={k}: {bad} {name} entries differ")
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
        err = max(err, float((got[1] - want[1]).abs().max()))
        for i in range(K):
            one = assign_cuda(scores[i], sizes[i], caps[i], k=k, block_n=bn)
            check(all(torch.equal(a, b[i]) for a, b in zip(one, got)),
                  f"assign lanes K={K}: lane {i} differs from its unbatched launch")
        print(f"[kernels] assign K={K} lanes N={N} E={E} k={k} block_n={bn}: idx/admit/pos "
              f"exact against the plain version and against {K} unbatched launches, gate "
              f"max_abs_err={err:.3e}, admitted={int(got[2].sum())}")
    call_ms = cuda_ms(lambda: assign_cuda(scores, sizes, caps, k=1), iters=50)
    per_call = {}
    parts = device_ms(lambda: assign_cuda(scores, sizes, caps, k=1), ASSIGN_KERNELS, iters=20,
                      counts=per_call, per_call=1)
    ms = sum(parts.values())
    plain_ms = cuda_ms(lambda: assign_ref(scores, sizes, caps, k=1), iters=2, warmup=1)
    unbatched_ms = cuda_ms(lambda: [assign_cuda(scores[i], sizes[i], caps[i], k=1)
                                    for i in range(ENS_K)], iters=20)
    N, E = ENGINE_J, ENGINE_S
    bytes_moved = ENS_K * (N * E * 4 + N * 4 + E * 4 + N * (4 + 4 + 1 + 4))
    bound_ms = max(bytes_moved / PEAK_HBM_BYTES_PER_S,
                   ENS_K * N * E * 7 / PEAK_FP32_OPS_PER_S) * 1e3
    print(f"[kernels] assign at the ensemble shape [{ENS_K}, {N}, {E}] k=1: {ms:.4f} ms of "
          f"device time ({', '.join(f'{k} {v:.4f}' for k, v in parts.items())}; launches a "
          f"call {json.dumps(per_call)}), {call_ms:.4f} ms a call between CUDA events; "
          f"{ENS_K} unbatched calls {unbatched_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms (bytes, {bytes_moved} B)")
    return dict(shape=[ENS_K, N, E], max_abs_err=err, ms=ms, device_ms=ms, cuda_ms=call_ms,
                unbatched_ms=unbatched_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None, kernels_per_call=sum(per_call.values()))


def fused_inputs(N, E, K, seed, device, kind: str = "random"):
    """Candidate rows of sorted distinct site ids, each with a random number
    of sentinel (``E``) pads; integral sizes; caps scaled as in
    ``assign_inputs``.  ``kind``: ``sentinel_rows`` makes half the rows all
    sentinels, ``sentinel_tile`` rows 256..511 (a whole tile of the kernel),
    ``one_site`` gives every row site 3 as its only candidate (the longest
    chain of claims) with room for half of them, and ``boundary`` gives
    every row size 8 against caps that are multiples of 8, so that admitted
    rows end exactly at their cap."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(N, K)).astype(np.float32)
    if N * E <= 30_000_000:
        cand = np.argsort(rng.random((N, E)), axis=1)[:, :K]
    else:
        cand = np.stack([rng.choice(E, K, replace=False) for _ in range(N)])
    filled = rng.integers(0, K + 1, N)
    cand = np.where(np.arange(K)[None, :] < filled[:, None], cand, E)
    if kind == "sentinel_rows":
        cand[rng.random(N) < 0.5] = E
    elif kind == "sentinel_tile":
        cand[256:512] = E
    elif kind == "one_site":
        cand[:] = E
        cand[:, 0] = 3
    cand = np.sort(cand, axis=1).astype(np.int32)
    engine = N == ENGINE_J
    sizes = rng.choice([1.0, 8.0] if engine else [1.0, 2.0, 8.0], size=N)
    caps = rng.uniform(2, 40, size=E) * (N / E if engine else 1.0)
    if kind == "one_site":
        caps[3] = sizes.sum() // 2
    elif kind == "boundary":
        sizes[:] = 8.0
        caps = 8.0 * rng.integers(0, 2 * N // E + 2, size=E)
    return (torch.from_numpy(scores).to(device), torch.from_numpy(cand).to(device),
            torch.from_numpy(sizes.astype(np.float32)).to(device),
            torch.from_numpy(caps.astype(np.float32)).to(device))


FUSED_CASES = [  # (N, E, K, block_n, seed, kind)
    (ENGINE_J, ENGINE_S, ENGINE_K, 256, 0, "random"),  # the engine shape
    *[(97, 7, 4, 32, seed, "random") for seed in range(5)],
    (97, 7, 4, 32, 5, "sentinel_rows"),             # half the rows all-sentinel
    (1000, 300, 48, 256, 6, "random"),              # K above a warp
    (2048, 50, 50, 256, 7, "random"),               # topk = S at the drain's S
    (1, 7, 4, 256, 8, "random"),                    # N = 1
    (1000, 300, 16, 256, 9, "random"),              # N not a multiple of the 256-row tile
    (5000, 300, 16, 256, 10, "one_site"),           # every row claims one site
    (3000, 300, 16, 256, 11, "sentinel_tile"),      # a whole tile of sentinel rows
    (3000, 50, 1, 256, 12, "random"),               # K = 1: one lane a row
    (3000, 50, 3, 256, 13, "random"),               # K = 3: no 16-byte loads
    (3000, 50, 8, 256, 14, "random"),               # K = 8: two lanes a row
    (20000, 512, 16, 256, 15, "random"),            # E = 512
    (5000, 300, 16, 256, 16, "boundary"),           # sizes 8 against caps at the boundary
    (3000, 6000, 8, 256, 18, "random"),             # bases and caps past shared memory
    (3000, 20000, 8, 256, 17, "random"),            # sites past the shared-memory totals
]
FUSED_KERNELS = ("fused_rows_kernel", "fused_base_kernel", "fused_place_kernel")


def phase_fused_kernel(device) -> dict:
    import torch

    from repro_torch.kernels.assign.fused_cuda import fused_assign_cuda
    from repro_torch.kernels.assign.fused_ref import fused_assign_ref

    for N, E, K, bn, seed, kind in FUSED_CASES:
        args = fused_inputs(N, E, K, seed, device, kind)
        want = fused_assign_ref(*args, block_n=bn)
        got = fused_assign_cuda(*args)
        torch.cuda.synchronize()
        for name, w, g in zip(("site", "admit"), want, got):
            bad = int((w != g).sum())
            check(bad == 0, f"fused N={N} E={E} K={K} seed={seed} {kind}: {bad} {name} entries "
                            "differ")
        print(f"[kernels] fused N={N} E={E} K={K} block_n={bn} seed={seed} {kind}: site/admit "
              f"exact, picked={int((got[0] >= 0).sum())}, admitted={int(got[1].sum())}")

    N, E, K = ENGINE_J, ENGINE_S, ENGINE_K
    args = fused_inputs(N, E, K, 0, device)
    call_ms = cuda_ms(lambda: fused_assign_cuda(*args), iters=200)
    per_call = {}
    parts = device_ms(lambda: fused_assign_cuda(*args), FUSED_KERNELS, iters=200,
                      counts=per_call, per_call=1)
    ms = sum(parts.values())
    plain_ms = cuda_ms(lambda: fused_assign_ref(*args), iters=5)
    bytes_moved = N * K * (4 + 4) + N * 4 + E * 4 + N * (4 + 1)
    ops = N * K * 3          # validity test, select, compare per slot
    bound_ms = max(bytes_moved / PEAK_HBM_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S) * 1e3
    print(f"[kernels] fused at the engine shape N={N} K={K} E={E}: kernel {ms:.4f} ms of device "
          f"time ({', '.join(f'{k} {v:.4f}' for k, v in parts.items())}; launches a call "
          f"{json.dumps(per_call)}), {call_ms:.4f} ms a call between CUDA events (host launch "
          f"work included); plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes, "
          f"{bytes_moved} B), library: no single PyTorch call computes this function")
    return dict(
        name="fused_assign", route="cuda",
        source="src/repro_torch/kernels/assign/csrc/fused.cu",
        replaces="src/repro/kernels/assign/fused.py:38", launches=None, max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=None,
        cuda_ms=call_ms, device_ms=ms, kernels_per_call=sum(per_call.values()),
        lanes=phase_fused_lanes(device),
    )


def fused_lane_inputs(K, N, E, Kc, seed, device):
    """``fused_inputs`` for K lanes, drawn on the card: candidate rows of
    sorted distinct site ids with a random number of sentinel pads, sizes 1
    or 8, integral caps scaled to the rows a site sees."""
    import torch

    g = torch.Generator(device).manual_seed(seed)
    scores = torch.randn((K, N, Kc), generator=g, device=device)
    cand = torch.rand((K, N, E), generator=g, device=device).argsort(-1)[..., :Kc]
    filled = torch.randint(0, Kc + 1, (K, N, 1), generator=g, device=device)
    cand = torch.where(torch.arange(Kc, device=device) < filled, cand, E).sort(-1).values
    sizes = torch.where(torch.rand((K, N), generator=g, device=device) < 0.5, 1.0, 8.0)
    caps = ((2 + 38 * torch.rand((K, E), generator=g, device=device)) * max(N / E, 1)).floor()
    return scores, cand.int().contiguous(), sizes, caps


FUSED_LANE_CASES = [  # (K, N, E, Kc)
    (3, 777, 50, 8),                          # ragged tiles, two lanes a row
    (3, 3000, 2000, 8),                       # sites past the shared-memory table
    (ENS_K, ENGINE_J, ENGINE_S, ENGINE_K),    # phase 16(d)'s shape
]


def phase_fused_lanes(device) -> dict:
    """The fused kernel with a lane axis: one call for K problems against
    its plain version (K unbatched plain calls) and against K unbatched
    launches, at K = 3 and at phase 16(d)'s shape [16, 100000, 16], E = 300,
    where it is timed against its bound and 16 unbatched launches."""
    import torch

    from repro_torch.kernels.assign.fused_cuda import fused_assign_cuda
    from repro_torch.kernels.assign.fused_ref import fused_assign_ref

    for K, N, E, Kc in FUSED_LANE_CASES:
        args = fused_lane_inputs(K, N, E, Kc, K * N + E, device)
        want = fused_assign_ref(*args)
        got = fused_assign_cuda(*args)
        torch.cuda.synchronize()
        for name, w, g in zip(("site", "admit"), want, got):
            bad = int((w != g).sum())
            check(bad == 0, f"fused lanes K={K} N={N} E={E} Kc={Kc}: {bad} {name} entries "
                            "differ")
        for i in range(K):
            one = fused_assign_cuda(*(a[i] for a in args))
            check(all(torch.equal(a, b[i]) for a, b in zip(one, got)),
                  f"fused lanes K={K}: lane {i} differs from its unbatched launch")
        print(f"[kernels] fused K={K} lanes N={N} E={E} Kc={Kc}: site/admit exact against the "
              f"plain version and against {K} unbatched launches, picked="
              f"{int((got[0] >= 0).sum())}, admitted={int(got[1].sum())}")
    K, N, E, Kc = FUSED_LANE_CASES[-1]
    call_ms = cuda_ms(lambda: fused_assign_cuda(*args), iters=100)
    per_call = {}
    parts = device_ms(lambda: fused_assign_cuda(*args), FUSED_KERNELS, iters=50,
                      counts=per_call, per_call=1)
    ms = sum(parts.values())
    plain_ms = cuda_ms(lambda: fused_assign_ref(*args), iters=2, warmup=1)

    def unbatched():
        return [fused_assign_cuda(*(a[i] for a in args)) for i in range(K)]

    unbatched_ms = cuda_ms(unbatched, iters=20)
    unbatched_device_ms = sum(device_ms(unbatched, FUSED_KERNELS, iters=10, per_call=K).values())
    bytes_moved = K * (N * Kc * (4 + 4) + N * 4 + E * 4 + N * (4 + 1))
    bound_ms = max(bytes_moved / PEAK_HBM_BYTES_PER_S,
                   K * N * Kc * 3 / PEAK_FP32_OPS_PER_S) * 1e3
    print(f"[kernels] fused at the ensemble shape [{K}, {N}, {Kc}] E={E}: {ms:.4f} ms of device "
          f"time ({', '.join(f'{k} {v:.4f}' for k, v in parts.items())}; launches a call "
          f"{json.dumps(per_call)}), {call_ms:.4f} ms a call between CUDA events; {K} unbatched "
          f"calls {unbatched_ms:.4f} ms ({unbatched_device_ms:.4f} ms of device time); plain "
          f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms (bytes, {bytes_moved} B)")
    return dict(shape=[K, N, Kc], E=E, max_abs_err=0.0, ms=ms, device_ms=ms, cuda_ms=call_ms,
                unbatched_ms=unbatched_ms, unbatched_device_ms=unbatched_device_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=None,
                kernels_per_call=sum(per_call.values()))


FLASH_CASES = [  # (B, Hq, Hkv, S, Skv, D, causal, window, dtype)
    (1, 4, 4, 256, 256, 64, True, 0, "float32"),    # tests/test_kernels.py's six
    (2, 8, 2, 128, 128, 64, True, 0, "float32"),
    (1, 4, 1, 384, 384, 128, True, 0, "float32"),
    (1, 4, 2, 256, 256, 64, True, 64, "float32"),
    (1, 8, 8, 256, 256, 64, True, 0, "bfloat16"),
    (2, 4, 2, 200, 200, 64, True, 96, "bfloat16"),
    (1, 2, 2, 100, 100, 32, False, 0, "float32"),   # non-causal, ragged Skv
    (2, 4, 2, 100, 300, 64, True, 0, "float32"),    # q right-aligned, Skv > S
    (1, 2, 1, 70, 70, 16, True, 0, "bfloat16"),     # mma.sync path, smallest D
    (1, 2, 2, 100, 100, 96, False, 0, "bfloat16"),  # mma.sync path, non-causal ragged
    (1, 4, 2, 130, 200, 192, True, 64, "bfloat16"),  # bf16 on the CUDA-core path (D > 128)
    # the wgmma/TMA path: ragged 128-row tails, right-aligned q, tiles wholly
    # inside a window, qwen2.5-32b's GQA, no causality, D = 64
    (1, 4, 2, 1000, 1000, 128, True, 0, "bfloat16"),
    (2, 4, 2, 300, 1000, 128, True, 0, "bfloat16"),
    (1, 4, 4, 1024, 1024, 128, True, 256, "bfloat16"),
    (1, 40, 8, 2048, 2048, 128, True, 0, "bfloat16"),
    (2, 4, 2, 200, 200, 128, False, 0, "bfloat16"),
    (1, 4, 2, 1000, 1000, 64, True, 0, "bfloat16"),
    (1, 4, 1, 700, 900, 64, True, 200, "bfloat16"),
    # the wgmma/TMA path at D = 256 (64-key tiles): ragged tiles, right-aligned
    # q, recurrentgemma's window on one KV head, no causality
    (1, 4, 2, 300, 300, 256, True, 0, "bfloat16"),
    (2, 4, 2, 100, 333, 256, True, 0, "bfloat16"),
    (1, 10, 1, 1000, 1000, 256, True, 200, "bfloat16"),
    (1, 4, 4, 200, 200, 256, False, 0, "bfloat16"),
    # more queries than keys under causality: the first rows keep no key
    (1, 2, 2, 100, 60, 64, True, 0, "bfloat16"),
    (1, 2, 1, 80, 50, 32, True, 0, "bfloat16"),
    (1, 2, 1, 80, 50, 32, True, 0, "float32"),
    (4, 32, 32, 4096, 4096, 128, True, 0, "bfloat16"),  # deepseek-7b prefill (phase 8)
]
FLASH_LSE_TOL = 1e-4  # the log-sum-exp against the plain one's (f32 row sums in another order)
FLASH_KERNEL = "flash_fwd_kernel_wgmma"  # the serving shape's kernel (profiler name)
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = "deepseek-7b", 4, 4096, 32


def flash_inputs(B, Hq, Hkv, S, Skv, D, dtype, seed, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    shapes = ((B, Hq, S, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))
    return tuple(torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
                 .to(device=device, dtype=getattr(torch, dtype)) for sh in shapes)


def phase_flash_kernel(device) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_cuda as flash_mod
    from repro_torch.kernels.flash_attention import flash_flops
    from repro_torch.kernels.flash_attention.flash_attention_cuda import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref

    worst = {}
    for B, Hq, Hkv, S, Skv, D, causal, window, dtype in FLASH_CASES:
        q, k, v = flash_inputs(B, Hq, Hkv, S, Skv, D, dtype, B * 131 + S, device)
        want, want_lse = attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
        got = flash_attention_cuda(q, k, v, causal=causal, window=window)
        with_lse, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                             return_lse=True)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        label = f"flash {B, Hq, Hkv, S, Skv, D} causal={causal} window={window} {dtype}"
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{label}: dtype or shape differs from the plain version")
        check(err <= tol, f"{label}: max_abs_err {err:.3e} > {tol}")
        check(torch.equal(with_lse, got), f"{label}: the log-sum-exp store changed the output")
        empty = torch.isinf(want_lse)
        check(torch.equal(torch.isinf(lse), empty) and bool((lse[empty] > 0).all()),
              f"{label}: rows that keep no key must have log-sum-exp +inf")
        lse_err = float((lse[~empty] - want_lse[~empty]).abs().max()) if bool((~empty).any()) \
            else 0.0
        check(lse_err <= FLASH_LSE_TOL, f"{label}: log-sum-exp error {lse_err:.3e}")
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        print(f"[flash] B={B} Hq={Hq} Hkv={Hkv} S={S} Skv={Skv} D={D} causal={causal} "
              f"window={window} {dtype}: max_abs_err={err:.3e} (tol {tol}); log-sum-exp "
              f"{lse_err:.3e} (tol {FLASH_LSE_TOL}), {int(empty.sum())} rows without a key")
        del q, k, v, want, got, with_lse, lse, want_lse

    B, Hq, Hkv, S, Skv, D, causal, window, dtype = FLASH_CASES[-1]
    q, k, v = flash_inputs(B, Hq, Hkv, S, Skv, D, dtype, 0, device)
    smem = flash_mod._lib().flash_attention_wgmma_smem_bytes(D)
    print(f"[flash] {FLASH_KERNEL} at D={D}: {smem} B of dynamic shared memory a CTA of 384 "
          "threads (one CTA an SM)")
    # the profiled launches must be the wgmma kernel, not the mma.sync or f32 one
    call_ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=causal), iters=10)
    parts = device_ms(lambda: flash_attention_cuda(q, k, v, causal=causal), (FLASH_KERNEL,),
                      iters=10, per_call=1,
                      forbid=("flash_fwd_kernel_mma", "flash_fwd_kernel<"))
    ms = parts[FLASH_KERNEL]
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=causal), iters=3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                         iters=10)
    ops = flash_flops(q.shape, k.shape, causal, window)  # the op's registered formula
    bytes_moved = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = ops / PEAK_BF16_OPS_PER_S, bytes_moved / PEAK_HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[flash] at the deepseek-7b prefill shape B={B} H={Hq} S={S} D={D} causal {dtype}: "
          f"kernel {FLASH_KERNEL} {ms:.4f} ms of device time ({call_ms:.4f} ms a call between CUDA events), "
          f"{ops / ms / 1e9:.2f} TFLOP/s; plain {plain_ms:.4f} ms; "
          f"scaled_dot_product_attention {library_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}: {ops:.4e} FLOP at 989 TFLOP/s bf16, {bytes_moved} B at 3.35 TB/s)")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:26", launches=None,
        max_abs_err=max(worst.values()), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
    )


def phase_serve(device) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda as flash_mod
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import attention, build_model, param_count
    from repro_torch.kernels.flash_attention.ops import chunked_attention
    from repro_torch.serve.serve_step import generate

    cfg = get_config(SERVE_ARCH)
    ref_shape = SHAPES["prefill_32k"]
    B, S, new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    print(f"[serve] {cfg.name} at full width and depth ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}), random weights from torch.Generator seed 0; "
          f"{B} prompts of {S} seeded tokens and {new} new tokens: the prompt cut from "
          f"{ref_shape.name}'s {ref_shape.seq_len} tokens and the batch from "
          f"{ref_shape.global_batch}, to fit one card's memory and the smoke's time limit")
    model = build_model(cfg, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    print(f"[serve] {param_count(params)} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.2f}s")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(device)}

    marks = {"prefill": [], "decode": []}

    def timed(name, fn):
        def call(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            marks[name].append((start, end))
            return out
        return call

    timed_model = model._replace(prefill=timed("prefill", model.prefill),
                                 decode=timed("decode", model.decode))

    def no_plain_version(*args, **kw):
        raise SmokeFailure("the serving path ran a plain attention version on the card")

    plain = flash_ops.attention_ref, attention.chunked_attention, attention.qblock_attention
    flash_ops.attention_ref = attention.chunked_attention = attention.qblock_attention = \
        no_plain_version
    try:
        torch.cuda.reset_peak_memory_stats()
        flash_mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out1 = generate(timed_model, params, batch, max_new=new, cache_len=S + new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_mod.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        first = {name: len(m) for name, m in marks.items()}
        out2 = generate(timed_model, params, batch, max_new=new, cache_len=S + new)
        torch.cuda.synchronize()
    finally:
        flash_ops.attention_ref, attention.chunked_attention, attention.qblock_attention = plain
    # run 1 is the model's first call on the card (cuBLAS and module loading
    # included); run 2 repeats it warm
    for run, (lo, hi) in enumerate(((0, first["prefill"]), (first["prefill"], None)), 1):
        prefill_s = sum(a.elapsed_time(b) for a, b in marks["prefill"][lo:hi]) / 1e3
        dmarks = marks["decode"][:first["decode"]] if run == 1 else marks["decode"][first["decode"]:]
        decode_s = sum(a.elapsed_time(b) for a, b in dmarks) / 1e3
        steps = len(dmarks)
        print(f"[serve] generate run {run}" + (f": {wall:.3f}s wall;" if run == 1 else ":") +
              f" prefill {prefill_s:.4f}s = {B * S / prefill_s:.1f} tokens/s; decode {steps} "
              f"steps in {decode_s:.4f}s = {B * steps / decode_s:.1f} tokens/s "
              f"({1e3 * decode_s / max(steps, 1):.2f} ms a step)" +
              (f"; flash launches {launches}; peak memory {peak_gb:.2f} GB" if run == 1 else ""))
    check(launches == cfg.n_layers,
          f"the prefill launched the flash kernel {launches} times, not once a layer "
          f"({cfg.n_layers})")
    check(out1.shape == (B, new) and out1.dtype == torch.int32, f"tokens {tuple(out1.shape)}")
    check(bool(((out1 >= 0) & (out1 < cfg.vocab_size)).all()), "a token outside the vocabulary")
    check(torch.equal(out1, out2), "two generate runs on the card differ")
    print(f"[serve] second run bit-identical; first tokens of prompt 0: "
          f"{out1[0, :8].tolist()}")

    # the kernel path's prefill logits against the plain chunked attention's
    cache = model.init_cache(B, S + new)
    got, _ = model.prefill(params, batch, cache)
    flash_fn = attention.flash_attention
    attention.flash_attention = lambda q, k, v, **kw: chunked_attention(q, k, v, chunk=cfg.attn_chunk,
                                                                        **kw)
    try:
        want, _ = model.prefill(params, batch, cache)
    finally:
        attention.flash_attention = flash_fn
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "prefill logits not finite")
    diff, top = float((got - want).abs().max()), float(want.abs().max())
    print(f"[serve] prefill last-position logits, kernel vs plain chunked_attention: "
          f"max|d|={diff:.4e}, max|logits|={top:.4e}, ratio {diff / top:.3e} (limit 2e-2); "
          f"argmax agrees on {int((got.argmax(-1) == want.argmax(-1)).sum())}/{B}")
    check(diff <= 2e-2 * top, f"kernel-path logits differ from the plain path by {diff:.4e}")
    del cache
    profile_serve(model, params, batch, S + new, cfg.n_layers)
    return {"flash_attention": launches}


def profile_serve(model, params, batch, cache_len, n_layers: int) -> None:
    """Device busy share and the top kernels of one prefill and of 8 decode
    steps (``torch.profiler``); the prefill's flash launches must all be
    ``FLASH_KERNEL``, one a layer."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cache = model.init_cache(batch["tokens"].shape[0], cache_len)
    logits, cache = model.prefill(params, batch, cache)
    token = logits[:, -1].argmax(-1, keepdim=True).int()
    for label, run in (("prefill", lambda: model.prefill(params, batch, cache)),
                       ("decode x8", lambda: [model.decode(params, token, dict(cache, len=cache["len"]))
                                              for _ in range(8)])):
        torch.cuda.synchronize()
        # one warm-up step, not recorded: the tracer can drop the first
        # kernels of a window it has just started
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            run()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
        # the step marker is an annotation on the device timeline, not a kernel
        kernels = [e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and not e.key.startswith("ProfilerStep")]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"[serve-profile] {label}: wall {wall_ms:.1f} ms (profiled), device busy "
              f"{busy:.1f} ms = {100 * busy / wall_ms:.1f}%, {sum(e.count for e in kernels)} kernels")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[serve-profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  "
                  f"{e.key[:90]}")
        flash = [e for e in kernels if "flash_fwd_kernel" in e.key]
        if label == "prefill":
            n = sum(e.count for e in flash)
            check(n == n_layers and all(FLASH_KERNEL in e.key for e in flash),
                  f"the profiled prefill ran {[(e.key[:60], e.count) for e in flash]}, not "
                  f"{n_layers} launches of {FLASH_KERNEL}")
            ms = sum(e.self_device_time_total for e in flash) / 1e3
            print(f"[serve-profile] prefill: {n} launches of {FLASH_KERNEL}, {ms:.3f} ms "
                  f"= {100 * ms / busy:.1f}% of the device time")


# ------------------------------------------------ phase 18: serving families ---

FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW = 4, 4096, 32   # phase 8's prompts
KIMI_LAYERS = 1            # depth cut of kimi-k2 (61 layers, 2.06 TB in bf16)
# depth of the sampled card = CPU check of each family, at full width
CPU_CHECK_LAYERS = {"granite-moe-1b-a400m": 2, "mamba2-130m": 24, "recurrentgemma-2b": 3}
CPU_CHECK_BATCH, CPU_CHECK_PROMPT, CPU_CHECK_NEW = 2, 16, 8


def check_moe_route(logits, cfg, label: str) -> dict:
    """Hold ``moe_route`` through the kernel against its plain version on
    the card at a router's real logits [G, Tg, E] (idx/slot/keep exact,
    combine within 1e-6, the same bits on two calls), and time both; print
    the assign kernel's form there, its tile rows and the kernels it
    launches."""
    import torch

    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign.ops import moe_route, moe_route_ref
    from repro_torch.models.moe import moe_capacity

    G, Tg, E = logits.shape
    k, C = cfg.top_k, moe_capacity(cfg, Tg)
    kw = dict(k=k, capacity=C, block_n=Tg if not cfg.scan_layers else 256)
    form = assign_mod.plan(G, Tg, E, k, kw["block_n"])
    check(set(form["kernels"]) <= set(ASSIGN_KERNELS + ROUTE_KERNELS),
          f"{label}: the route's kernels {form['kernels']} are not the assign kernel's")
    before = assign_mod.launches
    got = moe_route(logits, **kw)
    check(assign_mod.launches == before + 1, f"{label}: moe_route did not launch the kernel once")
    want = moe_route_ref(logits, **kw)
    torch.cuda.synchronize()
    check(assign_mod.launches == before + 1, f"{label}: the plain route launched the kernel")
    for name, i in (("idx", 0), ("slot", 2), ("keep", 3)):
        bad = int((got[i] != want[i]).sum())
        check(bad == 0, f"{label}: {bad} {name} entries of moe_route differ from the plain version")
    err = float((got[1] - want[1]).abs().max())
    check(err <= 1e-6, f"{label}: combine differs from the plain version by {err:.3e}")
    check(all(torch.equal(a, b) for a, b in zip(got, moe_route(logits, **kw))),
          f"{label}: two moe_route calls differ")
    call_ms = cuda_ms(lambda: moe_route(logits, **kw), iters=50)
    parts = device_ms(lambda: moe_route(logits, **kw), form["kernels"], iters=50,
                      per_call=1)
    ms = sum(parts.values())
    plain_ms = cuda_ms(lambda: moe_route_ref(logits, **kw), iters=3, warmup=1)
    N = G * Tg
    bytes_moved = N * E * 4 + N * 4 + G * E * 4 + N * k * (4 + 4 + 1 + 4)
    ops = N * E * (7 + 2 * k)    # the softmax's passes, then k compare-and-mask passes
    t_bytes, t_ops = bytes_moved / PEAK_HBM_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    kept = float(got[3].float().mean())
    split = ", ".join(f"{n} {t:.4f}" for n, t in parts.items())
    print(f"[families] {label} moe_route [{G}, {Tg}, {E}] k={k} capacity {C} block_n "
          f"{kw['block_n']}: kernel = plain (idx/slot/keep exact, combine max_abs_err {err:.3e}, "
          f"the same bits on two calls), {100 * (1 - kept):.2f}% of slots dropped; assign's "
          f"{form['form']} form, {form['tile_rows']}-row tiles, {form['ctas']} CTAs a group, "
          f"{form['launches']} launch(es) a call ({split}): {ms:.4f} ms of device time, {call_ms:.4f} ms a moe_route call between CUDA events, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4e} ms ({bound_by}: {bytes_moved} B, "
          f"{ops} operations)")
    return dict(shape=[G, Tg, E], k=k, capacity=C, block_n=kw["block_n"], max_abs_err=err,
                ms=ms, cuda_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                dropped=1 - kept, form=form["form"], tile_rows=form["tile_rows"],
                ctas=form["ctas"], kernels=parts)


def capture_router_logits(run):
    """Run ``run()`` and return the router logits of the first ``moe_route``
    call it makes (layer 0's)."""
    from repro_torch.models import moe

    seen = []
    route = moe.moe_route

    def recording(logits, **kw):
        if not seen:
            seen.append(logits.clone())
        return route(logits, **kw)

    moe.moe_route = recording
    try:
        run()
    finally:
        moe.moe_route = route
    return seen[0]


def serve_family(device, cfg, *, batch: int, prompt: int, new: int, seed: int = 0,
                 extra: dict | None = None):
    """Draw ``cfg``'s weights on the card (torch.Generator seed 0), then
    ``generate`` greedy and sampled (temperature 1.0, key ``PRNGKey(seed)``)
    over seeded prompts (with ``extra``, the frontend stub's tensors, in the
    batch), the launch counters set to 0 just before the greedy run.  Prints
    prefill tokens/s, decode ms a step, peak memory and the launches of each
    kernel a prefill and a decode step."""
    import numpy as np
    import torch

    from repro_torch.core.rng import PRNGKey
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.flash_attention import flash_attention_cuda as flash_mod
    from repro_torch.models import build_model, param_count
    from repro_torch.serve.serve_step import generate

    model = build_model(cfg, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    print(f"[families] {cfg.name}: {cfg.family}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}; {param_count(params)} parameters drawn on the "
          f"card in {time.perf_counter() - t0:.2f}s; {batch} prompts of {prompt} tokens, {new} new")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    batch_t = dict(extra or {}, tokens=torch.from_numpy(tokens).to(device))
    calls = {"prefill": [], "decode": []}

    def counted(name, fn):
        def call(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            n0 = (assign_mod.launches, flash_mod.launches)
            start.record()
            out = fn(*args)
            end.record()
            calls[name].append((start, end, assign_mod.launches - n0[0],
                                flash_mod.launches - n0[1]))
            return out
        return call

    timed = model._replace(prefill=counted("prefill", model.prefill),
                           decode=counted("decode", model.decode))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    assign_mod.launches = flash_mod.launches = 0
    torch.cuda.synchronize()
    greedy = generate(timed, params, batch_t, max_new=new, cache_len=prompt + new)
    torch.cuda.synchronize()
    launches = {"assign": assign_mod.launches, "flash_attention": flash_mod.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sampled = generate(timed, params, batch_t, max_new=new, cache_len=prompt + new,
                       rng=PRNGKey(seed))
    torch.cuda.synchronize()
    (p_s, p_e, p_assign, p_flash), *_ = calls["prefill"]
    steps = calls["decode"][:new - 1]
    prefill_s = p_s.elapsed_time(p_e) / 1e3
    decode_ms = sum(s.elapsed_time(e) for s, e, _, _ in steps) / len(steps)
    d_assign = {a for _, _, a, _ in steps}
    d_flash = {f for _, _, _, f in steps}
    check(len(d_assign) == 1 and len(d_flash) == 1, f"{cfg.name}: decode steps launched "
                                                    f"{d_assign} assign, {d_flash} flash kernels")
    for name, out in (("greedy", greedy), ("sampled", sampled)):
        check(out.shape == (batch, new) and out.dtype == torch.int32, f"{name} tokens {out.shape}")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), f"{name}: a token outside "
                                                                  "the vocabulary")
    check(torch.equal(greedy[:, 0], sampled[:, 0]), "the sampled run's first token is not the "
                                                     "prefill's argmax")
    check(not torch.equal(greedy, sampled), "sampling gave the greedy tokens")
    warm_s = calls["prefill"][1][0].elapsed_time(calls["prefill"][1][1]) / 1e3
    stats = dict(prefill_tokens_per_s=batch * prompt / prefill_s, decode_ms=decode_ms,
                 prefill_tokens_per_s_warm=batch * prompt / warm_s,
                 peak_gb=peak_gb, assign_prefill=p_assign, assign_decode=d_assign.pop(),
                 flash_prefill=p_flash, flash_decode=d_flash.pop(), launches=launches)
    print(f"[families] {cfg.name}: prefill {prefill_s:.4f}s = "
          f"{stats['prefill_tokens_per_s']:.1f} tokens/s (the sampled run's, warm, {warm_s:.4f}s = "
          f"{stats['prefill_tokens_per_s_warm']:.1f}); decode {len(steps)} steps, "
          f"{decode_ms:.3f} ms a step = {1e3 * batch / decode_ms:.1f} tokens/s; peak "
          f"{peak_gb:.2f} GB; launches a prefill: assign {p_assign}, flash {p_flash}; a decode "
          f"step: assign {stats['assign_decode']}, flash {stats['flash_decode']}; greedy "
          f"{greedy[0, :8].tolist()}, sampled {sampled[0, :8].tolist()} (prompt 0)")
    return model, params, batch_t, stats


def sampled_scores(model, params, batch, new: int, cache_len: int, key):
    """``generate``'s sampled loop, keeping each step's ``logits + gumbel``."""
    import torch

    from repro_torch.core import rng as prng

    cache = model.init_cache(batch["tokens"].shape[0], cache_len)
    logits, cache = model.prefill(params, batch, cache)
    scores = [logits[:, -1]]
    cur = logits[:, -1].argmax(-1, keepdim=True).int()
    for i in range(new - 1):
        logits, cache = model.decode(params, cur, cache)
        step_key = prng.fold_in(key, i).to(logits.device)
        noisy = prng.gumbel(step_key, tuple(logits[:, -1].shape)) + logits[:, -1]
        scores.append(noisy)
        cur = noisy.argmax(-1, keepdim=True).int()
    return torch.stack(scores, 1)


def sampled_card_vs_cpu(device, arch: str, layers: int | None = None,
                        extra: dict | None = None) -> None:
    """One sampled ``generate`` (key ``PRNGKey(0)``) at ``arch``'s full width,
    depth cut to ``layers`` (``CPU_CHECK_LAYERS``; an encoder-decoder's
    encoder and decoder each), with ``extra`` (CPU tensors of the frontend
    stub) in the batch, on the card and with the same weights on the CPU
    port: the first CPU_CHECK_NEW tokens must agree, or differ only where the
    CPU's noisy scores of the two picks are within the bf16 tolerance (2e-2
    of the largest logit), which is printed."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.rng import PRNGKey
    from repro_torch.models import build_model
    from repro_torch.serve.serve_step import generate

    L = CPU_CHECK_LAYERS[arch] if layers is None else layers
    cfg = get_config(arch).replace(n_layers=L)
    if cfg.family == "encdec":
        cfg = cfg.replace(n_enc_layers=L, n_dec_layers=L)
    card, cpu = build_model(cfg, device=device), build_model(cfg, device="cpu")
    params = card.init(0)
    params_cpu = copy.deepcopy(params).cpu()
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (CPU_CHECK_BATCH, CPU_CHECK_PROMPT))
    tok = torch.from_numpy(tok.astype(np.int32))
    n, cache_len = CPU_CHECK_NEW, CPU_CHECK_PROMPT + CPU_CHECK_NEW
    batch_cpu = dict(extra or {}, tokens=tok)
    batch_card = {k: v.to(device) for k, v in batch_cpu.items()}
    t0 = time.perf_counter()
    got = generate(card, params, batch_card, max_new=n, cache_len=cache_len,
                   rng=PRNGKey(0)).cpu()
    want = generate(cpu, params_cpu, batch_cpu, max_new=n, cache_len=cache_len,
                    rng=PRNGKey(0))
    seconds = time.perf_counter() - t0
    flips = []
    if not torch.equal(got, want):
        s_card = sampled_scores(card, params, batch_card, n, cache_len, PRNGKey(0)).cpu()
        s_cpu = sampled_scores(cpu, params_cpu, batch_cpu, n, cache_len, PRNGKey(0))
        for b in range(CPU_CHECK_BATCH):
            diff = (got[b] != want[b]).nonzero()
            if len(diff) == 0:
                continue
            i = int(diff[0])   # later tokens follow other histories
            gap = float(s_cpu[b, i, want[b, i]] - s_cpu[b, i, got[b, i]])
            top = float(s_cpu[b, i].abs().max())
            card_gap = float(s_card[b, i, got[b, i]] - s_card[b, i, want[b, i]])
            flips.append((b, i, gap, card_gap, top))
            check(gap <= 2e-2 * top, f"{arch}: sampled token {i} of prompt {b} is {int(got[b, i])} "
                                     f"on the card and {int(want[b, i])} on the CPU, a gap of "
                                     f"{gap:.4e} in the CPU's noisy scores (max {top:.4e})")
    print(f"[families] {cfg.name} cut to {L} layers, sampled generate card vs CPU "
          f"({CPU_CHECK_BATCH} prompts of {CPU_CHECK_PROMPT}, {n} tokens, {seconds:.1f}s): " +
          ("equal" if not flips else "near-ties at " + ", ".join(
              f"prompt {b} token {i} (CPU gap {g:.3e}, card gap {cg:.3e}, max score {t:.3e})"
              for b, i, g, cg, t in flips)) + f"; card {got[0].tolist()}")
    del params, params_cpu


FLASH_REL_TOL = 2.0 ** -6   # two bf16 ulps of a row's largest output


def check_family_flash(device, cfg, B: int, S: int, Skv: int | None = None,
                       causal: bool = True, label: str | None = None) -> dict:
    """Hold the flash kernel against its plain version at ``cfg``'s
    attention: q [B, Hq, S, D] against k/v [B, Hkv, Skv, D] (Skv = S by
    default), causal or not, with the config's window, in its dtype, on
    seeded standard-normal inputs.  The error of each output element is held
    relative to the largest output of its row (``FLASH_REL_TOL``); the plain
    version runs one prompt at a time to bound its f32 scores.  Times the
    kernel (device and call) beside the plain version and SDPA with the same
    mask."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_cuda as flash_mod
    from repro_torch.kernels.flash_attention import flash_flops
    from repro_torch.kernels.flash_attention.flash_attention_cuda import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref

    Hq, Hkv, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.window
    Skv = S if Skv is None else Skv
    label = label or cfg.name
    seed = 18 + D if causal and Skv == S else 18 + D + S + Skv   # phase 18's seeds kept
    q, k, v = flash_inputs(B, Hq, Hkv, S, Skv, D, cfg.dtype, seed, device)

    def kernel_call():
        return flash_attention_cuda(q, k, v, causal=causal, window=W)

    def plain():
        return torch.cat([attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=causal,
                                        window=W) for b in range(B)])

    before = flash_mod.launches
    got = kernel_call()
    want = plain()
    torch.cuda.synchronize()
    check(flash_mod.launches == before + 1, f"{label}: the flash call did not launch the kernel")
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{label}: flash output {got.dtype} {tuple(got.shape)} is not the plain version's")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    rel = float((diff / want.float().abs().amax(-1, keepdim=True)).max())
    check(rel <= FLASH_REL_TOL, f"{label}: flash differs from the plain version by {rel:.3e} "
                                f"of a row's largest output (max_abs_err {err:.3e})")
    del got, want, diff
    wgmma = cfg.dtype == "bfloat16" and D in (64, 128, 256)
    kernel = FLASH_KERNEL if wgmma else "flash_fwd_kernel<"
    others = tuple(n for n in ("flash_fwd_kernel_wgmma", "flash_fwd_kernel_mma", "flash_fwd_kernel<")
                   if n != kernel)
    iters = 5 if S * Skv >= 1 << 20 else 50
    call_ms = cuda_ms(kernel_call, iters=iters)
    ms = device_ms(kernel_call, (kernel,), iters=iters, per_call=1,
                   forbid=others)[kernel]
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    kq, vq = k.repeat_interleave(Hq // Hkv, 1), v.repeat_interleave(Hq // Hkv, 1)
    if W > 0:
        qpos = torch.arange(S, device=device) + (Skv - S)
        kpos = torch.arange(Skv, device=device)
        mask = kpos[None, :] > qpos[:, None] - W
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kq, vq, attn_mask=mask),
                             iters=iters)
    else:
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kq, vq,
                                                                    is_causal=causal),
                             iters=iters)
    ops = flash_flops(q.shape, k.shape, causal, W)  # the op's registered formula
    bytes_moved = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = ops / PEAK_BF16_OPS_PER_S, bytes_moved / PEAK_HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[families] flash at {label}'s attention q [{B}, {Hq}, {S}, {D}], k/v [{B}, {Hkv}, "
          f"{Skv}, {D}], causal {causal}, window {W}, {cfg.dtype}: max_abs_err {err:.3e}, "
          f"largest error {rel:.3e} of its row's largest output (limit {FLASH_REL_TOL:.3e}); "
          f"kernel {kernel} {ms:.4f} ms of device time ({call_ms:.4f} ms a call between CUDA "
          f"events), {ops / ms / 1e9:.2f} TFLOP/s; plain {plain_ms:.4f} ms; "
          f"scaled_dot_product_attention with the same mask {library_ms:.4f} ms; bound "
          f"{bound_ms:.4e} ms ({bound_by}: {ops:.4e} FLOP at 989 TFLOP/s bf16, {bytes_moved} B)")
    del q, k, v, kq, vq
    torch.cuda.empty_cache()
    return dict(shape=[B, Hq, Hkv, S, Skv, D], causal=causal, window=W, kernel=kernel,
                max_abs_err=err, max_rel_err=rel, ms=ms, cuda_ms=call_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_serve_families(device) -> dict:
    """Phase 18: granite-moe, kimi-k2 (1 layer), mamba2 and recurrentgemma
    served on the card, with the MoE router held on the assign kernel and
    the flash kernel at each family's attention (recurrentgemma's windowed
    D = 256 among them)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_kinds

    B, S, new = FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW
    torch.cuda.empty_cache()
    out = {"moe": {}, "launches": {}}

    # (a) granite-moe-1b-a400m at full width and depth
    cfg = get_config("granite-moe-1b-a400m")
    model, params, batch, stats = serve_family(device, cfg, batch=B, prompt=S, new=new)
    check(stats["assign_prefill"] == cfg.n_layers and stats["assign_decode"] == cfg.n_layers,
          f"granite: the router launched the assign kernel {stats['assign_prefill']} times a "
          f"prefill and {stats['assign_decode']} a decode step, not once a layer")
    check(stats["flash_prefill"] == cfg.n_layers, "granite: not one flash launch a layer")
    out["launches"]["granite"] = stats
    _, aux = model.forward(params, batch)
    drop = float(aux["moe_drop_frac"]) / cfg.n_layers
    print(f"[families] granite forward at the prompt: {100 * drop:.2f}% of the token slots "
          f"dropped (mean over layers), lb loss {float(aux['moe_lb_loss']):.4f}, z loss "
          f"{float(aux['moe_z_loss']):.4f} (sums over layers)")
    cache = model.init_cache(B, S + new)
    logits = capture_router_logits(lambda: model.prefill(params, batch, cache))
    out["moe"]["granite_prefill"] = check_moe_route(logits, cfg, "granite prefill")
    token = batch["tokens"][:, -1:]
    logits = capture_router_logits(lambda: model.decode(params, token, cache))
    out["moe"]["granite_decode"] = check_moe_route(logits, cfg, "granite decode")
    out["moe"]["granite_prefill"]["drop_frac_forward"] = drop
    del model, params, batch, cache, logits, aux
    torch.cuda.empty_cache()

    # (b) kimi-k2-1t-a32b at full width, depth cut
    cfg = get_config("kimi-k2-1t-a32b").replace(n_layers=KIMI_LAYERS)
    model, params, batch, stats = serve_family(device, cfg, batch=B, prompt=S, new=new)
    check(stats["assign_prefill"] == 1 and stats["assign_decode"] == 1 and
          stats["flash_prefill"] == 1, f"kimi: launches {stats}")
    out["launches"]["kimi"] = stats
    cache = model.init_cache(B, S + new)
    logits = capture_router_logits(lambda: model.prefill(params, batch, cache))
    out["moe"]["kimi_prefill"] = check_moe_route(logits, cfg, "kimi prefill")
    logits = capture_router_logits(lambda: model.decode(params, batch["tokens"][:, -1:], cache))
    out["moe"]["kimi_decode"] = check_moe_route(logits, cfg, "kimi decode")
    del model, params, batch, cache, logits
    torch.cuda.empty_cache()

    # (c) mamba2-130m at full width and depth
    cfg = get_config("mamba2-130m")
    model, params, batch, stats = serve_family(device, cfg, batch=B, prompt=S, new=new)
    check(stats["launches"] == {"assign": 0, "flash_attention": 0}, f"mamba2: launches {stats}")
    out["launches"]["mamba2"] = stats
    del model, params, batch
    torch.cuda.empty_cache()

    # (d) recurrentgemma-2b at full width and depth, prompts past the window
    cfg = get_config("recurrentgemma-2b")
    model, params, batch, stats = serve_family(device, cfg, batch=B, prompt=S, new=new)
    n_att = layer_kinds(cfg).count("att")
    check(stats["flash_prefill"] == n_att and stats["assign_prefill"] == 0,
          f"recurrentgemma: {stats['flash_prefill']} flash launches a prefill, not {n_att}")
    out["launches"]["recurrentgemma"] = stats
    # the rolling cache (the long_500k plan: cache_len = window) against the full one
    W = cfg.window
    full = model.init_cache(B, S + new)
    logits, full = model.prefill(params, batch, full)
    token = logits[:, -1].argmax(-1, keepdim=True).int()
    want, _ = model.decode(params, token, full)
    del full
    roll = model.init_cache(B, W)
    _, roll = model.prefill(params, batch, roll)
    got, roll = model.decode(params, token, roll)
    diff, top = float((got - want).abs().max()), float(want.abs().max())
    print(f"[families] recurrentgemma rolling cache of {W} slots (prompt {S}): first decode "
          f"logits vs the {S + new}-slot cache max|d|={diff:.4e}, max|logits|={top:.4e} "
          f"(limit 2e-2 of it), argmax agrees on "
          f"{int((got.argmax(-1) == want.argmax(-1)).sum())}/{B}")
    check(diff <= 2e-2 * top, f"recurrentgemma rolling-cache decode differs by {diff:.4e}")
    del model, params, batch, roll, logits, got, want
    torch.cuda.empty_cache()

    # the flash kernel at each family's prefill attention against its plain version
    out["flash"] = {name: check_family_flash(device, get_config(arch), B, S)
                    for name, arch in (("granite", "granite-moe-1b-a400m"),
                                       ("kimi", "kimi-k2-1t-a32b"),
                                       ("recurrentgemma", "recurrentgemma-2b"))}

    # sampling: the card's sampled tokens against the CPU port's, one model a family
    for arch in CPU_CHECK_LAYERS:
        sampled_card_vs_cpu(device, arch)
        torch.cuda.empty_cache()
    return out


def snapshot(res) -> dict:
    from repro_torch.core import result_to_numpy

    out = result_to_numpy(res)
    return dict(rounds=int(out["rounds"]), makespan=out["makespan"],
                **{f"jobs.{f}": out["jobs"][f] for f in JOB_FIELDS},
                **{f"sites.{f}": out["sites"][f] for f in SITE_FIELDS})


def mismatches(a: dict, b: dict) -> dict:
    """Count of differing elements per key; NaN equals NaN (the log's
    unwritten rows)."""
    import numpy as np

    def differ(x, y):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape:
            return max(x.size, 1)
        ne = x != y
        if x.dtype.kind == "f":
            ne &= ~(np.isnan(x) & np.isnan(y))
        return int(np.count_nonzero(ne))

    return {k: n for k in a if (n := differ(a[k], b[k]))}


def check_invariants(res, label: str) -> None:
    """Finite, well-shaped outputs that obey the engine's own bookkeeping."""
    import torch

    from repro_torch.core import RUNNING

    jobs, sites = res.jobs, res.sites
    check(bool(torch.isfinite(res.makespan)), f"{label}: makespan not finite")
    started = torch.isfinite(jobs.t_start)
    check(bool((jobs.t_finish[started] >= jobs.t_start[started]).all()),
          f"{label}: a job finishes before it starts")
    running_site = torch.where(jobs.state == RUNNING, jobs.site, sites.capacity)
    busy = torch.zeros(sites.capacity + 1, dtype=torch.int64, device=jobs.site.device)
    busy.index_add_(0, running_site.long(), jobs.cores.long())
    check(bool((sites.free_cores.long() + busy[:-1] == sites.cores.long()).all()),
          f"{label}: free + running cores differ from site cores")
    check(bool((sites.free_cores >= 0).all()), f"{label}: negative free cores")


def phase_full_width(device, max_rounds: int) -> dict:
    import torch

    from repro_torch import core as T
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import make_capacity_assign
    from repro_torch.kernels.assign import ops as assign_ops
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    sites = T.atlas_like_platform(ENGINE_S, seed=1, device=device)
    jobs = T.synthetic_panda_jobs(ENGINE_J, seed=0, duration=6 * 3600.0, device=device)
    work_rounds = [0]
    capacity_assign = make_capacity_assign(jobs.cores)

    def counted_assign(*args):
        work_rounds[0] += 1          # assign runs once per round with work
        return capacity_assign(*args)

    policy = T.with_capacity_assign(T.get_policy("panda_dispatch"), counted_assign)
    key = T.PRNGKey(0)

    def no_plain_version(*args, **kw):
        raise SmokeFailure("the main path called assign_ref on the card")

    plain = assign_ops.assign_ref
    assign_ops.assign_ref = no_plain_version
    try:
        assign_mod.launches = 0
        segsum_mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = T.simulate(jobs, sites, policy, key, max_rounds=max_rounds, device=device)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
    finally:
        assign_ops.assign_ref = plain
    launches = {"assign": assign_mod.launches, "segment_sum": segsum_mod.launches}
    rounds_with_work = work_rounds[0]
    print(f"[full] S={ENGINE_S} J={ENGINE_J} rounds={res.rounds} rounds_with_work="
          f"{rounds_with_work} launches={json.dumps(launches)} wall={wall1:.3f}s")
    check(launches["assign"] > 0, "the main path never launched the assign kernel")
    check(launches["assign"] == rounds_with_work,
          f"assign launches {launches['assign']} != rounds with work {rounds_with_work}")
    check(launches["segment_sum"] > 0, "the main path never launched the segment_sum kernel")
    check_invariants(res, "full")
    snap1 = SNAPSHOTS["dense"] = snapshot(res)   # phase 24(a) runs the same through the mesh

    # second run: determinism, and the assign kernel's call time (CUDA events
    # around the wrapper: host launch work included, not device time)
    timings = []
    real_assign = assign_ops.assign_cuda

    def timed_assign(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_assign(*args, **kw)
        end.record()
        timings.append((start, end))
        return out

    assign_ops.assign_cuda = timed_assign
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res2 = T.simulate(jobs, sites, policy, key, max_rounds=max_rounds, device=device)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    finally:
        assign_ops.assign_cuda = real_assign
    bad = mismatches(snap1, snapshot(res2))
    check(not bad, f"two runs on the card differ: {bad}")
    kernel_s = sum(s.elapsed_time(e) for s, e in timings) / 1e3
    print(f"[full] second run bit-identical; rounds/s first={res.rounds / wall1:.2f} "
          f"second={res2.rounds / wall2:.2f}; assign {len(timings)} calls, "
          f"{kernel_s * 1e3:.3f} ms of call time between CUDA events (host launch work "
          f"included) = {100 * kernel_s / wall2:.2f}% of the run's wall time "
          f"({1e3 * kernel_s / max(len(timings), 1):.4f} ms a call)")
    print(f"[full] {T.summary_str(T.compute_metrics(res))}")
    prof = profile_rounds(lambda: T.simulate(jobs, sites, policy, key, max_rounds=PROFILE_ROUNDS,
                                             device=device), names=ASSIGN_KERNELS)
    return launches, (res.rounds / wall1, res2.rounds / wall2), prof


def phase_sparse_full_width(device, max_rounds: int) -> dict:
    import torch

    from repro_torch import core as T
    from repro_torch.core.rng import fold_in
    from repro_torch.core.sparse import CAND_SALT
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import fused_cuda as fused_mod
    from repro_torch.kernels.assign import make_capacity_assign, make_fused_capacity_assign
    from repro_torch.kernels.assign import ops as assign_ops
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    sites = T.atlas_like_platform(ENGINE_S, seed=1, device=device)
    jobs = T.synthetic_panda_jobs(ENGINE_J, seed=0, duration=6 * 3600.0, device=device)
    work_rounds = [0]
    fused_assign = make_fused_capacity_assign(jobs.cores)

    def counted_assign(*args):
        work_rounds[0] += 1          # assign_cand runs once per round with work
        return fused_assign(*args)

    policy = T.with_fused_assign(T.get_policy("data_locality"), counted_assign)
    key = T.PRNGKey(0)

    def no_plain_version(*args, **kw):
        raise SmokeFailure("the sparse path called a plain assignment version on the card")

    plain = assign_ops.fused_assign_ref, assign_ops.assign_ref
    assign_ops.fused_assign_ref = assign_ops.assign_ref = no_plain_version
    try:
        fused_mod.launches = 0
        assign_mod.launches = 0
        segsum_mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = T.simulate(jobs, sites, policy, key, max_rounds=max_rounds, topk=ENGINE_K,
                         device=device)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
    finally:
        assign_ops.fused_assign_ref, assign_ops.assign_ref = plain
    launches = {"fused_assign": fused_mod.launches, "assign": assign_mod.launches,
                "segment_sum": segsum_mod.launches}
    rounds_with_work = work_rounds[0]
    print(f"[sparse] S={ENGINE_S} J={ENGINE_J} topk={ENGINE_K} rounds={res.rounds} "
          f"rounds_with_work={rounds_with_work} launches={json.dumps(launches)} "
          f"wall={wall1:.3f}s")
    check(launches["fused_assign"] > 0, "the sparse path never launched the fused kernel")
    check(launches["fused_assign"] == rounds_with_work,
          f"fused launches {launches['fused_assign']} != rounds with work {rounds_with_work}")
    check(launches["assign"] == 0, "the sparse path launched the dense assign kernel")
    check(launches["segment_sum"] > 0, "the sparse path never launched the segment_sum kernel")
    check_invariants(res, "sparse")
    snap1 = SNAPSHOTS["sparse"] = snapshot(res)  # phase 24(b) runs the same through the mesh

    # the candidate build that init paid, alone
    clock0 = torch.zeros((), dtype=torch.float32, device=device)
    cand_key = fold_in(key, CAND_SALT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cand = T.build_candidates(jobs, sites, policy, (), clock0, cand_key, {}, ENGINE_K)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    full_rows = float((cand < ENGINE_S).all(-1).float().mean())
    print(f"[sparse] candidate build at init: {build_s:.4f} s for i32[{ENGINE_J}, {ENGINE_K}] "
          f"({100 * full_rows:.1f}% of rows hold {ENGINE_K} feasible sites)")

    # second run: determinism, and the fused kernel's call time (CUDA events
    # around the wrapper: host launch work included, not device time)
    timings = []
    real_fused = assign_ops.fused_assign_cuda

    def timed_fused(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_fused(*args, **kw)
        end.record()
        timings.append((start, end))
        return out

    assign_ops.fused_assign_cuda = timed_fused
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res2 = T.simulate(jobs, sites, policy, key, max_rounds=max_rounds, topk=ENGINE_K,
                          device=device)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    finally:
        assign_ops.fused_assign_cuda = real_fused
    bad = mismatches(snap1, snapshot(res2))
    check(not bad, f"two sparse runs on the card differ: {bad}")
    kernel_s = sum(s.elapsed_time(e) for s, e in timings) / 1e3
    print(f"[sparse] second run bit-identical; rounds/s first={res.rounds / wall1:.2f} "
          f"second={res2.rounds / wall2:.2f}; fused {len(timings)} calls, "
          f"{kernel_s * 1e3:.3f} ms of call time between CUDA events (host launch work "
          f"included) = {100 * kernel_s / wall2:.2f}% of the run's wall time "
          f"({1e3 * kernel_s / max(len(timings), 1):.4f} ms a call)")
    print(f"[sparse] {T.summary_str(T.compute_metrics(res))}")

    # the same policy and depth through the dense path, for the rate
    dense_policy = T.with_capacity_assign(T.get_policy("data_locality"),
                                          make_capacity_assign(jobs.cores))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_d = T.simulate(jobs, sites, dense_policy, key, max_rounds=max_rounds, device=device)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    check_invariants(res_d, "sparse-vs-dense")
    first = {}
    for label, pol, k in (("sparse", policy, ENGINE_K), ("dense", dense_policy, None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.simulate(jobs, sites, pol, key, max_rounds=100, topk=k, device=device)
        torch.cuda.synchronize()
        first[label] = 100 / (time.perf_counter() - t0)
    print(f"[sparse] the same policy dense (capacity dispatch): rounds/s={res_d.rounds / wall_d:.2f}"
          f" over {res_d.rounds} rounds; first 100 rounds: sparse {first['sparse']:.2f}, "
          f"dense {first['dense']:.2f} rounds/s")
    profile_rounds(lambda: T.simulate(jobs, sites, policy, key, max_rounds=SHORT_PROFILE_ROUNDS,
                                      topk=ENGINE_K, device=device),
                   "sparse", names=FUSED_KERNELS, rounds=SHORT_PROFILE_ROUNDS)
    launches["rates"] = (res.rounds / wall1, res2.rounds / wall2)
    return launches


def profile_rounds(run, label: str = "profile", names=(), rounds: int = None) -> dict:
    """Device busy share and the kernels that take the most device time over
    the first ``rounds`` rounds of a full-width run (``torch.profiler``;
    ``run`` runs them), and the device time per launch of each kernel named
    in ``names``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm the caching allocator and the profiler-free path first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms == 0.0:
        print(f"[{label}] the profiler saw no device time: busy share not measured")
        return {}
    sorts = sum(e.count for e in kernels if "DeviceRadixSortOnesweepKernel" in e.key)
    print(f"[{label}] {rounds or PROFILE_ROUNDS} rounds: wall {wall_ms:.1f} ms (profiled), device busy "
          f"{device_ms:.1f} ms = {100 * device_ms / wall_ms:.1f}%, idle "
          f"{100 - 100 * device_ms / wall_ms:.1f}%, {sum(e.count for e in kernels)} kernels, "
          f"{sorts} of them DeviceRadixSortOnesweepKernel")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[{label}]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    total_ms, most = 0.0, 0
    for name in names:
        hits = [e for e in kernels if name in e.key]
        ms, count = sum(e.self_device_time_total for e in hits) / 1e3, sum(e.count for e in hits)
        check(count > 0, f"the profiled rounds launched no {name}")
        total_ms, most = total_ms + ms, max(most, count)
        print(f"[{label}] {name}: {ms:.3f} ms of device time in {count} launches = "
              f"{ms / count:.4f} ms a launch")
    if names:
        print(f"[{label}] {' + '.join(names)}: {total_ms / most:.4f} ms of device time a call "
              "(profiler, inside the run)")
    return dict(wall_ms=wall_ms, device_ms=device_ms, kernels=sum(e.count for e in kernels))


def kernels_of(fn) -> int:
    """The kernels one call of ``fn`` launches, as ``torch.profiler`` records
    them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA"))


def phase_drain(device, max_rounds: int) -> None:
    import torch

    from repro_torch import core as T
    from repro_torch.kernels.assign import make_capacity_assign

    snaps = {}
    threads = torch.get_num_threads()
    for dev in (device, torch.device("cpu")):
        sites = T.atlas_like_platform(50, seed=1, fail_rate=0.02, device=dev)
        jobs = T.synthetic_panda_jobs(5000, seed=0, device=dev)
        policy = T.with_capacity_assign(T.get_policy("panda_dispatch"),
                                        make_capacity_assign(jobs.cores))
        # at J=5000 every CPU op is small: one thread beats a pool (the
        # engine's results do not depend on the thread count)
        torch.set_num_threads(1 if dev.type == "cpu" else threads)
        t0 = time.perf_counter()
        try:
            res = T.simulate(jobs, sites, policy, T.PRNGKey(0), max_rounds=max_rounds, device=dev)
        finally:
            torch.set_num_threads(threads)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        active = int(((res.jobs.state <= T.RUNNING) & res.jobs.valid).sum())
        print(f"[drain] {dev.type}: rounds={res.rounds} makespan={float(res.makespan)!r} "
              f"active_left={active} wall={wall:.2f}s ({res.rounds / wall:.1f} rounds/s)")
        check(res.rounds == max_rounds or active == 0,
              f"{dev.type}: the drain stopped with {active} active jobs")
        check_invariants(res, f"drain-{dev.type}")
        snaps[dev.type] = snapshot(res)
        print(f"[drain] {dev.type}: {T.summary_str(T.compute_metrics(res))}")
    bad = mismatches(snaps["cuda"], snaps["cpu"])
    print(f"[drain] card vs CPU mismatch counts: {json.dumps(bad)}")
    check(not bad, "the card's drain differs from the CPU's")


def phase_sparse_drain(device, max_rounds: int) -> None:
    """The drain scenario cut to ``max_rounds``: the fused sparse path at
    ``topk=S`` against the dense capacity dispatch on the card, and ``topk=8``
    on the card against the CPU."""
    import torch

    from repro_torch import core as T
    from repro_torch.kernels.assign import make_capacity_assign, make_fused_capacity_assign

    def scenario(dev):
        sites = T.atlas_like_platform(50, seed=1, fail_rate=0.02, device=dev)
        jobs = T.synthetic_panda_jobs(5000, seed=0, device=dev)
        return jobs, sites

    def run(dev, label, dense=False, topk=None):
        jobs, sites = scenario(dev)
        base = T.get_policy("panda_dispatch")
        policy = (T.with_capacity_assign(base, make_capacity_assign(jobs.cores)) if dense
                  else T.with_fused_assign(base, make_fused_capacity_assign(jobs.cores)))
        threads = torch.get_num_threads()
        torch.set_num_threads(1 if dev.type == "cpu" else threads)
        t0 = time.perf_counter()
        try:
            res = T.simulate(jobs, sites, policy, T.PRNGKey(0), max_rounds=max_rounds,
                             topk=topk, device=dev)
        finally:
            torch.set_num_threads(threads)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_invariants(res, f"sparse-drain {label}")
        print(f"[sparse-drain] {label}: rounds={res.rounds} makespan={float(res.makespan)!r} "
              f"retries={int(res.jobs.retries.sum())} n_failed={int(res.sites.n_failed.sum())} "
              f"wall={wall:.2f}s ({res.rounds / wall:.1f} rounds/s)")
        return snapshot(res)

    cpu = torch.device("cpu")
    dense = run(device, "card dense capacity", dense=True)
    full = run(device, "card fused topk=S", topk=50)
    bad = mismatches(dense, full)
    print(f"[sparse-drain] topk=S vs dense mismatch counts: {json.dumps(bad)}")
    check(not bad, "topk=S with the fused assigner differs from the dense capacity dispatch")
    card8 = run(device, "card fused topk=8", topk=8)
    cpu8 = run(cpu, "cpu fused topk=8", topk=8)
    bad = mismatches(card8, cpu8)
    print(f"[sparse-drain] topk=8 card vs CPU mismatch counts: {json.dumps(bad)}")
    check(not bad, "topk=8 on the card differs from the CPU")
    check(mismatches(card8, full), "topk=8 gave the topk=S run: the cut did not bind")


# bench_availability.py's preemption-churn setting has mtbf = 4 h: at 300 sites
# its first outages within 2000 rounds hit no site with running jobs, so no
# job is preempted; at 1 h neither; at 30 min 155 jobs are (a CPU run of the
# same scenario cut to the jobs that arrive in those rounds)
SUB_MTBF = 1800.0
SUB_CHAINS = 25_000            # atlas_mc_workflows tasks: 4 jobs each, J = 100000
SUB_LOG_ROWS = 256
CROSS_S, CROSS_CHAINS = 50, 1250   # phase 10: card against CPU


def full_snapshot(res) -> dict:
    """Every array of ``result_to_numpy`` (jobs, sites, log and its columns,
    the subsystem states: catalog and transfer rings included), flat."""
    from repro_torch.core import result_to_numpy

    out = {}

    def walk(prefix, value):
        if isinstance(value, dict):
            for k, v in value.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        else:
            out[prefix] = value

    walk("", result_to_numpy(res))
    return out


def subsystem_scenario(device, n_sites, n_chains, flaky_windows=False):
    """Sites, 4-stage ATLAS MC workflows (``atlas_mc_workflows``) and the
    flaky-site calendar at ``SUB_MTBF``; with ``flaky_windows`` the
    calendar's windows are read back and joined by a rolling brown-out's
    into one ``make_availability`` calendar."""
    import numpy as np

    from repro_torch import core as T

    sites = T.atlas_like_platform(n_sites, seed=1, fail_rate=0.02, device=device)
    scn = T.atlas_mc_workflows(n_chains, seed=0, arrival_span=3600.0, device=device)
    av = T.flaky_sites(n_sites, np.arange(n_sites), horizon=86400.0, mtbf=SUB_MTBF,
                       mean_down=1800.0, seed=2, device=device)
    if flaky_windows:
        brown = T.rolling_brownout(n_sites, horizon=86400.0, factor=0.5, device="cpu")
        windows = []
        for state in (av, brown):
            start, end = state.win_start.cpu().numpy(), state.win_end.cpu().numpy()
            factor, preempt = state.win_factor.cpu().numpy(), state.win_preempt.cpu().numpy()
            windows += [dict(site=int(s), start=float(start[s, w]), end=float(end[s, w]),
                             factor=float(factor[s, w]), preempt=bool(preempt[s, w]))
                        for s, w in zip(*np.nonzero(np.isfinite(start)))]
        av = T.make_availability(n_sites, windows, device=device)
    return scn, sites, av


def phase_subsystems_full_width(device, max_rounds: int, plain_rates) -> dict:
    """The subsystem pipeline at WLCG scale: 300 sites with flaky-site
    outages (availability), 100000 jobs in 4-stage workflow DAGs,
    ``critical_path_first`` with capacity dispatch, the event log with its
    ``site_avail`` column; twice, with the launch counters set to 0 just
    before the first run."""
    import numpy as np
    import torch

    from repro_torch import core as T
    from repro_torch.core import events as TE
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import make_capacity_assign
    from repro_torch.kernels.assign import ops as assign_ops
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    t0 = time.perf_counter()
    scn, sites, av = subsystem_scenario(device, ENGINE_S, SUB_CHAINS)
    print(f"[subsys] scenario built in {time.perf_counter() - t0:.2f}s: S={ENGINE_S} "
          f"J={scn.jobs.capacity} in {SUB_CHAINS} 4-stage workflows, "
          f"{int(torch.isfinite(av.win_start).sum())} outage windows (mtbf {SUB_MTBF:g} s, "
          f"W={av.max_windows})")
    work_rounds = [0]
    capacity_assign = make_capacity_assign(scn.jobs.cores)

    def counted_assign(*args):
        work_rounds[0] += 1          # assign runs once per round with work
        return capacity_assign(*args)

    policy = T.with_capacity_assign(T.get_policy("critical_path_first"), counted_assign)
    key = T.PRNGKey(0)

    def run(rounds=max_rounds):
        return T.simulate(scn.jobs, sites, policy, key, availability=av, workflow=scn.workflow,
                          max_rounds=rounds, log_rows=SUB_LOG_ROWS, device=device)

    def no_plain_version(*args, **kw):
        raise SmokeFailure("the subsystem path called assign_ref on the card")

    plain = assign_ops.assign_ref
    assign_ops.assign_ref = no_plain_version
    try:
        assign_mod.launches = 0
        segsum_mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        launches = {"assign": assign_mod.launches, "segment_sum": segsum_mod.launches}
        rounds_with_work = work_rounds[0]
        t0 = time.perf_counter()
        res2 = run()
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    finally:
        assign_ops.assign_ref = plain
    n_pre = int(res.avail.n_preempted.sum())
    print(f"[subsys] rounds={res.rounds} rounds_with_work={rounds_with_work} "
          f"launches={json.dumps(launches)} ({launches['segment_sum'] / res.rounds:.2f} "
          f"segment sums a round) makespan={float(res.makespan)!r} n_preempted={n_pre} "
          f"n_cancelled={int(res.wf.n_cancelled)} log rows written={res.log.cursor}")
    check(launches["assign"] > 0, "the subsystem path never launched the assign kernel")
    check(launches["assign"] == rounds_with_work,
          f"assign launches {launches['assign']} != rounds with work {rounds_with_work}")
    check(launches["segment_sum"] > 0, "the subsystem path never launched the segment sum")
    check(n_pre > 0, "no running job was preempted: the path did not exercise preemption")
    check_invariants(res, "subsys")
    check(bool(torch.isfinite(res.log.extra["site_avail"]).all()), "site_avail not finite")
    bad = mismatches(full_snapshot(res), full_snapshot(res2))
    check(not bad, f"two subsystem runs on the card differ: {bad}")
    print(f"[subsys] second run bit-identical; rounds/s first={res.rounds / wall1:.2f} "
          f"second={res2.rounds / wall2:.2f}; the plain dense path in this call (phase 3): "
          f"first={plain_rates[0]:.2f} second={plain_rates[1]:.2f}")
    print(f"[subsys] {T.summary_str(T.compute_metrics(res))}")
    t0 = time.perf_counter()
    n_rows = len(TE.transition_rows(res))
    rows_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ml = TE.ml_dataset(res)
    ml_s = time.perf_counter() - t0
    check(ml["features"].shape[1] == len(ml["feature_names"]) and
          bool(np.isfinite(ml["features"]).all()), "ml_dataset features malformed")
    print(f"[subsys] transition_rows: {n_rows} rows in {rows_s:.3f}s on the host; ml_dataset: "
          f"{ml['features'].shape[0]} rows x {ml['features'].shape[1]} features in "
          f"{ml_s:.3f}s on the host")
    profile_rounds(lambda: run(SHORT_PROFILE_ROUNDS), "subsys-profile", names=ASSIGN_KERNELS,
                   rounds=SHORT_PROFILE_ROUNDS)
    launches["rounds"] = res.rounds
    launches["rate"] = res2.rounds / wall2
    return launches


def phase_subsystems_card_vs_cpu(device, max_rounds: int) -> dict:
    """The subsystem path at S=50 (1250 workflows, flaky-site outages and a
    rolling brown-out in one calendar), cut to ``max_rounds``: dense
    capacity dispatch and fused ``topk=8`` on the card each equal the CPU,
    and so do their transition rows and ML datasets, byte for byte."""
    import io

    import torch

    from repro_torch import core as T
    from repro_torch.core import events as TE
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import fused_cuda as fused_mod
    from repro_torch.kernels.assign import make_capacity_assign, make_fused_capacity_assign
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    def run(dev, fused):
        scn, sites, av = subsystem_scenario(dev, CROSS_S, CROSS_CHAINS, flaky_windows=True)
        base = T.get_policy("critical_path_first")
        policy = (T.with_fused_assign(base, make_fused_capacity_assign(scn.jobs.cores)) if fused
                  else T.with_capacity_assign(base, make_capacity_assign(scn.jobs.cores)))
        threads = torch.get_num_threads()
        torch.set_num_threads(1 if dev.type == "cpu" else threads)
        t0 = time.perf_counter()
        try:
            res = T.simulate(scn.jobs, sites, policy, T.PRNGKey(0), availability=av,
                             workflow=scn.workflow, max_rounds=max_rounds, log_rows=max_rounds,
                             topk=8 if fused else None, device=dev)
        finally:
            torch.set_num_threads(threads)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        label = f"{dev.type} {'fused topk=8' if fused else 'dense capacity'}"
        check_invariants(res, f"cross {label}")
        buf = io.StringIO()
        TE.write_ml_dataset(res, buf)
        exports = dict(csv=TE.to_csv(TE.transition_rows(res)), ml=buf.getvalue(),
                       avail_csv=TE.to_csv(TE.availability_rows(res)))
        print(f"[cross] {label}: rounds={res.rounds} makespan={float(res.makespan)!r} "
              f"n_preempted={int(res.avail.n_preempted.sum())} "
              f"n_cancelled={int(res.wf.n_cancelled)} W={av.max_windows} wall={wall:.2f}s "
              f"({res.rounds / wall:.1f} rounds/s); {exports['csv'].count(chr(10))} CSV lines, "
              f"{exports['ml'].count(chr(10))} NDJSON lines")
        return res, full_snapshot(res), exports

    cpu = torch.device("cpu")
    out = {}
    for fused in (False, True):
        name = "fused topk=8" if fused else "dense"
        assign_mod.launches = fused_mod.launches = segsum_mod.launches = 0
        card, card_snap, card_exp = run(device, fused)
        kernel, launched = (("fused_assign", fused_mod.launches) if fused
                            else ("assign", assign_mod.launches))
        out[kernel] = launched
        print(f"[cross] {name} on the card: {launched} {kernel} launches, "
              f"{segsum_mod.launches} segment_sum launches")
        check(launched > 0 and segsum_mod.launches > 0,
              f"the {name} subsystem run did not launch {kernel} and segment_sum")
        _, cpu_snap, cpu_exp = run(cpu, fused)
        bad = mismatches(card_snap, cpu_snap)
        print(f"[cross] {name} card vs CPU mismatch counts: {json.dumps(bad)}")
        check(not bad, f"the card's {name} subsystem run differs from the CPU's")
        for k in card_exp:
            check(card_exp[k] == cpu_exp[k], f"{name}: the card's {k} export differs from the CPU's")
        check(int(card.avail.n_preempted.sum()) > 0, f"{name}: no preemption at S={CROSS_S}")
        check(bool((card.log.extra["site_avail"] == 0.5).any()), f"{name}: no brown-out logged")
        print(f"[cross] {name}: transition CSV, availability CSV and ML NDJSON byte-identical "
              f"({len(card_exp['csv'])}, {len(card_exp['avail_csv'])} and {len(card_exp['ml'])} B)")
    return out


# phases 11 and 12: data movement and transfer queues
DATA_D = 1024                  # bench_data_movement.py:65's largest catalog
DATA_LOG_ROWS = 256
DATA_QUEUE_SLOTS = 256         # the [L, Q] rings at S=300: 2 x 90000 x 256 int32 = 184 MB
DATA_TR_ROUNDS = 400           # depth cut of run (b) and of phase 14
DATA_SPARSE_ROUNDS = 150       # depth cut of run (c)
XDATA_S, XDATA_J, XDATA_CHAINS = 50, 5000, 1250   # phase 12: card against CPU
XDATA_ROUNDS = 300             # depth cut of phase 12
# disk = memory x this, bytes: the workflow run's disks are ten times tighter
# than the fused run's, since even in 1000 rounds (~800 s simulated) only the
# small evgen outputs land and disks of memory x 1e8 fill to 57% at most (a
# CPU run of the same scenario); at 1e7 the outputs overflow a disk within
# ~200 rounds
XDATA_DISK = {"workflows": 1e7, "fused": 1e8}


def total_device_ms(fn, iters: int) -> tuple:
    """Device milliseconds and kernel launches per call of ``fn``, summed
    over every kernel it launches (``torch.profiler``, ``iters`` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return (sum(e.self_device_time_total for e in kernels) / 1e3 / iters,
            sum(e.count for e in kernels) / iters)


def ledger(ts, fs=None) -> dict:
    """The transfer ledger; every enqueue ends done, cancelled or (with the
    faults subsystem ``fs``) failed, or is queued or active at the cut."""
    import torch

    in_flight = int((ts.stat > 0).sum())
    led = dict(n_enq=int(ts.n_enq), n_done=int(ts.n_done), n_cancel=int(ts.n_cancel),
               in_flight=in_flight, n_overflow=int(ts.n_overflow),
               queued=int((ts.stat == 1).sum()), active=int(ts.active.sum()))
    if fs is not None:
        led["n_xfer_fail"] = int(fs.n_xfer_fail)
    check(led["n_enq"] == led["n_done"] + led["n_cancel"] + led.get("n_xfer_fail", 0)
          + in_flight, f"the transfer ledger does not balance: {led}")
    check(bool(torch.isfinite(ts.bytes_done)), "bytes_done not finite")
    return led


def phase_data_full_width(device, max_rounds: int, plain_rates) -> dict:
    """Data movement at WLCG scale: 300 sites, 100000 jobs reading a 1024-
    dataset Zipf catalog over the ATLAS-like WAN, ``cache_on_read`` under
    storage pressure; (a) panda_dispatch with capacity dispatch twice,
    (b) the same with the transfer queues, (c) ``data_locality`` with the
    fused kernel at ``topk=16``.  Counters set to 0 just before each."""
    import torch

    from repro_torch import core as T
    from repro_torch.core import replicas as TR
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import fused_cuda as fused_mod
    from repro_torch.kernels.assign import make_capacity_assign, make_fused_capacity_assign
    from repro_torch.kernels.assign import ops as assign_ops
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    t0 = time.perf_counter()
    sites = T.atlas_like_platform(ENGINE_S, seed=1, device=device)
    jobs = T.synthetic_panda_jobs(ENGINE_J, seed=0, duration=6 * 3600.0, n_datasets=DATA_D,
                                  zipf_alpha=1.2, device=device)
    net = T.atlas_like_network(ENGINE_S, seed=2, device=device)
    rep = T.make_replicas(T.zipf_dataset_sizes(DATA_D, seed=3), sites.memory * 1e9, seed=4,
                          device=device)
    data = T.get_data_policy("cache_on_read")
    sizes = rep.size.cpu()
    print(f"[data] scenario built in {time.perf_counter() - t0:.2f}s: S={ENGINE_S} "
          f"J={ENGINE_J} D={DATA_D} datasets (median {float(sizes.median()) / 1e9:.1f} GB, "
          f"largest {float(sizes.max()) / 1e9:.1f} GB); disks {float(rep.disk_cap.min()) / 1e9:.0f}"
          f"-{float(rep.disk_cap.max()) / 1e9:.0f} GB, {float(rep.disk_used.sum()) / 1e12:.2f} "
          f"TB of origin copies")
    work_rounds = [0]
    capacity_assign = make_capacity_assign(jobs.cores)

    def counted_assign(*args):
        work_rounds[0] += 1          # assign runs once per round with work
        return capacity_assign(*args)

    policy = T.with_capacity_assign(T.get_policy("panda_dispatch"), counted_assign)

    def run(rounds=max_rounds, **kw):
        return T.simulate(jobs, sites, policy, T.PRNGKey(0), data_policy=data, network=net,
                          replicas=rep, max_rounds=rounds, log_rows=DATA_LOG_ROWS,
                          device=device, **kw)

    def reset():
        assign_mod.launches = fused_mod.launches = segsum_mod.launches = 0
        TR.evicting_calls = 0
        work_rounds[0] = 0

    def no_plain_version(*args, **kw):
        raise SmokeFailure("the data path called a plain assignment version on the card")

    out = {}
    plain = assign_ops.assign_ref, assign_ops.fused_assign_ref
    assign_ops.assign_ref = assign_ops.fused_assign_ref = no_plain_version
    try:
        # (a) the dense data path, twice
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        launches = {"assign": assign_mod.launches, "segment_sum": segsum_mod.launches}
        evicting, rounds_with_work = TR.evicting_calls, work_rounds[0]
        t0 = time.perf_counter()
        res2 = run()
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        r = res.replicas
        inv = T.catalog_invariants(r)
        print(f"[data] (a) rounds={res.rounds} rounds_with_work={rounds_with_work} "
              f"launches={json.dumps(launches)} ({launches['segment_sum'] / res.rounds:.2f} "
              f"segment sums a round); n_hits={int(r.n_hits)} n_transfers={int(r.n_transfers)} "
              f"bytes_moved={float(r.bytes_moved):.6e}; insert_mask calls under storage "
              f"pressure (need > 0, the evicting path): {evicting} of {res.rounds}; "
              f"invariants {json.dumps(inv)}")
        check(launches["assign"] > 0 and launches["assign"] == rounds_with_work,
              f"assign launches {launches['assign']} != rounds with work {rounds_with_work}")
        check(launches["segment_sum"] > 0, "the data path never launched the segment sum")
        check(int(r.n_transfers) > 0 and int(r.n_hits) > 0, "no WAN transfer or no cache hit")
        check(all(inv.values()), f"catalog invariants broken: {inv}")
        check_invariants(res, "data")
        bad = mismatches(full_snapshot(res), full_snapshot(res2))
        check(not bad, f"two data runs on the card differ: {bad}")
        print(f"[data] (a) second run bit-identical (jobs, catalog, log); rounds/s "
              f"first={res.rounds / wall1:.2f} second={res2.rounds / wall2:.2f}; the plain "
              f"dense path in this call (phase 3): first={plain_rates[0]:.2f} "
              f"second={plain_rates[1]:.2f}")
        print(f"[data] (a) {T.summary_str(T.compute_metrics(res))}")
        prof = profile_rounds(lambda: run(SHORT_PROFILE_ROUNDS), "data-profile",
                              names=ASSIGN_KERNELS, rounds=SHORT_PROFILE_ROUNDS)
        if prof:
            print(f"[data] (a) {prof['kernels'] / SHORT_PROFILE_ROUNDS:.1f} kernels a round "
                  f"over the {SHORT_PROFILE_ROUNDS} profiled rounds")
        # source selection alone, as each round calls it: every job's
        # nearest replica toward its site
        dst = res.jobs.site.clamp(0, ENGINE_S - 1)
        ns_call = cuda_ms(lambda: T.nearest_source(res.replicas, net, jobs.dataset, dst), 20)
        ns_dev, ns_kernels = total_device_ms(
            lambda: T.nearest_source(res.replicas, net, jobs.dataset, dst), 20)
        print(f"[data] (a) nearest_source at J={ENGINE_J} S={ENGINE_S}: {ns_call:.4f} ms a call "
              f"between CUDA events, {ns_dev:.4f} ms device time in {ns_kernels:g} kernels")
        out["a"] = launches

        # (b) the same with the FTS transfer queues
        reset()
        ts0 = T.make_transfers(ENGINE_S, jobs, max_active=4, queue_slots=DATA_QUEUE_SLOTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_b = run(DATA_TR_ROUNDS, transfers=ts0)
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0
        launches = {"assign": assign_mod.launches, "segment_sum": segsum_mod.launches}
        led = ledger(res_b.ext["transfers"])
        print(f"[data] (b) transfers (max_active=4, queue_slots={DATA_QUEUE_SLOTS}): "
              f"rounds={res_b.rounds} rounds/s={res_b.rounds / wall_b:.2f} "
              f"launches={json.dumps(launches)} ({launches['segment_sum'] / res_b.rounds:.2f} "
              f"segment sums a round); ledger {json.dumps(led)}; n_overflow={led['n_overflow']}; "
              f"evicting insert_mask calls {TR.evicting_calls}")
        check(led["n_enq"] > 0 and led["n_done"] > 0, "no transfer was enqueued and landed")
        check(launches["assign"] == work_rounds[0] > 0, "assign launches != rounds with work")
        check_invariants(res_b, "data+tr")
        out["b"] = launches
        out["rate_b"] = res_b.rounds / wall_b

        # (c) sparse: data_locality, the fused kernel, topk=16, with the catalog
        reset()
        fused_assign = make_fused_capacity_assign(jobs.cores)

        def counted_fused(*args):
            work_rounds[0] += 1
            return fused_assign(*args)

        sparse_policy = T.with_fused_assign(T.get_policy("data_locality"), counted_fused)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_c = T.simulate(jobs, sites, sparse_policy, T.PRNGKey(0), data_policy=data,
                           network=net, replicas=rep, max_rounds=DATA_SPARSE_ROUNDS, topk=ENGINE_K,
                           log_rows=DATA_LOG_ROWS, device=device)
        torch.cuda.synchronize()
        wall_c = time.perf_counter() - t0
        launches = {"fused_assign": fused_mod.launches, "assign": assign_mod.launches,
                    "segment_sum": segsum_mod.launches}
        print(f"[data] (c) sparse data_locality topk={ENGINE_K}: rounds={res_c.rounds} "
              f"rounds/s={res_c.rounds / wall_c:.2f} launches={json.dumps(launches)}; "
              f"n_hits={int(res_c.replicas.n_hits)} n_transfers={int(res_c.replicas.n_transfers)}")
        check(launches["fused_assign"] > 0 and launches["fused_assign"] == work_rounds[0],
              f"fused launches {launches['fused_assign']} != rounds with work {work_rounds[0]}")
        check(launches["assign"] == 0, "the sparse data path launched the dense assign kernel")
        check(all(T.catalog_invariants(res_c.replicas).values()), "sparse: catalog invariants")
        check_invariants(res_c, "data sparse")
        out["c"] = launches
    finally:
        assign_ops.assign_ref, assign_ops.fused_assign_ref = plain
    return out


def data_cross_scenario(dev, combo: str, max_rounds: int, faults=None):
    """Phase 12's two runs at S=50 with disks of ``memory * XDATA_DISK``:
    ``"workflows"`` is 1250 ATLAS MC workflows with ``scenario_replicas``,
    the flaky-site calendar, ``cache_on_read`` and the transfer queues
    (``max_active=2``) under dense capacity dispatch; ``"fused"`` is 5000
    synthetic jobs on a 1024-dataset catalog, ``data_locality`` with the
    fused kernel at ``topk=8`` under ``cache_on_read``.  ``faults``, when
    given, builds a fault state from the jobs, the catalog and the device
    (phase 15)."""
    from repro_torch import core as T
    from repro_torch.kernels.assign import make_capacity_assign, make_fused_capacity_assign

    net = T.atlas_like_network(XDATA_S, seed=2, device=dev)
    data = T.get_data_policy("cache_on_read")
    kw = dict(max_rounds=max_rounds, log_rows=max_rounds, device=dev)
    if combo == "workflows":
        scn, sites, av = subsystem_scenario(dev, XDATA_S, XDATA_CHAINS)
        rep = T.scenario_replicas(scn, sites.memory.cpu().numpy() * XDATA_DISK[combo], seed=1)
        policy = T.with_capacity_assign(T.get_policy("critical_path_first"),
                                        make_capacity_assign(scn.jobs.cores))
        if faults is not None:
            kw["faults"] = faults(scn.jobs, rep, dev)
        return T.simulate(scn.jobs, sites, policy, T.PRNGKey(0), availability=av,
                          workflow=scn.workflow, data_policy=data, network=net, replicas=rep,
                          transfers=T.make_transfers(XDATA_S, scn.jobs, max_active=2,
                                                     queue_slots=DATA_QUEUE_SLOTS, device=dev),
                          **kw)
    sites = T.atlas_like_platform(XDATA_S, seed=1, fail_rate=0.02, device=dev)
    jobs = T.synthetic_panda_jobs(XDATA_J, seed=0, n_datasets=DATA_D, device=dev)
    rep = T.make_replicas(T.zipf_dataset_sizes(DATA_D, seed=3), sites.memory * XDATA_DISK[combo],
                          seed=4, device=dev)
    policy = T.with_fused_assign(T.get_policy("data_locality"),
                                 make_fused_capacity_assign(jobs.cores))
    return T.simulate(jobs, sites, policy, T.PRNGKey(0), data_policy=data, network=net,
                      replicas=rep, topk=8, **kw)


def phase_data_card_vs_cpu(device, max_rounds: int) -> dict:
    """Phase 12: each of ``data_cross_scenario``'s runs on the card equals
    the CPU's (catalog and transfer state included), goes under storage
    pressure at least once, and exports the same transfer rows, transition
    rows and ML NDJSON byte for byte."""
    import io

    import torch

    from repro_torch.core import events as TE
    from repro_torch.core import replicas as TR
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import fused_cuda as fused_mod
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    out = {}
    for combo in ("workflows", "fused"):
        runs = {}
        for dev in (device, torch.device("cpu")):
            threads = torch.get_num_threads()
            torch.set_num_threads(1 if dev.type == "cpu" else threads)
            assign_mod.launches = fused_mod.launches = segsum_mod.launches = 0
            TR.evicting_calls = 0
            t0 = time.perf_counter()
            try:
                res = data_cross_scenario(dev, combo, max_rounds)
            finally:
                torch.set_num_threads(threads)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                kernel = "fused_assign" if combo == "fused" else "assign"
                launched = fused_mod.launches if combo == "fused" else assign_mod.launches
                out[kernel] = out.get(kernel, 0) + launched
                out["segment_sum"] = out.get("segment_sum", 0) + segsum_mod.launches
                check(launched > 0 and segsum_mod.launches > 0,
                      f"{combo}: the run did not launch {kernel} and the segment sum")
            wall = time.perf_counter() - t0
            evicting = TR.evicting_calls
            buf = io.StringIO()
            TE.write_ml_dataset(res, buf)
            exports = dict(transfers=TE.to_csv(TE.transfer_rows(res)), ml=buf.getvalue(),
                           transitions=TE.to_csv(TE.transition_rows(res)))
            extra = ""
            if "transfers" in res.ext:
                extra = f" ledger {json.dumps(ledger(res.ext['transfers']))}"
            print(f"[xdata] {combo} {dev.type}: rounds={res.rounds} "
                  f"makespan={float(res.makespan)!r} n_hits={int(res.replicas.n_hits)} "
                  f"n_transfers={int(res.replicas.n_transfers)} evicting insert_mask calls "
                  f"{evicting} wall={wall:.2f}s ({res.rounds / wall:.1f} rounds/s);"
                  f"{extra} {exports['transfers'].count(chr(10))} transfer CSV lines")
            check(evicting > 0, f"{combo} {dev.type}: no storage pressure in the run")
            check(int(res.replicas.n_transfers) > 0, f"{combo}: no WAN transfer")
            check_invariants(res, f"xdata {combo} {dev.type}")
            runs[dev.type] = full_snapshot(res), exports
        bad = mismatches(runs["cuda"][0], runs["cpu"][0])
        print(f"[xdata] {combo} card vs CPU mismatch counts: {json.dumps(bad)}")
        check(not bad, f"{combo}: the card's run differs from the CPU's")
        for k, text in runs["cuda"][1].items():
            check(text == runs["cpu"][1][k], f"{combo}: the card's {k} export differs")
        print(f"[xdata] {combo}: transfer CSV, transition CSV and ML NDJSON byte-identical "
              f"({', '.join(str(len(t)) for t in runs['cuda'][1].values())} B)")
    return out


# phases 13 to 15: fault injection, segmented runs and the flight recorder
FAULT_SEGMENTS = 8
# bench_faults.py:91-97 arms walltime = 4 h; 2000 rounds at full width span
# ~400 simulated seconds, so a 4 h limit kills nothing and no limit above
# the span can: 300 s kills every job still running 300 s after its start
FAULT_WALLTIME = 300.0
# phase 14's replica-loss calendar: every loss event is an event round, and a
# loss only drops a cached (non-origin) replica, a few hundred of the 307200
# (dataset, site) cells in 600 rounds; so losses come often (FAULT_LOSS_RATE a
# site a second, over the first FAULT_LOSS_HORIZON seconds) and are applied at
# the storage elements' consistency scans, every FAULT_LOSS_SCAN seconds
FAULT_LOSS_RATE = 2.0
FAULT_LOSS_HORIZON = 300.0
FAULT_LOSS_SCAN = 30.0
XFAULT_ROUNDS = 300            # depth cut of phase 15's blackhole runs
XFAULT_MATRIX_ROUNDS = 120     # depth cut of phase 15's matrix run (transfer failures by round 120)
XFAULT_J = 5000                # phase 15's blackhole-site jobs at S = 50
# the fused run rebuilds its candidate index every XFAULT_REFRESH rounds: at
# t = 0 every 8-core site ties under least_loaded's pre-rank, so the index
# holds sites 0-7 and never the flaky site (44) until the load moves it up
XFAULT_REFRESH = 25


def faults_scenario(device):
    """Phase 13's configuration: ``flaky_grid(300, n_flaky=3, seed=1)``,
    100000 jobs, the fault channels that need no transfers armed as in
    ``bench_faults.py:91-97`` (``job_backoff=60``, ``blacklist_threshold=
    0.7``, ``max_retries=4``) with a walltime of ``FAULT_WALLTIME``."""
    from repro_torch import core as T

    sites, flaky = T.flaky_grid(ENGINE_S, n_flaky=3, seed=1, device=device)
    jobs = T.synthetic_panda_jobs(ENGINE_J, seed=0, duration=6 * 3600.0, device=device)
    faults = T.make_faults(ENGINE_S, jobs, job_backoff=60.0, walltime=FAULT_WALLTIME,
                           blacklist_threshold=0.7, device=device)
    return sites, flaky, jobs, faults


def phase_faults_full_width(device, max_rounds: int, plain_rates, plain_prof) -> dict:
    """Phase 13: the fault channels at WLCG scale, once through ``simulate``
    with a recorder and once through ``monitor.watch`` in ``FAULT_SEGMENTS``
    segments with an NDJSON sink and a recorder; the two results must be
    bit-identical.  Counters set to 0 just before the first run."""
    import io
    import tempfile

    import torch

    from repro_torch import core as T
    from repro_torch.core import engine as E
    from repro_torch.core import monitor as TM
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import make_capacity_assign
    from repro_torch.kernels.assign import ops as assign_ops
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    t0 = time.perf_counter()
    sites, flaky, jobs, faults = faults_scenario(device)
    print(f"[faults] scenario built in {time.perf_counter() - t0:.2f}s: S={ENGINE_S} J={ENGINE_J}, "
          f"flaky sites {flaky.tolist()} at fail_rate 0.9, walltime {FAULT_WALLTIME:g} s, "
          f"job_backoff 60 s, breaker at 0.7, max_retries 4")
    work_rounds = [0]
    capacity_assign = make_capacity_assign(jobs.cores)

    def counted_assign(*args):
        work_rounds[0] += 1          # assign runs once per round with work
        return capacity_assign(*args)

    policy = T.with_capacity_assign(T.get_policy("panda_dispatch"), counted_assign)
    kw = dict(faults=faults, max_retries=4, max_rounds=max_rounds, log_rows=SUB_LOG_ROWS,
              device=device)

    def no_plain_version(*args, **kw):
        raise SmokeFailure("the faults path called assign_ref on the card")

    plain = assign_ops.assign_ref
    assign_ops.assign_ref = no_plain_version
    try:
        assign_mod.launches = segsum_mod.launches = 0
        rec1 = T.TraceRecorder()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = T.simulate(jobs, sites, policy, T.PRNGKey(0), recorder=rec1, **kw)
        wall1 = time.perf_counter() - t0
        launches = {"assign": assign_mod.launches, "segment_sum": segsum_mod.launches}
        rounds_with_work = work_rounds[0]
        # the same run in segments, each ended at a simulated time, with
        # frames streamed to an NDJSON file between them
        rec2 = T.TraceRecorder()
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "faults.ndjson"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with T.NDJSONSink(path) as sink:
                res2 = TM.watch(jobs, sites, policy, T.PRNGKey(0),
                                segment=float(res.makespan) / (FAULT_SEGMENTS - 0.5),
                                sink=sink, render=False, recorder=rec2, **kw)
            torch.cuda.synchronize()
            wall2 = time.perf_counter() - t0
            shown = io.StringIO()
            n_frames = TM.follow_stream(path, clear=False, out=shown)
            stream_bytes = path.stat().st_size
    finally:
        assign_ops.assign_ref = plain
    fs = res.ext["faults"]
    counts = {k: int(getattr(fs, k)) for k in ("n_kills", "n_bl_trips", "n_probes")}
    counts["backoff_wait_s"] = float(fs.backoff_wait.sum())
    counts["time_lost_s"] = float(fs.time_lost)
    counts["tripped_sites_at_cut"] = int((fs.bl_state == T.BL_TRIPPED).sum())
    print(f"[faults] rounds={res.rounds} rounds_with_work={rounds_with_work} "
          f"launches={json.dumps(launches)} ({launches['segment_sum'] / res.rounds:.2f} segment "
          f"sums a round) makespan={float(res.makespan)!r} {json.dumps(counts)}")
    check(launches["assign"] > 0 and launches["assign"] == rounds_with_work,
          f"assign launches {launches['assign']} != rounds with work {rounds_with_work}")
    check(launches["segment_sum"] > 0, "the faults path never launched the segment sum")
    check(counts["n_kills"] > 0, "no walltime kill")
    check(counts["n_bl_trips"] > 0, "the circuit breaker never tripped")
    check(counts["backoff_wait_s"] > 0, "no resubmission backoff")
    check_invariants(res, "faults")
    bad = mismatches(full_snapshot(res), full_snapshot(res2))
    check(not bad, f"watch in segments differs from simulate: {bad}")
    n_seg = rec2.counters.get("watch_segments")
    check(n_seg == FAULT_SEGMENTS, f"watch ran {n_seg} segments, not {FAULT_SEGMENTS}")
    check(n_frames == FAULT_SEGMENTS and "end: rounds=" in shown.getvalue(),
          f"follow_stream rendered {n_frames} frames")
    print(f"[faults] watch in {n_seg} segments bit-identical to simulate (jobs, sites, log, "
          f"fault state); rounds/s simulate={res.rounds / wall1:.2f} watch={res2.rounds / wall2:.2f};"
          f" the plain dense path in this call (phase 3): first={plain_rates[0]:.2f} "
          f"second={plain_rates[1]:.2f}")
    print(f"[faults] recorder spans: simulate {json.dumps(rec1.summary()['spans'])}; watch "
          f"{json.dumps(rec2.summary()['spans'])}; stream {stream_bytes} B, {n_frames} frames "
          f"rendered by follow_stream ({len(shown.getvalue())} characters)")
    print(f"[faults] {T.summary_str(T.compute_metrics(res))}")

    # what job_backoff costs the start order: the packed single-key sort the
    # engine uses when arrivals are run-constant, against the general one
    in_queue = res.jobs.state == T.ASSIGNED
    sort_site = torch.where(in_queue, res.jobs.site, ENGINE_S)
    srank = E._static_start_rank(res.jobs)      # the rank of the arrivals as they are now
    zeros = torch.zeros((ENGINE_J,), dtype=torch.float32, device=device)
    packed = lambda: E._start_order_packed(sort_site.long() * ENGINE_J + srank)  # noqa: E731
    general = lambda: E._start_order(sort_site, res.jobs.priority, zeros, res.jobs.arrival)  # noqa: E731
    order = {}
    for name, fn in (("packed", packed), ("general", general)):
        dev_ms, kernels = total_device_ms(fn, 20)
        order[name] = dict(call_ms=round(cuda_ms(fn, 20), 4), device_ms=round(dev_ms, 4),
                           kernels=kernels)
    check(bool((packed() == general()).all()), "the two start orders differ")
    print(f"[faults] start order at J={ENGINE_J}: {json.dumps(order)}")
    prof = profile_rounds(lambda: T.simulate(jobs, sites, policy, T.PRNGKey(0),
                                             **{**kw, "max_rounds": SHORT_PROFILE_ROUNDS}),
                          "faults-profile", names=ASSIGN_KERNELS, rounds=SHORT_PROFILE_ROUNDS)
    if prof and plain_prof:
        print(f"[faults] {prof['kernels'] / SHORT_PROFILE_ROUNDS:.1f} kernels a round over "
              f"{SHORT_PROFILE_ROUNDS} profiled rounds, the plain dense path "
              f"{plain_prof['kernels'] / PROFILE_ROUNDS:.1f} (phase 3, same call)")
    launches["rounds"] = res.rounds
    launches["rate"] = res.rounds / wall1
    return launches


def phase_faults_transfers_full_width(device, max_rounds: int) -> dict:
    """Phase 14: phase 11(b)'s data path with the transfer queues and the
    fault channels that need them: lossy links (``lossy_links(300, p=0.05,
    hot=3)``), ``xfer_backoff=30`` and a replica-loss calendar over the 1024
    datasets.  Counters set to 0 just before the run."""
    import torch

    from repro_torch import core as T
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import make_capacity_assign
    from repro_torch.kernels.assign import ops as assign_ops
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    t0 = time.perf_counter()
    sites = T.atlas_like_platform(ENGINE_S, seed=1, device=device)
    jobs = T.synthetic_panda_jobs(ENGINE_J, seed=0, duration=6 * 3600.0, n_datasets=DATA_D,
                                  zipf_alpha=1.2, device=device)
    net = T.atlas_like_network(ENGINE_S, seed=2, device=device)
    rep = T.make_replicas(T.zipf_dataset_sizes(DATA_D, seed=3), sites.memory * 1e9, seed=4,
                          device=device)
    losses = [(math.ceil(t / FAULT_LOSS_SCAN) * FAULT_LOSS_SCAN, d, site)
              for t, d, site in T.replica_loss_calendar(rep, ENGINE_S, horizon=FAULT_LOSS_HORIZON,
                                                        rate=FAULT_LOSS_RATE, seed=5)]
    faults = T.make_faults(ENGINE_S, jobs, link_fail_p=T.lossy_links(ENGINE_S, p=0.05, hot=3,
                                                                     seed=3),
                           xfer_backoff=30.0, replica_loss=losses, device=device)
    print(f"[xfaults] scenario built in {time.perf_counter() - t0:.2f}s: phase 11's data path, "
          f"lossy links (p 0.05, 3 hot sites at 0.3), {len(losses)} replica-loss events over "
          f"{FAULT_LOSS_HORIZON:g} s, applied every {FAULT_LOSS_SCAN:g} s")
    work_rounds = [0]
    capacity_assign = make_capacity_assign(jobs.cores)

    def counted_assign(*args):
        work_rounds[0] += 1
        return capacity_assign(*args)

    policy = T.with_capacity_assign(T.get_policy("panda_dispatch"), counted_assign)

    def run(rounds=max_rounds):
        return T.simulate(jobs, sites, policy, T.PRNGKey(0),
                          data_policy=T.get_data_policy("cache_on_read"), network=net,
                          replicas=rep, transfers=T.make_transfers(
                              ENGINE_S, jobs, max_active=4, queue_slots=DATA_QUEUE_SLOTS,
                              device=device),
                          faults=faults, max_rounds=rounds, log_rows=DATA_LOG_ROWS,
                          device=device)

    def no_plain_version(*args, **kw):
        raise SmokeFailure("the transfer-faults path called assign_ref on the card")

    plain = assign_ops.assign_ref
    assign_ops.assign_ref = no_plain_version
    try:
        assign_mod.launches = segsum_mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"assign": assign_mod.launches, "segment_sum": segsum_mod.launches}
        rounds_with_work = work_rounds[0]
        prof = profile_rounds(lambda: run(SHORT_PROFILE_ROUNDS), "xfaults-profile",
                              names=ASSIGN_KERNELS, rounds=SHORT_PROFILE_ROUNDS)
    finally:
        assign_ops.assign_ref = plain
    fs = res.ext["faults"]
    led = ledger(res.ext["transfers"], fs)
    counts = {k: int(getattr(fs, k)) for k in ("n_xfer_fail", "n_xfer_retry", "n_xfer_exhaust",
                                               "n_lost_replicas")}
    inv = T.catalog_invariants(res.replicas)
    print(f"[xfaults] rounds={res.rounds} makespan={float(res.makespan)!r} rounds/s="
          f"{res.rounds / wall:.2f} launches={json.dumps(launches)} "
          f"({launches['segment_sum'] / res.rounds:.2f} segment sums a round); ledger "
          f"{json.dumps(led)}; {json.dumps(counts)}; loss events applied "
          f"{int(fs.loss_done.sum())}; invariants {json.dumps(inv)}")
    if prof:
        print(f"[xfaults] {prof['kernels'] / SHORT_PROFILE_ROUNDS:.1f} kernels a round over "
              f"{SHORT_PROFILE_ROUNDS} profiled rounds")
    check(launches["assign"] == rounds_with_work > 0, "assign launches != rounds with work")
    check(counts["n_xfer_fail"] > 0, "no transfer failed")
    check(counts["n_lost_replicas"] > 0, "no replica was lost")
    check(all(inv.values()), f"catalog invariants broken: {inv}")
    check_invariants(res, "xfaults")
    launches["rounds"] = res.rounds
    return launches


def faults_blackhole(dev, fused: bool, max_rounds: int):
    """``bench_faults.py:42-63``'s blackhole-site scenario at S = 50:
    ``flaky_grid(50, n_flaky=1)`` of 8-core sites, ``XFAULT_J`` one-core
    jobs arriving over 2000 s, ``least_loaded`` with capacity dispatch (or
    the fused kernel at ``topk=8``, its index rebuilt every
    ``XFAULT_REFRESH`` rounds), resubmission backoff and the breaker
    (``bench_faults.py:119-120``)."""
    import numpy as np
    import torch

    from repro_torch import core as T
    from repro_torch.kernels.assign import make_capacity_assign, make_fused_capacity_assign

    sites, _ = T.flaky_grid(XDATA_S, n_flaky=1, seed=12, cores_range=(8, 8),
                            speed_range=(10.0, 10.0), device=dev)
    rng = np.random.default_rng(7)
    jobs = T.synthetic_panda_jobs(XFAULT_J, seed=7, capacity=XFAULT_J + 3, device=dev)
    jobs = jobs._replace(
        arrival=torch.as_tensor(np.pad(np.sort(rng.uniform(0.0, 2000.0, XFAULT_J)), (0, 3),
                                       constant_values=np.inf), dtype=torch.float32, device=dev),
        work=torch.as_tensor(np.pad(rng.lognormal(np.log(800.0), 0.6, XFAULT_J), (0, 3)),
                             dtype=torch.float32, device=dev),
        cores=torch.ones((jobs.capacity,), dtype=torch.int32, device=dev),
        memory=torch.full((jobs.capacity,), 2.0, device=dev),
    )
    base = T.get_policy("least_loaded")
    policy = (T.with_fused_assign(base, make_fused_capacity_assign(jobs.cores)) if fused
              else T.with_capacity_assign(base, make_capacity_assign(jobs.cores)))
    faults = T.make_faults(XDATA_S, jobs, job_backoff=120.0, blacklist_threshold=0.6,
                           blacklist_alpha=0.5, blacklist_cooldown=600.0, device=dev)
    sparse = dict(topk=8, topk_refresh=XFAULT_REFRESH) if fused else {}
    return T.simulate(jobs, sites, policy, T.PRNGKey(1), faults=faults, max_retries=6,
                      max_rounds=max_rounds, log_rows=max_rounds, device=dev, **sparse)


def matrix_faults(jobs, rep, dev):
    """The golden matrix's fault state (``tests/test_golden_trace.py``) at
    S = 50, its three loss events replaced by a calendar over the catalog."""
    from repro_torch import core as T

    return T.make_faults(XDATA_S, jobs, link_fail_p=0.3, xfer_backoff=120.0,
                         max_xfer_attempts=3, job_backoff=60.0, walltime=4000.0,
                         replica_loss=T.replica_loss_calendar(rep, XDATA_S, horizon=20000.0,
                                                              rate=1 / 2000.0, seed=5),
                         blacklist_threshold=0.5, blacklist_alpha=0.5,
                         blacklist_cooldown=1800.0, device=dev)


def phase_faults_card_vs_cpu(device, max_rounds: int) -> dict:
    """Phase 15: card against CPU at S = 50, cut to ``max_rounds`` rounds,
    every round logged: phase 12's workflow run (availability, workflows,
    data, transfers) with the golden matrix's fault state, and the
    blackhole-site scenario under dense capacity dispatch and the fused
    kernel at ``topk=8``.  States, the log, ``fault_rows``, the transition
    rows and the ML NDJSON must be equal byte for byte."""
    import io

    import torch

    from repro_torch.core import events as TE
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import fused_cuda as fused_mod
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    runs = {
        "matrix": lambda dev: data_cross_scenario(dev, "workflows", XFAULT_MATRIX_ROUNDS,
                                                  faults=matrix_faults),
        "blackhole dense": lambda dev: faults_blackhole(dev, False, max_rounds),
        "blackhole fused": lambda dev: faults_blackhole(dev, True, max_rounds),
    }
    out = {}
    for name, build in runs.items():
        got = {}
        for dev in (device, torch.device("cpu")):
            threads = torch.get_num_threads()
            torch.set_num_threads(1 if dev.type == "cpu" else threads)
            assign_mod.launches = fused_mod.launches = segsum_mod.launches = 0
            t0 = time.perf_counter()
            try:
                res = build(dev)
            finally:
                torch.set_num_threads(threads)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                kernel = "fused_assign" if "fused" in name else "assign"
                launched = fused_mod.launches if "fused" in name else assign_mod.launches
                out[kernel] = out.get(kernel, 0) + launched
                out["segment_sum"] = out.get("segment_sum", 0) + segsum_mod.launches
                check(launched > 0 and segsum_mod.launches > 0,
                      f"{name}: the run did not launch {kernel} and the segment sum")
            wall = time.perf_counter() - t0
            fs = res.ext["faults"]
            buf = io.StringIO()
            TE.write_ml_dataset(res, buf)
            exports = dict(faults=TE.to_csv(TE.fault_rows(res)), ml=buf.getvalue(),
                           transitions=TE.to_csv(TE.transition_rows(res)))
            counts = {k: int(getattr(fs, k)) for k in ("n_kills", "n_xfer_fail",
                                                       "n_lost_replicas", "n_bl_trips",
                                                       "n_probes")}
            extra = ""
            if "transfers" in res.ext:
                extra = f" ledger {json.dumps(ledger(res.ext['transfers'], fs))}"
            print(f"[xfault] {name} {dev.type}: rounds={res.rounds} "
                  f"makespan={float(res.makespan)!r} {json.dumps(counts)} wall={wall:.2f}s "
                  f"({res.rounds / wall:.1f} rounds/s);{extra}")
            check_invariants(res, f"xfault {name} {dev.type}")
            got[dev.type] = full_snapshot(res), exports, counts
        bad = mismatches(got["cuda"][0], got["cpu"][0])
        print(f"[xfault] {name} card vs CPU mismatch counts: {json.dumps(bad)}")
        check(not bad, f"{name}: the card's run differs from the CPU's")
        for k, text in got["cuda"][1].items():
            check(text == got["cpu"][1][k], f"{name}: the card's {k} export differs")
        counts = got["cpu"][2]
        check(counts["n_bl_trips"] > 0 if "blackhole" in name else counts["n_xfer_fail"] > 0,
              f"{name}: the fault channels did not fire: {counts}")
        print(f"[xfault] {name}: fault CSV, ML NDJSON and transition CSV byte-identical "
              f"({', '.join(str(len(t)) for t in got['cuda'][1].values())} B)")
    return out


# phase 16: scenario ensembles (simulate_many) on the lane axis
ENS_ROUNDS = 300
ENS_BUCKETS = 4
ENS_BUCKET_ROUNDS = 50         # depth cut of (a)'s bucketed rerun (and of phase 19's dense lanes)
ENS_SUB_K = 4
ENS_SUB_ROUNDS = 200
XENS_S, XENS_CHAINS = 50, (750, 1000, 1125, 1250)   # (c): 3000 to 5000 jobs a lane
XENS_ROUNDS = 200              # depth cut of 16(c)'s workflow lanes (preemptions by round 200)
# (c)'s second run: four small lanes with data, transfer queues and faults at
# topk=8, which drain at different rounds (168 to 277 of a CPU run)
XENS_DATA_JOBS, XENS_DATA_D, XENS_DATA_ROUNDS = (40, 55, 70, 85), 64, 400
ENS_SPARSE_ROUNDS = 200        # phase 16(d) (and phase 19's sparse lanes)
ENS_DATA_K, ENS_DATA_ROUNDS = 4, 150   # phase 16(e)
ENS_FAULT_ROUNDS = 1200        # 16(e)'s fault lanes: the walltime kills start at
                               # 300 simulated seconds, ~1150 rounds in


def lane_capacity_assign(stacks):
    """Capacity dispatch for ensembles whose lanes carry their own job cores:
    one ``make_capacity_assign`` a stacked job shape (``[K, J]``), picked by
    the scores' shape, so a bucketed run sizes each bucket's lanes by their
    own cores."""
    from repro_torch.kernels.assign import make_capacity_assign

    fns = {tuple(s.jobs.cores.shape): make_capacity_assign(s.jobs.cores) for s in stacks}

    def assign_fn(scores, queued, feasible, sites):
        return fns[tuple(scores.shape[:-1])](scores, queued, feasible, sites)

    return assign_fn


def lane_of(res, i):
    """Lane ``i`` of an ensemble's result as a solo ``SimResult``."""
    from repro_torch.core.engine import _tree_map

    out = _tree_map(lambda x: x[i], res)
    return out._replace(rounds=int(res.rounds[i]),
                        log=out.log._replace(cursor=int(res.log.cursor[i])))


def ensemble_scenarios(device, K: int = ENS_K):
    """Phase 16(a)'s 16 lanes: the WLCG platform with speeds x (0.7 + 0.04 i)
    and 62500 + 2500 i synthetic PanDA jobs (seed 10 + i), ragged up to
    100000; past 16 lanes (phase 19's scaling rows) lane i takes lane i % 16's
    speed and size and its own seed."""
    from repro_torch import core as T

    sites = T.atlas_like_platform(ENGINE_S, seed=1, device=device)
    return [T.Scenario(
        T.synthetic_panda_jobs(62_500 + 2_500 * (i % ENS_K), seed=10 + i, duration=6 * 3600.0,
                               device=device),
        sites._replace(speed=sites.speed * (0.7 + 0.04 * (i % ENS_K))))
        for i in range(K)]


def phase_ensemble_full_width(device, max_rounds: int, plain_rates) -> dict:
    """16 ragged lanes at WLCG scale through one ``simulate_many`` loop,
    ``panda_dispatch`` with capacity dispatch, twice (counters set to 0 just
    before the first run); then the same lanes in ENS_BUCKETS buckets, then
    lanes 0 and 15 alone."""
    import torch

    from repro_torch import core as T
    from repro_torch.core.rng import split
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import ops as assign_ops
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    t0 = time.perf_counter()
    scens = ensemble_scenarios(device)
    stacked = T.stack_scenarios(scens)
    sb = T.stack_scenarios(scens, buckets=ENS_BUCKETS)
    print(f"[ens] {ENS_K} lanes built in {time.perf_counter() - t0:.2f}s: S={ENGINE_S}, "
          f"J={[s.jobs.capacity for s in scens][:2]}..{scens[-1].jobs.capacity} padded to "
          f"{stacked.jobs.capacity}; buckets {[s.jobs.capacity for s in sb.buckets]}")
    shapes = []
    capacity_assign = lane_capacity_assign([stacked, *sb.buckets])

    def counted_assign(scores, *args):
        shapes.append(tuple(scores.shape))    # assign runs once per round with work
        return capacity_assign(scores, *args)

    policy = T.with_capacity_assign(T.get_policy("panda_dispatch"), counted_assign)
    key = T.PRNGKey(0)

    def run(scn=stacked, rounds=max_rounds):
        return T.simulate_many(scn, policy, key, max_rounds=rounds, device=device)

    def no_plain_version(*args, **kw):
        raise SmokeFailure("the ensemble path called assign_ref on the card")

    plain = assign_ops.assign_ref
    assign_ops.assign_ref = no_plain_version
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        assign_mod.launches = 0
        segsum_mod.launches = 0
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        launches = {"assign": assign_mod.launches, "segment_sum": segsum_mod.launches}
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        work = list(shapes)
    finally:
        assign_ops.assign_ref = plain
    rounds = res.rounds.tolist()
    loops = max(rounds)
    print(f"[ens] rounds per lane {rounds}; rounds_with_work={len(work)} "
          f"launches={json.dumps(launches)} ({launches['segment_sum'] / loops:.2f} segment sums "
          f"a round); peak memory {peak_gb:.2f} GB")
    check(launches["assign"] > 0, "the ensemble never launched the assign kernel")
    check(launches["assign"] == len(work),
          f"assign launches {launches['assign']} != rounds with work {len(work)}")
    check(all(s[0] == ENS_K for s in work),
          f"the assign kernel was not called once for all {ENS_K} lanes: {set(work)}")
    check(launches["segment_sum"] > 0, "the ensemble never launched the segment sum")
    for i in (0, ENS_K - 1):
        check_invariants(lane_of(res, i), f"ens lane {i}")
    snap1 = full_snapshot(res)

    timings = []
    real_assign = assign_ops.assign_cuda

    def timed_assign(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_assign(*args, **kw)
        end.record()
        timings.append((start, end))
        return out

    assign_ops.assign_cuda = timed_assign
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res2 = run()
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    finally:
        assign_ops.assign_cuda = real_assign
    bad = mismatches(snap1, full_snapshot(res2))
    check(not bad, f"two ensemble runs on the card differ: {bad}")
    call_s = sum(s.elapsed_time(e) for s, e in timings) / 1e3
    rates = (sum(rounds) / wall1, sum(res2.rounds.tolist()) / wall2)
    print(f"[ens] second run bit-identical; lane-rounds/s first={rates[0]:.2f} "
          f"second={rates[1]:.2f} ({loops / wall1:.2f} and {loops / wall2:.2f} rounds/s of the "
          f"loop) against phase 3's solo rounds/s first={plain_rates[0]:.2f} "
          f"second={plain_rates[1]:.2f} in this call; the batched assign {len(timings)} calls, "
          f"{1e3 * call_s / max(len(timings), 1):.4f} ms a call between CUDA events = "
          f"{100 * call_s / wall2:.2f}% of the run's wall time")
    prof = profile_rounds(lambda: run(rounds=SHORT_PROFILE_ROUNDS), "ens-profile",
                          names=ASSIGN_KERNELS, rounds=SHORT_PROFILE_ROUNDS)
    if prof:
        print(f"[ens] {prof['kernels'] / SHORT_PROFILE_ROUNDS:.1f} kernels a round of {ENS_K} "
              "lanes")

    flat = full_snapshot(run(rounds=ENS_BUCKET_ROUNDS))
    t0 = time.perf_counter()
    res_b = run(sb, ENS_BUCKET_ROUNDS)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    bad = mismatches(flat, full_snapshot(res_b))
    check(not bad, f"the bucketed ensemble differs from the flat one: {bad}")
    print(f"[ens] {ENS_BUCKETS} buckets equal the flat ensemble bit for bit over "
          f"{ENS_BUCKET_ROUNDS} rounds "
          f"({sum(res_b.rounds.tolist()) / wall_b:.2f} lane-rounds/s); padding "
          f"{json.dumps(sb.padding_stats()['summary'])}")
    occ = T.lane_occupancy(res, sb)["summary"]
    print(f"[ens] lane occupancy {json.dumps(occ)}")

    keys = split(key.to(device), ENS_K)
    for i in (0, ENS_K - 1):
        jobs = T.pad_jobs_capacity(scens[i].jobs, stacked.jobs.capacity)
        solo_policy = T.with_capacity_assign(T.get_policy("panda_dispatch"),
                                             lane_capacity_assign([T.Scenario(jobs, None)]))
        t0 = time.perf_counter()
        solo = T.simulate(jobs, scens[i].sites, solo_policy, keys[i], max_rounds=max_rounds,
                          device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bad = mismatches(full_snapshot(solo), full_snapshot(lane_of(res, i)))
        check(not bad, f"ensemble lane {i} differs from its solo run on the card: {bad}")
        print(f"[ens] lane {i} equals its solo run on the card ({solo.rounds / wall:.2f} "
              "rounds/s solo)")
    launches["rounds"] = loops
    launches["rates"] = rates
    launches["snapshot"] = flat    # ENS_BUCKET_ROUNDS rounds: phase 19's dense lanes
    return launches


def ensemble_subsystem_scenarios(device, n_sites, chains, horizon=86400.0):
    """Phase 9's pipeline, one lane a workload of ``chains[i]`` 4-stage
    workflows with its own flaky-site outage seed (2 + i); the calendars
    share their window count."""
    import numpy as np

    from repro_torch import core as T

    sites = T.atlas_like_platform(n_sites, seed=1, fail_rate=0.02, device=device)

    def outages(i, w=None):
        return T.flaky_sites(n_sites, np.arange(n_sites), horizon=horizon, mtbf=SUB_MTBF,
                             mean_down=1800.0, seed=2 + i, max_windows=w, device=device)

    W = max(outages(i).max_windows for i in range(len(chains)))
    scens = []
    for i, n in enumerate(chains):
        scn = T.atlas_mc_workflows(n, seed=i, arrival_span=3600.0, device=device)
        scens.append(T.Scenario(scn.jobs, sites,
                                {"availability": outages(i, W), "workflow": scn.workflow}))
    return scens


def phase_ensemble_subsystems_full_width(device, max_rounds: int, sub_rate) -> dict:
    """Four lanes of phase 9's configuration (300 sites, 25000 workflows,
    flaky sites at mtbf 30 min, each lane its own outage seed),
    ``critical_path_first`` with capacity dispatch, the 256-row log."""
    import torch

    from repro_torch import core as T
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    t0 = time.perf_counter()
    subs = (T.availability_subsystem(), T.workflow_subsystem())
    scens = ensemble_subsystem_scenarios(device, ENGINE_S, [SUB_CHAINS] * ENS_SUB_K)
    stacked = T.stack_scenarios(scens, subsystems=subs)
    print(f"[ens-sub] {ENS_SUB_K} lanes built in {time.perf_counter() - t0:.2f}s: "
          f"J={stacked.jobs.capacity}, W={stacked.ext['availability'].max_windows}")
    work = [0]
    capacity_assign = lane_capacity_assign([stacked])

    def counted(*args):
        work[0] += 1
        return capacity_assign(*args)

    policy = T.with_capacity_assign(T.get_policy("critical_path_first"), counted)
    assign_mod.launches = segsum_mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = T.simulate_many(stacked, policy, T.PRNGKey(0), subsystems=subs, max_rounds=max_rounds,
                          log_rows=SUB_LOG_ROWS, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"assign": assign_mod.launches, "segment_sum": segsum_mod.launches}
    rounds = res.rounds.tolist()
    n_pre = res.avail.n_preempted.sum(-1).tolist()
    check(launches["assign"] == work[0] > 0,
          f"assign launches {launches['assign']} != rounds with work {work[0]}")
    down = (res.log.extra["site_avail"] < 1).flatten(1).any(-1).tolist()
    check(any(down), "no outage took a site down in the logged rounds of any lane")
    for i in range(ENS_SUB_K):
        check_invariants(lane_of(res, i), f"ens-sub lane {i}")
    print(f"[ens-sub] rounds per lane {rounds}, a site down in the log per lane {down}, "
          f"clock {res.makespan.tolist()}, preempted per lane {n_pre}, cancelled "
          f"{res.wf.n_cancelled.tolist()}; launches={json.dumps(launches)} "
          f"({launches['segment_sum'] / max(rounds):.2f} segment sums a round); "
          f"lane-rounds/s={sum(rounds) / wall:.2f} against phase 9's solo rounds/s "
          f"{sub_rate:.2f} in this call")
    launches["rounds"] = max(rounds)
    return launches


def phase_ensemble_card_vs_cpu(device, max_rounds: int) -> dict:
    """Four ragged lanes at S=50 (3000 to 5000 jobs in workflows, flaky-site
    outages a lane) on the card and on the CPU: every array equal, and one
    lane's transition rows and ML dataset byte for byte."""
    import io

    import torch

    from repro_torch import core as T
    from repro_torch.core import events as TE
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    subs = (T.availability_subsystem(), T.workflow_subsystem())

    def run(dev):
        scens = ensemble_subsystem_scenarios(dev, XENS_S, XENS_CHAINS)
        stacked = T.stack_scenarios(scens, subsystems=subs)
        policy = T.with_capacity_assign(T.get_policy("critical_path_first"),
                                        lane_capacity_assign([stacked]))
        t0 = time.perf_counter()
        res = T.simulate_many(stacked, policy, T.PRNGKey(5), subsystems=subs,
                              max_rounds=max_rounds, log_rows=max_rounds, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lane = lane_of(res, len(XENS_CHAINS) - 1)
        buf = io.StringIO()
        TE.write_ml_dataset(lane, buf)
        exports = dict(csv=TE.to_csv(TE.transition_rows(lane)), ml=buf.getvalue())
        print(f"[xens] {dev.type}: rounds {res.rounds.tolist()}, preempted "
              f"{res.avail.n_preempted.sum(-1).tolist()}, wall={wall:.2f}s")
        return res, full_snapshot(res), exports

    assign_mod.launches = segsum_mod.launches = 0
    card, card_snap, card_exp = run(device)
    out = {"assign": assign_mod.launches, "segment_sum": segsum_mod.launches}
    check(out["assign"] > 0 and out["segment_sum"] > 0,
          "the S=50 ensemble did not launch assign and segment_sum")
    _, cpu_snap, cpu_exp = run(torch.device("cpu"))
    bad = mismatches(card_snap, cpu_snap)
    check(not bad, f"the card's S=50 ensemble differs from the CPU's: {bad}")
    for k in card_exp:
        check(card_exp[k] == cpu_exp[k], f"the card's lane {k} export differs from the CPU's")
    check(int(card.avail.n_preempted.sum()) > 0, "no preemption in the S=50 ensemble")
    print(f"[xens] card = CPU on every array; lane {len(XENS_CHAINS) - 1}'s transition CSV "
          f"and ML NDJSON byte-identical ({len(card_exp['csv'])} and {len(card_exp['ml'])} B); "
          f"launches {json.dumps(out)}")
    return out


def phase_ensemble_sparse_full_width(device, max_rounds: int, sparse_rates) -> dict:
    """Phase 16(d): phase 16(a)'s 16 ragged lanes with ``data_locality`` and
    the fused capacity assign at ``topk=16``: lane-rounds/s beside phase 4's
    solo rate, fused launches a round with work (one for all lanes), the
    device busy share and peak memory; lane 15 against its solo run."""
    import torch

    from repro_torch import core as T
    from repro_torch.core.rng import split
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import fused_cuda as fused_mod
    from repro_torch.kernels.assign import make_fused_capacity_assign
    from repro_torch.kernels.assign import ops as assign_ops
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    scens = ensemble_scenarios(device)
    stacked = T.stack_scenarios(scens)
    shapes = []
    fused = make_fused_capacity_assign(stacked.jobs.cores)

    def counted(scores_k, *args):
        shapes.append(tuple(scores_k.shape))   # assign_cand runs once per round with work
        return fused(scores_k, *args)

    policy = T.with_fused_assign(T.get_policy("data_locality"), counted)
    key = T.PRNGKey(0)

    def run(rounds=max_rounds):
        return T.simulate_many(stacked, policy, key, topk=ENGINE_K, max_rounds=rounds,
                               device=device)

    def no_plain_version(*args, **kw):
        raise SmokeFailure("the sparse ensemble called a plain assignment version on the card")

    plain = assign_ops.fused_assign_ref, assign_ops.assign_ref
    assign_ops.fused_assign_ref = assign_ops.assign_ref = no_plain_version
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        fused_mod.launches = assign_mod.launches = segsum_mod.launches = 0
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fused_assign": fused_mod.launches, "assign": assign_mod.launches,
                    "segment_sum": segsum_mod.launches}
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        work = list(shapes)
    finally:
        assign_ops.fused_assign_ref, assign_ops.assign_ref = plain
    rounds = res.rounds.tolist()
    rate = sum(rounds) / wall
    check(launches["fused_assign"] > 0 and launches["fused_assign"] == len(work),
          f"fused launches {launches['fused_assign']} != rounds with work {len(work)}")
    check(all(sh[0] == ENS_K for sh in work),
          f"the fused kernel was not called once for all {ENS_K} lanes: {set(work)}")
    check(launches["assign"] == 0, "the sparse ensemble launched the dense assign kernel")
    for i in (0, ENS_K - 1):
        check_invariants(lane_of(res, i), f"ens-sparse lane {i}")
    print(f"[ens-sparse] {ENS_K} lanes topk={ENGINE_K}: rounds per lane {rounds}; "
          f"rounds_with_work={len(work)} launches={json.dumps(launches)} "
          f"({launches['fused_assign'] / max(rounds):.2f} fused launches a round for all lanes, "
          f"{launches['segment_sum'] / max(rounds):.2f} segment sums a round); "
          f"lane-rounds/s={rate:.2f} ({max(rounds) / wall:.2f} rounds/s of the loop) against "
          f"phase 4's solo rounds/s first={sparse_rates[0]:.2f} second={sparse_rates[1]:.2f} "
          f"in this call; peak memory {peak_gb:.2f} GB")
    prof = profile_rounds(lambda: run(SHORT_PROFILE_ROUNDS), "ens-sparse-profile",
                          names=FUSED_KERNELS, rounds=SHORT_PROFILE_ROUNDS)
    if prof:
        print(f"[ens-sparse] {prof['kernels'] / SHORT_PROFILE_ROUNDS:.1f} kernels a round of "
              f"{ENS_K} "
              "lanes")
    i = ENS_K - 1
    jobs = T.pad_jobs_capacity(scens[i].jobs, stacked.jobs.capacity)
    solo_policy = T.with_fused_assign(T.get_policy("data_locality"),
                                      make_fused_capacity_assign(jobs.cores))
    solo = T.simulate(jobs, scens[i].sites, solo_policy, split(key.to(device), ENS_K)[i],
                      topk=ENGINE_K, max_rounds=max_rounds, device=device)
    bad = mismatches(full_snapshot(solo), full_snapshot(lane_of(res, i)))
    check(not bad, f"sparse ensemble lane {i} differs from its solo run on the card: {bad}")
    print(f"[ens-sparse] lane {i} equals its solo run on the card")
    launches["rounds"] = max(rounds)
    launches["rate"] = rate
    launches["snapshot"] = full_snapshot(res)
    return launches


def phase_ensemble_data_full_width(device, max_rounds: int, data_rate: float) -> dict:
    """Phase 16(e): four lanes of phase 11(b)'s configuration (300 sites,
    100000 jobs on the 1024-dataset catalog, ``cache_on_read``, the transfer
    queues at ``queue_slots=256``), each lane its own jobs (seed i) and
    catalog placement (seed 4 + i), ``panda_dispatch`` with capacity
    dispatch: lane-rounds/s beside phase 11(b)'s solo rate, the ledgers."""
    import torch

    from repro_torch import core as T
    from repro_torch.core import replicas as TR
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    t0 = time.perf_counter()
    sites = T.atlas_like_platform(ENGINE_S, seed=1, device=device)
    net = T.atlas_like_network(ENGINE_S, seed=2, device=device)
    subs = (T.data_subsystem(T.get_data_policy("cache_on_read")), T.transfers_subsystem())
    scens = []
    for i in range(ENS_DATA_K):
        jobs = T.synthetic_panda_jobs(ENGINE_J, seed=i, duration=6 * 3600.0, n_datasets=DATA_D,
                                      zipf_alpha=1.2, device=device)
        rep = T.make_replicas(T.zipf_dataset_sizes(DATA_D, seed=3), sites.memory * 1e9,
                              seed=4 + i, device=device)
        ts = T.make_transfers(ENGINE_S, jobs, max_active=4, queue_slots=DATA_QUEUE_SLOTS,
                              device=device)
        scens.append(T.Scenario(jobs, sites, {"data": (net, rep), "transfers": ts}))
    stacked = T.stack_scenarios(scens, subsystems=subs)
    ring = stacked.ext["transfers"].queue
    print(f"[ens-data] {ENS_DATA_K} lanes built in {time.perf_counter() - t0:.2f}s: "
          f"J={stacked.jobs.capacity}, rings {list(ring.shape)} "
          f"({ring.numel() * 4 / 1e9:.2f} GB each of queue and tickets)")
    work = [0]
    capacity_assign = lane_capacity_assign([stacked])

    def counted(*args):
        work[0] += 1
        return capacity_assign(*args)

    policy = T.with_capacity_assign(T.get_policy("panda_dispatch"), counted)
    assign_mod.launches = segsum_mod.launches = 0
    TR.evicting_calls = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = T.simulate_many(stacked, policy, T.PRNGKey(0), subsystems=subs, max_rounds=max_rounds,
                          log_rows=DATA_LOG_ROWS, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"assign": assign_mod.launches, "segment_sum": segsum_mod.launches}
    rounds = res.rounds.tolist()
    check(launches["assign"] == work[0] > 0,
          f"assign launches {launches['assign']} != rounds with work {work[0]}")
    leds = [ledger(lane_of(res, i).ext["transfers"]) for i in range(ENS_DATA_K)]
    check(all(led["n_done"] > 0 for led in leds), "a lane landed no transfer")
    for i in range(ENS_DATA_K):
        lane = lane_of(res, i)
        check(all(T.catalog_invariants(lane.replicas).values()), f"lane {i}: catalog invariants")
        check_invariants(lane, f"ens-data lane {i}")
    print(f"[ens-data] rounds per lane {rounds}; launches={json.dumps(launches)} "
          f"({launches['segment_sum'] / max(rounds):.2f} segment sums a round); ledgers "
          f"{json.dumps(leds)}; evicting insert_mask calls {TR.evicting_calls}; "
          f"lane-rounds/s={sum(rounds) / wall:.2f} against phase 11(b)'s solo rounds/s "
          f"{data_rate:.2f} in this call; peak memory "
          f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")

    # the trace of the lanes' rounds, and the suspect for their rate: a
    # catalog column sum (``_col_bytes``) over K * S = 1200 columns of 1024
    # datasets needs 38400 windows, past ``scan.sum_f32``'s one-launch limit
    col_calls = [0]
    col_bytes = TR._col_bytes

    def counted_col_bytes(*args):
        col_calls[0] += 1
        return col_bytes(*args)

    TR._col_bytes = counted_col_bytes
    try:
        prof = profile_rounds(
            lambda: T.simulate_many(stacked, policy, T.PRNGKey(0), subsystems=subs,
                                    max_rounds=SHORT_PROFILE_ROUNDS, log_rows=DATA_LOG_ROWS,
                                    device=device),
            "ens-data-profile", names=ASSIGN_KERNELS, rounds=SHORT_PROFILE_ROUNDS)
    finally:
        TR._col_bytes = col_bytes
    mask, size = res.replicas.present, res.replicas.size
    batched = col_bytes(mask, size)
    check(torch.equal(batched, torch.stack([col_bytes(mask[i], size[i])
                                             for i in range(ENS_DATA_K)])),
          "the lanes' catalog column sums differ from one call a lane")
    col_ms = cuda_ms(lambda: col_bytes(mask, size), iters=20)
    lane_col_ms = cuda_ms(lambda: [col_bytes(mask[i], size[i]) for i in range(ENS_DATA_K)],
                          iters=20)
    col_kernels = kernels_of(lambda: col_bytes(mask, size))
    per_round = col_calls[0] / (2 * SHORT_PROFILE_ROUNDS)   # profile_rounds runs twice
    round_ms = 1e3 * wall / max(rounds)
    print(f"[ens-data] _col_bytes at {list(mask.shape)}: {col_ms:.4f} ms a call between CUDA "
          f"events, {col_kernels} kernels; one call a lane: {lane_col_ms:.4f} ms for "
          f"{ENS_DATA_K}; {per_round:.2f} calls a round = "
          f"{100 * per_round * col_ms / round_ms:.2f}% of a {round_ms:.2f} ms round")
    if prof:
        print(f"[ens-data] {prof['kernels'] / SHORT_PROFILE_ROUNDS:.1f} kernels a round of "
              f"{ENS_DATA_K} lanes")
    launches["rounds"] = max(rounds)
    return launches


def ensemble_faults_scenarios(device):
    """Phase 16(e)'s second run: four lanes of phase 13's configuration
    (``faults_scenario``), lane i its own full-width jobs (seed i) and the
    fault state made for them."""
    from repro_torch import core as T

    sites, _, _, _ = faults_scenario(device)
    scens = []
    for i in range(ENS_DATA_K):
        jobs = T.synthetic_panda_jobs(ENGINE_J, seed=i, duration=6 * 3600.0, device=device)
        faults = T.make_faults(ENGINE_S, jobs, job_backoff=60.0, walltime=FAULT_WALLTIME,
                               blacklist_threshold=0.7, device=device)
        scens.append(T.Scenario(jobs, sites, {"faults": faults}))
    return scens


def phase_ensemble_faults_full_width(device, max_rounds: int, fault_rate: float) -> dict:
    """Phase 16(e)'s second run: four lanes of phase 13's fault channels at
    WLCG scale through one ``simulate_many`` loop, ``max_retries=4``,
    counters set to 0 just before it: lane-rounds/s beside phase 13's solo
    rate, the fault counters a lane, the device busy share; lane 0 of the
    profiled rounds against its solo ``simulate`` run."""
    import torch

    from repro_torch import core as T
    from repro_torch.core.rng import split
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import make_capacity_assign
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    t0 = time.perf_counter()
    scens = ensemble_faults_scenarios(device)
    subs = (T.faults_subsystem(job_backoff=True, blacklist=True),)
    stacked = T.stack_scenarios(scens, subsystems=subs)
    print(f"[ens-faults] {ENS_DATA_K} lanes built in {time.perf_counter() - t0:.2f}s: "
          f"J={stacked.jobs.capacity}, S={ENGINE_S}")
    work = [0]
    capacity_assign = lane_capacity_assign([stacked])

    def counted(*args):
        work[0] += 1
        return capacity_assign(*args)

    policy = T.with_capacity_assign(T.get_policy("panda_dispatch"), counted)
    key = T.PRNGKey(0)
    kw = dict(max_retries=4, log_rows=SUB_LOG_ROWS, device=device)

    def run(rounds):
        return T.simulate_many(stacked, policy, key, subsystems=subs, max_rounds=rounds, **kw)

    assign_mod.launches = segsum_mod.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = run(max_rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"assign": assign_mod.launches, "segment_sum": segsum_mod.launches}
    rounds = res.rounds.tolist()
    check(launches["assign"] == work[0] > 0,
          f"assign launches {launches['assign']} != rounds with work {work[0]}")
    fs = res.ext["faults"]
    check(int(fs.n_kills.min()) > 0, f"a lane killed no job: {fs.n_kills.tolist()}")
    for i in range(ENS_DATA_K):
        check_invariants(lane_of(res, i), f"ens-faults lane {i}")
    print(f"[ens-faults] rounds per lane {rounds}; launches={json.dumps(launches)} "
          f"({launches['segment_sum'] / max(rounds):.2f} segment sums a round); makespan "
          f"{res.makespan.tolist()}, kills {fs.n_kills.tolist()}, breaker trips "
          f"{fs.n_bl_trips.tolist()}, backoff {fs.backoff_wait.sum(-1).tolist()} s; "
          f"lane-rounds/s={sum(rounds) / wall:.2f} against phase 13's solo rounds/s "
          f"{fault_rate:.2f} in this call; peak memory "
          f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    short = []
    prof = profile_rounds(lambda: short.append(run(SHORT_PROFILE_ROUNDS)), "ens-faults-profile",
                          names=ASSIGN_KERNELS, rounds=SHORT_PROFILE_ROUNDS)
    if prof:
        print(f"[ens-faults] {prof['kernels'] / SHORT_PROFILE_ROUNDS:.1f} kernels a round of "
              f"{ENS_DATA_K} lanes")

    lane0 = scens[0]
    solo = T.simulate(lane0.jobs, lane0.sites,
                      T.with_capacity_assign(T.get_policy("panda_dispatch"),
                                             make_capacity_assign(lane0.jobs.cores)),
                      split(key.to(device), ENS_DATA_K)[0], faults=lane0.ext["faults"],
                      max_rounds=SHORT_PROFILE_ROUNDS, **kw)
    bad = mismatches(full_snapshot(solo), full_snapshot(lane_of(short[-1], 0)))
    check(not bad, f"fault lane 0 differs from its solo run on the card: {bad}")
    print(f"[ens-faults] lane 0 of the {SHORT_PROFILE_ROUNDS} profiled rounds equals its solo "
          "run on the card")
    launches["rounds"] = max(rounds)
    return launches


def ensemble_data_scenarios(dev):
    """Phase 16(c)'s second run: four lanes at S = 50 of 40 to 85 jobs on a
    64-dataset catalog (disks of memory x 1e8 B, so the LRU path runs), each
    with its transfer queues (``max_active=2``) and fault state (transfer
    failures, resubmission backoff, walltime, a loss calendar, the breaker)."""
    from repro_torch import core as T

    S, D = XENS_S, XENS_DATA_D
    sites = T.atlas_like_platform(S, seed=1, fail_rate=0.02, device=dev)
    net = T.atlas_like_network(S, seed=2, device=dev)
    scens = []
    for i, n in enumerate(XENS_DATA_JOBS):
        jobs = T.synthetic_panda_jobs(n, seed=20 + i, duration=600.0, n_datasets=D, device=dev)
        rep = T.make_replicas(T.zipf_dataset_sizes(D, seed=3 + i), sites.memory * 1e8,
                              seed=4 + i, device=dev)
        ts = T.make_transfers(S, jobs, max_active=2, queue_slots=16, device=dev)
        fl = T.make_faults(S, jobs, link_fail_p=0.1, xfer_backoff=20.0, job_backoff=30.0,
                           walltime=20000.0,
                           replica_loss=[(300.0 * (k + 1), k, (i + k) % S) for k in range(4)],
                           blacklist_threshold=0.7, blacklist_alpha=0.4,
                           blacklist_cooldown=400.0, device=dev)
        scens.append(T.Scenario(jobs, sites._replace(speed=sites.speed * (0.8 + 0.1 * i)),
                                {"data": (net, rep), "transfers": ts, "faults": fl}))
    return scens


def phase_ensemble_data_card_vs_cpu(device, max_rounds: int) -> dict:
    """Phase 16(c)'s second run on the card and on the CPU: data, transfer
    queues and faults in four lanes at ``topk=8`` (the fused kernel), lanes
    freezing at different rounds; every array equal, and the last lane's
    transfer, fault and transition rows and ML NDJSON byte for byte."""
    import io

    import torch

    from repro_torch import core as T
    from repro_torch.core import events as TE
    from repro_torch.kernels.assign import fused_cuda as fused_mod
    from repro_torch.kernels.assign import make_fused_capacity_assign
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    subs = (T.data_subsystem(T.get_data_policy("cache_on_read")), T.transfers_subsystem(),
            T.faults_subsystem(job_backoff=True, blacklist=True))

    def run(dev):
        stacked = T.stack_scenarios(ensemble_data_scenarios(dev), subsystems=subs)
        policy = T.with_fused_assign(T.get_policy("data_locality"),
                                     make_fused_capacity_assign(stacked.jobs.cores))
        t0 = time.perf_counter()
        res = T.simulate_many(stacked, policy, T.PRNGKey(5), subsystems=subs, topk=8,
                              max_rounds=max_rounds, log_rows=max_rounds, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lane = lane_of(res, len(XENS_DATA_JOBS) - 1)
        buf = io.StringIO()
        TE.write_ml_dataset(lane, buf)
        exports = dict(transfers=TE.to_csv(TE.transfer_rows(lane)),
                       faults=TE.to_csv(TE.fault_rows(lane)),
                       transitions=TE.to_csv(TE.transition_rows(lane)), ml=buf.getvalue())
        fs = res.ext["faults"]
        print(f"[xens] {dev.type} data+transfers+faults topk=8: rounds {res.rounds.tolist()}, "
              f"transfer failures {fs.n_xfer_fail.tolist()}, kills {fs.n_kills.tolist()}, "
              f"breaker trips {fs.n_bl_trips.tolist()}, WAN transfers "
              f"{res.replicas.n_transfers.tolist()}, wall={wall:.2f}s")
        return res, full_snapshot(res), exports

    fused_mod.launches = segsum_mod.launches = 0
    card, card_snap, card_exp = run(device)
    out = {"fused_assign": fused_mod.launches, "segment_sum": segsum_mod.launches}
    check(out["fused_assign"] > 0 and out["segment_sum"] > 0,
          "the S=50 data lanes did not launch the fused kernel and the segment sum")
    rounds = card.rounds.tolist()
    check(len(set(rounds)) > 1 and max(rounds) < max_rounds,
          f"the S=50 data lanes did not drain at different rounds: {rounds}")
    check(int(card.ext["faults"].n_xfer_fail.sum()) > 0, "no transfer failed in the S=50 lanes")
    _, cpu_snap, cpu_exp = run(torch.device("cpu"))
    bad = mismatches(card_snap, cpu_snap)
    check(not bad, f"the card's S=50 data lanes differ from the CPU's: {bad}")
    for k in card_exp:
        check(card_exp[k] == cpu_exp[k], f"the card's lane {k} export differs from the CPU's")
    print(f"[xens] data lanes: card = CPU on every array; lane {len(XENS_DATA_JOBS) - 1}'s "
          f"transfer, fault and transition CSVs and ML NDJSON byte-identical "
          f"({', '.join(f'{k} {len(v)} B' for k, v in card_exp.items())}); launches "
          f"{json.dumps(out)}")
    return out


# --------------------------------------------------------------------------
# phase 17: calibration (Fig. 3's optimizers, calibrate_platform over engine
# lanes, torch.autograd through the closed form and the segment sum)
# --------------------------------------------------------------------------

CAL_METHODS = ("grid", "random", "cma_es", "gp_bo")
CAL_PLATFORM = dict(n_jobs=400, n_sites=6, seed=2, include=("speed", "bw"), trace="engine",
                    wan_frac=0.5, misconfig_sigma=0.7)   # bench_calibration.run_platform
CAL_PLATFORM_FITS = (   # run_platform's three method rows (all on the closed form)
    ("spsa", dict(objective="closed_form", n_iters=200, spsa_dirs=6, a0=0.25, c0=0.1)),
    ("grad", dict(objective="closed_form", n_iters=150, lr=0.1)),
    ("cma_es", dict(objective="closed_form", n_iters=40)),
)
CAL_POP_K = 8
CAL_POP_ROUNDS = 40            # depth cut of 17(b)'s throughput runs (the replay drains in 800)
CAL_WLCG_ROUNDS = 40           # depth cut of 17(c)'s population runs
CAL_WLCG_DIRS, CAL_WLCG_ITERS = 4, 2


def phase_calibration_fig3(device) -> dict:
    """Phase 17(a): Fig. 3 at the paper's scale (``bench_calibration.run``):
    3000 jobs over 30 days on 50 sites, misconfigured at sigma 1.05; the four
    optimizers at seed 3 on the card, each below err0, and ``grid`` (no
    draws) equal to the CPU's run."""
    import torch

    from repro_torch import core as T
    from repro_torch.core import calibration as TC
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    def problem(dev):
        jobs = T.synthetic_panda_jobs(3000, seed=0, duration=30 * 86400.0, device=dev)
        sites = T.atlas_like_platform(50, seed=1, device=dev)
        return TC.make_synthetic_problem(jobs, sites, seed=2, misconfig_sigma=1.05,
                                         noise_sigma=0.15)

    prob = problem(device)
    err0 = float(TC.closed_form_objective(prob, prob.sites0.speed)[2])
    segsum_mod.launches = 0
    out = {"err0": err0}
    for method in CAL_METHODS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = TC.calibrate(prob, method, seed=3)
        err = float(r.err)
        wall = time.perf_counter() - t0
        check(math.isfinite(err) and err < float(r.err0), f"{method}: err {err} >= err0")
        h = r.history.cpu()
        check(bool((h[1:] <= h[:-1]).all()), f"{method}: the history rises")
        out[method] = dict(err=err, seconds=wall)
        if method == "grid":
            grid_card = r
    cpu = TC.calibrate(problem("cpu"), "grid")
    check(torch.equal(cpu.speeds, grid_card.speeds.cpu()), "grid: card speeds differ from the CPU's")
    for name in ("err", "err0", "history"):
        torch.testing.assert_close(getattr(grid_card, name).cpu(), getattr(cpu, name),
                                   rtol=1e-6, atol=0.0)
    out["segment_sum"] = segsum_mod.launches
    check(segsum_mod.launches > 0, "Fig. 3's objectives launched no segment sum")
    print(f"[calib-fig3] err0 {err0:.4f} (paper ~0.76); " + "; ".join(
        f"{m} err {out[m]['err']:.4f} in {out[m]['seconds']:.2f}s" for m in CAL_METHODS)
        + f"; grid card = CPU (speeds exact, errors rtol 1e-6); {segsum_mod.launches} "
        "segment-sum launches")
    return out


def phase_calibration_platform(device) -> dict:
    """Phase 17(b): ``calibrate_platform`` at ``bench_calibration.run_platform``'s
    configuration: SPSA, Adam through ``torch.autograd`` (the segment sum's
    backward on the card; its loss curve equal to the CPU's) and CMA-ES,
    each with its recovery error; then the K = 8 engine population as one
    call against a loop of 8 solo ``engine_platform_objective`` calls, both
    cut to CAL_POP_ROUNDS rounds."""
    import torch

    from repro_torch import core as T
    from repro_torch.core import calibration as TC
    from repro_torch.core.engine import _tree_map
    from repro_torch.kernels.segment_sum import ops as segsum_ops
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    t0 = time.perf_counter()
    prob, truth = TC.make_synthetic_platform_problem(**CAL_PLATFORM, device=device)
    print(f"[calib-platform] problem (engine trace of 400 jobs at S=6) built in "
          f"{time.perf_counter() - t0:.2f}s")
    out = {}
    segsum_mod.launches = segsum_ops.backward_launches = 0
    for method, kw in CAL_PLATFORM_FITS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = TC.calibrate_platform(prob, method=method, include=CAL_PLATFORM["include"],
                                  seed=CAL_PLATFORM["seed"] + 1, **kw)
        err = float(r.err)
        wall = time.perf_counter() - t0
        check(err <= float(r.err0), f"{method}: err above err0")
        out[method] = dict(recovery=TC.recovery_error(prob, r.params, truth), err=err,
                           err0=float(r.err0), seconds=wall)
        if method == "grad":
            grad_card = r
    out["segment_sum"] = segsum_mod.launches
    out["backward"] = segsum_ops.backward_launches
    check(segsum_mod.launches > 0, "calibrate_platform launched no segment sum")
    check(segsum_ops.backward_launches > 0, "method='grad' ran no segment-sum backward on the card")
    cpu_prob = _tree_map(lambda x: x.cpu(), prob)      # the same problem on the CPU
    grad_cpu = TC.calibrate_platform(cpu_prob, method="grad", include=CAL_PLATFORM["include"],
                                     seed=CAL_PLATFORM["seed"] + 1, **dict(CAL_PLATFORM_FITS)["grad"])
    torch.testing.assert_close(grad_card.history.cpu(), grad_cpu.history, rtol=1e-5, atol=0.0)
    print("[calib-platform] " + "; ".join(
        f"{m} recovery {out[m]['recovery']:.4f} (loss {out[m]['err0']:.4f} -> {out[m]['err']:.4f}) "
        f"in {out[m]['seconds']:.2f}s" for m, _ in CAL_PLATFORM_FITS)
        + f"; {out['segment_sum']} segment-sum launches, {out['backward']} backward passes on the "
        "card; grad's loss curve = the CPU's (rtol 1e-5)")

    # candidate throughput: one population call of K lanes against K solo calls
    be = TC.make_population_objective(prob, objective="engine", include=CAL_PLATFORM["include"],
                                      max_rounds=CAL_POP_ROUNDS)
    zs = be.z0[None, :] + 0.2 * T.rng.normal(T.PRNGKey(0, device), (CAL_POP_K, be.z0.shape[0]))
    key = T.PRNGKey(1, device)
    policy = TC.pinned_policy(prob.hist_site)
    keys = T.rng.split(key, CAL_POP_K)

    def loop():
        return torch.stack([TC.engine_platform_objective(
            prob, TC.decode_params(be.unravel(z), be.bounds), keys[i], max_rounds=CAL_POP_ROUNDS,
            policy=policy) for i, z in enumerate(zs)])

    walls, scores = {}, {}
    for name, fn in (("lanes", lambda: be(zs, key)), ("loop", loop)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores[name] = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    check(torch.equal(scores["lanes"], scores["loop"]),
          f"population lanes {scores['lanes'].tolist()} != solo {scores['loop'].tolist()}")
    out["cands_per_s"] = {k: CAL_POP_K / v for k, v in walls.items()}
    out["lane_speedup"] = walls["loop"] / walls["lanes"]
    print(f"[calib-platform] {CAL_POP_K} engine candidates at {CAL_POP_ROUNDS} rounds: one "
          f"population call {out['cands_per_s']['lanes']:.2f} candidates/s, a loop of solo calls "
          f"{out['cands_per_s']['loop']:.2f}; ratio {out['lane_speedup']:.2f}x; lanes = solo "
          "bit for bit")
    return out


def phase_calibration_wlcg(device) -> dict:
    """Phase 17(c): the engine population at WLCG scale: 300 sites, 100000
    jobs (50000 of them reading single-replica WAN datasets under
    ``always_remote``), D = 300 speeds + 90000 links; ``calibrate_platform``
    SPSA on the engine objective, CAL_WLCG_ITERS iterations of 2 *
    CAL_WLCG_DIRS + 1 lanes (one ``simulate_many`` call each) after the
    1-lane err0 call, every call cut to CAL_WLCG_ROUNDS rounds."""
    import torch

    from repro_torch.core import calibration as TC
    from repro_torch.core import distributed as TD
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    t0 = time.perf_counter()
    prob, truth = TC.make_synthetic_platform_problem(
        n_jobs=ENGINE_J, n_sites=ENGINE_S, seed=2, include=("speed", "bw"), trace="closed_form",
        wan_frac=0.5, misconfig_sigma=0.7, device=device)
    torch.cuda.synchronize()
    D = ENGINE_S + ENGINE_S * ENGINE_S
    print(f"[calib-wlcg] problem built in {time.perf_counter() - t0:.2f}s: J={prob.jobs.capacity}, "
          f"S={prob.n_sites}, {prob.replicas.n_datasets} datasets, D={D} knobs")
    rounds = []
    run_population = TD.simulate_population

    def counted(*args, **kw):
        res = run_population(*args, **kw)
        rounds.append(res.rounds)
        return res

    TD.simulate_population = counted
    try:
        segsum_mod.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        r = TC.calibrate_platform(prob, method="spsa", objective="engine", include=("speed", "bw"),
                                  n_iters=CAL_WLCG_ITERS, spsa_dirs=CAL_WLCG_DIRS,
                                  max_rounds=CAL_WLCG_ROUNDS)
        err0, err = float(r.err0), float(r.err)
        wall = time.perf_counter() - t0
    finally:
        TD.simulate_population = run_population
    lanes = [int(x.numel()) for x in rounds]
    lane_rounds = sum(int(x.sum()) for x in rounds)
    launches = segsum_mod.launches
    check(lanes == [1] + [2 * CAL_WLCG_DIRS + 1] * CAL_WLCG_ITERS,
          f"population calls of {lanes} lanes")
    check(launches > 0, "the WLCG-scale population launched no segment sum")
    check(err <= err0, "err above err0")
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    max_rounds = sum(int(x.max()) for x in rounds)
    print(f"[calib-wlcg] SPSA over {len(lanes)} population calls of {lanes} lanes: {lane_rounds} "
          f"lane-rounds in {wall:.2f}s = {lane_rounds / wall:.2f} lane-rounds/s; "
          f"{launches} segment sums = {launches / max_rounds:.2f} a round; err0 {err0:.4f} -> "
          f"err {err:.4f} (recovery {TC.recovery_error(prob, r.params, truth):.4f}); peak memory "
          f"{peak:.2f} GB")
    be = TC.make_population_objective(prob, objective="engine", include=("speed", "bw"),
                                      max_rounds=SHORT_PROFILE_ROUNDS)
    z_pop = be.z0[None, :].repeat(2 * CAL_WLCG_DIRS + 1, 1)
    prof = profile_rounds(lambda: be(z_pop), "calib-wlcg-profile", rounds=SHORT_PROFILE_ROUNDS)
    if prof:
        print(f"[calib-wlcg] {prof['kernels'] / SHORT_PROFILE_ROUNDS:.1f} kernels a round of "
              f"{2 * CAL_WLCG_DIRS + 1} lanes")
    return dict(segment_sum=launches, rounds=max_rounds, lane_rounds_per_s=lane_rounds / wall,
                peak_gb=peak)


def phase_segment_sum_backward(device) -> dict:
    """Phase 17(d): the segment sum's backward on the card against the plain
    version's (``index_add_`` forward, autograd backward), bit for bit, at
    the engine shape and at S*S + 1 = 90001 segments, with lanes and F = 3;
    the forward without a gradient costs what the kernel alone costs."""
    import torch

    from repro_torch.kernels.segment_sum import ops as segsum_ops
    from repro_torch.kernels.segment_sum.ops import segment_sum, segment_sum_ref
    from repro_torch.kernels.segment_sum.segment_sum_cuda import segment_sum_cuda

    def grads(fn, values, seg, n, w):
        v = values.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((fn(v, seg, n) * w).sum(), v)
        return g

    cases = [("uniform", ENGINE_J, ENGINE_S, 1), ("padding95", ENGINE_J, ENGINE_S, 3),
             ("uniform", ENGINE_J, MANY_SEGMENTS, 1), ("out_of_range", 10_007, 37, 2)]
    for mix, J, S, F in cases:
        values, seg = (t.to(device) for t in segsum_inputs(mix, J, S, F, "float32", "int32", 5))
        w = torch.randn((S,) + values.shape[1:], device=device)
        got = grads(segment_sum, values, seg, S, w)
        want = grads(segment_sum_ref, values, seg, S, w)
        check(torch.equal(got, want), f"segment-sum backward {mix} J={J} S={S} F={F} differs")
    lanes_v = torch.rand(3, 5000, device=device)
    lanes_s = torch.randint(-2, 40, (3, 5000), device=device, dtype=torch.int32)
    w = torch.randn(3, 37, device=device)
    check(torch.equal(grads(segment_sum, lanes_v, lanes_s, 37, w),
                      grads(lambda v, s, n: torch.stack([segment_sum_ref(v[i], s[i], n)
                                                         for i in range(3)]),
                            lanes_v, lanes_s, 37, w)), "lane-offset backward differs")
    print(f"[segsum-backward] {len(cases) + 1} cases bit for bit the plain version's gradient "
          "(engine shape, 95% padding at F = 3, 90001 segments, out-of-range ids, 3 lanes)")

    out = {}
    for label, S in (("engine", ENGINE_S), ("many", MANY_SEGMENTS)):
        values, seg = (t.to(device) for t in segsum_inputs("uniform", ENGINE_J, S, 1, "float32",
                                                           "int32", 1))
        v = values.clone().requires_grad_(True)
        w = torch.randn(S, device=device)
        y_kernel, y_plain = segment_sum(v, seg, S), segment_sum_ref(v, seg, S)
        segsum_ops.backward_launches = 0
        ms = cuda_ms(lambda: torch.autograd.grad(y_kernel, v, w, retain_graph=True), iters=50)
        check(segsum_ops.backward_launches > 0, "the backward did not run")
        plain = cuda_ms(lambda: torch.autograd.grad(y_plain, v, w, retain_graph=True), iters=50)
        idx = seg.long().clamp(0, S - 1)
        library = cuda_ms(lambda: w.index_select(0, idx), iters=50)
        # seg read, grad_out read, grad written: J ids, S sums, J values
        nbytes = ENGINE_J * 4 + S * 4 + ENGINE_J * 4
        bound = max(nbytes / PEAK_HBM_BYTES_PER_S, ENGINE_J / PEAK_FP32_OPS_PER_S) * 1e3
        out[label] = dict(ms=ms, plain_ms=plain, library_ms=library, bound_ms=bound,
                          bound_by="bytes")
        print(f"[segsum-backward] J={ENGINE_J} S={S}: backward {ms:.4f} ms a call between CUDA "
              f"events; plain (index_add_'s autograd) {plain:.4f} ms; index_select {library:.4f} "
              f"ms; bound {bound:.6f} ms (bytes, {nbytes} B)")
    values, seg = (t.to(device) for t in segsum_inputs("uniform", ENGINE_J, ENGINE_S, 1, "float32",
                                                       "int32", 1))
    with torch.no_grad():
        via_ops = cuda_ms(lambda: segment_sum(values, seg, ENGINE_S), iters=200)
    direct = cuda_ms(lambda: segment_sum_cuda(values, seg, ENGINE_S), iters=200)
    out["forward_no_grad_ms"], out["forward_direct_ms"] = via_ops, direct
    print(f"[segsum-backward] forward without a gradient through ops.segment_sum {via_ops:.4f} ms "
          f"a call, the kernel's wrapper alone {direct:.4f} ms (CUDA events)")
    return out


# --------------------------------------------------------------------------
# phase 19: scenario ensembles over a device mesh (simulate_many_sharded)
# --------------------------------------------------------------------------

MESH_SCALING_LANES = (16, 64)  # the scaling rows' lanes (64: 16 a card on 4 cards)
MESH_SCALING_ROUNDS = 300      # depth of the scaling rows (phase 16(a)'s ENS_ROUNDS)
MESH_WARMUP_ROUNDS = 5         # a spawned rank's first call (kernels loaded, NCCL set up)


def mesh_policy(kind: str, stacked, lanes, shapes=None):
    """Phase 16(a)'s (``"dense"``) or 16(d)'s (``"sparse"``) policy for the
    lanes ``lanes`` of ``stacked``: capacity dispatch over their own cores.
    With ``shapes``, every assignment call appends its scores' shape."""
    import torch

    from repro_torch import core as T
    from repro_torch.kernels.assign import make_capacity_assign, make_fused_capacity_assign

    cores = stacked.jobs.cores[torch.tensor(lanes, device=stacked.jobs.cores.device)]
    fn = (make_capacity_assign if kind == "dense" else make_fused_capacity_assign)(cores)

    def counted(scores, *args):
        if shapes is not None:
            shapes.append(tuple(scores.shape))
        return fn(scores, *args)

    if kind == "dense":
        return T.with_capacity_assign(T.get_policy("panda_dispatch"), counted)
    return T.with_fused_assign(T.get_policy("data_locality"), counted)


def snapshot_digest(snap: dict) -> dict:
    """A sha256 of every array of a snapshot, by key."""
    import hashlib

    import numpy as np

    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in sorted(snap.items())}


def mesh_scaling_rank(mesh, out_dir: str, K: int, rounds: int) -> None:
    """One rank of a spawned NCCL mesh: phase 16(a)'s configuration with K
    lanes on this rank's card and the policy of its own lanes; a short
    warm-up call, a barrier, then ``simulate_many_sharded`` timed.  Writes
    the wall seconds, the lane-rounds and the gathered result's digest to
    ``rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch import core as T
    from repro_torch.core import distributed as D

    device = D.mesh_device(mesh)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    stacked = T.stack_scenarios(ensemble_scenarios(device, K))
    policy = mesh_policy("dense", stacked, D.lane_block(K, mesh))
    # the policy holds the block's [b, J] cores: one batched call a round
    D.simulate_many_sharded(stacked, policy, T.PRNGKey(0), mesh, lane_mode="vmap",
                            max_rounds=MESH_WARMUP_ROUNDS)
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    res = D.simulate_many_sharded(stacked, policy, T.PRNGKey(0), mesh, lane_mode="vmap",
                                  max_rounds=rounds)
    sync()
    wall = time.perf_counter() - t0
    rank = mesh.get_local_rank("data")
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(dict(
        wall=wall, lane_rounds=int(res.rounds.sum()), device=str(device),
        digest=snapshot_digest(full_snapshot(res)))))


def phase_mesh(device, dense_snap=None, sparse_snap=None) -> dict:
    """Phase 19: phase 16(a)'s 16 dense lanes (ENS_BUCKET_ROUNDS rounds) and
    16(d)'s sparse lanes (ENS_SPARSE_ROUNDS) through ``simulate_many_sharded``
    on a 1-rank NCCL mesh (lane mode ``auto``: ``vmap`` on a card), counters
    set to 0 just before each run: each equals phase 16's ``simulate_many``
    run of as many rounds (its snapshot, or recomputed when not given), with
    one assign (fused) launch a round with work for all lanes.  With more
    than one card, one spawned rank a card: lane-rounds/s of the 16 dense
    lanes at 1, 2, ... N ranks over MESH_SCALING_ROUNDS rounds, every rank's
    gathered result equal to the 1-rank spawn's (by digest), then 64 lanes
    (16 a card) on N ranks."""
    import tempfile

    import torch

    from repro_torch import core as T
    from repro_torch.core import distributed as D
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import fused_cuda as fused_mod
    from repro_torch.kernels.assign import ops as assign_ops
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    out = {}
    key = T.PRNGKey(0)
    with D.local_mesh("cuda") as mesh:
        check(D.mesh_device(mesh) == device, f"the 1-rank mesh runs on {D.mesh_device(mesh)}")
        for kind, want, rounds, kw in (("dense", dense_snap, ENS_BUCKET_ROUNDS, {}),
                                       ("sparse", sparse_snap, ENS_SPARSE_ROUNDS,
                                        {"topk": ENGINE_K})):
            stacked = T.stack_scenarios(ensemble_scenarios(device))
            if want is None:
                want = full_snapshot(T.simulate_many(
                    stacked, mesh_policy(kind, stacked, list(range(ENS_K))), key,
                    max_rounds=rounds, device=device, **kw))
            shapes = []
            policy = mesh_policy(kind, stacked, D.lane_block(ENS_K, mesh), shapes)

            def no_plain_version(*args, **kw):
                raise SmokeFailure("the mesh path called a plain assignment version on the card")

            plain = assign_ops.fused_assign_ref, assign_ops.assign_ref
            assign_ops.fused_assign_ref = assign_ops.assign_ref = no_plain_version
            try:
                torch.cuda.synchronize()
                assign_mod.launches = fused_mod.launches = segsum_mod.launches = 0
                t0 = time.perf_counter()
                res = D.simulate_many_sharded(stacked, policy, key, mesh, max_rounds=rounds,
                                              **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {"assign": assign_mod.launches, "fused_assign": fused_mod.launches,
                            "segment_sum": segsum_mod.launches}
            finally:
                assign_ops.fused_assign_ref, assign_ops.assign_ref = plain
            name = "assign" if kind == "dense" else "fused_assign"
            other = "fused_assign" if kind == "dense" else "assign"
            check(launches[name] > 0 and launches[name] == len(shapes),
                  f"mesh {kind}: {launches[name]} {name} launches, {len(shapes)} rounds with work")
            check(launches[other] == 0, f"mesh {kind}: launched the {other} kernel")
            check(all(sh[0] == ENS_K for sh in shapes),
                  f"mesh {kind}: the kernel was not called once for all {ENS_K} lanes")
            bad = mismatches(want, full_snapshot(res))
            check(not bad, f"mesh {kind}: the 1-rank mesh differs from phase 16's lanes: {bad}")
            lane_rounds = int(res.rounds.sum())
            print(f"[mesh] {kind}: {ENS_K} lanes over a 1-rank NCCL mesh, {rounds} rounds, "
                  f"equal to phase 16's simulate_many lanes bit for bit; launches "
                  f"{json.dumps(launches)} ({len(shapes)} rounds with work); "
                  f"{lane_rounds / wall:.2f} lane-rounds/s")
            out[kind] = dict(launches, rounds=rounds, rate=lane_rounds / wall)
            del res, stacked
            torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"[mesh] {n_cards} card: the scaling rows (one rank a card) need two or more")
        return out
    want, rows = None, []
    for K, ranks in [(MESH_SCALING_LANES[0], n) for n in range(1, n_cards + 1)] + [
            (MESH_SCALING_LANES[1], n_cards)]:
        rounds = MESH_SCALING_ROUNDS
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            t0 = time.perf_counter()
            D.run_ranks(mesh_scaling_rank, ranks, (tmp, K, rounds), device_type="cuda")
            spawn_s = time.perf_counter() - t0
            reports = [json.loads((pathlib.Path(tmp) / f"rank{r}.json").read_text())
                       for r in range(ranks)]
        wall = max(r["wall"] for r in reports)
        rate = reports[0]["lane_rounds"] / wall
        if K == ENS_K:
            want = want or reports[0]["digest"]   # the 1-rank spawn's
            for r, rep in enumerate(reports):
                bad = [k for k in want if rep["digest"].get(k) != want[k]]
                check(not bad, f"mesh: rank {r} of {ranks} differs from the 1-rank run in {bad}")
        rows.append(dict(lanes=K, ranks=ranks, rounds=rounds, lane_rounds_per_s=rate,
                         wall=wall, spawn_s=spawn_s))
        print(f"[mesh] {K} lanes over {ranks} ranks (one a card, NCCL), {rounds} rounds: "
              f"{rate:.2f} lane-rounds/s ({wall:.2f}s, the slowest rank; {spawn_s:.1f}s with "
              f"the processes' start)" + (", every rank's result = the 1-rank run"
                                          if K == ENS_K else ""))
    out["scaling"] = rows
    return out


# --------------------------------------------------------------------------
# phase 20: the encoder-decoder (whisper) and VLM (internvl2) families
# --------------------------------------------------------------------------

WHISPER_PROMPT, WHISPER_NEW = 32, 32   # decoder prompt and new tokens a 1500-frame utterance
VLM_LAYERS = 48                        # internvl2-26b at full depth (39.8 GB of bf16 weights)
ENCDEC_CPU_CHECK_LAYERS = {"whisper-small": 2, "internvl2-26b": 1}
VLM_CPU_CHECK_PATCHES = 8              # patches spliced in the card = CPU check's 16-token prompts


def frontend_stub(cfg, batch: int, device, seed: int, patches: int | None = None) -> dict:
    """The stub frontends' output, seeded standard normal in the model's
    dtype: whisper's ``frames [B, n_frames, d]``, internvl2's
    ``patch_embeds [B, P, d]``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        name, rows = "frames", cfg.n_frames
    else:
        name, rows = "patch_embeds", cfg.n_patches if patches is None else patches
    x = rng.standard_normal((batch, rows, cfg.d_model), dtype=np.float32)
    return {name: torch.from_numpy(x).to(device=device, dtype=getattr(torch, cfg.dtype))}


def phase_serve_encdec_vlm(device) -> dict:
    """Phase 20: whisper-small (12 + 12 layers, 4 utterances of 1500 frames,
    32-token prompts) and internvl2-26b (VLM_LAYERS layers, 4 prompts of
    4096 tokens with 256 patches) served greedy then sampled, counters set
    to 0 just before the greedy run; the flash kernel at each new attention
    shape against its plain version; sampled tokens card = CPU at a cut
    depth."""
    import torch

    from repro_torch.configs import get_config

    B = FAMILY_BATCH
    out = {"launches": {}, "flash": {}}
    torch.cuda.empty_cache()

    cfg = get_config("whisper-small")
    L = cfg.n_dec_layers
    model, params, batch, stats = serve_family(
        device, cfg, batch=B, prompt=WHISPER_PROMPT, new=WHISPER_NEW,
        extra=frontend_stub(cfg, B, device, 0))
    check(stats["flash_prefill"] == cfg.n_enc_layers + 2 * L and stats["flash_decode"] == L
          and stats["launches"]["assign"] == 0,
          f"whisper: {stats['flash_prefill']} flash launches a prefill (want encoder "
          f"{cfg.n_enc_layers} + decoder self {L} + cross {L}), {stats['flash_decode']} a decode "
          f"step (want {L}: the cross-attention)")
    frames = [cfg.n_frames * stats[k] / WHISPER_PROMPT
              for k in ("prefill_tokens_per_s", "prefill_tokens_per_s_warm")]
    print(f"[encdec] whisper prefill: {frames[0]:.1f} frames/s encoded with the "
          f"{WHISPER_PROMPT}-token prompts (warm: {frames[1]:.1f})")
    stats["prefill_frames_per_s"], stats["prefill_frames_per_s_warm"] = frames
    out["launches"]["whisper"] = stats
    del model, params, batch
    torch.cuda.empty_cache()

    cfg = get_config("internvl2-26b").replace(n_layers=VLM_LAYERS)
    model, params, batch, stats = serve_family(
        device, cfg, batch=B, prompt=FAMILY_PROMPT, new=FAMILY_NEW,
        extra=frontend_stub(cfg, B, device, 0))
    check(stats["flash_prefill"] == cfg.n_layers and stats["flash_decode"] == 0
          and stats["launches"]["assign"] == 0,
          f"internvl2: {stats['flash_prefill']} flash launches a prefill, "
          f"{stats['flash_decode']} a decode step")
    out["launches"]["internvl2"] = stats
    del model, params, batch
    torch.cuda.empty_cache()

    wcfg = get_config("whisper-small")
    for name, S, Skv, causal, c in (
            ("whisper_encoder", wcfg.n_frames, None, False, wcfg),
            ("whisper_cross_prefill", WHISPER_PROMPT, wcfg.n_frames, False, wcfg),
            ("whisper_cross_decode", 1, wcfg.n_frames, False, wcfg),
            ("internvl2", FAMILY_PROMPT, None, True, get_config("internvl2-26b"))):
        out["flash"][name] = check_family_flash(device, c, B, S, Skv, causal=causal,
                                                label=name.replace("_", " "))

    for arch, layers in ENCDEC_CPU_CHECK_LAYERS.items():
        c = get_config(arch)
        extra = frontend_stub(c, CPU_CHECK_BATCH, "cpu", 1, patches=VLM_CPU_CHECK_PATCHES)
        sampled_card_vs_cpu(device, arch, layers=layers, extra=extra)
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 21: training (make_train_step on granite-moe at full width and depth)
# --------------------------------------------------------------------------

TRAIN_ARCH = "granite-moe-1b-a400m"
# train_4k's sequence length; its 256-sequence global batch cut to 8 for one
# card, in 2 microbatches of 4 x 4096 tokens
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 4096, 8, 2
TRAIN_STEPS, TRAIN_REPEAT, TRAIN_VARIANT_STEPS = 6, 2, 2
TRAIN_VARIANT_LAYERS = 4         # depth cut of the 8-bit and compressed runs (24 -> 4)
TRAIN_OPT = dict(warmup_steps=1)   # AdamW's defaults, warmup cut to 1 step for a 6-step run
# bf16 at D = 64, 128 and 256 (every case below) runs the wgmma/TMA kernels;
# the dK/dV name also matches its D = 256 form, flash_bwd_dkdv_kernel_wgmma_split
FLASH_BWD_KERNELS = ("flash_bwd_preprocess_kernel", "flash_bwd_dkdv_kernel_wgmma",
                     "flash_bwd_dq_kernel_wgmma")
FLASH_BWD_OTHER = ("flash_bwd_dkdv_kernel<", "flash_bwd_dq_kernel<", "flash_bwd_dkdv_kernel_mma",
                   "flash_bwd_dq_kernel_mma")
FLASH_BWD_CASES = [  # (label, B, Hq, Hkv, S, Skv, D, causal, window): each family's training attention
    ("granite", 4, 16, 8, 4096, 4096, 64, True, 0),
    ("deepseek", 1, 32, 32, 4096, 4096, 128, True, 0),
    ("recurrentgemma", 1, 10, 1, 4096, 4096, 256, True, 2048),
    ("whisper_encoder", 4, 12, 12, 1500, 1500, 64, False, 0),
]
GATE_BWD_CASES = [("granite", 32, 512, 32, 8), ("kimi", 32, 512, 384, 8)]  # (label, G, T, E, k)
TRAIN_FAMILIES = ["deepseek-7b", "granite-moe-1b-a400m", "kimi-k2-1t-a32b", "mamba2-130m",
                  "recurrentgemma-2b", "whisper-small", "internvl2-26b"]


def row_error(got, want) -> float:
    """The largest error of a row over that row's largest magnitude (at least
    1e-2 of the tensor's largest: a row whose gradient is zero in exact
    arithmetic, such as the first causal row's dq, holds rounding only)."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    scale = want.abs().amax(-1).clamp_min(1e-2 * float(want.abs().max()) + 1e-30)
    return float(((got - want).abs().amax(-1) / scale).max())


def phase_flash_backward(device) -> dict:
    """Phase 21(b), flash: the backward kernel against its plain version at
    each family's training attention, on the output and log-sum-exp of the
    forward kernel (the LSE held to the plain one's), timed beside the plain
    version and SDPA's backward with the same mask; bad inputs raise."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_flops
    from repro_torch.kernels.flash_attention.flash_attention_bwd_cuda import (
        flash_attention_backward_cuda,
    )
    from repro_torch.kernels.flash_attention.flash_attention_cuda import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

    out = {}
    for label, B, Hq, Hkv, S, Skv, D, causal, window in FLASH_BWD_CASES:
        q, k, v = flash_inputs(B, Hq, Hkv, S, Skv, D, "bfloat16", S + D, device)
        do = torch.from_numpy(np.random.default_rng(S + D + 1).standard_normal(
            tuple(q.shape), dtype=np.float32)).to(device=device, dtype=q.dtype)
        o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True)
        want_lse = attention_ref(q, k, v, causal=causal, window=window, return_lse=True)[1]
        lse_err = float((lse - want_lse).abs().max())
        check(lse_err <= FLASH_LSE_TOL, f"flash backward {label}: the forward's log-sum-exp "
                                        f"differs from the plain one's by {lse_err:.3e}")
        del want_lse
        got = flash_attention_backward_cuda(q, k, v, o, do, lse, causal=causal, window=window)
        again = flash_attention_backward_cuda(q, k, v, o, do, lse, causal=causal, window=window)
        want = attention_bwd_ref(q, k, v, o, do, causal=causal, window=window, lse=lse)
        torch.cuda.synchronize()
        errs = {n: row_error(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        abs_err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash backward {label}: two calls differ")
        check(max(errs.values()) <= 2.0 ** -6, f"flash backward {label}: row errors "
                                               f"{json.dumps(errs)} above 2^-6")
        del want, again
        call = lambda: flash_attention_backward_cuda(q, k, v, o, do, lse,  # noqa: E731
                                                     causal=causal, window=window)
        call_ms = cuda_ms(call, iters=5)
        parts = device_ms(call, FLASH_BWD_KERNELS, iters=3, per_call=1,
                          forbid=FLASH_BWD_OTHER)
        dev_ms = sum(parts.values())
        plain_ms = cuda_ms(lambda: attention_bwd_ref(q, k, v, o, do, causal=causal,
                                                     window=window, lse=lse),
                           iters=2, warmup=1)
        mask = None
        if window > 0:
            pos = torch.arange(S, device=device)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        # SDPA on K/V repeated to the query heads, as phase 18 times it
        leaves = [t.detach().requires_grad_(True) for t in
                  (q, k.repeat_interleave(Hq // Hkv, 1), v.repeat_interleave(Hq // Hkv, 1))]
        sdpa = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                              is_causal=causal and mask is None)
        library_ms = cuda_ms(lambda: torch.autograd.grad(sdpa, leaves, do, retain_graph=True),
                             iters=5)
        ops = flash_flops(q.shape, k.shape, causal, window, backward=True)  # registered
        nbytes = q.element_size() * (3 * q.numel() + 2 * k.numel() + 2 * v.numel() + 2 * do.numel())
        t_ops, t_bytes = ops / PEAK_BF16_OPS_PER_S, nbytes / PEAK_HBM_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        out[label] = dict(shape=[B, Hq, Hkv, S, Skv, D], causal=causal, window=window,
                          row_err=errs, max_abs_err=abs_err, lse_err=lse_err, ms=dev_ms,
                          call_ms=call_ms,
                          kernels_ms=parts, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by="operations" if t_ops >= t_bytes else "bytes",
                          flop=ops)
        print(f"[train-flash-bwd] {label} [{B}, {Hq}, {S}, {D}] on {Hkv} kv heads causal={causal} "
              f"window={window} bf16: row errors dq {errs['dq']:.2e} dk {errs['dk']:.2e} dv "
              f"{errs['dv']:.2e} (tol 2^-6), max abs err {abs_err:.3e}; the forward kernel's "
              f"log-sum-exp within {lse_err:.2e} of the plain one's; device {dev_ms:.4f} ms "
              f"({' + '.join(f'{v:.4f}' for v in parts.values())}), {call_ms:.4f} ms a call; "
              f"plain {plain_ms:.4f} ms; SDPA backward {library_ms:.4f} ms; bound {bound_ms:.4f} ms "
              f"({ops:.4e} FLOP, 2.5 x the forward's, at 989 TFLOP/s; {nbytes} B); "
              f"{ops / dev_ms / 1e9:.2f} TFLOP/s")
        del q, k, v, o, lse, do, got, leaves, sdpa
        torch.cuda.empty_cache()
    q, k, v = flash_inputs(1, 2, 2, 64, 64, 64, "float32", 0, device)
    o, lse = attention_ref(q, k, v, return_lse=True)
    for bad, kind in (((q.half(), k.half(), v.half(), o.half(), o.half(), lse), TypeError),
                      ((q.cpu(), k, v, o, o, lse), ValueError),
                      ((q, k, v, o, o, lse[:, :, :10]), ValueError)):
        try:
            flash_attention_backward_cuda(*bad)
        except kind:
            continue
        raise SmokeFailure(f"the flash backward took a bad input ({kind.__name__} expected)")
    print("[train-flash-bwd] a half-precision input, a CPU tensor and a short log-sum-exp raise")
    return out


def phase_gate_backward(device) -> dict:
    """Phase 21(b), gate: the gate backward kernel against its plain version at
    granite's and kimi's router shapes, timed; bad inputs raise."""
    import numpy as np
    import torch

    from repro_torch.kernels.assign.gate_backward_cuda import gate_backward_cuda
    from repro_torch.kernels.assign.ref import gate_backward_ref

    out = {}
    for label, G, T, E, k in GATE_BWD_CASES:
        rng = np.random.default_rng(E)
        scores = torch.from_numpy(rng.normal(size=(G, T, E)).astype(np.float32)).to(device)
        idx = torch.from_numpy(np.argsort(-rng.random((G, T, E)), -1)[..., :k].astype(np.int32))
        idx = idx.to(device)
        dgate = torch.from_numpy(rng.normal(size=(G, T, k)).astype(np.float32)).to(device)
        got = gate_backward_cuda(scores, idx, dgate)
        want = gate_backward_ref(scores, idx, dgate)
        err = row_error(got, want)
        abs_err = float((got - want).abs().max())
        check(torch.equal(got, gate_backward_cuda(scores, idx, dgate)),
              f"gate backward {label}: two calls differ")
        check(err <= 1e-6, f"gate backward {label}: row error {err:.3e} > 1e-6")
        call = lambda: gate_backward_cuda(scores, idx, dgate)  # noqa: E731
        call_ms = cuda_ms(call, iters=50)
        dev_ms = device_ms(call, ("gate_backward_kernel",), iters=20, per_call=1)["gate_backward_kernel"]
        plain_ms = cuda_ms(lambda: gate_backward_ref(scores, idx, dgate), iters=20)
        nbytes = 4 * (2 * scores.numel() + idx.numel() + dgate.numel())
        bound_ms = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
        out[label] = dict(shape=[G, T, E], k=k, max_abs_err=abs_err, row_err=err, ms=dev_ms,
                          call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                          library_ms=None)
        print(f"[train-gate-bwd] {label} [{G}, {T}, {E}] k={k}: row error {err:.2e} (tol 1e-6), "
              f"max abs err {abs_err:.3e}; device {dev_ms:.4f} ms, {call_ms:.4f} ms a call; plain "
              f"{plain_ms:.4f} ms; bound {bound_ms:.6f} ms (bytes: {nbytes} B at 3.35 TB/s); no "
              "single PyTorch call computes it")
    for bad, kind in (((scores.double(), idx, dgate), TypeError),
                      ((scores.cpu(), idx, dgate), ValueError)):
        try:
            gate_backward_cuda(*bad)
        except kind:
            continue
        raise SmokeFailure(f"the gate backward took a bad input ({kind.__name__} expected)")
    print("[train-gate-bwd] an f64 input and a CPU tensor raise")
    return out


def train_counters():
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import gate_backward_cuda as gate_mod
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda as bwd_mod
    from repro_torch.kernels.flash_attention import flash_attention_cuda as flash_mod

    return {"flash_attention": flash_mod, "flash_attention_backward": bwd_mod,
            "assign": assign_mod, "assign_gate_backward": gate_mod}


def params_checksum(params) -> tuple:
    """(integer sum of every parameter's bf16 bit patterns, f64 sum of the values)."""
    import torch

    bits = sum(int(p.detach().view(torch.int16).sum(dtype=torch.int64)) for p in params.parameters())
    return bits, float(sum(p.detach().double().sum() for p in params.parameters()))


def train_granite(device, steps: int, *, label: str, profile_step: bool = False,
                  layers: int | None = None, **kw) -> dict:
    """``steps`` train steps of granite-moe at full width (and depth, unless
    ``layers`` cuts it) from seed-0 weights on TokenPipeline batches;
    per-step CUDA-event ms, losses, the parameters' checksum after step 2."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import build_model, param_count
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = get_config(TRAIN_ARCH)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    model = build_model(cfg, device=device)
    init_kw = {k: v for k, v in kw.items() if k in ("compress", "opt_8bit")}
    state = init_train_state(model, 0, **init_kw)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH), device=device)
    step = make_train_step(model, AdamWConfig(**TRAIN_OPT), microbatches=TRAIN_MICRO, **kw)
    counters = train_counters()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for mod in counters.values():
        mod.launches = 0
    marks, metrics, checksum = [], [], None
    for i in range(steps):
        batch = pipe.batch_at(i)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, met = step(state, batch)
        end.record()
        marks.append((start, end))
        metrics.append(met)
        if i == 1:
            checksum = params_checksum(state.params)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [s.elapsed_time(e) for s, e in marks]
    losses = [float(m["loss"]) for m in metrics]
    out = dict(label=label, step_ms=step_ms, losses=losses, peak_gb=peak_gb, launches=launches,
               checksum=checksum, params=param_count(state.params),
               drop=[float(m["moe_drop_frac"]) for m in metrics],
               grad_norm=[float(m["grad_norm"]) for m in metrics])
    if profile_step:
        out["profile"] = profile_train_step(lambda: step(state, pipe.batch_at(steps)))
    del state, model, step
    torch.cuda.empty_cache()
    return out


def profile_train_step(run) -> dict:
    """The device busy share of one train step (``torch.profiler``: the
    kernels' device time over the step's wall time) and its top kernels.
    Device activity only: the step launches ~30000 kernels, and the host
    side's events would cost more to read back than the step takes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if dev_ms == 0.0:
        print("[train-profile] the profiler saw no device time: busy share not measured")
        return {}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    print(f"[train-profile] one step: wall {wall_ms:.1f} ms (profiled), device busy "
          f"{dev_ms:.1f} ms = {100 * dev_ms / wall_ms:.1f}%, {sum(e.count for e in kernels)} kernels")
    for e in top[:12]:
        print(f"[train-profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  "
              f"{e.key[:90]}")
    by = {}
    for name in ("flash_bwd_", "flash_fwd_kernel", "assign_", "gate_backward_kernel"):
        by[name] = sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3
    print(f"[train-profile] device ms by kernel family: {json.dumps(by)}")
    return dict(wall_ms=wall_ms, device_ms=dev_ms, busy=dev_ms / wall_ms, by_kernel=by)


def phase_train_granite(device) -> dict:
    """Phase 21(a): granite-moe at full width and depth, bf16, seed-0 weights,
    TRAIN_STEPS steps of 2 microbatches of 4 x 4096 tokens with remat, the
    counters set to 0 just before; tokens/s of steps 2 to 6, losses (step 6
    below step 1), peak memory, launches a step, the busy share of one more
    step; a second run of TRAIN_REPEAT steps from the same seed with the same
    losses and parameter checksum bit for bit; then TRAIN_VARIANT_STEPS steps
    each with 8-bit moments and with int8 gradient compression, at full
    width and TRAIN_VARIANT_LAYERS layers."""
    t0 = time.perf_counter()
    main = train_granite(device, TRAIN_STEPS, label="adamw", profile_step=True)
    print(f"[train] the main run and its profiled step took {time.perf_counter() - t0:.1f}s")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rate = tokens * (TRAIN_STEPS - 1) / (sum(main["step_ms"][1:]) / 1e3)
    per_step = {k: v / TRAIN_STEPS for k, v in main["launches"].items()}
    print(f"[train] {TRAIN_ARCH}: {main['params']} parameters, bf16, {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens a step in {TRAIN_MICRO} microbatches, remat, AdamW {json.dumps(TRAIN_OPT)}; "
          f"step ms {[round(t, 1) for t in main['step_ms']]}; steps 2-{TRAIN_STEPS}: "
          f"{rate:.1f} tokens/s; losses {main['losses']}; grad norms "
          f"{[round(g, 4) for g in main['grad_norm']]}; dropped share {main['drop'][0]:.4f}; "
          f"peak {main['peak_gb']:.2f} GB; launches a step {json.dumps(per_step)}")
    check(all(math.isfinite(x) for x in main["losses"]), "a non-finite training loss")
    check(main["losses"][-1] < main["losses"][0], f"the loss did not fall: {main['losses']}")
    check(all(main["launches"][k] > 0 for k in main["launches"]),
          f"a kernel of the training path was not launched: {json.dumps(main['launches'])}")
    check(per_step["flash_attention_backward"] == 24 * TRAIN_MICRO and
          per_step["assign_gate_backward"] == 24 * TRAIN_MICRO,
          f"backward launches a step {json.dumps(per_step)}, not one a layer a microbatch")
    again = train_granite(device, TRAIN_REPEAT, label="repeat")
    check(again["losses"] == main["losses"][:TRAIN_REPEAT] and again["checksum"] == main["checksum"],
          f"a second run from the same seed differs: losses {again['losses']} against "
          f"{main['losses'][:TRAIN_REPEAT]}, checksum {again['checksum']} against "
          f"{main['checksum']}")
    print(f"[train] a second run of {TRAIN_REPEAT} steps from seed 0: the same losses and the "
          f"same parameter checksum {main['checksum']} bit for bit")
    variants = {}
    cut = train_granite(device, 1, label="cut", layers=TRAIN_VARIANT_LAYERS)
    for name, kw in (("opt_8bit", dict(opt_8bit=True)), ("compress", dict(compress=True))):
        run = train_granite(device, TRAIN_VARIANT_STEPS, label=name, layers=TRAIN_VARIANT_LAYERS,
                            **kw)
        check(math.isfinite(run["losses"][0]) and run["losses"][0] == cut["losses"][0],
              f"{name}: the first step's loss {run['losses'][0]} is not the plain AdamW run's "
              f"{cut['losses'][0]} at {TRAIN_VARIANT_LAYERS} layers")
        check(run["launches"]["flash_attention_backward"] > 0 and
              run["launches"]["assign_gate_backward"] > 0, f"{name}: no backward launch")
        variants[name] = dict(losses=run["losses"], step_ms=run["step_ms"], peak_gb=run["peak_gb"],
                              grad_norm=run["grad_norm"])
        print(f"[train] {name} at {TRAIN_VARIANT_LAYERS} layers: losses {run['losses']}, grad norms "
              f"{[round(g, 4) for g in run['grad_norm']]}, step ms "
              f"{[round(t, 1) for t in run['step_ms']]}, peak {run['peak_gb']:.2f} GB")
    main["tokens_per_s"] = rate
    main["per_step"] = per_step
    main["variants"] = variants
    return main


def phase_train_card_vs_cpu(device) -> dict:
    """Phase 21(c): every family's smoke config in f32, loss and gradients on
    the card (the flash kernel and its backward on each attention, the assign
    kernel and the gate backward on each router) against the port on the
    CPU: the loss within rtol 1e-5, each gradient within 1e-4 of its
    tensor's largest, plus 1e-7."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.train.train_step import trainable

    counters = train_counters()
    out = {}
    for arch in TRAIN_FAMILIES:
        cfg = get_smoke(arch).replace(dtype="float32")
        rng = np.random.default_rng(3)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48))
                                            .astype(np.int32))}
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.n_frames, cfg.d_model), dtype=np.float32))
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.n_patches, cfg.d_model), dtype=np.float32))
        results = {}
        cpu_params = build_model(cfg, device="cpu").init(0)
        card_params = copy.deepcopy(cpu_params).to(device)
        for dev, params in (("cpu", cpu_params), (device, card_params)):
            model = build_model(cfg, device=dev)
            named = trainable(params)
            before = {k: m.launches for k, m in counters.items()}
            loss, _ = model.loss(params, {k: v.to(dev) for k, v in batch.items()})
            grads = torch.autograd.grad(loss, list(named.values()))
            results[str(dev)] = (float(loss.detach()), {n: g.detach().cpu() for n, g in
                                                       zip(named, grads)},
                                 {k: m.launches - before[k] for k, m in counters.items()})
        (loss_c, grads_c, _), (loss_g, grads_g, launched) = results["cpu"], results[str(device)]
        # the largest error over its tolerance, 1e-4 of the tensor's largest plus 1e-7
        worst = max(float((grads_g[n] - g).abs().max() / (1e-4 * g.abs().max() + 1e-7))
                    for n, g in grads_c.items())
        ok = worst <= 1.0
        check(abs(loss_g - loss_c) <= 1e-5 * abs(loss_c), f"{arch}: card loss {loss_g} against "
                                                         f"the CPU's {loss_c}")
        check(ok, f"{arch}: a card gradient is off the CPU's by more than 1e-4 of its largest "
                  f"(worst {worst:.3e})")
        attn = cfg.family != "ssm"
        check(launched["flash_attention_backward"] > 0 if attn else True,
              f"{arch}: the flash backward kernel did not run")
        check(launched["assign_gate_backward"] > 0 if cfg.family == "moe" else True,
              f"{arch}: the gate backward kernel did not run")
        out[arch] = dict(loss_card=loss_g, loss_cpu=loss_c, worst_grad_err=worst,
                         launches=launched)
        print(f"[train-families] {arch} f32 smoke: loss card {loss_g:.7f} cpu {loss_c:.7f}; the "
              f"worst gradient error is {worst:.3f} of its tolerance; launches "
              f"{json.dumps(launched)}")
    return out


def phase_train(device) -> dict:
    """Phase 21: training.  Returns the kernel rows of the two backward kernels."""
    import torch

    t0 = time.perf_counter()
    laps = []

    def lap(name):
        laps.append(f"{name} {time.perf_counter() - t0:.1f}s")

    flash = phase_flash_backward(device)
    lap("21(b) flash")
    gate = phase_gate_backward(device)
    lap("21(b) gate")
    torch.cuda.empty_cache()
    main = phase_train_granite(device)
    lap("21(a)")
    families = phase_train_card_vs_cpu(device)
    lap("21(c)")
    print(f"[train] phase 21 took {time.perf_counter() - t0:.1f}s ({', '.join(laps)})")
    g = flash["granite"]
    flash_row = dict(
        name="flash_attention_backward", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention/ops.py:34", launches=main["launches"][
            "flash_attention_backward"], max_abs_err=g["max_abs_err"], ms=g["ms"],
        plain_ms=g["plain_ms"], bound_ms=g["bound_ms"], bound_by=g["bound_by"],
        library_ms=g["library_ms"], shapes=flash, launches_per_step=main["per_step"],
    )
    r = gate["granite"]
    gate_row = dict(
        name="assign_gate_backward", route="cuda",
        source="src/repro_torch/kernels/assign/csrc/gate_backward.cu",
        replaces="src/repro/kernels/assign/ref.py:35", launches=main["launches"][
            "assign_gate_backward"], max_abs_err=r["max_abs_err"], ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
        shapes=gate,
    )
    train = dict(tokens_per_s=main["tokens_per_s"], losses=main["losses"], peak_gb=main["peak_gb"],
                 step_ms=main["step_ms"], profile=main.get("profile"), variants=main["variants"],
                 families=families, launches=main["launches"])
    return dict(flash_attention_backward=flash_row, assign_gate_backward=gate_row, train=train)


# --------------------------------------------------------------------------
# phase 22: checkpoints and restart-safe training (checkpoint/, ft/, parallel/)
# --------------------------------------------------------------------------

FT_LAYERS = 4                  # depth cut of phase 22 (24 -> 4): 264M parameters, 3.2 GB a checkpoint
FT_STEPS, FT_EVERY, FT_FAIL = 6, 2, 3
FT_CKPT_BYTES_A_PARAM = 12     # bf16 parameters stored as f32, f32 m and v
FT_DISK_MARGIN = 1.25


def ft_model(device):
    """granite-moe at full width, FT_LAYERS layers, and phase 21's pipeline."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import build_model

    cfg = get_config(TRAIN_ARCH).replace(n_layers=FT_LAYERS)
    model = build_model(cfg, device=device)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH), device=device)
    return cfg, model, pipe


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in pathlib.Path(path).rglob("*") if p.is_file())


def ft_run_numbers(label: str, report, wall: float) -> dict:
    """A run's rates and checkpoint costs from its ``RunReport``."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ms = [t * 1e3 for t in report.step_times]
    busy = [t for t, f in zip(ms, report.save_in_flight) if f]
    idle = [t for t, f in zip(ms, report.save_in_flight) if not f][1:]  # the first step warms up
    out = dict(losses=report.losses, step_ms=ms, restarts=report.restarts,
               steps_done=report.steps_done,
               tokens_per_s_steps=tokens * len(ms) / sum(report.step_times),
               tokens_per_s_run=tokens * report.steps_done / wall, wall_s=wall,
               step_ms_save_in_flight=statistics.median(busy) if busy else None,
               step_ms_no_save=statistics.median(idle) if idle else None,
               save_copy_ms=[s * 1e3 for s in report.save_copy_s],
               save_wait_ms=[s * 1e3 for s in report.save_wait_s],
               write_s=report.write_s, restore_s=report.restore_s)
    print(f"[ft] {label}: {report.steps_done} steps, {report.restarts} restarts, "
          f"{len(ms)} steps run in {wall:.2f}s; {out['tokens_per_s_steps']:.1f} tokens/s over "
          f"the steps, {out['tokens_per_s_run']:.1f} over the run (saves and restarts "
          f"included); step ms {[round(t, 1) for t in ms]} (a save in flight at "
          f"{[i for i, f in enumerate(report.save_in_flight) if f]}): median "
          f"{out['step_ms_save_in_flight']} with a save in flight, {out['step_ms_no_save']} "
          f"without; host copy ms {[round(t, 1) for t in out['save_copy_ms']]} and wait for "
          f"the last write ms {[round(t, 1) for t in out['save_wait_ms']]} on the training "
          f"thread; writer thread s {[round(t, 3) for t in report.write_s]}; restore s "
          f"{[round(t, 3) for t in report.restore_s]}; losses {report.losses}")
    return out


def phase_ft_restart(device, tmp_root) -> dict:
    """Phase 22(a): a clean ``train_with_restarts`` run and one with a failure
    injected at FT_FAIL, each FT_STEPS steps with a checkpoint every
    FT_EVERY, each in its own fresh directory, the counters set to 0 just
    before the first.  Returns the faulty run's directory, kept for (c)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.ft import FailureInjector, train_with_restarts
    from repro_torch.models import param_count
    from repro_torch.train import AdamWConfig

    cfg, model, pipe = ft_model(device)
    n_params = param_count(model.init(0))
    torch.cuda.empty_cache()
    need = 3 * FT_CKPT_BYTES_A_PARAM * n_params * FT_DISK_MARGIN
    free = shutil.disk_usage(tmp_root).free
    check(free >= need, f"phase 22 needs {need / 1e9:.1f} GB free under {tmp_root} for three "
                        f"checkpoints of {n_params} parameters; {free / 1e9:.1f} GB are free, "
                        f"{(need - free) / 1e9:.1f} GB short")
    counters = train_counters()
    runs, dirs, sums = {}, {}, {}
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    for label, injector in (("clean", None), ("faulty", FailureInjector(at_steps=(FT_FAIL,)))):
        dirs[label] = tempfile.mkdtemp(prefix=f"ft_{label}_", dir=tmp_root)
        t0 = time.perf_counter()
        report = train_with_restarts(model, pipe, total_steps=FT_STEPS, ckpt_dir=dirs[label],
                                     ckpt_every=FT_EVERY, opt_cfg=AdamWConfig(**TRAIN_OPT),
                                     microbatches=TRAIN_MICRO, injector=injector)
        torch.cuda.synchronize()
        runs[label] = ft_run_numbers(label, report, time.perf_counter() - t0)
        names = sorted(p.name for p in pathlib.Path(dirs[label]).iterdir())
        check(names == [f"step_{s:08d}" for s in range(FT_EVERY, FT_STEPS + 1, FT_EVERY)],
              f"phase 22 {label}: the checkpoint directory holds {names}")
        runs[label]["bytes"] = dir_bytes(pathlib.Path(dirs[label]) / f"step_{FT_STEPS:08d}")
        sums[label] = params_checksum(report.state.params)
        report.state = None
        torch.cuda.empty_cache()
        if label == "clean":   # the disk holds one run's checkpoints at a time
            shutil.rmtree(dirs["clean"])
    launches = {name: mod.launches for name, mod in counters.items()}
    clean, faulty = runs["clean"], runs["faulty"]
    check(faulty["restarts"] == 1 and faulty["steps_done"] == FT_STEPS,
          f"phase 22: {faulty['restarts']} restarts, {faulty['steps_done']} steps")
    replay = clean["losses"][:FT_FAIL] + clean["losses"][FT_FAIL - 1:]
    check(faulty["losses"] == replay, f"phase 22: the faulty run's losses {faulty['losses']} do "
                                      f"not replay the clean run's {clean['losses']}")
    check(all(math.isfinite(x) for x in clean["losses"]), "phase 22: a non-finite loss")
    check(all(v > 0 for v in launches.values()),
          f"phase 22: a kernel of the training path was not launched: {json.dumps(launches)}")
    check(sums["clean"] == sums["faulty"], f"phase 22: the final parameters' checksum "
                                           f"{sums['faulty']} is not the clean run's "
                                           f"{sums['clean']}")
    print(f"[ft] granite-moe {FT_LAYERS} layers ({n_params} parameters): the failure at step "
          f"{FT_FAIL} restarted once from step {FT_FAIL - 1}'s checkpoint; the replayed losses "
          f"equal the clean run's bit for bit, the final parameters' checksum {sums['clean']} "
          f"too; a checkpoint "
          f"{clean['bytes']} bytes; launches over both runs {json.dumps(launches)}")
    del model
    torch.cuda.empty_cache()
    return dict(clean=clean, faulty=faulty, launches=launches, params=n_params,
                checksum=sums["clean"], faulty_dir=dirs["faulty"])


def phase_ft_quantized_states(device, tmp_root) -> dict:
    """Phase 22(b): with 8-bit moments and int8 error feedback, one step, a
    save, a restore into a fresh state, one more step, against the same two
    steps without the save and restore: the losses, the moments' codes and
    scales, the carried error and the parameters bit for bit."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import restore, save
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.train import (AdamWConfig, init_train_state, make_train_step,
                                   train_state_from_tree, train_state_to_tree)

    cfg, model, pipe = ft_model(device)
    kw = dict(opt_8bit=True, compress=True)
    step = make_train_step(model, AdamWConfig(**TRAIN_OPT), microbatches=TRAIN_MICRO, **kw)
    d = tempfile.mkdtemp(prefix="ft_8bit_", dir=tmp_root)
    try:
        kept = init_train_state(model, 0, **kw)
        kept, m0 = step(kept, pipe.batch_at(0))
        t0 = time.perf_counter()
        tree = train_state_to_tree(kept, cfg)
        copy_s = time.perf_counter() - t0
        save(d, 1, tree)
        write_s = time.perf_counter() - t0 - copy_s
        nbytes = dir_bytes(pathlib.Path(d) / "step_00000001")
        del tree
        fresh = init_train_state(model, 1, **kw)
        t0 = time.perf_counter()
        restored, at = restore(d, train_state_to_tree(fresh, cfg, copy=False))
        train_state_from_tree(restored, fresh, cfg)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del restored
        check(at == 1, f"phase 22(b): restored step {at}")
        batch = pipe.batch_at(1)
        kept, m_kept = step(kept, batch)
        fresh, m_fresh = step(fresh, batch)
        a = _flatten(train_state_to_tree(kept, cfg))
        b = _flatten(train_state_to_tree(fresh, cfg))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    losses = (float(m_kept["loss"]), float(m_fresh["loss"]))
    check(losses[0] == losses[1], f"phase 22(b): the loss after the restore {losses[1]} is not "
                                  f"{losses[0]}")
    check(not bad, f"phase 22(b): {len(bad)} leaves differ after the restore, e.g. {bad[:4]}")
    parts = {p: sum(1 for k in a if k.endswith(p)) for p in ("/q", "/scale")}
    parts["err"] = sum(1 for k in a if k.startswith(".err/"))
    check(all(parts.values()), f"phase 22(b): the state lacks 8-bit or error leaves {parts}")
    print(f"[ft] 8-bit moments and error feedback at {FT_LAYERS} layers: step, save, restore "
          f"into a fresh state, step = two steps without: losses {float(m0['loss'])}, "
          f"{losses[0]} and all {len(a)} leaves ({parts}) bit for bit; a checkpoint {nbytes} "
          f"bytes, host copy {copy_s * 1e3:.1f} ms, blocking write {write_s:.3f}s, restore "
          f"{restore_s:.3f}s")
    del kept, fresh, model, step, a, b
    torch.cuda.empty_cache()
    return dict(losses=[float(m0["loss"]), losses[0]], bytes=nbytes, copy_ms=copy_s * 1e3,
                write_s=write_s, restore_s=restore_s)


def ft_reshard_rank(mesh, out_dir: str, ckpt_dir: str) -> None:
    """One rank of a spawned NCCL mesh: restore ``ckpt_dir`` with
    ``shardings=params_shardings(...)`` on a ``("data", "model")`` mesh of
    (ranks // 2, 2) and hold this rank's shard of every leaf against its
    slice of the checkpoint's array; writes ``rank<r>.json``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.models import build_model

    n = mesh.size()
    grid = init_device_mesh("cuda", (n // 2, 2), mesh_dim_names=("data", "model"))
    cfg = get_config(TRAIN_ARCH).replace(n_layers=FT_LAYERS)
    report = ft_check_resharded(build_model(cfg, device=D.mesh_device(mesh)), cfg, grid,
                                ckpt_dir)
    (pathlib.Path(out_dir) / f"rank{torch.distributed.get_rank()}.json").write_text(
        json.dumps(report))


def ft_spec_slice(spec, shape, sizes: dict, coord: dict) -> tuple:
    """The block of a leaf a mesh position holds under a spec, as JAX splits
    it: a dimension over axes (a, b) in |a| * |b| blocks, block
    i_a * |b| + i_b."""
    out = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        idx, parts = 0, 1
        for a in axes:
            idx, parts = idx * sizes[a] + coord[a], parts * sizes[a]
        out.append(slice(idx * n // parts, (idx + 1) * n // parts))
    return tuple(out)


def ft_check_resharded(model, cfg, grid, ckpt_dir: str) -> dict:
    """Restore the latest checkpoint of ``ckpt_dir`` as DTensors on ``grid``
    and compare each leaf's local shard with its slice of the npz array."""
    import os

    import numpy as np
    import torch

    from repro_torch.checkpoint import restore
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.parallel import params_shardings
    from repro_torch.train import init_train_state, train_state_to_tree

    template = train_state_to_tree(init_train_state(model, 1), cfg, copy=False)
    shardings = params_shardings(template, grid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree, step = restore(ckpt_dir, template, shardings=shardings)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del template
    names = grid.mesh_dim_names
    sizes = dict(zip(names, grid.shape))
    coord = dict(zip(names, grid.get_coordinate()))
    specs = _flatten(shardings)
    bad, sharded, n = [], 0, 0
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")) as z:
        for key, leaf in _flatten(tree).items():
            want = z[key.replace("/", "__")]
            want = want[ft_spec_slice(specs[key].spec, want.shape, sizes, coord)]
            local = leaf.to_local()
            got = (local.float() if local.dtype == torch.bfloat16 else local).cpu().numpy()
            if got.shape != want.shape or not np.array_equal(got, want):
                bad.append(key)
            sharded += any(p.is_shard() for p in leaf.placements)
            n += 1
    return dict(step=step, leaves=n, sharded=sharded, bad=bad, restore_s=seconds,
                coordinate=list(grid.get_coordinate()))


def phase_ft_reshard(device, ckpt_dir: str) -> dict:
    """Phase 22(c): (a)'s last faulty checkpoint restored with
    ``shardings=params_shardings(...)`` as DTensors on a 1-rank NCCL
    ``("data", "model")`` mesh, each leaf bit for bit the checkpoint's array;
    with an even number N >= 2 of cards, also on N spawned ranks over a
    (N // 2, 2) mesh, each rank's shard bit for bit its slice."""
    import tempfile

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import distributed as D

    cfg, model, _ = ft_model(device)
    with D.local_mesh("cuda") as mesh:
        grid = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        check(D.mesh_device(mesh) == device, f"the 1-rank mesh runs on {D.mesh_device(mesh)}")
        one = ft_check_resharded(model, cfg, grid, ckpt_dir)
    del model
    torch.cuda.empty_cache()
    check(not one["bad"] and one["step"] == FT_STEPS,
          f"phase 22(c): resharded leaves differ from the checkpoint: {one['bad'][:4]}")
    print(f"[ft] reshard on restore, a 1-rank NCCL (data, model) mesh: all {one['leaves']} "
          f"leaves as DTensors ({one['sharded']} with a Shard placement), each bit for bit the "
          f"checkpoint's; restore {one['restore_s']:.3f}s")
    out = dict(one_rank=one)
    n_cards = torch.cuda.device_count()
    if n_cards < 2 or n_cards % 2:
        print(f"[ft] {n_cards} card: the N-rank reshard needs an even number of cards >= 2")
        return out
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        D.run_ranks(ft_reshard_rank, n_cards, (tmp, ckpt_dir), device_type="cuda")
        spawn_s = time.perf_counter() - t0
        reports = [json.loads((pathlib.Path(tmp) / f"rank{r}.json").read_text())
                   for r in range(n_cards)]
    for r, rep in enumerate(reports):
        check(not rep["bad"] and rep["leaves"] == one["leaves"],
              f"phase 22(c): rank {r}'s shards differ from their slices: {rep['bad'][:4]}")
    check(sorted(tuple(r["coordinate"]) for r in reports) ==
          sorted((i, j) for i in range(n_cards // 2) for j in range(2)),
          "phase 22(c): the ranks do not cover the mesh")
    print(f"[ft] reshard on restore over {n_cards} ranks, a ({n_cards // 2}, 2) (data, model) "
          f"NCCL mesh: every rank's shard of all {one['leaves']} leaves bit for bit its slice "
          f"({reports[0]['sharded']} leaves sharded); restore s "
          f"{[round(r['restore_s'], 3) for r in reports]}; {spawn_s:.1f}s with the spawn")
    out["ranks"] = dict(n=n_cards, restore_s=[r["restore_s"] for r in reports], spawn_s=spawn_s)
    return out


def start_ft_entry_point(tmp_root):
    """Phase 22(d), started: ``python -m repro_torch.ft --small --steps 10
    --inject 5`` on the card in a process of its own (its start-up, ~25 s,
    overlaps (c) and (b)).  Returns what ``finish_ft_entry_point`` takes."""
    import os
    import tempfile

    d = tempfile.mkdtemp(prefix="ft_main_", dir=tmp_root)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.ft", "--small", "--steps", "10",
                             "--inject", "5", "--ckpt-dir", d], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, d, time.perf_counter()


def finish_ft_entry_point(started) -> dict:
    """Phase 22(d), checked: the process exits 0 and prints ``restarts=1``."""
    import shutil

    proc, d, t0 = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(d, ignore_errors=True)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"phase 22(d): python -m repro_torch.ft exited "
                                f"{proc.returncode}: {err[-2000:]}")
    check("restarts=1" in out, f"phase 22(d): no restarts=1 in {out[-1000:]}")
    summary = " | ".join(line for line in out.splitlines() if line.strip())
    print(f"[ft] python -m repro_torch.ft --small --steps 10 --inject 5 on the card (beside (c) "
          f"and (b)): exit 0 after {seconds:.1f}s: {summary}")
    return dict(seconds=seconds)


def phase_ft(device) -> dict:
    """Phase 22: checkpoints and restart-safe training."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    laps = []

    def lap(name):
        laps.append(f"{name} {time.perf_counter() - t0:.1f}s")

    print(f"[power] {gpu_name_and_power()}")
    tmp_root = tempfile.gettempdir()
    restart = phase_ft_restart(device, tmp_root)
    lap("22(a)")
    started = start_ft_entry_point(tmp_root)
    try:
        try:
            reshard = phase_ft_reshard(device, restart["faulty_dir"])
        finally:
            shutil.rmtree(restart.pop("faulty_dir"), ignore_errors=True)
        lap("22(c)")
        quantized = phase_ft_quantized_states(device, tmp_root)
        lap("22(b)")
    except BaseException:
        proc, d, _ = started
        proc.kill()
        proc.wait()
        shutil.rmtree(d, ignore_errors=True)
        raise
    entry = finish_ft_entry_point(started)
    lap("22(d)")
    print(f"[ft] phase 22 took {time.perf_counter() - t0:.1f}s ({', '.join(laps)})")
    print(f"[power] {gpu_name_and_power()}")
    return dict(restart, quantized=quantized, reshard=reshard, entry=entry, laps=laps)


# --------------------------------------------------------------------------
# phase 23: launch/ (cell plans, counters, roofline terms, the dry-run CLI)
# --------------------------------------------------------------------------

LAUNCH_TIMED_STEPS = 2     # uncounted granite steps timed between CUDA events
LAUNCH_DRYRUN = [("granite-moe-1b-a400m", "train_4k", "single"),
                 ("deepseek-7b", "decode_32k", "multi")]


def start_dryruns(out_dir: str) -> list:
    """Phase 23(c), started first: ``python -m repro_torch.launch.dryrun``
    for each of ``LAUNCH_DRYRUN``, each in its own process on the host's
    CPU (the fake 256/512-rank process group), while the card runs (a) and
    (b)."""
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, mesh in LAUNCH_DRYRUN:
        out = pathlib.Path(out_dir) / f"{arch}__{shape}"
        procs.append((arch, shape, mesh, out, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--mesh", mesh, "--out", str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_dryruns(procs) -> dict:
    out = {}
    for arch, shape, mesh, path, t0, proc in procs:
        try:
            log, _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(proc.returncode == 0, f"dryrun {arch} {shape}: exit {proc.returncode}: "
                                    f"{log[-2000:]}")
        tag = f"{'2x16x16' if mesh == 'multi' else '16x16'}__{arch}__{shape}"
        rec = json.loads((path / f"{tag}.json").read_text())
        check(rec.get("ok") is True, f"dryrun {tag}: {rec.get('error')}")
        check(json.loads((path / "skips.json").read_text()) is not None, "no skips.json")
        check(rec["hlo_flops"] > 0 and math.isfinite(rec["step_s"]), f"dryrun {tag}: {rec}")
        out[tag] = {k: rec[k] for k in ("hlo_flops", "hlo_bytes", "coll_bytes", "coll_breakdown",
                                        "compute_s", "memory_s", "collective_s", "bottleneck",
                                        "roofline_frac", "useful_ratio", "peak_bytes_per_device",
                                        "microbatches", "trace_s")}
        out[tag]["wall_s"] = time.perf_counter() - t0
        print(f"[launch-dryrun] {tag}: {rec['n_devices']} fake ranks, {rec['microbatches']} "
              f"microbatches, traced in {rec['trace_s']:.1f}s ({out[tag]['wall_s']:.1f}s with "
              f"the process); per card {rec['hlo_flops']:.4e} FLOP, {rec['hlo_bytes']:.4e} B, "
              f"{rec['coll_bytes']:.4e} collective B {json.dumps(rec['coll_breakdown'])}; terms "
              f"compute {rec['compute_s']:.6f}s memory {rec['memory_s']:.6f}s collective "
              f"{rec['collective_s']:.6f}s -> {rec['bottleneck']}-bound, roofline_frac "
              f"{rec['roofline_frac']:.6f}, useful {rec['useful_ratio']:.4f}, peak "
              f"{rec['peak_bytes_per_device'] / 1e9:.2f} GB a card; largest collectives "
              f"{json.dumps(rec['top_collectives'][:3])}")
    train = out["16x16__granite-moe-1b-a400m__train_4k"]
    check(train["coll_bytes"] > 0, "the train cell counted no collective bytes")
    return out


def counted(run, *, peak: bool = False):
    """``run()`` under ``roofline.Counter`` -> (its record, the kernels'
    launches in it, the result)."""
    import torch

    from repro_torch.launch.roofline import Counter

    counters = train_counters()
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    with Counter(peak=peak) as c:
        res = run()
        torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in counters.items()}
    return c, launches, res


def meta_batch(batch: dict) -> dict:
    import torch

    return {k: torch.empty_like(v, device="meta") for k, v in batch.items()}


def phase_launch_train(device) -> dict:
    """Phase 23(a): granite-moe-1b-a400m's train_4k cell as ``build_cell``
    plans it on this host's mesh (vocab padded to 49168), at full width and
    depth, cut to phase 21's batch (TRAIN_BATCH x TRAIN_SEQ in TRAIN_MICRO
    microbatches, remat): a warm step, one step under the counter (the
    four kernels launched; its FLOPs equal to the same step's traced on
    meta tensors, exactly), then LAUNCH_TIMED_STEPS steps timed between CUDA
    events: TFLOP/s and the model-FLOPs share of 989 TFLOP/s."""
    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16, make_host_mesh
    from repro_torch.launch.roofline import model_flops_for_cell
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cell = build_cell(TRAIN_ARCH, "train_4k", make_host_mesh())
    cfg = cell.cfg
    check(cfg.vocab_size == 49168, f"vocab padded to {cfg.vocab_size}, not 49168")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH), device=device)
    runs = {}
    for dev in ("meta", device):
        model = build_model(cfg, device=dev)
        state = init_train_state(model, 0)
        step = make_train_step(model, AdamWConfig(**TRAIN_OPT), microbatches=TRAIN_MICRO)
        batch = pipe.batch_at(0)
        if dev == "meta":
            c, _, _ = counted(lambda: step(state, meta_batch(batch)))
            runs["meta"] = c.get_total_flops()
            continue
        torch.cuda.synchronize()
        state, _ = step(state, batch)                       # warm
        c, launches, (state, met) = counted(lambda: step(state, pipe.batch_at(1)))
        loss = float(met["loss"])
        torch.cuda.synchronize()
        marks = []
        for i in range(LAUNCH_TIMED_STEPS):
            b = pipe.batch_at(2 + i)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            state, met = step(state, b)
            e.record()
            marks.append((s, e))
        torch.cuda.synchronize()
        step_ms = [s.elapsed_time(e) for s, e in marks]
        runs["card"] = c.get_total_flops()
        del state, model, step
        torch.cuda.empty_cache()
    check(runs["card"] == runs["meta"], f"granite step: the card counted {runs['card']} FLOP, "
                                        f"the meta trace {runs['meta']}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the counted step was not launched: {json.dumps(launches)}")
    check(math.isfinite(loss), "a non-finite loss")
    step_s = statistics.mean(step_ms) / 1e3
    spec = ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    model_flops = model_flops_for_cell(cfg, spec, "train")
    share = model_flops / (step_s * PEAK_FLOPS_BF16)
    power = gpu_name_and_power()
    print(f"[launch-train] {TRAIN_ARCH} train_4k as build_cell plans it on {make_host_mesh()} "
          f"(vocab {cfg.vocab_size}, {cell.microbatches} microbatches planned; cut to "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICRO}): the counted step "
          f"{runs['card']:.6e} FLOP on the card = {runs['meta']:.6e} traced on meta tensors; "
          f"{c.bytes:.4e} material bytes; launches {json.dumps(launches)}; loss {loss:.4f}; "
          f"uncounted steps {[round(x, 1) for x in step_ms]} ms: "
          f"{runs['card'] / step_s / 1e12:.2f} TFLOP/s counted, model FLOPs "
          f"{model_flops:.4e} (6 N_active D) = {100 * share:.2f}% of 989 TFLOP/s on {power}")
    return dict(flops=runs["card"], meta_flops=runs["meta"], launches=launches,
                step_ms=step_ms, tflops=runs["card"] / step_s / 1e12, model_flops=model_flops,
                model_flops_share=share, bytes=c.bytes, power=power)


def phase_launch_prefill(device) -> dict:
    """Phase 23(b): deepseek-7b's prefill at phase 8's SERVE_BATCH x
    SERVE_PROMPT, counted on the card (= its meta trace, exactly), then
    timed uncounted: TFLOP/s and the model-FLOPs share."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    from repro_torch.launch.roofline import model_flops_for_cell
    from repro_torch.models import build_model

    cfg = get_config(SERVE_ARCH)
    B, S = SERVE_BATCH, SERVE_PROMPT
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
                              .astype(np.int32)).to(device)
    flops = {}
    meta = build_model(cfg, device="meta")
    mparams = meta.init(0)
    c, _, _ = counted(lambda: meta.prefill(mparams, {"tokens": tokens.to("meta")},
                                           meta.init_cache(B, S)))
    flops["meta"] = c.get_total_flops()
    model = build_model(cfg, device=device)
    params = model.init(0)
    cache = model.init_cache(B, S)
    model.prefill(params, {"tokens": tokens}, cache)        # warm
    c, launches, _ = counted(lambda: model.prefill(params, {"tokens": tokens}, cache))
    flops["card"] = c.get_total_flops()
    call_ms = cuda_ms(lambda: model.prefill(params, {"tokens": tokens}, cache), iters=2,
                      warmup=0)
    del params, cache, model
    torch.cuda.empty_cache()
    check(flops["card"] == flops["meta"], f"deepseek prefill: the card counted {flops['card']} "
                                          f"FLOP, the meta trace {flops['meta']}")
    check(launches["flash_attention"] == cfg.n_layers,
          f"prefill launches {json.dumps(launches)}, not one flash launch a layer")
    model_flops = model_flops_for_cell(cfg, ShapeSpec("prefill_32k", S, B, "prefill"), "prefill")
    share = model_flops / (call_ms / 1e3 * PEAK_FLOPS_BF16)
    power = gpu_name_and_power()
    print(f"[launch-prefill] {SERVE_ARCH} prefill {B} x {S}: {flops['card']:.6e} FLOP counted on "
          f"the card = {flops['meta']:.6e} on meta tensors; launches {json.dumps(launches)}; "
          f"{call_ms:.2f} ms uncounted: {flops['card'] / call_ms / 1e9:.2f} TFLOP/s counted, "
          f"model FLOPs {model_flops:.4e} (2 N_active D) = {100 * share:.2f}% of 989 TFLOP/s on "
          f"{power}")
    return dict(flops=flops["card"], meta_flops=flops["meta"], launches=launches,
                ms=call_ms, tflops=flops["card"] / call_ms / 1e9, model_flops=model_flops,
                model_flops_share=share, power=power)


def phase_launch(device) -> dict:
    """Phase 23: the dry-runs start on the CPU, (a) and (b) run on the card,
    then the dry-runs' records are read."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_dryruns(tmp)
        try:
            train = phase_launch_train(device)
            t_a = time.perf_counter() - t0
            prefill = phase_launch_prefill(device)
            t_b = time.perf_counter() - t0
        finally:
            dry = finish_dryruns(procs)
    print(f"[launch] phase 23 took {time.perf_counter() - t0:.1f}s ((a) {t_a:.1f}s, (b) done at "
          f"{t_b:.1f}s, (c) waited on after)")
    return dict(train=train, prefill=prefill, dryrun=dry)


# --------------------------------------------------------------------------
# phase 24: job-parallel simulation (simulate_distributed, lower_distributed)
# --------------------------------------------------------------------------

JP_SUB_ROUNDS = 100            # depth cut of 24(c): phase 9's configuration, 600 -> 100
JP_MEM_ROUNDS = 30             # rounds of 24(a)'s peak-memory runs
JP_BLOCKS = (4, 3)             # 24(f)'s row blocks: B = 25000 and 33334 at J = 100000
JP_DRYRUN_RANKS = 4            # 24(e)'s fake mesh


def jp_policy(kind: str, cores, calls: list):
    """Phase 3's (``"dense"``: ``panda_dispatch`` + capacity dispatch), 4's
    (``"sparse"``: ``data_locality`` + the fused capacity assign) or 9's
    (``"subsys"``: ``critical_path_first`` + capacity dispatch) policy, its
    assigner counted: each call appends the rows it was given and whether a
    job block came with them.  The counter keeps the assigner's
    ``splits_rows``, so a job-parallel run still splits."""
    from repro_torch import core as T
    from repro_torch.kernels.assign import make_capacity_assign, make_fused_capacity_assign

    fn = (make_fused_capacity_assign if kind == "sparse" else make_capacity_assign)(cores)

    def counting(scores, *args, **kw):
        calls.append((scores.shape[0], kw.get("block") is not None))
        return fn(scores, *args, **kw)

    counting.splits_rows = fn.splits_rows
    if kind == "sparse":
        return T.with_fused_assign(T.get_policy("data_locality"), counting)
    return T.with_capacity_assign(
        T.get_policy("critical_path_first" if kind == "subsys" else "panda_dispatch"), counting)


def jp_trimmed(snap: dict, J: int) -> dict:
    """A snapshot with the padding rows of its jobs cut off."""
    return {k: (v[:J] if k.startswith("jobs.") else v) for k, v in snap.items()}


def jp_run(mesh, device, kind: str, jobs, sites, rounds: int, **kw):
    """One counted job-parallel run on ``mesh``: launch counters and the
    collective count set to 0 just before, the plain assignments refused.
    Returns (result, wall seconds, launches, assigner calls, all-gathers)."""
    import torch

    from repro_torch import core as T
    from repro_torch.core import distributed as D
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import fused_cuda as fused_mod
    from repro_torch.kernels.assign import ops as assign_ops
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    calls, gathers = [], [0]
    policy = jp_policy(kind, jobs.cores, calls)
    real_gather = D._all_gather

    def counted_gather(*args):
        gathers[0] += 1
        return real_gather(*args)

    def no_plain_version(*args, **kw):
        raise SmokeFailure("the job-parallel path called a plain assignment version on the card")

    plain = assign_ops.fused_assign_ref, assign_ops.assign_ref
    assign_ops.fused_assign_ref = assign_ops.assign_ref = no_plain_version
    D._all_gather = counted_gather
    try:
        torch.cuda.synchronize()
        assign_mod.launches = fused_mod.launches = segsum_mod.launches = 0
        t0 = time.perf_counter()
        res = D.simulate_distributed(jobs, sites, policy, T.PRNGKey(0), mesh, max_rounds=rounds,
                                     **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"assign": assign_mod.launches, "fused_assign": fused_mod.launches,
                    "segment_sum": segsum_mod.launches}
    finally:
        assign_ops.fused_assign_ref, assign_ops.assign_ref = plain
        D._all_gather = real_gather
    name = "fused_assign" if kind == "sparse" else "assign"
    other = "assign" if kind == "sparse" else "fused_assign"
    check(launches[name] > 0 and launches[name] == len(calls),
          f"job-parallel {kind}: {launches[name]} {name} launches in {len(calls)} rounds with work")
    check(launches[other] == 0, f"job-parallel {kind}: launched the {other} kernel")
    check(all(blk for _, blk in calls), f"job-parallel {kind}: the assigner ran without a block")
    check(gathers[0] == 2 * len(calls),
          f"job-parallel {kind}: {gathers[0]} all-gathers in {len(calls)} rounds with work")
    check_invariants(res, f"job-parallel {kind}")
    return res, wall, launches, calls, gathers[0]


def jp_peak_mb(fn) -> float:
    """MB that ``fn`` allocated at its peak above what was allocated before."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def jp_scaling_rank(mesh, out_dir: str, rounds: int) -> None:
    """One rank of a spawned NCCL mesh: phase 3's configuration through
    ``simulate_distributed`` on this rank's card, a short warm-up call, a
    barrier, then the timed run.  Writes the wall seconds, rounds, peak
    memory and the digest of the result's first J rows to ``rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch import core as T
    from repro_torch.core import distributed as D

    device = D.mesh_device(mesh)
    sites = T.atlas_like_platform(ENGINE_S, seed=1, device=device)
    jobs = T.synthetic_panda_jobs(ENGINE_J, seed=0, duration=6 * 3600.0, device=device)
    policy = jp_policy("dense", jobs.cores, [])
    D.simulate_distributed(jobs, sites, policy, T.PRNGKey(0), mesh, max_rounds=MESH_WARMUP_ROUNDS)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    dist.barrier()
    t0 = time.perf_counter()
    res = D.simulate_distributed(jobs, sites, policy, T.PRNGKey(0), mesh, max_rounds=rounds)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    rank = mesh.get_local_rank("data")
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(dict(
        wall=wall, rounds=int(res.rounds), device=str(device), capacity=res.jobs.capacity,
        peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
        digest=snapshot_digest(jp_trimmed(snapshot(res), ENGINE_J)))))



def jp_scaling(want: dict, n_cards: int) -> list:
    """Phase 24(d): phase 3's configuration through ``simulate_distributed``
    on 2..``n_cards`` spawned NCCL ranks, one card a rank
    (``jp_scaling_rank``); every rank's digest must equal ``want``, the
    one-card ``simulate``'s.  Returns a row a rank count: rounds/s over the
    slowest rank's wall time, each rank's peak memory."""
    import tempfile

    from repro_torch.core import distributed as D

    rows = []
    for ranks in range(2, n_cards + 1):
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            t0 = time.perf_counter()
            D.run_ranks(jp_scaling_rank, ranks, (tmp, DENSE_FULL_ROUNDS), device_type="cuda")
            spawn_s = time.perf_counter() - t0
            reports = [json.loads((pathlib.Path(tmp) / f"rank{r}.json").read_text())
                       for r in range(ranks)]
        for r, rep in enumerate(reports):
            bad = [k for k in want if rep["digest"].get(k) != want[k]]
            check(not bad, f"job-parallel: rank {r} of {ranks} differs from one card in {bad}")
        wall = max(r["wall"] for r in reports)
        rows.append(dict(ranks=ranks, rounds=reports[0]["rounds"],
                         capacity=reports[0]["capacity"],
                         rounds_per_s=reports[0]["rounds"] / wall, wall=wall,
                         spawn_s=spawn_s, peak_gb=[r["peak_gb"] for r in reports]))
        print(f"[jobpar] (d) {ranks} ranks (one a card, NCCL), {reports[0]['rounds']} rounds, "
              f"capacity {reports[0]['capacity']}: {rows[-1]['rounds_per_s']:.2f} rounds/s over "
              f"the slowest rank's {wall:.2f}s; peak GB by rank "
              f"{[round(g, 3) for g in rows[-1]['peak_gb']]}; every rank's result = one card's "
              f"({spawn_s:.1f}s with the processes)")
    return rows

JP_DRYRUN = r"""
import json, sys
import torch
from torch.distributed.device_mesh import DeviceMesh
import repro_torch.core as T
from repro_torch.core import distributed as D
from repro_torch.kernels.assign import make_capacity_assign
from repro_torch.launch.mesh import init_fake_world
J, S, N, ROUNDS = (int(a) for a in sys.argv[1:5])
jobs = T.synthetic_panda_jobs(J, seed=0, duration=6 * 3600.0, device="cpu")
sites = T.atlas_like_platform(S, seed=1, device="cpu")
policy = T.with_capacity_assign(T.get_policy("panda_dispatch"),
                                make_capacity_assign(jobs.cores.to("meta")))
init_fake_world(N)
mesh = DeviceMesh("cpu", torch.arange(N), mesh_dim_names=("data",))
rec = D.lower_distributed(jobs, sites, policy, mesh, max_rounds=ROUNDS)
rec["cuda_initialized"] = torch.cuda.is_initialized()
print(json.dumps(rec))
"""


def start_jp_dryrun():
    """Phase 24(e), started beside (c): ``lower_distributed`` at (a)'s shapes
    on a fake JP_DRYRUN_RANKS-rank mesh, in its own process (the fake
    process group is the process's default group)."""
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-c", JP_DRYRUN, str(ENGINE_J), str(ENGINE_S), str(JP_DRYRUN_RANKS),
         str(DENSE_FULL_ROUNDS)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def finish_jp_dryrun(started) -> dict:
    t0, proc = started
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"lower_distributed: exit {proc.returncode}: {err[-2000:]}")
    rec = json.loads(out.strip().splitlines()[-1])
    n, S = JP_DRYRUN_RANKS, ENGINE_S
    J_pad = ENGINE_J + (-ENGINE_J) % n
    want = 4 * J_pad + 4 * n * S       # i32 picks [J_pad] and claims [n, S]
    gathers = rec["ops"].get("_c10d_functional::all_gather_into_tensor", 0)
    check(gathers == 2 and rec["coll_breakdown"]["all-gather"] == want,
          f"lower_distributed: {gathers} all-gathers of {rec['coll_breakdown']} B, want 2 of "
          f"{want} B")
    check(not rec["cuda_initialized"], "lower_distributed started CUDA")
    rec["wall_s"] = time.perf_counter() - t0
    print(f"[jobpar] (e) lower_distributed, {n} fake ranks, J={ENGINE_J} (block {rec['block_rows']}"
          f" rows) S={S}: one round per card {rec['flops']:.4e} FLOP, {rec['bytes']:.4e} B, "
          f"collectives {json.dumps(rec['coll_breakdown'])} ({gathers} all-gathers: "
          f"{json.dumps(rec['top_collectives'])}), peak of the round's results "
          f"{rec['peak_bytes'] / 1e6:.1f} MB; no CUDA in the process; {rec['wall_s']:.1f}s")
    return {k: rec[k] for k in ("flops", "bytes", "coll_breakdown", "coll_bytes", "peak_bytes",
                                "top_collectives", "ranks", "capacity", "block_rows", "wall_s")}


def phase_jp_fused_pos(device) -> dict:
    """24(f): the fused kernel's ``pos`` output against ``fused_ref`` at the
    engine shape and at JP_BLOCKS' block shapes; the engine shape solved in
    row blocks with ``block_admit`` against one call; device ms a call with
    and without ``pos``."""
    import torch

    from repro_torch.kernels.assign import block_admit, block_claims
    from repro_torch.kernels.assign.fused_cuda import fused_assign_cuda
    from repro_torch.kernels.assign.fused_ref import fused_assign_ref

    N, E, K = ENGINE_J, ENGINE_S, ENGINE_K
    args = fused_inputs(N, E, K, 0, device)
    for B in [N] + [-(-N // n) for n in JP_BLOCKS]:
        part = tuple(a[:B].contiguous() for a in args[:3]) + (args[3],)
        want = fused_assign_ref(*part, with_pos=True)
        got = fused_assign_cuda(*part, with_pos=True)
        plain_call = fused_assign_cuda(*part)
        for name, w, g in zip(("site", "admit", "pos"), want, got):
            check(torch.equal(w, g), f"fused pos B={B}: {int((w != g).sum())} {name} differ")
        check(torch.equal(got[0], plain_call[0]) and torch.equal(got[1], plain_call[1]),
              f"fused B={B}: site/admit change when pos is asked for")
    whole = fused_assign_cuda(*args)
    for n in JP_BLOCKS:
        b = -(-N // n)
        base = torch.zeros(E, dtype=torch.int32, device=device)
        sites_, admits = [], []
        for r in range(n):
            rows = slice(r * b, min((r + 1) * b, N))
            site, _, pos = fused_assign_cuda(*(a[rows].contiguous() for a in args[:3]), args[3],
                                             with_pos=True)
            admits.append(block_admit(site, pos, args[2][rows], args[3], base))
            base = base + block_claims(site, args[2][rows], E)
            sites_.append(site)
        check(torch.equal(torch.cat(sites_), whole[0]) and torch.equal(torch.cat(admits), whole[1]),
              f"fused: {n} row blocks with block_admit differ from one call")
    call = {w: cuda_ms(lambda w=w: fused_assign_cuda(*args, with_pos=w), iters=200)
            for w in (False, True)}
    dev = {w: sum(device_ms(lambda w=w: fused_assign_cuda(*args, with_pos=w), FUSED_KERNELS,
                            iters=200, per_call=1).values())
           for w in (False, True)}
    bytes_pos = N * K * (4 + 4) + N * 4 + E * 4 + N * (4 + 1) + N * 4
    bound = bytes_pos / PEAK_HBM_BYTES_PER_S * 1e3
    print(f"[jobpar] (f) fused pos: site/admit/pos exact against fused_ref at B={N}, "
          f"{', '.join(str(-(-N // n)) for n in JP_BLOCKS)}; {' and '.join(map(str, JP_BLOCKS))} "
          f"row blocks with block_admit = one call; device {dev[False]:.4f} ms without pos, "
          f"{dev[True]:.4f} ms with ({call[False]:.4f}, {call[True]:.4f} ms a call); bound with "
          f"pos {bound:.4f} ms ({bytes_pos} B)")
    return dict(device_ms=dev[False], device_ms_pos=dev[True], cuda_ms=call[False],
                cuda_ms_pos=call[True], bound_ms_pos=bound)


def phase_job_parallel(device, plain_rates, sparse_rates) -> dict:
    """Phase 24 (after phase 23): (a) phase 3's and (b) phase 4's runs
    through ``simulate_distributed`` on a 1-rank NCCL mesh, bit for bit
    their snapshots, one assign (fused) launch and two all-gathers a round
    with work, rounds/s beside theirs and peak memory beside ``simulate``'s;
    (c) phase 9's configuration cut to JP_SUB_ROUNDS rounds against
    ``simulate`` over as many; (d) with two or more cards, (a) on 2..N
    spawned NCCL ranks, each rank's result = the 1-rank run; (e) the dry run
    in its own process, started beside (c); (f) the fused kernel's ``pos``."""
    import torch

    from repro_torch import core as T
    from repro_torch.core import distributed as D

    t_phase = time.perf_counter()
    out = {}
    sites = T.atlas_like_platform(ENGINE_S, seed=1, device=device)
    jobs = T.synthetic_panda_jobs(ENGINE_J, seed=0, duration=6 * 3600.0, device=device)
    with D.local_mesh("cuda") as mesh:
        check(D.mesh_device(mesh) == device, f"the 1-rank mesh runs on {D.mesh_device(mesh)}")
        # NCCL sets its communicator up at the first collective: outside the timed runs
        t0 = time.perf_counter()
        D.simulate_distributed(jobs, sites, jp_policy("dense", jobs.cores, []), T.PRNGKey(0), mesh,
                               max_rounds=MESH_WARMUP_ROUNDS)
        torch.cuda.synchronize()
        out["warmup_s"] = time.perf_counter() - t0
        print(f"[jobpar] warm-up: {MESH_WARMUP_ROUNDS} rounds through the mesh (the NCCL "
              f"communicator's set-up) {out['warmup_s']:.2f}s")
        for kind, rounds, kw, rates in (("dense", DENSE_FULL_ROUNDS, {}, plain_rates),
                                        ("sparse", SPARSE_FULL_ROUNDS, {"topk": ENGINE_K},
                                         sparse_rates)):
            res, wall, launches, calls, gathers = jp_run(mesh, device, kind, jobs, sites,
                                                         rounds, **kw)
            bad = mismatches(SNAPSHOTS[kind], snapshot(res))
            check(not bad, f"job-parallel {kind}: differs from phase {3 if kind == 'dense' else 4}"
                           f"'s simulate: {bad}")
            rate = res.rounds / wall
            print(f"[jobpar] ({'a' if kind == 'dense' else 'b'}) {kind}: simulate_distributed "
                  f"on a 1-rank NCCL mesh, {res.rounds} rounds, bit for bit phase "
                  f"{3 if kind == 'dense' else 4}'s simulate; launches {json.dumps(launches)} "
                  f"({len(calls)} rounds with work, {gathers} all-gathers, block {calls[0][0]} "
                  f"rows); {rate:.2f} rounds/s against simulate's {rates[0]:.2f}, "
                  f"{rates[1]:.2f} (phase {3 if kind == 'dense' else 4}, this process)")
            out[kind] = dict(launches, rounds=res.rounds, rounds_with_work=len(calls),
                             all_gathers=gathers, rate=rate, simulate_rates=list(rates))
            del res
        policy = jp_policy("dense", jobs.cores, [])
        peak = {"simulate": jp_peak_mb(lambda: T.simulate(jobs, sites, policy, T.PRNGKey(0),
                                                          max_rounds=JP_MEM_ROUNDS,
                                                          device=device)),
                "simulate_distributed": jp_peak_mb(lambda: D.simulate_distributed(
                    jobs, sites, policy, T.PRNGKey(0), mesh, max_rounds=JP_MEM_ROUNDS))}
        print(f"[jobpar] (a) peak memory above the inputs over {JP_MEM_ROUNDS} rounds: simulate "
              f"{peak['simulate']:.1f} MB, simulate_distributed on 1 rank "
              f"{peak['simulate_distributed']:.1f} MB")
        out["dense"]["peak_mb"] = peak
        dry = start_jp_dryrun()
        try:
            scn, ssites, av = subsystem_scenario(device, ENGINE_S, SUB_CHAINS)
            kw = dict(availability=av, workflow=scn.workflow, log_rows=SUB_LOG_ROWS)
            want = full_snapshot(T.simulate(scn.jobs, ssites, jp_policy("subsys", scn.jobs.cores,
                                                                        []),
                                            T.PRNGKey(0), max_rounds=JP_SUB_ROUNDS, device=device,
                                            **kw))
            res, wall, launches, calls, gathers = jp_run(mesh, device, "subsys", scn.jobs, ssites,
                                                         JP_SUB_ROUNDS, **kw)
            bad = mismatches(want, full_snapshot(res))
            check(not bad, f"job-parallel subsystems: differ from simulate: {bad}")
            print(f"[jobpar] (c) phase 9's configuration, {res.rounds} rounds: "
                  f"simulate_distributed = simulate bit for bit (subsystem states and log "
                  f"included); launches {json.dumps(launches)} ({len(calls)} rounds with work); "
                  f"{res.rounds / wall:.2f} rounds/s")
            out["subsystems"] = dict(launches, rounds=res.rounds, rounds_with_work=len(calls),
                                     rate=res.rounds / wall)
            del res, scn, ssites, av
            torch.cuda.empty_cache()
        finally:
            out["dryrun"] = finish_jp_dryrun(dry)
    out["fused_pos"] = phase_jp_fused_pos(device)
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"[jobpar] (d) {n_cards} card: skipped, the spawned ranks need two or more")
    else:
        out["scaling"] = jp_scaling(snapshot_digest(SNAPSHOTS["dense"]), n_cards)
    print(f"[jobpar] phase 24 took {time.perf_counter() - t_phase:.1f}s")
    return out


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    def lap(phase: str) -> None:
        print(f"[time] phase {phase} done at {time.perf_counter() - t_start:.1f}s")

    phase_build()
    rows = phase_kernels(device)
    rows["fused_assign"] = phase_fused_kernel(device)
    lap("2")
    rows["flash_attention"] = phase_flash_kernel(device)
    lap("7")
    launches, plain_rates, plain_prof = phase_full_width(device, DENSE_FULL_ROUNDS)
    lap("3")
    fault_launches = phase_faults_full_width(device, FULL_MAX_ROUNDS, plain_rates, plain_prof)
    lap("13")
    sparse_launches = phase_sparse_full_width(device, SPARSE_FULL_ROUNDS)
    lap("4")
    sub_launches = phase_subsystems_full_width(device, SUB_FULL_ROUNDS, plain_rates)
    lap("9")
    phase_drain(device, DRAIN_ROUNDS)
    lap("5")
    phase_sparse_drain(device, SPARSE_DRAIN_ROUNDS)
    lap("6")
    cross_launches = phase_subsystems_card_vs_cpu(device, CROSS_ROUNDS)
    lap("10")
    print(f"[power] {gpu_name_and_power()}")
    data_launches = phase_data_full_width(device, DATA_FULL_ROUNDS, plain_rates)
    lap("11")
    xdata_launches = phase_data_card_vs_cpu(device, XDATA_ROUNDS)
    lap("12")
    xfault_launches = phase_faults_transfers_full_width(device, DATA_TR_ROUNDS)
    lap("14")
    s50_fault_launches = phase_faults_card_vs_cpu(device, XFAULT_ROUNDS)
    lap("15")
    ens_launches = phase_ensemble_full_width(device, ENS_ROUNDS, plain_rates)
    lap("16a")
    ens_sub_launches = phase_ensemble_subsystems_full_width(device, ENS_SUB_ROUNDS,
                                                            sub_launches["rate"])
    lap("16b")
    xens_launches = phase_ensemble_card_vs_cpu(device, XENS_ROUNDS)
    xens_data_launches = phase_ensemble_data_card_vs_cpu(device, XENS_DATA_ROUNDS)
    lap("16c")
    ens_sparse_launches = phase_ensemble_sparse_full_width(device, ENS_SPARSE_ROUNDS,
                                                           sparse_launches["rates"])
    lap("16d")
    mesh_launches = phase_mesh(device, ens_launches.pop("snapshot"),
                               ens_sparse_launches.pop("snapshot"))
    lap("19")
    ens_data_launches = phase_ensemble_data_full_width(device, ENS_DATA_ROUNDS,
                                                       data_launches["rate_b"])
    ens_fault_launches = phase_ensemble_faults_full_width(device, ENS_FAULT_ROUNDS,
                                                          fault_launches["rate"])
    lap("16e")
    cal_fig3 = phase_calibration_fig3(device)
    cal_platform = phase_calibration_platform(device)
    cal_wlcg = phase_calibration_wlcg(device)
    rows["segment_sum"]["backward"] = phase_segment_sum_backward(device)
    lap("17")
    print(f"[power] {gpu_name_and_power()}")
    serve_launches = phase_serve(device)
    lap("8")
    families = phase_serve_families(device)
    lap("18")
    encdec = phase_serve_encdec_vlm(device)
    lap("20")
    train = phase_train(device)
    lap("21")
    ft = phase_ft(device)
    lap("22")
    launch = phase_launch(device)
    lap("23")
    jobpar = phase_job_parallel(device, plain_rates, sparse_launches["rates"])
    lap("24")
    for name, row in rows.items():
        row["launches"] = (sparse_launches[name] if name == "fused_assign" else
                           serve_launches[name] if name == "flash_attention" else launches[name])
        # the subsystem paths' own counts (phases 9 and 10)
        if name in sub_launches:
            row["launches_subsystems"] = sub_launches[name]
        if name in cross_launches:
            row["launches_subsystems_s50"] = cross_launches[name]
        # the data paths' own counts (phases 11 and 12)
        for part, counts in data_launches.items():
            if isinstance(counts, dict) and name in counts:
                row[f"launches_data_{part}"] = counts[name]
        if name in xdata_launches:
            row["launches_data_s50"] = xdata_launches[name]
        # the fault paths' own counts (phases 13, 14 and 15)
        for part, counts in (("full", fault_launches), ("transfers", xfault_launches),
                             ("s50", s50_fault_launches)):
            if name in counts:
                row[f"launches_faults_{part}"] = counts[name]
        # the ensemble paths' own counts (phase 16): one launch a round for all lanes
        for part, counts in (("full", ens_launches), ("subsystems", ens_sub_launches),
                             ("s50", xens_launches), ("s50_data", xens_data_launches),
                             ("sparse", ens_sparse_launches), ("data", ens_data_launches),
                             ("faults", ens_fault_launches)):
            if name in counts:
                row[f"launches_ensemble_{part}"] = counts[name]
        # the mesh paths' own counts (phase 19): the 1-rank mesh's dense and sparse lanes
        for part in ("dense", "sparse"):
            if name in mesh_launches[part]:
                row[f"launches_mesh_{part}"] = mesh_launches[part][name]
        # the calibration paths' own counts (phase 17), the backward's passes
        for part, counts in (("fig3", cal_fig3), ("platform", cal_platform),
                             ("wlcg", cal_wlcg)):
            if name in counts:
                row[f"launches_calibration_{part}"] = counts[name]
    rows["segment_sum"]["backward"]["launches_calibration_platform"] = cal_platform["backward"]
    # the serving families' own counts (phase 18): the MoE router's assign
    # launches, and the flash launches of every family's greedy run
    fam = families["launches"]
    rows["assign"]["launches_moe"] = {
        name: {"run": fam[name]["launches"]["assign"], "prefill": fam[name]["assign_prefill"],
               "decode_step": fam[name]["assign_decode"]} for name in ("granite", "kimi")}
    rows["assign"]["moe_routes"] = families["moe"]
    rows["flash_attention"]["launches_families"] = {
        name: {"run": st["launches"]["flash_attention"], "prefill": st["flash_prefill"]}
        for name, st in fam.items()}
    rows["flash_attention"]["families"] = families["flash"]
    # the encoder-decoder and VLM families (phase 20): flash launches a
    # prefill and a decode step, and the kernel at each new attention shape
    rows["flash_attention"]["launches_families"].update({
        name: {"run": st["launches"]["flash_attention"], "prefill": st["flash_prefill"],
               "decode_step": st["flash_decode"]} for name, st in encdec["launches"].items()})
    rows["flash_attention"]["families"].update(encdec["flash"])
    if "scaling" in mesh_launches:
        rows["assign"]["mesh_scaling"] = mesh_launches["scaling"]
    # the training path (phase 21): the forward kernels' launches in 6 steps,
    # and the two backward kernels' rows
    rows["flash_attention"]["launches_train"] = train["train"]["launches"]["flash_attention"]
    rows["assign"]["launches_train"] = train["train"]["launches"]["assign"]
    rows["flash_attention_backward"] = train["flash_attention_backward"]
    rows["assign_gate_backward"] = train["assign_gate_backward"]
    rows["flash_attention_backward"]["train"] = train["train"]
    # restart-safe training (phase 22): the four kernels' launches over the
    # clean and the faulty run
    for name in ("flash_attention", "flash_attention_backward", "assign", "assign_gate_backward"):
        rows[name]["launches_ft"] = ft["launches"][name]
    # launch/ (phase 23): the kernels' launches in the counted granite step
    # and deepseek prefill, and the counts against the meta traces
    for name in ("flash_attention", "flash_attention_backward", "assign", "assign_gate_backward"):
        rows[name]["launches_launch_train"] = launch["train"]["launches"][name]
    rows["flash_attention"]["launches_launch_prefill"] = launch["prefill"]["launches"][
        "flash_attention"]
    rows["flash_attention"]["launch"] = {k: launch[k] for k in ("train", "prefill")}
    rows["flash_attention"]["launch"]["dryrun"] = launch["dryrun"]
    # job-parallel simulation (phase 24): the 1-rank mesh's dense, sparse and
    # subsystem runs, and the fused kernel with its pos output
    for part in ("dense", "sparse", "subsystems"):
        for name in ("assign", "fused_assign", "segment_sum"):
            if jobpar[part][name]:
                rows[name][f"launches_job_parallel_{part}"] = jobpar[part][name]
    rows["fused_assign"]["with_pos"] = jobpar["fused_pos"]
    rows["assign"]["job_parallel"] = {k: v for k, v in jobpar.items() if k != "fused_pos"}
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
