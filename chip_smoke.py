"""GPU smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one CUDA card and this checkout (it builds the kernels from
``nestmc_torch/csrc``). Phases, one line or more each:

1. the card: nvidia-smi's name and power limit, torch's device name;
2. the kernel build (nvcc, sm_90a) for p=4 and p=3 at once, seconds each,
   and ptxas's registers and spills of every kernel;
3. each kernel vs its plain PyTorch version, with external noise, at the
   shapes its paths give it: config 3's shape (C=512 chains, S=4000
   subjects, n=10, p=3) for the seven Poisson launch modes (the three obs
   passes; the RW, MALA and Newton refresh and frozen subject steps); the
   judged shape (C=1024, G=1000, n=50, p=4)
   for the Newton path's kernels; the mala-100k shape (C=512, G=100,000,
   n=20, p=3) for mala_step, logp_grad, rwmh_step and loglik, where the
   outputs are compared with the plain version on the first 64 chains
   (cells are independent per chain, so the comparison is exact; the plain
   version's (C, G, n) temporaries are 4.1 GB each at full width); the RW
   preset's shape (C=64, G=100, n=50, p=4) for rwmh_step and loglik;
   config 4's data (ragged-10k at seed 0: C=1024, G=10,000 groups of 5..30
   obs, N about 175,000, p=3) for the two segment kernels (tolerance
   |a-b| <= 2e-5 + rtol |b|, rtol 2e-5 for the loglik and 2e-4 for the
   gradient, the reference's segment contract), with a small case of
   empty groups and a group of more observations than one staged chunk,
   and the widest size bucket of that data (C=1024, about 5,400 groups,
   cap 32, p=3) for the bucketed route's obs passes and Newton and MALA
   steps; then (3d) the tiled templates (logp_grad, logp_grad_hess, the
   value-only loglik, the RW-MH step, the MALA step, the Newton step
   refresh and frozen, with and without the fold; Logit and Poisson) at
   partial tiles and odd sizes for p=3 and p=4 (C, G, n from 1 to 130,
   70, 50, and n=3000 for one unit a tile),
   and the segment kernels' tile at its edges (a group longer than a
   chunk, a group straddling two chunks, empty groups, G and C off the
   tile, one chain); then (3e) the Newton path's kernels (logp_grad,
   logp_grad_hess, newton_step refresh, frozen and frozen+fold) at config
   2's shape (C=64, G=100, n=50, p=4), the 1k-group presets' (C=256,
   G=1000, n=50, p=4; with mala_step's fold mode for -mala) and
   mala-100k-newton's (the mala-100k shape; parity and plain version on
   the first 64 chains), timed with Philox noise (the main paths' mode)
   as extra "cells" of each kernel's record, and the value-only loglik at
   the judged and 1k-group shapes (where group_loglik collection launches
   it once a retained draw); (3f) the binomial family's operands at
   config 2's shape (the mask a trials weight, integers 0..10 with
   zero-weight runs inside groups, y the fraction of successes: what
   models/hier_glm.py's binomial delegate feeds the logistic kernels) for
   loglik, logp_grad and newton_step refresh and frozen+fold, as more
   cells; (3g) the interweave's kernels (asis_stats at the current point
   and at the proposal, asis_propose, asis_accept; port-only, no Pallas
   kernel) in the Laplace mode with a Hessian a chain at the judged shape
   and in the Langevin mode with the shared bound metric at a mala-100k
   rank's (C=256, G=50,000, n=20, p=3), each wrapper against its plain
   version on the same inputs (rows, proposal, log alpha within 1e-3 +
   1e-4 |ref|, alpha within 1e-3 + 2e-3 |ref|; log u drawn within 1 of
   log alpha, so about half the chains accept, and the decisions equal
   wherever |log alpha - log u| > 1e-3), both timed as replays of ten
   captured calls. mala_step's record times the
   main path's mode at mala-100k (Philox noise, no fold; bound without the
   noise operands) and keeps the external-noise time beside it. Dense and
   masked data, with and without the R-hat fold. Each line: the max error
   against the stated tolerance (1e-3 + 1e-4 |ref| where no other is
   said), the accept decisions that differ (all must lie within
   |log alpha - log u| < 1e-3), both times (CUDA
   events; median over 7 batches of 10 back-to-back launches, after
   warm-up; the plain version at full width unless it runs out of memory,
   then on the slice, which the line says) and the bound (below);
4. the moments of the in-kernel Philox normals and uniforms;
5. small-input references: the hierarchical logistic (Newton, MALA,
   RW-MH; on ragged data Newton on the bucket route and MALA on the
   segment route) and nested Poisson (RW-MH, MALA, Newton) samplers on
   the card vs their plain versions on the CPU (posterior means of the
   population parameters within 4 combined MCSEs, mean beta / beta_s
   acceptance within 0.05);
6. the end-to-end paths at full width, launch counters reset just before
   each and read just after: the RW-MH preset (hier-logistic-100-rw),
   config 2 (hier-logistic-100: frozen-metric Newton-MH), config 1
   (eight-schools: plain PyTorch, two noise fills a sweep and no other
   launch; its posterior mu, tau and
   theta against a dense float64 quadrature of the posterior within 6
   standard errors), the exactness tier (the conjugate normal model's
   posterior moments within 5 standard errors of the closed form, as
   tests/test_torch_exactness.py), config 3 (nested-poisson-1k), config 4
   (ragged-10k: Newton-MH per size bucket; these five at full schedule,
   never cut), config 5's Newton variant (mala-100k-newton at full width,
   100/150 sweeps, cut from 200/300 to pay for phase 10d: its launches
   asserted, its R-hat printed), config 5
   (mala-100k), config 4's data on the segment-kernel
   route (ragged-10k-mala's model built with loglik_impl='pallas-segment':
   MALA, then RW-MH on a short schedule whose R-hat is printed, not
   asserted), config 3's MALA and Newton variants and the judged config.
   Each runs through sample() as a user's run does on the card: each
   phase's step captured once as a CUDA graph and replayed
   (``timings["sweep"] == "graph"``, asserted; its capture seconds and
   peak_mem_gb printed), the launches counted at the capture counted again
   at each replay. Each must launch exactly its kernels, as many times as
   its schedule implies, reach worst all-parameter R-hat < 1.01, a
   plausible
   acceptance of its MH-updated block and no NaN. When the time budget
   requires, depth is cut (never width), and the R-hat line is then
   printed, not asserted: first config 3's variants, then the segment
   MALA path, then the judged run, and mala-100k's warmup and draws
   first of all if even minimal other runs would not fit: each runs its
   full schedule only if the script would still end within 60% of its
   budget (TARGET_S, 720 s) with the others at their least (each
   cut path has a least schedule: mala-100k 300/256, config 3's variants
   300/256, the segment MALA path 100/256, judged 150/256). The script
   says so. Phases 7 to 10 run after the fixed paths (the five configs and
   mala-100k-newton) and before the cut ones (mala-100k, the segment
   paths, config 3's variants, judged), so each cut is decided on the
   time actually left, whatever the host's speed;
7. the command line (nestmc_torch/cli.py, in-process ``cli.main``, on the
   card by default), launch counters reset just before each call and read
   just after: (a) ``run --preset hier-logistic-100`` at full width, half
   its schedule (750/2048; phase 6 runs the full one), collecting mu,
   log_tau, beta:8 and group_loglik, a checkpoint every 512 sweeps or
   draws, --save-draws and --metric-json: the Newton path's launches plus
   exactly one loglik a retained draw, the gate over all 408 parameters,
   group_loglik (64, 2048, 100) against the plain pass on the collected
   groups' betas at four draws, the time of one collection; (b) the
   checkpoints cut after the second sample segment and ``run --resume``:
   only the remaining 1024 draws run (plus the
   template's one Hessian pass), the finalized all-parameter R-hat of
   every block equals the uninterrupted run's within 1e-5 (bitwise
   printed); a judged-size checkpoint written and loaded (MB, ms); (c)
   ``run --preset hier-logistic-100-rw`` on the same data (depth cut only
   if the budget demands it) and ``compare`` of the two npz files by
   PSIS-LOO and WAIC: finite elpd, k_hat > 0.7 counts printed; (d) config
   3's subject_loglik and group_loglik on the card vs the CPU's plain
   version at one position, timed as a pois_loglik cell; (e) ``python -m
   nestmc_torch list-presets`` in its own process;
8. the generic hierarchical GLM, posterior-predictive checks and the CSV
   loader (models/hier_glm.py, predictive.py, io/), on the card, launch
   counters reset just before each run and read just after: (a) the
   binomial family at config 2's width (synth_glm G=100, n=50, p=4, 10
   trials, 64 chains, invgamma tau, frozen Newton 750/2048, beta and
   group_loglik collected in full): config 2's launches plus one loglik a
   retained draw (the reweighting adds none), the gate over 408
   parameters, group_loglik at four draws against the plain pass plus the
   log binomial coefficient; (d) posterior_predictive on its draws: 64
   replicates (64, 100, 50) of counts in [0, 10], the masked-mean p-value
   in (0.02, 0.98), timed; (b) the poisson family at config 3's unit width
   (G=4000, n=10, p=3, 512 chains): Newton at 500/1024 (the Poisson
   steps' and obs passes' exact counts; its R-hat and the units its Laplace
   proposal traps printed, not asserted) and MALA at 2000/16384 (exact
   counts, the gate over 12,006 parameters); (c)
   gaussian and negbin at config 2's width (plain PyTorch, Newton on the
   zero-self split, 500/1024: two noise fills a sweep and no other
   launch, the gate, mu and the aux block's
   posterior means within 4 posterior sds of synth_glm's truth); (e) a CSV
   of ragged-10k's seed-0 data through load_csv, native parser and numpy
   path (both timed; the arrays equal from_numpy_ragged's), then 50
   sweeps of config 4's bucket-route Newton on the loaded data (launches
   asserted, R-hat printed);
9. the user-model toolkit and the data layer's converters (data.py's
   from_ragged / to_ragged / pad_groups_to, model.py's vmap_chains,
   distributions.py, transforms.py), on the card: (a) config 4's seed-0
   data split into per-group lists: RaggedData.from_ragged and
   NestedData.from_ragged(max_obs=30).to_ragged() give from_numpy_ragged's
   arrays exactly (host ms printed), and at one position of 1024 chains
   the loglik kernel on the padded form and the seg_loglik kernel on the
   ragged form agree within |a-b| <= 2e-5 + 2e-5 |b|; the judged data
   through pad_groups_to(1024): loglik, logp_grad and logp_grad_hess on
   the 1000 real groups against the unpadded kernels (bitwise printed,
   1e-3 + 1e-4 |ref| asserted), exactly 0 on the 24 padded groups, one
   newton_step refresh without a NaN; config 3's seed-0 data as ys[g][s]
   lists through NestedData3.from_ragged: from_numpy3's arrays and the
   same pois_loglik bits; unequal subjects per group build members; (b)
   a user's hierarchical logistic written for one chain with the port's
   distributions and log transform (make_hier_logistic's priors), lifted
   by vmap_chains, at config 2's width (64 chains, MALA through autograd
   under vmap, 600/1200): no kernel launch but two noise fills a sweep,
   the posterior means of mu
   and tau within 5 combined MCSEs of phase 6's built-in RW run on the
   same data, its R-hat and ms a sweep printed; (c) config 2 (frozen
   Newton, the R-hat fold in the step kernel; 150/200) and config 4's
   segment route (MALA on the segment kernels; 80/100) each run twice at
   seed 0 and once at seed 1: their launches asserted, every collected
   draw and streamed R-hat bitwise equal between the seed-0 runs, mu
   moved by the other seed; the plain segment sum at config 4's shape
   repeats its bits over 10 calls (the float index_add_ it replaced is
   timed and its distinct results counted beside it); (d) simulation-based
   calibration
   (tests/test_sbc.py's sizes: 512 replicas as chains, each with its own
   data, G=4, N=3, 127 draws thinned by 4) on a jax-free copy of the
   calibration model: rank chi-square p > 1e-3 for mu, log tau and
   theta[0], and the posterior sd of theta[0] below 0.6x the prior's.
10. sharding, before phase 6's cut paths: (a) the six step kernels in
   Philox mode (Newton refresh and frozen+fold at the judged shape, MALA
   and RW at config 2's, the three Poisson steps at config 3's), each
   launched on a chain slice and on a unit slice with its offsets:
   bitwise that slice of the full-width launch; the plain passes' batched
   matmuls (ops/loglik.py's eta_padded, xt_sum, xxt_packed) on a chain
   slice at the judged and config 2 shapes: bitwise that slice of the
   full call; (b) two ranks spawned on
   the one card (``--phase10-rank``, NESTMC_* env, a file:// rendezvous;
   multihost.initialize picks gloo) run the judged preset at full width,
   40/40 (``python3 chip_smoke.py --phase10 4`` runs this phase alone on
   four ranks, one a card, NCCL, (ii) then 2 x 2): (i) the preset as the
   ranks build it, with no shard flag (the reference's chain_shards = N,
   1024 N chains: asserted), replayed from each rank's captured graphs
   (``timings["sweep"] == "graph"`` asserted on every rank: the step
   issues no collective) and stepped eagerly (sample's ``_eager``) from
   the same seed, bitwise (draws, R-hat maps, the rank's final part, both
   generators, launches, groups_sum calls), the graph's peak_mem_gb
   within P10_GRAPH_MEM of the eager run's, each rank's ms a sweep of
   both and the capture's seconds printed; each rank's
   Posterior.final_state bitwise its chains' rows of the unsharded
   in-process run's carry, and every collected draw and the carry
   gathered on request (parallel.gather_state) bitwise the whole; (ii)
   one sampling sweep from that carry with group_shards=2, every leaf
   within 1e-4 + 1e-4 |ref| of the unsharded sweep's and mu, log tau and
   their log scales bitwise equal on both ranks, then a group_shards=2
   run whose acceptance is within 0.05 of the unsharded run's (worst
   R-hat printed): over gloo (ranks sharing a card) it steps eagerly
   (asserted: gloo's collectives go through the host), over NCCL it
   replays its graphs, with the all_reduces inside them, and runs again
   eagerly, the two bitwise or within P10_NCCL_TOL (the same checks and
   prints as (i)); groups_sum's calls a sweep (counted per replay under
   a graph) printed, and its ms a sweep timed in a short eager run
   (P10T_SCHED, ``_eager=True``: collectives.TIMING synchronises around
   each call, which a capture cannot hold). The path's Newton launches
   are asserted in both ranks' runs (both ranks time-share one card over
   gloo: not a scaling result); (c) config 4's ragged
   paths group-sharded: in this process, config 4's bucket-route obs
   passes and Philox-mode MALA and Newton steps (refresh, frozen) at
   C=1024 on each half of its 10,000 groups, through the half's bucket
   layout (cut from the global one: the global caps, the half's place in
   each bucket as the steps' Philox offsets), bitwise the global call's
   columns with the same Philox keys drawn, and the two segment passes on
   each half's own layout within their contract; the same two ranks run
   ragged-10k (bucket route, frozen Newton) and ragged-10k-mala (segment
   route, MALA) at full width, 20/20, groups split in two: launches
   asserted per rank (and listed in the kernels line), both generators'
   states equal the unsharded run's from the same seed, acceptance
   within 0.01 of it, each component of the chains' final mu and log tau
   with its mean over the chains within 5 combined standard errors of
   the unsharded run's, mu and log tau bitwise equal on both ranks, the
   loop asserted (eager over gloo, graph over NCCL), and
   one sampling sweep from the unsharded run's final carry with every
   position leaf within 1e-4 + 1e-4 |ref| of the unsharded sweep on at
   least 99% of the chains; the chains whose final mu and log tau are
   within 1e-4 of the unsharded run's are printed (the sums over groups
   differ from the unsharded ones in their last bits, an accept decision
   may flip on that, and the chain then moves on its own); each rank's
   ms a sweep,
   groups_sum calls a sweep (ms a sweep from a short eager run) and
   gather seconds printed; then the
   cost model (utils/profiling.count_sweep) of config 2 and of config 4
   at 8 chains counted on the card and on the CPU, which must be equal,
   and the judged preset's ``--cost-analysis`` line; (d) memory: each
   rank's ``timings.peak_mem_gb`` (the peak allocated through the last
   sweep and the finalize, less what was allocated at sample()'s entry;
   ``peak_mem_gb_gather`` through the final gathers printed beside it) at
   most 0.6x the unsharded run's at the same preset, schedule and seed:
   10b(i) against this process's judged run, 10c's two routes against the
   rank's own unsharded runs, and mala-100k-newton at full width (C=512,
   G=100,000, p=3) on P10D_SCHED, unsharded on rank 0 alone, then with
   the groups split in two on every rank (the preset's own shards at two
   ranks), where each rank's ``peak_mem_gb_gather`` is at most 1.05x its
   ``peak_mem_gb`` (no rank gathers the carry); 10b(i)'s streamed R-hat
   maps, finalized on the rank's chains a slice of units at a time,
   within 1e-6 relative of the unsharded run's; (e) the unit-axis noise
   fill (csrc/philox_fill.cu, one Philox call a quad of elements) in every
   mode at ragged-10k's (1024, 10000, 3) draw and on FILL_BLOCKS against
   its plain version run on the card: words and uniforms bitwise, log
   uniforms and normals within FILL_ULPS ulps (an ulp at least 2^-23), a
   shard's block and blocks that straddle quads bitwise that block of
   their whole fill, each mode timed beside its bound and torch.randn's
   time (a yardstick only); (f)
   with one card a rank (NCCL, ``--phase10 4``) only: P10F_PRESETS
   (judged and ragged-10k with the chains split over every rank,
   mala-100k and -newton at two group shards x N/2, as N ranks build
   them) each replayed from its graphs and stepped eagerly from one seed
   on every rank, with (i)'s checks and prints, each loop run again at
   twice the schedule for its steady ms a sweep (the extra time over the
   extra sweeps) and its fixed cost, and a JSON line of the ranks' table.
11. the compiled segments (nestmc_torch/segments.py), after phase 5 and
   before phase 6: (a) the streamed R-hat update's device-table form
   against its host-index form on the card, bitwise; (b) for judged,
   config 2, rw, config 3 (RW-MH, MALA, Newton), ragged-10k (bucket
   route), ragged-10k-mala (segment route), each 10 warmup sweeps and 10
   sampling draws with the fold, and mala-100k-newton at 4/4, all at full
   width: the engine's warmup and sampling steps from the same carry and
   seed, stepped eagerly and replayed from their captured graphs, every
   leaf of the carry (positions, caches, scales, accept sums,
   preconditioner moments), the fold's and the streamed update's
   accumulators, both generators' states and the launch counts bitwise;
   (c) the same schedule through sample(), eager (its private ``_eager``)
   and graph: draws, streamed R-hat and ESS maps, final positions,
   acceptance, generators and launches bitwise, and each run's wall ms a
   sweep (synced, the capture apart), the capture's seconds and
   ``timings.peak_mem_gb`` printed (the graph's against 1.25x the
   eager's: printed, not gated), with a JSON line of the table. The
   script prints this phase's seconds and phase 6's fixed paths' seconds,
   which the graph shortens. ``python3 chip_smoke.py --phase11`` runs
   this phase alone.

Bound: the least time the card could take for a call, the larger of its
bytes (each input read once, each output written once) over 3.35 TB/s and
its float32 operations over 67 TFLOP/s (the H100 SXM data sheet), with
each operation counted once (exp and log1p as one each, so the operation
count is a floor): nestmc_torch/utils/profiling.py's kernel_work and
bound_ms, the cost model behind ``--cost-analysis``. The Poisson terms take one exp and no log1p or
division, and the Poisson steps read a per-unit prior mean (C, S, p)
where the logistic ones read mu (C, p). The segment kernels count config
4's observations (N, not G x n) and read the (G+1) row pointer. No single
PyTorch call computes any of these functions, so library_ms is null, but
for the noise fill's: torch.randn of its normal draw's shape (the same
distribution, other bits).

Any failed check exits non-zero. The last lines are a JSON object of the
kernels, the nvidia-smi line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time

T_START = time.perf_counter()
BUDGET_S = 1200.0           # the whole script, build included
TARGET_S = 0.6 * BUDGET_S   # where the cut paths aim to end on one card
JUDGED = (1024, 1000, 50, 4)        # C, G, n, p
M100K = (512, 100_000, 20, 3)
MRANK = (256, 50_000, 20, 3)        # a rank of mala-100k's 2 x 2 mesh
RW = (64, 100, 50, 4)                # config 2 (both its presets)
HL1K = (256, 1000, 50, 4)           # hier-logistic-1k (and -mala)
POIS = (512, 4000, 10, 3)           # C, S (subjects), n, p: config 3
# the launches of the hierarchical logistic interweave's gradient modes
# (ops/cuda/asis.py) in W warmup and D sampling sweeps: one move a sweep,
# two statistics passes, a proposal and an accept each
ASIS = {"asis_stats": lambda W, D: 2 * (W + D),
        "asis_propose": lambda W, D: W + D,
        "asis_accept": lambda W, D: W + D}
FILL = (1024, 10_000, 3)            # ragged-10k's (C, G, p) normal draw
# the fill's normals and log uniforms against the plain version's float64
# conversions rounded once: within FILL_ULPS ulps, an ulp counted at least
# 2^-23 (the ulp of 1): near a zero of the cosine the kernel's float32
# cospif is good to about 4e-7 absolute, not to its tiny value's ulps
FILL_ULPS = 8
# blocks of the fill whose rows straddle quads (whole shape, U, block shape,
# c0, u0): K=1 (9, 11), the block from chains 1.. and units 6.. (element
# 17, a quad's lane 1); K=3 over an odd unit count, rows 39 elements
# apart, the block from element 87 (lane 3)
FILL_BLOCKS = [((9, 11), 11, (8, 5), 1, 6),
               ((7, 13, 3), 13, (5, 7, 3), 2, 3)]
SLICE = 64                  # chains the plain versions run on at M100K
SRC = {
    "loglik": ("nestmc_torch/csrc/loglik_logistic.cu",
               "nestmc/ops/pallas/loglik_logistic.py:191"),
    "logp_grad": ("nestmc_torch/csrc/loglik_logistic.cu",
                  "nestmc/ops/pallas/loglik_logistic.py:343"),
    "logp_grad_hess": ("nestmc_torch/csrc/loglik_logistic.cu",
                       "nestmc/ops/pallas/loglik_logistic.py:289"),
    "newton_step_refresh": ("nestmc_torch/csrc/newton_accept.cu",
                            "nestmc/ops/pallas/newton_accept.py:392"),
    "newton_step_frozen": ("nestmc_torch/csrc/newton_accept.cu",
                           "nestmc/ops/pallas/newton_accept.py:392"),
    "mala_step": ("nestmc_torch/csrc/mala_accept.cu",
                  "nestmc/ops/pallas/mala_accept.py:275"),
    "rwmh_step": ("nestmc_torch/csrc/mh_accept.cu",
                  "nestmc/ops/pallas/mh_accept.py:168"),
    "pois_loglik": ("nestmc_torch/csrc/loglik_poisson.cu",
                    "nestmc/ops/pallas/loglik_poisson.py:54"),
    "pois_logp_grad": ("nestmc_torch/csrc/loglik_poisson.cu",
                       "nestmc/ops/pallas/loglik_poisson.py:200"),
    "pois_logp_grad_hess": ("nestmc_torch/csrc/loglik_poisson.cu",
                            "nestmc/ops/pallas/loglik_poisson.py:147"),
    "pois_rwmh_step": ("nestmc_torch/csrc/poisson_accept.cu",
                       "nestmc/ops/pallas/poisson_accept.py:180"),
    "pois_mala_step": ("nestmc_torch/csrc/poisson_accept.cu",
                       "nestmc/ops/pallas/poisson_accept.py:341"),
    "pois_newton_step_refresh": ("nestmc_torch/csrc/poisson_accept.cu",
                                 "nestmc/ops/pallas/poisson_accept.py:576"),
    "pois_newton_step_frozen": ("nestmc_torch/csrc/poisson_accept.cu",
                                "nestmc/ops/pallas/poisson_accept.py:576"),
    "seg_loglik": ("nestmc_torch/csrc/loglik_segment.cu",
                   "nestmc/ops/pallas/loglik_segment.py:244"),
    "seg_logp_grad": ("nestmc_torch/csrc/loglik_segment.cu",
                      "nestmc/ops/pallas/loglik_segment.py:244"),
    # the unit-axis noise fill: no Pallas kernel of its own; the in-kernel
    # Philox draws' conversions (mh_accept.py:48, 72, 80)
    "philox_fill": ("nestmc_torch/csrc/philox_fill.cu",
                    "nestmc/ops/pallas/mh_accept.py:48"),
    # the interweave's kernels: port-only (the reference's move is XLA's)
    "asis_stats": ("nestmc_torch/csrc/asis_move.cu", "none"),
    "asis_propose": ("nestmc_torch/csrc/asis_move.cu", "none"),
    "asis_accept": ("nestmc_torch/csrc/asis_move.cu", "none"),
}


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def left_s() -> float:
    return BUDGET_S - (time.perf_counter() - T_START)


class DeviceKey:
    """Fixed Philox key words on the card, the pair a captured sweep's key
    row hands a launch: times a step kernel's Philox mode without the copy
    to the device that an eagerly drawn key takes."""

    def __init__(self, seed: int, dev):
        from nestmc_torch.rng import SweepRNG

        self.words = SweepRNG(seed, dev).key_table(1)[0].to(dev)

    def key_words(self, device):
        return self.words


def eight_schools_quadrature() -> dict:
    """Posterior moments of the eight-schools model (mu ~ N(0, 10^2), tau ~
    HalfCauchy(5)) by dense float64 grid quadrature over (mu, log tau),
    theta integrated out in closed form; the grid and formulas of the
    reference's test (tests/test_eight_schools.py)."""
    import numpy as np

    y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])
    MU, LT = np.meshgrid(np.linspace(-25.0, 40.0, 800),
                         np.linspace(-7.0, 4.5, 800), indexing="ij")
    TAU = np.exp(LT)
    var = sigma[None, None, :] ** 2 + TAU[..., None] ** 2
    loglik = -0.5 * np.sum((y - MU[..., None]) ** 2 / var
                           + np.log(2 * np.pi * var), axis=-1)
    logpost = (loglik - 0.5 * (MU / 10.0) ** 2 - np.log1p((TAU / 5.0) ** 2)
               + LT)
    w = np.exp(logpost - logpost.max())
    w /= w.sum()
    mu_mean = np.sum(w * MU)
    a, b = 1.0 / sigma**2, 1.0 / TAU[..., None] ** 2
    theta_cond = (a * y + b * MU[..., None]) / (a + b)
    return {"mu_mean": mu_mean, "mu_var": np.sum(w * (MU - mu_mean) ** 2),
            "tau_mean": np.sum(w * TAU),
            "theta_mean": np.sum(w[..., None] * theta_cond, axis=(0, 1))}


def calibration_model(G: int, n: int):
    """A jax-free copy of tests/calibration_model.py's chain-batched model
    (the random-walk interweaving form of its twin in
    tests/test_torch_calibration.py, which imports jax): y_gi ~
    N(theta_g, 1), theta_g ~ N(mu, tau), mu ~ N(0, 2), tau ~
    HalfNormal(1.5) as log tau; RW-MH on theta (G units), mu and log_tau
    and the interweaving move on (tau, theta) with z = (theta - mu)/tau
    fixed. Data {"y": (C, G, n)}: one data set a chain (phase 9d's SBC)."""
    import torch

    from nestmc_torch.distributions import logpdf_halfnormal, logpdf_normal
    from nestmc_torch.kernels.rwmh import accept_prob
    from nestmc_torch.model import Block, ModelSpec

    s0, tau0 = 2.0, 1.5

    def lik(state, data):
        return torch.sum(logpdf_normal(data["y"], state["theta"][:, :, None],
                                       1.0), dim=-1)            # (C, G)

    def gprior(state):
        tau = torch.exp(state["log_tau"])[:, None]
        return logpdf_normal(state["theta"], state["mu"][:, None], tau)

    def tau_prior(lt):
        return logpdf_halfnormal(torch.exp(lt), tau0) + lt

    def cond(name, value, state, data):
        state = {**state, name: value}
        if name == "theta":
            return lik(state, data) + gprior(state)
        if name == "mu":
            return (torch.sum(gprior(state), dim=-1)
                    + logpdf_normal(state["mu"], 0.0, s0))
        return torch.sum(gprior(state), dim=-1) + tau_prior(state["log_tau"])

    def joint(state, data):
        return (torch.sum(lik(state, data) + gprior(state), dim=-1)
                + logpdf_normal(state["mu"], 0.0, s0)
                + tau_prior(state["log_tau"]))

    def prior_sample(rng, data, chains):
        mu = s0 * rng.normal((chains,))
        tau = tau0 * torch.abs(rng.normal((chains,)))
        theta = mu[:, None] + tau[:, None] * rng.normal((chains, G))
        return {"theta": theta, "mu": mu, "log_tau": torch.log(tau)}

    def asis_tau_move(rng, position, cache, scale, data):
        theta, mu, lt = position["theta"], position["mu"], position["log_tau"]
        lt_new = lt + scale[:, 0] * rng.normal(lt.shape)
        theta_new = mu[:, None] + (theta - mu[:, None]) * torch.exp(
            lt_new - lt)[:, None]
        log_alpha = (
            torch.sum(lik({**position, "theta": theta_new}, data)
                      - lik(position, data), dim=-1)
            + tau_prior(lt_new) - tau_prior(lt))
        accept = rng.log_uniform(lt.shape) < log_alpha
        return ({"theta": torch.where(accept[:, None], theta_new, theta),
                 "log_tau": torch.where(accept, lt_new, lt)}, {},
                accept_prob(log_alpha))

    def sample_y(rng, theta):
        return theta[:, :, None] + rng.normal(tuple(theta.shape) + (n,))

    return ModelSpec(
        name="calibration_hier_normal",
        blocks=(Block("theta", (G,), units=G, init_scale=0.5),
                Block("mu", (), init_scale=0.5),
                Block("log_tau", (), init_scale=0.3)),
        init_state=prior_sample, cond_logdensity=cond,
        joint_logdensity=joint, prior_sample=prior_sample,
        joint_moves={"asis_tau": asis_tau_move},
        joint_move_init_scale={"asis_tau": 0.1},
    ), sample_y


P10_SCHED = (40, 40)        # phase 10b's warmup / draws at the judged width
P10_SWEEP_SEED = 77         # the noise of 10b(ii)'s one sweep
P10C_SCHED = (20, 20)       # phase 10c's warmup / draws at config 4's width
P10D_SCHED = (5, 5)         # phase 10d's mala-100k-newton memory reading
P10_MEM_RATIO = 0.6         # a rank's peak_mem_gb / the unsharded run's
P10_GATHER_RATIO = 1.05     # a rank's peak_mem_gb_gather / its peak_mem_gb
# 10c's routes: (tag, preset, loglik_impl): config 4's bucket route (frozen
# Newton) and ragged-10k-mala's segment route (MALA)
P10C_ROUTES = (("bucket", "ragged-10k", "bucket"),
               ("segment", "ragged-10k-mala", "pallas-segment"))
P10T_SCHED = (3, 3)         # the timed (synced) groups_sum runs, eager
P10_GRAPH_MEM = 1.05        # a rank's graph / eager peak_mem_gb
# NCCL's all_reduce of two group shards' partials, captured against eager:
# bitwise expected (a sum of two does not depend on order); else within
# 3.38e-06, the largest one-sweep difference measured of a group-sharded
# sweep against the unsharded one
P10_NCCL_TOL = 3.38e-06
# 10f, one card a rank (NCCL) only: the presets as N ranks build them, each
# stepped eagerly and replayed from its graphs: (preset, warmup, draws)
P10F_PRESETS = (("judged", 100, 100), ("mala-100k", 50, 50),
                ("mala-100k-newton", 50, 50), ("ragged-10k", 100, 100))


# phase 11's paths: (label, preset, loglik_impl, warmup, draws)
P11_PATHS = (
    ("judged", "judged", "auto", 10, 10),
    ("config 2", "hier-logistic-100", "auto", 10, 10),
    ("rw", "hier-logistic-100-rw", "auto", 10, 10),
    ("config 3 RW-MH", "nested-poisson-1k", "auto", 10, 10),
    ("config 3 MALA", "nested-poisson-1k-mala", "auto", 10, 10),
    ("config 3 Newton", "nested-poisson-1k-newton", "auto", 10, 10),
    ("ragged-10k bucket", "ragged-10k", "bucket", 10, 10),
    ("ragged-10k-mala segment", "ragged-10k-mala", "pallas-segment", 10,
     10),
    ("mala-100k-newton", "mala-100k-newton", "auto", 4, 4),
)
P11_MEM_RATIO = 1.25        # graph / eager peak_mem_gb, printed


def phase11(dev, smi: str) -> dict:
    """Phase 11, the compiled segments (nestmc_torch/segments.py), graph
    against eager: (a) the streamed R-hat update's device-table form
    against the host-index form, bitwise; (b) for each of P11_PATHS at
    full width, the warmup and sampling steps from the same carry and seed
    stepped eagerly and replayed from their captured graphs: positions,
    caches, scales, accept sums, preconditioner moments, the fold's and
    the streamed update's accumulators, both generators' states and the
    launch counts bitwise; then sample() on the same schedule, eager (its
    private _eager) and graph: the draws, the streamed R-hat and ESS maps
    and the final carry bitwise, each run's wall ms a sweep (synced; the
    capture apart), capture seconds and timings.peak_mem_gb printed (the
    graph's against P11_MEM_RATIO x the eager's, printed, not gated).
    Returns the graph runs' launch counts."""
    import dataclasses
    import gc

    import torch

    from nestmc_torch import sample
    from nestmc_torch.diagnostics import (
        fold_rhat_init,
        streaming_rhat_init,
        streaming_rhat_table,
        streaming_rhat_update,
        streaming_rhat_update_at,
    )
    from nestmc_torch.kernels.gibbs import make_sweep, rhat_fold_names
    from nestmc_torch.kernels.state import init_kernel_state
    from nestmc_torch.ops.cuda import launch_counts, reset_launch_counts
    from nestmc_torch.presets import get_preset
    from nestmc_torch.rng import SweepRNG
    from nestmc_torch.segments import DrawProgram, WarmupProgram

    t11 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(11)
    pos = {"a": torch.randn(512, 7, 3, generator=gen, device=dev)}
    acc = {"a": (torch.tensor([3.0, 0.0]),
                 torch.randn(512, 2, 7, 3, generator=gen, device=dev),
                 torch.rand(512, 2, 7, 3, generator=gen, device=dev))}
    for idx in (3, 9):
        ref = streaming_rhat_update(acc, pos, idx, 6)["a"]
        act, cnt, _ = streaming_rhat_table(acc["a"][0], [idx], 6)
        got = streaming_rhat_update_at(acc, pos, act[0].to(dev),
                                       cnt[0].to(dev))["a"]
        ok = torch.equal(ref[1], got[0]) and torch.equal(ref[2], got[1])
        say(f"11a streamed update at draw {idx} (half {idx // 6}): device "
            f"table form {'bitwise' if ok else 'DIFFERS from'} the host "
            "index form")
        if not ok:
            fail("the streamed update's table form differs on the card")

    def same(a, b) -> bool:
        """Bitwise equal, NaN where NaN (an R-hat of a short run)."""
        if a.is_floating_point():
            return (a.shape == b.shape
                    and torch.equal(torch.isnan(a), torch.isnan(b))
                    and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))
        return torch.equal(a, b)

    def leaves(tree, where=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{where}.{k}")
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{where}[{i}]")
        elif torch.is_tensor(tree):
            yield where, tree

    def steps(model, data, cfg, W, D, graph):
        """The engine's two programs from one seed: (carry, acc, rng
        states, launches)."""
        rng = SweepRNG(cfg.run.seed, dev)
        reset_launch_counts()
        sweep = make_sweep(model, cfg)
        pool = torch.cuda.graph_pool_handle() if graph else None
        warm = WarmupProgram(sweep, init_kernel_state(model, cfg, rng, data),
                             data, rng, cfg, W, graph, pool)
        warm.run(W)
        state = warm.state()
        warm.close()
        folds = rhat_fold_names(model, cfg)
        prog = DrawProgram(
            sweep, state, data, rng, cfg,
            streaming_rhat_init({k: v for k, v in state.position.items()
                                 if k not in folds}),
            fold_rhat_init(state.position, folds), lambda p: {}, 0, 0,
            D // 2, D, graph, pool)
        del state, warm
        prog.run(D, 0)
        prog.close()
        torch.cuda.synchronize()
        st = prog.state()
        return ({"position": st.position, "log_scale": st.log_scale,
                 "accept_sum": st.accept_sum, "cache": st.cache,
                 "precond": st.precond, "acc": prog.acc()},
                rng.get_state(), launch_counts())

    launches = {}
    table = []
    for label, preset, impl, W, D in P11_PATHS:
        model, data, cfg = get_preset(preset, device=dev, loglik_impl=impl)
        cfg = dataclasses.replace(cfg, run=dataclasses.replace(
            cfg.run, warmup=W, draws=D, full_rhat=True,
            log_every_segment=False))
        (e_c, er, el), (g_c, gr, gl) = (steps(model, data, cfg, W, D, g)
                                        for g in (False, True))
        bad = [w for (w, a), (_, b) in zip(leaves(e_c), leaves(g_c))
               if not same(a, b)]
        bad += [f"rng {k}" for k in er if not torch.equal(er[k], gr[k])]
        if el != gl:
            bad.append(f"launches {el} != {gl}")
        n_leaves = sum(1 for _ in leaves(e_c))
        say(f"11b {label} ({preset}, C={cfg.run.chains}, {W}/{D}): graph "
            f"and eager steps {'bitwise' if not bad else 'DIFFER'} over "
            f"{n_leaves} carry and accumulator leaves, both generators and"
            f" the launches {sum(gl.values())}" + (f": {bad}" if bad else ""))
        if bad:
            fail(f"11b {label}: the graph's steps differ from the eager "
                 f"ones at {bad}")
        del e_c, g_c
        runs = {}
        for eager in (True, False):
            # what earlier runs left to the collector is freed before the
            # run's entry, where its peak_mem_gb starts
            gc.collect()
            torch.cuda.empty_cache()
            rng = SweepRNG(cfg.run.seed, dev)
            reset_launch_counts()
            post = sample(model, data, cfg, rng=rng, _eager=eager)
            runs[eager] = (post, rng.get_state(), launch_counts())
        (e, e_rng, e_l), (g, g_rng, g_l) = runs[True], runs[False]
        for k, v in g_l.items():
            launches[k] = launches.get(k, 0) + v
        ok = (g.timings["sweep"] == "graph" and e_l == g_l
              and all(torch.equal(e_rng[k], g_rng[k]) for k in e_rng))
        for a, b in ((e.draws, g.draws), (e.full_rhat, g.full_rhat),
                     (e.full_ess, g.full_ess),
                     (e.final_state.position, g.final_state.position),
                     (e.accept_rates, g.accept_rates)):
            ok &= all(same(x, y) for (_, x), (_, y) in zip(leaves(a),
                                                           leaves(b)))
        sweeps = W + D * cfg.run.thin

        def ms(post):
            return 1e3 * (post.timings["warmup_s"]
                          + post.timings["sample_s"]) / sweeps
        ratio = g.timings["peak_mem_gb"] / max(e.timings["peak_mem_gb"],
                                               1e-12)
        row = {"path": label, "preset": preset, "W_D": [W, D],
               "eager_ms_sweep": ms(e), "graph_ms_sweep": ms(g),
               "capture_s": g.timings["capture_s"],
               "eager_peak_mem_gb": e.timings["peak_mem_gb"],
               "graph_peak_mem_gb": g.timings["peak_mem_gb"],
               "mem_ratio": ratio}
        table.append(row)
        say(f"11c {label} through sample(): draws, R-hat and ESS maps, "
            f"final positions, acceptance, generators and launches "
            f"{'bitwise' if ok else 'DIFFER'}; ms a sweep eager "
            f"{row['eager_ms_sweep']:.3f} graph {row['graph_ms_sweep']:.3f}"
            f" (capture {row['capture_s']:.3f} s); peak_mem_gb eager "
            f"{row['eager_peak_mem_gb']:.4f} graph "
            f"{row['graph_peak_mem_gb']:.4f} ({ratio:.3f}x, "
            f"{'within' if ratio <= P11_MEM_RATIO else 'OVER'} "
            f"{P11_MEM_RATIO}x; printed) on '{smi}'")
        if not ok:
            fail(f"11c {label}: sample()'s graph run differs from its "
                 "eager run")
        del runs, e, g, model, data
        torch.cuda.empty_cache()
    print(json.dumps({"phase11": table}), flush=True)
    say(f"phase 11 (graph against eager) took "
        f"{time.perf_counter() - t11:.1f} s")
    return launches


def state_pairs(got, ref):
    """(ours, reference) tensor pairs over the leaves of two KernelStates
    (position, log scales, acceptance sums, caches)."""
    import torch

    for part in ("position", "log_scale", "accept_sum", "cache"):
        a, b = getattr(got, part), getattr(ref, part)
        for k, v in b.items():
            if torch.is_tensor(v):
                yield a[k], v
            elif isinstance(v, dict):
                yield from ((a[k][kk], vv) for kk, vv in v.items())


def state_err(got, ref) -> float:
    """max |a - b| / (1 + |b|) over the leaves of two KernelStates."""
    return max(float(((q - r).abs() / (1.0 + r.abs())).max())
               for q, r in state_pairs(got, ref))


def run_pair(got, ref) -> tuple:
    """(what differs, worst |a - b|) between two runs' records, each
    (Posterior, SweepRNG): the collected draws, the streamed R-hat maps,
    every leaf of the rank's final carry and both generators' states."""
    import torch

    (a, ra), (b, rb) = got, ref
    pairs = [(f"draws.{k}", a.draws[k], v) for k, v in b.draws.items()]
    pairs += [(f"rhat.{k}", a.full_rhat[k], v)
              for k, v in (b.full_rhat or {}).items()]
    pairs += [(f"final.{i}", q, r) for i, (q, r) in enumerate(
        state_pairs(a.final_state, b.final_state))]
    pairs += [(f"rng.{k}", ra.get_state()[k], v)
              for k, v in rb.get_state().items()]
    bad = [name for name, q, r in pairs if not torch.equal(q, r)]
    worst = max([float((q.float() - r.float()).abs().max())
                 for name, q, r in pairs
                 if name in bad and not name.startswith("rng.")] or [0.0])
    return bad, worst


def phase10_rank() -> int:
    """One rank of phase 10b: ``python3 chip_smoke.py --phase10-rank``
    under the NESTMC_* env the phase sets (multihost.initialize picks gloo
    when ranks share a card, NCCL when each has its own). The judged
    preset at full width on P10_SCHED: (i) the chains split over every
    rank, replayed from its graphs and stepped eagerly; (ii) one sweep
    from (i)'s final carry with the groups split in two (and the chains
    over the rest), then a run so split (graph on NCCL, eager on gloo;
    on NCCL also eagerly), and a short eagerly timed one; then 10c's
    ragged runs, 10d's memory runs and, on NCCL, 10f's presets. Writes
    rank<r>.json (scalars) and rank<r>.npz (what the phase compares) to
    NESTMC_PHASE10_DIR."""
    import os

    import numpy as np
    import torch

    from nestmc_torch import ShardingConfig, sample
    from nestmc_torch.kernels.gibbs import make_sweep
    from nestmc_torch.ops.bucket import BucketLayout
    from nestmc_torch.ops.cuda import launch_counts, reset_launch_counts
    from nestmc_torch.parallel import collectives, gather_state, multihost
    from nestmc_torch.parallel.sharding import (
        make_mesh,
        make_shard,
        map_specs,
        state_shardings,
        take,
    )
    from nestmc_torch.presets import get_preset, override_run
    from nestmc_torch.rng import SweepRNG

    multihost.initialize()
    ready_s = time.time() - float(os.environ["NESTMC_PHASE10_T0"])
    out = os.environ["NESTMC_PHASE10_DIR"]
    rank, dev = multihost.rank(), multihost.device()
    model, data, cfg = get_preset("judged", device=dev)
    base = override_run(cfg, warmup=P10_SCHED[0], draws=P10_SCHED[1])
    world = multihost.world_size()
    nccl = multihost.backend() == "nccl"
    res = {"rank": rank, "backend": multihost.backend(), "device": str(dev),
           "world_size": world, "ready_s": ready_s}
    arrays = {}
    # the cuBLAS workspace is allocated at a process's first matmul and
    # kept: made here, it is not a run's memory
    torch.ones(64, 64, device=dev) @ torch.ones(64, 64, device=dev)
    torch.cuda.synchronize(dev)
    # the default group's communicator (NCCL makes it at the group's first
    # collective: a sharded graph run's first lockstep check) made here,
    # so that (i)'s first run is not charged for it
    t0 = time.perf_counter()
    torch.distributed.barrier()
    res["comm_s"] = time.perf_counter() - t0

    def peaks(post):
        return [post.timings["peak_mem_gb"],
                post.timings["peak_mem_gb_gather"]]

    def leaves(prefix, st):
        for part in ("position", "log_scale", "accept_sum", "cache"):
            for k, v in getattr(st, part).items():
                if torch.is_tensor(v):
                    arrays[f"{prefix}.{part}.{k}"] = v.cpu().numpy()
                elif isinstance(v, dict):
                    for kk, vv in v.items():
                        arrays[f"{prefix}.{part}.{k}.{kk}"] = vv.cpu().numpy()

    def run(tag, m, d, c, sched, eager=False):
        """sample() on schedule ``sched``, from ``c``'s seed: its record
        (ms a sweep, the loop, capture s, peaks, launches, groups_sum calls
        a sweep, counted per replay under a graph); returns (Posterior,
        its SweepRNG)."""
        c = override_run(c, warmup=sched[0], draws=sched[1])
        rng = SweepRNG(c.run.seed, dev)
        reset_launch_counts()
        collectives.STATS.update(groups_sum_calls=0, groups_sum_s=0.0)
        post = sample(m, d, c, rng=rng, _eager=eager)
        sweeps = sum(sched)
        t = post.timings
        res[f"{tag}_launches"] = launch_counts()
        res[f"{tag}_sweep"] = t["sweep"]
        res[f"{tag}_ms_sweep"] = 1e3 * (t["warmup_s"] + t["sample_s"]) / sweeps
        res[f"{tag}_capture_s"] = t["capture_s"]
        res[f"{tag}_setup_s"] = t["setup_s"]
        res[f"{tag}_peak"] = peaks(post)
        res[f"{tag}_groups_sum_calls_sweep"] = (
            collectives.STATS["groups_sum_calls"] / sweeps)
        res[f"{tag}_groups_sum_ms_sweep"] = (
            1e3 * collectives.STATS["groups_sum_s"] / sweeps)
        if post.accept_mean is not None:
            res[f"{tag}_accept"] = {k: float(v)
                                    for k, v in post.accept_mean.items()}
        return post, rng

    def pair(tag, m, d, c, sched):
        """The run replayed from its graphs (``tag``) and stepped eagerly
        (``tag``_eager) from one seed, compared: what differs and the
        worst difference. Returns the graph run's record."""
        got = run(tag, m, d, c, sched)
        ref = run(f"{tag}_eager", m, d, c, sched, eager=True)
        res[f"{tag}_vs_eager"] = run_pair(got, ref)
        del ref
        return got

    # (i) the preset as a launch of ``world`` ranks builds it: no shard
    # flags, the reference's chain_shards = N and 1024 N chains; the
    # chains split, so the step issues no collective: replayed from its
    # graphs on any backend, and stepped eagerly to compare
    res["i_sharding"] = [cfg.sharding.chain_shards,
                         cfg.sharding.group_shards]
    res["i_chains"] = cfg.run.chains
    post, _ = pair("i", model, data, base, P10_SCHED)
    for k, v in post.draws.items():
        arrays[f"i.draws.{k}"] = v.cpu().numpy()
    for k, v in post.full_rhat.items():
        arrays[f"r.i.rhat.{k}"] = v.cpu().numpy()
    # the rank's part of the final carry, as the Posterior holds it, and
    # its gather on request
    leaves("i_part", post.final_state)
    res["i_span"] = list(post.placement.shard.spans["chains"])
    carry = gather_state(post)
    leaves("i.final", carry)

    # (ii) one sampling sweep from (i)'s final carry, groups split
    split = ShardingConfig(chain_shards=world // 2, group_shards=2)
    cfg_g = dataclasses.replace(base, sharding=split)
    mesh = make_mesh(cfg_g)
    shard = make_shard(model, data, cfg_g, mesh)
    specs = state_shardings(model, cfg_g, mesh)
    local = map_specs(lambda t, sp: take(t, sp, shard.spans), specs, carry)
    rng = SweepRNG(P10_SWEEP_SEED, dev)
    c0, cl, C = shard.spans["chains"]
    if cl != C:
        rng.chains = (c0, C)
    with collectives.activate(shard):
        st = make_sweep(model, cfg_g)(local, shard.local, False, rng)
        for k in ("mu", "log_tau"):
            arrays[f"ii.local.position.{k}"] = st.position[k].cpu().numpy()
            arrays[f"ii.local.log_scale.{k}"] = st.log_scale[k].cpu().numpy()
        st = map_specs(lambda t, sp: collectives.gather(t, sp, shard),
                       specs, st)
    leaves("ii.sweep", st)

    # then a run so split: replayed from its graphs on NCCL (and stepped
    # eagerly to compare), eager on gloo; its groups_sum timed in a short
    # eager run (TIMING synchronises around each call)
    post, _ = (pair if nccl else run)("ii", model, data, cfg_g, P10_SCHED)
    collectives.TIMING = True
    run("ii_timed", model, data, cfg_g, P10T_SCHED, eager=True)
    collectives.TIMING = False
    res["ii_worst_rhat"] = post.worst_rhat()
    res["ii_finite"] = all(bool(torch.isfinite(v).all())
                           for v in post.draws.values())
    res["ii_gather_s"] = post.timings["gather_s"]
    # the rank part of the final carry gathered (gather_state) and cut
    # again must give the part back
    back = gather_state(post)
    part = map_specs(lambda t, sp: take(t, sp, shard.spans), specs, back)
    res["ii_gather_back_ok"] = state_err(part, post.final_state) == 0.0
    del post, carry, st, local, part, back
    torch.cuda.empty_cache()

    # 10c: config 4 at full width on each ragged route, P10C_SCHED from
    # the same seed unsharded (in this process) and with the groups split
    # in two (graph on NCCL, eager on gloo), compared here leaf by leaf;
    # their groups_sum timed in a short eager run
    for route, preset, impl in P10C_ROUTES:
        rm, rd, rcfg = get_preset(preset, device=dev, loglik_impl=impl)
        rbase = dataclasses.replace(rcfg, sharding=ShardingConfig())
        tag = f"c_{route}"
        upost, urng = run(f"{tag}_unsharded", rm, rd, rbase, P10C_SCHED)
        rsplit = dataclasses.replace(rbase, sharding=split)
        post, rrng = run(tag, rm, rd, rsplit, P10C_SCHED)
        collectives.TIMING = True
        run(f"{tag}_timed", rm, rd, rsplit, P10T_SCHED, eager=True)
        collectives.TIMING = False
        res[f"{tag}_gather_s"] = post.timings["gather_s"]
        res[f"{tag}_accept_diff"] = max(
            abs(float(post.accept_mean[k]) - float(v.mean()))
            for k, v in upost.accept_rates.items())
        res[f"{tag}_finite"] = all(
            bool(torch.isfinite(v).all()) for v in
            list(post.draws.values())
            + list(post.final_state.position.values()))
        # the sums over groups differ from the unsharded run's in their
        # last bits, and a flipped accept decision then moves a chain on
        # its own: the runs are compared in distribution (each component
        # of the chains' final mu and log_tau, its mean over the chains
        # within 5 combined standard errors), the chains that stayed
        # within 1e-4 are counted and printed
        final = gather_state(post)
        pairs = list(state_pairs(final, upost.final_state))
        pairs += [(post.draws[k], v) for k, v in upost.draws.items()]
        res[f"{tag}_run_err"] = max(
            float(((q - r).abs() / (1.0 + r.abs())).max()) for q, r in pairs)
        close = torch.ones(rbase.run.chains, dtype=torch.bool, device=dev)
        z = 0.0
        for k in ("mu", "log_tau"):
            q, r = final.position[k], upost.final_state.position[k]
            close &= ((q - r).abs() <= 1e-4 * (1.0 + r.abs())).all(dim=1)
            se = ((q.var(dim=0) + r.var(dim=0)) / q.shape[0]).sqrt()
            z = max(z, float(((q.mean(dim=0) - r.mean(dim=0)).abs()
                              / se).max()))
        res[f"{tag}_close_chains"] = int(close.sum())
        res[f"{tag}_chains"] = rbase.run.chains
        res[f"{tag}_mean_z"] = z
        res[f"{tag}_same_rng"] = all(
            torch.equal(rrng.get_state()[k], v)
            for k, v in urng.get_state().items())
        shard = make_shard(rm, rd, rsplit, mesh)
        # one sampling sweep from the unsharded run's final carry, with
        # the groups split and not: per chain, every leaf of the position
        # within 1e-4
        carry = upost.final_state
        ref = make_sweep(rm, rbase)(carry, rd, False,
                                    SweepRNG(P10_SWEEP_SEED, dev))
        rspecs = state_shardings(rm, rsplit, mesh)
        local = map_specs(lambda t, sp: take(t, sp, shard.spans), rspecs,
                          carry)
        srng = SweepRNG(P10_SWEEP_SEED, dev)
        rc0, rcl, rC = shard.spans["chains"]
        if rcl != rC:
            srng.chains = (rc0, rC)
        with collectives.activate(shard):
            st = make_sweep(rm, rsplit)(local, shard.local, False, srng)
            st = map_specs(lambda t, sp: collectives.gather(t, sp, shard),
                           rspecs, st)
        close = torch.ones(rbase.run.chains, dtype=torch.bool, device=dev)
        for k, r in ref.position.items():
            q = st.position[k]
            close &= ((q - r).abs() <= 1e-4 * (1.0 + r.abs())).reshape(
                q.shape[0], -1).all(dim=1)
        res[f"{tag}_sweep_close_chains"] = int(close.sum())
        for k in ("mu", "log_tau"):
            arrays[f"c.{route}.final.sweep_{k}"] = (
                st.position[k].cpu().numpy())
        del carry, ref, local, st
        res[f"{tag}_spans"] = {k: list(v) for k, v in shard.spans.items()}
        if route == "bucket":
            # the shard's layout as the model cuts it from the global one
            g0, gl, _ = shard.spans["groups"]
            res[f"{tag}_buckets"] = [
                [b.cap, b.size, list(b.units)] for b in
                BucketLayout.build(rd.segment_ids, rd.num_groups).shard(
                    g0, g0 + gl, shard.spans["obs"][0]).buckets]
        for k in ("mu", "log_tau"):
            arrays[f"c.{route}.final.{k}"] = final.position[k].cpu().numpy()
        del rm, rd, post, upost, final
        torch.cuda.empty_cache()

    # 10d: mala-100k-newton at full width on P10D_SCHED, unsharded on rank
    # 0 alone (the others wait), then with the groups split on every rank
    t_d = time.perf_counter()
    mm, md, mcfg = get_preset("mala-100k-newton", device=dev)
    # the preset as N ranks build it (the groups split in two, as the
    # reference's gsh rule gives), and unsharded
    res["d_sharding"] = [mcfg.sharding.chain_shards,
                         mcfg.sharding.group_shards]
    mbase = dataclasses.replace(mcfg, sharding=ShardingConfig())
    if rank == 0:
        upost, _ = run("d_unsharded", mm, md, mbase, P10D_SCHED)
        del upost
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    post, _ = run("d", mm, md, dataclasses.replace(mbase, sharding=split),
                  P10D_SCHED)
    res["d_finite"] = all(bool(torch.isfinite(v).all())
                          for v in post.draws.values())
    del post, mm, md
    torch.cuda.empty_cache()
    res["d_s"] = time.perf_counter() - t_d

    # 10f, one card a rank (NCCL): the presets as N ranks build them,
    # replayed from their graphs and stepped eagerly
    if nccl:
        t_f = time.perf_counter()
        for preset, w, d in P10F_PRESETS:
            fm, fd, fcfg = get_preset(preset, device=dev)
            tag = f"f_{preset}"
            res[f"{tag}_sharding"] = [fcfg.sharding.chain_shards,
                                      fcfg.sharding.group_shards]
            res[f"{tag}_chains"] = fcfg.run.chains
            pair(tag, fm, fd, fcfg, (w, d))
            # each loop again at twice the schedule: the extra time over
            # the extra sweeps is the steady ms a sweep, the rest the
            # run's fixed cost (a communicator's first use, a graph's first
            # replays)
            for loop in (tag, f"{tag}_eager"):
                run(f"{loop}_x2", fm, fd, fcfg, (2 * w, 2 * d),
                    eager=loop != tag)
                t1 = res[f"{loop}_ms_sweep"] * (w + d)
                t2 = res[f"{loop}_x2_ms_sweep"] * 2 * (w + d)
                res[f"{loop}_steady_ms"] = (t2 - t1) / (w + d)
                res[f"{loop}_fixed_s"] = (2 * t1 - t2) / 1e3
            del fm, fd
            torch.cuda.empty_cache()
        res["f_s"] = time.perf_counter() - t_f
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def graph_checks(res: dict, tag: str, what: str, want: str, smi: str,
                 bitwise: bool) -> None:
    """A rank's run ``tag`` replayed from its graphs against the same run
    stepped eagerly (``tag``_eager), as phase10_rank's pair records them:
    the loops recorded, the launches and groups_sum calls a sweep equal
    (a replay counts what its capture counted), the graph's peak memory
    within P10_GRAPH_MEM of the eager run's, and every draw, R-hat map,
    leaf of the final part and generator bitwise (``bitwise``), or, for a
    group-sharded run over NCCL, within P10_NCCL_TOL where they differ.
    Prints the rank's ms a sweep of both, the capture seconds, the calls
    and the peaks."""
    e = f"{tag}_eager"
    bad, worst = res[f"{tag}_vs_eager"]
    ratio = res[f"{tag}_peak"][0] / max(res[f"{e}_peak"][0], 1e-12)
    same = res[f"{tag}_launches"] == res[f"{e}_launches"]
    say(f"{what} rank {res['rank']}: '{res[f'{tag}_sweep']}' "
        f"{res[f'{tag}_ms_sweep']:.3f} ms a sweep (capture "
        f"{res[f'{tag}_capture_s']:.3f} s apart), '{res[f'{e}_sweep']}' "
        f"{res[f'{e}_ms_sweep']:.3f} ms; groups_sum calls a sweep "
        f"{res[f'{tag}_groups_sum_calls_sweep']:.2f} (counted per replay) "
        f"and {res[f'{e}_groups_sum_calls_sweep']:.2f}; launches "
        f"{'equal' if same else 'DIFFER'}; peak_mem_gb "
        f"{res[f'{tag}_peak'][0]:.4f} and {res[f'{e}_peak'][0]:.4f} ({ratio:.3f}x, <= {P10_GRAPH_MEM}); "
        f"graph against eager: "
        + ("bitwise" if not bad else f"{len(bad)} arrays differ, worst "
           f"|a-b| {worst:.3e} (<= {P10_NCCL_TOL}): {bad[:6]}")
        + f" on '{smi}'")
    if (res[f"{tag}_sweep"], res[f"{e}_sweep"]) != (want, "eager"):
        fail(f"{what} rank {res['rank']}: loops {res[f'{tag}_sweep']!r}, "
             f"{res[f'{e}_sweep']!r}, not {want!r}, 'eager'")
    if not same:
        fail(f"{what} rank {res['rank']}: launches {res[f'{tag}_launches']}"
             f" != {res[f'{e}_launches']}")
    if (res[f"{tag}_groups_sum_calls_sweep"]
            != res[f"{e}_groups_sum_calls_sweep"]):
        fail(f"{what} rank {res['rank']}: groups_sum calls differ")
    if not ratio <= P10_GRAPH_MEM:
        fail(f"{what} rank {res['rank']}: graph peak {ratio:.3f}x eager")
    if bad and (bitwise or any(b.startswith("rng.") for b in bad)
                or not worst <= P10_NCCL_TOL):
        fail(f"{what} rank {res['rank']}: graph and eager differ: {bad}, "
             f"worst {worst}")


def phase10_fill(dev, smi: str) -> dict:
    """Phase 10e, the unit-axis noise fill (csrc/philox_fill.cu), in every
    mode: at ragged-10k's (1024, 10000, 3) draw and on FILL_BLOCKS (rows
    that straddle quads, blocks that start off a quad), words and uniforms
    bitwise the plain version's (integer Philox on int64 tensors, run here
    on the card), log uniforms and normals within FILL_ULPS ulps of its
    float64 conversions rounded once (an ulp counted at least 2^-23, the
    ulp of 1); every block bitwise that block of its whole fill. Each
    mode timed at (1024, 10000, 3) beside its bound and torch.randn's time
    (torch.rand's for the uniforms). Returns the normal fill's record:
    {err, ms, plain_ms, library_ms, shape, work}."""
    import math

    import torch

    from nestmc_torch.ops.cuda.philox_fill import (
        FLOAT_OPS,
        philox_fill,
        philox_fill_plain,
    )
    from nestmc_torch.utils.profiling import bound_ms, kernel_work

    def timed(fn, batches=7, per=10):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(batches):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(per):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / per)
        times.sort()
        return times[len(times) // 2]

    def agree(mode, kern, ref):
        """(ok, ulps, max |diff|) of the kernel's fill against the plain
        version's."""
        if mode in ("words", "uniform"):
            return torch.equal(kern, ref), 0.0, 0.0
        ulp = (torch.nextafter(ref.abs(), torch.full_like(
            ref, math.inf)) - ref.abs()).clamp_min(2.0 ** -23)
        d = (kern - ref).abs()
        n_ulp = float((d / ulp).max())
        return n_ulp <= FILL_ULPS, n_ulp, float(d.max())

    FC, FU, FK = FILL
    fshape = (FC, FU, FK)
    fkey = torch.tensor([0x2468ACE, -0x13579BD], dtype=torch.int32,
                        device=dev)
    # (whole shape, U, block shape, c0, u0): a shard's block of the full
    # draw (chains 512.., units 5000..7499); FILL_BLOCKS' straddling ones
    blocks = [(fshape, FU, (FC - 512, 2500, FK), 512, 5000)] + FILL_BLOCKS
    modes = ("words", "uniform", "log_uniform", "normal")
    res, blocks_ok = {}, {}
    for mode in modes:
        kern = philox_fill(fshape, fkey, 0, 0, FU, mode, dev)
        ref = philox_fill_plain(fshape, fkey, 0, 0, FU, mode, device=dev)
        torch.cuda.synchronize()
        res[mode] = agree(mode, kern, ref)
        del kern, ref
        ok = True
        for shape, U, bshape, c0, u0 in blocks:
            whole = philox_fill(shape, fkey, 0, 0, U, mode, dev)
            part = philox_fill(bshape, fkey, c0, u0, U, mode, dev)
            ok &= torch.equal(part, whole[c0:, u0:u0 + bshape[1]])
            for got, args in ((whole, (shape, fkey, 0, 0, U)),
                              (part, (bshape, fkey, c0, u0, U))):
                ok &= agree(mode, got, philox_fill_plain(
                    *args, mode, device=dev))[0]
            del whole, part
        blocks_ok[mode] = bool(ok)
    times = {m: timed(lambda m=m: philox_fill(fshape, fkey, 0, 0, FU, m,
                                              dev)) for m in modes}
    pms = timed(lambda: philox_fill_plain(fshape, fkey, 0, 0, FU, "normal",
                                          device=dev), batches=3, per=2)
    randn_ms = timed(lambda: torch.randn(fshape, device=dev))
    rand_ms = timed(lambda: torch.rand(fshape, device=dev))
    torch.cuda.empty_cache()
    for m in modes:
        w = kernel_work("philox_fill", FC, FU * FK, FLOAT_OPS[m], 1)
        b_ms, by = bound_ms(*w)
        say(f"10e philox_fill {m} at {fshape}: {times[m]:.4f} ms, bound "
            f"{b_ms:.4f} ms by {by} ({w[0] / 1e6:.1f} MB), "
            f"{b_ms / times[m]:.3f} of the bound; torch.randn of the shape "
            f"{randn_ms:.4f} ms, torch.rand {rand_ms:.4f} ms (yardsticks "
            f"only: other bits) on '{smi}'")
    w = kernel_work("philox_fill", FC, FU * FK, FLOAT_OPS["normal"], 1)
    ok = all(v[0] for v in res.values()) and all(blocks_ok.values())
    say(f"10e philox_fill at {fshape}: words bitwise {res['words'][0]}, "
        f"uniforms bitwise {res['uniform'][0]}; log uniforms within "
        f"{res['log_uniform'][1]:.2f} ulps, normals within "
        f"{res['normal'][1]:.2f} ulps (max |diff| {res['normal'][2]:.3e}; "
        f"bound {FILL_ULPS} ulps, an ulp at least 2^-23); blocks (a "
        f"shard's, chains 512.., units 5000..7499, and {len(FILL_BLOCKS)} "
        f"that straddle quads) against the plain version and bitwise their "
        f"whole fill's, by mode: {blocks_ok}; normal {times['normal']:.4f} "
        f"ms against torch.randn {randn_ms:.4f} ms, plain version on the "
        f"card {pms:.3f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"10e philox_fill against its plain version: {res}, blocks "
             f"{blocks_ok}")
    return {"err": res["normal"][2], "ms": times["normal"], "plain_ms": pms,
            "library_ms": randn_ms, "shape": (FC, FU, 0, FK), "work": w}


def phase10(dev, smi: str, ranks: int = 2) -> dict:
    """Phase 10: (a) the step kernels at shard offsets; (b) ``ranks``
    processes (two on the one card by default: gloo; one a card when the
    host has that many: NCCL) run the judged preset at full width,
    chain-sharded over all ranks, then with the groups split in two; (c)
    the same ranks run config 4 on both ragged routes with the groups
    split in two (:func:`phase10c`). Every failed check exits through
    fail(). Then (10e) the unit-axis noise fill (:func:`phase10_fill`).
    Returns (10c's group-sharded runs' launches, 10e's fill record)."""
    import os
    import shutil
    import subprocess
    import tempfile

    import numpy as np
    import torch

    from nestmc_torch import sample
    from nestmc_torch.diagnostics import fold_rhat_scalars
    from nestmc_torch.kernels.gibbs import make_sweep
    from nestmc_torch.ops.cuda import poisson_accept as pacc
    from nestmc_torch.ops.cuda.mala_accept import fused_mala_logistic_step
    from nestmc_torch.ops.cuda.mh_accept import fused_rwmh_logistic_step
    from nestmc_torch.ops.cuda.newton_accept import (
        fused_newton_logistic_step,
    )
    from nestmc_torch.ops.loglik import eta_padded, xt_sum, xxt_packed
    from nestmc_torch.presets import get_preset, override_run
    from nestmc_torch.rng import SweepRNG

    t10 = time.perf_counter()

    def step_case(name, C, U, n, p, seed=5):
        """(launch(rng, cs, us) -> outputs, out layouts) of one step in
        Philox mode on slices cs (chains) and us (units) of its inputs."""
        g = torch.Generator().manual_seed(seed)
        T = p * (p + 1) // 2
        pois_ = name.startswith("pois")
        x = 0.5 * torch.randn(U, n, p, generator=g)
        x[:, :, 0] = 1.0
        y = (torch.poisson(torch.full((U, n), 1.5), generator=g) if pois_
             else (torch.rand(U, n, generator=g) < 0.5).float())
        h = torch.zeros(C, U, T)
        for i in range(p):
            h[..., i * (i + 1) // 2 + i] = 2.0 + torch.rand(C, U, generator=g)
        a = {k: v.to(dev) for k, v in dict(
            beta=0.3 * torch.randn(C, U, p, generator=g),
            v=0.3 * torch.randn(C, U, generator=g),
            g=0.3 * torch.randn(C, U, p, generator=g), h=h,
            ls=0.3 * torch.randn(C, U, generator=g) - 1.0,
            mu=0.3 * torch.randn(C, p, generator=g),
            lt=0.3 * torch.randn(C, p, generator=g) - 0.5,
            bgs=0.3 * torch.randn(C, U, p, generator=g), x=x, y=y,
            mask=torch.ones(U, n),
            fm=torch.randn(2, U, p, C, generator=g),
            fm2=torch.rand(2, U, p, C, generator=g)).items()}
        fsc = fold_rhat_scalars(torch.tensor([3.0, 0.0]), 3, 8)

        def launch(cs, us):
            rng = SweepRNG(9, dev)
            if cs.start:
                rng.chains = (cs.start, C)
            units = (us.start, U) if us.start else None

            def cut(k):
                v = a[k]
                if k in ("x", "y", "mask"):
                    return v[us].contiguous()
                if k in ("mu", "lt"):
                    return v[cs].contiguous()
                if k in ("fm", "fm2"):
                    return v[:, us, :, cs].contiguous()
                return v[cs, us].contiguous()

            d = (cut("x"), cut("y"), cut("mask"))
            if name == "rwmh_step":
                return fused_rwmh_logistic_step(
                    cut("beta"), cut("v"), cut("ls"), cut("mu"), cut("lt"),
                    *d, rng=rng, units=units)
            if name == "mala_step":
                return fused_mala_logistic_step(
                    cut("beta"), cut("v"), cut("g"), cut("ls"), cut("mu"),
                    cut("lt"), *d, rng=rng, units=units)
            if name.startswith("newton_step"):
                frozen = name == "newton_step_frozen_fold"
                return fused_newton_logistic_step(
                    cut("beta"), cut("v"), cut("g"), cut("h"), cut("ls"),
                    cut("mu"), cut("lt"), *d, rng=rng, frozen=frozen,
                    units=units, rhat_fold=((cut("fm"), cut("fm2"), fsc)
                                            if frozen else None))
            step = {"pois_rwmh_step": pacc.fused_rwmh_poisson_step,
                    "pois_mala_step": pacc.fused_mala_poisson_step,
                    "pois_newton_step": pacc.fused_newton_poisson_step}[name]
            args = [cut("beta"), cut("v")]
            if name != "pois_rwmh_step":
                args.append(cut("g"))
            if name == "pois_newton_step":
                args.append(cut("h"))
            return step(*args, cut("ls"), cut("bgs"), cut("lt"), *d, rng=rng,
                        units=units)
        return launch

    def sliced(t, cs, us):
        if t.ndim == 4 and t.shape[0] == 2:        # fold (2, U, p, C)
            return t[:, us, :, cs]
        return t[cs, us]

    cases10a = [("newton_step_refresh",) + JUDGED,
                ("newton_step_frozen_fold",) + JUDGED,
                ("mala_step",) + RW, ("rwmh_step",) + RW,
                ("pois_rwmh_step",) + POIS, ("pois_mala_step",) + POIS,
                ("pois_newton_step",) + POIS]
    for name, C, U, n, p in cases10a:
        launch = step_case(name, C, U, n, p)
        full_out = launch(slice(None), slice(None))
        for cs, us in ((slice(C // 2 + 1, C), slice(None)),
                       (slice(None), slice(U // 2 + 3, U))):
            part = launch(cs, us)
            bad = [i for i, (f, q) in enumerate(zip(full_out, part))
                   if not torch.equal(sliced(f, cs, us), q)]
            where = (f"chains {cs.start}..{C}" if cs.start
                     else f"units {us.start}..{U}")
            say(f"10a {name} at C={C} U={U} n={n} p={p}, {where}: "
                f"{'bitwise the full launch' if not bad else 'DIFFERS'}")
            if bad:
                fail(f"10a: {name} at offsets differs from the full launch "
                     f"(outputs {bad})")
    # the plain passes' batched matmuls (ops/loglik.py, the hier_glm
    # gaussian and negbin likelihoods) on a chain slice: the full call's
    # slice, bitwise, so chain shards repeat the unsharded run there too
    for C, U, n, p in (JUDGED, RW):
        g = torch.Generator().manual_seed(5)
        x = (0.5 * torch.randn(U, n, p, generator=g)).to(dev)
        beta = (0.3 * torch.randn(C, U, p, generator=g)).to(dev)
        r = torch.randn(C, U, n, generator=g).to(dev)
        for cs in (slice(C // 2 + 1, C), slice(0, 3)):
            bad = [name for name, fn in (
                ("eta_padded", lambda c: eta_padded(beta[c], x)),
                ("xt_sum", lambda c: xt_sum(r[c], x)),
                ("xxt_packed", lambda c: xxt_packed(x, r[c].abs())))
                if not torch.equal(fn(slice(None))[cs], fn(cs))]
            say(f"10a plain eta_padded, xt_sum, xxt_packed at C={C} U={U} "
                f"n={n} p={p}, chains {cs.start}..{cs.stop}: "
                f"{'bitwise the full call' if not bad else 'DIFFERS'}")
            if bad:
                fail(f"10a: the plain {bad} on a chain slice differ from the "
                     "full call")
    t10a = time.perf_counter() - t10

    # 10b: the ranks (two share the one card: gloo), judged at full width
    torch.cuda.empty_cache()
    shared = ranks > torch.cuda.device_count()
    backend = "gloo" if shared else "nccl"
    d10 = tempfile.mkdtemp(prefix="phase10_")
    t_spawn = time.time()
    # each rank's stderr goes to a file: a full pipe would stall a rank
    # and, through its collectives, every other
    logs = [open(os.path.join(d10, f"rank{r}.log"), "w")
            for r in range(ranks)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase10-rank"],
        env={**os.environ,
             "NESTMC_COORDINATOR_ADDRESS": f"file://{d10}/rendezvous",
             "NESTMC_NUM_PROCESSES": str(ranks),
             "NESTMC_PROCESS_ID": str(r),
             "NESTMC_PHASE10_DIR": d10, "NESTMC_PHASE10_T0": str(t_spawn)},
        stdout=subprocess.DEVNULL, stderr=logs[r])
        for r in range(ranks)]
    try:
        for proc in procs:
            proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
            proc.wait()
        fail("10b/10c: a rank ran past 300 s")
    finally:
        for f in logs:
            f.close()
    for r, proc in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(d10, f"rank{r}.log")) as f:
                err = f.read()
            fail(f"10b: rank {r} exited {proc.returncode}:\n{err[-3000:]}")
    rk = []
    for r in range(ranks):
        with open(os.path.join(d10, f"rank{r}.json")) as f:
            res = json.load(f)
        with np.load(os.path.join(d10, f"rank{r}.npz")) as z:
            rk.append((res, {k: z[k] for k in z.files}))
    shutil.rmtree(d10, ignore_errors=True)
    t10b_ranks = time.time() - t_spawn
    graph_ii = "eager" if shared else "graph"
    for res, _ in rk:
        say(f"10b rank {res['rank']} of {res['world_size']}: backend "
            f"{res['backend']} on {res['device']}; ready "
            f"{res['ready_s']:.1f} s after the spawn (the default "
            f"group's first collective {res['comm_s']:.3f} s), first sweep "
            f"after {res['ready_s'] + res['comm_s'] + res['i_setup_s']:.1f}"
            f" s on '{smi}'"
            + ("; the ranks time-share one card: not a scaling result"
               if shared else ""))
        if res["backend"] != backend or res["world_size"] != ranks:
            fail(f"10b: rank {res['rank']} ran {res['backend']} of "
                 f"{res['world_size']}, expected {backend} of {ranks}")
        for tag in ("i", "ii"):
            la = res[f"{tag}_launches"]
            for k in ("newton_step_refresh", "newton_step_frozen",
                      "logp_grad_hess", "logp_grad"):
                if not la.get(k):
                    fail(f"10b ({tag}) rank {res['rank']}: {k} launched "
                         f"no time on the path ({la})")
        # (i) the chains split: replayed from graphs on every backend
        graph_checks(res, "i", f"10b(i) judged chains split, "
                     f"{P10_SCHED[0]}/{P10_SCHED[1]}", "graph", smi,
                     bitwise=True)
        # (ii) the groups split: graphs on NCCL, eager over gloo
        if res["ii_sweep"] != graph_ii:
            fail(f"10b(ii) rank {res['rank']}: the group-sharded run over "
                 f"{res['backend']} recorded {res['ii_sweep']!r}, not "
                 f"{graph_ii!r}")
        if not shared:
            graph_checks(res, "ii", f"10b(ii) judged groups split, "
                         f"{P10_SCHED[0]}/{P10_SCHED[1]}", "graph", smi,
                         bitwise=False)
        else:
            say(f"10b(ii) rank {res['rank']}: groups split over gloo: "
                f"'{res['ii_sweep']}' (its all_reduces go through the "
                f"host), {res['ii_ms_sweep']:.2f} ms a sweep, groups_sum "
                f"{res['ii_groups_sum_calls_sweep']:.1f} calls a sweep")
        say(f"10b(ii) rank {res['rank']}: groups_sum timed in an eager run "
            f"({P10T_SCHED[0]}/{P10T_SCHED[1]}, synced around each call): "
            f"{res['ii_timed_groups_sum_calls_sweep']:.1f} calls, "
            f"{res['ii_timed_groups_sum_ms_sweep']:.3f} ms a sweep of "
            f"{res['ii_timed_ms_sweep']:.2f}")
        if res["ii_timed_sweep"] != "eager":
            fail("10b(ii): the timed run did not step eagerly")

    # the unsharded run of the same schedule and seed, in this process
    # (1024 a rank: the chains of the ranks' judged preset)
    jm, jd, jcfg = get_preset("judged", device=dev)
    jbase = override_run(jcfg, warmup=P10_SCHED[0], draws=P10_SCHED[1],
                         chains=1024 * ranks)
    jpost = sample(jm, jd, jbase)
    ref_arrays = {f"i.draws.{k}": v.cpu().numpy()
                  for k, v in jpost.draws.items()}

    def leaves10(prefix, st):
        out = {}
        for part in ("position", "log_scale", "accept_sum", "cache"):
            for k, v in getattr(st, part).items():
                if torch.is_tensor(v):
                    out[f"{prefix}.{part}.{k}"] = v.cpu().numpy()
                elif isinstance(v, dict):
                    for kk, vv in v.items():
                        out[f"{prefix}.{part}.{k}.{kk}"] = vv.cpu().numpy()
        return out

    ref_arrays.update(leaves10("i.final", jpost.final_state))
    for res, _ in rk:
        if res["i_sharding"] != [ranks, 1] or res["i_chains"] != 1024 * ranks:
            fail(f"10b(i): the judged preset at {ranks} ranks built shards "
                 f"{res['i_sharding']} and {res['i_chains']} chains, not the "
                 f"reference's [{ranks}, 1] and {1024 * ranks}")
    # each rank's Posterior holds its part of the final carry: the
    # unsharded carry's rows of its chains, bitwise
    part_bad = []
    for res, arrs in rk:
        c0, cl, _ = res["i_span"]
        keys = [k for k in arrs if k.startswith("i_part.")]
        if len(keys) != len([k for k in ref_arrays
                             if k.startswith("i.final.")]):
            fail(f"10b(i) rank {res['rank']}: {len(keys)} part leaves")
        part_bad += [(res["rank"], k) for k in keys if not np.array_equal(
            arrs[k], ref_arrays["i.final." + k[len("i_part."):]][
                c0:c0 + cl])]
    say(f"10b(i) the judged preset at {ranks} ranks, no shard flags: "
        f"chain_shards {rk[0][0]['i_sharding'][0]}, {rk[0][0]['i_chains']} "
        f"chains; each rank's final_state is its chains' part "
        f"({', '.join(str(r['i_span'][:2]) for r, _ in rk)} of "
        f"{rk[0][0]['i_span'][2]}): "
        f"{'bitwise the unsharded carry' if not part_bad else part_bad}")
    if part_bad:
        fail(f"10b(i): rank parts differ from the unsharded carry's rows")
    got = rk[0][1]
    i_keys = sorted(k for k in got if k.startswith("i."))
    if i_keys != sorted(ref_arrays):
        fail(f"10b(i): leaves {i_keys} != {sorted(ref_arrays)}")
    diff_i = [k for k in i_keys if not np.array_equal(got[k], ref_arrays[k])]
    judged_peak = [jpost.timings["peak_mem_gb"],
                   jpost.timings["peak_mem_gb_gather"]]
    # the streamed R-hat maps: the chain shards finalize a slice of their
    # units at a time; the unsharded run finalizes the whole
    rhat_err, rhat_same = 0.0, 0
    for k, v in jpost.full_rhat.items():
        ref, q = v.cpu().numpy(), got[f"r.i.rhat.{k}"]
        rhat_same += int(np.array_equal(q, ref))
        rhat_err = max(rhat_err, float(np.max(np.abs(q - ref) / np.abs(ref))))
    say(f"10b(i) streamed R-hat maps of the chain-sharded run against the "
        f"unsharded run's: {rhat_same} of {len(jpost.full_rhat)} blocks "
        f"bitwise, worst relative difference {rhat_err:.3e} (<= 1e-6)")
    if not rhat_err <= 1e-6:
        fail(f"10b(i): the chain-sharded R-hat maps differ by {rhat_err}")
    say(f"10b(i) chain_shards={ranks} vs the unsharded run ({P10_SCHED[0]}/"
        f"{P10_SCHED[1]}, every collected draw and the final carry gathered "
        f"on request by parallel.gather_state, {len(i_keys)} arrays): "
        f"{'bitwise equal' if not diff_i else 'DIFFER: ' + str(diff_i)}")
    if diff_i:
        fail("10b(i): chain-sharded draws differ from the unsharded run")
    sweep_ref = leaves10("ii.sweep", make_sweep(jm, jbase)(
        jpost.final_state, jd, False, SweepRNG(P10_SWEEP_SEED, dev)))
    worst_ii = 0.0
    for k, ref in sweep_ref.items():
        q = got[k]
        err = float(np.max(np.abs(q - ref) / (1.0 + np.abs(ref))))
        worst_ii = max(worst_ii, err)
        if not err <= 1e-4:
            fail(f"10b(ii): {k} of the group-sharded sweep off by {err}")
    # the replicated blocks of each chain shard's two group shards
    same = all(np.array_equal(rk[r][1][k], rk[r + 1][1][k])
               for r in range(0, ranks, 2)
               for k in rk[r][1] if k.startswith("ii.local."))
    acc_u = {k: float(v.mean()) for k, v in jpost.accept_rates.items()}
    acc_d = max(abs(res["ii_accept"][k] - v) for res, _ in rk
                for k, v in acc_u.items())
    say(f"10b(ii) chain_shards={ranks // 2} x group_shards=2: one sweep "
        f"from the same carry, every leaf within {worst_ii:.2e} "
        f"(|a-b|/(1+|b|) <= 1e-4) of the unsharded sweep's; mu, log_tau "
        f"and their log scales bitwise equal on each chain shard's group "
        f"shards: {same}; acceptance within {acc_d:.4f} (< 0.05) of the "
        f"unsharded run's {acc_u}; worst R-hat "
        f"{rk[0][0]['ii_worst_rhat']:.4f} (printed, not gated: "
        f"{sum(P10_SCHED)} sweeps)")
    if not same:
        fail("10b(ii): replicated blocks differ between the ranks")
    if not acc_d < 0.05:
        fail(f"10b(ii): acceptance off by {acc_d}")
    if not all(res["ii_finite"] for res, _ in rk):
        fail("10b(ii): NaN or inf in the group-sharded draws")
    for res, _ in rk:
        say(f"10b(ii) rank {res['rank']}: the run's gather of its draws "
            f"(timings.gather_s) {res['ii_gather_s']:.4f} s; its final "
            f"carry's part gathered and cut again gives the part back "
            f"bitwise: {res['ii_gather_back_ok']} on '{smi}'")
        if not res["ii_gather_back_ok"]:
            fail("10b(ii): a gather of the cut carry differs from it")
    del jpost, jm, jd
    torch.cuda.empty_cache()
    t10c = time.perf_counter()
    launches10 = phase10c(dev, smi, rk, ranks, shared)
    phase10d(smi, rk, judged_peak)
    if not shared:
        phase10f(smi, rk)
    fill = phase10_fill(dev, smi)
    say(f"phase 10 (sharding) took {time.perf_counter() - t10:.1f} s: 10a "
        f"{t10a:.1f}, the ranks (10b and 10c) {t10b_ranks:.1f} from spawn "
        f"to exit, 10c in this process {time.perf_counter() - t10c:.1f}")
    return launches10, fill


def phase10f(smi: str, rk: list) -> None:
    """Phase 10f, one card a rank (NCCL): the presets of P10F_PRESETS as
    the N ranks build them (judged and ragged-10k: the chains split over
    every rank; mala-100k and -newton: two group shards x N/2), each rank
    replaying its captured steps and stepping eagerly from one seed
    (graph_checks: bitwise with the chains split, within P10_NCCL_TOL
    with the groups split), with each rank's ms a sweep of both; a JSON
    line of the table."""
    n = len(rk)
    table = []
    for preset, w, d in P10F_PRESETS:
        tag = f"f_{preset}"
        want = [n // 2, 2] if preset.startswith("mala-100k") else [n, 1]
        for res, _ in rk:
            if res[f"{tag}_sharding"] != want:
                fail(f"10f {preset} at {n} ranks sharded "
                     f"{res[f'{tag}_sharding']}, not {want}")
            graph_checks(res, tag, f"10f {preset} ({w}/{d}, "
                         f"{res[f'{tag}_chains']} chains, shards {want})",
                         "graph", smi, bitwise=want[1] == 1)
            e = f"{tag}_eager"
            same = res[f"{tag}_x2_launches"] == res[f"{e}_x2_launches"]
            say(f"10f {preset} rank {res['rank']}: steady ms a sweep (the "
                f"runs at {w}/{d} and {2 * w}/{2 * d}) graph "
                f"{res[f'{tag}_steady_ms']:.3f}, eager "
                f"{res[f'{e}_steady_ms']:.3f}; fixed cost of a run (the "
                f"capture apart) graph {res[f'{tag}_fixed_s']:.3f} s, eager "
                f"{res[f'{e}_fixed_s']:.3f} s; the graph run at "
                f"{2 * w}/{2 * d}: '{res[f'{tag}_x2_sweep']}', launches "
                f"{'equal' if same else 'DIFFER'}")
            if res[f"{tag}_x2_sweep"] != "graph" or not same:
                fail(f"10f {preset} rank {res['rank']}: the runs at twice "
                     "the schedule differ in loop or launches")
            table.append({
                "preset": preset, "rank": res["rank"], "shards": want,
                "schedule": [w, d], "chains": res[f"{tag}_chains"],
                "graph_ms": res[f"{tag}_ms_sweep"],
                "eager_ms": res[f"{e}_ms_sweep"],
                "graph_steady_ms": res[f"{tag}_steady_ms"],
                "eager_steady_ms": res[f"{e}_steady_ms"],
                "graph_fixed_s": res[f"{tag}_fixed_s"],
                "eager_fixed_s": res[f"{e}_fixed_s"],
                "capture_s": res[f"{tag}_capture_s"],
                "groups_sum_calls_sweep": res[
                    f"{tag}_groups_sum_calls_sweep"],
                "peak_graph_gb": res[f"{tag}_peak"][0],
                "peak_eager_gb": res[f"{e}_peak"][0],
                "bitwise": not res[f"{tag}_vs_eager"][0],
                "worst_diff": res[f"{tag}_vs_eager"][1]})
    say("10f table: " + json.dumps({"card": smi, "ranks": table}))
    say(f"10f took {max(res['f_s'] for res, _ in rk):.1f} s on the "
        "slowest rank")


def phase10d(smi: str, rk: list, judged_peak: list) -> None:
    """Phase 10d: each rank's peak memory against the unsharded run's at
    the same preset, schedule and seed (``[peak_mem_gb,
    peak_mem_gb_gather]``, GB): 10b(i), 10c's two routes and
    mala-100k-newton, each at most P10_MEM_RATIO; the sharded runs' ms a
    sweep printed beside."""
    unsharded = {"i": judged_peak, "d": rk[0][0]["d_unsharded_peak"]}
    cases = (("i", f"10b(i) judged, {P10_SCHED[0]}/{P10_SCHED[1]}, chains "
                   "split"),
             ("c_bucket", f"10c ragged-10k bucket, {P10C_SCHED[0]}/"
                          f"{P10C_SCHED[1]}, groups split"),
             ("c_segment", f"10c ragged-10k-mala segment, {P10C_SCHED[0]}/"
                           f"{P10C_SCHED[1]}, groups split"),
             ("d", f"10d mala-100k-newton, {P10D_SCHED[0]}/{P10D_SCHED[1]}"
                   ", groups split"))
    for tag, what in cases:
        for res, _ in rk:
            ref = unsharded.get(tag) or res[f"{tag}_unsharded_peak"]
            got = res[f"{tag}_peak"]
            ratio = got[0] / ref[0]
            say(f"{what} rank {res['rank']}: peak_mem_gb {got[0]:.4f} "
                f"(through the gathers {got[1]:.4f}) against the unsharded "
                f"run's {ref[0]:.4f} ({ref[1]:.4f}): {ratio:.3f}x (<= "
                f"{P10_MEM_RATIO}); {res[f'{tag}_ms_sweep']:.2f} ms a sweep "
                f"on '{smi}'")
            if not ratio <= P10_MEM_RATIO:
                fail(f"{what} rank {res['rank']}: peak memory {ratio:.3f}x "
                     "the unsharded run's")
    # no rank gathers the final carry: each rank's peak through the
    # gathers (the draws) within P10_GATHER_RATIO of its peak without
    for res, _ in rk:
        g = res["d_peak"][1] / res["d_peak"][0]
        say(f"10d rank {res['rank']}: peak_mem_gb_gather "
            f"{res['d_peak'][1]:.4f} against peak_mem_gb "
            f"{res['d_peak'][0]:.4f}: {g:.4f}x (<= {P10_GATHER_RATIO}); "
            f"shards {res['d_sharding']} (the preset at {len(rk)} ranks) "
            f"on '{smi}'")
        if not g <= P10_GATHER_RATIO:
            fail(f"10d rank {res['rank']}: the gathers take the peak to "
                 f"{g:.4f}x")
        if res["d_sharding"] != [len(rk) // 2, 2]:
            fail(f"10d: mala-100k-newton at {len(rk)} ranks sharded "
                 f"{res['d_sharding']}, not [{len(rk) // 2}, 2]")
    for res, _ in rk:
        la = res["d_launches"]
        for k in ("newton_step_refresh", "newton_step_frozen",
                  "logp_grad_hess", "logp_grad"):
            if not la.get(k):
                fail(f"10d rank {res['rank']}: {k} launched no time ({la})")
        if not res["d_finite"]:
            fail("10d: NaN or inf in the group-sharded mala-100k-newton run")
        say(f"10d rank {res['rank']}: mala-100k-newton block {res['d_s']:.1f}"
            f" s (set-up {res['d_setup_s']:.1f} s; unsharded "
            f"{rk[0][0]['d_unsharded_ms_sweep']:.2f} ms a sweep on rank 0)")


def phase10c(dev, smi: str, rk: list, ranks: int, shared: bool) -> dict:
    """Phase 10c, this process's part: (1) config 4's bucket-route passes
    and steps (Philox mode) and its segment passes on each half of the
    groups, at the shard's bucket offsets and layout, against the global
    call; (2) the ranks' group-sharded runs of P10C_ROUTES against the
    unsharded run from the same seed; (3) the cost model counted on the
    card and on the CPU. Returns the ranks' launches (the kernels line)."""
    import numpy as np
    import torch

    from nestmc_torch.ops import bucket
    from nestmc_torch.ops.cuda.loglik_segment import (
        logistic_logp_grad_segment,
        logistic_loglik_segment,
    )
    from nestmc_torch.ops.segment import SegmentLayout
    from nestmc_torch.presets import get_preset
    from nestmc_torch.rng import SweepRNG
    from nestmc_torch.utils.profiling import count_sweep, sweep_cost

    # (1) each kernel of the ragged paths on a shard, against the global
    # call: the bucket steps bitwise (the same Philox cells), the same
    # Philox keys drawn, the segment passes within their contract
    _, rd, _ = get_preset("ragged-10k", device=dev)
    C, G, p = 1024, rd.num_groups, rd.num_covariates
    lay = bucket.BucketLayout.build(rd.segment_ids, G, x=rd.x, y=rd.y)
    offs = rd.offsets.cpu().numpy()
    halves = ((0, G // 2), (G // 2, G))
    g = torch.Generator().manual_seed(10)
    T = p * (p + 1) // 2
    h = torch.zeros(C, G, T)
    for i in range(p):
        h[..., i * (i + 1) // 2 + i] = 2.0 + torch.rand(C, G, generator=g)
    a = {k: v.to(dev) for k, v in dict(
        beta=0.3 * torch.randn(C, G, p, generator=g),
        v=-torch.rand(C, G, generator=g),
        g=0.3 * torch.randn(C, G, p, generator=g), h=h,
        ls=0.3 * torch.randn(C, G, generator=g) - 1.0,
        mu=0.3 * torch.randn(C, p, generator=g),
        lt=0.3 * torch.randn(C, p, generator=g) - 0.5).items()}

    def cut(k, cols):
        return a[k][:, cols] if k in ("beta", "v", "g", "h", "ls") else a[k]

    def bcall(kind):
        def call(L, cols, rng):
            t = {k: cut(k, cols) for k in a}
            if kind == "loglik":
                return (bucket.bucketed_logistic_loglik(t["beta"], L),)
            if kind == "logp_grad":
                return bucket.bucketed_logistic_logp_grad(t["beta"], L)
            if kind == "logp_grad_hess":
                return bucket.bucketed_logistic_logp_grad_hess(t["beta"], L)
            if kind == "mala_step":
                return bucket.bucketed_fused_mala_step(
                    t["beta"], t["v"], t["g"], t["ls"], t["mu"], t["lt"], L,
                    rng=rng)
            return bucket.bucketed_fused_newton_step(
                t["beta"], t["v"], t["g"], t["h"], t["ls"], t["mu"],
                t["lt"], L, rng=rng, frozen=kind == "newton_step_frozen")
        return call

    shard_lays = [lay.shard(g0, g1, int(offs[g0])) for g0, g1 in halves]
    for kind in ("loglik", "logp_grad", "logp_grad_hess", "mala_step",
                 "newton_step_refresh", "newton_step_frozen"):
        call = bcall(kind)
        rng = SweepRNG(5, dev)
        full = call(lay, slice(None), rng)
        for (g0, g1), L in zip(halves, shard_lays):
            srng = SweepRNG(5, dev)
            part = call(L, slice(g0, g1), srng)
            bad = [i for i, (f, q) in enumerate(zip(full, part))
                   if not torch.equal(f[:, g0:g1], q)]
            keys = torch.equal(srng.host.get_state(), rng.host.get_state())
            say(f"10c {kind} per bucket on groups {g0}..{g1} of config 4 "
                f"(C={C}, buckets cap/groups/units "
                f"{[(b.cap, b.size, b.units) for b in L.buckets]}): "
                f"{'bitwise the global call' if not bad else 'DIFFERS'}; "
                f"Philox keys as the global call's: {keys}")
            if bad or not keys:
                fail(f"10c: {kind} on a shard's buckets differs from the "
                     f"global call (outputs {bad}, keys {keys})")
    for (g0, g1) in halves:
        loc = rd.subset_groups(g0, g1)
        slay = SegmentLayout.build(loc.segment_ids, loc.num_groups)
        glay = SegmentLayout.build(rd.segment_ids, G)
        beta = a["beta"][:, g0:g1].contiguous()
        pairs = [("seg_loglik", (logistic_loglik_segment(
                      a["beta"], rd.x, rd.y, glay),),
                  (logistic_loglik_segment(beta, loc.x, loc.y, slay),),
                  (2e-5,)),
                 ("seg_logp_grad", logistic_logp_grad_segment(
                     a["beta"], rd.x, rd.y, glay),
                  logistic_logp_grad_segment(beta, loc.x, loc.y, slay),
                  (2e-5, 2e-4))]
        for name, full, part, rtols in pairs:
            err = max(float(((q - f[:, g0:g1]).abs()
                             / (2e-5 + rt * f[:, g0:g1].abs())).max())
                      for f, q, rt in zip(full, part, rtols))
            say(f"10c {name} on groups {g0}..{g1}'s own layout "
                f"({loc.num_obs} obs): |a-b| / (2e-5 + rtol |b|) "
                f"{err:.3f} (<= 1) against the global call")
            if not err <= 1.0:
                fail(f"10c: {name} on a shard's layout off by {err}")
    del a, h, lay, shard_lays, rd
    torch.cuda.empty_cache()

    # (2) the ranks' group-sharded runs against their unsharded runs
    launches = {}
    W, D = P10C_SCHED
    for route, preset, impl in P10C_ROUTES:
        tag = f"c_{route}"
        for res, _ in rk:
            la = res[f"{tag}_launches"]
            if route == "bucket":
                B = sum(1 for _, size, _ in res[f"{tag}_buckets"] if size)
                want = {"newton_step_refresh": B * W,
                        "newton_step_frozen": B * D,
                        "logp_grad_hess": B * (W + 1), "logp_grad": B * D}
            else:
                want = {"seg_logp_grad": 1 + 2 * (W + D),
                        "philox_fill": 2 * (W + D)}
            want |= {k: f(W, D) for k, f in ASIS.items()}
            want = {k: want.get(k, 0) for k in la}
            if la != want:
                fail(f"10c {route} rank {res['rank']}: launches {la} != "
                     f"{want}")
            for k, n in la.items():
                launches[k] = launches.get(k, 0) + n
            spans = res[f"{tag}_spans"]
            C10C = res[f"{tag}_chains"]
            say(f"10c {route} rank {res['rank']} ({preset}, {impl} route, "
                f"groups {spans['groups']}, obs rows {spans['obs']}"
                + (f", buckets cap/groups/units {res[f'{tag}_buckets']}"
                   if route == "bucket" else "")
                + f"; {W}/{D} at {C10C} chains): '{res[f'{tag}_sweep']}' "
                f"{res[f'{tag}_ms_sweep']:.2f} ms a sweep (unsharded in the "
                f"same process {res[f'{tag}_unsharded_ms_sweep']:.2f}), "
                f"groups_sum {res[f'{tag}_groups_sum_calls_sweep']:.1f} "
                f"calls a sweep (timed in an eager {P10T_SCHED[0]}/"
                f"{P10T_SCHED[1]} run: "
                f"{res[f'{tag}_timed_groups_sum_calls_sweep']:.1f} calls, "
                f"{res[f'{tag}_timed_groups_sum_ms_sweep']:.3f} ms a sweep)"
                f", gather {res[f'{tag}_gather_s']:.3f} s; launches "
                f"{ {k: n for k, n in la.items() if n} }; against the "
                f"unsharded run from the same seed: the chains' final mu "
                f"and log_tau means within {res[f'{tag}_mean_z']:.2f} "
                f"(<= 5) combined standard errors, acceptance within "
                f"{res[f'{tag}_accept_diff']:.4f} (< 0.01), generators "
                f"equal: {res[f'{tag}_same_rng']}; chains whose final mu "
                f"and log_tau are within 1e-4 (|a-b|/(1+|b|)): "
                f"{res[f'{tag}_close_chains']} of {C10C} (printed: a "
                f"flipped accept decision moves a chain on its own; worst "
                f"leaf {res[f'{tag}_run_err']:.2e}); one sweep from the "
                f"unsharded final carry: {res[f'{tag}_sweep_close_chains']}"
                f" of {C10C} chains with every position leaf within 1e-4 "
                f"(>= {C10C - C10C // 100}); on '{smi}'"
                + ("; the ranks time-share one card" if shared else ""))
            want_loop = "eager" if shared else "graph"
            if res[f"{tag}_sweep"] != want_loop:
                fail(f"10c {route} rank {res['rank']}: the group-sharded "
                     f"run recorded {res[f'{tag}_sweep']!r}, not "
                     f"{want_loop!r} over {res['backend']}")
            if not res[f"{tag}_mean_z"] <= 5.0:
                fail(f"10c {route}: the group-sharded run's chain means are "
                     f"{res[f'{tag}_mean_z']} standard errors off the "
                     "unsharded run's")
            if not res[f"{tag}_accept_diff"] < 0.01:
                fail(f"10c {route}: acceptance off the unsharded run's by "
                     f"{res[f'{tag}_accept_diff']}")
            if not res[f"{tag}_sweep_close_chains"] >= C10C - C10C // 100:
                fail(f"10c {route}: the group-sharded sweep differs from "
                     f"the unsharded one on more than 1% of the chains")
            if not res[f"{tag}_same_rng"]:
                fail(f"10c {route}: rank {res['rank']}'s generators differ "
                     "from the unsharded run's")
            if not res[f"{tag}_finite"]:
                fail(f"10c {route}: NaN or inf in the group-sharded run")
        same = all(np.array_equal(rk[r][1][k], rk[r + 1][1][k])
                   for r in range(0, ranks, 2) for k in rk[r][1]
                   if k.startswith(f"c.{route}.final."))
        say(f"10c {route}: mu and log_tau bitwise equal on each chain "
            f"shard's two group shards (final carry and the one sweep): "
            f"{same}")
        if not same:
            fail(f"10c {route}: replicated blocks differ between the ranks")

    # (3) the cost model: the same counts on the card and on the CPU
    for preset, chains in (("hier-logistic-100", None), ("ragged-10k", 8)):
        counts = []                                 # the card's, the CPU's
        for where in (dev, torch.device("cpu")):
            m, d, cfg = get_preset(preset, device=where)
            c = count_sweep(m, d, cfg, chains=chains)
            counts.append({k: c[k] for k in (
                "kernel_flops", "kernel_bytes", "plain_flops",
                "plain_bytes")})
            del m, d
        say(f"10c the cost model's count of one {preset} sweep (chains: "
            f"{chains or 'the preset'}'s): card {counts[0]}, CPU "
            f"{counts[1]}: "
            f"{'equal' if counts[0] == counts[1] else 'DIFFER'}")
        if counts[0] != counts[1]:
            fail(f"10c: {preset}'s counted cost differs between the card "
                 "and the CPU")
    m, d, cfg = get_preset("judged", device=dev)
    t0 = time.perf_counter()
    costs = sweep_cost(m, d, cfg)
    say(f"10c judged: sweep cost analysis: {json.dumps(costs)} (counted in "
        f"{time.perf_counter() - t0:.1f} s; sol at 3.35 TB/s, the H100 "
        f"80GB HBM3's rate at 700 W; card '{smi}')")
    del m, d
    torch.cuda.empty_cache()
    return launches

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: this smoke test needs a GPU",
              file=sys.stderr)
        return 1

    # fails outside a checkout of the repo
    from nestmc_torch import KernelConfig, RunConfig, SamplerConfig, sample
    from nestmc_torch import bench, kernel_ab
    from nestmc_torch.diagnostics import diagnose, ess, fold_rhat_scalars
    from nestmc_torch.models import (
        analytic_hier_normal_posterior,
        make_hier_logistic,
        make_hier_normal_known_scales,
        make_nested_poisson,
        synth_hier_normal,
        synth_logistic,
        synth_poisson3,
    )
    from nestmc_torch.ops import bucket, loglik
    from nestmc_torch.ops.cuda import _build, asis, launch_counts
    from nestmc_torch.ops.cuda import reset_launch_counts
    from nestmc_torch.ops.cuda import loglik_poisson as pois
    from nestmc_torch.ops.cuda import poisson_accept as pacc
    from nestmc_torch.ops.cuda.loglik_logistic import (
        logistic_loglik,
        logistic_logp_grad,
        logistic_logp_grad_hess,
    )
    from nestmc_torch.ops.cuda.mala_accept import (
        fused_mala_logistic_step,
        fused_mala_logistic_step_plain,
    )
    from nestmc_torch.ops.cuda.mh_accept import (
        fused_rwmh_logistic_step,
        fused_rwmh_logistic_step_plain,
    )
    from nestmc_torch.ops.cuda.loglik_segment import (
        logistic_logp_grad_segment,
        logistic_logp_grad_segment_plain,
        logistic_loglik_segment,
        logistic_loglik_segment_plain,
    )
    from nestmc_torch.ops.cuda.newton_accept import (
        fused_newton_logistic_step,
        fused_newton_logistic_step_plain,
        philox_probe,
    )
    from nestmc_torch.ops.cuda.common import SEG_OBS, TILE_KINDS, tile_plan
    from nestmc_torch.ops.segment import SegmentLayout
    from nestmc_torch.presets import get_preset
    from nestmc_torch.rng import SweepRNG
    # each call's bytes and operations, and its bound: the cost model's
    # (utils/profiling.py), so the bound and --cost-analysis agree
    from nestmc_torch.utils.profiling import bound_ms as bound
    from nestmc_torch.utils.profiling import kernel_work as work

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card ----
    smi = bench.gpu_query()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say(f"card: nvidia-smi '{smi}'; torch '{kind}'; "
        f"device_count {count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # ---- 2. build, p=4 and p=3 at once ----
    t0 = time.perf_counter()
    _build.build([4, 3])
    say(f"build: p=4 and p=3 in {time.perf_counter() - t0:.1f} s")
    for p in (4, 3):
        info = _build.build_info.get(p, {})
        say(f"  p={p}: "
            f"{'%.1f s' % info['seconds'] if info else 'cached'} -> "
            f"{_build.library_path(p).name}")
        for ln in info.get("log", "").splitlines():
            if "registers" in ln or "spill" in ln:
                say(f"    ptxas: {ln.strip()}")

    def timed(fn, batches=7, per=10):
        """ms per call: the median over batches of the mean of `per`
        back-to-back calls between two CUDA events, after warm-up (the
        wrapper's host work then overlaps the previous launch)."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(batches):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(per):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / per)
        times.sort()
        return times[len(times) // 2]

    def timed_plain(fn, fn_slice):
        """The plain version's ms at full width, or on the chain slice if
        full width runs out of memory (then said)."""
        try:
            return timed(fn), ""
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            return timed(fn_slice), f" (on {SLICE} chains: full width OOM)"

    def max_err(a, b, rtol):
        """max |a-b| and whether |a-b| <= 1e-3 + rtol |b| everywhere."""
        d = (a - b).abs()
        if d.numel() == 0:
            return 0.0, True
        return float(d.max()), bool((d <= 1e-3 + rtol * b.abs()).all())

    kernels = {}
    launches_total = {}

    def record(name, err, ms=None, plain_ms=None, shape=None, w=None):
        k = kernels.setdefault(name, {"max_abs_err": 0.0})
        k["max_abs_err"] = max(k["max_abs_err"], err)
        if ms is not None:
            b_ms, by = bound(*w)
            k.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                     shape=shape)

    def cell(name, shape, err, ms, pms, w, plain_on, **extra):
        """A timed record of ``name`` at another shape than its main one."""
        record(name, err)
        b_ms, by = bound(*w)
        kernels[name].setdefault("cells", []).append({
            "shape_C_G_n_p": list(shape), "ms": ms, "plain_ms": pms,
            "plain_on": plain_on, "bound_ms": b_ms, "bound_by": by,
            "max_abs_err": err, **extra})

    def bound_str(w):
        b_ms, by = bound(*w)
        return (f"bound {b_ms:.4f} ms by {by} ({w[0] / 1e6:.1f} MB, "
                f"{w[1] / 1e9:.2f} G ops)")

    def step_check(out, ref, beta, logu, alpha_i, tol_alpha=2e-3):
        """(max err, ok, differing decisions, outside the 1e-3 band)."""
        acc_k = (out[0] != beta).any(-1)
        acc_p = (ref[0] != beta).any(-1)
        near = (torch.log(ref[alpha_i]) - logu).abs() < 1e-3
        differ = acc_k != acc_p
        n_bad = int((differ & ~near).sum())
        same = ~differ
        errs = []
        for i in range(len(out)):
            a, b = out[i], ref[i]
            if i <= alpha_i:
                m = same if a.dim() == 2 else same[..., None]
                a, b = a[m.expand_as(a)], b[m.expand_as(b)]
            errs.append(max_err(a, b, tol_alpha if i == alpha_i else 1e-4))
        err = max(e for e, _ in errs)
        return err, all(o for _, o in errs) and n_bad == 0, \
            int(differ.sum()), n_bad

    def inputs(shape, data_seed, seed):
        C_, G_, N_, P_ = shape
        data, _ = synth_logistic(data_seed, G=G_, n=N_, p=P_, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        r = {
            "beta": 0.5 * torch.randn(C_, G_, P_, generator=gen, device=dev),
            "mu": 0.3 * torch.randn(C_, P_, generator=gen, device=dev),
            "lt": -0.7 + 0.2 * torch.randn(C_, P_, generator=gen,
                                           device=dev),
            "eps": torch.randn(C_, G_, P_, generator=gen, device=dev),
            "logu": torch.log(torch.rand(C_, G_, generator=gen, device=dev)
                              .clamp_min(1e-38)),
            "gen": gen,
        }
        masked_m = data.mask.clone()
        masked_m[:, N_ - 7:] = 0.0
        r["datasets"] = {"dense": (data.x, data.y, data.mask),
                         "masked": (data.x, data.y * masked_m, masked_m)}
        return r

    # ---- 3. config 3's Poisson kernels at its shape ----
    C, S, N, P = POIS
    pdata, _ = synth_poisson3(3003, G=S // 4, subjects_per_group=4, n=N,
                              p=P, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    beta = 0.3 * torch.randn(C, S, P, generator=gen, device=dev)
    bgs = beta + 0.15 * torch.randn(C, S, P, generator=gen, device=dev)
    lts = -1.4 + 0.2 * torch.randn(C, P, generator=gen, device=dev)
    eps = torch.randn(C, S, P, generator=gen, device=dev)
    logu = torch.log(torch.rand(C, S, generator=gen, device=dev)
                     .clamp_min(1e-38))
    noise = (eps, logu)
    masked_m = pdata.mask.clone()
    masked_m[:, N - 3:] = 0.0
    pdatasets = {"dense": (pdata.x, pdata.y, pdata.mask),
                 "masked": (pdata.x, pdata.y * masked_m, masked_m)}
    for dname, (x, y, m) in pdatasets.items():
        const = loglik.poisson_const(y, m)
        for name, kern, plain in (
            ("pois_loglik", lambda *a: (pois.poisson_loglik(*a),),
             lambda *a: (loglik.poisson_loglik_padded(*a),)),
            ("pois_logp_grad", pois.poisson_logp_grad,
             loglik.poisson_logp_grad_padded),
            ("pois_logp_grad_hess", pois.poisson_logp_grad_hess,
             loglik.poisson_logp_grad_hess_padded),
        ):
            args = (beta, x, y, m, const)
            out, ref = kern(*args), plain(*args)
            torch.cuda.synchronize()
            errs = [max_err(a, b, 1e-4) for a, b in zip(out, ref)]
            err = max(e for e, _ in errs)
            ok = all(o for _, o in errs)
            ms = timed(lambda: kern(*args))
            pms = timed(lambda: plain(*args))
            w = work(name, C, S, N, P)
            say(f"kernel {name} [{dname}, C={C} S={S} n={N} p={P}]: "
                f"max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|) "
                f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms; {bound_str(w)}")
            if not ok:
                fail(f"{name} [{dname}] disagrees with its plain version")
            record(name, err, ms if dname == "dense" else None, pms, POIS, w)
            del out, ref
        v, g, h = loglik.poisson_logp_grad_hess_padded(beta, x, y, m, const)
        for name, step, plain, args, kw, alpha_i in (
            ("pois_rwmh_step", pacc.fused_rwmh_poisson_step,
             pacc.fused_rwmh_poisson_step_plain,
             (beta, v, torch.full((C, S), -1.2, device=dev), bgs, lts, x, y,
              m), {}, 2),
            ("pois_mala_step", pacc.fused_mala_poisson_step,
             pacc.fused_mala_poisson_step_plain,
             (beta, v, g, torch.full((C, S), -1.0, device=dev), bgs, lts, x,
              y, m), {}, 3),
            ("pois_newton_step_refresh", pacc.fused_newton_poisson_step,
             pacc.fused_newton_poisson_step_plain,
             (beta, v, g, h, torch.zeros(C, S, device=dev), bgs, lts, x, y,
              m), {"frozen": False}, 4),
            ("pois_newton_step_frozen", pacc.fused_newton_poisson_step,
             pacc.fused_newton_poisson_step_plain,
             (beta, v, g, h, torch.zeros(C, S, device=dev), bgs, lts, x, y,
              m), {"frozen": True}, 4),
        ):
            out = step(*args, noise=noise, const=const, **kw)
            ref = plain(*args, noise, const=const, **kw)
            torch.cuda.synchronize()
            if kw.get("frozen"):
                if out[3] is not h:
                    fail("frozen pois_newton_step must return h itself")
                out, ref, alpha_i = out[:3] + out[4:], ref[:3] + ref[4:], 3
            err, ok, n_diff, n_bad = step_check(out, ref, beta, logu,
                                                alpha_i)
            acc = float(ref[alpha_i].mean())
            ms = timed(lambda: step(*args, noise=noise, const=const, **kw))
            pms = timed(lambda: plain(*args, noise, const=const, **kw))
            w = work(name, C, S, N, P)
            say(f"kernel {name} [{dname}, C={C} S={S} n={N} p={P}]: "
                f"max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|, alpha "
                f"2e-3|ref|); mean alpha {acc:.3f}; accept decisions differ "
                f"in {n_diff} of {C * S} cells, {n_bad} outside "
                f"|log a - log u| < 1e-3 {'ok' if ok else 'FAIL'}; kernel "
                f"{ms:.4f} ms, plain {pms:.4f} ms; {bound_str(w)}")
            if not ok:
                fail(f"{name} [{dname}] disagrees with its plain version")
            record(name, err, ms if dname == "dense" else None, pms, POIS, w)
            del out, ref
        del v, g, h
    del pdata, pdatasets, beta, bgs, lts, eps, logu, noise, masked_m
    torch.cuda.empty_cache()

    # ---- 3a. the Newton path's kernels at the judged shape ----
    C, G, N, P = JUDGED
    d = inputs(JUDGED, 2000, 7)
    beta, mu, lt, eps, logu = (d[k] for k in ("beta", "mu", "lt", "eps",
                                              "logu"))
    ls = torch.zeros(C, G, device=dev)
    for name, kern, plain in (
        ("logp_grad", logistic_logp_grad, loglik.logistic_logp_grad_padded),
        ("logp_grad_hess", logistic_logp_grad_hess,
         loglik.logistic_logp_grad_hess_padded),
    ):
        for dname, (x, y, m) in d["datasets"].items():
            out, ref = kern(beta, x, y, m), plain(beta, x, y, m)
            torch.cuda.synchronize()
            errs = [max_err(a, b, 1e-4) for a, b in zip(out, ref)]
            err = max(e for e, _ in errs)
            ok = all(o for _, o in errs)
            ms = timed(lambda: kern(beta, x, y, m))
            pms = timed(lambda: plain(beta, x, y, m))
            w = work(name, C, G, N, P)
            say(f"kernel {name} [{dname}, C={C} G={G} n={N} p={P}]: "
                f"max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|) "
                f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms; {bound_str(w)}")
            if not ok:
                fail(f"{name} [{dname}] disagrees with its plain version")
            main = dname == "dense"
            record(name, err, ms if main else None, pms, JUDGED, w)

    for frozen in (False, True):
        for fold in (False, True):
            for dname, (x, y, m) in d["datasets"].items():
                v, g, h = loglik.logistic_logp_grad_hess_padded(beta, x, y, m)
                rf = None
                if fold:
                    rf = (torch.randn(2, G, P, C, generator=d["gen"],
                                      device=dev),
                          torch.rand(2, G, P, C, generator=d["gen"],
                                     device=dev),
                          fold_rhat_scalars([11.0, 0.0], 11, 2048).to(dev))
                args = (beta, v, g, h, ls, mu, lt, x, y, m)
                out = fused_newton_logistic_step(
                    *args, noise=(eps, logu), frozen=frozen, rhat_fold=rf)
                ref = fused_newton_logistic_step_plain(
                    *args, (eps, logu), frozen=frozen, rhat_fold=rf)
                torch.cuda.synchronize()
                if frozen and out[3] is not h:
                    fail("frozen newton_step must return h itself")
                keep = [i for i in range(len(out)) if not (frozen and i == 3)]
                err, ok, n_diff, n_bad = step_check(
                    [out[i] for i in keep], [ref[i] for i in keep], beta,
                    logu, keep.index(4))
                ms = timed(lambda: fused_newton_logistic_step(
                    *args, noise=(eps, logu), frozen=frozen, rhat_fold=rf))
                pms = timed(lambda: fused_newton_logistic_step_plain(
                    *args, (eps, logu), frozen=frozen, rhat_fold=rf))
                kname = ("newton_step_frozen" if frozen
                         else "newton_step_refresh")
                w = work(kname, C, G, N, P, fold=fold)
                case = (f"{'frozen' if frozen else 'refresh'}"
                        f"{'+fold' if fold else ''} [{dname}]")
                say(f"kernel newton_step {case}: max_abs_err {err:.3e} "
                    f"(tol 1e-3 + 1e-4|ref|, alpha 2e-3|ref|); accept "
                    f"decisions differ in {n_diff} cells, {n_bad} outside "
                    f"|log a - log u| < 1e-3 {'ok' if ok else 'FAIL'}; "
                    f"kernel {ms:.4f} ms, plain {pms:.4f} ms; "
                    f"{bound_str(w)}")
                if not ok:
                    fail(f"newton_step {case} disagrees with its plain "
                         "version")
                # the main path's cases: refresh without fold (warmup) and
                # frozen with fold (sampling), on the dense judged data
                main = dname == "dense" and fold == frozen
                record(kname, err, ms if main else None, pms, JUDGED, w)
                del out, ref
    del d, beta, mu, lt, eps, logu, ls, v, g, h, rf, args
    torch.cuda.empty_cache()

    # ---- 3b. the MALA path's kernels at the mala-100k shape ----
    C, G, N, P = M100K
    S = SLICE
    d = inputs(M100K, 5000, 8)
    beta, mu, lt, eps, logu = (d[k] for k in ("beta", "mu", "lt", "eps",
                                              "logu"))
    ls = torch.full((C, G), -1.3, device=dev)
    sl = (beta[:S], mu[:S], lt[:S], eps[:S], logu[:S], ls[:S])
    for dname, (x, y, m) in d["datasets"].items():
        out = logistic_logp_grad(beta, x, y, m)
        ref = loglik.logistic_logp_grad_padded(beta[:S], x, y, m)
        torch.cuda.synchronize()
        errs = [max_err(a[:S], b, 1e-4) for a, b in zip(out, ref)]
        err = max(e for e, _ in errs)
        ok = all(o for _, o in errs)
        ms = timed(lambda: logistic_logp_grad(beta, x, y, m))
        pms, note = timed_plain(
            lambda: loglik.logistic_logp_grad_padded(beta, x, y, m),
            lambda: loglik.logistic_logp_grad_padded(beta[:S], x, y, m))
        say(f"kernel logp_grad [{dname}, C={C} G={G} n={N} p={P}, parity on "
            f"{S} chains]: max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|) "
            f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms{note}; {bound_str(work('logp_grad', *M100K))}")
        if not ok:
            fail(f"logp_grad [{dname}] at the mala-100k shape disagrees")
        record("logp_grad", err)
        del out, ref
        v, g = logistic_logp_grad(beta, x, y, m)
        for fold in (False, True):
            rf = rf_s = None
            if fold:
                fmean = torch.randn(2, G, P, C, generator=d["gen"],
                                    device=dev)
                fm2 = torch.rand(2, G, P, C, generator=d["gen"], device=dev)
                sc = fold_rhat_scalars([11.0, 0.0], 11, 512).to(dev)
                rf, rf_s = (fmean, fm2, sc), (fmean[..., :S], fm2[..., :S],
                                              sc)
            args = (beta, v, g, ls, mu, lt, x, y, m)
            out = fused_mala_logistic_step(*args, noise=(eps, logu),
                                           rhat_fold=rf)
            ref = fused_mala_logistic_step_plain(
                sl[0], v[:S], g[:S], sl[5], sl[1], sl[2], x, y, m,
                (sl[3], sl[4]), rhat_fold=rf_s)
            torch.cuda.synchronize()
            out_s = [o[:S] for o in out[:4]] + [o[..., :S] for o in out[4:]]
            err, ok, n_diff, n_bad = step_check(out_s, ref, sl[0], sl[4], 3)
            ms = timed(lambda: fused_mala_logistic_step(
                *args, noise=(eps, logu), rhat_fold=rf))
            pms, note = timed_plain(
                lambda: fused_mala_logistic_step_plain(
                    *args, (eps, logu), rhat_fold=rf),
                lambda: fused_mala_logistic_step_plain(
                    sl[0], v[:S], g[:S], sl[5], sl[1], sl[2], x, y, m,
                    (sl[3], sl[4]), rhat_fold=rf_s))
            w = work("mala_step", C, G, N, P, fold=fold)
            case = f"{'fold' if fold else 'no fold'} [{dname}]"
            say(f"kernel mala_step {case}, C={C} G={G} n={N} p={P}, parity "
                f"on {S} chains: max_abs_err {err:.3e} (tol 1e-3 + "
                f"1e-4|ref|, alpha 2e-3|ref|); accept decisions differ in "
                f"{n_diff} of {S * G} cells, {n_bad} outside |log a - log u|"
                f" < 1e-3 {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms "
                f"(external noise), plain {pms:.4f} ms{note}; {bound_str(w)}")
            if not ok:
                fail(f"mala_step {case} disagrees with its plain version")
            # the main path's case: no fold (thin 4), dense data, Philox
            # noise drawn in the kernel: its record times that mode
            main = dname == "dense" and not fold
            record("mala_step", err)
            if main:
                key = DeviceKey(8, dev)
                ms_px = timed(lambda: fused_mala_logistic_step(*args,
                                                               rng=key))
                w_px = work("mala_step", C, G, N, P, noise=False)
                say(f"kernel mala_step [main path's mode: Philox noise, no "
                    f"fold, {dname}, C={C} G={G} n={N} p={P}]: kernel "
                    f"{ms_px:.4f} ms (external noise {ms:.4f} ms); "
                    f"{bound_str(w_px)}")
                record("mala_step", err, ms_px, pms, M100K, w_px)
                kernels["mala_step"]["ms_external_noise"] = ms
            del out, ref, out_s, rf, rf_s
            torch.cuda.empty_cache()
        del v, g

    # rwmh_step and loglik at the mala-100k shape, then at the RW preset's
    for shape in (M100K, RW):
        C, G, N, P = shape
        S = min(SLICE, C)
        if shape == RW:
            del d, beta, mu, lt, eps, logu, ls, sl
            torch.cuda.empty_cache()
            d = inputs(RW, 1000, 9)
            beta, mu, lt, eps, logu = (d[k] for k in ("beta", "mu", "lt",
                                                      "eps", "logu"))
        ls = torch.full((C, G), -1.6, device=dev)
        sl = (beta[:S], mu[:S], lt[:S], eps[:S], logu[:S], ls[:S])
        main = shape == RW
        for dname, (x, y, m) in d["datasets"].items():
            out = logistic_loglik(beta, x, y, m)
            ref = loglik.logistic_loglik_padded(sl[0], x, y, m)
            torch.cuda.synchronize()
            err, ok = max_err(out[:S], ref, 1e-4)
            ms = timed(lambda: logistic_loglik(beta, x, y, m))
            pms, note = timed_plain(
                lambda: loglik.logistic_loglik_padded(beta, x, y, m),
                lambda: loglik.logistic_loglik_padded(sl[0], x, y, m))
            w = work("loglik", C, G, N, P)
            say(f"kernel loglik [{dname}, C={C} G={G} n={N} p={P}, parity on "
                f"{S} chains]: max_abs_err {err:.3e} (tol 1e-3 + "
                f"1e-4|ref|) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
                f"plain {pms:.4f} ms{note}; {bound_str(w)}")
            if not ok:
                fail(f"loglik [{dname}] disagrees with its plain version")
            record("loglik", err, ms if main and dname == "dense" else None,
                   pms, shape, w)
            lik = out
            args = (beta, lik, ls, mu, lt, x, y, m)
            out = fused_rwmh_logistic_step(*args, noise=(eps, logu))
            ref = fused_rwmh_logistic_step_plain(
                sl[0], lik[:S], sl[5], sl[1], sl[2], x, y, m, (sl[3], sl[4]))
            torch.cuda.synchronize()
            err, ok, n_diff, n_bad = step_check(
                [o[:S] for o in out], ref, sl[0], sl[4], 2)
            ms = timed(lambda: fused_rwmh_logistic_step(
                *args, noise=(eps, logu)))
            pms, note = timed_plain(
                lambda: fused_rwmh_logistic_step_plain(*args, (eps, logu)),
                lambda: fused_rwmh_logistic_step_plain(
                    sl[0], lik[:S], sl[5], sl[1], sl[2], x, y, m,
                    (sl[3], sl[4])))
            w = work("rwmh_step", C, G, N, P)
            say(f"kernel rwmh_step [{dname}, C={C} G={G} n={N} p={P}, parity "
                f"on {S} chains]: max_abs_err {err:.3e} (tol 1e-3 + "
                f"1e-4|ref|, alpha 2e-3|ref|); accept decisions differ in "
                f"{n_diff} of {S * G} cells, {n_bad} outside |log a - log u|"
                f" < 1e-3 {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
                f"plain {pms:.4f} ms{note}; {bound_str(w)}")
            if not ok:
                fail(f"rwmh_step [{dname}] disagrees with its plain version")
            record("rwmh_step", err, ms if main and dname == "dense" else None,
                   pms, shape, w)
            del out, ref, lik, args
    del d, beta, mu, lt, eps, logu, ls, sl
    torch.cuda.empty_cache()

    # ---- 3c. config 4: the segment kernels and the bucketed route ----
    _, rdata, _ = get_preset("ragged-10k", device=dev)     # seed 0's data
    C, G, P = 1024, rdata.num_groups, rdata.num_covariates
    NOBS = rdata.num_obs
    sizes = rdata.sizes()
    seg_layout = SegmentLayout.build(rdata.segment_ids, G)
    blayout = bucket.BucketLayout.build(rdata.segment_ids, G, x=rdata.x,
                                        y=rdata.y)
    B = len(blayout.buckets)
    say(f"config 4 data: G={G} N={NOBS} p={P}, group sizes "
        f"{int(sizes.min())}..{int(sizes.max())}; {B} size buckets (cap, "
        f"groups) {[(b.cap, len(b.obs_index)) for b in blayout.buckets]}, "
        f"{blayout.padded_obs()} padded obs")
    gen = torch.Generator(device=dev).manual_seed(10)
    beta = 0.5 * torch.randn(C, G, P, generator=gen, device=dev)

    def seg_err(out, ref, rtols):
        """max |a-b| and whether |a-b| <= 2e-5 + rtol |b| everywhere."""
        errs = [((a - b).abs(), rtol * b.abs()) for a, b, rtol
                in zip(out, ref, rtols)]
        return (max(float(d.max()) for d, _ in errs),
                all(bool((d <= 2e-5 + r).all()) for d, r in errs))

    small_sizes = torch.tensor([0, 5, 12, 700, 0, 257, 256, 1] * 4 + [0, 3])
    gs = torch.Generator().manual_seed(11)
    s_seg = torch.repeat_interleave(torch.arange(small_sizes.numel()),
                                    small_sizes)
    small = (0.7 * torch.randn(130, small_sizes.numel(), P,
                               generator=gs).to(dev),
             torch.randn(s_seg.numel(), P, generator=gs).to(dev),
             (torch.rand(s_seg.numel(), generator=gs) < 0.5).float().to(dev),
             SegmentLayout.build(s_seg, small_sizes.numel(), device=dev))
    for name, kern, plain, rtols in (
        ("seg_loglik", lambda *a: (logistic_loglik_segment(*a),),
         lambda *a: (logistic_loglik_segment_plain(*a),), (2e-5,)),
        ("seg_logp_grad", logistic_logp_grad_segment,
         logistic_logp_grad_segment_plain, (2e-5, 2e-4)),
    ):
        out, ref = kern(*small), plain(*small)
        torch.cuda.synchronize()
        err, ok = seg_err(out, ref, rtols)
        empty = (small_sizes == 0).to(dev)
        ok &= bool((out[0][:, empty] == 0).all())
        say(f"kernel {name} [small: C=130, G={small_sizes.numel()}, empty "
            f"groups and groups of 256-700 obs]: max_abs_err {err:.3e} "
            f"(tol 2e-5 + {rtols[-1]:g}|ref|, empty groups exactly 0) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} [small] disagrees with its plain version")
        record(name, err)
        args = (beta, rdata.x, rdata.y, seg_layout)
        out, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err, ok = seg_err(out, ref, rtols)
        ms = timed(lambda: kern(*args))
        pms = timed(lambda: plain(*args))
        w = work(name, C, G, NOBS, P)
        say(f"kernel {name} [config 4, C={C} G={G} N={NOBS} p={P}]: "
            f"max_abs_err {err:.3e} (tol 2e-5 + {rtols[-1]:g}|ref|) "
            f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms; {bound_str(w)}")
        if not ok:
            fail(f"{name} at config 4's shape disagrees with its plain "
                 "version")
        record(name, err, ms, pms, (C, G, NOBS, P), w)
        del out, ref
    del small
    torch.cuda.empty_cache()

    # the bucketed route's kernels at the widest bucket's shape
    wb = blayout.buckets[-1]
    Gb, cap = len(wb.obs_index), wb.cap
    x, y, m = wb.x, wb.y, wb.mask
    bb = beta.index_select(1, wb.group_index)
    gb = torch.Generator(device=dev).manual_seed(12)
    mu = 0.3 * torch.randn(C, P, generator=gb, device=dev)
    lt = -0.7 + 0.2 * torch.randn(C, P, generator=gb, device=dev)
    eps = torch.randn(C, Gb, P, generator=gb, device=dev)
    logu = torch.log(torch.rand(C, Gb, generator=gb, device=dev)
                     .clamp_min(1e-38))
    shape = f"C={C} Gb={Gb} cap={cap} p={P}, widest bucket"
    for name, kern, plain in (
        ("logp_grad", logistic_logp_grad, loglik.logistic_logp_grad_padded),
        ("logp_grad_hess", logistic_logp_grad_hess,
         loglik.logistic_logp_grad_hess_padded),
    ):
        out, ref = kern(bb, x, y, m), plain(bb, x, y, m)
        torch.cuda.synchronize()
        errs = [max_err(a, b, 1e-4) for a, b in zip(out, ref)]
        err, ok = max(e for e, _ in errs), all(o for _, o in errs)
        ms = timed(lambda: kern(bb, x, y, m))
        pms = timed(lambda: plain(bb, x, y, m))
        say(f"kernel {name} [{shape}]: max_abs_err {err:.3e} (tol 1e-3 + "
            f"1e-4|ref|) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms; {bound_str(work(name, C, Gb, cap, P))}")
        if not ok:
            fail(f"{name} at the widest bucket disagrees")
        record(name, err)
    v, g, h = loglik.logistic_logp_grad_hess_padded(bb, x, y, m)
    for kname, step, plain, args, kw, alpha_i in (
        ("newton_step_refresh", fused_newton_logistic_step,
         fused_newton_logistic_step_plain,
         (bb, v, g, h, torch.zeros(C, Gb, device=dev), mu, lt, x, y, m),
         {"frozen": False}, 4),
        ("newton_step_frozen", fused_newton_logistic_step,
         fused_newton_logistic_step_plain,
         (bb, v, g, h, torch.zeros(C, Gb, device=dev), mu, lt, x, y, m),
         {"frozen": True}, 4),
        ("mala_step", fused_mala_logistic_step,
         fused_mala_logistic_step_plain,
         (bb, v, g, torch.full((C, Gb), -1.3, device=dev), mu, lt, x, y, m),
         {}, 3),
    ):
        out = step(*args, noise=(eps, logu), **kw)
        ref = plain(*args, (eps, logu), **kw)
        torch.cuda.synchronize()
        if kw.get("frozen"):
            if out[3] is not h:
                fail("frozen newton_step must return h itself")
            out, ref, alpha_i = out[:3] + out[4:], ref[:3] + ref[4:], 3
        err, ok, n_diff, n_bad = step_check(out, ref, bb, logu, alpha_i)
        ms = timed(lambda: step(*args, noise=(eps, logu), **kw))
        pms = timed(lambda: plain(*args, (eps, logu), **kw))
        say(f"kernel {kname} [{shape}]: max_abs_err {err:.3e} (tol 1e-3 + "
            f"1e-4|ref|, alpha 2e-3|ref|); mean alpha "
            f"{float(ref[alpha_i].mean()):.3f}; accept decisions differ in "
            f"{n_diff} of {C * Gb} cells, {n_bad} outside |log a - log u| "
            f"< 1e-3 {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms; {bound_str(work(kname, C, Gb, cap, P))}")
        if not ok:
            fail(f"{kname} at the widest bucket disagrees with its plain "
                 "version")
        record(kname, err)
        del out, ref
    del beta, bb, x, y, m, v, g, h, mu, lt, eps, logu, blayout, seg_layout
    torch.cuda.empty_cache()

    # ---- 3d. the tiled templates at partial tiles and odd sizes ----
    # (C, G, n): one chain, units below a tile, ragged tiles on both axes,
    # one observation; n = 3000 gives one unit a tile (its rows all masked
    # but every 100th, so the float32 sums stay within the tolerance)
    for P in (3, 4):
        for C, G, N in ((1, 1, 1), (33, 31, 13), (130, 33, 50), (1, 70, 13),
                        (33, 70, 1), (130, 1, 50), (33, 3, 3000)):
            ge = torch.Generator(device=dev).manual_seed(13 + C + G + N)
            x = torch.randn(G, N, P, generator=ge, device=dev)
            x[:, :, 0] = 1.0
            m = torch.ones(G, N, device=dev)
            m[0, max(N - 4, 0):] = 0.0
            if N == 3000:
                m.zero_()
                m[:, ::100] = 1.0
            y = (torch.rand(G, N, generator=ge, device=dev) < 0.5).float() * m
            ypo = torch.poisson(torch.full((G, N), 1.5, device=dev),
                                generator=ge) * m
            const = loglik.poisson_const(ypo, m)
            beta = 0.5 * torch.randn(C, G, P, generator=ge, device=dev)
            bpo = 0.3 * torch.randn(C, G, P, generator=ge, device=dev)
            mu = 0.3 * torch.randn(C, P, generator=ge, device=dev)
            lt = -0.5 + 0.2 * torch.randn(C, P, generator=ge, device=dev)
            eps = torch.randn(C, G, P, generator=ge, device=dev)
            logu = torch.log(torch.rand(C, G, generator=ge, device=dev)
                             .clamp_min(1e-38))
            rf = (torch.randn(2, G, P, C, generator=ge, device=dev),
                  torch.rand(2, G, P, C, generator=ge, device=dev),
                  fold_rhat_scalars([3.0, 0.0], 3, 5).to(dev))
            errs = {}
            for name, kern, plain, a in (
                ("logp_grad", logistic_logp_grad,
                 loglik.logistic_logp_grad_padded, (beta, x, y, m)),
                ("logp_grad_hess", logistic_logp_grad_hess,
                 loglik.logistic_logp_grad_hess_padded, (beta, x, y, m)),
                ("pois_logp_grad", pois.poisson_logp_grad,
                 loglik.poisson_logp_grad_padded, (bpo, x, ypo, m, const)),
                ("pois_logp_grad_hess", pois.poisson_logp_grad_hess,
                 loglik.poisson_logp_grad_hess_padded,
                 (bpo, x, ypo, m, const)),
            ):
                out, ref = kern(*a), plain(*a)
                torch.cuda.synchronize()
                es = [max_err(o, f, 1e-4) for o, f in zip(out, ref)]
                errs[name] = (max(e for e, _ in es), all(o for _, o in es))
            v, g = loglik.logistic_logp_grad_padded(beta, x, y, m)
            ls = torch.full((C, G), -1.3, device=dev)
            for fold in (None, rf):
                args = (beta, v, g, ls, mu, lt, x, y, m)
                out = fused_mala_logistic_step(*args, noise=(eps, logu),
                                               rhat_fold=fold)
                ref = fused_mala_logistic_step_plain(*args, (eps, logu),
                                                     rhat_fold=fold)
                torch.cuda.synchronize()
                e, o, _, _ = step_check(out, ref, beta, logu, 3)
                prev = errs.get("mala_step", (0.0, True))
                errs["mala_step"] = (max(prev[0], e), prev[1] and o)
            vp, gp = loglik.poisson_logp_grad_padded(bpo, x, ypo, m, const)
            args = (bpo, vp, gp, ls, bpo + 0.1, lt - 0.7, x, ypo, m)
            out = pacc.fused_mala_poisson_step(*args, noise=(eps, logu),
                                               const=const)
            ref = pacc.fused_mala_poisson_step_plain(*args, (eps, logu),
                                                     const=const)
            torch.cuda.synchronize()
            e, o, _, _ = step_check(out, ref, bpo, logu, 3)
            errs["pois_mala_step"] = (e, o)
            # the Newton steps: Logit refresh and frozen, without and with
            # the fold; Poisson refresh and frozen
            lz = torch.zeros(C, G, device=dev)
            hs = (loglik.logistic_logp_grad_hess_padded(beta, x, y, m),
                  loglik.poisson_logp_grad_hess_padded(bpo, x, ypo, m, const))
            for frozen in (False, True):
                kname = ("newton_step_frozen" if frozen
                         else "newton_step_refresh")
                for fold in (None, rf):
                    args = (beta, *hs[0], lz, mu, lt, x, y, m)
                    out = fused_newton_logistic_step(
                        *args, noise=(eps, logu), frozen=frozen,
                        rhat_fold=fold)
                    ref = fused_newton_logistic_step_plain(
                        *args, (eps, logu), frozen=frozen, rhat_fold=fold)
                    torch.cuda.synchronize()
                    if frozen and out[3] is not hs[0][2]:
                        fail("frozen newton_step must return h itself")
                    keep = [i for i in range(len(out))
                            if not (frozen and i == 3)]
                    e, o, _, _ = step_check(
                        [out[i] for i in keep], [ref[i] for i in keep], beta,
                        logu, keep.index(4))
                    prev = errs.get(kname, (0.0, True))
                    errs[kname] = (max(prev[0], e), prev[1] and o)
                args = (bpo, *hs[1], lz, bpo + 0.1, lt - 0.7, x, ypo, m)
                out = pacc.fused_newton_poisson_step(
                    *args, noise=(eps, logu), frozen=frozen, const=const)
                ref = pacc.fused_newton_poisson_step_plain(
                    *args, (eps, logu), frozen=frozen, const=const)
                torch.cuda.synchronize()
                if frozen:
                    if out[3] is not hs[1][2]:
                        fail("frozen pois_newton_step must return h itself")
                    out, ref = out[:3] + out[4:], ref[:3] + ref[4:]
                e, o, _, _ = step_check(out, ref, bpo, logu,
                                        3 if frozen else 4)
                errs["pois_" + kname] = (e, o)
            # the value-only loglik and the RW-MH steps, Logit and Poisson
            for name, kern, plain, a in (
                ("loglik", logistic_loglik, loglik.logistic_loglik_padded,
                 (beta, x, y, m)),
                ("pois_loglik", pois.poisson_loglik,
                 loglik.poisson_loglik_padded, (bpo, x, ypo, m, const)),
            ):
                out, ref = kern(*a), plain(*a)
                torch.cuda.synchronize()
                errs[name] = max_err(out, ref, 1e-4)
            args = (beta, loglik.logistic_loglik_padded(beta, x, y, m), ls,
                    mu, lt, x, y, m)
            out = fused_rwmh_logistic_step(*args, noise=(eps, logu))
            ref = fused_rwmh_logistic_step_plain(*args, (eps, logu))
            torch.cuda.synchronize()
            e, o, _, _ = step_check(out, ref, beta, logu, 2)
            errs["rwmh_step"] = (e, o)
            args = (bpo, loglik.poisson_loglik_padded(bpo, x, ypo, m, const),
                    ls, bpo + 0.1, lt - 0.7, x, ypo, m)
            out = pacc.fused_rwmh_poisson_step(*args, noise=(eps, logu),
                                               const=const)
            ref = pacc.fused_rwmh_poisson_step_plain(*args, (eps, logu),
                                                     const=const)
            torch.cuda.synchronize()
            e, o, _, _ = step_check(out, ref, bpo, logu, 2)
            errs["pois_rwmh_step"] = (e, o)
            tgs = sorted({tile_plan(k, N, P)[0] for k in TILE_KINDS
                          if k != "seg"})
            ok = all(o for _, o in errs.values())
            say(f"tiled kernels [C={C} G={G} n={N} p={P}, units a tile "
                f"{tgs}]: max_abs_err "
                + ", ".join(f"{k} {e:.2e}" for k, (e, _) in errs.items())
                + f" (tol 1e-3 + 1e-4|ref|, alpha 2e-3|ref|) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"a tiled kernel at C={C} G={G} n={N} p={P} disagrees "
                     "with its plain version")
            for k, (e, _) in errs.items():
                record(k, e)
    # the segment kernels' tile (tg groups x 32 chains, observations staged
    # in chunks of tg x SEG_OBS): a group longer than a chunk and tiles
    # over the chunk budget, a group straddling a chunk boundary, config
    # 4's sizes with empty groups at G and C off the tile, fewer groups
    # than a tile, one chain
    for P in (3, 4):
        tg_seg = tile_plan("seg", SEG_OBS, P)[0]
        for C, sizes in ((33, [1500] + [30] * 39), (20, [40] * 33),
                         (70, [0 if i % 17 == 3 else 5 + (7 * i) % 26
                               for i in range(100)]),
                         (1, [3, 0, 31, 1, 2])):
            G = len(sizes)
            ge = torch.Generator(device=dev).manual_seed(17 + C + G)
            sz = torch.tensor(sizes)
            sl_ = SegmentLayout.build(
                torch.repeat_interleave(torch.arange(G), sz), G, device=dev)
            xs_ = torch.randn(int(sz.sum()), P, generator=ge, device=dev)
            ys_ = (torch.rand(int(sz.sum()), generator=ge, device=dev)
                   < 0.5).float()
            bs_ = 0.7 * torch.randn(C, G, P, generator=ge, device=dev)
            errs = {}
            for name, kern, plain, rtols in (
                ("seg_loglik", lambda *a: (logistic_loglik_segment(*a),),
                 lambda *a: (logistic_loglik_segment_plain(*a),), (2e-5,)),
                ("seg_logp_grad", logistic_logp_grad_segment,
                 logistic_logp_grad_segment_plain, (2e-5, 2e-4)),
            ):
                out = kern(bs_, xs_, ys_, sl_)
                ref = plain(bs_, xs_, ys_, sl_)
                torch.cuda.synchronize()
                e, o = seg_err(out, ref, rtols)
                o &= bool((out[0][:, (sz == 0).to(dev)] == 0).all())
                errs[name] = (e, o)
            ok = all(o for _, o in errs.values())
            say(f"tiled segment kernels [C={C} G={G} N={int(sz.sum())} "
                f"p={P}, groups of {min(sizes)}..{max(sizes)} obs, "
                f"{tg_seg} groups a tile, chunks of {tg_seg * SEG_OBS} "
                "obs]: max_abs_err "
                + ", ".join(f"{k} {e:.2e}" for k, (e, _) in errs.items())
                + f" (tol 2e-5 + rtol|ref|, empty groups exactly 0) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"a segment kernel at C={C} G={G} p={P} disagrees "
                     "with its plain version")
            for k, (e, _) in errs.items():
                record(k, e)
    torch.cuda.empty_cache()

    # ---- 3e. the Newton path's kernels at config 2's, the 1k-group
    # presets' and mala-100k-newton's shapes, and MALA at p=4 ----
    for shape, data_seed, seed in ((RW, 1000, 14), (HL1K, 2000, 15),
                                   (M100K, 5000, 16)):
        C, G, N, P = shape
        # the plain versions' (C, G, n) temporaries are 4.1 GB each at
        # mala-100k's width: there they run on the first chains only
        S = C if shape != M100K else SLICE
        plain_on = "full width" if S == C else f"{S} chains"
        d = inputs(shape, data_seed, seed)
        beta, mu, lt, eps, logu = (d[k] for k in ("beta", "mu", "lt", "eps",
                                                  "logu"))
        x, y, m = d["datasets"]["dense"]
        for name, kern, plain in (
            ("logp_grad", logistic_logp_grad,
             loglik.logistic_logp_grad_padded),
            ("logp_grad_hess", logistic_logp_grad_hess,
             loglik.logistic_logp_grad_hess_padded),
        ):
            out, ref = kern(beta, x, y, m), plain(beta[:S], x, y, m)
            torch.cuda.synchronize()
            errs = [max_err(a[:S], b, 1e-4) for a, b in zip(out, ref)]
            err, ok = max(e for e, _ in errs), all(o for _, o in errs)
            ms = timed(lambda: kern(beta, x, y, m))
            pms = timed(lambda: plain(beta[:S], x, y, m))
            w = work(name, C, G, N, P)
            say(f"kernel {name} [C={C} G={G} n={N} p={P}, parity and plain "
                f"on {plain_on}]: max_abs_err {err:.3e} (tol 1e-3 + "
                f"1e-4|ref|) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
                f"plain {pms:.4f} ms; {bound_str(w)}")
            if not ok:
                fail(f"{name} at C={C} G={G} disagrees with its plain version")
            cell(name, shape, err, ms, pms, w, plain_on)
            del out, ref
        v, g, h = logistic_logp_grad_hess(beta, x, y, m)
        ls = torch.zeros(C, G, device=dev)
        sl = tuple(a[:S] for a in (beta, v, g, h, ls, mu, lt))
        # refresh (warmup), frozen (mala-100k-newton's sampling: its R-hat
        # is thinned, so nothing folds in the kernel) and frozen+fold
        # (config 2's and hier-logistic-1k's sampling)
        for frozen, fold in ((False, False), (True, False), (True, True)):
            rf = rf_s = None
            if fold:
                fm = torch.randn(2, G, P, C, generator=d["gen"], device=dev)
                fm2 = torch.rand(2, G, P, C, generator=d["gen"], device=dev)
                sc = fold_rhat_scalars([11.0, 0.0], 11, 2048).to(dev)
                rf, rf_s = (fm, fm2, sc), (fm[..., :S], fm2[..., :S], sc)
            args = (beta, v, g, h, ls, mu, lt, x, y, m)
            out = fused_newton_logistic_step(*args, noise=(eps, logu),
                                             frozen=frozen, rhat_fold=rf)
            ref = fused_newton_logistic_step_plain(
                *sl, x, y, m, (eps[:S], logu[:S]), frozen=frozen,
                rhat_fold=rf_s)
            torch.cuda.synchronize()
            if frozen and out[3] is not h:
                fail("frozen newton_step must return h itself")
            out_s = [o[:S] for o in out[:5]] + [o[..., :S] for o in out[5:]]
            keep = [i for i in range(len(out_s)) if not (frozen and i == 3)]
            err, ok, n_diff, n_bad = step_check(
                [out_s[i] for i in keep], [ref[i] for i in keep], beta[:S],
                logu[:S], keep.index(4))
            ms_ext = timed(lambda: fused_newton_logistic_step(
                *args, noise=(eps, logu), frozen=frozen, rhat_fold=rf))
            key = DeviceKey(seed, dev)
            ms = timed(lambda: fused_newton_logistic_step(
                *args, rng=key, frozen=frozen, rhat_fold=rf))
            pms = timed(lambda: fused_newton_logistic_step_plain(
                *sl, x, y, m, (eps[:S], logu[:S]), frozen=frozen,
                rhat_fold=rf_s))
            kname = "newton_step_frozen" if frozen else "newton_step_refresh"
            w = work(kname, C, G, N, P, noise=False, fold=fold)
            case = (f"{'frozen' if frozen else 'refresh'}"
                    f"{'+fold' if fold else ''}")
            say(f"kernel newton_step {case} [C={C} G={G} n={N} p={P}, parity "
                f"and plain on {plain_on}]: max_abs_err {err:.3e} (tol 1e-3 "
                f"+ 1e-4|ref|, alpha 2e-3|ref|); accept decisions differ in "
                f"{n_diff} of {S * G} cells, {n_bad} outside |log a - log u| "
                f"< 1e-3 {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms "
                f"(Philox noise; external noise {ms_ext:.4f} ms), plain "
                f"{pms:.4f} ms; {bound_str(w)} (Philox)")
            if not ok:
                fail(f"newton_step {case} at C={C} G={G} disagrees with its "
                     "plain version")
            cell(kname, shape, err, ms, pms, w, plain_on, fold=fold,
                 ms_external_noise=ms_ext)
            del out, ref, out_s, rf, rf_s, args
        if shape == HL1K:
            # hier-logistic-1k-mala's step: Philox noise with the fold
            vg = logistic_logp_grad(beta, x, y, m)
            lsm = torch.full((C, G), -1.3, device=dev)
            rf = (torch.randn(2, G, P, C, generator=d["gen"], device=dev),
                  torch.rand(2, G, P, C, generator=d["gen"], device=dev),
                  fold_rhat_scalars([11.0, 0.0], 11, 2048).to(dev))
            args = (beta, *vg, lsm, mu, lt, x, y, m)
            out = fused_mala_logistic_step(*args, noise=(eps, logu),
                                           rhat_fold=rf)
            ref = fused_mala_logistic_step_plain(*args, (eps, logu),
                                                 rhat_fold=rf)
            torch.cuda.synchronize()
            err, ok, n_diff, n_bad = step_check(out, ref, beta, logu, 3)
            ms_ext = timed(lambda: fused_mala_logistic_step(
                *args, noise=(eps, logu), rhat_fold=rf))
            key = DeviceKey(seed, dev)
            ms = timed(lambda: fused_mala_logistic_step(*args, rng=key,
                                                        rhat_fold=rf))
            pms = timed(lambda: fused_mala_logistic_step_plain(
                *args, (eps, logu), rhat_fold=rf))
            w = work("mala_step", C, G, N, P, noise=False, fold=True)
            say(f"kernel mala_step fold [C={C} G={G} n={N} p={P}]: "
                f"max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|, alpha "
                f"2e-3|ref|); accept decisions differ in {n_diff} of "
                f"{C * G} cells, {n_bad} outside |log a - log u| < 1e-3 "
                f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms (Philox "
                f"noise; external noise {ms_ext:.4f} ms), plain {pms:.4f} "
                f"ms; {bound_str(w)} (Philox)")
            if not ok:
                fail("mala_step at p=4 disagrees with its plain version")
            cell("mala_step", shape, err, ms, pms, w, "full width", fold=True,
                 ms_external_noise=ms_ext)
            del out, ref, vg, rf, args
        del d, beta, mu, lt, eps, logu, x, y, m, v, g, h, ls, sl
        torch.cuda.empty_cache()

    # the value-only loglik at the shapes where group_loglik collects it,
    # one launch a retained draw: the judged and 1k-group presets
    for shape, data_seed, seed in ((JUDGED, 2000, 18), (HL1K, 2000, 19)):
        C, G, N, P = shape
        d = inputs(shape, data_seed, seed)
        beta, (x, y, m) = d["beta"], d["datasets"]["dense"]
        out, ref = logistic_loglik(beta, x, y, m), \
            loglik.logistic_loglik_padded(beta, x, y, m)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, 1e-4)
        ms = timed(lambda: logistic_loglik(beta, x, y, m))
        pms = timed(lambda: loglik.logistic_loglik_padded(beta, x, y, m))
        w = work("loglik", C, G, N, P)
        say(f"kernel loglik [C={C} G={G} n={N} p={P}, group_loglik's "
            f"shape]: max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|) "
            f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms; {bound_str(w)}")
        if not ok:
            fail(f"loglik at C={C} G={G} disagrees with its plain version")
        cell("loglik", shape, err, ms, pms, w, "full width",
             launches_per_draw_collected=1)
        del d, beta, x, y, m, out, ref
        torch.cuda.empty_cache()

    # ---- 3f. the binomial family's operands at config 2's shape: the
    # mask a trials weight (integers 0..10, zero-weight runs inside
    # groups), y the fraction of successes (hier_glm's binomial delegate)
    C, G, N, P = RW
    d = inputs(RW, 1000, 21)
    beta, mu, lt, eps, logu = (d[k] for k in ("beta", "mu", "lt", "eps",
                                              "logu"))
    x, gen = d["datasets"]["dense"][0], d["gen"]
    wm = torch.randint(0, 11, (G, N), generator=gen, device=dev).float()
    wm[::7, N // 2 - 2:N // 2 + 2] = 0.0
    yb = torch.where(wm > 0, torch.floor(
        torch.rand(G, N, generator=gen, device=dev) * (wm + 1.0))
        / wm.clamp_min(1.0), torch.zeros_like(wm))
    wlabel = "binomial weights 0..10"
    for name, kern, plain in (
        ("loglik", lambda *a: (logistic_loglik(*a),),
         lambda *a: (loglik.logistic_loglik_padded(*a),)),
        ("logp_grad", logistic_logp_grad, loglik.logistic_logp_grad_padded),
    ):
        out, ref = kern(beta, x, yb, wm), plain(beta, x, yb, wm)
        torch.cuda.synchronize()
        errs = [max_err(a, b, 1e-4) for a, b in zip(out, ref)]
        err, ok = max(e for e, _ in errs), all(o for _, o in errs)
        ms = timed(lambda: kern(beta, x, yb, wm))
        pms = timed(lambda: plain(beta, x, yb, wm))
        w = work(name, C, G, N, P)
        say(f"kernel {name} [{wlabel}, C={C} G={G} n={N} p={P}]: "
            f"max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|) "
            f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms; {bound_str(w)}")
        if not ok:
            fail(f"{name} on a binomial-weighted mask disagrees with its "
                 "plain version")
        cell(name, RW, err, ms, pms, w, "full width", mask=wlabel)
        del out, ref
    v, g, h = loglik.logistic_logp_grad_hess_padded(beta, x, yb, wm)
    ls = torch.zeros(C, G, device=dev)
    for frozen, fold in ((False, False), (True, True)):
        rf = None
        if fold:
            rf = (torch.randn(2, G, P, C, generator=gen, device=dev),
                  torch.rand(2, G, P, C, generator=gen, device=dev),
                  fold_rhat_scalars([11.0, 0.0], 11, 2048).to(dev))
        args = (beta, v, g, h, ls, mu, lt, x, yb, wm)
        out = fused_newton_logistic_step(*args, noise=(eps, logu),
                                         frozen=frozen, rhat_fold=rf)
        ref = fused_newton_logistic_step_plain(*args, (eps, logu),
                                               frozen=frozen, rhat_fold=rf)
        torch.cuda.synchronize()
        if frozen and out[3] is not h:
            fail("frozen newton_step must return h itself")
        keep = [i for i in range(len(out)) if not (frozen and i == 3)]
        err, ok, n_diff, n_bad = step_check(
            [out[i] for i in keep], [ref[i] for i in keep], beta, logu,
            keep.index(4))
        ms_ext = timed(lambda: fused_newton_logistic_step(
            *args, noise=(eps, logu), frozen=frozen, rhat_fold=rf))
        key = DeviceKey(22, dev)
        ms = timed(lambda: fused_newton_logistic_step(
            *args, rng=key, frozen=frozen, rhat_fold=rf))
        pms = timed(lambda: fused_newton_logistic_step_plain(
            *args, (eps, logu), frozen=frozen, rhat_fold=rf))
        kname = "newton_step_frozen" if frozen else "newton_step_refresh"
        w = work(kname, C, G, N, P, noise=False, fold=fold)
        case = f"{'frozen' if frozen else 'refresh'}{'+fold' if fold else ''}"
        say(f"kernel newton_step {case} [{wlabel}, C={C} G={G} n={N} "
            f"p={P}]: max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|, alpha "
            f"2e-3|ref|); accept decisions differ in {n_diff} of {C * G} "
            f"cells, {n_bad} outside |log a - log u| < 1e-3 "
            f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms (Philox noise; "
            f"external noise {ms_ext:.4f} ms), plain {pms:.4f} ms; "
            f"{bound_str(w)} (Philox)")
        if not ok:
            fail(f"newton_step {case} on a binomial-weighted mask disagrees "
                 "with its plain version")
        cell(kname, RW, err, ms, pms, w, "full width", fold=fold,
             mask=wlabel, ms_external_noise=ms_ext)
        del out, ref, rf, args
    del d, beta, mu, lt, eps, logu, x, gen, wm, yb, v, g, h, ls
    torch.cuda.empty_cache()

    # ---- 3g. the interweave's kernels (ops/cuda/asis.py) at the main
    # paths' shapes: the Laplace mode with a Hessian a chain at judged's,
    # the Langevin mode with the shared bound metric at a mala-100k rank's;
    # each wrapper against its plain version on the same inputs, both
    # timed as replays of ten captured calls (the wrappers' host work
    # outlasts their kernels; kernel_ab.timed_graph)
    for shape, laplace in ((JUDGED, True), (MRANK, False)):
        C, G, N, P = shape
        a = kernel_ab.asis_inputs(
            shape, kernel_ab.logistic_inputs(shape, dev, 8), laplace)
        beta, mu, lt, g, h, scale, prior = (a[k] for k in (
            "beta", "mu", "lt", "g", "h", "scale", "prior"))
        hn = 0 if h.shape[0] == 1 else P * (P + 1) // 2
        mode = "laplace" if laplace else "langevin"
        vv = (a["v_new"], a["v"])
        prop = (a["row"], mu, lt, a["eps"], scale, beta, prior)
        # log u within 1 of the plain version's log alpha: about half the
        # chains accept, so the decisions are held both ways
        gen = torch.Generator(device=dev).manual_seed(9)
        acc = (a["row_new"], a["th_new"], mu, lt, a["aux"], scale)
        logu = (asis.asis_accept_plain(*acc, a["logu"], prior)[0]
                + 2.0 * torch.rand(C, generator=gen, device=dev) - 1.0)
        acc += (logu, prior)
        calls = [
            ("asis_stats", "current",
             lambda: (asis.asis_stats(beta, mu, g, h),),
             lambda: (asis.asis_stats_plain(beta, mu, g, h),),
             work("asis_stats", C, G, 2 * P + hn, P)),
            ("asis_stats", "proposal",
             lambda: (asis.asis_stats(beta, mu, a["g_new"], h, a["aux"],
                                      vv),),
             lambda: (asis.asis_stats_plain(beta, mu, a["g_new"], h,
                                            a["aux"], vv),),
             work("asis_stats", C, G, 2 * P + hn + 2, P)),
            ("asis_propose", "", lambda: asis.asis_propose(*prop),
             lambda: asis.asis_propose_plain(*prop),
             work("asis_propose", C, G, 0, P)),
            ("asis_accept", "", lambda: asis.asis_accept(*acc),
             lambda: asis.asis_accept_plain(*acc),
             work("asis_accept", C, 0, 0, P)),
        ]
        for name, call, kern, plain, w in calls:
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            extra = ""
            if name == "asis_accept":
                # log alpha (atol 1e-3 + rtol 1e-4) and alpha (rtol 2e-3);
                # the decisions equal wherever |log alpha - log u| > 1e-3
                # and each the kernel's own log u < log alpha
                errs = [max_err(out[0], ref[0], 1e-4),
                        max_err(out[2], ref[2], 2e-3)]
                clear = (ref[0] - logu).abs() > 1e-3
                n_bad = int((out[1] != ref[1])[clear].sum())
                own = bool(torch.equal(out[1], logu < out[0]))
                errs.append((0.0, n_bad == 0 and own))
                extra = (f"; accepted {int(out[1].sum())} of {C} chains, "
                         f"{n_bad} decisions differ clear of log u")
            else:
                errs = [max_err(o, r, 1e-4) for o, r in zip(out, ref)]
            err, ok = max(e for e, _ in errs), all(o for _, o in errs)
            del out, ref
            ms = kernel_ab.timed_graph(kern)
            pms = kernel_ab.timed_graph(plain)
            label = f"{name}{' ' + call if call else ''}"
            say(f"kernel {label} [{mode}, C={C} G={G} n={N} p={P}]: "
                f"max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|) "
                f"{'ok' if ok else 'FAIL'}{extra}; kernel {ms:.4f} ms, "
                f"plain {pms:.4f} ms (graph replays); {bound_str(w)}")
            if not ok:
                fail(f"{label} [{mode}] disagrees with its plain version")
            if laplace and call != "proposal":
                record(name, err, ms, pms, shape, w)
            else:
                cell(name, shape, err, ms, pms, w, "full width", mode=mode,
                     call=call or None)
        del a, beta, mu, lt, g, h, scale, prior, prop, acc, logu, calls
        torch.cuda.empty_cache()

    # ---- 4. Philox moments ----
    nrm, uni = philox_probe(512 * 256, (1234, 99), dev, p=4)
    x = nrm.double().cpu()
    n = x.numel()
    mean, std = float(x.mean()), float(x.std())
    frac2 = float((x.abs() > 2.0).double().mean())
    skew = float((x**3).mean())
    u = uni.double().cpu()
    checks = [
        abs(mean) < 4 / math.sqrt(n),
        abs(std - 1.0) < 4 / math.sqrt(2 * n),
        abs(frac2 - 0.0455) < 0.01,
        abs(skew) < 6 * math.sqrt(15 / n),
        float(u.min()) > 0.0 and float(u.max()) <= 1.0,
        abs(float(u.mean()) - 0.5) < 4 * math.sqrt(1 / 12 / n),
    ]
    say(f"philox: {n} normals mean {mean:.2e} sd {std:.5f} "
        f"P(|z|>2) {frac2:.4f} E[z^3] {skew:.2e}; uniforms in "
        f"[{float(u.min()):.3e}, {float(u.max()):.7f}] mean "
        f"{float(u.mean()):.5f} {'ok' if all(checks) else 'FAIL'}")
    if not all(checks):
        fail("Philox moments")

    # ---- 5. small-input references: card (kernels) vs CPU (plain) ----
    def small_reference(label, make, algorithm, names, block):
        small = {}
        for dv in ("cuda", "cpu"):
            model, sd = make(dv)
            small[dv] = sample(model, sd, SamplerConfig(
                kernel=KernelConfig(algorithm=algorithm),
                run=RunConfig(chains=32, warmup=200, draws=400, seed=3,
                              full_rhat=True, log_every_segment=False,
                              collect={k: None for k in names}),
            ))
        for name in names:
            dk = small["cuda"].diagnostics()[name]
            dp = small["cpu"].diagnostics()[name]
            se = (dk["mcse_mean"].cpu() ** 2 + dp["mcse_mean"] ** 2).sqrt()
            gap = (dk["mean"].cpu() - dp["mean"]).abs()
            ok = bool((gap < 4 * se).all())
            say(f"small reference {label} {name}: card "
                f"{dk['mean'].cpu().tolist()} vs cpu {dp['mean'].tolist()}, "
                f"max gap/MCSE {float((gap / se).max()):.2f} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"small-input {label} posterior of {name} disagrees "
                     "with the CPU")
        ak = float(small["cuda"].accept_rates[block].mean())
        ap = float(small["cpu"].accept_rates[block].mean())
        say(f"small reference {label} {block} acceptance: card {ak:.4f} "
            f"cpu {ap:.4f}")
        if abs(ak - ap) >= 0.05:
            fail(f"small-input {label} {block} acceptance disagrees")

    for algorithm, tau_prior in (("newton", "invgamma"),
                                 ("mala", "halfnormal"),
                                 ("rwmh", "halfnormal")):
        def make_logistic(dv, tau_prior=tau_prior):
            sd, _ = synth_logistic(5, G=16, n=20, p=3, device=dv)
            return make_hier_logistic(sd, tau_prior=tau_prior), sd
        small_reference(algorithm, make_logistic, algorithm,
                        ("mu", "log_tau"), "beta")
    # ragged data: the invgamma prior for both routes; with half-normal
    # tau this small model's log tau mixes too slowly for a 0.05
    # acceptance check (the beta acceptance follows where tau sits)
    for algorithm, impl, tau_prior in (("newton", "bucket", "invgamma"),
                                       ("mala", "pallas-segment",
                                        "invgamma")):
        def make_ragged(dv, impl=impl, tau_prior=tau_prior):
            sd, _ = synth_logistic(5, G=96, n=32, p=3, ragged=True,
                                   min_obs=1, device=dv)
            nb = len(bucket.BucketLayout.build(sd.segment_ids, 96).buckets)
            if nb < 2:
                fail(f"small ragged data form {nb} size bucket(s), not >= 2")
            return make_hier_logistic(sd, tau_prior=tau_prior,
                                      loglik_impl=impl), sd
        small_reference(f"ragged {algorithm} ({impl})", make_ragged,
                        algorithm, ("mu", "log_tau"), "beta")
    for algorithm in ("rwmh", "mala", "newton"):
        def make_poisson(dv):
            sd, _ = synth_poisson3(5, G=8, subjects_per_group=3, n=10, p=2,
                                   device=dv)
            return make_nested_poisson(sd, tau_prior="invgamma"), sd
        small_reference(f"nested-poisson {algorithm}", make_poisson,
                        algorithm, ("mu", "log_tau_g", "log_tau_s"),
                        "beta_s")

    # ---- 11. the compiled segments: graph against eager ----
    for k, nl in phase11(dev, smi).items():
        launches_total[k] = launches_total.get(k, 0) + nl

    # ---- 6. the end-to-end paths at full width ----
    fixed_s = {}    # wall seconds of phase 6's fixed paths

    def logistic_shapes(C_, P_, k_):
        return lambda D: {"mu": (C_, D, P_), "log_tau": (C_, D, P_),
                          "beta": (C_, D, k_, P_)}

    def poisson_shapes(D):
        return {"mu": (512, D, 3), "log_tau_g": (512, D, 3),
                "log_tau_s": (512, D, 3), "beta_g": (512, D, 8, 3),
                "beta_s": (512, D, 8, 3)}

    def run_path(preset, expect, block, acc_range, shapes, full_rhat=None,
                 warmup=None, draws=None, gate=True, runner=None, check=None,
                 why="a short or cut schedule"):
        """Drive one path (bench.run of ``preset``, or ``runner``) and check
        its launches, R-hat (unless ``gate`` is False, for the reason
        ``why``), acceptance, finiteness and draw shapes, then
        ``check(post)`` where given."""
        runner = runner or (lambda **kw: bench.run(preset=preset, **kw))
        reset_launch_counts()
        t_path = time.perf_counter()
        result, post, run_info = runner(warmup=warmup, draws=draws,
                                        full_rhat=full_rhat)
        launches = launch_counts()
        fixed_s[preset] = time.perf_counter() - t_path
        if post.timings["sweep"] != "graph":
            fail(f"{preset}: the run stepped {post.timings['sweep']}, not "
                 "the captured graph")
        say(f"{preset}: replayed captured graphs (capture "
            f"{post.timings['capture_s']:.3f} s; peak_mem_gb "
            f"{post.timings['peak_mem_gb']:.4f})")
        W, D = run_info["warmup"], run_info["draws"]
        say(f"{preset} run: {json.dumps(run_info)}")
        print(json.dumps(result), flush=True)
        say(f"launches in the {preset} run: {launches}")
        for k, nl in launches.items():
            launches_total[k] = launches_total.get(k, 0) + nl
        want = {k: 0 for k in launches}
        want.update({k: f(W, D) for k, f in expect.items()})
        if launches != want:
            fail(f"{preset}: launches {launches} != expected {want}")
        worst = post.worst_rhat()
        acc = float(post.accept_rates[block].mean())
        n_par = run_info["n_params"]
        covered = sum(v.numel() for v in post.full_rhat.values())
        if covered != n_par:
            fail(f"{preset}: streamed R-hat covers {covered} of {n_par} "
                 "parameters")
        say(f"{preset}: worst all-param R-hat {worst:.5f} over {n_par} "
            f"parameters ({'gate < 1.01' if gate else 'NOT asserted: ' + why}"
            f"); {block} sampling acceptance {acc:.4f} (in "
            f"{acc_range}); ESS/s/GPU {result['value']} min-ESS/s "
            f"{result['min_ess_per_sec_per_chip']} on '{smi}'")
        if gate and not worst < 1.01:
            fail(f"{preset}: worst R-hat {worst}")
        if not acc_range[0] < acc < acc_range[1]:
            fail(f"{preset}: {block} acceptance {acc}")
        finite = all(bool(torch.isfinite(v).all())
                     for v in post.draws.values())
        finite &= all(bool(torch.isfinite(v).all())
                      for v in post.final_state.position.values())
        if not finite:
            fail(f"{preset}: NaN or inf in the draws or the final state")
        got = {k: tuple(v.shape) for k, v in post.draws.items()}
        if got != shapes(D):
            fail(f"{preset}: draw shapes {got} != {shapes(D)}")
        if check is not None:
            check(post)
        del post
        torch.cuda.empty_cache()

    def segment_runner(algorithm):
        """ragged-10k-mala's data and config, the model built on the
        segment-kernel route with the preset's priors, ``algorithm`` on
        beta."""
        def run(**kw):
            model, data, cfg = get_preset("ragged-10k-mala", device=dev)
            model = make_hier_logistic(data, loglik_impl="pallas-segment")
            cfg = dataclasses.replace(cfg, kernel=dataclasses.replace(
                cfg.kernel, algorithm=algorithm))
            return bench.measure(
                model, data, cfg, f"ragged-10k pallas-segment {algorithm}",
                f"10k-group ragged hierarchical logistic, {algorithm}, "
                "segment kernels", **kw)
        return run

    def per_sweep(preset, runner=None):
        """(seconds a sweep, fixed seconds) at full width from a 10/10 run:
        the sweeps' wall over 20 (first sweeps included, so it errs long)
        and the rest of the run (data, set-up, diagnostics)."""
        runner = runner or (lambda **kw: bench.run(preset=preset, **kw))
        t0 = time.perf_counter()
        _, _, info = runner(warmup=10, draws=10)
        torch.cuda.empty_cache()
        sweeps = info["warmup_s"] + info["sample_s"]
        return sweeps / 20, time.perf_counter() - t0 - sweeps

    def need_s(est, sched):
        return 2.0 * est[1] + 1.15 * est[0] * sum(sched)

    def mu_tau_stats(post):
        """{name: (mean, MCSE)} of mu and tau = exp(log_tau), (p,) each."""
        dg = diagnose({"mu": post.draws["mu"],
                       "tau": torch.exp(post.draws["log_tau"])})
        return {k: (dg[k]["mean"].cpu(), dg[k]["mcse_mean"].cpu())
                for k in dg}

    rw_ref = {}     # the built-in RW run's posterior, for phase 9b
    run_path("hier-logistic-100-rw",
             {"rwmh_step": lambda W, D: W + D,
              "loglik": lambda W, D: W + D + 1},
             "beta", (0.1, 0.5), logistic_shapes(64, 4, 16), full_rhat=True,
             check=lambda post: rw_ref.update(mu_tau_stats(post)))

    # config 2: frozen-metric Newton, one step and one Laplace interweave
    # (its Hessian pass in warmup and once for the initial cache, its
    # gradient pass in sampling) a sweep, at full schedule
    newton_path = {"newton_step_refresh": lambda W, D: W,
                   "newton_step_frozen": lambda W, D: D,
                   "logp_grad_hess": lambda W, D: W + 1,
                   "logp_grad": lambda W, D: D, **ASIS}
    run_path("hier-logistic-100", newton_path, "beta", (0.5, 1.0),
             logistic_shapes(64, 4, 16))

    # config 1: plain PyTorch (no kernel), 4 chains, full schedule, against
    # the dense quadrature of the posterior
    ref8 = eight_schools_quadrature()

    def check_eight_schools(post):
        d = post.diagnostics()
        mu_err = abs(float(d["mu"]["mean"]) - ref8["mu_mean"])
        mu_se = float(d["mu"]["mcse_mean"])
        mu_var = float(post.var("mu"))
        var_tol = 6 * ref8["mu_var"] * math.sqrt(
            2 / float(d["mu"]["ess_bulk"]))
        tau = torch.exp(post.draws["log_tau"])
        tau_se = float(tau.std()) / math.sqrt(float(ess(tau)))
        tau_err = abs(float(tau.mean()) - ref8["tau_mean"])
        th_err = (d["theta"]["mean"].cpu().double()
                  - torch.tensor(ref8["theta_mean"])).abs()
        th_ratio = float((th_err / d["theta"]["mcse_mean"].cpu()).max())
        ok = (mu_err < 6 * mu_se and abs(mu_var - ref8["mu_var"]) < var_tol
              and tau_err < 6 * tau_se and th_ratio < 6)
        say(f"eight-schools vs quadrature: mu {float(d['mu']['mean']):.4f} "
            f"(quadrature {ref8['mu_mean']:.4f}, |err|/mcse "
            f"{mu_err / mu_se:.2f}), var {mu_var:.3f} ({ref8['mu_var']:.3f},"
            f" tol {var_tol:.3f}); tau {float(tau.mean()):.4f} "
            f"({ref8['tau_mean']:.4f}, |err|/se {tau_err / tau_se:.2f}); "
            f"theta max |err|/mcse {th_ratio:.2f} (tol 6) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("eight-schools disagrees with the quadrature")

    # its z block's proposal noise and accept uniforms: two unit-axis
    # noise fills a sweep (ops/cuda/philox_fill)
    run_path("eight-schools", {"philox_fill": lambda W, D: 2 * (W + D)},
             "z", (0.2, 0.7),
             lambda D: {"z": (4, D, 8), "mu": (4, D), "log_tau": (4, D),
                        "theta": (4, D, 8)},
             check=check_eight_schools)

    # the exactness tier: the conjugate model's moments against the closed
    # form (tests/test_torch_exactness.py's schedule and z)
    t0 = time.perf_counter()
    edata = synth_hier_normal(11, G=15, n=8, sigma=1.0, tau=1.5, m0=0.0,
                              s0=3.0, device=dev)
    reset_launch_counts()
    epost = sample(
        make_hier_normal_known_scales(edata, sigma=1.0, tau=1.5, m0=0.0,
                                      s0=3.0),
        edata, SamplerConfig(run=RunConfig(chains=32, warmup=1500,
                                           draws=2500, seed=2,
                                           log_every_segment=False)))
    # theta's RW-MH noise: two unit-axis noise fills a sweep, nothing else
    want = {k: 0 for k in launch_counts()}
    want["philox_fill"] = 2 * (1500 + 2500)
    if launch_counts() != want:
        fail(f"the conjugate model launched {launch_counts()} != {want}")
    launches_total["philox_fill"] = (launches_total.get("philox_fill", 0)
                                     + want["philox_fill"])
    truth = analytic_hier_normal_posterior(edata, 1.0, 1.5, 0.0, 3.0)
    d = epost.diagnostics()
    e_mu = abs(float(d["mu"]["mean"]) - truth["mu_mean"]) / float(
        d["mu"]["mcse_mean"])
    e_muv = abs(float(epost.var("mu")) - truth["mu_var"]) / (
        truth["mu_var"] * math.sqrt(2.0 / float(d["mu"]["ess_bulk"])))
    e_th = float(((d["theta"]["mean"].cpu().double()
                   - torch.tensor(truth["theta_mean"])).abs()
                  / d["theta"]["mcse_mean"].cpu()).max())
    e_thv = float(((epost.var("theta").cpu().double()
                    - torch.tensor(truth["theta_var"])).abs()
                   / (torch.tensor(truth["theta_var"]) * torch.sqrt(
                       2.0 / d["theta"]["ess_bulk"].cpu().double()))).max())
    e_rhat = epost.worst_rhat()
    ok = e_rhat < 1.02 and max(e_mu, e_muv, e_th, e_thv) < 5.0
    say(f"exactness tier on the card ({time.perf_counter() - t0:.1f} s): "
        f"R-hat {e_rhat:.5f} (< 1.02); |err| in units of its standard error "
        f"(< 5): mu mean {e_mu:.2f}, mu var {e_muv:.2f}, theta means "
        f"{e_th:.2f}, theta vars {e_thv:.2f} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the exactness tier on the card")
    del epost, edata

    run_path("nested-poisson-1k",
             {"pois_rwmh_step": lambda W, D: W + D,
              "pois_loglik": lambda W, D: 1 + 2 * (W + D),
              "philox_fill": lambda W, D: W + D},
             "beta_s", (0.1, 0.5), poisson_shapes)

    # config 4: every bucket runs one fused Newton step a sweep, and one
    # Hessian (warmup, and once for the initial cache) or gradient
    # (sampling) pass for the interweave's proposal
    run_path("ragged-10k",
             {"newton_step_refresh": lambda W, D: B * W,
              "newton_step_frozen": lambda W, D: B * D,
              "logp_grad_hess": lambda W, D: B * (W + 1),
              "logp_grad": lambda W, D: B * D, **ASIS},
             "beta", (0.5, 1.0), logistic_shapes(1024, 3, 8))

    # config 5's Newton variant at full width, depth cut: its launches
    # asserted, its R-hat printed (the full schedule's gate comes from
    # python -m nestmc_torch.bench --preset mala-100k-newton)
    run_path("mala-100k-newton", newton_path, "beta", (0.5, 1.0),
             logistic_shapes(512, 3, 8), warmup=100, draws=150, gate=False)

    say("phase 6's fixed paths took "
        f"{sum(fixed_s.values()):.1f} s (phase 11 is paid for by what the "
        "graph saves here): " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in fixed_s.items()))
    # phases 7 and 8 run here, between phase 6's fixed paths and its cut
    # ones, so the cuts below see the time they actually took
    # ---- 7. the command line: run -> checkpoint -> resume -> compare ----
    import contextlib
    import io
    import os
    import shutil
    import subprocess
    import tempfile

    import numpy as np

    from nestmc_torch import cli
    from nestmc_torch.checkpoint import (
        checkpoint_tag,
        load_checkpoint,
        save_checkpoint,
    )
    from nestmc_torch.kernels.state import checkpoint_template

    t7 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="nestmc_smoke_")

    def cli_run(label, argv, expect):
        """cli.main(argv) on the card with its stdout captured and echoed;
        its launch counts, reset just before, must equal ``expect``.
        Returns (the last stdout line, seconds)."""
        buf = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        sec = time.perf_counter() - t0
        launches = launch_counts()
        out = buf.getvalue()
        print(out, end="", flush=True)
        say(f"cli {label} ({sec:.1f} s): rc {rc}; launches {launches}")
        if rc != 0:
            fail(f"cli {label}: exit code {rc}")
        want = {k: 0 for k in launches}
        want.update(expect)
        if launches != want:
            fail(f"cli {label}: launches {launches} != expected {want}")
        for k, nl in launches.items():
            launches_total[k] = launches_total.get(k, 0) + nl
        return out.strip().splitlines()[-1], sec

    # (a) config 2 at full width through the command line, half its
    # schedule (phase 6 gates the full one), collecting group_loglik (one
    # value-only loglik launch a retained draw), checkpointing every
    # segment of 512
    W2, D2 = 750, 2048
    HALF = D2 // 2
    path_a, path_r, path_b = (os.path.join(tmp, f) for f in
                              ("a.npz", "a_resumed.npz", "b.npz"))
    ck_a, ck_r = os.path.join(tmp, "ck"), os.path.join(tmp, "ck_resume")
    base = ["run", "--preset", "hier-logistic-100", "--collect",
            "mu,log_tau,beta:8,group_loglik", "--warmup", str(W2),
            "--draws", str(D2), "--segment-size", "512",
            "--checkpoint-every", "1", "--metric-json", "--quiet"]
    line, sec_a = cli_run("run hier-logistic-100", base + [
        "--checkpoint-dir", ck_a, "--save-draws", path_a],
        {"newton_step_refresh": W2, "newton_step_frozen": D2,
         "logp_grad_hess": W2 + 1, "logp_grad": D2, "loglik": D2,
         **{k: f(W2, D2) for k, f in ASIS.items()}})
    res_a = json.loads(line)
    za = dict(np.load(path_a))
    gll = za["group_loglik"]
    rh_a = {k[len("__full_rhat__."):]: v for k, v in za.items()
            if k.startswith("__full_rhat__.")}
    covered = sum(v.size for v in rh_a.values())
    ck_ms = 1e3 * res_a["timings"]["checkpoint_s"] / max(
        res_a["timings"]["checkpoints"], 1)
    say(f"cli config 2: worst R-hat {res_a['worst_rhat']:.5f} (gate < 1.01 "
        f"over {covered} streamed parameters and the collected scalars); "
        f"ESS/s/GPU {res_a['value']:.1f}; sample {res_a['sample_s']:.1f} s; "
        f"{res_a['timings']['checkpoints']} checkpoints at {ck_ms:.2f} ms "
        f"each; group_loglik {gll.shape}")
    if covered != 408 or res_a["rhat_params_streamed"] != 408:
        fail(f"cli config 2: streamed R-hat covers {covered} of 408")
    if not res_a["worst_rhat"] < 1.01:
        fail(f"cli config 2: worst R-hat {res_a['worst_rhat']}")
    if gll.shape != (64, D2, 100) or not np.isfinite(gll).all():
        fail(f"cli config 2: group_loglik {gll.shape}, finite "
             f"{bool(np.isfinite(gll).all())}")
    # group_loglik against the plain pass on the collected groups' betas
    _, d2data, _ = get_preset("hier-logistic-100", device=dev)
    x8, y8, m8 = d2data.x[:8], d2data.y[:8], d2data.mask[:8]
    errs = []
    for j in (0, 1, D2 // 2, D2 - 1):
        b8 = torch.from_numpy(za["beta"][:, j]).to(dev)
        ref = loglik.logistic_loglik_padded(b8, x8, y8, m8)
        errs.append(max_err(torch.from_numpy(gll[:, j, :8]).to(dev), ref,
                            1e-4))
    err = max(e for e, _ in errs)
    ok = all(o for _, o in errs)
    say(f"cli config 2: group_loglik of draws 0, 1, {D2 // 2}, {D2 - 1} "
        f"(the 8 collected groups) vs the plain pass: max_abs_err "
        f"{err:.3e} (tol 1e-3 + 1e-4|ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("group_loglik disagrees with its plain version")
    record("loglik", err)
    # the added cost of collecting group_loglik, a retained draw
    m2, _, _ = get_preset("hier-logistic-100", device=dev)
    pos2 = m2.init_state(SweepRNG(4, dev), d2data, 64)
    buf2 = torch.empty(64, 8, 100, device=dev)
    gl_ms = timed(lambda: buf2[:, 3].copy_(m2.derived["group_loglik"](pos2)))
    say(f"cli config 2: group_loglik a retained draw (loglik launch + "
        f"buffer write) {gl_ms:.4f} ms")

    # (b) a crash after the second sample segment: resume from its
    # checkpoint; only the remaining draws run (the template's init pass
    # is one logp_grad_hess) and the all-parameter gate is the
    # uninterrupted run's
    os.makedirs(ck_r)
    for f in os.listdir(ck_a):
        ck_phase, _, ck_n = f.split(".")[0].split("_", 1)[1].rpartition("_")
        if ck_phase == "warmup" or int(ck_n) <= HALF:
            shutil.copy(os.path.join(ck_a, f), ck_r)
    line, sec_b = cli_run("run --resume", base + [
        "--checkpoint-dir", ck_r, "--resume", "--save-draws", path_r],
        {"newton_step_frozen": D2 - HALF, "logp_grad": D2 - HALF,
         "loglik": D2 - HALF, "logp_grad_hess": 1,
         **{k: f(0, D2 - HALF) for k, f in ASIS.items()}})
    res_r = json.loads(line)
    zr = dict(np.load(path_r))
    if res_r["timings"]["draws_run"] != D2 - HALF or zr["mu"].shape[1] != (
            D2 - HALF):
        fail(f"resume ran {res_r['timings']['draws_run']} draws, not "
             f"{D2 - HALF}")
    gaps = {k: float(np.abs(zr["__full_rhat__." + k] - v).max())
            for k, v in rh_a.items()}
    bitwise = all(np.array_equal(zr["__full_rhat__." + k], v)
                  for k, v in rh_a.items()) and all(
        np.array_equal(zr[k], za[k][:, HALF:]) for k in
        ("mu", "log_tau", "beta", "group_loglik"))
    say(f"cli resume from {checkpoint_tag('sample', HALF)}: {D2 - HALF} "
        f"draws in "
        f"{sec_b:.1f} s (load {1e3 * res_r['timings']['resume_s']:.1f} ms, "
        f"setup {1e3 * res_r['timings']['setup_s']:.1f} ms); finalized "
        f"all-parameter R-hat vs the uninterrupted run: max |diff| {gaps} "
        f"(tol 1e-5); bitwise {bitwise}")
    if not all(g <= 1e-5 for g in gaps.values()):
        fail("the resumed run's all-parameter R-hat differs")

    # checkpoint write and load at judged: the frozen (C, G, 10) packed
    # Hessian and the accumulators
    jm, jdata, jcfg = get_preset("judged", device=dev)
    jcarry = checkpoint_template(jm, jcfg, jdata, with_acc=True)
    jdir = os.path.join(tmp, "ck_judged")
    t0 = time.perf_counter()
    save_checkpoint(jdir, "sample_000002048", jcarry, {"phase": "sample"})
    j_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_checkpoint(jdir, "sample_000002048", jcarry)
    torch.cuda.synchronize()
    j_load = time.perf_counter() - t0
    j_mb = os.path.getsize(os.path.join(
        jdir, "carry_sample_000002048.npz")) / 1e6
    say(f"checkpoint at judged (C=1024, G=1000, p=4, with accumulators): "
        f"{j_mb:.1f} MB, write {1e3 * j_save:.1f} ms, load "
        f"{1e3 * j_load:.1f} ms")
    del jm, jdata, jcarry
    torch.cuda.empty_cache()

    # (c) the RW preset on the same data, then compare (both methods)
    rw_sched = ["--warmup", "1500", "--draws", "4096"]
    if left_s() < 150.0:
        rw_sched = ["--warmup", "500", "--draws", "1024"]
        say(f"CUT the cli RW run to warmup 500, draws 1024: {left_s():.0f} "
            "s left")
    Wr, Dr = int(rw_sched[1]), int(rw_sched[3])
    cli_run("run hier-logistic-100-rw", [
        "run", "--preset", "hier-logistic-100-rw", "--collect",
        "group_loglik", "--save-draws", path_b, "--metric-json", "--quiet",
        *rw_sched],
        {"rwmh_step": Wr + Dr, "loglik": Wr + 2 * Dr + 1})
    for method in ("loo", "waic"):
        line, sec = cli_run(f"compare --method {method}", [
            "compare", path_a, path_b, "--method", method], {})
        rows = json.loads(line)
        if len(rows) != 2 or not all(math.isfinite(r["elpd"])
                                     for r in rows):
            fail(f"compare {method}: {rows}")

    # (d) config 3's subject_loglik (pois_loglik) and group_loglik at one
    # position, card vs the CPU's plain version, timed as a pois_loglik
    # cell
    C, S, N, P = POIS
    pm, pd3, _ = get_preset("nested-poisson-1k", device=dev)
    cm, cd3, _ = get_preset("nested-poisson-1k", device="cpu")
    ppos = pm.init_state(SweepRNG(5, dev), pd3, C)
    cpos = {k: v.cpu() for k, v in ppos.items()}
    errs = {}
    for name in ("subject_loglik", "group_loglik"):
        out = pm.derived[name](ppos).cpu()
        errs[name] = max_err(out, cm.derived[name](cpos), 1e-4)
    ok = all(o for _, o in errs.values())
    ms = timed(lambda: pm.derived["subject_loglik"](ppos))
    const = loglik.poisson_const(pd3.y, pd3.mask)
    pms = timed(lambda: loglik.poisson_loglik_padded(
        ppos["beta_s"], pd3.x, pd3.y, pd3.mask, const))
    w = work("pois_loglik", C, S, N, P)
    say(f"config 3 subject_loglik / group_loglik [C={C} S={S} n={N} p={P}] "
        f"card vs CPU plain: max_abs_err "
        + ", ".join(f"{k} {e:.3e}" for k, (e, _) in errs.items())
        + f" (tol 1e-3 + 1e-4|ref|) {'ok' if ok else 'FAIL'}; "
        f"subject_loglik {ms:.4f} ms, plain on the card {pms:.4f} ms; "
        f"{bound_str(w)}")
    if not ok:
        fail("config 3's per-unit logliks disagree with the CPU")
    cell("pois_loglik", POIS, errs["subject_loglik"][0], ms, pms, w,
         "full width", via="subject_loglik")
    del pm, pd3, cm, cd3, ppos, cpos

    # (e) the module entry point in its own process
    r = subprocess.run([sys.executable, "-m", "nestmc_torch",
                        "list-presets"], capture_output=True, text=True,
                       timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    names = [ln.split()[0] for ln in r.stdout.splitlines() if ln.strip()]
    say(f"python -m nestmc_torch list-presets: rc {r.returncode}, "
        f"{len(names)} presets")
    if r.returncode != 0 or len(names) != 16:
        fail(f"python -m nestmc_torch list-presets: {r.stderr[-2000:]}")
    shutil.rmtree(tmp, ignore_errors=True)
    say(f"phase 7 (the command line) took {time.perf_counter() - t7:.1f} s")

    # ---- 8. the hierarchical GLM, posterior-predictive checks, the CSV
    # loader (models/hier_glm.py, predictive.py, io/), on the card ----
    from nestmc_torch import posterior_predictive, predictive_pvalue
    from nestmc_torch.io import load_csv
    from nestmc_torch.io.build import native_lib
    from nestmc_torch.io.loaders import _load_csv_native, _load_csv_python
    from nestmc_torch.models import make_hier_glm, synth_glm

    t8 = time.perf_counter()
    tmp8 = tempfile.mkdtemp(prefix="nestmc_smoke8_")

    def glm_cfg(chains, collect, **kernel):
        return SamplerConfig(
            kernel=KernelConfig(algorithm="newton", **kernel),
            run=RunConfig(chains=chains, seed=0, full_rhat=True,
                          collect=collect, log_every_segment=False))

    def glm_runner(model, data, cfg, label, title):
        return lambda **kw: bench.measure(model, data, cfg, label, title,
                                          **kw)

    # (a) binomial at config 2's width: the logistic delegate on the
    # reweighted data (mask = trials, y = successes / trials), frozen
    # Newton at config 2's schedule; beta is collected in full for (d)
    bdata, _ = synth_glm(0, "binomial", G=100, n=50, p=4, trials=10,
                         device=dev)
    bmodel = make_hier_glm(bdata, family="binomial", tau_prior="invgamma")
    xw, yw, mw = bdata.x, bdata.y / 10.0, bdata.mask * 10.0
    log_binom = torch.sum(
        torch.lgamma(bdata.extra["trials"] + 1.0)
        - torch.lgamma(bdata.y + 1.0)
        - torch.lgamma(bdata.extra["trials"] - bdata.y + 1.0), dim=-1)

    def check_binomial(post):
        D = post.draws["beta"].shape[1]
        gll = post.draws["group_loglik"]
        errs = []
        for j in (0, 1, D // 2, D - 1):
            ref = loglik.logistic_loglik_padded(
                post.draws["beta"][:, j].contiguous(), xw, yw, mw
            ) + log_binom[None, :]
            errs.append(max_err(gll[:, j], ref, 1e-4))
        err, ok = max(e for e, _ in errs), all(o for _, o in errs)
        say(f"hier_glm binomial: group_loglik of draws 0, 1, {D // 2}, "
            f"{D - 1} vs the plain pass on (y/m, mask m) plus the log "
            f"binomial coefficient: max_abs_err {err:.3e} (tol 1e-3 + "
            f"1e-4|ref|) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("hier_glm binomial group_loglik disagrees with the plain "
                 "pass")
        record("loglik", err)
        # (d) posterior-predictive replicates of (a)'s draws
        reset_launch_counts()
        t0 = time.perf_counter()
        y_rep = posterior_predictive(bmodel, post, bdata, SweepRNG(8, dev),
                                     num=64)
        pval = float(predictive_pvalue(y_rep, bdata))
        torch.cuda.synchronize()
        pp_s = time.perf_counter() - t0
        ok = (tuple(y_rep.shape) == (64, 100, 50)
              and bool(((y_rep >= 0) & (y_rep <= 10)).all())
              and bool((y_rep == torch.round(y_rep)).all())
              and 0.02 < pval < 0.98 and not any(launch_counts().values()))
        say(f"posterior_predictive on the binomial draws: {tuple(y_rep.shape)}"
            f" replicates in [{float(y_rep.min()):.0f}, "
            f"{float(y_rep.max()):.0f}] (trials 10), masked-mean p-value "
            f"{pval:.3f} (in (0.02, 0.98)), {1e3 * pp_s:.1f} ms with the "
            f"p-value, launches {launch_counts()} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("posterior_predictive on the binomial draws")

    newton_gl = {**newton_path, "loglik": lambda W, D: D}
    run_path("hier_glm binomial", newton_gl, "beta", (0.5, 1.0),
             lambda D: {"mu": (64, D, 4), "log_tau": (64, D, 4),
                        "beta": (64, D, 100, 4),
                        "group_loglik": (64, D, 100)},
             warmup=750, draws=2048, full_rhat=True,
             runner=glm_runner(bmodel, bdata, glm_cfg(64, {
                 "mu": None, "log_tau": None, "beta": None,
                 "group_loglik": None}), "hier_glm binomial",
                 "G=100 binomial hierarchical GLM, trials 10, 64 chains, "
                 "frozen Newton on the logistic kernels"),
             check=check_binomial)
    del bdata, bmodel, xw, yw, mw, log_binom

    # (b) poisson at config 3's unit width: the fused Poisson steps with mu
    # broadcast as the per-group prior mean. Newton-MH's parameter-free
    # Laplace proposal traps a chain whose group starts far in its tail
    # (the reverse proposal's density is too small ever to accept; the
    # reference's Newton path traps the same groups): its launches are
    # asserted, its R-hat and trapped units printed; MALA, whose scales
    # adapt per unit, carries the gate at config 3's 16384 draws (2048
    # left its slowest groups at R-hat 1.03)
    pdata, _ = synth_glm(0, "poisson", G=4000, n=10, p=3, device=dev)
    pmodel = make_hier_glm(pdata, family="poisson", tau_prior="invgamma")
    pshapes = (lambda D: {"mu": (512, D, 3), "log_tau": (512, D, 3),
                          "beta": (512, D, 8, 3)})
    pcollect = {"mu": None, "log_tau": None, "beta": 8}

    def trapped(post):
        acc = post.accept_rates["beta"]
        stuck = acc < 0.01
        groups = sorted(set(stuck.nonzero()[:, 1].tolist()))
        say(f"hier_glm poisson newton: {int(stuck.sum())} of {acc.numel()} "
            f"(chain, group) units accept < 0.01 in sampling, in "
            f"{len(groups)} groups (first {groups[:10]})")

    run_path("hier_glm poisson newton",
             {"pois_newton_step_refresh": lambda W, D: W,
              "pois_newton_step_frozen": lambda W, D: D,
              "pois_logp_grad_hess": lambda W, D: W + 1,
              "pois_logp_grad": lambda W, D: D},
             "beta", (0.5, 1.0), pshapes, warmup=500, draws=1024,
             full_rhat=True, gate=False, why="Laplace-proposal traps",
             runner=glm_runner(pmodel, pdata, glm_cfg(512, pcollect),
                               "hier_glm poisson newton",
                               "G=4000 poisson hierarchical GLM, 512 chains, "
                               "frozen Newton on the Poisson kernels"),
             check=trapped)
    run_path("hier_glm poisson mala",
             {"pois_mala_step": lambda W, D: W + D,
              "pois_logp_grad": lambda W, D: W + D + 1},
             "beta", (0.3, 0.9), pshapes, warmup=2000, draws=16384,
             full_rhat=True,
             runner=glm_runner(pmodel, pdata, dataclasses.replace(
                 glm_cfg(512, pcollect),
                 kernel=KernelConfig(algorithm="mala")),
                 "hier_glm poisson mala", "G=4000 poisson hierarchical "
                 "GLM, 512 chains, MALA on the Poisson kernels"))
    del pdata, pmodel
    torch.cuda.empty_cache()

    # (c) gaussian and negbin at config 2's width: plain PyTorch (their
    # likelihoods read the aux block), Newton on the zero-self split
    for family, aux, true_aux in (("gaussian", "log_sigma", math.log(0.7)),
                                  ("negbin", "log_r", math.log(5.0))):
        gdata, gtruth = synth_glm(0, family, G=100, n=50, p=4, device=dev)

        def check_aux(post, aux=aux, true_aux=true_aux, gtruth=gtruth,
                      family=family):
            d8 = post.diagnostics()
            gaps = {}
            for name, truth in (("mu", torch.tensor(gtruth["mu"])),
                                (aux, torch.tensor(true_aux))):
                m = d8[name]["mean"].cpu().double()
                sd = post.draws[name].double().std().cpu() if name == aux \
                    else post.draws[name].double().flatten(0, 1).std(0).cpu()
                gaps[name] = float(((m - truth).abs() / sd).max())
            acc = float(post.accept_rates[aux].mean())
            ok = all(g < 4.0 for g in gaps.values())
            say(f"hier_glm {family}: posterior mean vs synth_glm's truth, "
                f"max |mean - truth| / posterior sd: "
                + ", ".join(f"{k} {v:.2f}" for k, v in gaps.items())
                + f" (< 4); {aux} acceptance {acc:.3f} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"hier_glm {family} misses the truth")

        run_path(f"hier_glm {family}",
                 {"philox_fill": lambda W, D: 2 * (W + D)}, "beta",
                 (0.5, 1.01),
                 lambda D, aux=aux: {"mu": (64, D, 4), "log_tau": (64, D, 4),
                                     aux: (64, D), "beta": (64, D, 8, 4)},
                 warmup=500, draws=1024, full_rhat=True,
                 runner=glm_runner(
                     make_hier_glm(gdata, family=family, tau_prior="invgamma"),
                     gdata, glm_cfg(64, {"mu": None, "log_tau": None,
                                         aux: None, "beta": 8}),
                     f"hier_glm {family}", f"G=100 {family} hierarchical "
                     "GLM, 64 chains, Newton on the zero-self split, plain "
                     "PyTorch"),
                 check=check_aux)
        del gdata

    # (e) a CSV of ragged-10k's seed-0 data through load_csv: the native
    # parser and the numpy path give the arrays of from_numpy_ragged; then
    # 50 sweeps of config 4's bucket-route Newton on the loaded data
    rmodel, rdata, rcfg = get_preset("ragged-10k", device=dev)
    del rmodel
    seg_np = rdata.segment_ids.cpu().numpy()
    cols = np.column_stack([seg_np.astype(np.float64),
                            rdata.y.cpu().numpy().astype(np.float64),
                            rdata.x.cpu().numpy().astype(np.float64)])
    csv = os.path.join(tmp8, "ragged10k.csv")
    t0 = time.perf_counter()
    # 17 significant digits of the float32 values: exact after parsing
    np.savetxt(csv, cols, delimiter=",",
               fmt=["%d"] + ["%.17g"] * (cols.shape[1] - 1))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if native_lib() is None:
        from nestmc_torch.io.build import build_error
        fail(f"the native CSV parser did not build: {build_error()}")
    build_s = time.perf_counter() - t0

    def parse(native):
        t0 = time.perf_counter()
        out = load_csv(csv, native=native, device=dev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    loaded, native_s = parse(True)
    native_s = min([native_s] + [parse(True)[1] for _ in range(2)])
    by_numpy, numpy_s = parse(False)
    # the host parse alone (no tensors built), each parser
    t0 = time.perf_counter()
    _load_csv_native(csv)
    parse_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _load_csv_python(csv)
    parse_numpy_s = time.perf_counter() - t0
    same = all(
        a.num_groups == rdata.num_groups
        and all(torch.equal(getattr(a, k), getattr(rdata, k))
                for k in ("y", "x", "segment_ids", "offsets"))
        for a in (loaded, by_numpy))
    mb = os.path.getsize(csv) / 1e6
    say(f"load_csv of ragged-10k's data ({loaded.num_obs} rows, "
        f"{loaded.num_groups} groups, p={loaded.num_covariates}; {mb:.1f} MB"
        f" written in {write_s:.2f} s): load_csv to the card, native parser"
        f" {1e3 * native_s:.1f} ms (best of 3; g++ build or load "
        f"{build_s:.2f} s), numpy path {1e3 * numpy_s:.1f} ms; the host "
        f"parse alone {1e3 * parse_native_s:.1f} ms native, "
        f"{1e3 * parse_numpy_s:.1f} ms numpy; arrays equal "
        f"from_numpy_ragged's {'ok' if same else 'FAIL'}")
    if not same:
        fail("load_csv's arrays differ from the data written")
    B8 = len(bucket.BucketLayout.build(loaded.segment_ids,
                                       loaded.num_groups).buckets)
    run_path("ragged-10k from CSV",
             {"newton_step_refresh": lambda W, D: B8 * W,
              "newton_step_frozen": lambda W, D: B8 * D,
              "logp_grad_hess": lambda W, D: B8 * (W + 1),
              "logp_grad": lambda W, D: B8 * D, **ASIS},
             "beta", (0.5, 1.0), logistic_shapes(1024, 3, 8),
             warmup=20, draws=30, gate=False,
             runner=glm_runner(
                 make_hier_logistic(loaded, tau_prior="invgamma"), loaded,
                 rcfg, "ragged-10k from CSV", "ragged-10k's data loaded "
                 "from CSV, bucket-route Newton"))
    del rdata, loaded, by_numpy, cols, seg_np
    shutil.rmtree(tmp8, ignore_errors=True)
    torch.cuda.empty_cache()
    say(f"phase 8 (hier_glm, predictive, CSV) took "
        f"{time.perf_counter() - t8:.1f} s")

    # ---- 9. the user-model toolkit and the data layer's converters ----
    from nestmc_torch import distributions as dist
    from nestmc_torch import transforms
    from nestmc_torch.data import NestedData, NestedData3, RaggedData
    from nestmc_torch.model import Block, ModelSpec, vmap_chains

    t9 = time.perf_counter()

    def same(label, pairs):
        """Fail unless each (ours, theirs) pair has one shape, dtype and
        the same bits."""
        bad = [k for k, (a, b) in pairs.items()
               if a.shape != b.shape or a.dtype != b.dtype
               or not torch.equal(a, b)]
        say(f"{label}: {', '.join(pairs)} "
            f"{'equal' if not bad else 'DIFFER in ' + ', '.join(bad)}")
        if bad:
            fail(f"{label}: {bad} differ")

    def host_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    # (a) the converters at full width. Config 4's seed-0 data (the
    # ragged-10k preset's) split into per-group lists and rebuilt
    G4 = 10_000
    rdata, _ = synth_logistic(4000, G=G4, n=30, p=3, ragged=True,
                              device=dev)
    off = rdata.offsets.cpu().numpy()
    yn, xn = rdata.y.cpu().numpy(), rdata.x.cpu().numpy()
    ys = [yn[off[g]:off[g + 1]] for g in range(G4)]
    xs = [xn[off[g]:off[g + 1]] for g in range(G4)]
    rr, ms_rr = host_ms(lambda: RaggedData.from_ragged(ys, xs, device=dev))
    nd, ms_nd = host_ms(lambda: NestedData.from_ragged(ys, xs, max_obs=30,
                                                       device=dev))
    back, ms_back = host_ms(nd.to_ragged)
    fields = ("y", "x", "segment_ids", "offsets")
    same(f"9a RaggedData.from_ragged ({ms_rr:.1f} ms) vs from_numpy_ragged"
         f" on config 4's seed-0 data (N={rdata.num_obs})",
         {k: (getattr(rr, k), getattr(rdata, k)) for k in fields})
    same(f"9a NestedData.from_ragged(max_obs=30) ({ms_nd:.1f} ms) -> "
         f"to_ragged() ({ms_back:.1f} ms) vs from_numpy_ragged",
         {k: (getattr(back, k), getattr(rdata, k)) for k in fields})
    gen9 = torch.Generator(device=dev).manual_seed(9)
    beta = 0.5 * torch.randn(1024, G4, 3, generator=gen9, device=dev)
    a = logistic_loglik(beta, nd.x, nd.y, nd.mask)
    b = logistic_loglik_segment(beta, back.x, back.y, SegmentLayout.build(
        back.segment_ids, back.num_groups))
    dd = (a - b).abs()
    ok = bool((dd <= 2e-5 + 2e-5 * b.abs()).all())
    say(f"9a loglik kernel on the padded form (1024, {G4}, 30, 3) vs the "
        f"seg_loglik kernel on the ragged form: max |a-b| "
        f"{float(dd.max()):.3e} (|a-b| <= 2e-5 + 2e-5|b|) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the padded and segment logliks disagree through the "
             "converters")
    del rdata, rr, nd, back, beta, a, b, dd, ys, xs

    # the judged data padded to 1024 groups: the obs passes on the padded
    # data against the unpadded ones on the 1000 real groups (cells are
    # independent: the same bits expected), exactly 0 on the 24 padded
    # groups, and one Newton refresh there without a NaN
    C9, P9 = 1024, 4
    jd9, _ = synth_logistic(2000, G=1000, n=50, p=P9, device=dev)
    jp9 = jd9.pad_groups_to(1024)
    if bool(jp9.mask[1000:].any()) or bool(jp9.sizes[1000:].any()):
        fail("pad_groups_to left a padded group with observations")
    beta = 0.5 * torch.randn(C9, 1024, P9, generator=gen9, device=dev)
    for name, fn in (("loglik", logistic_loglik),
                     ("logp_grad", logistic_logp_grad),
                     ("logp_grad_hess", logistic_logp_grad_hess)):
        full = fn(beta, jp9.x, jp9.y, jp9.mask)
        part = fn(beta[:, :1000].contiguous(), jd9.x, jd9.y, jd9.mask)
        full = full if isinstance(full, tuple) else (full,)
        part = part if isinstance(part, tuple) else (part,)
        errs = [max_err(f[:, :1000], q, 1e-4) for f, q in zip(full, part)]
        bitwise = all(torch.equal(f[:, :1000], q)
                      for f, q in zip(full, part))
        zero = all(float(f[:, 1000:].abs().max()) == 0.0 for f in full)
        err, ok = max(e for e, _ in errs), all(o for _, o in errs)
        say(f"9a pad_groups_to(1024) on the judged data, {name}: the 1000 "
            f"real groups {'bitwise equal to' if bitwise else 'NOT bitwise'}"
            f" the unpadded kernel's (max |diff| {err:.3e}); the 24 padded "
            f"groups exactly 0: {zero} {'ok' if ok and zero else 'FAIL'}")
        if not (ok and zero):
            fail(f"{name} on the padded judged data")
    v, g, h = logistic_logp_grad_hess(beta, jp9.x, jp9.y, jp9.mask)
    mu9 = 0.3 * torch.randn(C9, P9, generator=gen9, device=dev)
    lt9 = -0.7 + 0.2 * torch.randn(C9, P9, generator=gen9, device=dev)
    out = fused_newton_logistic_step(
        beta, v, g, h, torch.zeros(C9, 1, device=dev), mu9, lt9, jp9.x,
        jp9.y, jp9.mask, rng=SweepRNG(9, dev))
    finite = all(bool(torch.isfinite(t).all()) for t in out)
    acc_pad = float(out[4][:, 1000:].mean())
    say(f"9a newton_step refresh on the padded judged data: finite "
        f"{finite}; mean alpha of the padded groups {acc_pad:.4f} (their "
        "proposal is the prior's exact conditional)")
    if not finite:
        fail("newton_step on the padded judged data gave a NaN")
    del jd9, jp9, beta, v, g, h, out

    # config 3's seed-0 data as ys[g][s] lists, and a case with unequal
    # subjects per group
    pd3, _ = synth_poisson3(3000, G=1000, subjects_per_group=4, n=10, p=3,
                            device=dev)
    yn, xn = pd3.y.cpu().numpy(), pd3.x.cpu().numpy()
    keep = pd3.mask.cpu().numpy() > 0.5
    ys3, xs3 = [[] for _ in range(1000)], [[] for _ in range(1000)]
    for s_, g_ in enumerate(pd3.subject_group.cpu().tolist()):
        ys3[g_].append(yn[s_][keep[s_]])
        xs3[g_].append(xn[s_][keep[s_]])
    d3, ms_d3 = host_ms(lambda: NestedData3.from_ragged(ys3, xs3,
                                                        device=dev))
    same(f"9a NestedData3.from_ragged ({ms_d3:.1f} ms) vs from_numpy3 on "
         "config 3's seed-0 data",
         {k: (getattr(d3, k), getattr(pd3, k))
          for k in ("y", "mask", "x", "subject_group", "subject_counts")})
    if d3.members is not None or pd3.members is not None or not bool(
            (d3.subjects_per_group() == 4).all()):
        fail("config 3's groups of 4 subjects: members or subject counts")
    bs = 0.3 * torch.randn(512, d3.num_subjects, 3, generator=gen9,
                           device=dev)
    same("9a pois_loglik on NestedData3.from_ragged's data vs from_numpy3's",
         {"pois_loglik": (pois.poisson_loglik(bs, d3.x, d3.y, d3.mask),
                          pois.poisson_loglik(bs, pd3.x, pd3.y, pd3.mask))})
    r9 = np.random.default_rng(5)
    counts = [2, 0, 4, 1, 3]
    ysu = [[r9.poisson(2.0, size=int(r9.integers(1, 11))).astype(np.float32)
            for _ in range(c)] for c in counts]
    xsu = [[r9.normal(size=(len(y_), 3)) for y_ in grp] for grp in ysu]
    du = NestedData3.from_ragged(ysu, xsu, device=dev)
    sums = du.group_sum(torch.ones(2, du.num_subjects, device=dev))
    ok = (du.members is not None
          and du.subjects_per_group().tolist() == counts
          and sums.tolist() == [[float(c) for c in counts]] * 2)
    say(f"9a NestedData3.from_ragged with subjects per group {counts}: "
        f"members built {du.members is not None}, subjects_per_group "
        f"{du.subjects_per_group().tolist()}, group_sum of ones "
        f"{sums[0].tolist()} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("NestedData3.from_ragged with unequal subjects per group")
    del pd3, d3, bs, ys3, xs3
    torch.cuda.empty_cache()
    t9a = time.perf_counter() - t9

    # (b) a user's model: the hierarchical logistic written for ONE chain
    # with nestmc_torch.distributions and transforms (make_hier_logistic's
    # defaults: mu ~ N(0, 5), tau ~ HalfNormal(2) on the log transform with
    # its log-Jacobian and the log-scale guard), lifted by vmap_chains, at
    # config 2's width on the generic MALA path: no kernel of the port,
    # and its posterior of mu and tau against the built-in model's RW run
    # of phase 6 on the same data. The centred user model has no
    # interweaving move; 600/1200 sweeps (about 10-16 ms each, host-paced)
    # keep the phase near a minute, and its R-hat is printed, not gated
    def user_hier_logistic(G, p, mu_scale=5.0, tau_scale=2.0):
        lt_tr = transforms.log_transform

        def gprior(s):
            tau = lt_tr.forward(s["log_tau"])
            return torch.sum(dist.logpdf_normal(s["beta"], s["mu"], tau),
                             dim=-1)                            # (G,)

        def cond(name, value, state, data):
            s = {**state, name: value}
            if name == "beta":
                eta = torch.einsum("gnp,gp->gn", data.x, s["beta"])
                lik = dist.logpmf_bernoulli_logit(data.y, eta) * data.mask
                return torch.sum(lik, dim=-1) + gprior(s)
            if name == "mu":
                return torch.sum(gprior(s)) + torch.sum(
                    dist.logpdf_normal(s["mu"], 0.0, mu_scale))
            lt = s["log_tau"]
            return torch.sum(gprior(s)) + torch.sum(
                dist.logpdf_halfnormal(lt_tr.forward(lt), tau_scale)
                + lt_tr.log_jac(lt) + dist.log_scale_guard(lt))

        def init_state(rng, data, chains):
            return {"beta": 0.5 * rng.normal((G, p)),
                    "mu": 0.5 * rng.normal((p,)),
                    "log_tau": -1.0 + 0.2 * rng.normal((p,))}

        return vmap_chains(ModelSpec(
            name="user hier logistic",
            blocks=(Block("beta", (G, p), units=G, init_scale=0.3),
                    Block("mu", (p,), init_scale=0.1),
                    Block("log_tau", (p,), init_scale=0.1)),
            cond_logdensity=cond, init_state=init_state))

    UW, UD = 600, 1200
    udata, _ = synth_logistic(1000, G=100, n=50, p=4, device=dev)
    reset_launch_counts()
    upost = sample(user_hier_logistic(100, 4), udata, SamplerConfig(
        kernel=KernelConfig(algorithm="mala"),
        run=RunConfig(chains=64, warmup=UW, draws=UD, seed=0,
                      full_rhat=True, log_every_segment=False)))
    torch.cuda.synchronize()
    ulaunch = launch_counts()
    u_ms = 1e3 * (upost.timings["warmup_s"] + upost.timings["sample_s"]) / (
        UW + UD)
    us = mu_tau_stats(upost)
    z = {k: float(((us[k][0] - rw_ref[k][0]).abs() / torch.sqrt(
        us[k][1] ** 2 + rw_ref[k][1] ** 2)).max()) for k in us}
    # beta's MALA noise on the lifted unit axis: two fills a sweep, no
    # other kernel
    uwant = {k: 0 for k in ulaunch}
    uwant["philox_fill"] = 2 * (UW + UD)
    ok = ulaunch == uwant and max(z.values()) < 5.0
    launches_total["philox_fill"] = (launches_total.get("philox_fill", 0)
                                     + ulaunch["philox_fill"])
    uacc = {k: round(float(v.mean()), 4)
            for k, v in upost.accept_rates.items()}
    say(f"9b user model (vmap_chains, MALA, 64 chains, {UW}/{UD}) at "
        f"config 2's width: {u_ms:.2f} ms a sweep on '{smi}'; launches "
        f"{ {k: n for k, n in ulaunch.items() if n} } (must be "
        f"{2 * (UW + UD)} philox_fill alone); worst R-hat "
        f"{upost.worst_rhat():.5f} (printed, not asserted) at "
        f"{upost.worst_rhat_at()}; acceptance {uacc}")
    for k in us:
        say(f"9b {k}: user {[round(x, 4) for x in us[k][0].tolist()]} vs "
            f"built-in RW {[round(x, 4) for x in rw_ref[k][0].tolist()]}, "
            f"max |diff| / combined MCSE {z[k]:.2f} (< 5)")
    if not ok:
        fail("the user model launched another kernel than the fill or "
             "disagrees with the built-in model")
    del upost, udata
    t9b = time.perf_counter() - t9 - t9a

    # (c) same seed, same bits on the card: config 2 (frozen Newton with
    # the R-hat fold in the step kernel) and config 4's segment route
    # (MALA on the segment kernels), each twice at seed 0 and once at 1
    def det_check(label, build, sched, expect):
        model, data, cfg = build()
        runs = []
        for seed in (0, 0, 1):
            cfg_s = dataclasses.replace(cfg, run=dataclasses.replace(
                cfg.run, warmup=sched[0], draws=sched[1], seed=seed,
                log_every_segment=False))
            reset_launch_counts()
            post = sample(model, data, cfg_s)
            torch.cuda.synchronize()
            launches = launch_counts()
            want = {k: 0 for k in launches}
            want.update({k: f(*sched) for k, f in expect.items()})
            if launches != want:
                fail(f"9c {label}: launches {launches} != {want}")
            for k, nl in launches.items():
                launches_total[k] = launches_total.get(k, 0) + nl
            runs.append(post)
        a, b, c = runs
        differ = [k for k in a.draws if not torch.equal(a.draws[k],
                                                        b.draws[k])]
        differ += [f"full_rhat {k}" for k in (a.full_rhat or {})
                   if not torch.equal(a.full_rhat[k], b.full_rhat[k])]
        moved = not torch.equal(a.draws["mu"], c.draws["mu"])
        say(f"9c {label} {sched[0]}/{sched[1]}: two runs at seed 0 "
            f"{'bitwise equal' if not differ else 'DIFFER in ' + str(differ)}"
            f" over {', '.join(a.draws)}; seed 1 moves mu: {moved}; "
            f"launches a run {({k: n for k, n in want.items() if n})}")
        if differ or not moved:
            fail(f"9c {label}: same seed, other bits, or seed ignored")

    det_check("hier-logistic-100 (config 2)",
              lambda: get_preset("hier-logistic-100", device=dev),
              (150, 200), newton_path)

    def seg_build():
        _, data, cfg = get_preset("ragged-10k-mala", device=dev)
        return (make_hier_logistic(data, loglik_impl="pallas-segment"),
                data, cfg)

    det_check("ragged-10k pallas-segment mala", seg_build, (80, 100),
              {"seg_logp_grad": lambda W, D: 1 + 2 * (W + D),
               "philox_fill": lambda W, D: 2 * (W + D), **ASIS})

    # the plain segment sum (the segment route's Hessian pass and every
    # segment kernel's plain version) at config 4's shape: the segmented
    # reduction repeats its bits; the float scatter-add it replaced is
    # shown for comparison (its atomics add in another order each run)
    sd, _ = synth_logistic(4000, G=G4, n=30, p=3, ragged=True, device=dev)
    vals = torch.randn(1024, sd.num_obs, generator=gen9, device=dev)

    def scatter_sum():
        return torch.zeros(1024, G4, device=dev).index_add_(
            1, sd.segment_ids, vals)

    def seg_sum():
        return loglik._segsum(vals, sd.segment_ids, G4)

    distinct = {}
    for name, fn in (("segment_reduce", seg_sum),
                     ("index_add_", scatter_sum)):
        distinct[name] = len({fn().cpu().numpy().tobytes()
                              for _ in range(10)})
    err = float((seg_sum() - scatter_sum()).abs().max())
    say(f"9c plain segment sum (1024, {sd.num_obs}) -> (1024, {G4}): "
        f"segment_reduce {distinct['segment_reduce']} distinct result(s) "
        f"of 10, {timed(seg_sum):.4f} ms; index_add_ (replaced) "
        f"{distinct['index_add_']} of 10, {timed(scatter_sum):.4f} ms; max "
        f"|diff| {err:.3e}")
    if distinct["segment_reduce"] != 1 or err > 1e-3:
        fail("the plain segment sum is not deterministic on the card")
    del sd, vals
    torch.cuda.empty_cache()
    t9c = time.perf_counter() - t9 - t9a - t9b

    # (d) simulation-based calibration on the card, tests/test_sbc.py's
    # sizes: C = 512 replicas as chains, each with its own data set, G=4,
    # N=3, L=127 draws thinned by 4; the true value's rank among each
    # replica's draws is uniform for a correct sampler (chi-square on 8
    # bins, p > 1e-3), and the posterior must contract below the prior
    from scipy import stats as st

    cmodel, sample_y = calibration_model(4, 3)
    for seed, warmup in ((42, 500), (43, 300)):
        truth = cmodel.prior_sample(SweepRNG(seed, dev), None, 512)
        cdata = {"y": sample_y(SweepRNG(seed + 1000, dev), truth["theta"])}
        reset_launch_counts()
        cpost = sample(cmodel, cdata, SamplerConfig(run=RunConfig(
            chains=512, warmup=warmup, draws=127, thin=4, seed=seed - 35,
            log_every_segment=False)))
        if any(launch_counts().values()):
            fail(f"9d the calibration model launched {launch_counts()}")
        pvals = {}
        for name, dr, tr in (
                ("mu", cpost.draws["mu"], truth["mu"]),
                ("log_tau", cpost.draws["log_tau"], truth["log_tau"]),
                ("theta[0]", cpost.draws["theta"][:, :, 0],
                 truth["theta"][:, 0])):
            ranks = torch.sum(dr < tr[:, None], dim=1).cpu().numpy()
            counts = np.bincount((ranks / 16).astype(int), minlength=8)[:8]
            chi2 = float(((counts - 64.0) ** 2 / 64.0).sum())
            pvals[name] = float(st.chi2.sf(chi2, 7))
        post_sd = float(cpost.draws["theta"][:, :, 0].std(dim=1).mean())
        prior_sd = float(truth["theta"][:, 0].std())
        ok = (min(pvals.values()) > 1e-3 if seed == 42
              else post_sd < 0.6 * prior_sd)
        pv = {k: round(v, 4) for k, v in pvals.items()}
        say(f"9d SBC seed {seed} ({warmup}/127 thinned by 4, 512 replicas; "
            f"{cpost.timings['warmup_s'] + cpost.timings['sample_s']:.1f} "
            f"s): rank chi-square p {pv} (> 1e-3 asserted at seed 42); "
            f"posterior sd of theta[0] "
            f"{post_sd:.3f} vs prior {prior_sd:.3f} (< 0.6x asserted at "
            f"seed 43) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"9d SBC at seed {seed}")
    t9d = time.perf_counter() - t9 - t9a - t9b - t9c
    say(f"phase 9 (converters, user model, determinism, SBC) took "
        f"{time.perf_counter() - t9:.1f} s: 9a {t9a:.1f}, 9b {t9b:.1f}, "
        f"9c {t9c:.1f}, 9d {t9d:.1f}")

    # ---- 10. sharding on the card ----
    launches10, fill = phase10(dev, smi)
    for k, nl in launches10.items():
        launches_total[k] = launches_total.get(k, 0) + nl
    record("philox_fill", fill["err"], fill["ms"], fill["plain_ms"],
           fill["shape"], fill["work"])
    kernels["philox_fill"]["library_ms"] = fill["library_ms"]

    # ---- 6, continued: the paths cut to the time left ----
    full, p_full, s_full = (1500, 4096), (1000, 16384), (800, 2048)
    j_min, p_min, s_min = (150, 256), (300, 256), (100, 256)
    m_min = (300, 256)
    s_rw = (200, 200)           # the segment RW path: short, R-hat printed
    seg_mala = segment_runner("mala")
    est = {k: per_sweep(k) for k in ("mala-100k", "judged",
                                     "nested-poisson-1k-mala",
                                     "nested-poisson-1k-newton")}
    est["segment"] = per_sweep(None, seg_mala)
    variants = ("nested-poisson-1k-mala", "nested-poisson-1k-newton")

    def need_seg(sched):
        # the RW path: about the MALA one's cost a sweep
        return need_s(est["segment"], sched) + need_s(est["segment"], s_rw)

    need_least = (need_s(est["mala-100k"], m_min)
                  + need_s(est["judged"], j_min)
                  + sum(need_s(est[v], p_min) for v in variants)
                  + need_seg(s_min))
    say(f"the cut paths start {BUDGET_S - left_s():.1f} s in, "
        f"{left_s():.0f} s left; their least schedules need ~"
        f"{need_least:.0f} s; estimated ms a sweep (s of set-up): "
        + ", ".join(f"{k} {1e3 * v[0]:.1f} ({v[1]:.1f})"
                    for k, v in est.items()))

    need_m = need_s(est["mala-100k"], full)
    spare = (left_s() - (BUDGET_S - TARGET_S) - 15.0 - need_m
             - need_s(est["judged"], j_min)
             - sum(need_s(est[v], p_min) for v in variants)
             - need_seg(s_min))
    m_sched = full
    if spare < 0:
        scale = max(0.0, 1.0 + spare / need_m)
        m_sched = (max(m_min[0], int(full[0] * scale)),
                   max(m_min[1], int(full[1] * scale) // 4 * 4))
        say(f"CUT mala-100k: {full[0]}/{full[1]} needs ~{need_m:.0f} s and "
            f"{left_s():.0f} s are left: running warmup {m_sched[0]}, draws "
            f"{m_sched[1]} at full width")
    run_path("mala-100k",
             {"mala_step": lambda W, D: W + D,
              "logp_grad": lambda W, D: W + D + 1, **ASIS},
             "beta", (0.3, 0.9), logistic_shapes(512, 3, 8),
             warmup=m_sched[0], draws=m_sched[1], gate=m_sched == full)

    # config 4's segment route: ragged-10k-mala's model on the segment
    # kernels, MALA at full schedule unless the script would then not end
    # within 60% of its budget with the variants at their least and the
    # full judged run (its draws shrink then, to s_min at the least)
    need_v_min = sum(need_s(est[v], p_min) for v in variants)
    room = (left_s() - (BUDGET_S - TARGET_S) - need_s(est["judged"], full)
            - need_v_min)
    sm_sched = s_full
    if need_seg(s_full) > room:
        scale = max(room - need_seg(s_min), 0.0) / max(
            need_seg(s_full) - need_seg(s_min), 1e-9)
        sm_sched = (s_min[0] + int((s_full[0] - s_min[0]) * min(scale, 1.0)),
                    s_min[1] + int(
                        (s_full[1] - s_min[1]) * min(scale, 1.0)) // 2 * 2)
        if scale <= 0.0:
            sm_sched = s_min
        say(f"CUT the segment MALA path: {s_full[0]}/{s_full[1]} needs "
            f"~{need_seg(s_full):.0f} s and {left_s():.0f} s are left: "
            f"running warmup {sm_sched[0]}, draws {sm_sched[1]} at full "
            "width")
    run_path("ragged-10k pallas-segment mala",
             {"seg_logp_grad": lambda W, D: 1 + 2 * (W + D),
              "philox_fill": lambda W, D: 2 * (W + D), **ASIS},
             "beta", (0.3, 0.9), logistic_shapes(1024, 3, 8),
             warmup=sm_sched[0], draws=sm_sched[1], gate=sm_sched == s_full,
             runner=seg_mala)
    run_path("ragged-10k pallas-segment rwmh",
             {"seg_loglik": lambda W, D: 1 + 2 * (W + D),
              "philox_fill": lambda W, D: 2 * (W + D)},
             "beta", (0.1, 0.5), logistic_shapes(1024, 3, 8),
             warmup=s_rw[0], draws=s_rw[1], gate=False,
             runner=segment_runner("rwmh"))

    # config 3's variants run their full schedule only if the script would
    # still end within 60% of its budget after them and the full judged
    # run; otherwise their draws shrink first (to p_min at the least)
    need_v = sum(need_s(est[v], p_full) for v in variants)
    room = left_s() - (BUDGET_S - TARGET_S) - need_s(est["judged"], full)
    v_sched = p_full
    if need_v > room:
        scale = max(room, 0.0) / need_v
        v_sched = (max(p_min[0], int(p_full[0] * scale)),
                   max(p_min[1], int(p_full[1] * scale) // 2 * 2))
        say(f"CUT config 3's variants: {p_full[0]}/{p_full[1]} needs "
            f"~{need_v:.0f} s and {left_s():.0f} s are left: running "
            f"warmup {v_sched[0]}, draws {v_sched[1]} at full width")
    run_path("nested-poisson-1k-mala",
             {"pois_mala_step": lambda W, D: W + D,
              "pois_logp_grad": lambda W, D: 1 + 2 * (W + D),
              "philox_fill": lambda W, D: W + D},
             "beta_s", (0.3, 0.9), poisson_shapes,
             warmup=v_sched[0], draws=v_sched[1], gate=v_sched == p_full)
    run_path("nested-poisson-1k-newton",
             {"pois_newton_step_refresh": lambda W, D: W,
              "pois_newton_step_frozen": lambda W, D: D,
              "pois_logp_grad_hess": lambda W, D: 1 + 2 * W,
              "pois_logp_grad": lambda W, D: 2 * D,
              "philox_fill": lambda W, D: W + D},
             "beta_s", (0.5, 1.0), poisson_shapes,
             warmup=v_sched[0], draws=v_sched[1], gate=v_sched == p_full)

    need_j = need_s(est["judged"], full)
    avail = left_s() - (BUDGET_S - TARGET_S) - 5.0
    j_sched = full
    if need_j > avail:
        scale = avail / need_j
        j_sched = (max(j_min[0], int(full[0] * scale)),
                   max(j_min[1], int(full[1] * scale) // 2 * 2))
        say(f"CUT judged: {full[0]}/{full[1]} needs ~{need_j:.0f} s, "
            f"{avail:.0f} s left: running warmup {j_sched[0]}, draws "
            f"{j_sched[1]} at full width")
    run_path("judged", newton_path, "beta", (0.5, 1.0),
             logistic_shapes(1024, 4, 8), warmup=j_sched[0],
             draws=j_sched[1], gate=j_sched == full)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SRC[k][0],
         "replaces": SRC[k][1], "launches": launches_total[k],
         "max_abs_err": kernels[k]["max_abs_err"], "ms": kernels[k]["ms"],
         "plain_ms": kernels[k]["plain_ms"],
         "bound_ms": kernels[k]["bound_ms"],
         "bound_by": kernels[k]["bound_by"],
         "library_ms": kernels[k].get("library_ms"),
         "shape_C_G_n_p": list(kernels[k]["shape"]),
         **{key: kernels[k][key] for key in ("ms_external_noise", "cells")
            if key in kernels[k]}}
        for k in SRC
    ]}), flush=True)
    say(f"total {time.perf_counter() - T_START:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


def phase10_alone(ranks: int) -> int:
    """``python3 chip_smoke.py --phase10 N``: build p=3 and p=4, then phase
    10 alone with N ranks, one a card (NCCL) on a host of N cards."""
    import torch

    from nestmc_torch import bench
    from nestmc_torch.ops.cuda import _build

    if not torch.cuda.is_available():
        fail("no CUDA device")
    _build.build([3, 4])
    smi = bench.gpu_query()
    say(f"phase 10 alone: {ranks} ranks on {torch.cuda.device_count()} "
        f"card(s), '{smi}'")
    phase10(torch.device("cuda"), smi, ranks)
    say(f"total {time.perf_counter() - T_START:.1f} s")
    return 0


def phase11_alone() -> int:
    """``python3 chip_smoke.py --phase11``: build p=3 and p=4, then phase
    11 alone."""
    import torch

    from nestmc_torch import bench
    from nestmc_torch.ops.cuda import _build

    if not torch.cuda.is_available():
        fail("no CUDA device")
    _build.build([3, 4])
    smi = bench.gpu_query()
    say(f"phase 11 alone on '{smi}'")
    phase11(torch.device("cuda"), smi)
    say(f"total {time.perf_counter() - T_START:.1f} s")
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--phase10-rank"]:
        raise SystemExit(phase10_rank())
    if sys.argv[1:] == ["--phase11"]:
        raise SystemExit(phase11_alone())
    if sys.argv[1:2] == ["--phase10"]:
        raise SystemExit(phase10_alone(int(sys.argv[2])))
    raise SystemExit(main())
