#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (smarties_tpu_torch).

    python3 chip_smoke.py      # every phase, one CUDA card

Phases, each reported on its own line:
1. device: a CUDA card is required (exit 2 without one; there is no CPU
   fallback). Prints `nvidia-smi --query-gpu=name,power.limit`, turns
   TF32 off for matmuls and cuDNN and keeps f32 accumulation in the bf16
   GEMMs' split-K reductions (runtime/trainer.py::set_precision).
2. kernels: builds K1 (csrc/retrace.cu) with nvcc from this checkout and
   holds its three entry points against their plain torch versions on
   the card at [200, 37], [33, 22], the main path's [4096, 501] and the
   [256, 501] and [1024, 501] of the PPO and GRU paths and the Atari
   path's [65536, 40], for Retrace and GAE: `affine_suffix_scan` and `batched_retrace` in the
   time-major layout the replay stores (bit-equal) and in row-major, the
   in-place `retrace_sweep_` with a mixed, a full and an empty select,
   both `zero_unselected` values and lengths 0 and L1-1 among the slots
   (bit-equal). Times every entry point at [4096, 501] with CUDA events
   on a cold L2 (runtime/bench_retrace.py's table: random and full
   lengths, the ingest's 1024 of 4096 slots) beside the bound its bytes
   set at 3.35 TB/s, a clone of as many bytes and the plain version;
   the sweep also at the PPO path's [256, 501] in GAE mode, the GRU
   path's [1024, 501], the Atari path's [65536, 40], the glider's
   [16912, 501] and predator-prey's [20971, 201] (the Trainer's and each
   MultiTrainer learner's), where the kernel is also held against its
   plain version.
2b. adam: builds the Adam kernel (csrc/adam.cu) and holds it against the
   loop it replaces (models/optim.py::adam_update_plain_,
   adam_advance_plain_) on the card: 200 steps at the main path's 7
   leaves and at 150 leaves (three update launches), torch.equal on the
   params, both moments, beta_t and step; then the update's time, and
   the update's with the advance, at the main path's leaves (200 calls
   replayed in one CUDA graph, warm L2) beside the bound of its bytes
   (w, g, m1, m2 read, w, m1, m2 written: 28 B a parameter at 3.35 TB/s)
   and the loop's time taken the same way. Phases 4, 4b, 5, 6 and 11
   count the kernel's launches against the optimiser's step counter: one
   update per part (two for DPG, PPO and ACER) and one advance a step,
   a graph's replays included. They count the step-tail kernel's
   launches too (csrc/step_tail.cu, held against the chain it replaces,
   algos/base.py::step_tail_plain_, by tests/test_torch_step_tail_cuda.py):
   one grad_stats and one step_tail a grad step and no tail on the chain
   in phases 4, 4b and 5, none in 6 and 11 (PPO and ACER keep theirs).
2c. tail: builds the step-tail kernel (csrc/step_tail.cu) and holds one
   tail against the chain it replaces at the two benchmark cells'
   shapes (4096 slots x 501, batch 256, the main path's 7 gradient
   leaves; 65,536 slots x 40, batch 128, RACER_atari's 10 leaves):
   torch.equal in the replay's fields and ReF-ER scalars, the metrics
   within 1e-6; then its time and the chain's (200 and 20 calls in one
   CUDA graph) beside the bound of the bytes it must move.
2d. head: builds V-RACER's continuous-head kernel (csrc/policy_head.cu)
   and holds it against the chain it replaces (algos/vracer.py::VRacer.
   output_grad_plain) on tests/_torch_head_cases.py's inputs at
   cart-pole's shapes (batch 256, one bounded action dim) and at batch
   128 with 6 dims (a mixed mask): torch.equal in every output row; then
   its time and the chain's (200 calls in one CUDA graph) beside the
   bound of the bytes it must move. Phases 4, 4b, 5, 8 and 21 count its
   launches against the optimiser's step counter: one a grad step on
   V-RACER's captured paths (the main path and PERrank), none on the
   eager side of 4b (the chain) and on the other learners (RACER's
   Gaussian advantage, RACER-discrete, DQN, NAF, DPG, MixedPG).
2e. lstm_window: builds the LSTM window's kernel (csrc/lstm_window.cu)
   and holds it, at the benchmark cell's shapes (RACER_RNN's LSTM [32,
   32] over cartpole.pomdp's 3 inputs, batch 128, W = 16, rows that
   cover inactive prefixes and holes), against the chain it replaces
   (algos/base.py::chain_outputs) on the card and against the float64
   chain on the CPU: the outputs at t and t+1 and every leaf's gradient,
   one forward, one backward and one reduce launch; then the window's
   time (forward, output layer and backward; the forward alone) and the
   chain's, 200 and 20 calls in one CUDA graph, beside the bound of its
   FLOPs at the FP32 peak. Then the other learners whose LSTM it takes
   on the card (RACER, DQN, NAF, DPG and PPO's encoder, each with an LSTM
   [16, 16] and W = 8) against the CPU's chain at a small size (4 pinned
   train steps and a refresh), each launching the kernel. Phases 4b and
   7 count its launches against
   the optimiser's step counter: one forward, one backward and one reduce
   a grad step on RACER_RNN's path (captured and eager), none elsewhere.
3. reference: the port on the card against the port on the CPU at a
   small size, from one state (8 train steps and a refresh, so K1 runs
   inside the pipeline against its plain version).
4. main path: the V-RACER cart-pole trainer at full width (1024 envs x
   4096 slots x 501 steps, [128, 128] net, batch 256), as users run it:
   its env sweep and grad step captured as CUDA graphs
   (runtime/graphs.py): warmup, two fused cycles (2048 grad steps, two
   1000-step refreshes), one train() chunk and evaluate(32). Checks
   finiteness, the stored-step count, and that every call of K1's four
   sites made exactly one sweep launch (a graph's replays count what its
   capture launched).
4b. graphs: the captured programs against the eager loops
   (Trainer(graphs=False), the counterpart of jax.disable_jit), each
   path from one state: the main path, then RACER, RACER-discrete, DQN,
   NAF, DPG and MixedPG at their recipes' widths with 1024 envs (phase
   5's settings), then V-RACER under PERrank + farpolfrac (phase 9's,
   the draw inside the captured step), then RACER_RNN on cartpole.pomdp
   (phase 7's trainer: the BPTT step and the acting carry captured).
   The captured side runs the Adam and step-tail kernels, the eager side
   the loop and the chain they replace; both run the LSTM window's
   kernel. Per path: warmup, the
   graphs' warm-up calls and their capture in short fused cycles (1
   sweep + 8 grad steps), 2 fused cycles timed by CUDA events, a save,
   a short cycle, a restore and a short cycle (the 1000-step refresh after each
   timed cycle). Params (target nets included), optimiser state, replay,
   in-progress episodes, env state, acting carry and the four generator
   states must be torch.equal; K1 one sweep launch per site call,
   counted over replays, on both (none on DQN's 1-step path). Prints
   fused_cycle_ms both ways, launches per grad step and per env sweep
   both ways (torch.profiler: kernel launches, graph launches, copies;
   one graph launch a captured step), a train chunk's ms per grad step
   both ways, and the graph pools' bytes.
5. learners: RACER, RACER-discrete, DQN, NAF, DPG and MixedPG, each
   through the launcher (smarties_tpu_torch.launch.run) at its recipe's
   published widths and batch with 1024 envs: warmup, train(1000) timed
   with CUDA events (so the 1000-step refresh runs), evaluate(8, 200).
   Checks finiteness and one sweep launch per call at ingest,
   initialize_stats and refresh on every Retrace path (DQN's recipe has
   no Retrace sweep: its 0 is measured and printed); then the port on
   the card against the port on the CPU at a small size (4 pinned train
   steps and a refresh). Each runs captured (Trainer's default), its ms
   per grad step printed beside the eager figure of PERF.md §5.
6. on-policy: PPO on cartpole and on cartpole_discrete through the
   launcher at the recipe's widths (encoder [64] + heads [64], batch 64,
   horizon 2048, 10 epochs) with the launcher's default 64 envs (at
   1024 lanes one wave of a fresh policy's episodes exceeds the commit
   cap of 4 horizons and fresh data would be pruned): two whole horizon
   cycles (fill, 320 updates, the statistics refresh, clear_all), the
   train chunks timed with CUDA events, evaluate(8, 200). Checks that
   every K1 launch ran in GAE mode, one per ingest and one in
   initialize_stats, and none in PPO's refresh; then the card against the
   CPU at a small size.
7. recurrent: RACER_RNN (LSTM [32, 32], BPTT 16, batch 128) on
   cartpole.pomdp with the Trainer built as the main path's (1024 envs,
   4096 slots x 501 steps, training from 16384 observations): warmup,
   train(200), a refresh, evaluate(8, 200); the GRU recipe
   VRACER_expensiveData the same way at 1024 slots. Both run captured
   (the Trainer's default); the ms per grad step is printed beside the
   eager 60.889 and 42.948 measured before the capture and the captured
   8.885 and 5.732 measured before the LSTM window's kernel (the GRU keeps
   the chain).
   Checks that every K1 launch ran in Retrace mode, one per site call;
   then LSTM and GRU V-RACER on the card against the CPU at a small size.
8. conv / Atari: app `catch` with recipe RACER_atari through the launcher
   at full width (RACER-discrete, the Mnih stack over 4 stacked 84x84
   frames + [512], batch 128, maxTotObsNum 262144, a uint8 replay of
   65,536 slots x 40 frames, 1024 envs, training from the recipe's 131072
   observations): warmup, train(300) by CUDA events, 10 env sweeps by
   events, a refresh, evaluate(8, 39). Prints the memory peak of the run
   and of initialize_stats alone (its chunked statistics must stay far
   below a second copy of the replay). Checks finiteness, the uint8
   storage, one Retrace launch of K1 per call at ingest,
   initialize_stats and refresh, and that the ball falls 2 rows a step
   in 256 stored episodes; then the conv learner on the card
   against the CPU on the 20x20 board (two conv layers, 2 appended
   frames, uint8 replay; cuDNN's f32 backward sums in another order than
   the CPU's, and the params stay within the other learners' rtol 1e-4 /
   atol 1e-6).
8b. bf16: the nnBf16 compute type (the dense and conv contractions in
   bf16 with f32 accumulation). `catch` with RACER_atari and nnBf16
   through the launcher at phase 8's width (1024 envs, 65,536 x 40 uint8
   slots): warmup, one fused cycle of 1024 grad steps timed by CUDA
   events (its 1000-step refresh at the end), evaluate(8, 39); one K1
   Retrace launch per call at ingest, initialize_stats and refresh; the
   ball falling 2 rows a step in 256 stored episodes. Then
   the RACER_atari grad step at profile_main.atari_setup's shapes in f32,
   bf16, bf16, f32: ms per step by events, launches, device-busy ms,
   TFLOP/s at the step's FLOPs from the shapes and the MFU against the
   H100 SXM's dense BF16 (989.4 TFLOP/s) or FP32 (67) peak; the bf16
   GEMM and conv kernels of a bf16 step counted by name with
   torch.profiler (more than none; no kernel of an f32 step names bf16).
   Last, 4 pinned bf16 grad steps at RACER_atari's widths on the card and
   on the CPU from one state: their params must differ less than the
   card's bf16 and f32 steps differ (so the card computed bf16, not TF32
   or f32).
9. samplers: the main path's learner (V-RACER, 1024 envs, 4096 x 501
   slots, [128, 128], batch 256) under dataSamplingAlgo PERrank with
   ERoldSeqFilter farpolfrac: warmup, train_fused(1024), one fused cycle
   with the draw inside every step (the 1000-step refresh at its end),
   and train(100), every step drawing from the TD errors the steps
   before wrote, captured with the draw inside the step graph; then
   PERrank, PERerr and PERseq draws on the card against the CPU on a
   copy of the replay for the same injected uniforms (equal).
10. learning: the port learns on the card. V-RACER on cartpole with the
   settings of tests/test_torch_e2e.py (32 envs, 512 slots, batch 128,
   learnrate 1e-4, randSeed 1): a deterministic eval of 16 episodes
   before and after 6000 grad steps must rise by more than 30 and end
   above 80. Prints both evals and the trailing noisy return.
11. ACER: recipe ACER on pendulum through the launcher as published
   (encoder [128] + [128], batch 24, minTotObsNum = maxTotObsNum =
   131072, windows of S = 200) with 1024 envs: warmup, one fused cycle
   (train_fused(1024): ACER's own episode draw up front, the 1000-step
   refresh at its end), evaluate(8, 200). Checks one launch of K1's
   affine_suffix_scan per grad step (both window recursions as [48, 200]
   rows) and no other K1 launch; holds the kernel against its plain
   version on the last step's own coefficients and times both at that
   shape; then the card against the CPU at a small size (4 steps on
   distinct episodes with the clipped normals injected).
12. RACER-ES: recipe VRACER_CMA (a population of 60, [64, 64], batch 60)
   on cartpole through the launcher with 1024 envs: warmup, one fused
   cycle (each step draws its own minibatch), evaluate(8, 200); one K1
   sweep launch per call at ingest, initialize_stats and refresh; then
   the card against the CPU (the population normals injected; the
   members' losses within 1e-2, the update ranked by the CPU's).
13. CMA: recipe CMA (12 members, 384 episodes a generation, [64, 64]) on
   cartpole through the launcher with 1020 envs for 5 generations:
   avgR, the best member and ms per generation; the mean stays finite;
   then one generation (a pendulum rollout and the update) on the card
   against the CPU with the noise injected.
14. Engine K1: `batched_retrace` on one row-major slot as the Engine's
   commit hands it over, [1, 1025] and [1, 257], lengths L1-1, ragged,
   1 and 0, terminal and truncated, rho the Engine's indicator and a
   random one: bit-equal to the plain version; times on a cold L2 beside
   the bound of the bytes and the plain version's.
15. Engine main: the external-env runtime as a user runs it. V-RACER
   (recipe VRACER: [128, 128] SoftSign, batch 256, obsPerStep 1) in
   `smarties_tpu_torch.Engine` serving 16 forked `apps/cart_pole_py`
   apps, event serving, max_ep_len 1024 (4096 slots x 1025),
   minTotObsNum cut to 32768 (4096 slots of a fresh policy's ~20-step
   episodes cannot hold 131072): train to 2000 grad steps (two
   refreshes) and checkpoint.pt, a second Engine restarts from it for
   500 more (the counters continued), a third serves 8 eval episodes
   with no grad step. Prints the env steps/s while the replay fills,
   the lanes served a round, ms per grad step under the pacing by CUDA
   events, ms per round's act, the returns from the rewards file.
   Checks one `batched_retrace` launch per committed episode and one
   `retrace_sweep_` per initialize_stats and refresh, call by call.
16. Engine paths: a learner bundle on the card against one on the CPU
   (3 episodes committed, 8 pinned train steps); RACER_RNN (LSTM [32,
   32], BPTT 16) over 4 forked apps for 200 grad steps, the acting
   contexts advanced; `cart_pole_cpp` over `SocketEnvPool`, built with
   `make -C native BUILD=build/native`, for 200 grad steps, then the
   distributed-agent C++ team (2 teams of 3); an app that crashes once
   after CUDA is up, respawned by a fork, training done; CMA's
   `run_external` over 8 forked `apps/func_maximization` apps for 20
   generations, avgR rising toward the optimum.
17. glider: one env step (100 rk46_nl substeps) on the card against the
   CPU from 1024 states (start draws, lanes just above the ground that
   freeze part-way through the step, lanes over from the start): done
   and terminal equal, states within 1e-4; the step's ms by CUDA events,
   host enqueue, kernel launches and device busy time. Then app `glider`
   with recipe RACER_glider through the launcher ([128, 128, 128], gamma
   1, clipImpWeight 1, maxTotObsNum 524288, so 16912 slots x 501 steps;
   minTotObsNum cut to 65536) with 1024 envs: warmup, one fused cycle of
   1024 grad steps, evaluate(8, 4); one K1 sweep launch per call of each
   site.
18. predator-prey through the Trainer: app `predator_prey` with recipe
   VRACER ([128, 128]) and 1024 lanes (512 envs x 2 agents, one shared
   learner, 20971 slots x 201 steps): warmup, one fused cycle,
   evaluate(8, 200) (zero-sum returns); one K1 launch per site call.
19. MultiTrainer: two V-RACER learners (recipe VRACER) on predator-prey
   with tests/test_competing.py's per-agent MDPs, 512 envs: one roll to
   the truncation at step 200 on the card against the CPU (8 envs,
   deterministic acting, the same params), then warmup, train(1024)
   with train_mask [True, False] and then [False, True] (the frozen
   learner's params bit-unchanged), evaluate(8, 200); K1's launches per
   learner and site equal the code's prediction (one ingest sweep per
   roll, one initialize_stats, one refresh per 1000 steps).
20. logs: cart-pole through the launcher with --logAllSamples (VRACER
   [128, 128], 64 envs, 300 grad steps), log_status and
   log_status(full=True): agent_00_rank00_obs.raw, grads_rank00.raw, the
   stats row, the histogram and the profiler's table written and
   parsed; then two fused cycles in torch's sync debug mode (none
   flagged) and two under torch.profiler (no synchronising CUDA call
   but the profiler's own), while the profiler's CUDA events wait
   unread until its table.
21. multichip: the learner mesh (parallel/mesh.py). K1's sweep at a
   rank's [2048, 501] against its plain version (bit-equal) and timed
   on a cold L2 beside its bytes' bound; the launcher refuses more NCCL
   ranks than cards; then 2 learner ranks spawned on cuda:0 with gloo
   (the host has one card): the main path's V-RACER trainer split in two
   (1024 envs and 4096 x 501 slots in total), warmup and train(1000),
   one refresh with its rebalance. Checks each rank's K1 launches, one
   per call of each site; its step-tail launches, one grad_stats,
   step_tail and finish a grad step (the kernel's mesh form, with the
   chain's three collectives between step_tail and finish); parameters, Adam state, beta, alpha and the
   statistics torch.equal across ranks on the card; one pinned step of
   the mesh against one single-process step on the card with the same
   global batch (rtol 2e-5 / atol 2e-6). Prints ms per grad step by
   CUDA events beside the single-rank step's, the collectives per step
   (each a gloo host round trip) and one all-reduce's cost. NCCL is not
   measured: one card.
22. curves: the learning-record tools (smarties_tpu_torch/tools) through
   their command lines on the card at cut budgets: `learning_curves run
   vracer_cma_cartpole --budget 2048` (warmup, 2 fused cycles of 1024
   grad steps) and `run ppo_std_cartpole --budget 1` (one horizon of 320
   updates), then `cma_func_max_record --generations 3` over 8 forked
   func_maximization apps. Checks the rewards rows (5 columns) and every
   summary key (the JAX tool's and the port's), a finite eval, the budget
   reached, the card's name in the summary, K1's launches by site (one
   per call; none in PPO's refresh) and mode; holds K1 against its plain
   version at each run's replay shape (bit-equal) and times it there.
23. bench: the port's bench (smarties_tpu_torch/bench.py) through its
   `run` at full width: the main path's trainer (1024 envs, 4096 x 501
   slots), warmup, one untimed and 2 timed fused cycles, the steady
   phase as in the bench (64 sweeps, a chunk of 500 steps), the Atari
   step with 128 presampled steps, and quality on seed 0 with 2 cycles
   and the full evaluate(32). Checks that the line parses, fits 1800
   characters and has every throughput, Atari and quality key, finite;
   that K1 made one sweep launch per call of each site of the fused and
   quality trainers, as many calls as the code makes, and none in the
   steady and Atari phases. Then the serving bench
   (tools/serving_bench.py) for 3 s over 4 forked apps: served > 0.
   Prints the phase's time.
`--only NAME ...` runs the device phase and the named phases of 2b-2e,
4, 4b, 7, 8, 8b and 17-23 alone (adam, tail, head, lstm_window, main,
graphs, graphs_rnn: 4b's racer_rnn path alone, recurrent, atari, bf16,
glider, predator_prey, multitrainer, logs, multichip, curves, bench).
Then one JSON line with the kernels' results and, last, the device line.

The script imports no JAX and nothing of the JAX package. Any failed
check raises and the exit code is non-zero. Whether it passes or fails,
it ends by stopping every process it started that is still running
(forked apps, native clients, the multiprocessing resource tracker, and
their orphans, which it reaps as the subreaper), and names them on
stderr.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# agreement of kernel and plain version, as tests/test_pallas_retrace.py
RTOL = 1e-4
ATOL = 1e-4
MAIN_E, MAIN_L1 = 4096, 501
# the Atari path's replay: the launcher's 2 * 262144 // 8 slots of catch's
# 39 steps
ATARI_E, ATARI_L1 = 65536, 40
# the replay shapes K1 meets on the other paths: PPO's 256 slots (GAE), the
# GRU recipe's 1024 and the Atari path's (Retrace); the learners and
# RACER_RNN use MAIN_E
# the glider's replay at RACER_glider's maxTotObsNum (2 * 524288 // 62
# slots of 500 steps) and predator-prey's at VRACER's (2 * 262144 // 25
# slots of 200 steps; the Trainer's, and each MultiTrainer learner's)
GLIDER_E, GLIDER_L1 = 16912, 501
PP_E, PP_L1 = 20971, 201
PATH_SWEEPS = (("ppo", 256, MAIN_L1, "GAE"),
               ("vracer_gru", 1024, MAIN_L1, "retrace"),
               ("racer_atari", ATARI_E, ATARI_L1, "retrace"),
               ("glider", GLIDER_E, GLIDER_L1, "retrace"),
               ("predator_prey / multitrainer", PP_E, PP_L1, "retrace"))
KERNEL_SHAPES = ((200, 37), (33, 22), (256, MAIN_L1), (1024, MAIN_L1),
                 (MAIN_E, MAIN_L1), (ATARI_E, ATARI_L1),
                 (GLIDER_E, GLIDER_L1), (PP_E, PP_L1))
# the learners phase: (name, app, recipe as the launcher takes it)
LEARNER_PATHS = (
    ("racer", "cartpole", "RACER"),
    ("racer_discrete", "cartpole_discrete", "RACER"),
    ("dqn", "cartpole_discrete", "DQN"),
    ("naf", "pendulum", "NAF"),
    ("dpg", "pendulum", "DPG"),
    ("mixedpg", "cartpole", '{"learner": "MixedPG"}'),
)
LEARNER_ENVS, LEARNER_STEPS = 1024, 1000
# the on-policy phase: two horizons of 320 updates each, 64 lanes
PPO_PATHS = (("ppo", "cartpole"), ("ppo_discrete", "cartpole_discrete"))
PPO_ENVS, PPO_STEPS = 64, 640
# the recurrent phase: (name, recipe, replay slots, minTotObsNum); 1024
# lanes each. RACER_RNN starts at the main path's 16384 observations (its
# settings leave the default of 131072, which 4096 slots of a fresh
# policy's short episodes cannot hold)
RNN_PATHS = (("racer_rnn", "RACER_RNN", 4096, 16384),
             ("vracer_gru", "VRACER_expensiveData", 1024, 4096))
RNN_ENVS, RNN_STEPS = 1024, 200
# the eager grad steps of the two recipes before their capture (the
# launcher's RACER_RNN and VRACER_expensiveData on an NVIDIA H100 80GB
# HBM3), ms; their captured steps in train() before the LSTM window's
# kernel (the same card)
RNN_EAGER_MS = {"racer_rnn": 60.889, "vracer_gru": 42.948}
RNN_CAPTURED_MS = {"racer_rnn": 8.885, "vracer_gru": 5.732}
# the conv / Atari phase
ATARI_ENVS, ATARI_STEPS = 1024, 300
# the bf16 phase: the grad step at atari_setup's shapes timed in each
# dtype (calls by events, calls profiled); the card against the CPU
# (replay slots of random pixels, pinned steps); the H100 SXM's dense
# BF16 and FP32 peaks (NVIDIA's datasheet), TFLOP/s
BF16_TIMED, BF16_PROFILED = 30, 5
BF16_CVC_SLOTS, BF16_CVC_STEPS = 64, 4
BF16_PEAK_TFLOPS, FP32_PEAK_TFLOPS = 989.4, 67.0
# the samplers phase: steps through train()
PER_STEPS = 100
# the learning phase: tests/test_torch_e2e.py's settings
LEARN_CFG = dict(minTotObsNum=2048, maxTotObsNum=16384, batchSize=128,
                 learnrate=1e-4, obsPerStep=1.0, randSeed=1)
LEARN_ENVS, LEARN_SLOTS, LEARN_STEPS = 32, 512, 6000
# ACER and RACER-ES: lanes, and grad steps in one fused cycle
CYCLE_ENVS = 1024
# CMA: lanes (the largest multiple of its 12 members up to 1024), and
# generations
CMA_ENVS, CMA_GENERATIONS = 1020, 5
# the Engine: K1's single-slot rows ([1, max_ep_len + 1]) of the main
# run's max_ep_len 1024 and of a 256-step app
ENGINE_K1_L1 = (1025, 257)
# the main run: 16 forked apps, episodes up to 1024 steps (4096 slots x
# 1025 at the recipe's maxTotObsNum), training from 32768 observations
# (4096 slots of a fresh policy's ~20-step episodes cannot hold the
# recipe's 131072), 2000 grad steps, 500 more after the restart, 8 eval
# episodes
ENGINE_ENVS, ENGINE_MAX_LEN, ENGINE_MIN_OBS = 16, 1024, 32768
ENGINE_STEPS, ENGINE_MORE, ENGINE_EVAL = 2000, 500, 8
# the other Engine paths: LSTM and native grad steps, the team's and the
# crash run's, their start thresholds, CMA generations
ENGINE_SIDE_STEPS, ENGINE_TEAM_STEPS = 200, 50
ENGINE_RNN_MIN_OBS, ENGINE_NATIVE_MIN_OBS = 2048, 4096
CMA_EXT_GENERATIONS = 20
# the glider: envs, steps of the deterministic eval (each env step is 600
# derivative evaluations of eager elementwise ops, ~0.8 s at 1024 lanes),
# and the start threshold: the recipe's settings but minTotObsNum cut to
# 65536, which the first wave of episodes (100-125 steps) fills; the
# recipe's 131072 takes a second wave (221 sweeps, 136 s)
GLIDER_ENVS, GLIDER_EVAL_STEPS, GLIDER_MIN_OBS = 1024, 4, 65536
# predator-prey: the Trainer's lanes (512 envs x 2 agents); the
# MultiTrainer's envs and grad steps per learner
PP_LANES, MT_ENVS, MT_STEPS = 1024, 512, 1024
# the logs phase: a short cart-pole run
LOGS_ENVS, LOGS_STEPS = 64, 300
# the multichip phase: learner ranks on the one card, the main path's
# lanes and slots in total, grad steps (one refresh), a collective's
# timeout, the pinned step's tolerance (tests/test_multichip.py's 1 vs 4
# devices) and the single-rank steps timed beside it
MC_RANKS, MC_ENVS, MC_SLOTS, MC_STEPS = 2, 1024, 4096, 1000
MC_TIMEOUT_S, MC_RTOL, MC_ATOL, MC_SINGLE_STEPS = 300.0, 2e-5, 2e-6, 50
# the curves phase: (combo, --budget, the grad steps it runs (whole fused
# cycles of 1024 steps; one PPO horizon of 10 epochs x 2048 / 64), K1's
# mode); CMA generations
CURVES_RUNS = (("vracer_cma_cartpole", 2048, 2048, "retrace"),
               ("ppo_std_cartpole", 1, 320, "GAE"))
CURVES_CMA_GENERATIONS = 3
# the graphs phase: fused cycles timed each way, grad steps of a short
# cycle, of the profiled chunk and of the timed train chunk
GRAPH_TIMED_CYCLES, GRAPH_SHORT_STEPS = 2, 8
GRAPH_PROFILED_STEPS, GRAPH_CHUNK = 20, 100
# the eager grad step of each learner path as PERF.md §5 has it
# (profile_main --path on an NVIDIA H100 80GB HBM3 at 700 W), ms
EAGER_STEP_MS = {"racer": 12.525, "racer_discrete": 8.696, "dqn": 6.995,
                 "naf": 10.262, "dpg": 9.742, "mixedpg": 11.825}
# the Adam phase: steps held against the loop, launches timed in a graph
ADAM_STEPS, ADAM_TIMED = 200, 200
TAIL_TIMED = 200
# the head phase: (name, batch, action dims, bounded mask), calls timed
HEAD_SHAPES = (("vracer_cartpole", 256, 1, "bounded"),
               ("batch128_6dims", 128, 6, "mixed"))
HEAD_TIMED = 200
# the LSTM window phase: (hidden, n_in, batch, W) of the benchmark cell
# racer_rnn_cartpole.fused; calls timed of the kernel and of the chain;
# the learners whose LSTM it also takes, (name, app, recipe)
LSTM_CELL = ((32, 32), 3, 128, 16)
LSTM_TIMED, LSTM_CHAIN_TIMED = 200, 20
LSTM_LEARNERS = (("racer", "cartpole", "RACER"),
                 ("dqn", "cartpole_discrete", "DQN"),
                 ("naf", "pendulum", "NAF"), ("dpg", "pendulum", "DPG"),
                 ("ppo", "cartpole", "PPO"))
# the bench phase: timed fused cycles, the Atari step's presampled steps,
# quality cycles of seed 0; the serving bench's apps and seconds
BENCH_CYCLES, BENCH_ATARI_STEPS, BENCH_QUALITY_CYCLES = 2, 128, 2
SERVING_APPS, SERVING_S = 4, 3.0


def phase_device():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on a CUDA card only", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    from smarties_tpu_torch.runtime.trainer import set_precision
    set_precision()
    print(card, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} | count "
          f"{torch.cuda.device_count()} | torch {torch.__version__} | "
          f"cuda {torch.version.cuda} | tf32 off, bf16 reductions in f32",
          flush=True)
    return card


def _retrace_inputs(rng, E, L1, time_major, dev):
    import numpy as np
    import torch

    def f32(x):
        t = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return t.t().contiguous().t() if time_major else t.contiguous()

    r = f32(rng.randn(E, L1))
    v = f32(rng.randn(E, L1))
    adv = f32(rng.randn(E, L1))
    rho = f32(np.exp(rng.randn(E, L1)))
    b = f32(rng.rand(E, L1) * 0.9)
    lens = torch.as_tensor(rng.randint(1, L1, E).astype(np.int32),
                           device=dev)
    terms = torch.as_tensor(rng.rand(E) > 0.5, device=dev)
    return r, v, adv, rho, b, lens, terms


def _check_sweep(rng, E, L1, dev, check):
    """`retrace_sweep_` against `retrace_sweep_plain_` on time-major
    replay fields: Retrace and GAE, both zero_unselected values, a mixed,
    a full and an empty select, lengths 0 and L1-1 among the slots."""
    import numpy as np
    import torch
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.ops import returns as ret

    def f32(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device=dev)

    qret, r, v, adv = (f32(L1, E) for _ in range(4))
    rho, v_trunc = torch.exp(f32(L1, E)), f32(E)
    lens = rng.randint(0, L1, E)
    lens[:2] = [0, L1 - 1]
    lens = torch.as_tensor(lens.astype(np.int32), device=dev)
    terms = torch.as_tensor(rng.rand(E) > 0.5, device=dev)
    mean = torch.full((), 0.3, device=dev)
    scale = torch.full((), 1.7, device=dev)
    selects = {"mixed": torch.as_tensor(rng.rand(E) > 0.5, device=dev),
               "all": torch.ones(E, dtype=torch.bool, device=dev),
               "none": torch.zeros(E, dtype=torch.bool, device=dev)}
    for mode in ("retrace", "GAE"):
        for zero in (False, True):
            for tag, select in selects.items():
                got, want = qret.clone(), qret.clone()
                for fn, q in ((rk.retrace_sweep_, got),
                              (ret.retrace_sweep_plain_, want)):
                    fn(q, r, v, adv, rho, v_trunc, lens, terms, select,
                       mean, scale, 0.995, 0.95, mode, zero)
                check("retrace_sweep", got, want,
                      f"[{E},{L1}] {mode} select {tag} "
                      f"zero_unselected={zero}", True)


def phase_kernels():
    import numpy as np
    import torch
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.ops import returns as ret
    from smarties_tpu_torch.runtime import bench_retrace as bench

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rk.library()
    build_s = time.perf_counter() - t0
    nvcc_s = rk.LIB.build_info["seconds"]
    print(f"kernels: K1 built in {build_s:.2f} s (nvcc "
          f"{'cached' if nvcc_s is None else f'{nvcc_s:.2f} s'}) -> "
          f"{os.path.relpath(rk.LIB.build_info['path'])}", flush=True)
    for line in bench.ptxas_lines():
        print(f"  ptxas: {line}", flush=True)

    rng = np.random.RandomState(0)
    err = {"affine_suffix_scan": 0.0, "batched_retrace": 0.0,
           "retrace_sweep": 0.0}

    def check(name, got, want, what, exact):
        torch.cuda.synchronize()
        if exact:
            assert torch.equal(got, want), \
                f"{name} {what}: not bit-equal to the plain version, " \
                f"max |diff| {float((got - want).abs().max()):.3e}"
        else:
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                       msg=lambda m: f"{name} {what}: {m}")
        e = float((got - want).abs().max()) if got.numel() else 0.0
        err[name] = max(err[name], e)
        print(f"  {name} {what}: max|kernel - plain| = {e:.3e}"
              f"{' (bit-equal)' if exact else ''}", flush=True)

    for E, L1 in KERNEL_SHAPES:
        for tm in (True, False):
            lay = "time-major" if tm else "row-major"
            r, v, adv, rho, b, lens, terms = _retrace_inputs(rng, E, L1,
                                                             tm, dev)
            check("affine_suffix_scan", rk.affine_suffix_scan(r, b),
                  ret.affine_suffix_scan_plain(r, b), f"[{E},{L1}] {lay}",
                  tm)
            for mode in ("retrace", "GAE"):
                args = (r, v, adv, rho, lens, terms, 0.995, 0.95, mode)
                check("batched_retrace", rk.batched_retrace(*args),
                      ret.batched_retrace_plain(*args),
                      f"[{E},{L1}] {lay} {mode}", tm)
        _check_sweep(rng, E, L1, dev, check)

    # times at the main path's shape and layout, each launch on a cold L2
    rows = bench.measure(dev, n=30)
    for row in rows:
        print(f"kernels: {bench.format_row(row)}", flush=True)
    floor_ms = bench.launch_floor_ms(dev, n=30)
    print(f"kernels: a launch that selects no slot {floor_ms:.4f} ms",
          flush=True)
    plain = bench.plain_ms(dev, n=10)
    for name, ms in plain.items():
        print(f"kernels: plain torch version of {name}, Retrace, random "
              f"lengths: {ms:.4f} ms (median)", flush=True)
    path_rows = {}
    for path, E, L1, mode in PATH_SWEEPS:
        r = path_rows[path] = bench.measure_sweep_at(dev, E, L1, mode)
        print(f"kernels: retrace_sweep {mode} at the {path} path's "
              f"[{E}, {L1}]: kernel {r['ms']:.4f} ms | plain torch "
              f"version {r['plain_ms']:.4f} ms | {r['bytes']} B, bound "
              f"{r['bound_ms'] * 1e3:.2f} us, share of bound "
              f"{r['share_of_bound']:.3f} | clone of as many bytes "
              f"{r['clone_ms']:.4f} ms", flush=True)
    return {"build_s": build_s, "err": err, "rows": rows, "plain": plain,
            "floor_ms": floor_ms, "path_rows": path_rows}


class SiteCounter:
    """Attributes K1 launches to their sites by diffing the launch
    counters around the trainer's three return-sweep callables: per site
    the calls and the launches they made. The ingest sweep counts
    under `ingest_site`, which the main path sets per phase. A captured
    sweep calls the wrapper once, at its capture: both dicts are
    counters registered in ops/cuda_lib.py, which each replay advances
    as it does K1's and cuda_lib.reset_launches() zeroes with K1's."""

    def __init__(self, trainer, rk):
        from smarties_tpu_torch.ops import cuda_lib
        self.rk = rk
        self.ingest_site = "ingest"
        self.sites = {}
        self.calls = {}
        cuda_lib.register(self.sites, self.calls)
        for attr, site in (("_fix_returns", "ingest"),
                           ("_init_stats", "initialize_stats"),
                           ("_refresh", "refresh")):
            setattr(trainer, attr, self._wrap(getattr(trainer, attr), site))

    def _wrap(self, fn, site):
        def counted(*a, **kw):
            n0 = sum(self.rk.launches.values())
            out = fn(*a, **kw)
            key = self.ingest_site if site == "ingest" else site
            self.sites[key] = (self.sites.get(key, 0)
                               + sum(self.rk.launches.values()) - n0)
            self.calls[key] = self.calls.get(key, 0) + 1
            return out
        return counted

    def check_one_launch_per_call(self, counts, expected_sites, what,
                                  no_sweep_sites=()):
        """Every call of a site made exactly one launch (none at a
        `no_sweep_sites` site, which must have been called), all of them
        through the fused sweep, and every expected site was reached."""
        for site in expected_sites:
            assert self.sites.get(site, 0) > 0, \
                f"{what}: K1 was not launched at the {site} site: " \
                f"{self.sites}"
        want = {k: 0 if k in no_sweep_sites else n
                for k, n in self.calls.items()}
        assert set(no_sweep_sites) <= set(self.calls), (what, self.calls)
        assert self.sites == want, \
            f"{what}: launches {self.sites} != calls {self.calls}"
        assert counts["retrace_sweep"] == sum(self.sites.values()) \
            == sum(counts.values()), (what, counts, self.sites)


def _adam_parts(algo, params):
    """Adam update launches per grad step: one per part with its own
    config (DPG's and PPO's split step, ACER's actor and critics), else
    one for all leaves (no learner has more leaves in a part than one
    launch's table holds)."""
    net = params.get("net", params)
    parts = getattr(algo, "part_adam", None)
    if parts is not None:
        return len({k if k in parts else None for k in net})
    return 2 if hasattr(algo, "critic_adam") else 1


def _check_adam_launches(tr, what):
    """The Adam kernel's launches since the last reset against the
    optimiser's own step counter: one update per part and one advance a
    grad step (a graph's replays count what its capture launched)."""
    from smarties_tpu_torch.ops import adam_kernel
    opt = tr.opt_state
    steps = int((opt if hasattr(opt, "step") else opt.adam).step)
    parts = _adam_parts(tr.algo, tr.params)
    want = {"adam_update": parts * steps, "adam_advance": steps}
    assert adam_kernel.launches == want, \
        f"{what}: Adam launches {adam_kernel.launches} != {want}"
    return dict(want, parts=parts)


_ADAM_KERNEL = []


def _use_plain_adam(plain):
    """Send the card's Adam through models/optim.py's loop (plain True),
    which the kernel is held against, or back through the kernel."""
    from smarties_tpu_torch.models import optim
    from smarties_tpu_torch.ops import adam_kernel as ak
    if not _ADAM_KERNEL:
        _ADAM_KERNEL.extend((ak.update_, ak.advance_))
    if plain:
        ak.update_ = (lambda ws, gs, m1s, m2s, st, cfg, gf, eps:
                      optim.adam_update_plain_(
                          ws, gs, st._replace(m1=m1s, m2=m2s), cfg, gf))
        ak.advance_ = lambda st, cfg, eps: optim.adam_advance_plain_(st, cfg)
    else:
        ak.update_, ak.advance_ = _ADAM_KERNEL


def _check_tail_launches(tr, what, used=True, mesh=False):
    """The step-tail kernel's launches since the last reset against the
    optimiser's step counter: one grad_stats and one step_tail a grad
    step (a graph's replays count what its capture launched) where the
    learner's tail is the kernel's (`used`), none where it is not (ACER,
    PPO), and one finish a step more under a mesh."""
    from smarties_tpu_torch.ops import step_tail_kernel
    opt = tr.opt_state
    steps = int((opt if hasattr(opt, "step") else opt.adam).step) * used
    want = {"step_tail": steps, "grad_stats": steps,
            "finish": steps * mesh}
    assert step_tail_kernel.launches == want, \
        f"{what}: step-tail launches {step_tail_kernel.launches} != {want}"
    return want


_TAIL_KERNEL = []


def _use_plain_tail(plain):
    """Send the card's grad-step tails through algos/base.py's chain
    (plain True), which the kernel is held against, or back through the
    kernel."""
    from smarties_tpu_torch.algos import base
    from smarties_tpu_torch.ops import step_tail_kernel as stk
    if not _TAIL_KERNEL:
        _TAIL_KERNEL.append(stk.tail_)
    if plain:
        stk.tail_ = (lambda rs, mb, cfg, step, grads, *rows, net2v=False,
                     mesh=None: base.step_tail_plain_(
                         rs, mb, cfg, step, grads, *rows, mesh=mesh,
                         net2v=net2v))
    else:
        stk.tail_ = _TAIL_KERNEL[0]


def _takes_head_kernel(algo):
    """Whether a learner's CUDA grad step runs the continuous-head kernel:
    V-RACER's own train_step over continuous actions (the zero
    advantage)."""
    from smarties_tpu_torch.algos.vracer import VRacer
    return (type(algo).train_step is VRacer.train_step
            and not algo.discrete and algo.adv_kind == "zero")


def _check_head_launches(tr, what, used=None):
    """The continuous-head kernel's launches since the last reset against
    the optimiser's step counter: one a grad step (a graph's replays
    count what its capture launched) where the learner takes it (`used`;
    by default _takes_head_kernel), none elsewhere."""
    from smarties_tpu_torch.ops import policy_head_kernel
    if used is None:
        used = _takes_head_kernel(tr.algo)
    opt = tr.opt_state
    steps = int((opt if hasattr(opt, "step") else opt.adam).step) * used
    want = {"continuous": steps}
    assert policy_head_kernel.launches == want, \
        f"{what}: head launches {policy_head_kernel.launches} != {want}"
    return want


_HEAD_KERNEL = []


def _use_plain_head(plain):
    """Send V-RACER's heads through the chain (plain True), which the
    kernel is held against, or back through the dispatcher."""
    from smarties_tpu_torch.algos.vracer import VRacer
    if not _HEAD_KERNEL:
        _HEAD_KERNEL.append(VRacer.output_grad)
    VRacer.output_grad = VRacer.output_grad_plain if plain \
        else _HEAD_KERNEL[0]


def _takes_window_kernel(algo):
    """Whether a learner's CUDA grad step runs the LSTM window's kernel:
    a recurrent net that ops/lstm_window_kernel.py takes."""
    from smarties_tpu_torch.ops import lstm_window_kernel
    spec = getattr(algo, "spec", None)
    return spec is not None and lstm_window_kernel.takes(spec)


def _check_window_launches(tr, what):
    """The LSTM window kernel's launches since the last reset against the
    optimiser's step counter: one forward, one backward and one reduce a
    grad step (a graph's replays count what its capture launched) where
    the learner's net takes the kernel, none elsewhere."""
    from smarties_tpu_torch.ops import lstm_window_kernel
    opt = tr.opt_state
    steps = int((opt if hasattr(opt, "step") else opt.adam).step) \
        * _takes_window_kernel(tr.algo)
    want = {"forward": steps, "backward": steps, "reduce": steps}
    assert lstm_window_kernel.launches == want, \
        f"{what}: window launches {lstm_window_kernel.launches} != {want}"
    return want


def _graph_ms(fn, n):
    """Median ms of one fn() call: n calls captured in one CUDA graph,
    replayed 5 times between CUDA events (no host time inside)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    return statistics.median(times)


def phase_adam():
    """The Adam kernel against the loop it replaces, and its time (phase
    2b in the module docstring)."""
    import torch
    from smarties_tpu_torch.models import net as tnet
    from smarties_tpu_torch.models import optim
    from smarties_tpu_torch.ops import adam_kernel, cuda_lib
    from smarties_tpu_torch.runtime import bench_retrace as bench
    from smarties_tpu_torch.runtime.profile_main import main_path_trainer

    t0 = time.perf_counter()
    adam_kernel.LIB.load()
    build_s = time.perf_counter() - t0
    regs = [ln.strip()
            for ln in adam_kernel.LIB.build_info["log"].splitlines()
            if "registers" in ln]
    tr = main_path_trainer(0, "cuda", n_envs=16, n_slots=64)
    cfg, gf = tr.algo.adam_cfg, 1.0 / tr.cfg.batchSize
    sizes = [p.numel() for p in tnet.tree_leaves(tr.params)]
    gen = torch.Generator("cuda").manual_seed(0)

    def grads(params, k):
        return tnet.tree_map(lambda p: torch.randn(
            p.shape, generator=gen, device="cuda")
            * (10.0 if k % 7 == 3 else 1.0), params)

    def both(params, acfg, steps):
        """steps through the kernel and the loop from one state ->
        (launches, every tensor torch.equal)"""
        kp = tnet.tree_map(lambda p: p.detach().clone(), params)
        lp = tnet.tree_map(lambda p: p.detach().clone(), params)
        ks, ls = optim.adam_init(kp), optim.adam_init(lp)
        cuda_lib.reset_launches()
        for k in range(steps):
            g = grads(kp, k)
            optim.adam_step(kp, g, ks, acfg, gf)
            optim.adam_update_plain_(lp, g, ls, acfg, gf)
            optim.adam_advance_plain_(ls, acfg)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(
            tnet.tree_leaves([kp, list(ks)]),
            tnet.tree_leaves([lp, list(ls)])))
        return dict(adam_kernel.launches), equal

    main_launches, main_equal = both(tr.params, cfg, ADAM_STEPS)
    assert main_equal, "adam: kernel != loop at the main path's leaves"
    assert main_launches == {"adam_update": ADAM_STEPS,
                             "adam_advance": ADAM_STEPS}, main_launches
    many = {f"l{i:03d}": torch.randn(n, generator=gen, device="cuda")
            for i, n in enumerate(torch.randint(
                1, 3000, (150,), generator=gen, device="cuda").tolist())}
    many_cfg = optim.AdamConfig(eta=1e-3, lambda_=1e-3, eps_anneal=5e-3)
    many_launches, many_equal = both(many, many_cfg, ADAM_STEPS)
    assert many_equal, "adam: kernel != loop at 150 leaves"
    assert many_launches["adam_update"] == 3 * ADAM_STEPS, many_launches

    kp = tnet.tree_map(lambda p: p.detach().clone(), tr.params)
    ks, g = optim.adam_init(kp), grads(kp, 0)
    n_bytes = 28 * sum(sizes)
    bound_ms = n_bytes / bench.HBM_BYTES_PER_S * 1e3
    rows = {
        "update": (_graph_ms(lambda: optim.adam_update_(kp, g, ks, cfg, gf),
                             ADAM_TIMED),
                   _graph_ms(lambda: optim.adam_update_plain_(
                       kp, g, ks, cfg, gf), ADAM_TIMED // 10)),
        "update + advance": (
            _graph_ms(lambda: optim.adam_step(kp, g, ks, cfg, gf),
                      ADAM_TIMED),
            _graph_ms(lambda: (optim.adam_update_plain_(kp, g, ks, cfg, gf),
                               optim.adam_advance_plain_(ks, cfg)),
                      ADAM_TIMED // 10))}
    cuda_lib.reset_launches()
    del tr
    torch.cuda.empty_cache()
    ms, plain_ms = rows["update"]
    print(f"adam: built in {build_s:.2f} s ({'; '.join(regs)}) | "
          f"{ADAM_STEPS} steps at the main path's {len(sizes)} leaves "
          f"({sum(sizes)} params) torch.equal to the loop (params, moments, "
          f"beta_t, step), launches {main_launches}; at 150 leaves "
          f"torch.equal, launches {many_launches}", flush=True)
    for name, (k_ms, p_ms) in rows.items():
        print(f"adam: {name} at the main path's leaves {k_ms * 1e3:.3f} us "
              f"a call (kernel, {ADAM_TIMED} in one graph) | loop "
              f"{p_ms * 1e3:.3f} us | bound {n_bytes} B -> "
              f"{bound_ms * 1e3:.4f} us ({bound_ms / k_ms:.3f} of the "
              f"kernel's time)", flush=True)
    return {"build_s": build_s, "registers": regs, "bytes": n_bytes,
            "bound_ms": bound_ms, "ms": ms, "plain_ms": plain_ms,
            "share_of_bound": bound_ms / ms,
            "step_ms": rows["update + advance"][0],
            "plain_step_ms": rows["update + advance"][1],
            "launches": main_launches, "many_leaves_launches": many_launches}


# phase 2c: a cell's name -> (slots, steps a slot, batch, env)
TAIL_SHAPES = {
    "vracer_cartpole": (4096, 500, 256, "cartpole"),
    "racer_atari": (65536, 39, 128, "catch"),
}


def _tail_inputs(name, dev):
    """A grad step's tail at a cell's shapes: a replay of that many slots
    and steps (one state dimension: the tail reads no state), B rows at
    distinct slots, the cell's learner's gradient leaves, random values
    from a seed -> (rs, mb, rows, grads, step, cfg)."""
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.algos import base
    from smarties_tpu_torch.algos.registry import make_learner
    from smarties_tpu_torch.models import net as tnet
    from smarties_tpu_torch.replay import buffer as rb
    from smarties_tpu_torch.utils.config import HyperParameters
    E, L, B, app = TAIL_SHAPES[name]
    env = launch.env_module(app)
    cfg = (launch.load_recipe("RACER_atari", 0) if app == "catch" else
           HyperParameters(batchSize=B, maxTotObsNum=262144,
                           nnLayerSizes=[128, 128]))
    algo = make_learner(env.MDP, cfg)
    g = torch.Generator(dev).manual_seed(20)
    params, _ = algo.init(torch.Generator().manual_seed(0), dev)
    grads = tnet.tree_map(lambda p: torch.randn(
        p.shape, generator=g, device=dev) * 1e-2, params)
    rs = rb.init_replay(E, L, 1, 1, 3, clip_imp_weight=cfg.clipImpWeight,
                        device=dev)
    rs.slot_len.copy_(torch.randint(1, L + 1, (E,), generator=g, device=dev,
                                    dtype=torch.int32))
    rs.slot_id.copy_(torch.where(
        torch.rand(E, generator=g, device=dev) < 0.9,
        torch.arange(E, device=dev, dtype=torch.int32), -1))
    for x in (rs.kl_tm, rs.delta_tm, rs.value_tm, rs.advantage_tm,
              rs.v_trunc):
        x.copy_(torch.randn(x.shape, generator=g, device=dev))
    rs.rho_tm.copy_(torch.exp(torch.randn(rs.rho_tm.shape, generator=g,
                                          device=dev)))
    rs.far_count.copy_(rb.far_count_exact(rs))
    ep = torch.randperm(E, generator=g, device=dev)[:B].to(torch.int32)
    t = (torch.rand(B, generator=g, device=dev)
         * rs.slot_len[ep.long()]).to(torch.int32)
    mb = base.gather_minibatch(rs, ep, t)
    rho = torch.exp(torch.randn(B, generator=g, device=dev))
    rows = dict(rho=rho, dkl=torch.rand(B, generator=g, device=dev),
                delta=torch.randn(B, generator=g, device=dev),
                value=torch.randn(B, generator=g, device=dev),
                advantage=torch.randn(B, generator=g, device=dev),
                v_next=torch.randn(B, generator=g, device=dev),
                is_far=rb.is_far_policy(rho, rs.cmax_ret, rs.cinv_ret))
    step = torch.full((), 12345, dtype=torch.int32, device=dev)
    return rs, mb, rows, grads, step, cfg


def _tail_bytes(rs, mb, rows, grads):
    """What the tail must move at these inputs: the gradients, the slots'
    length, id and far count read once; the rows' inputs read; the five
    fields written at the valid rows, the far count read and written
    where a row's far state changes, v_trunc written at the truncated
    rows; the scalars and metrics."""
    from smarties_tpu_torch.models import net as tnet
    from smarties_tpu_torch.replay import buffer as rb
    B = mb.ep.numel()
    was = rb.is_far_policy(mb.rho_old, rs.cmax_ret, rs.cinv_ret)
    now = rb.is_far_policy(rows["rho"], rs.cmax_ret, rs.cinv_ret)
    changed = int(((was != now) & mb.valid).sum())
    return (4 * sum(x.numel() for x in tnet.tree_leaves(grads))
            + 12 * rs.n_slots
            + B * (7 * 4 + 3 + mb.ep.element_size() + mb.t.element_size())
            + 20 * int(mb.valid.sum()) + 8 * changed
            + 4 * int(mb.truncated_next.sum()) + 2 * 4 * 6 + 4 * 9)


def phase_tail():
    """The step-tail kernel against the chain it replaces, and its time
    (phase 2c in the module docstring)."""
    import torch
    from smarties_tpu_torch.algos import base
    from smarties_tpu_torch.models import net as tnet
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import step_tail_kernel as stk
    from smarties_tpu_torch.runtime import bench_retrace as bench

    t0 = time.perf_counter()
    stk.LIB.load()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in stk.LIB.build_info["log"].splitlines()
            if "registers" in ln]
    dev = torch.device("cuda")
    out = {"build_s": build_s, "registers": regs}
    for name in TAIL_SHAPES:
        rs, mb, rows, grads, step, cfg = _tail_inputs(name, dev)
        ref = _clone_replay(rs)
        cuda_lib.reset_launches()
        _, mk = stk.tail_(rs, mb, cfg, step, grads, **rows)
        _, mc = base.step_tail_plain_(ref, mb, cfg, step, grads, **rows)
        torch.cuda.synchronize()
        fields = ("rho_tm", "kl_tm", "delta_tm", "value_tm", "advantage_tm",
                  "far_count", "v_trunc", "cmax_ret", "cinv_ret", "beta",
                  "alpha", "max_abs_error")
        equal = all(torch.equal(getattr(rs, f), getattr(ref, f))
                    for f in fields)
        assert equal, f"tail: kernel != chain at {name}'s shapes"
        assert all(torch.equal(mk[k], mc[k]) for k in
                   ("frac_far_data", "beta", "grad_max")), name
        worst = max(float(torch.abs(mk[k] - mc[k]) / torch.abs(mc[k]))
                    for k in mk if float(mc[k]) != 0)
        assert worst < 1e-6, (name, worst)
        n_bytes = _tail_bytes(ref, mb, rows, grads)
        bound_ms = n_bytes / bench.HBM_BYTES_PER_S * 1e3
        ms = _graph_ms(lambda: stk.tail_(rs, mb, cfg, step, grads, **rows),
                       TAIL_TIMED)
        plain_ms = _graph_ms(lambda: base.step_tail_plain_(
            ref, mb, cfg, step, grads, **rows), TAIL_TIMED // 10)
        n_params = sum(x.numel() for x in tnet.tree_leaves(grads))
        print(f"tail: {name}'s shapes ({rs.n_slots} slots x "
              f"{rs.max_len + 1}, batch {mb.ep.numel()}, "
              f"{len(tnet.tree_leaves(grads))} gradient leaves, {n_params} "
              f"params): kernel torch.equal to the chain (replay fields, "
              f"ReF-ER scalars; metrics within {worst:.2e}), "
              f"{ms * 1e3:.3f} us a call (2 launches, {TAIL_TIMED} calls in "
              f"one graph) | chain {plain_ms * 1e3:.3f} us | bound "
              f"{n_bytes} B -> {bound_ms * 1e3:.4f} us "
              f"({bound_ms / ms:.4f} of the kernel's time)", flush=True)
        out[name] = {"bytes": n_bytes, "bound_ms": bound_ms, "ms": ms,
                     "plain_ms": plain_ms, "metrics_rel": worst}
        del rs, ref, mb, rows, grads
        torch.cuda.empty_cache()
    cuda_lib.reset_launches()
    print(f"tail: built in {build_s:.2f} s ({'; '.join(regs)})", flush=True)
    return {"tail": out}


def _head_bytes(B, nA):
    """What the head must move: the net's outputs, actions, behaviour
    vectors, returns and valid flags of the B rows, the mask and three
    scalars read; the gradient, five float rows and the far flags
    written."""
    return (4 * B * (1 + 2 * nA) * 2 + 4 * B * 3 * nA + 4 * B + B + nA
            + 12 + 20 * B + B)


def phase_head():
    """V-RACER's continuous-head kernel against the chain it replaces,
    and its time (phase 2d in the module docstring)."""
    import torch
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import policy_head_kernel as phk
    from smarties_tpu_torch.runtime import bench_retrace as bench
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_head_cases as cases

    t0 = time.perf_counter()
    phk.LIB.load()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in phk.LIB.build_info["log"].splitlines()
            if "registers" in ln]
    dev = torch.device("cuda")
    out = {"build_s": build_s, "registers": regs}
    for name, B, nA, kind in HEAD_SHAPES:
        algo = cases.learner(nA, kind)
        net_out, mb, rs = cases.case(dev, algo, B=B, seed=40)
        cuda_lib.reset_launches()
        got = algo.output_grad(net_out, mb, rs)
        want = algo.output_grad_plain(net_out, mb, rs)
        torch.cuda.synchronize()
        assert phk.launches == {"continuous": 1}, phk.launches
        for row, x, y in zip(cases.ROWS, got, want):
            assert torch.equal(x, y), \
                f"head: kernel != chain at {name} in {row}"
        n_bytes = _head_bytes(B, nA)
        bound_ms = n_bytes / bench.HBM_BYTES_PER_S * 1e3
        ms = _graph_ms(lambda: algo.output_grad(net_out, mb, rs), HEAD_TIMED)
        plain_ms = _graph_ms(lambda: algo.output_grad_plain(net_out, mb, rs),
                             HEAD_TIMED)
        print(f"head: {name} (batch {B}, {nA} action dims, {kind}): kernel "
              f"torch.equal to the chain ({', '.join(cases.ROWS)}), "
              f"{ms * 1e3:.3f} us a call (1 launch, {HEAD_TIMED} calls in one "
              f"graph) | chain {plain_ms * 1e3:.3f} us | bound {n_bytes} B -> "
              f"{bound_ms * 1e3:.4f} us ({bound_ms / ms:.5f} of the kernel's "
              f"time)", flush=True)
        out[name] = {"bytes": n_bytes, "bound_ms": bound_ms, "ms": ms,
                     "plain_ms": plain_ms}
    cuda_lib.reset_launches()
    print(f"head: built in {build_s:.2f} s ({'; '.join(regs)})", flush=True)
    return {"head": out}


def _window_flops(hidden, n_in, B, W):
    """The LSTM window's FLOPs from its shapes (2 a multiply-add): the
    forward's gate products at the W + 1 positions, 4 H (in + H) a cell;
    the backward's at the W positions through t, as many for dW and dR
    and 4 H (in + H) for dx and dh_prev, less 4 H in at the first layer,
    whose input takes no gradient."""
    fwd = bwd = 0
    nin = n_in
    for li, h in enumerate(hidden):
        cell = 4 * h * (nin + h)
        fwd += cell
        bwd += 2 * cell - (4 * h * nin if li == 0 else 0)
        nin = h
    return 2 * B * ((W + 1) * fwd + W * bwd)


def phase_lstm_window():
    """The LSTM window's kernel against the chain it replaces and the
    float64 chain, and its time (phase 2e in the module docstring)."""
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.algos import base
    from smarties_tpu_torch.models import net as tnet
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import lstm_window_kernel as lw
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_lstm_window_cases as cases

    t0 = time.perf_counter()
    lw.LIB.load()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in lw.LIB.build_info["log"].splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    dev = torch.device("cuda")
    hidden, n_in, B, W = LSTM_CELL
    spec = cases.spec_of(hidden, n_in)
    p64 = cases.params_of(spec, seed=21)
    xs64, act64 = cases.window(n_in, W, seed=22, B=B)
    cot64 = cases.cotangent(spec, B, seed=23)
    want = cases.outputs_and_grads(p64, spec, xs64, act64, cot64, False)
    params = tnet.tree_map(
        lambda x: x.detach().float().to(dev).requires_grad_(True), p64)
    xs, act = xs64.float().to(dev), act64.to(dev)
    cot = cot64.float().to(dev)
    cuda_lib.reset_launches()
    got = cases.outputs_and_grads(params, spec, xs, act, cot, True)
    torch.cuda.synchronize()
    assert lw.launches == {"forward": 1, "backward": 1, "reduce": 1}, \
        lw.launches
    chain = cases.outputs_and_grads(params, spec, xs, act, cot, False)

    def rel(a, b):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        return float((a - b).abs().max() / b.abs().max())

    def worst(x, y):
        return max(rel(a, b) for a, b in zip([x[0], x[1], *x[2]],
                                             [y[0], y[1], *y[2]]))

    err = {"kernel_vs_f64": worst(got, want),
           "chain_vs_f64": worst(chain, want),
           "kernel_vs_chain": worst(got, chain)}
    # tests/test_torch_lstm_window_cuda.py's tolerance on the gradients
    assert err["kernel_vs_f64"] <= 2e-5, err

    def kernel_step():
        y_t, _ = base.window_outputs(params, spec, xs, act)
        base.backprop(params, y_t, cot)

    def chain_step():
        y_t, _ = base.chain_outputs(params, spec, xs, act)
        base.backprop(params, y_t, cot)

    def kernel_forward():
        with torch.no_grad():
            lw.lstm_window(xs, act, params["layers"])

    ms = _graph_ms(kernel_step, LSTM_TIMED)
    fwd_ms = _graph_ms(kernel_forward, LSTM_TIMED)
    chain_ms = _graph_ms(chain_step, LSTM_CHAIN_TIMED)
    flops = _window_flops(hidden, n_in, B, W)
    bound_ms = flops / (FP32_PEAK_TFLOPS * 1e12) * 1e3
    cells = (2 * W + 1) * len(hidden)
    learners = {}
    for name, app, recipe in LSTM_LEARNERS:
        cfg = _small_cfg(recipe)
        cfg.nnType, cfg.nnBPTTseq = "LSTM", 8
        cuda_lib.reset_launches()
        worst = _card_vs_cpu(launch.env_module(app), cfg, 4)
        assert lw.launches["forward"] > 0 and lw.launches["backward"] > 0, \
            (name, lw.launches)
        learners[name] = {"card_vs_cpu": worst, "launches": dict(lw.launches)}
        print(f"lstm_window: {name} ({recipe} with an LSTM "
              f"{cfg.nnLayerSizes}, BPTT 8) on the card against the CPU's "
              f"chain, 4 pinned steps: max |diff| {_fmt_diffs(worst)} | "
              f"window launches {dict(lw.launches)}", flush=True)
    cuda_lib.reset_launches()
    print(f"lstm_window: LSTM {list(hidden)} over {n_in} inputs, batch {B}, "
          f"W = {W}: kernel against float64 {err['kernel_vs_f64']:.3e}, "
          f"chain against float64 {err['chain_vs_f64']:.3e}, kernel against "
          f"chain {err['kernel_vs_chain']:.3e} (largest |diff| over the "
          f"tensor's largest magnitude, outputs and every gradient) | "
          f"window {ms * 1e3:.3f} us a call (forward, output layer, "
          f"backward, reduce; {LSTM_TIMED} in one graph; "
          f"{ms * 1e3 / cells:.3f} us a cell of {cells}), forward alone "
          f"{fwd_ms * 1e3:.3f} us | chain {chain_ms * 1e3:.3f} us "
          f"({LSTM_CHAIN_TIMED} in one graph) | bound {flops} FLOP -> "
          f"{bound_ms * 1e3:.4f} us at {FP32_PEAK_TFLOPS} TFLOP/s "
          f"({bound_ms / ms:.5f} of the kernel's time) | built in "
          f"{build_s:.2f} s ({'; '.join(regs)})", flush=True)
    return {"lstm_window": {"build_s": build_s, "registers": regs,
                            "err": err, "ms": ms, "forward_ms": fwd_ms,
                            "plain_ms": chain_ms, "flops": flops,
                            "bound_ms": bound_ms, "cells": cells,
                            "learners": learners}}


def _clone_replay(rs):
    import dataclasses
    return dataclasses.replace(rs, **{f.name: getattr(rs, f.name).clone()
                                      for f in dataclasses.fields(rs)})


def _leaves(tree, prefix=""):
    """(path, tensor) pairs of a nested dict/list of tensors."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}{i}.")]
    return [(prefix.rstrip("."), tree)]


def _to(tree, device):
    """A tensor, or a tuple of tensors, on `device`."""
    if isinstance(tree, tuple):
        return tuple(x.to(device) for x in tree)
    return tree.to(device)


def _card_vs_cpu(env, cfg, n_steps, state_dtype=None, draws=None,
                 distinct_episodes=False, held_apart=None):
    """The port on the card against the port on the CPU (whose K1 is the
    plain torch loop) at a small size, from the same state: the CPU
    trainer's warmup, then its params, optimiser state and replay copied
    to the card, n_steps train steps on the same pinned samples and a
    refresh on both. `draws(rng, trainer)`, when given, makes a step's
    other random inputs as CPU tensors (ACER's clipped normals, RACER-ES's
    population normals), passed to both as keyword arguments.
    `distinct_episodes`: one sample per episode (ACER's windows of one
    episode would overlap, and the order of the overlapping writes is
    not defined). `held_apart` {param path: atol}: leaves held to an
    absolute bound of their own (ACER's advantage output bias, whose
    gradient is zero but for rounding, which Adam scales to whole
    steps). cuBLAS and the CPU BLAS reduce in another order (TF32
    off): rtol 1e-4; values pass through scale_net2v in RACER, which
    cancels two terms near 5100 (one f32 ulp is 4.9e-4): atol 2e-3 on V,
    TD errors and returns. The conv learner (cuDNN on the card) keeps
    these tolerances. Returns the worst |diff| of params, qret, rho and
    value."""
    import numpy as np
    import torch
    from smarties_tpu_torch.models import convert
    from smarties_tpu_torch.runtime.trainer import Trainer

    size = dict(n_envs=16, n_slots=64, max_len=64, state_dtype=state_dtype)
    cpu = Trainer(env, env.MDP, cfg, device="cpu", **size)
    cpu.warmup(chunk=16)
    gpu = Trainer(env, env.MDP, cfg, device="cuda", **size)
    gpu.params = convert.params_from_jax(convert.params_to_jax(cpu.params),
                                         "cuda")
    gpu.opt_state = convert.opt_state_from_jax(
        convert.opt_state_to_numpy(cpu.opt_state), "cuda")
    gpu.carry = gpu.carry._replace(replay=convert.replay_from_jax(
        convert.replay_to_numpy(cpu.replay), "cuda"))
    rng = np.random.RandomState(0)
    lens = convert.replay_to_numpy(cpu.replay)["length"]
    valid = np.nonzero(convert.replay_to_numpy(cpu.replay)["ep_id"] >= 0)[0]
    for _ in range(n_steps):
        pairs = set()
        if distinct_episodes:
            pairs = {(int(e), int(rng.randint(0, lens[e])))
                     for e in rng.choice(valid, cfg.batchSize,
                                         replace=False)}
        while len(pairs) < cfg.batchSize:
            e = int(rng.choice(valid))
            pairs.add((e, int(rng.randint(0, lens[e]))))
        ep, t = (torch.tensor(x, dtype=torch.int32) for x in zip(*pairs))
        kw = {} if draws is None else draws(rng, cpu)
        for tr in (cpu, gpu):
            tr.params, tr.opt_state, _, _ = tr.algo.train_step(
                tr.params, tr.opt_state, tr.replay,
                sample_override=(ep.to(tr.device), t.to(tr.device)),
                **{k: _to(v, tr.device) for k, v in kw.items()})
    for tr in (cpu, gpu):
        tr.carry = tr.carry._replace(replay=tr._refresh(tr.replay, 1000.0))
    worst = {"params": 0.0}
    got_p = dict(_leaves(gpu.params))
    for k, p in _leaves(cpu.params):
        g = got_p[k].detach().cpu()
        if held_apart and k in held_apart:
            torch.testing.assert_close(g, p.detach(), rtol=0,
                                       atol=held_apart[k],
                                       msg=lambda m: f"param {k}: {m}")
            continue
        torch.testing.assert_close(g, p.detach(), rtol=1e-4, atol=1e-6,
                                   msg=lambda m: f"param {k}: {m}")
        worst["params"] = max(worst["params"],
                              float((g - p.detach()).abs().max()))
    want = convert.replay_to_numpy(cpu.replay)
    got = convert.replay_to_numpy(gpu.replay)
    for k in convert.REPLAY_FIELDS:
        atol = 2e-3 if k in ("qret", "delta", "value", "v_trunc",
                             "max_abs_error") else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol,
                                   err_msg=f"replay field {k}")
        if k in ("qret", "rho", "value"):
            worst[k] = float(np.abs(got[k] - want[k]).max())
    return worst


def phase_reference():
    """V-RACER on cart-pole, 8 pinned train steps and a refresh."""
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.utils.config import HyperParameters

    cfg = HyperParameters(minTotObsNum=256, maxTotObsNum=2048, batchSize=32,
                          nnLayerSizes=[16, 16], randSeed=0)
    worst = _card_vs_cpu(cartpole, cfg, 8)
    print(f"reference: port on the card vs on the CPU, 16 envs x 64 slots, "
          f"8 train steps + refresh: max |diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()), flush=True)


def phase_main_path():
    import numpy as np
    import torch
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.runtime.profile_main import main_path_trainer

    t_build = time.perf_counter()
    tr = main_path_trainer(0, "cuda")
    assert tr.replay.rewards.shape == (MAIN_E, MAIN_L1) and tr.graphs
    sites = SiteCounter(tr, rk)
    torch.cuda.synchronize()
    print(f"main: trainer built in {time.perf_counter() - t_build:.2f} s "
          f"(1024 envs, 4096 x 501 slots, [128,128], batch 256)",
          flush=True)

    cuda_lib.reset_launches()
    sites.ingest_site = "warmup_train_ingest"
    t0 = time.perf_counter()
    tr.warmup(chunk=16, blind_sweeps=16)
    torch.cuda.synchronize()
    print(f"main: warmup (16 blind sweeps + initialize_stats) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    sites.ingest_site = "fused_cycle_ingest"
    cycle_ms = []
    for _ in range(2):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        tr.train_fused(tr.n_envs, log_every=10 ** 9, flush=False)
        e1.record()
        e1.synchronize()
        cycle_ms.append(e0.elapsed_time(e1))
    sites.ingest_site = "warmup_train_ingest"
    g0 = tr.n_grad_steps
    t0 = time.perf_counter()
    tr.train(100, log_every=10 ** 9)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rets = tr.evaluate(32)
    eval_s = time.perf_counter() - t0
    counts = dict(rk.launches)
    site_counts = dict(sites.sites)

    # checks
    for k, p in _leaves(tr.params):
        assert torch.isfinite(p).all(), f"non-finite parameter {k}"
    for k, m in tr._last_metrics.items():
        assert torch.isfinite(m).all(), f"non-finite metric {k}"
    assert np.isfinite(rets).all() and rets.shape == (32,), rets
    n_stored = int(tr.replay.n_stored_steps())
    assert n_stored > 0, n_stored
    assert tr.n_grad_steps - g0 >= 100 and g0 >= 2048, (g0, tr.n_grad_steps)
    sites.check_one_launch_per_call(
        counts, ("warmup_train_ingest", "initialize_stats", "refresh",
                 "fused_cycle_ingest"), "main")
    adam = _check_adam_launches(tr, "main")
    tail = _check_tail_launches(tr, "main")
    head = _check_head_launches(tr, "main", used=True)

    per_cycle = statistics.median(cycle_ms)
    print(f"main: fused cycle {cycle_ms[0]:.1f} / {cycle_ms[1]:.1f} ms "
          f"(1 env sweep + 1024 grad steps) | "
          f"{1024 / per_cycle * 1e3:.1f} grad steps/s | "
          f"{tr.n_envs / per_cycle * 1e3:.1f} env steps/s", flush=True)
    print(f"main: train() chunk of {tr.n_grad_steps - g0} steps "
          f"{train_s:.2f} s | evaluate(32) {eval_s:.2f} s, mean return "
          f"{float(np.mean(rets)):.2f} | stored steps {n_stored} | "
          f"grad steps {tr.n_grad_steps} | env steps {tr.n_env_steps}",
          flush=True)
    print(f"main: K1 launches {counts} by site {site_counts}, one per "
          f"call of each site (captured: {sorted(tr._sweep_graphs)}-sweep "
          f"graphs, the step graph; pools "
          f"{tr.graph_pool_bytes() / 2 ** 20:.1f} MiB) | Adam launches "
          f"{adam}, one update and one advance a grad step | step-tail "
          f"launches {tail}, one grad_stats and one step_tail a grad step "
          f"| head launches {head}, one a grad step", flush=True)
    return {"cycle_ms": cycle_ms, "launches": counts, "sites": site_counts,
            "adam": adam, "tail": tail, "head": head}


def _state_tensors(x, name=""):
    """(path, tensor) of every tensor in a tree of dicts, (named) tuples
    and dataclasses."""
    import dataclasses

    import torch
    if isinstance(x, torch.Tensor):
        return [(name, x)]
    if isinstance(x, dict):
        return [p for k in sorted(x)
                for p in _state_tensors(x[k], f"{name}.{k}")]
    if isinstance(x, (list, tuple)):
        keys = getattr(x, "_fields", range(len(x)))
        return [p for k, v in zip(keys, x)
                for p in _state_tensors(v, f"{name}.{k}")]
    if dataclasses.is_dataclass(x):
        return [p for f in dataclasses.fields(x)
                for p in _state_tensors(getattr(x, f.name),
                                        f"{name}.{f.name}")]
    return []


def _per_trainer(graphs=None):
    """The samplers phase's trainer: the main path's V-RACER under
    PERrank + farpolfrac (4096 x 501 slots, 1024 envs)."""
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.runtime.trainer import Trainer
    from smarties_tpu_torch.utils.config import HyperParameters

    cfg = HyperParameters(minTotObsNum=16384, maxTotObsNum=262144,
                          batchSize=256, obsPerStep=1.0,
                          nnLayerSizes=[128, 128], randSeed=0,
                          dataSamplingAlgo="PERrank",
                          ERoldSeqFilter="farpolfrac")
    tr = Trainer(cartpole, cartpole.MDP, cfg, n_envs=1024, n_slots=MAIN_E,
                 max_len=cartpole.MAX_STEPS, device="cuda", graphs=graphs)
    tr.log_flush_threshold = 10 ** 9
    return tr


def _learner_trainer(app, recipe, graphs=None):
    """A learners-phase path's trainer as the launcher builds it (the
    recipe's settings, 1024 envs, the default replay), without a run
    directory."""
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.runtime.trainer import Trainer

    env = launch.env_module(app)
    tr = Trainer(env, env.MDP, launch.load_recipe(recipe, 0),
                 n_envs=LEARNER_ENVS, max_len=env.MAX_STEPS, device="cuda",
                 graphs=graphs)
    tr.log_flush_threshold = 10 ** 9
    return tr


def _graphs_path(name, make, tmp):
    """One path of phase 4b: `make(graphs)` builds its trainer; captured
    and eager from one state -> results by mode."""
    import gc

    import torch
    from smarties_tpu_torch.ops import adam_kernel, cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.runtime import graphs as cg
    from smarties_tpu_torch.runtime.profile_main import profile_calls

    t_path = time.perf_counter()
    res, trainers = {}, {}
    for mode in ("captured", "eager"):
        # captured: the Adam and step-tail kernels; eager: the loop and
        # the chain they replace
        _use_plain_adam(mode == "eager")
        _use_plain_tail(mode == "eager")
        _use_plain_head(mode == "eager")
        tr = make(None if mode == "captured" else False)
        assert tr.graphs == (mode == "captured"), (name, mode, tr.graphs)
        sites = SiteCounter(tr, rk)
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        tr.warmup(chunk=16)
        torch.cuda.synchronize()
        stages = {"warmup_s": time.perf_counter() - t0}

        def short_cycle():
            tr._fused_cycle(1, GRAPH_SHORT_STEPS)

        # the graphs' eager warm-up calls, then their capture
        for _ in range(cg.WARMUP_CALLS + 1):
            short_cycle()
        cycle_ms = []
        for _ in range(GRAPH_TIMED_CYCLES):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            tr.train_fused(tr.n_envs, log_every=10 ** 9, flush=False)
            e1.record()
            e1.synchronize()
            cycle_ms.append(e0.elapsed_time(e1))
        tail = _check_tail_launches(tr, f"graphs {name} {mode}",
                                    mode == "captured")
        head = _check_head_launches(
            tr, f"graphs {name} {mode}",
            mode == "captured" and _takes_head_kernel(tr.algo))
        window = _check_window_launches(tr, f"graphs {name} {mode}")
        if mode == "captured":
            adam = _check_adam_launches(tr, f"graphs {name} {mode}")
        else:
            assert sum(adam_kernel.launches.values()) == 0, \
                (name, adam_kernel.launches)
            adam = dict(adam_kernel.launches)
        ckpt = os.path.join(tmp, f"{name}_{mode}.pt")
        t0 = time.perf_counter()
        tr.save(ckpt)
        short_cycle()
        tr.restore(ckpt)
        short_cycle()
        os.remove(ckpt)
        torch.cuda.synchronize()
        stages["save_restore_s"] = time.perf_counter() - t0
        counts = dict(rk.launches)
        if tr.algo.returns_mode == "none":
            assert sum(counts.values()) == 0 == sum(sites.sites.values()), \
                (name, mode, counts, sites.sites)
        else:
            sites.check_one_launch_per_call(
                counts, ("ingest", "initialize_stats", "refresh"),
                f"graphs {name} {mode}")
        if mode == "captured":
            assert all(g.graph is not None for g in tr._step_graphs.values())
            assert tr._step_graphs and tr._sweep_graphs[1].graph is not None
        res[mode] = {"fused_cycle_ms": cycle_ms,
                     "k1": counts.get("retrace_sweep", 0), "adam": adam,
                     "tail": tail, "head": head, "window": window,
                     "sites": dict(sites.sites), "stages": stages}
        tr._pending_logs.clear()
        trainers[mode] = tr

    # one state: everything the graphs read and write, and the generators
    cap, eag = trainers["captured"], trainers["eager"]

    def state(tr):
        return _state_tensors({"params": tr.params, "opt": tr.opt_state,
                               "carry": tr.carry})

    cap_presamples = cap._can_presample
    sc, se = state(cap), state(eag)
    assert [k for k, _ in sc] == [k for k, _ in se]
    for (k, x), (_, y) in zip(sc, se):
        assert torch.equal(x, y), f"graphs {name}: {k} differs captured " \
            f"vs eager"
    for g in ("env", "act", "batch", "eval"):
        assert torch.equal(getattr(cap, "gen_" + g).get_state(),
                           getattr(eag, "gen_" + g).get_state()), (name, g)
    assert cap.n_grad_steps == eag.n_grad_steps

    # launches per grad step and per env sweep, and a train chunk's time
    for mode, tr in trainers.items():
        _use_plain_adam(mode == "eager")
        _use_plain_tail(mode == "eager")
        _use_plain_head(mode == "eager")
        t0 = time.perf_counter()
        step = profile_calls(
            lambda: tr._train_chunk(GRAPH_PROFILED_STEPS), 1)
        sweep = profile_calls(lambda: tr._sweep(1), 3)
        per_step = {k: step[k] / GRAPH_PROFILED_STEPS for k in
                    ("launches", "graph_launches", "copies")}
        per_step["device_busy_ms"] = step["busy_ms"] / GRAPH_PROFILED_STEPS
        per_sweep = {k: sweep[k] for k in ("launches", "graph_launches",
                                           "copies")}
        per_sweep["device_busy_ms"] = sweep["busy_ms"]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        tr._train_chunk(GRAPH_CHUNK)
        e1.record()
        e1.synchronize()
        chunk_ms = e0.elapsed_time(e1)
        res[mode]["stages"]["profile_s"] = time.perf_counter() - t0
        res[mode].update(per_grad_step=per_step, per_sweep=per_sweep,
                         train_chunk_ms=chunk_ms,
                         ms_per_grad_step=chunk_ms / GRAPH_CHUNK,
                         pool_bytes=tr.graph_pool_bytes())
    _use_plain_adam(False)
    _use_plain_tail(False)
    _use_plain_head(False)
    c, e = res["captured"], res["eager"]
    assert c["per_grad_step"]["graph_launches"] == 1, (name, c)
    # a replay launches 2 kernels (its seed and offset) per generator the
    # graph registers: gen_batch where the step draws its own minibatch
    in_step_draw = not cap_presamples
    assert c["per_grad_step"]["launches"] < 1 + 2 * in_step_draw, (name, c)
    assert e["per_grad_step"]["graph_launches"] == 0 and \
        e["per_grad_step"]["launches"] > 100, (name, e)
    algo, n_tensors = type(cap.algo).__name__, len(sc)
    del cap, eag, trainers, tr, sc, se
    gc.collect()
    torch.cuda.empty_cache()
    for mode, r in res.items():
        print(f"graphs {name} ({algo}) [{mode}]: fused_cycle_ms "
              f"{' / '.join(f'{x:.2f}' for x in r['fused_cycle_ms'])} "
              f"(1 env sweep + 1024 grad steps, CUDA events) | "
              f"{r['ms_per_grad_step']:.4f} ms per grad step (a chunk of "
              f"{GRAPH_CHUNK}) | per grad step {r['per_grad_step']} | per "
              f"env sweep + ingest {r['per_sweep']} | K1 {r['k1']} sweep "
              f"launches by site {r['sites']}, one per call | Adam kernel "
              f"{r['adam']} | step-tail kernel {r['tail']} | head kernel "
              f"{r['head']} | window kernel {r['window']} | graph pools "
              f"{r['pool_bytes']} B | s "
              + ", ".join(f"{k} {v:.2f}" for k, v in r["stages"].items()),
              flush=True)
    res["tensors"] = n_tensors
    res["path_s"] = time.perf_counter() - t_path
    print(f"graphs {name}: captured (Adam, step-tail and head kernels) and "
          f"eager (Adam loop, tail and head chains) torch.equal after warmup, "
          f"{cg.WARMUP_CALLS + 1 + GRAPH_TIMED_CYCLES + 2} fused cycles, "
          f"their refreshes and a save / restore ({n_tensors} tensors and 4 "
          f"generator states) | {res['path_s']:.2f} s", flush=True)
    return res


def _rnn_trainer(graphs=None):
    """Phase 4b's recurrent path: phase 7's RACER_RNN trainer (1024
    envs, 4096 x 501 slots, training from 16384 observations)."""
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.runtime.trainer import Trainer

    _, recipe, n_slots, min_obs = RNN_PATHS[0]
    cfg = launch.load_recipe(recipe, 0)
    cfg.minTotObsNum = min_obs
    env = cartpole.pomdp
    tr = Trainer(env, env.MDP, cfg, n_envs=RNN_ENVS, n_slots=n_slots,
                 max_len=env.MAX_STEPS, device="cuda", graphs=graphs)
    tr.log_flush_threshold = 10 ** 9
    return tr


def phase_graphs(only=None):
    """Every captured path against its eager loops, from one state
    (phase 4b in the module docstring); `only`: these paths alone."""
    import functools
    import shutil
    import tempfile

    from smarties_tpu_torch.runtime.profile_main import main_path_trainer

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_graphs_",
                           dir=os.path.join(ROOT, "build"))
    paths = {"vracer_main": lambda g: main_path_trainer(0, "cuda", graphs=g)}
    for name, app, recipe in LEARNER_PATHS:
        paths[name] = functools.partial(_learner_trainer, app, recipe)
    paths["vracer_perrank"] = _per_trainer
    paths["racer_rnn"] = _rnn_trainer
    if only:
        paths = {k: paths[k] for k in only}
    try:
        res = {name: _graphs_path(name, make, tmp)
               for name, make in paths.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"graphs: {len(paths)} paths captured and eager torch.equal | "
          f"phase {res['phase_s']:.2f} s", flush=True)
    return {"graphs": res}


def _small_cfg(recipe):
    """The launcher's recipe cut to the reference phase's small size."""
    from smarties_tpu_torch import launch
    cfg = launch.load_recipe(recipe, 0)
    cfg.minTotObsNum, cfg.maxTotObsNum, cfg.batchSize = 256, 2048, 32
    cfg.nnLayerSizes = [16, 16]
    if any(s > 0 for s in cfg.encoderLayerSizes):
        cfg.encoderLayerSizes = [16]
    return cfg


def phase_learners():
    """The six other learners through the launcher, each at its recipe's
    widths: K1 counted per site around warmup + train(1000), the grad
    step timed with CUDA events, then evaluate and the small-size
    reference against the CPU."""
    import shutil

    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk

    runs = os.path.join(ROOT, "build", "chip_smoke_runs")
    results = {}
    for name, app, recipe in LEARNER_PATHS:
        args = launch.parse_args([
            app, "--recipe", recipe, "--device", "cuda", "--nEnvironments",
            str(LEARNER_ENVS), "--nTrainSteps", str(LEARNER_STEPS),
            "--runprefix", runs, "--runname", name])
        hooks = {}

        def prepare(tr):
            tr.log_flush_threshold = 10 ** 9
            hooks["sites"] = SiteCounter(tr, rk)
            train = tr.train

            def timed_train(n, **kw):
                g0 = tr.n_grad_steps
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                train(n, **kw)
                e1.record()
                e1.synchronize()
                hooks.update(train_ms=e0.elapsed_time(e1),
                             train_wall_s=time.perf_counter() - t0,
                             steps=tr.n_grad_steps - g0)
            tr.train = timed_train

        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        tr = launch.run(args, prepare=prepare)
        torch.cuda.synchronize()
        assert tr.graphs, f"{name}: not captured"
        run_s = time.perf_counter() - t0
        counts, sites = dict(rk.launches), dict(hooks["sites"].sites)
        adam = _check_adam_launches(tr, name)
        tail = _check_tail_launches(tr, name)
        _check_head_launches(tr, name)
        rets = tr.evaluate(8, max_steps=200)

        for k, p in _leaves(tr.params):
            assert torch.isfinite(p).all(), f"{name}: non-finite param {k}"
        for k, m in tr._last_metrics.items():
            assert torch.isfinite(m).all(), f"{name}: non-finite metric {k}"
        assert np.isfinite(rets).all() and rets.shape == (8,), (name, rets)
        assert hooks["steps"] >= LEARNER_STEPS, (name, hooks)
        mode = tr.algo.returns_mode
        if mode == "none":
            assert sum(counts.values()) == 0 == sum(sites.values()), \
                (name, counts, sites)
            k1 = ("K1 launches 0, measured: returnsEstimator 'none' "
                  "(1-step targets) runs no Retrace sweep")
        else:
            hooks["sites"].check_one_launch_per_call(
                counts, ("ingest", "initialize_stats", "refresh"), name)
            k1 = f"K1 sweep launches by site {sites}, one per call"
        worst = _card_vs_cpu(launch.env_module(app), _small_cfg(recipe), 4)
        shutil.rmtree(tr.run_dir)
        cfg = tr.cfg
        widths = (f"enc {cfg.encoderLayerSizes} + {cfg.nnLayerSizes}"
                  if type(tr.algo).__name__ == "DPG" else
                  f"{cfg.nnLayerSizes}")
        ms_step = hooks["train_ms"] / hooks["steps"]
        print(f"learners: {name} ({type(tr.algo).__name__}, {app}, "
              f"{widths}, batch {cfg.batchSize}, {LEARNER_ENVS} envs, "
              f"returns {mode}, captured): train({LEARNER_STEPS}) "
              f"{hooks['train_ms']:.1f} ms by events "
              f"({ms_step:.3f} ms/grad step with its sweeps; eager "
              f"train_step {EAGER_STEP_MS[name]} ms in PERF.md §5; host wall "
              f"{hooks['train_wall_s']:.2f} s) | launch.run {run_s:.2f} s | "
              f"evaluate(8, 200) mean return {float(np.mean(rets)):.2f} | "
              f"{k1} | Adam launches {adam} | step-tail launches {tail} | "
              f"card vs CPU max |diff| "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()),
              flush=True)
        results[name] = {"sites": sites, "launches": counts["retrace_sweep"],
                         "adam": adam, "tail": tail,
                         "ms_per_grad_step": ms_step,
                         "train_ms": hooks["train_ms"], "run_s": run_s,
                         "card_vs_cpu": worst}
    return results


def _check_finite(name, tr, rets, n_eval):
    import numpy as np
    import torch
    for k, p in _leaves(tr.params):
        assert torch.isfinite(p).all(), f"{name}: non-finite param {k}"
    for k, m in tr._last_metrics.items():
        assert torch.isfinite(m).all(), f"{name}: non-finite metric {k}"
    assert np.isfinite(rets).all() and rets.shape == (n_eval,), (name, rets)


def _fmt_diffs(worst):
    return ", ".join(f"{k} {v:.3e}" for k, v in worst.items())


def phase_on_policy():
    """PPO, continuous and discrete, through the launcher: two horizon
    cycles each; the train chunks timed with CUDA events; K1 counted per
    site and by mode; evaluate; the small-size reference against the
    CPU."""
    import shutil

    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk

    runs = os.path.join(ROOT, "build", "chip_smoke_runs")
    results = {}
    for name, app in PPO_PATHS:
        args = launch.parse_args([
            app, "--recipe", "PPO", "--device", "cuda", "--nEnvironments",
            str(PPO_ENVS), "--nTrainSteps", str(PPO_STEPS), "--runprefix",
            runs, "--runname", name])
        hooks = {"events": [], "cleared": [], "stored": []}

        def prepare(tr):
            tr.log_flush_threshold = 10 ** 9
            hooks["sites"] = SiteCounter(tr, rk)
            chunk, refresh = tr._train_chunk, tr._refresh

            def timed_chunk(n):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = chunk(n)
                e1.record()
                hooks["events"].append((e0, e1, n))
                return out

            def watched_refresh(rs, n):
                # the horizon as the updates saw it, before clear_all
                hooks["stored"].append(rs.n_stored_steps())
                return refresh(rs, n)

            tr._train_chunk, tr._refresh = timed_chunk, watched_refresh

        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        tr = launch.run(args, prepare=prepare)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts, modes = dict(rk.launches), dict(rk.launch_modes)
        adam = _check_adam_launches(tr, name)
        _check_tail_launches(tr, name, used=False)
        assert adam["parts"] == 2 and adam["adam_advance"] == PPO_STEPS, \
            (name, adam)
        sites, calls = dict(hooks["sites"].sites), dict(hooks["sites"].calls)
        n_left = int(tr.replay.n_stored_steps())
        rets = tr.evaluate(8, max_steps=200)

        _check_finite(name, tr, rets, 8)
        cfg, algo = tr.cfg, tr.algo
        per_cycle = algo.n_epochs * algo.n_horizon // cfg.batchSize
        steps = sum(n for _, _, n in hooks["events"])
        assert tr.on_policy and algo.returns_mode == "GAE", name
        assert steps == tr.n_grad_steps == PPO_STEPS == 2 * per_cycle, \
            (name, steps, tr.n_grad_steps, per_cycle)
        assert calls["refresh"] == 2 and calls["initialize_stats"] == 1, \
            (name, calls)
        stored = [int(x) for x in hooks["stored"]]
        assert all(algo.n_horizon <= x <= 4 * algo.n_horizon
                   for x in stored), (name, stored)
        assert n_left == 0, f"{name}: replay not cleared: {n_left}"
        hooks["sites"].check_one_launch_per_call(
            counts, ("ingest", "initialize_stats"), name,
            no_sweep_sites=("refresh",))
        assert modes == {"retrace": 0, "GAE": counts["retrace_sweep"]}, \
            (name, modes, counts)
        train_ms = sum(e0.elapsed_time(e1) for e0, e1, _ in hooks["events"])
        ms_step = train_ms / steps
        worst = _card_vs_cpu(launch.env_module(app), _small_cfg("PPO"), 4)
        shutil.rmtree(tr.run_dir)
        print(f"on-policy: {name} (PPO, {app}, enc {cfg.encoderLayerSizes} "
              f"+ {cfg.nnLayerSizes}, batch {cfg.batchSize}, horizon "
              f"{algo.n_horizon}, {algo.n_epochs} epochs, {PPO_ENVS} envs): "
              f"2 horizon cycles, {steps} updates {train_ms:.1f} ms by "
              f"events ({ms_step:.3f} ms/grad step) | launch.run "
              f"{run_s:.2f} s, {tr.n_env_steps} env steps, horizons held "
              f"{stored} steps, cleared to {n_left} | evaluate(8, 200) mean "
              f"return {float(np.mean(rets)):.2f} | K1 sweep launches by "
              f"site {sites} of calls {calls}, by mode {modes} | Adam "
              f"launches {adam} | card vs CPU max |diff| "
              f"{_fmt_diffs(worst)}", flush=True)
        results[name] = {"sites": sites, "launches": counts["retrace_sweep"],
                         "modes": modes, "adam": adam,
                         "ms_per_grad_step": ms_step,
                         "run_s": run_s, "card_vs_cpu": worst}
    return results


def phase_recurrent():
    """The recurrent recipes on the no-velocity cart-pole, the Trainer
    built directly at the main path's replay shape: warmup, train(n) by
    CUDA events, a refresh, evaluate; K1 per site, all in Retrace mode;
    then LSTM and GRU V-RACER on the card against the CPU."""
    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.runtime.trainer import Trainer

    env = cartpole.pomdp
    results = {}
    for name, recipe, n_slots, min_obs in RNN_PATHS:
        cfg = launch.load_recipe(recipe, 0)
        cfg.minTotObsNum = min_obs
        tr = Trainer(env, env.MDP, cfg, n_envs=RNN_ENVS, n_slots=n_slots,
                     max_len=env.MAX_STEPS, device="cuda")
        tr.log_flush_threshold = 10 ** 9
        assert tr.algo_is_recurrent and tr.algo.spec.kind == cfg.nnType
        assert tr.graphs, f"{name}: not captured"
        assert tr.replay.rewards.shape == (n_slots, MAIN_L1)
        sites = SiteCounter(tr, rk)
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        tr.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        tr.train(RNN_STEPS, log_every=10 ** 9)
        e1.record()
        e1.synchronize()
        train_s = time.perf_counter() - t0
        train_ms = e0.elapsed_time(e1)
        tr.carry = tr.carry._replace(
            replay=tr._refresh(tr.replay, float(tr.n_grad_steps)))
        counts, modes = dict(rk.launches), dict(rk.launch_modes)
        window = _check_window_launches(tr, name)
        rets = tr.evaluate(8, max_steps=200)

        _check_finite(name, tr, rets, 8)
        assert tr.n_grad_steps == RNN_STEPS, (name, tr.n_grad_steps)
        sites.check_one_launch_per_call(
            counts, ("ingest", "initialize_stats", "refresh"), name)
        assert modes == {"retrace": counts["retrace_sweep"], "GAE": 0}, \
            (name, modes, counts)
        # the acting carry: one entry per layer, (h, c) pairs for the LSTM
        assert len(tr.carry.rnn) == len(cfg.nnLayerSizes), name
        worst = _card_vs_cpu(env, _small_cfg(recipe), 4)
        ms_step = train_ms / RNN_STEPS
        print(f"recurrent: {name} (VRacer, cartpole.pomdp, {cfg.nnType} "
              f"{cfg.nnLayerSizes}, BPTT {cfg.nnBPTTseq}, batch "
              f"{cfg.batchSize}, {RNN_ENVS} envs, {n_slots} x {MAIN_L1} "
              f"slots): warmup {warm_s:.2f} s | train({RNN_STEPS}) "
              f"{train_ms:.1f} ms by events ({ms_step:.3f} ms/grad step "
              f"captured, against {RNN_CAPTURED_MS[name]} captured before "
              f"the window kernel and {RNN_EAGER_MS[name]} eager, "
              f"host wall {train_s:.2f} s) | window kernel {window} | "
              f"stored steps "
              f"{int(tr.replay.n_stored_steps())} | evaluate(8, 200) mean "
              f"return {float(np.mean(rets)):.2f} | K1 sweep launches by "
              f"site {dict(sites.sites)}, one per call, by mode {modes} | "
              f"card vs CPU max |diff| {_fmt_diffs(worst)}", flush=True)
        results[name] = {"sites": dict(sites.sites), "window": window,
                         "launches": counts["retrace_sweep"], "modes": modes,
                         "ms_per_grad_step": ms_step, "warmup_s": warm_s,
                         "card_vs_cpu": worst}
        del tr
        torch.cuda.empty_cache()
    return results


def _check_catch_frames(tr, n=256):
    """In n stored episodes of `catch`, the ball's top row is FALL * t at
    every step t and its column that of the first frame: the rollout
    writes the env state back field by field, and fields that shared
    memory would make the ball fall 1 row a step."""
    import numpy as np
    import torch
    from smarties_tpu_torch.envs import catch
    rs = tr.replay
    slots = torch.nonzero(rs.slot_id >= 0)[:n, 0]
    frames = rs.states_tm[:, slots].transpose(0, 1).cpu().numpy()
    lens = rs.slot_len[slots].cpu().numpy()
    frames = frames.reshape(len(slots), -1, catch.H, catch.W)
    ball = frames[:, :, :catch.H - catch.PADDLE_H] > 0
    for e in range(len(slots)):
        left0 = np.nonzero(ball[e, 0].any(0))[0].min()
        for t in range(int(lens[e]) + 1):
            rows = np.nonzero(ball[e, t].any(1))[0]
            cols = np.nonzero(ball[e, t].any(0))[0]
            assert rows.min() == catch.FALL * t and cols.min() == left0, \
                (e, t, rows.min(), cols.min(), left0)
    return len(slots)


def phase_atari():
    """`catch` with RACER_atari through the launcher at full width."""
    import shutil

    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.envs import catch
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk

    name = "racer_atari"
    runs = os.path.join(ROOT, "build", "chip_smoke_runs")
    args = launch.parse_args([
        "catch", "--recipe", "RACER_atari", "--device", "cuda",
        "--nEnvironments", str(ATARI_ENVS), "--nTrainSteps",
        str(ATARI_STEPS), "--runprefix", runs, "--runname", name,
        "--noCheckpoint"])
    hooks = {}
    gib = 2.0 ** 30

    def prepare(tr):
        tr.log_flush_threshold = 10 ** 9
        hooks["sites"] = SiteCounter(tr, rk)
        train, warmup, init_stats = tr.train, tr.warmup, tr._init_stats

        def timed_warmup(**kw):
            t0 = time.perf_counter()
            warmup(**kw)
            torch.cuda.synchronize()
            hooks.update(warmup_s=time.perf_counter() - t0,
                         warmup_sweeps=tr.n_env_steps // tr.n_envs)

        def watched_init_stats(rs):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = init_stats(rs)
            torch.cuda.synchronize()
            hooks.update(init_s=time.perf_counter() - t0, init_base=base,
                         init_peak=torch.cuda.max_memory_allocated())
            return out

        def timed_train(n, **kw):
            g0 = tr.n_grad_steps
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            train(n, **kw)
            e1.record()
            e1.synchronize()
            hooks.update(train_ms=e0.elapsed_time(e1),
                         train_wall_s=time.perf_counter() - t0,
                         steps=tr.n_grad_steps - g0)

        tr.train, tr.warmup, tr._init_stats = (timed_train, timed_warmup,
                                               watched_init_stats)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    tr = launch.run(args, prepare=prepare)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    # initialize_stats reset the peak counter: the run's peak is the larger
    peak = max(hooks["init_peak"], torch.cuda.max_memory_allocated())
    rs = tr.replay
    states_bytes = rs.states_tm.numel() * rs.states_tm.element_size()

    # 10 env sweeps alone (act on stacked frames, env step, commit)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(10):
        tr.carry, _ = tr._rollout(tr.params, tr.carry, 1)
    e1.record()
    sweep_enq_ms = (time.perf_counter() - t0) * 1e2
    e1.synchronize()
    sweep_ms = e0.elapsed_time(e1) / 10
    tr.carry = tr.carry._replace(
        replay=tr._refresh(tr.replay, float(tr.n_grad_steps)))
    counts, modes = dict(rk.launches), dict(rk.launch_modes)
    sites = dict(hooks["sites"].sites)
    rets = tr.evaluate(8, max_steps=catch.MAX_STEPS)
    peak = max(peak, torch.cuda.max_memory_allocated())

    _check_finite(name, tr, rets, 8)
    cfg = tr.cfg
    assert (cfg.batchSize, cfg.nnLayerSizes, cfg.maxTotObsNum,
            cfg.minTotObsNum) == (128, [512], 262144, 131072), cfg
    assert [tuple(getattr(c, f) for f in ("in_w", "in_h", "in_c", "out_c",
                                          "filter", "stride"))
            for c in tr.algo.spec.conv] == list(catch.CONV_STACK)
    assert rs.states_tm.dtype == torch.uint8
    assert tuple(rs.states_tm.shape) == (ATARI_L1, ATARI_E, 84 * 84)
    assert tr.carry.inprog.states.dtype == torch.uint8
    assert hooks["steps"] >= ATARI_STEPS, hooks
    n_stored = int(rs.n_stored_steps())
    assert n_stored >= cfg.minTotObsNum, n_stored
    assert set(np.unique(rets)) <= {-1.0, 1.0}, rets
    hooks["sites"].check_one_launch_per_call(
        counts, ("ingest", "initialize_stats", "refresh"), name)
    assert modes == {"retrace": counts["retrace_sweep"], "GAE": 0}, \
        (name, modes, counts)
    _check_head_launches(tr, name, used=False)
    n_checked = _check_catch_frames(tr)
    # the statistics pass never holds a second copy of the replay
    init_extra = hooks["init_peak"] - hooks["init_base"]
    assert init_extra < 0.5 * states_bytes, (init_extra, states_bytes)
    assert peak < 1.5 * states_bytes, (peak, states_bytes)
    ms_step = hooks["train_ms"] / hooks["steps"]
    print(f"atari: {name} ({type(tr.algo).__name__}, catch, Mnih conv + "
          f"{cfg.nnLayerSizes}, batch {cfg.batchSize}, {ATARI_ENVS} envs, "
          f"uint8 replay {ATARI_E} x {ATARI_L1} x 7056 = "
          f"{states_bytes / gib:.2f} GiB, minTotObsNum {cfg.minTotObsNum} "
          f"as published): warmup {hooks['warmup_s']:.2f} s for "
          f"{hooks['warmup_sweeps']} sweeps, initialize_stats "
          f"{hooks['init_s']:.2f} s of it with {init_extra / gib:.2f} GiB "
          f"above the {hooks['init_base'] / gib:.2f} GiB held | "
          f"train({ATARI_STEPS}) {hooks['train_ms']:.1f} ms by events "
          f"({ms_step:.3f} ms/grad step, host wall "
          f"{hooks['train_wall_s']:.2f} s) | env sweep {sweep_ms:.3f} ms by "
          f"events (host enqueue {sweep_enq_ms:.3f} ms) | launch.run "
          f"{run_s:.2f} s | stored steps {n_stored} | evaluate(8, 39) mean "
          f"return {float(np.mean(rets)):.2f} | memory peak "
          f"{peak / gib:.2f} GiB | K1 sweep launches by site {sites}, one "
          f"per call, by mode {modes} | ball falls {catch.FALL} rows a step "
          f"in {n_checked} stored episodes", flush=True)
    shutil.rmtree(tr.run_dir)
    del tr, rs
    torch.cuda.empty_cache()

    small_cfg = _small_cfg("RACER_atari")
    small_cfg.nnLayerSizes = [16]
    worst = _card_vs_cpu(catch.small, small_cfg, 4, state_dtype=torch.uint8)
    print(f"atari: conv learner on the card vs on the CPU (20x20 board, "
          f"conv {catch.small.CONV_STACK}, 2 appended frames, uint8 replay, "
          f"4 train steps + refresh): max |diff| {_fmt_diffs(worst)}",
          flush=True)
    return {name: {"sites": sites, "launches": counts["retrace_sweep"],
                   "modes": modes, "ms_per_grad_step": ms_step,
                   "ms_per_env_sweep": sweep_ms, "run_s": run_s,
                   "memory_peak_bytes": peak,
                   "init_stats_extra_bytes": init_extra,
                   "card_vs_cpu": worst}}


def _bf16_kernels(counts):
    """{name: launches} of the GEMM and convolution kernels among
    `counts` whose names mark bf16 operands: cuDNN's and CUTLASS's name
    the type, cuBLAS's `nvjet_tst_*` GEMMs mark bf16 operands with the
    first letter of their type code (cuDNN's layout transforms and
    padding kernels name bf16 too, and are left out)."""
    gemm_or_conv = ("nvjet", "gemm", "fprop", "dgrad", "wgrad")
    return {k: n for k, n in counts.items()
            if _marks_bf16(k) and any(m in k.lower() for m in gemm_or_conv)}


def _marks_bf16(name):
    return (name.startswith("nvjet_t")
            or any(m in name for m in ("bf16", "bfloat16", "BFloat16")))


def _atari_step(bf16):
    """The RACER_atari grad step at profile_main.atari_setup's shapes in
    one compute type: (ms per step by events, the profile of
    BF16_PROFILED steps, GFLOP of a step)."""
    import torch
    from smarties_tpu_torch.algos.base import presample_uniform
    from smarties_tpu_torch.runtime import profile_main as pm

    algo, params, opt, rs = pm.atari_setup("cuda", bf16=bf16)
    B = algo.cfg.batchSize
    n = 10 + BF16_TIMED + BF16_PROFILED
    eps, ts = presample_uniform(torch.Generator(device="cuda").manual_seed(2),
                                rs, B, n)
    state = {"p": params, "o": opt, "rs": rs, "i": 0}

    def step():
        i = state["i"] % n
        state["p"], state["o"], state["rs"], _ = algo.train_step(
            state["p"], state["o"], state["rs"],
            sample_override=(eps[i], ts[i]))
        state["i"] += 1

    for _ in range(10):
        step()
    ms = pm.time_calls(step, BF16_TIMED)[0]
    prof = pm.profile_calls(step, BF16_PROFILED)
    # [s_t; s_t1] go forward together and back together, as bench.py counts
    gflop = pm.step_flops(algo.spec, 2 * B, 2 * B) / 1e9
    del algo, params, opt, rs, state
    torch.cuda.empty_cache()
    return ms, prof, gflop


def _bf16_card_vs_cpu():
    """The same pinned state and (ep, t): BF16_CVC_STEPS bf16 grad steps
    of the RACER_atari learner at its widths on the CPU and on the card,
    and the same steps in f32 on the card -> (max |card bf16 - CPU bf16|,
    max |card bf16 - card f32|) over the params."""
    import torch
    import dataclasses

    from smarties_tpu_torch.algos.base import presample_uniform
    from smarties_tpu_torch.algos.vracer import VRacer
    from smarties_tpu_torch.models import convert
    from smarties_tpu_torch.runtime.profile_main import atari_setup

    algo, params, opt, rs = atari_setup("cpu", n_slots=BF16_CVC_SLOTS,
                                        bf16=True)
    eps, ts = presample_uniform(torch.Generator().manual_seed(3), rs,
                                algo.cfg.batchSize, BF16_CVC_STEPS)
    p_np, o_np = convert.params_to_jax(params), convert.opt_state_to_numpy(opt)
    rs_np = convert.replay_to_numpy(rs)
    out = {}
    for dev, bf16 in (("cpu", True), ("cuda", True), ("cuda", False)):
        learner = VRacer(algo.mdp, dataclasses.replace(algo.cfg,
                                                       nnBf16=bf16))
        assert learner.spec.compute_dtype == ("bfloat16" if bf16
                                              else "float32")
        p = convert.params_from_jax(p_np, dev)
        o = convert.opt_state_from_jax(o_np, dev)
        r = convert.replay_from_jax(rs_np, dev)
        for i in range(BF16_CVC_STEPS):
            p, o, r, _ = learner.train_step(
                p, o, r, sample_override=(eps[i].to(dev), ts[i].to(dev)))
        out[dev, bf16] = {k: x.detach().cpu() for k, x in _leaves(p)}

    def gap(a, b):
        return max(float((out[a][k] - out[b][k]).abs().max()) for k in out[a])

    return gap(("cuda", True), ("cpu", True)), gap(("cuda", True),
                                                   ("cuda", False))


def phase_bf16():
    """The nnBf16 compute type on the conv path: `catch` with RACER_atari
    and nnBf16 through the launcher at the Atari phase's width; bf16 GEMM
    and conv kernels in a grad step (none in f32); the card against the
    CPU; the grad step timed in f32 and bf16."""
    import shutil

    import numpy as np
    import torch
    from smarties_tpu_torch.envs import catch
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.utils.recipes import RECIPES

    name = "racer_atari_bf16"
    recipe = json.dumps(dict(RECIPES["RACER_atari"], nnBf16=True))
    # warmup from the recipe's 131072 observations, then one fused cycle:
    # one env sweep and 1024 grad steps, the 1000-step refresh at its end
    tr, hooks, counts, run_s = _launcher_path(
        name, "catch", recipe, ATARI_ENVS, ATARI_ENVS)
    modes, sites = dict(rk.launch_modes), dict(hooks["sites"].sites)
    rets = tr.evaluate(8, max_steps=catch.MAX_STEPS)
    _check_finite(name, tr, rets, 8)
    assert tr.algo.spec.compute_dtype == "bfloat16" and tr.cfg.nnBf16
    assert (tr.cfg.batchSize, tr.cfg.nnLayerSizes, tr.n_envs) == (
        128, [512], ATARI_ENVS), tr.cfg
    assert tuple(tr.replay.states_tm.shape) == (ATARI_L1, ATARI_E, 84 * 84)
    assert tr.replay.states_tm.dtype == torch.uint8
    assert hooks["cycles"] == 1 and hooks["steps"] == ATARI_ENVS, hooks
    assert all(p.dtype == torch.float32 for _, p in _leaves(tr.params))
    assert set(np.unique(rets)) <= {-1.0, 1.0}, rets
    hooks["sites"].check_one_launch_per_call(
        counts, ("ingest", "initialize_stats", "refresh"), name)
    assert modes == {"retrace": counts["retrace_sweep"], "GAE": 0}, \
        (name, modes, counts)
    n_checked = _check_catch_frames(tr)
    ms_step = hooks["train_ms"] / hooks["steps"]
    print(f"bf16: {name} (catch, RACER_atari + nnBf16, {ATARI_ENVS} envs, "
          f"uint8 replay {ATARI_E} x {ATARI_L1}): warmup "
          f"{hooks['warmup_s']:.2f} s | one fused cycle "
          f"{hooks['train_ms']:.1f} ms by events ({ms_step:.3f} ms/grad "
          f"step, host wall {hooks['train_wall_s']:.2f} s) | launch.run "
          f"{run_s:.2f} s | evaluate(8, 39) mean return "
          f"{float(np.mean(rets)):.2f} | K1 sweep launches by site {sites},"
          f" one per call, by mode {modes} | ball falls {catch.FALL} rows "
          f"a step in {n_checked} stored episodes", flush=True)
    shutil.rmtree(tr.run_dir)
    del tr
    torch.cuda.empty_cache()

    # the grad step in each dtype, in turns: f32, bf16, bf16, f32
    steps = {"float32": [], "bfloat16": []}
    for bf16 in (False, True, True, False):
        ms, prof, gflop = _atari_step(bf16)
        steps["bfloat16" if bf16 else "float32"].append((ms, prof))
    for dtype, runs in steps.items():
        peak, kind = ((BF16_PEAK_TFLOPS, "BF16") if dtype == "bfloat16"
                      else (FP32_PEAK_TFLOPS, "FP32"))
        for ms, prof in runs:
            tflops = gflop / ms
            print(f"bf16: RACER_atari grad step at atari_setup's shapes in "
                  f"{dtype}: {ms:.3f} ms/step by events | "
                  f"{prof['launches']:.1f} launches/step | "
                  f"{prof['device_kernels']:.1f} device kernels/step | "
                  f"device busy "
                  f"{prof['busy_ms']:.3f} ms/step | {tflops:.3f} TFLOP/s at "
                  f"{gflop:.3f} GFLOP a step | MFU {tflops / peak:.4f} of "
                  f"the {peak} TFLOP/s dense {kind} peak (H100 SXM "
                  f"datasheet)", flush=True)
    # the bf16 GEMMs and convs of one step, by name
    bf16_counts = steps["bfloat16"][0][1]["kernel_counts"]
    f32_counts = steps["float32"][0][1]["kernel_counts"]
    bf_kernels = _bf16_kernels(bf16_counts)
    f32_marked = {k: n for k, n in f32_counts.items() if _marks_bf16(k)}
    per_step = sum(bf_kernels.values()) / BF16_PROFILED
    print(f"bf16: bf16 GEMM and conv kernels per bf16 step "
          f"{per_step:.1f}: " + "; ".join(
              f"{k[:90]} x{n // BF16_PROFILED}" for k, n in
              sorted(bf_kernels.items())), flush=True)
    print(f"bf16: kernels naming bf16 in an f32 step: {len(f32_marked)}",
          flush=True)
    # what the bf16 step runs in place of the f32 step's kernels
    for label, a, b in (("bf16 only", bf16_counts, f32_counts),
                        ("f32 only", f32_counts, bf16_counts)):
        for k in sorted(set(a) - set(b)):
            print(f"  {label}: x{a[k] / BF16_PROFILED:g}/step {k[:150]}",
                  flush=True)
    assert per_step > 0, "no bf16 GEMM or conv kernel ran in a bf16 step"
    assert not f32_marked, f32_marked

    d_cpu, d_f32 = _bf16_card_vs_cpu()
    print(f"bf16: {BF16_CVC_STEPS} bf16 grad steps at RACER_atari's widths "
          f"from one state: max |param, card - CPU| {d_cpu:.3e} | max "
          f"|param, card bf16 - card f32| {d_f32:.3e}", flush=True)
    assert d_cpu < d_f32, (d_cpu, d_f32)
    return {name: {"sites": sites, "launches": counts["retrace_sweep"],
                   "modes": modes, "ms_per_grad_step": ms_step,
                   "run_s": run_s,
                   "step": {k: [{"ms": ms, "launches": p["launches"],
                                 "busy_ms": p["busy_ms"]} for ms, p in v]
                            for k, v in steps.items()},
                   "step_gflop": gflop,
                   "bf16_kernels_per_step": per_step,
                   "card_vs_cpu": d_cpu, "bf16_vs_f32": d_f32}}


def phase_samplers():
    """The main path's learner under PERrank + farpolfrac, then every
    prioritized sampler's draw on the card against the CPU."""
    import numpy as np
    import torch
    from smarties_tpu_torch.models import convert
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.replay import buffer as rb

    name = "vracer_perrank"
    tr = _per_trainer()
    cfg = tr.cfg
    assert tr.graphs
    sites = SiteCounter(tr, rk)
    cuda_lib.reset_launches()
    tr.warmup(chunk=16, blind_sweeps=16)
    assert not tr._can_presample
    hooks = {}
    cycle = tr._fused_cycle

    def counted_cycle(*a):
        hooks["cycles"] = hooks.get("cycles", 0) + 1
        return cycle(*a)

    tr._fused_cycle = counted_cycle
    ms = []
    # one fused cycle (1024 steps, each drawing from the TD errors the
    # steps before wrote; the 1000-step refresh at its end), then train()
    for run, n in ((tr.train_fused, tr.n_envs), (tr.train, PER_STEPS)):
        g0 = tr.n_grad_steps
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run(n, log_every=10 ** 9)
        e1.record()
        e1.synchronize()
        assert tr.n_grad_steps - g0 == n, (g0, tr.n_grad_steps)
        ms.append(e0.elapsed_time(e1) / n)
    assert hooks["cycles"] == 1, hooks
    counts = dict(rk.launches)
    rets = tr.evaluate(8, max_steps=200)
    _check_finite(name, tr, rets, 8)
    sites.check_one_launch_per_call(
        counts, ("ingest", "initialize_stats", "refresh"), name)
    rs = tr.replay
    assert float(rs.delta_tm.abs().max()) > 0      # TD errors were written
    cpu = convert.replay_from_jax(convert.replay_to_numpy(rs), "cpu")
    rng = np.random.RandomState(0)
    agree = {}
    for algo in ("PERrank", "PERerr", "PERseq"):
        shape = (2, cfg.batchSize) if algo == "PERseq" else (cfg.batchSize,)
        u = torch.as_tensor(rng.rand(*shape).astype(np.float32))
        ep_c, t_c = rb.sample(None, cpu, cfg.batchSize, algo, u=u)
        ep_g, t_g = rb.sample(None, rs, cfg.batchSize, algo, u=u.cuda())
        assert torch.equal(ep_g.cpu(), ep_c) and torch.equal(t_g.cpu(), t_c), \
            f"{algo}: the card's draw differs from the CPU's"
        assert bool((t_c < cpu.slot_len[ep_c.long()]).all()), algo
        agree[algo] = int(torch.unique(ep_c).numel())
    print(f"samplers: {name} (VRacer, cartpole, [128, 128], batch 256, 1024 "
          f"envs, {MAIN_E} x {MAIN_L1} slots, PERrank + farpolfrac): "
          f"train_fused({tr.n_envs}), one fused cycle with the draws in "
          f"the captured steps: {ms[0]:.3f} ms/grad step by events, "
          f"train({PER_STEPS}) {ms[1]:.3f} | stored "
          f"steps {int(rs.n_stored_steps())} | evaluate(8, 200) mean return "
          f"{float(np.mean(rets)):.2f} | K1 sweep launches by site "
          f"{dict(sites.sites)}, one per call | draws of {cfg.batchSize} on "
          f"the card equal the CPU's for the same uniforms (distinct "
          f"episodes drawn: {agree})", flush=True)
    del tr
    torch.cuda.empty_cache()
    return {name: {"sites": dict(sites.sites),
                   "launches": counts["retrace_sweep"],
                   "ms_per_grad_step": ms[0]}}


def phase_learning():
    """The port learns on the card: tests/test_torch_e2e.py's run (the
    twin of tests/test_e2e_cartpole.py::test_vracer_improves), with the
    same two inequalities on the deterministic eval."""
    import numpy as np
    import torch
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.runtime.trainer import Trainer
    from smarties_tpu_torch.utils.config import HyperParameters

    name = "vracer_learning"
    tr = Trainer(cartpole, cartpole.MDP, HyperParameters(**LEARN_CFG),
                 n_envs=LEARN_ENVS, n_slots=LEARN_SLOTS,
                 max_len=cartpole.MAX_STEPS, device="cuda")
    sites = SiteCounter(tr, rk)
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    tr.warmup(chunk=32)
    base = float(np.mean(tr.evaluate(16)))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    tr.train(LEARN_STEPS, log_every=10 ** 9)
    e1.record()
    e1.synchronize()
    trained = float(np.mean(tr.evaluate(16)))
    trail = float(np.mean(tr._ep_returns[-20:]))
    run_s = time.perf_counter() - t0
    counts = dict(rk.launches)
    _check_finite(name, tr, np.array([base, trained]), 2)
    assert tr.n_grad_steps == LEARN_STEPS, tr.n_grad_steps
    sites.check_one_launch_per_call(
        counts, ("ingest", "initialize_stats", "refresh"), name)
    ms_step = e0.elapsed_time(e1) / LEARN_STEPS
    print(f"learning: {name} (VRacer, cartpole, {tr.cfg.nnLayerSizes}, "
          f"batch {tr.cfg.batchSize}, learnrate {tr.cfg.learnrate}, "
          f"{LEARN_ENVS} envs, {LEARN_SLOTS} slots, randSeed "
          f"{tr.cfg.randSeed}): deterministic eval of 16 episodes "
          f"{base:.3f} before, {trained:.3f} after {LEARN_STEPS} grad "
          f"steps (needs > base + 30 = {base + 30:.3f} and > 80) | trailing "
          f"20 noisy returns {trail:.3f} | train({LEARN_STEPS}) "
          f"{ms_step:.3f} ms/grad step by events | phase {run_s:.2f} s | "
          f"K1 sweep launches by site {dict(sites.sites)}, one per call",
          flush=True)
    assert trained > base + 30, (base, trained, trail)
    assert trained > 80, (trained, trail)
    return {name: {"sites": dict(sites.sites),
                   "launches": counts["retrace_sweep"],
                   "ms_per_grad_step": ms_step, "eval_before": base,
                   "eval_after": trained, "trailing_return": trail}}


def _timed_fused(tr, hooks):
    """Replace tr.train (what launch.run calls) by train_fused timed with
    CUDA events, counting the fused cycles."""
    import torch
    fused, cycle = tr.train_fused, tr._fused_cycle

    def counted_cycle(*a):
        hooks["cycles"] = hooks.get("cycles", 0) + 1
        return cycle(*a)

    def timed(n, **kw):
        g0 = tr.n_grad_steps
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        fused(n, log_every=10 ** 9)
        e1.record()
        e1.synchronize()
        hooks.update(train_ms=e0.elapsed_time(e1),
                     train_wall_s=time.perf_counter() - t0,
                     steps=tr.n_grad_steps - g0)

    tr.train, tr._fused_cycle = timed, counted_cycle


def _acer_draws(rng, tr):
    """ACER's clipped normals of one step, as CPU tensors."""
    import numpy as np
    import torch
    from smarties_tpu_torch.algos import acer
    B, nA = tr.cfg.batchSize, tr.mdp.dim_action
    S = min(acer.SEQ_CUTOFF, tr.replay.max_len)

    def f(*shape):
        return torch.as_tensor(
            np.clip(rng.randn(*shape), -3, 3).astype(np.float32))

    return {"noise": (f(B, S + 1, nA), f(acer.N_EXPECTATION, B, S + 1, nA))}


def _es_draws(rng, tr):
    """RACER-ES's population normals of one step, as a CPU tensor."""
    import numpy as np
    import torch
    return {"z": torch.as_tensor(rng.randn(
        tr.algo.P, tr.algo.unravel.n).astype(np.float32))}


def phase_acer():
    """ACER on pendulum through the launcher at the published settings:
    warmup, one fused cycle of 1024 grad steps (the 1000-step refresh at
    its end), evaluate; K1's affine_suffix_scan once per grad step, held
    against its plain version on the last step's own coefficients and
    timed at that shape; then the card against the CPU."""
    import shutil

    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.algos import acer
    from smarties_tpu_torch.envs import pendulum
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.ops import returns as ret
    from smarties_tpu_torch.runtime import bench_retrace as bench

    name = "acer"
    runs = os.path.join(ROOT, "build", "chip_smoke_runs")
    args = launch.parse_args([
        "pendulum", "--recipe", "ACER", "--device", "cuda",
        "--nEnvironments", str(CYCLE_ENVS), "--nTrainSteps", str(CYCLE_ENVS),
        "--runprefix", runs, "--runname", name, "--noCheckpoint"])
    hooks = {"scans": 0}
    scan = acer.affine_suffix_scan

    def recorded_scan(a, b):
        hooks["scans"] += 1
        hooks["ab"] = (a, b)
        return scan(a, b)

    def prepare(tr):
        tr.log_flush_threshold = 10 ** 9
        hooks["sites"] = SiteCounter(tr, rk)
        _timed_fused(tr, hooks)

    acer.affine_suffix_scan = recorded_scan
    try:
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        tr = launch.run(args, prepare=prepare)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = dict(rk.launches)
    finally:
        acer.affine_suffix_scan = scan
    adam = _check_adam_launches(tr, name)
    _check_tail_launches(tr, name, used=False)
    assert adam["parts"] == 2, adam
    sites, calls = dict(hooks["sites"].sites), dict(hooks["sites"].calls)
    rets = tr.evaluate(8, max_steps=200)
    _check_finite(name, tr, rets, 8)
    cfg, B = tr.cfg, tr.cfg.batchSize
    S = min(acer.SEQ_CUTOFF, tr.replay.max_len)
    assert (B, S, cfg.encoderLayerSizes, cfg.nnLayerSizes, cfg.minTotObsNum,
            cfg.maxTotObsNum) == (24, 200, [128], [128], 131072, 131072), cfg
    assert tr.algo.returns_mode == "none" and tr._can_presample
    steps = hooks["steps"]
    assert steps == CYCLE_ENVS and hooks["cycles"] == 1, hooks
    assert calls.get("refresh") == 1, calls
    # one launch of the affine scan per grad step; no sweep anywhere
    assert counts == {"affine_suffix_scan": steps, "batched_retrace": 0,
                      "retrace_sweep": 0} and hooks["scans"] == steps, \
        (counts, hooks["scans"], steps)
    assert sum(sites.values()) == 0, sites
    a, b = hooks["ab"]
    assert tuple(a.shape) == (2 * B, S) and a.is_contiguous(), a.shape
    got, want = rk.affine_suffix_scan(a, b), ret.affine_suffix_scan_plain(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    err = float((got - want).abs().max())
    bit_equal = bool(torch.equal(got, want))
    timer = bench.ColdTimer(torch.device("cuda"))
    ms = timer(lambda: rk.affine_suffix_scan(a, b), 50)
    plain_ms = timer(lambda: ret.affine_suffix_scan_plain(a, b), 10)
    n_bytes = 3 * a.numel() * a.element_size()
    bound_ms = n_bytes / bench.HBM_BYTES_PER_S * 1e3
    cpu_cfg = _small_cfg("ACER")
    cpu_cfg.batchSize = 8
    # up to one Adam step of the critics' 10 x learnrate per train step,
    # from either side's rounding (tests/test_torch_acer.py)
    bias_tol = 4 * 3 * 10 * cpu_cfg.learnrate
    worst = _card_vs_cpu(pendulum, cpu_cfg, 4, draws=_acer_draws,
                         distinct_episodes=True,
                         held_apart={"net.advtg.out.b": bias_tol})
    shutil.rmtree(tr.run_dir)
    ms_step = hooks["train_ms"] / steps
    print(f"acer: {name} (ACER, pendulum, enc {cfg.encoderLayerSizes} + "
          f"{cfg.nnLayerSizes}, batch {B} windows of S = {S}, {CYCLE_ENVS} envs, "
          f"minTotObsNum = maxTotObsNum = {cfg.maxTotObsNum}): "
          f"train_fused({CYCLE_ENVS}) {hooks['train_ms']:.1f} ms by events "
          f"({ms_step:.3f} ms/grad step, host wall "
          f"{hooks['train_wall_s']:.2f} s, {hooks['cycles']} cycle, refresh "
          f"calls {calls.get('refresh')}) | launch.run {run_s:.2f} s | "
          f"stored steps {int(tr.replay.n_stored_steps())} | evaluate(8, "
          f"200) mean return {float(np.mean(rets)):.2f} | K1 launches "
          f"{counts} for {steps} grad steps (sweeps by site {sites}) | "
          f"Adam launches {adam} | "
          f"affine_suffix_scan on the last step's [{2 * B}, {S}] "
          f"coefficients: max|kernel - plain| {err:.3e}"
          f"{' (bit-equal)' if bit_equal else ' (not bit-equal)'}, kernel "
          f"{ms:.4f} ms | plain torch version {plain_ms:.4f} ms | "
          f"{n_bytes} B, bound {bound_ms * 1e3:.4f} us | card vs CPU "
          f"(batch 8 distinct episodes, S = 64, 4 steps + refresh) max "
          f"|diff| {_fmt_diffs(worst)}", flush=True)
    res = {"launches": steps, "ms_per_grad_step": ms_step, "run_s": run_s,
           "card_vs_cpu": worst, "adam": adam,
           "scan": {"shape": [2 * B, S], "max_abs_err": err,
                    "bit_equal": bit_equal, "ms": ms, "plain_ms": plain_ms,
                    "bytes": n_bytes, "bound_ms": bound_ms}}
    del tr
    torch.cuda.empty_cache()
    return {name: res}


def _es_card_vs_cpu(env):
    """RACER-ES on the card against the CPU (`_card_vs_cpu`, 4 steps and a
    refresh), the card's update ranked by the CPU's losses. At the small
    size the members' losses (0.01-0.6, spread ~3e-3) tie or differ by
    1e-7, less than the card and the CPU disagree (V passes through
    scale_net2v, whose f32 cancellation near 5100 leaves them up to
    ~5e-4 apart per sample), so the two rankings need not agree, and
    one swap moves the new mean by (w_i - w_j) * learnrate * |y_i -
    y_j|, far above the params' tolerance. The losses are held to rtol
    1e-2 / atol 1e-2 (a gross check; member 0's statistics are held at
    the replay's tolerances). Returns the worst |diff|, the losses'
    included."""
    import torch
    from smarties_tpu_torch.algos import racer_es

    update = racer_es.cma_update
    cpu_losses, worst = [], {"losses": 0.0}

    def ranked_as_on_cpu(pop, noise, losses, *a):
        if losses.device.type == "cpu":
            cpu_losses.append(losses.clone())
        else:
            want = cpu_losses.pop()
            torch.testing.assert_close(losses.cpu(), want, rtol=1e-2,
                                       atol=1e-2)
            worst["losses"] = max(worst["losses"], float(
                (losses.cpu() - want).abs().max()))
            losses = want.to(losses.device)
        return update(pop, noise, losses, *a)

    racer_es.cma_update = ranked_as_on_cpu
    try:
        worst.update(_card_vs_cpu(env, _small_cfg("VRACER_CMA"), 4,
                                  draws=_es_draws))
    finally:
        racer_es.cma_update = update
    return worst


def phase_racer_es():
    """RACER-ES (VRACER_CMA, a population of 60) on cartpole through the
    launcher: warmup, one fused cycle of 1024 steps, each drawing its own
    minibatch (the 1000-step refresh at its end), evaluate; K1 per site;
    then the card against the CPU."""
    import shutil

    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk

    name = "vracer_cma"
    runs = os.path.join(ROOT, "build", "chip_smoke_runs")
    args = launch.parse_args([
        "cartpole", "--recipe", "VRACER_CMA", "--device", "cuda",
        "--nEnvironments", str(CYCLE_ENVS), "--nTrainSteps", str(CYCLE_ENVS),
        "--runprefix", runs, "--runname", name, "--noCheckpoint"])
    hooks = {}

    def prepare(tr):
        tr.log_flush_threshold = 10 ** 9
        hooks["sites"] = SiteCounter(tr, rk)
        _timed_fused(tr, hooks)

    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    tr = launch.run(args, prepare=prepare)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts, modes = dict(rk.launches), dict(rk.launch_modes)
    sites, calls = dict(hooks["sites"].sites), dict(hooks["sites"].calls)
    rets = tr.evaluate(8, max_steps=200)
    _check_finite(name, tr, rets, 8)
    cfg, algo = tr.cfg, tr.algo
    assert type(algo).__name__ == "RacerES" and not tr._can_presample
    assert (algo.P, cfg.batchSize, cfg.nnLayerSizes) == (60, 60, [64, 64])
    assert tuple(tr.params["pop"].shape) == (60, algo.unravel.n)
    steps = hooks["steps"]
    assert steps == CYCLE_ENVS and hooks["cycles"] == 1, hooks
    assert int(tr.opt_state.step) == steps and calls.get("refresh") == 1
    hooks["sites"].check_one_launch_per_call(
        counts, ("ingest", "initialize_stats", "refresh"), name)
    assert modes == {"retrace": counts["retrace_sweep"], "GAE": 0}, modes
    worst = _es_card_vs_cpu(cartpole)
    shutil.rmtree(tr.run_dir)
    ms_step = hooks["train_ms"] / steps
    print(f"racer-es: {name} (RacerES, cartpole, population {algo.P} of "
          f"{algo.unravel.n} weights, {cfg.nnLayerSizes}, batch "
          f"{cfg.batchSize}, {CYCLE_ENVS} envs): train_fused({CYCLE_ENVS}) "
          f"{hooks['train_ms']:.1f} ms by events ({ms_step:.3f} ms/grad "
          f"step, host wall {hooks['train_wall_s']:.2f} s, "
          f"{hooks['cycles']} cycle, in-step draws) | launch.run "
          f"{run_s:.2f} s | stored steps {int(tr.replay.n_stored_steps())} "
          f"| evaluate(8, 200) mean return {float(np.mean(rets)):.2f} | K1 "
          f"sweep launches by site {sites} of calls {calls}, by mode "
          f"{modes} | card vs CPU (population 60, [16, 16], 4 steps + "
          f"refresh, ranked by the CPU's losses) max |diff| "
          f"{_fmt_diffs(worst)}", flush=True)
    res = {"sites": sites, "launches": counts["retrace_sweep"],
           "modes": modes, "ms_per_grad_step": ms_step, "run_s": run_s,
           "card_vs_cpu": worst}
    del tr
    torch.cuda.empty_cache()
    return {name: res}


def _cma_generation_vs_cpu():
    """One generation of CMA on the card against the CPU from one state,
    the acting noise and the population normals injected: a rollout of
    pendulum lanes (episodes end only at max_len, so no reset draw
    enters) and the update. Tolerances: returns and observation moments
    rtol 1e-4 (cuBLAS and the CPU BLAS sum in another order); the update
    rtol 1e-5 / atol 1e-6 (elementwise, the members ranked alike).
    Returns the worst |diff| of the returns and of the new mean."""
    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.algos.cma import CMAES
    from smarties_tpu_torch.envs import pendulum

    cfg = launch.load_recipe("CMA", 0)
    cfg.nnLayerSizes = [16, 16]
    P, T = cfg.ESpopSize, 32
    cpu, gpu = (CMAES(pendulum, pendulum.MDP, cfg, n_envs=2 * P, max_len=T,
                      device=d) for d in ("cpu", "cuda"))
    rng = np.random.RandomState(0)
    n = cpu.unravel.n
    z0 = torch.as_tensor(rng.randn(P, n).astype(np.float32))
    z1 = torch.as_tensor(rng.randn(P, n).astype(np.float32))
    noise = torch.as_tensor(np.clip(rng.randn(T, 2 * P, 1), -3, 3)
                            .astype(np.float32))
    st = cpu.init(z=z0)
    es = pendulum.init(torch.Generator().manual_seed(0), 2 * P, "cpu")
    out = {}
    for tr, dev in ((cpu, "cpu"), (gpu, "cuda")):
        st_d = type(st)(*(x.to(dev) for x in st))
        es_d = type(es)(*(x.to(dev) for x in es))
        _, rsum, rcnt, (ssum, ssq, _) = tr._generation_rollout(
            st_d, es_d, T, noise=noise.to(dev))
        losses = -rsum / torch.clamp(rcnt, min=1).to(torch.float32)
        new = tr._cma_update(st_d, losses, z=z1.to(dev))
        out[dev] = ({"rsum": rsum, "ssum": ssum, "ssq": ssq},
                    rcnt, {k: getattr(new, k) for k in
                           ("mean", "diag_cov", "path_cov", "pop")})
    (c_roll, c_cnt, c_new), (g_roll, g_cnt, g_new) = out["cpu"], out["cuda"]
    assert torch.equal(g_cnt.cpu(), c_cnt) and int(c_cnt.sum()) == 2 * P
    for k in c_roll:
        torch.testing.assert_close(g_roll[k].cpu(), c_roll[k], rtol=1e-4,
                                   atol=1e-4, msg=lambda m: f"{k}: {m}")
    for k in c_new:
        torch.testing.assert_close(g_new[k].cpu(), c_new[k], rtol=1e-5,
                                   atol=1e-6, msg=lambda m: f"{k}: {m}")
    return {"returns": float((g_roll["rsum"].cpu() - c_roll["rsum"])
                             .abs().max()),
            "mean": float((g_new["mean"].cpu() - c_new["mean"]).abs().max())}


def phase_cma():
    """CMA-ES (recipe CMA) on cartpole through the launcher, 1020 lanes
    (85 per member), 5 generations; then one generation against the
    CPU."""
    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk

    name = "cma"
    runs = os.path.join(ROOT, "build", "chip_smoke_runs")
    args = launch.parse_args([
        "cartpole", "--recipe", "CMA", "--device", "cuda", "--nEnvironments",
        str(CMA_ENVS), "--nTrainSteps", str(CMA_GENERATIONS), "--runprefix",
        runs, "--runname", name])
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    cma = launch.run(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dict(rk.launches)
    rets = cma.evaluate(8, max_steps=200)
    assert type(cma).__name__ == "CMAES", type(cma)
    assert (cma.P, cma.cfg.batchSize, cma.eps_per_gen) == (12, 32, 384)
    assert cma.n_generations == CMA_GENERATIONS == int(cma.state.gen)
    for k in ("mean", "diag_cov", "path_cov", "pop"):
        assert torch.isfinite(getattr(cma.state, k)).all(), k
    assert np.isfinite(rets).all() and rets.shape == (8,), rets
    assert sum(counts.values()) == 0, counts
    hist = cma.history
    assert all(np.isfinite([h["avgR"], h["best"]]).all() for h in hist)
    worst = _cma_generation_vs_cpu()
    gens = " ".join(f"{i + 1}:{h['avgR']:.2f}/{h['best']:.2f}/"
                    f"{h['wall_s'] * 1e3:.1f}ms" for i, h in enumerate(hist))
    print(f"cma: {name} (CMAES, cartpole, {cma.cfg.nnLayerSizes}, population "
          f"{cma.P} of {cma.unravel.n} weights, {cma.eps_per_gen} episodes "
          f"a generation, {CMA_ENVS} envs): generation:avgR/best/ms "
          f"{gens} | {cma.n_env_steps} env steps | launch.run {run_s:.2f} s "
          f"| evaluate(8, 200) of the mean {float(np.mean(rets)):.2f} | K1 "
          f"launches {counts} (CMA runs no return sweep) | one generation "
          f"card vs CPU (pendulum, 24 lanes x 32 steps, noise injected) max "
          f"|diff| {_fmt_diffs(worst)}", flush=True)
    return {"ms_per_generation": [h["wall_s"] * 1e3 for h in hist],
            "avgR": [h["avgR"] for h in hist], "run_s": run_s,
            "card_vs_cpu": worst}


# ---------------------------------------------------------------------
# the external-env runtime: the Engine serving forked and native apps

class EngineProbe:
    """The prepare(engine) hook of an Engine run: per learner it counts
    K1's launches at each site (a commit launches `batched_retrace`
    once; initialize_stats and a refresh launch `retrace_sweep_` once)
    and checks them call by call, times the train chunks by CUDA events
    and each round's act by the host clock (the act ends in its one read
    of the device), and notes when the statistics start."""

    SITES = {"commit": "batched_retrace",
             "initialize_stats": "retrace_sweep",
             "refresh": "retrace_sweep"}

    def __init__(self, rk):
        self.rk = rk
        self.calls = {k: 0 for k in self.SITES}
        self.chunks, self.act_s, self.act_lanes = [], [], []
        self.commit_s = []
        self.t_start = self.init_at = None
        self.restored_grad = []

    def __call__(self, engine):
        self.t_start = time.perf_counter()
        for b in engine.learners:
            self.restored_grad.append(b.n_grad)
            b.commit = self._count(b.commit, "commit")
            b._init_stats = self._count(b._init_stats, "initialize_stats",
                                        b)
            b._refresh = self._count(b._refresh, "refresh")
            b._train_chunk = self._timed_chunk(b._train_chunk)
            b.act = self._timed_act(b.act)

    def _count(self, fn, site, bundle=None):
        entry = self.SITES[site]

        def counted(*a, **kw):
            before = dict(self.rk.launches)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if site == "commit":
                self.commit_s.append(time.perf_counter() - t0)
            made = {k: self.rk.launches[k] - before[k] for k in before}
            assert made[entry] == 1 == sum(made.values()), \
                f"{site}: K1 launches {made}, want one {entry}"
            self.calls[site] += 1
            if bundle is not None:
                self.init_at = (time.perf_counter(), bundle.n_env_steps,
                                len(self.act_lanes), len(self.commit_s))
            return out
        return counted

    def _timed_chunk(self, fn):
        import torch

        def timed(n):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(n)
            e1.record()
            self.chunks.append((e0, e1, n))
            return out
        return timed

    def _timed_act(self, fn):
        def timed(obs_rows, ready_rows=None):
            t0 = time.perf_counter()
            out = fn(obs_rows, ready_rows)
            self.act_s.append(time.perf_counter() - t0)
            self.act_lanes.append(len(obs_rows) if ready_rows is None
                                  else len(ready_rows))
            return out
        return timed

    def grad_steps(self):
        return sum(n for _, _, n in self.chunks)

    def ms_per_grad_step(self):
        import torch
        torch.cuda.synchronize()
        n = self.grad_steps()
        return (sum(e0.elapsed_time(e1) for e0, e1, _ in self.chunks) / n
                if n else float("nan"))

    def act_ms(self):
        return (statistics.median(self.act_s) * 1e3 if self.act_s
                else float("nan"))

    def lanes_per_round(self):
        """Mean count of the lanes an act served (those ready that round)."""
        return (statistics.mean(self.act_lanes) if self.act_lanes
                else float("nan"))

    def fill(self):
        """From the first round to the start of the statistics (the
        replay filling to minTotObsNum): env steps per second, rounds,
        mean lanes served a round, and per round the host ms of the acts,
        of the commits (enqueue: a commit reads nothing back) and of the
        rest (the poll, the events, the replies)."""
        t, steps, rounds, commits = self.init_at
        wall = t - self.t_start
        act = sum(self.act_s[:rounds])
        commit = sum(self.commit_s[:commits])
        return {"env_steps_per_s": steps / wall, "rounds": rounds,
                "lanes_per_round": statistics.mean(self.act_lanes[:rounds]),
                "commits": commits,
                "act_ms_per_round": act / rounds * 1e3,
                "commit_ms_per_round": commit / rounds * 1e3,
                "rest_ms_per_round": (wall - act - commit) / rounds * 1e3}


def _engine(cfg, n_envs, max_len, steps, run_dir=None):
    from smarties_tpu_torch.runtime.engine import Engine
    e = Engine([], device="cuda")
    e.setSettings(cfg)
    e.setNEnvironments(n_envs)
    e.setMaxEpisodeLength(max_len)
    e.setNTrainSteps(steps)
    e.run_dir = run_dir
    return e


def _app(name):
    import runpy
    return runpy.run_path(os.path.join(ROOT, "apps", name, "exec.py"))


def _reward_rows(run_dir):
    import numpy as np
    return np.loadtxt(os.path.join(
        run_dir, "agent_00_rank00_cumulative_rewards.dat"), ndmin=2)


def phase_engine_k1():
    """K1's batched_retrace on one row-major slot, the Engine's commit:
    [1, 1025] and [1, 257], lengths full, ragged and 0, both terminal
    kinds, rho the Engine's indicator and a random one: bit-equal to the
    plain version. Times at a ragged and a full length, cold L2, beside
    the bound of the bytes."""
    import numpy as np
    import torch
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.ops import returns as ret
    from smarties_tpu_torch.runtime import bench_retrace as bench

    dev = torch.device("cuda")
    rng = np.random.RandomState(5)
    rows, n_checked = [], 0
    for L1 in ENGINE_K1_L1:
        for T in (L1 - 1, int(0.7 * (L1 - 1)), 1, 0):
            for term in (True, False):
                for kind in ("indicator", "random"):
                    row = lambda x: torch.as_tensor(
                        np.asarray(x, np.float32)[None], device=dev)
                    rho = (row(np.arange(L1) < T) if kind == "indicator"
                           else row(np.exp(rng.randn(L1))))
                    args = (row(rng.randn(L1)), row(rng.randn(L1)),
                            row(rng.randn(L1)), rho,
                            torch.tensor([T], dtype=torch.int32, device=dev),
                            torch.tensor([term], device=dev), 0.995, 0.95,
                            "retrace")
                    got = rk.batched_retrace(*args)
                    want = ret.batched_retrace_plain(*args)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), \
                        f"batched_retrace [1, {L1}] T={T} terminal={term} " \
                        f"rho {kind}: not bit-equal, max |diff| " \
                        f"{float((got - want).abs().max()):.3e}"
                    n_checked += 1
        for T in (int(0.7 * (L1 - 1)), L1 - 1):
            r = bench.measure_row(dev, L1, T, False)
            rows.append(r)
            print(f"engine K1: batched_retrace retrace [1, {L1}] T={T} "
                  f"truncated: kernel {r['ms']:.4f} ms | plain torch "
                  f"version {r['plain_ms']:.4f} ms | {r['bytes']} B, bound "
                  f"{r['bound_ms'] * 1e6:.2f} ns, share of bound "
                  f"{r['share_of_bound']:.2e}", flush=True)
    print(f"engine K1: batched_retrace bit-equal to its plain version in "
          f"{n_checked} cases at [1, L1] for L1 in {ENGINE_K1_L1}: T in "
          f"(L1-1, 0.7 (L1-1), 1, 0), terminal and truncated, rho the "
          f"Engine's indicator and random", flush=True)
    return {"rows": rows, "max_abs_err": 0.0}


def phase_engine_main():
    """V-RACER at full width over 16 forked apps/cart_pole_py apps, event
    serving: train to 2000 grad steps (checkpoint.pt), restart for 500
    more, serve 8 eval episodes with no grad step. K1 per site."""
    import shutil

    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk

    run_dir = os.path.join(ROOT, "build", "chip_smoke_runs", "engine")
    shutil.rmtree(run_dir, ignore_errors=True)
    app = _app("cart_pole_py")["app_main"]
    cfg = launch.load_recipe("VRACER", 0)
    cfg.minTotObsNum = ENGINE_MIN_OBS
    assert (cfg.nnLayerSizes, cfg.nnFunc, cfg.batchSize, cfg.obsPerStep) \
        == ([128, 128], "SoftSign", 256, 1.0), cfg
    out = {}
    counts = {}
    for stage, steps in (("train", ENGINE_STEPS),
                         ("restart", ENGINE_STEPS + ENGINE_MORE),
                         ("eval", None)):
        c = cfg
        if stage == "eval":
            c = launch.load_recipe("VRACER", 0)
            c.minTotObsNum, c.bTrain = ENGINE_MIN_OBS, False
        e = _engine(c, ENGINE_ENVS, ENGINE_MAX_LEN,
                    steps or 10 ** 9, run_dir)
        if stage != "train":
            e.setRestartFolderPath(os.path.join(run_dir, "checkpoint.pt"))
        if stage == "eval":
            e.setNumEvaluationEpisodes(ENGINE_EVAL)
            n_rows = len(_reward_rows(run_dir))
        probe = EngineProbe(rk)
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        e.run(app, prepare=probe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[stage] = dict(rk.launches)
        b = e.learners[0]
        assert (b.rs.n_slots, b.rs.max_len) == (MAIN_E, ENGINE_MAX_LEN), \
            (b.rs.n_slots, b.rs.max_len)
        for k, p in _leaves(b.params):
            assert torch.isfinite(p).all(), f"engine {stage}: param {k}"
        assert counts[stage] == {
            "batched_retrace": probe.calls["commit"],
            "retrace_sweep": probe.calls["initialize_stats"]
            + probe.calls["refresh"], "affine_suffix_scan": 0}, \
            (stage, counts[stage], probe.calls)
        assert probe.calls["commit"] > 0, stage
        res = {"wall_s": wall, "calls": dict(probe.calls),
               "launches": counts[stage], "grad_steps": probe.grad_steps(),
               "act_ms_median": probe.act_ms(), "rounds": len(probe.act_s),
               "lanes_per_round": probe.lanes_per_round()}
        if stage == "train":
            assert e.n_grad_steps == ENGINE_STEPS, e.n_grad_steps
            assert probe.calls["initialize_stats"] == 1
            assert probe.calls["refresh"] == ENGINE_STEPS // 1000
            assert os.path.exists(os.path.join(run_dir, "checkpoint.pt"))
            res["fill"] = probe.fill()
            res["fill_env_steps"] = probe.init_at[1]
        elif stage == "restart":
            assert probe.restored_grad == [ENGINE_STEPS], probe.restored_grad
            assert e.n_grad_steps == ENGINE_STEPS + ENGINE_MORE
            assert probe.calls["initialize_stats"] == 0
            # the JAX Engine's restore leaves last_refresh at 0: one refresh
            # at the first chunk after the restart
            assert probe.calls["refresh"] == 1, probe.calls
        else:
            assert probe.grad_steps() == 0 and probe.chunks == []
            assert e.n_grad_steps == ENGINE_STEPS + ENGINE_MORE
            assert probe.calls["refresh"] == probe.calls[
                "initialize_stats"] == 0
            assert len(_reward_rows(run_dir)) - n_rows >= ENGINE_EVAL
        if stage != "eval":
            res["ms_per_grad_step"] = probe.ms_per_grad_step()
        out[stage] = res
    rows = _reward_rows(run_dir)
    assert np.isfinite(rows).all()
    train_rows = rows[:len(rows) - out["eval"]["calls"]["commit"]]
    eval_rows = rows[len(train_rows):]
    out["trailing_return_train"] = float(np.mean(train_rows[-20:, 4]))
    out["eval_returns"] = eval_rows[:, 4].tolist()
    tr, rs = out["train"], out["restart"]
    print(f"engine main: V-RACER [128, 128] SoftSign, batch 256, obsPerStep "
          f"1, minTotObsNum {ENGINE_MIN_OBS}, {ENGINE_ENVS} forked "
          f"apps/cart_pole_py apps, event serving, max_ep_len "
          f"{ENGINE_MAX_LEN} ({MAIN_E} x {ENGINE_MAX_LEN + 1} slots) | "
          f"fill {tr['fill_env_steps']} env steps at "
          f"{tr['fill']['env_steps_per_s']:.1f} env steps/s in "
          f"{tr['fill']['rounds']} rounds of "
          f"{tr['fill']['lanes_per_round']:.2f} lanes and "
          f"{tr['fill']['commits']} commits; host ms a round: act "
          f"{tr['fill']['act_ms_per_round']:.3f}, commits "
          f"{tr['fill']['commit_ms_per_round']:.3f}, the rest "
          f"{tr['fill']['rest_ms_per_round']:.3f} | train to "
          f"{ENGINE_STEPS}: {tr['ms_per_grad_step']:.3f} ms/grad step by "
          f"events, act {tr['act_ms_median']:.3f} ms/round (median of "
          f"{tr['rounds']} rounds, {tr['lanes_per_round']:.2f} lanes served "
          f"a round), run {tr['wall_s']:.2f} s, K1 {tr['launches']} "
          f"for calls {tr['calls']} | restart to {ENGINE_STEPS + ENGINE_MORE}"
          f": {rs['ms_per_grad_step']:.3f} ms/grad step, act "
          f"{rs['act_ms_median']:.3f} ms/round, run {rs['wall_s']:.2f} s, "
          f"K1 {rs['launches']} for calls {rs['calls']} | eval "
          f"{len(out['eval_returns'])} episodes, no grad step, returns "
          f"{[round(x, 1) for x in out['eval_returns']]}, act "
          f"{out['eval']['act_ms_median']:.3f} ms/round | trailing-20 "
          f"training return {out['trailing_return_train']:.2f}", flush=True)
    return out


def _bundle_card_vs_cpu():
    """The same three episodes committed into a bundle on each device
    (from one snapshot), the statistics started, 8 train steps on the
    same pinned samples: the worst |diff| of params and replay fields.
    Tolerances as _card_vs_cpu's."""
    import numpy as np
    import torch
    from smarties_tpu_torch.runtime import engine as eng
    from smarties_tpu_torch.runtime.communicator import spec_to_mdp
    from smarties_tpu_torch.models import convert
    from smarties_tpu_torch.utils.config import HyperParameters

    spec = {"dim_state": 6, "dim_action": 1, "bounded": (True,),
            "upper": (10.0,), "lower": (-10.0,), "discrete_values": (),
            "observable": (True, True, False, True, True, True),
            "n_agents": 1, "n_appended_obs": 0, "agent_overrides": {},
            "different_mdps": False}
    cfg = HyperParameters(minTotObsNum=64, maxTotObsNum=4096, batchSize=32,
                          nnLayerSizes=[128, 128], randSeed=0)
    max_len = 256
    cpu, gpu = (eng._LearnerBundle(0, spec_to_mdp(spec), cfg, [0], max_len,
                                   device=d) for d in ("cpu", "cuda"))
    gpu.restore(cpu.snapshot())
    rng = np.random.RandomState(0)
    eps = []
    for T, term in ((200, True), (37, False), (max_len, False)):
        asm = eng._EpisodeAssembler()
        asm.add_state(rng.randn(5).astype(np.float32), 0.0)
        for _ in range(T):
            asm.add_action(rng.randn(1).astype(np.float32),
                           np.asarray([rng.randn(), 0.3 + rng.rand()],
                                      np.float32),
                           float(rng.randn()), float(rng.randn()))
            asm.add_state(rng.randn(5).astype(np.float32),
                          float(rng.randn()))
        eps.append(asm.finalize(term, max_len))
    for b in (cpu, gpu):
        for *arrs, T, term, _ in eps:
            b.commit(arrs, T, term)
            b.n_env_steps += T
    commit_q = [convert.replay_to_numpy(b.rs)["qret"] for b in (cpu, gpu)]
    lens = convert.replay_to_numpy(cpu.rs)["length"]
    valid = np.nonzero(convert.replay_to_numpy(cpu.rs)["ep_id"] >= 0)[0]
    pre = []
    for _ in range(8):
        pairs = set()
        while len(pairs) < cfg.batchSize:
            e = int(rng.choice(valid))
            pairs.add((e, int(rng.randint(0, lens[e]))))
        pre.append(list(zip(*sorted(pairs))))
    ep, t = (torch.tensor(np.asarray(x), dtype=torch.int32)
             for x in zip(*pre))
    for b in (cpu, gpu):
        b.maybe_init_stats()
        assert b.initialized
        b.start_env_steps = b.n_env_steps - 8
        b.sample_indices = lambda n, b=b: (ep[:n].to(b.device),
                                           t[:n].to(b.device))
        b.train_to_pace(10 ** 9)
        assert b.n_grad == 8
    worst = {"commit_qret": float(np.abs(commit_q[1] - commit_q[0]).max()),
             "params": 0.0}
    got_p = dict(_leaves(gpu.params))
    for k, p in _leaves(cpu.params):
        g = got_p[k].detach().cpu()
        torch.testing.assert_close(g, p.detach(), rtol=1e-4, atol=1e-6,
                                   msg=lambda m: f"param {k}: {m}")
        worst["params"] = max(worst["params"],
                              float((g - p.detach()).abs().max()))
    want = convert.replay_to_numpy(cpu.rs)
    got = convert.replay_to_numpy(gpu.rs)
    for k in convert.REPLAY_FIELDS:
        atol = 2e-3 if k in ("qret", "delta", "value", "v_trunc",
                             "max_abs_error") else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol,
                                   err_msg=f"replay field {k}")
        if k in ("qret", "rho", "value", "states"):
            worst[k] = float(np.abs(got[k] - want[k]).max())
    assert worst["commit_qret"] == 0.0, worst
    return worst


def phase_engine_paths():
    """The bundle on the card against the CPU; LSTM serving over forked
    apps; the native C++ client over sockets and its distributed-agent
    team; a crash after CUDA is up, respawned; CMA over external apps."""
    import shutil

    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.algos.cma import CMAES
    from smarties_tpu_torch.models.net import tree_leaves
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.runtime.env_pool import EnvPool
    from smarties_tpu_torch.runtime.socket_pool import SocketEnvPool
    from smarties_tpu_torch.utils.config import HyperParameters

    out = {"card_vs_cpu": _bundle_card_vs_cpu()}
    print(f"engine card vs CPU: one bundle per device from one snapshot, 3 "
          f"episodes committed (K1 at [1, 257]), the statistics started, 8 "
          f"pinned train steps ([128, 128], batch 32): max |diff| "
          f"{_fmt_diffs(out['card_vs_cpu'])}", flush=True)

    def run(name, e, app=None, pool=None, check=None):
        probe = EngineProbe(rk)
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        e.run(app, pool=pool, prepare=probe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(rk.launches)
        assert counts["batched_retrace"] == probe.calls["commit"] > 0, \
            (name, counts, probe.calls)
        assert counts["retrace_sweep"] == probe.calls["initialize_stats"] \
            + probe.calls["refresh"] >= 1, (name, counts, probe.calls)
        for b in e.learners:
            for k, p in _leaves(b.params):
                assert torch.isfinite(p).all(), f"{name}: param {k}"
        res = {"wall_s": wall, "launches": counts,
               "calls": dict(probe.calls),
               "ms_per_grad_step": probe.ms_per_grad_step(),
               "act_ms_median": probe.act_ms(),
               "n_grad_steps": e.n_grad_steps,
               "stored_steps": int(e.replay.n_stored_steps())}
        if check:
            check(e, res)
        out[name] = res
        print(f"engine {name}: {e.n_grad_steps} grad steps at "
              f"{res['ms_per_grad_step']:.3f} ms/step by events, act "
              f"{res['act_ms_median']:.3f} ms/round, stored steps "
              f"{res['stored_steps']}, run {wall:.2f} s | K1 {counts} for "
              f"calls {probe.calls}", flush=True)

    # LSTM serving: RACER_RNN over 4 forked apps; the contexts advance
    cfg = launch.load_recipe("RACER_RNN", 0)
    cfg.minTotObsNum = ENGINE_RNN_MIN_OBS

    def lstm_check(e, res):
        b = e.learners[0]
        assert b.algo.spec.kind == "LSTM" and len(b.rnn) == 2
        assert any(float(x.abs().sum()) > 0 for x in tree_leaves(b.rnn))
        assert e.n_grad_steps == ENGINE_SIDE_STEPS
    run("lstm", _engine(cfg, 4, 500, ENGINE_SIDE_STEPS),
        _app("cart_pole_py")["app_main"], check=lstm_check)

    # native: cart_pole_cpp over sockets, then the distributed-agent team
    build = os.path.join(ROOT, "build", "native")
    subprocess.run(["make", "-C", os.path.join(ROOT, "native"),
                    f"BUILD={build}"], check=True, capture_output=True,
                   timeout=300)
    cfg = launch.load_recipe("VRACER", 0)
    cfg.minTotObsNum = ENGINE_NATIVE_MIN_OBS
    pool = SocketEnvPool([os.path.join(build, "cart_pole_cpp")], n_envs=4)

    def native_check(e, res):
        assert e.n_grad_steps == ENGINE_SIDE_STEPS, e.n_grad_steps
    run("native", _engine(cfg, 4, 1024, ENGINE_SIDE_STEPS), pool=pool,
        check=native_check)
    team = SocketEnvPool([os.path.join(build, "cart_pole_distribAgent_cpp")],
                         n_envs=2, workers_per_env=3)

    def team_check(e, res):
        assert team.dist_agents and team.n_channels == 2 == team.n_lanes
        assert e.n_grad_steps == ENGINE_TEAM_STEPS
    run("native_team", _engine(cfg, 2, 1024, ENGINE_TEAM_STEPS), pool=team,
        check=team_check)

    # a crash after CUDA is up: the app dies once, is respawned by a fork
    crash_dir = os.path.join(ROOT, "build", "chip_smoke_runs", "crash")
    shutil.rmtree(crash_dir, ignore_errors=True)
    os.makedirs(crash_dir)
    sentinel = os.path.join(crash_dir, "crashed")
    crash = EnvPool(_crashing_app(sentinel), 2, seed=0)
    cfg = HyperParameters(minTotObsNum=256, maxTotObsNum=4096,
                          batchSize=32, nnLayerSizes=[128, 128])

    def crash_check(e, res):
        assert os.path.exists(sentinel) and crash._respawns[0] == 1, \
            crash._respawns
        assert e.n_grad_steps == ENGINE_TEAM_STEPS
        res["respawns"] = list(crash._respawns)
    run("crash", _engine(cfg, 2, 64, ENGINE_TEAM_STEPS), pool=crash,
        check=crash_check)

    # CMA over 8 forked apps/func_maximization apps
    app = _app("func_maximization")
    cfg = HyperParameters(learner="CMA", ESpopSize=8, batchSize=4,
                          explNoise=0.0, nnLayerSizes=[8], learnrate=0.05)
    pool = EnvPool(app["app_main"], n_envs=8)
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    try:
        cma = CMAES(None, pool.probe_spec(), cfg, n_envs=8, max_len=4,
                    device="cuda")
        cma.run_external(pool, CMA_EXT_GENERATIONS, log_every=10 ** 9)
    finally:
        pool.kill()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    avg = [h["avgR"] for h in cma.history]
    assert cma.n_generations == CMA_EXT_GENERATIONS == int(cma.state.gen)
    assert torch.isfinite(cma.state.mean).all() and np.isfinite(avg).all()
    assert np.mean(avg[-3:]) > np.mean(avg[:3]) + 0.1, avg
    assert sum(rk.launches.values()) == 0, rk.launches
    out["cma_external"] = {"avgR": avg, "wall_s": wall,
                           "ms_per_generation": [h["wall_s"] * 1e3
                                                 for h in cma.history]}
    print(f"engine cma_external: CMA (population 8, [8]) over 8 forked "
          f"apps/func_maximization apps, {CMA_EXT_GENERATIONS} generations "
          f"in {wall:.2f} s: avgR {avg[0]:.3f} -> {avg[-1]:.3f} (optimum 0)"
          f" | K1 launches 0", flush=True)
    shutil.rmtree(crash_dir)
    return out


def _crashing_app(sentinel):
    import numpy as np

    def app(comm):
        """Dies mid-episode once (the sentinel file marks the crash)."""
        comm.setStateActionDims(1, 1)
        comm.setActionScales([1.0], [-1.0], True)
        rng = np.random.RandomState(os.getpid())
        while True:
            x = rng.uniform(-1, 1)
            comm.sendInitState(np.array([x]))
            for t in range(10):
                a = comm.recvAction()
                x += 0.1 * float(a[0])
                if (comm.env_id == 0 and t == 3
                        and not os.path.exists(sentinel)):
                    open(sentinel, "w").close()
                    os._exit(1)
                (comm.sendLastState if t == 9 else comm.sendState)(
                    np.array([x]), -abs(x))
    return app


# ---------------------------------------------------------------------
# the glider, predator-prey, the competing-agents MultiTrainer and the
# trainer's logs

def _glider_states(rng, n):
    """[n, 6] glider states as numpy: the env's start draw, with a
    quarter of the lanes placed just above the ground and falling (most
    touch down inside the step, so their integration freezes after some
    of its 100 substeps) and an eighth already over (under the ground,
    or past x = 200: frozen from the first substep)."""
    import numpy as np
    q = np.zeros((n, 6), np.float32)
    q[:, 0:2] = rng.uniform(-0.1, 0.1, (n, 2))
    q[:, 3] = rng.uniform(-10.0, 10.0, n)
    q[:, 5] = rng.uniform(-np.pi, np.pi, n)
    near = np.arange(n) % 8 < 2
    k = int(near.sum())
    q[near, 0] = rng.uniform(0.0, 0.6, k)
    q[near, 1] = -np.sign(np.cos(q[near, 5])) * rng.uniform(0.6, 1.2, k)
    q[near, 2] = rng.uniform(-0.5, 0.5, k)
    q[near, 4] = rng.uniform(-49.95, -49.7, k)
    over = np.flatnonzero(np.arange(n) % 8 == 2)
    q[over[0::2], 4] = -50.5
    q[over[1::2], 3] = 201.0
    return q


def _glider_step_card_vs_cpu(n):
    """One glider env step from the same states on the card and on the
    CPU: done and terminal equal, states and rewards within 1e-4 of
    their scale (sin / cos / sqrt of the card and of the CPU differ in
    the last ulp over 600 derivative evaluations). Returns the counts of
    lanes that froze mid-step and from the start, and the worst
    differences."""
    import numpy as np
    import torch
    from smarties_tpu_torch.envs import glider

    rng = np.random.RandomState(17)
    q = _glider_states(rng, n)
    act = rng.uniform(-1.0, 1.0, (n, 1)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        st = glider.GliderState(q=torch.as_tensor(q, device=dev),
                                step=torch.zeros(n, dtype=torch.int32,
                                                 device=dev))
        st2, r, d, term = glider.step(st, torch.as_tensor(act, device=dev))
        out[dev] = [x.cpu() for x in (st2.q, r, d, term)]
    (qc, rc, dc, tc), (qg, rg, dg, tg) = out["cpu"], out["cuda"]
    assert torch.equal(dg, dc) and torch.equal(tg, tc), \
        "glider step: done / terminal differ between the card and the CPU"
    torch.testing.assert_close(qg, qc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(rg, rc, rtol=1e-4, atol=1e-4)
    start_over = glider._is_over_space(torch.as_tensor(q))
    return {"froze_mid_step": int((dc & ~start_over).sum()),
            "frozen_at_start": int(start_over.sum()),
            "max_abs_diff_q": float((qg - qc).abs().max()),
            "max_abs_diff_reward": float((rg - rc).abs().max())}


def _launcher_path(name, app, recipe, n_envs, n_steps, extra=()):
    """`launch.run` of a built-in app on the card with K1 counted per site,
    the warmup timed by the host clock (it reads the stored-step count
    back once per chunk) and the train call replaced by one timed fused
    cycle (train_fused, CUDA events). Returns (trainer, hooks, K1
    launches, wall s of the run)."""
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk

    runs = os.path.join(ROOT, "build", "chip_smoke_runs")
    args = launch.parse_args([
        app, "--recipe", recipe, "--device", "cuda", "--nEnvironments",
        str(n_envs), "--nTrainSteps", str(n_steps), "--runprefix", runs,
        "--runname", name, "--noCheckpoint", *extra])
    hooks = {}

    def prepare(tr):
        tr.log_flush_threshold = 10 ** 9
        hooks["sites"] = SiteCounter(tr, rk)
        _timed_fused(tr, hooks)
        warmup = tr.warmup

        def timed_warmup(*a, **kw):
            t0 = time.perf_counter()
            warmup(*a, **kw)
            torch.cuda.synchronize()
            hooks["warmup_s"] = time.perf_counter() - t0
            hooks["warmup_env_steps"] = tr.n_env_steps
        tr.warmup = timed_warmup

    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    tr = launch.run(args, prepare=prepare)
    torch.cuda.synchronize()
    return tr, hooks, dict(rk.launches), time.perf_counter() - t0


def phase_glider():
    """The glider through the launcher at the published RACER_glider
    settings with 1024 envs: warmup, one fused cycle of 1024 grad steps,
    evaluate(8, GLIDER_EVAL_STEPS); one K1 sweep launch per call of each
    site. Before it, one env step card against CPU from common,
    near-ground and over states, and the env step's launches and ms."""
    import shutil

    import numpy as np
    import torch
    from smarties_tpu_torch.envs import glider
    from smarties_tpu_torch.runtime import profile_main as pm

    name = "glider"
    ref = _glider_step_card_vs_cpu(GLIDER_ENVS)
    # the env step alone at 1024 lanes: events, host enqueue, launches
    st = glider.init(torch.Generator(device="cuda").manual_seed(0),
                     GLIDER_ENVS, "cuda")
    act = torch.zeros((GLIDER_ENVS, 1), device="cuda")
    step = lambda: glider.step(st, act)
    step()
    ev_ms, enq_ms, _ = pm.time_calls(step, 3)
    prof = pm.profile_calls(step, 1)

    print(f"glider: env step card vs CPU at {GLIDER_ENVS} lanes: done and "
          f"terminal equal ({ref['froze_mid_step']} lanes froze mid-step, "
          f"{ref['frozen_at_start']} from the start), max |diff| q "
          f"{ref['max_abs_diff_q']:.3e}, reward "
          f"{ref['max_abs_diff_reward']:.3e} | env step at {GLIDER_ENVS} "
          f"lanes: {ev_ms:.1f} ms by events, host enqueue {enq_ms:.1f} ms, "
          f"{prof['launches']:.0f} kernel launches, device busy "
          f"{prof['busy_ms']:.2f} ms (profiled wall {prof['wall_ms']:.1f} "
          f"ms)", flush=True)
    from smarties_tpu_torch.utils.recipes import RECIPES
    recipe = json.dumps(dict(RECIPES["RACER_glider"],
                             minTotObsNum=GLIDER_MIN_OBS))
    tr, hooks, counts, run_s = _launcher_path(
        name, "glider", recipe, GLIDER_ENVS, GLIDER_ENVS)
    sites, calls = dict(hooks["sites"].sites), dict(hooks["sites"].calls)
    t0 = time.perf_counter()
    rets = tr.evaluate(8, max_steps=GLIDER_EVAL_STEPS)
    eval_s = time.perf_counter() - t0
    _check_finite(name, tr, rets, 8)
    cfg = tr.cfg
    assert (cfg.nnLayerSizes, cfg.gamma, cfg.clipImpWeight, cfg.maxTotObsNum,
            cfg.minTotObsNum, tr.replay.n_slots, tr.replay.max_len + 1) == (
        [128, 128, 128], 1.0, 1.0, 524288, GLIDER_MIN_OBS, GLIDER_E,
        GLIDER_L1), cfg
    assert hooks["steps"] == GLIDER_ENVS and hooks["cycles"] == 1, hooks
    hooks["sites"].check_one_launch_per_call(
        counts, ("ingest", "initialize_stats", "refresh"), name)
    shutil.rmtree(tr.run_dir)
    ms_step = hooks["train_ms"] / hooks["steps"]
    print(f"glider: {name} (Racer, RACER_glider {cfg.nnLayerSizes}, batch "
          f"{cfg.batchSize}, gamma {cfg.gamma}, clipImpWeight "
          f"{cfg.clipImpWeight}, minTotObsNum {cfg.minTotObsNum}, "
          f"{GLIDER_ENVS} envs, {GLIDER_E} x {GLIDER_L1} slots): warmup {hooks['warmup_s']:.1f} s "
          f"({hooks['warmup_env_steps'] // GLIDER_ENVS} env sweeps, "
          f"{hooks['warmup_s'] * 1e3 / (hooks['warmup_env_steps'] // GLIDER_ENVS):.1f}"
          f" ms per sweep) | train_fused({GLIDER_ENVS}) "
          f"{hooks['train_ms']:.1f} ms by events ({ms_step:.3f} ms/grad "
          f"step) | launch.run {run_s:.2f} s | evaluate(8, "
          f"{GLIDER_EVAL_STEPS}) {eval_s:.2f} s, mean return "
          f"{float(np.mean(rets)):.2f} | stored steps "
          f"{int(tr.replay.n_stored_steps())} | K1 sweep launches by site "
          f"{sites} for calls {calls}, one per call", flush=True)
    res = {"sites": sites, "launches": counts["retrace_sweep"],
           "ms_per_grad_step": ms_step, "run_s": run_s,
           "env_step": {"lanes": GLIDER_ENVS, "ms": ev_ms,
                        "enqueue_ms": enq_ms, "launches": prof["launches"],
                        "busy_ms": prof["busy_ms"]},
           "warmup_s": hooks["warmup_s"], "card_vs_cpu": ref}
    del tr
    torch.cuda.empty_cache()
    return {name: res}


def phase_predator_prey():
    """Predator-prey through the launcher's Trainer: recipe VRACER, 1024
    lanes (512 envs x 2 agents sharing one learner): warmup, one fused
    cycle of 1024 grad steps, evaluate(8, 200); one K1 sweep launch per
    call of each site."""
    import shutil

    import numpy as np
    import torch
    from smarties_tpu_torch.envs import predator_prey as pp

    name = "predator_prey"
    tr, hooks, counts, run_s = _launcher_path(
        name, "predator_prey", "VRACER", PP_LANES, PP_LANES)
    sites, calls = dict(hooks["sites"].sites), dict(hooks["sites"].calls)
    rets = tr.evaluate(8, max_steps=pp.MAX_STEPS)
    _check_finite(name, tr, rets, 8)
    # zero-sum: each env's predator and prey returns cancel
    np.testing.assert_allclose(rets.reshape(-1, 2).sum(1), 0.0, atol=1e-3)
    assert (tr.replay.n_slots, tr.replay.max_len + 1) == (PP_E, PP_L1)
    assert hooks["steps"] == PP_LANES and hooks["cycles"] == 1, hooks
    hooks["sites"].check_one_launch_per_call(
        counts, ("ingest", "initialize_stats", "refresh"), name)
    shutil.rmtree(tr.run_dir)
    ms_step = hooks["train_ms"] / hooks["steps"]
    print(f"predator_prey: {name} (VRacer, VRACER {tr.cfg.nnLayerSizes}, "
          f"batch {tr.cfg.batchSize}, {PP_LANES} lanes = {PP_LANES // 2} "
          f"envs x 2 agents, {PP_E} x {PP_L1} slots): warmup "
          f"{hooks['warmup_s']:.2f} s | train_fused({PP_LANES}) "
          f"{hooks['train_ms']:.1f} ms by events ({ms_step:.3f} ms/grad "
          f"step) | launch.run {run_s:.2f} s | evaluate(8, 200) returns "
          f"{np.round(rets, 2).tolist()} | K1 sweep launches by site "
          f"{sites} for calls {calls}, one per call", flush=True)
    res = {"sites": sites, "launches": counts["retrace_sweep"],
           "ms_per_grad_step": ms_step, "run_s": run_s,
           "warmup_s": hooks["warmup_s"]}
    del tr
    torch.cuda.empty_cache()
    return {name: res}


def _pp_mdps():
    """tests/test_competing.py's per-agent MDPs (the prey's descriptor
    lists its observable dims)."""
    from smarties_tpu_torch.core.mdp import MDPSpec
    kw = dict(dim_state=4, dim_action=2, bounded=(True, True),
              upper_action=(1.0, 1.0), lower_action=(-1.0, -1.0),
              n_agents_per_env=2)
    return (MDPSpec(**kw), MDPSpec(**kw, observable=(True,) * 4))


def _multitrainer_roll_card_vs_cpu():
    """A MultiTrainer on the card against one on the CPU, deterministic
    acting, the same params and pinned starts, 8 envs: 201 sweeps (every
    lane truncates at step 200 and commits), then K1's at-ingest sweep
    per learner (the kernel on the card, its plain version on the CPU);
    both replays field by field (the tolerances of `_card_vs_cpu`).
    Returns the worst |diff| of states, qret and value."""
    import numpy as np
    import torch
    from smarties_tpu_torch.envs import predator_prey as pp
    from smarties_tpu_torch.models import convert
    from smarties_tpu_torch.runtime.multitrainer import MultiTrainer
    from smarties_tpu_torch.utils.config import HyperParameters

    def cfg():
        return HyperParameters(minTotObsNum=256, maxTotObsNum=4096,
                               batchSize=32, nnLayerSizes=[16, 16],
                               bTrain=False, randSeed=0)

    u0 = torch.as_tensor(np.random.RandomState(3).rand(8, 4)
                         .astype(np.float32))
    mts = []
    for dev in ("cpu", "cuda"):
        mt = MultiTrainer(pp, _pp_mdps(), [cfg(), cfg()], n_envs=8,
                          n_slots=64, max_len=pp.MAX_STEPS, device=dev)
        mt.carry = mt.carry._replace(env_state=pp.init(None, 16,
                                                       u_new=u0.to(dev)))
        if mts:
            mt.load(mts[0].state())
        mts.append(mt)
    for mt in mts:
        mt._roll(pp.MAX_STEPS + 1)
    worst = {}
    for a in range(2):
        want = convert.replay_to_numpy(mts[0].carry.replays[a])
        got = convert.replay_to_numpy(mts[1].carry.replays[a])
        assert want["length"].max() == pp.MAX_STEPS \
            and (want["ep_id"] >= 0).sum() == 8, want["length"]
        for k in convert.REPLAY_FIELDS:
            atol = 2e-3 if k in ("qret", "delta", "value", "v_trunc",
                                 "max_abs_error") else 1e-5
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=atol,
                                       err_msg=f"learner {a} field {k}")
            if k in ("states", "qret", "value"):
                worst[k] = max(worst.get(k, 0.0),
                               float(np.abs(got[k] - want[k]).max()))
    return worst


def phase_multitrainer():
    """Two V-RACER learners (recipe VRACER, [128, 128], batch 256) on
    predator-prey with the per-agent MDPs of tests/test_competing.py,
    512 envs (1024 lanes): warmup, train(1024) with only the predator
    learning, then only the prey, evaluate(8, 200). K1 launches counted
    per learner and site and held to what the code predicts: one
    ingest sweep per learner per roll, one initialize_stats each at the
    end of warmup, one refresh per learner per 1000 of its steps; the
    frozen learner's params bit-unchanged in each half. Before it, one
    roll card against CPU."""
    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.envs import predator_prey as pp
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.runtime.multitrainer import MultiTrainer

    name = "multitrainer"
    worst = _multitrainer_roll_card_vs_cpu()
    cfgs = [launch.load_recipe("VRACER", a) for a in range(2)]
    t0 = time.perf_counter()
    mt = MultiTrainer(pp, _pp_mdps(), cfgs, n_envs=MT_ENVS,
                      max_len=pp.MAX_STEPS, device="cuda")
    assert (mt.n_slots, mt.carry.replays[0].max_len + 1) == (PP_E, PP_L1)
    sites = [{} for _ in range(2)]
    calls = {"roll": 0}

    def counted(fn, a, site):
        def f(*args):
            n0 = sum(rk.launches.values())
            out = fn(*args)
            sites[a][site] = (sites[a].get(site, 0)
                              + sum(rk.launches.values()) - n0)
            calls[(a, site)] = calls.get((a, site), 0) + 1
            return out
        return f

    for a in range(2):
        mt._fix_returns[a] = counted(mt._fix_returns[a], a, "ingest")
        mt._init_stats[a] = counted(mt._init_stats[a], a,
                                    "initialize_stats")
        mt._refresh[a] = counted(mt._refresh[a], a, "refresh")
    roll = mt._roll

    def counted_roll(n):
        calls["roll"] += 1
        return roll(n)

    mt._roll = counted_roll
    cuda_lib.reset_launches()
    mt.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    rolls_warmup = calls["roll"]
    ms = []
    for mask in ([True, False], [False, True]):
        frozen = [k for k, m in enumerate(mask) if not m][0]
        before = [p.detach().clone() for _, p in _leaves(mt.params[frozen])]
        mt.train_mask = mask
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        mt.train(MT_STEPS)
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1) / MT_STEPS)
        after = [p for _, p in _leaves(mt.params[frozen])]
        assert all(torch.equal(x, y) for x, y in zip(before, after)), \
            f"learner {frozen} was frozen, but its params changed"
    counts = dict(rk.launches)
    t0 = time.perf_counter()
    rets = mt.evaluate(8, max_steps=pp.MAX_STEPS)
    eval_s = time.perf_counter() - t0
    assert rets.shape == (8, 2) and np.isfinite(rets).all(), rets
    np.testing.assert_allclose(rets.sum(1), 0.0, atol=1e-3)
    for a in range(2):
        for k, p in _leaves(mt.params[a]):
            assert torch.isfinite(p).all(), f"{name}: learner {a} param {k}"
    assert mt.n_grad_steps == [MT_STEPS, MT_STEPS], mt.n_grad_steps
    # what the code predicts, per learner: the calls of each site, and
    # one launch per call
    for a in range(2):
        want = {"ingest": calls["roll"], "initialize_stats": 1,
                "refresh": mt.n_grad_steps[a] // 1000}
        made = {k: calls.get((a, k), 0) for k in want}
        assert made == want == sites[a], (a, made, want, sites[a])
    assert counts["retrace_sweep"] == sum(counts.values()) \
        == sum(sum(s.values()) for s in sites), (counts, sites)
    with_rows = [len(mt._ep_returns[a]) for a in range(2)]
    print(f"multitrainer: card vs CPU, one roll to the truncation at step "
          f"200 (8 envs, [16, 16], deterministic acting, same params) and "
          f"K1's ingest sweep per learner: max |diff| "
          f"{_fmt_diffs(worst)}", flush=True)
    print(f"multitrainer: {name} (2 x VRacer, VRACER [128, 128], batch "
          f"{cfgs[0].batchSize}, {MT_ENVS} envs x 2 agents, {PP_E} x "
          f"{PP_L1} slots per learner): warmup {warmup_s:.2f} s "
          f"({rolls_warmup} rolls of 16 sweeps) | train({MT_STEPS}) "
          f"predator only {ms[0]:.3f} ms/grad step, prey only "
          f"{ms[1]:.3f} by events; the frozen learner's params "
          f"bit-unchanged in each | rolls {calls['roll']} | evaluate(8, "
          f"200) {eval_s:.2f} s, mean returns "
          f"{np.round(rets.mean(0), 3).tolist()} | episodes logged "
          f"{with_rows} | K1 sweep launches per learner by site "
          f"{sites}, as predicted (ingest = rolls, initialize_stats 1, "
          f"refresh = grad steps // 1000)", flush=True)
    res = {"sites": {f"learner{a}": sites[a] for a in range(2)},
           "launches": counts["retrace_sweep"], "rolls": calls["roll"],
           "ms_per_grad_step": ms, "warmup_s": warmup_s,
           "card_vs_cpu": worst}
    del mt
    torch.cuda.empty_cache()
    return {name: res}


def phase_logs():
    """The trainer's logs on the card: a short cart-pole run through the
    launcher with --logAllSamples, then log_status(full=True); the obs
    stream, the gradient rows, the stats and profiler tables written
    and parsed. Then two fused cycles under torch's sync debug mode: no
    synchronising call, while the profiler's events wait unread until
    its table is asked for."""
    import contextlib
    import io
    import shutil
    import warnings

    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.envs import cartpole

    name = "logs"
    runs = os.path.join(ROOT, "build", "chip_smoke_runs")
    recipe = json.dumps({"learner": "VRACER", "nnLayerSizes": [128, 128],
                         "minTotObsNum": 4096, "maxTotObsNum": 65536})
    args = launch.parse_args([
        "cartpole", "--recipe", recipe, "--device", "cuda",
        "--nEnvironments", str(LOGS_ENVS), "--nTrainSteps",
        str(LOGS_STEPS), "--runprefix", runs, "--runname", name,
        "--noCheckpoint", "--logAllSamples"])
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tr = launch.run(args)
        tr.log_status()
        tr.log_status(full=True)
    tr._obs_file.flush()
    run_s = time.perf_counter() - t0
    text = out.getvalue()
    assert tr.obs_log and tr.n_grad_steps == LOGS_STEPS
    for want in ("|  nEp |   nObs", "OFF-POLICY IMP WEIGHTS HISTOGRAM",
                 "profiler:", "ROLL", "TRAIN", "HOST"):
        assert want in text, f"{name}: {want!r} not printed:\n{text}"
    stats_line = text.splitlines()[text.splitlines().index(
        next(l for l in text.splitlines() if l.startswith("|  nEp"))) + 1]
    assert len(stats_line.split()) == 14, stats_line
    prof_lines = text.split("profiler:\n", 1)[1].strip().splitlines()
    dim_s = cartpole.MDP.dim_state_observed
    rows = np.fromfile(os.path.join(tr.run_dir, "agent_00_rank00_obs.raw"),
                       np.float32)
    assert rows.size % (dim_s + 3) == 0 and rows.size > 0, rows.size
    rows = rows.reshape(-1, dim_s + 3)
    status = rows[:, 1].astype(int)
    n_end = int(((status == 2) | (status == 3)).sum())
    assert (status == 0).sum() >= LOGS_ENVS and n_end > 0
    assert len(rows) == (status < 2).sum() + n_end
    assert np.isfinite(rows).all()
    assert set(np.unique(rows[:, 0]).astype(int)) == set(range(LOGS_ENVS))
    grads = np.fromfile(os.path.join(tr.run_dir, "grads_rank00.raw"),
                        np.float32).reshape(-1, 3)
    # one row per log_status
    np.testing.assert_array_equal(grads[:, 0], [LOGS_STEPS] * 2)
    assert np.isfinite(grads).all() and (grads[:, 1] > 0).all()

    # the cycle makes no host read: two fused cycles in torch's sync
    # debug mode (it flags the synchronising calls it knows of), the
    # CUDA runtime's synchronising calls counted in a profiler trace of
    # two more
    n_events0 = len(tr.profiler._events)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tr.train_fused(2 * LOGS_ENVS, log_every=10 ** 9, flush=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train_fused(2 * LOGS_ENVS, log_every=10 ** 9, flush=False)
    runtime = {}
    for e in prof.events():
        if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize", "cudaMemcpy",
                      "cudaMemcpyAsync"):
            runtime[e.name] = runtime.get(e.name, 0) + 1
    n_events = len(tr.profiler._events)
    assert not syncs, f"{name}: {len(syncs)} synchronising calls in the " \
        f"fused cycles: {syncs[:3]}"
    # the one device synchronize allowed is torch.profiler's own, which
    # its exit makes while it still records
    waits = (runtime.get("cudaStreamSynchronize", 0)
             + runtime.get("cudaEventSynchronize", 0)
             + runtime.get("cudaMemcpy", 0)
             + runtime.get("cudaDeviceSynchronize", 0) - 1)
    assert waits == 0, f"{name}: synchronising CUDA calls {runtime}"
    assert n_events == n_events0 + 8, (n_events0, n_events)
    table = tr.profiler.table()
    assert not tr.profiler._events and "TRAIN" in table
    n_rows_obs = len(rows)
    shutil.rmtree(tr.run_dir)
    print(f"logs: cartpole (VRACER [128, 128], {LOGS_ENVS} envs, "
          f"--logAllSamples, {LOGS_STEPS} grad steps) in {run_s:.2f} s: "
          f"agent_00_rank00_obs.raw {n_rows_obs} rows of {dim_s + 3} f32 "
          f"({int((status == 0).sum())} episode starts, {n_end} ends), "
          f"grads_rank00.raw rows {grads.tolist()}, stats row "
          f"'{stats_line.strip()}', profiler table "
          f"{[l.strip() for l in prof_lines]} | two fused cycles in sync "
          f"debug mode: 0 synchronising calls flagged; two more under "
          f"torch.profiler: CUDA runtime calls {runtime} (the one device "
          f"synchronize is the profiler's exit); "
          f"{n_events - n_events0} profiler event pairs left unread until "
          f"the table", flush=True)
    res = {"obs_rows": n_rows_obs, "grads_rows": grads.tolist(),
           "syncs_in_cycle": 0, "runtime_calls_in_2_cycles": runtime,
           "run_s": run_s}
    del tr
    torch.cuda.empty_cache()
    return {name: res}


def _mc_config():
    """The main path's settings (recipe VRACER at its published widths:
    [128, 128] SoftSign, batch 256, obsPerStep 1; minTotObsNum 16384)."""
    from smarties_tpu_torch.utils.config import HyperParameters
    return HyperParameters(minTotObsNum=16384, maxTotObsNum=262144,
                           batchSize=256, obsPerStep=1.0,
                           nnLayerSizes=[128, 128], randSeed=0)


def _mc_replicated(tr):
    """One flat f32 vector of what every rank must hold the same: the
    parameters, the Adam state, beta, alpha and the state and reward
    statistics."""
    import torch
    from smarties_tpu_torch.runtime.trainer import _plain
    rs = tr.replay
    parts = [x for _, x in _leaves(tr.params)]
    parts += [x for _, x in _leaves(_plain(tr.opt_state))]
    parts += [rs.beta, rs.alpha, rs.state_mean, rs.state_std, rs.rew_mean,
              rs.rew_std]
    return torch.cat([x.detach().float().reshape(-1) for x in parts])


def _mc_rank(rank, store, out_dir):
    """One learner rank of the multichip phase (a spawned process): the
    sharded Trainer on the card through gloo, warmup and train(MC_STEPS)
    with K1 counted per site and the grad steps timed, the replicated
    state compared across ranks on the card, then one pinned step whose
    inputs and result go to out_dir for the parent's single-process
    step."""
    import torch
    import torch.distributed as dist
    from smarties_tpu_torch.algos.base import presample_uniform
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.models.net import tree_map
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.parallel import mesh as pm
    from smarties_tpu_torch.parallel.multihost import init_multihost
    from smarties_tpu_torch.runtime.trainer import Trainer, _plain

    init_multihost(store, MC_RANKS, rank, backend="gloo",
                   timeout_s=MC_TIMEOUT_S)
    try:
        mesh = pm.make_mesh("cuda:0")
        cfg = _mc_config()
        tr = Trainer(cartpole, cartpole.MDP, cfg, n_envs=MC_ENVS,
                     n_slots=MC_SLOTS, max_len=cartpole.MAX_STEPS,
                     device=mesh.device, mesh=mesh)
        tr.log_flush_threshold = 10 ** 9
        assert tr.replay.rewards.shape == (MC_SLOTS // MC_RANKS, MAIN_L1)
        sites = SiteCounter(tr, rk)
        hooks = {"ms": 0.0, "steps": 0, "collectives": 0}
        chunk = tr._train_chunk

        def timed_chunk(n):
            c0 = sum(mesh.counts.values())
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = chunk(n)
            e1.record()
            e1.synchronize()
            hooks["ms"] += e0.elapsed_time(e1)
            hooks["steps"] += n
            hooks["collectives"] += sum(mesh.counts.values()) - c0
            return out
        tr._train_chunk = timed_chunk

        # the counts start at 0 here: warmup and train(MC_STEPS) are the
        # path's run
        cuda_lib.reset_launches()
        mesh.counts.clear()
        t0 = time.perf_counter()
        tr.warmup()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tr.train(MC_STEPS, log_every=10 ** 9)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts, by_kind = dict(rk.launches), dict(mesh.counts)
        # every grad step's tail on the kernel, its finish after the
        # collectives
        tail = _check_tail_launches(tr, f"multichip rank {rank}", mesh=True)
        _check_head_launches(tr, f"multichip rank {rank}", used=True)
        sites.check_one_launch_per_call(
            counts, ("ingest", "initialize_stats", "refresh"),
            f"multichip rank {rank}")
        assert sites.calls["initialize_stats"] == 1, sites.calls
        assert sites.calls["refresh"] == MC_STEPS // 1000, sites.calls
        stored, n_eps = tr._global_counts(tr.replay.n_stored_steps(),
                                          tr.replay.n_stored_eps())
        mine = _mc_replicated(tr)
        others = pm.all_gather(mesh, mine)
        assert all(torch.equal(x, mine) for x in others), \
            f"rank {rank}: the replicated state differs across ranks"
        assert torch.isfinite(mine).all(), f"rank {rank}: non-finite state"

        # one pinned step: its inputs for the parent's single-process step
        ep, t = presample_uniform(tr.gen_batch, tr.replay,
                                  cfg.batchSize // MC_RANKS, 1)
        rs = tr.replay
        cpu = lambda tree: tree_map(lambda x: x.detach().cpu(), _plain(tree))
        before = {"params": cpu(tr.params), "opt": cpu(tr.opt_state),
                  "replay": {f: getattr(rs, f).cpu()
                             for f in rs.__dataclass_fields__},
                  "ep": ep[0].cpu(), "t": t[0].cpu()}
        c0 = dict(mesh.counts)
        tr.params, tr.opt_state, _, _ = tr.algo.train_step(
            tr.params, tr.opt_state, rs, sample_override=(ep[0], t[0]),
            mesh=mesh)
        step_coll = {k: n - c0.get(k, 0) for k, n in mesh.counts.items()
                     if n > c0.get(k, 0)}
        mine = _mc_replicated(tr)
        assert all(torch.equal(x, mine) for x in pm.all_gather(mesh, mine)), \
            f"rank {rank}: the pinned step diverged across ranks"

        # what one gloo collective costs on CUDA tensors (each copies
        # through the host and synchronises): the gradient's flat buffer
        # and a 2-element count
        n_par = sum(p.numel() for _, p in _leaves(tr.params))
        cost = {}
        for what, n in (("grad_buffer", n_par), ("counts", 2)):
            x = torch.zeros(n, device=mesh.device)
            pm.psum_(mesh, x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                pm.psum_(mesh, x)
            torch.cuda.synchronize()
            cost[what] = (time.perf_counter() - t0) / 50 * 1e3
        torch.save({"rank": rank, "before": before,
                    "after": {"params": cpu(tr.params),
                              "opt": cpu(tr.opt_state)},
                    "launches": counts, "tail": tail,
                    "sites": dict(sites.sites),
                    "calls": dict(sites.calls),
                    "collectives_by_kind": by_kind,
                    "step_collectives": sum(step_coll.values()),
                    "step_collectives_by_kind": step_coll,
                    "chunk_ms": hooks["ms"], "chunk_steps": hooks["steps"],
                    "chunk_collectives": hooks["collectives"],
                    "warmup_s": warmup_s, "train_s": train_s,
                    "grad_steps": tr.n_grad_steps,
                    "env_steps": tr.n_env_steps, "global_stored": stored,
                    "global_eps": n_eps, "n_params": n_par,
                    "collective_ms": cost},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_multichip():
    """The learner mesh on the card: MC_RANKS gloo ranks on cuda:0
    (the host has one card, and NCCL takes one rank per card), spawned
    with torch.multiprocessing and joined through a file store under
    build/. The main path at full width: V-RACER on cart-pole, 1024 envs
    and 4096 x 501 slots in total ([2048, 501] per rank), batch 256 (128
    per rank). K1 against its plain version at [2048, 501] first, in the
    parent; then the ranks' warmup and train(MC_STEPS), which takes in
    one refresh with its rebalance; then one pinned step of the mesh
    against one single-process step on the card with the same global
    batch. A rank that dies, times out (MC_TIMEOUT_S per collective) or
    diverges fails the phase: mp.spawn raises."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from smarties_tpu_torch.algos.base import presample_uniform
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.models.convert import gather_replay
    from smarties_tpu_torch.models.net import tree_map
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.algos.vracer import VRacer
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.replay import buffer as rb
    from smarties_tpu_torch.runtime import bench_retrace as bench
    from smarties_tpu_torch.runtime.trainer import _restructure

    name = "multichip"
    dev = torch.device("cuda")
    E = MC_SLOTS // MC_RANKS
    # the launcher refuses more NCCL ranks than cards before any starts
    n_cards = torch.cuda.device_count()
    args = launch.parse_args([
        "cartpole", "--device", "cuda", "--nLearners", str(n_cards + 1),
        "--nEnvironments", str(8 * (n_cards + 1)), "--runprefix",
        os.path.join(ROOT, "build", "chip_smoke_runs")])
    try:
        launch.run(args)
        raise AssertionError(f"{name}: {n_cards + 1} NCCL ranks on "
                             f"{n_cards} card(s) did not raise")
    except ValueError as e:
        assert "one rank per card" in str(e), e
    rk.library()      # built here once; the ranks load it
    rng = np.random.RandomState(0)
    err = {"retrace_sweep": 0.0}

    def check(kname, got, want, what, exact):
        torch.cuda.synchronize()
        assert torch.equal(got, want), \
            f"{name}: {kname} {what} not bit-equal to the plain version"
        err[kname] = max(err[kname], float((got - want).abs().max())
                         if got.numel() else 0.0)
    _check_sweep(rng, E, MAIN_L1, dev, check)
    k1 = bench.measure_sweep_at(dev, E, MAIN_L1, "retrace")
    print(f"{name}: K1 retrace_sweep at a rank's [{E}, {MAIN_L1}]: "
          f"bit-equal to the plain version in 12 cases | kernel "
          f"{k1['ms']:.4f} ms (cold L2) | plain torch version "
          f"{k1['plain_ms']:.4f} ms | {k1['bytes']} B, bound "
          f"{k1['bound_ms'] * 1e3:.2f} us, share of bound "
          f"{k1['share_of_bound']:.3f}", flush=True)

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="multichip_", dir=build)
    try:
        t0 = time.perf_counter()
        mp.spawn(_mc_rank, args=("file://" + os.path.join(tmp, "store"),
                                 tmp), nprocs=MC_RANKS, join=True)
        ranks_s = time.perf_counter() - t0
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=True) for r in range(MC_RANKS)]
    finally:
        shutil.rmtree(tmp)

    # the same global batch in one process, on the card
    cfg = _mc_config()
    algo = VRacer(cartpole.MDP, cfg)
    params0, opt0 = algo.init(torch.Generator().manual_seed(0), dev)
    b = outs[0]["before"]
    params = tree_map(lambda x: x.to(dev).requires_grad_(True), b["params"])
    opt = _restructure(opt0, tree_map(lambda x: x.to(dev), b["opt"]))
    full = gather_replay([rb.ReplayState(**{
        f: x.to(dev) for f, x in o["before"]["replay"].items()})
        for o in outs])
    ep = torch.cat([o["before"]["ep"] + r * E
                    for r, o in enumerate(outs)]).to(dev)
    t = torch.cat([o["before"]["t"] for o in outs]).to(dev)
    p1, o1, _, _ = algo.train_step(params, opt, full,
                                   sample_override=(ep, t))
    worst = 0.0
    got = dict(_leaves(outs[0]["after"]["params"]))
    for k, want in _leaves(p1):
        g = got[k].to(dev)
        torch.testing.assert_close(g, want.detach(), rtol=MC_RTOL,
                                   atol=MC_ATOL,
                                   msg=lambda m: f"{name}: param {k}: {m}")
        worst = max(worst, float((g - want.detach()).abs().max()))
    for moment in ("m1", "m2"):
        got = dict(_leaves(outs[0]["after"]["opt"][moment]))
        for k, y in _leaves(getattr(o1, moment)):
            torch.testing.assert_close(
                got[k].to(dev), y, rtol=1e-3, atol=1e-9,
                msg=lambda m: f"{name}: Adam {moment} {k}: {m}")
    # the single-rank grad step at the same width, batch and replay
    pre = presample_uniform(torch.Generator(device=dev).manual_seed(1),
                            full, cfg.batchSize, MC_SINGLE_STEPS)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(MC_SINGLE_STEPS):
        p1, o1, full, _ = algo.train_step(p1, o1, full, sample_override=(
            pre[0][i], pre[1][i]))
    e1.record()
    e1.synchronize()
    single_ms = e0.elapsed_time(e1) / MC_SINGLE_STEPS

    launches = [o["launches"]["retrace_sweep"] for o in outs]
    ms_step = [o["chunk_ms"] / o["chunk_steps"] for o in outs]
    per_step = outs[0]["step_collectives"]
    o0 = outs[0]
    assert all(o["grad_steps"] == o0["grad_steps"] >= MC_STEPS
               and o["global_stored"] == o0["global_stored"] for o in outs)
    print(f"{name}: {MC_RANKS} gloo ranks on cuda:0, V-RACER cart-pole "
          f"{MC_ENVS} envs ({MC_ENVS // MC_RANKS} a rank), {MC_SLOTS} x "
          f"{MAIN_L1} slots ([{E}, {MAIN_L1}] a rank), batch "
          f"{cfg.batchSize} ({cfg.batchSize // MC_RANKS} a rank): warmup "
          f"{[round(o['warmup_s'], 2) for o in outs]} s, train({MC_STEPS}) "
          f"{[round(o['train_s'], 2) for o in outs]} s, ranks' processes "
          f"{ranks_s:.2f} s | {o0['grad_steps']} grad steps, "
          f"{o0['env_steps']} env steps, global stored steps "
          f"{o0['global_stored']} in {o0['global_eps']} episodes | params, "
          f"Adam state, beta, alpha and statistics equal across ranks "
          f"(torch.equal on the card)", flush=True)
    print(f"{name}: K1 sweep launches by rank {launches}, by site "
          f"{[o['sites'] for o in outs]} for calls "
          f"{[o['calls'] for o in outs]}, one per call | step-tail "
          f"launches by rank {[o['tail'] for o in outs]}, one grad_stats, "
          f"step_tail and finish a grad step", flush=True)
    print(f"{name}: ms per grad step by CUDA events in train's chunks "
          f"{[round(x, 4) for x in ms_step]} (ranks) | single-rank step at "
          f"the same width and batch on the gathered replay "
          f"{single_ms:.4f} ms | collectives per grad step {per_step} "
          f"({o0['step_collectives_by_kind']}), all {per_step} gloo host "
          f"round trips (gloo on CUDA tensors) | in train's chunks "
          f"{o0['chunk_collectives']} for {o0['chunk_steps']} steps | all "
          f"collectives of the run {o0['collectives_by_kind']} | one gloo "
          f"all-reduce: {o0['n_params']}-float gradient buffer "
          f"{o0['collective_ms']['grad_buffer']:.4f} ms, 2 counts "
          f"{o0['collective_ms']['counts']:.4f} ms (host clock) | NCCL "
          f"not measured (one card)", flush=True)
    print(f"{name}: pinned step of the mesh vs one single-process step "
          f"with the same global batch of {cfg.batchSize}: max |diff| of "
          f"params {worst:.3e} (rtol {MC_RTOL}, atol {MC_ATOL})",
          flush=True)
    torch.cuda.empty_cache()
    return {name: {"sites": {f"rank{r}": o["sites"]
                             for r, o in enumerate(outs)},
                   "launches": sum(launches),
                   "tail": [o["tail"] for o in outs],
                   "launches_by_rank": launches, "k1": k1,
                   "k1_max_abs_err": err["retrace_sweep"],
                   "ms_per_grad_step": ms_step,
                   "single_rank_ms_per_grad_step": single_ms,
                   "collectives_per_grad_step": per_step,
                   "gloo_round_trips_per_grad_step": per_step,
                   "collectives_by_kind": o0["collectives_by_kind"],
                   "collective_ms": o0["collective_ms"],
                   "pinned_step_max_abs_diff": worst,
                   "ranks_s": ranks_s}}


def phase_curves():
    """The learning-record tools on the card through their own command
    lines, at cut budgets; the files, keys and K1's launches checked; K1
    against its plain version at each run's replay shape."""
    import shutil

    import numpy as np
    import torch
    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.runtime import bench_retrace as bench
    from smarties_tpu_torch.tools import cma_func_max_record as cmarec
    from smarties_tpu_torch.tools import learning_curves as lc

    dev = torch.device("cuda")
    out = os.path.join(ROOT, "build", "chip_smoke_curves")
    card = lc.card(dev)
    jax_keys = {"name", "recipe", "env", "grad_steps", "env_steps",
                "episodes", "wall_s", "eval_mean", "eval_std"}
    port_keys = {"device", "power_limit", "budget", "wall_cap_s",
                 "stopped_by", "cuts", "deviations", "k1_launches",
                 "k1_calls", "k1_launches_by_entry", "replay"}
    rng = np.random.RandomState(22)
    err = {"retrace_sweep": 0.0}

    def check(kname, got, want, what, exact):
        torch.cuda.synchronize()
        assert torch.equal(got, want), \
            f"curves: {kname} {what} not bit-equal to the plain version"
        err[kname] = max(err[kname], float((got - want).abs().max())
                         if got.numel() else 0.0)

    results = {}
    for name, budget, steps, mode in CURVES_RUNS:
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        lc.main(["run", name, "--device", "cuda", "--budget", str(budget),
                 "--out", out])
        run_s = time.perf_counter() - t0
        counts, modes = dict(rk.launches), dict(rk.launch_modes)
        s = json.load(open(os.path.join(out, name, "summary.json")))
        rows = np.loadtxt(os.path.join(out, name, lc.REWARDS), ndmin=2)
        assert jax_keys | port_keys <= set(s), (name, sorted(s))
        assert rows.shape[1] == 5 and len(rows) == s["episodes"] >= 1, \
            (name, rows.shape, s["episodes"])
        assert np.isfinite(rows).all() and np.isfinite(s["eval_mean"]), name
        assert (s["grad_steps"], s["stopped_by"]) == (steps, "budget"), s
        assert (s["device"], s["power_limit"]) == (card["device"],
                                                   card["power_limit"]), s
        no_sweep = {"refresh"} if mode == "GAE" else set()
        assert set(s["k1_calls"]) == {"ingest", "initialize_stats",
                                      "refresh"}, s["k1_calls"]
        assert s["k1_launches"] == {
            k: 0 if k in no_sweep else n for k, n in s["k1_calls"].items()}, \
            (name, s["k1_launches"], s["k1_calls"])
        total = sum(s["k1_launches"].values())
        assert counts["retrace_sweep"] == sum(counts.values()) == total, \
            (name, counts, s["k1_launches"])
        assert s["k1_launches_by_entry"] == counts, (name, counts, s)
        assert modes == {"retrace": 0, "GAE": 0, mode: total}, (name, modes)
        E, L1 = s["replay"]
        err["retrace_sweep"] = 0.0
        _check_sweep(rng, E, L1, dev, check)
        k1 = dict(bench.measure_sweep_at(dev, E, L1, mode),
                  max_abs_err=err["retrace_sweep"])
        print(f"curves: {name} (learning_curves run --budget {budget}): "
              f"{s['grad_steps']} grad steps, {s['env_steps']} env steps, "
              f"{s['episodes']} episodes in {s['wall_s']} s (command "
              f"{run_s:.2f} s) | eval {s['eval_mean']} +- {s['eval_std']} "
              f"| K1 launches by site {s['k1_launches']} of calls "
              f"{s['k1_calls']}, by mode {modes} | K1 {mode} sweep at the "
              f"replay's [{E}, {L1}]: bit-equal to the plain version in 12 "
              f"cases | kernel {k1['ms']:.4f} ms (cold L2) | plain torch "
              f"version {k1['plain_ms']:.4f} ms | {k1['bytes']} B, bound "
              f"{k1['bound_ms'] * 1e3:.2f} us, share of bound "
              f"{k1['share_of_bound']:.3f}", flush=True)
        results[f"curves_{name}"] = {
            "sites": s["k1_launches"], "launches": total, "modes": modes,
            "k1": k1, "run_s": run_s, "grad_steps": s["grad_steps"],
            "eval_mean": s["eval_mean"]}

    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    cma_out = os.path.join(out, "cma_func_max")
    cmarec.main(["--device", "cuda", "--generations",
                 str(CURVES_CMA_GENERATIONS), "--out", cma_out])
    run_s = time.perf_counter() - t0
    s = json.load(open(os.path.join(cma_out, "summary.json")))
    curve = json.load(open(os.path.join(cma_out, "curve.json")))
    assert {"name", "recipe", "app", "dim", "generations",
            "final_avg_return", "final_objective", "proposed_x",
            "optimum_x", "solved", "device", "power_limit"} <= set(s), s
    assert [g for g, _ in curve] == list(
        range(1, CURVES_CMA_GENERATIONS + 1)), curve
    assert np.isfinite([r for _, r in curve] + [s["final_objective"]]).all()
    assert s["device"] == card["device"], s
    assert sum(rk.launches.values()) == 0, dict(rk.launches)
    print(f"curves: cma_func_max_record --generations "
          f"{CURVES_CMA_GENERATIONS}: avgR by generation "
          f"{[round(r, 4) for _, r in curve]}, objective "
          f"{s['final_objective']} at x {s['proposed_x']} (command "
          f"{run_s:.2f} s) | K1 launches 0 (CMA runs no return sweep)",
          flush=True)
    results["curves_cma_func_max"] = {"launches": 0, "run_s": run_s,
                                      "curve": curve}
    shutil.rmtree(out)
    return results


# the bench line's keys that must hold finite numbers (the Atari MFU and
# Adam floor may be null for a card missing from the bench's tables, with
# the reason in atari_peak_note)
BENCH_KEYS = ("combined_env_steps_per_s", "combined_grad_steps_per_s",
              "fused_cycle_ms", "fused_cycle_ms_min", "fused_cycle_ms_median",
              "fused_cycle_ms_max", "rollout_env_steps_per_s",
              "train_chunk_grad_steps_per_s", "atari_train_step_ms",
              "atari_grad_steps_per_s", "atari_flops_per_step_g",
              "atari_tflops_achieved", "setup_s", "wall_s")
BENCH_PEAK_KEYS = ("atari_mfu_vs_f32_peak", "atari_adam_hbm_floor_ms",
                   "atari_adam_hbm_floor_frac")


def phase_bench():
    """The port's bench through its `run` at full width with cut
    repetitions; the line's keys, K1's launches by site and phase; then
    the serving bench."""
    import math

    from smarties_tpu_torch import bench
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.tools import serving_bench

    counters = {}

    def hook(tr, phase):
        counters[phase] = SiteCounter(tr, rk)

    t0 = time.perf_counter()
    line, errors = bench.run(
        bench.Sizes(fused_cycles=BENCH_CYCLES,
                    atari_steps=BENCH_ATARI_STEPS),
        seeds=(0,), quality_cycles=BENCH_QUALITY_CYCLES, device="cuda",
        partial_path=os.path.join(ROOT, "build", "chip_smoke_bench.json"),
        hook=hook)
    bench_s = time.perf_counter() - t0
    assert errors == [], errors
    assert len(line) <= bench.LINE_BUDGET, len(line)
    doc = json.loads(line)
    assert set(doc) == {"metric", "value", "unit", "vs_baseline",
                        "extras"}, sorted(doc)
    ex = doc["extras"]
    for k in BENCH_KEYS:
        assert isinstance(ex.get(k), (int, float)) and math.isfinite(ex[k]), \
            (k, ex.get(k))
    for k in BENCH_PEAK_KEYS:
        assert (isinstance(ex.get(k), float) and math.isfinite(ex[k])) or (
            k in ex and ex[k] is None and "atari_peak_note" in ex), (k, ex)
    assert doc["value"] == ex["combined_env_steps_per_s"] > 0, doc["value"]
    assert ex["fused_cycles"] == BENCH_CYCLES, ex
    assert ex["skipped_for_budget"] == [], ex["skipped_for_budget"]
    assert ex["quality_seeds"] == [0] and ex["quality_cycles"] == \
        BENCH_QUALITY_CYCLES, ex
    assert ex["quality_grad_steps"] == [
        BENCH_QUALITY_CYCLES * bench.Sizes().n_envs], ex
    assert ex["cut_by_wall_s"] == [False], ex
    assert "episodes_to_threshold" in ex and "final_trail_mean" in ex, ex
    ev = ex["eval_mean_deterministic"][0]
    assert isinstance(ev, float) and math.isfinite(ev), ex
    # K1: one sweep launch per site call, and the calls the code makes:
    # fused: 1 warmup roll of 16 sweeps + 1 untimed and BENCH_CYCLES timed
    # cycles at ingest, a refresh after each cycle (1024 steps cross a
    # 1000-step boundary); quality: 64 blind sweeps in rolls of 16
    want_calls = {
        "fused": {"ingest": 2 + BENCH_CYCLES, "initialize_stats": 1,
                  "refresh": 1 + BENCH_CYCLES},
        "quality0": {"ingest": bench.Sizes().quality_sweeps // 16
                     + BENCH_QUALITY_CYCLES,
                     "initialize_stats": 1,
                     "refresh": BENCH_QUALITY_CYCLES}}
    k1 = ex["k1_launches"]
    for phase, want in want_calls.items():
        c = counters[phase]
        assert c.calls == want, (phase, c.calls, want)
        assert c.sites == c.calls, (phase, c.sites, c.calls)
        assert k1[phase] == sum(c.sites.values()), (phase, k1, c.sites)
    assert k1["steady"] == k1["atari"] == 0, k1
    print(f"bench: the port's bench at full width ({BENCH_CYCLES} timed "
          f"fused cycles, Atari {BENCH_ATARI_STEPS} steps, quality seed 0 "
          f"x {BENCH_QUALITY_CYCLES} cycles) in {bench_s:.2f} s | line of "
          f"{len(line)} characters: {line}", flush=True)
    print(f"bench: K1 launches by phase {k1}; by site, fused "
          f"{counters['fused'].sites}, quality0 "
          f"{counters['quality0'].sites}, one per call", flush=True)

    t1 = time.perf_counter()
    srv = serving_bench.serve(SERVING_APPS, SERVING_S, "cuda")
    assert srv["served"] > 0 and srv["rounds"] > 0, srv
    phase_s = time.perf_counter() - t0
    print(f"bench: serving_bench {SERVING_APPS} apps for {SERVING_S} s: "
          f"served {srv['served']} states in {srv['seconds']:.1f}s -> "
          f"{srv['states_per_s']:,.0f} states/s, {srv['rounds']} rounds "
          f"(command {time.perf_counter() - t1:.2f} s) | phase "
          f"{phase_s:.2f} s", flush=True)
    return {"bench": {"sites": {p: dict(c.sites)
                                for p, c in counters.items()},
                      "launches": sum(k1.values()), "k1_by_phase": k1,
                      "line_chars": len(line), "bench_s": bench_s,
                      "serving": srv, "phase_s": phase_s}}


# phases 2b-2e, 4, 4b (graphs_rnn: its recurrent path alone), 7, 8, 8b
# and 17-23, by the names `--only` takes
NEW_PHASES = {"adam": phase_adam, "tail": phase_tail, "head": phase_head,
              "lstm_window": phase_lstm_window,
              "main": lambda: {"main": phase_main_path()},
              "graphs": phase_graphs,
              "graphs_rnn": lambda: phase_graphs(("racer_rnn",)),
              "recurrent": lambda: {"recurrent": phase_recurrent()},
              "atari": phase_atari, "bf16": phase_bf16,
              "glider": phase_glider,
              "predator_prey": phase_predator_prey,
              "multitrainer": phase_multitrainer, "logs": phase_logs,
              "multichip": phase_multichip, "curves": phase_curves,
              "bench": phase_bench}


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(prog="python3 chip_smoke.py")
    p.add_argument("--only", nargs="+", choices=sorted(NEW_PHASES),
                   help="run the device phase and these phases only, and "
                        "print their results instead of the kernels' "
                        "line (for work on one path; the check is the "
                        "run with no arguments)")
    args = p.parse_args(argv)
    _adopt_orphans()
    phase_device()
    import torch
    if args.only:
        res = {}
        for name in args.only:
            res.update(NEW_PHASES[name]())
        print(json.dumps({"phases": res}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    kern = phase_kernels()
    adam = phase_adam()
    tail = phase_tail()["tail"]
    head = phase_head()["head"]
    window = phase_lstm_window()["lstm_window"]
    phase_reference()
    main_res = phase_main_path()
    graphs = phase_graphs()["graphs"]
    learners = phase_learners()
    learners.update(phase_on_policy())
    learners.update(phase_recurrent())
    learners.update(phase_atari())
    learners.update(phase_bf16())
    learners.update(phase_samplers())
    learners.update(phase_learning())
    learners.update(phase_acer())
    learners.update(phase_racer_es())
    cma = phase_cma()
    eng_k1 = phase_engine_k1()
    eng = phase_engine_main()
    eng.update(phase_engine_paths())
    for name in ("glider", "predator_prey", "multitrainer"):
        learners.update(NEW_PHASES[name]())
    logs = phase_logs()["logs"]
    learners.update(phase_multichip())
    kern["path_rows"]["multichip"] = learners["multichip"]["k1"]
    learners.update(phase_curves())
    learners.update(phase_bench())
    for name, *_ in CURVES_RUNS:
        kern["path_rows"][f"curves_{name}"] = learners[f"curves_{name}"]["k1"]
    launches = main_res["launches"]

    def row(entry, mode, case):
        return next(r for r in kern["rows"] if (r["entry"], r["mode"],
                                                r["case"]) == (entry, mode,
                                                               case))

    # per entry point: the Retrace case with random lengths (the affine
    # scan has one case), which the plain version is timed at as well
    entry_rows = {"retrace_sweep": row("retrace_sweep", "retrace", "random"),
                  "batched_retrace": row("batched_retrace", "retrace",
                                         "random"),
                  "affine_suffix_scan": row("affine_suffix_scan", "-",
                                            "all steps")}
    # the paths that launch each entry point, with their launches
    by_entry = {"retrace_sweep": {"vracer_main": launches["retrace_sweep"]},
                "batched_retrace": {}, "affine_suffix_scan": {}}
    for path, v in learners.items():
        entry = "affine_suffix_scan" if "scan" in v else "retrace_sweep"
        if v["launches"]:
            by_entry[entry][path] = v["launches"]
    # the Engine's paths: one batched_retrace launch per committed episode
    k1_entries = ("batched_retrace", "retrace_sweep")
    engine_paths = {"engine_main": {
        k: sum(eng[s]["launches"][k] for s in ("train", "restart", "eval"))
        for k in k1_entries}}
    for path in ("lstm", "native", "native_team", "crash"):
        engine_paths[path] = {k: eng[path]["launches"][k]
                              for k in k1_entries}
    for path, c in engine_paths.items():
        for entry in k1_entries:
            if c[entry]:
                by_entry[entry][path] = c[entry]
    entry_points = {
        name: {"launches": launches[name],
               "max_abs_err": kern["err"][name], "ms": r["ms"],
               "plain_ms": kern["plain"][name], "bytes": r["bytes"],
               "bound_ms": r["bound_ms"], "bound_by": "bytes",
               "share_of_bound": r["share_of_bound"],
               "clone_ms": r["clone_ms"],
               "library_ms": None, "paths": by_entry[name]}
        for name, r in entry_rows.items()}
    acer_scan = learners["acer"]["scan"]
    entry_points["batched_retrace"]["engine_rows"] = [
        dict(r, bound_by="bytes", library_ms=None) for r in eng_k1["rows"]]
    entry_points["affine_suffix_scan"]["acer_step"] = dict(
        acer_scan, bound_by="bytes", library_ms=None,
        launches=learners["acer"]["launches"])
    sweep = entry_points["retrace_sweep"]
    tail_main = tail["vracer_cartpole"]
    graph_paths = [k for k, v in graphs.items() if isinstance(v, dict)]
    print(json.dumps({"kernels": [{
        "name": "retrace_suffix_scan",
        "route": "cuda",
        "source": "smarties_tpu_torch/csrc/retrace.cu",
        "replaces": "smarties_tpu/ops/pallas_retrace.py:42",
        # the main path reaches the kernel through the fused sweep only
        "launches": sum(launches.values()),
        "max_abs_err": max(kern["err"].values()),
        "ms": sweep["ms"],
        "plain_ms": sweep["plain_ms"],
        "bound_ms": sweep["bound_ms"],
        "bound_by": "bytes",
        "share_of_bound": sweep["share_of_bound"],
        "library_ms": None,
        "entry_points": entry_points,
        "cases": kern["rows"],
        "path_cases": kern["path_rows"],
        "launch_floor_ms": kern["floor_ms"],
        "build_s": kern["build_s"],
        "sites": {"vracer_main": main_res["sites"],
                  **{k: v["sites"] for k, v in learners.items()
                     if "sites" in v},
                  **{f"graphs_{k}_{m}": graphs[k][m]["sites"]
                     for k in graph_paths for m in ("captured", "eager")}},
        "launches_by_path": {"vracer_main": launches["retrace_sweep"],
                             **{k: v["launches"]
                                for k, v in learners.items()},
                             **{k: sum(c.values())
                                for k, c in engine_paths.items()},
                             **{f"graphs_{k}_{m}": graphs[k][m]["k1"]
                                for k in graph_paths
                                for m in ("captured", "eager")}},
        "engine_launches_by_path": engine_paths,
        "modes_by_path": {k: v["modes"] for k, v in learners.items()
                          if "modes" in v},
        "cma": {"launches": 0,
                "ms_per_generation": cma["ms_per_generation"]},
        "glider_env_step": learners["glider"]["env_step"],
        "multitrainer_rolls": learners["multitrainer"]["rolls"],
        "logs": logs,
        "graphs": graphs,
    }, {
        "name": "adam_step",
        "route": "cuda",
        "source": "smarties_tpu_torch/csrc/adam.cu",
        "replaces": None,
        "launches": main_res["adam"]["adam_update"],
        "max_abs_err": 0.0,
        "ms": adam["ms"],
        "plain_ms": adam["plain_ms"],
        "bound_ms": adam["bound_ms"],
        "bound_by": "bytes",
        "share_of_bound": adam["share_of_bound"],
        "library_ms": None,
        "phase": adam,
        "launches_by_path": {
            "vracer_main": main_res["adam"],
            **{k: v["adam"] for k, v in learners.items() if "adam" in v},
            **{f"graphs_{k}": graphs[k]["captured"]["adam"]
               for k in graph_paths}},
    }, {
        "name": "step_tail",
        "route": "cuda",
        "source": "smarties_tpu_torch/csrc/step_tail.cu",
        "replaces": None,
        "launches": main_res["tail"]["step_tail"],
        "max_abs_err": 0.0,
        # at the main path's shapes; the conv cell's under "phase"
        "ms": tail_main["ms"],
        "plain_ms": tail_main["plain_ms"],
        "bound_ms": tail_main["bound_ms"],
        "bound_by": "bytes",
        "share_of_bound": tail_main["bound_ms"] / tail_main["ms"],
        "library_ms": None,
        "phase": tail,
        "launches_by_path": {
            "vracer_main": main_res["tail"],
            **{k: v["tail"] for k, v in learners.items() if "tail" in v},
            **{f"graphs_{k}": graphs[k]["captured"]["tail"]
               for k in graph_paths}},
    }, {
        "name": "policy_head",
        "route": "cuda",
        "source": "smarties_tpu_torch/csrc/policy_head.cu",
        "replaces": None,
        "launches": main_res["head"]["continuous"],
        "max_abs_err": 0.0,
        # at the main path's shapes; batch 128 with 6 dims under "phase"
        "ms": head["vracer_cartpole"]["ms"],
        "plain_ms": head["vracer_cartpole"]["plain_ms"],
        "bound_ms": head["vracer_cartpole"]["bound_ms"],
        "bound_by": "bytes",
        "share_of_bound": head["vracer_cartpole"]["bound_ms"]
        / head["vracer_cartpole"]["ms"],
        "library_ms": None,
        "phase": head,
        "launches_by_path": {
            "vracer_main": main_res["head"],
            **{f"graphs_{k}": graphs[k]["captured"]["head"]
               for k in graph_paths}},
    }, {
        "name": "lstm_window",
        "route": "cuda",
        "source": "smarties_tpu_torch/csrc/lstm_window.cu",
        "replaces": None,
        "launches": graphs["racer_rnn"]["captured"]["window"]["forward"],
        # against the float64 chain, relative to each tensor's magnitude
        "max_abs_err": window["err"]["kernel_vs_f64"],
        "ms": window["ms"],
        "plain_ms": window["plain_ms"],
        "bound_ms": window["bound_ms"],
        "bound_by": "flops",
        "share_of_bound": window["bound_ms"] / window["ms"],
        "library_ms": None,
        "phase": window,
        "launches_by_path": {
            "recurrent": {k: v["window"]
                          for k, v in learners.items() if "window" in v},
            **{f"graphs_{k}": graphs[k]["captured"]["window"]
               for k in graph_paths}},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _adopt_orphans():
    """Make this process the reaper of its descendants' orphans
    (prctl PR_SET_CHILD_SUBREAPER), so that _stop_children finds a
    process whose parent ended before it did."""
    import ctypes
    ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)


def _children():
    """{pid: command line} of the processes whose parent is this one."""
    me, kids = os.getpid(), {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        # the fields after the command's closing parenthesis: state, ppid
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            kids[int(d)] = cmd.strip() or stat.split(" ", 2)[1]
    return kids


def _stop_children():
    """Stop every process this run started that is still there: the
    multiprocessing children, the resource tracker (which unlinks the
    shared-memory segments left registered, then exits) and whatever
    else has this process as its parent, orphans included. Prints what
    was still running."""
    import multiprocessing
    import signal
    from multiprocessing import resource_tracker
    for p in multiprocessing.active_children():
        p.terminate()
        p.join(5)
    resource_tracker._resource_tracker._stop()
    stopped = []
    # a process stopped here may leave orphans of its own: sweep again
    for _ in range(5):
        left = _children()
        if not left:
            break
        stopped += left.values()
        for pid in left:
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + 5
        for pid in left:
            try:
                while os.waitpid(pid, os.WNOHANG) == (0, 0):
                    if time.monotonic() > deadline:
                        os.kill(pid, signal.SIGKILL)
                        os.waitpid(pid, 0)
                        break
                    time.sleep(0.05)
            except ChildProcessError:
                pass
    if stopped:
        print(f"chip_smoke: stopped {len(stopped)} processes still running "
              f"at the end: " + "; ".join(c[:100] for c in stopped),
              file=sys.stderr, flush=True)

if __name__ == "__main__":
    try:
        main()
    finally:
        _stop_children()
