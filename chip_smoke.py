#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure stops the script with a non-zero exit; nothing falls
back to the CPU):

1. Build the four kernel libraries from their sources
   (``src/repro_torch/kernels/*/csrc``; flash attention's forward and
   backward, and their tangents, are two) with nvcc for sm_90a, the four
   compilers started together; print the compiler's register report and the
   card's name and power limit.
2. Hold every compressor kernel on the card against its plain PyTorch
   version on a CPU copy of the same inputs, at the main path's row shapes
   and on edge rows: the results must be bit-identical.  The keyed
   fused_dither (row keys and uniforms drawn in the kernel) also against
   the u-taking kernel fed ``random.uniform(random.split(key, n), (L,))``,
   at n = 1, 20, 40, 200 rows of L = 1 ... 20,001 (every cluster size) and
   on zero, -0 and NaN rows.  fused_topk also on
   1, 40 and 200 rows (cluster sizes 8, 2 and 1), rows whose ties straddle
   the shares of a cluster, an all-equal row, denormals, and, through its
   grid-wide instance (rows of at least ops.TOPK_GRID_MIN_L), single rows
   of 300,000 and 3,000,000 elements, rows of odd length whose ties
   straddle the chunks, an all-equal row (the candidate buffer overflows),
   integer ties and NaN/inf/-0 rows, each case through the instance
   ``topk_plan`` names (per-instance launch counts), the grid-wide ones
   also through the grouped entry with a mixed frac and bitwise over two
   runs.
   Hold the flash-attention kernel against its plain version on the card,
   on the same inputs: the reference's test shapes in float32 and bfloat16,
   a ragged length (S = 200) and the serving shape (B=8, H=32, KV=4,
   S=1024, D=64); rtol = atol = 2e-5 in float32, 2e-2 in bfloat16 (the
   reference's own kernel test), and bitwise the same over two runs.  Hold
   the int8 dither codec's encode (u-taking and keyed) and decode kernels
   against their plain versions, bit for bit: the reference test's shapes
   in float32 and bfloat16, zero/inf/NaN rows, s = 255, whole trainer
   leaves ([22·2048, 5632] and [32000, 2048]) as one block, and
   ``quantize``'s layout; the keyed encode also on lengths that are not a
   multiple of 4, an x that is not 16-byte aligned, and against the
   u-taking kernel fed ``random.uniform(key, shape)``; the keyed encode's
   split entries (``dither_absmax_into``, ``dither_levels_keyed``: the
   norm pass over every worker's x into one norm, then each worker's
   levels) over 1, 2 and 3 workers at those shapes, ragged lengths, edge
   rows and the trainer's largest leaf, against their plain versions and,
   at one worker, the fused keyed encode; the decode also on
   ragged blocks and on levels 1 and 4 bytes past an aligned address.  Hold
   the grouped compressor entries (one launch for a grid of G points)
   against their plain versions and against G launches of the scalar
   entries, bit for bit: G = 1, 3, 8 (every cluster size of both row
   kernels), a grid spec mixing families, and fused_topk_grouped on
   [60, 25,000,000] (row offsets past 2^32 bytes).  Hold the
   flash-attention backward (dq, dk, dv) against the plain version's
   autograd on the card: the reference's five shapes, S = 1, 200 (window
   7; cap 50), 333 and the training shape, in float32 and bfloat16,
   max |Δ| <= 1e-5 (f32) / 1e-2 (bf16) · max |grad|, and bitwise the same
   over two runs; the forward's output must be bitwise the same with and
   without its log-sum-exp output; the bf16 backward's six wgmma kernels
   must hold HGMMA in the SASS of the library built.  The grouped keyed
   dither with global row ids (``ids=``) against its plain version, bit
   for bit: a cohort's ids (``cohort_indices`` of 102,400 clients; rows
   [64, 123] and [64, 492]), per-point ids [G, n], a block 10..19 of a
   20-worker federation (rows [10, 5000]), at G = 1 and 3; ids 0..n-1
   equal to the kernel without ids.
3. Quickstart (d=123, n=20, r=64, m=4, seed 0): 201 rounds with
   dither64/dither64 and 50 with a topk0.1 Hessian compressor, on the card
   and in the port on the CPU.  Ledgers must be equal every round, the
   dither run's final objective within rtol 1e-4 of the CPU run, and the
   launch counters (set to 0 before each run, read after it) must show
   that the card run went through the kernels: the round is the sweep
   step's [1] grid, so fused_dither_keyed_grouped and dither_bits_grouped
   twice a round less the top-k rounds, fused_topk_grouped and
   topk_bits_grouped once a top-k round, and the scalar entries and the
   u-taking fused_dither never.
3b. Plans at quickstart size (d=123, n=20, r=64, seed 0): budget_fair_plan
   (five methods × 3 budgets), baselines_plan and fig1_plan on the card
   against the port on this machine's CPU: ledgers, activity counts,
   round counters, scan lengths and budget rounds equal, final F within
   rtol 1e-4, frozen tails bit-stable; only grouped entries launched.
   The paper's remaining figures (``experiments.fig3_iterate_updates``,
   ``comm_table``, ``ablation_dither_levels``, ``vmapped_grid``,
   ``ablation_grid``; 20 rounds each, the cut) on the card against the
   CPU (worker processes): ledger columns and the communication table
   equal, F within rtol 1e-4 at every row but for a run whose F climbs 5%
   past its start on the CPU too (fig3's L-SR1 run: logged).
3c. The stochastic setting: randint, permutation, choice and the exact-k
   masks on the card bit for bit the CPU's; natural, count sketch (its
   table twice, and the decode of one table) and min-max on the card bit
   for bit the CPU's (their sums in float64, rounded once; a sum that
   still lands one ulp apart, a double rounding, is logged as such);
   stochastic FLECS-CGD at quickstart size (minibatch oracles of 32 rows,
   exact-k p = 0.5, alpha 0.2; 50 rounds) on the card against the CPU:
   ledgers, every round's masks and rows equal, 10 workers a round, the
   full-batch round's compressor launches, and the round ms of both;
   ``sketch_families_plan`` at quickstart size (100 rounds, the cut):
   round_bits,
   omega and ledgers equal, one grouped launch a kernel family a round.
   Both runs record every compressor call (``plan_drift``) and are held
   by ``plan_drift.verdict``: every card message is the plain
   compressor's on the CPU from the recorded key and input, at every
   round; the first differing message is explained by a rounding
   decision after rounds that agreed within 1e-6; F within rtol 1e-4 of
   the CPU at every round, or else within 3x the largest gap one ulp of
   noise in A opens between two CPU runs (five seeds; the envelopes' CPU
   runs in seven spawned worker processes, after the timed quickstart
   rounds).  Whether final F held rtol 1e-4 is logged for each run;
   at gisette width, 10 rounds
   a cell, stochastic FLECS-CGD with the coordinate and with the Gaussian
   sketch and ``sketch_families_plan`` at m = 2: ms, kernels and busy ms a
   round (10- less 1-round runs; 3- less 1-round profiles), compressor
   launches, peak memory.
3d. The async engine (FedBuff-style buffered aggregation) and its traffic
   model, at quickstart size on the card against the port on the CPU,
   every compressor call and every round's routing recorded
   (``plan_drift``): ``experiments.async_grid`` (FLECS-CGD m = 2, exact-k
   p = 0.5, taus {0, 2, 4} × buffer_k {1, 5, 20}, alpha auto-damped, 200
   rounds (the cut), G = 9 in one batched run): ledgers, sends, arrivals, flushes
   and buffered counts equal every round, and every point held by
   ``plan_drift.verdict`` (card messages their CPU replays, the first
   difference an explained decision, F within rtol 1e-4 or else within 3x
   the CPU's ulp envelope over five seeds);
   the grid's tau = 0 points with buffer_k <= the cohort equal the
   synchronous sweep on the card bit for bit, and so does each method's
   legacy async step at tau = 0, buffer_k = the cohort (FLECS-CGD, DIANA,
   FedNL topk0.25, GD; state, ledgers and aux); each legacy async step
   under a fixed, a uniform and a geometric (q 0.5) schedule at tau 2,
   buffer_k 5, 25 rounds (the cut): ledgers and routing equal, a
   geometric delay
   that differs must lie within 4 ulps of an integer log(u) / log(q) (and
   is logged), and ``plan_drift.verdict`` with F held at rtol 1e-4 (F
   logged only for FedNL, whose eigh parts the sides before a top-k tie
   flips); the five-method traffic plan of
   ``benchmarks/traffic_bench.py`` (tau 2, buffer_k 2; fixed, poisson 0.6
   and diurnal (0.9, 0.5, 0.2, 0.5) arrivals, the default availability
   chain, admission cutoff 3 / 6 in flight), 40 rounds (the cut; the
   runs that diverge on the CPU pass twice their first F by round 29): the
   availability
   states and admitted arrivals of every round and the ledgers bit for
   bit, and each method under ``plan_drift.verdict`` (F logged only for
   FedNL, and for a run that diverges on the CPU too); a cutoff of 0 at
   tau 0 is the synchronous plan on the card bit for bit, at tau 2 it
   leaves w and every ledger at zero.  Only the grouped compressor
   entries launch.  The CPU side of every comparison (and the grid's ulp
   envelope, a run a job) runs in seven spawned worker processes while
   the card runs its own side.  The gisette cells (async FLECS-CGD G = 3
   and the diurnal traffic plan at d = 5000, ``phase_async_gisette``)
   were cut to make room for phase 12.
3e. Hierarchy, cohort and sharding.  With the host quiet: gisette width
   (d = 5000, n = 20, r = 300, m = 4) with an edge tier of 4 aggregators
   over a [3] grid of edge specs (identity, dither64, count_sketch64), and
   the cohort FLECS-CGD engine over K = 20 of a virtual population of
   102,400 shards of 16 rows (10 rounds each: ms, kernels, busy ms, peak
   a round as phase 4b takes them); the cohort engine's memory round by
   round (K = 64 of N = 1,024, 102,400 and 1,048,576, d = 123, 10 rounds):
   the last round's peak above the allocation before it agrees within 2
   MiB over the three N; DIANA and GD at N = 102,400 logged.  Then, the
   CPU side in worker processes meanwhile: the sharded engine at world
   size 1 (NCCL) equal to ``run_sweep`` on the card bit for bit over 25
   rounds (FLECS FedSONIA, FLECS truncated inverse, hierarchical
   FLECS-CGD, DIANA); the cohort runs (FLECS-CGD at N = 1,024, DIANA and
   GD at 102,400; 10 rounds) against the CPU: every round's ids and mask,
   the ledgers equal, F held by ``plan_drift.verdict``; the hierarchy grid
   at quickstart size (50 rounds, the cut) against the CPU: edge_bits
   and
   bits_per_node equal every round, each point held by ``verdict``, the
   identity point within rtol 1e-5 of the flat server over 6 rounds (the
   reference's own contract; its gap over the run logged).  Only the
   grouped compressor entries launch.
4. Gisette width (d=5000, n=20, r=300, m=4): 10 rounds with each Hessian
   compressor on the card, with exact ledgers; the dither run's objective
   against the port on this machine's CPU; round time and peak memory.
4b. baselines_plan at gisette width, 10 rounds a method (the cut): ms and
   device kernels a round without the run's setup (10-round minus 1-round
   runs, 3-round minus 1-round profiles; FedNL's kernels in linalg_eigh
   apart), peak memory, exact ledgers, FedNL's fused_topk_grouped on
   [20, 25,000,000] rows once a round through the grid-wide instance;
   fused_topk on [20, 25e6] and the grouped entry on [20, 25e6] and
   [60, 25e6] beside torch.topk; one eigh of 5000 × 5000.
5. Serving, tinyllama-1.1b at full width and depth 2 (float32 weights
   built on the card from seed 0, then copied to the CPU): prefill of one
   256-token prompt and 8 greedy decode steps on both devices, the CPU fed
   the card's tokens; logits within max |Δ| <= 1e-4 · max |logits|, greedy
   ids equal wherever the CPU's top-2 margin exceeds that bound.
6. Serving, tinyllama-1.1b at full width and all 22 layers (float32): batch
   8, prompt 1024, 64 greedy decode steps through ``launch/serve.py``'s own
   functions; the flash-attention count, set to 0 just before, must be 22
   after the prefill; finite logits; prefill ms, decode ms per step, tokens
   per second, peak memory; then profiles of one prefill and of 4 steps.
7. A profile of a few Algorithm 1 rounds at both sizes (device kernels a
   round, int64 elementwise launches a round, busy share), then each
   kernel's time by CUDA events beside its plain version, its bound (the
   keyed dither's from the instructions of its main loop on the busiest
   pipe, read from the SASS of the library built) and the library call
   (``torch.topk``; ``scaled_dot_product_attention``, timed only); then
   fused_topk at the seven shapes of ``TOPK_TIMED`` (quickstart and plan
   shapes, [1, 3e6], FedNL's rows), each instance forced beside the one
   the plan takes; the flash forward in float32 (bound: 3xTF32) and
   bfloat16.
8. Training, tinyllama-1.1b at full width and depth 2, batch 2 x 128, on
   the card against this machine's CPU: first-step gradients per leaf
   within 1e-4 · max |g|, the first FLECS-CGD step's int8 levels at no more
   than 1e-3 of the elements and by one level at most; then 2 adam steps
   and 2 FLECS-CGD steps (the cut) from the same weights: losses within
   rtol 1e-4,
   ``uplink_mbits`` equal.
9. Training, tinyllama-1.1b at full width, all 22 layers (float32, remat),
   batch 8 x 1024: 3 adam steps and 3 FLECS-CGD steps (the cut) on one
   batch through
   ``launch/train.py``'s functions, the counters set to 0 just before each
   run and read after it: flash_attention 44 a step (remat recomputes it),
   flash_attention_backward 22, and on FLECS steps dither_encode_keyed,
   dither_decode and dither_bits once per parameter leaf and the u-taking
   dither_encode and the split entries never; finite losses, adam's falling; step ms and peak
   memory; a profile of one step of each mode (the FLECS step's int64
   elementwise passes must take under 50 ms: its uniforms are drawn inside
   the keyed encode); then the codec and backward kernels timed by CUDA
   events beside their plain versions, bounds (the keyed encode's from
   the instructions of its main loop on the busiest pipe, read with
   cuobjdump from the SASS of the library built), SDPA's backward and,
   for the decode, ``torch.mul`` (both timed only); the backward in
   float32 (bound: 3xTF32 on the tensor cores) and bfloat16 (wgmma; its
   HGMMA count read from the SASS).
10. The sketched-Hessian FLECS-CGD trainer (m = 2, alpha = 30 · lr).
   (a) The forward- and backward-tangent kernels against their plain
   versions on the card, on the same inputs, at ``JVP_SHAPES``
   (tinyllama's [8, 32/4, 1024, 64] in the model and the kernel layout,
   ragged S (one past and one short of a 64-row tile too), window, cap,
   D = 32 and 128, S = 1): max |Δ| <= 1e-5 · max |t|, bitwise the same
   over two runs; the forward-, dK/dV- and dQ-tangent kernels' SASS at
   D = 32, 64 and 128 must hold HMMA (3xTF32 on the tensor cores).  (b)
   tinyllama-1.1b at full width and depth 2, batch 2 x 128: one m = 2
   step on the card and, in a
   spawned worker process with every core, on this machine's CPU from the
   card's weights, then each side's loss of its new weights on the next
   batch: losses within rtol 1e-5, ``uplink_mbits`` equal, every card Y
   message (each leaf's compressed HVP column) its replay through the
   plain encode on the CPU, the Y levels differing at no more than 1e-3
   of the elements and by one level at most.  (c) 22 layers, float32,
   remat, batch 8 x 1024 (cut to 4 only if 8 does not fit): 1 m = 2 step
   (the cut),
   the counters set to 0 just before and read just after (per step 6 L
   forwards, 3 L backwards, 4 L forward tangents, 2 L backward tangents,
   and 3 codec launches of each kind per parameter leaf); losses, step ms
   split into the gradient pass, the HVP passes, the sketch draws and
   FedSONIA, peak memory.  (d) ``train_lm --flecs --flecs-m 2 --steps 2
   --checkpoint DIR`` (the cut) at its defaults, every kernel of the path launched,
   the checkpoint restored bit for bit.  Then both tangent kernels timed
   at the training shape beside their plain versions and bounds.  (b)'s
   CPU side runs while the card runs (a), (c) and (d).
11. The multi-worker FLECS-CGD trainer (alpha = 30 · lr).  (a)
   tinyllama-1.1b at full width and depth 2, global batch 4 x 128, one
   step of 4 workers (m = 0) through ``launch/train.train`` and the new
   weights' loss on the next batch, on the card and, in a spawned worker
   process with every core, on this machine's CPU from the card's
   weights: both losses within rtol 1e-5, ``uplink_mbits`` equal, every
   worker's step-0 level message
   its replay through the plain split entries on the CPU (the norm over
   the card's inputs of all four workers, each worker's levels from it),
   the CPU's own step-0 levels differing from the card's at no more than
   1e-3 of the elements and by one level.  (d) The same run over a NCCL
   ``WorkerGroup`` at world size 1 (the norm and the level sums through
   ``all_reduce``): every param and shift leaf and the metrics bit for
   bit the run without a group.  (b) 22 layers, float32, remat, global
   batch 8 x 1024: 3 steps of 4 workers (2 x 1024 each), m = 0, through
   ``launch/train.train``; (c) 1 step (the cut) of 2 workers (4 x 1024
   each) at
   m = 2 (cut to 4 x 1024 globally only if 8 does not fit); for each the
   counters set to 0 just before and read just after (per step and
   worker 2 L (1 + m) forwards, L (1 + m) backwards, 2 L m and L m
   tangents, a norm and a levels pass a message, a decode a gradient
   message; a bits launch a message; the fused encode never), losses,
   step ms split by ``StepSplit`` (gradient, HVP, sketch draws,
   FedSONIA, norm pass, norm all-reduce, levels pass, level sum,
   decode), peak memory.  (a)'s CPU side runs while the card runs (d),
   (b) and (c).
12. The other model families through ``launch/serve.py``: (a) at smoke
   width, card against this machine's CPU fed the card's tokens (mamba2,
   recurrentgemma, deepseek-v3, qwen3-moe, llava with image embeds,
   musicgen's 4 codebooks, gemma2 at head dim 256): logits within 1e-4 ·
   max |logits|, greedy ids and every MoE layer's routing ids equal where
   the margin is clear, one flash launch an attention layer; (b) at full
   width (``FAMILY_FULL``: mamba2-1.3b's 48 layers and musicgen-large's
   48 in float32 at 8 x 1024; recurrentgemma-9b's first 3 layers at 4 x
   3072, past its 2048 window; gemma2-9b's first 2; llava's first 2 at 4
   x 3072 with 2304 image embeds; deepseek-v3's first 4 (3 dense MLA, 1
   MoE of 256 experts) and qwen3-moe's first 2 in bfloat16 at 8 x 1024):
   weights from seed 0 (init seconds), 2 warm-up steps, then the prefill
   and greedy steps with the flash counter set to 0 just before and read
   just after (one launch an attention layer), prefill and decode ms, peak
   memory, row 0's ids, and one more prefill split by module (the SSD, the
   RG-LRU scan, the MoE dispatch, flash; synchronized); deepseek's MoE
   layer on 4 tokens against the plain gather formula.  Phase 2 holds the
   flash forward's new instances ((256, 256), MLA's (192, 128); float32
   and bf16, the bf16 (192, 128) one on the wgmma forward, whose SASS
   must hold HGMMA) against their plain version at the families' shapes
   (``FAMILY_FLASH_SHAPES``) and ragged lengths, and times them; phase 12
   (b) checks each family's prefill launched ``ops.forward_plan``'s
   kernel.
13. Training the other families through ``launch/train.py``: (a) the
   float32 flash backward's (256, 256) and (192, 128) instances against
   the plain version under autograd on the card, max |Δ| <= 1e-5 · max
   |grad| over dq, dk, dv and the same bits over two runs, at gemma2-9b's
   local layer (window 4096, cap 50), recurrentgemma-9b's MQA band (KV 1,
   window 2048, S = 3072) and deepseek-v3's MLA [8, 128, KV 128, 1024]
   (timed by CUDA events beside the plain version's backward and SDPA's,
   with the bound, and each kernel's device ms from a profile: one dK/dV
   launch a call), and at ragged lengths through the model layout; the
   build log shows no spill in the wide backward's kernels and the wgmma
   forward at (192, 128) (``FAMILY_BWD_KERNELS``).  (b) Each family of
   ``FAMILY_SMOKE`` at smoke width, one adam and one FLECS-CGD (m = 0)
   step, card against this machine's CPU: losses within 1e-5 relative,
   ``uplink_mbits`` equal, the params held, the backward launched once an
   attention layer at the layer's pair.  (c) Each family at full width and
   the depth of ``FAMILY_TRAIN`` (on phase 12's float32 weights where the
   depth matches): 1 warm-up and 2 timed steps of adam (adafactor for
   deepseek-v3 and qwen3-moe), then of FLECS-CGD (m = 0), counters set to
   0 just before each run and read just after: step ms, peak memory, flash
   launches (the backward's by pair), codec launches.
14. Print the kernels line (eighteen kernels: the ten of slices 1–6, the
   four grouped entries, whose launches add phase 3e's, the two tangent
   kernels and the keyed encode's two split entries; the backward's entry
   with its family instances and launches by pair), then the device line
   as the last line.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12         # H100 SXM TF32 on the tensor cores (dense)
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 on the tensor cores (dense)
# clocks a second of the H100 SXM's 132 SMs at its 1.98 GHz boost clock
SM_CLOCKS_PER_S = 132 * 1.98e9
#: Thread-instructions an sm_90 SM completes a clock on each pipe, and the
#: SASS opcodes each pipe takes (Nsight Compute's pipe names): the integer
#: and logic ALU; the FMA pipe's heavy half, which alone takes integer
#: multiply-adds (the compiler moves integer adds there as IMAD.IADD and
#: VIADD); the whole FMA pipe, which also takes float32 adds and products;
#: the transcendental and conversion unit; and the four schedulers' issue
#: slots, which every instruction takes.
SASS_PIPES = {
    "alu": (64, {"IADD3", "LOP3", "SHF", "LEA", "ISETP", "PRMT", "SEL",
                 "FSEL", "FSET", "FSETP", "FMNMX", "IMNMX", "MOV", "PLOP3",
                 "FCHK"}),
    "fma_int": (64, {"IMAD", "IMUL", "VIADD"}),
    "fma": (128, {"IMAD", "IMUL", "VIADD", "FFMA", "FADD", "FMUL"}),
    "xu": (16, {"MUFU", "FRND", "F2I", "I2F", "F2F"}),
    "issue": (128, None),
}
SOURCE = "src/repro_torch/kernels/compressor/csrc/compressor.cu"
# the u-taking and the keyed dither both replace the Pallas dither kernel
REPLACES = {
    "fused_dither": "src/repro/kernels/compressor/compressor.py:71",
    "fused_dither_keyed": "src/repro/kernels/compressor/compressor.py:71",
    "fused_topk": "src/repro/kernels/compressor/compressor.py:105",
    "dither_bits": "src/repro/kernels/compressor/compressor.py:161",
    "topk_bits": "src/repro/kernels/compressor/compressor.py:165",
}
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:28"
DITHER_SOURCE = "src/repro_torch/kernels/dither/csrc/dither.cu"
# the u-taking and the keyed encode both replace the Pallas encode
DITHER_REPLACES = {
    "dither_encode": "src/repro/kernels/dither/dither.py:25",
    "dither_encode_keyed": "src/repro/kernels/dither/dither.py:25",
    # the keyed encode's two passes apart: n workers share one norm
    "dither_absmax": "src/repro/kernels/dither/dither.py:25",
    "dither_levels_keyed": "src/repro/kernels/dither/dither.py:25",
    "dither_decode": "src/repro/kernels/dither/dither.py:62"}
# no Pallas kernel: the reference differentiates chunked_attention in XLA
BWD_REPLACES = "src/repro/models/attention.py:38"
QUICK = dict(d=123, n_workers=20, r=64, m=4, seed=0)
GISETTE = dict(d=5000, n_workers=20, r=300, m=4, seed=0)
# the shapes of tests/test_kernels.py's flash test, a ragged length, and the
# serving shape (tinyllama-1.1b, batch 8, prompt 1024): B, H, KV, S, D,
# window, cap
FLASH_SHAPES = [(1, 4, 2, 256, 64, 0, 0.0), (2, 4, 4, 128, 32, 0, 50.0),
                (1, 8, 2, 512, 64, 128, 0.0), (2, 2, 1, 256, 128, 64, 30.0),
                (1, 2, 2, 384, 64, 0, 0.0), (1, 4, 2, 200, 64, 0, 0.0),
                (2, 4, 1, 200, 32, 70, 20.0)]
SERVE_SHAPE = (8, 32, 4, 1024, 64, 0, 0.0)
TINYLLAMA = "tinyllama-1.1b"
# tinyllama-1.1b training: batch 8 x 1024 at full width (the attention shape
# is SERVE_SHAPE's), and its two largest parameter leaves, the stacked FFN
# weights [22, 2048, 5632] and the embedding, each quantized as one block
TRAIN_BATCH = (8, 1024)
LEAF_SHAPES = ((22 * 2048, 5632), (32000, 2048))


def log(*args):
    print(*args, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_functions(lib: Path) -> dict:
    """The SASS of every kernel in a built library (``cuobjdump -sass``, from
    the toolkit that holds nvcc), as ``parse_sass`` gives it."""
    from repro_torch.kernels.nvcc import nvcc
    tool = Path(nvcc()).parent / "cuobjdump"
    return parse_sass(subprocess.run(
        [str(tool), "-sass", str(lib)], capture_output=True, text=True,
        check=True, timeout=300).stdout)


def parse_sass(text: str) -> dict:
    """``cuobjdump -sass`` output -> {mangled name: [(address, predicate,
    opcode, operands), ...]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
            continue
        head = line.split(";")[0].strip()
        if cur is None or not head.startswith("/*") or "*/" not in head:
            continue
        addr, _, body = head[2:].partition("*/")
        words = body.split()
        if not words:
            continue
        pred = words.pop(0) if words[0].startswith("@") else None
        cur.append((int(addr, 16), pred, words[0], " ".join(words[1:])))
    return funcs


def loop_issue_per_element(code) -> tuple:
    """Per-pipe thread-instructions an element costs in a kernel's main loop
    on its common path, read from its SASS (``sass_functions``): the loop is
    the widest backward branch; a forward branch out of it (the loop's
    break) is not taken, and one that jumps over a CALL (the slow path of a
    correctly rounded division) is.  Elements per trip: the instructions
    that set the exponent bits 0x3f800000 of a uniform, one an element.
    Returns ({pipe: instructions per element}, elements per trip)."""
    at = {a: i for i, (a, _, _, _) in enumerate(code)}

    def target(ops):
        return int(ops.split()[-1].rstrip(";").split(",")[-1].strip(), 16)

    loops = [(target(o), a) for a, _, op, o in code
             if op == "BRA" and target(o) < a]
    if not loops:
        raise ValueError("no loop in the kernel's SASS")
    start, end = max(loops, key=lambda lo_hi: lo_hi[1] - lo_hi[0])
    counts = {name: 0 for name in SASS_PIPES}
    elems, i = 0, at[start]
    while True:
        a, pred, op, ops = code[i]
        base = op.split(".")[0]
        for name, (_, opcodes) in SASS_PIPES.items():
            if opcodes is None or base in opcodes:
                counts[name] += 1
        elems += "0x3f800000" in ops
        if a == end:
            break
        if base == "BRA":
            t = target(ops)
            if pred is None:
                i = at[t]
                continue
            if t > end:                       # the loop's break
                i += 1
                continue
            if any(c[2].startswith("CALL") for c in code[i + 1:at[t]]):
                i = at[t]                     # over the division's slow path
                continue
            raise ValueError(f"branch at {a:#x} of unknown kind")
        i += 1
    if elems == 0:
        raise ValueError("no uniform drawn in the loop")
    return {k: v / elems for k, v in counts.items()}, elems


#: Mangled-name fragments of the kernels whose bound is read from their
#: SASS: encode_keyed_kernel<float, true> (dither library) and
#: fused_dither_keyed_kernel (compressor library).
KEYED_ENCODE_SASS = "encode_keyed_kernelIfLb1E"
KEYED_DITHER_SASS = "fused_dither_keyed_kernel"


def loop_clocks_per_element(lib: Path, kernel: str) -> tuple:
    """SM clocks an element of a kernel takes at the least: its main loop's
    instructions on each pipe (``loop_issue_per_element`` on the SASS of
    the one kernel of the library ``lib`` whose mangled name holds
    ``kernel``) over that pipe's rate, the busiest pipe.  Returns (clocks,
    that pipe, per-pipe counts, elements per trip)."""
    return loop_clocks_from(sass_functions(lib), kernel)


def loop_clocks_from(funcs: dict, kernel: str) -> tuple:
    """``loop_clocks_per_element`` on parsed SASS."""
    names = [n for n in funcs if kernel in n]
    if len(names) != 1:
        raise ValueError(f"{kernel}: {names}")
    per, elems = loop_issue_per_element(funcs[names[0]])
    clocks = {k: per[k] / SASS_PIPES[k][0] for k in per}
    pipe = max(clocks, key=clocks.get)
    return clocks[pipe], pipe, per, elems


def cuda_ms(fn, reps: int, backlog: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after one warm-up call.

    With ``backlog`` the card first runs a ~50 ms spin kernel, so the host
    enqueues every call before the first one starts: the events then time
    the device alone, not the host's rate of issuing launches (one Python
    wrapper call costs tens of microseconds, more than these kernels).
    Without it the time is that of the calls as issued from Python."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if backlog:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _sms(dev) -> int:
    import torch
    return torch.cuda.get_device_properties(dev).multi_processor_count


#: fused_topk's timed shapes: rows, L, frac.  The quickstart and plan
#: shapes (the cluster instance), rows about the crossover
#: (ops.TOPK_GRID_MIN_L), single long rows, and FedNL's Hessian
#: differences at gisette width (d² = 25e6; 60 rows: a grid of 3 points).
TOPK_TIMED = ((20, 492, 0.1), (20, 20000, 0.1), (60, 15129, 0.25),
              (1, 65_536, 0.1), (1, 131_072, 0.1), (20, 131_072, 0.1),
              (1, 300_000, 0.1), (1, 3_000_000, 0.1),
              (20, 25_000_000, 0.25), (60, 25_000_000, 0.25))


def topk_shape_timing(dev, ops, ref, shapes=TOPK_TIMED) -> dict:
    """fused_topk by CUDA events at each (rows, L, frac) of ``shapes`` (60
    rows through the grouped entry, three points of 20), beside torch.topk
    of |x| and the byte bound (x read once, out written once).  Where the
    checkout has both instances (``ops.topk_plan``), each is also timed
    forced, so one call sets the crossover; ``instance`` is the one the
    plan takes."""
    import torch
    g = torch.Generator(device=dev).manual_seed(21)
    res = {}
    plan = getattr(ops, "topk_plan", None)
    for rows, L, frac in shapes:
        x = torch.randn((rows, L), generator=g, device=dev)
        fg = torch.full((rows // 20,), frac, dtype=torch.float32,
                        device=dev) if rows == 60 else None
        reps = 200 if L < 100_000 else (20 if L < 10_000_000 else 3)

        def call():
            return (ops.fused_topk(x, frac) if fg is None
                    else ops.fused_topk_grouped(x, fg))

        r = dict(ms=cuda_ms(call, reps),
                 library_ms=cuda_ms(lambda: torch.topk(
                     x.abs(), ref.topk_keep_count(frac, L), dim=1), reps),
                 bound_ms=1e3 * (8 * rows * L + 4 * rows) / HBM_BYTES_PER_S,
                 bound_by="bytes", frac=frac)
        if plan is not None:
            r["instance"] = plan(rows, L, _sms(dev))[0]
            try:
                for kind in ("cluster", "grid"):
                    ops.topk_plan = (
                        (lambda n, m, sms: ("cluster",
                                            ops.topk_cluster(n, m, sms)))
                        if kind == "cluster"
                        else (lambda n, m, sms: ("grid",
                                                 ops.topk_chunk(n, m, sms))))
                    r[f"{kind}_ms"] = cuda_ms(call, reps)
            finally:
                ops.topk_plan = plan
        log(f"timing fused_topk [{rows},{L}] frac={frac}: {r['ms']!r} ms"
            + (f" ({r['instance']} instance; cluster {r['cluster_ms']!r} ms,"
               f" grid {r['grid_ms']!r} ms)" if plan else "")
            + f"; torch.topk {r['library_ms']!r} ms, bound "
            f"{r['bound_ms']!r} ms by bytes")
        res[f"[{rows},{L}]"] = r
        del x
        torch.cuda.empty_cache()
    return res


def opcode_counts(funcs: dict, fragment: str, prefix: str) -> dict:
    """Instructions whose opcode starts with ``prefix`` in each function of
    parsed SASS (``sass_functions``) whose mangled name holds
    ``fragment``: {name: count}."""
    return {name: sum(op.startswith(prefix) for _, _, op, _ in code)
            for name, code in funcs.items() if fragment in name}


#: Mangled-name fragment of the bf16 backward's wgmma kernels
#: (flash_attention.cu, namespace wg).
WGMMA_BWD_SASS = "2wg"
#: Mangled-name fragment of the bf16 forward's wgmma kernels
#: (flash_attention.cu, namespace wgf; one a ``ops.WGMMA_FWD_HEAD_DIMS``
#: pair).
WGMMA_FWD_SASS = "3wgf"


def max_abs_err(a, b) -> float:
    """Largest |a - b| over positions where neither is NaN (0.0 when the two
    are bit-identical there); NaN positions must agree."""
    import torch
    a, b = a.cpu(), b.cpu()
    check(torch.equal(torch.isnan(a), torch.isnan(b)), "NaN positions differ")
    keep = ~torch.isnan(b)
    if not bool(keep.any()):
        return 0.0
    return float((a[keep].double() - b[keep].double()).abs().max())


def bit_identical(a, b) -> bool:
    import torch
    a, b = a.cpu(), b.cpu()
    keep = ~torch.isnan(b)
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a[keep].view(torch.int32),
                            b[keep].view(torch.int32)))


def phase_kernels(dev, ops, ref, random):
    """Phase 2: every kernel against its plain version, bit for bit."""
    import numpy as np
    import torch
    err = {name: 0.0 for name in REPLACES}
    rng = np.random.default_rng(0)

    def compare(name, got, want, what):
        check(bit_identical(got, want), f"{name} differs from its plain "
              f"version on {what}")
        err[name] = max(err[name], max_abs_err(got, want))

    cases = [(f"[20,{L}]", torch.as_tensor(
        (rng.normal(size=(20, L)) * 10).astype(np.float32)))
        for L in (123, 492, 5000, 20000)]
    for L in (1, 127, 128, 129):
        cases.append((f"[3,{L}]", torch.as_tensor(
            rng.normal(size=(3, L)).astype(np.float32))))
    inf, nan = float("inf"), float("nan")
    cases += [
        ("zero row", torch.zeros((2, 300))),
        ("inf row", torch.tensor([[1.0, inf, 3.0, -2.0, 0.5, 0.0, 7.0,
                                   -inf]])),
        ("nan row", torch.tensor([[1.0, nan, 3.0, -2.0, -0.0, 0.5, 2.0,
                                   1.0]])),
        ("integer ties", torch.as_tensor(
            rng.integers(-3, 4, size=(4, 1000)).astype(np.float32))),
    ]
    keys = random.split(random.key(7, "cpu"), 20)
    for what, x in cases:
        u = random.uniform(keys[:x.shape[0]], (x.shape[1],))
        out, bits = ops.fused_dither(x.to(dev), u.to(dev), 64.0)
        want, want_bits = ref.fused_dither_ref(x, u, 64.0)
        compare("fused_dither", out, want, what)
        compare("fused_dither", bits, want_bits, what + " (bits)")
        compare_keyed(ops, ref, random, x, random.key(len(what), "cpu"),
                      64.0, dev, compare, what)
        for frac in (0.1, 0.5):
            out, bits = ops.fused_topk(x.to(dev), frac)
            want, want_bits = ref.fused_topk_ref(x, frac)
            compare("fused_topk", out, want, f"{what} frac={frac}")
            compare("fused_topk", bits, want_bits, f"{what} (bits)")
    for d in (1, 123, 128, 129, 492, 5000, 20000):
        for s in (1.0, 64.0):
            compare("dither_bits", ops.dither_bits(s, d, dev),
                    ref.dither_bits_ref(s, d, "cpu"), f"s={s} d={d}")
        for frac in (0.1, 0.37, 1.0):
            compare("topk_bits", ops.topk_bits(frac, d, dev),
                    ref.topk_bits_ref(frac, d, "cpu"), f"frac={frac} d={d}")
    torch.cuda.synchronize()
    log(f"phase 2: {len(cases)} row sets, every kernel bit-identical to its "
        f"plain version; max_abs_err {err}")
    return err


def compare_keyed(ops, ref, random, x, key, s, dev, compare, what):
    """fused_dither_keyed on the card against its plain version on the CPU
    (``random.split``, ``random.uniform``, then the plain dither) and
    against the u-taking kernel fed the same uniforms drawn on the card."""
    out, bits = ops.fused_dither_keyed(x.to(dev), key.to(dev), s)
    want, want_bits = ref.fused_dither_keyed_ref(x, key, s)
    compare("fused_dither_keyed", out, want, what)
    compare("fused_dither_keyed", bits, want_bits, what + " (bits)")
    u = random.uniform(random.split(key.to(dev), x.shape[0]), (x.shape[1],))
    check(bit_identical(out, ops.fused_dither(x.to(dev), u, s)[0]),
          f"fused_dither_keyed differs from fused_dither on the same "
          f"uniforms on {what}")


#: fused_dither_keyed's cluster cases: n rows of L (n = 1, 20, 40, 200 take
#: 8, 4, 2, 1 CTAs a row on 132 SMs where L allows it).
DITHER_CLUSTER_N = (1, 20, 40, 200)
DITHER_CLUSTER_L = (1, 123, 492, 5000, 20000, 20001)


def phase_dither_cluster(dev, ops, ref, random, err):
    """Phase 2, fused_dither_keyed at every cluster size, and on zero, ±0
    and NaN rows, bit for bit; updates err["fused_dither_keyed"]."""
    import numpy as np
    import torch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(11)

    def compare(name, got, want, what):
        check(bit_identical(got, want), f"{name} differs from its plain "
              f"version on {what}")
        err[name] = max(err[name], max_abs_err(got, want))

    sizes = set()
    for n in DITHER_CLUSTER_N:
        for L in DITHER_CLUSTER_L:
            x = torch.as_tensor((rng.normal(size=(n, L)) * 10).astype(
                np.float32))
            x[0, :L // 2] = 0.0        # shares whose maximum is 0
            compare_keyed(ops, ref, random, x, random.key(n * L, "cpu"),
                          64.0, dev, compare, f"[{n},{L}]")
            sizes.add(ops.dither_cluster(n, L, sms))
    nan, zero = float("nan"), torch.zeros(3, 20000)
    zero[1] = -0.0
    zero[2, ::3] = -0.0
    special = torch.as_tensor(rng.normal(size=(4, 20000)).astype(np.float32))
    special[1, 7777] = nan
    special[2, 19999] = nan
    special[3, ::5] = -0.0
    for what, x in (("zero and -0 rows", zero), ("NaN rows", special)):
        for s in (1.0, 64.0):
            compare_keyed(ops, ref, random, x, random.key(5, "cpu"), s, dev,
                          compare, f"{what} s={s}")
    torch.cuda.synchronize()
    log(f"phase 2: fused_dither_keyed bit-identical to its plain version and "
        f"to fused_dither on the cluster cases; cluster sizes taken "
        f"{sorted(sizes)} on {sms} SMs")
    check(sms != 132 or sizes == {1, 2, 4, 8},
          f"fused_dither_keyed took cluster sizes {sorted(sizes)}")


def topk_rows():
    """fused_topk's cluster cases, (what, rows): 1, 40 and 200 rows of
    20,000 and 20,037 (8, 2 and 1 CTAs a row on 132 SMs; 20 rows, 4 CTAs,
    are phase 2's main cases), rows of 16,384 split 8 ways with ties
    straddling the share boundaries, an all-equal row, denormals, and one
    row of 300,000 and of 3,000,000; and for the grid-wide instance (rows
    of at least ``ops.TOPK_GRID_MIN_L``): rows of odd length whose ties
    straddle the chunks, an all-equal row, integer ties and
    NaN/inf/-0 rows."""
    import numpy as np
    import torch
    rng = np.random.default_rng(10)
    cases = []
    for n in (1, 40, 200):
        for L in (20000, 20037):
            cases.append((f"[{n},{L}]", (rng.normal(size=(n, L)) * 10)))
            cases.append((f"[{n},{L}] ties", rng.integers(-3, 4, (n, L))))
    L = 16384
    straddle = rng.normal(size=L) * 1e-3
    for c in range(1, 8):
        straddle[c * 2048 - 40:c * 2048 + 40] = 5.0
    straddle[rng.integers(0, L, 30)] = 9.0
    denormal = rng.normal(size=L) * 1e-41
    denormal[::7] = 0.0
    denormal[::11] = -0.0
    cases += [("straddling ties", straddle[None]),
              ("all-equal row", np.full((1, L), -2.5)),
              ("denormals", denormal[None])]
    for L in (300_000, 3_000_000):
        cases.append((f"[1,{L}]", rng.normal(size=(1, L))))
        cases.append((f"[1,{L}] ties", rng.integers(-50, 51, (1, L))))
    # the grid-wide instance: odd L (rows start unaligned), ties across the
    # chunk edges, the all-equal row (the candidates overflow, its ties are
    # ranked), more ties than the budget, NaN/inf/-0
    L = 200_003
    edges = rng.normal(size=(3, L)) * 1e-3
    for c in range(1, L // 4096 + 1):          # ops.topk_chunk(3, L, 132)
        edges[:, c * 4096 - 50:c * 4096 + 50] = 5.0
    edges[:, rng.integers(0, L, 40)] = 9.0
    special = rng.normal(size=(2, 150_001))
    special[:, ::97] = np.nan
    special[:, 5::89] = np.inf
    special[:, 7::83] = -np.inf
    special[:, ::13] = -0.0
    cases += [(f"[3,{L}] chunk-edge ties", edges),
              ("[1,300001] all-equal", np.full((1, 300_001), -2.5)),
              ("[2,150001] integer ties", rng.integers(-3, 4, (2, 150_001))),
              ("[2,150001] nan inf -0", special)]
    return [(what, torch.as_tensor(np.asarray(x, np.float32)))
            for what, x in cases]


def phase_topk_cluster(dev, ops, ref, err):
    """Phase 2, fused_topk across both instances, the cluster sizes and
    staging modes, bit for bit against its plain version, each case through
    the instance ``topk_plan`` names (by the per-instance launch counts);
    the grid-wide rows also through the grouped entry with a mixed frac
    [G], and the same bits over two runs; updates err["fused_topk"]."""
    import torch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sizes, kinds = set(), set()
    for what, x in topk_rows():
        kind, size = ops.topk_plan(*x.shape, sms)
        kinds.add(kind)
        if kind == "cluster":
            sizes.add(size)
        xd = x.to(dev)
        for frac in (1e-4, 0.01, 0.1, 0.5):
            ops.reset_launches()
            out, bits = ops.fused_topk(xd, frac)
            check(ops.topk_instances["fused_topk"][kind] == 1,
                  f"fused_topk on {what} did not take the {kind} instance: "
                  f"{ops.topk_instances}")
            want, want_bits = ref.fused_topk_ref(x, frac)
            check(bit_identical(out, want) and bit_identical(bits, want_bits),
                  f"fused_topk differs from its plain version on {what} "
                  f"frac={frac}")
            err["fused_topk"] = max(err["fused_topk"], max_abs_err(out, want))
            if kind == "grid":
                check(same_bits(out, ops.fused_topk(xd, frac)[0]),
                      f"fused_topk's grid instance differs between two runs "
                      f"on {what} frac={frac}")
        if kind == "grid":
            G = x.shape[0]
            frac = torch.tensor([0.01, 0.25, 1e-4][:G], dtype=torch.float32)
            ops.reset_launches()
            out, bits = ops.fused_topk_grouped(xd, frac.to(dev))
            check(ops.topk_instances["fused_topk_grouped"]["grid"] == 1,
                  f"fused_topk_grouped on {what}: {ops.topk_instances}")
            want, want_bits = ref.fused_topk_grouped_ref(x, frac)
            check(bit_identical(out, want) and bit_identical(bits, want_bits),
                  f"fused_topk_grouped differs from its plain version on "
                  f"{what} frac={frac.tolist()}")
        del xd
    torch.cuda.synchronize()
    sizes |= {ops.topk_cluster(20, L, sms) for L in (123, 492, 5000, 20000)}
    check(kinds == {"cluster", "grid"}, f"instances taken: {kinds}")
    log(f"phase 2: fused_topk bit-identical on the cluster and grid-wide "
        f"cases (and fused_topk_grouped on the grid-wide ones); cluster "
        f"sizes taken in phase 2 {sorted(sizes)} on {sms} SMs; the grid "
        f"instance from L >= {ops.TOPK_GRID_MIN_L}")


def flash_inputs(shape, dtype, dev, seed=0):
    import torch
    B, H, KV, S, D, _, _ = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(s, generator=g).to(dev, dtype)
            for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))]


def phase_flash_kernel(dev, fa_ops, fa_ref):
    """Phase 2, flash attention: the kernel against its plain version on
    the card, on the same inputs, and bitwise equal over two runs; returns
    the largest |Δ| per dtype."""
    import torch
    err = {}
    for shape in FLASH_SHAPES + [SERVE_SHAPE]:
        dtypes = ((torch.float32,) if shape == SERVE_SHAPE
                  else (torch.float32, torch.bfloat16))
        for dtype in dtypes:
            q, k, v = flash_inputs(shape, dtype, dev)
            window, cap = shape[5], shape[6]
            got = fa_ops.flash_attention(q, k, v, window, cap)
            again = fa_ops.flash_attention(q, k, v, window, cap)
            torch.cuda.synchronize()
            check(same_bits(got, again), f"flash_attention differs between "
                  f"two runs at {shape} {dtype}")
            want = fa_ref.attention_ref(q, k, v, window, cap)
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            check(got.dtype == dtype, f"flash_attention returned {got.dtype}")
            got, want = got.float(), want.float()
            ok = bool(((got - want).abs() <= tol + tol * want.abs()).all())
            e = max_abs_err(got, want)
            check(ok,
                  f"flash_attention differs from its plain version at "
                  f"{shape} {dtype}: max |Δ| {e!r} beyond rtol=atol={tol}")
            name = str(dtype).replace("torch.", "")
            err[name] = max(err.get(name, 0.0), e)
            log(f"phase 2: flash_attention {shape} {name}: max |Δ| {e!r}; "
                f"bitwise equal over two runs")
            del q, k, v, got, again, want
    torch.cuda.empty_cache()
    return err


def to_cpu(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.cpu(), tree)


def phase_serve_depth2(serve):
    """Phase 5: tinyllama-1.1b at full width, depth 2, on the card against
    the port on this machine's CPU (weights built once, on the card)."""
    import torch
    cfg, params, tokens = serve.setup(TINYLLAMA, smoke=False, batch=1,
                                      prompt_len=256, device="cuda",
                                      n_layers=2)
    card = serve.generate(cfg, params, tokens, gen=8)
    cpu = serve.generate(cfg, to_cpu(params), tokens.cpu(), gen=8,
                         feed=card["generated"].cpu())
    got, want = card["logits"].cpu(), cpu["logits"]
    bound = 1e-4 * float(want.abs().max())
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), "depth 2: logits not finite")
    check(err <= bound, f"depth 2: card logits {err!r} from the CPU's, "
          f"beyond 1e-4 · max |logits| = {bound!r}")
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > bound
    ids_card, ids_cpu = got.argmax(-1), want.argmax(-1)
    check(bool((ids_card == ids_cpu)[sure].all()),
          "depth 2: greedy ids differ where the top-2 margin is clear")
    log(f"phase 5: tinyllama depth 2, prompt 256, 8 steps: logits max |Δ| "
        f"card-CPU {err!r} (bound {bound!r}); greedy ids equal at "
        f"{int(sure.sum())} of {sure.numel()} positions with a clear margin; "
        f"ids {ids_card[:, 0].tolist()}")
    del params
    torch.cuda.empty_cache()
    return dict(max_abs_logit_diff=err, bound=bound,
                clear_margin_positions=int(sure.sum()))


def device_rows(prof):
    """(device µs, count, name) of the device-side events of a profile
    (kernels, copies): the operator events that launched them carry the
    same time again."""
    return [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]


def phase_serve_full(serve, fa_ops):
    """Phase 6: tinyllama-1.1b, all 22 layers, float32: batch 8, prompt
    1024, 64 greedy steps (after a short warm-up run), then a profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cfg, params, tokens = serve.setup(TINYLLAMA, smoke=False, batch=8,
                                      prompt_len=1024, device="cuda")
    n_layers = cfg.n_layers
    serve.generate(cfg, params, tokens, gen=4)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_launches()
    out = serve.generate(cfg, params, tokens, gen=64)
    launches = fa_ops.launches["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    check(out["prefill_flash_launches"] == n_layers == launches,
          f"full depth: flash_attention launched {launches} times "
          f"({out['prefill_flash_launches']} in the prefill), expected "
          f"{n_layers}")
    check(bool(torch.isfinite(out["logits"]).all()),
          "full depth: logits not finite")
    res = dict(prefill_ms=out["prefill_ms"], decode_ms=out["decode_ms"],
               tokens_per_s=out["tokens_per_s"], peak_gib=peak / 2**30,
               launches=launches)
    log(f"phase 6: {TINYLLAMA} x{n_layers} f32, batch 8, prompt 1024, 64 "
        f"steps: prefill {out['prefill_ms']!r} ms, decode "
        f"{out['decode_ms']!r} ms/step, {out['tokens_per_s']!r} tokens/s, "
        f"peak memory {peak / 2**30!r} GiB; flash_attention launches "
        f"{launches}; row 0 ids {out['generated'][0, :16].tolist()}")
    # profiles of serve.generate itself: a prefill and 1 step, then a
    # prefill and 9 steps; their difference over 8 is one decode step
    windows = {}
    for gen in (1, 9):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve.generate(cfg, params, tokens, gen=gen)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        rows = {}
        for t, count, name in device_rows(prof):
            t0_, c0 = rows.get(name, (0.0, 0))
            rows[name] = (t0_ + t, c0 + count)
        windows[gen] = (wall_us, rows)
    (wall1, rows1), (wall9, rows9) = windows[1], windows[9]
    step = {name: ((t - rows1.get(name, (0.0, 0))[0]) / 8,
                   (c - rows1.get(name, (0.0, 0))[1]) / 8)
            for name, (t, c) in rows9.items()}
    res["profile"] = {}
    for label, wall_us, rows in (("prefill + 1 step", wall1, rows1),
                                 ("decode step", (wall9 - wall1) / 8, step)):
        busy = sum(t for t, _ in rows.values())
        n_kernels = sum(c for _, c in rows.values())
        flash_us = sum(t for name, (t, _) in rows.items()
                       if "flash_fwd" in name)
        top = sorted(((t, c, name) for name, (t, c) in rows.items()),
                     reverse=True)[:10]
        log(f"profile serve {label} (profiled): wall {wall_us / 1e3!r} ms, "
            f"device busy {busy / 1e3!r} ms ({100 * busy / wall_us:.1f}% "
            f"of wall), {n_kernels:g} device kernels and copies, "
            f"flash_attention {flash_us / 1e3!r} ms")
        for t, count, name in top:
            log(f"  {t / 1e3:10.4f} ms  x{count:7.1f}  {name[:80]}")
        res["profile"][label] = dict(
            wall_ms=wall_us / 1e3, busy_ms=busy / 1e3, kernels=n_kernels,
            flash_ms=flash_us / 1e3,
            top=[[t / 1e3, c, name[:80]] for t, c, name in top])
    del params
    torch.cuda.empty_cache()
    return res


def phase_flash_timing(dev, fa_ops, fa_ref):
    """The flash forward at the serving shape by CUDA events, in float32
    and bfloat16, beside its plain version, the library call (SDPA in the
    same dtype, timed only) and its bound at the arithmetic the kernel
    uses: float32 as 3xTF32 (three TF32 products a product), bf16 on the
    bf16 tensor cores.  The float32 CUDA-core bound is logged too."""
    import torch
    import torch.nn.functional as F
    B, H, KV, S, D, _, _ = SERVE_SHAPE
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = flash_inputs(SERVE_SHAPE, dtype, dev, seed=1)
        r = dict(ms=cuda_ms(lambda: fa_ops.flash_attention(q, k, v), 20),
                 plain_ms=cuda_ms(lambda: fa_ref.attention_ref(q, k, v), 5))
        try:
            r["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 20)
        except (TypeError, RuntimeError) as exc:       # no enable_gqa here
            log(f"timing: scaled_dot_product_attention unavailable: {exc}")
            r["library_ms"] = None
        ops = 4 * B * H * S * S * D / 2                  # causal half
        nbytes = q.element_size() * (2 * B * H * S * D + 2 * B * KV * S * D)
        tensor_ops, rate = ((3 * ops, TF32_OPS_PER_S)
                            if dtype == torch.float32
                            else (ops, BF16_OPS_PER_S))
        t_ops = 1e3 * tensor_ops / rate
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        r.update(bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 ops=ops, tensor_ops=tensor_ops, bytes=nbytes,
                 cuda_core_bound_ms=1e3 * ops / F32_OPS_PER_S,
                 tflops=ops / r["ms"] / 1e9)
        name = str(dtype).replace("torch.", "")
        log(f"timing flash_attention {list(SERVE_SHAPE[:5])} {name}: "
            f"{r['ms']!r} ms (plain {r['plain_ms']!r} ms, SDPA "
            f"{r['library_ms']!r} ms; bound {r['bound_ms']!r} ms by "
            f"{r['bound_by']}: {tensor_ops:.4g} tensor-core operations at "
            f"{rate / 1e12:g} TFLOP/s, {nbytes:.4g} bytes; float32 "
            f"CUDA-core bound {r['cuda_core_bound_ms']!r} ms); "
            f"{r['tflops']!r} TFLOP/s of the function's products")
        res[name] = r
        del q, k, v
    torch.cuda.empty_cache()
    return res


def drive(quickstart, ops, counts_total, expect, label, iters, **kw):
    """One main-path run on the card, through the quickstart's pieces:
    the counters are set to 0 just before the recorded run and read just
    after, and each must equal ``expect``.  A second run of the same rounds
    without metrics is timed by the host clock around synchronize."""
    import torch
    from repro_torch.core.driver import run_experiment
    prob, step, state, key = quickstart.setup(device="cuda", **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    _, tr = run_experiment(step, state, key, iters,
                           record=lambda st: prob.metrics(st.w))
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: launches {counts}")
    for name, n in expect.items():
        check(counts[name] == n, f"{label}: {name} launched {counts[name]} "
              f"times, expected {n}")
    for name in counts_total:
        counts_total[name] += counts[name]
    t0 = time.perf_counter()
    run_experiment(step, state, key, iters)
    torch.cuda.synchronize()
    round_ms = 1e3 * (time.perf_counter() - t0) / iters
    return prob, tr, round_ms, peak


def compare_ledgers_and_F(label, gpu, cpu, per_round, n_workers=20):
    """Exact ledgers (equal on both devices and ``per_round`` a round);
    returns the per-round relative difference of F, card against CPU."""
    import numpy as np
    bits_g = gpu["bits_per_node"].cpu().numpy()
    check(np.array_equal(bits_g, cpu["bits_per_node"].numpy()),
          f"{label}: card and CPU ledgers differ")
    want = per_round * np.arange(1, len(bits_g) + 1, dtype=np.float64)
    check(np.array_equal(bits_g, np.repeat(want[:, None], n_workers, 1)),
          f"{label}: ledger is not {per_round} a round")
    F_g = gpu["F"].cpu().numpy().astype(np.float64)
    F_c = cpu["F"].numpy().astype(np.float64)
    with np.errstate(invalid="ignore"):
        rel = np.abs(F_g / F_c - 1)
    log(f"{label}: final bits {bits_g[-1, 0]:.0f}; F card "
        f"{float(F_g[-1])!r} cpu {float(F_c[-1])!r}; rel diff final "
        f"{float(rel[-1])!r} max {float(np.nanmax(rel))!r}")
    return F_g, rel


def main_path_expect(n_dither: int, n_top: int) -> dict:
    """Launches of a main-path run with ``n_dither`` dithered and ``n_top``
    top-k messages: the round is the sweep step's [1] grid, so every
    message and ledger takes a grouped entry, and the scalar entries and
    the u-taking dither are never launched."""
    return {"fused_dither_keyed_grouped": n_dither,
            "dither_bits_grouped": n_dither,
            "fused_topk_grouped": n_top, "topk_bits_grouped": n_top,
            "fused_dither": 0, "fused_dither_keyed": 0, "dither_bits": 0,
            "fused_topk": 0, "topk_bits": 0}


def phase_quickstart(quickstart, ops, counts_total):
    """Phase 3: the quickstart on the card against the port on the CPU."""
    import numpy as np
    out = {}
    for hess, iters, per_round in (("dither64", 201, 5432),
                                   ("topk0.1", 50, 3546)):
        n_top = iters if hess.startswith("topk") else 0
        expect = main_path_expect(2 * iters - n_top, n_top)
        label = f"quickstart {hess} x{iters}"
        _, gpu, round_ms, _ = drive(quickstart, ops, counts_total, expect,
                                    label, iters, hess=hess, **QUICK)
        _, _, cpu = quickstart.run(iters, device="cpu", hess=hess, **QUICK)
        F, rel = compare_ledgers_and_F(label, gpu, cpu, per_round)
        log(f"{label}: {round_ms!r} ms/round on the card")
        out[hess] = dict(round_ms=round_ms, F_final=float(F[-1]),
                         rel_final=float(rel[-1]))
        if n_top == 0:
            # the topk0.1 quickstart diverges (F -> inf) in the reference
            # itself, so only its ledger is held
            check(np.isfinite(F).all(), f"{label}: F not finite")
            check(rel[-1] <= 1e-4, f"{label}: final F beyond rtol 1e-4")
    return out


def phase_gisette(quickstart, ops, counts_total):
    """Phase 4: gisette width on the card: exact ledgers, F against the
    port on this machine's CPU (dither), round time and peak memory."""
    import numpy as np
    quickstart.run(2, record=False, device="cuda", **GISETTE)    # warm-up
    out = {}
    for hess, per_round in (("dither64", 200_512), ("topk0.1", 134_512)):
        n_top = 10 if hess.startswith("topk") else 0
        expect = main_path_expect(20 - n_top, n_top)
        label = f"gisette {hess} x10"
        _, gpu, round_ms, peak = drive(quickstart, ops, counts_total, expect,
                                       label, 10, hess=hess, **GISETTE)
        log(f"{label}: {round_ms!r} ms/round (host clock around "
            f"synchronize); peak memory {peak / 2**30!r} GiB; F "
            f"{gpu['F'].tolist()}")
        res = dict(round_ms=round_ms, peak_gib=peak / 2**30,
                   F=gpu["F"].tolist())
        if n_top == 0:
            _, _, cpu = quickstart.run(10, device="cpu", hess=hess,
                                       **GISETTE)
            F, rel = compare_ledgers_and_F(label, gpu, cpu, per_round)
            # a last-ulp difference moves a dithered value across a
            # rounding boundary now and then, and the run amplifies it
            # (scripts/torch_vs_reference.py shows the same spread between
            # the port and the JAX reference on the CPU)
            check(np.isfinite(F).all() and float(np.nanmax(rel)) <= 1e-3,
                  f"{label}: F not finite or beyond rtol 1e-3 of the CPU")
            res["rel_max"] = float(np.nanmax(rel))
        else:
            bits = gpu["bits_per_node"].cpu().numpy()
            want = per_round * np.arange(1, 11, dtype=np.float64)
            check(np.array_equal(bits, np.repeat(want[:, None], 20, 1)),
                  f"{label}: ledger is not {per_round} a round")
        out[hess] = res
    return out


def profile_rounds(quickstart, iters, **kw):
    """torch.profiler over ``iters`` rounds of the quickstart's pieces
    (``kw``: setup keywords) on the card, after one round: (profiled wall
    µs, device rows as ``device_rows`` gives them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.driver import run_experiment
    _, step, state, key = quickstart.setup(device="cuda", **kw)
    run_experiment(step, state, key, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_experiment(step, state, key, iters)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    return wall_us, device_rows(prof)


def int64_elementwise(rows) -> tuple:
    """(device µs, launches) of the int64 elementwise kernels among a
    profile's device rows: threefry in tensor ops (``random.py``)."""
    mine = [(t, c) for t, c, name in rows
            if "elementwise" in name and ("long" in name or "int64" in name)]
    return sum(t for t, _ in mine), sum(c for _, c in mine)


#: Each compressor entry's kernel, as the profiler names it (a name may
#: end another: dither_bits_kernel and grouped_dither_bits_kernel).
KERNEL_SYMBOLS = {
    "fused_dither": "fused_dither_kernel",
    "fused_dither_keyed": "fused_dither_keyed_kernel",
    "fused_topk": "fused_topk_kernel",
    "dither_bits": "dither_bits_kernel",
    "topk_bits": "topk_bits_kernel",
    "fused_dither_keyed_grouped": "grouped_dither_keyed_kernel",
    "fused_topk_grouped": "grouped_topk_kernel",
    "dither_bits_grouped": "grouped_dither_bits_kernel",
    "topk_bits_grouped": "grouped_topk_bits_kernel",
}


def phase_profile(quickstart):
    """Phase 7: where a round's device time goes: torch.profiler over 10
    quickstart rounds and 3 gisette rounds; the device kernels a round and
    the int64 elementwise launches among them, the top kernels by device
    time, each compressor kernel's device time per launch, and the
    device's busy share of the profiled window's wall time (the profiler
    slows the host, so the window is longer than an unprofiled round)."""
    out = {}
    for label, iters, kw in (("quickstart", 10, QUICK),
                             ("gisette", 3, GISETTE)):
        wall_us, rows = profile_rounds(quickstart, iters, **kw)
        for name, symbol in KERNEL_SYMBOLS.items():
            mine = [r for r in rows
                    if re.search(rf"(?<!\w){symbol}(?!\w)", r[2])]
            t = sum(r[0] for r in mine)
            n = sum(r[1] for r in mine)
            log(f"profile {label}: {name} {n / iters:g} launches/round, "
                f"{t / max(n, 1) / 1e3!r} ms device time per launch")
            out.setdefault(f"{label}_kernel_ms", {})[name] = (
                t / max(n, 1) / 1e3)
        busy = sum(r[0] for r in rows)
        kernels = sum(r[1] for r in rows) / iters
        i64_us, i64_n = int64_elementwise(rows)
        rows.sort(reverse=True)
        log(f"profile {label} x{iters}: wall {wall_us / iters / 1e3!r} "
            f"ms/round, device busy {busy / iters / 1e3!r} ms/round "
            f"({100 * busy / wall_us:.1f}% of wall); {kernels:g} device "
            f"kernels and copies a round, of which {i64_n / iters:g} int64 "
            f"elementwise ({i64_us / iters / 1e3!r} ms)")
        for t, count, name in rows[:12]:
            log(f"  {t / iters / 1e3:10.4f} ms/round  x{count / iters:6.1f}"
                f"  {name[:70]}")
        out[label] = dict(wall_ms=wall_us / iters / 1e3,
                          busy_ms=busy / iters / 1e3,
                          kernels_per_round=kernels,
                          int64_launches_per_round=i64_n / iters,
                          int64_ms_per_round=i64_us / iters / 1e3)
    return out


#: The rounds ``kernel_timing.py quickstart`` times: (label, rounds timed,
#: setup keywords).
ROUND_CELLS = (("quickstart dither64/dither64", 50, dict(QUICK)),
               ("quickstart dither64/topk0.1", 50,
                dict(QUICK, hess="topk0.1")),
               ("gisette dither64/dither64", 10, dict(GISETTE)),
               ("gisette dither64/topk0.1", 10,
                dict(GISETTE, hess="topk0.1")))


def round_timing(quickstart) -> dict:
    """Each ROUND_CELLS cell on the card: round ms (host clock around
    rounds that end in a synchronize, after a warm-up run), then device
    kernels a round and int64 elementwise launches a round (a profile of
    3 rounds)."""
    import torch
    from repro_torch.core.driver import run_experiment
    out = {}
    for label, iters, kw in ROUND_CELLS:
        _, step, state, key = quickstart.setup(device="cuda", **kw)
        run_experiment(step, state, key, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_experiment(step, state, key, iters)
        torch.cuda.synchronize()
        round_ms = 1e3 * (time.perf_counter() - t0) / iters
        _, rows = profile_rounds(quickstart, 3, **kw)
        _, i64_n = int64_elementwise(rows)
        r = dict(round_ms=round_ms,
                 kernels_per_round=sum(c for _, c, _ in rows) / 3,
                 int64_launches_per_round=i64_n / 3,
                 busy_ms_per_round=sum(t for t, _, _ in rows) / 3e3)
        log(f"rounds {label}: {round_ms!r} ms a round over {iters}; "
            f"{r['kernels_per_round']:g} device kernels and copies a round, "
            f"{r['int64_launches_per_round']:g} int64 elementwise; device "
            f"busy {r['busy_ms_per_round']!r} ms a round")
        out[label] = r
        torch.cuda.empty_cache()
    return out


#: Row lengths each row kernel is timed at: gisette's (d = 5000, its
#: Hessian rows m*d = 20000) and the quickstart's (d = 123, m*d = 492),
#: where 462 of the keyed dither's 482 main-path launches and 50 of
#: top-k's 60 run.
TIMED_L = {"fused_dither": (5000, 20000),
           "fused_dither_keyed": (123, 492, 5000, 20000),
           "fused_topk": (492, 20000)}


def phase_timing(dev, ops, ref, random, library):
    """Per-kernel device times at the main path's shapes (TIMED_L), beside
    the plain version, the library call (top-k) and the bound.  The keyed
    dither's bound is the larger of its bytes and its main loop's
    instructions on the busiest pipe, read from the SASS of ``library``
    (the built compressor library; ``loop_clocks_per_element``)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(0)
    n = 20
    rows = {L: torch.randn((n, L), generator=g).to(dev)
            for L in sorted(set(sum(TIMED_L.values(), ())))}
    key = random.key(3, dev)
    us = {L: random.uniform(random.split(key, n), (L,)) for L in rows}
    res = {}
    clocks, pipe, per, elems = loop_clocks_per_element(library,
                                                       KEYED_DITHER_SASS)
    log(f"fused_dither_keyed_kernel main loop, {elems} elements a trip, "
        f"thread-instructions an element by pipe (SASS): "
        + ", ".join(f"{k} {v!r}" for k, v in per.items())
        + f"; bound {clocks!r} SM clocks an element on the {pipe} pipe")
    for L in TIMED_L["fused_dither_keyed"]:
        x = rows[L]
        keyed = lambda: ops.fused_dither_keyed(x, key, 64.0)  # noqa: E731
        res[("fused_dither_keyed", L)] = dict(
            ms=cuda_ms(keyed, 200), host_ms=cuda_ms(keyed, 200, False),
            plain_ms=cuda_ms(lambda: ref.fused_dither_keyed_ref(
                x, key, 64.0), 20),
            library_ms=None, bytes=8 * n * L + 4 * n + 16,
            ops=clocks * n * L, rate=SM_CLOCKS_PER_S, pipe=pipe,
            clocks_per_element=clocks)
    for L in TIMED_L["fused_dither"]:
        x, u = rows[L], us[L]
        dither = lambda: ops.fused_dither(x, u, 64.0)       # noqa: E731
        res[("fused_dither", L)] = dict(
            ms=cuda_ms(dither, 200), host_ms=cuda_ms(dither, 200, False),
            plain_ms=cuda_ms(lambda: ref.fused_dither_ref(x, u, 64.0), 20),
            library_ms=None,
            bytes=12 * n * L + 4 * n, ops=10 * n * L)
    for L in TIMED_L["fused_topk"]:
        x, k = rows[L], ref.topk_keep_count(0.1, L)
        topk = lambda: ops.fused_topk(x, 0.1)                # noqa: E731
        res[("fused_topk", L)] = dict(
            ms=cuda_ms(topk, 200), host_ms=cuda_ms(topk, 200, False),
            plain_ms=cuda_ms(lambda: ref.fused_topk_ref(x, 0.1), 20),
            library_ms=cuda_ms(lambda: torch.topk(x.abs(), k, dim=1), 100),
            bytes=8 * n * L + 4 * n, ops=34 * n * L)
    for name, fn, plain in (
            ("dither_bits", lambda: ops.dither_bits(64.0, 20000, dev),
             lambda: ref.dither_bits_ref(64.0, 20000, dev)),
            ("topk_bits", lambda: ops.topk_bits(0.1, 20000, dev),
             lambda: ref.topk_bits_ref(0.1, 20000, dev))):
        res[(name, 1)] = dict(ms=cuda_ms(fn, 200),
                              host_ms=cuda_ms(fn, 200, False),
                              plain_ms=cuda_ms(plain, 20), library_ms=None,
                              bytes=4, ops=12)
    for r in res.values():
        t_bytes = 1e3 * r["bytes"] / HBM_BYTES_PER_S
        t_ops = 1e3 * r["ops"] / r.pop("rate", F32_OPS_PER_S)
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    for (name, L), r in res.items():
        shape = f"[{n},{L}]" if L > 1 else "(scalar)"
        pipe = f" ({r['pipe']} pipe)" if "pipe" in r else ""
        log(f"timing {name} {shape}: {r['ms']!r} ms (as issued from "
            f"Python {r['host_ms']!r} ms; plain "
            f"{r['plain_ms']!r} ms, library {r['library_ms']!r} ms, bound "
            f"{r['bound_ms']!r} ms by {r['bound_by']}{pipe})")
    return res


# ---------------------------------------------------------------------------
# Slice 7: the comparison set (DIANA, FedNL, GD), [G] sweeps, ExperimentPlan
# ---------------------------------------------------------------------------

#: The grouped entries (one launch for a grid of G points) replace the same
#: Pallas kernels as their scalar entries.
GROUPED_REPLACES = {
    "fused_dither_keyed_grouped": REPLACES["fused_dither_keyed"],
    "fused_topk_grouped": REPLACES["fused_topk"],
    "dither_bits_grouped": REPLACES["dither_bits"],
    "topk_bits_grouped": REPLACES["topk_bits"],
}
#: Rows a grid point of phase 2's grouped cases holds: n, L (G·n rows in
#: all; with G = 1, 3, 8 they take every cluster size of both row kernels).
GROUPED_ROWS = ((20, 123), (20, 492), (20, 5000), (5, 300), (2, 20001),
                (1, 20000))
#: FedNL's Hessian-difference rows at gisette width: d² = 25,000,000.
LONG_L = 25_000_000
PLAN_PROBLEM = dict(d=123, n_workers=20, r=64, mu=1e-3, seed=0)
GISETTE_PROBLEM = dict(d=5000, n_workers=20, r=300, mu=1e-3, seed=0)


def phase_grouped_kernels(dev, ops, ref, random, compressors):
    """Phase 2, the grouped entries: each against its plain version on a CPU
    copy and against G launches of its scalar entry on the card, bit for
    bit, at G = 1, 3, 8 (every cluster size); a grid spec mixing families
    through ``compress_split`` and ``spec_bits_many`` against the CPU; and
    fused_topk_grouped on [60, 25,000,000] (1.5 G elements, past 2^32
    bytes) against fused_topk and the plain version on the card, per
    point."""
    import numpy as np
    import torch
    err = {name: 0.0 for name in GROUPED_REPLACES}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(17)
    f32 = np.float32

    def plain(name, got, want, what):
        check(bit_identical(got, want), f"{name} differs from its plain "
              f"version on {what}")
        err[name] = max(err[name], max_abs_err(got, want))

    def scalar(name, got, want, what):
        check(bit_identical(got, want), f"{name} differs from its scalar "
              f"entry on {what}")

    sizes = {"dither": set(), "topk": set()}
    for G in (1, 3, 8):
        s = torch.as_tensor(rng.choice([1.0, 4.0, 16.0, 64.0, 127.0],
                                       G).astype(f32))
        frac = torch.as_tensor(rng.choice([1e-4, 0.01, 0.1, 0.25, 1.0],
                                          G).astype(f32))
        keys = random.split(random.key(100 + G, "cpu"), G)
        sd, fd, kd = s.to(dev), frac.to(dev), keys.to(dev)
        for n, L in GROUPED_ROWS:
            x = torch.as_tensor((rng.normal(size=(G * n, L)) * 10)
                                .astype(f32))
            x[0, :L // 2] = 0.0              # shares whose maximum is 0
            xd = x.to(dev)
            what = f"G={G} [{G * n},{L}]"
            out, bits = ops.fused_dither_keyed_grouped(xd, kd, sd)
            want, want_bits = ref.fused_dither_keyed_grouped_ref(x, keys, s)
            plain("fused_dither_keyed_grouped", out, want, what)
            plain("fused_dither_keyed_grouped", bits, want_bits, what)
            tout, tbits = ops.fused_topk_grouped(xd, fd)
            want, want_bits = ref.fused_topk_grouped_ref(x, frac)
            plain("fused_topk_grouped", tout, want, what)
            plain("fused_topk_grouped", tbits, want_bits, what)
            for g in range(G):
                rows = slice(g * n, (g + 1) * n)
                o, b = ops.fused_dither_keyed(xd[rows], kd[g], float(s[g]))
                scalar("fused_dither_keyed_grouped", out[rows], o, what)
                scalar("fused_dither_keyed_grouped", bits[rows], b, what)
                o, b = ops.fused_topk(xd[rows], float(frac[g]))
                scalar("fused_topk_grouped", tout[rows], o, what)
                scalar("fused_topk_grouped", tbits[rows], b, what)
            sizes["dither"].add(ops.dither_cluster(G * n, L, sms))
            sizes["topk"].add(ops.topk_cluster(G * n, L, sms))
        for d in (1, 123, 492, 5000, 20000, LONG_L):
            for name, grouped, fn_ref, fn_scalar, p in (
                    ("dither_bits_grouped", ops.dither_bits_grouped,
                     ref.dither_bits_grouped_ref, ops.dither_bits, s),
                    ("topk_bits_grouped", ops.topk_bits_grouped,
                     ref.topk_bits_grouped_ref, ops.topk_bits, frac)):
                got = grouped(p.to(dev), d)
                plain(name, got, fn_ref(p, d), f"G={G} d={d}")
                scalar(name, got, torch.stack([
                    fn_scalar(float(v), d, dev) for v in p]), f"d={d}")
    torch.cuda.synchronize()
    check(sms != 132 or sizes["dither"] == sizes["topk"] == {1, 2, 4, 8},
          f"grouped cluster sizes taken {sizes}")
    # a grid mixing families, one of them not a run of points
    names = ("identity", "dither64", "topk0.25", "dither16", "identity",
             "topk0.01", "dither64")
    spec = compressors.stack_specs(*names)
    G = len(names)
    x = torch.as_tensor(rng.normal(size=(G, 20, 492)).astype(f32))
    keys = random.split(random.key(7, "cpu"), G)
    got = compressors.compress_split(compressors.spec_to(spec, dev),
                                     keys.to(dev), x.to(dev))
    want = compressors.compress_split(spec, keys, x)
    check(bit_identical(got, want), "mixed-family compress_split differs "
          "from the CPU's")
    for d in (123, 492, LONG_L):
        check(bit_identical(compressors.spec_bits_many(
            compressors.spec_to(spec, dev), d),
            compressors.spec_bits_many(spec, d)),
            f"mixed-family spec_bits_many differs from the CPU's at d={d}")
    # FedNL's rows at gisette width, three points of 20 rows
    frac = (0.25, 0.1, 0.25)
    x = torch.randn((60, LONG_L), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    out, bits = ops.fused_topk_grouped(
        x, torch.tensor(frac, dtype=torch.float32, device=dev))
    for g, f in enumerate(frac):
        rows = slice(20 * g, 20 * (g + 1))
        o, b = ops.fused_topk(x[rows], f)
        scalar("fused_topk_grouped", out[rows], o, "[60,25000000]")
        del o
        want, want_bits = ref.fused_topk_ref(x[rows], f)
        plain("fused_topk_grouped", out[rows], want, "[60,25000000]")
        plain("fused_topk_grouped", bits[rows], want_bits, "[60,25000000]")
        del want
        torch.cuda.empty_cache()
    del x, out
    torch.cuda.empty_cache()
    log(f"phase 2: the grouped entries bit-identical to their plain versions "
        f"and to G launches of the scalar entries at G = 1, 3, 8 "
        f"(cluster sizes {sizes}), on a mixed-family grid and on "
        f"[60,{LONG_L}]; max_abs_err {err}")
    return err


def _plan_launches(api, plan, ops):
    """Run a plan on the card with the launch counters set to 0 just
    before and read just after: (result, launches)."""
    import torch
    torch.cuda.synchronize()
    ops.reset_launches()
    res = api.run_plan(plan)
    torch.cuda.synchronize()
    return res, dict(ops.launches)


def phase_plans(api, experiments, make_problem, ops, counts):
    """Phase 3b: ``budget_fair_plan`` (five methods × 3 budgets),
    ``baselines_plan`` and ``fig1_plan`` at quickstart size on the card,
    against the port on this machine's CPU: bit ledgers, activity counts,
    round counters and scan lengths equal, every grid point's final F
    within rtol 1e-4, budget rounds equal and every frozen tail bit-stable
    (``experiments.budget_fair_rows``)."""
    import numpy as np
    gpu = make_problem(**PLAN_PROBLEM, device="cuda")
    cpu = make_problem(**PLAN_PROBLEM, device="cpu")
    out = {}
    for name, make in (("budget_fair", experiments.budget_fair_plan),
                       ("baselines", experiments.baselines_plan),
                       ("fig1", experiments.fig1_plan)):
        res, launched = _plan_launches(api, make(gpu), ops)
        for k, v in launched.items():
            counts[k] += v
        want = api.run_plan(make(cpu))
        check(res.labels == want.labels, f"{name}: labels differ")
        rel_final, rounds, rels = 0.0, 0, {}
        for lab in res.labels:
            (st, tr), (wst, wtr) = res[lab], want[lab]
            for key in ("bits_per_node", "n_active"):
                check(np.array_equal(tr[key].cpu().numpy(),
                                     wtr[key].numpy()),
                      f"{name} {lab}: {key} differs from the CPU's")
            check(np.array_equal(st.k.cpu().numpy(), wst.k.numpy()),
                  f"{name} {lab}: round counters differ")
            F = tr["F"].cpu().numpy().astype(np.float64)
            Fc = wtr["F"].numpy().astype(np.float64)
            check(F.shape == Fc.shape and np.isfinite(F).all(),
                  f"{name} {lab}: F not finite or of another length")
            rels[lab] = float(np.abs(F[:, -1] / Fc[:, -1] - 1).max())
            rel_final = max(rel_final, rels[lab])
            rounds += F.shape[0] * F.shape[1]
        log(f"phase 3b: {name}_plan final F, card against CPU, largest "
            f"relative difference by run: {rels}")
        check(rel_final <= 1e-4, f"{name}: final F beyond rtol 1e-4 of the "
              "CPU's")
        if name == "budget_fair":
            budgets = experiments.budget_fair_budgets(gpu)
            rows = experiments.budget_fair_rows(res, budgets)
            check([(r["bits_per_node"], r["rounds"]) for r in rows]
                  == [(r["bits_per_node"], r["rounds"]) for r in
                      experiments.budget_fair_rows(want, budgets)],
                  "budget_fair: rounds or final ledgers differ")
            out["budget_fair_rows"] = rows
        grouped = {k: v for k, v in launched.items() if "grouped" in k}
        log(f"phase 3b: {name}_plan on the card: {len(res.labels)} runs, "
            f"{rounds} point-rounds in {res.seconds!r} s; ledgers, counts "
            f"and scan lengths equal to the CPU's, final F within "
            f"{rel_final!r} of it; launches {launched}")
        out[name] = dict(seconds=res.seconds, rel_final=rel_final,
                         launches=launched, grouped=grouped)
    return out


def device_split(prof, op: str) -> dict:
    """Device events (kernels, copies, sets) of a profile split into those
    launched from inside the CPU operator ``op`` and the rest: {"op":
    (count, µs), "rest": (count, µs)}.  A device event's launch call (CUDA
    runtime or driver) carries its correlation id in the profile's trace;
    it belongs to ``op`` when that call lies inside one of the op's spans."""
    events = trace_events(prof)
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "cpu_op" and e.get("name") == op]
    out = {"op": [0, 0.0], "rest": [0, 0.0]}
    for e, ts in device_launches(events):
        side = "op" if ts is not None and any(
            a <= ts <= b for a, b in spans) else "rest"
        out[side][0] += 1
        out[side][1] += e["dur"]
    return {k: tuple(v) for k, v in out.items()}


def trace_events(prof) -> list:
    """A profile's events, as its chrome trace holds them."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


def device_launches(events: list) -> list:
    """(device event, host time of the runtime or driver call that
    launched it, None if not found) for every kernel, copy and set of a
    trace: a device event carries its launch call's correlation id."""
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    return [(e, launch_ts.get(e.get("args", {}).get("correlation")))
            for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def phase_gisette_baselines(api, experiments, make_problem, ops, ref,
                            counts):
    """Phase 4b: ``baselines_plan`` at gisette width (d=5000, n=20, r=300;
    10 rounds a method, the cut is rounds): per method the round time and
    the device kernels a round, each the difference of a 10-round and a
    1-round run (10 rounds timed by the host clock around runs that end in
    a synchronize, after a 1-round warm-up; kernels from profiles of 3 and
    1 rounds), so the run's setup (initial state, keys, pricing) is not in
    them; FedNL's kernels split into those of ``aten::linalg_eigh`` and
    the rest; peak memory and exact ledgers; FedNL's fused_topk_grouped on
    its [20, 25,000,000] rows; then fused_topk and fused_topk_grouped on
    [20, 25e6], fused_topk_grouped on [60, 25e6] beside torch.topk, and
    one eigh of 5000 × 5000."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.driver import grid1
    prob = make_problem(**GISETTE_PROBLEM, device="cuda")
    plan = experiments.baselines_plan(prob, iters=10)
    out = {}

    def profiled(plan_):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            api.run_plan(plan_)
            torch.cuda.synchronize()
        return prof

    for run in plan.runs:
        def one(iters):
            return dataclasses.replace(plan, runs=(dataclasses.replace(
                run, iters=iters),))
        api.run_plan(one(1))
        torch.cuda.synchronize()
        t1 = api.run_plan(one(1)).seconds
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, launched = _plan_launches(api, one(10), ops)
        instances = {k: dict(v) for k, v in ops.topk_instances.items()}
        peak = torch.cuda.max_memory_allocated()
        for k, v in launched.items():
            counts[k] += v
        st, tr = res[run.label]
        spec = api.get_method(run.method)
        price = np.float32(spec.round_bits(prob, run.cfg, grid1(
            spec.from_config(run.cfg)))[0])
        # the ledger adds the price once a round, in float32
        want = np.cumsum(np.full(10, price, np.float32), dtype=np.float32)
        bits = tr["bits_per_node"].cpu().numpy()
        check(np.array_equal(bits, np.broadcast_to(want[None, :, None],
                                                   bits.shape)),
              f"gisette {run.label}: ledger is not {price} a round")
        price = float(price)
        split = {n: device_split(profiled(one(n)), "aten::linalg_eigh")
                 for n in (1, 3)}
        per_round = {side: ((split[3][side][0] - split[1][side][0]) / 2,
                            (split[3][side][1] - split[1][side][1]) / 2e3)
                     for side in ("op", "rest")}
        r = dict(round_ms=1e3 * (res.seconds - t1) / 9,
                 setup_ms=1e3 * t1 - 1e3 * (res.seconds - t1) / 9,
                 kernels_per_round=per_round["op"][0]
                 + per_round["rest"][0],
                 busy_ms_per_round=per_round["op"][1] + per_round["rest"][1],
                 eigh_kernels_per_round=per_round["op"][0],
                 eigh_busy_ms_per_round=per_round["op"][1],
                 peak_gib=peak / 2**30, launches=launched,
                 topk_instances=instances,
                 F=tr["F"][0].tolist(), bits_per_round=price)
        log(f"phase 4b: gisette {run.label} x10: {r['round_ms']!r} ms a "
            f"round (setup {r['setup_ms']!r} ms), "
            f"{r['kernels_per_round']:g} device kernels and copies a round "
            f"({r['eigh_kernels_per_round']:g} of them in linalg_eigh), "
            f"device busy {r['busy_ms_per_round']!r} ms a round "
            f"({r['eigh_busy_ms_per_round']!r} in linalg_eigh), peak "
            f"{r['peak_gib']!r} GiB, {price:.0f} bits a round; F {r['F']}; "
            f"launches {launched}; top-k instances {instances}")
        out[run.label] = r
        del res, st, tr
        torch.cuda.empty_cache()
    check(out["FedNL"]["launches"]["fused_topk_grouped"] == 10,
          "gisette FedNL: fused_topk_grouped not launched once a round")
    check(out["FedNL"]["topk_instances"]["fused_topk_grouped"]["grid"] == 10,
          f"gisette FedNL: fused_topk_grouped not launched through the "
          f"grid-wide instance: {out['FedNL']['topk_instances']}")
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((20, LONG_L), generator=g, device="cuda")
    k = ref.topk_keep_count(0.25, LONG_L)
    frac1 = torch.full((1,), 0.25, dtype=torch.float32, device="cuda")
    long = {"[20,25000000]": dict(
        ms=cuda_ms(lambda: ops.fused_topk(x, 0.25), 3),
        grouped_ms=cuda_ms(lambda: ops.fused_topk_grouped(x, frac1), 3),
        library_ms=cuda_ms(lambda: torch.topk(x.abs(), k, dim=1), 3),
        bound_ms=1e3 * (8 * x.numel() + 80) / HBM_BYTES_PER_S,
        instance=ops.topk_plan(20, LONG_L, _sms("cuda"))[0])}
    del x
    torch.cuda.empty_cache()
    x = torch.randn((60, LONG_L), generator=g, device="cuda")
    frac = torch.full((3,), 0.25, dtype=torch.float32, device="cuda")
    long["[60,25000000]"] = dict(
        ms=cuda_ms(lambda: ops.fused_topk_grouped(x, frac), 3),
        library_ms=cuda_ms(lambda: torch.topk(x.abs(), k, dim=1), 3),
        bound_ms=1e3 * (8 * x.numel() + 252) / HBM_BYTES_PER_S,
        instance=ops.topk_plan(60, LONG_L, _sms("cuda"))[0])
    del x
    torch.cuda.empty_cache()
    for shape, r in long.items():
        log(f"timing fused_topk {shape} (FedNL's rows at gisette width, "
            f"{r['instance']} instance): {r['ms']!r} ms "
            + (f"(the grouped entry at G = 1 {r['grouped_ms']!r} ms) "
               if "grouped_ms" in r else "")
            + f"(torch.topk {r['library_ms']!r} ms, bound {r['bound_ms']!r} "
            f"ms by bytes)")
    A = torch.randn((5000, 5000), generator=g, device="cuda")
    A = A @ A.mT / 5000 + torch.eye(5000, device="cuda")
    eigh_ms = cuda_ms(lambda: torch.linalg.eigh(A), 3, backlog=False)
    log(f"timing torch.linalg.eigh 5000 x 5000 (FedNL's direction, once a "
        f"round and point): {eigh_ms!r} ms")
    del A
    torch.cuda.empty_cache()
    out["fused_topk_long"] = long
    out["eigh_ms"] = eigh_ms
    return out


def fednl_round_ms(api, experiments, make_problem, reps=3) -> list:
    """FedNL's round at gisette width (``baselines_plan``'s FedNL run): ms
    a round as phase 4b takes it, a 10-round run less a 1-round run by the
    host clock around runs that end in a synchronize, ``reps`` times after
    a warm-up.  For ``kernel_timing.py fednl``, to compare checkouts."""
    import dataclasses
    import torch
    prob = make_problem(**GISETTE_PROBLEM, device="cuda")
    plan = experiments.baselines_plan(prob, iters=10)
    run = next(r for r in plan.runs if r.label == "FedNL")

    def seconds(iters):
        res = api.run_plan(dataclasses.replace(plan, runs=(
            dataclasses.replace(run, iters=iters),)))
        torch.cuda.synchronize()
        return res.seconds

    seconds(1)
    out = []
    for _ in range(reps):
        t1 = seconds(1)
        out.append(1e3 * (seconds(10) - t1) / 9)
    log(f"timing FedNL gisette round: {out} ms")
    return out


def grouped_timing(dev, ops, ref, random, library):
    """The grouped entries at the plans' shapes (three points of 20 rows:
    ``budget_fair_plan``'s runs at quickstart size), by CUDA events beside
    their plain versions, G = 3 launches of the scalar entries, the library
    call (top-k) and the bound (the grouped keyed dither's from the SASS of
    its main loop, as the scalar one's)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(4)
    G, n = 3, 20
    keys = random.split(random.key(12, dev), G)
    s = torch.tensor([64.0] * G, device=dev)
    frac = torch.tensor([0.25] * G, device=dev)
    clocks, pipe, per, elems = loop_clocks_per_element(
        library, "grouped_dither_keyed_kernel")
    log(f"grouped_dither_keyed_kernel main loop, {elems} elements a trip, "
        f"thread-instructions an element by pipe (SASS): "
        + ", ".join(f"{k} {v!r}" for k, v in per.items())
        + f"; bound {clocks!r} SM clocks an element on the {pipe} pipe")
    res = {}
    L = 123
    x = torch.randn((G * n, L), generator=g).to(dev)
    res["fused_dither_keyed_grouped"] = dict(
        shape=[G * n, L],
        ms=cuda_ms(lambda: ops.fused_dither_keyed_grouped(x, keys, s), 200),
        scalar_ms=cuda_ms(lambda: [ops.fused_dither_keyed(
            x[i * n:(i + 1) * n], keys[i], 64.0) for i in range(G)], 200),
        plain_ms=cuda_ms(lambda: ref.fused_dither_keyed_grouped_ref(
            x, keys, s), 20),
        library_ms=None, bytes=8 * G * n * L + 4 * G * n + 20 * G,
        ops=clocks * G * n * L, rate=SM_CLOCKS_PER_S)
    L = 123 * 123                          # FedNL's d² rows at d = 123
    x = torch.randn((G * n, L), generator=g).to(dev)
    k = ref.topk_keep_count(0.25, L)
    res["fused_topk_grouped"] = dict(
        shape=[G * n, L],
        ms=cuda_ms(lambda: ops.fused_topk_grouped(x, frac), 200),
        scalar_ms=cuda_ms(lambda: [ops.fused_topk(
            x[i * n:(i + 1) * n], 0.25) for i in range(G)], 200),
        plain_ms=cuda_ms(lambda: ref.fused_topk_grouped_ref(x, frac), 10),
        library_ms=cuda_ms(lambda: torch.topk(x.abs(), k, dim=1), 100),
        bytes=8 * G * n * L + 4 * G * n + 4 * G, ops=34 * G * n * L,
        rate=F32_OPS_PER_S)
    for name, fn, scal, plain, p, v in (
            ("dither_bits_grouped", ops.dither_bits_grouped, ops.dither_bits,
             ref.dither_bits_grouped_ref, s, 64.0),
            ("topk_bits_grouped", ops.topk_bits_grouped, ops.topk_bits,
             ref.topk_bits_grouped_ref, frac, 0.25)):
        res[name] = dict(
            shape=[G], ms=cuda_ms(lambda: fn(p, 123), 200),
            scalar_ms=cuda_ms(lambda: [scal(v, 123, dev)
                                       for _ in range(G)], 200),
            plain_ms=cuda_ms(lambda: plain(p, 123), 20), library_ms=None,
            bytes=8 * G, ops=12 * G, rate=F32_OPS_PER_S)
    for name, r in res.items():
        t_bytes = 1e3 * r.pop("bytes") / HBM_BYTES_PER_S
        t_ops = 1e3 * r.pop("ops") / r.pop("rate")
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"timing {name} {r['shape']}: {r['ms']!r} ms ({G} launches of "
            f"the scalar entry {r['scalar_ms']!r} ms; plain "
            f"{r['plain_ms']!r} ms, library {r['library_ms']!r} ms, bound "
            f"{r['bound_ms']!r} ms by {r['bound_by']})")
    return res


# ---------------------------------------------------------------------------
# Slice 9: the stochastic setting, exact-k sampling, sketches, families
# ---------------------------------------------------------------------------

def held_by_verdict(label: str, report: dict, envelope: float) -> None:
    """Log one run's ``plan_drift`` report against the CPU (and whether
    final F held rtol 1e-4), and fail on every fault
    ``plan_drift.verdict`` finds in it."""
    from repro_torch import plan_drift
    faults = plan_drift.verdict(report, envelope)
    log(f"phase 3c: {label}, card against CPU: final F rel gap "
        f"{report['final_rel_gap']!r} (rtol 1e-4 "
        f"{'held' if report['final_rel_gap'] <= 1e-4 else 'not held'}), "
        f"max {report['max_rel_gap']!r}; the CPU's ulp envelope "
        f"{envelope!r}; card messages not the plain compressor's "
        f"{report['unfaithful_a']}; first differing message "
        f"{report.get('first_difference')}; faults {faults}")
    check(not faults, f"{label}: {faults}")


def phase_key_streams(random, driver):
    """Phase 3c (a): randint, permutation, choice and the choice masks on
    the card, bit for bit those of the port on the CPU."""
    import torch
    cases = {
        "randint [1, 20] x 32 of 300": lambda k: random.randint(
            driver.worker_keys(k.unsqueeze(0), 20), (32,), 0, 300),
        "randint [7, 5000] of 2**31 - 1": lambda k: random.randint(
            k, (7, 5000), 0, 2**31 - 1),
        "permutation 20": lambda k: random.permutation(k, 20),
        "permutation 1626": lambda k: random.permutation(k, 1626),
        "permutation 5000": lambda k: random.permutation(k, 5000),
        "choice 5000 (4,)": lambda k: random.choice(k, 5000, (4,),
                                                    replace=False),
        "choice masks [50, 20] p 0.5": lambda k: driver.participation_mask(
            random.split(k, 50), 20, 0.5, "choice"),
    }
    for seed in (0, 1, 12345):
        for name, fn in cases.items():
            a = fn(random.key(seed, "cuda")).cpu()
            b = fn(random.key(seed, "cpu"))
            check(torch.equal(a, b), f"key streams: {name} (seed {seed}) "
                  "differs between the card and the CPU")
    log(f"phase 3c: {len(cases)} key streams x 3 seeds bit-identical, card "
        f"against CPU: {list(cases)}")


def phase_stochastic_quickstart(quickstart, random, driver, ops, counts):
    """Phase 3c (b): stochastic FLECS-CGD at quickstart size (batch 32,
    exact-k p = 0.5, alpha 0.2), 50 rounds on the card against the port on
    the CPU, every compressor call recorded: ledgers exact, 10 workers
    every round, every round's masks and minibatch rows equal, the same
    compressor launches a round as the full-batch round; then the round ms
    of both, timed in this call.  Returns the results, with the drift
    report that :func:`phase_stochastic` holds to the CPU's ulp envelope,
    and the CPU run's F."""
    import numpy as np
    import torch
    from repro_torch import plan_drift
    from repro_torch.core.driver import run_experiment
    iters = STOCHASTIC_ITERS
    kw = dict(QUICK, **quickstart.STOCHASTIC)
    card = plan_drift.stochastic_setup("cuda")
    host = plan_drift.stochastic_setup("cpu")
    torch.cuda.synchronize()
    ops.reset_launches()
    rec = plan_drift.record_run(plan_drift.rounds(card, iters))
    torch.cuda.synchronize()
    launched = dict(ops.launches)
    for k, v in launched.items():
        counts[k] += v
    expect = main_path_expect(2 * iters, 0)
    for name, n in expect.items():
        check(launched[name] == n, f"stochastic quickstart: {name} launched "
              f"{launched[name]} times, expected {n} (the full-batch "
              "round's)")
    crec = plan_drift.record_run(plan_drift.rounds(host, iters))
    gpu, cpu = rec[1], crec[1]
    check(np.array_equal(gpu["bits_per_node"].cpu().numpy(),
                         cpu["bits_per_node"].numpy()),
          "stochastic quickstart: card and CPU ledgers differ")
    active = gpu["n_active"].cpu().numpy()
    check((active == 10).all(), f"stochastic quickstart: n_active {active}")

    def draws(pieces):
        """Every round's gradient and HVP minibatch rows and mask."""
        p, k = pieces[0], pieces[3]
        k_g, k_h, _, _, k_p = random.split(random.split(k, iters),
                                           5).unbind(dim=-2)
        return [p.minibatch(driver.worker_keys(kk, 20), kw["batch"])[0].cpu()
                for kk in (k_g, k_h)] + [driver.participation_mask(
                    k_p, 20, kw["participation"], "choice").cpu()]

    check(all(torch.equal(a, b) for a, b in zip(draws(card), draws(host))),
          "stochastic quickstart: minibatch rows or masks differ")
    F = gpu["F"].cpu().numpy().astype(np.float64)
    check(np.isfinite(F).all(), "stochastic quickstart: F not finite")
    log(f"phase 3c: stochastic quickstart x{iters} (batch 32, choice p 0.5, "
        f"alpha 0.2): ledgers and the masks and rows of every round equal; "
        f"final bits {gpu['bits_per_node'][-1].tolist()}; F card "
        f"{float(F[-1])!r} cpu {float(cpu['F'][-1])!r}; launches {launched}")
    drift = plan_drift.compare_recorded_runs(rec, crec)
    ms = {}
    for label, setup_kw in (("stochastic", kw), ("full batch", QUICK)):
        _, step, state, k = quickstart.setup(device="cuda", **setup_kw)
        run_experiment(step, state, k, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_experiment(step, state, k, iters)
        torch.cuda.synchronize()
        ms[label] = 1e3 * (time.perf_counter() - t0) / iters
    log(f"phase 3c: quickstart round, host clock around {iters} rounds: "
        f"stochastic {ms['stochastic']!r} ms, full batch "
        f"{ms['full batch']!r} ms")
    return dict(F_final=float(F[-1]), rel_final=drift["final_rel_gap"],
                rel_max=drift["max_rel_gap"], launches=launched,
                round_ms=ms, drift=drift), cpu["F"]


#: One grouped launch a family a round: the gradient's dither and top-k
#: points, the count sketch's heavy hitters (fused_topk_grouped), the
#: Hessian's dither64 over all four points; the ledgers of the dither
#: points and of the top-k and min-max points (one formula).
FAMILIES_PER_ROUND = {"fused_dither_keyed_grouped": 2,
                      "fused_topk_grouped": 2, "dither_bits_grouped": 2,
                      "topk_bits_grouped": 2}


def phase_families_plan(api, experiments, make_problem, ops, counts):
    """Phase 3c (c): ``sketch_families_plan`` at quickstart size on the
    card against the CPU, every compressor call recorded: round_bits and
    omega exact, ledgers exact, one grouped launch a kernel family a
    round.  Returns the results, with each family's drift report that
    :func:`phase_stochastic` holds to the CPU's ulp envelope, and the CPU
    run's F."""
    import numpy as np
    import torch
    from repro_torch import plan_drift
    iters = FAMILIES_ITERS

    def plan(prob):
        return experiments.sketch_families_plan(prob, iters)

    gpu = make_problem(**PLAN_PROBLEM, device="cuda")
    cpu = make_problem(**PLAN_PROBLEM, device="cpu")
    torch.cuda.synchronize()
    ops.reset_launches()
    rec = plan_drift.run_recorded(plan(gpu))
    torch.cuda.synchronize()
    launched = dict(ops.launches)
    for k, v in launched.items():
        counts[k] += v
    for name, per in FAMILIES_PER_ROUND.items():
        check(launched[name] == per * iters, f"sketch_families: {name} "
              f"launched {launched[name]} times, expected {per * iters}")
    crec = plan_drift.run_recorded(plan(cpu))
    res, want = rec[0], crec[0]
    rows = experiments.sketch_families_rows(res, gpu.d)
    wrows = experiments.sketch_families_rows(want, cpu.d)
    check([(r["round_bits"], r["omega"], r["Mbits_mean"]) for r in rows]
          == [(r["round_bits"], r["omega"], r["Mbits_mean"]) for r in wrows],
          "sketch_families: round_bits, omega or Mbits_mean differ")
    (_, tr), (_, wtr) = res["families"], want["families"]
    check(np.array_equal(tr["bits_per_node"].cpu().numpy(),
                         wtr["bits_per_node"].numpy()),
          "sketch_families: ledgers differ")
    F = tr["F"].cpu().numpy().astype(np.float64)
    check(np.isfinite(F).all(), "sketch_families: F not finite")
    log(f"phase 3c: sketch_families_plan x{iters} at quickstart size: "
        f"rows {rows}; launches {launched}")
    drift = plan_drift.compare_recorded(rec, crec)["families"]
    return dict(rows=rows, rel_final=[r["final_rel_gap"] for r in drift],
                rel_max=[r["max_rel_gap"] for r in drift], launches=launched,
                drift=drift), wtr["F"]


def _profile_ms(run) -> tuple:
    """(device kernels and copies, device busy ms) of one call of ``run``
    under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    return sum(c for _, c, _ in rows), sum(t for t, _, _ in rows) / 1e3


def _cell(label, run_n, ops, counts, phase="3c") -> dict:
    """One gisette cell: ms a round (10-round less 1-round run, host clock
    around runs that end in a synchronize, after a 1-round warm-up),
    kernels and busy ms a round (3-round less 1-round profiles), the
    10-round run's compressor launches and peak memory."""
    import torch
    start = time.perf_counter()
    run_n(1)
    torch.cuda.synchronize()
    t = {}
    for n in (1, 10):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        run_n(n)
        torch.cuda.synchronize()
        t[n] = time.perf_counter() - t0
    launched = dict(ops.launches)
    for k, v in launched.items():
        counts[k] += v
    peak = torch.cuda.max_memory_allocated()
    (k1, b1), (k3, b3) = (_profile_ms(lambda: run_n(n)) for n in (1, 3))
    r = dict(round_ms=1e3 * (t[10] - t[1]) / 9,
             kernels_per_round=(k3 - k1) / 2, busy_ms_per_round=(b3 - b1) / 2,
             launches={k: v for k, v in launched.items() if v},
             peak_gib=peak / 2**30)
    log(f"phase {phase}: gisette {label} x10: {r['round_ms']!r} ms a round, "
        f"{r['kernels_per_round']:g} device kernels and copies a round, "
        f"device busy {r['busy_ms_per_round']!r} ms a round, peak "
        f"{r['peak_gib']!r} GiB; launches {r['launches']} "
        f"({time.perf_counter() - start:.1f} s)")
    return r


def phase_gisette_stochastic(quickstart, api, experiments, make_problem, ops,
                             counts):
    """Phase 3c (d): gisette width (d = 5000, n = 20, r = 300), 10 rounds a
    cell: stochastic FLECS-CGD with the coordinate and with the Gaussian
    sketch (batch 32, m = 4, choice p = 0.5), and ``sketch_families_plan``
    at FlecsConfig(m=2)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.driver import run_experiment
    out = {}
    for sk in ("coordinate", "gaussian"):
        prob, step, state, key = quickstart.setup(
            device="cuda", sketch=sk, **GISETTE, **quickstart.STOCHASTIC)
        out[f"stochastic {sk}"] = _cell(
            f"stochastic FLECS-CGD, {sk} sketch",
            lambda n: run_experiment(step, state, key, n), ops, counts)
        _, tr = run_experiment(step, state, key, 10,
                               record=lambda st: prob.metrics(st.w))
        F = tr["F"].cpu().numpy()
        check(np.isfinite(F).all() and (tr["n_active"] == 10).all().item(),
              f"gisette stochastic {sk}: F not finite or n_active not 10")
        out[f"stochastic {sk}"]["F"] = F.tolist()
        del step, state, tr
        torch.cuda.empty_cache()
    prob = make_problem(**GISETTE_PROBLEM, device="cuda")
    plan = experiments.sketch_families_plan(prob, 10)

    def run_plan(n):
        return api.run_plan(dataclasses.replace(plan, iters=n))

    out["sketch_families"] = _cell("sketch_families_plan (m = 2)", run_plan,
                                   ops, counts)
    res = run_plan(10)
    rows = experiments.sketch_families_rows(res, prob.d)
    check(all(np.isfinite(r["F"]) for r in rows),
          "gisette sketch_families: F not finite")
    log(f"phase 3c: gisette sketch_families rows {rows}")
    out["sketch_families"]["rows"] = rows
    return out


# ---------------------------------------------------------------------------
# Slice 10: the async engine, staleness schedules and traffic
# ---------------------------------------------------------------------------

ASYNC_SIZE = dict(d=123, n_workers=20, r=64)
# rounds, cut from 600, 100 and 100 to make room for phase 11 (and 300 and
# 40 to 200 and 25 for phase 13); the traffic runs that diverge on the CPU
# pass twice their first F by round 29, so 40 rounds keep which runs have
# their F held
ASYNC_ITERS = 200
LEGACY_ITERS = 25
TRAFFIC_ITERS = 40
CUTOFF_ITERS = 30


#: Per-round aux entries an async run's card and CPU runs share exactly
#: (masks, delays and traffic come from key streams both draw alike).
ASYNC_EXACT = ("bits_per_node", "n_active", "n_arrived", "flushed",
               "buffered", "staleness_mean")


#: Worker processes of the CPU side of phases 3c and 3d (the card's
#: machine has 8 cores; one drives the card).
CPU_WORKERS = 7
STOCHASTIC_ITERS = 50
# sketch_families_plan's rounds, cut from 200 for phase 13
FAMILIES_ITERS = 100


def cpu_pool():
    """The worker processes (spawned) that run :func:`cpu_job`."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(CPU_WORKERS, mp_context=multiprocessing
                               .get_context("spawn"))


def envelope_jobs(kind: str, iters: int, problem=None) -> list:
    """The :func:`cpu_job` runs of ``plan_drift.envelope(kind, ...)``
    but problem seed 0's as made (the recorded CPU run's): each other
    problem seed's, then every nudged one."""
    from repro_torch import plan_drift
    seeds = plan_drift.ENVELOPE_SEEDS
    keys = ([(ps, None) for ps in sorted({ps for ps, _ in seeds} - {0})]
            + list(seeds))
    items = tuple(sorted((problem or {}).items()))
    return [("envelope", kind, ps, us, iters, items) for ps, us in keys]


def envelope_from(cpu: dict, kind: str, iters: int, problem, base) -> tuple:
    """``plan_drift.envelope`` of ``kind`` from the finished
    :func:`envelope_jobs` in ``cpu`` and problem seed 0's F ``base``."""
    from repro_torch import plan_drift
    runs = {(0, None): base}
    for job in envelope_jobs(kind, iters, problem):
        runs[job[2:4]] = cpu_result(cpu, job)
    return plan_drift.envelope(kind, iters, problem, runs=runs)


def cpu_job(job: tuple) -> bytes:
    """One CPU run of phases 3b to 3e, in a worker process (one thread
    each): ("grid",) the async grid's recorded run; ("legacy", method,
    kind) a legacy async step's; ("traffic", profile) a traffic plan's;
    ("envelope", kind, ps, us, iters, problem items) the F of one run of
    an ulp envelope (``plan_drift.envelope_F``); phase 3e's and the paper
    figures' runs (:func:`_pop_cpu_run`).  Returns the record (or
    F) as ``torch.save`` bytes: a record holds thousands of tensors, too
    many to pass as shared memory handles."""
    import io
    import torch
    torch.set_num_threads(1)
    buf = io.BytesIO()
    torch.save(_cpu_run(job), buf)
    return buf.getvalue()


def cpu_result(cpu: dict, job: tuple):
    """A finished :func:`cpu_job`'s record, loaded in this process."""
    import io
    import torch
    return torch.load(io.BytesIO(cpu[job].result()), weights_only=False)


def _cpu_run(job: tuple):
    from repro_torch import experiments, plan_drift, random
    from repro_torch.core.driver import run_experiment
    from repro_torch.data.logreg import make_problem
    kind = job[0]
    if kind in ("hier", "cohort", "figure"):
        return _pop_cpu_run(job)
    if kind == "grid":
        return plan_drift.record_run(plan_drift.async_grid_run(
            "cpu", ASYNC_ITERS, **ASYNC_SIZE))
    if kind == "envelope":
        return plan_drift.envelope_F(*job[1:5], dict(job[5]))
    prob = make_problem(**ASYNC_SIZE, mu=1e-3, seed=0, device="cpu")
    if kind == "legacy":
        (step, st0), _ = experiments.legacy_steps(job[1], prob, job[2], 2,
                                                  5)
        return plan_drift.record_run(lambda: run_experiment(
            step, st0, random.key(0, "cpu"), LEGACY_ITERS,
            record=lambda st: prob.metrics(st.w)))
    return plan_drift.run_recorded(experiments.traffic_plan(
        prob, job[1], TRAFFIC_ITERS, 2))


def _exact_aux(label, a, b, keys=ASYNC_EXACT) -> None:
    import numpy as np
    for key in keys:
        check(np.array_equal(a[key].cpu().numpy(), b[key].cpu().numpy()),
              f"{label}: {key} differs between the card and the CPU")


def _bitwise(label, a, b) -> None:
    """Two runs' states or trace dicts equal bit for bit, leaf by leaf."""
    import torch
    from repro_torch.core.driver import map_tree
    bad = []
    map_tree(lambda x, y: None if torch.equal(x.cpu(), y.cpu())
             else bad.append(tuple(x.shape)), a, b)
    check(not bad, f"{label}: leaves of shapes {bad} differ")


#: Why F is logged and not held, for the runs where a cause was shown.
EIGH_PARTS = ("FedNL's eigh parts the card from the CPU by more than 1e-6 "
              "before its first top-k tie flips")
DIVERGES = "the run diverges on the CPU too (F grew past twice its start)"


def held_async(label, report, envelope=0.0, relax=None) -> dict:
    """``plan_drift.verdict`` of one point's card-against-CPU report,
    against the CPU's ulp ``envelope``.  ``relax``, the cause shown for
    a run (``EIGH_PARTS``, ``DIVERGES``), logs F without holding it, nor
    the rule that F agreed within 1e-6 until the first differing message.
    Fails on every other fault."""
    from repro_torch import plan_drift
    faults = plan_drift.verdict(report, envelope)
    if relax:
        faults = [f for f in faults
                  if not f.startswith(("F parted", "F had parted"))]
    how = f"logged, not held: {relax}" if relax else "held"
    log(f"phase 3d: {label}, card against CPU: final F "
        f"{report['F_a']!r} / {report['F_b']!r}, rel gap "
        f"{report['final_rel_gap']!r}, max {report['max_rel_gap']!r}; ulp "
        f"envelope {envelope!r}; F {how}; card messages not their "
        f"replays {report['unfaithful_a']}; first difference "
        f"{report.get('first_difference')}; faults {faults}")
    check(not faults, f"{label}: {faults}")
    return dict(final_rel_gap=report["final_rel_gap"],
                max_rel_gap=report["max_rel_gap"], envelope=envelope,
                F_held=not relax, first_difference=report.get(
                    "first_difference"))


def _recorded(ops, counts, run):
    """``plan_drift.record_run(run)`` on the card with the launch counters
    set to 0 just before and read just after (added to ``counts``):
    (record, seconds)."""
    import torch
    from repro_torch import plan_drift
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    rec = plan_drift.record_run(run)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for k, v in ops.launches.items():
        counts[k] += v
    return rec, seconds


def phase_async_grid(ops, counts, cpu) -> dict:
    """Phase 3d (a): ``experiments.async_grid`` at quickstart size, 600
    rounds, card against CPU (``cpu``: the CPU side's futures), and its
    tau = 0 points against the synchronous sweep on the card."""
    import torch
    from repro_torch import experiments, plan_drift, random
    from repro_torch.core import driver, flecs
    from repro_torch.data.logreg import make_problem
    rec, secs = _recorded(ops, counts, plan_drift.async_grid_run(
        "cuda", ASYNC_ITERS, **ASYNC_SIZE))
    crec = cpu_result(cpu, ("grid",))
    (sts, tr, _), (csts, ctr, _) = rec, crec
    _exact_aux("async_grid", tr, ctr)
    prob = make_problem(**ASYNC_SIZE, mu=1e-3, seed=0, device="cuda")
    cfg, _, ahp, _ = experiments.async_grid_setup(prob)
    rows = experiments.async_grid_rows(ahp, sts, tr)
    log(f"phase 3d: async_grid x{ASYNC_ITERS} (G = 9) on the card in "
        f"{secs!r} s ({1e3 * secs / ASYNC_ITERS!r} ms a round, compressor "
        f"calls and routing recorded, the host shared with the CPU side's "
        f"workers): rows {rows}; CPU rows "
        f"{experiments.async_grid_rows(ahp, csts, ctr)}")
    reports = plan_drift.compare_recorded_grid(rec, crec)
    # the CPU's ulp envelope of every point, a run a worker
    env, gaps = envelope_from(cpu, "async", ASYNC_ITERS, ASYNC_SIZE,
                              ctr["F"])
    parted = [g for g, r in enumerate(reports)
              if r["max_rel_gap"] > plan_drift.STRICT]
    log(f"phase 3d: async_grid points {parted} part past rtol 1e-4; the "
        f"CPU against itself with A moved by one ulp, (problem, ulp) seeds "
        f"{plan_drift.ENVELOPE_SEEDS}: envelopes {env}, gaps {gaps}")
    held = [held_async(f"async_grid point {g} (tau {rows[g]['tau']}, K "
                       f"{rows[g]['K']})", rep, env[g])
            for g, rep in enumerate(reports)]
    # tau = 0 with buffer_k <= the cohort: the synchronous sweep
    cohort = round(experiments.ASYNC_GRID_P * prob.n_workers)
    sync = driver.run_sweep(
        flecs.make_flecs_sweep_step(cfg, *prob.make_oracles()), ahp.hp,
        flecs.init_state(torch.zeros(prob.d, device="cuda"),
                         prob.n_workers),
        random.key(0, "cuda"), ASYNC_ITERS,
        record=lambda st: prob.metrics(st.w))
    points = [g for g, r in enumerate(rows)
              if r["tau"] == 0 and r["K"] <= cohort]
    for g in points:
        _bitwise(f"async_grid tau 0 point {g}", {
            k: getattr(sts, k)[g] for k in ("w", "h", "B", "bits_per_node")},
            {k: getattr(sync[0], k)[g] for k in ("w", "h", "B",
                                                 "bits_per_node")})
        _bitwise(f"async_grid tau 0 point {g} traces",
                 {k: tr[k][g] for k in sync[1]},
                 {k: v[g] for k, v in sync[1].items()})
    log(f"phase 3d: async_grid points {points} (tau 0, buffer_k <= "
        f"{cohort}) equal the synchronous sweep on the card bit for bit "
        f"over {ASYNC_ITERS} rounds: state, ledgers, F and every shared "
        f"trace")
    return dict(rows=rows, seconds=secs, held=held, tau0_points=points)


def phase_async_legacy(ops, counts, cpu) -> dict:
    """Phase 3d (b): each method's legacy async step at tau = 0, buffer_k
    the cohort, against its synchronous step on the card (bit for bit);
    then under each schedule at tau 2, buffer_k 5, card against CPU
    (``cpu``: the CPU side's futures)."""
    import numpy as np
    import torch
    from repro_torch import experiments, plan_drift, random
    from repro_torch.core.driver import run_experiment
    from repro_torch.data.logreg import make_problem
    gpu = make_problem(**ASYNC_SIZE, mu=1e-3, seed=0, device="cuda")
    cohort = gpu.n_workers // 2
    methods = experiments.LEGACY_METHODS
    for method in methods:
        (astep, a0), (sstep, s0) = experiments.legacy_steps(
            method, gpu, "fixed", 0, cohort)
        rec = lambda st: gpu.metrics(st.w)                 # noqa: E731
        sa, ta = run_experiment(astep, a0, random.key(1, "cuda"), 50,
                                record=rec)
        ss, ts = run_experiment(sstep, s0, random.key(1, "cuda"), 50,
                                record=rec)
        # the sync state's tensors (its edge_bits is None: no hierarchy)
        names = [f for f, v in zip(ss._fields, ss)
                 if isinstance(v, torch.Tensor) and f != "k"]
        _bitwise(f"{method} tau 0 state", {f: getattr(ss, f) for f in names},
                 {f: getattr(sa, f) for f in names})
        _bitwise(f"{method} tau 0 traces", ts, {k: ta[k] for k in ts})
    log(f"phase 3d: legacy async steps at tau 0, buffer_k {cohort} (the "
        f"cohort), 50 rounds: {list(methods)} equal their "
        f"synchronous steps on the card bit for bit (state, ledgers, aux)")
    out = {}
    for method in methods:
        for kind in ("fixed", "uniform", "geometric"):
            label = f"{method} {kind} tau 2"
            (step, st0), _ = experiments.legacy_steps(method, gpu, kind, 2,
                                                      5)
            rec, secs = _recorded(ops, counts, lambda: run_experiment(
                step, st0, random.key(0, "cuda"), LEGACY_ITERS,
                record=lambda st: gpu.metrics(st.w)))
            crec = cpu_result(cpu, ("legacy", method, kind))
            rep = plan_drift.compare_recorded_runs(rec, crec)
            diff = rep.get("first_difference")
            routed = diff is not None and diff.get("kind") is not None
            if routed:
                log(f"phase 3d: {label}: routing parts at {diff}")
                check(diff["explained"], f"{label}: unexplained routing "
                      f"difference {diff}")
            else:
                _exact_aux(label, rec[1], crec[1])
            F = rec[1]["F"].cpu().numpy()
            check(np.isfinite(F).all(), f"{label}: F not finite")
            held = held_async(label, rep, relax=EIGH_PARTS
                              if method == "FedNL" else None)
            out[label] = dict(held, seconds=secs, F=float(F[-1]),
                              arrived=float(rec[1]["n_arrived"].sum()),
                              flushes=float(rec[1]["flushed"].sum()))
    return out


def phase_traffic(ops, counts, cpu) -> dict:
    """Phase 3d (c): the five-method traffic plan at traffic_bench's
    settings, 100 rounds a profile, card against CPU (``cpu``: the CPU
    side's futures; routing, availability and admitted arrivals of every
    round, ledgers); the cutoff-0 contracts on the card, 30 rounds."""
    import dataclasses
    import torch
    from repro_torch import experiments, plan_drift
    from repro_torch.core import api
    from repro_torch.core.traffic import AdmissionPolicy, TrafficModel
    from repro_torch.data.logreg import make_problem
    gpu = make_problem(**ASYNC_SIZE, mu=1e-3, seed=0, device="cuda")
    out = {}
    for profile in experiments.TRAFFIC_PROFILES:
        torch.cuda.synchronize()
        ops.reset_launches()
        rec = plan_drift.run_recorded(experiments.traffic_plan(
            gpu, profile, TRAFFIC_ITERS, 2))
        torch.cuda.synchronize()
        for k, v in ops.launches.items():
            counts[k] += v
        crec = cpu_result(cpu, ("traffic", profile))
        routes, croutes = rec[1].routes, crec[1].routes
        check(len(routes) == len(croutes) == 5 * TRAFFIC_ITERS,
              f"traffic {profile}: {len(routes)} / {len(croutes)} rounds")
        for a, b in zip(routes, croutes):
            for key in ("avail", "send", "delays", "drained", "arrived"):
                if a[key] is not None:
                    check(torch.equal(a[key], b[key]),
                          f"traffic {profile} {a['label']} round "
                          f"{a['round']}: {key} differs from the CPU's")
        reports = plan_drift.compare_recorded(rec, crec)
        rows = experiments.traffic_rows(profile, rec[0])
        out[profile] = dict(rows=rows, seconds=rec[0].seconds, held={})
        for lab in rec[0].labels:
            _exact_aux(f"traffic {profile} {lab}", rec[0].traces[lab],
                       crec[0].traces[lab])
            Fc = crec[0].traces[lab]["F"][0]
            relax = (EIGH_PARTS if lab == "fednl" else DIVERGES
                     if float(Fc.max()) > 2 * float(Fc[0]) else None)
            out[profile]["held"][lab] = held_async(
                f"traffic {profile} {lab}", reports[lab][0], relax=relax)
        log(f"phase 3d: traffic plan {profile} x{TRAFFIC_ITERS} on the "
            f"card in {rec[0].seconds!r} s: routing, availability states "
            f"and admitted arrivals of every round and the ledgers equal the "
            f"CPU's; rows {rows}")
    zero = TrafficModel(admission=AdmissionPolicy(staleness_cutoff=0.0))
    n = gpu.n_workers
    sync = api.run_plan(dataclasses.replace(
        experiments.traffic_plan(gpu, "fixed", CUTOFF_ITERS, 0),
        staleness=None))
    at0 = api.run_plan(dataclasses.replace(
        experiments.traffic_plan(gpu, "fixed", CUTOFF_ITERS, 0, zero),
        buffer_k=float(n)))
    for lab in sync.labels:
        _bitwise(f"cutoff 0 at tau 0, {lab}", sync.traces[lab],
                 {k: at0.traces[lab][k] for k in sync.traces[lab]})
        check(torch.equal(sync.states[lab].w, at0.states[lab].w),
              f"cutoff 0 at tau 0, {lab}: w differs from the sync run's")
    at2 = api.run_plan(experiments.traffic_plan(gpu, "fixed", CUTOFF_ITERS,
                                                2, zero))
    for lab in at2.labels:
        trc = at2.traces[lab]
        check(float(trc["n_active"].sum()) > 0
              and not trc["bits_per_node"].any()
              and not trc["n_arrived"].any()
              and not at2.states[lab].w.any(),
              f"cutoff 0 at tau 2, {lab}: something was billed or moved")
    log(f"phase 3d: cutoff 0: at tau 0 (buffer_k {n}) the five methods are "
        f"their synchronous plan on the card bit for bit; at tau 2 they "
        f"send but w and every ledger stay at zero")
    return out


def route_split(prof) -> dict:
    """Inside a profile's ``route_round`` spans (``record_function``):
    their host µs, the µs of that in copy and synchronize calls (the host
    read of the per-point flags, which waits for the card to drain its
    queue), and the device events launched from inside them (count, µs)."""
    events = trace_events(prof)
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") == "route_round"]

    def inside(ts):
        return ts is not None and any(a <= ts <= b for a, b in spans)

    read = [e for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and ("Memcpy" in e.get("name", "")
                 or "Synchronize" in e.get("name", "")) and inside(e["ts"])]
    mine = [e for e, ts in device_launches(events) if inside(ts)]
    return dict(host_us=sum(b - a for a, b in spans),
                read_us=sum(e["dur"] for e in read),
                kernels=len(mine), busy_us=sum(e["dur"] for e in mine))


def route_cost(run_n) -> dict:
    """The routing half of a gisette async round of DIANA or GD
    (``traffic.route_round``, whose host read of the per-point flags is
    the round's one wait on the card): host ms a round inside it (host
    clock around each call, 10-round less 1-round runs, over 9); and from
    3-round less 1-round profiles with each call traced: its host ms a
    round, the ms of that in the read's copy and synchronize calls, and
    the kernels it launches a round with their device busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.optim import baselines
    inner, spent = baselines.route_round, [0.0]

    def timed(*args):
        t0 = time.perf_counter()
        try:
            return inner(*args)
        finally:
            spent[0] += time.perf_counter() - t0

    def traced(*args):
        with record_function("route_round"):
            return inner(*args)

    host, split = {}, {}
    try:
        baselines.route_round = timed
        for n in (1, 10):
            spent[0] = 0.0
            run_n(n)
            torch.cuda.synchronize()
            host[n] = spent[0]
        baselines.route_round = traced
        for n in (1, 3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run_n(n)
                torch.cuda.synchronize()
            split[n] = route_split(prof)
    finally:
        baselines.route_round = inner

    def per_round(key):
        return (split[3][key] - split[1][key]) / 2

    return dict(host_ms=1e3 * (host[10] - host[1]) / 9,
                traced_host_ms=per_round("host_us") / 1e3,
                read_ms=per_round("read_us") / 1e3,
                kernels=per_round("kernels"),
                kernel_busy_ms=per_round("busy_us") / 1e3)


def phase_async_gisette(ops, counts) -> dict:
    """Gisette width, 10 rounds a run: async FLECS-CGD over taus {0, 2, 4}
    × buffer_k 5 (G = 3), and each method of the diurnal traffic plan at
    tau 2 (FedNL's linalg_eigh apart).  Phase 3d (d) until it was cut to
    make room for phase 12; call it from a script of its own (with the
    host quiet: its rounds are host-bound)."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import experiments, random
    from repro_torch.core import api
    from repro_torch.core.driver import run_async_sweep
    from repro_torch.core.flecs import hparams_round_bits
    from repro_torch.data.logreg import make_problem
    prob = make_problem(**GISETTE_PROBLEM, device="cuda")
    out = {}
    cfg, sweep, ahp, st0 = experiments.async_grid_setup(prob, ks=(5.0,))
    timed = {}

    def grid(n):
        res = run_async_sweep(sweep, ahp, st0, random.key(0, "cuda"), n)
        if n == 10:
            timed[n] = res
        return res

    r = _cell("async FLECS-CGD taus {0, 2, 4} x K 5 (G = 3)", grid, ops,
              counts, phase="3d")
    sts, _ = timed.pop(10)            # the timed 10-round run's result
    r["bits_per_round"] = hparams_round_bits(cfg, ahp.hp, prob.d).tolist()
    r["mean_bits_per_node_round"] = (sts.bits_per_node.mean(dim=1) / 10
                                     ).tolist()
    r["w_finite"] = bool(torch.isfinite(sts.w).all())
    check(r["w_finite"], "gisette async grid: w not finite")
    out["async_grid"] = r
    del sts
    torch.cuda.empty_cache()
    plan = experiments.traffic_plan(prob, "diurnal", 10, 2)
    for run in plan.runs:
        label = run.label or run.method
        timed = {}

        def run_n(n, run=run, timed=timed):
            res = api.run_plan(dataclasses.replace(plan, iters=n,
                                                   runs=(run,)))
            if n == 10:
                timed[n] = res
            return res

        r = _cell(f"diurnal traffic {label} tau 2", run_n, ops, counts,
                  phase="3d")
        res = timed.pop(10)           # the timed 10-round run's result
        if run.method in ("diana", "gd"):
            r["route"] = route_cost(run_n)
            log(f"phase 3d: gisette diurnal traffic {label}: routing "
                f"{r['route']}")
        if run.method == "fednl":
            # its eigh's share, by the CPU op that launched each kernel
            split = {}
            for n in (1, 3):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    run_n(n)
                    torch.cuda.synchronize()
                split[n] = device_split(prof, "aten::linalg_eigh")
            r["eigh_kernels_per_round"] = (split[3]["op"][0]
                                           - split[1]["op"][0]) / 2
            r["eigh_busy_ms_per_round"] = (split[3]["op"][1]
                                           - split[1]["op"][1]) / 2e3
            log(f"phase 3d: gisette diurnal traffic {label}: "
                f"{r['eigh_kernels_per_round']:g} kernels and "
                f"{r['eigh_busy_ms_per_round']!r} busy ms a round in "
                f"linalg_eigh")
        st, trc = res[label]
        spec = api.get_method(run.method)
        r["bits_per_round"] = float(np.asarray(spec.round_bits(
            prob, run.cfg or spec.default_config(),
            res.hparams[label].hp))[0])
        r["mean_bits_per_node_round"] = float(st.bits_per_node.mean()) / 10
        r["F"] = trc["F"][0].tolist()
        r["arrived"] = float(trc["n_arrived"].sum())
        log(f"phase 3d: gisette diurnal traffic {label}: price "
            f"{r['bits_per_round']!r} bits a message, "
            f"{r['mean_bits_per_node_round']!r} bits a node a round billed; "
            f"{r['arrived']:g} arrivals; F {r['F']}")
        out[f"traffic {label}"] = r
        del res, st, trc
        torch.cuda.empty_cache()
    return out


def phase_async(ops, counts) -> dict:
    """Phase 3d: the async engine and its traffic model.  The CPU side of
    every card-against-CPU comparison runs in worker processes while the
    card runs its own side (whose times are logged, not measured: the
    host is shared).  The gisette cells (``phase_async_gisette``, ~50-106
    s) were cut from the script to make room for phase 12; a script of
    its own still runs them."""
    from repro_torch import experiments
    # the longest runs first; the card's side takes the shortest first
    jobs = ([("grid",)] + envelope_jobs("async", ASYNC_ITERS, ASYNC_SIZE)
            + [("traffic", p) for p in experiments.TRAFFIC_PROFILES]
            + [("legacy", m, k) for m in experiments.LEGACY_METHODS
               for k in ("fixed", "uniform", "geometric")])
    out, seconds = {}, {}
    with cpu_pool() as pool:
        cpu = {job: pool.submit(cpu_job, job) for job in jobs}
        for name, fn in (("legacy", phase_async_legacy),
                         ("traffic", phase_traffic),
                         ("grid", phase_async_grid)):
            t0 = time.perf_counter()
            out[name] = fn(ops, counts, cpu)
            seconds[name] = time.perf_counter() - t0
        for f in cpu.values():
            f.result()
    out["seconds"] = seconds
    log(f"phase 3d: seconds by part {seconds}")
    return out


def ulps_apart(a, b) -> tuple:
    """(elements of two float32 tensors whose bits differ, the largest
    distance among them in ulps)."""
    import torch
    d = (a.cpu().view(torch.int32).long()
         - b.cpu().view(torch.int32).long()).abs()
    return int((d > 0).sum()), int(d.max()) if d.numel() else 0


def phase_family_contracts(dev, compressors, random):
    """Phase 3c: the three plain-PyTorch families on the card against the
    CPU, on the same rows and keys: natural bit for bit (also on powers of
    two and one ulp either side, where ``log2`` could round apart), its
    decode of one table bit for bit; the count sketch's table (a float64
    scatter-add on atomics, rounded once) and min-max's ℓ1 norm (a float64
    sum) bit for bit, or else one ulp apart: a float64 sum of float32
    terms is not always exact, so two orders can round to neighbouring
    float32 values next to a midpoint (a double rounding, logged as such);
    min-max's messages bit for bit in every row whose ℓ1 norm agrees."""
    import numpy as np
    import torch
    g = np.random.default_rng(0)
    x = torch.as_tensor((g.normal(size=(20, 5000))).astype(np.float32))
    p = np.float32(2.0) ** np.arange(-30, 31, dtype=np.float32)
    edge = np.concatenate([p, np.nextafter(p, np.float32(0)),
                           np.nextafter(p, np.float32(np.inf))])
    edge = torch.as_tensor(np.tile(np.concatenate([edge, -edge]), (20, 1)))
    keys = random.split(random.key(5, "cpu"), 20)
    exact, sums = {}, {}

    def differing(fn, rows):
        return int((fn(rows.to(dev), keys.to(dev)).cpu() != fn(rows, keys))
                   .sum())

    nat = compressors.make_spec("natural")
    for name, rows in (("normal", x), ("powers of two +-1 ulp", edge)):
        exact[f"natural differing, {name}"] = differing(
            lambda r, k: compressors.compress(nat, k, r), rows)
    width = torch.full((20,), 64.0)
    tab = [compressors.count_sketch_encode(keys.to(dev), x.to(dev),
                                           width.to(dev)).cpu()
           for _ in range(2)]
    tab_cpu = compressors.count_sketch_encode(keys, x, width)
    sums["count_sketch table"] = ulps_apart(tab[0], tab_cpu)
    sums["count_sketch two card runs"] = ulps_apart(tab[0], tab[1])
    depth, hh = torch.full((20,), 3.0), torch.full((1,), 0.25)
    dec = compressors.count_sketch_decode(
        keys.to(dev), tab_cpu.to(dev), width.to(dev), depth.to(dev),
        hh.to(dev)).cpu()
    exact["count_sketch decode differing"] = int(
        (dec != compressors.count_sketch_decode(keys, tab_cpu, width, depth,
                                                hh)).sum())
    l1 = compressors._l1(x.to(dev).abs()).cpu()
    l1_cpu = compressors._l1(x.abs())
    sums["minmax l1"] = ulps_apart(l1, l1_cpu)
    same_l1 = (l1 == l1_cpu)[:, 0]
    mm = compressors.make_spec("minmax0.5")
    got = compressors.compress(mm, keys.to(dev), x.to(dev)).cpu()
    exact["minmax differing, rows whose l1 agrees"] = int(
        (got != compressors.compress(mm, keys, x))[same_l1].sum())
    log(f"phase 3c: the families on the card against the CPU at [20, 5000] "
        f"(natural also on +-2^-30..2^30 and one ulp either side), elements "
        f"differing: {exact}; the float64 sums (elements differing, largest "
        f"ulps): {sums}")
    for name, n in exact.items():
        check(n == 0, f"families on the card: {name} {n}")
    for name, (n, ulps) in sums.items():
        check(ulps <= 1, f"families on the card: {name}: {n} elements up "
              f"to {ulps} ulps apart")
        if n:
            log(f"phase 3c: {name}: {n} elements one ulp apart, a double "
                "rounding of the float64 sum (not a port fault)")
    return dict(exact, **{f"{k} (elements, ulps)": v
                          for k, v in sums.items()})


def phase_stochastic(dev, quickstart, random, driver, compressors, api,
                     experiments, make_problem, ops, counts):
    """Phase 3c: the stochastic setting (key streams, the stochastic
    quickstart, the families plan, the three families' contracts, gisette
    width)."""
    from repro_torch import plan_drift
    out = {}
    phase_key_streams(random, driver)
    out["families_on_card"] = phase_family_contracts(dev, compressors,
                                                     random)
    q, q_F = phase_stochastic_quickstart(quickstart, random, driver, ops,
                                         counts)
    fam, fam_F = phase_families_plan(api, experiments, make_problem, ops,
                                     counts)
    # the CPU's ulp envelopes, their runs in worker processes after the
    # timed quickstart rounds and before the gisette cells
    problem = {k: v for k, v in PLAN_PROBLEM.items() if k != "seed"}
    kinds = (("stochastic", STOCHASTIC_ITERS, None, q_F),
             ("sketch_families_plan", FAMILIES_ITERS, problem, fam_F))
    with cpu_pool() as pool:
        cpu = {job: pool.submit(cpu_job, job) for kind, iters, prob, _ in
               kinds for job in envelope_jobs(kind, iters, prob)}
        (q_env, q_gaps), (f_env, f_gaps) = (
            envelope_from(cpu, *k) for k in kinds)
    log(f"phase 3c: the CPU against itself with A moved by one ulp, "
        f"(problem, ulp) seeds {plan_drift.ENVELOPE_SEEDS}: max rel gaps of "
        f"F, stochastic quickstart {q_gaps}, sketch_families {f_gaps}")
    held_by_verdict("stochastic quickstart", q["drift"], q_env[0])
    for rep, e, name in zip(fam["drift"], f_env,
                            experiments.SKETCH_FAMILY_NAMES):
        held_by_verdict(f"sketch_families {name}", rep, e)
    q.update(ulp_envelope=q_env[0], ulp_gaps=q_gaps)
    fam.update(ulp_envelope=f_env)
    out["quickstart"], out["sketch_families"] = q, fam
    out["gisette"] = phase_gisette_stochastic(quickstart, api, experiments,
                                              make_problem, ops, counts)
    return out


# ---------------------------------------------------------------------------
# Slice 11: hierarchy, cohort and sharding
# ---------------------------------------------------------------------------

#: Phase 3e's sizes: the quickstart's federation, the edge tier of four
#: aggregators, the cohort of 64 clients of a virtual population of shards
#: of 16 rows; the hierarchy's and the sharded engine's rounds (cut from
#: 100 and 50 for phase 13).
POP_SIZE = dict(d=123, n_workers=20, r=64)
HIER_ITERS = 50
HIER_EDGES = ("identity", "dither64", "count_sketch64")
HIER_E = 4
COHORT_K = 64
COHORT_R = 16
COHORT_NS = (1024, 102_400, 1_048_576)
COHORT_ITERS = 10
SHARDED_ITERS = 25
#: Rounds of each of phase 3b's paper figures (the reference's 200-300,
#: cut so the CPU side fits the time limit; 30 until phase 13).
FIGURE_ITERS = 20


def hierarchy_setup(dev, d=123, n_workers=20, r=64, seed=0):
    """Hierarchical FLECS-CGD (m = 4, dither64, E = 4) over a [3] grid of
    edge specs (identity, dither64, count_sketch64), and the flat server on
    the same grid: (problem, step, hparams, state, flat step, flat
    hparams, flat state)."""
    import torch
    from repro_torch.core import compressors, driver, flecs
    from repro_torch.core.hierarchy import HierarchyConfig
    from repro_torch.data.logreg import make_problem
    prob = make_problem(d=d, n_workers=n_workers, r=r, mu=1e-3, seed=seed,
                        device=dev)
    lg, lh = prob.make_oracles()
    flat = flecs.FlecsConfig(m=4, grad_compressor="dither64",
                             hess_compressor="dither64")
    cfg = flecs.FlecsConfig(m=4, grad_compressor="dither64",
                            hess_compressor="dither64",
                            hierarchy=HierarchyConfig(HIER_E))
    flat_hp = driver.tile_hparams(driver.grid1(flecs.hparams_from_config(
        flat)), len(HIER_EDGES))
    hp = flat_hp._replace(edge_spec=compressors.stack_specs(*HIER_EDGES))
    w0 = torch.zeros(d, device=dev)
    return (prob, flecs.make_flecs_sweep_step(cfg, lg, lh), hp,
            flecs.init_state(w0, n_workers, n_edges=HIER_E),
            flecs.make_flecs_sweep_step(flat, lg, lh), flat_hp,
            flecs.init_state(w0, n_workers))


def hierarchy_run(dev, iters, flat=False, **size):
    """A zero-argument run of :func:`hierarchy_setup`'s grid (or of the
    flat server on it), recording F each round."""
    from repro_torch import random
    from repro_torch.core.driver import run_sweep
    prob, step, hp, st0, fstep, fhp, fst0 = hierarchy_setup(dev, **size)
    if flat:
        step, hp, st0 = fstep, fhp, fst0
    return lambda: run_sweep(step, hp, st0, random.key(0, dev), iters,
                             record=lambda st: prob.metrics(st.w))


def cohort_setup(method, dev, n_total, d=123, r=COHORT_R, cohort=COHORT_K,
                 m=4):
    """The cohort engine of ``method`` (flecs: FLECS-CGD m = 4 dither64;
    diana: dither64; gd) at p = 0.5 over ``make_virtual_problem(d, n_total,
    r)``: (problem, sweep step, [1] grid, initial state)."""
    import torch
    from repro_torch.core import driver, flecs
    from repro_torch.data.logreg import make_virtual_problem
    from repro_torch.optim import baselines as tb
    prob = make_virtual_problem(d=d, n_total=n_total, r=r, seed=0,
                                device=dev)
    lg, lh = prob.make_oracles()
    w0 = torch.zeros(d, device=dev)
    if method == "flecs":
        cfg = flecs.FlecsConfig(m=m, participation=0.5)
        return (prob, flecs.make_flecs_cohort_sweep_step(cfg, lg, lh,
                                                         n_total, cohort),
                driver.grid1(flecs.hparams_from_config(cfg)),
                flecs.init_cohort_state(w0, n_total))
    if method == "diana":
        cfg = tb.DianaConfig(participation=0.5)
        return (prob, tb.make_diana_cohort_sweep_step(cfg, lg, n_total,
                                                      cohort),
                driver.grid1(tb.diana_hparams_from_config(cfg)),
                tb.init_diana(w0, n_total))
    cfg = tb.GDConfig(participation=0.5)
    return (prob, tb.make_gd_cohort_sweep_step(cfg, lg, n_total, cohort),
            driver.grid1(tb.gd_hparams_from_config(cfg)),
            tb.init_gd(w0, n_total))


def cohort_run(method, dev, n_total, iters, **kw):
    """A zero-argument run of :func:`cohort_setup`, recording F."""
    from repro_torch import random
    from repro_torch.core.driver import run_sweep
    prob, step, hp, st0 = cohort_setup(method, dev, n_total, **kw)
    return lambda: run_sweep(step, hp, st0, random.key(0, dev), iters,
                             record=lambda st: prob.metrics(st.w))


def cohort_draws(dev, n_total, cohort, iters, splits):
    """Every round's cohort ids and mask (p = 0.5) of a [1] grid on key 0,
    drawn as the cohort steps draw them (``splits``: the method's key
    split count): (ids [iters, K], masks [iters, K]) on the CPU."""
    import torch
    from repro_torch import random
    from repro_torch.core import driver
    keys = driver.sweep_keys(random.key(0, dev), 1, iters)[0]
    k_p = random.split(keys, splits)[:, -1]
    ids = driver.cohort_indices(random.fold_in(k_p, driver.COHORT_SALT),
                                n_total, cohort)
    mask = driver.resolve_participation(k_p, n_total, 0.5, "bernoulli",
                                        cohort=cohort)
    return ids.cpu(), mask.cpu()


def phase_row_ids(dev, ops, ref, random, driver, err) -> None:
    """Phase 2, ``fused_dither_keyed_grouped(..., ids=)``: against its
    plain version bit for bit at a cohort's ids (``cohort_indices`` of
    102,400 clients, 64 rows of 123 and 492), a block of a 20-worker
    federation (ids 10..19, rows of 5000), per-point ids [G, n] and over
    G = 3 points; and ids = 0..n-1 equal to the kernel without ids."""
    import numpy as np
    import torch
    rng = np.random.default_rng(23)
    cases = []
    for G in (1, 3):
        coh = driver.cohort_indices(random.split(random.key(31, "cpu"), G),
                                    102_400, 64)
        for L in (123, 492):
            cases.append((G, coh[0], L, "cohort ids"))
            cases.append((G, coh, L, "per-point cohort ids"))
        cases.append((G, torch.arange(10, 20), 5000, "block 10..19"))
    for G, ids, L, what in cases:
        n = ids.shape[-1]
        x = torch.as_tensor((rng.normal(size=(G * n, L)) * 10)
                            .astype(np.float32))
        keys = random.split(random.key(40 + G, "cpu"), G)
        s = torch.as_tensor(rng.choice([4.0, 16.0, 64.0], G)
                            .astype(np.float32))
        ids = ids.contiguous()
        out, bits = ops.fused_dither_keyed_grouped(
            x.to(dev), keys.to(dev), s.to(dev), ids.to(dev))
        want, want_bits = ref.fused_dither_keyed_grouped_ref(x, keys, s,
                                                             ids)
        label = f"{what}, G={G} [{G * n},{L}]"
        check(bit_identical(out, want) and bit_identical(bits, want_bits),
              f"fused_dither_keyed_grouped with ids differs from its plain "
              f"version on {label}")
        err["fused_dither_keyed_grouped"] = max(
            err["fused_dither_keyed_grouped"], max_abs_err(out, want))
        plain_ids = ops.fused_dither_keyed_grouped(
            x.to(dev), keys.to(dev), s.to(dev),
            torch.arange(n, device=dev))[0]
        check(bit_identical(plain_ids, ops.fused_dither_keyed_grouped(
            x.to(dev), keys.to(dev), s.to(dev))[0]),
            f"ids 0..n-1 differ from the kernel without ids on {label}")
    log(f"phase 2: fused_dither_keyed_grouped with global row ids "
        f"bit-identical to its plain version on {len(cases)} cases "
        f"(cohort ids of 102,400 clients, per-point ids, a 10..19 block) "
        f"and with ids 0..n-1 to the kernel without ids")


def _pop_cpu_run(job: tuple):
    """Phase 3e's CPU runs (a worker process, two threads): ("hier",) the
    hierarchy grid's recorded run at quickstart size; ("cohort", method,
    n_total) a cohort run's; ("figure", name) a paper figure's rows."""
    import torch
    from repro_torch import plan_drift
    torch.set_num_threads(2)
    if job[0] == "hier":
        return plan_drift.record_run(hierarchy_run("cpu", HIER_ITERS,
                                                   **POP_SIZE))
    if job[0] == "cohort":
        return plan_drift.record_run(cohort_run(job[1], "cpu", job[2],
                                                COHORT_ITERS))
    return figure_rows(job[1], "cpu")


def figure_rows(name, dev):
    """One of the paper figures of ``experiments`` at quickstart size,
    FIGURE_ITERS rounds where it takes rounds: its rows."""
    from repro_torch import experiments
    from repro_torch.data.logreg import make_problem
    prob = make_problem(**PLAN_PROBLEM, device=dev)
    if name == "comm_table":
        return experiments.comm_table(prob)
    out = getattr(experiments, name)(prob, FIGURE_ITERS)
    return out[0] if isinstance(out, tuple) else out


#: The kernels phase 3e's paths launch: the dither messages and prices,
#: and the count sketch's heavy-hitter top-k (no spec is priced by top-k).
POP_PATH = ("fused_dither_keyed_grouped", "dither_bits_grouped",
            "fused_topk_grouped")
#: Why a figure's F is logged and not held.
RISES = ("the run's F climbs 5% past its first value on the CPU too (the "
         "L-SR1 update's unstable start amplifies an ulp)")
FIGURES = ("fig3_iterate_updates", "comm_table", "ablation_dither_levels",
           "vmapped_grid", "ablation_grid")
#: Row keys compared exactly (ledgers and the grid's coordinates).
FIGURE_EXACT = ("bits_per_node", "Mbits", "iter", "s", "alpha", "grad_s",
                "hess_s", "beta", "method", "m", "measured_bits",
                "formula_bits", "match")


def _figure_pairs(rows):
    """(label, row) pairs of a figure's rows (fig3: by run)."""
    if isinstance(rows, dict):
        return [(f"{k} {r.get('iter')}", r) for k, v in rows.items()
                for r in v]
    return [(str(i), r) for i, r in enumerate(rows)]


def phase_figures(ops, counts) -> dict:
    """Phase 3b, the paper's remaining figures at quickstart size
    (``experiments.fig3_iterate_updates``, ``comm_table``,
    ``ablation_dither_levels``, ``vmapped_grid``, ``ablation_grid``;
    FIGURE_ITERS rounds): on the card against the CPU (run in worker
    processes meanwhile): ledger columns and the communication table
    exactly, every row's F within rtol 1e-4, but for a run whose F climbs
    past its start on the CPU too (``RISES``: logged)."""
    import numpy as np
    import torch
    out = {}
    with cpu_pool() as pool:
        cpu = {("figure", name): pool.submit(cpu_job, ("figure", name))
               for name in FIGURES}
        for name in FIGURES:
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            rows = figure_rows(name, "cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            for k, v in ops.launches.items():
                counts[k] += v
            want = cpu_result(cpu, ("figure", name))
            pairs, wpairs = _figure_pairs(rows), _figure_pairs(want)
            check([p[0] for p in pairs] == [p[0] for p in wpairs],
                  f"{name}: rows differ in shape from the CPU's")
            worst, logged = 0.0, []
            diverged = {}
            if isinstance(want, dict):
                # a run whose F climbs on the CPU too amplifies an ulp
                diverged = {k: max(r["F"] for r in v) > 1.05 * v[0]["F"]
                            for k, v in want.items()}
            for (lab, r), (_, w) in zip(pairs, wpairs):
                for key in FIGURE_EXACT:
                    if key in w:
                        check(r[key] == w[key], f"{name} row {lab}: {key} "
                              f"{r[key]} != the CPU's {w[key]}")
                if "F" in w:
                    rel = abs(r["F"] / w["F"] - 1)
                    run = lab.rsplit(" ", 1)[0]
                    if diverged.get(run):
                        logged.append((lab, rel))
                        continue
                    worst = max(worst, rel)
                    check(np.isfinite(r["F"]) and rel <= 1e-4,
                          f"{name} row {lab}: F {r['F']!r} beyond rtol "
                          f"1e-4 of the CPU's {w['F']!r}")
            log(f"phase 3b: {name} x{FIGURE_ITERS} on the card in "
                f"{secs!r} s: ledgers equal to the CPU's, F within "
                f"{worst!r}; logged, not held ({RISES}): {logged}; rows "
                f"{rows if not isinstance(rows, dict) else {k: v[-1] for k, v in rows.items()}}")
            out[name] = dict(seconds=secs, rel_final=worst,
                             diverged_logged=logged)
    return out


def _round_memory(step, hp, st, keys):
    """Step one round from ``st``: (state, aux, the round's peak device
    memory above the allocation before it, bytes)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st, aux = step(hp, st, keys)
    torch.cuda.synchronize()
    return st, aux, torch.cuda.max_memory_allocated() - base


def cohort_memory(method, n_total, ops, counts) -> dict:
    """COHORT_ITERS rounds of ``method``'s cohort engine over N = n_total
    on the card, round by round: ms a round, the persistent state's bytes,
    every round's peak above the allocation before it (the last is the
    N-independence measure)."""
    import torch
    from repro_torch import random
    from repro_torch.core import driver
    prob, step, hp, st0 = cohort_setup(method, "cuda", n_total)
    hp = driver.hparams_to(hp, "cuda")
    keys = driver.sweep_keys(random.key(0, "cuda"), 1, COHORT_ITERS)
    st = driver.batch_state(st0, 1, copy=True)
    persistent = sum(v.numel() * v.element_size() for v in st
                     if isinstance(v, torch.Tensor))
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    peaks = []
    for t in range(COHORT_ITERS):
        st, aux, peak = _round_memory(step, hp, st, keys[:, t])
        peaks.append(peak)
    secs = time.perf_counter() - t0
    for k, v in ops.launches.items():
        counts[k] += v
    F = float(prob.metrics(st.w)["F"][0])
    check(torch.isfinite(st.w).all().item(),
          f"cohort {method} N={n_total}: w not finite")
    r = dict(round_ms=1e3 * secs / COHORT_ITERS, persistent_bytes=persistent,
             round_peak_bytes=peaks[-1], round_peaks=peaks, F=F)
    log(f"phase 3e: cohort {method} K={COHORT_K} of N={n_total} x"
        f"{COHORT_ITERS}: {r['round_ms']!r} ms a round (each round timed "
        f"alone), persistent state {persistent / 2**20:.1f} MiB, the last "
        f"round's peak above the state {peaks[-1] / 2**20!r} MiB (every "
        f"round's: {[round(p / 2**20, 3) for p in peaks]}), F {F!r}")
    del st, st0
    torch.cuda.empty_cache()
    return r


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_sharded(ops, counts) -> dict:
    """Phase 3e, the sharded engine at world size 1 (NCCL, one rank, a
    ``tcp://localhost`` rendezvous): ``run_sharded_sweep`` against
    ``run_sweep`` on the card, bit for bit in every state leaf and trace,
    SHARDED_ITERS rounds at quickstart size with p = 0.5: FLECS (FedSONIA),
    FLECS (truncated inverse), hierarchical FLECS-CGD (dither64 edges) and
    DIANA."""
    import torch
    import torch.distributed as dist
    from repro_torch import random
    from repro_torch.core import driver, flecs
    from repro_torch.core.hierarchy import HierarchyConfig
    from repro_torch.data.logreg import make_problem
    from repro_torch.optim import baselines as tb
    group = driver.worker_group(1, 0, f"tcp://localhost:{_free_port()}",
                                backend="nccl")
    prob = make_problem(**POP_SIZE, mu=1e-3, seed=0, device="cuda")
    lg, lh = prob.make_oracles()
    n, w0 = prob.n_workers, torch.zeros(prob.d, device="cuda")
    cases = {}
    for name, kw in (("FLECS fedsonia", dict(grad_compressor="identity")),
                     ("FLECS truncated_inverse", dict(
                         grad_compressor="identity",
                         direction="truncated_inverse", tinv_floor=1e-3)),
                     ("FLECS-CGD hierarchy", dict(
                         hierarchy=HierarchyConfig(HIER_E, "dither64")))):
        cfg = flecs.FlecsConfig(m=4, participation=0.5, **kw)
        E = HIER_E if cfg.hierarchy else None
        cases[name] = (flecs.make_flecs_sweep_step(cfg, lg, lh),
                       flecs.make_flecs_sharded_sweep_step(cfg, lg, lh, n,
                                                           group),
                       driver.grid1(flecs.hparams_from_config(cfg)),
                       flecs.init_state(w0, n, n_edges=E),
                       flecs.sharded_state_specs(E is not None))
    cfg = tb.DianaConfig(participation=0.5)
    cases["DIANA"] = (tb.make_diana_sweep_step(cfg, lg),
                      tb.make_diana_sharded_sweep_step(cfg, lg, n, group),
                      driver.grid1(tb.diana_hparams_from_config(cfg)),
                      tb.init_diana(w0, n), tb.diana_sharded_state_specs())
    out = {}
    rec = lambda st: prob.metrics(st.w)                     # noqa: E731
    for name, (dense, sharded, hp, st0, specs) in cases.items():
        key = random.key(0, "cuda")
        ops.reset_launches()
        d = driver.run_sweep(dense, hp, st0, key, SHARDED_ITERS, record=rec)
        t0 = time.perf_counter()
        s = driver.run_sharded_sweep(sharded, hp, st0, key, SHARDED_ITERS,
                                     specs, group, record=rec)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for k, v in ops.launches.items():
            counts[k] += v
        _bitwise(f"sharded {name} state", {f: v for f, v in zip(
            d[0]._fields, d[0]) if isinstance(v, torch.Tensor)},
            {f: v for f, v in zip(s[0]._fields, s[0])
             if isinstance(v, torch.Tensor)})
        _bitwise(f"sharded {name} traces", d[1], s[1])
        out[name] = dict(seconds=secs, F=float(d[1]["F"][0, -1]))
        log(f"phase 3e: run_sharded_sweep (NCCL, world size 1) equals "
            f"run_sweep on the card bit for bit, {name} x{SHARDED_ITERS}: "
            f"every state leaf and trace; {secs!r} s, final F "
            f"{out[name]['F']!r}")
    dist.destroy_process_group()
    return out


def phase_population(ops, counts) -> dict:
    """Phase 3e: hierarchy, cohort and sharding on the card.  First, with
    the host quiet, the timed cells: gisette width with the edge tier and
    the cohort engine (ms, kernels, busy ms, peak a round as phase 4b
    takes them), and the cohort engine's memory round by round at N =
    1,024, 102,400 and 1,048,576 (FLECS-CGD) and 102,400 (DIANA, GD).
    Then, the CPU side in worker processes meanwhile: the hierarchy grid
    at quickstart size (100 rounds: ledgers equal, each point held by
    ``plan_drift.verdict``, the identity point against the flat server),
    the cohort runs against the CPU (ids, masks and ledgers equal, F held
    by ``verdict``), and the sharded engine at world size 1."""
    import torch
    from repro_torch import random
    from repro_torch.core.driver import run_sweep
    out = {}
    # gisette width, the edge tier and the cohort engine
    _, step, hp, st0, _, _, _ = hierarchy_setup("cuda", d=5000,
                                                n_workers=20, r=300)
    out["gisette_hierarchy"] = _cell(
        "hierarchical FLECS-CGD E=4, edges identity/dither64/count_sketch64"
        " (G = 3)", lambda n: run_sweep(step, hp, st0,
                                        random.key(0, "cuda"), n),
        ops, counts, phase="3e")
    del step, st0
    torch.cuda.empty_cache()
    _, gstep, ghp, gst0 = cohort_setup("flecs", "cuda", 102_400, d=5000,
                                           cohort=20)
    out["gisette_cohort"] = _cell(
        "cohort FLECS-CGD K=20 of N=102,400 (virtual shards of 16 rows)",
        lambda n: run_sweep(gstep, ghp, gst0, random.key(0, "cuda"), n),
        ops, counts, phase="3e")
    del gstep, gst0
    torch.cuda.empty_cache()
    # a round's memory above the persistent state, by N
    mem = {n: cohort_memory("flecs", n, ops, counts) for n in COHORT_NS}
    peaks = [mem[n]["round_peak_bytes"] for n in COHORT_NS]
    check(max(peaks) - min(peaks) <= 2 * 2**20,
          f"cohort round peaks above the state differ by more than 2 MiB "
          f"over N {COHORT_NS}: {peaks}")
    out["cohort_memory"] = mem
    for method in ("diana", "gd"):
        out[f"cohort_memory_{method}"] = cohort_memory(method, 102_400, ops,
                                                       counts)
    log(f"phase 3e: one cohort round's peak above the persistent state at N "
        f"{COHORT_NS}: {[p / 2**20 for p in peaks]} MiB (within 2 MiB)")
    jobs = [("hier",), ("cohort", "flecs", 1024), ("cohort", "diana", 102_400),
            ("cohort", "gd", 102_400)]
    with cpu_pool() as pool:
        cpu = {job: pool.submit(cpu_job, job) for job in jobs}
        # the card's own runs first, while the CPU side works
        out["sharded"] = phase_sharded(ops, counts)
        out["cohort"] = {}
        for method, n_total in (("flecs", 1024), ("diana", 102_400),
                                ("gd", 102_400)):
            out["cohort"][method] = phase_cohort_cpu(method, n_total, ops,
                                                     counts, cpu)
        out["hierarchy"] = phase_hierarchy_quick(ops, counts, cpu)
        for f in cpu.values():
            f.result()
    return out


def phase_hierarchy_quick(ops, counts, cpu) -> dict:
    """Phase 3e (a): the hierarchy grid at quickstart size, HIER_ITERS
    rounds, on the card against the CPU: edge_bits and bits_per_node equal
    every round, each point held by ``plan_drift.verdict``; the identity
    point's F within rtol 1e-5 of the flat server's over the first 6
    rounds (the reference's own contract) and its largest gap over all
    rounds logged."""
    import numpy as np
    from repro_torch import plan_drift
    rec, secs = _recorded(ops, counts, hierarchy_run("cuda", HIER_ITERS,
                                                     **POP_SIZE))
    crec = cpu_result(cpu, ("hier",))
    (sts, tr, _), (csts, ctr, _) = rec, crec
    for key in ("edge_bits", "bits_per_node", "n_active"):
        check(np.array_equal(tr[key].cpu().numpy(), ctr[key].numpy()),
              f"hierarchy: {key} differs between the card and the CPU")
    check(np.array_equal(sts.edge_bits.cpu().numpy(),
                         csts.edge_bits.numpy()),
          "hierarchy: final edge_bits differ from the CPU's")
    reports = plan_drift.compare_recorded_grid(rec, crec)
    held = {}
    for g, (name, rep) in enumerate(zip(HIER_EDGES, reports)):
        faults = plan_drift.verdict(rep)
        log(f"phase 3e: hierarchy {name} edges x{HIER_ITERS}, card against "
            f"CPU: final F {rep['F_a']!r} / {rep['F_b']!r}, max rel gap "
            f"{rep['max_rel_gap']!r}; first difference "
            f"{rep.get('first_difference')}; faults {faults}")
        check(not faults, f"hierarchy {name}: {faults}")
        held[name] = dict(final_rel_gap=rep["final_rel_gap"],
                          max_rel_gap=rep["max_rel_gap"],
                          edge_bits=sts.edge_bits[g].cpu().tolist())
    _, ftr = hierarchy_run("cuda", HIER_ITERS, flat=True, **POP_SIZE)()
    F_id = tr["F"][0].cpu().double().numpy()
    F_flat = ftr["F"][0].cpu().double().numpy()
    rel = np.abs(F_id / F_flat - 1)
    check(rel[:6].max() <= 1e-5, f"hierarchy: the identity edge point "
          f"parts from the flat server by {rel[:6].max()!r} in 6 rounds")
    log(f"phase 3e: hierarchy x{HIER_ITERS} (G = 3) on the card in {secs!r} "
        f"s (compressor calls recorded): edge_bits and bits_per_node equal "
        f"to the CPU's every round, final edge_bits "
        f"{sts.edge_bits.cpu().tolist()}; the identity point within "
        f"{rel[:6].max()!r} of the flat server over 6 rounds, "
        f"{rel.max()!r} over {HIER_ITERS} (logged)")
    return dict(points=held, seconds=secs, identity_vs_flat_6=rel[:6].max(),
                identity_vs_flat_all=rel.max())


def phase_cohort_cpu(method, n_total, ops, counts, cpu) -> dict:
    """Phase 3e (b): a cohort run (K = 64 of ``n_total``, COHORT_ITERS
    rounds) on the card against the CPU: every round's cohort ids and mask
    equal, the ledgers (bits_per_node, cohort_bits, n_active) equal, and
    F held by ``plan_drift.verdict``."""
    import numpy as np
    import torch
    from repro_torch import plan_drift
    splits = {"flecs": 5, "diana": 3, "gd": 2}[method]
    ids, masks = cohort_draws("cuda", n_total, COHORT_K, COHORT_ITERS, splits)
    cids, cmasks = cohort_draws("cpu", n_total, COHORT_K, COHORT_ITERS,
                                splits)
    check(torch.equal(ids, cids) and torch.equal(masks, cmasks),
          f"cohort {method} N={n_total}: ids or masks differ from the CPU's")
    rec, secs = _recorded(ops, counts, cohort_run(method, "cuda", n_total,
                                                  COHORT_ITERS))
    crec = cpu_result(cpu, ("cohort", method, n_total))
    (sts, tr, _), (csts, ctr, _) = rec, crec
    for key in ("cohort_bits", "n_active"):
        check(np.array_equal(tr[key].cpu().numpy(), ctr[key].numpy()),
              f"cohort {method}: {key} differs between the card and CPU")
    check(np.array_equal(sts.bits_per_node.cpu().numpy(),
                         csts.bits_per_node.numpy()),
          f"cohort {method}: bits_per_node differs from the CPU's")
    (rep,) = plan_drift.compare_recorded_grid(rec, crec)
    faults = plan_drift.verdict(rep)
    log(f"phase 3e: cohort {method} K={COHORT_K} of N={n_total} "
        f"x{COHORT_ITERS} on the card in {secs!r} s: ids, masks and ledgers "
        f"equal to the CPU's; final F {rep['F_a']!r} / {rep['F_b']!r}, max "
        f"rel gap {rep['max_rel_gap']!r}; first difference "
        f"{rep.get('first_difference')}; faults {faults}")
    check(not faults, f"cohort {method}: {faults}")
    return dict(seconds=secs, max_rel_gap=rep["max_rel_gap"],
                F=rep["F_a"])


def empty_launch_ms() -> float:
    """One launch of a kernel that does nothing (``torch.cuda._sleep(0)``),
    timed back to back behind a spin: the least any kernel takes on this
    card, the floor of the ledger kernels' time."""
    import torch
    return cuda_ms(lambda: torch.cuda._sleep(0), 200)


# ---------------------------------------------------------------------------
# Slice 3: the int8 dither codec, the flash-attention backward, training
# ---------------------------------------------------------------------------

def same_bits(a, b) -> bool:
    """Equal element for element on any device (NaN matching NaN, any
    payload), dtype and shape too."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    b = b.to(a.device)
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    word = torch.int32 if a.element_size() == 4 else torch.int16
    return bool(((a.view(word) == b.view(word)) | na).all())


def abs_err(a, b) -> float:
    """max |a - b| over the positions where b is not NaN (0.0 if none)."""
    import torch
    a, b = a.double(), b.to(a.device).double()
    d = (a - b).abs()
    d = torch.where(torch.isnan(b), torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


def phase_dither_kernels(dev, d_ops, d_ref, random):
    """Phase 2, the int8 dither codec: the encode (u-taking and keyed, and
    the keyed encode's split entries over one worker and several) and
    decode kernels on the card against their plain versions on the same
    inputs, bit for bit."""
    import numpy as np
    import torch
    err = {"dither_encode": 0.0, "dither_encode_keyed": 0.0,
           "dither_absmax": 0.0, "dither_levels_keyed": 0.0,
           "dither_decode": 0.0}
    rng = np.random.default_rng(4)
    n = 0

    def compare_split(xs, key, s, br, what):
        """The keyed encode's split entries over the workers' tensors xs
        (the norm pass of each into zeroed norms, then each worker's levels
        pass) against their plain versions on the same inputs, and at one
        worker against the fused keyed encode, bit for bit."""
        nonlocal n
        nb = xs[0].shape[0] // br
        bits = torch.zeros(nb, dtype=torch.int32, device=dev)
        want_bits = torch.zeros(nb, dtype=torch.int32, device=xs[0].device)
        for x in xs:
            d_ops.dither_absmax_into(x.to(dev), bits, block_rows=br)
            d_ref.dither_absmax_into_ref(x, want_bits, br)
        check(same_bits(bits, want_bits.to(dev)),
              f"dither_absmax differs from its plain version on {what}")
        err["dither_absmax"] = max(err["dither_absmax"], abs_err(
            bits.view(torch.float32), want_bits.view(torch.float32)))
        for x in xs:
            lv, sc = d_ops.dither_levels_keyed(x.to(dev), key.to(dev), bits,
                                               s=s, block_rows=br)
            want_lv, want_sc = d_ref.dither_levels_keyed_ref(
                x, key.to(x.device), want_bits, s, br)
            check(same_bits(lv, want_lv.to(dev)) and same_bits(sc, want_sc),
                  f"dither_levels_keyed differs from its plain version on "
                  f"{what}")
            err["dither_levels_keyed"] = max(
                err["dither_levels_keyed"], abs_err(lv, want_lv),
                abs_err(sc, want_sc))
            del want_lv
        if len(xs) == 1:
            f_lv, f_sc = d_ops.dither_encode_keyed(xs[0].to(dev), key.to(dev),
                                                   s=s, block_rows=br)
            check(same_bits(lv, f_lv) and same_bits(sc, f_sc),
                  f"the split entries differ from dither_encode_keyed on "
                  f"{what}")
        n += 1

    def compare_keyed(x, key, s, br, what):
        """The keyed encode against its plain version (uniform(key, shape),
        then the plain encode, on x's device) and against the u-taking
        kernel fed the same uniforms drawn on the card."""
        nonlocal n
        lv, sc = d_ops.dither_encode_keyed(x.to(dev), key.to(dev), s=s,
                                           block_rows=br)
        want_lv, want_sc = d_ref.dither_encode_keyed_ref(
            x, key.to(x.device), s, br)
        check(same_bits(lv, want_lv.to(dev)) and same_bits(sc, want_sc),
              f"dither_encode_keyed differs from its plain version on "
              f"{what}")
        u = random.uniform(key.to(dev), tuple(x.shape))
        u_lv, u_sc = d_ops.dither_encode(x.to(dev), u, s=s, block_rows=br)
        check(same_bits(lv, u_lv) and same_bits(sc, u_sc),
              f"dither_encode_keyed differs from dither_encode on the same "
              f"uniforms on {what}")
        err["dither_encode_keyed"] = max(err["dither_encode_keyed"],
                                         abs_err(lv, want_lv),
                                         abs_err(sc, want_sc))
        n += 1

    def compare(x, u, s, br, what):
        nonlocal n
        lv, sc = d_ops.dither_encode(x.to(dev), u.to(dev), s=s,
                                     block_rows=br)
        out = d_ops.dither_decode(lv, sc, block_rows=br)
        want_lv, want_sc = d_ref.dither_encode_ref(x, u, s, br)
        want = d_ref.dither_decode_ref(want_lv, want_sc, br)
        check(same_bits(lv, want_lv.to(dev)) and same_bits(sc, want_sc),
              f"dither_encode differs from its plain version on {what}")
        check(same_bits(out, want.to(dev)),
              f"dither_decode differs from its plain version on {what}")
        err["dither_encode"] = max(err["dither_encode"], abs_err(
            lv, want_lv), abs_err(sc, want_sc))
        err["dither_decode"] = max(err["dither_decode"], abs_err(out, want))
        n += 1

    # tests/test_kernels.py's shapes (R, C, block_rows, s), f32 and bf16
    for R, C, br, s in ((16, 128, 8, 127), (32, 256, 8, 63), (8, 512, 4, 15),
                        (64, 128, 16, 127), (64, 512, 8, 255)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.as_tensor((rng.normal(size=(R, C)) * 10).astype(
                np.float32)).to(dtype)
            u = torch.as_tensor(rng.random((R, C), dtype=np.float32))
            compare(x, u, s, br, f"[{R},{C}] br={br} s={s} {dtype}")
            compare_keyed(x, random.fold_in(random.key(R, "cpu"), C), s, br,
                          f"[{R},{C}] br={br} s={s} {dtype} (keyed)")
            compare_split([x], random.key(R + C, "cpu"), s, br,
                          f"[{R},{C}] br={br} s={s} {dtype} (split)")
    # lengths that are not a multiple of 4, and an x that is not 16-byte
    # aligned: the keyed pass's scalar path
    for R, C, br, s in ((24, 77, 3, 255), (1, 4099, 1, 127)):
        x = torch.as_tensor((rng.normal(size=(R, C)) * 10).astype(
            np.float32))
        compare_keyed(x, random.key(C, "cpu"), s, br, f"[{R},{C}] (keyed)")
        for workers in (1, 3):
            xs = [x] + [x * (0.5 + j) for j in range(1, workers)]
            compare_split(xs, random.key(C, "cpu"), s, br,
                          f"[{R},{C}] br={br} s={s}, {workers} workers "
                          f"(split)")
    x = torch.as_tensor(rng.normal(size=64 * 128 + 1).astype(
        np.float32)).to(dev)[1:].view(64, 128)
    compare_keyed(x, random.key(2, "cpu"), 127, 16,
                  "x not 16-byte aligned (keyed)")
    # zero, -0, ±inf and NaN blocks; s = 255 saturates past 127
    inf, nan = float("inf"), float("nan")
    x = torch.tensor([[0.0] * 4, [-0.0] * 4,
                      [1.0, inf, 3.0, -2.0], [0.5, -inf, 0.0, 7.0],
                      [1.0, nan, 3.0, -2.0], [-0.0, 0.5, 2.0, 1.0],
                      [4.0, -4.0, 3.9, -3.9], [1e-3, 2e-3, -4.0, 0.25]])
    u = torch.as_tensor(rng.random(x.shape, dtype=np.float32))
    for s in (15, 127, 255):
        compare(x, u, s, 2, f"edge rows s={s}")
        compare_keyed(x, random.key(s, "cpu"), s, 2,
                      f"edge rows s={s} (keyed)")
        compare_split([x, x.flip(0)], random.key(s, "cpu"), s, 2,
                      f"edge rows s={s}, 2 workers (split)")
    # whole trainer leaves as one block (the FLECS-CGD path's shapes):
    # inputs made on the card, the plain version run there too
    g = torch.Generator(device=dev).manual_seed(5)
    for i, (R, C) in enumerate(LEAF_SHAPES):
        x = torch.randn((R, C), generator=g, device=dev) * 1e-3
        u = torch.rand((R, C), generator=g, device=dev)
        compare(x, u, 127.0, R, f"leaf [{R},{C}] as one block")
        del u
        compare_keyed(x, random.fold_in(random.key(29, "cpu"), i), 127.0, R,
                      f"leaf [{R},{C}] as one block (keyed)")
        if i == 0:
            # the trainer's largest leaf, one worker and two
            compare_split([x], random.fold_in(random.key(29, "cpu"), i),
                          127.0, R, f"leaf [{R},{C}] as one block (split)")
            compare_split([x, x * 2.0], random.fold_in(random.key(29, "cpu"),
                                                       i), 127.0, R,
                          f"leaf [{R},{C}] as one block, 2 workers (split)")
        del x
        torch.cuda.empty_cache()
    # the decode alone: multi-block, ragged blocks (the scalar kernel), and
    # levels that start 1 byte (scalar) or 4 bytes (vector loads; 4- but
    # not 16-byte aligned) into an allocation
    for R, C, br, offset in ((64, 128, 16, 0), (300, 1000, 300, 0),
                             (24, 77, 3, 0), (7, 5, 7, 0), (64, 128, 16, 1),
                             (64, 128, 16, 4), (33, 12, 11, 4)):
        buf = torch.as_tensor(rng.integers(-128, 128, size=R * C + offset,
                                           dtype=np.int8))
        lv = buf.to(dev)[offset:].view(R, C)
        sc = torch.as_tensor(rng.random(R // br, dtype=np.float32) + 0.5)
        check(lv.data_ptr() % 16 == offset,
              "decode case not at the intended alignment")
        got = d_ops.dither_decode(lv, sc.to(dev), block_rows=br)
        want = d_ref.dither_decode_ref(lv.cpu(), sc, br)
        check(same_bits(got, want.to(dev)), f"dither_decode differs from its "
              f"plain version on [{R},{C}] br={br} offset {offset}")
        err["dither_decode"] = max(err["dither_decode"], abs_err(got, want))
        n += 1
    # quantize's layout and draw, card against CPU
    for shape in ((1000,), (33, 77), (4, 5, 6), (128, 512)):
        x = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
        got = d_ops.quantize(random.key(1, dev), x.to(dev), s=63)
        want = d_ops.quantize(random.key(1, "cpu"), x, s=63)
        check(same_bits(got[0], want[0].to(dev))
              and same_bits(got[1], want[1]) and got[2] == want[2],
              f"quantize differs from its plain version on {shape}")
        check(same_bits(d_ops.dequantize(*got), d_ops.dequantize(*want)),
              f"dequantize differs from its plain version on {shape}")
        n += 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 2: dither codec, {n} cases bit-identical to the plain "
        f"versions; max_abs_err {err}")
    return err


# the reference's five test shapes, S = 1, S = 200 with a window of 7 and
# with a cap of 50, S = 333, and the training shape (tinyllama-1.1b, batch
# 8 x 1024): B, H, KV, S, D, window, cap
BWD_SHAPES = FLASH_SHAPES[:5] + [(1, 2, 1, 1, 128, 0, 0.0),
                                 (1, 4, 2, 200, 64, 7, 0.0),
                                 (2, 4, 1, 200, 32, 0, 50.0),
                                 (1, 2, 2, 333, 64, 5, 0.0), SERVE_SHAPE]
#: Flash backward against the plain version under autograd on the card:
#: max |Δ| <= BWD_REL · max |grad| (max over dq, dk, dv), per dtype.
BWD_REL = {"float32": 1e-5, "bfloat16": 1e-2}


def bwd_wgmma_sass(fa_ops, required=True) -> dict:
    """HGMMA instructions in the SASS of each of the bf16 backward's wgmma
    kernels (dK/dV and dQ at D = 32, 64, 128), read with cuobjdump from the
    flash library built; ``required``: fail unless all six hold some, so a
    fall back to HMMA cannot pass unseen."""
    counts = opcode_counts(sass_functions(fa_ops.LIBRARY.build()),
                           WGMMA_BWD_SASS, "HGMMA")
    check(not required or (len(counts) == 6 and all(counts.values())),
          f"the bf16 backward's wgmma kernels hold no HGMMA: {counts}")
    return counts


def fwd_wgmma_sass(fa_ops, required=True) -> dict:
    """HGMMA instructions in the SASS of each instance of the bf16 forward
    on wgmma (cuobjdump of the flash library built); ``required``: fail
    unless each of the four holds some."""
    counts = opcode_counts(sass_functions(fa_ops.LIBRARY.build()),
                           WGMMA_FWD_SASS, "HGMMA")
    check(not required or (len(counts) == 4 and all(counts.values())),
          f"the bf16 forward's wgmma kernels hold no HGMMA: {counts}")
    return counts


def phase_flash_backward(dev, fa_ops, fa_ref, need_wgmma=True):
    """Phase 2, flash-attention backward: dq, dk, dv of the kernels against
    the plain version's autograd on the card, same inputs and output
    gradient; and the forward's output bitwise the same with and without
    its log-sum-exp output.  With ``need_wgmma`` the bf16 kernels' SASS
    must hold HGMMA (an earlier checkout timed beside this one has none)."""
    import torch
    hgmma = bwd_wgmma_sass(fa_ops, need_wgmma)
    log(f"phase 2: HGMMA instructions of the bf16 backward kernels (SASS): "
        f"{hgmma}")
    err, rel_worst = {}, {}
    for shape in BWD_SHAPES:
        window, cap = shape[5], shape[6]
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            q, k, v = flash_inputs(shape, dtype, dev, seed=2)
            gen = torch.Generator(device="cpu").manual_seed(3)
            dout = torch.randn(q.shape, generator=gen).to(dev, dtype)

            def grads(fn):
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                out = fn(*leaves, window, cap)
                return out.detach(), torch.autograd.grad(out, leaves, dout)

            out, got = grads(fa_ops.flash_attention)
            _, again = grads(fa_ops.flash_attention)
            check(all(same_bits(a, b) for a, b in zip(got, again)),
                  f"flash backward differs between two runs at {shape} "
                  f"{name}")
            with torch.no_grad():
                plain_fwd = fa_ops.flash_attention(q, k, v, window, cap)
            check(same_bits(out, plain_fwd),
                  f"flash_attention's output changes with the LSE output at "
                  f"{shape} {name}")
            _, want = grads(fa_ref.attention_ref)
            scale = max(float(w.float().abs().max()) for w in want)
            e = max(abs_err(a.float(), w.float()) for a, w in zip(got, want))
            check(all(a.dtype == dtype for a in got),
                  f"flash backward returned {[a.dtype for a in got]}")
            check(e <= BWD_REL[name] * scale,
                  f"flash backward differs from the plain autograd at "
                  f"{shape} {name}: max |Δ| {e!r} beyond "
                  f"{BWD_REL[name]} · {scale!r}")
            err[name] = max(err.get(name, 0.0), e)
            rel_worst[name] = max(rel_worst.get(name, 0.0),
                                  e / scale if scale else 0.0)
            log(f"phase 2: flash backward {shape} {name}: max |Δ| {e!r} "
                f"({e / scale if scale else 0.0!r} of max |grad| {scale!r})")
            del q, k, v, dout, out, got, again, want, plain_fwd
    torch.cuda.empty_cache()
    return err, rel_worst


def train_counters(fa_ops, d_ops, ops):
    return {**fa_ops.launches, **d_ops.launches,
            "dither_bits": ops.launches["dither_bits"]}


def check_launches(label, counts, expect, steps) -> None:
    for name, n in expect.items():
        check(counts[name] == n * steps,
              f"{label}: {name} launched {counts[name]} times in {steps} "
              f"steps, expected {n * steps}")


def reset_train_counters(fa_ops, d_ops, ops):
    fa_ops.reset_launches()
    d_ops.reset_launches()
    ops.reset_launches()


#: Depth-2 training, card against this machine's CPU: losses within
#: LOSS_REL of each other every step; first-step gradients per leaf within
#: GRAD_REL · max |g|; the first FLECS step's int8 levels at no more than
#: LEVEL_SHARE of the elements, by one level at most; uplink_mbits equal.
LOSS_REL, GRAD_REL, LEVEL_SHARE = 1e-5, 1e-4, 1e-3
#: Phase 8's steps of each mode (cut from 3 for phase 13: the second step's
#: loss still holds the first step's update), and the depth-2 batch of
#: phases 8 and 10 (cut from 2 x 256 for phase 13: their CPU sides bound
#: both phases on a slow host).
DEPTH2_STEPS = 2
DEPTH2_BATCH = (2, 128)


def phase_train_depth2(train, value_and_grad, compressors, random, tree):
    """Phase 8: tinyllama-1.1b at full width and depth 2, batch DEPTH2_BATCH:
    first-step gradients and int8 levels, then DEPTH2_STEPS adam steps and
    as many FLECS-CGD steps from the same weights, on the card and on this
    machine's CPU."""
    import torch
    cfg, params = train.setup(TINYLLAMA, smoke=False, device="cuda",
                              n_layers=2)
    cpu_params = to_cpu(params)
    batch = next(train.token_batches(cfg, *DEPTH2_BATCH,
                                     params["embed"].device))
    cpu_batch = to_cpu(batch)
    loss_g, g_card = value_and_grad(params, batch, cfg, remat=True)
    loss_c, g_cpu = value_and_grad(cpu_params, cpu_batch, cfg, remat=True)
    check(abs(float(loss_g) - float(loss_c)) <= LOSS_REL * abs(float(loss_c)),
          f"depth 2: first loss {float(loss_g)!r} on the card, "
          f"{float(loss_c)!r} on the CPU")
    worst, flips, total, max_flip = 0.0, 0, 0, 0
    s = compressors.psum_level_cap(127, 1)
    key0 = random.fold_in(random.key(29, "cpu"), 0)
    for i, (a, b) in enumerate(zip(tree.tree_leaves(g_card),
                                   tree.tree_leaves(g_cpu))):
        e = abs_err(a, b) / max(float(b.abs().max()), 1e-30)
        worst = max(worst, e)
        check(e <= GRAD_REL, f"depth 2: gradient leaf {i} {tuple(b.shape)} "
              f"differs by {e!r} of max |g|, beyond {GRAD_REL}")
        key = random.fold_in(key0, i)
        lv_a, _ = compressors.shared_scale_levels(key.to(a.device), a, s)
        lv_b, _ = compressors.shared_scale_levels(key, b, s)
        d = (lv_a.cpu().int() - lv_b.int()).abs()
        flips += int((d > 0).sum())
        total += d.numel()
        max_flip = max(max_flip, int(d.max()))
    check(max_flip <= 1 and flips <= LEVEL_SHARE * total,
          f"depth 2: first-step levels differ at {flips} of {total} "
          f"elements, by up to {max_flip}")
    log(f"phase 8: depth 2 first step: loss card {float(loss_g)!r} cpu "
        f"{float(loss_c)!r}; gradients within {worst!r} of max |g| per leaf"
        f" (bound {GRAD_REL}); int8 levels differ at {flips} of {total} "
        f"elements, by at most {max_flip}")
    del g_card, g_cpu
    runs = {}
    for mode in ("adam", "flecs"):
        for name, p, dev in (("cuda", params, batch["tokens"].device),
                             ("cpu", cpu_params, torch.device("cpu"))):
            batches = train.token_batches(cfg, *DEPTH2_BATCH, dev)
            out = train.train(cfg, p, batches, DEPTH2_STEPS,
                              flecs=mode == "flecs")
            runs[(mode, name)] = out["metrics"]
            del out
        for a, b in zip(runs[(mode, "cuda")], runs[(mode, "cpu")]):
            check(abs(a["loss"] - b["loss"]) <= LOSS_REL * abs(b["loss"]),
                  f"depth 2 {mode}: losses {a['loss']!r} (card) and "
                  f"{b['loss']!r} (CPU) beyond rtol {LOSS_REL}")
            if mode == "flecs":
                check(a["uplink_mbits"] == b["uplink_mbits"],
                      f"depth 2 flecs: uplink {a['uplink_mbits']!r} (card) "
                      f"and {b['uplink_mbits']!r} (CPU)")
        log(f"phase 8: depth 2 {mode} x{DEPTH2_STEPS}: losses card "
            f"{[m['loss'] for m in runs[(mode, 'cuda')]]} cpu "
            f"{[m['loss'] for m in runs[(mode, 'cpu')]]}")
    del params, cpu_params
    torch.cuda.empty_cache()
    return dict(grad_rel_worst=worst, level_flips=flips, level_total=total,
                losses={f"{m}_{d}": [x["loss"] for x in r]
                        for (m, d), r in runs.items()},
                uplink_mbits=runs[("flecs", "cuda")][0]["uplink_mbits"])


#: Phase 9's steps of each mode (cut from 5 for phase 13).
FULL_STEPS = 3


def phase_train_full(train, fa_ops, d_ops, ops, tree):
    """Phase 9: tinyllama-1.1b at full width (22 layers, float32, remat),
    batch 8 x 1024, FULL_STEPS adam steps and as many FLECS-CGD steps
    (alpha = 30 · lr)
    on one batch through ``launch/train.py``'s own functions; the counters
    are set to 0 just before each run and read just after.  Then a profile
    of one step of each mode."""
    import itertools
    import torch
    from torch.profiler import ProfilerActivity, profile
    cfg, params = train.setup(TINYLLAMA, smoke=False, device="cuda")
    batch = next(train.token_batches(cfg, *TRAIN_BATCH,
                                     params["embed"].device))
    L = cfg.n_layers
    n_leaves = len(tree.tree_leaves(params))
    steps = FULL_STEPS
    res = {}
    for mode in ("adam", "flecs"):
        flecs = mode == "flecs"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_train_counters(fa_ops, d_ops, ops)
        out = train.train(cfg, params, itertools.repeat(batch), steps,
                          flecs=flecs, log=lambda s: log(f"  {mode} {s}"))
        torch.cuda.synchronize()
        counts = train_counters(fa_ops, d_ops, ops)
        peak = torch.cuda.max_memory_allocated()
        losses = [m["loss"] for m in out["metrics"]]
        per_leaf = n_leaves if flecs else 0
        expect = {"flash_attention": 2 * L * steps,
                  "flash_attention_backward": L * steps,
                  "dither_encode": 0, "dither_absmax": 0,
                  "dither_levels_keyed": 0,
                  "dither_encode_keyed": per_leaf * steps,
                  "dither_decode": per_leaf * steps,
                  "dither_bits": per_leaf * steps}
        for name, n in expect.items():
            check(counts[name] == n, f"full-width {mode}: {name} launched "
                  f"{counts[name]} times in {steps} steps, expected {n}")
        check(all(map(math.isfinite, losses)),
              f"full-width {mode}: losses not finite: {losses}")
        if not flecs:
            check(losses[-1] < losses[0],
                  f"full-width adam: loss did not fall: {losses}")
        res[mode] = dict(
            losses=losses, grad_norm=[m["grad_norm"] for m in out["metrics"]],
            step_ms=out["step_ms"], peak_gib=peak / 2**30,
            launches=counts, launches_per_step={
                k: v / steps for k, v in counts.items()})
        if flecs:
            res[mode]["uplink_mbits"] = out["metrics"][-1]["uplink_mbits"]
        log(f"phase 9: {TINYLLAMA} x{L} f32 remat, batch 8 x 1024, {mode} "
            f"x{steps}: losses {losses}; step ms {out['step_ms']}; peak "
            f"memory {peak / 2**30!r} GiB; launches per step "
            f"{res[mode]['launches_per_step']}")
        del out
        torch.cuda.empty_cache()
    # one profiled step of each mode
    res["profile"] = {}
    for mode in ("adam", "flecs"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = train.train(cfg, params, itertools.repeat(batch), 1,
                              flecs=mode == "flecs")
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        del out
        rows = {}
        for t, count, name in device_rows(prof):
            t0_, c0 = rows.get(name, (0.0, 0))
            rows[name] = (t0_ + t, c0 + count)
        busy = sum(t for t, _ in rows.values())
        n_kernels = sum(c for _, c in rows.values())
        top = sorted(((t, c, name) for name, (t, c) in rows.items()),
                     reverse=True)[:15]
        mine = {k: sum(t for name, (t, _) in rows.items() if k in name) / 1e3
                for k in ("flash_fwd", "flash_bwd", "absmax_kernel",
                          "encode_keyed_kernel", "encode_kernel",
                          "decode_kernel")}
        # the int64 elementwise passes (threefry in tensor ops, fold_in)
        int64 = [(t, c) for name, (t, c) in rows.items()
                 if "elementwise" in name and ("long" in name
                                               or "int64" in name)]
        int64_ms = sum(t for t, _ in int64) / 1e3
        int64_n = sum(c for _, c in int64)
        log(f"profile train {mode} step (profiled): wall "
            f"{wall_us / 1e3!r} ms, device busy {busy / 1e3!r} ms "
            f"({100 * busy / wall_us:.1f}% of wall), {n_kernels} device "
            f"kernels and copies; ours (ms) {mine}; int64 elementwise "
            f"{int64_ms!r} ms in {int64_n} launches")
        for t, count, name in top:
            log(f"  {t / 1e3:10.4f} ms  x{count:6d}  {name[:80]}")
        res["profile"][mode] = dict(
            wall_ms=wall_us / 1e3, busy_ms=busy / 1e3, kernels=n_kernels,
            ours_ms=mine, int64_elementwise_ms=int64_ms,
            int64_elementwise_launches=int64_n,
            top=[[t / 1e3, c, name[:80]] for t, c, name in top])
        if mode == "flecs":
            check(int64_ms < 50.0, f"full-width flecs: {int64_ms!r} ms of "
                  f"int64 elementwise kernels a step, expected < 50 (the "
                  f"uniforms are drawn inside the keyed encode)")
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return res


def flash_backward_timing(dev, dtype, fa_ops, fa_ref, g):
    """The flash backward kernels at the training shape by CUDA events,
    beside the plain version's autograd and SDPA's backward (each fwd+bwd
    less its forward; SDPA timed only) and the bound at the arithmetic the
    kernel uses: float32 as 3xTF32 (three TF32 products a product), bf16
    on the bf16 tensor cores.  The float32 CUDA-core bound is logged too."""
    import torch
    import torch.nn.functional as F
    B, H, KV, S, D, _, _ = SERVE_SHAPE
    q, k, v = flash_inputs(SERVE_SHAPE, dtype, dev, seed=1)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    fa_ops._launch(q, k, v, out, 0, 0.0, lse)
    dout = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))

    def fwd_bwd(fn):
        def run():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = fn(*leaves)
            torch.autograd.grad(o, leaves, dout)
        return run

    def sdpa(qq, kk, vv):
        return F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                              enable_gqa=True)

    r = dict(ms=cuda_ms(lambda: fa_ops._launch_backward(
        q, k, v, out, dout, lse, dq, dk, dv, 0, 0.0), 10))
    r["plain_ms"] = (cuda_ms(fwd_bwd(fa_ref.attention_ref), 3)
                     - cuda_ms(lambda: fa_ref.attention_ref(q, k, v), 3))
    try:
        r["library_ms"] = (cuda_ms(fwd_bwd(sdpa), 10)
                           - cuda_ms(lambda: sdpa(q, k, v), 10))
    except (TypeError, RuntimeError) as exc:       # no enable_gqa here
        log(f"timing: scaled_dot_product_attention unavailable: {exc}")
        r["library_ms"] = None
    size = q.element_size()
    ops = 5 * 2 * B * H * S * S * D / 2              # five causal products
    nbytes = (size * (4 * B * H * S * D + 4 * B * KV * S * D)
              + 4 * B * H * S)                       # + the float32 lse
    tensor_ops, rate = ((3 * ops, TF32_OPS_PER_S) if dtype == torch.float32
                        else (ops, BF16_OPS_PER_S))
    t_ops, t_bytes = 1e3 * tensor_ops / rate, 1e3 * nbytes / HBM_BYTES_PER_S
    r.update(ops=ops, tensor_ops=tensor_ops, bytes=nbytes,
             bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             cuda_core_bound_ms=1e3 * ops / F32_OPS_PER_S,
             tflops=ops / r["ms"] / 1e9)
    name = str(dtype).replace("torch.", "")
    if dtype == torch.bfloat16:
        r["hgmma"] = bwd_wgmma_sass(fa_ops, required=False)
    log(f"timing flash_attention_backward {list(SERVE_SHAPE[:5])} {name}: "
        f"{r['ms']!r} ms (plain {r['plain_ms']!r} ms, SDPA "
        f"{r['library_ms']!r} ms; bound {r['bound_ms']!r} ms by "
        f"{r['bound_by']}: {tensor_ops:.4g} tensor-core operations at "
        f"{rate / 1e12:g} TFLOP/s, {nbytes:.4g} bytes; float32 CUDA-core "
        f"bound {r['cuda_core_bound_ms']!r} ms); {r['tflops']!r} TFLOP/s "
        f"of the five products"
        + (f"; HGMMA in the SASS {r['hgmma']}" if "hgmma" in r else ""))
    del q, k, v, out, lse, dout, dq, dk, dv
    torch.cuda.empty_cache()
    return r


def dither_timing(dev, d_ops, d_ref, random):
    """The codec kernels at the trainer's leaf shapes (one block) by CUDA
    events, beside their plain versions and bounds: the u-taking encode
    (bytes: x and u read, levels written, 9 B an element), the keyed encode
    (5 B an element, but bound by the instructions of its main loop on the
    busiest pipe, read from the SASS of the library it runs:
    ``loop_clocks_per_element``) with the draw it replaces
    (``random.uniform``, timed alone), its split entries (the norm pass:
    4 B an element, beside ``torch.linalg.vector_norm(x, inf)``, one
    PyTorch call of the same function, timed only; the levels pass: the
    keyed encode's main loop, the same pipe bound), and the decode (5 B an
    element) beside ``torch.mul(levels.view(nb, -1), scale[:, None])``,
    one PyTorch call of the same function (timed only)."""
    import torch
    res = {}
    g = torch.Generator(device=dev).manual_seed(6)
    clocks, pipe, per, elems = loop_clocks_per_element(
        d_ops.LIBRARY.build(), KEYED_ENCODE_SASS)
    log(f"encode_keyed_kernel<float, true> main loop, {elems} elements a "
        f"trip, thread-instructions an element by pipe (SASS): "
        + ", ".join(f"{k} {v!r}" for k, v in per.items())
        + f"; bound {clocks!r} SM clocks an element on the {pipe} pipe")
    for R, C in LEAF_SHAPES:
        N = R * C
        x = torch.randn((R, C), generator=g, device=dev) * 1e-3
        u = torch.rand((R, C), generator=g, device=dev)
        lv, sc = d_ops.dither_encode(x, u, s=127.0, block_rows=R)
        res[("dither_encode", (R, C))] = dict(
            ms=cuda_ms(lambda: d_ops.dither_encode(x, u, s=127.0,
                                                   block_rows=R), 20),
            plain_ms=cuda_ms(lambda: d_ref.dither_encode_ref(x, u, 127.0, R),
                             3),
            library_ms=None, bytes=9 * N + 4, ops=8 * N, rate=F32_OPS_PER_S)
        del u
        key = random.fold_in(random.key(29, dev), 3)
        res[("dither_encode_keyed", (R, C))] = dict(
            ms=cuda_ms(lambda: d_ops.dither_encode_keyed(
                x, key, s=127.0, block_rows=R), 20),
            plain_ms=cuda_ms(lambda: d_ref.dither_encode_keyed_ref(
                x, key, 127.0, R), 3),
            draw_ms=cuda_ms(lambda: random.uniform(key, (R, C)), 3),
            library_ms=None, bytes=5 * N + 4 + 16,
            ops=clocks * N, rate=SM_CLOCKS_PER_S, pipe=pipe)
        bits = torch.zeros(1, dtype=torch.int32, device=dev)
        res[("dither_absmax", (R, C))] = dict(
            ms=cuda_ms(lambda: d_ops.dither_absmax_into(x, bits,
                                                        block_rows=R), 20),
            plain_ms=cuda_ms(lambda: d_ref.dither_absmax_into_ref(
                x, bits, R), 3),
            # one PyTorch call of the same function (timed only)
            library_ms=cuda_ms(lambda: torch.linalg.vector_norm(
                x, float("inf")), 20),
            bytes=4 * N + 4, ops=N, rate=F32_OPS_PER_S)
        res[("dither_levels_keyed", (R, C))] = dict(
            ms=cuda_ms(lambda: d_ops.dither_levels_keyed(
                x, key, bits, s=127.0, block_rows=R), 20),
            plain_ms=cuda_ms(lambda: d_ref.dither_levels_keyed_ref(
                x, key, bits, 127.0, R), 3),
            library_ms=None, bytes=5 * N + 4 + 16 + 4,
            ops=clocks * N, rate=SM_CLOCKS_PER_S, pipe=pipe)
        del bits
        res[("dither_decode", (R, C))] = dict(
            ms=cuda_ms(lambda: d_ops.dither_decode(lv, sc, block_rows=R), 20),
            plain_ms=cuda_ms(lambda: d_ref.dither_decode_ref(lv, sc, R), 3),
            # one PyTorch call of the same function (timed only)
            library_ms=cuda_ms(lambda: torch.mul(lv.view(1, -1),
                                                 sc[:, None]), 20),
            bytes=5 * N + 4, ops=N, rate=F32_OPS_PER_S)
        del x, lv, sc
        torch.cuda.empty_cache()
    for (name, shape), r in res.items():
        t_bytes = 1e3 * r["bytes"] / HBM_BYTES_PER_S
        t_ops = 1e3 * r.pop("ops") / r.pop("rate")
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        pipe = r.pop("pipe", None)
        ops_what = (f"{pipe}-pipe SM clocks" if pipe else "operations")
        draw = (f", the u draw alone {r['draw_ms']!r} ms" if "draw_ms" in r
                else "")
        log(f"timing {name} {list(shape)}: {r['ms']!r} ms (plain "
            f"{r['plain_ms']!r} ms{draw}, library {r['library_ms']!r} ms, "
            f"bound {r['bound_ms']!r} ms by {r['bound_by']}: bytes "
            f"{t_bytes!r} ms, {ops_what} {t_ops!r} ms)")
    return res


def phase_train_kernel_timing(dev, d_ops, d_ref, fa_ops, fa_ref, random):
    """The codec kernels at the trainer's leaf shapes (``dither_timing``)
    and the flash backward at the training shape in float32 and bfloat16,
    by CUDA events, beside their plain versions, their bounds and, for the
    backward, SDPA's backward (timed only)."""
    import torch
    res = dither_timing(dev, d_ops, d_ref, random)
    g = torch.Generator(device=dev).manual_seed(6)
    for dtype in (torch.float32, torch.bfloat16):
        res[("flash_attention_backward", dtype)] = flash_backward_timing(
            dev, dtype, fa_ops, fa_ref, g)
    return res


def topk_entry(entry, ttopk, rows_of) -> None:
    """Add topk_shape_timing's shapes whose row count ``rows_of`` takes to a
    kernels-line entry: times, library times, bounds, the instance each
    shape takes and both instances' times."""
    for shape, r in ttopk.items():
        if not rows_of(int(shape[1:].split(",")[0])):
            continue
        for key, field in (("ms_by_shape", "ms"),
                           ("library_ms_by_shape", "library_ms"),
                           ("bound_ms_by_shape", "bound_ms"),
                           ("instance_by_shape", "instance"),
                           ("cluster_ms_by_shape", "cluster_ms"),
                           ("grid_ms_by_shape", "grid_ms")):
            entry.setdefault(key, {})[shape] = r[field]


# ---------------------------------------------------------------------------
# Phase 10: the sketched-Hessian FLECS-CGD trainer (m = 2)
# ---------------------------------------------------------------------------

JVP_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_jvp.cu")
# no Pallas kernel: the reference takes attention's tangents by jax.jvp (of
# jax.grad) through chunked_attention, in XLA
JVP_REPLACES = "src/repro/models/attention.py:38"
#: The tangent kernels' shapes: tinyllama's training attention in the model
#: layout (as the trainer calls them) and in the kernel layout, ragged S
#: (S = 65 and 191: one past and one short of a 64-row tile, the latter
#: with a window smaller than a tile and a cap), a window, a cap, D = 32
#: and 128, S = 1: B, H, KV, S, D, window, cap, model layout.
JVP_SHAPES = [(8, 32, 4, 1024, 64, 0, 0.0, True),
              (8, 32, 4, 1024, 64, 0, 0.0, False),
              (2, 8, 2, 777, 64, 0, 0.0, True),
              (2, 8, 4, 300, 32, 64, 0.0, False),
              (1, 4, 1, 200, 128, 0, 30.0, True),
              (2, 4, 2, 129, 128, 33, 50.0, False),
              (1, 2, 2, 1, 32, 0, 0.0, False),
              (1, 4, 2, 65, 64, 0, 0.0, True),
              (2, 8, 2, 191, 64, 40, 20.0, False)]
#: Each tangent kernel's outputs within JVP_REL · max |t| (over the
#: kernel's outputs) of its plain version: the float32 backward's tolerance.
JVP_REL = 1e-5
#: FLECS-CGD with m = 2 sketch columns at launch/train.py's alpha (30 · lr).
FLECS_M, FLECS_M_ALPHA = 2, 3e-3 * 30
# full-width m = 2 steps of phase 10, cut from 3 to make room for phase 11
# and from 2 for phase 13
FLECS_M_STEPS = 1
#: Steps of phase 10's ``train_lm --flecs-m 2`` run (cut from 3 for phase
#: 13).
TRAIN_LM_STEPS = 2


def jvp_inputs(shape, dev, seed=0):
    """q, k, v, tq, tk, tv, dout, tdout (float32, on ``dev``) for a
    JVP_SHAPES entry, [B, H or KV, S, D]: views of the model layout
    [B, S, H, D] where the entry asks for it."""
    import torch
    B, H, KV, S, D, _, _, model = shape
    g = torch.Generator(device="cpu").manual_seed(seed)

    def one(h):
        t = torch.randn((B, S, h, D) if model else (B, h, S, D),
                        generator=g).to(dev)
        return t.transpose(1, 2) if model else t

    return [one(H), one(KV), one(KV), one(H), one(KV), one(KV), one(H),
            one(H)]


def launch_jvp(fa_ops, q, k, v, out, lse, tq, tk, tv, tout, tlse, window,
               cap):
    """The forward-tangent kernel of ``fa_ops``: since the tensor-core
    version it takes the forward's output; an earlier checkout's (timed
    beside this one by ``kernel_timing.py flash-jvp --root``) does not."""
    import inspect
    if "out" in inspect.signature(fa_ops._launch_jvp).parameters:
        fa_ops._launch_jvp(q, k, v, out, lse, tq, tk, tv, tout, tlse, window,
                           cap)
    else:
        fa_ops._launch_jvp(q, k, v, lse, tq, tk, tv, tout, tlse, window, cap)


#: Mangled-name fragment of the three tensor-core tangent kernels
#: (flash_attention_jvp.cu: fwd_tangent, bwd_tangent_dkdv, bwd_tangent_dq).
JVP_MMA_SASS = "tangent"


def jvp_mma_sass(fa_ops, required=True) -> dict:
    """HMMA instructions in the SASS of each tangent kernel (forward, dK/dV
    and dQ at D = 32, 64, 128), read with cuobjdump from the tangent
    library built; ``required``: fail unless all nine hold some, so a
    CUDA-core version cannot pass unseen."""
    counts = opcode_counts(sass_functions(fa_ops.JVP_LIBRARY.build()),
                           JVP_MMA_SASS, "HMMA")
    check(not required or (len(counts) == 9 and all(counts.values())),
          f"the tangent kernels hold no HMMA: {counts}")
    return counts


def launch_jvp_pair(fa_ops, q, k, v, tq, tk, tv, do, tdo, out, lse, tout,
                    tlse, window, cap):
    """Both tangent kernels on one set of inputs (out, lse, tout and tlse
    given, the plain version's): (tout, tlse) and (tdq, tdk, tdv)."""
    import torch
    got_to, got_tl = torch.empty_like(q), torch.empty_like(lse)
    launch_jvp(fa_ops, q, k, v, out, lse, tq, tk, tv, got_to, got_tl, window,
               cap)
    tdq, tdk, tdv = (torch.empty_like(t) for t in (q, k, v))
    fa_ops._launch_backward_jvp(q, k, v, out, do, lse, tq, tk, tv, tout,
                                tdo, tlse, tdq, tdk, tdv, window, cap)
    return (got_to, got_tl), (tdq, tdk, tdv)


def phase_flash_jvp(dev, fa_ops, fa_ref, need_mma=True):
    """Phase 10 (a): the forward- and backward-tangent kernels against
    their plain versions on the card, same inputs (out, lse, tO and t_lse
    from the plain forward tangent), at JVP_SHAPES; bitwise the same over
    two runs.  With ``need_mma`` the tangent kernels' SASS must hold HMMA
    (an earlier checkout timed beside this one has none).  Returns (max
    |Δ|, max |Δ| / max |t|) per kernel."""
    import torch
    hmma = jvp_mma_sass(fa_ops, need_mma)
    log(f"phase 10: HMMA instructions of the tangent kernels (SASS): "
        f"{hmma}")
    err = {"flash_attention_jvp": 0.0, "flash_attention_backward_jvp": 0.0}
    rel = dict(err)
    for shape in JVP_SHAPES:
        window, cap = shape[5], shape[6]
        q, k, v, tq, tk, tv, do, tdo = jvp_inputs(shape, dev, seed=4)
        out, tout, lse, tlse = fa_ref.attention_jvp_ref(q, k, v, tq, tk, tv,
                                                        window, cap)
        want_b = fa_ref.attention_backward_jvp_ref(
            q, k, v, out, do, lse, tq, tk, tv, tout, tdo, tlse, window, cap)
        args = (q, k, v, tq, tk, tv, do, tdo, out, lse, tout, tlse, window,
                cap)
        got_f, got_b = launch_jvp_pair(fa_ops, *args)
        again_f, again_b = launch_jvp_pair(fa_ops, *args)
        torch.cuda.synchronize()
        check(all(same_bits(a, b) for a, b in zip(got_f + got_b,
                                                  again_f + again_b)),
              f"the tangent kernels differ between two runs at {shape}")
        for name, got, want in (("flash_attention_jvp", got_f,
                                 (tout, tlse)),
                                ("flash_attention_backward_jvp", got_b,
                                 want_b)):
            scale = max(float(w.abs().max()) for w in want)
            e = max(abs_err(a, w) for a, w in zip(got, want))
            check(e <= JVP_REL * scale,
                  f"{name} differs from its plain version at {shape}: max "
                  f"|Δ| {e!r} beyond {JVP_REL} · {scale!r}")
            err[name] = max(err[name], e)
            rel[name] = max(rel[name], e / scale if scale else 0.0)
            log(f"phase 10: {name} {shape}: max |Δ| {e!r} "
                f"({e / scale if scale else 0.0!r} of max |t| {scale!r}); "
                f"bitwise equal over two runs")
        del q, k, v, tq, tk, tv, do, tdo, out, tout, lse, tlse, want_b
        del got_f, got_b, again_f, again_b
    torch.cuda.empty_cache()
    return err, rel


def flash_jvp_timing(dev, fa_ops, fa_ref):
    """The tangent kernels at the training shape (SERVE_SHAPE's attention,
    model layout) by CUDA events, beside their plain versions, with their
    bounds, as the float32 flash rows take theirs: the products the
    function needs a live (query, key) pair (forward tangent: S0, tS0's two
    products and tO's two, 10·D operations; backward tangent: S0, tS0, dP,
    tdP and two products for each of tdQ, tdK, tdV, 24·D) as 3xTF32 on the
    tensor cores (three TF32 operations each), and the 6·D a row for D and
    tD on the CUDA cores, against each input read once and each output
    written once (the forward tangent's inputs include the forward's
    output O).  No one PyTorch call computes attention's tangent (SDPA has
    no forward-mode rule of its own), so library_ms is null."""
    import torch
    shape = SERVE_SHAPE + (True,)
    B, H, KV, S, D = shape[:5]
    q, k, v, tq, tk, tv, do, tdo = jvp_inputs(shape, dev, seed=5)
    out, tout, lse, tlse = fa_ref.attention_jvp_ref(q, k, v, tq, tk, tv)
    got_to, got_tl = torch.empty_like(q), torch.empty_like(lse)
    tdq, tdk, tdv = (torch.empty_like(t) for t in (q, k, v))
    pairs = B * H * S * (S + 1) / 2
    q_elems, kv_elems, rows = B * H * S * D, B * KV * S * D, B * H * S
    res = {}
    for name, run, plain, products, row_ops, nbytes in (
            ("flash_attention_jvp",
             lambda: launch_jvp(fa_ops, q, k, v, out, lse, tq, tk, tv,
                                got_to, got_tl, 0, 0.0),
             lambda: fa_ref.attention_jvp_ref(q, k, v, tq, tk, tv),
             10 * D * pairs, 0, 4 * (4 * q_elems + 4 * kv_elems + 2 * rows)),
            ("flash_attention_backward_jvp",
             lambda: fa_ops._launch_backward_jvp(
                 q, k, v, out, do, lse, tq, tk, tv, tout, tdo, tlse, tdq,
                 tdk, tdv, 0, 0.0),
             lambda: fa_ref.attention_backward_jvp_ref(
                 q, k, v, out, do, lse, tq, tk, tv, tout, tdo, tlse),
             24 * D * pairs, 6 * D * rows,
             4 * (7 * q_elems + 6 * kv_elems + 2 * rows))):
        ops = products + row_ops
        r = dict(ms=cuda_ms(run, 10), plain_ms=cuda_ms(plain, 3),
                 library_ms=None, ops=ops, tensor_ops=3 * products,
                 bytes=nbytes)
        t_ops = 1e3 * max(3 * products / TF32_OPS_PER_S,
                          row_ops / F32_OPS_PER_S)
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        r.update(bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 tflops=ops / r["ms"] / 1e9)
        log(f"timing {name} {list(shape[:5])} float32: {r['ms']!r} ms "
            f"(plain {r['plain_ms']!r} ms; bound {r['bound_ms']!r} ms by "
            f"{r['bound_by']}: {3 * products:.4g} tensor-core operations at "
            f"{TF32_OPS_PER_S / 1e12:g} TFLOP/s, {nbytes:.4g} bytes); "
            f"{r['tflops']!r} TFLOP/s")
        res[name] = r
    del q, k, v, tq, tk, tv, do, tdo, out, tout, lse, tlse
    del got_to, got_tl, tdq, tdk, tdv
    torch.cuda.empty_cache()
    return res


def m2_step(cfg, dl_flecs, n=1):
    return dl_flecs.make_flecs_train_step(
        cfg, dl_flecs.FlecsDLConfig(alpha=FLECS_M_ALPHA, m=FLECS_M),
        remat=True, n_workers=n)


def record_y_messages(dl_flecs, n_leaves, on_y, fn):
    """Run ``fn()`` with ``dl_flecs.shared_scale_levels`` wrapped: each
    step's Y messages (every call after the step's first n_leaves, its
    gradient messages) go through ``on_y(inner, key, xs, s, group)``
    instead (xs: the workers' inputs, one here); returns what ``fn``
    returns."""
    inner = dl_flecs.shared_scale_levels
    calls = [0]

    def wrapped(key, xs, s, group=None):
        calls[0] += 1
        if (calls[0] - 1) % (n_leaves * (1 + FLECS_M)) < n_leaves:
            return inner(key, xs, s, group)
        return on_y(inner, key, xs, s, group)

    dl_flecs.shared_scale_levels = wrapped
    try:
        return fn()
    finally:
        dl_flecs.shared_scale_levels = inner


def m2_one_step(cfg, dl_flecs, params, b0, b1):
    """One m = 2 step from ``params`` on b0, then the new weights' loss on
    b1: (loss, next loss, uplink Mbit)."""
    import torch
    from repro_torch.train.step import _loss_fn
    new, _, m = m2_step(cfg, dl_flecs)(params, dl_flecs.init_shifts(params),
                                       b0, 0)
    with torch.no_grad():
        nxt = _loss_fn(new, b1, cfg)
    return float(m["loss"]), float(nxt), float(m["uplink_mbits"])


def m2_depth2_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(TINYLLAMA, smoke=False)
    return dataclasses.replace(cfg, n_layers=2, layer_plan=cfg.layer_plan[:2])


def phase_m2_depth2_card(train, dl_flecs, tree, path):
    """Phase 10 (b), the card's side: tinyllama-1.1b at full width and
    depth 2, batch DEPTH2_BATCH, one FLECS-CGD step with m = 2 (remat) from the
    weights of phase 8, then the loss of the new weights on the next batch;
    every Y message's key, input and int8 levels recorded.  Writes the
    weights, the batches and the messages to ``path`` (the CPU's side reads
    them) and returns the card's numbers."""
    import torch
    cfg, params = train.setup(TINYLLAMA, smoke=False, device="cuda",
                              n_layers=2)
    batches = train.token_batches(cfg, *DEPTH2_BATCH, params["embed"].device)
    b0, b1 = next(batches), next(batches)
    n_leaves = len(tree.tree_leaves(params))
    messages = []

    def on_y(inner, key, xs, s, group):
        levels, scale = inner(key, xs, s, group)
        messages.append((key.cpu(), xs[0].cpu(), levels[0].cpu(),
                         scale.cpu()))
        return levels, scale

    loss, loss_next, uplink = record_y_messages(
        dl_flecs, n_leaves, on_y,
        lambda: m2_one_step(cfg, dl_flecs, params, b0, b1))
    check(len(messages) == FLECS_M * n_leaves,
          f"depth 2 m = 2: {len(messages)} Y messages, expected "
          f"{FLECS_M * n_leaves}")
    torch.save({"params": to_cpu(params), "batches": [to_cpu(b0),
                                                      to_cpu(b1)],
                "messages": messages}, path)
    log(f"phase 10: depth 2 m = 2 on the card: loss {loss!r}, next loss "
        f"{loss_next!r}, uplink {uplink!r} Mbit, {len(messages)} Y messages "
        f"recorded")
    del params, messages
    torch.cuda.empty_cache()
    return dict(loss=loss, loss_next=loss_next, uplink_mbits=uplink)


def m2_cpu_job(path: str) -> dict:
    """Phase 10 (b), the CPU's side, in a worker process with every core:
    the same step from the card's weights, its Y messages' int8 levels
    against the card's (flips counted, by how many levels), and every card
    Y message replayed through the plain encode on the CPU with the same
    uniforms (drawn once for both)."""
    import os
    import torch
    from repro_torch import random
    from repro_torch.core import dl_flecs
    from repro_torch.kernels.dither import ref as d_ref
    from repro_torch import tree
    torch.set_num_threads(os.cpu_count() or 1)
    data = torch.load(path, weights_only=False)
    cfg = m2_depth2_cfg()
    params, (b0, b1), card = data["params"], data["batches"], \
        data["messages"]
    n_leaves = len(tree.tree_leaves(params))
    stats = dict(flips=0, total=0, max_flip=0, replay_differ=0,
                 messages=0)
    seen = [0]

    def on_y(inner, key, xs, s, group):
        (x,) = xs
        ckey, cx, clev, cscale = card[seen[0]]
        seen[0] += 1
        check(torch.equal(ckey, key), "depth 2 m = 2: the CPU's Y keys "
              "differ from the card's")
        rows, crows = x.reshape(-1, x.shape[-1]), cx.reshape(-1, x.shape[-1])
        u = random.uniform(key, tuple(rows.shape))
        levels, scale = d_ref.dither_encode_ref(rows, u, s, rows.shape[0])
        rl, rs = d_ref.dither_encode_ref(crows, u, s, crows.shape[0])
        if not (torch.equal(rl.reshape(clev.shape), clev)
                and same_bits(rs[0], cscale)):
            stats["replay_differ"] += 1
        d = (levels.reshape(clev.shape).int() - clev.int()).abs()
        stats["flips"] += int((d > 0).sum())
        stats["total"] += d.numel()
        stats["max_flip"] = max(stats["max_flip"], int(d.max()))
        stats["messages"] += 1
        return [levels.reshape(x.shape)], scale[0]

    t0 = time.perf_counter()
    loss, loss_next, uplink = record_y_messages(
        dl_flecs, n_leaves, on_y,
        lambda: m2_one_step(cfg, dl_flecs, params, b0, b1))
    return dict(loss=loss, loss_next=loss_next, uplink_mbits=uplink,
                seconds=time.perf_counter() - t0, **stats)


class StepSplit:
    """Wraps the trainer's parts so that each call's time (host clock
    between two synchronizes) adds to ``ms[part]``; ``close()`` unwraps.
    ``dl_flecs``'s gradient pass, HVP passes, sketch draws, FedSONIA, level
    sum and decode; the dither codec's fused encode, norm pass and levels
    pass (``kernels/dither/ops``); the norm's all-reduce
    (``core/driver``).  The rest of a step is the shift and parameter
    updates."""

    PARTS = (("dl_flecs", "value_and_grad", "gradient"),
             ("dl_flecs", "hvp_pytree", "hvp"),
             ("dl_flecs", "_sketch_signs", "sketch draws"),
             ("dl_flecs", "_fedsonia_tensor", "fedsonia"),
             ("d_ops", "dither_encode_keyed", "fused encode"),
             ("d_ops", "dither_absmax_into", "norm pass"),
             ("driver", "max_workers", "norm all-reduce"),
             ("d_ops", "dither_levels_keyed", "levels pass"),
             ("dl_flecs", "sum_levels", "level sum"),
             ("dl_flecs", "decode_int8", "decode"))

    def __init__(self, dl_flecs):
        import torch
        from repro_torch.core import driver
        from repro_torch.kernels.dither import ops as d_ops
        mods = {"dl_flecs": dl_flecs, "d_ops": d_ops, "driver": driver}
        self.saved = []
        self.ms = {part: 0.0 for _, _, part in self.PARTS}
        for mod, name, part in self.PARTS:
            fn = getattr(mods[mod], name)
            self.saved.append((mods[mod], name, fn))

            def timed(*a, _fn=fn, _part=part, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                self.ms[_part] += 1e3 * (time.perf_counter() - t0)
                return out

            setattr(mods[mod], name, timed)

    def take(self) -> dict:
        ms, self.ms = self.ms, {p: 0.0 for p in self.ms}
        return ms

    def close(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def m2_full_steps(train, cfg, params, rows, dl_flecs, fa_ops, d_ops, ops,
                  n=1, steps=None):
    """``steps`` (FLECS_M_STEPS) m = 2 steps of n workers at batch rows x
    TRAIN_BATCH[1] from ``params`` on one batch, the counters set to 0 just
    before: (losses, step ms, split ms a step, uplink Mbit, launches), or
    None if the card runs out of memory (the failed run's tensors are gone
    on return)."""
    import itertools
    import torch
    steps = steps or FLECS_M_STEPS
    batch = next(train.token_batches(cfg, rows, TRAIN_BATCH[1],
                                     params["embed"].device))
    step = m2_step(cfg, dl_flecs, n)
    shifts = dl_flecs.init_shifts(params, n)
    split = StepSplit(dl_flecs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counters(fa_ops, d_ops, ops)
    p, losses, step_ms, parts, uplink = params, [], [], [], None
    try:
        for i, b in zip(range(steps), itertools.repeat(batch)):
            t0 = time.perf_counter()
            p, shifts, met = step(p, shifts, b, i)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(met["loss"]))
            uplink = float(met["uplink_mbits"])
            parts.append(split.take())
            log(f"  m = 2, n = {n} step {i}: loss {losses[-1]!r}, "
                f"{step_ms[-1]!r} ms: {parts[-1]}")
    except torch.cuda.OutOfMemoryError as exc:
        log(f"batch {rows} x {TRAIN_BATCH[1]} at n = {n}, m = 2 does not "
            f"fit ({str(exc).splitlines()[0]})")
        return None
    finally:
        split.close()
    return losses, step_ms, parts, uplink, train_counters(fa_ops, d_ops,
                                                          ops)


def phase_m2_full(train, dl_flecs, fa_ops, d_ops, ops, tree):
    """Phase 10 (c): tinyllama-1.1b at full width, 22 layers, float32,
    remat, batch 8 x 1024 (cut to 4 x 1024 only if 8 does not fit): 3
    FLECS-CGD steps with m = 2 on one batch; the counters set to 0 just
    before and read just after; losses, step ms split into the gradient
    pass, the HVP passes, the sketch draws and FedSONIA (the rest: the
    codec and the update), peak memory, launches a step by kernel."""
    import torch
    cfg, params = train.setup(TINYLLAMA, smoke=False, device="cuda")
    L, n_leaves = cfg.n_layers, len(tree.tree_leaves(params))
    for rows in (TRAIN_BATCH[0], TRAIN_BATCH[0] // 2):
        out = m2_full_steps(train, cfg, params, rows, dl_flecs, fa_ops,
                            d_ops, ops)
        torch.cuda.empty_cache()
        if out is not None:
            break
    else:
        fail("full-width m = 2 does not fit even at batch 4 x 1024")
    losses, step_ms, parts, uplink, counts = out
    peak = torch.cuda.max_memory_allocated()
    m = FLECS_M
    per_step = {"flash_attention": 2 * L * (1 + m),
                "flash_attention_backward": L * (1 + m),
                "flash_attention_jvp": 2 * L * m,
                "flash_attention_backward_jvp": L * m,
                "dither_encode": 0, "dither_absmax": 0,
                "dither_levels_keyed": 0,
                "dither_encode_keyed": n_leaves * (1 + m),
                "dither_decode": n_leaves * (1 + m),
                "dither_bits": n_leaves * (1 + m)}
    check_launches("full-width m = 2", counts, per_step, FLECS_M_STEPS)
    check(all(map(math.isfinite, losses)),
          f"full-width m = 2: losses not finite: {losses}")
    res = dict(batch=[rows, TRAIN_BATCH[1]], losses=losses, step_ms=step_ms,
               split_ms=parts, peak_gib=peak / 2**30, launches=counts,
               launches_per_step={k: v / FLECS_M_STEPS
                                  for k, v in counts.items()},
               uplink_mbits=uplink)
    log(f"phase 10: {TINYLLAMA} x{L} f32 remat, batch {rows} x "
        f"{TRAIN_BATCH[1]}, FLECS-CGD m = {m} x{FLECS_M_STEPS}: losses "
        f"{losses}; step ms {step_ms}; split {parts}; peak "
        f"{peak / 2**30!r} GiB; launches per step "
        f"{res['launches_per_step']}")
    del params
    torch.cuda.empty_cache()
    return res


def phase_m2_driver(dl_flecs, fa_ops, d_ops, ops, tmp):
    """Phase 10 (d): ``python -m repro_torch.train_lm --flecs --flecs-m 2
    --steps TRAIN_LM_STEPS --checkpoint DIR`` at its defaults
    (tinyllama-1.1b at full width, batch 8 x 128, no remat), DIR under
    ``tmp``; the counters set to 0 just before and read just after; then
    the checkpoint restored onto the card, bit for bit the run's last
    weights, at step TRAIN_LM_STEPS."""
    import torch
    from repro_torch import train_lm
    from repro_torch.checkpoint import store
    from repro_torch.tree import tree_leaves
    ckpt = tmp / "train_lm_ckpt"
    reset_train_counters(fa_ops, d_ops, ops)
    t0 = time.perf_counter()
    out = train_lm.main(["--flecs", "--flecs-m", str(FLECS_M), "--steps",
                         str(TRAIN_LM_STEPS), "--checkpoint", str(ckpt)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = train_counters(fa_ops, d_ops, ops)
    for name in ("flash_attention", "flash_attention_backward",
                 "flash_attention_jvp", "flash_attention_backward_jvp",
                 "dither_encode_keyed", "dither_decode", "dither_bits"):
        check(counts[name] > 0, f"train_lm --flecs-m 2: {name} never "
              f"launched")
    losses = [m["loss"] for m in out["metrics"]]
    check(all(map(math.isfinite, losses)),
          f"train_lm --flecs-m 2: losses not finite: {losses}")
    t1 = time.perf_counter()
    restored, step = store.restore(ckpt, out["params"])
    restore_s = time.perf_counter() - t1
    check(step == TRAIN_LM_STEPS, f"train_lm checkpoint: step {step}, "
          f"expected {TRAIN_LM_STEPS}")
    check(all(a.device == b.device and same_bits(a, b) for a, b in zip(
        tree_leaves(restored), tree_leaves(out["params"]))),
        "train_lm checkpoint: the restored weights are not the saved ones")
    nbytes = sum(f.stat().st_size for f in ckpt.iterdir())
    log(f"phase 10: train_lm --flecs --flecs-m 2 --steps {TRAIN_LM_STEPS} "
        f"--checkpoint: "
        f"losses {losses}, {seconds!r} s with the save; checkpoint "
        f"{nbytes / 2**30!r} GiB restored bit for bit in {restore_s!r} s; "
        f"launches {counts}")
    del out, restored
    torch.cuda.empty_cache()
    return dict(losses=losses, seconds=seconds, restore_s=restore_s,
                checkpoint_gib=nbytes / 2**30, launches=counts)


#: The CPU's Y levels may differ from the card's at no more than this share
#: of the elements, by one level (phase 8's bound for the gradients').
Y_LEVEL_SHARE = LEVEL_SHARE


def phase_flecs_m2(dev, train, dl_flecs, fa_ops, fa_ref, d_ops, ops, tree,
                   meanwhile=None):
    """Phase 10: the sketched-Hessian FLECS-CGD trainer, m = 2.  (b)'s
    card side first; its CPU side then runs in a spawned worker process
    with every core while the card runs (a), (c) and (d), times the
    tangent kernels and runs ``meanwhile()`` (card work of other phases
    that does not read the host clock); then (b)'s comparison: losses within LOSS_REL, uplink
    equal, every card Y message its CPU replay, the Y levels' flips at no
    more than Y_LEVEL_SHARE of the elements and by one level."""
    import multiprocessing
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    tmp = Path(tempfile.mkdtemp(prefix="_smoke_tmp_", dir=ROOT))
    try:
        card2 = phase_m2_depth2_card(train, dl_flecs, tree,
                                     tmp / "depth2.pt")
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
                "spawn")) as pool:
            cpu_side = pool.submit(m2_cpu_job, str(tmp / "depth2.pt"))
            err, rel = phase_flash_jvp(dev, fa_ops, fa_ref)
            full = phase_m2_full(train, dl_flecs, fa_ops, d_ops, ops, tree)
            drv = phase_m2_driver(dl_flecs, fa_ops, d_ops, ops, tmp)
            timing = flash_jvp_timing(dev, fa_ops, fa_ref)
            if meanwhile is not None:
                meanwhile()
            t0 = time.perf_counter()
            cpu2 = cpu_side.result()
            waited = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for key in ("loss", "loss_next"):
        check(abs(card2[key] - cpu2[key]) <= LOSS_REL * abs(cpu2[key]),
              f"depth 2 m = 2: {key} {card2[key]!r} (card) and "
              f"{cpu2[key]!r} (CPU) beyond rtol {LOSS_REL}")
    check(card2["uplink_mbits"] == cpu2["uplink_mbits"],
          f"depth 2 m = 2: uplink {card2['uplink_mbits']!r} (card) and "
          f"{cpu2['uplink_mbits']!r} (CPU)")
    check(cpu2["replay_differ"] == 0,
          f"depth 2 m = 2: {cpu2['replay_differ']} of {cpu2['messages']} "
          f"card Y messages are not their CPU replay")
    check(cpu2["max_flip"] <= 1
          and cpu2["flips"] <= Y_LEVEL_SHARE * cpu2["total"],
          f"depth 2 m = 2: Y levels differ at {cpu2['flips']} of "
          f"{cpu2['total']} elements, by up to {cpu2['max_flip']}")
    log(f"phase 10: depth 2 m = 2, card against CPU: losses "
        f"{card2['loss']!r} / {cpu2['loss']!r}, next {card2['loss_next']!r}"
        f" / {cpu2['loss_next']!r}; uplink {card2['uplink_mbits']!r} Mbit "
        f"both; {cpu2['messages']} Y messages, each its CPU replay; Y levels"
        f" differ at {cpu2['flips']} of {cpu2['total']} elements, by at "
        f"most {cpu2['max_flip']}; the CPU side took {cpu2['seconds']!r} s "
        f"({waited!r} s waited for)")
    return dict(depth2=dict(card=card2, cpu=cpu2, waited_s=waited),
                jvp_err=err, jvp_rel=rel, full=full, driver=drv,
                timing=timing)



# ---------------------------------------------------------------------------
# Slice 14: the multi-worker FLECS-CGD trainer
# ---------------------------------------------------------------------------

#: Phase 11's federations: n workers at m = 0 (and its steps), at m = 2
#: (and its steps, cut from 2 for phase 13), and the depth-2
#: card-against-CPU run's batch (cut from 4 x 256 for phase 13) and steps.
WORKERS_N, WORKERS_STEPS = 4, 3
WORKERS_M2_N, WORKERS_M2_STEPS = 2, 1
WORKERS_DEPTH2_BATCH, WORKERS_DEPTH2_STEPS = (4, 128), 1


def workers_launches(n, n_leaves, L, m=0) -> dict:
    """The kernel launches of one step of n workers: every worker's
    forwards (remat recomputes them), backwards and, with m > 0, tangents;
    the split encode entries once per message and worker (a message a leaf
    and, with m > 0, a leaf and column), the decode once per gradient
    message and worker, the bits kernel once per message."""
    return {"flash_attention": 2 * L * (1 + m) * n,
            "flash_attention_backward": L * (1 + m) * n,
            "flash_attention_jvp": 2 * L * m * n,
            "flash_attention_backward_jvp": L * m * n,
            "dither_encode": 0, "dither_encode_keyed": 0,
            "dither_absmax": n_leaves * (1 + m) * n,
            "dither_levels_keyed": n_leaves * (1 + m) * n,
            "dither_decode": n_leaves * n,
            "dither_bits": n_leaves * (1 + m)}


def workers_run(train, cfg, params, batch):
    """WORKERS_DEPTH2_STEPS FLECS-CGD steps of WORKERS_N workers from
    ``params`` through ``launch/train.train`` on the launcher's stream at
    ``batch`` (rows, seq) on the params' device, then the new weights' loss
    on the stream's next batch (``loss_next``)."""
    import torch
    from repro_torch.train.step import _loss_fn
    batches = train.token_batches(cfg, *batch, params["embed"].device)
    out = train.train(cfg, params, batches, WORKERS_DEPTH2_STEPS, flecs=True,
                      workers=WORKERS_N)
    with torch.no_grad():
        out["loss_next"] = float(_loss_fn(out["params"], next(batches), cfg))
    return out


def workers_depth2_card(train, dl_flecs, tree, path):
    """Phase 11 (a), the card's side: tinyllama-1.1b at full width and
    depth 2, batch WORKERS_DEPTH2_BATCH, WORKERS_DEPTH2_STEPS FLECS-CGD steps of 4
    workers (m = 0) through ``launch/train.train``, then the new weights'
    loss on the next batch (``workers_run``); step 0's gradient messages
    (key, every worker's input, levels and the shared scale) recorded.  Writes the config, the batch shape, the initial weights and
    the messages to ``path`` (the CPU's side reads them) and returns
    (config, weights, the card's run)."""
    import torch
    cfg, params = train.setup(TINYLLAMA, smoke=False, device="cuda",
                              n_layers=2)
    n_leaves = len(tree.tree_leaves(params))
    messages = []
    inner = dl_flecs.shared_scale_levels

    def recorded(key, xs, s, group=None):
        levels, scale = inner(key, xs, s, group)
        if len(messages) < n_leaves:
            messages.append((key.cpu(), [x.cpu() for x in xs],
                             [lv.cpu() for lv in levels], scale.cpu(), s))
        return levels, scale

    dl_flecs.shared_scale_levels = recorded
    try:
        out = workers_run(train, cfg, params, WORKERS_DEPTH2_BATCH)
    finally:
        dl_flecs.shared_scale_levels = inner
    check(len(messages) == n_leaves,
          f"depth 2 n = {WORKERS_N}: {len(messages)} messages recorded")
    torch.save({"cfg": cfg, "batch": WORKERS_DEPTH2_BATCH,
                "params": to_cpu(params), "messages": messages}, path)
    log(f"phase 11: depth 2, {WORKERS_N} workers on the card: losses "
        f"{[m['loss'] for m in out['metrics']]}, next {out['loss_next']!r}, "
        f"uplink "
        f"{out['metrics'][0]['uplink_mbits']!r} Mbit; {n_leaves} messages "
        f"of {WORKERS_N} workers recorded")
    return cfg, params, out


def workers_cpu_job(path: str) -> dict:
    """Phase 11 (a), the CPU's side, in a worker process with every core:
    every card message replayed through the plain split entries on the CPU
    (the norm over the card's inputs of every worker, each worker's levels
    from it under the same uniforms, drawn once a message); then the same
    run from the card's weights on the CPU, its step-0 levels against the
    card's (flips counted, by how many levels)."""
    import os
    import torch
    from repro_torch import random
    from repro_torch.core import dl_flecs
    from repro_torch.kernels.dither import ref as d_ref
    from repro_torch.launch import train
    torch.set_num_threads(os.cpu_count() or 1)
    data = torch.load(path, weights_only=False)
    cfg, params, card = data["cfg"], data["params"], data["messages"]
    t0 = time.perf_counter()
    stats = dict(replay_differ=0, messages=0, flips=0, total=0, max_flip=0)
    for key, xs, levels, scale, s in card:
        rows = [x.reshape(-1, x.shape[-1]) for x in xs]
        bits = torch.zeros(1, dtype=torch.int32)
        for r in rows:
            d_ref.dither_absmax_into_ref(r, bits, r.shape[0])
        u = random.uniform(key, tuple(rows[0].shape))
        for r, lv in zip(rows, levels):
            rl, rs = d_ref.dither_levels_ref(r, u, bits, s, r.shape[0])
            if not (torch.equal(rl.reshape(lv.shape), lv)
                    and same_bits(rs[0], scale)):
                stats["replay_differ"] += 1
        stats["messages"] += 1
    replay_s = time.perf_counter() - t0
    seen = [0]
    inner = dl_flecs.shared_scale_levels

    def compared(key, xs, s, group=None):
        levels, scale = inner(key, xs, s, group)
        if seen[0] < len(card):
            for lv, clv in zip(levels, card[seen[0]][2]):
                d = (lv.int() - clv.int()).abs()
                stats["flips"] += int((d > 0).sum())
                stats["total"] += d.numel()
                stats["max_flip"] = max(stats["max_flip"], int(d.max()))
            seen[0] += 1
        return levels, scale

    dl_flecs.shared_scale_levels = compared
    t1 = time.perf_counter()
    try:
        out = workers_run(train, cfg, params, data["batch"])
    finally:
        dl_flecs.shared_scale_levels = inner
    return dict(metrics=out["metrics"], loss_next=out["loss_next"],
                replay_s=replay_s, run_s=time.perf_counter() - t1, **stats)


def workers_nccl(dl_flecs, cfg, params, card_out, tree):
    """Phase 11 (d): the depth-2 run of (a) again over a NCCL
    ``WorkerGroup`` at world size 1 (4 workers in the one rank: the norm
    and the level sums through ``all_reduce``), every param and shift leaf
    and the metrics bit for bit the run without a group."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import driver
    from repro_torch.launch import train
    group = driver.worker_group(1, 0, f"tcp://localhost:{_free_port()}",
                                backend="nccl")
    try:
        step = dl_flecs.make_flecs_train_step(
            cfg, dl_flecs.FlecsDLConfig(alpha=FLECS_M_ALPHA), remat=True,
            n_workers=WORKERS_N, group=group)
        p, s = params, dl_flecs.init_shifts(params, WORKERS_N)
        batches = train.token_batches(cfg, *WORKERS_DEPTH2_BATCH,
                                      params["embed"].device)
        metrics = []
        for i in range(WORKERS_DEPTH2_STEPS):
            p, s, m = step(p, s, next(batches), i)
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    check(metrics == card_out["metrics"],
          f"NCCL world size 1: metrics {metrics} differ from the run "
          f"without a group, {card_out['metrics']}")
    check(len(metrics) == WORKERS_DEPTH2_STEPS, "NCCL world size 1: steps")
    for what, a, b in (("params", p, card_out["params"]),
                       ("shifts", s, card_out["state"])):
        la, lb = tree.tree_leaves(a), tree.tree_leaves(b)
        check(len(la) == len(lb) and all(same_bits(x, y)
                                         for x, y in zip(la, lb)),
              f"NCCL world size 1: the {what} differ from the run without "
              f"a group")
    log(f"phase 11: depth 2, {WORKERS_N} workers over NCCL at world size 1 "
        f"x{WORKERS_DEPTH2_STEPS}: every param and shift leaf and the "
        f"metrics bit for bit the run without a group")
    return metrics


def workers_full_m0(train, dl_flecs, cfg, params, fa_ops, d_ops, ops,
                    n_leaves):
    """Phase 11 (b): tinyllama-1.1b at full width, 22 layers, float32,
    remat, global batch 8 x 1024: WORKERS_STEPS FLECS-CGD steps (m = 0) of
    WORKERS_N workers (2 x 1024 each) on one batch through
    ``launch/train.train``; the counters set to 0 just before and read
    just after; losses, step ms, the split (``StepSplit``), peak."""
    import itertools
    import torch
    batch = next(train.token_batches(cfg, *TRAIN_BATCH,
                                     params["embed"].device))
    split = StepSplit(dl_flecs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counters(fa_ops, d_ops, ops)
    try:
        out = train.train(cfg, params, itertools.repeat(batch),
                          WORKERS_STEPS, flecs=True, workers=WORKERS_N,
                          log=lambda s: log(f"  n = {WORKERS_N} {s}"))
        torch.cuda.synchronize()
    finally:
        split.close()
    counts = train_counters(fa_ops, d_ops, ops)
    peak = torch.cuda.max_memory_allocated()
    parts = {k: v / WORKERS_STEPS for k, v in split.take().items()}
    losses = [m["loss"] for m in out["metrics"]]
    check_launches(f"full-width n = {WORKERS_N}", counts, workers_launches(
        WORKERS_N, n_leaves, cfg.n_layers), WORKERS_STEPS)
    check(all(map(math.isfinite, losses)),
          f"full-width n = {WORKERS_N}: losses not finite: {losses}")
    res = dict(batch=list(TRAIN_BATCH), workers=WORKERS_N, losses=losses,
               step_ms=out["step_ms"], split_ms_per_step=parts,
               peak_gib=peak / 2**30, launches=counts,
               uplink_mbits=out["metrics"][-1]["uplink_mbits"])
    log(f"phase 11: {TINYLLAMA} x{cfg.n_layers} f32 remat, batch "
        f"{TRAIN_BATCH[0]} x {TRAIN_BATCH[1]}, FLECS-CGD m = 0, "
        f"{WORKERS_N} workers x{WORKERS_STEPS}: losses {losses}; step ms "
        f"{out['step_ms']}; split a step {parts}; peak {peak / 2**30!r} "
        f"GiB; uplink {res['uplink_mbits']!r} Mbit; launches {counts}")
    del out
    torch.cuda.empty_cache()
    return res


def workers_full_m2(train, dl_flecs, cfg, params, fa_ops, d_ops, ops,
                    n_leaves):
    """Phase 11 (c): as (b) with m = 2 and WORKERS_M2_N workers,
    WORKERS_M2_STEPS steps at global batch 8 x 1024 (cut to 4 x 1024 only
    if 8 does not fit), the step split by ``StepSplit``."""
    import torch
    for rows in (TRAIN_BATCH[0], TRAIN_BATCH[0] // 2):
        out = m2_full_steps(train, cfg, params, rows, dl_flecs, fa_ops,
                            d_ops, ops, n=WORKERS_M2_N,
                            steps=WORKERS_M2_STEPS)
        torch.cuda.empty_cache()
        if out is not None:
            break
    else:
        fail(f"full-width m = 2 at n = {WORKERS_M2_N} does not fit even at "
             f"batch 4 x 1024")
    losses, step_ms, parts, uplink, counts = out
    peak = torch.cuda.max_memory_allocated()
    check_launches(f"full-width m = 2 n = {WORKERS_M2_N}", counts,
                   workers_launches(WORKERS_M2_N, n_leaves, cfg.n_layers,
                                    FLECS_M), WORKERS_M2_STEPS)
    check(all(map(math.isfinite, losses)),
          f"full-width m = 2 n = {WORKERS_M2_N}: losses not finite: "
          f"{losses}")
    res = dict(batch=[rows, TRAIN_BATCH[1]], workers=WORKERS_M2_N,
               losses=losses, step_ms=step_ms, split_ms=parts,
               peak_gib=peak / 2**30, launches=counts, uplink_mbits=uplink)
    log(f"phase 11: {TINYLLAMA} x{cfg.n_layers} f32 remat, batch {rows} x "
        f"{TRAIN_BATCH[1]}, FLECS-CGD m = {FLECS_M}, {WORKERS_M2_N} workers "
        f"x{WORKERS_M2_STEPS}: losses {losses}; step ms {step_ms}; split "
        f"{parts}; peak {peak / 2**30!r} GiB; uplink {uplink!r} Mbit")
    return res


def phase_flecs_workers(train, dl_flecs, fa_ops, d_ops, ops, tree,
                        meanwhile=None):
    """Phase 11: the multi-worker FLECS-CGD trainer.  (a)'s card side
    first; (a)'s CPU side then runs in a spawned worker process with every
    core while the card runs (d), (b), (c) and ``meanwhile()`` (card work
    of another phase); then (a)'s comparison:
    losses within LOSS_REL and uplink equal every step, every card message
    of every worker its CPU replay, the CPU's own step-0 levels differing
    from the card's at no more than LEVEL_SHARE of the elements and by one
    level."""
    import multiprocessing
    import shutil
    import tempfile
    import torch
    from concurrent.futures import ProcessPoolExecutor
    tmp = Path(tempfile.mkdtemp(prefix="_smoke_tmp_", dir=ROOT))
    try:
        cfg2, params2, card = workers_depth2_card(train, dl_flecs, tree,
                                                  tmp / "workers.pt")
        card_metrics, card_next = card["metrics"], card["loss_next"]
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
                "spawn")) as pool:
            cpu_side = pool.submit(workers_cpu_job, str(tmp / "workers.pt"))
            nccl = workers_nccl(dl_flecs, cfg2, params2, card, tree)
            del params2, card
            torch.cuda.empty_cache()
            cfg, params = train.setup(TINYLLAMA, smoke=False, device="cuda")
            n_leaves = len(tree.tree_leaves(params))
            m0 = workers_full_m0(train, dl_flecs, cfg, params, fa_ops, d_ops,
                                 ops, n_leaves)
            m2 = workers_full_m2(train, dl_flecs, cfg, params, fa_ops, d_ops,
                                 ops, n_leaves)
            del params
            torch.cuda.empty_cache()
            if meanwhile is not None:
                meanwhile()
            t0 = time.perf_counter()
            cpu = cpu_side.result()
            waited = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card_losses = [m["loss"] for m in card_metrics] + [card_next]
    cpu_losses = [m["loss"] for m in cpu["metrics"]] + [cpu["loss_next"]]
    for i, (a, b) in enumerate(zip(card_losses, cpu_losses)):
        check(abs(a - b) <= LOSS_REL * abs(b),
              f"depth 2 n = {WORKERS_N} loss {i}: {a!r} (card) and {b!r} "
              f"(CPU) beyond rtol {LOSS_REL}")
    for i, (a, b) in enumerate(zip(card_metrics, cpu["metrics"])):
        check(a["uplink_mbits"] == b["uplink_mbits"],
              f"depth 2 n = {WORKERS_N} step {i}: uplink "
              f"{a['uplink_mbits']!r} (card) and {b['uplink_mbits']!r} (CPU)")
    check(cpu["replay_differ"] == 0,
          f"depth 2 n = {WORKERS_N}: {cpu['replay_differ']} of "
          f"{cpu['messages']} card messages are not their CPU replay")
    check(cpu["max_flip"] <= 1 and cpu["flips"] <= LEVEL_SHARE * cpu["total"],
          f"depth 2 n = {WORKERS_N}: step-0 levels differ at {cpu['flips']} "
          f"of {cpu['total']} elements, by up to {cpu['max_flip']}")
    log(f"phase 11: depth 2, {WORKERS_N} workers, card against CPU: losses "
        f"and the next batch's {card_losses} / {cpu_losses}; uplink equal "
        f"every step; "
        f"{cpu['messages']} messages of {WORKERS_N} workers, each its CPU "
        f"replay ({cpu['replay_s']!r} s); step-0 levels differ at "
        f"{cpu['flips']} of {cpu['total']} elements, by at most "
        f"{cpu['max_flip']}; the CPU run took {cpu['run_s']!r} s "
        f"({waited!r} s waited for)")
    return dict(depth2=dict(card=card_metrics, card_loss_next=card_next,
                            cpu=cpu, waited_s=waited),
                nccl=nccl, n4_m0=m0, n2_m2=m2)


# ---------------------------------------------------------------------------
# Slice 15: the other model families (MLA, MoE, SSD, RG-LRU, VLM, audio)
# ---------------------------------------------------------------------------

#: The flash forward's instances at the families' shapes: B, H, KV, S, Dk,
#: Dv, window, cap; gemma2-9b's local layer (window 4096, cap 50),
#: recurrentgemma-9b's (KV 1, window 2048, past it at S = 3072) and
#: deepseek-v3's MLA (192 / 128), then ragged lengths of each pair.
FAMILY_FLASH_SHAPES = [(8, 16, 8, 1024, 256, 256, 4096, 50.0),
                       (4, 16, 1, 3072, 256, 256, 2048, 0.0),
                       (8, 128, 128, 1024, 192, 128, 0, 0.0)]
FAMILY_FLASH_RAGGED = [(2, 4, 2, 200, 256, 256, 0, 50.0),
                       (1, 4, 1, 300, 256, 256, 70, 0.0),
                       (2, 4, 4, 200, 192, 128, 0, 0.0)]
#: Phase 12 (a): the families at smoke width, card against CPU; gemma2 at
#: the (256, 256) pair.  (arch, config overrides).
FAMILY_SMOKE = (("mamba2-1.3b", {}), ("recurrentgemma-9b", {}),
                ("deepseek-v3-671b", {}), ("qwen3-moe-235b-a22b", {}),
                ("llava-next-mistral-7b", {}), ("musicgen-large", {}),
                ("gemma2-9b", {"head_dim": 256}))
#: Phase 12 (b): full width, the depth cut where the card or the time limit
#: forces one: (arch, layers (0: all), dtype, batch, prompt, decode steps;
#: the steps halved from 32 and 16 for phase 13).
FAMILY_FULL = (("mamba2-1.3b", 0, "float32", 8, 1024, 16),
               ("recurrentgemma-9b", 3, "float32", 4, 3072, 16),
               ("gemma2-9b", 2, "float32", 8, 1024, 16),
               ("deepseek-v3-671b", 4, "bfloat16", 8, 1024, 8),
               ("qwen3-moe-235b-a22b", 2, "bfloat16", 8, 1024, 8),
               ("llava-next-mistral-7b", 2, "float32", 4, 3072, 8),
               ("musicgen-large", 0, "float32", 8, 1024, 16))


def flash_pair_inputs(shape, dtype, dev, seed=0):
    """q, k, v of a (Dk, Dv) shape, drawn on the card (a CPU draw of
    MLA's 200 M-element q takes seconds)."""
    import torch
    B, H, KV, S, Dk, Dv, _, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in ((B, H, S, Dk), (B, KV, S, Dk), (B, KV, S, Dv))]


def live_pairs(S: int, window: int) -> int:
    """(query, key) pairs the causal mask, and the window, leave."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def family_fwd_timing(dev, fa_ops, fa_ref, shape, q, k, v,
                      kernel=None) -> dict:
    """One family shape's forward timed by CUDA events (``kernel``: the
    ``ops.FWD_KERNELS`` name to force, else the route's own) beside the
    plain version and SDPA (null under a soft-cap), with its bound: the
    live pairs' products as 3xTF32 or bf16 against q, k, v and the output
    read or written once."""
    import torch
    import torch.nn.functional as F
    B, H, KV, S, Dk, Dv, window, cap = shape
    name = str(q.dtype).replace("torch.", "")
    r = {}
    if kernel is None:
        r["ms"] = cuda_ms(lambda: fa_ops.flash_attention(
            q, k, v, window, cap), 10)
    else:
        out = torch.empty((B, H, S, Dv), dtype=q.dtype, device=dev)
        r["ms"] = cuda_ms(lambda: fa_ops._launch(
            q, k, v, out, window, cap, kernel=kernel), 10)
        del out
    r["plain_ms"] = cuda_ms(lambda: fa_ref.attention_ref(
        q, k, v, window, cap), 3)
    if cap:
        r["library_ms"] = None      # SDPA has no soft-cap
    else:
        mask = None
        if window and window < S:
            i = torch.arange(S, device=dev)
            mask = ((i[:, None] >= i[None, :])
                    & (i[:, None] - i[None, :] < window))
        try:
            r["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask,
                    is_causal=mask is None, enable_gqa=True), 10)
        except (TypeError, RuntimeError) as exc:
            log(f"timing: scaled_dot_product_attention at "
                f"{shape} {name} unavailable: {exc}")
            r["library_ms"] = None
    ops = 2 * B * H * live_pairs(S, window) * (Dk + Dv)
    nbytes = q.element_size() * (B * H * S * (Dk + Dv)
                                  + B * KV * S * (Dk + Dv))
    tensor_ops, rate = ((3 * ops, TF32_OPS_PER_S)
                        if q.dtype == torch.float32
                        else (ops, BF16_OPS_PER_S))
    t_ops = 1e3 * tensor_ops / rate
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    r.update(bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             ops=ops, bytes=nbytes)
    log(f"timing flash_attention {shape} {name}"
        f"{'' if kernel is None else ' on ' + kernel}: {r['ms']!r} ms "
        f"(plain {r['plain_ms']!r} ms, SDPA {r['library_ms']!r} "
        f"ms; bound {r['bound_ms']!r} ms by {r['bound_by']})")
    return r


def check_forward(fa_ops, fa_ref, shape, q, k, v, kernel=None) -> float:
    """The forward (``kernel`` forced, else the route's own) against its
    plain version on the same inputs: rtol = atol = 2e-5 in float32, 2e-2
    in bf16 (row 7's), the same bits over two runs, q's type and [B, H, S,
    Dv]; where the checkout routes by ``forward_plan``, the launch went
    to the kernel named.  Returns max |Δ|."""
    import torch
    B, H, KV, S, Dk, Dv, window, cap = shape
    dtype = q.dtype

    def run():
        if kernel is None:
            return fa_ops.flash_attention(q, k, v, window, cap)
        out = torch.empty((B, H, S, Dv), dtype=dtype, device=q.device)
        fa_ops._launch(q, k, v, out, window, cap, kernel=kernel)
        return out

    counts = getattr(fa_ops, "forward_launches_by_kernel", None)
    before = dict(counts) if counts is not None else None
    got = run()
    again = run()
    torch.cuda.synchronize()
    if counts is not None:
        want_kernel = kernel or fa_ops.forward_plan(dtype, Dk, Dv)
        check(counts[want_kernel] - before[want_kernel] == 2,
              f"flash_attention at {shape} {dtype}: {counts} launches by "
              f"kernel (before {before}), expected 2 more on {want_kernel}")
    check(same_bits(got, again), f"flash_attention differs between "
          f"two runs at {shape} {dtype}")
    want = fa_ref.attention_ref(q, k, v, window, cap)
    check(got.dtype == dtype and got.shape == (B, H, S, Dv),
          f"flash_attention returned {got.dtype} {tuple(got.shape)}")
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    gf, wf = got.float(), want.float()
    e = max_abs_err(gf, wf)
    check(bool(((gf - wf).abs() <= tol + tol * wf.abs()).all()),
          f"flash_attention differs from its plain version at "
          f"{shape} {dtype}: max |Δ| {e!r} beyond rtol=atol={tol}")
    return e


def phase_flash_families(dev, fa_ops, fa_ref, need_wgmma=True):
    """Phase 2, the flash forward's family instances: (256, 256) and MLA's
    (192, 128), float32 (3xTF32) and bfloat16 (at (192, 128) the wgmma
    kernel, ``ops.forward_plan``), against the plain version on the card
    (``check_forward``) at the families' shapes and ragged lengths; then
    each family shape timed (``family_fwd_timing``).  With ``need_wgmma``
    the wgmma forward's SASS must hold HGMMA (``fwd_wgmma_sass``; an
    earlier checkout timed beside this one has no such kernel)."""
    import torch
    if need_wgmma:
        log(f"phase 2: HGMMA instructions of the bf16 forward on wgmma "
            f"(SASS): {fwd_wgmma_sass(fa_ops)}")
    res = []
    for shape in FAMILY_FLASH_SHAPES + FAMILY_FLASH_RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_pair_inputs(shape, dtype, dev)
            e = check_forward(fa_ops, fa_ref, shape, q, k, v)
            name = str(dtype).replace("torch.", "")
            r = dict(shape=list(shape), dtype=name, max_abs_err=e)
            torch.cuda.empty_cache()
            if shape in FAMILY_FLASH_SHAPES:
                r.update(family_fwd_timing(dev, fa_ops, fa_ref, shape, q, k,
                                           v))
            log(f"phase 2: flash_attention {shape} {name}: max |Δ| {e!r}; "
                f"bitwise equal over two runs")
            res.append(r)
            del q, k, v
            torch.cuda.empty_cache()
    return res


#: The bf16 forward on wgmma beside the mma.sync kernel at the pairs it is
#: built for but not routed at (``kernel_timing.py flash-families``): the
#: serving shape (D 64), the same at D 128, and the (256, 256) family
#: shapes.
WGMMA_FWD_TIMED = [SERVE_SHAPE[:4] + (64, 64) + SERVE_SHAPE[5:],
                   SERVE_SHAPE[:4] + (128, 128) + SERVE_SHAPE[5:],
                   FAMILY_FLASH_SHAPES[0], FAMILY_FLASH_SHAPES[1]]


def wgmma_forward_beside(dev, fa_ops, fa_ref) -> list:
    """``WGMMA_FWD_TIMED`` in bfloat16: the wgmma forward and the mma.sync
    kernel each forced, held to the plain version and timed in turns
    (mma.sync, wgmma), with SDPA and the bound."""
    import torch
    res = []
    for shape in WGMMA_FWD_TIMED:
        q, k, v = flash_pair_inputs(shape, torch.bfloat16, dev)
        r = dict(shape=list(shape))
        for kernel in ("mma_sync", "wgmma"):
            r[kernel] = family_fwd_timing(dev, fa_ops, fa_ref, shape, q, k,
                                          v, kernel=kernel)
            r[kernel]["max_abs_err"] = check_forward(fa_ops, fa_ref, shape,
                                                     q, k, v, kernel)
        res.append(r)
        del q, k, v
        torch.cuda.empty_cache()
    return res


#: The instances a redesign of the wide backward and the (192, 128) bf16
#: forward leaves alone, digested by ``flash_digest``: the forward (with
#: its log-sum-exp) in float32 at every pair, in bf16 at the square pairs;
#: (dtype, Dk, Dv, window, cap).
FWD_DIGEST_CASES = [("float32", 32, 32, 0, 30.0), ("float32", 64, 64, 100, 0.0),
                    ("float32", 128, 128, 0, 0.0),
                    ("float32", 256, 256, 70, 50.0),
                    ("float32", 192, 128, 0, 0.0),
                    ("bfloat16", 32, 32, 0, 30.0),
                    ("bfloat16", 64, 64, 100, 0.0),
                    ("bfloat16", 128, 128, 0, 0.0),
                    ("bfloat16", 256, 256, 70, 50.0)]


def flash_digest(fa_ops, case) -> str:
    """sha256 of the forward's output and log-sum-exp at one
    ``FWD_DIGEST_CASES`` case (B 2, H 4, KV 2, S 333; inputs from numpy's
    generator seeded with Dk + Dv) on the card."""
    import hashlib
    import numpy as np
    import torch
    name, dk, dv, window, cap = case
    B, H, KV, S = 2, 4, 2, 333
    g = np.random.default_rng(dk + dv)
    q, k, v = (torch.as_tensor(g.normal(size=s).astype(np.float32)).to(
        "cuda", getattr(torch, name))
        for s in ((B, H, S, dk), (B, KV, S, dk), (B, KV, S, dv)))
    out = torch.empty((B, H, S, dv), dtype=q.dtype, device="cuda")
    lse = torch.empty((B, H, S), device="cuda")
    fa_ops._launch(q, k, v, out, window, cap, lse)
    h = hashlib.sha256()
    for t in (out, lse):
        h.update(t.cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _attention_layers(cfg) -> int:
    return sum(m in ("attn_global", "attn_local", "attn_mla")
               for m, _ in cfg.layer_plan)


def _attention_pair(cfg) -> tuple:
    """The (Dk, Dv) head dims a config's attention layers launch at."""
    if cfg.is_mla:
        return (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
    return (cfg.head_dim, cfg.head_dim)


class RouteRecorder:
    """Records every MoE layer's routing ids (``models/moe.route``) while
    it is entered: (ids, the top k + 1 probabilities) a layer call."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        import torch
        route = self.route = self.moe.route

        def recording(params, x, cfg):
            w, ids, aux = route(params, x, cfg)
            probs = torch.softmax(x.float() @ params["router"], -1)
            top = probs.topk(cfg.moe.top_k + 1, dim=-1).values
            self.calls.append((ids.cpu(), top.cpu()))
            return w, ids, aux

        self.moe.route = recording
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def family_smoke(serve, moe, arch, overrides):
    """One family at smoke width (``overrides`` replace config fields):
    the card's prefill and 8 greedy steps against the CPU's fed the card's
    tokens, from the same weights; logits within 1e-4 · max |logits|, ids
    and every MoE layer's routing equal where the margin is clear."""
    import dataclasses
    import torch
    from repro_torch import random
    from repro_torch.models.model import init_params
    cfg, params, tokens = serve.setup(arch, smoke=True, batch=2,
                                      prompt_len=40, device="cuda")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
        params = init_params(cfg, random.key(0, "cuda"), torch.float32)
    img = serve.image_embeds(cfg, 2, 40, "cuda")
    with RouteRecorder(moe) as card_routes:
        card = serve.generate(cfg, params, tokens, gen=8, image_embeds=img)
    with RouteRecorder(moe) as cpu_routes:
        cpu = serve.generate(cfg, to_cpu(params), tokens.cpu(), gen=8,
                             feed=card["generated"].cpu(),
                             image_embeds=None if img is None else img.cpu())
    got, want = card["logits"].cpu(), cpu["logits"]
    bound = 1e-4 * float(want.abs().max())
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"{arch} smoke: logits not finite")
    check(err <= bound, f"{arch} smoke: card logits {err!r} from the CPU's, "
          f"beyond 1e-4 · max |logits| = {bound!r}")
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * bound
    check(bool((got.argmax(-1) == want.argmax(-1))[sure].all()),
          f"{arch} smoke: greedy ids differ where the margin is clear")
    check(card["prefill_flash_launches"] == _attention_layers(cfg),
          f"{arch} smoke: {card['prefill_flash_launches']} flash launches "
          f"in the prefill, expected {_attention_layers(cfg)}")
    routed = clear = 0
    check(len(card_routes.calls) == len(cpu_routes.calls),
          f"{arch} smoke: {len(card_routes.calls)} MoE calls on the card, "
          f"{len(cpu_routes.calls)} on the CPU")
    for (ids_a, top), (ids_b, _) in zip(card_routes.calls, cpu_routes.calls):
        ok = ((top[:, :-1] - top[:, 1:]) > 1e-5).all(-1)
        check(bool((ids_a == ids_b)[ok].all()), f"{arch} smoke: routing "
              f"ids differ where the probabilities part by more than 1e-5")
        routed += ok.numel()
        clear += int(ok.sum())
    log(f"phase 12: {cfg.arch_id} (smoke{', ' + str(overrides) if overrides else ''}), "
        f"prompt 40, 8 steps, card against CPU: logits max |Δ| {err!r} "
        f"(bound {bound!r}); greedy ids equal at the {int(sure.sum())} of "
        f"{sure.numel()} positions with a clear margin; routing ids equal "
        f"at the {clear} of {routed} token routings with a clear margin; "
        f"flash launches "
        f"{card['prefill_flash_launches']}")
    del params
    torch.cuda.empty_cache()
    return dict(max_abs_logit_diff=err, bound=bound,
                clear_positions=int(sure.sum()), routed_clear=clear)


class Split:
    """Adds each wrapped function's synchronized wall time (ms) under its
    name while entered: where a prefill's time goes by module."""

    def __init__(self, targets):
        self.targets, self.ms, self.saved = targets, {}, []

    def __enter__(self):
        import torch
        for module, attr, label in self.targets:
            fn = getattr(module, attr)
            self.saved.append((module, attr, fn))

            def timed(*a, _fn=fn, _label=label, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                self.ms[_label] = (self.ms.get(_label, 0.0)
                                   + 1e3 * (time.perf_counter() - t0))
                return out

            setattr(module, attr, timed)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self.saved):
            setattr(module, attr, fn)


def family_full(serve, fa_ops, moe, arch, layers, dtype_name, B, S, gen):
    """One family at full width: weights from seed 0 (timed), 2 warm-up
    steps, then the prefill and ``gen`` greedy steps with the flash
    counter set to 0 just before and read just after; then one more
    prefill split by module (``Split``: the SSD, the RG-LRU scan, the MoE
    dispatch, the attention mixers; a synchronize around each call)."""
    import torch
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.train.step import make_prefill_step
    from repro_torch.tree import tree_leaves
    dtype = serve.DTYPES[dtype_name]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, params, tokens = serve.setup(arch, smoke=False, batch=B,
                                      prompt_len=S, device="cuda",
                                      n_layers=layers, dtype=dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    img = serve.image_embeds(cfg, B, S, "cuda")
    serve.generate(cfg, params, tokens, gen=2, image_embeds=img)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_launches()
    out = serve.generate(cfg, params, tokens, gen=gen, image_embeds=img)
    launches = fa_ops.launches["flash_attention"]
    by_kernel = dict(fa_ops.forward_launches_by_kernel)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_attn = _attention_layers(cfg)
    check(out["prefill_flash_launches"] == n_attn == launches,
          f"{arch} full width: flash_attention launched {launches} times "
          f"({out['prefill_flash_launches']} in the prefill), expected "
          f"{n_attn}")
    plan = fa_ops.forward_plan(dtype, *_attention_pair(cfg))
    check(by_kernel[plan] == launches,
          f"{arch} full width: {by_kernel} forward launches by kernel, "
          f"expected all {launches} on {plan}")
    check(bool(torch.isfinite(out["logits"]).all()),
          f"{arch} full width: logits not finite")
    # attention and MLA reach the kernel through the one ``ops.attention``
    targets = [(ssm_mod, "ssd_scan", "ssd_scan"),
               (rglru_mod, "linear_scan", "rglru scan"),
               (moe, "moe_forward", "moe dispatch"),
               (fa_ops, "attention", "flash forward")]
    batch = {"tokens": tokens}
    if img is not None:
        batch["image_embeds"] = img
    step = make_prefill_step(cfg, max_len=S + gen)
    with Split(targets) as split:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        split_ms = 1e3 * (time.perf_counter() - t1)
    ids = out["generated"][0, :8].tolist()
    res = dict(arch=cfg.arch_id, layers=cfg.n_layers, dtype=dtype_name,
               batch=B, prompt=S, steps=gen, params=n_params,
               init_s=init_s, prefill_ms=out["prefill_ms"],
               decode_ms=out["decode_ms"], tokens_per_s=out["tokens_per_s"],
               peak_gib=peak, flash_launches=launches,
               flash_launches_by_kernel=by_kernel,
               split_prefill_ms=split_ms, split=split.ms, row0_ids=ids)
    log(f"phase 12: {cfg.arch_id} x{cfg.n_layers} {dtype_name}, "
        f"{n_params / 1e9:.3f} B params, batch {B} x {S}"
        f"{' with ' + str(img.shape[1]) + ' image embeds' if img is not None else ''}"
        f", {gen} steps: init {init_s!r} s, prefill {out['prefill_ms']!r} "
        f"ms, decode {out['decode_ms']!r} ms/step, peak {peak!r} GiB; "
        f"flash launches {launches} (attention layers {n_attn}); split "
        f"prefill {split_ms!r} ms: {split.ms}; row 0 ids {ids}")
    return cfg, params, res


def deepseek_moe_layer(moe, cfg, params):
    """deepseek-v3's first MoE layer at full width: its dispatch (the main
    path's function) against the plain gather formula on the card, on 4
    tokens, bf16: max |Δ| <= 2e-2 · max |out|."""
    import torch
    gi = next(i for i, (plan, _) in enumerate(cfg.layer_groups())
              if plan[0][1] == "moe")
    p = {k: (v[0] if not isinstance(v, dict) else v)
         for k, v in params["blocks"][gi][0]["moe"].items()
         if k != "shared"}
    g = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn((1, 4, cfg.d_model), generator=g).to("cuda",
                                                          torch.bfloat16)
    got, aux = moe.moe_forward(p, x, cfg)
    want, want_aux = moe.moe_ref(p, x, cfg)
    e = max_abs_err(got.float(), want.float())
    bound = 2e-2 * float(want.float().abs().max())
    check(e <= bound and torch.equal(aux, want_aux),
          f"deepseek MoE layer: dispatch {e!r} from the gather formula "
          f"(bound {bound!r}) or router loss {float(aux)!r} against "
          f"{float(want_aux)!r}")
    log(f"phase 12: deepseek-v3 MoE layer (256 experts, top 8), 4 tokens, "
        f"bf16: sorted dispatch against the gather formula max |Δ| {e!r} "
        f"(bound {bound!r}); router loss equal")
    return dict(max_abs_err=e, bound=bound)


def phase_families(serve, fa_ops, then=None):
    """Phase 12: the other model families through ``launch/serve.py``:
    (a) each at smoke width, card against CPU; (b) each at full width
    (FAMILY_FULL), memory freed between models; deepseek's MoE layer
    against the gather formula.  ``then(arch, cfg, params)`` is called on
    each model's weights before they are freed (phase 13 trains on them)."""
    import gc
    import torch
    from repro_torch.models import moe
    out = {"smoke": {}, "full": {}}
    for arch, overrides in FAMILY_SMOKE:
        label = arch + ("@" + ",".join(f"{k}={v}" for k, v in
                                       overrides.items()) if overrides else "")
        out["smoke"][label] = family_smoke(serve, moe, arch, overrides)
    for arch, layers, dtype, B, S, gen in FAMILY_FULL:
        cfg, params, r = family_full(serve, fa_ops, moe, arch, layers, dtype,
                                     B, S, gen)
        if cfg.moe is not None and cfg.is_mla:
            r["moe_layer"] = deepseek_moe_layer(moe, cfg, params)
        out["full"][arch] = r
        if then is not None:
            then(arch, cfg, params)
        del params
        gc.collect()           # a model's weights must not reach the next
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 13: training the other families
# ---------------------------------------------------------------------------

#: Phase 13 (a): the float32 backward at the families' head-dim pairs
#: against the plain version under autograd: B, H, KV, S, Dk, Dv, window,
#: cap; gemma2-9b's local layer (window 4096, cap 50), recurrentgemma-9b's
#: MQA band (KV 1, window 2048 at S = 3072) and deepseek-v3's MLA
#: (phase 2's forward shapes), timed; then ragged lengths, in the model
#: layout (strided views).
FAMILY_BWD_SHAPES = FAMILY_FLASH_SHAPES
FAMILY_BWD_RAGGED = [(2, 4, 2, 200, 256, 256, 0, 50.0),
                     (1, 16, 1, 300, 256, 256, 70, 0.0),
                     (2, 4, 4, 200, 192, 128, 0, 0.0)]
#: The float32 backward's kernels at the wide pairs (one dK/dV and one dQ
#: launch, eight warps a CTA) and the bf16 forward on wgmma at (192, 128),
#: as their mangled names hold them in the build log: ptxas must report no
#: spill in any.
FAMILY_BWD_KERNELS = ("flash_bwd_dkdv_wide_kernelILi256ELi256E",
                      "flash_bwd_dq_wide_kernelILi256ELi256E",
                      "flash_bwd_dkdv_wide_kernelILi192ELi128E",
                      "flash_bwd_dq_wide_kernelILi192ELi128E",
                      "3wgf10fwd_kernelILi192ELi128E")
#: Phase 13 (b): a smoke-width batch, its length past a 64-row tile.
FAMILY_TRAIN_SMOKE_BATCH = (2, 80)
#: Phase 13 (c): full width, the depth cut the card or the time limit
#: forces: (arch, layers (0: all), batch, seq, optimizer).  deepseek-v3 and
#: qwen3-moe take adafactor, as the reference's dryrun does for models
#: past 20 B parameters: adam's functional update holds eight copies of
#: their 3.0 and 3.7 B float32 weights (97 and 119 GB).  recurrentgemma-9b
#: at 2 x 3072 (past its 2,048 window): at 4 x 3072 a step took 7.4 s.
FAMILY_TRAIN = (("mamba2-1.3b", 0, 8, 1024, "adam"),
                ("recurrentgemma-9b", 3, 2, 3072, "adam"),
                ("gemma2-9b", 2, 8, 1024, "adam"),
                ("deepseek-v3-671b", 2, 8, 1024, "adafactor"),
                ("qwen3-moe-235b-a22b", 1, 4, 1024, "adafactor"),
                ("llava-next-mistral-7b", 2, 4, 3072, "adam"),
                ("musicgen-large", 12, 8, 1024, "adam"))
#: Steps of each full-width run: the first a warm-up, the others timed.
FAMILY_TRAIN_STEPS = 3
#: Families whose full-width runs each get fresh weights, handed over: the
#: caller's weights, the step's, its gradients, the shifts and the new
#: weights of deepseek-v3's 12.1 GB and qwen3-moe's 14.9 GB do not fit the
#: card beside the step's temporaries (deepseek's FLECS-CGD step ran out
#: of memory with its first weights held).
FAMILY_TRAIN_HANDOVER = ("deepseek-v3-671b", "qwen3-moe-235b-a22b")


def ptxas_report(log_text: str) -> dict:
    """Each entry function of an nvcc build log (``-Xptxas -v``): its
    registers and spill stores and loads in bytes."""
    import re
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def family_bwd_ptxas(fa_ops) -> dict:
    """The registers and spills of ``FAMILY_BWD_KERNELS`` from the flash
    library's build log, by fragment; fails on a spill or a missing
    kernel."""
    report = ptxas_report(fa_ops.LIBRARY.build_log())
    res = {}
    for frag in FAMILY_BWD_KERNELS:
        found = {n: r for n, r in report.items() if frag in n}
        check(len(found) == 1,
              f"{len(found)} kernels {frag} in the flash library's build log")
        for name, r in found.items():
            check(r.get("spill_stores", 1) == 0
                  and r.get("spill_loads", 1) == 0,
                  f"{name} spills: {r}")
            res[frag] = r
    return res


def kernel_split(fn, calls: int = 2) -> dict:
    """Each kernel ``fn`` launches: device ms and launches a call, from
    torch.profiler over ``calls`` calls after one warm-up, by its name
    without the argument list."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # CPU and CUDA, as the other profiles here: after those, a CUDA-only
    # session in the same process reported no device events
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for us, count, name in device_rows(prof):
        short = re.sub(r"^void |\(.*$", "",
                       name.replace("(anonymous namespace)::", ""))
        split[short] = dict(ms=us / 1e3 / calls, launches=count / calls)
    return split


def family_bwd_bound(shape) -> dict:
    """The backward's least time at a (Dk, Dv) shape: the five products
    over the live pairs (S and dQ, dK at Dk; dP, dV at Dv: 2 (3 Dk + 2 Dv)
    operations a pair) as 3xTF32, against q, k, v, o, dO, dQ, dK, dV and
    the lse read or written once."""
    B, H, KV, S, Dk, Dv, window, _ = shape
    ops = 2 * B * H * live_pairs(S, window) * (3 * Dk + 2 * Dv)
    nbytes = 4 * (2 * B * H * S * Dk + 2 * B * KV * S * Dk
                  + 2 * B * KV * S * Dv + 2 * B * H * S * Dv + B * H * S)
    t_ops = 1e3 * 3 * ops / TF32_OPS_PER_S
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return dict(ops=ops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def phase_flash_bwd_families(dev, fa_ops, fa_ref, new=True):
    """Phase 13 (a): the float32 backward at (256, 256) and (192, 128)
    against the plain version under autograd on the card (max |Δ| <=
    BWD_REL · max |grad| over dq, dk, dv), the same bits over two runs, at
    the family shapes (kernel layout) and ragged lengths (model layout,
    strided views); launches counted by pair; each family shape timed by
    CUDA events beside the plain version's backward and SDPA's (its
    ``is_causal`` or explicit band-mask form; null under a soft-cap), with
    its bound, and its kernels' device ms from a profile
    (``kernel_split``).  With ``new`` (an earlier checkout timed beside
    this one has other kernels): the build log's registers and spills of
    ``FAMILY_BWD_KERNELS``, and one dK/dV launch a call."""
    import torch
    import torch.nn.functional as F
    ptx = family_bwd_ptxas(fa_ops) if new else None
    log(f"phase 13: the new kernels' ptxas report: {ptx}")
    res, err_worst = [], 0.0
    for shape in FAMILY_BWD_SHAPES + FAMILY_BWD_RAGGED:
        B, H, KV, S, Dk, Dv, window, cap = shape
        model = shape in FAMILY_BWD_RAGGED
        q, k, v = flash_pair_inputs(shape, torch.float32, dev, seed=4)
        g = torch.Generator(device=dev).manual_seed(5)
        dout = torch.randn((B, H, S, Dv), generator=g, device=dev)
        if model:           # [B, S, H, D] tensors: the kernels get strides
            q, k, v, dout = (t.transpose(1, 2).contiguous()
                             for t in (q, k, v, dout))

        def grads(fn):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = fn(*leaves)
            return torch.autograd.grad(out, leaves, dout)

        if model:
            card = lambda a, b, c: fa_ops.attention(a, b, c, window, cap)  # noqa: E731
            plain = lambda a, b, c: fa_ref.attention_ref(             # noqa: E731
                a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
                window, cap).transpose(1, 2)
        else:
            card = lambda a, b, c: fa_ops.flash_attention(a, b, c, window, cap)  # noqa: E731
            plain = lambda a, b, c: fa_ref.attention_ref(a, b, c, window, cap)  # noqa: E731
        got = grads(card)
        again = grads(card)
        check(all(same_bits(a, b) for a, b in zip(got, again)),
              f"flash backward differs between two runs at {shape}")
        want = grads(plain)
        scale = max(float(w.abs().max()) for w in want)
        e = max(abs_err(a, w) for a, w in zip(got, want))
        check(all(a.shape == w.shape and a.dtype == torch.float32
                  for a, w in zip(got, want)),
              f"flash backward returned {[tuple(a.shape) for a in got]}")
        check(e <= BWD_REL["float32"] * scale,
              f"flash backward at {shape} differs from the plain autograd: "
              f"max |Δ| {e!r} beyond {BWD_REL['float32']} · {scale!r}")
        err_worst = max(err_worst, e / scale)
        r = dict(shape=list(shape), layout="model" if model else "kernel",
                 max_abs_err=e, rel_err=e / scale)
        del got, again, want
        if not model:
            out = torch.empty((B, H, S, Dv), device=dev)
            lse = torch.empty((B, H, S), device=dev)
            fa_ops._launch(q, k, v, out, window, cap, lse)
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            r["ms"] = cuda_ms(lambda: fa_ops._launch_backward(
                q, k, v, out, dout, lse, dq, dk, dv, window, cap), 5)

            def fwd_bwd(fn):
                def run():
                    leaves = [t.detach().requires_grad_(True)
                              for t in (q, k, v)]
                    torch.autograd.grad(fn(*leaves), leaves, dout)
                return run

            r["plain_ms"] = (cuda_ms(fwd_bwd(plain), 2)
                             - cuda_ms(lambda: plain(q, k, v), 2))
            if cap:
                r["library_ms"] = None        # SDPA has no soft-cap
            else:
                mask = None
                if window and window < S:
                    i = torch.arange(S, device=dev)
                    mask = ((i[:, None] >= i[None, :])
                            & (i[:, None] - i[None, :] < window))

                def sdpa(a, b, c):
                    return F.scaled_dot_product_attention(
                        a, b, c, attn_mask=mask, is_causal=mask is None,
                        enable_gqa=True)
                try:
                    r["library_ms"] = (cuda_ms(fwd_bwd(sdpa), 5)
                                       - cuda_ms(lambda: sdpa(q, k, v), 5))
                except (TypeError, RuntimeError) as exc:
                    log(f"timing: SDPA's backward at {shape} unavailable: "
                        f"{exc}")
                    r["library_ms"] = None
            r.update(family_bwd_bound(shape))
            r["split"] = kernel_split(lambda: fa_ops._launch_backward(
                q, k, v, out, dout, lse, dq, dk, dv, window, cap))
            dkdv = [n for n in r["split"] if "dkdv" in n]
            # after phase 10 the profiler reports no device events in this
            # process (a fresh one does: kernel_timing.py flash-families,
            # and tests/test_torch_gpu.py holds the one dK/dV launch)
            check(not new or not r["split"] or (
                len(dkdv) == 1 and r["split"][dkdv[0]]["launches"] == 1),
                  f"flash backward at {shape}: dK/dV kernels {dkdv} "
                  f"({r['split']}), expected one launch of one")
            if not r["split"]:
                log(f"phase 13: the profiler reported no device events at "
                    f"{shape}: no split by kernel")
            log(f"timing flash_attention_backward {shape}: {r['ms']!r} ms "
                f"(plain {r['plain_ms']!r} ms, SDPA {r['library_ms']!r} ms; "
                f"bound {r['bound_ms']!r} ms by {r['bound_by']}); device ms "
                f"a call by kernel: " + ", ".join(
                    f"{n} {v['ms']!r} (x{v['launches']!r})"
                    for n, v in r["split"].items()))
            del out, lse, dq, dk, dv
        log(f"phase 13: flash backward {shape} float32 ({r['layout']} "
            f"layout): max |Δ| {e!r} ({e / scale!r} of max |grad| "
            f"{scale!r}); bitwise equal over two runs")
        res.append(r)
        del q, k, v, dout
        torch.cuda.empty_cache()
    return dict(instances=res, rel_err_worst=err_worst, ptxas=ptx)


#: Phase 13 (b)'s modes: (label, FLECS-CGD, workers); 2 workers at smoke
#: width are held card against CPU in ``tests/test_torch_gpu.py``.
FAMILY_TRAIN_SMOKE_MODES = (("adam", False, 1), ("flecs", True, 1))


def family_train_smoke_card(train, fa_ops, arch, overrides) -> dict:
    """Phase 13 (b), the card's side of one family at smoke width: one
    step of each of FAMILY_TRAIN_SMOKE_MODES through ``launch/train.train``
    (adam, FLECS-CGD m = 0); the weights and
    batch on the host for the CPU's side, each mode's metrics, new params
    and flash launches (the backward's by pair)."""
    import dataclasses
    import torch
    from repro_torch import random
    from repro_torch.models.model import init_params
    cfg, params = train.setup(arch, smoke=True, device="cuda")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
        params = init_params(cfg, random.key(0, "cuda"), torch.float32)
    batch = next(train.token_batches(cfg, *FAMILY_TRAIN_SMOKE_BATCH,
                                     "cuda"))
    out = dict(arch=arch, overrides=overrides, cfg=cfg,
               params=to_cpu(params), batch=to_cpu(batch), modes={})
    for mode, flecs, n in FAMILY_TRAIN_SMOKE_MODES:
        fa_ops.reset_launches()
        run = train.train(cfg, params, iter([batch]), 1, flecs=flecs,
                          workers=n)
        out["modes"][mode] = dict(
            metrics=run["metrics"][0], params=to_cpu(run["params"]),
            launches=dict(fa_ops.launches),
            by_pair=dict(fa_ops.backward_launches_by_pair))
        del run
    del params
    torch.cuda.empty_cache()
    return out


def family_train_smoke_cpu(train, card) -> dict:
    """Phase 13 (b), the CPU's side: the same steps from the same weights
    and batch on this machine's CPU (``launch/train.train``), each mode's
    metrics, new params and new mean shift."""
    out = {}
    for mode, flecs, n in FAMILY_TRAIN_SMOKE_MODES:
        run = train.train(card["cfg"], card["params"], iter([card["batch"]]),
                          1, flecs=flecs, workers=n)
        out[mode] = dict(metrics=run["metrics"][0], params=run["params"],
                         mean=run["state"]["mean"] if flecs else None)
    return out


def family_train_smoke_held(card, cpu) -> dict:
    """Phase 13 (b), one family card against CPU: losses within LOSS_REL,
    ``uplink_mbits`` equal, the new params as ``test_torch_family_
    training.py`` holds them against the reference (adam: at most 1e-3 of
    the elements more than 1e-6 apart, none more than 2 lr; FLECS-CGD:
    within a level step's move, alpha · 2 · max |h̄| / 127 + 1e-6), the
    card's flash forward launched twice an attention layer and worker
    (remat) and the backward once, at the layer's (Dk, Dv) pair."""
    import torch
    from repro_torch.tree import tree_leaves
    arch, cfg, lr = card["arch"], card["cfg"], 3e-3
    n_attn = _attention_layers(cfg)
    pair = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
            if cfg.is_mla else (cfg.head_dim, cfg.head_dim))
    res = {}
    for mode, flecs, n in FAMILY_TRAIN_SMOKE_MODES:
        c, p = card["modes"][mode], cpu[mode]
        a, b = c["metrics"], p["metrics"]
        launches, by_pair = c["launches"], c["by_pair"]
        check(abs(a["loss"] - b["loss"]) <= LOSS_REL * abs(b["loss"]),
              f"{arch} smoke {mode}: loss {a['loss']!r} (card) and "
              f"{b['loss']!r} (CPU)")
        check(launches["flash_attention"] == 2 * n_attn * n
              and launches["flash_attention_backward"] == n_attn * n
              and by_pair == ({pair: n_attn * n} if n_attn else {}),
              f"{arch} smoke {mode}: launches {launches}, backward by pair "
              f"{by_pair}, expected {n_attn} attention layers at {pair}")
        got = torch.cat([t.float().reshape(-1)
                         for t in tree_leaves(c["params"])])
        want = torch.cat([t.float().reshape(-1)
                          for t in tree_leaves(p["params"])])
        diff = (got - want).abs()
        if flecs:
            check(a["uplink_mbits"] == b["uplink_mbits"],
                  f"{arch} smoke {mode}: uplink {a['uplink_mbits']!r} (card) "
                  f"and {b['uplink_mbits']!r} (CPU)")
            h = max(float(t.float().abs().max())
                    for t in tree_leaves(p["mean"]))
            bound = lr * 30 * 2 * h / 127 + 1e-6
            check(float(diff.max()) <= bound,
                  f"{arch} smoke {mode}: params {float(diff.max())!r} apart, "
                  f"beyond {bound!r}")
        else:
            share = float((diff > 1e-6).float().mean())
            check(share <= 1e-3 and float(diff.max()) <= 2 * lr,
                  f"{arch} smoke adam: params differ past 1e-6 at {share!r} "
                  f"of the elements, by up to {float(diff.max())!r}")
        res[mode] = dict(loss_card=a["loss"], loss_cpu=b["loss"],
                         max_param_diff=float(diff.max()),
                         flash=launches["flash_attention"],
                         backward_by_pair={str(k): v
                                           for k, v in by_pair.items()})
        if flecs:
            res[mode]["uplink_mbits"] = a["uplink_mbits"]
    overrides = card["overrides"]
    log(f"phase 13: {cfg.arch_id} (smoke{', ' + str(overrides) if overrides else ''}), "
        f"batch {FAMILY_TRAIN_SMOKE_BATCH}, one adam and one FLECS-CGD step, "
        f"card against CPU: {res}")
    return res


def family_train_full(train, fa_ops, d_ops, arch, cfg, make_params, B, S,
                      optimizer) -> dict:
    """Phase 13 (c), one family at full width: FAMILY_TRAIN_STEPS steps of
    ``optimizer`` and then of FLECS-CGD (m = 0) through ``launch/train.
    train`` on one batch, each from ``make_params()`` (handed over, so the
    first weights are freed after the first step where nothing else holds
    them), the counters set to 0 just before each run and read just after:
    step ms (the first a warm-up), peak GiB, flash launches (the forward
    twice a layer a step under remat, the backward once) by pair, the dither
    codec's (a leaf a step)."""
    import itertools
    import torch
    t_start = time.perf_counter()
    batch = next(train.token_batches(cfg, B, S, "cuda"))
    n_attn = _attention_layers(cfg)
    steps = FAMILY_TRAIN_STEPS
    res = {}
    for mode in (optimizer, "flecs"):
        flecs = mode == "flecs"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa_ops.reset_launches()
        d_ops.reset_launches()
        out = train.train(cfg, make_params(), itertools.repeat(batch), steps,
                          flecs=flecs, optimizer=optimizer)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = dict(fa_ops.launches)
        by_pair = dict(fa_ops.backward_launches_by_pair)
        losses = [m["loss"] for m in out["metrics"]]
        check(all(map(math.isfinite, losses)),
              f"{arch} full width {mode}: losses not finite: {losses}")
        check(launches["flash_attention"] == 2 * n_attn * steps
              and launches["flash_attention_backward"] == n_attn * steps,
              f"{arch} full width {mode}: flash launches {launches}, "
              f"expected {2 * n_attn} and {n_attn} a step")
        leaves = d_ops.launches["dither_encode_keyed"]
        check(not flecs or (leaves > 0 and leaves
                            == d_ops.launches["dither_decode"]),
              f"{arch} full width flecs: codec launches {d_ops.launches}")
        res[mode] = dict(
            losses=losses, step_ms=out["step_ms"],
            timed_step_ms=out["step_ms"][1:], peak_gib=peak,
            flash_launches=launches["flash_attention"],
            backward_launches=launches["flash_attention_backward"],
            backward_by_pair={str(k): v for k, v in by_pair.items()},
            codec_launches=leaves)
        if flecs:
            res[mode]["uplink_mbits"] = out["metrics"][-1]["uplink_mbits"]
        log(f"phase 13: {cfg.arch_id} x{cfg.n_layers} f32, batch {B} x {S}, "
            f"{mode} x{steps}: losses {losses}; step ms {out['step_ms']}; "
            f"peak {peak!r} GiB; flash {launches['flash_attention']}, "
            f"backward {by_pair}; codec {leaves}")
        del out
        torch.cuda.empty_cache()
    return dict(arch=cfg.arch_id, layers=cfg.n_layers, batch=B, seq=S,
                optimizer=optimizer, seconds=time.perf_counter() - t_start,
                **res)


def reuses_serving_weights(arch) -> bool:
    """Whether phase 13 (c) trains ``arch`` on phase 12's weights: float32
    at FAMILY_TRAIN's depth (init is ~1.3 ns a weight)."""
    served = {a: (layers, dtype) for a, layers, dtype, *_ in FAMILY_FULL}
    trained = {a: layers for a, layers, *_ in FAMILY_TRAIN}
    return (arch in served and arch in trained
            and served[arch] == (trained[arch], "float32"))


def train_on_serving_weights(train, fa_ops, d_ops, arch, cfg, params,
                             done) -> None:
    """Phase 13 (c) on phase 12's weights where ``reuses_serving_weights``:
    the run goes into ``done`` by arch."""
    if not reuses_serving_weights(arch):
        return
    _, _, B, S, optimizer = next(r for r in FAMILY_TRAIN if r[0] == arch)
    done[arch] = family_train_full(train, fa_ops, d_ops, arch, cfg,
                                   lambda: params, B, S, optimizer)


def family_train_rest(train, fa_ops, d_ops) -> dict:
    """Phase 13 (c) of the families phase 12 leaves no float32 weights for,
    by arch.  A family of FAMILY_TRAIN_HANDOVER gets fresh weights for each
    run, handed over, so no caller holds a step's first weights; the
    others' weights are drawn once."""
    import gc
    import torch
    out = {}
    for arch, layers, B, S, optimizer in FAMILY_TRAIN:
        if reuses_serving_weights(arch):
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cfg, params = train.setup(arch, smoke=False, device="cuda",
                                  n_layers=layers)
        held = [params]
        del params
        if arch in FAMILY_TRAIN_HANDOVER:
            def make(arch=arch, layers=layers, held=held):
                return held.pop() if held else train.setup(
                    arch, smoke=False, device="cuda", n_layers=layers)[1]
        else:
            def make(held=held):
                return held[0]
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        out[arch] = family_train_full(train, fa_ops, d_ops, arch, cfg, make,
                                      B, S, optimizer)
        out[arch]["init_s"] = init_s
        del make, held
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_family_training(train, fa_ops, d_ops, done) -> dict:
    """Phase 13 (b), each family card against CPU, with (c)'s full-width
    runs (``done``, by arch: made on phase 12's weights and, while phase
    11's CPU side ran, on fresh ones) in FAMILY_TRAIN's order."""
    out = {"smoke": {}}
    t0 = time.perf_counter()
    for arch, overrides in FAMILY_SMOKE:
        label = arch + ("@" + ",".join(f"{k}={v}" for k, v in
                                       overrides.items()) if overrides else "")
        card = family_train_smoke_card(train, fa_ops, arch, overrides)
        out["smoke"][label] = family_train_smoke_held(
            card, family_train_smoke_cpu(train, card))
    out["smoke_s"] = time.perf_counter() - t0
    log(f"phase 13 (b): {out['smoke_s']:.1f} s")
    out["full"] = {arch: done[arch] for arch, *_ in FAMILY_TRAIN}
    return out

def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a card")
    from repro_torch import experiments, quickstart, random
    from repro_torch.core import api, driver
    from repro_torch.data.logreg import make_problem
    from repro_torch.kernels.compressor import build, ops, ref
    from repro_torch.kernels.flash_attention import build as fa_build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.dither import build as d_build
    from repro_torch.kernels.dither import ops as d_ops
    from repro_torch.kernels.dither import ref as d_ref
    from repro_torch import tree
    from repro_torch.core import compressors
    from repro_torch.launch import serve
    from repro_torch.launch import train
    from repro_torch.core import dl_flecs
    from repro_torch.train.step import value_and_grad

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch", torch.__version__, "cuda", torch.version.cuda, "python",
        sys.version.split()[0])

    t0 = start = time.perf_counter()

    def elapsed(what):
        log(f"elapsed after {what}: {time.perf_counter() - start:.1f} s")

    libraries = (build, fa_build, d_build, fa_build.JVP_LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:   # one nvcc per source
        built = list(pool.map(lambda b: b.build(), libraries))
    log(f"phase 1: built {[p.name for p in built]} in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in libraries:
        for line in lib.build_log().splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                log("  ptxas:", line.strip())
    card = card_line()
    log(card)

    err = phase_kernels(dev, ops, ref, random)
    phase_dither_cluster(dev, ops, ref, random, err)
    phase_topk_cluster(dev, ops, ref, err)
    grouped_err = phase_grouped_kernels(dev, ops, ref, random, compressors)
    phase_row_ids(dev, ops, ref, random, driver, grouped_err)
    flash_err = phase_flash_kernel(dev, fa_ops, fa_ref)
    fam_flash = phase_flash_families(dev, fa_ops, fa_ref)
    dither_err = phase_dither_kernels(dev, d_ops, d_ref, random)
    bwd_err, bwd_rel = phase_flash_backward(dev, fa_ops, fa_ref)
    elapsed("phase 2")
    counts = {name: 0 for name in ops.launches}
    quick = phase_quickstart(quickstart, ops, counts)
    gis = phase_gisette(quickstart, ops, counts)
    for name, n in counts.items():
        # the round takes the grouped entries; the scalar ones are off it
        check((n > 0) == (name in GROUPED_REPLACES),
              f"{name} launched {n} times on the main path")
    log(f"main-path launches (sum of the four runs above): {counts}")
    elapsed("phases 3 and 4")
    plan_counts = {name: 0 for name in ops.launches}
    plans = phase_plans(api, experiments, make_problem, ops, plan_counts)
    plans["figures"] = phase_figures(ops, plan_counts)
    gis_base = phase_gisette_baselines(api, experiments, make_problem, ops,
                                       ref, plan_counts)
    for name, n in plan_counts.items():
        check((n > 0) == (name in GROUPED_REPLACES),
              f"{name} launched {n} times by the plans")
    log(f"plan launches (sum of phases 3b and 4b): {plan_counts}")
    elapsed("phases 3b and 4b")
    stoch_counts = {name: 0 for name in ops.launches}
    stoch = phase_stochastic(dev, quickstart, random, driver, compressors,
                             api, experiments, make_problem, ops,
                             stoch_counts)
    for name, n in stoch_counts.items():
        check((n > 0) == (name in GROUPED_REPLACES),
              f"{name} launched {n} times by the stochastic phase")
    log(f"stochastic launches (sum of phase 3c): {stoch_counts}")
    elapsed("phase 3c")
    async_counts = {name: 0 for name in ops.launches}
    asy = phase_async(ops, async_counts)
    for name, n in async_counts.items():
        check((n > 0) == (name in GROUPED_REPLACES),
              f"{name} launched {n} times by the async phase")
    log(f"async launches (sum of phase 3d): {async_counts}")
    elapsed("phase 3d")
    pop_counts = {name: 0 for name in ops.launches}
    pop = phase_population(ops, pop_counts)
    for name, n in pop_counts.items():
        # no top-k-priced spec on this path: topk_bits_grouped stays at 0
        check((n > 0) == (name in POP_PATH),
              f"{name} launched {n} times by the population phase")
    log(f"population launches (sum of phase 3e): {pop_counts}")
    elapsed("phase 3e")
    depth2 = phase_serve_depth2(serve)
    elapsed("phase 5")
    full = phase_serve_full(serve, fa_ops)
    elapsed("phase 6")
    train2 = phase_train_depth2(train, value_and_grad, compressors, random,
                                tree)
    elapsed("phase 8")
    trained = phase_train_full(train, fa_ops, d_ops, ops, tree)
    elapsed("phase 9")
    # the kernel timings that read no host clock run on the card while
    # phase 10's CPU side runs, and phase 13 (c)'s runs on fresh weights
    # while phase 11's does (both sides are CPU-bound on a slow host)
    timed = {}

    def kernel_timings():
        timed["ttopk"] = topk_shape_timing(dev, ops, ref)
        timed["gtiming"] = grouped_timing(dev, ops, ref, random,
                                          library=built[0])
        timed["flash"] = phase_flash_timing(dev, fa_ops, fa_ref)
        timed["ttiming"] = phase_train_kernel_timing(dev, d_ops, d_ref,
                                                     fa_ops, fa_ref, random)
        elapsed("phase 7's and 9's kernel timings")

    m2 = phase_flecs_m2(dev, train, dl_flecs, fa_ops, fa_ref, d_ops, ops,
                        tree, meanwhile=kernel_timings)
    elapsed("phase 10")
    fam_bwd = phase_flash_bwd_families(dev, fa_ops, fa_ref)
    elapsed("phase 13 (a)")
    fresh = {}

    def family_training_fresh():
        fresh.update(family_train_rest(train, fa_ops, d_ops))
        elapsed("phase 13 (c) on fresh weights")

    workers = phase_flecs_workers(train, dl_flecs, fa_ops, d_ops, ops, tree,
                                  meanwhile=family_training_fresh)
    elapsed("phase 11")
    on_serving = {}
    families = phase_families(
        serve, fa_ops, then=lambda arch, cfg, params: train_on_serving_weights(
            train, fa_ops, d_ops, arch, cfg, params, on_serving))
    elapsed("phase 12 (and phase 13 (c) on its float32 weights)")
    fam_train = phase_family_training(train, fa_ops, d_ops,
                                      {**on_serving, **fresh})
    elapsed("phase 13")
    prof = phase_profile(quickstart)
    elapsed("phase 7's profile")
    timing = phase_timing(dev, ops, ref, random, library=built[0])
    elapsed("phase 7's compressor timing")
    ttopk, gtiming = timed["ttopk"], timed["gtiming"]
    floor_ms = empty_launch_ms()
    log(f"timing an empty kernel (torch.cuda._sleep(0)) back to back: "
        f"{floor_ms!r} ms a launch")
    flash, ttiming = timed["flash"], timed["ttiming"]

    # phase 10's two main paths (the m = 2 trainer and train_lm) and phase
    # 11's two (n workers at m = 0 and at m = 2)
    m2_paths = {
        f"train flecs m=2 x{FLECS_M_STEPS}": m2["full"]["launches"],
        f"train_lm --flecs-m 2 x{TRAIN_LM_STEPS}": m2["driver"]["launches"],
        f"train flecs n={WORKERS_N} x{WORKERS_STEPS}": workers["n4_m0"][
            "launches"],
        f"train flecs m=2 n={WORKERS_M2_N} x{WORKERS_M2_STEPS}": workers[
            "n2_m2"]["launches"]}
    m2_launches = {name: sum(n.get(name, 0) for n in m2_paths.values())
                   for name in m2["full"]["launches"]}
    kernels = []
    for name in REPLACES:
        L = 20000 if name.startswith("fused") else 1
        r = timing[(name, L)]
        entry = {"name": name, "route": "cuda", "source": SOURCE,
                 "replaces": REPLACES[name],
                 "launches": counts[name] + plan_counts[name]
                 + trained["flecs"]["launches"].get(name, 0)
                 + m2_launches.get(name, 0),
                 "launches_by_path": {
                     "quickstart, gisette": counts[name],
                     "plans": plan_counts[name],
                     f"train flecs x{FULL_STEPS}": trained["flecs"][
                         "launches"].get(name, 0),
                     **{path: n.get(name, 0)
                        for path, n in m2_paths.items()}},
                 "max_abs_err": err[name], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                 "host_ms": r["host_ms"], "shape": [20, L] if L > 1 else []}
        if name.startswith("fused"):
            entry["ms_by_shape"] = {f"[20,{Ls}]": timing[(name, Ls)]["ms"]
                                    for Ls in TIMED_L[name]}
            entry["bound_ms_by_shape"] = {
                f"[20,{Ls}]": timing[(name, Ls)]["bound_ms"]
                for Ls in TIMED_L[name]}
        if name in ("dither_bits", "topk_bits"):
            entry["launch_floor_ms"] = floor_ms
        if name == "fused_dither_keyed":
            entry["bound_pipe"] = r["pipe"]
            entry["clocks_per_element"] = r["clocks_per_element"]
        if name == "fused_topk":
            entry["library_ms_by_shape"] = {
                f"[20,{Ls}]": timing[(name, Ls)]["library_ms"]
                for Ls in TIMED_L[name]}
            topk_entry(entry, ttopk, lambda rows: rows != 60)
            entry["ms_by_shape"]["[20,25000000] (phase 4b)"] = gis_base[
                "fused_topk_long"]["[20,25000000]"]["ms"]
        kernels.append(entry)
    for name, r in gtiming.items():
        entry = {"name": name, "route": "cuda", "source": SOURCE,
                 "replaces": GROUPED_REPLACES[name],
                 "launches": counts[name] + plan_counts[name]
                 + stoch_counts[name] + async_counts[name]
                 + pop_counts[name],
                 "launches_by_path": {"quickstart, gisette": counts[name],
                                      "plans": plan_counts[name],
                                      "stochastic": stoch_counts[name],
                                      "async": async_counts[name],
                                      "population": pop_counts[name]},
                 "max_abs_err": grouped_err[name], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                 "scalar_entry_ms": r["scalar_ms"], "shape": r["shape"]}
        if name.endswith("bits_grouped"):
            entry["launch_floor_ms"] = floor_ms
        if name == "fused_topk_grouped":
            long = gis_base["fused_topk_long"]
            entry["ms_by_shape"] = {
                "[20,25000000] (phase 4b)": long["[20,25000000]"][
                    "grouped_ms"],
                "[60,25000000] (phase 4b)": long["[60,25000000]"]["ms"]}
            entry["library_ms_by_shape"] = {
                f"{shape} (phase 4b)": r["library_ms"]
                for shape, r in long.items()}
            entry["bound_ms_by_shape"] = {}
            topk_entry(entry, ttopk, lambda rows: rows == 60)
            entry["launches_by_instance"] = {
                "gisette FedNL x10": gis_base["FedNL"]["topk_instances"][
                    name]}
        kernels.append(entry)
    by_path = {"serve prefill": full["launches"],
               f"train adam x{FULL_STEPS}": trained["adam"]["launches"],
               f"train flecs x{FULL_STEPS}": trained["flecs"]["launches"],
               **m2_paths}
    family_paths = {f"serve {r['arch']} x{r['layers']} prefill":
                    r["flash_launches"]
                    for r in families["full"].values()}
    family_by_kernel = {}
    for r in families["full"].values():
        for name, n in r["flash_launches_by_kernel"].items():
            family_by_kernel[name] = family_by_kernel.get(name, 0) + n
    for r in fam_flash:
        flash_err[r["dtype"]] = max(flash_err[r["dtype"]], r["max_abs_err"])
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": full["launches"]
        + trained["adam"]["launches"]["flash_attention"]
        + trained["flecs"]["launches"]["flash_attention"]
        + m2_launches["flash_attention"] + sum(family_paths.values()),
        "launches_by_path": {**{k: (v if isinstance(v, int)
                                    else v["flash_attention"])
                                for k, v in by_path.items()},
                             **family_paths},
        "family_launches_by_kernel": family_by_kernel,
        "instances": fam_flash,
        "max_abs_err": max(flash_err.values()), "ms": flash["float32"]["ms"],
        "plain_ms": flash["float32"]["plain_ms"],
        "bound_ms": flash["float32"]["bound_ms"],
        "bound_by": flash["float32"]["bound_by"],
        "library_ms": flash["float32"]["library_ms"],
        "max_abs_err_by_dtype": flash_err,
        "bf16": {key: flash["bfloat16"][key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "shape": list(SERVE_SHAPE[:5])})
    leaf = LEAF_SHAPES[0]
    for name in DITHER_REPLACES:
        r = ttiming[(name, leaf)]
        kernels.append({
            "name": name, "route": "cuda", "source": DITHER_SOURCE,
            "replaces": DITHER_REPLACES[name],
            "launches": trained["flecs"]["launches"][name]
            + m2_launches[name],
            "launches_by_path": {f"train flecs x{FULL_STEPS}": trained["flecs"][
                "launches"][name], **{path: n[name]
                                      for path, n in m2_paths.items()}},
            "max_abs_err": dither_err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": list(leaf), "ms_by_shape": {
                str(list(sh)): ttiming[(name, sh)]["ms"]
                for (n, sh) in ttiming if n == name}})
        if "draw_ms" in r:
            kernels[-1]["draw_ms"] = r["draw_ms"]
    r = ttiming[("flash_attention_backward", torch.float32)]
    r16 = ttiming[("flash_attention_backward", torch.bfloat16)]
    # phase 13 (c)'s main paths: each family's two full-width runs
    fam_paths, fam_pairs = {}, {}
    for run in fam_train["full"].values():
        for mode in (run["optimizer"], "flecs"):
            fam_paths[f"train {run['arch']} x{run['layers']} {mode} "
                      f"x{FAMILY_TRAIN_STEPS}"] = run[mode][
                          "backward_launches"]
            for pair, n in run[mode]["backward_by_pair"].items():
                fam_pairs[pair] = fam_pairs.get(pair, 0) + n
    kernels.append({
        "name": "flash_attention_backward", "route": "cuda",
        "source": FLASH_SOURCE, "replaces": BWD_REPLACES,
        "launches": trained["adam"]["launches"]["flash_attention_backward"]
        + trained["flecs"]["launches"]["flash_attention_backward"]
        + m2_launches["flash_attention_backward"]
        + sum(fam_paths.values()),
        "launches_by_path": {**{k: v["flash_attention_backward"]
                                for k, v in by_path.items()
                                if k != "serve prefill"}, **fam_paths},
        "family_launches_by_pair": fam_pairs,
        "instances": fam_bwd["instances"],
        "max_abs_err": max(bwd_err.values()), "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "max_abs_err_by_dtype": bwd_err, "rel_err_by_dtype": bwd_rel,
        "bf16": {key: r16[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "hgmma")},
        "shape": list(SERVE_SHAPE[:5])})
    for name in ("flash_attention_jvp", "flash_attention_backward_jvp"):
        r = m2["timing"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": JVP_SOURCE,
            "replaces": JVP_REPLACES, "launches": m2_launches[name],
            "launches_by_path": {path: n[name]
                                 for path, n in m2_paths.items()},
            "max_abs_err": m2["jvp_err"][name],
            "rel_err": m2["jvp_rel"][name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library_ms_why": "no one PyTorch call computes attention's "
                              "tangent",
            "shape": list(SERVE_SHAPE[:5])})
    log(json.dumps({"plans": plans, "gisette_baselines": gis_base}))
    log(json.dumps({"stochastic": stoch}))
    log(json.dumps({"async": asy}, default=str))
    log(json.dumps({"population": pop}, default=str))
    log(json.dumps({"quickstart": quick, "gisette": gis, "profile": prof,
                    "serve_depth2": depth2, "serve": full,
                    "train_depth2": train2, "train": trained}))
    log(json.dumps({"flecs_m2": {k: v for k, v in m2.items()
                                 if k != "timing"}}))
    log(json.dumps({"flecs_workers": workers}))
    log(json.dumps({"families": families}))
    log(json.dumps({"family_training": fam_train,
                    "family_backward": {k: v for k, v in fam_bwd.items()
                                        if k != "instances"}}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
