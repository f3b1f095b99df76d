#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's paths on one CUDA card and check them.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Phases, each of which raises on failure:

  1. environment — the card's name and power limit (nvidia-smi), torch and
     CUDA versions, the matmul precision flags;
  2. build       — every CUDA kernel, one nvcc each, all started together,
     into build/ (each build's time, registers and spills printed);
  3. kernels     — each kernel against its plain PyTorch version on the
     card: gather_tiles bit for bit (tile counts around its persistent
     grid up to 2^18 + 7, 4 KiB and 2 KiB tiles, maps with repeated and
     with out-of-range entries); rmsnorm, flash_attention and
     decode_attention in bf16 within tests/test_kernels.py's tolerance
     (2e-2) at the serve phases' shapes, with ragged lengths (rmsnorm
     also at 8, the longest prompt's, 1024 and 4096 rows by widths 2048,
     2560 and 3072 in bf16 and at (1024, 2048) in f32, there also bit for
     bit against its strided path (the old kernel), whose reduction order
     it keeps, each timed in turns with the old kernel on inputs rotated
     over 128 MiB, beside the launch floor: an empty kernel through the
     same ctypes path), flash also
     at per-batch query offsets (a prefill at a nonzero cache position)
     and at zamba2's head dim 80; ssd_chunks at every prompt length of
     the serve run padded as apply_ssm pads it, at mamba2's and zamba2's
     widths and at S = 16384 (y within 2e-2, the f32 states and cum within
     1e-3), against the plain version and against ssd_chunks_split_ref,
     the model of its bf16 arithmetic.  Each is then timed beside its plain
     version, one library call (none for ssd_chunks) and its bound, at a
     serve-phase shape and at one larger shape; flash, decode and
     ssd_chunks also at zamba2's serve shapes (head dim 80, one query head
     a KV head: flash at the longest prompt, decode over the 8 slots;
     ssd_chunks at 80 heads and state 64), so the hd-80 tiles, the g = 1
     split and a partial head group are timed too; flash and decode also
     at head dim 128 with the GQA groups of starcoder2-3b (12 query heads a
     KV head), granite-3-8b (4), qwen1.5-110b (8), moonshot-v1-16b-a3b (1)
     and arctic-480b (7), held at every serve length and timed at the
     serve shapes; flash and decode at head dim 96 with phi-3-vision's
     32/32 heads (every serve prompt length, the 8 x 2048 ragged cache),
     timed at P = 938 and over the 8 slots; non-causal flash at
     seamless-m4t's widths (the encoder's self-attention over 512 frames,
     each prompt's cross-attention, a decode step's at Sq = 1), the last
     timed; flash and decode timed at the tensor-parallel members' shapes
     of phase 20 (c) (llama3.2-1b 16 query heads on 4 KV heads of 64 and
     4 rows, zamba2-2.7b 8 on 8 of 80 and 8 rows).  The smoke models' f32 logits on the card (kernels) are held
     against the CPU (plain versions) for all ten models (phi-3 with
     patches, seamless with frames);
  4. Algorithm 2 — every scenario of the registry at the ``full`` preset
     (the mesh-sized families at one device) under uvm, marshal,
     marshal+db, marshal+delta and pointerchain: line-7 check ok and the
     ledger equal to the expected motion exactly;
  5. steady      — marshal+delta steady passes on steady_reuse_n2048;
  6. real size   — the paper's two figures at about 1 GiB under every spec
     (ledger == the closed forms);
  7. pack        — pack_tree / unpack_tree of the dense tree's f32 payload
     through the tile-gather kernel: the packed buffer and the unpacked
     pool each equal to the plain version on the same pool and maps, and
     the round trip bit-exact;
  8. serve       — llama3.2-1b at full width (bf16, all 16 layers, params
     drawn on the card from a seeded torch.Generator) behind
     Server(slots=8, max_seq=2048), 12 requests with prompt lengths drawn
     from 32-1024 and 32 new tokens each: every request completes with 32
     tokens, the lifecycle is conserved, the install pass's region ledgers
     equal the closed forms, the launch counts are exact, and request 0's
     32 tokens equal, exactly, a manual batch-1 prefill + greedy decode
     loop run with the server's slot count (so with its rounding);
  9. serve-mamba2 — mamba2-1.3b at full width and depth (bf16, 48 layers,
     1446652928 params) behind the same server, traffic and checks;
 10. serve-zamba2 — zamba2-2.7b at full width (d_model 2560, 32 heads of
     80, state 64), cut to 12 of its 54 layers (2 applications of the
     shared attention block), the same server, traffic and checks;
 11. serve-starcoder2 — starcoder2-3b at full width and depth (bf16, 30
     layers, 3181274112 params: LayerNorm, the tanh-GeLU MLP, qkv biases,
     24 query heads on 2 KV heads of 128, so no rmsnorm), the same server,
     traffic and checks;
 12. serve-moonshot — moonshot-v1-16b-a3b at full width (64 experts, top
     6 of d_ff 1408, vocab 163840, 16 heads of 128 on 16 KV heads), cut to
     4 of its 48 layers (2953332736 params), the same server, traffic and
     checks.
     Each serve phase has its own TransferSession; its server, programs
     and pinned staging are released (and the pinned bytes printed)
     before the next;
 13. policy      — run_policy_scenario on mixed_policy and elastic at n =
     2^25 (1 GiB + 4 B and 805306376 B of host tree), three passes (cold,
     then two after the scenario's mutation) under the blocking and then
     the async executor, every region ledger equal to its closed form on
     every pass, one synchronize a pass, values equal to the host tree;
     Algorithm 2 over each declared policy (line 7, merged ledger == the
     cold sum); the region-pipelining walls of
     benchmarks/transfer_overlap.py over POLICY_ROUNDS interleaved rounds
     (median, min and max; recorded, not gated); and full-width
     llama3.2-1b params (2471628800 B of bf16, drawn on the card, moved to
     the host) as a model_state cell under every spec (real_size), then
     priced from their signatures alone: the Algorithm-2 step's derivation
     equals the closed form the ledger was held to, and ``policy_cost``
     equals a program pass's region ledgers, cold and steady, under every
     spec.  Each part has its own session, released after it;
 14. analysis    — the static policy analysis: the cost model's wall half
     calibrated on the card (single pageable host-to-card copies of 64 KiB,
     1 MiB and 4 MiB, the minimum of 5 each, then the affine fit; printed
     with the card's name and power limit); check_registry('full') at the
     live mesh and every declared policy resharded to 8 (no error-severity
     diagnostic); for every scenario at ``full``, ``policy_cost`` of its
     signature tree under its declared policy (marshal where it has none)
     equal to the card's region ledgers from run_policy_scenario, cold and
     steady; and the autotuner's three stages on phase 13's two trees at n
     = 2^25: the 27 candidates of enumerate_policies over the declared
     patterns (plus the declared policy, whose ``marshal@dp1`` is not in
     the grid), ranked by the calibrated model's objective_us, the declared
     policy and the best 3 measured (cold + 2 steady passes, a session
     each), predicted bytes and copies equal to the ledger per region, and
     the predicted and measured walls printed (recorded, not gated);
 15. train       — training with rmsnorm and flash_attention under
     autograd (the kernel forward, the plain version's gradient backward):
     (a) the backward's wiring: each Function's gradients on the card
     against torch.autograd of the plain version (rmsnorm dx, dscale at
     (1024, 2048); causal flash dq, dk, dv at batch 8, 32/8 heads, seq 128,
     hd 64), f32 within 1e-5, bf16 within 2e-2; (b) one step of
     llama3.2-1b at full width cut to 2 layers in f32 (batch 2 x seq 128,
     remat "dots"), card against CPU from the same params: the loss within
     rtol 1e-4, every gradient leaf within 2e-3 of its largest element and
     nonzero on the card; (c) llama3.2-1b at full size (bf16, 16 layers,
     AdamW at the CLI's peak lr of 3e-4, batch 8 x seq 128, seeded params
     drawn on the card) trains 12 steps on one batch repeated through
     runtime.loop.run: finite losses, each update with a nonzero lr
     lowering the loss, the last 3 below the first 3 by more than the
     spread of the initial loss over 8 fresh batches,
     launches exactly kernel_launches(train_steps=12); one AsyncCheckpointer save of the
     12.36 GB state, its restore through state_transfer_policy()'s program
     with a StatePrefetcher (region ledgers == closed forms, the state
     equal bit for bit) and one OffloadedOptimizer step under marshal
     (ledger == closed form, params == the resident AdamW's); (d) under
     deterministic algorithms, 8 steps of the model cut to 1 layer
     uninterrupted against a run with a checkpoint every 4 steps and a
     NodeFailure at step 6: trajectory_diff empty, final states equal bit
     for bit; (e) after (c)'s save, the serve CLI (``python -m
     repro_torch.launch.serve``'s ``main``) at full size with its defaults
     (16 requests, 4 slots, max_seq 128, 16 new tokens) and ``--ckpt-dir``
     on (c)'s checkpoint: the served params equal to (c)'s final params
     bit for bit, every request completed, the tokens and the kernel
     launches equal to those of a Server built on the in-memory params
     over the same requests; (f) the other families at full width, each
     on one batch repeated with (c)'s optimizer, peak lr and schedule
     shape: mamba2-1.3b cut to 2 of its 48 layers (batch 8 x seq 512, so
     two 256-token chunks a sequence, 8 steps), zamba2-2.7b cut to 7
     layers and moonshot-v1-16b-a3b cut to 2 (4 steps each): each update
     with a nonzero lr lowering the loss, launches exactly
     kernel_launches(train_steps=) (ssd_chunks 2 x 2 a mamba2 step:
     forward and recompute); then each of the three in f32 (mamba2 and
     zamba2 at 2 layers, moonshot at 1), card vs CPU as (b).  (a) also holds ssd_chunks' autograd Function
     (y_diag, states and cum each carrying a gradient) against autograd
     of the plain version at mamba2's widths.  Printed: step wall,
     tokens/s, device time vs wall of one step, peak device memory,
     checkpoint stall and write rate, the restore's load / reshard / h2d
     split and rate, pinned bytes, the CLI's restore wall and tokens/s;
 16. sanitizer   — run after phase 14 and before phase 15, so the card holds
     no train state: (a) under ``sanitize()``, phase 4's Algorithm-2
     matrix, phase 6's two real-size trees under every spec (two passes,
     cold and steady, on one executor each; a steady marshal+delta pass
     moves nothing) and
     phase 13's mixed_policy program under both executors: no finding,
     every ledger its closed form, one barrier a program pass, each
     drive's events printed; (b) the steady pass wall of a 1 GiB f32 tree
     under marshal+db and marshal+delta, alternating passes without and
     with one sanitizer, and one fingerprint of the 1 GiB staging buffer
     (recorded, not asserted); (c) the six seeded mutants of
     tests/test_torch_sanitizer_mutants.py on a 256 MiB tree on the card,
     each raising its own code (DC301-DC306) and its clean counterpart
     silent; for DC301 and DC305 the copy stream is held so the copy is in
     flight, and whether the card's bytes differ from those enqueued is
     printed (and first, the DC301 mutant without the sanitizer);
 17. multimodal  — after phase 15: phi-3-vision-4.2b (32 layers, head dim
     96, 3830516736 params) and seamless-m4t-medium (12 + 12 layers,
     614926336 params) at full size, bf16, seeded on the card.  Each runs
     first through the registry: 8 requests of 32-512 text tokens
     prefilled one by one with their seeded side input (phi-3: 576 patch
     embeddings before the prompt; seamless: frames (1, 512, 1024),
     encoded at every prefill), their caches stacked into 8 slots, 32
     greedy tokens each; launches exact, request 0's tokens equal to a
     batch-1 prefill + greedy decode over 8 slots.  Then behind phase 8's
     Server and traffic (text prompts: the Server passes neither patches
     nor frames, as the reference's does), with phase 8's checks and
     install ledgers held to their closed forms;
 18. sharded     — after phase 17: the sharded deep copy (@dpK) on a mesh
     of SHARD_K = 4 positions, position i on cuda:(i mod the visible card
     count) (on one card every position sits on cuda:0: the per-shard
     staging views, copies, event fences, delta versions and write checks
     run on the real copy engine, but that is not multi-GPU).  (a) the
     mesh and the card count printed; (b) Algorithm 2 on the sharded and
     sharded_delta trees at n = 2^26 (2^30 B of f32 and a 64 B id table
     each) under uvm@dp4, marshal@dp4, marshal+delta@dp4 and
     pointerchain@dp4: line 7 ok and every position's ledger its closed
     form (SHARD_CLOSED), then each position's H2D rate (its copies timed
     alone with CUDA events); (c) three marshal+delta@dp4 steady passes on
     the sharded_delta tree after mutating hot.a and hot.b: exactly
     shards 2 and 3 of the f32 bucket ship (2^28 B in one copy each),
     h2d + skipped == full on every position, values == the host tree;
     (d) mixed_policy and elastic at n = 2^25 on the mesh, three passes
     under each executor: every region's per-position ledger equal to the
     family's closed form and to policy_cost's, one barrier a pass; (e)
     the registry's full sharded and sharded_delta families at the live
     card count under every spec they declare; (f) (b)'s sharded_delta
     cells once more under ``sanitize()``: no finding;
 19. dp          — after phase 18, on the same DP_K positions (on one card
     the collectives' pieces are device-local copies: not multi-GPU):
     (a) llama3.2-1b at full width cut to DP_LAYERS layers, bf16, AdamW,
     dp 4, batch 8 x 128, under deterministic algorithms: in float32 at
     2 layers the 4 slices' gradients summed by the collective within
     DP_GRAD_TOL of 4 x the dp-1 gradient over the whole batch; on one
     replicated bf16 state, arena's synced gradients equal to
     pertensor's bit for bit and within BF16_TOL of the float32 sum of
     the local gradients; then DP_STEPS steps under each of
     pertensor, arena and arena+int8 from that state: every position's
     params and optimizer state equal bit for bit after every step, the
     collective calls exact (one psum a gradient leaf; one psum_scatter
     and one all_gather a bucket; one pmax and one psum a bucket; one
     pmean of the loss), arena's losses equal to pertensor's and int8's
     within DP_INT8_LOSS_TOL; printed: the losses, step walls, peak
     memory and, from the last step under torch.profiler, the device time
     of each collective's copies and adds; (b) apply_moe_sharded on one
     moonshot-v1-16b-a3b layer at full width (seeded bf16 weights), x (8,
     128, 2048), on meshes (4, 1) and (2, 2): each ep slice equal to the
     plain layer on it within BF16_TOL, and the tokens that kept every
     choice (and routed alike) in both paths equal to the plain layer
     over the whole batch within BF16_TOL; the aux loss printed; (c)
     run_elastic 4 -> 2 and 2 -> 4 with make_train_step on llama3.2-1b
     cut to ELASTIC_LAYERS layers, as benchmarks/elastic_restart.py runs
     it, under deterministic algorithms: trajectory_diff against the
     uninterrupted run empty, one policy re-derivation, the last
     checkpoint restored through the survivor's policy and replicated
     onto m positions equal to it bit for bit on each; the restore split
     printed.
 20. launch      — after phase 19, on four positions of phase 18's mesh (one
     card: not multi-GPU), under deterministic algorithms: (a) the
     production-mesh step (``make_sharded_train_step``) tensor-parallel
     over its model axis (``models/tp.py``), first for the vlm, the MoE,
     the ssm and the hybrid family: phi-3-vision-4.2b on (2, 2) (heads,
     d_ff and vocab split; 576 seeded patch embeddings a row),
     moonshot-v1-16b-a3b on (1, 4) (heads, every expert's d_ff and vocab
     split; the one row block routes as one position does), mamba2-1.3b
     on (2, 2) (each Mamba2 mixer's 64 heads, 32 a position, and their
     channels; vocab 50280 splits by 2) and zamba2-2.7b on (1, 4) (20 of
     the mixers' 80 heads a position, 8 of the shared block's 32 heads,
     a quarter of its d_ff and of the vocab; at 2 layers the shared block
     applies once), and the encoder-decoder, seamless-m4t-medium on (2,
     2) (8 of the 16 heads of every self- and cross-attention, half of
     both stacks' d_ff and of the vocab 256206; 32 seeded frames a row),
     each at full width cut to 2 layers (seamless: 2 encoder + 2
     decoder), bf16, AdamW, batch 8 x 128, 2 steps: the regions split as
     listed, the predicted peak under the limit, the losses within
     LAUNCH_LOSS_TOL of make_train_step's on one position, the replicas
     bit-equal, every block equal to the gathered state's, launches
     exactly mesh size x kernel_launches a step; the median wall, peak,
     gathered params and one profiled step's device time and idle share
     printed.  Then on a
     (2, 2) mesh (each position computes its 16 of the 32 heads, half of
     d_ff and half of the vocab): llama3.2-1b at full width cut to
     LAUNCH_LAYERS layers, bf16, AdamW at
     LAUNCH_LR, batch 8 x 128, 3 steps from a seeded state, and apart
     from them one step from that state on labels masked unevenly over
     the row blocks (block 0 all masked, half of block 1): the predicted
     peak printed first, the losses within LAUNCH_LOSS_TOL of
     make_train_step's on one position from the same state, the model
     axis's replicas bit-equal after every step, every block equal to its
     block of the gathered state, launches exactly 4 x kernel_launches a
     step; the median step wall and the peak, then apart from the run one
     step's wall and, profiled, its device time and the device's idle
     share, printed; before it, f32 at 2 layers under SGD-momentum, 2 steps and
     apart from them a masked one, within 1e-5
     (losses) and DP_GRAD_TOL (leaves) of one position; (b) (a)'s state
     saved, then restored with ``restore(shardings=)`` onto (4, 1) and
     (1, 4) under each mesh's train rules: every block equal to the
     host's bit for bit, the blocks' bytes equal, exactly, to the dry
     run's placement summed over the positions (the allocator's growth
     printed); (c) placed prefill and decode (``runtime.placed``), each
     model group tensor-parallel over the model axis (``lm.serve_tp``):
     llama3.2-1b at full size on (2, 2) (16 of the 32 heads, half of
     d_ff and of the vocab a position): phase 8's first 8 prompts each
     prefilled into its slot of an 8 x 2048 cache (batch over data, its
     sequence over model), 8 decode steps fed the one-position run's
     greedy tokens: every logit and every block of every cache leaf
     within BF16_TOL of the one-position run's (batch-1 prefills stacked
     into 8 slots), every block equal to its block of the gathered leaf,
     launches exact; then the same in f32 cut to 2 layers, within 2e-4 of
     the largest, and zamba2-2.7b at full width cut to 2 layers on (1,
     4) (its cache's sequence 4 ways, its state and conv tail by the
     mixers' heads), and seamless-m4t-medium at full width
     (``encdec.serve_tp``; 512 seeded frames a prompt, encoded at each
     prefill) on (2, 2) in f32 (8 of the 16 heads of every self- and
     cross-attention, half of both stacks' d_ff and of the vocab 256206)
     cut to 2 + 2 layers (finite) and to 1 + 1 (within 2e-4 of the
     largest), and on (1, 4) in bf16 (4 of 16 heads, a quarter of d_ff,
     the vocab whole) cut to 1 + 1 (finite); (d) the four
     ``examples/torch_*.py`` through ``main(argv)`` at small sizes:
     quickstart's transfers and bytes equal to its tree's closed forms,
     the demo's DMAs and MB equal to its CPU run's, serve completes 8
     requests, train restarts once; (e) the dry run's llama3.2-1b train_4k
     cell on both production meshes (meta positions, host counts): 2/2
     ok, the probe identity exact, the memory keys reported; then (a)'s
     llama3.2-1b config (4 layers, bf16, AdamW, 8 x 128) on a (1, 1)
     mesh of cuda:0, one train step, one placed prefill and one decode
     step, each after a warm-up: the growth of the card allocator's peak
     over the call within 5 % (or 16 MiB) of the dry run's prediction on
     a (1, 1) meta mesh, each storage rounded up to the allocator's 512
     bytes; launches exact.

Each path is driven with the launch counters set to 0 just before it and
read just after: Algorithm 2 (phases 4-6) must launch no kernel, as the
reference engine calls none; the pack path must launch gather_tiles
exactly twice (pack and unpack) and nothing else; a serve path launches
what ``repro_torch.models.lm.kernel_launches`` gives for its own prefill
and decode-step counts, exactly: llama rmsnorm 33 per forward (prefill
request or decode step), flash 16 per prefill request, decode 16 per
step; mamba2 rmsnorm 49 per forward and
ssd_chunks 48 per prefill request; zamba2 rmsnorm 17 per forward, flash 2
and ssd_chunks 12 per prefill request, decode 2 per step; starcoder2 no
rmsnorm, flash 30 per prefill request, decode 30 per step; moonshot (4
layers) rmsnorm 9 per forward, flash 4 per prefill request, decode 4 per
step; phi-3 rmsnorm 65 per forward, flash 32 per prefill request, decode
32 per step; seamless no rmsnorm, flash 12 (the encoder, given frames) +
24 per prefill request, decode 12 and flash 12 per step; gather_tiles
never; the policy, analysis, sanitizer and sharded
phases launch nothing; the serve CLI launches what a Server on the same params
and requests launches; a train step launches rmsnorm 2L + 1 and flash L times per
forward, and under remat the blocks' 2L and L again in the backward
(llama: 65 and 32 a step; a Mamba2 model's ssd_chunks L, and L again); the
dp phase launches a train step's count on every position of every step
(4 x 9 rmsnorm and 4 x 4 flash a dp step at 2 layers; each of an elastic
survivor's m positions a step's count) and nothing in the MoE layer;
the launch phase's sharded steps launch 4 x a train step's count a step
(llama, phi-3-vision, moonshot, mamba2 and zamba2: ssd_chunks once a
member a Mamba2 layer, on its heads; seamless-m4t-medium at 2 + 2
layers: flash 12 a member a step, on its heads, and no rmsnorm) and its
placed prefill and decode, tensor-parallel, what kernel_launches gives
for the slot's holders x the prompts (2 on (2, 2), 4 on (1, 4)) and 4 x
the steps, each member launching on its heads.
The last lines are the card's name and power limit, a ``kernels`` JSON
line (launches summed over the serve phases 8-12 and 17, and per phase,
the train runs, the serve CLI, the sharded phase, the dp phase and the
launch phase under ``launches_by_phase``) and
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits with code 2 and prints no result.

Matmul precision: ``torch.backends.cuda.matmul.allow_tf32`` is set to False
(the default: f32 products in full f32); the bf16 reduced-precision
reduction flag is left at its default and printed.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

# deterministic cuBLAS for phase 15's bit-identical restart: read when the
# first cuBLAS handle is made, so set before any phase runs a product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SPECS = ("uvm", "marshal", "marshal+db", "marshal+delta", "pointerchain")
# phase 6's two real-size trees: each scheme kind's (bytes, copies), closed
# forms (dense_case(8, 524288, 3), linear_case(6, 33554432,
# "allinit-allused"))
REAL_CLOSED = {"dense": {"marshal": (1226836552, 2), "uvm": (2097180, 8),
                         "pointerchain": (2097152, 1)},
               "linear": {"marshal": (805306512, 2), "uvm": (805306368, 6),
                          "pointerchain": (805306368, 6)}}
GIB_TILES = 262144                       # 262144 f32 tiles of 4 KiB = 1 GiB
H100_SXM_BANDWIDTH = 3.35e12             # bytes/s, NVIDIA's H100 SXM data sheet
H100_SXM_BF16_FLOPS = 989e12             # dense bf16 tensor-core FLOP/s, same sheet
H100_SXM_F32_FLOPS = 67e12               # f32 outside the tensor cores, same sheet
BF16_TOL = 2e-2                          # tests/test_kernels.py's bf16 tolerance
SSD_F32_TOL = 1e-3                       # ssd_chunks' f32 states and cum

# the serve phases: each model at full width, the same server and traffic
SERVE_SLOTS = 8
SERVE_MAX_SEQ = 2048
SERVE_REQUESTS = 12
SERVE_NEW_TOKENS = 32
SERVE_PROMPT_RANGE = (32, 1024)          # inclusive, numpy default_rng(0)
# the install pass's region ledgers (bytes, copies), closed forms: 1235814400
# bf16 params (every leaf a multiple of 128 elements), k and v (16, 8, 2048,
# 8, 64) bf16 plus pos (8,) int32, and the (8,) int32 slot table's two leaves
SERVE_LEDGERS = {"params/**": (2471628800, 1), "cache/**": (536870944, 2),
                 "**": (64, 2)}
# the SSM serve phases (9, 10): the cache region's (bytes, copies), closed
# forms — mamba2: state (48, 8, 64, 64, 128) f32 805306368 B + conv (48, 8,
# 3, 4096) bf16 9437184 B + pos 32 B; zamba2 at 12 layers: state (12, 8, 80,
# 64, 64) f32 125829120 B + conv (12, 8, 3, 5120) bf16 2949120 B + k and v
# (2, 8, 2048, 32, 80) bf16 335544320 B + pos 32 B; one copy per dtype.  The
# params region is the port's arena.plan of the 128-aligned params.
SSM_CACHE_LEDGERS = {"mamba2-1.3b": (814743584, 3),
                     "zamba2-2.7b": (464322592, 3)}
ZAMBA_LAYERS = 12                        # of 54: 2 shared-block applications
# the attention variants (phases 11, 12): the install pass's region ledgers
# (bytes, copies), closed forms.  starcoder2-3b at full width and depth:
# 3181274112 bf16 params (every leaf a multiple of 128 elements); k and v
# (30, 8, 2048, 2, 128) bf16 plus pos.  moonshot-v1-16b-a3b at full width
# cut to 4 of its 48 layers: 2953332736 bf16 params; k and v (4, 8, 2048,
# 16, 128) bf16 plus pos.  The slot table is SERVE_LEDGERS'.
VARIANT_LEDGERS = {
    "starcoder2-3b": {"params/**": (6362548224, 1),
                      "cache/**": (503316512, 2),
                      "**": SERVE_LEDGERS["**"]},
    "moonshot-v1-16b-a3b": {"params/**": (5906665472, 1),
                            "cache/**": (536870944, 2),
                            "**": SERVE_LEDGERS["**"]},
}
MOONSHOT_LAYERS = 4                      # of 48: staging near the others'
# the head-dim-128 attention shapes phase 3 holds and times: 12, 4, 8, 1
# and 7 query heads a KV head
HD128_ARCHS = ("starcoder2-3b", "granite-3-8b", "qwen1.5-110b",
               "moonshot-v1-16b-a3b", "arctic-480b")
# the policy phase (13): mixed_policy and elastic at n = 2^25 (one device),
# each region's (bytes, copies) on the cold pass and on a steady pass after
# the scenario's mutation, closed forms: params w + b, 3n f32; mixed_policy's
# opt m + v, 2n f32, + t, 4 B; its meta ids 2n i32 + scale n f32, one copy a
# leaf; elastic's opt mu + nu, 3n f32, + t; its step, 4 B
POLICY_N = 2 ** 25
POLICY_PASSES = 3
POLICY_ROUNDS = 5                        # interleaved region-pipelining rounds
POLICY_LEDGERS = {
    "mixed_policy": ({"params/**": (402653184, 1), "opt/**": (268435460, 2),
                      "**": (402653184, 2)},
                     {"params/**": (402653184, 1), "opt/**": (268435456, 1),
                      "**": (402653184, 2)}),
    "elastic": ({"params/**": (402653184, 1), "opt/**": (402653188, 2),
                 "**": (4, 1)},
                {"params/**": (402653184, 1), "opt/**": (402653184, 1),
                 "**": (4, 1)}),
}
# Algorithm 2 over each declared policy: the merged ledger, the cold sum
POLICY_ALG2 = {"mixed_policy": (1073741828, 5), "elastic": (805306376, 4)}
# full-width llama3.2-1b params (bf16, 11 leaves) as a model_state cell:
# marshal ships them all (phase 8's params region), uvm and pointerchain the
# embedding (525336576 B) and final_norm (4096 B)
MODEL_STATE_BYTES = 2471628800
MODEL_STATE_CLOSED = {"marshal": (MODEL_STATE_BYTES, 1),
                      "uvm": (525340672, 2), "pointerchain": (525340672, 2)}
# the analysis phase (14): the autotuner's grid over each declared policy's
# three patterns on one card (3 candidate specs a pattern), and how many of
# the calibrated model's best-ranked candidates are measured beside the
# declared policy, each over a cold and two steady passes
ANALYSIS_GRID = 27
ANALYSIS_TOP = 3
ANALYSIS_PASSES = 3
# the train phase (15): llama3.2-1b at launch/train.py's batch 8 x seq 128,
# AdamW, peak lr and schedule shape (warmup_cosine over the run, 2 warmup
# steps) for 12 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 128, 12, 3e-4
# (c) trains on one batch repeated, so the model must learn it: every
# update with a nonzero lr must lower the loss on that batch, and the mean
# loss of the last 3 steps must lie below the first 3's by more than the
# spread (max - min) of the initial model's loss over TRAIN_SPREAD_BATCHES
# fresh batches
TRAIN_SPREAD_BATCHES = 8
TRAIN_NORM_ROWS = 1024                   # (a): rmsnorm on (1024, 2048)
RMS_TRAIN_ROWS = 1024                    # phase 3: llama's 8 x 128 train step
RMS_FAMILY_ROWS = 4096                   # mamba2 / zamba2 / moonshot 8 x 512
RMS_ROTATE_BYTES = 128 << 20             # phase 3: rmsnorm's inputs, > L2's 50 MB
TRAIN_F32_TOL = 1e-5                     # (a): f32 gradients vs plain
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH = 2, 2   # (b): full width, f32
# (b): each gradient leaf, card vs CPU, of the leaf's largest |grad|: two
# float32 implementations summing in different orders (the port and the
# reference differ by up to 1.2e-4 on the smoke model)
TRAIN_STEP_TOL = 2e-3
# (c): the restore pass's region ledgers (bytes, copies), closed forms:
# 1235814400 bf16 params (every leaf a multiple of 128 elements) in one
# bucket; mu and nu, 2 x 1235814400 f32, plus the int32 count; the step.
# The offloaded optimizer step moves the same opt state under marshal.
TRAIN_STATE_LEDGERS = {"params/**": (2471628800, 1),
                       "opt/**": (9886515204, 2), "**": (4, 1)}
OFFLOAD_LEDGER = (9886515204, 2)
# (d): full width cut to 1 of 16 layers (3.23 GB a checkpoint; 3 before
# phase 20 (a) took the ssm and hybrid runs, cut for the script's wall), 8
# steps (saves at steps 4 and 8; the script's wall sets the count), a
# NodeFailure at step 6
RESTART_LAYERS, RESTART_STEPS, RESTART_EVERY, RESTART_FAIL = 1, 8, 4, 6
# the sanitizer phase (16): passes per real-size spec (a cold and a steady
# one; three until PR 24, cut to keep the script's wall as phase 19 came
# in); the overhead tree (2^28 f32, 1 GiB) and its alternating rounds; the
# mutants' tree (2^26 f32, 256 MiB, so a copy is really in flight) and how
# long the copy stream is held for DC301 and DC305
SAN_PASSES = 2
SAN_OVERHEAD_N, SAN_ROUNDS = 2 ** 28, 5
SAN_MUTANT_N, SAN_HOLD_S = 2 ** 26, 1.0
# (e): the serve CLI's defaults (repro_torch/launch/serve.py, the
# reference's): requests, slots, max_seq and new tokens a request
SERVE_CLI = {"requests": 16, "slots": 4, "max_seq": 128, "max_new": 16}
# (f): the other families trained at full width.  mamba2-1.3b cut to
# MAMBA_TRAIN_LAYERS of its 48 layers (for the script's wall), 8 steps;
# batch 8 x seq 512, so each sequence spans two 256-token chunks and the
# inter-chunk recurrence carries gradient; then zamba2-2.7b cut to
# ZAMBA_TRAIN_LAYERS of 54 layers and moonshot-v1-16b-a3b cut to 2 of 48
# layers, 4 steps each; AdamW at the CLI's peak lr with the CLI's schedule
# shape, one batch repeated.  moonshot at its serve depth of 4
# layers (2953332736 params) does not fit: the functional AdamW holds the
# old and the new f32 moments (2 x 23.6 GB) at once beside the params and
# gradients, and such a run went out of memory in its first update with
# 69.45 GB allocated (H100 80GB HBM3)
FAMILY_BATCH, FAMILY_SEQ = 8, 512
MOONSHOT_TRAIN_LAYERS = 2
MAMBA_TRAIN_LAYERS = 2                   # of 48 (was 8): the script's wall
ZAMBA_TRAIN_LAYERS = 7                   # of 54 (was 12): still 2 shared-
                                         # block applications (layers 0, 6)
FAMILY_RUNS = (("mamba2-1.3b", MAMBA_TRAIN_LAYERS, 8),
               ("zamba2-2.7b", ZAMBA_TRAIN_LAYERS, 4),
               ("moonshot-v1-16b-a3b", MOONSHOT_TRAIN_LAYERS, 4))
# (f)'s card-vs-CPU check of each family at full width in f32 (part (b)'s
# tolerance), (layers, seq) at batch 2: the Mamba2 models at 2 layers and
# seq 512 (two chunks); moonshot at 1 layer (for the script's wall: at 2,
# its 1.8e9 f32 params on the CPU took 35 s) and seq 128
FAMILY_CHECK = {"mamba2-1.3b": (TRAIN_CHECK_LAYERS, 512),
                "zamba2-2.7b": (TRAIN_CHECK_LAYERS, 512),
                "moonshot-v1-16b-a3b": (1, TRAIN_SEQ)}
# the multimodal phase (17): phi-3-vision-4.2b and seamless-m4t-medium at
# full size.  The registry run: MM_REQUESTS requests of MM_PROMPT_RANGE
# text tokens (numpy default_rng(17)), MM_NEW_TOKENS greedy tokens each;
# phi-3's 576 patches before each prompt, seamless' frames (1,
# SERVE_MAX_SEQ / 4, 1024), the length of its cache's encoder memory, so
# the requests' caches stack into slots.  The Server run: phase 8's
# traffic.  Its install ledgers (bytes, copies), closed forms: phi-3
# 3830516736 bf16 params (every leaf a multiple of 128 elements), k and v
# (32, 8, 2048, 32, 96) bf16 plus pos; seamless 614926336 bf16 params, k
# and v (12, 8, 2048, 16, 64) and enc_out (8, 512, 1024) bf16 plus pos
MM_ARCHS = (("phi-3-vision-4.2b", "serve-phi3"),
            ("seamless-m4t-medium", "serve-seamless"))
MM_REQUESTS, MM_NEW_TOKENS = 8, 32
MM_PROMPT_RANGE = (32, 512)
MM_LEDGERS = {
    "phi-3-vision-4.2b": {"params/**": (7661033472, 1),
                          "cache/**": (6442450976, 2),
                          "**": SERVE_LEDGERS["**"]},
    "seamless-m4t-medium": {"params/**": (1229852672, 1),
                            "cache/**": (813695008, 2),
                            "**": SERVE_LEDGERS["**"]},
}

# the sharded phase (18): a SHARD_K-position mesh on the visible cards,
# position i on cuda:(i mod count) (on one card every position sits on
# cuda:0: the per-device arenas, copies, fences and delta versions run,
# but that is not multi-GPU).  The sharded and sharded_delta families at n
# = 2^26 (2^30 B of f32 plus a 64 B id table each) under the four @dp4
# specs; each position's (bytes, copies), closed forms: marshal (2^30 +
# 64) / 4 in 2 (the f32 and the i32 bucket's shard); the per-leaf schemes
# the used leaves' rows, w + v = 2^30 / 4 (sharded) and hot.a + cold = 3 *
# 2^26 (sharded_delta), in 2.  A steady marshal+delta@dp4 pass after
# mutating hot.a and hot.b ships shards 2 and 3 of the f32 bucket, 2^28 B
# in one copy each.  The policy families at n = 2^25 over the same mesh.
SHARD_K = 4
SHARD_N = 2 ** 26
SHARD_SPECS = tuple(f"{s}@dp{SHARD_K}" for s in
                    ("uvm", "marshal", "marshal+delta", "pointerchain"))
SHARD_CLOSED = {"sharded": {"marshal": ((2 ** 30 + 64) // 4, 2),
                            "per_leaf": (2 ** 28, 2)},
                "sharded_delta": {"marshal": ((2 ** 30 + 64) // 4, 2),
                                  "per_leaf": (3 * 2 ** 26, 2)}}
SHARD_STEADY = {"2": (2 ** 28, 1), "3": (2 ** 28, 1)}
SHARD_PASSES = 3
SHARD_POLICY_N = 2 ** 25
# the dp phase (19): SHARD_K positions of the same mesh.  (a) the dp step on
# llama3.2-1b at full width cut to DP_LAYERS of 16 layers (PERF.md §4: four
# replicas of params and AdamW moments and the update's new set beside the
# old; the depth set by the script's wall), batch DP_BATCH x DP_SEQ (two
# rows a position), AdamW at the CLI's peak lr, DP_STEPS steps a scheme;
# the K slices' float32
# gradients summed against K x the dp-1 gradient within DP_GRAD_TOL of each
# leaf's largest element; int8's losses within DP_INT8_LOSS_TOL of
# pertensor's (the reference's tests/test_distributed.py bound).  (b) one moonshot MoE layer
# at full width, x (MOE_BATCH, MOE_SEQ, d).  (c) run_elastic over
# ELASTIC_EPISODES on llama3.2-1b at full width cut to ELASTIC_LAYERS
# layers (3.23 GB of train state a checkpoint; the depth set by the
# script's wall), benchmarks/elastic_restart.py's batch, steps, crash and
# checkpoint interval
DP_K = SHARD_K
DP_LAYERS = 2                            # of 16 (was 4): the script's wall
DP_BATCH, DP_SEQ, DP_STEPS = 8, 128, 3
DP_GRAD_TOL = 2e-2
DP_INT8_LOSS_TOL = 0.1
MOE_BATCH, MOE_SEQ = 8, 128
ELASTIC_LAYERS = 1
ELASTIC_BATCH, ELASTIC_SEQ = 4, 32
ELASTIC_STEPS, ELASTIC_CRASH, ELASTIC_EVERY = 8, 6, 4
ELASTIC_EPISODES = ((4, 2), (2, 4))

# phase 20 (launch): the production-mesh tooling on four positions of
# phase 18's mesh.  (a) the sharded step on a (2, 2) mesh: llama3.2-1b at
# full width cut to LAUNCH_LAYERS of its 16 layers (at 16 the save of (b)
# alone took 30.38 s: 12.36 GB at 0.41 GB/s), bf16, AdamW at LAUNCH_LR,
# batch LAUNCH_BATCH x LAUNCH_SEQ, LAUNCH_STEPS steps; its f32 check at
# TRAIN_CHECK_LAYERS layers under SGD-momentum (AdamW's first update is lr
# * g / |g|, which turns float32 noise into lr-sized differences), held
# as phase 19 holds its f32 gradient identity at 2 layers: losses within
# LAUNCH_F32_LOSS_RTOL, every leaf within DP_GRAD_TOL of its largest
# element (two row counts' products round apart on the card).  (b)
# restores onto LAUNCH_RESTORE_MESHES.  (c) LAUNCH_PROMPTS of phase 8's
# prompts prefilled into the slots of a placed cache, LAUNCH_NEW decode
# steps.  (d) the four examples at small sizes.  (e) the dry run's
# llama3.2-1b train_4k cell on both production meshes, then its memory
# analysis against the card's allocator: (a)'s llama config on a (1, 1)
# mesh, the allocator's peak over one call within LAUNCH_MEMORY_TOL of
# the prediction (or LAUNCH_MEMORY_SLACK where that is larger).
LAUNCH_MESH = (2, 2)
LAUNCH_LAYERS = 4                        # of 16: the script's wall (PERF.md)
LAUNCH_BATCH, LAUNCH_SEQ, LAUNCH_STEPS = 8, 128, 3
LAUNCH_LR = 3e-4
LAUNCH_LOSS_TOL = 2e-2                   # bf16 sharded vs one position,
                                         # as _close: atol + rtol
LAUNCH_F32_LOSS_RTOL = 1e-5             # f32 losses; the leaves: DP_GRAD_TOL
LAUNCH_PEAK_LIMIT = 70e9
LAUNCH_RESTORE_MESHES = ((4, 1), (1, 4))
LAUNCH_PROMPTS, LAUNCH_NEW = 8, 8
# (c) is tensor-parallel: the group's psums add in another order than
# one position's products, and the seeded model amplifies any rounding
# with depth (scripts/torch_placed_tp_spread.py: at 16 layers one f32 ulp
# of the params moves llama3.2-1b's logits by as much as their largest,
# in bf16 the placed and one-position logits part by 0.0156 at 1 layer,
# 0.145 at 2, 4.67 at 16).  So the full-depth runs are held finite and
# their distance printed, and the values are held where rounding stays
# small: bf16 at LAUNCH_SERVE_BF16_LAYERS within BF16_TOL, f32 at
# LAUNCH_SERVE_F32_LAYERS within LAUNCH_SERVE_F32_TOL of the largest.
# zamba2-2.7b is cut to 2 of its 54 layers (2 Mamba2 mixers, one
# application of the shared attention block) on (1, 4)
LAUNCH_SERVE_BF16_LAYERS = 1
LAUNCH_SERVE_F32_LAYERS = 2
LAUNCH_SERVE_F32_TOL = 2e-4
LAUNCH_SERVE_ZAMBA_LAYERS = 2
# seamless-m4t-medium, each prompt with SERVE_MAX_SEQ / src_ratio seeded
# frames: in f32 on LAUNCH_MESH (heads, d_ff and the vocab split) at
# LAUNCH_SERVE_SEAMLESS_LAYERS encoder + decoder layers, held finite, and
# at LAUNCH_SERVE_SEAMLESS_HELD_LAYERS within LAUNCH_SERVE_F32_TOL of the
# largest; in bf16 on (1, 4) (heads and d_ff; 256206 does not divide by
# 4, as by 16 at full size) at LAUNCH_SERVE_SEAMLESS_HELD_LAYERS, held
# finite.  Its seeded model amplifies rounding faster than llama's
# (scripts/torch_placed_tp_spread.py, the first prompt on (2, 2)): at 2 +
# 2 layers one f32 ulp of the params moves the logits by 0.011-0.023 of a
# largest 2.98, and f32 placed and one-position logits part by 0.0056
# (0.054 over (c)'s prompts and steps); at 1 + 1 by 6e-5 to 9.6e-5 and
# 5.6e-5.  In bf16 at 1 + 1 placed and one position part by 0.039 where
# bf16 lies 0.67 from f32: past BF16_TOL at a small logit
LAUNCH_SERVE_SEAMLESS_LAYERS = 2
LAUNCH_SERVE_SEAMLESS_HELD_LAYERS = 1
# (a) also the vlm, the MoE, the ssm and the hybrid family tensor-parallel
# over the model axis, each at full width cut to LAUNCH_FAMILY_LAYERS
# layers, bf16, AdamW at LAUNCH_LR, LAUNCH_BATCH x LAUNCH_SEQ text tokens,
# LAUNCH_FAMILY_STEPS steps, against make_train_step on one position:
# phi-3-vision-4.2b on (2, 2) with its 576 seeded patch embeddings a row;
# moonshot-v1-16b-a3b on (1, 4), whose one row block is the whole batch,
# so routing, capacity and the aux loss are one position's; mamba2-1.3b on
# (2, 2), where the data axis splits the rows too; zamba2-2.7b on (1, 4),
# its shared block applied once; seamless-m4t-medium on (2, 2), both its
# stacks cut to LAUNCH_FAMILY_LAYERS, with LAUNCH_SEQ / src_ratio seeded
# frames a row.  With the regions each must split.
LAUNCH_FAMILIES = (("phi-3-vision-4.2b", (2, 2), ("heads", "mlp", "vocab")),
                   ("moonshot-v1-16b-a3b", (1, 4),
                    ("heads", "vocab", "experts")),
                   ("mamba2-1.3b", (2, 2), ("ssm", "vocab")),
                   ("zamba2-2.7b", (1, 4), ("ssm", "heads", "mlp", "vocab")),
                   ("seamless-m4t-medium", (2, 2), ("heads", "mlp", "vocab")))
LAUNCH_FAMILY_LAYERS, LAUNCH_FAMILY_STEPS = 2, 2
CUDA_ALLOC_GRANULE = 512                 # the caching allocator's rounding
LAUNCH_MEMORY_TOL, LAUNCH_MEMORY_SLACK = 0.05, 16 << 20


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def memory_bandwidth(name: str) -> float:
    """The H100 SXM's (its CUDA name is "NVIDIA H100 80GB HBM3"); the
    bound is stated for no other card."""
    if "H100" in name and "HBM3" in name:
        return H100_SXM_BANDWIDTH
    fail(f"the bounds are stated for the H100 SXM only, not {name!r}")


def time_ms(fn, device, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls: CUDA
    events on the card.  The device is held busy (``torch.cuda._sleep``)
    while the host queues the timed calls, so a call whose launch costs
    the host more than the kernel costs the card is timed on the card, not
    by the host's dispatch rate; Python's garbage collector is off while
    they are queued."""
    import torch

    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # no collection while queueing: a pause longer than the hold below
    # would leave the card idle inside the timed span
    collecting = gc.isenabled()
    gc.disable()
    try:
        # ~2e9 cycles a second: hold the card for twice the queueing time
        torch.cuda._sleep(int(min(2.0, 2 * iters * host_s + 1e-3) * 2e9))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    finally:
        if collecting:
            gc.enable()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 3 -----------------------------------------------------------------

# tile counts around the kernel's persistent grid (a few blocks per SM):
# below, at and just past one block per SM, several blocks per SM, 2^18 + 7
GRID_TILES = (1, 131, 132, 133, 4 * 132 + 5, 2 ** 18 + 7)


def check_gather_tiles(device, big_tiles: int) -> dict:
    """gather_tiles vs its plain version, bit for bit: f32/bf16/int32 at 1,
    4 and 17 tiles and f32/bf16 (4 KiB / 2 KiB tiles) at GRID_TILES, by
    random permutation maps; a map with repeated entries; a map with
    out-of-range entries (those tiles are not written, every other one
    must equal the plain version); then f32 at ``big_tiles``, timed."""
    import numpy as np
    import torch
    from repro_torch.kernels.marshal_pack import kernel as K, ref

    tile = K.TILE
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0

    def same(got, want, what):
        nonlocal max_err
        if not torch.equal(got, want):
            fail(f"gather_tiles != plain for {what}")
        max_err = max(max_err, float((got.double() - want.double())
                                     .abs().max()))

    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        counts = (1, 4, 17) + (GRID_TILES if dtype != torch.int32 else ())
        for n in counts:
            src = (torch.randn(n * K.SUBLANE, K.LANE, generator=gen) * 10
                   ).to(dtype).to(device)
            tmap = torch.randperm(n, generator=gen).to(torch.int32).to(device)
            got = K.gather_tiles(src, tmap)
            want = ref.pack_ref(src.reshape(-1), tmap, tile).reshape(-1, K.LANE)
            same(got, want, f"{dtype} x {n} tiles")
    rng = np.random.default_rng(0)
    src = torch.randn(97 * K.SUBLANE, K.LANE, generator=gen).to(device)
    tmap = torch.from_numpy(rng.integers(0, 97, 1500).astype(np.int32)
                            ).to(device)
    same(K.gather_tiles(src, tmap), ref.pack_ref(src.reshape(-1), tmap, tile)
         .reshape(-1, K.LANE), "1500 tiles from 97 by a map with repeats")
    if device.type != "cuda":
        return {"max_abs_err": max_err}      # the plain version raises there
    m = rng.integers(0, 97, 700).astype(np.int32)
    bad = rng.random(700) < 0.2
    m[bad] = rng.choice(np.array([-1, 97, 2 ** 31 - 1], np.int32), bad.sum())
    tmap = torch.from_numpy(m).to(device)
    ok = torch.from_numpy(~bad).to(device)
    got = K.gather_tiles(src, tmap).view(700, -1)[ok]
    want = ref.pack_ref(src.reshape(-1), tmap.clamp(0, 96), tile
                        ).view(700, -1)[ok]
    same(got, want, "the in-range tiles of a map with out-of-range entries")
    src = torch.randn(big_tiles * K.SUBLANE, K.LANE, generator=gen
                      ).to(device)
    tmap = torch.randperm(big_tiles, generator=gen).to(torch.int32).to(device)
    tmap_long = tmap.long()
    got = K.gather_tiles(src, tmap)
    want = ref.pack_ref(src.reshape(-1), tmap, tile).reshape(-1, K.LANE)
    if not torch.equal(got, want):
        fail(f"gather_tiles != plain at {big_tiles} tiles")
    max_err = max(max_err, float((got - want).abs().max()))
    del got, want

    def kernel():
        K.gather_tiles(src, tmap)

    def plain():
        ref.pack_ref(src.reshape(-1), tmap, tile)

    def library():
        torch.index_select(src.view(big_tiles, -1), 0, tmap_long)

    times = {"kernel": [], "plain": [], "library": []}
    for name, fn in (("plain", plain), ("kernel", kernel), ("library", library),
                     ("library", library), ("kernel", kernel), ("plain", plain)):
        times[name].append(time_ms(fn, device))
    tile_bytes = tile * src.element_size()
    moved = 2 * big_tiles * tile_bytes + 4 * big_tiles
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    bw = memory_bandwidth(name) if device.type == "cuda" else float("nan")
    out = {"ms": sum(times["kernel"]) / 2, "plain_ms": sum(times["plain"]) / 2,
           "library_ms": sum(times["library"]) / 2,
           "bound_ms": moved / bw * 1e3, "bound_by": "bytes",
           "max_abs_err": max_err}
    say(f"[kernels] gather_tiles: bit-exact vs plain (f32/bf16/int32 x 1,4,17 "
        f"tiles; f32/bf16 x {GRID_TILES} tiles; a map with repeats; the "
        f"in-range tiles of a map with out-of-range entries; f32 x "
        f"{big_tiles} tiles = {big_tiles * tile_bytes / 2**30:.3f} GiB; "
        f"{K.BLOCKS_PER_SM} blocks per SM); kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
        f"index_select {out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} "
        f"ms ({moved} B at {bw / 1e12} TB/s); runs {times}")
    return out


# -- phases 4-7 --------------------------------------------------------------

def algorithm2_matrix(device, size: str, log: bool = True) -> int:
    from repro_torch.scenarios import iter_scenarios, run_scenario

    cells = 0
    for sc in iter_scenarios(size):
        tree = sc.build()
        sc.validate(tree)
        for spec in SPECS:
            m = run_scenario(sc, spec, tree=tree, device=device)
            if not (m.ok and m.motion_ok):
                fail(f"{sc.name}/{spec}: ok={m.ok} ledger "
                     f"{(m.h2d_bytes, m.h2d_calls)} expected "
                     f"{m.expected.as_tuple()}")
            cells += 1
        if log:
            say(f"[algorithm2] {sc.name}: " + ", ".join(
                f"{s} ok" for s in SPECS))
    return cells


def steady(device, n: int) -> None:
    from repro_torch.scenarios import Motion, run_steady_scenario, steady_reuse_case

    sc = steady_reuse_case(n)
    want = Motion(4 * (n + n // 2), 1)
    for i, m in enumerate(run_steady_scenario(sc, passes=3, device=device)):
        if not (m.ok and m.motion_ok
                and (m.h2d_bytes, m.h2d_calls) == want.as_tuple()):
            fail(f"steady pass {i} of {sc.name}: {m}")
        say(f"[steady] {sc.name} pass {i}: moved {m.h2d_bytes} B in "
            f"{m.h2d_calls} copy, skipped {m.skipped_bytes} B, "
            f"{m.wall_us:.1f} us")


def real_size(device, cases) -> None:
    """Algorithm 2 on each (scenario, {kind: (bytes, calls)}) under every
    spec, each ledger held to its closed form, then the transfer step
    alone on a fresh executor (warm staging) for its H2D rate."""
    import torch
    from repro_torch._device import synchronize
    from repro_torch.core import get_session
    from repro_torch.scenarios import run_scenario

    for sc, closed in cases:
        t0 = time.perf_counter()
        tree = sc.build()
        say(f"[real] {sc.name}: built in {time.perf_counter() - t0:.2f} s")
        for spec in SPECS:
            m = run_scenario(sc, spec, tree=tree, device=device)
            want = closed[spec.split("+")[0]]
            if not (m.ok and m.motion_ok
                    and (m.h2d_bytes, m.h2d_calls) == want):
                fail(f"{sc.name}/{spec}: ok={m.ok} ledger "
                     f"{(m.h2d_bytes, m.h2d_calls)} closed form {want}")
            scheme = sc.scheme_for(spec, device=device)
            t0 = time.perf_counter()
            scheme.stage(tree, list(sc.used_paths),
                         uvm_access=list(sc.uvm_access) if sc.uvm_access
                         else None)
            synchronize(device)
            stage_s = time.perf_counter() - t0
            say(f"[real] {sc.name}/{spec}: line-7 ok, ledger "
                f"{m.h2d_bytes} B / {m.h2d_calls} calls == closed form; "
                f"Alg-2 wall {m.wall_us / 1e3:.2f} ms (enqueue "
                f"{m.enqueue_us / 1e3:.2f} + sync {m.sync_us / 1e3:.2f}); "
                f"stage {stage_s * 1e3:.2f} ms = "
                f"{scheme.ledger.h2d_bytes / stage_s / 1e9:.2f} GB/s H2D")
            del scheme
        del tree
        get_session().clear()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def pack_roundtrip(device, sc):
    """pack_tree / unpack_tree of the f32 payload leaves of ``sc``'s tree
    through the tile-gather kernel.  Returns the kernel's launches in those
    two calls (read right after them) and the largest |kernel - plain|
    difference of the checks that follow:

    - the packed buffer equals the plain gather of the same source pool by
      pack_tree's own arena map, and the unpacked pool the plain gather of
      the packed buffer by the inverse map, both on the card;
    - on a one-dtype tree the arena keeps leaf order, so that map is the
      identity; the kernel therefore also gathers the same pool by a random
      permutation of its tiles, held against the plain version, so that a
      kernel that ignored its map fails here too;
    - the round trip gives the leaves back bit for bit.
    """
    import torch
    from repro_torch._device import synchronize
    from repro_torch.core import tree_leaves
    from repro_torch.kernels.marshal_pack import kernel as K, ops, ref

    payload = [l for l in tree_leaves(sc.build())
               if l.dtype == torch.float32]
    nbytes = sum(l.numel() * 4 for l in payload)
    synchronize(device)
    t0 = time.perf_counter()
    packed, meta = ops.pack_tree(payload, device=device)
    back = ops.unpack_tree(packed, meta)
    synchronize(device)
    dt = time.perf_counter() - t0
    launches = K.gather_tiles.launches

    pack_map, unpack_map = ops._device_maps(meta["layout"], meta["shapes"],
                                            device)
    if not torch.equal(unpack_map, meta["unpack_map"]):
        fail("pack_tree's unpack map is not the cached inverse map")
    identity = bool(torch.equal(pack_map, torch.arange(
        pack_map.numel(), dtype=torch.int32, device=device)))
    pool = ops.flatten_to_pool(payload, torch.float32, device)
    want = ref.pack_ref(pool, pack_map, ops.TILE)
    if not torch.equal(packed, want):
        fail("pack_tree's packed buffer != the plain gather of its pool")
    err = float((packed - want).abs().max())
    perm = torch.randperm(pack_map.numel(), generator=torch.Generator()
                          .manual_seed(1)).to(torch.int32).to(device)
    got = ops.pack_pool(pool, perm)
    want = ref.pack_ref(pool, perm, ops.TILE)
    if not torch.equal(got, want):
        fail("gather_tiles != plain on the pack path's pool with a "
             "permuted map")
    err = max(err, float((got - want).abs().max()))
    del pool, want, got
    # the leaves unpack_tree returns are views of one unpacked pool
    unpacked = torch.empty(0, dtype=torch.float32, device=device).set_(
        back[0].untyped_storage())
    want = ref.pack_ref(packed, unpack_map, ops.TILE)
    if not torch.equal(unpacked, want):
        fail("unpack_tree's pool != the plain gather of the packed buffer")
    err = max(err, float((unpacked - want).abs().max()))
    del want, unpacked
    for a, b in zip(back, payload):
        if not torch.equal(a.cpu(), b):
            fail("pack_tree -> unpack_tree round trip is not bit-exact")
    say(f"[pack] pack_tree/unpack_tree: {len(payload)} f32 leaves, "
        f"{nbytes} B ({nbytes / 2**30:.3f} GiB), packed {packed.numel() * 4} "
        f"B ({pack_map.numel()} tiles, arena map "
        f"{'the identity' if identity else 'a permutation'}); {launches} "
        f"launch(es), {dt:.3f} s including the H2D of the pool; packed and "
        f"unpacked pools == plain gather by the arena maps, pool gathered by "
        f"a random permutation == plain, round trip bit-exact")
    return launches, err


# -- phase 2 -----------------------------------------------------------------

def build_kernels(sources) -> None:
    """Every kernel source, one nvcc each, all started together; each
    build's time and, per compiled function, its registers and spills."""
    import re
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    times = _build.build(sources)
    say(f"[build] {len(times)} of {len(sources)} sources compiled in "
        f"{time.perf_counter() - t0:.2f} s (the rest were in build/)")
    for src in sources:
        src = Path(src)
        log = _build.library_path(src).with_suffix(".log")
        regs = spills = []
        if log.exists():
            text = log.read_text()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spills = [int(a) + int(b) for a, b in re.findall(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
        took = times.get(src)
        say(f"[build] {src.name}: "
            + (f"{took:.2f} s" if took is not None else "already built")
            + f"; {len(regs)} kernel(s), registers {regs}, spill bytes "
            f"{spills}")


# -- phase 3: the model kernels ----------------------------------------------

def _trio(device, fns, iters: int) -> dict:
    """Kernel, plain and library call (and the old kernel, where ``fns``
    has ``"old"``) timed in turns (plain, kernel, library, old, old,
    library, kernel, plain); the mean of each pair, in ms."""
    names = [n for n in ("plain", "kernel", "library", "old") if n in fns]
    times = {n: [] for n in names}
    for name in names + names[::-1]:
        times[name].append(time_ms(fns[name], device, iters=iters))
    out = {"ms": sum(times["kernel"]) / 2, "plain_ms": sum(times["plain"]) / 2,
           "library_ms": sum(times["library"]) / 2}
    if "old" in times:
        out["old_ms"] = sum(times["old"]) / 2
    return out


def _bound(nbytes: float, flops: float,
           rate: float = H100_SXM_BF16_FLOPS) -> dict:
    t_bytes = nbytes / H100_SXM_BANDWIDTH * 1e3
    t_ops = flops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _close(got, want, what: str) -> float:
    import torch

    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=BF16_TOL,
                          atol=BF16_TOL):
        fail(f"{what}: kernel != plain (max |diff| {err})")
    return err


def _causal_pairs(Sq: int, kv_len: int) -> int:
    """(q, k) pairs a causal pass over Sq queries and kv_len keys scores."""
    return sum(min(i + 1, kv_len) for i in range(Sq))


def rmsnorm_err(device, serve_rows, D: int) -> float:
    """rmsnorm against its plain version in bf16 at every row count of
    ``serve_rows`` (a prefill's prompt length, a decode step's slots) and
    width D; returns the largest |kernel - plain|."""
    import torch
    from repro_torch.kernels.rmsnorm import kernel as RK, ref

    gen = torch.Generator(device=device).manual_seed(1)
    w = torch.randn(D, generator=gen, device=device).to(torch.bfloat16)
    err = 0.0
    for rows in sorted(set(serve_rows)):
        x = torch.randn(rows, D, generator=gen, device=device).to(torch.bfloat16)
        err = max(err, _close(RK.rmsnorm(x, w), ref.rmsnorm_ref(x, w),
                              f"rmsnorm {rows}x{D}"))
    return err


def rmsnorm_grid(prompt_rows: int, widths):
    """phase 3's rmsnorm shapes, (label, rows, D, dtype): bf16 at the rows
    the path launches it with (a decode step's slots, the longest serve
    prompt, llama's 8 x 128 train step, the other families' 8 x 512) at
    every width it runs at, and f32 at the 2-layer checks' (1024, 2048)."""
    import torch

    out = [(f"bf16 {rows}x{D}", rows, D, torch.bfloat16)
           for D in widths
           for rows in (SERVE_SLOTS, prompt_rows, RMS_TRAIN_ROWS,
                        RMS_FAMILY_ROWS)]
    return out + [(f"f32 {RMS_TRAIN_ROWS}x{widths[0]}", RMS_TRAIN_ROWS,
                   widths[0], torch.float32)]


def rmsnorm_floor_ms(device, iters: int = 200) -> float:
    """The launch floor: an empty kernel from rmsnorm's library, through
    the same ctypes path, timed as the kernel is (``time_ms``), twice."""
    from repro_torch.kernels.rmsnorm import kernel as RK

    return sum(time_ms(lambda: RK.empty_launch(device), device, iters=iters)
               for _ in range(2)) / 2


def rmsnorm_strided(x, w):
    """rmsnorm forced onto its strided path: the one-block-a-row kernel
    the row path replaced (256 threads at most, 16-byte words when
    aligned), whose reduction order the row path keeps."""
    from repro_torch.kernels.rmsnorm import kernel as RK

    return RK._launch(x, w, 1e-6, strided=True)


def _rotating(fn, xs):
    """A call of ``fn`` on each of ``xs`` in turn, its output kept until
    its turn comes round again: the inputs and the outputs each rotate
    over ``len(xs)`` buffers, so a timed loop reads and writes HBM, not
    what the call before left in L2.  One pass over ``xs`` is made first,
    so the allocator holds every output's block before any call is timed
    (a new segment's cudaMalloc would stall the queue)."""
    import itertools

    outs = [fn(x) for x in xs]
    turn = itertools.count()

    def call():
        i = next(turn) % len(xs)
        outs[i] = fn(xs[i])
    return call


def check_rmsnorm(device, serve_rows, grid) -> dict:
    """rmsnorm against its plain version at every serve row count and at
    every shape of ``grid`` (``rmsnorm_grid``), and there bit for bit
    against its strided path (the old kernel, whose reduction order it
    keeps), each timed in turns with the old kernel, its plain version and
    ``F.rms_norm`` on inputs rotated over RMS_ROTATE_BYTES (``_rotating``:
    every time reads x from HBM, none from the 50 MB L2), beside its bound;
    the launch floor timed before and after the grid.  ``serve`` is the
    decode step's bf16 (8, D) and ``large`` bf16 (4096, D), D the first
    width."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel as RK, ref

    D0 = grid[0][2]
    err = rmsnorm_err(device, serve_rows, D0)
    gen = torch.Generator(device=device).manual_seed(1)
    floors = [rmsnorm_floor_ms(device)]
    rows_out = []
    for label, rows, D, dtype in grid:
        w = torch.randn(D, generator=gen, device=device).to(dtype)
        item = torch.tensor([], dtype=dtype).element_size()
        copies = -(-RMS_ROTATE_BYTES // (rows * D * item))
        pool = torch.randn(copies * rows, D, generator=gen,
                           device=device).to(dtype)
        xs = list(pool.split(rows))
        x = xs[0]
        got = RK.rmsnorm(x, w)
        err = max(err, _close(got, ref.rmsnorm_ref(x, w), f"rmsnorm {label}"))
        if not torch.equal(got, rmsnorm_strided(x, w)):
            fail(f"rmsnorm {label}: the row path differs from the strided "
                 f"loop (the one-block-a-row kernel's reduction)")
        m = _trio(device, {
            "kernel": _rotating(lambda x: RK.rmsnorm(x, w), xs),
            "plain": _rotating(lambda x: ref.rmsnorm_ref(x, w), xs),
            "library": _rotating(
                lambda x: F.rms_norm(x, (D,), weight=w, eps=1e-6), xs),
            "old": _rotating(lambda x: rmsnorm_strided(x, w), xs)},
            200 if rows * D <= 2 ** 22 else 50)
        m.update(_bound((2 * rows * D + D) * item, 4.0 * rows * D,
                        H100_SXM_F32_FLOPS))
        m["shape"] = f"({rows}, {D}) {str(dtype).split('.')[-1]}"
        m["rotated_over"] = copies
        rows_out.append(m)
        del x, xs, pool, got, w
    floors.append(rmsnorm_floor_ms(device))
    floor = sum(floors) / 2
    for m in rows_out:
        m["floor_ms"] = floor
    by_shape = {(r, D, dt): m for (_, r, D, dt), m in zip(grid, rows_out)}
    return {"serve": by_shape[(SERVE_SLOTS, D0, torch.bfloat16)],
            "large": by_shape[(RMS_FAMILY_ROWS, D0, torch.bfloat16)],
            "grid": rows_out, "floor_ms": floor, "max_abs_err": err}


def _bf16_randn(gen, device, *shape):
    import torch

    return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)


def time_flash(device, gen, P: int, S_max: int, H: int, KV: int, hd: int,
               iters: int):
    """q (1, P, H, hd) against the first P rows of a (1, S_max, KV, hd)
    cache layer, causal, as prefill calls it: checked against the plain
    version, then timed beside it and SDPA.  Returns (row, max error)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref

    q = _bf16_randn(gen, device, 1, P, H, hd)
    k = _bf16_randn(gen, device, 1, S_max, KV, hd)[:, :P]
    v = _bf16_randn(gen, device, 1, S_max, KV, hd)[:, :P]

    def plain():
        return ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True
                                 ).transpose(1, 2)

    err = _close(ops.mha(q, k, v, causal=True), plain(),
                 f"flash P={P} hd {hd}")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    m = _trio(device, {
        "kernel": lambda: ops.mha(q, k, v, causal=True),
        "plain": plain,
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)}, iters)
    m.update(_bound((2 * P * H * hd + 2 * P * KV * hd) * 2,
                    4.0 * H * _causal_pairs(P, P) * hd))
    m["shape"] = (f"q (1, {P}, {H}, {hd}), k/v (1, {P}, {KV}, {hd}) of a "
                  f"{S_max}-row cache, bf16, causal")
    return m, err


def check_flash(device, prompt_lens, big_len: int, H: int, KV: int,
                hd: int) -> dict:
    """At every prompt length of the serve phase, q (1, P, H, hd) against
    the first P rows of a (1, S_max, KV, hd) cache layer, as prefill calls
    it; then timed at the longest prompt and at big_len."""
    from repro_torch.kernels.flash_attention import ops, ref
    import torch

    gen = torch.Generator(device=device).manual_seed(2)
    err = 0.0
    for P in sorted(set(prompt_lens)):
        q = _bf16_randn(gen, device, 1, P, H, hd)
        k = _bf16_randn(gen, device, 1, SERVE_MAX_SEQ, KV, hd)[:, :P]
        v = _bf16_randn(gen, device, 1, SERVE_MAX_SEQ, KV, hd)[:, :P]
        want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True
                                 ).transpose(1, 2)
        err = max(err, _close(ops.mha(q, k, v, causal=True), want,
                              f"flash P={P}"))
    out = {}
    for label, P, S_max, iters in (
            ("serve", max(prompt_lens), SERVE_MAX_SEQ, 10),
            ("large", big_len, big_len, 3)):
        out[label], e = time_flash(device, gen, P, S_max, H, KV, hd, iters)
        err = max(err, e)
    out["max_abs_err"] = err
    return out


def time_decode(device, gen, valid, S: int, H: int, KV: int, hd: int,
                iters: int):
    """q (B, H, hd) against one cache layer (B, S, KV, hd) read in place
    through a transposed view, as decode_step calls it, with the valid
    lengths ``valid``: checked against the plain version, then timed
    beside it and SDPA with a mask.  Returns (row, max error)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref

    B = len(valid)
    q = _bf16_randn(gen, device, B, 1, H, hd)
    ck = _bf16_randn(gen, device, B, S, KV, hd)
    cv = _bf16_randn(gen, device, B, S, KV, hd)
    vl = torch.as_tensor(np.asarray(valid, np.int32), device=device)
    kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
    err = _close(ops.decode_mha(q, ck, cv, vl)[:, 0],
                 ref.decode_ref(q[:, 0], kt, vt, vl),
                 f"decode {B} x {S}, hd {hd}, {H // KV} heads a KV head")
    mask = (torch.arange(S, device=device)[None, :]
            < vl[:, None].long())[:, None, None, :]
    qt = q.transpose(1, 2)
    m = _trio(device, {
        "kernel": lambda: ops.decode_mha(q, ck, cv, vl),
        "plain": lambda: ref.decode_ref(q[:, 0], kt, vt, vl),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)}, iters)
    keys = int(np.minimum(np.asarray(valid), S).sum())
    m.update(_bound(keys * KV * hd * 2 * 2 + 2 * B * H * hd * 2 + 4 * B,
                    4.0 * keys * H * hd))
    m["shape"] = (f"q ({B}, {H}, {hd}) against a ({B}, {S}, {KV}, {hd}) "
                  f"bf16 cache layer, valid lengths {list(map(int, valid))}"
                  if B <= 8 else
                  f"q ({B}, {H}, {hd}) against a ({B}, {S}, {KV}, {hd}) "
                  f"bf16 cache layer, {keys} valid keys in all")
    return m, err


def check_decode(device, serve_valid, big_slots: int, big_seq: int, H: int,
                 KV: int, hd: int) -> dict:
    """Decode as decode_step calls it with ragged valid lengths, timed at
    the serve phase's lengths and at big_slots x big_seq."""
    import numpy as np
    import torch

    gen = torch.Generator(device=device).manual_seed(3)
    big_valid = np.random.default_rng(3).integers(1, big_seq + 1,
                                                  size=big_slots)
    out, err = {}, 0.0
    for label, valid, S, iters in (
            ("serve", serve_valid, SERVE_MAX_SEQ, 50),
            ("large", big_valid, big_seq, 20)):
        out[label], e = time_decode(device, gen, valid, S, H, KV, hd, iters)
        err = max(err, e)
    out["max_abs_err"] = err
    return out


def time_serve_attention(device, P: int, serve_valid, H: int, KV: int,
                         hd: int):
    """A model's attention timed at its serve shapes (zamba2's head dim 80
    with one query head a KV head, the head-dim-128 groups of the
    attention variants): flash at a P-token prompt, decode over the serve
    run's 8 slots.  Returns (flash row, decode row, max error)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(7)
    flash, e1 = time_flash(device, gen, P, SERVE_MAX_SEQ, H, KV, hd, 10)
    dec, e2 = time_decode(device, gen, serve_valid, SERVE_MAX_SEQ, H, KV, hd,
                          50)
    return flash, dec, max(e1, e2)


def check_flash_offsets(device, prompt_lens, H: int, KV: int,
                        hd: int) -> float:
    """Flash as a prefill at a nonzero cache position calls it: two rows of
    a (2, S_max, KV, hd) cache layer at different per-batch offsets, the
    whole layer as keys with per-batch valid lengths; for every prompt
    length P of the serve run, the first P // 2 tokens are in the cache and
    the rest is the call.  Returns the largest |kernel - plain|."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device=device).manual_seed(4)
    err = 0.0
    for P in sorted(set(prompt_lens)):
        first = P // 2
        off = torch.tensor([first, max(0, first - 17)], dtype=torch.int32,
                           device=device)
        Sq = P - first
        q = torch.randn(2, Sq, H, hd, generator=gen, device=device
                        ).to(torch.bfloat16)
        ck = torch.randn(2, SERVE_MAX_SEQ, KV, hd, generator=gen,
                         device=device).to(torch.bfloat16)
        cv = torch.randn(2, SERVE_MAX_SEQ, KV, hd, generator=gen,
                         device=device).to(torch.bfloat16)
        valid = off + Sq
        got = ops.mha(q, ck, cv, causal=True, kv_len=valid, q_offset=off)
        want = ref.attention_ref(q.transpose(1, 2), ck.transpose(1, 2),
                                 cv.transpose(1, 2), causal=True,
                                 kv_len=valid, q_offset=off).transpose(1, 2)
        err = max(err, _close(got, want, f"flash at offsets {off.tolist()}, "
                                         f"{Sq} queries, hd {hd}"))
    return err


def check_serve_attention(device, prompt_lens, serve_valid, H: int, KV: int,
                          hd: int) -> float:
    """A model's attention at its serve shapes (zamba2's shared block at
    head dim 80, the attention variants at head dim 128): flash for every
    prompt length as prefill calls it (the whole cache layer as keys,
    per-batch length and offset tensors), decode over 8 slots with the
    run's ragged lengths.  Returns the largest |kernel - plain|."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import ops as dops, ref as dref
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device=device).manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device
                           ).to(torch.bfloat16)

    err = 0.0
    zero = torch.zeros(1, dtype=torch.int32, device=device)
    for P in sorted(set(prompt_lens)):
        q, ck, cv = (randn(1, P, H, hd), randn(1, SERVE_MAX_SEQ, KV, hd),
                     randn(1, SERVE_MAX_SEQ, KV, hd))
        valid = zero + P
        got = ops.mha(q, ck, cv, causal=True, kv_len=valid, q_offset=zero)
        want = ref.attention_ref(q.transpose(1, 2), ck.transpose(1, 2),
                                 cv.transpose(1, 2), causal=True,
                                 kv_len=valid).transpose(1, 2)
        err = max(err, _close(got, want, f"flash hd {hd} P={P}"))
    B = len(serve_valid)
    q, ck, cv = (randn(B, 1, H, hd), randn(B, SERVE_MAX_SEQ, KV, hd),
                 randn(B, SERVE_MAX_SEQ, KV, hd))
    vl = torch.as_tensor(np.asarray(serve_valid, np.int32), device=device)
    err = max(err, _close(dops.decode_mha(q, ck, cv, vl)[:, 0],
                          dref.decode_ref(q[:, 0], ck.transpose(1, 2),
                                          cv.transpose(1, 2), vl),
                          f"decode hd {hd}"))
    return err


def check_cross_attention(device, prompt_lens, H: int, KV: int, hd: int,
                          src: int, slots: int):
    """The encoder-decoder's non-causal flash calls at its serve shapes:
    the encoder's self-attention over ``src`` frames, a prefill's
    cross-attention for every prompt length (q (1, P, H, hd) against the
    (1, src, KV, hd) memory) and a decode step's (q (slots, 1, H, hd)
    against (slots, src, KV, hd)), each against the plain version; the
    decode step's call is then timed beside it and SDPA.  Returns (timed
    row, max error)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device=device).manual_seed(9)

    def plain(q, k, v):
        return ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=False
                                 ).transpose(1, 2)

    err = 0.0
    for B, Sq in [(1, src)] + [(1, P) for P in sorted(set(prompt_lens))] \
            + [(slots, 1)]:
        q = _bf16_randn(gen, device, B, Sq, H, hd)
        k, v = (_bf16_randn(gen, device, B, src, KV, hd) for _ in range(2))
        err = max(err, _close(ops.mha(q, k, v, causal=False), plain(q, k, v),
                              f"non-causal flash {B} x {Sq} queries against "
                              f"{src} keys, hd {hd}"))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    m = _trio(device, {
        "kernel": lambda: ops.mha(q, k, v, causal=False),
        "plain": lambda: plain(q, k, v),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True)}, 50)
    m.update(_bound((2 * slots * H * hd + 2 * slots * src * KV * hd) * 2,
                    4.0 * slots * H * src * hd))
    m["shape"] = (f"q ({slots}, 1, {H}, {hd}) against ({slots}, {src}, {KV}, "
                  f"{hd}) encoder memory, bf16, non-causal (a decode step's "
                  f"cross-attention)")
    return m, err


def ssd_padded_len(P: int, chunk: int) -> int:
    """The length apply_ssm scans for a P-token prompt: one chunk of P steps
    up to the chunk size, else P padded to a chunk multiple."""
    return P if P <= chunk else -(-P // chunk) * chunk


def ssd_bound(B: int, nc: int, nh: int, Q: int, hd: int, N: int) -> dict:
    """Least time of one ssd_chunks call: ops = 2 B nc (P N + nh (P hd + Q
    hd N)) with P = Q (Q + 1) / 2 causal pairs (the scores once per chunk,
    B and C being shared), at the bf16 tensor-core rate; bytes = x and y
    (bf16), B and C (bf16), dt, dtA and cum (f32) and the f32 states, at
    the HBM rate."""
    P = Q * (Q + 1) // 2
    ops = 2.0 * B * nc * (P * N + nh * (P * hd + Q * hd * N))
    nbytes = (2 * B * nc * nh * Q * hd * 2 + 2 * B * nc * Q * N * 2
              + 3 * B * nc * nh * Q * 4 + B * nc * nh * hd * N * 4)
    return _bound(nbytes, ops)


def check_ssd(device, prompt_lens, chunk: int, widths, big_len: int) -> dict:
    """ssd_chunks against its plain version on the strided views that
    ops.ssd_chunked_kernel passes it: at every prompt length of the serve
    run, padded as apply_ssm pads it (the padded steps carry dt = 0), at
    each of ``widths`` ((label, nh, hd, N): mamba2's and zamba2's), and at
    B = 1, S = big_len at mamba2's widths.  x, B, C in bf16, dt in f32 from
    a softplus as the model computes it, A = -exp(A_log).  y within 2e-2,
    the f32 states and cum within 1e-3; the same checks also against
    ``ssd_chunks_split_ref`` (the kernel's own arithmetic, bf16 hi + lo
    operands, on the card), whose largest difference is returned as
    ``max_abs_err_vs_split``.  Then timed beside the plain version at the
    longest prompt at each width ("serve" mamba2, "zamba2") and at big_len
    ("large"); no single PyTorch call computes this function, so there is
    no library time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import kernel as SK, ref

    gen = torch.Generator(device=device).manual_seed(6)

    def inputs(S, P, nh, hd, N):
        x = torch.randn(1, S, nh, hd, generator=gen, device=device
                        ).to(torch.bfloat16)
        dt = F.softplus(torch.randn(1, S, nh, generator=gen, device=device))
        dt[:, P:] = 0.0                               # apply_ssm's padding
        A = -torch.exp(0.5 * torch.randn(nh, generator=gen, device=device))
        Bm, Cm = (torch.randn(1, S, N, generator=gen, device=device
                              ).to(torch.bfloat16) for _ in range(2))
        Q = min(chunk, S)
        nc = S // Q
        return (x.reshape(1, nc, Q, nh, hd).transpose(2, 3),
                dt.reshape(1, nc, Q, nh).transpose(2, 3)[:, :, :, None, :],
                (dt * A).reshape(1, nc, Q, nh).transpose(2, 3)[
                    :, :, :, None, :],
                Bm.reshape(1, nc, Q, N), Cm.reshape(1, nc, Q, N))

    split_err = 0.0

    def held(got, want, what, against):
        e = _close(got[0], want[0], f"ssd_chunks y, {what} ({against})")
        for g, w, name in ((got[1], want[1], "states"),
                           (got[2], want[2], "cum")):
            d = float((g - w).abs().max())
            if not torch.allclose(g, w, rtol=SSD_F32_TOL, atol=SSD_F32_TOL):
                fail(f"ssd_chunks {name}, {what}: kernel != {against} (max "
                     f"|diff| {d}, tolerance {SSD_F32_TOL})")
            e = max(e, d)
        return e

    def compare(args, what):
        nonlocal split_err
        got = SK.ssd_chunks(*args)
        e = held(got, ref.ssd_chunks_ref(*args), what, "plain")
        split_err = max(split_err, held(got, ref.ssd_chunks_split_ref(*args),
                                        what, "split model"))
        return e

    err = 0.0
    for label, nh, hd, N in widths:
        for P in sorted(set(prompt_lens)):
            S = ssd_padded_len(P, chunk)
            err = max(err, compare(inputs(S, P, nh, hd, N),
                                   f"{label} P={P} (S={S})"))
    out = {}
    (_, nh, hd, N), (_, znh, zhd, zN) = widths[0], widths[1]
    for label, P, iters, (nh, hd, N) in (
            ("serve", max(prompt_lens), 10, (nh, hd, N)),
            ("zamba2", max(prompt_lens), 10, (znh, zhd, zN)),
            ("large", big_len, 3, (nh, hd, N))):
        S = ssd_padded_len(P, chunk)
        args = inputs(S, P, nh, hd, N)
        err = max(err, compare(args, f"{label} S={S}"))
        fns = {"kernel": lambda: SK.ssd_chunks(*args),
               "plain": lambda: ref.ssd_chunks_ref(*args)}
        times = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            times[name].append(time_ms(fns[name], device, iters=iters))
        Q = min(chunk, S)
        m = {"ms": sum(times["kernel"]) / 2,
             "plain_ms": sum(times["plain"]) / 2, "library_ms": None}
        m.update(ssd_bound(1, S // Q, nh, Q, hd, N))
        m["shape"] = (f"x (1, {S // Q}, {nh}, {Q}, {hd}) bf16 (S = {S}), "
                      f"B/C N = {N}, dt f32")
        out[label] = m
    out["max_abs_err"] = err
    out["max_abs_err_vs_split"] = split_err
    say(f"[kernels] ssd_chunks against ssd_chunks_split_ref (the kernel's "
        f"bf16 hi + lo arithmetic on the card): within {BF16_TOL} (y) and "
        f"{SSD_F32_TOL} (states, cum) at every shape; max |diff| {split_err}")
    return out


def check_hd128_attention(device, prompt_lens, serve_valid, cfgs):
    """Flash and decode at each attention variant's head dim 128 and GQA
    group (12, 4, 8, 1 and 7 query heads a KV head), held against the plain
    versions at every serve length, then timed at the longest prompt and
    over the serve run's 8 slots.  Returns (flash rows, decode rows, the
    largest |kernel - plain|), the rows keyed by model."""
    flash, dec, err = {}, {}, 0.0
    for cfg in cfgs:
        shape = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
        err = max(err, check_serve_attention(device, prompt_lens, serve_valid,
                                             *shape))
        flash[cfg.name], dec[cfg.name], e = time_serve_attention(
            device, max(prompt_lens), serve_valid, *shape)
        err = max(err, e)
    return flash, dec, err


def report_kernel(name: str, m: dict) -> None:
    rows = [(label, m.get(label))
            for label in ("serve", "large", "zamba2", "llama_tp",
                          "zamba2_tp", "phi3", "seamless_cross")]
    rows += sorted(m.get("hd128", {}).items())
    if "grid" in m:     # it holds serve and large
        rows = [("grid", r) for r in m["grid"]]
    for label, r in rows:
        if r is None:
            continue
        lib = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        say(f"[kernels] {name} {label} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) = "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound"
            + (f", launch floor {r['floor_ms']:.4f} ms = "
               f"{r['ms'] / r['floor_ms']:.2f}x" if "floor_ms" in r else "")
            + (f", old kernel {r['old_ms']:.4f} ms = "
               f"{r['old_ms'] / r['ms']:.3f}x, inputs rotated over "
               f"{r['rotated_over']}" if "old_ms" in r else ""))
    say(f"[kernels] {name}: max |kernel - plain| {m['max_abs_err']} "
        f"(tolerance {BF16_TOL}, bf16)")


# -- phase 8: serve ----------------------------------------------------------

def serve_prompts(vocab: int):
    import numpy as np

    rng = np.random.default_rng(0)
    lo, hi = SERVE_PROMPT_RANGE
    lens = rng.integers(lo, hi + 1, size=SERVE_REQUESTS)
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]


def region_closed_forms(host_state, policy) -> dict:
    """Each region's (bytes, copies) for one cold pass, from the port's
    own arena plan (marshal: one copy per dtype bucket; pointerchain: one
    per leaf)."""
    from repro_torch.core import arena, partition_tree, tree_leaves

    leaves = tree_leaves(host_state)
    out = {}
    for key, region in partition_tree(host_state, policy).items():
        sub = [leaves[i] for i in region.indices]
        if region.spec.kind == "marshal":
            layout = arena.plan(sub, region.spec.align_elems)
            out[key] = (layout.total_bytes(), len(layout.bucket_sizes))
        else:
            out[key] = (sum(t.numel() * t.element_size() for t in sub),
                        len(sub))
    return out


def small_logits_check(device, arch: str = "llama3.2-1b") -> float:
    """The smoke model (f32) on the card, through the kernels, against the
    same weights on the CPU, through the plain versions: logits of a
    forward, a prefill, three decode steps and a second prefill at the
    position they reached, within 2e-4 (the forward and the first prefill
    with seeded patches for the vlm, frames for the encdec)."""
    import numpy as np
    import torch
    from repro_torch.core import tree_map
    from repro_torch.models import registry

    api = registry.get(arch, smoke=True)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    dparams = tree_map(lambda t: t.to(device), params)
    rng = np.random.default_rng(5)
    toks = torch.as_tensor(rng.integers(
        0, api.cfg.vocab_size, (2, 37)).astype(np.int32))
    cfg, kw = api.cfg, {}
    if cfg.is_encdec or cfg.frontend == "vision":
        rows = 16 if cfg.is_encdec else cfg.frontend_tokens
        kw["frames" if cfg.is_encdec else "patches"] = torch.as_tensor(
            rng.standard_normal((2, rows, cfg.d_model)).astype(np.float32))
    dkw = {k: v.to(device) for k, v in kw.items()}
    err = 0.0

    def cmp(a, b, what):
        nonlocal err
        e = float((a.cpu() - b).abs().max())
        if not torch.allclose(a.cpu(), b, rtol=2e-4, atol=2e-4):
            fail(f"smoke {arch} {what}: card != CPU (max |diff| {e})")
        err = max(err, e)

    cmp(api.forward(dparams, toks.to(device), **dkw)[0],
        api.forward(params, toks, **kw)[0], "forward")
    cc, hc = api.init_cache(2, 64, device=device), api.init_cache(2, 64,
                                                                  device="cpu")
    dl, cc = api.prefill(dparams, toks.to(device), cc, **dkw)
    hl, hc = api.prefill(params, toks, hc, **kw)
    cmp(dl, hl, "prefill")
    for _ in range(3):
        nxt = hl[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        dl, cc = api.decode_step(dparams, nxt.to(device), cc)
        hl, hc = api.decode_step(params, nxt, hc)
        cmp(dl, hl, "decode")
    at = int(hc["pos"][0])
    dl, cc = api.prefill(dparams, toks[:, :9].to(device), cc)
    hl, hc = api.prefill(params, toks[:, :9], hc)
    cmp(dl, hl, f"prefill at position {at}")
    return err


def pinned_report(session) -> str:
    """The pinned staging a session holds, and the pinned bytes the caching
    host allocator owns (in use and cached), where this torch reports
    them."""
    import torch

    held = f"{session.pinned_bytes()} B of pinned staging in the session"
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is not None:
        owned = stats().get("allocated_bytes.current", "not reported")
        held += f", {owned} B pinned owned by the host allocator"
    return held


def release_host_cache() -> None:
    """Free the device cache and hand the host allocator's cached pinned
    blocks back to CUDA (the private call is named differently across
    torch versions)."""
    import gc
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):
        empty = getattr(torch._C, name, None)
        if empty is not None:
            empty()
            break


def serve_phase(device, kernels: dict, api, tag: str,
                ledgers_want: dict, params=None) -> dict:
    """``api``'s model at full width (random bf16 params drawn on the card,
    unless given) behind Server(slots=8, max_seq=2048) with its own
    TransferSession, serving the 12 requests of ``serve_prompts``; returns
    the run's launch counts.  Raises on any failed check.  The server, its
    programs and the session's pinned staging are released before it
    returns."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch._device import synchronize
    from repro_torch.core import TransferSession
    from repro_torch.models.specs import param_count
    from repro_torch.models import moe, registry
    from repro_torch.runtime import Request, Server

    cfg = api.cfg
    prompts = serve_prompts(cfg.vocab_size)
    longest = max(len(p) for p in prompts)
    t0 = time.perf_counter()
    if params is None:
        params = api.init(torch.Generator(device=device).manual_seed(0),
                          device=device)
    synchronize(device)
    say(f"[{tag}] {cfg.name}: {cfg.family}, "
        + (f"{cfg.enc_layers} encoder + " if cfg.is_encdec else "")
        + f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
        + (f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV of "
           f"{cfg.resolved_head_dim}, " if cfg.family != "ssm" else "")
        + (f"{cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, state "
           f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
           if cfg.family in ("ssm", "hybrid") else "")
        + (f"{cfg.num_experts} experts top {cfg.experts_per_token} of d_ff "
           f"{cfg.d_ff} (capacity {moe.capacity(cfg, SERVE_SLOTS)} at a "
           f"decode step, {moe.capacity(cfg, longest)} at a {longest}-token "
           f"prefill), " if cfg.family == "moe" else "")
        + f"{cfg.norm}, "
        + f"vocab {cfg.vocab_size}, {cfg.param_dtype}, "
        f"{param_count(registry.spec_tree(cfg))} params; on the card in "
        f"{time.perf_counter() - t0:.2f} s")

    times = {"prefill": [], "decode": []}

    def timed(name, fn):
        def call(*args):
            synchronize(device)
            t = time.perf_counter()
            out = fn(*args)
            synchronize(device)
            times[name].append(time.perf_counter() - t)
            return out
        return call

    class TimedServer(Server):
        def _stage_state(self, policy):
            synchronize(device)
            t = time.perf_counter()
            out = super()._stage_state(policy)
            synchronize(device)
            self.install_s = time.perf_counter() - t
            return out

    tapi = dataclasses.replace(api, prefill=timed("prefill", api.prefill),
                               decode_step=timed("decode", api.decode_step))
    session = TransferSession()
    t0 = time.perf_counter()
    server = TimedServer(tapi, params, slots=SERVE_SLOTS,
                         max_seq=SERVE_MAX_SEQ, session=session, device=device)
    init_s = time.perf_counter() - t0
    ledgers = {k: (l.h2d_bytes, l.h2d_calls)
               for k, l in server.program.ledgers.items()}
    closed = region_closed_forms(server._host_state, server.policy)
    # a region left open (None) is held to the arena plan alone
    ledgers_want = {k: closed.get(k) if v is None else v
                    for k, v in ledgers_want.items()}
    if ledgers != closed or ledgers != ledgers_want:
        fail(f"{cfg.name} install ledgers {ledgers}; arena plan {closed}; "
             f"closed forms {ledgers_want}")
    installed = sum(b for b, _ in ledgers.values())
    say(f"[{tag}] Server(slots={SERVE_SLOTS}, max_seq={SERVE_MAX_SEQ}) under "
        f"'{server.policy}': built in {init_s:.2f} s; install pass "
        f"{server.install_s * 1e3:.1f} ms for {installed} B = "
        f"{installed / server.install_s / 1e9:.2f} GB/s (compile, host pack "
        f"into pinned staging, H2D, one synchronize "
        f"{server.program.last_stats.sync_s * 1e3:.1f} ms); region ledgers "
        f"{ledgers} == arena plan == closed forms")

    reqs = [Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        server.submit(r)
    done = server.run(max_steps=10000)
    synchronize(device)
    run_s = time.perf_counter() - t0
    counts = {name: k.launches for name, k in kernels.items()}

    stats = server.stats
    server.tracker.assert_conserved()
    bad = [r.rid for r in done
           if r.state != "completed" or len(r.tokens_out) != SERVE_NEW_TOKENS]
    if len(done) != SERVE_REQUESTS or bad:
        fail(f"{cfg.name}: requests {bad} did not complete with "
             f"{SERVE_NEW_TOKENS} tokens ({len(done)} terminal of "
             f"{SERVE_REQUESTS})")
    def expected_launches(prefills, steps):      # the pack kernel: never
        return {"gather_tiles": 0,
                **registry.kernel_launches(cfg, prefills, steps)}

    want = expected_launches(stats.prefill_requests, stats.decode_steps)
    if counts != want:
        fail(f"{cfg.name} serve launches {counts}, expected {want} "
             f"({stats.prefill_requests} prefills, {stats.decode_steps} "
             f"decode steps)")
    per_fwd = expected_launches(1, 0)
    tokens = stats.tokens_generated
    say(f"[{tag}] {SERVE_REQUESTS} requests (prompts "
        f"{[len(p) for p in prompts]}) completed with {SERVE_NEW_TOKENS} "
        f"tokens each; lifecycle conserved; {stats.prefill_batches} refill "
        f"batches, {stats.prefill_requests} prefills, {stats.decode_steps} "
        f"decode steps; launches {counts} == {per_fwd['rmsnorm']} rmsnorm x "
        f"(prefills + steps), {per_fwd['flash_attention']} flash and "
        f"{per_fwd['ssd_chunks']} ssd_chunks x prefills, "
        f"{expected_launches(0, 1)['decode_attention']} decode "
        f"(+ {expected_launches(0, 1)['flash_attention']} flash) x steps")
    pre, dec = times["prefill"], times["decode"]
    say(f"[{tag}] run {run_s:.3f} s, {tokens} tokens = {tokens / run_s:.1f} "
        f"tokens/s; prefill per request {1e3 * sum(pre) / len(pre):.2f} ms "
        f"mean, {1e3 * sorted(pre)[len(pre) // 2]:.2f} median "
        f"({1e3 * min(pre):.2f}-{1e3 * max(pre):.2f}); decode step "
        f"{1e3 * sum(dec) / len(dec):.2f} ms mean, "
        f"{1e3 * sorted(dec)[len(dec) // 2]:.2f} median "
        f"({1e3 * min(dec):.2f}-{1e3 * max(dec):.2f}) for {SERVE_SLOTS} slots")

    # request 0 against a manual loop: a batch-1 prefill, as the server's
    # refill runs it, then greedy decode with that cache in each of the
    # server's slots, so every product has the server's shapes and rounding
    # and row 0 must give the server's tokens exactly.  A batch-1 decode
    # fed the same tokens is measured beside it, not held: its products
    # round differently, and in bf16 over random weights the difference
    # grows from step to step.
    got = next(r for r in done if r.rid == 0).tokens_out
    cache = api.init_cache(1, SERVE_MAX_SEQ, device=device)
    logits, cache = api.prefill(params, torch.as_tensor(prompts[0][None],
                                                        device=device), cache)
    wide = widen(cache, SERVE_SLOTS)
    last_w = last_1 = logits[0, -1].float()
    manual, agree, drift = [], 0, 0.0
    for step in range(SERVE_NEW_TOKENS):
        if not bool(torch.isfinite(last_w).all()):
            fail(f"{cfg.name} manual decode step {step}: non-finite logits")
        manual.append(int(torch.argmax(last_w)))
        agree += int(torch.argmax(last_1)) == manual[-1]
        drift = max(drift, float((last_1 - last_w).abs().max()))
        if step + 1 < SERVE_NEW_TOKENS:
            tok = torch.full((SERVE_SLOTS, 1), manual[-1], dtype=torch.int32,
                             device=device)
            logits, wide = api.decode_step(params, tok, wide)
            last_w = logits[0, -1].float()
            logits, cache = api.decode_step(params, tok[:1], cache)
            last_1 = logits[0, -1].float()
    if manual != got:
        step = next(i for i, (a, b) in enumerate(zip(manual, got)) if a != b)
        fail(f"{cfg.name} request 0 differs from the manual loop at step "
             f"{step}: server {got[step:]}, manual {manual[step:]}")
    say(f"[{tag}] request 0 == manual batch-1 prefill + greedy decode over "
        f"{SERVE_SLOTS} slots at all {SERVE_NEW_TOKENS} steps; a batch-1 "
        f"decode fed the same tokens (measured, not held) picks the same "
        f"token at {agree} of {SERVE_NEW_TOKENS} steps, max |logit diff| "
        f"{drift}")
    # where a step's time goes: device time under the profiler against the
    # unprofiled wall of the same call
    prompt = torch.as_tensor(prompts[-1][None], device=device)
    step_tokens = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int32,
                              device=device)
    for label, fn in (
            (f"prefill (P={len(prompts[-1])})", lambda: api.prefill(
                params, prompt, api.init_cache(1, SERVE_MAX_SEQ,
                                               device=device))),
            (f"decode step ({SERVE_SLOTS} slots)", lambda: api.decode_step(
                server.params, step_tokens, server.cache))):
        prof = profile_device_ms(device, fn)
        if not prof["device_ms"]:
            say(f"[{tag}] profile, {label}: the profiler recorded no device "
                f"time; device busy share not measured")
            continue
        say(f"[{tag}] profile, {label}: {prof['wall_ms']:.2f} ms of wall "
            f"(unprofiled), device busy {prof['device_ms']:.2f} ms under the "
            f"profiler, so the device is idle "
            f"{100 * max(0.0, 1 - prof['device_ms'] / prof['wall_ms']):.1f}%"
            f" of the call; top device ops {prof['top']}")
    held = pinned_report(session)
    server.program.clear()
    session.clear()
    del server, params, cache, wide, logits, tapi
    release_host_cache()
    say(f"[{tag}] released: before, {held}; after, {pinned_report(session)}")
    return counts


def widen(cache: dict, n: int) -> dict:
    """A batch-1 cache repeated into ``n`` slots: the (L, B, ...) stacks on
    axis 1, ``pos`` and the encoder memory on axis 0."""
    return {k: v.repeat_interleave(n, dim=0 if k in ("pos", "enc_out")
                                   else 1)
            for k, v in cache.items()}


def serve_multimodal(device, kernels: dict, api, params, tag: str) -> dict:
    """``api``'s model through the registry's ``prefill`` with its side
    input (phi-3's patches, seamless' frames; seeded, bf16) and
    ``decode_step``, as a server would run them: MM_REQUESTS requests of
    MM_PROMPT_RANGE text tokens prefilled one by one at batch 1, their
    caches stacked into MM_REQUESTS slots, then MM_NEW_TOKENS - 1 greedy
    decode steps over the slots.  Fails unless every logit is finite, the
    launches are exactly ``kernel_launches``' (each prefill encoding its
    frames for seamless) and request 0's tokens equal a batch-1 prefill
    and greedy decode with its cache in every slot (phases 8-12's check of
    the server).  Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch._device import synchronize
    from repro_torch.models import registry

    cfg = api.cfg
    rng = np.random.default_rng(17)
    lo, hi = MM_PROMPT_RANGE
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(lo, hi + 1, size=MM_REQUESTS)]
    if cfg.is_encdec:
        key, rows = "frames", max(1, SERVE_MAX_SEQ // cfg.src_ratio)
        encodes = {"encodes": MM_REQUESTS}
    else:
        key, rows, encodes = "patches", cfg.frontend_tokens, {}
    gen = torch.Generator(device=device).manual_seed(17)
    extras = [torch.randn(1, rows, cfg.d_model, generator=gen,
                          device=device).to(torch.bfloat16) for _ in prompts]

    def prefill(j):
        cache = api.init_cache(1, SERVE_MAX_SEQ, device=device)
        return api.prefill(params, torch.as_tensor(prompts[j][None],
                                                   device=device),
                           cache, **{key: extras[j]})

    def greedy(logits):
        if not bool(torch.isfinite(logits).all()):
            fail(f"{cfg.name} {key} run: non-finite logits")
        return logits[:, -1].argmax(-1).tolist()

    for k in kernels.values():
        k.launches = 0
    pre, dec, caches, out = [], [], [], []
    for j in range(MM_REQUESTS):
        synchronize(device)
        t = time.perf_counter()
        logits, cache = prefill(j)
        synchronize(device)
        pre.append(time.perf_counter() - t)
        out.append(greedy(logits))
        caches.append(cache)
    cache = {k: torch.cat([c[k] for c in caches],
                          dim=0 if k in ("pos", "enc_out") else 1)
             for k in caches[0]}
    del caches
    for _ in range(MM_NEW_TOKENS - 1):
        tok = torch.tensor([[o[-1]] for o in out], dtype=torch.int32,
                           device=device)
        synchronize(device)
        t = time.perf_counter()
        logits, cache = api.decode_step(params, tok, cache)
        synchronize(device)
        dec.append(time.perf_counter() - t)
        for o, n in zip(out, greedy(logits)):
            o.append(n)
    counts = {name: k.launches for name, k in kernels.items()}
    want = {"gather_tiles": 0, **registry.kernel_launches(
        cfg, MM_REQUESTS, MM_NEW_TOKENS - 1, **encodes)}
    if counts != want:
        fail(f"{cfg.name} {key} run launched {counts}, expected {want}")
    del cache, logits

    logits, one = prefill(0)
    wide = widen(one, MM_REQUESTS)
    manual = greedy(logits)
    for _ in range(MM_NEW_TOKENS - 1):
        tok = torch.full((MM_REQUESTS, 1), manual[-1], dtype=torch.int32,
                         device=device)
        logits, wide = api.decode_step(params, tok, wide)
        manual.append(greedy(logits)[0])
    if manual != out[0]:
        at = next(i for i, (a, b) in enumerate(zip(manual, out[0])) if a != b)
        fail(f"{cfg.name} {key} run: request 0 differs from the batch-1 run "
             f"at token {at}: {out[0][at:]} vs {manual[at:]}")
    extra = (f"frames (1, {rows}, {cfg.d_model}) encoded at every prefill"
             if cfg.is_encdec else
             f"{rows} patch embeddings (1, {rows}, {cfg.d_model}) before "
             f"each prompt")
    tokens = MM_REQUESTS * MM_NEW_TOKENS
    say(f"[{tag}] registry prefill({key}=) + decode_step: {MM_REQUESTS} "
        f"requests of {[len(p) for p in prompts]} text tokens, {extra}, "
        f"{MM_NEW_TOKENS} greedy tokens each over {MM_REQUESTS} slots; "
        f"launches {counts} == kernel_launches; request 0 == a batch-1 "
        f"prefill + greedy decode over {MM_REQUESTS} slots at all "
        f"{MM_NEW_TOKENS} tokens; prefill per request {_spread_ms(pre)}; "
        f"decode step {_spread_ms(dec)}; {tokens} tokens in "
        f"{sum(pre) + sum(dec):.3f} s = "
        f"{tokens / (sum(pre) + sum(dec)):.1f} tokens/s")
    return counts


def multimodal_phase(device, kernels: dict) -> dict:
    """Phase 17: phi-3-vision-4.2b and seamless-m4t-medium at full size,
    each drawn once on the card (seeded bf16), first through the registry
    with patches / frames (serve_multimodal), then behind the Server
    (serve_phase: text prompts, as the reference's Server serves them).
    Returns the launch counts of each run."""
    import torch
    from repro_torch._device import synchronize
    from repro_torch.models import registry

    out = {}
    t0 = time.perf_counter()
    for arch, tag in MM_ARCHS:
        api = registry.get(arch)
        t = time.perf_counter()
        params = api.init(torch.Generator(device=device).manual_seed(0),
                          device=device)
        synchronize(device)
        say(f"[{tag}] {arch}: params drawn on the card in "
            f"{time.perf_counter() - t:.2f} s")
        out[f"{tag}-{'frames' if api.cfg.is_encdec else 'patches'}"] = \
            serve_multimodal(device, kernels, api, params, tag)
        out[tag] = serve_phase(device, kernels, api, tag, MM_LEDGERS[arch],
                               params=params)
        del params
        release_host_cache()
    say(f"[multimodal] phase 17 ok in {time.perf_counter() - t0:.2f} s")
    return out


def profile_device_ms(device, fn, calls: int = 3) -> dict:
    """Per call of ``fn``: the wall time without the profiler, and the
    device time under torch.profiler (the sum of the device ops' self
    time, one stream)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch._device import synchronize

    fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    synchronize(device)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        synchronize(device)
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows) / 1e3 / calls
    top = [f"{k[:40]} {us / 1e3 / calls:.3f} ms x{n // calls}"
           for us, k, n in rows[:6]]
    return {"device_ms": total, "wall_ms": wall * 1e3 / calls, "top": top}


# -- phase 13: the policy scenarios ------------------------------------------

def _spread(xs) -> str:
    import statistics

    ms = [x * 1e3 for x in xs]
    return (f"median {statistics.median(ms):.2f} ms (min {min(ms):.2f}, "
            f"max {max(ms):.2f}, {len(ms)} rounds)")


def region_pipelining(device, sc, tree, rounds: int) -> None:
    """benchmarks/transfer_overlap.py's region-pipelining measurement, at
    this tree's size: per round, each region staged as its own single-rule
    blocking program (one barrier each, summed), one warm blocking program
    pass, one warm async pass materialized at once; all clean warm passes,
    interleaved.  The region programs and the whole program have a session
    each, so they share no staging entry.  Recorded, not gated."""
    from repro_torch._device import synchronize
    from repro_torch.core import (TransferPolicy, TransferSession,
                                  partition_tree, tree_leaves)

    policy = sc.policy()
    leaves = tree_leaves(tree)
    alone, whole = TransferSession(), TransferSession()
    regions = []
    for key, region in partition_tree(tree, policy).items():
        sub = [leaves[i] for i in region.indices]
        prog = alone.compile(sub, TransferPolicy.of(region.spec),
                             device=device)
        prog.to_device(sub)                                 # warm
        regions.append((key, prog, sub))
    program = whole.compile(tree, policy, device=device)
    program.to_device(tree)                                 # warm
    synchronize(device)
    walls = {"regions": [], "program": [], "async": []}
    offloaded = []
    for _ in range(rounds):
        total = 0.0
        for _, prog, sub in regions:
            t0 = time.perf_counter()
            prog.to_device(sub)
            synchronize(device)
            total += time.perf_counter() - t0
        walls["regions"].append(total)
        t0 = time.perf_counter()
        program.to_device(tree)
        synchronize(device)
        walls["program"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        program.to_device_async(tree).result()
        synchronize(device)
        walls["async"].append(time.perf_counter() - t0)
        offloaded.append(program.last_stats.offloaded_s)
    say(f"[policy] {sc.name} region pipelining: sum of {len(regions)} "
        f"single-region programs {_spread(walls['regions'])}; one blocking "
        f"program pass {_spread(walls['program'])}; one async pass "
        f"{_spread(walls['async'])}, offloaded "
        f"{max(offloaded) * 1e3:.3f} ms at most")
    for prog in [p for _, p, _ in regions] + [program]:
        prog.clear()
    alone.clear()
    whole.clear()


def policy_scenarios(device, n: int) -> None:
    """run_policy_scenario on mixed_policy and elastic at ``n`` (one
    device), POLICY_PASSES passes under each executor, every region held to
    its closed form; Algorithm 2 over each declared policy; then the region
    pipelining.  Each sub-phase has its own session, released after it."""
    from repro_torch.core import TransferSession
    from repro_torch.scenarios import (elastic_case, mixed_policy_case,
                                       run_algorithm2, run_policy_scenario)

    for case in (mixed_policy_case, elastic_case):
        sc = case(n, 1)
        cold, steady = POLICY_LEDGERS[sc.family]
        for declared, want in ((sc.region_expected, cold),
                               (sc.steady_region_expected, steady)):
            if {k: v.as_tuple() for k, v in declared.items()} != want:
                fail(f"{sc.name}: the family's closed forms {declared} are "
                     f"not this phase's {want}")
        t0 = time.perf_counter()
        tree = sc.build()
        say(f"[policy] {sc.name}: {sc.declared_policy}; built in "
            f"{time.perf_counter() - t0:.2f} s")
        for executor in ("blocking", "async"):
            session = TransferSession()
            ms = run_policy_scenario(sc, tree=tree, passes=POLICY_PASSES,
                                     executor=executor, session=session,
                                     device=device)
            for i, m in enumerate(ms):
                got = {k: (r["h2d_bytes"], r["h2d_calls"])
                       for k, r in m.regions.items()}
                if not (m.ok and m.motion_ok and m.syncs == 1
                        and got == (cold if i == 0 else steady)):
                    fail(f"{sc.name} {executor} pass {i}: ok={m.ok} "
                         f"motion_ok={m.motion_ok} syncs={m.syncs} "
                         f"regions {got}")
                say(f"[policy] {sc.name} {executor} pass {i}: regions {got}"
                    f" == closed forms, skipped {m.skipped_bytes} B, values "
                    f"== host; wall {m.wall_us / 1e3:.2f} ms = "
                    f"{m.h2d_bytes / m.wall_us / 1e3:.2f} GB/s H2D; sync "
                    f"{m.sync_us / 1e3:.3f} ms, overlap "
                    f"{m.overlap_us / 1e3:.3f} ms, offloaded "
                    f"{m.offload_us / 1e3:.3f} ms, finish "
                    f"{m.finish_us / 1e3:.3f} ms")
            say(f"[policy] {sc.name} {executor}: {pinned_report(session)}")
            session.clear()
            release_host_cache()
        session = TransferSession()
        program = session.compile(tree, sc.policy(), device=device)
        m = run_algorithm2(tree, list(sc.used_paths), program=program)
        if not (m.ok and (m.h2d_bytes, m.h2d_calls) == POLICY_ALG2[sc.family]):
            fail(f"{sc.name} Algorithm 2 over its policy: ok={m.ok} ledger "
                 f"{(m.h2d_bytes, m.h2d_calls)}, want "
                 f"{POLICY_ALG2[sc.family]}")
        say(f"[policy] {sc.name} Algorithm 2 over {m.spec}: line-7 ok, "
            f"merged ledger {m.h2d_bytes} B / {m.h2d_calls} copies == the "
            f"cold sum; wall {m.wall_us / 1e3:.2f} ms")
        program.clear()
        session.clear()
        del program
        release_host_cache()
        region_pipelining(device, sc, tree, POLICY_ROUNDS)
        del tree
        release_host_cache()


def model_state_full(device) -> None:
    """llama3.2-1b's params at full width, drawn on the card from a seeded
    generator and moved to the host, as a model_state cell (used paths
    embed and final_norm) under every spec, each ledger held to its closed
    form (real_size)."""
    import torch
    from repro_torch.core import tree_leaves, tree_map
    from repro_torch.models import registry
    from repro_torch.scenarios import Scenario

    api = registry.get("llama3.2-1b")
    params = api.init(torch.Generator(device=device).manual_seed(0),
                      device=device)
    host = tree_map(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    leaves = tree_leaves(host)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    if nbytes != MODEL_STATE_BYTES or len(leaves) != 11 or any(
            t.dtype != torch.bfloat16 for t in leaves):
        fail(f"full-width llama3.2-1b params: {nbytes} B in {len(leaves)} "
             f"leaves, want {MODEL_STATE_BYTES} B of bf16 in 11")
    sc = Scenario(name="model_state_llama3_2_1b_full_width",
                  family="model_state", build=lambda: host,
                  used_paths=("embed", "final_norm"),
                  params=dict(arch="llama3.2-1b"))
    real_size(device, [(sc, MODEL_STATE_CLOSED)])
    model_state_static(device, sc, host)
    del host
    release_host_cache()


def model_state_static(device, sc, host) -> None:
    """The static analysis on the full-width params, priced from their
    signatures alone: under every spec, the Algorithm-2 step's structural
    derivation equals the closed form real_size held the ledger to, and
    ``policy_cost`` equals a program pass's region ledger on the card,
    cold and on a clean steady pass."""
    from repro_torch.analysis.cost import policy_cost, signature_tree
    from repro_torch.core import TransferSession
    from repro_torch.scenarios import derive_motion, run_policy_scenario

    sig = signature_tree(host)
    for spec in SPECS:
        alg2 = derive_motion(sig, sc.used_paths, None, spec).as_tuple()
        if alg2 != MODEL_STATE_CLOSED[spec.split("+")[0]]:
            fail(f"{sc.name}/{spec}: the signature tree derives {alg2} for "
                 f"the Algorithm-2 step, the ledger booked "
                 f"{MODEL_STATE_CLOSED[spec.split('+')[0]]}")
        cost = policy_cost(sig, spec)
        session = TransferSession()
        ms = run_policy_scenario(sc, spec, tree=host, passes=2,
                                 session=session, device=device)
        static_equals_ledger(f"{sc.name}/{spec}", cost, ms)
        say(f"[real] {sc.name}/{spec}: static Alg-2 step {alg2} == ledger; "
            f"static program pass cold ({cost.cold_bytes}, "
            f"{cost.cold_calls}) / steady ({cost.steady_bytes}, "
            f"{cost.steady_calls}) == the card's region ledgers")
        session.clear()
        del ms
        release_host_cache()


# -- phase 14: the static analysis -------------------------------------------

def static_equals_ledger(tag: str, cost, ms) -> None:
    """``cost`` (a PolicyCost) against a run_policy_scenario measurement:
    every pass ok, and the predicted bytes and copies equal to the ledger,
    per region and in total, on the cold pass and on every steady one."""
    for i, m in enumerate(ms):
        want = {rc.key: (rc.cold if i == 0 else rc.steady).as_tuple()
                for rc in cost.regions}
        got = {k: (r["h2d_bytes"], r["h2d_calls"])
               for k, r in m.regions.items()}
        total = (cost.cold_bytes, cost.cold_calls) if i == 0 \
            else (cost.steady_bytes, cost.steady_calls)
        if not (m.ok and m.motion_ok and got == want
                and (m.h2d_bytes, m.h2d_calls) == total):
            fail(f"{tag} pass {i}: ok={m.ok} motion_ok={m.motion_ok}; the "
                 f"card's regions {got} (total "
                 f"{(m.h2d_bytes, m.h2d_calls)}), predicted {want} "
                 f"({total})")


def analysis_phase(device, smi: str, n: int) -> None:
    """(a) calibrate the wall model on the card; (b) the registry's declared
    policies checked at the live mesh and resharded to 8, no error; (c) the
    static prediction == the card's ledger for every scenario at ``full``;
    (d) the autotuner's three stages on mixed_policy and elastic at ``n``:
    enumerate, rank with the calibrated model, measure the declared policy
    and the best ANALYSIS_TOP, each held to its prediction."""
    import torch
    from repro_torch.analysis import errors
    from repro_torch.analysis.check import check_policy, check_registry
    from repro_torch.analysis.cost import (CostModel, policy_cost,
                                           signature_tree)
    from repro_torch.core import TransferPolicy, TransferSession
    from repro_torch.core import enumerate_policies
    from repro_torch.scenarios import (elastic_case, iter_scenarios,
                                       mixed_policy_case,
                                       run_policy_scenario)

    model = CostModel.calibrate(device=device)
    say(f"[analysis] calibrated on {smi}: latency {model.latency_us} us, "
        f"bandwidth {model.bandwidth_gbps} GB/s; probes (bytes, us) "
        f"{list(model.probes)}")

    results = check_registry("full", mesh_size=None)
    n_diags = sum(len(d) for d in results.values())
    bad = [str(d) for ds in results.values() for d in errors(ds)]
    at8 = []
    for sc in iter_scenarios("full"):
        if sc.declared_policy is None:
            continue
        steady = bool(sc.steady_mutate_paths()) \
            or sc.steady_region_expected is not None
        at8 += check_policy(sc.build(), sc.policy().reshard(8), mesh_size=8,
                            steady_reuse=steady, where=sc.name)
    bad += [str(d) for d in errors(at8)]
    if bad or not results:
        fail(f"the registry check found errors {bad} over {sorted(results)}")
    say(f"[analysis] check_registry('full') at the live mesh "
        f"({torch.cuda.device_count()} card): {len(results)} declared "
        f"policies, "
        f"{n_diags} diagnostics, 0 errors; resharded to 8: "
        f"{len(at8)} diagnostics, 0 errors")

    cells = 0
    for sc in iter_scenarios("full"):
        policy = sc.policy() or TransferPolicy.of("marshal")
        tree = sc.build()
        cost = policy_cost(signature_tree(tree), policy,
                           sc.steady_mutate_paths())
        session = TransferSession()
        ms = run_policy_scenario(sc, policy, tree=tree, passes=2,
                                 session=session, device=device)
        static_equals_ledger(sc.name, cost, ms)
        session.clear()
        cells += 1
    say(f"[analysis] static == the card's ledger, cold and steady, per "
        f"region, for all {cells} scenarios at 'full'")

    for case in (mixed_policy_case, elastic_case):
        sc = case(n, 1)
        tree = sc.build()
        sig = signature_tree(tree)
        mutate = sc.steady_mutate_paths()
        declared = sc.policy()
        grid = enumerate_policies(tuple(r.pattern for r in declared.rules))
        if len(grid) != ANALYSIS_GRID:
            fail(f"{sc.name}: {len(grid)} candidates, not {ANALYSIS_GRID}")
        if declared not in grid:
            grid.append(declared)                 # marshal@dp1 is not marshal
        costs = {p: policy_cost(sig, p, mutate) for p in grid}
        ranked = sorted(grid, key=lambda p: model.objective_us(costs[p]))
        measured = [declared] + [p for p in ranked
                                 if p != declared][:ANALYSIS_TOP]
        say(f"[analysis] {sc.name}: {len(grid)} candidates priced; the "
            f"declared policy ranks {ranked.index(declared) + 1}")
        for p in measured:
            cost = costs[p]
            session = TransferSession()
            ms = run_policy_scenario(sc, p, tree=tree,
                                     passes=ANALYSIS_PASSES,
                                     session=session, device=device)
            static_equals_ledger(f"{sc.name} {p}", cost, ms)
            say(f"[analysis] {sc.name} rank {ranked.index(p) + 1} {p}: "
                f"motion == ledger, cold ({cost.cold_bytes}, "
                f"{cost.cold_calls}), steady ({cost.steady_bytes}, "
                f"{cost.steady_calls}), staging {cost.staging_bytes} B; wall "
                f"predicted cold {model.cold_wall_us(cost) / 1e3:.3f} ms, "
                f"steady {model.steady_wall_us(cost) / 1e3:.3f} ms, measured "
                f"cold {ms[0].wall_us / 1e3:.3f} ms, steady "
                + " / ".join(f"{m.wall_us / 1e3:.3f}" for m in ms[1:])
                + " ms")
            session.clear()
            del ms
            release_host_cache()
        del tree
        release_host_cache()


# -- phase 16: the staging race sanitizer ------------------------------------

def _launched(kernels: dict) -> dict:
    return {k: f.launches for k, f in kernels.items() if f.launches}


def _events(san) -> str:
    return json.dumps(dict(sorted(san.events.items())))


def sanitizer_clean(device, kernels: dict, real_cases) -> None:
    """Part (a): under ``sanitize()``, the Algorithm-2 matrix of phase 4,
    phase 6's two real-size trees under every spec (SAN_PASSES passes on
    one executor each) and phase 13's mixed_policy program under both
    executors: no StagingRaceError, every ledger its closed form (a steady
    marshal+delta pass moves nothing and skips the whole tree), one
    barrier and one pass report per program pass, no kernel launched.
    Each drive's events are printed."""
    from repro_torch.analysis.sanitizer import sanitize
    from repro_torch.core import TransferSession, transfer_scheme
    from repro_torch.scenarios import (mixed_policy_case, run_algorithm2,
                                       run_policy_scenario)

    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    with sanitize() as san:
        cells = algorithm2_matrix(device, "full", log=False)
    say(f"[sanitizer] (a) Algorithm 2, {cells} cells at 'full': ledgers == "
        f"expected, no finding in {time.perf_counter() - t0:.2f} s; events "
        f"{_events(san)}")
    for sc, closed in real_cases:
        tree = sc.build()
        access = list(sc.uvm_access) if sc.uvm_access else None
        for spec in SPECS:
            want = closed[spec.split("+")[0]]
            session = TransferSession()
            scheme = transfer_scheme(spec, session, device=device)
            walls = []
            with sanitize() as san:
                for i in range(SAN_PASSES):
                    m = run_algorithm2(tree, list(sc.used_paths),
                                       uvm_access=access, scheme=scheme)
                    moved = (m.h2d_bytes, m.h2d_calls)
                    steady = spec == "marshal+delta" and i > 0
                    exact = (moved == (0, 0) and m.skipped_bytes == want[0]
                             if steady else moved == want)
                    if not (m.ok and exact):
                        fail(f"sanitized {sc.name}/{spec} pass {i}: "
                             f"ok={m.ok} ledger {moved} skipped "
                             f"{m.skipped_bytes}, closed form {want}")
                    walls.append(m.wall_us / 1e3)
            say(f"[sanitizer] (a) {sc.name}/{spec}: {SAN_PASSES} passes, "
                f"line-7 ok, ledgers == closed forms, no finding; walls "
                f"{[round(w, 2) for w in walls]} ms; events {_events(san)}")
            session.clear()
            del scheme
            release_host_cache()
        del tree
    sc = mixed_policy_case(POLICY_N, 1)
    cold, steady = POLICY_LEDGERS[sc.family]
    tree = sc.build()
    for executor in ("blocking", "async"):
        session = TransferSession()
        with sanitize() as san:
            ms = run_policy_scenario(sc, tree=tree, passes=POLICY_PASSES,
                                     executor=executor, session=session,
                                     device=device)
        for i, m in enumerate(ms):
            got = {k: (r["h2d_bytes"], r["h2d_calls"])
                   for k, r in m.regions.items()}
            if not (m.ok and m.motion_ok and m.syncs == 1
                    and got == (cold if i == 0 else steady)):
                fail(f"sanitized {sc.name} {executor} pass {i}: ok={m.ok} "
                     f"motion_ok={m.motion_ok} syncs={m.syncs} regions "
                     f"{got}")
        if (san.events.get("pass"), san.events.get("sync")) != (
                POLICY_PASSES, POLICY_PASSES):
            fail(f"sanitized {sc.name} {executor}: {POLICY_PASSES} passes "
                 f"reported events {san.events}")
        say(f"[sanitizer] (a) {sc.name} {executor}: {POLICY_PASSES} passes,"
            f" regions == closed forms, one barrier a pass, no finding; "
            f"walls {[round(m.wall_us / 1e3, 2) for m in ms]} ms; events "
            f"{_events(san)}")
        session.clear()
        release_host_cache()
    del tree
    release_host_cache()
    if _launched(kernels):
        fail(f"the sanitized drives launched {_launched(kernels)}; they run "
             f"no kernel")


def sanitizer_overhead(device, n: int, rounds: int) -> None:
    """Part (b): the steady pass wall of a 4n-byte f32 tree under
    marshal+db (two fingerprints a pass: at enqueue and at drain) and
    marshal+delta (the identity path: a byte compare every VERIFY_EVERY
    passes), alternating passes without and with one long-lived
    sanitizer; and the fingerprint alone on the pinned staging buffer.
    Recorded, not asserted."""
    import statistics
    import torch
    from repro_torch._device import synchronize
    from repro_torch.analysis import sanitizer
    from repro_torch.core import TransferSession, transfer_scheme

    tree = {"w": torch.arange(n, dtype=torch.float32)}
    for spec in ("marshal+db", "marshal+delta"):
        session = TransferSession()
        scheme = transfer_scheme(spec, session, device=device)
        for _ in range(2):
            scheme.to_device(tree)
        synchronize(device)
        san = sanitizer.Sanitizer()
        walls = {False: [], True: []}
        try:
            for _ in range(rounds):
                for on in (False, True):
                    sanitizer._ACTIVE = san if on else None
                    t0 = time.perf_counter()
                    scheme.to_device(tree)
                    synchronize(device)
                    walls[on].append(time.perf_counter() - t0)
        finally:
            sanitizer._ACTIVE = None
        off, on = (statistics.median(walls[k]) * 1e3 for k in (False, True))
        say(f"[sanitizer] (b) {spec} steady pass at {4 * n} B: "
            f"{off:.2f} ms without, {on:.2f} ms with the sanitizer "
            f"({on / off:.2f}x; without {_spread_ms(walls[False])}, with "
            f"{_spread_ms(walls[True])} over {rounds} alternating rounds); "
            f"events {_events(san)}")
        if spec == "marshal+db":
            staging = scheme._entry.staging["float32"]
            folds = []
            for _ in range(3):
                t0 = time.perf_counter()
                sanitizer._fingerprint(staging)
                folds.append(time.perf_counter() - t0)
            say(f"[sanitizer] (b) one fingerprint of the {4 * n} B pinned "
                f"staging buffer: {min(folds) * 1e3:.2f} ms (min of 3) = "
                f"{4 * n / min(folds) / 1e9:.2f} GB/s on the host")
        session.clear()
        del scheme
        release_host_cache()


def _hold_copy_stream(device, seconds: float) -> None:
    """Queue a sleep on the copy stream, so the next pass's copies are
    still waiting to run when the host goes on (about 2e9 cycles a
    second)."""
    import torch
    from repro_torch._device import copy_stream

    with torch.cuda.stream(copy_stream(device)):
        torch.cuda._sleep(int(seconds * 2e9))


def sanitizer_mutants(device, n: int) -> None:
    """Part (c): the six seeded mutants of
    tests/test_torch_sanitizer_mutants.py on a tree of 4n bytes of f32
    (plus 4 KiB of int32) on the card, each raising its own code, and its
    clean counterpart silent.  For DC301 and DC305 the copy stream is held
    (``_hold_copy_stream``) so the copy is in flight when the staging is
    rewritten, and whether the card's bytes then differ from the bytes at
    enqueue time is recorded, not asserted."""
    import torch
    from repro_torch.analysis import sanitizer
    from repro_torch.analysis.sanitizer import StagingRaceError, sanitize
    from repro_torch.core import TransferSession, engine, transfer_scheme
    from repro_torch.core.schemes import MarshalScheme
    from repro_torch.core.spec import TransferSpec

    def tree(v):
        return {"w": torch.full((n,), float(v)),
                "i": torch.arange(1024, dtype=torch.int32) + v}

    def drive(fn):
        """``fn(session)`` under a fresh sanitizer: the code it raised
        (None if none) and the events."""
        session = TransferSession()
        with sanitize() as san:
            try:
                fn(session)
                got = None
            except StagingRaceError as e:
                got = e.code
        torch.cuda.synchronize(device)
        session.clear()
        release_host_cache()
        return got, _events(san)

    def skip_fence_wait(session):
        session.get_entry(tree(0), 1, pin_memory=True)._wait_fence = \
            lambda bucket, buf_idx: None

    def fenced_passes(mutate):
        def fn(session):
            s = transfer_scheme("marshal+db", session, device=device)
            if mutate:
                skip_fence_wait(session)
            _hold_copy_stream(device, SAN_HOLD_S)
            fn.devs = [s.to_device(tree(v)) for v in (1, 2, 3)]
        return fn

    def leaky(session):
        entry = session.get_entry(tree(0), 1, pin_memory=True)

        def add_fence(bucket, event):   # the bug: no FENCE_DEPTH trim
            fence = entry._fences[bucket][entry._active[bucket]]
            fence.append(event)
            if sanitizer._ACTIVE is not None:
                sanitizer._ACTIVE.on_add_fence(
                    entry, bucket, entry._active[bucket], len(fence),
                    engine.FENCE_DEPTH)
        entry.add_fence = add_fence

    def fences(mutate):
        def fn(session):
            entry = session.get_entry(tree(0), 1, pin_memory=True)
            if mutate:
                leaky(session)
            entry.pack_host(tree(0))
            for _ in range(engine.FENCE_DEPTH + 3):
                event = torch.cuda.Event()
                event.record()
                entry.add_fence("float32", event)
        return fn

    class DoubleSync(MarshalScheme):
        def _begin_pipelined(self, t):  # the bug: a barrier per region
            entry = self._entry_for(t)
            buffers = entry.pack_host(t)
            names = list(buffers)
            dev, _ = self._put_batch([buffers[b] for b in names], sync=True)
            return dev, lambda: entry.unpack(dict(zip(names, dev)))

    class ReuseDrained(MarshalScheme):
        def _begin_pipelined(self, t):  # the bug: the spare buffer shipped
            entry = self._entry_for(t)
            entry.pack_host(t)
            names = list(entry.staging)
            stale = {b: entry._bufs[b][1 - entry._active[b]] for b in names}
            dev, _ = self._put_batch([stale[b] for b in names], sync=False)
            self._san_enqueued(entry, stale, names)
            return dev, lambda: entry.unpack(dict(zip(names, dev)))

    def scheme_pass(cls):
        def fn(session):
            cls(TransferSpec.parse("marshal+db"), session,
                device=device).to_device(tree(1))
        return fn

    def program_pass(cls):
        def fn(session):
            program = session.compile(tree(1), "**=marshal+db",
                                      device=device)
            if cls is not None:
                key = next(iter(program._schemes))
                program._schemes[key] = cls(TransferSpec.parse("marshal+db"),
                                            session, device=device)
            program.to_device(tree(1))
        return fn

    def scribble(mutate):
        def fn(session):
            s = transfer_scheme("marshal+db", session, device=device)
            _hold_copy_stream(device, SAN_HOLD_S)
            pending, finish = s.begin_pass(tree(1))
            fn.f32 = pending[list(s._entry.staging).index("float32")]
            if mutate:
                s._entry.staging["float32"][0] += 1.0  # lint: allow=DC204 -- seeded bug
            finish()
        return fn

    def identity(mutate):
        def fn(session):
            s = transfer_scheme("marshal+delta", session, device=device)
            t = tree(1)
            s.to_device(t)
            s.to_device(t)
            t["w"][0] += 42.0
            if not mutate:
                s.mark_dirty(t)
            s.to_device(t)
        return fn

    # the hazard itself: DC301's mutant run without the sanitizer
    session = TransferSession()
    hazard = fenced_passes(True)
    hazard(session)
    torch.cuda.synchronize(device)
    landed = float(hazard.devs[0]["w"][0])
    say(f"[sanitizer] (c) hazard, no sanitizer: the first of three "
        f"marshal+db passes of {4 * n} B, its copy held behind a "
        f"{SAN_HOLD_S} s sleep and its staging rewritten by the third pass "
        f"with the fence wait skipped: the card holds {landed} where 1.0 "
        f"was enqueued ({'corrupted' if landed != 1.0 else 'intact'})")
    del hazard
    session.clear()
    release_host_cache()

    for code, bad, good in (
            ("DC301", fenced_passes(True), fenced_passes(False)),
            ("DC302", scheme_pass(ReuseDrained), scheme_pass(MarshalScheme)),
            ("DC303", fences(True), fences(False)),
            ("DC304", program_pass(DoubleSync), program_pass(None)),
            ("DC305", scribble(True), scribble(False)),
            ("DC306", identity(True), identity(False))):
        got, bad_events = drive(bad)
        if got != code:
            fail(f"sanitizer mutant {code} raised {got}")
        clean, good_events = drive(good)
        if clean is not None:
            fail(f"the clean counterpart of mutant {code} raised {clean}")
        note = ""
        if code == "DC301":
            ok = all(float(d["w"][0]) == v
                     for d, v in zip(good.devs, (1.0, 2.0, 3.0)))
            note = (f"; clean passes held behind the sleep land "
                    f"{'intact' if ok else 'CORRUPTED'}")
            if not ok:
                fail("the fence discipline let a held copy be corrupted")
        if code == "DC305":
            differs = float(bad.f32[0]) != 1.0
            note = (f"; the held copy landed "
                    f"{float(bad.f32[0])} where 1.0 was enqueued "
                    f"({'the bytes differ' if differs else 'the same bytes'})")
        say(f"[sanitizer] (c) mutant {code} at {4 * n} B: caught as {code}, "
            f"clean counterpart silent{note}; events {bad_events} / "
            f"{good_events}")


def sanitizer_phase(device, kernels: dict, real_cases) -> None:
    """Phase 16: parts (a)-(c); no kernel may launch.  The mutants'
    drives keep their device trees on function attributes (reference
    cycles), so the cache release at the end collects them before the
    next phase measures its peak memory."""
    import torch

    walls = []
    for part in (lambda: sanitizer_clean(device, kernels, real_cases),
                 lambda: sanitizer_overhead(device, SAN_OVERHEAD_N,
                                            SAN_ROUNDS),
                 lambda: sanitizer_mutants(device, SAN_MUTANT_N)):
        t0 = time.perf_counter()
        part()
        walls.append(time.perf_counter() - t0)
    release_host_cache()
    if _launched(kernels):
        fail(f"the sanitizer phase launched {_launched(kernels)}")
    say(f"[sanitizer] phase 16 ok in {sum(walls):.2f} s ((a) {walls[0]:.2f}"
        f" s, (b) {walls[1]:.2f} s, (c) {walls[2]:.2f} s), no kernel "
        f"launched; {torch.cuda.memory_allocated(device)} B allocated on "
        f"the card after it")


# -- phase 15: training ------------------------------------------------------

def _grad_check(what: str, got, want, tol: float) -> float:
    """max |got - want| over the pairs, failing past ``tol`` (absolute
    plus relative)."""
    import torch

    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{what} gradient {i}: {a.dtype} {tuple(a.shape)} != plain "
                 f"{b.dtype} {tuple(b.shape)}")
        e = float((a.float() - b.float()).abs().max())
        if not torch.allclose(a.float(), b.float(), rtol=tol, atol=tol):
            fail(f"{what} gradient {i}: max |diff| {e} past {tol}")
        err = max(err, e)
    return err


def train_kernel_grads(device, rows: int, D: int, B: int, H: int, KV: int,
                       S: int, hd: int) -> dict:
    """Part (a): each kernel's autograd.Function on the card (the kernel
    forward, the plain version's gradient backward) against
    ``torch.autograd`` of the plain version on the same inputs, in f32
    (within TRAIN_F32_TOL) and bf16 (within BF16_TOL): rmsnorm's dx and
    dscale at (rows, D), causal flash's dq, dk, dv at B, H/KV heads, S, hd.
    Returns the max |diff| per kernel."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK, ref as FR
    from repro_torch.kernels.rmsnorm import kernel as RK, ref as RR

    out = {"rmsnorm": 0.0, "flash_attention": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TRAIN_F32_TOL if dtype == torch.float32 else BF16_TOL
        gen = torch.Generator(device=device).manual_seed(15)
        x = torch.randn(rows, D, generator=gen, device=device).to(dtype)
        w = (1 + 0.1 * torch.randn(D, generator=gen, device=device)).to(dtype)
        g = torch.randn(rows, D, generator=gen, device=device).to(dtype)
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        got = torch.autograd.grad(RK.rmsnorm(xa, wa), (xa, wa), g)
        xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
        want = torch.autograd.grad(RR.rmsnorm_ref(xb, wb), (xb, wb), g)
        # dscale sums over the rows: its tolerance scales with its size
        dscale_tol = tol * max(1.0, float(want[1].float().abs().max()))
        out["rmsnorm"] = max(out["rmsnorm"],
                             _grad_check(f"rmsnorm {dtype} dx", got[:1],
                                         want[:1], tol),
                             _grad_check(f"rmsnorm {dtype} dscale", got[1:],
                                         want[1:], dscale_tol))
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=device
                               ).to(dtype).transpose(1, 2)
                   for n in (H, KV, KV))
        g = torch.randn(B, H, S, hd, generator=gen, device=device).to(dtype)
        qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
        got = torch.autograd.grad(FK.flash_attention(qa, ka, va, causal=True),
                                  (qa, ka, va), g)
        qb, kb, vb = (t.detach().requires_grad_() for t in (q, k, v))
        want = torch.autograd.grad(FR.attention_ref(qb, kb, vb, causal=True),
                                   (qb, kb, vb), g)
        out["flash_attention"] = max(
            out["flash_attention"],
            _grad_check(f"flash_attention {dtype} dq/dk/dv", got, want, tol))
    say(f"[train] (a) the backward's wiring (its gradient is the plain "
        f"version's; phase 3 checks the forward kernels): autograd on the "
        f"card == autograd of the plain version: rmsnorm dx, dscale at ({rows}, {D}) max |diff| {out['rmsnorm']}; "
        f"causal flash_attention dq, dk, dv at B {B}, {H}/{KV} heads, S {S}, "
        f"hd {hd} max |diff| {out['flash_attention']} (f32 within "
        f"{TRAIN_F32_TOL}, bf16 within {BF16_TOL})")
    return out


def train_ssd_grads(device, B: int, S: int, nh: int, hd: int, N: int,
                    chunk: int) -> float:
    """Part (a), continued: ssd_chunks' autograd.Function on the card (the
    kernel forward, the plain version's gradient backward) against
    ``torch.autograd`` of the plain version, with y_diag, states and cum
    each carrying a seeded gradient, at B x S tokens cut into chunks of
    ``chunk`` (nh heads of hd, state N), in f32 (within TRAIN_F32_TOL) and
    bf16 (within BF16_TOL); one launch forward, none backward.  Returns the
    max |diff|."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as SK, ref as SR

    nc = S // chunk
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = TRAIN_F32_TOL if dtype == torch.float32 else BF16_TOL
        gen = torch.Generator(device=device).manual_seed(16)
        x = torch.randn(B, nc, chunk, nh, hd, generator=gen, device=device
                        ).to(dtype).transpose(2, 3)
        dt = 0.01 + 0.1 * torch.rand(B, nc, nh, 1, chunk, generator=gen,
                                     device=device)
        dtA = -dt * (0.1 + torch.rand(nh, 1, 1, generator=gen,
                                      device=device))
        Bm, Cm = (torch.randn(B, nc, chunk, N, generator=gen, device=device
                              ).to(dtype) for _ in range(2))
        ins = (x, dt, dtA, Bm, Cm)
        leaves = [t.detach().requires_grad_() for t in ins]
        before = SK.ssd_chunks.launches
        outs = SK.ssd_chunks(*leaves)
        grads = [torch.randn(o.shape, generator=gen, device=device
                             ).to(o.dtype) for o in outs]
        got = torch.autograd.grad(outs, leaves, grads)
        if device.type == "cuda" and SK.ssd_chunks.launches != before + 1:
            fail(f"ssd_chunks under autograd launched "
                 f"{SK.ssd_chunks.launches - before} times, not once")
        plain = [t.detach().requires_grad_() for t in ins]
        want = torch.autograd.grad(SR.ssd_chunks_ref(*plain), plain, grads)
        err = max(err, _grad_check(f"ssd_chunks {dtype} dx/ddt/ddtA/dB/dC",
                                   got, want, tol))
    say(f"[train] (a) ssd_chunks: autograd on the card == autograd of the "
        f"plain version for x, dt, dtA, B and C at B {B}, S {S} in chunks of "
        f"{chunk}, {nh} heads of {hd}, state {N} (y_diag, states and cum "
        f"each carrying a gradient): max |diff| {err} (f32 within "
        f"{TRAIN_F32_TOL}, bf16 within {BF16_TOL}); one launch forward, "
        f"none backward")
    return err


def train_family(device, kernels: dict, cfg, batch: int, seq: int,
                 steps: int) -> dict:
    """Part (f): ``cfg`` at full width trains ``steps`` steps through
    ``runtime.loop.run`` from params drawn on the card, on one batch
    repeated: finite losses, each lower than the one before wherever the
    update between them had a nonzero lr, the launches exactly
    ``kernel_launches(cfg, train_steps=steps)``.  Prints the step walls,
    one step's device busy share and the peak device memory; returns the
    launch counts."""
    import torch
    from repro_torch._device import synchronize
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm, registry
    from repro_torch.models.specs import param_count
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.runtime import loop, train

    api = registry.get_model(cfg)
    opt = make_optimizer(cfg.optimizer)
    warmup = min(100, steps // 10 + 1)
    step = train.make_train_step(api, opt,
                                 warmup_cosine(TRAIN_LR, warmup, steps))
    data = SyntheticLM(cfg.vocab_size, seq, batch)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device) if cuda else 0
    held = [train.train_state(api, opt, torch.Generator(
        device=device).manual_seed(0), device=device)]
    one = data.batch(0)
    for k in kernels.values():
        k.launches = 0
    res = loop.run(step, held.pop, lambda s: one, steps, device=device)
    synchronize(device)
    counts = {name: k.launches for name, k in kernels.items()}
    want = {"gather_tiles": 0, **lm.kernel_launches(cfg, train_steps=steps)}
    if counts != want:
        fail(f"{cfg.name} training launched {counts}, expected {want}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    losses = [m["loss"] for m in res.metrics_history]
    lrs = [float(m["lr"]) for m in res.metrics_history]
    if not all(x == x and abs(x) != float("inf") for x in losses):
        fail(f"{cfg.name} training: non-finite loss {losses}")
    rises = [s for s in range(1, steps)
             if lrs[s - 1] > 0 and not losses[s] < losses[s - 1]]
    if rises:
        fail(f"{cfg.name} training on one batch: the updates before steps "
             f"{rises} did not lower the loss ({losses}; lrs {lrs})")
    walls = [m["wall_s"] for m in res.metrics_history]
    tps = batch * seq / sorted(walls[1:])[len(walls[1:]) // 2]
    say(f"[train] (f) {cfg.name} at full width ({cfg.family}, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{param_count(lm.spec_tree(cfg))} {cfg.param_dtype} params, "
        f"{cfg.optimizer}, remat {cfg.remat}), batch {batch} x seq {seq}, "
        f"lr warmup_cosine({TRAIN_LR}, {warmup}, {steps}), {steps} steps on "
        f"one batch: losses {[round(x, 4) for x in losses]}, each lower than "
        f"the one before after an update with a nonzero lr; launches "
        f"{counts} == kernel_launches(train_steps={steps}); step wall: first "
        f"{walls[0] * 1e3:.2f} ms, then {_spread_ms(walls[1:])}; {tps:.1f} "
        f"tokens/s at the median; peak device memory {peak} B ({before} B "
        f"allocated before the run)")
    bat = data.batch(steps)
    prof = profile_device_ms(device, lambda: step(res.state, bat), calls=2)
    if prof["device_ms"]:
        say(f"[train] (f) {cfg.name} profile, one step: "
            f"{prof['wall_ms']:.2f} ms of wall (unprofiled), device busy "
            f"{prof['device_ms']:.2f} ms under the profiler, so the device is "
            f"idle {100 * max(0.0, 1 - prof['device_ms'] / prof['wall_ms']):.1f}"
            f"% of the step; top device ops {prof['top']}")
    else:
        say(f"[train] (f) {cfg.name} profile: the profiler recorded no "
            f"device time; device busy share not measured")
    del res, bat, held
    release_host_cache()
    return counts


def train_card_vs_cpu(device, cfg, batch: int, seq: int,
                      part: str = "b") -> float:
    """Part (b) (and (f)'s checks): one train step's loss and gradients of ``cfg`` (f32) on
    the card, through the kernels, against the CPU, through the plain
    versions, from the same params (drawn on the CPU and carried over by
    ``convert``'s round trip): the loss within rtol 1e-4, every gradient
    leaf within TRAIN_STEP_TOL of its largest element, and every leaf's
    gradient on the card nonzero.  Returns the largest relative gap."""
    import torch
    from repro_torch.convert import params_from_reference, to_reference_tree
    from repro_torch.core import leaf_paths, tree_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.runtime import train

    api = registry.get_model(cfg)
    t0 = time.perf_counter()
    host = api.init(torch.Generator().manual_seed(15), device="cpu")
    params = params_from_reference(to_reference_tree(host), device)
    b = SyntheticLM(cfg.vocab_size, seq, batch, seed=15).batch(0)
    loss, _, grads = train.value_and_grad(
        api.loss_fn, params, {k: torch.as_tensor(v, device=device)
                              for k, v in b.items()})
    h_loss, _, h_grads = train.value_and_grad(
        api.loss_fn, host, {k: torch.as_tensor(v) for k, v in b.items()})
    if abs(float(loss) - float(h_loss)) > 1e-4 * abs(float(h_loss)):
        fail(f"train step card vs CPU: loss {float(loss)} != {float(h_loss)}")
    worst = 0.0
    for path, g, h in zip(leaf_paths(grads), tree_leaves(grads),
                          tree_leaves(h_grads)):
        top = float(h.abs().max())
        if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0:
            fail(f"train step on the card: the gradient of {path} is zero "
                 f"or not finite")
        gap = float((g.cpu() - h).abs().max()) / max(top, 1e-30)
        if gap > TRAIN_STEP_TOL:
            fail(f"train step card vs CPU: {path} differs by {gap} of its "
                 f"largest |grad| {top} (tolerance {TRAIN_STEP_TOL})")
        worst = max(worst, gap)
    say(f"[train] ({part}) {cfg.name} at full width cut to {cfg.num_layers} "
        f"layers (f32, remat {cfg.remat}), batch {batch} x seq {seq}: loss "
        f"{float(loss):.6f} on the card (kernels) vs {float(h_loss):.6f} on "
        f"the CPU (plain versions); all {len(tree_leaves(grads))} gradient "
        f"leaves nonzero on the card and within {worst:.3g} of their "
        f"largest element of the CPU's (tolerance {TRAIN_STEP_TOL}) in "
        f"{time.perf_counter() - t0:.2f} s")
    return worst


def _spread_ms(xs) -> str:
    import statistics

    ms = [x * 1e3 for x in xs]
    return (f"mean {statistics.mean(ms):.2f} ms, median "
            f"{statistics.median(ms):.2f} ms ({min(ms):.2f}-{max(ms):.2f})")


def train_full(device, kernels: dict, cfg, batch: int, seq: int, steps: int,
               ckpt_root: Path, ledgers_want=None,
               offload_want=None) -> dict:
    """Part (c): ``cfg`` at full size trains ``steps`` steps through
    ``runtime.loop.run`` from params drawn on the card, on one batch
    repeated: finite losses, each lower than the one before wherever the
    update between them had a nonzero lr, whose last-3 mean lies below the
    first 3's by more than the spread of the initial model's loss over
    fresh batches, the launches exactly
    ``kernel_launches(cfg, train_steps=steps)``.  Then one
    AsyncCheckpointer save of the whole state, a restore of it through
    ``state_transfer_policy()``'s program with a StatePrefetcher (region
    ledgers == the arena plan == ``ledgers_want``; the staged state equal
    to the saved one bit for bit), and one OffloadedOptimizer step under
    marshal (ledger == ``offload_want``; new params equal to the resident
    AdamW's on the same gradients, bit for bit).  Returns the run's launch
    counts and its numbers."""
    import statistics
    import torch
    from repro_torch._device import synchronize
    from repro_torch.checkpoint import AsyncCheckpointer, load
    from repro_torch.core import TransferSession, tree_bytes, tree_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm, registry
    from repro_torch.models.specs import param_count
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.optim.quantized import OffloadedOptimizer
    from repro_torch.runtime import loop, train

    api = registry.get_model(cfg)
    opt = make_optimizer(cfg.optimizer)
    lr = warmup_cosine(TRAIN_LR, min(100, steps // 10 + 1), steps)
    data = SyntheticLM(cfg.vocab_size, seq, batch)
    step = train.make_train_step(api, opt, lr)
    say(f"[train] (c) {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
        f"{cfg.vocab_size}, {param_count(lm.spec_tree(cfg))} {cfg.param_dtype}"
        f" params, {cfg.optimizer}, remat {cfg.remat}; batch {batch} x seq "
        f"{seq}, lr warmup_cosine({TRAIN_LR}, {min(100, steps // 10 + 1)}, "
        f"{steps})")
    before = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    held = [train.train_state(api, opt, torch.Generator(
        device=device).manual_seed(0), device=device)]
    with torch.no_grad():
        fresh = [float(api.loss_fn(held[0]["params"], train._batch_on(
            data.batch(s), device))[1]["loss"])
            for s in range(1, 1 + TRAIN_SPREAD_BATCHES)]
    spread = max(fresh) - min(fresh)
    one = data.batch(0)
    for k in kernels.values():
        k.launches = 0
    # the loop takes the state over (nothing else holds the initial one)
    res = loop.run(step, held.pop, lambda s: one, steps, device=device)
    synchronize(device)
    counts = {name: k.launches for name, k in kernels.items()}
    want = {"gather_tiles": 0, **lm.kernel_launches(cfg, train_steps=steps)}
    if counts != want:
        fail(f"{cfg.name} training launched {counts}, expected {want}")
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    losses = [m["loss"] for m in res.metrics_history]
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        fail(f"{cfg.name} training: non-finite loss {losses}")
    lrs = [float(m["lr"]) for m in res.metrics_history]
    rises = [s for s in range(1, steps)
             if lrs[s - 1] > 0 and not losses[s] < losses[s - 1]]
    if rises:
        fail(f"{cfg.name} training on one batch: the updates before steps "
             f"{rises} did not lower the loss ({losses}; lrs {lrs})")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not first - last > spread:
        fail(f"{cfg.name} training on one batch: the loss fell by "
             f"{first - last:.4f}, not by more than the batches' spread "
             f"{spread:.4f} ({losses}; initial loss on fresh batches "
             f"{fresh})")
    nbytes = tree_bytes(res.state)
    walls = [m["wall_s"] for m in res.metrics_history]
    warm = walls[1:]
    tps = batch * seq / statistics.median(warm)
    norms = ["%.3g" % m["grad_norm"] for m in res.metrics_history]
    say(f"[train] (c) {steps} steps on one batch: losses "
        f"{[round(x, 4) for x in losses]}, each lower than the one before "
        f"after an update with a nonzero lr, grad norms {norms}; first 3 "
        f"mean {first:.4f} - last 3 mean {last:.4f} = {first - last:.4f} = "
        f"{(first - last) / spread:.2f} x the spread {spread:.4f} of the "
        f"initial loss over {TRAIN_SPREAD_BATCHES} fresh batches "
        f"({min(fresh):.4f}-{max(fresh):.4f}); launches "
        f"{counts} == kernel_launches(train_steps={steps}); step wall: first "
        f"{walls[0] * 1e3:.2f} ms, then {_spread_ms(warm)}; {tps:.1f} tokens/s"
        f" at the median; train state {nbytes} B, peak device memory "
        f"{peak} B ({before} B allocated before the run)")
    bat = data.batch(steps)
    prof = profile_device_ms(device, lambda: step(res.state, bat))
    if prof["device_ms"]:
        say(f"[train] (c) profile, one step: {prof['wall_ms']:.2f} ms of wall "
            f"(unprofiled), device busy {prof['device_ms']:.2f} ms under the "
            f"profiler, so the device is idle "
            f"{100 * max(0.0, 1 - prof['device_ms'] / prof['wall_ms']):.1f}% "
            f"of the step; top device ops {prof['top']}")
    else:
        say("[train] (c) profile: the profiler recorded no device time; "
            "device busy share not measured")

    # one asynchronous save of the whole state, written and committed
    ckpt_dir = ckpt_root / "full"
    ac = AsyncCheckpointer(str(ckpt_dir), keep=1)
    t0 = time.perf_counter()
    ac.save(res.state, steps)
    stall = ac.last_stall_s
    snapshot = ac._snapshot.nbytes()
    ac.wait()
    write_s = time.perf_counter() - t0
    on_disk = sum(f.stat().st_size for f in (ckpt_dir / f"step_{steps:08d}"
                                             ).iterdir())
    say(f"[train] (c) AsyncCheckpointer.save: stall {stall * 1e3:.2f} ms on "
        f"the caller, {on_disk} B written and committed in {write_s:.2f} s = "
        f"{on_disk / write_s / 1e9:.3f} GB/s (device pack, D2H into "
        f"{snapshot} B of pinned snapshot buffers, write, fsync, rename)")
    ac.close()
    release_host_cache()

    # restore through the state policy's program
    t0 = time.perf_counter()
    host = load(str(ckpt_dir))
    load_s = time.perf_counter() - t0
    session = TransferSession()
    t1 = time.perf_counter()
    program = train.compile_state_program(host, session=session,
                                          device=device)
    compile_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    prefetch = train.StatePrefetcher(program)
    prefetch.schedule(host)
    restored = prefetch.take()
    synchronize(device)
    h2d_s = time.perf_counter() - t2
    ledgers = {k: (l.h2d_bytes, l.h2d_calls)
               for k, l in program.ledgers.items()}
    closed = region_closed_forms(host, program.policy)
    if ledgers != closed or (ledgers_want is not None
                             and ledgers != ledgers_want):
        fail(f"{cfg.name} state restore ledgers {ledgers}; arena plan "
             f"{closed}; closed forms {ledgers_want}")
    bad = [i for i, (a, b) in enumerate(zip(tree_leaves(restored),
                                            tree_leaves(res.state)))
           if a.dtype != b.dtype or not torch.equal(a, b)]
    if bad:
        fail(f"{cfg.name} restored state differs from the saved one at "
             f"leaves {bad}")
    pinned = pinned_report(session)
    say(f"[train] (c) restore under '{program.policy}': load {load_s:.2f} s "
        f"({on_disk / load_s / 1e9:.3f} GB/s from disk), compile "
        f"{compile_s:.2f} s, h2d {h2d_s:.2f} s (host pack into pinned "
        f"staging + copies: {nbytes / h2d_s / 1e9:.3f} GB/s; one synchronize "
        f"{program.last_stats.sync_s * 1e3:.1f} ms); region ledgers "
        f"{ledgers} == arena plan == closed forms; the staged state == the "
        f"saved one bit for bit; {pinned}")
    program.clear()
    session.clear()
    del host, restored, program, prefetch
    release_host_cache()

    # one step with the optimizer state offloaded to the host (marshal)
    params = res.state["params"]
    grads = train.value_and_grad(api.loss_fn, params, {
        k: torch.as_tensor(v, device=device) for k, v in bat.items()})[2]
    rate = lr(res.state["step"])
    resident, _ = opt.update(grads, opt.init(params), params, rate)
    off = OffloadedOptimizer(opt, "marshal", device=device)
    t0 = time.perf_counter()
    off.init(params)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    new = off.step(grads, params, rate)
    synchronize(device)
    off_s = time.perf_counter() - t0
    led = (off.scheme.ledger.h2d_bytes, off.scheme.ledger.h2d_calls)
    if offload_want is not None and led != offload_want:
        fail(f"OffloadedOptimizer marshal ledger {led} != {offload_want}")
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(new),
                                                 tree_leaves(resident))):
        fail("OffloadedOptimizer's step differs from the resident AdamW's")
    say(f"[train] (c) OffloadedOptimizer(adamw, 'marshal'): init (state to "
        f"the host) {init_s:.2f} s; one step {off_s:.2f} s (H2D {led[0]} B in"
        f" {led[1]} copies == closed form, update, D2H back); new params == "
        f"the resident AdamW's bit for bit; "
        f"{pinned_report(off.scheme.session)}")
    off.scheme.session.clear()
    del off, new, resident, grads, params
    release_host_cache()
    cli = serve_cli(device, kernels, cfg, ckpt_dir, res.state["params"])
    del res
    release_host_cache()
    return {"counts": counts, "step_ms": statistics.median(warm) * 1e3,
            "tokens_per_s": tps, "serve-cli": cli}


def _cli_requests(vocab: int, n: int, max_new: int):
    """The serve CLI's request stream: default_rng(0), prompts of 4-15
    tokens (repro_torch/launch/serve.py, as the reference's)."""
    import numpy as np
    from repro_torch.runtime import Request

    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(
        0, vocab, size=int(rng.integers(4, 16))).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


def serve_cli(device, kernels: dict, cfg, ckpt_dir: Path, params,
              cli_args=None) -> dict:
    """Part (e): ``repro_torch.launch.serve.main`` at ``cfg``'s full size
    (``cli_args``, default ``--arch cfg.name``: the card, the registry's
    config) with ``--ckpt-dir`` on part (c)'s checkpoint and the CLI's
    defaults:
    the served params equal to (c)'s final ``params`` bit for bit, every
    request completed with its tokens, and the tokens and the launches
    equal to those of a Server built on the in-memory ``params`` over the
    same requests.  Returns the CLI run's launch counts."""
    import contextlib
    import io
    import re
    import torch
    from repro_torch._device import synchronize
    from repro_torch.core import TransferSession, get_session, tree_leaves
    from repro_torch.launch import serve as cli
    from repro_torch.models import registry
    from repro_torch.runtime import Server

    for k in kernels.values():
        k.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        server, done = cli.main((cli_args or ["--arch", cfg.name])
                                + ["--ckpt-dir", str(ckpt_dir)])
    synchronize(device)
    wall = time.perf_counter() - t0
    counts = {name: k.launches for name, k in kernels.items()}
    text = out.getvalue()
    for line in text.strip().splitlines():
        say(f"[train] (e) serve CLI: {line}")
    restore_s = float(re.search(r" in ([0-9.]+)s", text).group(1))
    tok_s = float(re.search(r"\(([0-9.]+) tok/s\)", text).group(1))
    bad = [i for i, (a, b) in enumerate(zip(tree_leaves(server.params),
                                            tree_leaves(params)))
           if a.dtype != b.dtype or not torch.equal(a, b)]
    if bad or len(tree_leaves(server.params)) != len(tree_leaves(params)):
        fail(f"the serve CLI's params differ from (c)'s at leaves {bad}")
    got = {r.rid: list(r.tokens_out) for r in done}
    if (server.stats.completed != SERVE_CLI["requests"]
            or sorted(got) != list(range(SERVE_CLI["requests"]))
            or any(len(t) != SERVE_CLI["max_new"] for t in got.values())):
        fail(f"the serve CLI finished {sorted(got)} with {server.stats}")
    del server, done
    get_session().clear()
    release_host_cache()

    session = TransferSession()
    ref = Server(registry.get_model(cfg), params, slots=SERVE_CLI["slots"],
                 max_seq=SERVE_CLI["max_seq"], session=session,
                 device=device)
    for req in _cli_requests(cfg.vocab_size, SERVE_CLI["requests"],
                             SERVE_CLI["max_new"]):
        ref.submit(req)
    for k in kernels.values():
        k.launches = 0
    want = {r.rid: list(r.tokens_out) for r in ref.run(
        max_steps=SERVE_CLI["requests"] * SERVE_CLI["max_new"] + 50)}
    synchronize(device)
    ref_counts = {name: k.launches for name, k in kernels.items()}
    if got != want:
        fail(f"the serve CLI's tokens differ from the in-memory Server's at "
             f"requests {[r for r in want if got.get(r) != want[r]]}")
    if counts != ref_counts:
        fail(f"the serve CLI launched {counts}, the in-memory Server "
             f"{ref_counts}")
    say(f"[train] (e) serve CLI on (c)'s checkpoint: restore (selective "
        f"params read + full load) {restore_s:.2f} s, {wall:.2f} s in all; "
        f"params == (c)'s bit for bit; {len(got)} requests completed, "
        f"{tok_s} tokens/s; tokens == an in-memory Server's over the same "
        f"requests; launches {counts} == that Server's")
    del ref
    session.clear()
    release_host_cache()
    return counts


def train_restart(device, kernels: dict, cfg, batch: int, seq: int,
                  steps: int, every: int, fail_at: int,
                  ckpt_root: Path) -> dict:
    """Part (d): under deterministic algorithms, ``steps`` steps of ``cfg``
    uninterrupted, then again with a checkpoint every ``every`` steps and
    a NodeFailure at step ``fail_at``, restored through the state policy's
    program: trajectory_diff empty (losses and grad norms) and the final
    states equal bit for bit; launches exactly kernel_launches over the
    steps both runs took.  Returns the counts."""
    import torch
    from repro_torch.core import get_session, tree_bytes, tree_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm, registry
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.runtime import (NodeFailure, loop, train,
                                     trajectory_diff)

    api = registry.get_model(cfg)
    opt = make_optimizer(cfg.optimizer)
    step = train.make_train_step(api, opt, warmup_cosine(
        TRAIN_LR, min(100, steps // 10 + 1), steps))
    data = SyntheticLM(cfg.vocab_size, seq, batch)
    init = lambda: train.train_state(api, opt, torch.Generator(
        device=device).manual_seed(1), device=device)
    boom = {"armed": True}

    def node_failure(s):
        if s == fail_at and boom["armed"]:
            boom["armed"] = False
            raise NodeFailure(f"simulated node loss at step {s}")

    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        a = loop.run(step, init, data.batch, steps, device=device)
        b = loop.run(step, init, data.batch, steps,
                     ckpt_dir=str(ckpt_root / "restart"), ckpt_every=every,
                     failure_injector=node_failure,
                     state_policy=train.state_transfer_policy(),
                     device=device)
    finally:
        torch.use_deterministic_algorithms(False)
    wall = time.perf_counter() - t0
    counts = {name: k.launches for name, k in kernels.items()}
    taken = steps + fail_at + (steps - (fail_at // every) * every)
    want = {"gather_tiles": 0, **lm.kernel_launches(cfg, train_steps=taken)}
    if counts != want:
        fail(f"restart runs launched {counts}, expected {want} ({taken} "
             f"steps)")
    diff = trajectory_diff(a.metrics_history, b.metrics_history,
                           keys=("loss", "grad_norm"))
    if b.restarts != 1 or diff:
        fail(f"crash-and-restore trajectory: {b.restarts} restarts, {diff}")
    bad = [i for i, (x, y) in enumerate(zip(tree_leaves(a.state),
                                            tree_leaves(b.state)))
           if not torch.equal(x, y)]
    if bad:
        fail(f"crash-and-restore: final state differs at leaves {bad}")
    split = b.restore_splits[0]
    nbytes = tree_bytes(b.state)
    say(f"[train] (d) {cfg.name} at full width cut to {cfg.num_layers} "
        f"layers ({nbytes} B of train state, {b.ckpt_saves} saves), "
        f"deterministic algorithms: {steps} steps uninterrupted vs a "
        f"NodeFailure at step {fail_at} restored from step {split['step']} "
        f"under '{split['policy']}': trajectory_diff empty (loss, "
        f"grad_norm), final states equal bit for bit; launches {counts} over "
        f"{taken} steps; restore split load {split['load_s']:.2f} s / reshard "
        f"{split['reshard_s']:.2f} s / h2d {split['h2d_s']:.2f} s "
        f"({nbytes / split['h2d_s'] / 1e9:.3f} GB/s); checkpoint stall "
        f"{b.ckpt_stall_s * 1e3:.2f} ms over {b.ckpt_saves} saves; "
        f"{pinned_report(get_session())}; {wall:.2f} s")
    get_session().clear()
    del a, b
    release_host_cache()
    return counts


def train_phase(device, kernels: dict) -> dict:
    """Phase 15: parts (a)-(f) at the shapes the constants name; returns
    the launch counts of (c), (d), (e) and each of (f)'s runs.
    Checkpoints go under build/ (ignored by git) and are removed."""
    import dataclasses
    import shutil
    from repro_torch.models import registry

    cfg = registry.get("llama3.2-1b").cfg
    mamba = registry.get("mamba2-1.3b").cfg
    t0 = time.perf_counter()
    train_kernel_grads(device, TRAIN_NORM_ROWS, cfg.d_model,
                                  TRAIN_BATCH, cfg.num_heads,
                                  cfg.num_kv_heads, TRAIN_SEQ,
                                  cfg.resolved_head_dim)
    train_ssd_grads(device, 2, FAMILY_SEQ, mamba.ssm_heads,
                    mamba.ssm_head_dim, mamba.ssm_state, mamba.ssm_chunk)
    f32 = dataclasses.replace(cfg, num_layers=TRAIN_CHECK_LAYERS,
                              param_dtype="float32",
                              compute_dtype="float32")
    train_card_vs_cpu(device, f32, TRAIN_CHECK_BATCH, TRAIN_SEQ)
    root = ROOT / "build" / "phase15_checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    try:
        full = train_full(device, kernels, cfg, TRAIN_BATCH, TRAIN_SEQ,
                          TRAIN_STEPS, root, TRAIN_STATE_LEDGERS,
                          OFFLOAD_LEDGER)
        cut = dataclasses.replace(cfg, num_layers=RESTART_LAYERS)
        restart = train_restart(device, kernels, cut, TRAIN_BATCH, TRAIN_SEQ,
                                RESTART_STEPS, RESTART_EVERY, RESTART_FAIL,
                                root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"train": full["counts"], "serve-cli": full["serve-cli"],
           "train-restart": restart}
    for arch, layers, steps in FAMILY_RUNS:
        fcfg = registry.get(arch).cfg
        if layers is not None:
            fcfg = dataclasses.replace(fcfg, num_layers=layers)
        out[f"train-{arch.split('-')[0]}"] = train_family(
            device, kernels, fcfg, FAMILY_BATCH, FAMILY_SEQ, steps)
    for arch, _, _ in FAMILY_RUNS:
        layers, seq = FAMILY_CHECK[arch]
        f32 = dataclasses.replace(registry.get(arch).cfg, num_layers=layers,
                                  param_dtype="float32",
                                  compute_dtype="float32")
        train_card_vs_cpu(device, f32, TRAIN_CHECK_BATCH, seq, part="f")
    say(f"[train] phase 15 ok in {time.perf_counter() - t0:.2f} s")
    return out


# -- phase 18 ----------------------------------------------------------------

def sharded_mesh():
    """The phase's mesh and the visible card count: SHARD_K positions,
    position i on cuda:(i mod count)."""
    import torch

    count = torch.cuda.device_count()
    return tuple(torch.device("cuda", i % count)
                 for i in range(SHARD_K)), count


def shard_copy_rates(mesh, sources) -> str:
    """Each position's H2D rate: its copies (``sources[s]``, host tensors)
    timed alone between CUDA events on its device's copy stream (a pass
    queues every position's copies back to back, so its wall does not
    split by position).  Not measured on the CPU."""
    import torch
    from repro_torch._device import copy_stream

    if mesh[0].type != "cuda":
        return "not measured (CPU mesh)"
    out = []
    for s, dev in enumerate(mesh):
        dsts = [torch.empty(t.shape, dtype=t.dtype, device=dev)
                for t in sources[s]]
        stream = copy_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            for dst, src in zip(dsts, sources[s]):
                dst.copy_(src, non_blocking=True)
            end.record(stream)
        end.synchronize()
        nbytes = sum(t.numel() * t.element_size() for t in sources[s])
        ms = start.elapsed_time(end)
        out.append(f"{s}: {nbytes} B in {ms:.3f} ms = "
                   f"{nbytes / ms / 1e6:.2f} GB/s")
        del dsts
    return "; ".join(out)


def _per_position(ledger_dict) -> dict:
    return {d: (ledger_dict["h2d_bytes_by_device"][d],
                ledger_dict["h2d_calls_by_device"].get(d, 0))
            for d in ledger_dict["h2d_bytes_by_device"]}


def sharded_algorithm2(mesh, n: int) -> None:
    """Parts (b) and (f): Algorithm 2 on the sharded and sharded_delta trees
    at ``n`` under every @dpK spec on ``mesh``: line 7 ok, every position's
    ledger its closed form (SHARD_CLOSED at n = SHARD_N; the families'
    closed forms at any n), then each position's H2D rate.  (f): the
    sharded_delta tree's cold passes once more under ``sanitize()``: no
    finding."""
    from repro_torch.analysis.sanitizer import sanitize
    from repro_torch.core import declare, extract, get_session
    from repro_torch.core.sharded import host_pieces
    from repro_torch.scenarios import (run_scenario, sharded_case,
                                       sharded_delta_case)

    k = len(mesh)
    for case in (sharded_case, sharded_delta_case):
        sc = case(n, k)
        t0 = time.perf_counter()
        tree = sc.build()
        say(f"[sharded] (b) {sc.name}: built in "
            f"{time.perf_counter() - t0:.2f} s")
        rows = [[p.tensor for p in host_pieces(leaf, k)]
                for leaf in extract(tree, declare(tree, *sc.used_paths))]
        for sanitized in (False, True) if sc.family == "sharded_delta" \
                else (False,):
            for spec in SHARD_SPECS:
                motion = sc.expected[spec.split("@")[0].replace(
                    "marshal+delta", "marshal_delta")]
                want = {str(s): motion.per_device_tuple() for s in range(k)}
                if n == SHARD_N:
                    kind = "marshal" if spec.startswith("marshal") \
                        else "per_leaf"
                    if motion.per_device_tuple() != \
                            SHARD_CLOSED[sc.family][kind]:
                        fail(f"{sc.name}/{spec}: the family's closed form "
                             f"{motion} is not this phase's")
                scheme = sc.scheme_for(spec, device=mesh)
                if sanitized:
                    with sanitize() as san:
                        m = run_scenario(sc, scheme=scheme, tree=tree)
                else:
                    m = run_scenario(sc, scheme=scheme, tree=tree)
                if not (m.ok and m.motion_ok and m.per_device == want):
                    fail(f"{sc.name}/{spec}: ok={m.ok} motion_ok="
                         f"{m.motion_ok} per position {m.per_device}, "
                         f"closed form {want}")
                if sanitized:
                    say(f"[sharded] (f) {sc.name}/{spec} under the "
                        f"sanitizer: line-7 ok, per position == closed "
                        f"form, no finding; wall {m.wall_us / 1e3:.2f} ms;"
                        f" events {_events(san)}")
                    continue
                if spec.startswith("marshal"):
                    views = scheme._entry.shard_views()
                    sources = [[v[s] for v in views.values()]
                               for s in range(k)]
                else:
                    sources = [[r[s] for r in rows] for s in range(k)]
                say(f"[sharded] (b) {sc.name}/{spec}: line-7 ok, per "
                    f"position {m.per_device} == closed form; Alg-2 wall "
                    f"{m.wall_us / 1e3:.2f} ms (enqueue "
                    f"{m.enqueue_us / 1e3:.2f} + sync "
                    f"{m.sync_us / 1e3:.2f}); H2D per position: "
                    f"{shard_copy_rates(mesh, sources)}")
                del scheme
        del tree, rows
        get_session().clear()
        release_host_cache()


def sharded_steady(mesh, n: int) -> None:
    """Part (c): SHARD_PASSES marshal+delta@dpK passes on the sharded_delta
    tree after mutating hot.a and hot.b: exactly the trailing shards of the
    f32 bucket ship (SHARD_STEADY at n = SHARD_N), one copy each; every
    position keeps h2d + skipped == the full sharded motion; the values
    equal the host tree."""
    from repro_torch.core import get_session
    from repro_torch.scenarios import run_steady_scenario, sharded_delta_case

    sc = sharded_delta_case(n, len(mesh))
    want = {str(s): (b, c) for s, (b, c) in enumerate(
        sc.steady_expected.by_shard) if c}
    if n == SHARD_N and want != SHARD_STEADY:
        fail(f"{sc.name}: the family's steady closed form {want} is not "
             f"this phase's {SHARD_STEADY}")
    for i, m in enumerate(run_steady_scenario(sc, passes=SHARD_PASSES,
                                              device=mesh)):
        if not (m.ok and m.motion_ok
                and {d: b for d, b in m.h2d_by_device.items()}
                == {d: b for d, (b, _) in want.items()}):
            fail(f"{sc.name} steady pass {i}: {m}")
        say(f"[sharded] (c) {sc.name} pass {i}: moved {m.h2d_by_device} B "
            f"in {m.h2d_calls} copies (one a shard), skipped "
            f"{m.skipped_by_device} B; h2d + skipped == full on every "
            f"position; values == host; wall {m.wall_us / 1e3:.2f} ms = "
            f"{m.h2d_bytes / m.wall_us / 1e3:.2f} GB/s H2D")
    get_session().clear()
    release_host_cache()


def sharded_policy(mesh, n: int) -> None:
    """Part (d): mixed_policy and elastic at ``n`` on the mesh through
    run_policy_scenario, SHARD_PASSES passes under each executor: every
    region's per-position ledger equal to the family's closed form (cold,
    then steady), one barrier a pass, and policy_cost's per-position
    prediction equal to the same ledgers."""
    from repro_torch.analysis.cost import policy_cost
    from repro_torch.core import TransferSession
    from repro_torch.scenarios import (elastic_case, mixed_policy_case,
                                       run_policy_scenario)

    k = len(mesh)

    def positions(motion) -> dict:
        if motion.per_device_tuple() is not None:
            return {str(s): motion.per_device_tuple() for s in range(k)}
        return {"0": motion.as_tuple()} if motion.h2d_calls else {}

    for case in (mixed_policy_case, elastic_case):
        sc = case(n, k)
        t0 = time.perf_counter()
        tree = sc.build()
        cost = policy_cost(tree, sc.policy(), sc.steady_mutate_paths())
        say(f"[sharded] (d) {sc.name}: {sc.declared_policy}; built in "
            f"{time.perf_counter() - t0:.2f} s")
        for executor in ("blocking", "async"):
            session = TransferSession()
            ms = run_policy_scenario(sc, tree=tree, passes=SHARD_PASSES,
                                     executor=executor, session=session,
                                     device=mesh)
            for i, m in enumerate(ms):
                closed = sc.region_expected if i == 0 \
                    else sc.steady_region_expected
                got = {key: _per_position(r) for key, r in m.regions.items()}
                want = {key: positions(v) for key, v in closed.items()}
                priced = {rc.key: positions(rc.cold if i == 0 else rc.steady)
                          for rc in cost.regions}
                if not (m.ok and m.motion_ok and m.syncs == 1
                        and got == want == priced):
                    fail(f"{sc.name} {executor} pass {i}: ok={m.ok} "
                         f"motion_ok={m.motion_ok} syncs={m.syncs} per "
                         f"position {got}, closed forms {want}, priced "
                         f"{priced}")
                say(f"[sharded] (d) {sc.name} {executor} pass {i}: per "
                    f"position {got} == closed forms == policy_cost, one "
                    f"barrier, values == host; wall {m.wall_us / 1e3:.2f} ms"
                    f" = {m.h2d_bytes / m.wall_us / 1e3:.2f} GB/s H2D; sync "
                    f"{m.sync_us / 1e3:.3f} ms, finish "
                    f"{m.finish_us / 1e3:.3f} ms")
            session.clear()
            release_host_cache()
        del tree
        release_host_cache()


def sharded_registry(device, count: int) -> int:
    """Part (e): the registry's ``full`` sharded and sharded_delta families
    at the live card count, under every spec they declare."""
    from repro_torch.scenarios import iter_scenarios, run_scenario

    cells = 0
    for sc in iter_scenarios("full", only=["sharded", "sharded_delta"],
                             devices=count):
        tree = sc.build()
        sc.validate(tree)
        for spec in sc.specs():
            m = run_scenario(sc, spec, tree=tree, device=device)
            if not (m.ok and m.motion_ok):
                fail(f"{sc.name}/{spec}: ok={m.ok} ledger "
                     f"{(m.h2d_bytes, m.h2d_calls)} per device "
                     f"{m.per_device}, expected {m.expected}")
            cells += 1
        say(f"[sharded] (e) {sc.name}: " + ", ".join(
            f"{s} ok" for s in sc.specs()))
    return cells


def sharded_phase(kernels: dict, smi: str) -> dict:
    """Phase 18: the sharded deep copy on a SHARD_K-position mesh; no kernel
    may launch.  Returns the launch counts of its run (all 0)."""
    mesh, count = sharded_mesh()
    say(f"[sharded] {smi}; mesh {[str(d) for d in mesh]} over {count} "
        f"visible card(s)" + (": every position on one card, which is not "
                              "multi-GPU" if count == 1 else ""))
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    sharded_algorithm2(mesh, SHARD_N)
    sharded_steady(mesh, SHARD_N)
    sharded_policy(mesh, SHARD_POLICY_N)
    cells = sharded_registry(None, count)
    launched = {name: k.launches for name, k in kernels.items()}
    if any(launched.values()):
        fail(f"the sharded phase launched {launched}; it runs no kernel")
    say(f"[sharded] phase 18 ok in {time.perf_counter() - t0:.2f} s ((e): "
        f"{cells} cells), no kernel launched")
    return launched


# -- phase 19: data parallelism on four positions -----------------------------

def _dp_mesh(shape):
    """A named mesh of ``shape`` over phase 18's positions (on one card
    every position sits on cuda:0)."""
    from repro_torch.launch.mesh import make_debug_mesh

    return make_debug_mesh(*shape, device=sharded_mesh()[0])


def _replicas_equal(state, k: int, what: str) -> None:
    import torch
    from repro_torch.core import tree_leaves
    from repro_torch.core.sharded import replica

    for i, leaf in enumerate(tree_leaves(state)):
        first = replica(leaf, 0)
        for p in range(1, k):
            if not torch.equal(first, replica(leaf, p)):
                fail(f"{what}: position {p}'s copy of leaf {i} differs "
                     f"from position 0's")


def _collective_device_ms(prof, steps: int = 1) -> dict:
    """Device time (ms) of the kernels and copies each ``collective.*``
    range launched, and of every device op, from a profile."""
    out, total = {}, 0.0
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = e.cuda_time_total
        self_dev = getattr(e, "self_device_time_total", None)
        if self_dev is None:
            self_dev = e.self_cuda_time_total
        total += self_dev
        if e.key.startswith("collective."):
            out[e.key[len("collective."):]] = dev / 1e3 / steps
    return {"collectives": out, "device_ms": total / 1e3 / steps}


def dp_step_phase(kernels: dict, smi: str) -> dict:
    """Part (a): llama3.2-1b at full width cut to DP_LAYERS layers, bf16,
    AdamW, dp DP_K on the mesh's positions, under deterministic
    algorithms (so separate runs compute the same local gradients).

    First the gradient collective on batch 0.  The identity "the sum of
    the K slices' gradients == K x the dp-1 gradient over the whole
    batch" (each slice's mean is over equal tokens) is held in float32 at
    full width cut to TRAIN_CHECK_LAYERS layers, within DP_GRAD_TOL of
    each leaf's largest element: deeper, this randomly initialised model
    amplifies the rounding of products of different row counts until the
    two sides part (PERF.md, PR 24).  On the step's own bf16 state,
    replicated: arena's synced gradients bit-equal to pertensor's, and the
    synced gradient within BF16_TOL of the float32 sum of the positions'
    local gradients; its distance to K x a bf16 dp-1 gradient is printed.

    Then DP_STEPS steps under each scheme from the seeded state: every
    position's state equal bit for bit after every step, collective calls
    and kernel launches exact, arena's losses equal to pertensor's and
    int8's within the reference test's 0.1 of them (equal at the first
    step).  The last step of each scheme runs under torch.profiler.
    Returns the launch counts of the three runs."""
    import dataclasses
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import train

    cfg = dataclasses.replace(registry.get("llama3.2-1b").cfg,
                              num_layers=DP_LAYERS)
    api = registry.get_model(cfg)
    opt = make_optimizer("adamw")
    mesh = _dp_mesh((DP_K, 1))
    dev = mesh.positions[0]
    data = SyntheticLM(cfg.vocab_size, DP_SEQ, DP_BATCH)

    def fresh():
        return train.train_state(api, opt, torch.Generator(
            device=dev).manual_seed(0), device=dev)

    torch.use_deterministic_algorithms(True)
    try:
        return _dp_runs(kernels, smi, cfg, api, opt, mesh, data, fresh)
    finally:
        torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def _collective_spans(spans: dict, cuda: bool):
    """Within the block, each collective of repro_torch.core.collectives
    is bracketed by CUDA events on the current stream; on leaving, the
    spans (ms, first event to last, so a host-side gap counts too) are
    summed into ``spans`` by kind.  Nothing is timed without a card."""
    import torch
    from repro_torch.core import collectives as C

    if not cuda:
        yield
        return
    marks, real = [], {k: getattr(C, k) for k in C.KINDS}

    def bracket(kind, fn):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            marks.append((kind, start, end))
            return out
        return timed

    for kind, fn in real.items():
        setattr(C, kind, bracket(kind, fn))
    try:
        yield
    finally:
        for kind, fn in real.items():
            setattr(C, kind, fn)
    torch.cuda.synchronize()
    for kind, start, end in marks:
        spans[kind] = spans.get(kind, 0.0) + start.elapsed_time(end)


def _leaf_rel(got, want) -> list:
    """Per leaf: max |got - want| over the leaf's largest |want|."""
    out = []
    for a, b in zip(got, want):
        top = float(b.float().abs().max())
        out.append(float((a.float() - b.float()).abs().max())
                   / max(top, 1e-30))
    return out


def _slice_identity(mesh, cfg, batch, slices) -> list:
    """Float32 at full width cut to TRAIN_CHECK_LAYERS layers: the
    positions' slice gradients summed by the pertensor collective against
    K x the dp-1 gradient over the whole batch, per leaf (max |diff| over
    the leaf's largest)."""
    import dataclasses
    import torch
    from repro_torch.core import tree_leaves
    from repro_torch.models import registry
    from repro_torch.runtime import train

    api = registry.get_model(dataclasses.replace(
        cfg, num_layers=TRAIN_CHECK_LAYERS, param_dtype="float32",
        compute_dtype="float32"))
    dev = mesh.positions[0]
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    grads = [train.value_and_grad(api.loss_fn, st["params"], b)[2]
             for st, b in zip(train.per_position({"params": params}, mesh),
                              slices)]
    synced = train.sync_gradients(grads, [{}] * mesh.size, mesh,
                                  "pertensor", False)[0]
    g1 = train.value_and_grad(api.loss_fn, params, batch)[2]
    return _leaf_rel(tree_leaves(synced[0]),
                     [mesh.size * g for g in tree_leaves(g1)])


def _dp_runs(kernels, smi, cfg, api, opt, mesh, data, fresh) -> dict:
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch._device import synchronize
    from repro_torch.core import collectives as C
    from repro_torch.core import leaf_paths, tree_leaves
    from repro_torch.models import lm
    from repro_torch.optim import constant
    from repro_torch.runtime import train

    dev = mesh.positions[0]
    batch = data.batch(0)
    whole = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    slices = train._split_batch(batch, mesh)
    none = [{} for _ in range(mesh.size)]
    names = [str(p) for p in leaf_paths(api.abstract())]
    worst = lambda rel: max(zip(rel, names))
    t0 = time.perf_counter()
    f32_rel = _slice_identity(mesh, cfg, whole, slices)
    bad = [(names[i], r) for i, r in enumerate(f32_rel) if r > DP_GRAD_TOL]
    if bad:
        fail(f"dp: float32 slice gradients summed vs {DP_K} x the dp-1 "
             f"gradient past {DP_GRAD_TOL} of the leaf's largest: {bad}")
    release_host_cache()
    state = train.replicate_state(fresh(), mesh.size, device=mesh.positions)
    states = train.per_position(state, mesh)
    grads = [train.value_and_grad(api.loss_fn, st["params"], b)[2]
             for st, b in zip(states, slices)]
    local = [sum(g.float() for g in leaves)
             for leaves in zip(*[tree_leaves(g) for g in grads])]
    pert = train.sync_gradients(list(grads), none, mesh, "pertensor",
                                False)[0]
    arena = train.sync_gradients(list(grads), none, mesh, "arena", False)[0]
    del grads
    for p in range(mesh.size):
        for i, (a, b) in enumerate(zip(tree_leaves(pert[p]),
                                       tree_leaves(arena[p]))):
            if not torch.equal(a, b):
                fail(f"dp: arena's synced gradient leaf {i} on position {p} "
                     f"!= pertensor's")
    del arena
    sum_rel = _leaf_rel(tree_leaves(pert[0]), local)
    bad = [(names[i], r) for i, r in enumerate(sum_rel) if r > BF16_TOL]
    if bad:
        fail(f"dp: the bf16 synced gradient vs the float32 sum of the local "
             f"gradients past {BF16_TOL} of the leaf's largest: {bad}")
    del local
    bf1 = [DP_K * g.float() for g in tree_leaves(
        train.value_and_grad(api.loss_fn, states[0]["params"], whole)[2])]
    bb_rel = _leaf_rel(tree_leaves(pert[0]), bf1)
    say(f"[dp] (a) {smi}; {cfg.name} at full width cut to {DP_LAYERS} "
        f"layers, bf16, AdamW, dp {DP_K} on {[str(d) for d in mesh.positions]}"
        f" (four positions on one card: not multi-GPU), batch {DP_BATCH} x "
        f"{DP_SEQ}; of each leaf's largest: the {DP_K} float32 slice "
        f"gradients summed vs {DP_K} x the dp-1 gradient at "
        f"{TRAIN_CHECK_LAYERS} layers worst {worst(f32_rel)} (held to "
        f"{DP_GRAD_TOL}); the bf16 synced gradient vs the float32 sum of the "
        f"local ones worst {worst(sum_rel)} (held to {BF16_TOL}), vs {DP_K} x "
        f"a bf16 dp-1 gradient at {DP_LAYERS} layers worst {worst(bb_rel)} "
        f"(recorded); arena's synced gradients == pertensor's bit for bit "
        f"on every position ({time.perf_counter() - t0:.2f} s)")
    del pert, bf1, states, state, whole
    release_host_cache()

    n_leaves = len(tree_leaves(api.abstract()))
    per_step = lm.kernel_launches(cfg, train_steps=DP_STEPS)
    out, losses = {}, {}
    for scheme, compress in (("pertensor", False), ("arena", False),
                             ("arena", True)):
        tag = scheme + ("+int8" if compress else "")
        t_run = time.perf_counter()
        step = train.make_dp_train_step(api, opt, constant(TRAIN_LR), mesh,
                                        grad_scheme=scheme,
                                        compress=compress)
        # the step gets the only references to the state and the error
        # state, so it frees each position's old copy once it is updated
        box = {"state": train.replicate_state(fresh(), mesh.size,
                                              device=mesh.positions),
               "err": train.init_error_state(api, compress, mesh)}

        def one_step(s):
            box["state"], met, box["err"] = step(
                box.pop("state"), data.batch(s), box.pop("err"))
            return float(met["loss"])

        synchronize(dev)
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        for k in kernels.values():
            k.launches = 0
        C.STATS.reset()
        walls, prof, spans = [], None, {}
        for s in range(DP_STEPS):
            t0 = time.perf_counter()
            if s < DP_STEPS - 1:
                loss = one_step(s)
            elif scheme == "arena" and not compress:
                # the one profiled step (reading a profile takes ~12 s)
                with _collective_spans(spans, cuda), profile(
                        activities=[ProfilerActivity.CPU] + (
                            [ProfilerActivity.CUDA] if cuda else [])
                ) as prof:
                    loss = one_step(s)
            else:
                with _collective_spans(spans, cuda):
                    loss = one_step(s)
            walls.append(time.perf_counter() - t0)
            losses.setdefault(tag, []).append(loss)
            _replicas_equal(box["state"], mesh.size, f"dp {tag} step {s}")
        counts = {name: k.launches for name, k in kernels.items()}
        calls = C.STATS.snapshot()
        want = {"gather_tiles": 0, **{k: DP_K * v
                                      for k, v in per_step.items()}}
        if counts != want:
            fail(f"dp {tag}: launched {counts}, expected {want} ({DP_K} "
                 f"positions x {DP_STEPS} steps)")
        if scheme == "pertensor":
            want_calls = {"psum": n_leaves * DP_STEPS, "pmean": DP_STEPS}
        elif not compress:
            want_calls = {"psum_scatter": DP_STEPS, "all_gather": DP_STEPS,
                          "pmean": DP_STEPS}
        else:
            want_calls = {"pmax": DP_STEPS, "psum": DP_STEPS,
                          "pmean": DP_STEPS}
        if calls != want_calls:
            fail(f"dp {tag}: collectives {calls}, expected {want_calls}")
        if not all(abs(v) < float("inf") for v in losses[tag]):
            fail(f"dp {tag}: losses {losses[tag]}")
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        span = "; ".join(f"{k} {v:.3f} ms" for k, v in sorted(
            spans.items())) or "not measured (no card)"
        profiled = ""
        if prof is not None:
            profd = _collective_device_ms(prof)
            coll = "; ".join(f"{k} {v:.3f} ms" for k, v in
                             sorted(profd["collectives"].items()))
            profiled = (f"; under torch.profiler: device "
                        f"{profd['device_ms']:.2f} ms, the collectives' "
                        f"kernels and copies {coll or 'not measured'}")
        a_step = {k: v // DP_STEPS for k, v in calls.items()}
        say(f"[dp] (a) {tag}: losses {losses[tag]}; step walls "
            f"{[round(w * 1e3, 2) for w in walls]} ms (the last with CUDA "
            f"events around each collective{', and profiled' if prof else ''}"
            f"; median of the others "
            f"{statistics.median(walls[:-1]) * 1e3:.2f} ms); peak "
            f"{peak / 1e9:.2f} GB; collectives a step {a_step}, "
            f"{sum(C.STATS.bytes.values()) // DP_STEPS} B of operands a "
            f"position; the last step's collectives from first to last "
            f"event, summed by kind: {span}{profiled}; launches {counts} == "
            f"{DP_K} x kernel_launches; {time.perf_counter() - t_run:.2f} s")
        out[tag] = counts
        del box, step, prof
    if losses["arena+int8"][0] != losses["pertensor"][0] or any(
            abs(a - b) >= DP_INT8_LOSS_TOL for a, b in zip(
                losses["arena+int8"], losses["pertensor"])):
        fail(f"dp: int8 losses {losses['arena+int8']} vs pertensor "
             f"{losses['pertensor']}")
    if losses["arena"] != losses["pertensor"]:
        fail(f"dp: arena losses {losses['arena']} != pertensor "
             f"{losses['pertensor']}")
    return {k: sum(c[k] for c in out.values()) for k in kernels}


def moe_sharded_phase(kernels: dict) -> None:
    """Part (b): one moonshot-v1-16b-a3b MoE layer at full width (seeded
    bf16 weights on the card) through apply_moe_sharded on meshes (4, 1)
    and (2, 2) of the positions, x (MOE_BATCH, MOE_SEQ, d): each ep slice
    within BF16_TOL of the plain layer on that slice (same routing and
    capacity), and the tokens no path dropped a choice of within BF16_TOL
    of the plain layer over the whole batch; no kernel launched."""
    import torch
    from repro_torch._device import synchronize
    from repro_torch.models import moe, registry

    cfg = registry.get("moonshot-v1-16b-a3b").cfg
    mesh0 = _dp_mesh((DP_K, 1))
    dev = mesh0.positions[0]
    gen = torch.Generator(device=dev).manual_seed(19)
    p = {k: (torch.randn(s.shape, generator=gen, device=dev) * 0.02)
         .to(torch.bfloat16) for k, s in moe.moe_specs(cfg).items()}
    x = torch.randn(MOE_BATCH, MOE_SEQ, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    nbytes = sum(t.numel() * t.element_size() for t in p.values())
    N = MOE_BATCH * MOE_SEQ
    K = cfg.experts_per_token

    def routed(xs, C):
        """Each token's K expert ids and whether it kept every choice."""
        ids, pos = moe._route_and_rank(cfg, p["router"],
                                       xs.reshape(-1, cfg.d_model))[:2]
        return ids.view(-1, K), (pos < C).view(-1, K).all(dim=1)

    for k in kernels.values():
        k.launches = 0
    plain, plain_aux = moe.apply_moe(cfg, p, x)
    ids_global, keep_global = routed(x, moe.capacity(cfg, N))
    for shape in ((4, 1), (2, 2)):
        mesh = _dp_mesh(shape)
        n_ep = shape[0]
        synchronize(dev)
        t0 = time.perf_counter()
        out, aux = moe.apply_moe_sharded(cfg, p, x, mesh, ("data",),
                                         ("model",))
        synchronize(dev)
        wall = time.perf_counter() - t0
        rows = MOE_BATCH // n_ep
        C_l = moe.capacity(cfg, rows * MOE_SEQ)
        err = 0.0
        keep = keep_global.clone()
        same = torch.ones_like(keep)
        for e in range(n_ep):
            xs = x[e * rows:(e + 1) * rows]
            err = max(err, _close(out[e * rows:(e + 1) * rows],
                                  moe.apply_moe(cfg, p, xs)[0],
                                  f"moe {shape} slice {e} vs plain"))
            ids, kept = routed(xs, C_l)
            sl = slice(e * rows * MOE_SEQ, (e + 1) * rows * MOE_SEQ)
            keep[sl] &= kept
            # the f32 router product at another row count may round a
            # near-tie the other way: such a token routes differently
            same[sl] = (ids == ids_global[sl]).all(dim=1)
        both = (keep & same).view(MOE_BATCH, MOE_SEQ)
        gerr = _close(out[both], plain[both],
                      f"moe {shape} vs the plain layer on kept tokens")
        say(f"[dp] (b) apply_moe_sharded, {cfg.name} layer at full width "
            f"({cfg.num_experts} experts, top {K}, d {cfg.d_model}, d_ff "
            f"{cfg.d_ff}; {nbytes} B of bf16 weights), x {tuple(x.shape)}, "
            f"mesh {shape} (ep {n_ep}, tp {shape[1]}; local capacity "
            f"{C_l}): each slice == the plain layer on it within {BF16_TOL} "
            f"(max |diff| {err}); {int(both.sum())} of {N} tokens kept "
            f"every choice in both paths ({N - int(keep_global.sum())} "
            f"dropped one at the global capacity {moe.capacity(cfg, N)}, "
            f"{N - int(keep.sum())} at either, {N - int(same.sum())} routed "
            f"otherwise), "
            f"those == the plain layer within {BF16_TOL} (max |diff| "
            f"{gerr}); aux {float(aux['moe_aux_loss']):.6f} (the pmean of "
            f"the local losses) vs the global "
            f"{float(plain_aux['moe_aux_loss']):.6f}; wall "
            f"{wall * 1e3:.2f} ms")
    launched = {name: k.launches for name, k in kernels.items()}
    if any(launched.values()):
        fail(f"the MoE layer launched {launched}; it runs no kernel")
    del p, x, plain
    release_host_cache()


def elastic_phase(kernels: dict, root: Path) -> dict:
    """Part (c): run_elastic n -> m over the positions for each of
    ELASTIC_EPISODES, with make_train_step on llama3.2-1b at full width cut
    to ELASTIC_LAYERS layers (bf16, AdamW, SyntheticLM(vocab, 32, 4)),
    deterministic algorithms: trajectory_diff against the uninterrupted
    run empty, one policy re-derivation, and the last checkpoint restored
    through the survivor's policy and replicated onto m positions equal to
    it bit for bit on each; launches exact.  Returns the counts."""
    import dataclasses
    import torch
    from repro_torch.checkpoint import load
    from repro_torch.core import TransferSession, tree_bytes, tree_leaves
    from repro_torch.core.sharded import replica
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm, registry
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.runtime import (loop, run_elastic, train,
                                     trajectory_diff)

    cfg = dataclasses.replace(registry.get("llama3.2-1b").cfg,
                              num_layers=ELASTIC_LAYERS)
    api = registry.get_model(cfg)
    opt = make_optimizer("adamw")
    step = train.make_train_step(api, opt, constant(TRAIN_LR))
    data = SyntheticLM(cfg.vocab_size, ELASTIC_SEQ, ELASTIC_BATCH)
    positions = sharded_mesh()[0]
    dev = positions[0]
    init = lambda: train.train_state(api, opt, torch.Generator(
        device=dev).manual_seed(11), device=dev)
    for k in kernels.values():
        k.launches = 0
    taken = ELASTIC_STEPS
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        ref = loop.run(step, init, data.batch, ELASTIC_STEPS,
                       device=positions)
        say(f"[dp] (c) the uninterrupted run: {ELASTIC_STEPS} steps in "
            f"{time.perf_counter() - t0:.2f} s")
        for n, m in ELASTIC_EPISODES:
            ckpt = root / f"elastic_{n}_{m}"
            t0 = time.perf_counter()
            res = run_elastic(step, init, data.batch, ELASTIC_STEPS,
                              ckpt_dir=str(ckpt), crash_step=ELASTIC_CRASH,
                              n_devices=n, m_devices=m,
                              ckpt_every=ELASTIC_EVERY, device=positions)
            wall = time.perf_counter() - t0
            taken += ELASTIC_CRASH + m * (ELASTIC_STEPS - res.restored_step)
            diff = trajectory_diff(ref.metrics_history,
                                   res.result.metrics_history)
            if diff or res.result.policy_reshards != 1:
                fail(f"elastic {n} -> {m}: trajectory {diff}, "
                     f"{res.result.policy_reshards} policy re-derivations")
            _replicas_equal(res.result.state, m, f"elastic {n} -> {m}")
            split = res.restore_split
            t1 = time.perf_counter()
            host = load(str(ckpt))
            program = TransferSession().compile(host, split["policy"],
                                                device=positions)
            placed = train.replicate_state(program.to_device(host), m,
                                           device=positions)
            for i, (a, b) in enumerate(zip(tree_leaves(placed),
                                           tree_leaves(host))):
                b = b.to(dev)
                for p in range(m):
                    if not torch.equal(replica(a, p), b.to(
                            replica(a, p).device)):
                        fail(f"elastic {n} -> {m}: position {p}'s restored "
                             f"leaf {i} != the checkpoint")
            nbytes = tree_bytes(host)
            say(f"[dp] (c) run_elastic {n} -> {m} on "
                f"{[str(d) for d in positions[:max(n, m)]]}, {cfg.name} at "
                f"full width cut to {ELASTIC_LAYERS} layers ({nbytes} B of "
                f"train state a copy), {ELASTIC_STEPS} steps, crash at "
                f"{ELASTIC_CRASH}, a checkpoint every {ELASTIC_EVERY}: "
                f"trajectory_diff empty, {res.result.policy_reshards} policy "
                f"re-derivation to '{split['policy']}', the checkpoint "
                f"restored and replicated onto {m} positions == it bit for "
                f"bit on each; restore split load {split['load_s']:.2f} s / "
                f"reshard {split['reshard_s']:.2f} s / h2d + replication "
                f"{split['h2d_s']:.2f} s; checkpoint stall "
                f"{res.result.ckpt_stall_s * 1e3:.2f} ms over "
                f"{res.result.ckpt_saves} saves; episode {wall:.2f} s, "
                f"the restore check {time.perf_counter() - t1:.2f} s")
            del res, host, program, placed
    finally:
        torch.use_deterministic_algorithms(False)
    counts = {name: k.launches for name, k in kernels.items()}
    want = {"gather_tiles": 0, **lm.kernel_launches(cfg, train_steps=taken)}
    if counts != want:
        fail(f"elastic runs launched {counts}, expected {want} ({taken} "
             f"position-steps)")
    del ref
    release_host_cache()
    return counts


def dp_phase(kernels: dict, smi: str) -> dict:
    """Phase 19: (a) the dp step, (b) expert-parallel MoE, (c) elastic
    restarts n -> m, on the positions of phase 18's mesh.  Returns the
    launch counts of (a) and (c) summed."""
    import shutil

    t0 = time.perf_counter()
    root = ROOT / "build" / "phase19_checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    try:
        dp = dp_step_phase(kernels, smi)
        t1 = time.perf_counter()
        moe_sharded_phase(kernels)
        t2 = time.perf_counter()
        elastic = elastic_phase(kernels, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t3 = time.perf_counter()
    say(f"[dp] phase 19 ok in {t3 - t0:.2f} s ((a) {t1 - t0:.2f} s, (b) "
        f"{t2 - t1:.2f} s, (c) {t3 - t2:.2f} s)")
    return {k: dp[k] + elastic[k] for k in dp}


# -- phase 20: the launch tooling on four positions ---------------------------

def _model_replicas_equal(state, mesh, what: str) -> None:
    """Positions that differ only on ``model`` hold bit-equal blocks of
    every leaf whose spec does not name ``model``."""
    import torch
    from repro_torch.core import tree_leaves
    from repro_torch.core.placement import entry_axes

    for i, leaf in enumerate(tree_leaves(state)):
        if any("model" in entry_axes(e) for e in leaf.placement.spec):
            continue
        for group in mesh.groups("model"):
            for p in group[1:]:
                if not torch.equal(leaf.blocks[p], leaf.blocks[group[0]]):
                    fail(f"{what}: leaf {i}'s block on position {p} differs "
                         f"from position {group[0]}'s (model replicas)")


def _blocks_equal_whole(state, what: str, host=None) -> None:
    """Every block equals its block of the whole leaf, bit for bit: the
    leaf gathered on the card, or ``host``'s leaf moved there."""
    import torch
    from repro_torch.core import tree_leaves

    hosts = tree_leaves(host) if host is not None else None
    for i, leaf in enumerate(tree_leaves(state)):
        dev = leaf.blocks[0].device
        whole = leaf.gather(dev) if hosts is None else hosts[i].to(dev)
        for p, block in enumerate(leaf.blocks):
            if not torch.equal(block, whole[leaf.placement.index(
                    p, leaf.shape)]):
                fail(f"{what}: leaf {i}'s block on position {p} is not its "
                     f"block of the whole leaf")
        del whole


def _predict_sharded_peak(step) -> float:
    """The sharded step's predicted peak bytes on the card, the larger of
    its two phases: the compute (the placed state, every position's
    gathered params, its blocks of the leaves the step splits over the
    model axis, ``gathered_param_bytes``, every position's gradients of
    them, and one model group's f32 logits, B/n x S x V over its members,
    with their gradient), and the update (the caller's state and the new
    one beside every position's gradients)."""
    from repro_torch.core import tree_leaves
    from repro_torch.core.placement import position_bytes
    from repro_torch.runtime import train

    api, mesh = step.api, step.mesh
    state_abs = train.abstract_train_state(api, step.optimizer)
    placed = mesh.size * position_bytes(
        [(v.shape, v.dtype, pl) for v, pl in zip(
            tree_leaves(state_abs), tree_leaves(step.shardings))])
    rows = LAUNCH_BATCH // mesh.shape["data"]
    logits = 2 * rows * LAUNCH_SEQ * api.cfg.vocab_size * 4
    gathered = mesh.size * step.gathered_param_bytes()
    return max(placed + 2 * gathered + logits, 2 * placed + gathered)


def masked_batch(batch: dict, blocks: int) -> dict:
    """``batch`` with its labels masked unevenly over ``blocks`` equal row
    blocks: block 0's all masked, the first half of block 1's (in row
    order, so whole rows of it), the others' none."""
    import numpy as np

    out = {k: np.array(v) for k, v in batch.items()}
    labels = out["labels"]
    r = labels.shape[0] // blocks
    labels[:r] = -1
    if blocks > 1:
        labels[r:2 * r].reshape(-1)[:labels[r:2 * r].size // 2] = -1
    return out


def launch_sharded_step(kernels: dict, smi: str):
    """Part (a): the production-mesh step.  First the vlm, MoE, ssm,
    hybrid and encdec runs (``_launch_family_runs``).  Then, on a (2, 2)
    mesh, the f32 check at TRAIN_CHECK_LAYERS layers (SGD-momentum, 2 steps): losses
    within LAUNCH_F32_LOSS_RTOL and every gathered leaf within DP_GRAD_TOL
    of its largest element against make_train_step on one position.  Then llama3.2-1b at LAUNCH_LAYERS layers, bf16,
    AdamW: make_train_step's LAUNCH_STEPS losses on one position, then the
    sharded step's from the same seeded state: losses within
    LAUNCH_LOSS_TOL of them, model replicas bit-equal after every step,
    launches exactly mesh.size x kernel_launches(train_steps=1) a step,
    every block equal to its block of the gathered state.  In both
    parts, apart from the run, one step from the seeded state on both
    sides on labels masked unevenly over the row blocks
    (``masked_batch``), held as the run's steps are.  All under
    deterministic algorithms: the embedding's index backward accumulates
    in a racy order otherwise, and the replicas would part by rounding.
    Returns the counts (the family runs' and llama's), llama's placed
    state, its api and the optimizer."""
    import torch
    from repro_torch._device import synchronize
    from repro_torch.runtime import train

    torch.use_deterministic_algorithms(True)
    try:
        families = _launch_family_runs(kernels, smi, synchronize, train)
        counts, state, api, opt = _launch_sharded_runs(kernels, smi,
                                                       synchronize, train)
        return ({k: counts[k] + families[k] for k in counts}, state, api,
                opt)
    finally:
        torch.use_deterministic_algorithms(False)


def _family_batch(cfg, data, i: int) -> dict:
    """``data``'s batch ``i``, with a vlm model's patch embeddings
    (LAUNCH_BATCH, frontend_tokens, d_model) or an encoder-decoder's
    frames (LAUNCH_BATCH, LAUNCH_SEQ / src_ratio, d_model) in its compute
    dtype, drawn from a generator seeded with ``i`` (the shapes
    ``ModelApi.inputs`` gives them)."""
    import torch
    from repro_torch.models.specs import torch_dtype

    batch = data.batch(i)
    rows = {"patches": cfg.frontend_tokens} if cfg.frontend == "vision" \
        else {"frames": max(1, LAUNCH_SEQ // cfg.src_ratio)} \
        if cfg.is_encdec else {}
    for key, n in rows.items():
        g = torch.Generator().manual_seed(i)
        batch[key] = torch.randn(LAUNCH_BATCH, n, cfg.d_model,
                                 generator=g).to(
                                     torch_dtype(cfg.compute_dtype))
    return batch


def _launch_family_runs(kernels: dict, smi: str, synchronize, train
                        ) -> dict:
    """Part (a)'s vlm, MoE, ssm, hybrid and encdec runs
    (LAUNCH_FAMILIES): for each, the
    sharded step must split exactly the regions listed; its predicted
    peak is printed and must stay under LAUNCH_PEAK_LIMIT; then
    make_train_step's LAUNCH_FAMILY_STEPS losses on one position, and the
    sharded step's from the same seeded state: losses within
    LAUNCH_LOSS_TOL x (1 + |loss|) of them, model replicas bit-equal
    after every step, launches exactly mesh.size x kernel_launches a
    step, every block equal to its block of the gathered state; its
    median step wall, peak, gathered params a position and one profiled
    step's device time and idle share printed.  Returns the runs' launch
    counts summed."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.optim import constant, make_optimizer

    total = {name: 0 for name in kernels}
    for arch, shape, regions in LAUNCH_FAMILIES:
        t0 = time.perf_counter()
        mesh = _dp_mesh(shape)
        dev = mesh.positions[0]
        cfg = registry.get(arch).cfg
        cfg = dataclasses.replace(
            cfg, num_layers=LAUNCH_FAMILY_LAYERS,
            enc_layers=min(cfg.enc_layers, LAUNCH_FAMILY_LAYERS))
        api = registry.get_model(cfg)
        opt = make_optimizer("adamw")
        lr = constant(LAUNCH_LR)
        step = train.make_sharded_train_step(api, opt, lr, mesh)
        split = tuple(r for r in ("heads", "mlp", "vocab", "experts", "ssm")
                      if step.tp is not None and getattr(step.tp, r))
        if set(split) != set(regions):
            fail(f"[launch] (a) {arch} on {shape}: the step splits {split} "
                 f"over the model axis, not {regions}")
        predicted = _predict_sharded_peak(step)
        gathered = step.gathered_param_bytes()
        say(f"[launch] (a) {arch}: predicted peak of the sharded step "
            f"{predicted / 1e9:.2f} GB, {gathered / 1e9:.3f} GB of params "
            f"gathered a position (its blocks of {', '.join(split)}); "
            f"limit {LAUNCH_PEAK_LIMIT / 1e9:.0f} GB; "
            + (f"{cfg.enc_layers} encoder + " if cfg.is_encdec else "")
            + f"{cfg.num_layers} layers")
        if predicted >= LAUNCH_PEAK_LIMIT:
            fail(f"[launch] (a) {arch}: predicted peak "
                 f"{predicted / 1e9:.2f} GB: cut LAUNCH_FAMILY_LAYERS")
        data = SyntheticLM(cfg.vocab_size, LAUNCH_SEQ, LAUNCH_BATCH)
        batches = [_family_batch(cfg, data, i)
                   for i in range(LAUNCH_FAMILY_STEPS)]
        fresh = lambda: train.train_state(
            api, opt, torch.Generator(device=dev).manual_seed(0),
            device=dev)
        plain = train.make_train_step(api, opt, lr)
        s, ref = fresh(), []
        for b in batches:
            s, m = plain(s, b)
            ref.append(float(m["loss"]))
        del s, plain
        torch.cuda.empty_cache()
        state = step.place(fresh())
        synchronize(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for k in kernels.values():
            k.launches = 0
        losses, walls = [], []
        for i, b in enumerate(batches):
            synchronize(dev)
            t = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t)
            _model_replicas_equal(state, mesh,
                                  f"[launch] (a) {arch} step {i}")
        counts = {name: k.launches for name, k in kernels.items()}
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        one = registry.kernel_launches(cfg, train_steps=1)
        want = {"gather_tiles": 0, **{k: LAUNCH_FAMILY_STEPS * mesh.size * v
                                      for k, v in one.items()}}
        if counts != want:
            fail(f"[launch] (a) {arch} launched {counts}, expected {want}")
        for i, (x, y) in enumerate(zip(ref, losses)):
            if not abs(x - y) <= LAUNCH_LOSS_TOL * (1 + abs(x)):
                fail(f"[launch] (a) {arch} step {i}: sharded loss {y} vs "
                     f"one position's {x}")
        _blocks_equal_whole(state, f"[launch] (a) {arch}")
        prof = profile_device_ms(dev, lambda: step(state, batches[0]),
                                 calls=1)
        extra = {k: v.shape[1] for k, v in batches[0].items()
                 if k in ("patches", "frames")}
        say(f"[launch] (a) {arch} "
            + (f"{cfg.enc_layers} encoder + " if cfg.is_encdec else "")
            + f"{cfg.num_layers} layers bf16 AdamW lr "
            f"{LAUNCH_LR}, batch {LAUNCH_BATCH} x {LAUNCH_SEQ} text tokens"
            + "".join(f" + {n} {k}" for k, n in extra.items())
            + f" on {dict(mesh.shape)}, tensor-parallel over the model "
            f"axis ({', '.join(split)}): losses {losses} vs one position's "
            f"{ref} (each within {LAUNCH_LOSS_TOL} x (1 + |loss|)); model "
            f"replicas bit-equal after every step; every block == its "
            f"block of the gathered state; launches {counts} == "
            f"{mesh.size} x kernel_launches a step; step wall "
            f"{_spread_ms(walls)}, peak {peak / 1e9:.2f} GB (predicted {predicted / 1e9:.2f} "
            f"GB), gathered params {gathered / 1e9:.3f} GB a position; one "
            f"step apart: wall {prof['wall_ms']:.2f} ms, device time "
            f"{prof['device_ms']:.2f} ms under the profiler (idle "
            f"{max(0.0, 100 * (1 - prof['device_ms'] / prof['wall_ms'])):.1f}"
            f" %), top {prof['top']}; in {time.perf_counter() - t0:.2f} s; "
            f"{smi}")
        for k in total:
            total[k] += counts[k]
        del state, step, batches
        torch.cuda.empty_cache()
    return total


def _launch_sharded_runs(kernels: dict, smi: str, synchronize, train):
    import dataclasses
    import statistics
    import torch
    from repro_torch.core import tree_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.optim import constant, make_optimizer

    mesh = _dp_mesh(LAUNCH_MESH)
    dev = mesh.positions[0]
    base = registry.get("llama3.2-1b").cfg
    data = SyntheticLM(base.vocab_size, LAUNCH_SEQ, LAUNCH_BATCH)

    # the f32 check
    t_f32 = time.perf_counter()
    f32 = dataclasses.replace(base, num_layers=TRAIN_CHECK_LAYERS,
                              param_dtype="float32",
                              compute_dtype="float32")
    api = registry.get_model(f32)
    opt = make_optimizer("sgdm")
    lr = constant(1e-2)
    plain = train.make_train_step(api, opt, lr)
    sharded = train.make_sharded_train_step(api, opt, lr, mesh)
    worst = 0.0
    blocks = mesh.shape["data"]
    # two steps, then apart from them one step on labels masked unevenly
    # over the row blocks; each run from the seeded state on both sides,
    # so the masked step's gap is only its own rounding
    f32_losses = []
    for run in ([data.batch(0), data.batch(1)],
                [masked_batch(data.batch(0), blocks)]):
        a = train.train_state(api, opt, torch.Generator(
            device=dev).manual_seed(0), device=dev)
        b = sharded.place(a)
        for i, batch in enumerate(run):
            a, ma = plain(a, batch)
            b, mb = sharded(b, batch)
            la, lb = float(ma["loss"]), float(mb["loss"])
            f32_losses.append((lb, la))
            if abs(la - lb) > LAUNCH_F32_LOSS_RTOL * abs(la):
                fail(f"[launch] (a) f32: sharded loss {lb} vs one "
                     f"position's {la} at step {i} of {len(run)}")
        for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
            top = float(x.float().abs().max()) if x.numel() else 0.0
            err = float((y.gather(dev).float() - x.float()).abs().max()) \
                if x.numel() else 0.0
            worst = max(worst, err / max(top, 1e-30))
            if err > DP_GRAD_TOL * top + 1e-6:
                fail(f"[launch] (a) f32: leaf {i} {err} vs max {top} "
                     f"after {len(run)} step(s)")
        del a, b
    del plain, sharded
    t_f32 = time.perf_counter() - t_f32
    say(f"[launch] (a) f32 in {t_f32:.2f} s at {TRAIN_CHECK_LAYERS} layers, "
        f"full width, tensor-parallel over the model axis, "
        f"SGD-momentum, 2 steps, then from the seeded state again one on "
        f"labels masked unevenly over the {blocks} row blocks, on "
        f"{dict(mesh.shape)}: losses (sharded, one position) {f32_losses} "
        f"within rtol {LAUNCH_F32_LOSS_RTOL}, every leaf within "
        f"{DP_GRAD_TOL} of its largest element of make_train_step on one "
        f"position (worst {worst:.3g})")
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(base, num_layers=LAUNCH_LAYERS)
    api = registry.get_model(cfg)
    opt = make_optimizer("adamw")
    lr = constant(LAUNCH_LR)
    step = train.make_sharded_train_step(api, opt, lr, mesh)
    if step.tp is None or not (step.tp.heads and step.tp.mlp
                               and step.tp.vocab):
        fail(f"[launch] (a) the step does not split heads, d_ff and vocab "
             f"over the model axis: {step.tp}")
    predicted = _predict_sharded_peak(step)
    say(f"[launch] (a) predicted peak of the sharded step: "
        f"{predicted / 1e9:.2f} GB (the larger of the compute: the placed "
        f"state, {mesh.size} positions' gathered params, "
        f"{step.gathered_param_bytes() / 1e9:.3f} GB each: their blocks of "
        f"heads, d_ff and vocab over the model axis, and gradients, one "
        f"model group's f32 logits and their gradient; and the update: the "
        f"old and new state beside the gradients); limit "
        f"{LAUNCH_PEAK_LIMIT / 1e9:.0f} GB; {cfg.num_layers} layers")
    if predicted >= LAUNCH_PEAK_LIMIT:
        fail(f"[launch] (a) predicted peak {predicted / 1e9:.2f} GB: cut "
             f"LAUNCH_LAYERS")
    fresh = lambda: train.train_state(
        api, opt, torch.Generator(device=dev).manual_seed(0), device=dev)
    plain = train.make_train_step(api, opt, lr)
    # apart from the run: one step from the seeded state on both sides on
    # labels masked unevenly over the row blocks (equal params: the gap
    # is the masked mean's own rounding)
    masked = masked_batch(data.batch(0), blocks)
    s, m = plain(fresh(), masked)
    masked_ref = float(m["loss"])
    del s
    s, m = step(step.place(fresh()), masked)
    masked_loss = float(m["loss"])
    _model_replicas_equal(s, mesh, "[launch] (a) the masked step")
    del s
    if not abs(masked_ref - masked_loss) <= \
            LAUNCH_LOSS_TOL * (1 + abs(masked_ref)):
        fail(f"[launch] (a) the masked step: sharded loss {masked_loss} vs "
             f"one position's {masked_ref}")
    t_ref = time.perf_counter()
    s = fresh()
    ref = []
    for i in range(LAUNCH_STEPS):
        s, m = plain(s, data.batch(i))
        ref.append(float(m["loss"]))
    del s, plain
    t_ref = time.perf_counter() - t_ref
    torch.cuda.empty_cache()
    state = step.place(fresh())
    synchronize(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0
    losses, walls = [], []
    for i in range(LAUNCH_STEPS):
        synchronize(dev)
        t = time.perf_counter()
        state, m = step(state, data.batch(i))
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t)
        _model_replicas_equal(state, mesh, f"[launch] (a) step {i}")
    counts = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    one = registry.kernel_launches(cfg, train_steps=1)
    want = {"gather_tiles": 0, **{k: LAUNCH_STEPS * mesh.size * v
                                  for k, v in one.items()}}
    if counts != want:
        fail(f"[launch] (a) launched {counts}, expected {want}")
    for i, (x, y) in enumerate(zip(ref, losses)):
        # _close's bf16 convention: atol and rtol LAUNCH_LOSS_TOL
        if not abs(x - y) <= LAUNCH_LOSS_TOL * (1 + abs(x)):
            fail(f"[launch] (a) step {i}: sharded loss {y} vs one "
                 f"position's {x}")
    _blocks_equal_whole(state, "[launch] (a)")
    # apart from the counted run: one step timed, then one under
    # torch.profiler (the device ops' self time) on the same inputs
    prof = profile_device_ms(dev, lambda: step(state, data.batch(0)),
                             calls=1)
    tokens = LAUNCH_BATCH * LAUNCH_SEQ
    say(f"[launch] (a) sharded step, tensor-parallel over the model axis "
        f"(heads, d_ff and vocab), median wall "
        f"{statistics.median(walls) * 1e3:.2f} ms, peak {peak / 1e9:.2f} GB;"
        f" one step apart: wall {prof['wall_ms']:.2f} ms, device time "
        f"{prof['device_ms']:.2f} ms (idle "
        f"{100 * (1 - prof['device_ms'] / prof['wall_ms']):.1f} %), top "
        f"{prof['top']}; {smi}")
    say(f"[launch] (a) sharded step, llama3.2-1b {cfg.num_layers} layers "
        f"bf16 AdamW lr {LAUNCH_LR}, batch {LAUNCH_BATCH} x {LAUNCH_SEQ} on "
        f"{dict(mesh.shape)} ({mesh.size} positions on "
        f"{sorted({str(d) for d in mesh.positions})}): losses "
        f"{losses} vs one position's {ref}, and apart from the run one "
        f"step from the seeded state on labels masked unevenly over the "
        f"{blocks} row blocks: {masked_loss} vs {masked_ref} (each within "
        f"{LAUNCH_LOSS_TOL} x (1 + |loss|)); "
        f"model replicas "
        f"bit-equal after every step; every block == its block of the "
        f"gathered state; launches {counts} == {mesh.size} x "
        f"kernel_launches a step; step wall {_spread_ms(walls)} "
        f"({tokens / (sum(walls[1:]) / max(1, len(walls) - 1)):.1f} "
        f"tokens/s after the first); peak {peak / 1e9:.2f} GB (predicted "
        f"{predicted / 1e9:.2f} GB); the one-position run {t_ref:.2f} s; "
        f"{smi}")
    return counts, state, api, opt


def launch_restore(state, api, opt, root: Path, smi: str) -> None:
    """Part (b): save (a)'s placed state, restore it onto each of
    LAUNCH_RESTORE_MESHES with that mesh's train rules: every block equal
    to the host's block bit for bit, and the bytes the restore allocated
    (its blocks' storages) equal, exactly, to the dry run's placement
    summed over the positions.  The caching allocator's growth is
    printed: at least that sum with each block rounded up to
    CUDA_ALLOC_GRANULE, more where it hands out a cached block without
    splitting it."""
    import torch
    from repro_torch import checkpoint
    from repro_torch._device import synchronize
    from repro_torch.core import tree_leaves
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import rules_for, tree_shardings
    from repro_torch.runtime import train

    dev = tree_leaves(state)[0].blocks[0].device
    nbytes = sum(x.numel() * x.blocks[0].element_size()
                 for x in tree_leaves(state))
    t = time.perf_counter()
    checkpoint.save(state, str(root), LAUNCH_STEPS)
    t_save = time.perf_counter() - t
    del state
    torch.cuda.empty_cache()
    t = time.perf_counter()
    host = checkpoint.load(str(root))
    t_load = time.perf_counter() - t
    say(f"[launch] (b) save of (a)'s placed state ({nbytes} B gathered): "
        f"{t_save:.2f} s ({nbytes / t_save / 1e9:.2f} GB/s); load "
        f"{t_load:.2f} s")
    state_abs = train.abstract_train_state(api, opt)
    for shape in LAUNCH_RESTORE_MESHES:
        mesh = _dp_mesh(shape)
        sh = tree_shardings(mesh, train.train_state_axes(api, opt),
                            rules_for(api.cfg, mesh, "train"), state_abs)
        predicted = dryrun._placed_bytes(state_abs, sh) * mesh.size
        allocated = (lambda: torch.cuda.memory_allocated(dev)) \
            if dev.type == "cuda" else (lambda: 0)
        synchronize(dev)
        before = allocated()
        t = time.perf_counter()
        out = checkpoint.restore(str(root), shardings=sh)
        synchronize(dev)
        wall = time.perf_counter() - t
        grown = allocated() - before
        blocks = [b for x in tree_leaves(out) for b in x.blocks]
        storage = sum(b.untyped_storage().nbytes() for b in blocks)
        granules = sum(-(-b.numel() * b.element_size() // CUDA_ALLOC_GRANULE)
                       * CUDA_ALLOC_GRANULE for b in blocks)
        if storage != predicted:
            fail(f"[launch] (b) restore onto {shape}: blocks hold {storage} "
                 f"B, the dry run's placement gives {predicted} B")
        if dev.type == "cuda" and grown < granules:
            fail(f"[launch] (b) restore onto {shape}: the allocator grew "
                 f"{grown} B, less than the blocks rounded to "
                 f"{CUDA_ALLOC_GRANULE} B ({granules} B)")
        _blocks_equal_whole(out, f"[launch] (b) restore onto {shape}", host)
        say(f"[launch] (b) restore onto {dict(mesh.shape)}: {wall:.2f} s "
            f"({storage / wall / 1e9:.2f} GB/s of blocks); blocks hold "
            f"{storage} B == the dry run's placement summed over "
            f"{mesh.size} positions; the allocator grew {grown} B, "
            f"{grown - granules} B above the blocks rounded to "
            f"{CUDA_ALLOC_GRANULE} B (a cached block it does not split); "
            f"every block == the host's block bit for bit; {smi}")
        del out, blocks
        torch.cuda.empty_cache()


def _one_position_serve(api, params, prompts, extras, dev):
    """``api`` on one position: each prompt prefilled at batch 1 (with
    its ``extras``, an encoder-decoder's frames), the caches stacked into
    the slots, LAUNCH_NEW greedy decode steps.  Returns (the prefill
    logits, the decode steps' logits, the tokens fed to each step, the
    final cache)."""
    import torch

    pre, caches = [], []
    for tok, extra in zip(prompts, extras):
        logits, c = api.prefill(params, tok, api.init_cache(
            1, SERVE_MAX_SEQ, device=dev), **extra)
        pre.append(logits)
        caches.append(c)
    cache = {k: torch.cat([c[k] for c in caches], dim=0 if k in (
        "pos", "enc_out") else 1) for k in caches[0]}
    del caches
    feed = [torch.cat([lg[:, -1].argmax(-1, keepdim=True) for lg in pre])
            .to(torch.int32)]
    dec = []
    for _ in range(LAUNCH_NEW):
        logits, cache = api.decode_step(params, feed[-1], cache)
        dec.append(logits)
        feed.append(logits[:, -1].argmax(-1, keepdim=True).to(torch.int32))
    return pre, dec, feed, cache


def launch_placed_run(kernels: dict, api, shape, regions, hold, smi: str
                      ) -> dict:
    """One placed serving run of (c): ``api`` at full width (random params
    drawn on the card from seed 0), LAUNCH_PROMPTS of phase 8's prompts.
    On one position first (:func:`_one_position_serve`); then placed on
    a mesh of ``shape`` under the decode rules (the batch over data, the
    cache's sequence over model, each model group tensor-parallel over
    ``regions``, which the plan must split): each prompt prefilled into its
    slot (the model group that holds the row computes), then the decode
    steps fed the one-position run's tokens.  Every logit, and every
    block of every cache leaf against its block of the one-position
    cache, is held by ``hold``: "bf16" within BF16_TOL, a number within
    it times the block's largest |value|, None finite only, its distance
    printed (a seeded model deeper than LAUNCH_SERVE_BF16_LAYERS in bf16
    amplifies any rounding past BF16_TOL: LAUNCH_SERVE_F32_TOL's
    comment); ``pos`` exactly; every block equal to its block of the
    gathered leaf; the launches exactly kernel_launches(prefills=the
    row's holders x prompts, steps=mesh size x steps).  An
    encoder-decoder's prompts each come with SERVE_MAX_SEQ / src_ratio
    frames (seeded, in its compute dtype), encoded at every prefill
    (encodes=prefills).  Returns the counts."""
    import torch
    from repro_torch._device import synchronize
    from repro_torch.launch.mesh import adapt_batch_rule, rules_for
    from repro_torch.models import registry
    from repro_torch.models.specs import torch_dtype
    from repro_torch.runtime.placed import PlacedServe

    cfg = api.cfg
    mesh = _dp_mesh(shape)
    dev = mesh.positions[0]
    params = api.init(torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    prompts = [torch.as_tensor(p[None], device=dev)
               for p in serve_prompts(cfg.vocab_size)[:LAUNCH_PROMPTS]]
    n = len(prompts)
    extras = [{}] * n
    if cfg.is_encdec:
        gen = torch.Generator(device=dev).manual_seed(19)
        extras = [{"frames": torch.randn(
            1, max(1, SERVE_MAX_SEQ // cfg.src_ratio), cfg.d_model,
            generator=gen, device=dev).to(torch_dtype(cfg.compute_dtype))}
            for _ in prompts]
    pre, dec, feed, want_cache = _one_position_serve(api, params, prompts,
                                                     extras, dev)
    rules = adapt_batch_rule(rules_for(cfg, mesh, "decode"), mesh, n)
    serve = PlacedServe(api, mesh, rules)
    plan = serve.plan
    split = tuple(r for r in ("heads", "mlp", "vocab", "experts", "ssm")
                  if plan is not None and getattr(plan, r))
    if split != tuple(regions):
        fail(f"[launch] (c) {cfg.name}: the plan splits {split}, not "
             f"{tuple(regions)}")
    if "k" in want_cache and not serve.kv_split(n, SERVE_MAX_SEQ):
        fail(f"[launch] (c) {cfg.name}: the cache's sequence does not split "
             f"over model")
    placed = serve.place_params(params)
    del params
    pcache = serve.place_cache(api.init_cache(n, SERVE_MAX_SEQ, device=dev))
    synchronize(dev)
    tops = {"logits": 0.0, "cache": 0.0}

    def close(got, want, what, part="logits"):
        if not bool(torch.isfinite(got.float()).all()):
            fail(f"{what}: a value is not finite")
        if hold == "bf16":
            return _close(got, want, what)
        err = float((got.float() - want.float()).abs().max())
        top = float(want.float().abs().max())
        tops[part] = max(tops[part], top)
        if hold is not None and err > hold * top:
            fail(f"{what}: max |diff| {err} > {hold} x {top}")
        return err

    for k in kernels.values():
        k.launches = 0
    err, t_pre, t_dec = 0.0, [], []
    for r, (tok, extra) in enumerate(zip(prompts, extras)):
        t = time.perf_counter()
        logits, pcache = serve.prefill(placed, tok, pcache, slot=r, **extra)
        synchronize(dev)
        t_pre.append(time.perf_counter() - t)
        err = max(err, close(logits, pre[r], f"[launch] (c) {cfg.name} "
                             f"prefill {r}"))
    for i in range(LAUNCH_NEW):
        t = time.perf_counter()
        logits, pcache = serve.decode_step(placed, feed[i], pcache)
        synchronize(dev)
        t_dec.append(time.perf_counter() - t)
        err = max(err, close(logits.gather(dev), dec[i],
                             f"[launch] (c) {cfg.name} decode step {i}"))
    counts = {name: k.launches for name, k in kernels.items()}
    holders = mesh.size // mesh.shape["data"]
    encodes = {"encodes": holders * n} if cfg.is_encdec else {}
    want = {"gather_tiles": 0, **registry.kernel_launches(
        cfg, prefills=holders * n, steps=mesh.size * LAUNCH_NEW,
        **encodes)}
    if counts != want:
        fail(f"[launch] (c) {cfg.name} launched {counts}, expected {want}")
    _blocks_equal_whole(pcache, f"[launch] (c) {cfg.name} cache")
    cerr = 0.0
    for key, leaf in pcache.items():
        whole = want_cache[key]
        for p, block in enumerate(leaf.blocks):
            mine = whole[leaf.placement.index(p, leaf.shape)]
            if key == "pos":
                if not torch.equal(block, mine):
                    fail(f"[launch] (c) {cfg.name}: pos on position {p} "
                         f"{block.tolist()} != {mine.tolist()}")
                continue
            cerr = max(cerr, close(block, mine, f"[launch] (c) {cfg.name} "
                                   f"cache {key} block {p}", "cache"))
    pl = {k: v.placement.spec for k, v in pcache.items()}
    del placed, pcache, want_cache
    if hold == "bf16":
        held = f"held within {BF16_TOL}"
    elif hold is not None:
        held = f"held within {hold} x the largest"
    else:
        held = "finite, not held (rounding amplified past any tolerance)"
    largest = "" if hold == "bf16" else (
        f" of a largest {tops['logits']:.6g} / {tops['cache']:.6g}")
    layers = (f"{cfg.enc_layers} + {cfg.num_layers} layers, "
              f"{tuple(extras[0]['frames'].shape[1:])} frames a prompt"
              if cfg.is_encdec else f"{cfg.num_layers} layers")
    say(f"[launch] (c) placed prefill + decode tensor-parallel, {cfg.name} "
        f"({layers}, {cfg.compute_dtype}) on "
        f"{dict(mesh.shape)} (split {', '.join(split)}; cache placed {pl}): "
        f"{n} prompts of {[int(p.shape[1]) for p in prompts]} tokens into "
        f"the slots of an {n} x {SERVE_MAX_SEQ} cache, {LAUNCH_NEW} decode "
        f"steps: logits and every cache block against one position's "
        f"{held} (max |diff| {err} / {cerr}{largest}); every block equal to "
        f"its block of the gathered leaf; launches {counts} exact; prefill "
        f"per prompt {_spread_ms(t_pre)}; decode step {_spread_ms(t_dec)}; "
        f"{smi}")
    return counts


def launch_placed_serve(kernels: dict, smi: str) -> dict:
    """Part (c): placed prefill and decode (``runtime.placed``), each model
    group tensor-parallel over the model axis (``lm.serve_tp``), each run
    :func:`launch_placed_run`: llama3.2-1b at full size on LAUNCH_MESH in
    bf16 (finite), then cut to LAUNCH_SERVE_BF16_LAYERS in bf16 (within
    BF16_TOL) and to LAUNCH_SERVE_F32_LAYERS in f32 (within
    LAUNCH_SERVE_F32_TOL of the largest); zamba2-2.7b at full width cut
    to LAUNCH_SERVE_ZAMBA_LAYERS on (1, 4) in bf16 (finite) and in f32
    (within LAUNCH_SERVE_F32_TOL of the largest); seamless-m4t-medium at
    full width (``encdec.serve_tp``, its prompts with frames), both
    stacks cut, in f32 on LAUNCH_MESH to LAUNCH_SERVE_SEAMLESS_LAYERS
    (finite) and to LAUNCH_SERVE_SEAMLESS_HELD_LAYERS (within
    LAUNCH_SERVE_F32_TOL of the largest), and in bf16 on (1, 4), where
    its vocab stays whole, to LAUNCH_SERVE_SEAMLESS_HELD_LAYERS (finite).
    Returns the launch counts summed."""
    import dataclasses
    from repro_torch.models import registry

    llama = registry.get("llama3.2-1b").cfg
    zamba = dataclasses.replace(registry.get("zamba2-2.7b").cfg,
                                num_layers=LAUNCH_SERVE_ZAMBA_LAYERS)
    seamless = registry.get("seamless-m4t-medium").cfg
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    dense, hybrid = ("heads", "mlp", "vocab"), ("heads", "mlp", "vocab",
                                                 "ssm")
    runs = ((llama, LAUNCH_MESH, dense, None),
            (dataclasses.replace(llama, num_layers=LAUNCH_SERVE_BF16_LAYERS),
             LAUNCH_MESH, dense, "bf16"),
            (dataclasses.replace(llama, num_layers=LAUNCH_SERVE_F32_LAYERS,
                                 **f32), LAUNCH_MESH, dense,
             LAUNCH_SERVE_F32_TOL),
            (zamba, (1, 4), hybrid, None),
            (dataclasses.replace(zamba, **f32), (1, 4), hybrid,
             LAUNCH_SERVE_F32_TOL),
            (dataclasses.replace(
                seamless, num_layers=LAUNCH_SERVE_SEAMLESS_LAYERS,
                enc_layers=LAUNCH_SERVE_SEAMLESS_LAYERS, **f32),
             LAUNCH_MESH, dense, None),
            (dataclasses.replace(
                seamless, num_layers=LAUNCH_SERVE_SEAMLESS_HELD_LAYERS,
                enc_layers=LAUNCH_SERVE_SEAMLESS_HELD_LAYERS, **f32),
             LAUNCH_MESH, dense, LAUNCH_SERVE_F32_TOL),
            (dataclasses.replace(
                seamless, num_layers=LAUNCH_SERVE_SEAMLESS_HELD_LAYERS,
                enc_layers=LAUNCH_SERVE_SEAMLESS_HELD_LAYERS), (1, 4),
             ("heads", "mlp"), None))
    total = {}
    for cfg, shape, regions, hold in runs:
        counts = launch_placed_run(kernels, registry.get_model(cfg), shape,
                                   regions, hold, smi)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    return total


def _run_example(name: str, argv) -> str:
    """``examples/torch_<name>.py``'s ``main(argv)``; its printed text."""
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(list(argv))
    return buf.getvalue()


def launch_examples(root: Path) -> None:
    """Part (d): the four examples through ``main(argv)`` on the card at
    small sizes.  quickstart's transfers and bytes equal the closed forms
    of its tree; the demo's DMAs, MB and checks equal its CPU run's; serve
    completes every request; train restarts once from its checkpoint."""
    import re

    t0 = time.perf_counter()
    out = _run_example("quickstart", [])
    pos = 1024 * 3 * 4                      # positions: 1024 x 3 f32
    whole = 3 * pos + 4 + 9 * 4             # traits, N, box
    for line in (f"uvm           H2D: 1 transfer(s), {pos / 1e3:8.1f} KB",
                 f"marshal       H2D: 2 transfer(s), {whole / 1e3:8.1f} KB",
                 f"pointerchain  H2D: 1 transfer(s), {pos / 1e3:8.1f} KB",
                 f"requestList: 5 slots, {whole / 1e3:.1f} KB total"):
        if line not in out:
            fail(f"[launch] (d) quickstart printed no {line!r}:\n{out}")
    pat = re.compile(r"^\s+(\S.*?)\s+wall .*H2D\s+(\d+) DMAs /\s+([\d.]+) MB"
                     r"\s+check=(\w+)", re.M)
    args = ["--k", "3", "--n", "1000", "--q", "3"]
    card = pat.findall(_run_example("deepcopy_demo", args))
    cpu = pat.findall(_run_example("deepcopy_demo", args + ["--device",
                                                            "cpu"]))
    if card != cpu or len(card) != 10 or any(c[3] != "ok" for c in card):
        fail(f"[launch] (d) deepcopy demo: card {card} vs cpu {cpu}")
    out = _run_example("serve_lm", [])
    if "served 8 requests, 96 tokens" not in out or "completed 8" not in out:
        fail(f"[launch] (d) serve example:\n{out}")
    out = _run_example("train_lm", ["--steps", "4", "--batch", "2", "--seq",
                                    "32", "--fail-at", "2", "--ckpt-dir",
                                    str(root / "train_lm")])
    if "restarts: 1" not in out or "nan" in out:
        fail(f"[launch] (d) train example:\n{out}")
    say(f"[launch] (d) examples/torch_quickstart.py (transfers and bytes == "
        f"the closed forms), torch_deepcopy_demo.py (10 cells' DMAs and MB "
        f"== its CPU run's, checks ok), torch_serve_lm.py (8 requests, 96 "
        f"tokens), torch_train_lm.py (4 steps, a failure at step 2, one "
        f"restart) on the card in {time.perf_counter() - t0:.2f} s")


def launch_dryrun() -> None:
    """Part (e): ``python -m repro_torch.launch.dryrun --arch llama3.2-1b
    --shape train_4k --mesh both`` on meta positions (host counts, not
    card measurements): 2/2 cells ok, the probe identity exact, the five
    memory keys reported."""
    import io
    from repro_torch.launch import dryrun

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        results = dryrun.main(["--arch", "llama3.2-1b", "--shape",
                               "train_4k", "--mesh", "both"])
    out = buf.getvalue()
    if "[dryrun] 2/2 cells ok" not in out:
        fail(f"[launch] (e) dry run:\n{out}")
    for r in results:
        if not r["probe_check"]["exact"]:
            fail(f"[launch] (e) {r['mesh_name']}: the probe identity fails "
                 f"{r['probe_check']}")
        mem = r["memory"]
        if len(mem) != 5 or mem["temp_size_in_bytes"] < 0:
            fail(f"[launch] (e) {r['mesh_name']}: memory {mem}")
        say(f"[launch] (e) dry run llama3.2-1b|train_4k|{r['mesh_name']} "
            f"({r['mesh']} meta positions, counted on this host): arguments "
            f"{mem['argument_size_in_bytes']} B a position, outputs "
            f"{mem['output_size_in_bytes']} B, aliases "
            f"{mem['alias_size_in_bytes']} B, temps "
            f"{mem['temp_size_in_bytes']} B, peak "
            f"{mem['peak_memory_in_bytes']} B, "
            f"{r['flops']:.6g} FLOPs and {r['bytes_accessed']:.6g} B a "
            f"position's step, collectives "
            f"{r['collectives']['total_count']} calls / "
            f"{r['collectives']['total_bytes']} B, gathered params "
            f"{r['gathered_param_bytes']} B a position, trace "
            f"{r['trace_s']} s; "
            f"step == layers x body + layer-free exactly")
    say(f"[launch] (e) {out.strip().splitlines()[-1]} in "
        f"{time.perf_counter() - t0:.2f} s")


def launch_memory(kernels: dict, smi: str) -> dict:
    """Part (e), second: the dry run's memory analysis held against the
    card.  (a)'s llama3.2-1b config (LAUNCH_LAYERS layers, bf16, AdamW)
    at LAUNCH_BATCH x LAUNCH_SEQ: ``dryrun.trace_step`` on a (1, 1) meta
    mesh, each storage rounded up to CUDA_ALLOC_GRANULE, predicts the
    peak of the storages a call allocates; the same call runs on a (1, 1)
    mesh of cuda:0 (a train step, a placed prefill into a LAUNCH_SEQ
    cache, a placed decode step on a 2 x LAUNCH_SEQ cache), once to warm
    up and once measured: the growth of ``max_memory_allocated`` over it
    (after ``reset_peak_memory_stats``) must lie within LAUNCH_MEMORY_TOL
    of the prediction or LAUNCH_MEMORY_SLACK, whichever is larger.  The
    warm-up's and the measured call's launches must each be the model's.
    Returns the launch counts of both calls summed."""
    import dataclasses
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (adapt_batch_rule, make_debug_mesh,
                                         rules_for)
    from repro_torch.models import registry
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.runtime.placed import PlacedServe
    from repro_torch.runtime.train import ShardedTrainStep, train_state

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(registry.get("llama3.2-1b").cfg,
                              num_layers=LAUNCH_LAYERS)
    api = registry.get_model(cfg)
    card = make_debug_mesh(1, 1, device=dev)
    meta = make_debug_mesh(1, 1, device="meta")
    gen = torch.Generator(device=dev).manual_seed(0)
    total = {name: 0 for name in kernels}
    calls = (("train", LAUNCH_SEQ), ("prefill", LAUNCH_SEQ),
             ("decode", 2 * LAUNCH_SEQ))
    for mode, seq in calls:
        shape = InputShape(f"card_{mode}", seq_len=seq,
                           global_batch=LAUNCH_BATCH, mode=mode)
        rules = adapt_batch_rule(rules_for(cfg, meta, mode), meta,
                                 LAUNCH_BATCH)
        traced = dryrun.trace_step(api, shape, meta, rules,
                                   granule=CUDA_ALLOC_GRANULE)
        predicted = traced["memory"].peak
        inputs = {k: torch.randint(0, cfg.vocab_size, sh, dtype=dt,
                                   device=dev, generator=gen)
                  for k, (sh, dt) in api.inputs(shape).items()}
        if mode == "train":
            opt = make_optimizer(cfg.optimizer)
            step = ShardedTrainStep(api, opt,
                                    warmup_cosine(3e-4, 100, 10_000), card,
                                    rules)
            state = step.place(train_state(api, opt, gen, device=dev))
            call = lambda: step(state, inputs)
            want = registry.kernel_launches(cfg, train_steps=1)
        else:
            serve = PlacedServe(api, card, rules)
            params = serve.place_params(api.init(gen, device=dev))
            cache = serve.place_cache(api.init_cache(LAUNCH_BATCH, seq,
                                                     device=dev))
            tokens = inputs.pop("tokens")
            if mode == "prefill":
                call = lambda: serve.prefill(params, tokens, cache)
                want = registry.kernel_launches(cfg, prefills=1)
            else:
                call = lambda: serve.decode_step(params, tokens, cache)
                want = registry.kernel_launches(cfg, steps=1)
        want = {"gather_tiles": 0, **want}
        for what in ("warm-up", "measured"):
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            for k in kernels.values():
                k.launches = 0
            start = torch.cuda.memory_allocated(dev)
            out = call()
            torch.cuda.synchronize(dev)
            measured = torch.cuda.max_memory_allocated(dev) - start
            counts = {name: k.launches for name, k in kernels.items()}
            del out
            if counts != want:
                fail(f"[launch] (e) memory, {mode} ({what}): launched "
                     f"{counts}, expected {want}")
            for name in total:
                total[name] += counts[name]
        del call
        gap = measured - predicted
        bound = max(LAUNCH_MEMORY_TOL * predicted, LAUNCH_MEMORY_SLACK)
        say(f"[launch] (e) memory, llama3.2-1b {cfg.num_layers} layers "
            f"bf16, {mode} at {LAUNCH_BATCH} x {seq} on (1, 1) of {dev}: "
            f"the allocator's peak grew {measured} B over the call (card), "
            f"the dry run predicts {predicted} B (host count, (1, 1) meta "
            f"mesh, storages rounded up to {CUDA_ALLOC_GRANULE} B; "
            f"arguments {traced['argument_bytes']} B, outputs "
            f"{traced['memory'].output} B, aliases "
            f"{traced['memory'].alias} B): gap {gap:+d} B "
            f"({100 * gap / predicted:+.2f} %, bound {bound:.0f} B); "
            f"launches {counts}; {smi}")
        if abs(gap) > bound:
            fail(f"[launch] (e) memory, {mode}: the card's {measured} B vs "
                 f"the dry run's {predicted} B")
        torch.cuda.empty_cache()
    say(f"[launch] (e) memory: {len(calls)} calls within "
        f"{100 * LAUNCH_MEMORY_TOL:.0f} % (or {LAUNCH_MEMORY_SLACK >> 20} "
        f"MiB) of the dry run")
    return total


def launch_phase(kernels: dict, smi: str) -> dict:
    """Phase 20: (a) the sharded step, (b) save and restore onto other
    meshes, (c) placed prefill and decode, (d) the four examples, (e) the
    dry run and its memory analysis against the card.  Returns the launch
    counts of (a), (c) and (e) summed."""
    import shutil
    import torch

    t0 = time.perf_counter()
    root = ROOT / "build" / "phase20_checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    marks = [t0]
    try:
        trained, state, api, opt = launch_sharded_step(kernels, smi)
        marks.append(time.perf_counter())
        launch_restore(state, api, opt, root, smi)
        del state
        torch.cuda.empty_cache()
        marks.append(time.perf_counter())
        served = launch_placed_serve(kernels, smi)
        torch.cuda.empty_cache()
        marks.append(time.perf_counter())
        launch_examples(root)
        marks.append(time.perf_counter())
        launch_dryrun()
        memory = launch_memory(kernels, smi)
        marks.append(time.perf_counter())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    parts = ", ".join(f"({c}) {b - a:.2f} s" for c, a, b in
                      zip("abcde", marks, marks[1:]))
    say(f"[launch] phase 20 ok in {marks[-1] - t0:.2f} s ({parts})")
    return {k: trained[k] + served[k] + memory[k] for k in trained}


def main() -> int:
    import dataclasses
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.marshal_pack import kernel as K
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.core import get_session
    from repro_torch.models import registry
    from repro_torch.scenarios import dense_case, linear_case

    kernels = {"gather_tiles": K.gather_tiles, "rmsnorm": RK.rmsnorm,
               "flash_attention": FK.flash_attention,
               "decode_attention": DK.decode_attention,
               "ssd_chunks": SK.ssd_chunks}

    def reset():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {name: k.launches for name, k in kernels.items()}

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"[env] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; matmul allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32} (set), "
        f"allow_bf16_reduced_precision_reduction = "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}"
        f" (default)")
    memory_bandwidth(name)

    build_kernels([K.SOURCE, RK.SOURCE, FK.SOURCE, DK.SOURCE, SK.SOURCE])

    gather = check_gather_tiles(device, GIB_TILES)
    cfg = registry.get("llama3.2-1b").cfg
    hd = cfg.resolved_head_dim
    prompts = serve_prompts(cfg.vocab_size)
    lens = [len(p) for p in prompts]
    rms_widths = (cfg.d_model,
                  registry.get("zamba2-2.7b").cfg.d_model,
                  registry.get("phi-3-vision-4.2b").cfg.d_model)
    rms = check_rmsnorm(device, lens + [SERVE_SLOTS],
                        rmsnorm_grid(max(lens), rms_widths))
    report_kernel("rmsnorm", rms)
    flash = check_flash(device, lens, 4096, cfg.num_heads, cfg.num_kv_heads,
                        hd)
    flash["max_abs_err"] = max(flash["max_abs_err"], check_flash_offsets(
        device, lens, cfg.num_heads, cfg.num_kv_heads, hd))
    serve_valid = [n + SERVE_NEW_TOKENS // 2 for n in lens[:SERVE_SLOTS]]
    dec = check_decode(device, serve_valid, 32, 8192, cfg.num_heads,
                       cfg.num_kv_heads, hd)
    mamba = registry.get("mamba2-1.3b").cfg
    zamba = dataclasses.replace(registry.get("zamba2-2.7b").cfg,
                                num_layers=ZAMBA_LAYERS)
    zerr = check_serve_attention(device, lens, serve_valid, zamba.num_heads,
                                 zamba.num_kv_heads, zamba.resolved_head_dim)
    rerr = rmsnorm_err(device, lens + [SERVE_SLOTS], zamba.d_model)
    say(f"[kernels] rmsnorm at zamba2's width {zamba.d_model}, rows "
        f"{sorted(set(lens + [SERVE_SLOTS]))}: == plain within {BF16_TOL} "
        f"(max |diff| {rerr})")
    rms["max_abs_err"] = max(rms["max_abs_err"], rerr)
    flash["zamba2"], dec["zamba2"], terr = time_serve_attention(
        device, max(lens), serve_valid, zamba.num_heads, zamba.num_kv_heads,
        zamba.resolved_head_dim)
    zerr = max(zerr, terr)
    say(f"[kernels] flash_attention at per-batch offsets (llama) and at head "
        f"dim {zamba.resolved_head_dim} (zamba2), decode_attention at head "
        f"dim {zamba.resolved_head_dim}: == plain within {BF16_TOL} (max "
        f"|diff| {max(flash['max_abs_err'], zerr)})")
    flash["max_abs_err"] = max(flash["max_abs_err"], zerr)
    dec["max_abs_err"] = max(dec["max_abs_err"], zerr)
    # the member shapes of phase 20 (c)'s tensor-parallel serving: a
    # member's query heads and the kv heads they read, its rows of the
    # batch (the data axis's share), the prompts and valid lengths there
    launch_lens = lens[:LAUNCH_PROMPTS]
    terr = 0.0
    for tag, c, (data, model) in (("llama_tp", cfg, LAUNCH_MESH),
                                  ("zamba2_tp", zamba, (1, 4))):
        valid = [n + LAUNCH_NEW // 2 for n in launch_lens[:len(
            launch_lens) // data]]
        flash[tag], dec[tag], e = time_serve_attention(
            device, max(launch_lens), valid, c.num_heads // model,
            c.num_kv_heads // model, c.resolved_head_dim)
        terr = max(terr, e)
    say(f"[kernels] flash_attention and decode_attention at the "
        f"tensor-parallel members' shapes of phase 20 (c) (llama3.2-1b "
        f"{cfg.num_heads // LAUNCH_MESH[1]}/"
        f"{cfg.num_kv_heads // LAUNCH_MESH[1]} heads of {hd}, zamba2-2.7b "
        f"{zamba.num_heads // 4}/{zamba.num_kv_heads // 4} of "
        f"{zamba.resolved_head_dim}): == plain within {BF16_TOL} (max "
        f"|diff| {terr})")
    flash["max_abs_err"] = max(flash["max_abs_err"], terr)
    dec["max_abs_err"] = max(dec["max_abs_err"], terr)
    variants = [registry.get(a).cfg for a in HD128_ARCHS]
    flash["hd128"], dec["hd128"], herr = check_hd128_attention(
        device, lens, serve_valid, variants)
    say(f"[kernels] flash_attention and decode_attention at head dim 128, "
        + ", ".join(f"{c.name} {c.num_heads}/{c.num_kv_heads} heads"
                    for c in variants)
        + f": == plain within {BF16_TOL} (max |diff| {herr})")
    flash["max_abs_err"] = max(flash["max_abs_err"], herr)
    dec["max_abs_err"] = max(dec["max_abs_err"], herr)
    phi = registry.get("phi-3-vision-4.2b").cfg
    perr = check_serve_attention(device, lens, serve_valid, phi.num_heads,
                                 phi.num_kv_heads, phi.resolved_head_dim)
    flash["phi3"], dec["phi3"], terr = time_serve_attention(
        device, max(lens), serve_valid, phi.num_heads, phi.num_kv_heads,
        phi.resolved_head_dim)
    perr = max(perr, terr)
    say(f"[kernels] flash_attention and decode_attention at head dim "
        f"{phi.resolved_head_dim} ({phi.name}, {phi.num_heads}/"
        f"{phi.num_kv_heads} heads; prompts {sorted(set(lens))}, the serve "
        f"run's ragged 8 x {SERVE_MAX_SEQ} cache): == plain within "
        f"{BF16_TOL} (max |diff| {perr})")
    seam = registry.get("seamless-m4t-medium").cfg
    src = SERVE_MAX_SEQ // seam.src_ratio
    flash["seamless_cross"], cerr = check_cross_attention(
        device, lens, seam.num_heads, seam.num_kv_heads,
        seam.resolved_head_dim, src, SERVE_SLOTS)
    say(f"[kernels] non-causal flash_attention at {seam.name}'s widths "
        f"({seam.num_heads} heads of {seam.resolved_head_dim}, {src} frames "
        f"of encoder memory: the encoder's self-attention, each prompt's "
        f"cross-attention, a decode step's at Sq = 1): == plain within "
        f"{BF16_TOL} (max |diff| {cerr})")
    flash["max_abs_err"] = max(flash["max_abs_err"], perr, cerr)
    dec["max_abs_err"] = max(dec["max_abs_err"], perr)
    report_kernel("flash_attention", flash)
    report_kernel("decode_attention", dec)
    ssd = check_ssd(device, lens, mamba.ssm_chunk, [
        ("mamba2", mamba.ssm_heads, mamba.ssm_head_dim, mamba.ssm_state),
        ("zamba2", zamba.ssm_heads, zamba.ssm_head_dim, zamba.ssm_state)],
        16384)
    report_kernel("ssd_chunks", ssd)
    for arch in ("llama3.2-1b", "mamba2-1.3b", "zamba2-2.7b") + HD128_ARCHS \
            + tuple(a for a, _ in MM_ARCHS):
        say(f"[kernels] smoke {arch} (f32) logits on the card == CPU within "
            f"2e-4: max |diff| {small_logits_check(device, arch)}")
    torch.cuda.empty_cache()

    # Algorithm 2 (phases 4-6): the engine attaches with views and calls
    # no kernel, so none may be launched here
    reset()
    t0 = time.perf_counter()
    cells = algorithm2_matrix(device, "full")
    say(f"[algorithm2] {cells} cells ok in {time.perf_counter() - t0:.2f} s")
    steady(device, 2048)
    dense = dense_case(8, 524288, 3)
    linear = linear_case(6, 33554432, "allinit-allused")
    real_size(device, [(dense, REAL_CLOSED["dense"]),
                       (linear, REAL_CLOSED["linear"])])
    if any(counts().values()):
        fail(f"Algorithm 2 launched {counts()}; its engine calls no kernel")

    # the pack path (phase 7): one launch to pack, one to unpack
    reset()
    launches, pack_err = pack_roundtrip(device, dense)
    others = {k: n for k, n in counts().items() if k != "gather_tiles"}
    if launches != 2 or any(others.values()):
        fail(f"pack_tree/unpack_tree launched gather_tiles {launches} "
             f"time(s) (not 2) and {others}")
    gather["max_abs_err"] = max(gather["max_abs_err"], pack_err)
    del dense, linear
    get_session().clear()
    release_host_cache()

    # the serve paths (phases 8-12): serve_phase resets the counters just
    # before driving each and reads them just after
    moonshot = dataclasses.replace(registry.get("moonshot-v1-16b-a3b").cfg,
                                   num_layers=MOONSHOT_LAYERS)
    served = {}
    for tag, api, want in (
            ("serve", registry.get("llama3.2-1b"), SERVE_LEDGERS),
            ("serve-mamba2", registry.get("mamba2-1.3b"), None),
            ("serve-zamba2", registry.get_model(zamba), None),
            ("serve-starcoder2", registry.get("starcoder2-3b"),
             VARIANT_LEDGERS["starcoder2-3b"]),
            ("serve-moonshot", registry.get_model(moonshot),
             VARIANT_LEDGERS["moonshot-v1-16b-a3b"])):
        if want is None:
            want = {"params/**": None,
                    "cache/**": SSM_CACHE_LEDGERS[api.cfg.name],
                    "**": SERVE_LEDGERS["**"]}
        served[tag] = serve_phase(device, kernels, api, tag, want)

    # the policy scenarios (phase 13): transfers only, so no kernel launches
    reset()
    t0 = time.perf_counter()
    policy_scenarios(device, POLICY_N)
    model_state_full(device)
    if any(counts().values()):
        fail(f"the policy phase launched {counts()}; it runs no kernel")
    say(f"[policy] phase 13 ok in {time.perf_counter() - t0:.2f} s, no "
        f"kernel launched")

    # the static analysis (phase 14): host arithmetic and transfers only
    reset()
    t0 = time.perf_counter()
    analysis_phase(device, smi, POLICY_N)
    if any(counts().values()):
        fail(f"the analysis phase launched {counts()}; it runs no kernel")
    say(f"[analysis] phase 14 ok in {time.perf_counter() - t0:.2f} s, no "
        f"kernel launched")

    # the staging race sanitizer (phase 16), before training so the card
    # holds no train state: transfers only, so no kernel launches
    sanitizer_phase(device, kernels, [
        (dense_case(8, 524288, 3), REAL_CLOSED["dense"]),
        (linear_case(6, 33554432, "allinit-allused"), REAL_CLOSED["linear"])])

    # training (phase 15): train_phase resets the counters just before
    # each run of the train path and reads them just after
    trained = train_phase(device, kernels)

    # the vlm and the encoder-decoder (phase 17), after training so the
    # card holds no train state: each run resets the counters just before
    # and reads them just after
    multimodal = multimodal_phase(device, kernels)
    served.update(multimodal)
    served_counts = {k: sum(c[k] for c in served.values()) for k in kernels}
    served.update(trained)

    # the sharded deep copy (phase 18): transfers only, counters 0
    served["sharded"] = sharded_phase(kernels, smi)

    # data parallelism on the mesh's positions (phase 19): each run resets
    # the counters just before and reads them just after
    served["dp"] = dp_phase(kernels, smi)

    # the launch tooling on the mesh's positions (phase 20): the sharded
    # step's and the placed serve's runs each reset the counters just
    # before and read them just after
    served["launch"] = launch_phase(kernels, smi)

    src = "src/repro_torch/kernels/{0}/csrc/{1}.cu"
    rows = [dict(name="gather_tiles", route="cuda",
                 source=src.format("marshal_pack", "gather_tiles"),
                 replaces="src/repro/kernels/marshal_pack/kernel.py:32",
                 launches=launches, **gather)]
    for kname, m, pkg, line in (
            ("rmsnorm", rms, "rmsnorm", "rmsnorm/kernel.py:24"),
            ("flash_attention", flash, "flash_attention",
             "flash_attention/kernel.py:69"),
            ("decode_attention", dec, "decode_attention",
             "decode_attention/kernel.py:65"),
            ("ssd_chunks", ssd, "ssd_scan", "ssd_scan/kernel.py:56")):
        serve_m = m["serve"]
        extra = {k: m[k] for k in ("zamba2", "llama_tp", "zamba2_tp",
                                   "phi3", "seamless_cross", "hd128",
                                   "max_abs_err_vs_split", "grid",
                                   "floor_ms")
                 if k in m}
        rows.append(dict(
            name=kname, route="cuda", source=src.format(pkg, kname),
            replaces=f"src/repro/kernels/{line}",
            launches=served_counts[kname], max_abs_err=m["max_abs_err"],
            ms=serve_m["ms"], plain_ms=serve_m["plain_ms"],
            bound_ms=serve_m["bound_ms"], bound_by=serve_m["bound_by"],
            library_ms=serve_m["library_ms"], shape=serve_m["shape"],
            large=m["large"], **extra,
            launches_by_phase={t: c[kname] for t, c in served.items()}))
    say(smi)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
