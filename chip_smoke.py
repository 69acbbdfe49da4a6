"""End-to-end check of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA device, ``nvcc`` and the
repository's ``src/`` next to this file, and exits non-zero (printing no
result) without them.  Every phase but 3t runs with the kernels' launch
tuner off (their fixed launch shapes), in this process and in every
process it starts (``MADUPITE_OPTIONS``), and every process points the
tuner at ``build/chip_smoke/autotune.json``.  Phases, each of which
raises on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and hold both ELL kernels against
   their plain PyTorch versions on garnet tables ``n=10^6, m=16, K=8`` in
   float32 and float64: max |diff| must be 0 and the argmin identical.
   Kernel, plain version and (SpMV only) ``torch.sparse_csr_tensor @ x``
   are timed with CUDA events (median of 25 after warm-up, each call
   queued behind a spin on the card so that the host's launch time falls
   outside the events: :func:`time_ms`).  Each ELL
   kernel is timed again, and checked bitwise again, on tables of the same
   shapes with local ``idx`` (``idx[s, a, k] = s``: each warp's gathers hit
   one cached sector): the local time against the byte bound is the table
   stream's efficiency, the random time less the local one the cost of the
   random gather, whose 32-byte L2 sector traffic, modelled as one sector
   per slot, is logged beside it.  Then each ELL kernel's registers and spills, read
   from its library's build log (``-Xptxas -v``);
3. the main path at full width, ``garnet n=10^6, m=16, k=8, gamma=0.99``:
   (a) the CLI ``repro_torch.launch.solve ... --method ipi_gmres --atol
   1e-8`` (float64) must exit 0; (b) ``madupite_session({-method mpi,
   -dtype float32, -atol 1e-4}).solve(...)`` must converge.  The launch
   counters are set to 0 just before each of (a) and (b) and read just
   after it, and both kernels must have launched in each; the CLI's value
   vector is checked independently by one plain-version backup on the
   CPU;
   then the same ipi_gmres solve once plain and once under torch.profiler
   (device time by kernel, idle share);
   (3g) the rest of the single-device surface on the same garnet, each
   path with its own launch counts (both ELL kernels must launch in
   each): (a) ``repro_torch.core.io.save_mdp`` writes it in 4 blocks under
   ``build/``, then the CLI ``--load DIR --method ipi_bicgstab --option
   pc_type=jacobi --atol 1e-8 --monitor --ckpt-dir DIR2`` (float64) must
   exit 0, print outer + 1 monitor lines and pass phase 3's independent
   CPU backup check; (b) one Session runs ``ipi_chebyshev``,
   ``ipi_anderson`` and ``ipi_gmres -pc_type bjacobi`` in float32 to
   1e-4, each of which must converge; (c) ``ipi_gmres
   -deterministic_dots`` in float64 must give the CLI's (3a) policy and
   outer count, the value difference logged; (d) 3a's solve stopped at
   ``-max_outer 3`` with ``-checkpoint_dir`` and resumed must give 3a's
   policy and counts, values bitwise equal or within 1e-12 |v|_inf (the
   difference logged); (e) ``ipi_anderson`` float64 with ``-monitor``
   must give equal stream and chunk records; then each solve of (a)-(c)
   on the card's tables, once plain and once under torch.profiler (busy
   time, idle share against the plain run's wall; the Chebyshev, GMRES
   + block-Jacobi and deterministic GMRES solves over their first 20, 3
   and 3 outer steps);
   (3w) the rest of the reference's public surface on the same garnet:
   (a) ``repro_torch.api.MDP.save`` into a temporary directory under
   ``build/`` and ``MDP.from_file`` back, the tables bit for bit 3a's,
   the save and load timed; (b) ``ipi.init_state`` and then
   ``ipi.outer_step`` until the lane stops, with the options of 3a's CLI
   solve: its values bit for bit, its policy, outer and inner counts, and
   its ``ell_backup`` / ``ell_matvec`` launches (counters set to 0 just
   before the loop);
4. GPU vs CPU parity at n=20,000 for vi / mpi / ipi_gmres / ipi_bicgstab
   / ipi_chebyshev / ipi_anderson x mincost / maxreward in float64: same
   policy and counts, values within max(1e-10 |v|_inf, gap bound);
5. the dense path, on ``as_dense()`` of garnet ``n=16,384, m=16, k=8,
   gamma=0.99`` built on the card (P is 17.2 GB of float32):
   (2d) ``dense_backup`` against its plain version in float32 and float64,
   bitwise, timed as in phase 2, beside ``torch.mv(P.view(n*m, n), v)``
   (the cuBLAS product alone, float32 only); (3d) a Session ipi_gmres
   float64 solve to ``1e-8`` and a ``driver.solve`` mpi float32 solve to
   ``1e-4``, each with its own launch counts (``dense_backup`` >= 1, the
   ELL kernels 0), the first certified by one plain-version backup of its
   value vector and held against the ELL solve of the same garnet; (3e)
   the ipi_gmres solve profiled as in phase 3b; (4d) GPU vs CPU parity on
   a fully dense random MDP at n=2,048, m=8 for mpi / ipi_gmres x
   mincost / maxreward in float64;
6. (2q) ``ops.ell_qvalues`` (the SpMV kernel over the ``(n*m, K)`` rows
   plus the ``cost + gamma * pv`` epilogue) on the phase-2 garnet in
   float32 and float64, its launch counts read around those two calls
   (its only path: no solver calls it), each result bitwise equal to the
   plain version; timed beside ``torch.sparse_csr_tensor @ v`` plus the
   same epilogue;
7. (3h) fleets, each path with its launch counts against the unbatched
   solves of the same instances: (a) the CLI ``--batch 4`` seed ensemble
   (garnet ``n=10^6, m=16, k=8``, seeds 0-3: a batched ``idx``,
   ipi_gmres float64 to ``1e-8``) must exit 0, each lane must pass phase
   3's independent CPU backup and give its unbatched solve's policy and
   counts with values within 1e-10 |v|_inf, and ``ell_backup`` and
   ``ell_matvec`` must each launch fewer times than the four unbatched
   solves together; (e) the same fleet on the card's tables, once plain
   and once profiled as in phase 3b, beside the unbatched solves' walls;
   (b) ``Session.solve_fleet`` of a gamma sweep over [0.9, 0.99] (B=4,
   seed 0: one shared ``idx``), mpi float32 to ``1e-4``: every lane bit
   for bit its unbatched solve; (d) ``ell_backup``, ``ell_matvec`` and
   ``ell_qvalues`` at B=4 on the sweep's (shared ``idx``) and the
   ensemble's (batched ``idx``) tables in float32 and float64, bitwise
   against their batched plain versions, timed in both grid orders of
   the lane axis beside four unbatched launches, with the batched byte
   bound; (c) after the dense phases, ``driver.solve_many`` of two
   ``as_dense()`` garnets ``n=8,192, m=16`` (2 x 4.3 GB of P), ipi_gmres
   float64 to ``1e-8``: ``dense_backup`` launched fewer times than in the
   two unbatched solves, each lane certified by the plain dense backup
   with its unbatched solve's policy and counts; then ``dense_backup`` at
   B=2 against its plain version, timed as in (d) in its one grid order
   (lane-slowest);
8. (3m) sharded solves on ``torch.distributed``, after 3h on the phase-2
   garnet: (a) a world of one rank on NCCL in this process (an explicit
   store), ``driver.solve(mesh=, layout="1d")`` and ``"2d"`` (a ``(1, 1)``
   mesh: every collective runs) in f64 ipi_gmres to ``1e-8``, each with
   its launch counts (both ELL kernels), bit for bit the single-device
   solve, which is bit for bit phase 3a's CLI solve; then the three solves
   profiled in turns (single, 1d, 2d): wall, busy and
   idle of each, the collective layer's overhead at world 1; (b)
   ``maze2d(size=1000)`` (n = 10^6, m = 5, banded at 1000), f64 ipi_gmres
   over its first 10 outer steps (its policy iteration takes ~2 x size of
   them) four ways: ``-halo 0``, ``-halo 1000``, ``-comm_overlap on`` and
   ``off``, each with its launch counts, all bitwise equal; then
   ``async_vi -async_sweeps 8`` to ``1e-8``, certified by phase 3's
   independent CPU backup; the group is torn down; (c) ``torchrun
   --nproc-per-node <cards> -m repro_torch.launch.solve -- --instance
   garnet --n 1000000 ... --layout 1d`` as a subprocess (beside 3p (d),
   below) must exit 0, each rank name its own card, and its value vector
   pass phase 3's CPU backup; (d) with two or more cards, (a) and (b) over all of them
   (``torchrun`` of this script's ``--ranks`` mode: 1d and 2d give the
   single solve's policy and counts with values within 1e-10 |v|_inf,
   the maze's four ways bitwise); on one card it says that the
   multi-rank cases ran only in the CPU tests;
   (3n) function-backed MDPs, after 3m (b) on its process group: (a)
   ``MDP.from_generator("garnet", deferred=True, n=750,000, m=16, k=8,
   gamma=0.99, seed=0)`` — one rebuild of every row timed (ms per 10^6
   rows) in chunks of half the chunk rule's rows, of the rule's and of
   all rows, with one chunk's measured transient (the rule's under the
   cap); ``ops.ell_backup_chunk`` (the ``ell_backup`` kernel) on one
   rebuilt chunk of the rule's rows against a value vector of n and
   against four of them with (c)'s gammas over the shared tables, both
   dtypes, bit for bit the plain version on the CPU copies and timed;
   the host's build of the same constructors bit for bit the card's —
   then solved through a ``Session`` with ``-mdp_materialize
   device`` and ``matrix_free``, f64 ``ipi_gmres`` to ``1e-8`` and f32
   ``mpi`` to ``1e-4``: each pair bit for bit (values, policy, counts,
   trace), each solve with its launch counts (matrix-free: the
   materialized solve's ``ell_backup`` launches times the chunks, the
   same ``ell_matvec`` launches), its peak device memory above the
   baseline (``max_memory_allocated``; matrix-free at least the table's
   bytes less the chunk cap below materialized) beside ``table_bytes`` /
   ``operator_bytes``, its wall, and its first outer step profiled
   (busy, idle; the constructors' share of device time as 1 - busy
   materialized / busy matrix-free); the f64 matrix-free values pass
   phase 3's CPU backup over the host's tables; (b) maze2d by
   constructors (size 1000, band 1000), matrix-free under
   ``driver.solve(mesh=<3m's world-1 mesh>, layout="1d")``, f64
   ``ipi_gmres`` over 10 outer steps four ways (``-halo 0`` / ``1000`` x
   ``-comm_overlap on`` / ``off``), each bit for bit the
   device-materialized single solve, with its launch counts; (c)
   ``Session.solve_fleet`` of a matrix-free gamma sweep (B = 2, gamma
   0.9 and 0.99) in f32 ``mpi``: each lane bit for bit its unbatched
   matrix-free solve, one ``ell_backup`` launch a chunk for the lanes,
   fewer than the two solves', walls beside each other;
   (3p) the fleet layouts, after 3n on 3m's world-1 group: (a) 3h's
   B = 4 seed ensemble (the card's tables, f64 ``ipi_gmres`` to ``1e-8``)
   through ``driver.solve_many(mesh=make_fleet_mesh(1, layout=...))``
   under ``fleet`` and ``fleet2d``, each bit for bit 3h (e)'s mesh-less
   fleet with 3h (a)'s ``ell_backup`` / ``ell_matvec`` launches, its wall,
   its collectives by kind and axis (counted around torch.distributed's
   calls, by the ``Axes`` method that issued them) and its profile (busy,
   idle), beside the host time of one fleet gather of a step's flags;
   (b) ``Session.solve_fleet`` over the fleet mesh of 4 deferred garnets
   ``n=10^6`` (3n's family: ``place_function_fleet`` builds each lane's
   block on the card), f32 ``mpi`` to ``1e-4``: the placed tables bit for
   bit the lanes built one by one by 3n's device pipeline, every lane bit
   for bit their mesh-less fleet; (c) ``Session.solve_fleet`` and a
   ``Server`` over the fleet mesh on four garnets of 10^5 / 2 x 10^5
   states (f64 ``ipi_gmres``), every request held to its solo solve
   (policy and counts exact, values within 1e-10 |v|_inf); after the
   group is torn down, beside 3m (c), (d) ``torchrun --nproc-per-node
   <cards> -m repro_torch.launch.solve -- ... --batch 4 --layout fleet
   --fleet <cards>`` must exit 0 with each lane held to 3h's fleet (bit
   for bit on one card), and beside it ``python -m
   repro_torch.launch.elastic --device cuda --batch 4`` must resume its
   fleet-layout checkpoint (on one card: with no mesh) to ``|dv| <
   1e-9``; after 3h (c) the dense fleet under
   ``fleet`` on a world-1 group of its own, bit for bit with the same
   ``dense_backup`` launches;
   (3s) ``-method auto`` and solve serving, after 3n on the phase-2
   garnet: (a) the CLI ``--method auto --atol 1e-8`` (float64) must exit
   0, print the probe's profile and the choice, choose what
   ``tests/test_torch_adaptive.py`` fixes for the garnet family (``mpi``),
   and pass phase 3's independent CPU backup; the probe's launches are
   counted alone (``probe`` on the same tables) beside the solve's, the
   auto solve's wall beside phase 3a's fixed-method one; a Session's
   second auto solve of the family hits its choice cache: no probe, the
   launches and bits of a plain solve of the chosen method; (b)
   ``-adapt_on_stagnation`` on ``chain_walk(10^6, gamma=0.99)`` with
   ``ipi_chebyshev`` (safeguard off, ``-divtol 10``, ``-atol 1e-3``,
   float64): the swap is logged, the resumed solve converges and passes
   the CPU backup; (c) ``repro_torch.launch.serve`` in this process on a
   JSONL stream of 6 garnets (``n`` of 500,000 or 1,000,000, ``m=16,
   k=8``, distinct seeds), a matrix-free gamma sweep of 2 deferred
   garnets (``n=50,000``, gamma 0.9-0.95, admitted by operator bytes)
   and 2 dense garnets (``as_dense()`` of ``n=8,192``), Poisson arrivals
   at 20 req/s dealt to 4 client threads, ``-method auto``, ``-serve_batch_window
   0.05``, ``-serve_max_batch 4``: it must exit 0 with every request
   converged and print each request's dispatch, slot and latency, each
   dispatch's kernel launches, p50 / p95 latency, throughput and the
   program-cache counters; the same stream is served again on the same
   MDPs under the profiler (the serving window's busy and idle share);
   one request of each bucket kind is certified by the CPU backup and held
   to a solo ``driver.solve`` of its bucket's method on the card
   (policy and counts exact, values within 1e-9 |v|_inf); three served
   10^6 lanes are timed as a fleet unpadded and at a padded slot of 4
   (old, new, new, old; the same launches); (d) in-process, a request over
   ``-serve_max_states`` (materialized) and one over its byte budget
   (matrix-free) raise ``AdmissionError("too_large")``, and ``drain``
   completes the work in flight;
   (3t) the kernel options and the launch tuner: (a) where the tables
   live — the phase-2 garnet after 3s, 3h (d)'s B = 4 fleets, 3n (a)'s
   shared-table chunk (B = 4), phase 5's P — every candidate launch
   shape (``ell_backup`` / ``ell_matvec``: 128, 256, 512 threads a CTA,
   for a fleet each in both grid orders; ``dense_backup``: 4, 8, 16 warps)
   bit for bit the plain version in float32 and float64, each timed
   (median of 10, as ``time_ms``), beside the default's time and the
   winner the dispatch picks with the tuner on; after 3s, (b) 3a's CLI
   solve with a fresh cache and tuning on: 3a's policy, counts, value
   bits and launches, the tune launches and the tuning's share of the
   wall; (c) the same CLI in a second process on the same file: 0 tune
   launches, the same shapes, the file unchanged; (d) ``driver.solve``
   with ``impl="torch"`` on the card: no hand kernel launched, 3a's bits;
   (e) the CLI with ``--device cpu --option kernel_impl=cuda`` exits
   non-zero; (f) ``examples/torch/quickstart.py`` and
   ``epidemic_control.py``, side by side, exit 0 on the card with both
   ELL kernels launched;
9. the LM serving path, minitron-8b (32 layers, d_model 4096, 32 query /
   8 KV heads, d_head 128, vocab 256,000, bf16, random weights from a
   seed):
   (2f) ``flash_attention`` against its plain version at ``B=4, T=S=2048``
   causal in bf16, at minitron-8b's heads and at stablelm-3b's (d=80,
   MHA) and granite-34b's (MQA) head layouts, within one bf16 ulp; timed
   beside ``scaled_dot_product_attention(..., enable_gqa=True)`` (timed
   only: the port never calls it), with the kernel's TFLOP/s and share of
   its operation bound; then the bf16 kernel's registers, shared memory,
   spills and SASS tensor-core and copy instructions, read from the
   library that ran (it fails without a tensor-core instruction, or if
   ptxas serialized the wgmma products);
   (3f) the CLI ``repro_torch.launch.serve_lm --arch minitron-8b --batch 4
   --prompt-len 2048 --gen 16`` must exit 0 with ``flash_attention``
   launched once per layer (32) and no other kernel; then prefill over
   2048 tokens (32 launches) plus one decode step (0 launches) must give
   the logits of a prefill over 2049 tokens within 5% of their largest
   magnitude (bf16 through 32 layers); then that decode step and the
   prefill profiled as in phase 3b;
   (3v) the CLI's run of 3f again in the script (seed 0, batch 4, prompt
   2048, 16 greedy tokens), unplaced and then placed on a ``(1, 1)``
   ``(data, model)`` mesh over a world-1 NCCL group (``place`` by
   ``infer_param_specs``, the cache by ``place_cache``): tokens and every
   step's logits bit for bit, 32 flash launches in each prefill, the
   placed prefill's and decode step's collectives by kind (the dry run's
   counter, ``launch/dryrun.py``), both runs' prefill and decode step
   profiled beside 3f's; (b) one full-size dry-run cell (stablelm-3b
   ``train_4k`` at 256 ranks of the fake backend, ``python -m
   repro_torch.launch.dryrun``) runs on the host beside phases 3m-3p and
   its record is logged;
   (4f) GPU vs CPU parity: minitron-8b at full width but 2 layers, float32,
   the same weights on both, prompt 256, batch 2, 8 greedy tokens: logits
   within 1e-4 of their largest magnitude at every step, tokens equal;
   2f also holds the kernel at the other families' prefill layouts, B=4
   in bf16 within one bf16 ulp and beside SDPA: olmoe-1b-7b (16 / 16
   heads, d 128, causal, 2048), zamba2-1.2b's shared block (32 / 32, d 64,
   causal, 2048), llava-next-34b (56 / 8, d 128, causal, 2,880 patches +
   512 text = 3,392) and whisper-base's encoder (8 / 8, d 64, non-causal
   over 1,500 frames); its resources also at d 64 (DC=4);
   (3l) the other families at their published widths, batch 4, 16 greedy
   tokens: olmoe-1b-7b, mamba2-130m, zamba2-1.2b (prompt 2048) and
   whisper-base (prompt 448, its decoder context; frames (4, 1500, 512))
   through the ``serve_lm`` CLI, which must exit 0 with ``flash_attention``
   launched once a prefill's attention layer (16, 0, 6, 6 + 6) and no
   other kernel; llava-next-34b cut to 16 layers (512 tokens after 2,880
   patch embeddings) and arctic-480b cut to 1 layer (prompt 2048) built in
   the script (the CLI has no depth flag, as the reference's has none);
   then for each, built in the script from a seed, prefill (timed, its
   launches counted: as the CLI's) and 15 greedy decode steps (none
   launched), every logit finite; a warm prefill and the last decode step
   profiled as in phase 3b; then one decode step fed token t + 1 of a
   prompt of t + 1, whose prefill must give its logits within 5% of
   their largest magnitude (bf16); for the MoE families that check as
   served is logged only (slot-major capacity makes a prefill over t + 1
   another function, in the reference too: ``serve_family``), and the
   one that decides runs the same weights with dropless groups of 256 /
   top_k tokens, on one row;
   (4l) GPU vs CPU parity as 4f at full width and least depth, float32,
   batch 1, prompt 64, 8 greedy tokens: olmoe-1b-7b and mamba2-130m at 2
   layers, zamba2-1.2b at 6 (one shared site), whisper-base at 2 + 2 with
   1,500 frames;
   (3r) LM training, through no hand-written kernel (the reference trains
   through no TPU kernel; the flash kernel has no backward): (a) the CLI
   ``repro_torch.launch.train --arch stablelm-3b --steps 4 --batch 4
   --seq 2048 --microbatches 2`` must exit 0 with every loss and grad norm
   finite and no kernel launched; (b) a warm train step of stablelm-3b
   built in the script, its two halves (``accumulate_grads``,
   ``apply_updates``) counted: no kernel launched, every attention
   projection's gradient non-zero and finite, ``max_memory_allocated``
   beside the bytes ``launch/specs.py`` reckons from the meta device; then
   a step timed and profiled as in phase 3b (tokens/s, busy, idle, top);
   (c) two steps (the second timed) of mamba2-130m and whisper-base
   uncut, olmoe-1b-7b at 2
   of 16 layers (aux losses finite and non-zero), zamba2-1.2b at 6 (one
   shared site), llava-next-34b at 2 (2 x (2,880 patches + 512 tokens)),
   and one Adafactor step of stablelm-3b at 2 layers (its factored second
   moment reached); arctic-480b's training is held on the CPU only (one
   layer's weights, f32 masters and gradients pass 80 GB); (d) the CLI's
   resume at the smoke config: 4 steps straight against 2 then 2 resumed,
   the checkpoints bit for bit; (e) the sharded trainer on a world-1
   process group of its own (NCCL, in this process): stablelm-3b uncut
   from (b)'s seed, placed on a ``(1, 1)`` ``(data, model)`` mesh by the
   reference's specs (``infer_param_specs``, ``place``), (b)'s batch and
   step index: loss, grad norm and three updated weights (a layer's
   ``wq`` and ``w_down``, the final norm) bit for bit (b)'s first step
   (every collective over one rank is an identity), no kernel launched;
   then a step's collectives by kind (a dispatch mode over the
   ``c10d`` / ``_c10d_functional`` ops), a step timed and profiled, the
   peak beside ``launch/specs.rank_bytes``; then the CLI under ``torchrun
   --nproc-per-node 1`` (its ``main`` through this script's
   ``--train-cli`` mode, which reports the rank's launches; 4r runs here
   meanwhile) resumes (d)'s 2-step checkpoint: its losses and its step-4 checkpoint bit for bit
   (d)'s straight run; with at least 2 cards the same step at world 2
   (``--train-ranks``) against (b)'s within the CPU tests' tolerances;
   (4r) GPU vs CPU: stablelm-3b and olmoe-1b-7b at full width and 1
   layer, float32 with an f32 accumulator, batch 2, seq 64, 2
   microbatches, one Adam step from the same weights and batch: loss, aux
   losses and grad norm within 1e-4 relative, every gradient and every
   updated weight within 1e-4 of its largest magnitude;
10. one JSON ``kernels`` line, then the ``ok`` line last.  An ELL kernel's
   ``launches`` is its count in the CLI's ipi_gmres solve (a), the
   default method; ``dense_backup``'s is its count in the dense ipi_gmres
   solve (3d); ``ell_qvalues``'s its phase-2q count; ``flash_attention``'s
   its count in the serve_lm CLI run (3f), and its ``launches_by_path``
   3v's and 3l's runs too, and 3r's: ``train`` (b), ``train_cli`` (a), each
   (c) step, ``train_sharded`` and ``train_cli_torchrun`` (e), all 0.  ``launches_by_path`` gives
   each path's counts (the ELL kernels' include phase 3g's and 3h's
   paths).  Rows 1-4 carry ``batched``: phase 3h (d)'s rows, keyed by
   ``idx`` kind and dtype; the ELL kernels' also carry phase 3m (a)'s
   ``sharded_1d`` / ``sharded_2d`` counts and phase 3n's ``mf_*`` paths;
   rows 1-3 also phase 3s's ``auto_cli``, ``auto_swap`` and ``serve``,
   and phase 3p's ``fleet_*`` paths; rows 1-3 carry ``launch_shapes``,
   phase 3t (a)'s rows.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shlex
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and non-tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12,
              torch.bfloat16: 989e12}    # bf16: dense tensor-core peak

N, M, K, GAMMA = 1_000_000, 16, 8, 0.99
DN, DM, DK = 16_384, 16, 8          # the dense phases' garnet
REPS, WARMUP = 25, 3
SPIN_CYCLES = 1_000_000             # queued ahead of each timed call
PLAIN_DENSE_REPS = 5                # the dense plain version is slow
ELL_KERNELS = ("ell_backup", "ell_matvec")
FLEET_B = 4                         # phase 3h's ELL fleets
MF_N = 750_000                      # phase 3n's garnet: 3 chunks
MF_SWEEP_B = 2                      # phase 3n (c)'s matrix-free sweep
FLEET_SWEEP = (0.9, 0.99)           # (b)'s gamma sweep, the CLI's LO HI
DFN, DENSE_FLEET_B = 8_192, 2       # (c)'s dense garnets: 2 x 4.3 GB of P
MAZE_SIZE = 1000                    # phase 3m (b): maze2d, n = 10^6, m = 5
MAZE_OUTER = 10                     # (b)'s ipi_gmres trajectory (the
                                    # maze's PI takes ~2 x size outer steps)
LM_ARCH = "minitron-8b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 16
# (name, H, KV, d, T = S, causal) at B=4: minitron-8b (the row's main
# case), stablelm-3b, granite-34b; then the other families' prefills
FLASH_CASES = (("minitron-8b", 32, 8, 128, 2048, True),
               ("stablelm-3b", 32, 32, 80, 2048, True),
               ("granite-34b", 48, 1, 128, 2048, True),
               ("olmoe-1b-7b", 16, 16, 128, 2048, True),
               ("zamba2-1.2b", 32, 32, 64, 2048, True),
               ("llava-next-34b", 56, 8, 128, 512 + 2880, True),
               ("whisper-base-encoder", 8, 8, 64, 1500, False))
PLAIN_FLASH_REPS = 5                # the plain scan is slow
# phase 3v: one full-size dry-run cell on the host, beside 3m-3p
DRYRUN_CELL = ("stablelm-3b", "train_4k", "pod")
DECODE_TOL = 0.05    # decode vs prefill logits, of max |logit| (bf16)
PARITY_TOL = 1e-4    # GPU vs CPU logits, of max |logit| (float32)
PARITY_BATCH, PARITY_PROMPT, PARITY_GEN = 2, 256, 8
# phase 3l: (arch, prompt, depth cut or None for the full depth through
# the serve_lm CLI); batch LM_BATCH, LM_GEN greedy tokens
FAMILY_RUNS = (("olmoe-1b-7b", 2048, None), ("mamba2-130m", 2048, None),
               ("zamba2-1.2b", 2048, None), ("whisper-base", 448, None),
               ("llava-next-34b", 512, 16), ("arctic-480b", 2048, 1))
# phase 4l: (arch, depth overrides); batch 1, prompt 64, PARITY_GEN tokens
FAMILY_PARITY = (("olmoe-1b-7b", dict(n_layers=2)),
                 ("mamba2-130m", dict(n_layers=2)),
                 ("zamba2-1.2b", dict(n_layers=6)),
                 ("whisper-base", dict(n_layers=2, encoder_layers=2)))
FAMILY_PARITY_BATCH, FAMILY_PARITY_PROMPT = 1, 64
# phase 3g profiles these long solves over their first outer steps only
# (tens of thousands of small ops make torch.profiler's tables slow)
PROFILE_PREFIX = {"session_ipi_chebyshev": 20,
                  "session_ipi_gmres_bjacobi": 3,
                  "driver_ipi_gmres_deterministic": 3}


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One progress line, with the seconds since the script started."""
    print(f"{msg}  [+{time.perf_counter() - _T0:.1f}s]", flush=True)


def time_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Median device time of one call, by CUDA events around each call.
    Each call is queued behind a spin of about half a millisecond on the
    card, so that the host's launch time (tens of microseconds through a
    wrapper) falls outside the events where the call's own work is
    shorter than the spin."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, flops: int, dtype: torch.dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    ia = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(a.view(ia), b.view(ia))


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a.double() - b.double())))


def ell_as_csr(idx: torch.Tensor, val: torch.Tensor, n_cols: int,
               dt: torch.dtype) -> torch.Tensor:
    """The (rows, K) ELL rows as a CSR matrix of ``dt`` on the card, for
    PyTorch's sparse product: the library yardstick of the SpMV."""
    rows, k = idx.shape
    crow = torch.arange(0, rows * k + 1, k, dtype=torch.int32,
                        device="cuda")
    return torch.sparse_csr_tensor(crow, idx.reshape(-1),
                                   val.reshape(-1).to(dt),
                                   size=(rows, n_cols), check_invariants=False)


def kernel_checks(mdp, gen: np.random.Generator) -> dict:
    """Phase 2: each kernel against its plain version, timed."""
    from repro_torch.core import bellman
    from repro_torch.core.comm import Axes
    from repro_torch.kernels import bellman_ell, ref, spmv_ell

    idx, val, cost = mdp.idx, mdp.val, mdp.cost
    n, m, k = idx.shape
    local_idx = torch.arange(n, dtype=torch.int32, device="cuda") \
        .view(n, 1, 1).expand(n, m, k).contiguous()
    out = {"ell_backup": {}, "ell_matvec": {}}
    for dt in (torch.float32, torch.float64):
        name = str(dt).replace("torch.", "")
        v = torch.from_numpy(gen.random(n) * 50.0).to("cuda", dt)
        got_v, got_pi = bellman_ell.ell_backup(idx, val, cost, GAMMA, v)
        want_v, want_pi = ref.ell_backup(idx, val, cost, GAMMA, v)
        torch.cuda.synchronize()
        if not (bits_equal(got_v, want_v) and torch.equal(got_pi, want_pi)):
            raise AssertionError(
                f"ell_backup {name}: kernel != plain version (max |diff| "
                f"{max_abs_diff(got_v, want_v)}, argmin mismatches "
                f"{int((got_pi != want_pi).sum())})")
        nbytes = (idx.nbytes + val.nbytes + cost.nbytes + v.nbytes
                  + got_v.nbytes + got_pi.nbytes)
        flops = n * m * (2 * k + 3)
        b_ms, b_by = bound_ms(nbytes, flops, dt)
        ms = time_ms(lambda: bellman_ell.ell_backup(idx, val, cost, GAMMA,
                                                    v))
        out["ell_backup"][name] = dict(
            max_abs_err=max_abs_diff(got_v, want_v), ms=ms,
            plain_ms=time_ms(lambda: ref.ell_backup(idx, val, cost, GAMMA,
                                                    v)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            bytes=nbytes, flops=flops,
            **gather_split("ell_backup", name, local_idx, val, cost, v,
                           ms, b_ms))

        rows = bellman.policy_rows(mdp, got_pi, Axes())
        x = torch.from_numpy(gen.random(n) * 50.0).to("cuda", dt)
        got_y = spmv_ell.ell_matvec(rows.idx, rows.val, x)
        want_y = ref.ell_matvec(rows.idx, rows.val, x)
        torch.cuda.synchronize()
        if not bits_equal(got_y, want_y):
            raise AssertionError(f"ell_matvec {name}: kernel != plain "
                                 f"version (max |diff| "
                                 f"{max_abs_diff(got_y, want_y)})")
        csr = ell_as_csr(rows.idx, rows.val, n, dt)
        lib_y = csr @ x
        nbytes = rows.idx.nbytes + rows.val.nbytes + x.nbytes + got_y.nbytes
        flops = 2 * n * k
        b_ms, b_by = bound_ms(nbytes, flops, dt)
        ms = time_ms(lambda: spmv_ell.ell_matvec(rows.idx, rows.val, x))
        out["ell_matvec"][name] = dict(
            max_abs_err=max_abs_diff(got_y, want_y), ms=ms,
            plain_ms=time_ms(lambda: ref.ell_matvec(rows.idx, rows.val, x)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: csr @ x),
            library_max_abs_diff=max_abs_diff(lib_y, want_y),
            bytes=nbytes, flops=flops,
            **gather_split("ell_matvec", name, local_idx[:, 0].contiguous(),
                           rows.val, None, x, ms, b_ms))
        log(f"[phase2] {name}: backup {out['ell_backup'][name]['ms']:.4f} "
            f"ms (plain {out['ell_backup'][name]['plain_ms']:.4f}, bound "
            f"{out['ell_backup'][name]['bound_ms']:.4f}); spmv "
            f"{out['ell_matvec'][name]['ms']:.4f} ms (plain "
            f"{out['ell_matvec'][name]['plain_ms']:.4f}, csr "
            f"{out['ell_matvec'][name]['library_ms']:.4f}, bound "
            f"{out['ell_matvec'][name]['bound_ms']:.4f}); bitwise equal")
    return out


def gather_split(kernel: str, name: str, idx, val, cost, v, ms: float,
                 bound: float) -> dict:
    """An ELL kernel on tables of the same shapes with local ``idx``
    (``idx[s, ...] = s``), checked bitwise against its plain version and
    timed: the stream alone, without the random gather.  The log gives
    beside it the random run's gathers per second (``ms`` is its time) and
    their L2 sector traffic, modelled as one 32-byte sector a gather; only
    the measured local time is returned."""
    from repro_torch.kernels import bellman_ell, ref, spmv_ell

    if kernel == "ell_backup":
        def run():
            return bellman_ell.ell_backup(idx, val, cost, GAMMA, v)
        want = ref.ell_backup(idx, val, cost, GAMMA, v)
    else:
        def run():
            return (spmv_ell.ell_matvec(idx, val, v),)
        want = (ref.ell_matvec(idx, val, v),)
    got = run()
    torch.cuda.synchronize()
    if not all(bits_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{kernel} {name} on local idx: kernel != "
                             f"plain version")
    local = time_ms(run)
    gathers = idx.numel()
    sectors = gathers * 32          # modelled: one 32-byte sector a gather
    rate = gathers / (ms / 1e3)
    log(f"[phase2] {kernel} {name} local idx: {local:.4f} ms, "
        f"{bound / local:.1%} of the byte bound; random: {ms:.4f} ms, "
        f"{ms - local:.4f} ms more for {gathers / 1e6:.0f} M gathers "
        f"({sectors / 1e9:.3f} GB of L2 sectors, modelled), "
        f"{rate / 1e9:.1f} G gathers/s")
    return dict(local_ms=local)


def ptxas_entries(build_log: str) -> dict:
    """Registers and spill bytes of each entry function in an ``-Xptxas
    -v`` build log, by mangled name."""
    out = {}
    for block in build_log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if not (regs and spill):
            raise AssertionError(f"ptxas printed no registers or spills "
                                 f"for {name}")
        out[name] = dict(registers=int(regs.group(1)),
                         spill_store_bytes=int(spill.group(1)),
                         spill_load_bytes=int(spill.group(2)))
    return out


def ell_report(libs: dict) -> dict:
    """Each ELL kernel instantiation's registers and spills, from its
    library's build log."""
    from repro_torch.kernels import bellman_ell, build, spmv_ell

    report = {}
    for name, source in (("ell_backup", bellman_ell.SOURCE),
                         ("ell_matvec", spmv_ell.SOURCE)):
        entries = ptxas_entries(build.build_log(libs[source]).read_text())
        report[name] = {}
        for mangled, row in entries.items():
            acc, vec = re.search(r"_kernelI([fd])Li(\d+)E", mangled).groups()
            acc = {"f": "float", "d": "double"}[acc]
            report[name][f"{acc}, vec {vec}"] = row
        if len(report[name]) != 4:
            raise AssertionError(f"{name}: expected 4 instantiations in the "
                                 f"build log, got {sorted(report[name])}")
    log(f"[phase2] ELL kernel resources: {json.dumps(report)}")
    return report


def require_launched(path: str, launches: dict, names) -> None:
    """Every kernel in ``names`` launched on ``path``, and no other."""
    if any(launches[k] < 1 for k in names) or \
            any(c for k, c in launches.items() if k not in names):
        raise AssertionError(f"{path}: expected launches of exactly "
                             f"{sorted(names)}, got {launches}")


def main_path(mdp) -> dict:
    """Phase 3: the CLI (f64 ipi_gmres) and a Session (f32 mpi) at full
    width, each with its own launch counts, then an independent CPU check
    of the CLI's value vector."""
    from repro_torch.api import MDP, madupite_session
    from repro_torch.kernels import ops
    from repro_torch.launch import solve as cli

    OUT.mkdir(parents=True, exist_ok=True)
    v_path, pi_path = OUT / "cli_v.npy", OUT / "cli_pi.npy"
    stats_path = OUT / "cli_stats.jsonl"
    stats_path.unlink(missing_ok=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(["--instance", "garnet", "--n", str(N), "--m", str(M),
                   "--k", str(K), "--gamma", str(GAMMA),
                   "--method", "ipi_gmres", "--atol", "1e-8",
                   "--option", f"file_cost={v_path}",
                   "--option", f"file_policy={pi_path}",
                   "--option", f"file_stats={stats_path}"])
    t_cli = time.perf_counter() - t0
    cli_launches = ops.launch_counts()
    if rc != 0:
        raise AssertionError(f"CLI ipi_gmres exited {rc}")
    require_launched("CLI ipi_gmres", cli_launches, ELL_KERNELS)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with madupite_session({"-method": "mpi", "-dtype": "float32",
                           "-atol": 1e-4}) as s:
        r = s.solve(MDP(mdp))
    torch.cuda.synchronize()
    t_sess = time.perf_counter() - t0
    sess_launches = ops.launch_counts()
    if not r.converged:
        raise AssertionError(f"Session mpi float32 did not converge: "
                             f"{r.summary()}")
    require_launched("Session mpi", sess_launches, ELL_KERNELS)
    log(f"[phase3] session mpi f32: {r.summary()} wall={t_sess:.2f}s; "
        f"launches {sess_launches}")

    v = np.load(v_path)
    pi = np.load(pi_path)
    res = certify_on_cpu(mdp, v, pi, "independent CPU backup")
    log(f"[phase3] CLI wall={t_cli:.2f}s; independent CPU residual "
        f"{res:.3e} <= 1e-8; launches {cli_launches}")
    cli_entry = read_stats(stats_path)
    cli_solve = cli_entry["solves"][0]
    launches = {"cli_ipi_gmres": cli_launches, "session_mpi": sess_launches}
    return dict(launches=launches, cli_wall_s=t_cli, session_wall_s=t_sess,
                cli_solve_wall_s=cli_entry["wall_s"],
                cli_outer=cli_solve["outer_iterations"],
                cli_inner=cli_solve["inner_iterations"], cli_v=v,
                cli_pi=pi, session_outer=r.outer_iterations,
                session_inner=r.inner_iterations, cpu_residual=res)


def certify_on_cpu(mdp, v: np.ndarray, pi: np.ndarray, what: str,
                   atol: float = 1e-8) -> float:
    """Phase 3's independent check of a float64 value vector: one
    plain-version backup on the CPU must give ``||Tv - v||_inf <= atol``
    (plus 16 ulps of ``|v|_inf``) and the solve's greedy policy."""
    from repro_torch.kernels import ref

    if v.shape != (mdp.n_global,) or v.dtype != np.float64 \
            or not np.isfinite(v).all():
        raise AssertionError(f"{what}: value vector shape {v.shape} dtype "
                             f"{v.dtype}, finite={np.isfinite(v).all()}")
    host = mdp.to("cpu")
    tv, tpi = ref.ell_backup(host.idx, host.val, host.cost, mdp.gamma,
                             torch.from_numpy(v))
    res = float(torch.max(torch.abs(tv - torch.from_numpy(v))))
    slack = 16 * np.finfo(np.float64).eps * float(np.abs(v).max())
    if not res <= atol + slack:
        raise AssertionError(f"{what}: ||Tv - v||_inf = {res} > {atol}")
    if not np.array_equal(tpi.numpy(), pi):
        raise AssertionError(f"{what}: greedy policy differs from the "
                             f"solve's")
    return res


def read_stats(path: Path) -> dict:
    """The last entry of a ``-file_stats`` jsonl file."""
    return json.loads(path.read_text().splitlines()[-1])


class _Tee(io.TextIOBase):
    """Standard output that is also kept, to count what a CLI printed."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def run_cli(main, argv) -> tuple[int, str]:
    """``main(argv)`` in this process; its exit code and what it printed
    (still printed)."""
    tee, saved = _Tee(sys.stdout), sys.stdout
    sys.stdout = tee
    try:
        rc = main(argv)
    finally:
        sys.stdout = saved
    return rc, tee.kept.getvalue()


def run_beside(argv, env=None, beside=None, timeout: float = 900):
    """``argv`` in a process session of its own while ``beside()`` runs
    here (the host is mostly idle cores and the card mostly idle time, so
    two such paths take little longer than one): the completed process,
    its wall and ``beside()``'s result.  Its output goes to files, so it
    never waits on a full pipe; it and its children are killed if either
    side fails."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as fo, \
            tempfile.TemporaryFile("w+") as fe:
        proc = subprocess.Popen(argv, env=env, stdout=fo, stderr=fe,
                                text=True, start_new_session=True)
        try:
            got = beside() if beside is not None else None
            proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        wall = time.perf_counter() - t0
        fo.seek(0)
        fe.seek(0)
        done = subprocess.CompletedProcess(argv, proc.returncode, fo.read(),
                                           fe.read())
    return done, wall, got


def other_paths(mdp, main: dict) -> dict:
    """Phase 3g: the rest of the single-device surface on the phase-2
    garnet, each path with its own launch counts (both ELL kernels in
    every one) and wall time; then each solve's device busy time."""
    from repro_torch.api import MDP, Options, madupite_session
    from repro_torch.core import driver, io as core_io
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.kernels import ops
    from repro_torch.launch import solve as cli

    launches, rows, profiled = {}, {}, {}

    def drive(name: str, fn):
        """``fn()`` with the launch counters set to 0 just before it and
        read just after; both ELL kernels must have launched."""
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = ops.launch_counts()
        require_launched(name, launches[name], ELL_KERNELS)
        return out, wall

    # (a) io.save_mdp in 4 blocks, then the CLI: --load, BiCGStab + Jacobi,
    # --monitor, --ckpt-dir, float64 to 1e-8
    mdp_dir, ck_dir = OUT / "garnet_blocks", OUT / "ckpt_3g_cli"
    for d in (mdp_dir, ck_dir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    core_io.save_mdp(str(mdp_dir), mdp, n_blocks=4)
    t_save = time.perf_counter() - t0
    v_path, pi_path = OUT / "cli_3g_v.npy", OUT / "cli_3g_pi.npy"
    stats_path = OUT / "cli_3g_stats.jsonl"
    stats_path.unlink(missing_ok=True)
    argv = ["--load", str(mdp_dir), "--method", "ipi_bicgstab",
            "--option", "pc_type=jacobi", "--atol", "1e-8", "--monitor",
            "--ckpt-dir", str(ck_dir), "--option", f"file_cost={v_path}",
            "--option", f"file_policy={pi_path}",
            "--option", f"file_stats={stats_path}"]
    (rc, printed), t_cli = drive("cli_load_bicgstab_jacobi",
                                 lambda: run_cli(cli.main, argv))
    if rc != 0:
        raise AssertionError(f"CLI --load ipi_bicgstab exited {rc}")
    solve = read_stats(stats_path)["solves"][0]
    outer, n_lines = solve["outer_iterations"], printed.count("[monitor] k=")
    if n_lines != outer + 1:
        raise AssertionError(f"CLI --monitor printed {n_lines} records for "
                             f"{outer} outer iterations")
    res = certify_on_cpu(mdp, np.load(v_path), np.load(pi_path),
                         "3g(a) independent CPU backup")
    if not sorted(p.name for p in ck_dir.iterdir()):
        raise AssertionError("CLI --ckpt-dir wrote no checkpoint")
    rows["cli_load_bicgstab_jacobi"] = dict(
        outer=outer, inner=solve["inner_iterations"], wall_s=t_cli,
        save_s=t_save, monitor_lines=n_lines, cpu_residual=res)
    log(f"[phase3g] (a) save_mdp 4 blocks {t_save:.2f}s; CLI --load "
        f"ipi_bicgstab pc=jacobi f64: outer={outer} inner="
        f"{solve['inner_iterations']} wall={t_cli:.2f}s, {n_lines} monitor "
        f"lines, CPU residual {res:.3e}; launches "
        f"{launches['cli_load_bicgstab_jacobi']}")
    opts_a = Options({"-method": "ipi_bicgstab", "-pc_type": "jacobi",
                      "-dtype": "float64", "-atol": 1e-8,
                      "-max_outer": 2000}).to_ipi()
    loaded = core_io.load_mdp(str(mdp_dir)).to("cuda")
    profiled["cli_load_bicgstab_jacobi"] = \
        lambda: driver.solve(loaded, opts_a, device="cuda")

    # (b) one Session, three methods, float32 to 1e-4
    with madupite_session({"-dtype": "float32", "-atol": 1e-4}) as s:
        for method, extra in (("ipi_chebyshev", {}), ("ipi_anderson", {}),
                              ("ipi_gmres", {"pc_type": "bjacobi"})):
            name = f"session_{method}" + (f"_{extra['pc_type']}"
                                          if extra else "")
            r, wall = drive(name, lambda: s.solve(MDP(mdp), method=method,
                                                  **extra))
            if not r.converged:
                raise AssertionError(f"{name} did not converge: "
                                     f"{r.summary()}")
            rows[name] = dict(outer=r.outer_iterations,
                              inner=r.inner_iterations, wall_s=wall)
            log(f"[phase3g] (b) {name} f32: {r.summary()} wall={wall:.2f}s;"
                f" launches {launches[name]}")
            opts_b = IPIOptions(method=method, dtype="float32", atol=1e-4,
                                max_outer=PROFILE_PREFIX.get(name, 500),
                                **extra)
            profiled[name] = lambda o=opts_b: driver.solve(mdp, o,
                                                           device="cuda")

    # (c) deterministic GMRES, float64: phase 3a's policy and outer count
    opts_c = IPIOptions(method="ipi_gmres", dtype="float64", atol=1e-8,
                        max_outer=2000, deterministic_dots=True)
    rdet, wall = drive("driver_ipi_gmres_deterministic",
                       lambda: driver.solve(mdp, opts_c, device="cuda"))
    dv = float(np.abs(rdet.v - main["cli_v"]).max())
    if not (rdet.converged and np.array_equal(rdet.policy, main["cli_pi"])
            and rdet.outer_iterations == main["cli_outer"]):
        raise AssertionError(f"deterministic GMRES: {rdet.summary()} against "
                             f"3a's outer={main['cli_outer']} (policies "
                             f"equal: {np.array_equal(rdet.policy, main['cli_pi'])})")
    rows["driver_ipi_gmres_deterministic"] = dict(
        outer=rdet.outer_iterations, inner=rdet.inner_iterations,
        wall_s=wall, max_abs_dv_vs_3a=dv,
        inner_3a=main["cli_inner"])
    log(f"[phase3g] (c) ipi_gmres deterministic_dots f64: {rdet.summary()} "
        f"wall={wall:.2f}s; 3a's policy and outer count; max |v - v_3a| "
        f"{dv:.3e} (3a inner {main['cli_inner']}); launches "
        f"{launches['driver_ipi_gmres_deterministic']}")
    opts_p = IPIOptions(method="ipi_gmres", dtype="float64", atol=1e-8,
                        deterministic_dots=True, max_outer=PROFILE_PREFIX[
                            "driver_ipi_gmres_deterministic"])
    profiled["driver_ipi_gmres_deterministic"] = \
        lambda: driver.solve(mdp, opts_p, device="cuda")

    # (d) phase 3a's solve stopped at -max_outer 3 with -checkpoint_dir,
    # then resumed
    ck = OUT / "ckpt_3g_session"
    shutil.rmtree(ck, ignore_errors=True)
    common = {"-method": "ipi_gmres", "-dtype": "float64", "-atol": 1e-8,
              "-max_outer": 2000, "-checkpoint_dir": str(ck)}

    def stop_and_resume():
        with madupite_session({**common, "-max_outer": 3}) as s:
            part = s.solve(MDP(mdp))
        with madupite_session(common) as s:
            return part, s.solve(MDP(mdp))

    (part, whole), wall = drive("session_ipi_gmres_resumed", stop_and_resume)
    dv = float(np.abs(whole.v - main["cli_v"]).max())
    bitwise = bool(np.array_equal(whole.v.view(np.int64),
                                  main["cli_v"].view(np.int64)))
    tol = 1e-12 * float(np.abs(main["cli_v"]).max())
    if not (part.outer_iterations == 3 and whole.converged
            and np.array_equal(whole.policy, main["cli_pi"])
            and (whole.outer_iterations, whole.inner_iterations)
            == (main["cli_outer"], main["cli_inner"]) and dv <= tol):
        raise AssertionError(f"resumed solve {whole.summary()} against 3a's "
                             f"outer={main['cli_outer']} inner="
                             f"{main['cli_inner']}, max |dv| {dv} > {tol}")
    rows["session_ipi_gmres_resumed"] = dict(
        outer=whole.outer_iterations, inner=whole.inner_iterations,
        wall_s=wall, bitwise_vs_3a=bitwise, max_abs_dv_vs_3a=dv)
    log(f"[phase3g] (d) ipi_gmres stopped at k=3 and resumed: "
        f"{whole.summary()} wall={wall:.2f}s (both sessions); 3a's policy "
        f"and counts; values bitwise equal to 3a's: {bitwise} (max |dv| "
        f"{dv:.3e}); launches {launches['session_ipi_gmres_resumed']}")

    # (e) the same solve's stream and chunk monitor records
    records = {}
    for mode in ("stream", "chunk"):
        recs = []
        opts_e = IPIOptions(method="ipi_anderson", dtype="float64",
                            atol=1e-8, monitor=True, monitor_mode=mode)
        r, wall = drive(f"driver_ipi_anderson_monitor_{mode}",
                        lambda: driver.solve(mdp, opts_e, device="cuda",
                                             monitor=recs.append, chunk=4))
        records[mode] = [{k: v for k, v in rec.items() if k != "elapsed"}
                         for rec in recs]
        rows[f"driver_ipi_anderson_monitor_{mode}"] = dict(
            outer=r.outer_iterations, inner=r.inner_iterations, wall_s=wall,
            records=len(recs))
    if records["stream"] != records["chunk"] or \
            len(records["stream"]) != r.outer_iterations + 1:
        raise AssertionError(f"stream and chunk monitor records differ: "
                             f"{records}")
    log(f"[phase3g] (e) ipi_anderson f64 monitor: {len(records['stream'])} "
        f"stream records equal to the chunk ones ({r.summary()}); launches "
        f"{launches['driver_ipi_anderson_monitor_stream']}")

    # device busy time and idle share of each solve of (a)-(c): a warm
    # plain run of its solve on the card's tables, then a profiled one (a
    # prefix of outer steps where PROFILE_PREFIX says so)
    for name, fn in profiled.items():
        r, prof = device_profile(fn)
        prof["profiled_outer"] = r.outer_iterations
        rows[name]["profile"] = prof
        log(f"[phase3g] profile {name}: {json.dumps(prof)}")
    return dict(launches=launches, rows=rows)


def surface_paths(mdp, main: dict) -> dict:
    """Phase 3w: (a) ``MDP.save`` and ``MDP.from_file`` of the phase-2
    garnet, the tables bit for bit; (b) ``outer_step`` from
    ``init_state`` until the lane stops, bit for bit 3a's CLI solve with
    its launches."""
    import tempfile

    from repro_torch.api import MDP, Options
    from repro_torch.core import ipi
    from repro_torch.core.comm import Axes
    from repro_torch.core.mdp import as_fleet
    from repro_torch.kernels import ops

    # (a) the file round trip
    OUT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MDP(mdp).save(tmp)
        t_save = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(tmp).iterdir())
        t0 = time.perf_counter()
        loaded = MDP.from_file(tmp)
        t_load = time.perf_counter() - t0
        core = loaded.core.to("cuda")
    same = {f: bits_equal(getattr(core, f), getattr(mdp, f))
            for f in ("idx", "val", "cost")}
    meta = (core.n_global, core.m_global, core.gamma, loaded.mode)
    if not all(same.values()) or meta != (mdp.n_global, mdp.m_global,
                                          mdp.gamma, "mincost"):
        raise AssertionError(f"3w (a): MDP.save / MDP.from_file gave tables "
                             f"{same}, shape and mode {meta}")
    del core, loaded
    log(f"[phase3w] (a) MDP.save {nbytes / 1e9:.3f} GB in {t_save:.2f}s, "
        f"MDP.from_file in {t_load:.2f}s; idx, val, cost bit for bit 3a's")

    # (b) the solve as a loop of outer steps, with the CLI's options
    opts = Options({"-method": "ipi_gmres", "-dtype": "float64",
                    "-atol": 1e-8, "-max_outer": 2000}).to_ipi()
    dev, axes = as_fleet(mdp), Axes()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ipi.init_state(dev, axes, opts)
    stop, _, _, k = ipi.stop_flags(state, axes)
    while not stop.all() and k.max() < opts.max_outer:
        # the step's own read gives the flags: one read a step
        state, (stop, _, _, k) = ipi.outer_step(dev, state, opts, axes,
                                               with_flags=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    v, pi = state.v[0].cpu().numpy(), state.pi[0].cpu().numpy()
    outer, inner = int(state.k[0]), int(state.inner_total[0])
    want = main["launches"]["cli_ipi_gmres"]
    if not (bool(state.done[0]) and np.array_equal(
            v.view(np.int64), main["cli_v"].view(np.int64))
            and np.array_equal(pi, main["cli_pi"])
            and (outer, inner) == (main["cli_outer"], main["cli_inner"])
            and launches == want):
        raise AssertionError(
            f"3w (b): outer_step loop outer={outer} inner={inner} launches "
            f"{launches} against 3a's CLI outer={main['cli_outer']} inner="
            f"{main['cli_inner']} launches {want} (policies equal: "
            f"{np.array_equal(pi, main['cli_pi'])}, max |dv| "
            f"{np.abs(v - main['cli_v']).max():.3e})")
    log(f"[phase3w] (b) init_state + {outer} outer_step calls, ipi_gmres "
        f"f64: inner={inner} wall={wall:.2f}s; values bit for bit 3a's CLI, "
        f"its policy, counts and launches {launches}")
    return dict(launches={"outer_step_loop": launches}, save_s=t_save,
                load_s=t_load, save_bytes=nbytes, loop_wall_s=wall)


def device_profile(fn) -> tuple:
    """``fn()`` once plain for its wall time and once under torch.profiler
    for device time by entry; returns the plain run's result and the
    profile.  The idle share is 1 - busy / wall against the plain run's
    wall, and against the profiled run's (profiling adds host time, so
    that one is an upper bound)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    _, prof = profile_once(fn, wall_ms)
    return result, prof


def profile_once(fn, wall_ms: float) -> tuple:
    """``fn()`` once under :func:`profiled`: its result, and its device
    time by kernel (kernels, copies and sets), with the idle share against
    ``wall_ms`` (a plain run's wall) and against the profiled run's own
    wall."""
    out: dict = {}
    with profiled(out):
        result = fn()
    busy_ms = out["device_busy_ms"]
    return result, dict(
        wall_ms=wall_ms, profiled_wall_ms=out["wall_ms"],
        device_busy_ms=busy_ms, device_entries=out["device_entries"],
        idle_share=(1.0 - busy_ms / wall_ms) if out["device_entries"]
        else None,
        idle_share_profiled=out["idle_share"], top=out["top"])


@contextlib.contextmanager
def profiled(out: dict):
    """torch.profiler (CUDA activity only) around the block; ``out`` gets
    the block's wall, its device busy time (the card's kernels, copies and
    sets, summed over the profiler's own records, without the chrome
    trace, whose export and parse take minutes at millions of launches),
    the idle share against that wall and the top entries."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    on_card = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        # the card's own records: kernels, copies and sets (the runtime
        # calls that launch them are the host's)
        if e.device_type() == on_card:
            ms, count = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
    rows = sorted(((ms, c, k) for k, (ms, c) in by_name.items()),
                  reverse=True)
    busy_ms = sum(ms for ms, _, _ in rows)
    out.update(wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_entries=len(rows),
               idle_share=(1.0 - busy_ms / wall_ms) if rows else None,
               top=[dict(ms=ms, count=c, kernel=k[:90])
                    for ms, c, k in rows[:8]])


def where_time_goes(mdp, phase: str) -> dict:
    """Phase 3b (and 3e, on the dense path): the ipi_gmres float64 solve
    of the path's instance again, profiled (:func:`device_profile`)."""
    from repro_torch.core import driver
    from repro_torch.core.ipi import IPIOptions

    opts = IPIOptions(method="ipi_gmres", dtype="float64", atol=1e-8,
                      max_outer=2000)
    r, prof = device_profile(lambda: driver.solve(mdp, opts, device="cuda"))
    out = dict(outer=r.outer_iterations, inner=r.inner_iterations, **prof)
    log(f"[{phase}] {json.dumps(out)}")
    return out


def parity() -> list:
    """Phase 4: the same solves on the GPU and on the CPU."""
    from repro_torch.core import driver, generators
    from repro_torch.core.ipi import IPIOptions

    mdp = generators.garnet(n=20_000, m=8, k=4, gamma=GAMMA, seed=3)
    rows = []
    for method in ("vi", "mpi", "ipi_gmres", "ipi_bicgstab", "ipi_chebyshev",
                   "ipi_anderson"):
        for mode in ("mincost", "maxreward"):
            opts = IPIOptions(method=method, mode=mode, dtype="float64",
                              atol=1e-6, max_outer=2000)
            rg = driver.solve(mdp, opts, device="cuda")
            rc = driver.solve(mdp, opts, device="cpu")
            dv = float(np.abs(rg.v - rc.v).max())
            tol = max(1e-10 * float(np.abs(rc.v).max()), rc.gap_bound)
            row = dict(method=method, mode=mode,
                       outer=(rg.outer_iterations, rc.outer_iterations),
                       inner=(rg.inner_iterations, rc.inner_iterations),
                       policy_equal=bool(np.array_equal(rg.policy,
                                                         rc.policy)),
                       max_abs_dv=dv, tol=tol)
            log(f"[phase4] {json.dumps(row)}")
            if not (rg.converged and rc.converged and row["policy_equal"]
                    and rg.outer_iterations == rc.outer_iterations
                    and rg.inner_iterations == rc.inner_iterations
                    and dv <= tol):
                raise AssertionError(f"GPU vs CPU parity failed: {row}")
            rows.append(row)
    return rows


def dense_kernel_checks(dmdp, gen: np.random.Generator) -> dict:
    """Phase 2d: ``dense_backup`` against its plain version at full width,
    timed, beside ``torch.mv`` over the same P (the product alone)."""
    from repro_torch.kernels import dense_backup, ref

    p, cost = dmdp.p, dmdp.cost
    n, m, n_cols = p.shape
    out = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).replace("torch.", "")
        v = torch.from_numpy(gen.random(n_cols) * 50.0).to("cuda", dt)
        got_v, got_pi = dense_backup.dense_backup(p, cost, GAMMA, v)
        want_v, want_pi = ref.dense_backup(p, cost, GAMMA, v)
        torch.cuda.synchronize()
        if not (bits_equal(got_v, want_v) and torch.equal(got_pi, want_pi)):
            raise AssertionError(
                f"dense_backup {name}: kernel != plain version (max |diff| "
                f"{max_abs_diff(got_v, want_v)}, argmin mismatches "
                f"{int((got_pi != want_pi).sum())})")
        nbytes = (p.nbytes + cost.nbytes + v.nbytes + got_v.nbytes
                  + got_pi.nbytes)
        flops = n * m * (2 * n_cols + 3)
        b_ms, b_by = bound_ms(nbytes, flops, dt)
        row = dict(
            max_abs_err=max_abs_diff(got_v, want_v),
            ms=time_ms(lambda: dense_backup.dense_backup(p, cost, GAMMA, v)),
            plain_ms=time_ms(lambda: ref.dense_backup(p, cost, GAMMA, v),
                             reps=PLAIN_DENSE_REPS),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            bytes=nbytes, flops=flops)
        if dt == torch.float32:
            # torch.mv takes one dtype: in float32 it is cuBLAS's gemv over
            # the same P, the product without the epilogue and min/argmin
            p2 = p.view(n * m, n_cols)
            row["library_ms"] = time_ms(lambda: torch.mv(p2, v))
            row["library"] = "torch.mv(P.view(n*m, n_cols), v), product only"
        out[name] = row
        log(f"[phase2d] dense_backup {name}: {row['ms']:.4f} ms (plain "
            f"{row['plain_ms']:.4f}, torch.mv {row['library_ms']}, bound "
            f"{row['bound_ms']:.4f} by {b_by}); bitwise equal")
    return out


def dense_main_path(ell, dmdp) -> dict:
    """Phase 3d: the dense path through a Session (ipi_gmres, float64) and
    through ``driver.solve`` (mpi, float32), each with its own launch
    counts; an independent plain-version certificate of the first; the
    ELL solve of the same garnet as a cross-check."""
    from repro_torch.api import MDP, madupite_session
    from repro_torch.core import driver
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.kernels import ops, ref

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with madupite_session({"-method": "ipi_gmres", "-dtype": "float64",
                           "-atol": 1e-8}) as s:
        r = s.solve(MDP(dmdp))
    torch.cuda.synchronize()
    t_gmres = time.perf_counter() - t0
    gmres_launches = ops.launch_counts()
    if not r.converged:
        raise AssertionError(f"dense Session ipi_gmres did not converge: "
                             f"{r.summary()}")
    require_launched("dense Session ipi_gmres", gmres_launches,
                     ("dense_backup",))
    log(f"[phase3d] dense Session ipi_gmres f64: {r.summary()} "
        f"wall={t_gmres:.3f}s; launches {gmres_launches}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rm = driver.solve(dmdp, IPIOptions(method="mpi", dtype="float32",
                                       atol=1e-4, max_outer=2000),
                      device="cuda")
    torch.cuda.synchronize()
    t_mpi = time.perf_counter() - t0
    mpi_launches = ops.launch_counts()
    if not rm.converged:
        raise AssertionError(f"dense driver mpi float32 did not converge: "
                             f"{rm.summary()}")
    require_launched("dense driver mpi", mpi_launches, ("dense_backup",))
    log(f"[phase3d] dense driver mpi f32: {rm.summary()} "
        f"wall={t_mpi:.3f}s; launches {mpi_launches}")

    v = torch.from_numpy(r.v).to("cuda")
    tv, tpi = ref.dense_backup(dmdp.p, dmdp.cost, GAMMA, v)
    res = float(torch.max(torch.abs(tv - v)))
    slack = 16 * np.finfo(np.float64).eps * float(np.abs(r.v).max())
    if not res <= 1e-8 + slack:
        raise AssertionError(f"plain-version certificate: ||Tv - v||_inf = "
                             f"{res} > 1e-8")
    if not np.array_equal(tpi.cpu().numpy(), r.policy):
        raise AssertionError("plain-version certificate: greedy policy "
                             "differs from the solve's")
    re_ = driver.solve(ell, IPIOptions(method="ipi_gmres", dtype="float64",
                                       atol=1e-8), device="cuda")
    dv = float(np.abs(re_.v - r.v).max())
    tol = 1e-5 * float(np.abs(re_.v).max())
    if not (re_.converged and dv <= tol):
        raise AssertionError(f"dense vs ELL solve of one garnet: max |dv| "
                             f"{dv} > {tol} ({re_.summary()})")
    log(f"[phase3d] plain-version residual {res:.3e} <= 1e-8, same policy; "
        f"dense vs ELL max |dv| {dv:.3e} <= {tol:.3e} (policies equal: "
        f"{bool(np.array_equal(re_.policy, r.policy))})")
    launches = {"session_ipi_gmres": gmres_launches,
                "driver_mpi": mpi_launches}
    return dict(launches=launches, gmres_wall_s=t_gmres,
                gmres_outer=r.outer_iterations,
                gmres_inner=r.inner_iterations, mpi_wall_s=t_mpi,
                mpi_outer=rm.outer_iterations,
                mpi_inner=rm.inner_iterations, plain_residual=res,
                ell_max_abs_dv=dv)


def dense_parity() -> list:
    """Phase 4d: dense solves on the GPU and on the CPU, a fully dense
    random MDP at n=2,048, m=8."""
    from repro_torch.core import driver
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.core.mdp import DenseMDP

    rng = np.random.default_rng(4)
    n, m = 2048, 8
    p = rng.random((n, m, n)) ** 4
    p /= p.sum(-1, keepdims=True)
    mdp = DenseMDP.from_numpy(p, rng.random((n, m)), GAMMA, n, m)
    rows = []
    for method in ("mpi", "ipi_gmres"):
        for mode in ("mincost", "maxreward"):
            opts = IPIOptions(method=method, mode=mode, dtype="float64",
                              atol=1e-6, max_outer=2000)
            rg = driver.solve(mdp, opts, device="cuda")
            rc = driver.solve(mdp, opts, device="cpu")
            dv = float(np.abs(rg.v - rc.v).max())
            tol = max(1e-10 * float(np.abs(rc.v).max()), rc.gap_bound)
            row = dict(method=method, mode=mode,
                       outer=(rg.outer_iterations, rc.outer_iterations),
                       inner=(rg.inner_iterations, rc.inner_iterations),
                       policy_equal=bool(np.array_equal(rg.policy,
                                                         rc.policy)),
                       max_abs_dv=dv, tol=tol)
            log(f"[phase4d] {json.dumps(row)}")
            if not (rg.converged and rc.converged and row["policy_equal"]
                    and rg.outer_iterations == rc.outer_iterations
                    and rg.inner_iterations == rc.inner_iterations
                    and dv <= tol):
                raise AssertionError(f"dense GPU vs CPU parity failed: {row}")
            rows.append(row)
    return rows


def fleet_gammas(lo: float, hi: float, b: int) -> list[float]:
    """The CLI's ``--sweep-gamma LO HI`` gammas for a fleet of ``b``."""
    return [float(g) for g in 1.0 - np.geomspace(1 - lo, 1 - hi, b)]


def timed_solve(fn) -> tuple:
    """``fn()`` and its wall in seconds, between device syncs."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def same_bits(a, b) -> bool:
    """Two solves' values, policies, counts and traces bit for bit."""
    return (np.array_equal(np.asarray(a.v).view(np.uint64),
                           np.asarray(b.v).view(np.uint64))
            and np.array_equal(a.policy, b.policy)
            and (a.outer_iterations, a.inner_iterations)
            == (b.outer_iterations, b.inner_iterations)
            and np.array_equal(a.trace_residual, b.trace_residual,
                               equal_nan=True))


def maze_cases(maze, mesh, device: str) -> dict:
    """Phase 3m (b) on one mesh: maze2d's f64 ipi_gmres trajectory over
    MAZE_OUTER outer steps four ways (``-halo 0`` / ``-halo`` the band,
    ``-comm_overlap on`` / ``off``), each with its launch counts, all
    bitwise equal; then ``async_vi -async_sweeps 8`` to 1e-8, certified
    by phase 3's independent CPU backup."""
    from repro_torch.core import driver
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.kernels import ops

    size = int(round(maze.n_global ** 0.5))
    base = dict(method="ipi_gmres", dtype="float64", atol=1e-8,
                max_outer=MAZE_OUTER)
    ways = {"halo0": dict(halo=0), f"halo{size}": dict(halo=size),
            "overlap_on": dict(comm_overlap="on"),
            "overlap_off": dict(comm_overlap="off")}
    runs, out = {}, {}
    for name, extra in ways.items():
        ops.reset_launch_counts()
        r, wall = timed_solve(lambda: driver.solve(
            maze, IPIOptions(**base, **extra), mesh=mesh, layout="1d",
            device=device))
        launches = ops.launch_counts()
        if device == "cuda":
            require_launched(f"3m (b) {name}", launches, ELL_KERNELS)
        runs[name] = r
        out[name] = dict(outer=r.outer_iterations, inner=r.inner_iterations,
                         wall_s=wall, launches=launches)
    bad = [k for k, r in runs.items() if not same_bits(r, runs["halo0"])]
    if bad:
        raise AssertionError(f"3m (b): {bad} differ from -halo 0 bit for "
                             f"bit")
    ops.reset_launch_counts()
    ra, wall = timed_solve(lambda: driver.solve(
        maze, IPIOptions(method="async_vi", async_sweeps=8, dtype="float64",
                         atol=1e-8, max_outer=20_000),
        mesh=mesh, layout="1d", device=device))
    if not ra.converged:
        raise AssertionError(f"3m (b) async_vi: {ra.summary()}")
    res = certify_on_cpu(maze, ra.v, ra.policy, "3m (b) async_vi")
    out["async_vi_8"] = dict(outer=ra.outer_iterations,
                             inner=ra.inner_iterations, wall_s=wall,
                             cpu_residual=res, launches=ops.launch_counts())
    return out


def sharded_paths(mdp, main: dict, device: str = "cuda",
                  maze_size: int = MAZE_SIZE, then=None,
                  beside=None) -> dict:
    """Phase 3m: the sharded solve path (``torch.distributed``) on the
    card, at world size 1 in this process, then ``torchrun`` over every
    card (module docstring).  ``then(meshes)``, if given, runs after (b)
    on the same process group (phase 3n), its result under ``"then"``;
    ``beside()``, if given, runs while (c)'s process does (phase 3p (d)),
    its result under ``"beside"``."""
    import torch.distributed as dist
    from repro_torch.core import driver, generators
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lm

    out, launches = {}, {}
    lm.init_distributed(device, store=dist.HashStore(), rank=0,
                        world_size=1)
    try:
        meshes = {"1d": lm.make_host_mesh((1, 1), device=device),
                  "2d": lm.make_host_mesh((1, 1), device=device)}
        # (a) the phase-3 garnet, f64 ipi_gmres, 1d and 2d against the
        # single-device solve (and the CLI's bits of phase 3a)
        opts = IPIOptions(method="ipi_gmres", dtype="float64", atol=1e-8,
                          max_outer=2000)
        single = driver.solve(mdp, opts, device=device)
        if main is not None and not (
                np.array_equal(single.v.view(np.uint64),
                               main["cli_v"].view(np.uint64))
                and single.outer_iterations == main["cli_outer"]):
            raise AssertionError("3m (a): the single-device solve is not "
                                 "phase 3a's")
        for layout, mesh in meshes.items():
            ops.reset_launch_counts()
            r = driver.solve(mdp, opts, mesh=mesh, layout=layout,
                             device=device)
            launches[f"sharded_{layout}"] = ops.launch_counts()
            if device == "cuda":
                require_launched(f"3m (a) {layout}", launches[
                    f"sharded_{layout}"], ELL_KERNELS)
            if not same_bits(r, single):
                raise AssertionError(f"3m (a) {layout}: not bit for bit the "
                                     f"single-device solve")
        out["collectives"] = collective_costs(mdp, opts, meshes, device)
        # the collective layer's overhead: each solve timed and profiled
        # once, in turns (single, 1d, 2d)
        solves = {"single": lambda: driver.solve(mdp, opts, device=device)}
        for layout, mesh in meshes.items():
            solves[layout] = (lambda mesh=mesh, layout=layout: driver.solve(
                mdp, opts, mesh=mesh, layout=layout, device=device))
        profs = {k: [] for k in solves}
        for k in ("single", "1d", "2d"):
            profs[k].append(device_profile(solves[k])[1])
        for k, ps in profs.items():
            out[k] = dict(outer=single.outer_iterations,
                          inner=single.inner_iterations,
                          wall_ms=[p["wall_ms"] for p in ps],
                          device_busy_ms=[p["device_busy_ms"] for p in ps],
                          idle_share=[p["idle_share"] for p in ps],
                          top=ps[0]["top"])
            if k != "single":
                log(f"[phase3m] (a) world=1 {k}: bitwise the single solve "
                    f"({single.summary()}); launches "
                    f"{launches[f'sharded_{k}']}")
            log(f"[phase3m] (a) world=1 {k}: wall {out[k]['wall_ms']} ms, "
                f"busy {out[k]['device_busy_ms']} ms, idle "
                f"{out[k]['idle_share']}; top {json.dumps(out[k]['top'])}")
        # (b) maze2d at n = 10^6, banded at its width
        t0 = time.perf_counter()
        maze = generators.maze2d(size=maze_size, gamma=GAMMA).to(device)
        log(f"[phase3m] (b) maze2d size={maze_size} on the device in "
            f"{time.perf_counter() - t0:.1f}s")
        out["maze"] = maze_cases(maze, meshes["1d"], device)
        log(f"[phase3m] (b) world=1: {json.dumps(out['maze'])}")
        del maze
        if then is not None:
            out["then"] = then(meshes)
    finally:
        lm.shutdown()
    # (c) the CLI under torchrun, one rank a card
    out["torchrun"], out["beside"] = torchrun_cli(mdp, device, beside)
    # (d) (a) and (b) over every card, where there are several
    n_dev = torch.cuda.device_count() if device == "cuda" else 1
    if n_dev >= 2:
        out["ranks"] = run_ranks(n_dev, device)
    else:
        log("[phase3m] (d) world=1: one card, so the multi-rank cases ran "
            "only in the CPU tests (tests/test_torch_distributed.py, 4 "
            "gloo ranks)")
    return dict(launches=launches, **out)


def rebuild_rate(spec, n: int, bn: int, device: str) -> dict:
    """Phase 3n (a): one rebuild of every row of ``spec`` in chunks of
    ``bn`` rows (the matrix-free backup's constructor work, without the
    backup), in milliseconds per 10^6 rows (CUDA events, median of 3
    after one warm-up), and
    one chunk's measured transient against the cap."""
    from repro_torch.kernels import matrix_free

    acts = tuple(range(spec.m))

    def rebuild():
        for lo in range(0, n, bn):
            rows = torch.arange(lo, min(lo + bn, n), dtype=torch.int32,
                                device=device)
            matrix_free.build_rows_block(spec, rows, acts, "mincost",
                                         check=False)

    ms = time_ms(rebuild, reps=3, warmup=1)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    chunk = matrix_free.build_rows_block(
        spec, torch.arange(bn, dtype=torch.int32, device=device), acts,
        "mincost", check=False)
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - base
    del chunk
    return dict(chunk_rows=bn, chunks=-(-n // bn), rebuild_ms=ms,
                ms_per_1e6_rows=ms * 1e6 / n, chunk_transient_bytes=transient,
                chunk_cap_bytes=matrix_free.CHUNK_BYTES)


def chunk_kernel_checks(spec, n: int, bn: int, gammas, device: str) -> list:
    """Phase 3n (a): ``ops.ell_backup_chunk`` on one rebuilt chunk of
    ``bn`` rows against a whole value vector: unbatched (``v`` (n,)) and in
    a matrix-free fleet's shared-table form (``v`` (B, n), one gamma a
    lane), in both dtypes, bit for bit against the plain version on the
    CPU copies of the same inputs; timed beside the byte bound."""
    from repro_torch.kernels import matrix_free, ops, ref

    idx, val, cost, _ = matrix_free.build_rows_block(
        spec, torch.arange(bn, dtype=torch.int32, device=device),
        tuple(range(spec.m)), "mincost", check=False)
    tables = (idx, val, cost)
    on_cpu = tuple(t.cpu() for t in tables)
    gen = np.random.default_rng(3)
    out = []
    for dt in (torch.float64, torch.float32):
        name = str(dt).replace("torch.", "")
        for lanes in (None, len(gammas)):
            shape = (n,) if lanes is None else (lanes, n)
            v = torch.from_numpy(gen.random(shape) * 50.0).to(device, dt)
            g = GAMMA if lanes is None else torch.tensor(gammas, dtype=dt,
                                                         device=device)
            got = ops.ell_backup_chunk(*tables, g, v)
            want = ref.ell_backup(*on_cpu, g if lanes is None else g.cpu(),
                                  v.cpu())
            got = tuple(t.cpu() for t in got)
            diff = max_abs_diff(got[0], want[0])
            if not (bits_equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(
                    f"3n (a) ell_backup_chunk {name} v {shape}: kernel != "
                    f"plain version on the CPU (max |diff| {diff}, argmin "
                    f"mismatches {int((got[1] != want[1]).sum())})")
            b = lanes or 1
            nbytes = (idx.nbytes + val.nbytes + cost.nbytes + v.nbytes
                      + b * bn * (v.element_size() + 4))
            b_ms, b_by = bound_ms(nbytes, b * idx.numel() * 2
                                  + b * cost.numel() * 3, dt)
            row = dict(dtype=name, v_shape=list(shape), chunk_rows=bn,
                       max_abs_err=diff,
                       ms=time_ms(lambda: ops.ell_backup_chunk(*tables, g,
                                                               v)),
                       bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
            out.append(row)
            log(f"[phase3n] (a) ell_backup_chunk: {json.dumps(row)}; bit "
                f"for bit the plain version on the CPU")
            if lanes is not None and device == "cuda":
                chunk_candidates(tables, g, v)
    return out


def bits_same(a, b) -> bool:
    """Two solves' values (either float dtype), policies, counts and
    residual traces bit for bit."""
    va, vb = np.asarray(a.v), np.asarray(b.v)
    ints = {4: np.int32, 8: np.int64}[va.dtype.itemsize]
    return (va.dtype == vb.dtype and np.array_equal(va.view(ints),
                                                    vb.view(ints))
            and np.array_equal(a.policy, b.policy)
            and (a.outer_iterations, a.inner_iterations)
            == (b.outer_iterations, b.inner_iterations)
            and np.array_equal(a.trace_residual, b.trace_residual,
                               equal_nan=True))


def matrix_free_paths(meshes, device: str = "cuda", n: int = N,
                      maze_size: int = MAZE_SIZE) -> dict:
    """Phase 3n: function-backed MDPs, materialized on the card and
    matrix-free (module docstring), on phase 3m's process group."""
    from repro_torch.api import MDP, madupite_session
    from repro_torch.core import driver
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.kernels import matrix_free, ops

    out, launches = {}, {}
    garnet = MDP.from_generator("garnet", deferred=True, n=n, m=M, k=K,
                                gamma=GAMMA, seed=0)
    spec = garnet._row_spec()
    table = matrix_free.table_bytes(n, M, K)
    rule = matrix_free.chunk_rows(spec, M)
    rates = [rebuild_rate(spec, n, bn, device) for bn in (rule // 2, rule, n)]
    out["rebuild"] = rate = rates[1]
    out["rebuild_by_chunk_rows"] = rates
    for r in rates:
        log(f"[phase3n] (a) one rebuild of garnet n={n} m={M} k={K} on the "
            f"card{' (the rule)' if r is rate else ''}: {json.dumps(r)}")
    if rate["chunk_transient_bytes"] > matrix_free.CHUNK_BYTES:
        raise AssertionError(f"3n (a): one chunk's transient "
                             f"{rate['chunk_transient_bytes']} bytes is over "
                             f"the cap {matrix_free.CHUNK_BYTES}")
    gammas = fleet_gammas(0.9, 0.99, FLEET_B)
    out["chunk_kernel"] = chunk_kernel_checks(spec, n, rule, gammas, device)
    # the host's tables, by the same constructors, certify the card's
    t0 = time.perf_counter()
    host = garnet.build("cpu")
    t_host = time.perf_counter() - t0
    card = garnet.build(device)
    for f in ("idx", "val", "cost"):
        if not bits_equal(getattr(card, f).cpu(), getattr(host, f)):
            raise AssertionError(f"3n (a): the card's {f} is not the "
                                 f"host's bit for bit")
    garnet.evict()
    del card
    log(f"[phase3n] (a) the host built the same tables bit for bit in "
        f"{t_host:.1f}s")

    chunks = rate["chunks"]
    solves = {"ipi_gmres_f64": {"-method": "ipi_gmres", "-dtype": "float64",
                                "-atol": 1e-8},
              "mpi_f32": {"-method": "mpi", "-dtype": "float32",
                          "-atol": 1e-4}}
    results = {}
    for tag, opts in solves.items():
        rows = {}
        for mat in ("device", "matrix_free"):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            with madupite_session({**opts, "-mdp_materialize": mat}) as s:
                r, wall = timed_solve(lambda: s.solve(garnet))
                peak = torch.cuda.max_memory_allocated() - base
                c = ops.launch_counts()
                # busy and idle over the first outer step (a whole
                # matrix-free solve launches millions of kernels)
                prefix = lambda: s.solve(garnet, max_outer=1)
                _, w_prefix = timed_solve(prefix)
                _, prof = profile_once(prefix, w_prefix * 1e3)
            require_launched(f"3n (a) {tag} {mat}", c, ELL_KERNELS)
            if not r.converged:
                raise AssertionError(f"3n (a) {tag} {mat}: {r.summary()}")
            launches[f"mf_{tag}_{mat}"] = c
            results[(tag, mat)] = r
            rows[mat] = dict(outer=r.outer_iterations,
                             inner=r.inner_iterations, wall_s=wall,
                             peak_bytes=peak, launches=c,
                             first_step_profile=prof)
        dev, mf = results[(tag, "device")], results[(tag, "matrix_free")]
        if not bits_same(dev, mf):
            raise AssertionError(f"3n (a) {tag}: matrix-free is not the "
                                 f"device-materialized solve bit for bit")
        c_dev, c_mf = rows["device"]["launches"], rows["matrix_free"][
            "launches"]
        if c_mf["ell_backup"] != c_dev["ell_backup"] * chunks \
                or c_mf["ell_matvec"] != c_dev["ell_matvec"]:
            raise AssertionError(f"3n (a) {tag}: launches {c_mf} against "
                                 f"{c_dev} in {chunks} chunks")
        saved = rows["device"]["peak_bytes"] - rows["matrix_free"][
            "peak_bytes"]
        if saved < table - matrix_free.CHUNK_BYTES:
            raise AssertionError(f"3n (a) {tag}: matrix-free peak only "
                                 f"{saved} bytes below the materialized one")
        b_dev = rows["device"]["first_step_profile"]["device_busy_ms"]
        b_mf = rows["matrix_free"]["first_step_profile"]["device_busy_ms"]
        rows["constructor_share_of_device_time"] = 1.0 - b_dev / b_mf
        rows["table_bytes"] = table
        rows["operator_bytes"] = matrix_free.operator_bytes(
            n, K, krylov=True)
        out[tag] = rows
        log(f"[phase3n] (a) {tag}: matrix-free bit for bit the "
            f"device-materialized solve ({mf.summary()}); "
            f"{json.dumps(rows)}")
    # the value vector against the host's tables, by one plain backup
    r64 = results[("ipi_gmres_f64", "matrix_free")]
    out["cpu_residual"] = certify_on_cpu(host, r64.v, r64.policy,
                                         "3n (a) matrix-free ipi_gmres")
    del host
    log(f"[phase3n] (a) independent CPU residual {out['cpu_residual']:.3e} "
        f"<= 1e-8")

    # (b) maze2d by constructors, matrix-free under the world-1 mesh
    maze = MDP.from_generator("maze2d", deferred=True, size=maze_size,
                              gamma=GAMMA)
    base = dict(method="ipi_gmres", dtype="float64", atol=1e-8,
                max_outer=MAZE_OUTER)
    single = driver.solve(maze.build(device), IPIOptions(**base),
                          device=device)
    mf_maze = maze.build(device, materialize="matrix_free")
    ways = {}
    for halo in (0, maze_size):
        for ov in ("on", "off"):
            ops.reset_launch_counts()
            r, wall = timed_solve(lambda: driver.solve(
                mf_maze, IPIOptions(**base, halo=halo, comm_overlap=ov),
                mesh=meshes["1d"], layout="1d", device=device))
            c = ops.launch_counts()
            require_launched(f"3n (b) halo {halo} overlap {ov}", c,
                             ELL_KERNELS)
            if not bits_same(r, single):
                raise AssertionError(f"3n (b) halo {halo} overlap {ov}: not "
                                     f"the device-materialized single "
                                     f"solve bit for bit")
            launches[f"mf_maze_halo{halo}_{ov}"] = c
            ways[f"halo{halo}/{ov}"] = dict(wall_s=wall, launches=c)
    maze.evict()
    out["maze"] = dict(outer=single.outer_iterations,
                       inner=single.inner_iterations, ways=ways)
    log(f"[phase3n] (b) maze2d size={maze_size} matrix-free, world=1 mesh, "
        f"four ways bit for bit the materialized single solve: "
        f"{json.dumps(out['maze'])}")

    # (c) a matrix-free gamma sweep: one spec, one rebuild a chunk for the
    # lanes
    gammas = fleet_gammas(0.9, GAMMA, MF_SWEEP_B)
    sweep = [MDP.from_generator("garnet", deferred=True, n=n, m=M, k=K,
                                gamma=g, seed=0) for g in gammas]
    opts = {**solves["mpi_f32"], "-mdp_materialize": "matrix_free"}
    with madupite_session(opts) as s:
        ops.reset_launch_counts()
        fleet, t_fleet = timed_solve(lambda: s.solve_fleet(sweep))
        c_fleet = ops.launch_counts()
        solo, walls, c_solo = [], [], []
        for g, m in zip(gammas, sweep):
            if g == GAMMA:      # (a)'s matrix-free mpi solve: this lane
                solo.append(results[("mpi_f32", "matrix_free")])
                walls.append(out["mpi_f32"]["matrix_free"]["wall_s"])
                c_solo.append(out["mpi_f32"]["matrix_free"]["launches"])
                continue
            ops.reset_launch_counts()
            r, wall = timed_solve(lambda m=m: s.solve(m))
            solo.append(r)
            walls.append(wall)
            c_solo.append(ops.launch_counts())
    require_launched("3n (c) fleet", c_fleet, ELL_KERNELS)
    for b, (f, r) in enumerate(zip(fleet, solo)):
        if not (f.converged and bits_same(f, r)):
            raise AssertionError(f"3n (c) lane {b} (gamma {gammas[b]}): "
                                 f"{f.summary()} not bit for bit its "
                                 f"unbatched {r.summary()}")
    solo_backups = sum(c["ell_backup"] for c in c_solo)
    if c_fleet["ell_backup"] % chunks or c_fleet["ell_backup"] \
            >= solo_backups:
        raise AssertionError(f"3n (c): fleet launches {c_fleet} against "
                             f"{solo_backups} unbatched backups")
    launches["mf_session_fleet_mpi"] = c_fleet
    out["sweep"] = dict(gammas=gammas, wall_s=t_fleet, launches=c_fleet,
                        solo_wall_s=walls, solo_launches=c_solo,
                        lanes=[dict(outer=f.outer_iterations,
                                    inner=f.inner_iterations)
                               for f in fleet])
    log(f"[phase3n] (c) matrix-free gamma sweep {gammas} mpi f32: fleet "
        f"wall {t_fleet:.2f}s against {sum(walls):.2f}s for the "
        f"{len(gammas)} solves, each lane bit for bit its unbatched "
        f"solve; launches {c_fleet} against {c_solo}")
    return dict(launches=launches, **out)


def collective_costs(mdp, opts, meshes, device: str,
                     reps: int = 200) -> dict:
    """Phase 3m (a): the collectives one sharded solve issues, by kind and
    axis (:func:`count_collectives`), and the host-clock
    cost of one call of each kind at this solve's sizes (a 0-d float64
    all-reduce, an all-gather of the float64 value vector), between
    device syncs, over ``reps`` calls."""
    from repro_torch.core import driver, partition

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out = {}
    for layout, mesh in meshes.items():
        _, out[f"calls_{layout}"] = count_collectives(lambda: driver.solve(
            mdp, opts, mesh=mesh, layout=layout, device=device))
    axes = partition.mesh_axes(meshes["1d"], "1d")
    scalar = torch.ones((), dtype=torch.float64, device=device)
    vec = torch.ones(mdp.n_global, dtype=torch.float64, device=device)
    for kind, fn in (("all_reduce_0d_us", lambda: axes.psum_state(scalar)),
                     ("all_gather_n_us", lambda: axes.allgather_state(vec))):
        for _ in range(10):
            fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        out[kind] = (time.perf_counter() - t0) / reps * 1e6
    log(f"[phase3m] (a) collectives: {json.dumps(out)}")
    return out


def torchrun_cli(mdp, device: str, beside=None) -> tuple:
    """Phase 3m (c): ``torchrun --nproc-per-node <cards>`` of the solve CLI
    on the phase-3 garnet, ``--layout 1d``: exit 0, every rank on its own
    card, the certificate held by phase 3's independent CPU backup.
    ``beside()`` runs meanwhile (:func:`run_beside`); its result is
    returned second."""
    n_dev = torch.cuda.device_count() if device == "cuda" else 2
    v_path, pi_path = OUT / "torchrun_v.npy", OUT / "torchrun_pi.npy"
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n_dev), "-m", "repro_torch.launch.solve",
            "--", "--instance", "garnet", "--n", str(mdp.n_global), "--m",
            str(mdp.m_global), "--k", str(mdp.nnz_per_row), "--gamma",
            str(GAMMA), "--method", "ipi_gmres", "--atol", "1e-8",
            "--layout", "1d", "--device", device,
            "--option", f"file_cost={v_path}",
            "--option", f"file_policy={pi_path}"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc, wall, got = run_beside(argv, env, beside)
    log("\n".join(ln for ln in proc.stdout.splitlines()
                   if ln.startswith("[solve]")))
    if proc.returncode != 0:
        raise AssertionError(f"3m (c) torchrun CLI exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    ranks = re.findall(r"\[solve\] rank (\d+) of (\d+) on (\S+)",
                       proc.stdout)
    devices = {d for _, _, d in ranks}
    if len(ranks) != n_dev or (device == "cuda" and len(devices) != n_dev):
        raise AssertionError(f"3m (c): ranks {ranks}: want {n_dev} ranks "
                             f"each on its own device")
    res = certify_on_cpu(mdp, np.load(v_path), np.load(pi_path),
                         "3m (c) torchrun CLI")
    log(f"[phase3m] (c) torchrun --nproc-per-node {n_dev}"
        f"{' (beside 3p (d))' if beside else ''}: exit 0 in {wall:.1f}s, "
        f"ranks on {sorted(devices)}, independent CPU residual {res:.3e}")
    return dict(world=n_dev, wall_s=wall, devices=sorted(devices),
                cpu_residual=res), got


def run_ranks(n_dev: int, device: str) -> dict:
    """Phase 3m (d): ``torchrun`` of this script's ``--ranks`` mode over
    ``n_dev`` cards (:func:`ranks_main`); its JSON line back."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n_dev), str(ROOT / "chip_smoke.py"),
            "--ranks", device, str(N), str(MAZE_SIZE)]
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"3m (d) exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("[phase3m] (d)")][-1]
    log(line)
    return json.loads(line.split(" ", 3)[3])


def ranks_main(device: str, n: int = N, maze_size: int = MAZE_SIZE) -> int:
    """``--ranks``: one rank of phase 3m (d), under ``torchrun``.  (a)'s
    garnet over the world, ``1d`` and ``2d`` (``(world // 2, 2)``), must
    give the single-device solve's policy and counts with values within
    1e-10 |v|_inf; (b)'s four maze trajectories must be bitwise equal and
    its async_vi solve certified.  Rank 0 prints one JSON line."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import driver, generators
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.launch import mesh as lm

    tuner_off()
    dev = lm.init_distributed(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    try:
        mdp = generators.garnet(n=n, m=M, k=K, gamma=GAMMA, seed=0).to(dev)
        opts = IPIOptions(method="ipi_gmres", dtype="float64", atol=1e-8,
                          max_outer=2000)
        single, wall = timed_solve(lambda: driver.solve(mdp, opts,
                                                        device=dev))
        out = dict(world=world, single_wall_s=wall)
        shapes = {"1d": (world, 1), "2d": (world // 2, 2) if world % 2 == 0
                  else (world, 1)}
        for layout, shape in shapes.items():
            mesh = lm.make_host_mesh(shape, device=device)
            r, wall = timed_solve(lambda: driver.solve(
                mdp, opts, mesh=mesh, layout=layout, device=dev))
            dv = float(np.abs(r.v - single.v).max())
            if not (np.array_equal(r.policy, single.policy)
                    and r.outer_iterations == single.outer_iterations
                    and r.inner_iterations == single.inner_iterations
                    and dv <= 1e-10 * float(np.abs(single.v).max())):
                raise AssertionError(f"3m (d) {layout}: {r.summary()} "
                                     f"against {single.summary()}, dv {dv}")
            out[layout] = dict(shape=shape, wall_s=wall, max_abs_dv=dv)
        maze = generators.maze2d(size=maze_size, gamma=GAMMA).to(dev)
        out["maze"] = maze_cases(maze, lm.make_host_mesh((world, 1),
                                                         device=device),
                                 device)
        if rank == 0:
            print(f"[phase3m] (d) world={world} {json.dumps(out)}",
                  flush=True)
    finally:
        lm.shutdown()
    return 0


def fleet_paths(mdp) -> dict:
    """Phase 3h (a), (b) and (e), and (d) for the ELL kernels: fleets on
    the phase-2 garnet's shape through the CLI, a Session and the
    driver, each with its launch counts against the unbatched solves of
    the same instances."""
    from repro_torch.api import madupite_session
    from repro_torch.core import driver, generators, mdp as core_mdp
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.kernels import ops
    from repro_torch.launch import solve as cli

    out = {"launches": {}}
    opts = IPIOptions(method="ipi_gmres", dtype="float64", atol=1e-8,
                      max_outer=2000)

    # (a) the CLI's seed ensemble: B garnets, seeds 0 .. B-1, a batched idx
    v_path, pi_path = OUT / "fleet_v.npz", OUT / "fleet_pi.npz"
    stats_path = OUT / "fleet_stats.jsonl"
    stats_path.unlink(missing_ok=True)
    ops.reset_launch_counts()
    rc, t_cli = timed_solve(lambda: cli.main(
        ["--instance", "garnet", "--n", str(N), "--m", str(M), "--k",
         str(K), "--gamma", str(GAMMA), "--batch", str(FLEET_B),
         "--method", "ipi_gmres", "--dtype", "float64", "--atol", "1e-8",
         "--option", f"file_cost={v_path}",
         "--option", f"file_policy={pi_path}",
         "--option", f"file_stats={stats_path}"]))
    fleet_launches = ops.launch_counts()
    if rc != 0:
        raise AssertionError(f"CLI --batch {FLEET_B} ipi_gmres exited {rc}")
    require_launched("CLI fleet ipi_gmres", fleet_launches, ELL_KERNELS)
    stats = read_stats(stats_path)
    with np.load(v_path) as zv, np.load(pi_path) as zp:
        vs = [zv[f"instance_{b}"] for b in range(FLEET_B)]
        pis = [zp[f"instance_{b}"] for b in range(FLEET_B)]
    # the lanes' instances, and their unbatched solves on the card
    lanes = [generators.garnet(n=N, m=M, k=K, gamma=GAMMA, seed=s)
             for s in range(FLEET_B)]
    dev_lanes = [lane.to("cuda") for lane in lanes]
    singles, walls, lane_launches = [], [], []
    for d in dev_lanes:
        ops.reset_launch_counts()
        r, wall = timed_solve(lambda d=d: driver.solve(d, opts,
                                                       device="cuda"))
        singles.append(r)
        walls.append(wall)
        lane_launches.append(ops.launch_counts())
    single_launches = {name: sum(c[name] for c in lane_launches)
                       for name in ELL_KERNELS}
    rows = []
    for b, (s, solve) in enumerate(zip(singles, stats["solves"])):
        res = certify_on_cpu(lanes[b], vs[b], pis[b],
                             f"3h(a) lane {b}, independent CPU backup")
        dv = float(np.abs(vs[b] - s.v).max())
        tol = 1e-10 * float(np.abs(s.v).max())
        counts = (solve["outer_iterations"], solve["inner_iterations"])
        if not (s.converged and np.array_equal(pis[b], s.policy)
                and counts == (s.outer_iterations, s.inner_iterations)
                and dv <= tol):
            raise AssertionError(
                f"3h(a) lane {b}: fleet outer/inner {counts}, unbatched "
                f"{s.summary()}, policies equal "
                f"{np.array_equal(pis[b], s.policy)}, max |dv| {dv} > {tol}")
        rows.append(dict(lane=b, outer=counts[0], inner=counts[1],
                         cpu_residual=res, max_abs_dv_vs_unbatched=dv,
                         unbatched_wall_s=walls[b],
                         unbatched_launches=lane_launches[b]))
    for name in ELL_KERNELS:
        if not fleet_launches[name] < single_launches[name]:
            raise AssertionError(
                f"3h(a) {name}: the fleet launched {fleet_launches[name]} "
                f"times, the {FLEET_B} unbatched solves "
                f"{single_launches[name]}: the lane axis is not native")
    out["launches"]["cli_fleet_ipi_gmres"] = fleet_launches
    out["cli"] = dict(wall_s=t_cli, lanes=rows,
                      unbatched_launches=single_launches)
    log(f"[phase3h] (a) CLI --batch {FLEET_B} ipi_gmres f64: wall "
        f"{t_cli:.2f}s (generation, stacking, H2D, solve); lanes "
        f"{json.dumps(rows)}; launches fleet {fleet_launches} against "
        f"{single_launches} for the {FLEET_B} unbatched solves")

    # (e) the same fleet on the card's tables, plain then profiled,
    # against the unbatched solves' walls
    seeds = core_mdp.stack_mdps(dev_lanes)
    assert seeds.batch == FLEET_B and not seeds.shared_topology
    rs, prof = device_profile(lambda: driver.solve_many(seeds, opts,
                                                        device="cuda"))
    # phase 3p holds its fleet layouts to this fleet's bits and launches
    out["_seeds"], out["_results"] = seeds, rs
    for b, (r, s) in enumerate(zip(rs, singles)):
        if (r.outer_iterations, r.inner_iterations) != \
                (s.outer_iterations, s.inner_iterations):
            raise AssertionError(f"3h(e) lane {b}: {r.summary()} against "
                                 f"{s.summary()}")
    prof["sum_unbatched_wall_ms"] = sum(walls) * 1e3
    prof["wall_per_lane_ms"] = prof["wall_ms"] / FLEET_B
    out["profile"] = prof
    log(f"[phase3h] (e) fleet of {FLEET_B} ipi_gmres f64 profiled: "
        f"{json.dumps(prof)}")
    del dev_lanes, lanes
    torch.cuda.empty_cache()

    # (b) a Session gamma sweep over one seed (one shared idx), mpi f32
    gammas = fleet_gammas(*FLEET_SWEEP, FLEET_B)
    sweep = [dataclasses.replace(mdp, gamma=g) for g in gammas]
    ops.reset_launch_counts()
    with madupite_session({"-method": "mpi", "-dtype": "float32",
                           "-atol": 1e-4}) as s:
        rs, t_sweep = timed_solve(lambda: s.solve_fleet(sweep))
    sweep_launches = ops.launch_counts()
    require_launched("Session fleet mpi", sweep_launches, ELL_KERNELS)
    opts_b = IPIOptions(method="mpi", dtype="float32", atol=1e-4)
    lanes_b = []
    for b, (r, inst) in enumerate(zip(rs, sweep)):
        single = driver.solve(inst, opts_b, device="cuda")
        if not (r.converged and single.converged
                and np.array_equal(r.v.view(np.int32),
                                   single.v.view(np.int32))
                and np.array_equal(r.policy, single.policy)):
            raise AssertionError(
                f"3h(b) lane {b} (gamma {gammas[b]}): {r.summary()} not bit "
                f"for bit the unbatched {single.summary()} (max |dv| "
                f"{float(np.abs(r.v - single.v).max())})")
        lanes_b.append(dict(gamma=gammas[b], outer=r.outer_iterations,
                            inner=r.inner_iterations))
    out["launches"]["session_fleet_mpi"] = sweep_launches
    out["sweep"] = dict(wall_s=t_sweep, lanes=lanes_b)
    log(f"[phase3h] (b) Session gamma sweep {gammas} mpi f32: wall "
        f"{t_sweep:.2f}s; lanes {json.dumps(lanes_b)}, each bit for bit its "
        f"unbatched solve; launches {sweep_launches}")

    # (d) the ELL kernels' lane axis at B on the phase-2 shape: a shared
    # idx (the sweep's tables) and a batched one (the seeds')
    shared = core_mdp.stack_mdps(sweep)
    assert shared.shared_topology
    out["kernels"] = fleet_kernel_checks(
        {"shared": shared, "batched": seeds}, gammas,
        np.random.default_rng(7))
    fleet_candidates({"shared": shared, "batched": seeds}, gammas,
                     np.random.default_rng(9))
    ops.reset_launch_counts()
    q = ops.ell_qvalues(seeds.idx, seeds.val, seeds.cost, GAMMA,
                        torch.zeros((FLEET_B, N), dtype=torch.float64,
                                    device="cuda"))
    torch.cuda.synchronize()
    out["qvalues_launches"] = ops.launch_counts()
    require_launched("ops.ell_qvalues fleet", out["qvalues_launches"],
                     ("ell_qvalues",))
    del q, shared, seeds, sweep
    torch.cuda.empty_cache()
    return out


def batched_rows(rows: list) -> dict:
    """Phase 3h (d)'s rows of one kernel for its ``kernels`` entry, keyed
    by ``idx`` kind and dtype (each row: B, ``idx``, ms by grid order, the
    B-launch loop's ms, bound, max |diff|)."""
    return {f"{r['idx']}_idx_{r['dtype']}" if r["idx"] != "none"
            else r["dtype"]: r for r in rows}


def fleet_kernel_checks(fleets: dict, gammas, gen) -> dict:
    """Phase 3h (d), ELL: ``ell_backup``, ``ell_matvec`` and
    ``ell_qvalues`` on each fleet in float32 and float64, bitwise against
    their batched plain versions, timed in both grid orders beside B
    unbatched launches (one timed call), with the batched byte bound."""
    from repro_torch.kernels import bellman_ell, lanes, ref, spmv_ell

    out = {"ell_backup": [], "ell_matvec": [], "ell_qvalues": []}
    for kind, f in fleets.items():
        b_, n, m, k = f.val.shape
        one = lambda t, b: t if kind == "shared" else t[b]
        rows_i = f.idx[..., 0, :].contiguous()     # action 0's rows
        rows_v = f.val[:, :, 0].contiguous()
        for dt in (torch.float64, torch.float32):
            name = str(dt).replace("torch.", "")
            v = torch.from_numpy(gen.random((b_, n)) * 50.0).to("cuda", dt)
            g = torch.tensor(gammas, dtype=dt, device="cuda") \
                if kind == "shared" else GAMMA
            lane_g = (lambda b: gammas[b]) if kind == "shared" \
                else (lambda b: GAMMA)
            cases = {
                "ell_backup": (
                    lambda o=None: bellman_ell.ell_backup(
                        f.idx, f.val, f.cost, g, v, lane_order=o),
                    lambda: ref.ell_backup(f.idx, f.val, f.cost, g, v),
                    lambda: [bellman_ell.ell_backup(
                        one(f.idx, b), f.val[b], f.cost[b], lane_g(b), v[b])
                        for b in range(b_)],
                    f.idx.nbytes + f.val.nbytes + f.cost.nbytes + v.nbytes
                    + b_ * n * (v.element_size() + 4),
                    b_ * n * m * (2 * k + 3)),
                "ell_matvec": (
                    lambda o=None: (spmv_ell.ell_matvec(rows_i, rows_v, v,
                                                        lane_order=o),),
                    lambda: (ref.ell_matvec(rows_i, rows_v, v),),
                    lambda: [spmv_ell.ell_matvec(one(rows_i, b), rows_v[b],
                                                 v[b]) for b in range(b_)],
                    rows_i.nbytes + rows_v.nbytes + 2 * v.nbytes,
                    2 * b_ * n * k),
                "ell_qvalues": (
                    lambda o=None: (bellman_ell.ell_qvalues(
                        f.idx, f.val, f.cost, g, v, lane_order=o),),
                    lambda: (ref.ell_qvalues(f.idx, f.val, f.cost, g, v),),
                    lambda: [bellman_ell.ell_qvalues(
                        one(f.idx, b), f.val[b], f.cost[b], lane_g(b), v[b])
                        for b in range(b_)],
                    f.idx.nbytes + f.val.nbytes + f.cost.nbytes + v.nbytes
                    + b_ * n * m * v.element_size(),
                    b_ * n * m * (2 * k + 2)),
            }
            for kernel, (run, plain, loop, nbytes, flops) in cases.items():
                got, want = run(), plain()
                torch.cuda.synchronize()
                diff = max(max_abs_diff(a, w) for a, w in zip(got, want))
                if not all(bits_equal(a, w) for a, w in zip(got, want)):
                    raise AssertionError(
                        f"3h(d) {kernel} {kind} idx {name}: batched kernel "
                        f"!= batched plain version (max |diff| {diff})")
                b_ms, b_by = bound_ms(nbytes, flops, dt)
                by_order = {o: time_ms(lambda o=o: run(o))
                            for o in lanes.LANE_ORDERS}
                row = dict(B=b_, idx=kind, dtype=name,
                           ms=by_order[lanes.LANE_ORDER],
                           ms_by_order=by_order,
                           unbatched_loop_ms=time_ms(loop), bound_ms=b_ms,
                           bound_by=b_by, bytes=nbytes, max_abs_diff=diff)
                out[kernel].append(row)
                log(f"[phase3h] (d) {kernel} B={b_} {kind} idx {name}: "
                    f"{json.dumps(row)}; bitwise equal")
    return out


def dense_fleet(gen) -> dict:
    """Phase 3h (c), and (d) for ``dense_backup``: a fleet of
    ``as_dense()`` garnets through ``driver.solve_many`` against their
    unbatched solves, each lane certified by the plain dense backup; then
    the batched kernel against its plain version, timed."""
    from repro_torch.core import driver, generators, mdp as core_mdp
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.kernels import dense_backup, ops, ref

    dense = [generators.garnet(n=DFN, m=DM, k=DK, gamma=GAMMA, seed=s)
             .to("cuda").as_dense() for s in range(DENSE_FLEET_B)]
    fleet = core_mdp.stack_mdps(dense)
    opts = IPIOptions(method="ipi_gmres", dtype="float64", atol=1e-8,
                      max_outer=2000)
    ops.reset_launch_counts()
    rs, wall = timed_solve(lambda: driver.solve_many(fleet, opts,
                                                     device="cuda"))
    launches = ops.launch_counts()
    require_launched("dense fleet ipi_gmres", launches, ("dense_backup",))
    single_launches, lanes = 0, []
    for b, (r, d) in enumerate(zip(rs, dense)):
        ops.reset_launch_counts()
        s, s_wall = timed_solve(lambda d=d: driver.solve(d, opts,
                                                         device="cuda"))
        single_launches += ops.launch_counts()["dense_backup"]
        v = torch.from_numpy(r.v).to("cuda")
        tv, tpi = ref.dense_backup(d.p, d.cost, GAMMA, v)
        res = float(torch.max(torch.abs(tv - v)))
        slack = 16 * np.finfo(np.float64).eps * float(np.abs(r.v).max())
        dv = float(np.abs(r.v - s.v).max())
        if not (r.converged and res <= 1e-8 + slack
                and np.array_equal(tpi.cpu().numpy(), r.policy)
                and np.array_equal(r.policy, s.policy)
                and (r.outer_iterations, r.inner_iterations)
                == (s.outer_iterations, s.inner_iterations)):
            raise AssertionError(
                f"3h(c) dense lane {b}: {r.summary()}, plain-version "
                f"residual {res}, unbatched {s.summary()}")
        lanes.append(dict(lane=b, outer=r.outer_iterations,
                          inner=r.inner_iterations, plain_residual=res,
                          max_abs_dv_vs_unbatched=dv, unbatched_wall_s=s_wall))
    if not launches["dense_backup"] < single_launches:
        raise AssertionError(
            f"3h(c) dense_backup: the fleet launched "
            f"{launches['dense_backup']} times, the unbatched solves "
            f"{single_launches}")
    log(f"[phase3h] (c) dense fleet B={DENSE_FLEET_B} n={DFN} ipi_gmres f64: "
        f"wall {wall:.2f}s; lanes {json.dumps(lanes)}; launches {launches} "
        f"against {single_launches} for the unbatched solves")
    layout_launches = dense_fleet_layout(fleet, opts, rs, launches)

    p, cost = fleet.p, fleet.cost
    b_, n, m, n_cols = p.shape
    rows = []
    for dt in (torch.float32, torch.float64):
        name = str(dt).replace("torch.", "")
        v = torch.from_numpy(gen.random((b_, n_cols)) * 50.0).to("cuda", dt)
        got = dense_backup.dense_backup(p, cost, GAMMA, v)
        want = ref.dense_backup(p, cost, GAMMA, v)
        torch.cuda.synchronize()
        diff = max_abs_diff(got[0], want[0])
        if not (bits_equal(got[0], want[0]) and torch.equal(got[1],
                                                            want[1])):
            raise AssertionError(f"3h(d) dense_backup {name}: batched kernel "
                                 f"!= batched plain version ({diff})")
        nbytes = p.nbytes + cost.nbytes + v.nbytes + b_ * n * (
            v.element_size() + 4)
        b_ms, b_by = bound_ms(nbytes, b_ * n * m * (2 * n_cols + 3), dt)
        row = dict(B=b_, idx="none", dtype=name,
                   ms=time_ms(lambda: dense_backup.dense_backup(p, cost,
                                                                GAMMA, v)),
                   unbatched_loop_ms=time_ms(lambda: [
                       dense_backup.dense_backup(p[b], cost[b], GAMMA, v[b])
                       for b in range(b_)]),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                   max_abs_diff=diff)
        rows.append(row)
        log(f"[phase3h] (d) dense_backup B={b_} {name}: {json.dumps(row)}; "
            f"bitwise equal")
    del dense, fleet
    torch.cuda.empty_cache()
    return dict(launches={"driver_fleet_ipi_gmres": launches,
                          "fleet_layout_dense": layout_launches},
                wall_s=wall, lanes=lanes, kernel=rows)


def dense_fleet_layout(fleet, opts, base: list, base_launches: dict,
                       device: str = "cuda") -> dict:
    """Phase 3p (dense): the dense fleet of 3h (c) under the ``fleet``
    layout on a world of one rank (a group of its own in this process):
    bit for bit the mesh-less fleet, with its ``dense_backup`` launches."""
    import torch.distributed as dist
    from repro_torch.core import driver
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lm

    lm.init_distributed(device, store=dist.HashStore(), rank=0,
                        world_size=1)
    try:
        mesh = lm.make_fleet_mesh(1, layout="fleet", device=device)
        ops.reset_launch_counts()
        rs, wall = timed_solve(lambda: driver.solve_many(
            fleet, opts, mesh=mesh, layout="fleet", device=device))
        launches = ops.launch_counts()
    finally:
        lm.shutdown()
    if device == "cuda":
        require_launched("3p dense fleet layout", launches,
                         ("dense_backup",))
    bad = [b for b, (r, w) in enumerate(zip(rs, base)) if not same_bits(r, w)]
    if bad or launches["dense_backup"] != base_launches["dense_backup"]:
        raise AssertionError(f"3p dense: lanes {bad} not bit for bit the "
                             f"mesh-less fleet, or launches {launches} "
                             f"against {base_launches}")
    log(f"[phase3p] dense fleet B={len(rs)} under layout fleet (world 1): "
        f"wall {wall:.2f}s, bit for bit the mesh-less fleet, launches "
        f"{launches}")
    return launches


# --------------------------------------------------------------------------- #
# phase 3p: the fleet layouts                                                  #
# --------------------------------------------------------------------------- #

SERVE_FLEET_NS = (100_000, 200_000) * 2   # 3p (c): four garnets
ELASTIC_N = 100_000                       # 3p (d): launch/elastic.py's n


def count_collectives(fn) -> tuple:
    """``fn()`` with torch.distributed's collective calls counted by kind
    and by the axis they serve: the :class:`repro_torch.core.comm.Axes`
    method that issued them (``state`` / ``action`` / ``fleet``; on a
    world of one the groups of a mesh's dims may be one group, so the
    group alone cannot tell them apart), or ``other`` (the driver's and
    the session's own calls)."""
    import collections
    import torch.distributed as dist
    from repro_torch.core import comm

    calls = collections.Counter()
    axis: list = []
    tags = {"state": ("allgather_state", "gather_start", "psum_state",
                      "pmax_state", "psum_ordered"),
            "action": ("pmin_action", "pmax_action", "psum_action"),
            "fleet": ("any_fleet", "pmax_fleet", "allgather_fleet")}
    saved_methods = {m: getattr(comm.Axes, m)
                     for ms in tags.values() for m in ms}

    def tagged(f, name):
        def wrapped(self, *a, **k):
            axis.append(name)
            try:
                return f(self, *a, **k)
            finally:
                axis.pop()
        return wrapped

    def count(kind, f):
        def wrapped(*a, **k):
            calls[f"{kind}/{axis[0] if axis else 'other'}"] += 1
            return f(*a, **k)
        return wrapped

    saved = dist.all_reduce, comm._all_gather, dist.barrier
    for name, ms in tags.items():
        for m in ms:
            setattr(comm.Axes, m, tagged(saved_methods[m], name))
    dist.all_reduce = count("all_reduce", saved[0])
    comm._all_gather = count("all_gather", saved[1])
    dist.barrier = count("barrier", saved[2])
    try:
        result = fn()
    finally:
        dist.all_reduce, comm._all_gather, dist.barrier = saved
        for m, f in saved_methods.items():
            setattr(comm.Axes, m, f)
    return result, dict(sorted(calls.items()))


def fleet_layout_paths(fleet: dict, device: str = "cuda") -> dict:
    """Phase 3p (a)-(c) on phase 3m's world-1 process group: the fleet
    layouts' solve of 3h's B = 4 ensemble, ``place_function_fleet``, and
    ``Session.solve_fleet`` and a ``Server`` over the fleet mesh."""
    from repro_torch.api import MDP, Session
    from repro_torch.core import driver, generators, partition
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.core.mdp import stack_mdps
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lm
    from repro_torch.serve import Server

    out, launches = {}, {}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    fmeshes = {lay: lm.make_fleet_mesh(1, layout=lay, device=device)
               for lay in partition.FLEET_LAYOUTS}
    # (a) 3h's ensemble, f64 ipi_gmres, under fleet and fleet2d: bit for
    # bit 3h's mesh-less fleet with its launches; wall, idle, collectives
    seeds, base = fleet["_seeds"], fleet["_results"]
    base_launches = fleet["launches"]["cli_fleet_ipi_gmres"]
    opts = IPIOptions(method="ipi_gmres", dtype="float64", atol=1e-8,
                      max_outer=2000)
    for lay, mesh in fmeshes.items():
        solve = (lambda mesh=mesh, lay=lay: driver.solve_many(
            seeds, opts, mesh=mesh, layout=lay, device=device))
        ops.reset_launch_counts()
        rs, wall = timed_solve(solve)
        c = launches[f"fleet_layout_{lay}"] = ops.launch_counts()
        if device == "cuda":
            require_launched(f"3p (a) {lay}", c, ELL_KERNELS)
        bad = [b for b, (r, w) in enumerate(zip(rs, base))
               if not same_bits(r, w)]
        if bad or any(c[k] != base_launches[k] for k in ELL_KERNELS):
            raise AssertionError(f"3p (a) {lay}: lanes {bad} not bit for bit "
                                 f"3h's mesh-less fleet, or launches {c} "
                                 f"against {base_launches}")
        _, calls = count_collectives(solve)
        _, prof = device_profile(solve)
        out[lay] = dict(wall_s=wall, collectives=calls, profile=prof)
        log(f"[phase3p] (a) B={len(rs)} ipi_gmres f64 under {lay} (world "
            f"1): bit for bit 3h's mesh-less fleet, launches {c}; wall "
            f"{wall:.3f}s; collectives {json.dumps(calls)}; profile "
            f"{json.dumps(prof)}")
    axes = partition.mesh_axes(fmeshes["fleet"], "fleet")
    flags = torch.ones((FLEET_B, 5), dtype=torch.float64, device=device)
    for _ in range(10):
        axes.allgather_fleet(flags)
    sync()
    t0 = time.perf_counter()
    for _ in range(200):
        axes.allgather_fleet(flags)
    sync()
    out["fleet_gather_us"] = (time.perf_counter() - t0) / 200 * 1e6
    out["mesh_less_profile"] = fleet["profile"]
    log(f"[phase3p] (a) one fleet gather of the step's flags "
        f"({FLEET_B} x 5 float64): {out['fleet_gather_us']:.1f} us of host "
        f"time; 3h (e)'s mesh-less fleet: wall "
        f"{fleet['profile']['wall_ms']:.1f} ms, idle "
        f"{fleet['profile']['idle_share']}")

    # (b) place_function_fleet of 4 deferred garnets (3n's family) through
    # a Session over the fleet mesh, held to the lanes built one by one
    fns = [MDP.from_generator("garnet", deferred=True, n=N, m=M, k=K,
                              gamma=GAMMA, seed=s) for s in range(FLEET_B)]
    mpi = dict(method="mpi", dtype="float32", atol=1e-4)
    ops.reset_launch_counts()
    with Session({"-device": device, **{f"-{k}": v for k, v in mpi.items()}},
                 mesh=fmeshes["fleet"]) as sess:
        rs, wall = timed_solve(lambda: sess.solve_fleet(fns))
        c = launches["fleet_fn_session"] = ops.launch_counts()
        placed = list(sess._fleet_cache.values())[0]
        layout = sess.stats[-1]["layout"]
        t0 = time.perf_counter()
        lanes = [m.build(device, materialize="device") for m in fns]
        sync()
        t_lanes = time.perf_counter() - t0
        for b, lane in enumerate(lanes):
            for f in ("idx", "val", "cost"):
                if not bits_equal(getattr(placed.block, f)[b],
                                  getattr(lane, f)):
                    raise AssertionError(f"3p (b) lane {b}: the placed {f} "
                                         f"is not the device build's")
        del placed
        base_b = driver.solve_many(stack_mdps(lanes), IPIOptions(**mpi),
                                   device=device)
    if device == "cuda":
        require_launched("3p (b) place_function_fleet", c, ELL_KERNELS)
    bad = [b for b, (r, w) in enumerate(zip(rs, base_b))
           if not same_bits(r, w)]
    if bad or layout != "fleet":
        raise AssertionError(f"3p (b): layout {layout}, lanes {bad} not bit "
                             f"for bit the stacked device-built lanes")
    for m in fns:
        m.evict()
    del lanes, base_b
    torch.cuda.empty_cache()
    out["function_fleet"] = dict(wall_s=wall, build_lanes_s=t_lanes,
                                 outer=[r.outer_iterations for r in rs])
    log(f"[phase3p] (b) place_function_fleet of {FLEET_B} deferred garnets "
        f"n={N} + mpi f32 through a Session over the fleet mesh: "
        f"{wall:.2f}s; tables bit for bit the lanes built one by one "
        f"({t_lanes:.2f}s), results bit for bit their mesh-less fleet; "
        f"launches {c}")

    # (c) Session.solve_fleet and a Server over the fleet mesh, held to
    # solo solves
    t0 = time.perf_counter()
    cores = [generators.garnet(n=n, m=M, k=K, gamma=GAMMA, seed=100 + i)
             for i, n in enumerate(SERVE_FLEET_NS)]
    log(f"[phase3p] (c) {len(cores)} garnets of {sorted(set(SERVE_FLEET_NS))}"
        f" states on the host in {time.perf_counter() - t0:.1f}s")
    solos = [driver.solve(core, opts, device=device) for core in cores]

    def held(what, rs):
        for i, (r, w) in enumerate(zip(rs, solos)):
            dv = float(np.abs(r.v - w.v).max())
            if not (r.converged and np.array_equal(r.policy, w.policy)
                    and (r.outer_iterations, r.inner_iterations)
                    == (w.outer_iterations, w.inner_iterations)
                    and dv <= 1e-10 * float(np.abs(w.v).max())):
                raise AssertionError(f"3p (c) {what} request {i}: "
                                     f"{r.summary()} against its solo "
                                     f"{w.summary()}, dv {dv}")

    serve_opts = {"-device": device, "-method": "ipi_gmres",
                  "-dtype": "float64", "-atol": 1e-8,
                  "-serve_batch_window": 0.05, "-serve_max_batch": 4}
    with Session(serve_opts, mesh=fmeshes["fleet"]) as sess:
        ops.reset_launch_counts()
        rs, wall_s = timed_solve(lambda: sess.solve_fleet(
            [MDP(core) for core in cores]))
        c_s = launches["fleet_session_mesh"] = ops.launch_counts()
        held("Session.solve_fleet", rs)
        buckets = sess.stats[-1]["fleet"]["buckets"]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with Server(session=sess) as srv:
            reqs = [srv.submit(MDP(core)) for core in cores]
            served = [r.result(timeout=600) for r in reqs]
            st, log_d = srv.stats(), srv.dispatch_log()
        wall_v = time.perf_counter() - t0
        c_v = launches["fleet_serve_mesh"] = ops.launch_counts()
        held("Server", served)
    if device == "cuda":
        require_launched("3p (c) Session", c_s, ELL_KERNELS)
        require_launched("3p (c) Server", c_v, ELL_KERNELS)
    out["serve"] = dict(session_wall_s=wall_s, buckets=buckets,
                        server_wall_s=wall_v, dispatches=st["dispatches"],
                        completed=st["completed"],
                        dispatch_log=[dict(n_pad=d["n_pad"], slot=d["slot"],
                                           seconds=d["seconds"])
                                      for d in log_d])
    log(f"[phase3p] (c) Session.solve_fleet over the fleet mesh: {wall_s:.2f}s"
        f", buckets {buckets}, launches {c_s}; Server: {len(served)} "
        f"requests in {st['dispatches']} dispatches, {wall_v:.2f}s, launches "
        f"{c_v}; every request held to its solo solve")
    del cores
    return dict(launches=launches, **out)


def fleet_layout_cli(fleet: dict, device: str = "cuda") -> dict:
    """Phase 3p (d): ``torchrun --nproc-per-node <cards>`` of the solve CLI
    on 3h's ensemble (``--batch 4 --layout fleet --fleet <cards>``): exit
    0, each rank on its own card, every lane held to 3h's mesh-less fleet
    (bit for bit on one card); beside it, ``launch/elastic.py --device
    cuda --batch 4``: a fleet-layout checkpoint resumed (on one card: with
    no mesh), ``|dv| < 1e-9``.  The two run side by side, so each wall
    includes the other's share of the host and the card."""
    n_dev = torch.cuda.device_count() if device == "cuda" else 2
    v_path, pi_path = OUT / "fleet_torchrun_v.npz", OUT / "fleet_torchrun_pi.npz"
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n_dev), "-m", "repro_torch.launch.solve",
            "--", "--instance", "garnet", "--n", str(N), "--m", str(M),
            "--k", str(K), "--gamma", str(GAMMA), "--batch", str(FLEET_B),
            "--layout", "fleet", "--fleet", str(n_dev), "--method",
            "ipi_gmres", "--dtype", "float64", "--atol", "1e-8", "--device",
            device, "--option", f"file_cost={v_path}",
            "--option", f"file_policy={pi_path}"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()

    def cli():
        done = subprocess.run(argv, env=env, capture_output=True, text=True,
                              timeout=900)
        return done, time.perf_counter() - t0

    elastic, e_wall, (proc, wall) = run_beside(
        [sys.executable, "-m", "repro_torch.launch.elastic", "--device",
         device, "--batch", str(FLEET_B), "--n", str(ELASTIC_N),
         "--timeout", "400"], env, cli)
    e_out, e_err = elastic.stdout, elastic.stderr
    log("\n".join(ln for ln in proc.stdout.splitlines()
                   if ln.startswith("[solve]")))
    if proc.returncode != 0:
        raise AssertionError(f"3p (d) torchrun CLI --layout fleet exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    ranks = re.findall(r"\[solve\] rank (\d+) of (\d+) on (\S+)",
                       proc.stdout)
    if len(ranks) != n_dev or (device == "cuda" and
                               len({d for _, _, d in ranks}) != n_dev):
        raise AssertionError(f"3p (d): ranks {ranks}: want {n_dev} ranks "
                             f"each on its own device")
    counts = re.findall(r"\[solve\] kernel launches: (.*)", proc.stdout)
    launches = {k: int(v) for k, v in (kv.split("=") for kv in
                                       counts[-1].split())} if counts else {}
    if device == "cuda":
        require_launched("3p (d) CLI --layout fleet", launches, ELL_KERNELS)
    with np.load(v_path) as zv, np.load(pi_path) as zp:
        for b, w in enumerate(fleet["_results"]):
            v, pi = zv[f"instance_{b}"], zp[f"instance_{b}"]
            dv = float(np.abs(v - w.v).max())
            exact = n_dev == 1 and np.array_equal(v.view(np.uint64),
                                                  w.v.view(np.uint64))
            if not (np.array_equal(pi, w.policy) and (exact or (
                    n_dev > 1 and dv <= 1e-10 * float(np.abs(w.v).max())))):
                raise AssertionError(f"3p (d) lane {b}: max |dv| {dv} "
                                     f"against 3h's fleet")
    log(f"[phase3p] (d) torchrun --nproc-per-node {n_dev} --batch {FLEET_B} "
        f"--layout fleet --fleet {n_dev} (beside elastic.py): exit 0 in "
        f"{wall:.1f}s, lanes held "
        f"to 3h's fleet{' bit for bit' if n_dev == 1 else ''}; launches "
        f"{launches}")
    lines = [ln for ln in e_out.splitlines() if ln.startswith("[elastic]")]
    log("\n".join(lines))
    dv = re.findall(r"\|v - v_ref\|_inf = (\S+)", e_out)
    if elastic.returncode != 0 or not dv or not float(dv[0]) < 1e-9:
        raise AssertionError(f"3p (d) elastic exited {elastic.returncode}: "
                             f"{e_out[-1500:]} {e_err[-1500:]}")
    log(f"[phase3p] (d) launch/elastic.py --device {device} --batch "
        f"{FLEET_B} (beside the torchrun CLI): exit 0, done within "
        f"{e_wall:.1f}s, |dv| {dv[0]}")
    return dict(launches={"fleet_layout_cli": launches}, cli_wall_s=wall,
                world=n_dev, elastic_wall_s=e_wall, elastic_dv=float(dv[0]))


def qvalues_checks(mdp, gen: np.random.Generator) -> dict:
    """Phase 2q: ``ops.ell_qvalues`` (its only path) in float32 and
    float64 between reset and read launch counts, each result bitwise
    equal to the plain version; then the wrapper, the plain version and
    a CSR product plus the same epilogue, timed."""
    from repro_torch.kernels import bellman_ell, ops, ref

    idx, val, cost = mdp.idx, mdp.val, mdp.cost
    n, m, k = idx.shape
    vs = {dt: torch.from_numpy(gen.random(n) * 50.0).to("cuda", dt)
          for dt in (torch.float32, torch.float64)}
    ops.reset_launch_counts()
    got = {dt: ops.ell_qvalues(idx, val, cost, GAMMA, v)
           for dt, v in vs.items()}
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    require_launched("ops.ell_qvalues", launches, ("ell_qvalues",))
    out = {}
    for dt, v in vs.items():
        name = str(dt).replace("torch.", "")
        want = ref.ell_qvalues(idx, val, cost, GAMMA, v)
        torch.cuda.synchronize()
        if not bits_equal(got[dt], want):
            raise AssertionError(f"ell_qvalues {name}: kernel != plain "
                                 f"version (max |diff| "
                                 f"{max_abs_diff(got[dt], want)})")
        csr = ell_as_csr(idx.view(n * m, k), val.view(n * m, k), n, dt)

        def library(csr=csr, v=v):
            return cost.to(v.dtype) + GAMMA * (csr @ v).view(n, m)

        nbytes = idx.nbytes + val.nbytes + cost.nbytes + v.nbytes \
            + got[dt].nbytes
        flops = n * m * (2 * k + 2)
        b_ms, b_by = bound_ms(nbytes, flops, dt)
        out[name] = dict(
            max_abs_err=max_abs_diff(got[dt], want),
            ms=time_ms(lambda: bellman_ell.ell_qvalues(idx, val, cost, GAMMA,
                                                       v)),
            plain_ms=time_ms(lambda: ref.ell_qvalues(idx, val, cost, GAMMA,
                                                     v)),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library),
            library_max_abs_diff=max_abs_diff(library(), want),
            bytes=nbytes, flops=flops)
        del csr
        log(f"[phase2q] ell_qvalues {name}: {out[name]['ms']:.4f} ms (plain "
            f"{out[name]['plain_ms']:.4f}, csr+epilogue "
            f"{out[name]['library_ms']:.4f}, bound {b_ms:.4f} by {b_by}); "
            f"bitwise equal")
    out["launches"] = launches
    return out


def flash_within_tolerance(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst ratio of |kernel - plain| to the stated bf16 tolerance: one
    bf16 ulp of the larger value (2^-7 relative: both round an f32 result
    that differs in its last bits) plus 1e-5.  At most 1 passes."""
    g, w = got.float(), want.float()
    tol = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-5
    return float(((g - w).abs() / tol).max())


def flash_checks() -> dict:
    """Phase 2f: ``flash_attention`` against its plain version at the
    serving paths' prefill shapes (B=4, T=S, bf16) for each head layout of
    ``FLASH_CASES``, timed beside SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    b = LM_BATCH
    out = {}
    for name, h, kv, d, t, causal in FLASH_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16)
                   for shape in ((b, t, h, d), (b, t, kv, d), (b, t, kv, d)))
        got = flash_attention.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ratio = flash_within_tolerance(got, want)
        if not ratio <= 1.0:
            raise AssertionError(f"flash_attention {name}: kernel vs plain "
                                 f"version {ratio:.3f}x the tolerance (max "
                                 f"|diff| {max_abs_diff(got, want)})")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        nbytes = q.nbytes + k.nbytes + v.nbytes + got.nbytes
        # QK^T and PV over the (query, key) pairs the mask keeps
        flops = 4 * b * h * d * (t * (t + 1) // 2 if causal else t * t)
        b_ms, b_by = bound_ms(nbytes, flops, torch.bfloat16)
        out[name] = dict(
            shape=dict(B=b, T=t, S=t, H=h, KV=kv, d=d), dtype="bfloat16",
            causal=causal, max_abs_err=max_abs_diff(got, want),
            tolerance_ratio=ratio,
            ms=time_ms(lambda: flash_attention.flash_attention(
                q, k, v, causal=causal)),
            plain_ms=time_ms(lambda: ref.flash_attention(q, k, v,
                                                         causal=causal),
                             reps=PLAIN_FLASH_REPS),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library),
            library_max_abs_diff=max_abs_diff(library().transpose(1, 2),
                                              want),
            bytes=nbytes, flops=flops)
        r = out[name]
        r["tflops"] = flops / r["ms"] / 1e9
        r["bound_share"] = b_ms / r["ms"]
        log(f"[phase2f] flash_attention {name} (H={h}, KV={kv}, d={d}, "
            f"T=S={t}, causal={causal}): "
            f"{r['ms']:.4f} ms, {r['tflops']:.1f} TFLOP/s, "
            f"{r['bound_share']:.1%} of the bound (plain "
            f"{r['plain_ms']:.3f}, sdpa {r['library_ms']:.4f}, bound "
            f"{b_ms:.4f} by {b_by}); max |diff| {r['max_abs_err']:.3e} "
            f"(sdpa's {r['library_max_abs_diff']:.3e}), {ratio:.3f}x the "
            f"tolerance")
    return out


def flash_report(library: Path) -> dict:
    """The bf16 kernel at each head dim the serving configs use (d = 128:
    DC=8, d = 80: DC=5, d = 64: DC=4), read from the library that ran
    phase 2f: its registers, dynamic shared memory and local memory as the
    runtime holds them (``flash_attention_bf16_attributes``, after the
    launches), its
    spills and ptxas's advisories from the library's build log (``-Xptxas
    -v``), and its tensor-core and copy instructions from ``cuobjdump
    -sass``.  Raises if a kernel has no tensor-core instruction or ptxas
    serialized its wgmma products (advisory C7518: still right, slower)."""
    import ctypes

    from repro_torch.kernels import build
    ptxas = build.build_log(library).read_text()
    entries = ptxas_entries(ptxas)
    sass = subprocess.run(
        [str(Path(build.nvcc()).parent / "cuobjdump"), "-sass",
         str(library)], capture_output=True, text=True, check=True).stdout
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "flash_attention.sass.txt").write_text(sass)
    funcs = re.split(r"\n\s*Function : ", sass)
    lib = build.load("flash_attention")
    report = {}
    for dc, d in ((8, 128), (5, 80), (4, 64)):
        tag = f"flash_fwd_bf16ILi{dc}E"
        attrs = (ctypes.c_int * 4)()
        build.check(lib.flash_attention_bf16_attributes(d, attrs),
                    f"flash_attention_bf16_attributes({d})")
        entry = next((row for name, row in entries.items() if tag in name),
                     None)
        if entry is None:
            raise AssertionError(f"ptxas printed nothing for {tag}")
        body = next(f for f in funcs if f.startswith("_Z") and tag in
                    f.split("\n", 1)[0])
        ops = {}
        for op in re.findall(r"\b((?:HMMA|HGMMA|LDSM|LDGSTS|MUFU\.EX2)"
                             r"[.xA-Z0-9]*)", body):
            ops[op] = ops.get(op, 0) + 1
        report[f"DC={dc}"] = dict(
            registers=attrs[0], dynamic_smem_bytes=attrs[1],
            local_bytes=attrs[2], static_smem_bytes=attrs[3],
            spill_store_bytes=entry["spill_store_bytes"],
            spill_load_bytes=entry["spill_load_bytes"], sass=ops)
        if not any(op.startswith(("HMMA", "HGMMA")) for op in ops):
            raise AssertionError(f"{tag}: no tensor-core instruction in "
                                 f"its SASS: {ops}")
        serialized = [line for line in ptxas.splitlines()
                      if "serialized" in line and tag in line]
        if serialized:
            raise AssertionError(f"{tag}: ptxas serialized its wgmma "
                                 f"products: {serialized}")
    log(f"[phase2f] bf16 flash kernel resources: {json.dumps(report)}")
    return report


def lm_main_path() -> dict:
    """Phase 3f: the serve_lm CLI at full width with its own launch counts;
    then the decode-vs-prefill check, each step with its own counts; then
    the prefill profiled."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = get_config(LM_ARCH)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = serve_lm.main(["--arch", LM_ARCH, "--batch", str(LM_BATCH),
                        "--prompt-len", str(LM_PROMPT), "--gen",
                        str(LM_GEN)])
    t_cli = time.perf_counter() - t0
    cli_launches = ops.launch_counts()
    if rc != 0:
        raise AssertionError(f"serve_lm exited {rc}")
    require_launched("serve_lm", cli_launches, ("flash_attention",))
    if cli_launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"serve_lm: flash_attention launched "
                             f"{cli_launches['flash_attention']} times, not "
                             f"once per layer ({cfg.n_layers}) of one "
                             f"prefill")
    log(f"[phase3f] serve_lm CLI wall={t_cli:.2f}s (weights built "
        f"included); launches {cli_launches}")
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(1)
    model = build_model(cfg, generator=gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 1),
                         generator=gen, device="cuda")
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    ops.reset_launch_counts()
    _, cache = prefill(toks[:, :LM_PROMPT])
    torch.cuda.synchronize()
    prefill_launches = ops.launch_counts()
    cache = model.extend_cache(cache, 1)
    ops.reset_launch_counts()
    _, logits_dec, cache_out = decode(toks[:, LM_PROMPT:], cache)
    torch.cuda.synchronize()
    decode_launches = ops.launch_counts()
    # the same step again (it rewrites the same slot: ``cache`` still says
    # len = LM_PROMPT), profiled
    _, decode_prof = device_profile(lambda: decode(toks[:, LM_PROMPT:],
                                                   cache))
    log(f"[phase3f] decode step profile: {json.dumps(decode_prof)}")
    del cache, cache_out
    logits_full, _ = prefill(toks)
    if prefill_launches["flash_attention"] != cfg.n_layers or \
            any(decode_launches.values()):
        raise AssertionError(f"prefill launches {prefill_launches}, decode "
                             f"launches {decode_launches}")
    diff = max_abs_diff(logits_dec, logits_full)
    scale = float(logits_full.float().abs().max())
    finite = bool(torch.isfinite(logits_dec.float()).all()
                  and torch.isfinite(logits_full.float()).all())
    argmax_equal = float((logits_dec.argmax(-1) == logits_full.argmax(-1))
                         .float().mean())
    check = dict(max_abs_diff=diff, max_abs_logit=scale,
                 rel=diff / scale, tol=DECODE_TOL, argmax_equal=argmax_equal,
                 shape=list(logits_dec.shape), dtype=str(logits_dec.dtype))
    log(f"[phase3f] decode vs prefill over {LM_PROMPT + 1} tokens: "
        f"{json.dumps(check)}")
    if not (finite and tuple(logits_dec.shape) ==
            (LM_BATCH, 1, cfg.vocab_size) and diff <= DECODE_TOL * scale):
        raise AssertionError(f"decode vs prefill check failed: {check}")

    _, prof = device_profile(lambda: prefill(toks[:, :LM_PROMPT]))
    log(f"[phase3f] prefill profile: {json.dumps(prof)}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches={"serve_lm_cli": cli_launches,
                          "prefill": prefill_launches,
                          "decode": decode_launches},
                cli_wall_s=t_cli, decode_check=check, prefill_profile=prof,
                decode_profile=decode_prof)


def parity_run(cfg, batch: int, prompt: int, seed: int) -> dict:
    """``cfg`` in float32 with the same weights on the card and on the
    host (drawn on the card from ``seed``), the same prompt and stub
    inputs: prefill and ``PARITY_GEN`` greedy decode steps.  Logits within
    ``PARITY_TOL`` of their largest magnitude at every step and the tokens
    equal, or it raises."""
    from repro_torch.launch.serve_lm import stub_inputs
    from repro_torch.models import DecoderLM, WhisperModel, build_model
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    card = build_model(cfg, generator=gen, device="cuda")
    host = (WhisperModel if cfg.family == "encdec" else DecoderLM)(
        cfg, device="cpu")
    host.load_state_dict(card.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device="cuda")
    extra = stub_inputs(cfg, batch, gen)
    runs = {}
    for name, model in (("card", card), ("host", host)):
        dev = model.embed.device
        prefill, decode = make_prefill_step(model), make_decode_step(model)
        logits, cache = prefill(toks.to(dev),
                                None if extra is None else extra.to(dev))
        cache = model.extend_cache(cache, PARITY_GEN)
        tok, out, steps = torch.argmax(logits, -1), [], [logits]
        for _ in range(PARITY_GEN):
            out.append(tok)
            tok, logits, cache = decode(tok, cache)
            steps.append(logits)
        runs[name] = (torch.cat(out, 1).cpu(), [x.cpu() for x in steps])
    rel = max(max_abs_diff(g, w) / float(w.abs().max())
              for g, w in zip(runs["card"][1], runs["host"][1]))
    same = bool(torch.equal(runs["card"][0], runs["host"][0]))
    row = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, prompt=prompt, batch=batch,
               steps=PARITY_GEN + 1, max_rel_logit_diff=rel, tol=PARITY_TOL,
               tokens_equal=same, tokens=runs["card"][0][0].tolist())
    if cfg.family == "encdec":
        row["encoder_layers"] = cfg.encoder_layers
    del card, host
    gc.collect()
    torch.cuda.empty_cache()
    if not (same and rel <= PARITY_TOL):
        raise AssertionError(f"LM GPU vs CPU parity failed: {row}")
    return row


def lm_parity() -> dict:
    """Phase 4f: minitron-8b at full width but 2 layers, float32, the same
    weights on the card and on the host: prefill and greedy decode."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2)
    row = parity_run(cfg, PARITY_BATCH, PARITY_PROMPT, seed=2)
    log(f"[phase4f] {json.dumps(row)}")
    return row


def lm_serve_loop(model, prompts, place=None) -> dict:
    """serve_lm's loop on ``model``: prefill (its flash launches counted),
    ``extend_cache`` (then ``place(cache)`` where given), ``LM_GEN - 1``
    greedy decode steps; the tokens, every step's logits and the final
    cache (one free slot left)."""
    from repro_torch.kernels import ops
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    prefill, decode = make_prefill_step(model), make_decode_step(model)
    ops.reset_launch_counts()
    logits, cache = prefill(prompts)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    cache = model.extend_cache(cache, LM_GEN)
    if place is not None:
        cache = place(cache)
    tok = torch.argmax(logits, dim=-1)
    out, steps = [tok], [logits]
    for _ in range(LM_GEN - 1):
        tok, logits, cache = decode(tok, cache)
        out.append(tok)
        steps.append(logits)
    torch.cuda.synchronize()
    return dict(tokens=torch.cat(out, 1), logits=steps, cache=cache,
                tok=tok, launches=launches, prefill=prefill, decode=decode)


def lm_placed(lm: dict) -> dict:
    """Phase 3v: serve_lm's run of phase 3f (minitron-8b uncut, seed 0,
    batch LM_BATCH, prompt LM_PROMPT, LM_GEN greedy tokens) in-process,
    unplaced and then placed on a ``(1, 1)`` mesh over a world-1 NCCL
    group (``place`` by ``infer_param_specs``, the cache by
    ``place_cache``): tokens and every step's logits bit for bit, one
    flash launch a layer in each prefill, the collectives of a placed
    prefill and decode step by kind (the dry run's counter), and both
    runs' prefill and decode step profiled beside 3f's."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.dryrun import StepMeter
    from repro_torch.models import build_model
    from repro_torch.train import sharding as shd

    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)     # serve_lm's
    model = build_model(cfg, generator=gen, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=gen, device="cuda")
    runs, profiles = {}, {}

    def profile(name, run):
        _, profiles[f"{name}_prefill"] = device_profile(
            lambda: run["prefill"](prompts))
        _, profiles[f"{name}_decode"] = device_profile(
            lambda: run["decode"](run["tok"], run["cache"]))

    runs["unplaced"], unplaced_s = sync_wall(
        lambda: lm_serve_loop(model, prompts))
    profile("unplaced", runs["unplaced"])
    lmesh.init_distributed("cuda", store=dist.HashStore(), rank=0,
                           world_size=1)
    try:
        mesh = lmesh.make_host_mesh((1, 1), device="cuda")
        shd.place(model, mesh, shd.infer_param_specs(model, mesh))
        runs["placed"], placed_s = sync_wall(lambda: lm_serve_loop(
            model, prompts, lambda c: shd.place_cache(c, mesh, cfg,
                                                      LM_BATCH)))
        run = runs["placed"]
        with StepMeter() as m_prefill:
            run["prefill"](prompts)
        with StepMeter() as m_decode:
            run["decode"](run["tok"], run["cache"])
        torch.cuda.synchronize()
        profile("placed", run)
    finally:
        lmesh.shutdown()
    a, b = runs["unplaced"], runs["placed"]
    same = dict(tokens=bits_equal(a["tokens"], b["tokens"]),
                logits=all(bits_equal(x, y)
                           for x, y in zip(a["logits"], b["logits"])))
    out = dict(
        arch=LM_ARCH, batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN,
        mesh={"data": 1, "model": 1}, bit_for_bit=same,
        launches={k: r["launches"] for k, r in runs.items()},
        collectives_prefill=m_prefill.by_kind(),
        collective_ops_prefill=dict(m_prefill.calls),
        collectives_decode=m_decode.by_kind(),
        collective_ops_decode=dict(m_decode.calls),
        serve_s=dict(unplaced=unplaced_s, placed=placed_s),
        walls_ms={k: p["wall_ms"] for k, p in profiles.items()},
        idle_share={k: p["idle_share"] for k, p in profiles.items()},
        walls_ms_3f=dict(prefill=lm["prefill_profile"]["wall_ms"],
                         decode=lm["decode_profile"]["wall_ms"]),
        idle_share_3f=dict(prefill=lm["prefill_profile"]["idle_share"],
                           decode=lm["decode_profile"]["idle_share"]),
        tokens=b["tokens"][0].tolist())
    log(f"[phase3v] {json.dumps(out)}")
    for k, p in profiles.items():
        log(f"[phase3v] {k} profile: {json.dumps(p)}")
    del model, runs
    gc.collect()
    torch.cuda.empty_cache()
    flash = {k: v["flash_attention"] for k, v in out["launches"].items()}
    if not all(same.values()):
        raise AssertionError(f"3v: the placed run is not the unplaced one "
                             f"bit for bit: {same}")
    if set(flash.values()) != {cfg.n_layers}:
        raise AssertionError(f"3v: flash launches a prefill {flash}, not "
                             f"{cfg.n_layers}")
    return out


def dryrun_cell_beside(beside) -> tuple:
    """Phase 3v (b): the dry run of ``DRYRUN_CELL`` (a full-size cell at
    256 ranks of the fake backend, on the host) in a process of its own
    while ``beside()`` runs here (:func:`run_beside`); its record is
    logged, and ``beside()``'s result returned with it."""
    OUT.mkdir(parents=True, exist_ok=True)
    arch, shape, mesh = DRYRUN_CELL
    path = OUT / "dryrun_cell.json"
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--mesh", mesh, "--out", str(path)]
    # one thread: the phases beside it are host-bound too
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    done, wall, got = run_beside(argv, env=env, beside=beside, timeout=900)
    if done.returncode != 0:
        raise AssertionError(f"3v (b): the dry run exited "
                             f"{done.returncode}:\n{done.stderr[-3000:]}")
    rec = json.loads(path.read_text())[f"{arch}/{shape}/{mesh}"]
    log(f"[phase3v] (b) dry run {arch}/{shape}/{mesh} in {wall:.1f}s "
        f"(beside 3m-3p): {json.dumps(rec)}")
    return rec, got


# --------------------------------------------------------------------------- #
# phases 3l / 4l: the other LM families                                       #
# --------------------------------------------------------------------------- #

def attention_layers(cfg) -> int:
    """Flash launches of one prefill: one per attention layer (the
    hybrid's shared block once a call site; whisper's encoder and decoder
    layers; none for the ssm family)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "encdec":
        return cfg.encoder_layers + cfg.n_layers
    return cfg.n_layers


def require_flash_only(what: str, launches: dict, want: int) -> None:
    """``flash_attention`` launched ``want`` times and no other kernel."""
    other = {k: n for k, n in launches.items()
             if k != "flash_attention" and n}
    if launches["flash_attention"] != want or other:
        raise AssertionError(f"{what}: launches {launches}, want "
                             f"flash_attention {want} and no other kernel")


def sync_wall(fn):
    """``fn()`` between two syncs: its result and wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def decode_check(model, toks: torch.Tensor, extra, prompt: int) -> dict:
    """Prefill over ``prompt`` tokens, then one decode step fed token
    ``prompt + 1``, against a prefill over ``prompt + 1`` tokens: the
    logits within ``DECODE_TOL`` of their largest magnitude (``ok``) and
    finite."""
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    prefill, decode = make_prefill_step(model), make_decode_step(model)
    _, cache = prefill(toks[:, :prompt], extra)
    cache = model.extend_cache(cache, 1)
    _, logits_dec, _ = decode(toks[:, prompt:], cache)
    del cache
    logits_full, _ = prefill(toks, extra)
    diff = max_abs_diff(logits_dec, logits_full)
    scale = float(logits_full.float().abs().max())
    finite = bool(torch.isfinite(logits_dec.float()).all()
                  and torch.isfinite(logits_full.float()).all())
    return dict(batch=toks.shape[0], max_abs_diff=diff, max_abs_logit=scale,
                rel=diff / scale, tol=DECODE_TOL,
                argmax_equal=float((logits_dec.argmax(-1)
                                    == logits_full.argmax(-1))
                                   .float().mean()),
                ok=finite and diff <= DECODE_TOL * scale)


def serve_family(cfg, prompt: int) -> dict:
    """3l for one configuration, built in the script from a seed: prefill
    over ``prompt`` tokens (and the stub inputs) and ``LM_GEN - 1`` greedy
    decode steps, timed with their launches counted, every logit finite;
    a warm prefill and the last decode step profiled; then
    :func:`decode_check` (bf16).

    For the moe family that check, as served, is logged only: a prefill
    over t + 1 is another function than a prefill over t plus a decode
    step, in the reference as in the port.  Capacity is taken slot by
    slot, so a group's later tokens (the zero rows that pad the last
    group among them) take an expert's capacity before an earlier
    token's later slot, and the decoded token, dropless in its group of
    B, loses slots in the prefill's.  The check that decides runs the same
    weights (drawn again from the seed) with groups of ``256 // top_k``
    tokens, the reference's dropless regime (``_capacity``), on row 0
    (the experts' buffers are E x tokens x d)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_lm import stub_inputs
    from repro_torch.models import build_model
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    gen = torch.Generator(device="cuda").manual_seed(1)
    model, build_s = sync_wall(lambda: build_model(cfg, generator=gen,
                                                   device="cuda"))
    toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, prompt + 1),
                         generator=gen, device="cuda")
    extra = stub_inputs(cfg, LM_BATCH, gen)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    ops.reset_launch_counts()
    (logits, cache), prefill_s = sync_wall(
        lambda: prefill(toks[:, :prompt], extra))
    prefill_launches = ops.launch_counts()
    require_flash_only(f"{cfg.name} prefill", prefill_launches,
                       attention_layers(cfg))
    finite = bool(torch.isfinite(logits.float()).all())
    cache = model.extend_cache(cache, LM_GEN)
    ops.reset_launch_counts()
    tok, step_s = torch.argmax(logits, -1), []
    for _ in range(LM_GEN - 2):
        (tok, logits, cache), wall = sync_wall(lambda: decode(tok, cache))
        step_s.append(wall)
        finite &= bool(torch.isfinite(logits.float()).all())
    (tok, logits, cache), decode_prof = device_profile(
        lambda: decode(tok, cache))
    finite &= bool(torch.isfinite(logits.float()).all())
    decode_launches = ops.launch_counts()
    require_flash_only(f"{cfg.name} decode", decode_launches, 0)
    del cache, logits
    _, prefill_prof = device_profile(
        lambda: prefill(toks[:, :prompt], extra))
    checks = {"as_served": decode_check(model, toks, extra, prompt)}
    row = dict(arch=cfg.name, layers=cfg.n_layers, prompt=prompt,
               batch=LM_BATCH, gen=LM_GEN, weights_gb=sum(
                   p.nbytes for p in model.state_dict().values()) / 1e9,
               build_s=build_s, prefill_s=prefill_s,
               decode_step_ms=statistics.median(step_s) * 1e3,
               finite=finite, launches={"prefill": prefill_launches,
                                        "decode": decode_launches},
               decode_check=checks, prefill_profile=prefill_prof,
               decode_profile=decode_prof)
    if cfg.family == "vlm":
        row["patches"] = cfg.n_patches
    if cfg.family == "encdec":
        row["frames"] = cfg.encoder_len
    del model
    gc.collect()
    torch.cuda.empty_cache()
    gate = checks["as_served"]
    if cfg.family == "moe":
        dropless = dataclasses.replace(cfg,
                                       moe_group_size=256 // cfg.top_k)
        gen = torch.Generator(device="cuda").manual_seed(1)
        model = build_model(dropless, generator=gen, device="cuda")
        gate = checks["dropless_groups"] = decode_check(
            model, toks[:1], None, prompt)
        gate["moe_group_size"] = dropless.moe_group_size
        del model
        gc.collect()
        torch.cuda.empty_cache()
    if not (finite and gate["ok"]):
        raise AssertionError(f"{cfg.name}: decode vs prefill check failed "
                             f"(finite {finite}): {checks}")
    return row


def lm_family_paths() -> dict:
    """Phase 3l: each of ``FAMILY_RUNS`` through the serve_lm CLI (full
    depth) and built in the script (:func:`serve_family`)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_lm

    out = {}
    for arch, prompt, depth in FAMILY_RUNS:
        cfg = get_config(arch)
        row = {}
        if depth is None:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rc, text = run_cli(serve_lm.main, [
                "--arch", arch, "--batch", str(LM_BATCH), "--prompt-len",
                str(prompt), "--gen", str(LM_GEN)])
            cli_s = time.perf_counter() - t0
            launches = ops.launch_counts()
            if rc != 0:
                raise AssertionError(f"serve_lm --arch {arch} exited {rc}")
            require_flash_only(f"serve_lm --arch {arch}", launches,
                               attention_layers(cfg))
            m = re.search(r"prefill=([\d.]+)s decode=([\d.]+)ms/tok", text)
            row = dict(cli_wall_s=cli_s, cli_prefill_s=float(m[1]),
                       cli_decode_ms=float(m[2]), cli_launches=launches)
            gc.collect()
            torch.cuda.empty_cache()
        else:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        row.update(serve_family(cfg, prompt))
        out[arch] = row
        brief = {k: v for k, v in row.items()
                 if not k.endswith("_profile")}
        log(f"[phase3l] {arch}: {json.dumps(brief)}")
        for what in ("prefill", "decode"):
            log(f"[phase3l] {arch} {what} profile: "
                f"{json.dumps(row[what + '_profile'])}")
    return out


def lm_family_parity() -> list:
    """Phase 4l: :func:`parity_run` for each of ``FAMILY_PARITY``."""
    from repro_torch.configs import get_config

    rows = []
    for arch, depth in FAMILY_PARITY:
        cfg = dataclasses.replace(get_config(arch), **depth)
        row = parity_run(cfg, FAMILY_PARITY_BATCH, FAMILY_PARITY_PROMPT,
                         seed=3)
        log(f"[phase4l] {json.dumps(row)}")
        rows.append(row)
    return rows


# --------------------------------------------------------------------------- #
# phases 3r / 4r: LM training                                                 #
# --------------------------------------------------------------------------- #

TRAIN_ARCH = "stablelm-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 2048, 2, 4
# 3r (c): (arch, depth cut, batch, sequence incl. patches, optimizer)
TRAIN_FAMILIES = (("mamba2-130m", {}, 4, 2048, None),
                  ("whisper-base", {}, 4, 448, None),
                  ("olmoe-1b-7b", dict(n_layers=2), 4, 2048, None),
                  ("zamba2-1.2b", dict(n_layers=6), 4, 2048, None),
                  ("llava-next-34b", dict(n_layers=2), 2, 512 + 2880, None),
                  ("stablelm-3b", dict(n_layers=2), 4, 2048, "adafactor"))
# 3r (d): the CLI's resume at the smoke config
TRAIN_RESUME = ["--arch", TRAIN_ARCH, "--smoke", "--batch", "8", "--seq",
                "128", "--log-every", "1"]
# phase 4r: (arch, depth cut); f32, batch 2, seq 64, 2 microbatches
TRAIN_PARITY = (("stablelm-3b", dict(n_layers=1)),
                ("olmoe-1b-7b", dict(n_layers=1)))
TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 64
# 3r (e): the updated weights held bit for bit against (b)'s first step
TRAIN_SHARDED_WEIGHTS = ("blocks.0.attn.wq", "blocks.0.mlp.w_down",
                         "final_norm")
TRAIN_TOL = 1e-4     # GPU vs CPU: metrics relative, tensors of max |x|
ATTN_PROJ = ("wq", "wk", "wv", "wo")


def train_source(cfg, batch: int, seq: int, device: str = "cuda"):
    from repro_torch.data.pipeline import SyntheticSource

    return SyntheticSource(
        cfg.vocab_size, seq, batch, n_patches=cfg.n_patches,
        d_model=cfg.d_model,
        encoder_len=cfg.encoder_len if cfg.family == "encdec" else 0,
        device=device)


def require_no_kernel(what: str, launches: dict) -> None:
    """The train step launches no hand-written kernel: the reference
    trains through no TPU kernel, and the flash kernel has no backward."""
    if any(launches.values()):
        raise AssertionError(f"{what}: launches {launches}, want none (the "
                             f"train step runs the chunked attention scan)")


def finite_metrics(what: str, metrics: dict) -> dict:
    out = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"{what}: non-finite metrics {out}")
    return out


def train_cli() -> dict:
    """3r (a): the training CLI at stablelm-3b's full width, one line a
    step, every loss and grad norm finite, no kernel launched."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc, text = run_cli(train.main, [
        "--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--microbatches",
        str(TRAIN_MICRO), "--log-every", "1"])
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = re.findall(r"\[train\] step=(\d+) loss=(\S+) gnorm=(\S+) "
                       r"(\d+)ms/step", text)
    if rc != 0 or len(steps) != TRAIN_STEPS or not all(
            np.isfinite(float(x)) for _, loss, gn, _ in steps
            for x in (loss, gn)):
        raise AssertionError(f"train CLI: exit {rc}, steps {steps}")
    require_no_kernel("train CLI", launches)
    out = dict(wall_s=wall, launches=launches,
               steps=[dict(step=int(a), loss=float(b), grad_norm=float(c),
                           ms_per_step=int(d)) for a, b, c, d in steps])
    log(f"[phase3r] (a) train CLI {TRAIN_ARCH} --steps {TRAIN_STEPS} "
        f"--batch {TRAIN_BATCH} --seq {TRAIN_SEQ} --microbatches "
        f"{TRAIN_MICRO}: {json.dumps(out)}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_step_main() -> dict:
    """3r (b): a warm train step of stablelm-3b built in the script: no
    kernel launched, every attention projection's gradient non-zero and
    finite, the peak bytes beside the bytes ``launch/specs.py`` reckons;
    then a step timed and profiled."""
    from repro_torch.configs import get_config, get_train_config
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import apply_updates, init_opt_state
    from repro_torch.train.steps import accumulate_grads, make_train_step

    cfg, tcfg = get_config(TRAIN_ARCH), get_train_config(TRAIN_ARCH)
    meta, _, _ = specs.param_specs(TRAIN_ARCH, {"data": 1})
    reckoned = specs.state_bytes(
        meta, specs.opt_specs(TRAIN_ARCH, {"data": 1}, meta)[0], tcfg)
    model = build_model(cfg, generator=torch.Generator(device="cuda")
                        .manual_seed(0), device="cuda")
    opt = init_opt_state(model, tcfg)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    batch = train_source(cfg, TRAIN_BATCH, TRAIN_SEQ).next_batch(0)
    step_fn = make_train_step(model, tcfg, n_microbatches=TRAIN_MICRO)
    (opt, met0), first_s = sync_wall(lambda: step_fn(opt, 0, batch))  # warm
    # (e)'s reference: the first step's metrics and a few updated weights
    first = dict(metrics={k: v.detach().cpu() for k, v in met0.items()},
                 weights={n: model.get_parameter(n).detach().cpu().clone()
                          for n in TRAIN_SHARDED_WEIGHTS}, step_s=first_s)

    # the train step's two halves, counted
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    grads, metrics = accumulate_grads(model, tcfg, batch,
                                      n_microbatches=TRAIN_MICRO)
    opt, gnorm = apply_updates(model, grads, opt, 1, tcfg)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    require_no_kernel("train step", launches)
    metrics = finite_metrics("train step", {**metrics, "grad_norm": gnorm})
    proj = {n: float(g.float().norm()) for n, g in grads.items()
            if n.rsplit(".", 1)[-1] in ATTN_PROJ}
    if len(proj) != 4 * cfg.n_layers or not all(
            np.isfinite(v) and v > 0 for v in proj.values()):
        raise AssertionError(f"attention projections' gradients: {proj}")
    del grads
    (opt, _), prof = device_profile(lambda: step_fn(opt, 2, batch))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = dict(arch=TRAIN_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               microbatches=TRAIN_MICRO, launches=launches, metrics=metrics,
               attn_proj_grad_norm_min=min(proj.values()),
               step_s=prof["wall_ms"] / 1e3,
               tokens_per_s=tokens / (prof["wall_ms"] / 1e3),
               reckoned_bytes=reckoned, resident_bytes=resident,
               peak_bytes=peak, peak_over_reckoned=peak / reckoned["total"],
               idle_share=prof["idle_share"])
    log(f"[phase3r] (b) {json.dumps(out)}")
    log(f"[phase3r] (b) train step profile: {json.dumps(prof)}")
    out["profile"], out["first"] = prof, first
    del model, opt, batch, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_families() -> list:
    """3r (c): two train steps of each of ``TRAIN_FAMILIES`` at its
    published width (depth as cut), built in the script, the second
    timed and counted: finite metrics, MoE's aux losses non-zero, no
    kernel launched; Adafactor's factored second moment reached."""
    from repro_torch.configs import get_config, get_train_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.steps import make_train_step

    rows = []
    for arch, cut, batch, seq, optim in TRAIN_FAMILIES:
        cfg = dataclasses.replace(get_config(arch), **cut)
        tcfg = get_train_config(arch)
        if optim:
            tcfg = dataclasses.replace(tcfg, optimizer=optim)
        model = build_model(cfg, generator=torch.Generator(device="cuda")
                            .manual_seed(0), device="cuda")
        opt = init_opt_state(model, tcfg)
        data = train_source(cfg, batch, seq).next_batch(0)
        step_fn = make_train_step(model, tcfg, n_microbatches=TRAIN_MICRO)
        (opt, cold), cold_s = sync_wall(lambda: step_fn(opt, 0, data))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        (opt, metrics), wall = sync_wall(lambda: step_fn(opt, 1, data))
        launches = ops.launch_counts()
        require_no_kernel(f"{arch} train step", launches)
        metrics = finite_metrics(arch, metrics)
        finite_metrics(arch, cold)
        row = dict(arch=arch, layers=cfg.n_layers, batch=batch, seq=seq,
                   optimizer=tcfg.optimizer, launches=launches,
                   first_step_s=cold_s, step_s=wall, metrics=metrics,
                   weights_gb=sum(p.nbytes for p in model.parameters())
                   / 1e9, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        if cfg.family == "moe" and not (metrics["load_balance_loss"] > 0
                                        and metrics["router_z_loss"] > 0):
            raise AssertionError(f"{arch}: aux losses {metrics}")
        if tcfg.optimizer == "adafactor":
            row["factored"] = sum(opt["vr"][n].dim() < p.dim()
                                  for n, p in model.named_parameters())
            if not row["factored"]:
                raise AssertionError(f"{arch}: Adafactor never factored")
        log(f"[phase3r] (c) {json.dumps(row)}")
        rows.append(row)
        del model, opt, data, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    log("[phase3r] (c) arctic-480b: training held on the CPU only "
        "(tests/test_torch_train_families.py): one layer is 28.1 GB of bf16 "
        "weights, and Adafactor's f32 masters (56 GB) with the bf16 "
        "gradients (28 GB) pass the card's 80 GB")
    return rows


def train_resume() -> dict:
    """3r (d): the CLI on the card at the smoke config, 4 steps straight
    against 2 steps then 2 resumed: the checkpoints bit for bit."""
    from repro_torch.launch import train

    root = OUT / "train_resume"
    shutil.rmtree(root, ignore_errors=True)
    texts = {}
    for name, steps in (("a", 4), ("b", 2), ("b", 4)):
        if (name, steps) == ("b", 4):     # (e) resumes the same file
            (root / "e").mkdir()
            shutil.copy(root / "b" / f"step_{2:010d}.npz", root / "e")
        rc, texts[name] = run_cli(train.main, TRAIN_RESUME + [
            "--steps", str(steps), "--ckpt-dir", str(root / name)])
        if rc != 0:
            raise AssertionError(f"train CLI --smoke --steps {steps}: {rc}")
    same = ckpt_leaves_equal(root / "a", root / "b", 4)
    out = dict(leaves=same, bit_for_bit=bool(same))
    log(f"[phase3r] (d) resume on the card, 4 straight vs 2 + 2: "
        f"{json.dumps(out)}")
    if not same:
        raise AssertionError("the resumed run's weights and state differ")
    # (e) reads the straight run's log and checkpoint, then removes root
    return dict(out, root=root, straight=texts["a"])


def ckpt_leaves_equal(a: Path, b: Path, step: int) -> int:
    """The leaf count of two checkpoints at ``step`` if every leaf is equal
    bit for bit (dtype, shape and bits), else 0."""
    leaves = {}
    for d in (a, b):
        with np.load(d / f"step_{step:010d}.npz") as z:
            leaves[d] = [z[k] for k in sorted(z.files)
                         if k.startswith("leaf_")]
    same = len(leaves[a]) == len(leaves[b]) > 0 and all(
        x.dtype == y.dtype and np.array_equal(x, y)
        for x, y in zip(leaves[a], leaves[b]))
    return len(leaves[a]) if same else 0


def sharded_train_model(mesh, device: str = "cuda"):
    """stablelm-3b uncut from 3r (b)'s seed, placed on ``mesh`` by the
    reference's specs; its optimizer state, step function and specs."""
    from repro_torch.configs import get_config, get_train_config
    from repro_torch.models import build_model
    from repro_torch.train import sharding as shd
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.steps import make_train_step

    cfg, tcfg = get_config(TRAIN_ARCH), get_train_config(TRAIN_ARCH)
    model = build_model(cfg, generator=torch.Generator(device=device)
                        .manual_seed(0), device=device)
    specs = shd.infer_param_specs(model, mesh)
    shd.place(model, mesh, specs)
    opt = init_opt_state(model, tcfg)
    step_fn = make_train_step(model, tcfg, n_microbatches=TRAIN_MICRO,
                              mesh=mesh)
    return cfg, tcfg, model, opt, step_fn, specs


def train_sharded(first: dict, resume: dict, beside=None) -> dict:
    """3r (e): the sharded trainer at world 1 against (b)'s first step,
    its collectives, time, peak and profile, then the CLI under torchrun
    resuming (d)'s checkpoint (module docstring), ``beside()`` running
    meanwhile (phase 4r), its result under ``"beside"``."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import count_dispatched_collectives
    from repro_torch.train import sharding as shd
    from repro_torch.train.optimizer import local

    lm.init_distributed("cuda", store=dist.HashStore(), rank=0,
                        world_size=1)
    try:
        mesh = lm.make_host_mesh((1, 1), device="cuda")
        cfg, tcfg, model, opt, step_fn, pspecs = sharded_train_model(mesh)
        meta, _, _ = specs.param_specs(TRAIN_ARCH, {"data": 1,
                                                    "model": 1})
        state, ospecs = specs.opt_specs(TRAIN_ARCH, {"data": 1, "model": 1},
                                        meta)
        reckoned = specs.rank_bytes(meta, state, tcfg, mesh, pspecs, ospecs)
        del meta, state
        batch = train_source(cfg, TRAIN_BATCH, TRAIN_SEQ).next_batch(0)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        (opt, met), first_s = sync_wall(lambda: step_fn(opt, 0, batch))
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        require_no_kernel("sharded train step", launches)
        metrics = finite_metrics("sharded train step", met)
        same = {k: bits_equal(met[k].detach().cpu(), first["metrics"][k])
                for k in ("loss", "grad_norm")}
        rel = {k: abs(metrics[k] - float(first["metrics"][k]))
               / abs(float(first["metrics"][k])) for k in same}
        for n, want in first["weights"].items():
            got = local(model.get_parameter(n)).detach().cpu()
            same[n] = bits_equal(got, want)
            rel[n] = _rel_err(got, want)
        (opt, _), calls = count_dispatched_collectives(
            lambda: step_fn(opt, 1, batch))  # the dry run's counter
        (opt, _), prof = device_profile(lambda: step_fn(opt, 2, batch))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        out = dict(arch=TRAIN_ARCH, mesh={"data": 1, "model": 1},
                   launches=launches, metrics=metrics, bit_for_bit=same,
                   rel_diff=rel, first_step_s=first_s,
                   first_step_s_unsharded=first["step_s"],
                   collectives_a_step=calls,
                   step_s=prof["wall_ms"] / 1e3,
                   tokens_per_s=tokens / (prof["wall_ms"] / 1e3),
                   reckoned_rank_bytes=reckoned, resident_bytes=resident,
                   peak_bytes=peak,
                   peak_over_reckoned=peak / reckoned["total"],
                   idle_share=prof["idle_share"],
                   placements={n: [repr(p) for p in model.get_parameter(n)
                                   .placements]
                               for n in TRAIN_SHARDED_WEIGHTS})
        log(f"[phase3r] (e) {json.dumps(out)}")
        log(f"[phase3r] (e) sharded train step profile: {json.dumps(prof)}")
        out["profile"] = prof
        del model, opt, batch, step_fn
    finally:
        lm.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    if not all(same.values()):
        raise AssertionError(f"3r (e): the world-1 sharded step is not (b)'s "
                             f"first step bit for bit: {same}, {rel}")
    out["cli"], out["beside"] = train_cli_torchrun(resume, beside)
    n_dev = torch.cuda.device_count()
    if n_dev >= 2:
        out["ranks"] = run_train_ranks(n_dev, first)
    else:
        log("[phase3r] (e) world=1: one card, so the multi-rank sharded "
            "steps ran only in the CPU tests (tests/test_torch_train_"
            "sharded.py, 4 gloo ranks)")
    return out


def train_cli_torchrun(resume: dict, beside=None) -> tuple:
    """3r (e): ``torchrun --nproc-per-node 1`` of the train CLI (its
    ``main``, through ``--train-cli``) resuming (d)'s 2-step checkpoint on
    the card: exit 0, steps 2-3's losses as (d)'s straight run's lines,
    the step-4 checkpoint bit for bit, no kernel launched.  ``beside()``
    runs meanwhile (:func:`run_beside`); its result is returned second."""
    root = resume["root"]
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1", str(ROOT / "chip_smoke.py"),
            "--train-cli", "--", *TRAIN_RESUME, "--steps", "4",
            "--ckpt-dir", str(root / "e")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc, wall, beside_out = run_beside(argv, env, beside, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"3r (e) torchrun train CLI exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    lines = lambda text: re.findall(r"\[train\] step=(\d+) loss=(\S+)", text)
    got, want = lines(proc.stdout), lines(resume["straight"])[2:]
    launches = json.loads(re.search(r"\[train-cli\] rank 0 launches (.*)",
                                    proc.stdout).group(1))
    same = ckpt_leaves_equal(root / "a", root / "e", 4)
    out = dict(wall_s=wall, resumed="[train] resumed from step 2" in
               proc.stdout, losses=got, straight=want, leaves=same,
               launches=launches)
    log(f"[phase3r] (e) torchrun --nproc-per-node 1 train CLI resume"
        f"{' (beside 4r)' if beside else ''}: {json.dumps(out)}")
    shutil.rmtree(root, ignore_errors=True)
    require_no_kernel("torchrun train CLI", launches)
    if not (out["resumed"] and got == want and len(got) == 2 and same):
        raise AssertionError(f"3r (e): the torchrun CLI's resume is not the "
                             f"straight run's: {out}")
    return out, beside_out


def train_cli_main(argv: list) -> int:
    """``--train-cli ARGS``: ``repro_torch.launch.train.main(ARGS)`` in this
    rank (under ``torchrun``), then its kernel launches on one line."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    tuner_off()
    rc = train.main(argv)
    print(f"[train-cli] rank {os.environ.get('RANK', '0')} launches "
          f"{json.dumps(ops.launch_counts())}", flush=True)
    return rc


def run_train_ranks(n_dev: int, first: dict) -> dict:
    """3r (e) with >= 2 cards: ``torchrun`` of ``--train-ranks`` over every
    card (:func:`train_ranks_main`); its metrics against (b)'s first step
    (loss 1e-5, grad norm 2e-4 relative, tests/test_torch_train_sharded.py's
    tolerances)."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n_dev), str(ROOT / "chip_smoke.py"),
            "--train-ranks"]
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"3r (e) ranks exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("[phase3r] (e) world=")][-1]
    log(line)
    got = json.loads(line.split(" ", 3)[3])
    want = {k: float(v) for k, v in first["metrics"].items()}
    if abs(got["loss"] - want["loss"]) > 1e-5 * abs(want["loss"]) or \
            abs(got["grad_norm"] - want["grad_norm"]) > \
            2e-4 * want["grad_norm"]:
        raise AssertionError(f"3r (e) world={n_dev}: {got} against {want}")
    return got


def train_ranks_main() -> int:
    """``--train-ranks``: one rank of 3r (e)'s multi-card step, under
    ``torchrun``: stablelm-3b placed on ``(world, 1)``, (b)'s batch and
    step 0; rank 0 prints the metrics on one line."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.launch import mesh as lm

    tuner_off()
    lm.init_distributed("cuda")
    try:
        mesh = lm.make_host_mesh(device="cuda")
        cfg, _, _, opt, step_fn, _ = sharded_train_model(mesh)
        batch = train_source(cfg, TRAIN_BATCH, TRAIN_SEQ).next_batch(0)
        (_, met), wall = sync_wall(lambda: step_fn(opt, 0, batch))
        out = {**{k: float(v) for k, v in met.items()}, "step_s": wall}
        if dist.get_rank() == 0:
            print(f"[phase3r] (e) world={dist.get_world_size()} "
                  f"{json.dumps(out)}", flush=True)
    finally:
        lm.shutdown()
    return 0


def train_paths(beside=None) -> dict:
    """Phase 3r (module docstring); ``beside()`` runs beside 3r (e)'s
    torchrun CLI, its result under ``out["sharded"]["beside"]``."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase3r] {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
        f"allocated by the earlier phases")
    out = dict(cli=train_cli(), step=train_step_main(),
               families=train_families(), resume=train_resume())
    out["sharded"] = train_sharded(out["step"].pop("first"),
                                   out["resume"], beside)
    return out


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return max_abs_diff(got, want) / max(float(want.abs().max()), 1e-30)


def train_parity() -> list:
    """Phase 4r: one Adam step of each of ``TRAIN_PARITY`` in f32 (an f32
    accumulator) with the same weights and batch on the card and on the
    host: metrics within ``TRAIN_TOL`` relative, every gradient and every
    updated weight within ``TRAIN_TOL`` of its largest magnitude."""
    from repro_torch.configs import get_config, get_train_config
    from repro_torch.models import DecoderLM, build_model
    from repro_torch.train.optimizer import apply_updates, init_opt_state
    from repro_torch.train.steps import accumulate_grads

    rows = []
    for arch, cut in TRAIN_PARITY:
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **cut)
        tcfg = dataclasses.replace(get_train_config(arch),
                                   grad_dtype="float32")
        models = {"card": build_model(
            cfg, generator=torch.Generator(device="cuda").manual_seed(4),
            device="cuda")}
        models["host"] = DecoderLM(cfg, device="cpu")
        models["host"].load_state_dict(models["card"].state_dict())
        batch = train_source(cfg, TRAIN_PARITY_BATCH,
                             TRAIN_PARITY_SEQ).next_batch(0)
        runs, walls = {}, {}
        for name in ("card", "host"):
            model = models.pop(name)
            dev = model.embed.device
            t0 = time.perf_counter()
            grads, metrics = accumulate_grads(
                model, tcfg, {k: v.to(dev) for k, v in batch.items()},
                n_microbatches=TRAIN_MICRO)
            opt, gnorm = apply_updates(model, grads,
                                       init_opt_state(model, tcfg), 0, tcfg)
            runs[name] = dict(
                metrics={**{k: float(v) for k, v in metrics.items()},
                         "grad_norm": float(gnorm)},
                grads={n: g.cpu() for n, g in grads.items()},
                weights={n: p.detach().cpu()
                         for n, p in model.named_parameters()})
            walls[name] = time.perf_counter() - t0
            del model, grads, opt
            gc.collect()
            torch.cuda.empty_cache()
        mc, mh = runs["card"]["metrics"], runs["host"]["metrics"]
        rel = {k: abs(mc[k] - mh[k]) / abs(mh[k]) if mh[k] else abs(mc[k])
               for k in mh}
        metric_rel = max(rel.values())
        grad_rel = max(_rel_err(runs["card"]["grads"][n], g)
                       for n, g in runs["host"]["grads"].items())
        weight_rel = max(_rel_err(runs["card"]["weights"][n], w)
                         for n, w in runs["host"]["weights"].items())
        row = dict(arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
                   batch=TRAIN_PARITY_BATCH, seq=TRAIN_PARITY_SEQ,
                   microbatches=TRAIN_MICRO, metrics_card=mc,
                   rel_metric_diff=rel, max_rel_metric_diff=metric_rel,
                   max_rel_grad_diff=grad_rel,
                   max_rel_weight_diff=weight_rel, tol=TRAIN_TOL,
                   card_s=walls["card"], host_s=walls["host"])
        log(f"[phase4r] {json.dumps(row)}")
        rows.append(row)
        del runs
        gc.collect()
        if max(metric_rel, grad_rel, weight_rel) > TRAIN_TOL:
            raise AssertionError(f"training GPU vs CPU parity failed: {row}")
    return rows


# phase 3s: -method auto, the hot-swap and solve serving
AUTO_GARNET_CHOICE = "mpi"          # tests/test_torch_adaptive.py CHOICE
SWAP_N = 1_000_000                  # (b)'s chain_walk
SERVE_REQUESTS = 6                  # (c)'s materialized garnets ...
SERVE_NS = (500_000, 1_000_000)     # ... with these state counts
SERVE_MF_N, SERVE_MF_B = 50_000, 2      # (c)'s matrix-free gamma sweep
SERVE_MF_GAMMAS = (0.9, 0.95)           # ... over this range
SERVE_DENSE_N, SERVE_DENSE_B = 8_192, 2  # (c)'s dense requests
SERVE_RATE, SERVE_CLIENTS = 20.0, 4
SERVE_WINDOW, SERVE_MAX_BATCH = 0.05, 4
FLEET_ATOL = 1e-9        # tests/test_torch_fleet.py: values, of |v|_inf


def serve_workload(path: Path) -> list[dict]:
    """(c)'s request stream, written as the serve CLI's JSONL: 6 garnets
    of 500,000 or 1,000,000 states (distinct seeds), a matrix-free gamma
    sweep of 2 deferred garnets of 50,000 (gamma 0.9-0.95: the eager
    row constructors rebuild every chunk in every backup, ROADMAP queue 3
    item 9) and 2 dense garnets, in a seeded order."""
    rng = np.random.default_rng(11)
    specs = [dict(instance="garnet", n=int(rng.choice(SERVE_NS)), m=M, k=K,
                  gamma=GAMMA, seed=100 + i) for i in range(SERVE_REQUESTS)]
    specs += [dict(instance="garnet", n=SERVE_MF_N, m=M, k=K, gamma=g,
                   seed=200, deferred=True,
                   overrides={"-mdp_materialize": "matrix_free"})
              for g in fleet_gammas(*SERVE_MF_GAMMAS, SERVE_MF_B)]
    specs += [dict(instance="garnet", n=SERVE_DENSE_N, m=M, k=K,
                   gamma=GAMMA, seed=300 + i, dense=True)
              for i in range(SERVE_DENSE_B)]
    specs = [specs[i] for i in rng.permutation(len(specs))]
    path.write_text("".join(json.dumps(x) + "\n" for x in specs))
    return specs


def _bucket_kind(spec: dict) -> str:
    if spec.get("deferred"):
        return "matrix_free"
    if spec.get("dense"):
        return "dense"
    return f"ell_{spec['n']}"


def _served_core(spec: dict, mdp):
    """The host tables a served request was solved on (a matrix-free
    request's built on the card, bit for bit the host's, then copied) and
    the core a solo solve of it takes."""
    if spec.get("deferred"):
        host = mdp.build("cuda", materialize="device").to("cpu")
        mdp.evict()
        return host, mdp.build("cuda", materialize="matrix_free")
    return mdp.core, mdp.core


def _certify_served(spec, host, v, pi) -> float:
    """The independent CPU backup of a served float64 value vector."""
    from repro_torch.core.mdp import DenseMDP
    from repro_torch.kernels import ref

    if not isinstance(host, DenseMDP):
        return certify_on_cpu(host, v, pi, f"served {_bucket_kind(spec)}")
    tv, tpi = ref.dense_backup(host.p, host.cost, host.gamma,
                               torch.from_numpy(v))
    res = float(torch.max(torch.abs(tv - torch.from_numpy(v))))
    slack = 16 * np.finfo(np.float64).eps * float(np.abs(v).max())
    if not res <= 1e-8 + slack or not np.array_equal(tpi.numpy(), pi):
        raise AssertionError(f"served dense: ||Tv - v||_inf = {res}, "
                             f"policy equal "
                             f"{np.array_equal(tpi.numpy(), pi)}")
    return res


def _held_to_solo(what: str, served, solo) -> float:
    """A served lane against its solo solve: policy and counts exact,
    values within FLEET_ATOL |v|_inf (tests/test_torch_fleet.py)."""
    dv = float(np.abs(served.v - solo.v).max())
    tol = FLEET_ATOL * max(1.0, float(np.abs(solo.v).max()))
    if not (np.array_equal(served.policy, solo.policy)
            and (served.outer_iterations, served.inner_iterations)
            == (solo.outer_iterations, solo.inner_iterations)
            and dv <= tol):
        raise AssertionError(
            f"{what}: served {served.summary()} against solo "
            f"{solo.summary()}, max |dv| {dv} (tol {tol}), policy equal "
            f"{np.array_equal(served.policy, solo.policy)}")
    return dv


def serve_paths(mdp, main: dict) -> dict:
    """Phase 3s: (a) ``--method auto`` through the CLI on the phase-2
    garnet, (b) the ``-adapt_on_stagnation`` hot-swap on a chain of 10^6
    states, (c) ``repro_torch.launch.serve`` on the card, (d) admission
    and drain in-process; each path with its launch counts."""
    from repro_torch.adaptive import probe
    from repro_torch.api import MDP, madupite_session
    from repro_torch.core import driver, generators
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import solve as cli
    from repro_torch.serve import AdmissionError, Server

    OUT.mkdir(parents=True, exist_ok=True)
    launches: dict = {}
    t_phase = time.perf_counter()

    def lap(what: str) -> None:
        log(f"[time] 3s {what} done at +{time.perf_counter() - t_phase:.1f}s")

    # (a) -method auto through the CLI
    v_path, pi_path = OUT / "auto_v.npy", OUT / "auto_pi.npy"
    stats_path = OUT / "auto_stats.jsonl"
    stats_path.unlink(missing_ok=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc, text = run_cli(cli.main, [
        "--instance", "garnet", "--n", str(N), "--m", str(M), "--k", str(K),
        "--gamma", str(GAMMA), "--method", "auto", "--atol", "1e-8",
        "--option", f"file_cost={v_path}",
        "--option", f"file_policy={pi_path}",
        "--option", f"file_stats={stats_path}"])
    t_cli = time.perf_counter() - t0
    launches["auto_cli"] = ops.launch_counts()
    if rc != 0:
        raise AssertionError(f"CLI --method auto exited {rc}")
    require_launched("CLI --method auto", launches["auto_cli"], ELL_KERNELS)
    entry = read_stats(stats_path)
    ad = entry["adaptive"]
    choice = ad["choice"]["method"]
    if choice != AUTO_GARNET_CHOICE or "[solve] auto-selected" not in text \
            or "[solve] probe:" not in text:
        raise AssertionError(f"--method auto chose {choice} (the CPU test "
                             f"fixes {AUTO_GARNET_CHOICE}) or printed no "
                             f"profile / choice")
    res = certify_on_cpu(mdp, np.load(v_path), np.load(pi_path),
                         "--method auto: independent CPU backup")
    popts = IPIOptions(method="auto", dtype="float64", atol=1e-8,
                       max_outer=2000)
    ops.reset_launch_counts()
    probe(mdp, popts, device="cuda")
    probe_launches = ops.launch_counts()
    solve_launches = {k: v - probe_launches[k]
                      for k, v in launches["auto_cli"].items()}
    auto = dict(choice=ad["choice"], profile=ad["profile"],
                methods=ad["methods"], outer=entry["solves"][0][
                    "outer_iterations"],
                inner=entry["solves"][0]["inner_iterations"],
                solve_wall_s=entry["wall_s"], cli_wall_s=t_cli,
                fixed_3a_solve_wall_s=main["cli_solve_wall_s"],
                fixed_3a_cli_wall_s=main["cli_wall_s"],
                probe_launches=probe_launches,
                solve_launches=solve_launches, cpu_residual=res)
    # a second solve of the family hits the session's choice cache: the
    # same launches as a plain solve of the chosen method (no probe)
    with madupite_session({"-method": "auto", "-dtype": "float64",
                           "-atol": 1e-8}) as s:
        ops.reset_launch_counts()
        s.solve(MDP(mdp))
        first = ops.launch_counts()
        ops.reset_launch_counts()
        r2 = s.solve(MDP(mdp))
        second = ops.launch_counts()
        cached = s.stats[-1]["adaptive"]
    ops.reset_launch_counts()
    plain = driver.solve(mdp, IPIOptions(method=choice, dtype="float64",
                                         atol=1e-8, max_outer=2000),
                         device="cuda")
    plain_launches = ops.launch_counts()
    if cached["profile"] is not None or second != plain_launches \
            or not same_bits(r2, plain):
        raise AssertionError(f"second auto solve: profile "
                             f"{cached['profile']}, launches {second} "
                             f"against a plain {choice} solve's "
                             f"{plain_launches}, bits equal "
                             f"{same_bits(r2, plain)}")
    auto.update(session_first_launches=first, session_cached_launches=second)
    log(f"[phase3s] (a) CLI --method auto: {json.dumps(auto)}")
    lap("(a)")

    # (b) -adapt_on_stagnation: a diverging Chebyshev hot-swapped
    chain = generators.chain_walk(SWAP_N, gamma=GAMMA)
    sw_opts = {"-method": "ipi_chebyshev", "-adapt_on_stagnation": True,
               "-safeguard": False, "-divtol": 10.0, "-atol": 1e-3,
               "-max_inner": 64, "-max_outer": 3000, "-dtype": "float64"}
    ops.reset_launch_counts()
    with madupite_session(sw_opts) as s:
        rs, t_sw = timed_solve(lambda: s.solve(MDP(chain)))
        sw = s.stats[-1]["adaptive"]
    launches["auto_swap"] = ops.launch_counts()
    require_launched("adapt_on_stagnation", launches["auto_swap"],
                     ELL_KERNELS)
    if not (rs.converged and sw["swaps"]
            and sw["swaps"][0]["from_method"] == "ipi_chebyshev"
            and sw["swaps"][0]["resumed"]):
        raise AssertionError(f"hot-swap: {rs.summary()}, swaps "
                             f"{sw['swaps']}")
    res_sw = certify_on_cpu(chain, rs.v, rs.policy,
                            "hot-swap: independent CPU backup", atol=1e-3)
    swap = dict(methods=sw["methods"], swaps=sw["swaps"],
                outer=rs.outer_iterations, inner=rs.inner_iterations,
                wall_s=t_sw, cpu_residual=res_sw)
    log(f"[phase3s] (b) hot-swap: {json.dumps(swap)}")
    del chain
    lap("(b)")

    # (c) the serve CLI on the card
    workload = OUT / "serve_workload.jsonl"
    specs = serve_workload(workload)
    argv = ["--workload", str(workload), "--rate", str(SERVE_RATE),
            "--clients", str(SERVE_CLIENTS), "--prebuild",
            "--window", str(SERVE_WINDOW), "--seed", "5",
            "--option", "method=auto", "--option", "atol=1e-8",
            "--option", f"serve_max_batch={SERVE_MAX_BATCH}",
            "--option", f"serve_max_states={max(SERVE_NS)}"]
    keep: dict = {}
    ops.reset_launch_counts()
    rc, text = run_cli(lambda a: serve_cli.main(a, keep=keep), argv)
    launches["serve"] = ops.launch_counts()
    if rc != 0:
        raise AssertionError(f"serve CLI exited {rc}")
    lap("(c) serving")
    # the same stream again on the same MDPs, under the profiler: the
    # serving window's device busy time and idle share
    window: dict = {}
    again: dict = {}
    rc2, _ = run_cli(lambda a: serve_cli.main(
        a, keep=again, mdps=keep["mdps"],
        window=lambda: profiled(window)), argv)
    if rc2 != 0:
        raise AssertionError(f"serve CLI (profiled) exited {rc2}")
    window["served_wall_s"] = again["wall"]
    window["dispatches"] = again["stats"]["dispatches"]
    del again
    lap("(c) profiled serving")
    require_launched("serve CLI", launches["serve"],
                     ELL_KERNELS + ("dense_backup",))
    outcomes, mdps, st, dlog = (keep["outcomes"], keep["mdps"],
                                keep["stats"], keep["log"])
    if not all(o["converged"] for o in outcomes):
        raise AssertionError("serve: a request did not converge")
    lats = sorted(o["latency"] for o in outcomes)
    # one request of each bucket kind: certified on the CPU, held to a solo
    # solve of its bucket's method on the card
    checked = {}
    for i, (spec, o) in enumerate(zip(specs, outcomes)):
        kind = _bucket_kind(spec)
        if kind in checked:
            continue
        method = dlog[o["dispatch"]]["method"]
        host, core = _served_core(spec, mdps[i])
        r = o["result"]
        res_c = _certify_served(spec, host, r.v, r.policy)
        ops.reset_launch_counts()
        solo, t_solo = timed_solve(lambda: driver.solve(
            core, IPIOptions(method=method, dtype="float64", atol=1e-8,
                             max_outer=2000), device="cuda"))
        dv = _held_to_solo(f"served {kind}", r, solo)
        checked[kind] = dict(request=i, dispatch=o["dispatch"],
                             method=method, cpu_residual=res_c,
                             max_abs_dv_solo=dv, latency_s=o["latency"],
                             solo_wall_s=t_solo,
                             solo_launches=ops.launch_counts())
        del host, core
    serve = dict(
        requests=len(specs), wall_s=keep["wall"],
        throughput_rps=len(outcomes) / keep["wall"],
        latency_p50_s=float(np.percentile(lats, 50, method="nearest")),
        latency_p95_s=float(np.percentile(lats, 95, method="nearest")),
        latency_mean_s=float(np.mean(lats)), dispatches=st["dispatches"],
        padded_lanes=st["padded_lanes"], batch=st["batch"],
        program_cache={k: st["program_cache"][k] for k in
                       ("hits", "misses", "evictions", "hit_rate")},
        slots=st["program_cache"]["slots"],
        buckets=[{k: d[k] for k in ("dispatch", "n_pad", "slot", "method",
                                    "seconds", "launches")}
                 for d in dlog],
        requests_by_bucket={str(d["dispatch"]): len(d["requests"])
                            for d in dlog},
        window=window, checked=checked)
    log(f"[phase3s] (c) serve: {json.dumps(serve)}")
    lap("(c) checks")

    # the cost of padded slots: one served bucket's lanes solved unpadded
    # and at the next slot of the pow2 grid (a duplicate lane, as the
    # scheduler pads), in turns
    lanes = [mdps[i] for i, sp in enumerate(specs)
             if _bucket_kind(sp) == f"ell_{max(SERVE_NS)}"][:3]
    padded = dict(lanes=len(lanes), slot=4)
    with madupite_session({"-method": AUTO_GARNET_CHOICE,
                           "-dtype": "float64", "-atol": 1e-8,
                           "-fleet_bucketing": "off"}) as s:
        walls = {"unpadded": [], "padded": []}
        counts = {}
        for turn in ("unpadded", "padded", "padded", "unpadded"):
            fleet = lanes + [lanes[0]] * (turn == "padded")
            ops.reset_launch_counts()
            _, t = timed_solve(lambda: s.solve_fleet(fleet))
            walls[turn].append(t)
            counts[turn] = ops.launch_counts()
    padded.update(walls_s=walls, launches=counts,
                  cost=statistics.mean(walls["padded"])
                  / statistics.mean(walls["unpadded"]) - 1.0)
    if counts["padded"] != counts["unpadded"]:
        raise AssertionError(f"padded slot: launches {counts}")
    log(f"[phase3s] (c) padded slot: {json.dumps(padded)}")
    lap("(c) padded slot")

    # (d) admission and drain on the card, in-process
    with Server({"-method": AUTO_GARNET_CHOICE, "-dtype": "float64",
                 "-atol": 1e-8, "-serve_max_states": N - 1,
                 "-serve_batch_window": 600.0}) as srv:
        rejected = []
        for what, sub in (
                ("materialized", lambda: srv.submit(MDP(mdp))),
                ("matrix_free", lambda: srv.submit(
                    MDP.from_generator("garnet", deferred=True,
                                       n=20 * N, m=M, k=K, gamma=GAMMA),
                    mdp_materialize="matrix_free"))):
            try:
                sub()
            except AdmissionError as e:
                rejected.append((what, e.reason))
        small = [mdps[i] for i, sp in enumerate(specs)
                 if _bucket_kind(sp) == f"ell_{min(SERVE_NS)}"][:2]
        reqs = [srv.submit(m) for m in small]
        drained = srv.drain(timeout=600)
        done = [r.done and r.result(timeout=0).converged for r in reqs]
        st_d = srv.stats()
    if rejected != [("materialized", "too_large"),
                    ("matrix_free", "too_large")] \
            or not drained or not all(done):
        raise AssertionError(f"admission: rejected {rejected}, drained "
                             f"{drained}, done {done}")
    admission = dict(rejected=rejected, drained=drained,
                     completed=st_d["completed"],
                     dispatches=st_d["dispatches"])
    log(f"[phase3s] (d) admission and drain: {json.dumps(admission)}")
    lap("(d)")
    del mdps, keep
    gc.collect()
    return dict(launches=launches, auto=auto, swap=swap, serve=serve,
                padded=padded, admission=admission)




# --------------------------------------------------------------------------- #
# phase 3t: the kernel options and the launch tuner                           #
# --------------------------------------------------------------------------- #

TUNE_CACHE = OUT / "autotune.json"       # the tuner cache of every process
TUNE_CANDIDATES = OUT / "autotune_3t_a.json"  # 3t (a)'s winners
TUNE_REPS = 10                           # 3t (a): timed calls a candidate
EXAMPLE_TIMEOUT = 300                    # 3t (c), (e), (f): each process
# 3t (a)'s rows (kernel, form, dtype, the candidates' ms, the default's,
# the tuner's winner, the bound), and each sub-phase's seconds
TUNE = {"rows": [], "seconds": {}}


def tuner_off() -> None:
    """Before phase 2: the earlier phases run with the launch tuner off
    (the kernels' fixed shapes, so that their walls compare with runs
    before the tuner), in this process and every process it starts, all pointed at :data:`TUNE_CACHE` under
    ``build/`` (``MADUPITE_OPTIONS``), so that no run writes elsewhere."""
    from repro_torch.kernels import tuning

    os.environ["MADUPITE_OPTIONS"] = " ".join(filter(None, (
        os.environ.get("MADUPITE_OPTIONS", ""), "-kernel_tune off",
        f"-kernel_tune_cache {shlex.quote(str(TUNE_CACHE))}")))
    tuning.configure(enabled=False, cache_path=str(TUNE_CACHE))
    TUNE_CANDIDATES.unlink(missing_ok=True)


@contextlib.contextmanager
def tuner_on(path: Path, fresh: bool = True):
    """The tuner on, on the file ``path`` (emptied first if ``fresh``), for
    the body; off again on :data:`TUNE_CACHE` after it."""
    from repro_torch.kernels import tuning

    if fresh:
        path.unlink(missing_ok=True)
    tuning.reset(cache_path=str(path))
    try:
        yield tuning
    finally:
        tuning.reset(cache_path=str(TUNE_CACHE))
        tuning.configure(enabled=False)


def tune_key(kernel: str, n: int, m: int, k: int, dt) -> str:
    from repro_torch.kernels import tuning

    return tuning.cache_key(kernel, tuning.backend(torch.device("cuda")), n,
                            m, k, str(dt).replace("torch.", ""))


def candidate_rows(kernel: str, case: str, key: str, dt, cands, default,
                   run, plain, tuned, nbytes: int, flops: int) -> dict:
    """3t (a): every candidate launch shape of one call bit for bit its
    plain version's outputs, each timed (median of :data:`TUNE_REPS`
    CUDA-event calls behind a spin); then ``tuned()``, the dispatch with
    the tuner on, whose winner is read back by its key."""
    from repro_torch.kernels import ops

    want = plain()
    torch.cuda.synchronize()
    times = {}
    for c in cands:
        got = run(c)
        torch.cuda.synchronize()
        if not all(bits_equal(a, w) for a, w in zip(got, want)):
            raise AssertionError(
                f"3t (a) {key} candidate {c}: != plain version (max |diff| "
                f"{max(max_abs_diff(a, w) for a, w in zip(got, want))})")
        times[str(c)] = time_ms(lambda c=c: run(c), reps=TUNE_REPS)
    del got, want
    with tuner_on(TUNE_CANDIDATES, fresh=False):
        out = tuned()
        torch.cuda.synchronize()
        winner = ops.launch_shapes()[key]
    del out
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    row = dict(kernel=kernel, case=case, key=key,
               dtype=str(dt).replace("torch.", ""),
               ms_by_candidate=times, default=str(default),
               default_ms=times[str(default)], winner=str(winner),
               winner_ms=times[str(winner)],
               best=min(times, key=times.get), bound_ms=b_ms, bound_by=b_by)
    TUNE["rows"].append(row)
    log(f"[phase3t] (a) {json.dumps(row)}; every candidate bitwise equal")
    return row


def ell_candidates(mdp, gen) -> None:
    """3t (a) on the phase-2 garnet: ``ell_backup`` and ``ell_matvec``
    unbatched, each CTA size, in both dtypes."""
    from repro_torch.kernels import bellman_ell, lanes, ops, ref, spmv_ell

    t0 = time.perf_counter()
    idx, val, cost = mdp.idx, mdp.val, mdp.cost
    n, m, k = idx.shape
    rows_i, rows_v = idx[:, 0].contiguous(), val[:, 0].contiguous()
    for dt in (torch.float64, torch.float32):
        v = torch.from_numpy(gen.random(n) * 50.0).to("cuda", dt)
        candidate_rows(
            "ell_backup", "unbatched", tune_key("ell_backup", n, m, k, dt),
            dt,
            lanes.THREADS, lanes.DEFAULT_THREADS,
            lambda t: bellman_ell.ell_backup(idx, val, cost, GAMMA, v,
                                             threads=t),
            lambda: ref.ell_backup(idx, val, cost, GAMMA, v),
            lambda: ops.ell_backup(idx, val, cost, GAMMA, v),
            idx.nbytes + val.nbytes + cost.nbytes + v.nbytes
            + n * (v.element_size() + 4), n * m * (2 * k + 3))
        candidate_rows(
            "ell_matvec", "unbatched", tune_key("ell_matvec", n, 1, k, dt),
            dt,
            lanes.THREADS, lanes.DEFAULT_THREADS,
            lambda t: (spmv_ell.ell_matvec(rows_i, rows_v, v, threads=t),),
            lambda: (ref.ell_matvec(rows_i, rows_v, v),),
            lambda: ops.ell_matvec(rows_i, rows_v, v),
            rows_i.nbytes + rows_v.nbytes + 2 * v.nbytes, 2 * n * k)
    TUNE["seconds"]["(a) ell"] = time.perf_counter() - t0


def fleet_candidates(fleets: dict, gammas, gen) -> None:
    """3t (a) on 3h's B = 4 fleets (a shared and a batched ``idx``):
    ``ell_backup`` and ``ell_matvec``, each CTA size in both grid
    orders, in both dtypes."""
    from repro_torch.kernels import bellman_ell, lanes, ops, ref, spmv_ell

    t0 = time.perf_counter()
    cands = [f"{t}/{o}" for t in lanes.THREADS for o in lanes.LANE_ORDERS]
    default = f"{lanes.DEFAULT_THREADS}/{lanes.LANE_ORDER}"
    split = lambda c: (int(c.split("/")[0]), c.split("/")[1])
    for kind, f in fleets.items():
        b_, n, m, k = f.val.shape
        rows_i = f.idx[..., 0, :].contiguous()
        rows_v = f.val[:, :, 0].contiguous()
        for dt in (torch.float64, torch.float32):
            v = torch.from_numpy(gen.random((b_, n)) * 50.0).to("cuda", dt)
            g = torch.tensor(gammas, dtype=dt, device="cuda") \
                if kind == "shared" else GAMMA
            candidate_rows(
                "ell_backup", f"B={b_} {kind} idx",
                tune_key("ell_backup[fleet]", n, m, k, dt), dt, cands,
                default,
                lambda c: bellman_ell.ell_backup(
                    f.idx, f.val, f.cost, g, v, threads=split(c)[0],
                    lane_order=split(c)[1]),
                lambda: ref.ell_backup(f.idx, f.val, f.cost, g, v),
                lambda: ops.ell_backup(f.idx, f.val, f.cost, g, v),
                f.idx.nbytes + f.val.nbytes + f.cost.nbytes + v.nbytes
                + b_ * n * (v.element_size() + 4), b_ * n * m * (2 * k + 3))
            candidate_rows(
                "ell_matvec", f"B={b_} {kind} idx",
                tune_key("ell_matvec[fleet]", n, 1, k, dt), dt, cands,
                default,
                lambda c: (spmv_ell.ell_matvec(
                    rows_i, rows_v, v, threads=split(c)[0],
                    lane_order=split(c)[1]),),
                lambda: (ref.ell_matvec(rows_i, rows_v, v),),
                lambda: ops.ell_matvec(rows_i, rows_v, v),
                rows_i.nbytes + rows_v.nbytes + 2 * v.nbytes, 2 * b_ * n * k)
    TUNE["seconds"]["(a) fleet"] = time.perf_counter() - t0


def chunk_candidates(tables, g, v) -> None:
    """3t (a) on 3n (a)'s rebuilt chunk in its shared-table fleet form
    (B = 4 value vectors over one chunk): each CTA size in both grid
    orders."""
    from repro_torch.kernels import bellman_ell, lanes, ops, ref

    t0 = time.perf_counter()
    idx, val, cost = tables
    bn, m, k = idx.shape
    b_ = v.shape[0]
    split = lambda c: (int(c.split("/")[0]), c.split("/")[1])
    candidate_rows(
        "ell_backup", f"3n chunk of {bn} rows, B={b_} shared tables",
        tune_key("ell_backup[shared]", bn, m, k, v.dtype), v.dtype,
        [f"{t}/{o}" for t in lanes.THREADS for o in lanes.LANE_ORDERS],
        f"{lanes.DEFAULT_THREADS}/{lanes.LANE_ORDER}",
        lambda c: bellman_ell.ell_backup(idx, val, cost, g, v,
                                         threads=split(c)[0],
                                         lane_order=split(c)[1]),
        lambda: ref.ell_backup(idx, val, cost, g, v),
        lambda: ops.ell_backup_chunk(idx, val, cost, g, v),
        idx.nbytes + val.nbytes + cost.nbytes + v.nbytes
        + b_ * bn * (v.element_size() + 4),
        b_ * idx.numel() * 2 + b_ * cost.numel() * 3)
    TUNE["seconds"]["(a) chunk"] = TUNE["seconds"].get("(a) chunk", 0.0) \
        + time.perf_counter() - t0


def dense_candidates(dmdp, gen) -> None:
    """3t (a) on phase 5's P: ``dense_backup`` at each CTA size (warps),
    in both dtypes."""
    from repro_torch.kernels import dense_backup, ops, ref

    t0 = time.perf_counter()
    p, cost = dmdp.p, dmdp.cost
    n, m, n_cols = p.shape
    for dt in (torch.float32, torch.float64):
        v = torch.from_numpy(gen.random(n_cols) * 50.0).to("cuda", dt)
        candidate_rows(
            "dense_backup", "unbatched", tune_key("dense_backup", n, m, n_cols, dt), dt,
            dense_backup.WARPS, dense_backup.DEFAULT_WARPS,
            lambda w: dense_backup.dense_backup(p, cost, GAMMA, v, warps=w),
            lambda: ref.dense_backup(p, cost, GAMMA, v),
            lambda: ops.dense_backup(p, cost, GAMMA, v),
            p.nbytes + cost.nbytes + v.nbytes + n * (v.element_size() + 4),
            n * m * (2 * n_cols + 3))
    TUNE["seconds"]["(a) dense"] = time.perf_counter() - t0


def solve_lines(out: str) -> dict:
    """The CLI's kernel launches, tune launches and launch shapes."""
    counts = lambda tag: {k: int(v) for k, v in re.findall(
        r"(\w+)=(\d+)", _line(out, f"[solve] {tag}:"))}
    return dict(launches=counts("kernel launches"),
                tune_launches=counts("tune launches"),
                shapes=json.loads(_line(out, "[solve] launch shapes:")
                                  .split(":", 1)[1]))


def _line(out: str, prefix: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    if len(lines) != 1:
        raise AssertionError(f"want one {prefix!r} line, got {lines}")
    return lines[0]


def run_example(name: str, *args, env=None) -> tuple[int, str, float]:
    """``python examples/torch/<name>.py ARGS`` in a process of its own:
    its exit code, standard output and wall."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"),
         *args], env=env or dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT)
    if proc.returncode != 0:
        log(f"[phase3t] {name} stderr: {proc.stderr[-2000:]}")
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def kernel_option_paths(mdp, main: dict) -> dict:
    """Phase 3t (b)-(f) on the phase-2 garnet (module docstring); 3t (a)'s
    rows were taken where their tables lived."""
    from repro_torch.core import driver
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.kernels import ops, tuning
    from repro_torch.launch import solve as cli

    t_start = time.perf_counter()
    out = {"earlier_phases": "tuning off, cache " + str(TUNE_CACHE)}
    log(f"[phase3t] phases 2-3s, 2d-4f ran with the launch tuner off (the "
        f"kernels' fixed shapes, as before the tuner), MADUPITE_OPTIONS="
        f"{os.environ['MADUPITE_OPTIONS']!r}")
    env_src = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # (e) -kernel_impl cuda on the host must fail: started first, on the CPU
    bad = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.solve", "--instance",
         "garnet", "--n", "1000", "--device", "cpu", "--option",
         "kernel_impl=cuda"], env=env_src, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    # (b) 3a's CLI solve with a fresh cache and tuning on
    argv = ["--instance", "garnet", "--n", str(N), "--m", str(M), "--k",
            str(K), "--gamma", str(GAMMA), "--method", "ipi_gmres",
            "--atol", "1e-8"]
    v_path, pi_path = OUT / "tuned_v.npy", OUT / "tuned_pi.npy"
    with tuner_on(TUNE_CACHE):
        ops.reset_launch_counts()
        s0 = tuning.tuned_seconds()
        t0 = time.perf_counter()
        rc, text = run_cli(cli.main, argv + [
            "--option", "kernel_tune=on", "--option",
            f"kernel_tune_cache={TUNE_CACHE}", "--option",
            f"file_cost={v_path}", "--option", f"file_policy={pi_path}"])
        wall = time.perf_counter() - t0
        tuned_s = tuning.tuned_seconds() - s0
    if rc != 0:
        raise AssertionError(f"3t (b) tuned CLI exited {rc}")
    first = solve_lines(text)
    v, pi = np.load(v_path), np.load(pi_path)
    counts = tuple(map(int, re.search(r"outer=(\d+) inner=(\d+)",
                                      text).groups()))
    want = {k: c for k, c in main["launches"]["cli_ipi_gmres"].items()}
    if not (np.array_equal(v.view(np.uint64), main["cli_v"].view(np.uint64))
            and np.array_equal(pi, main["cli_pi"])
            and counts == (main["cli_outer"], main["cli_inner"])
            and first["launches"] == want):
        raise AssertionError(
            f"3t (b) tuned CLI: counts {counts}, launches "
            f"{first['launches']} against 3a's "
            f"{(main['cli_outer'], main['cli_inner'])}, {want}; values "
            f"bitwise {np.array_equal(v.view(np.uint64), main['cli_v'].view(np.uint64))}")
    if not sum(first["tune_launches"].values()):
        raise AssertionError("3t (b): a fresh cache and tuning on timed "
                             "no candidate")
    cache = TUNE_CACHE.read_bytes()
    out["b"] = dict(wall_s=wall, tuning_s=tuned_s,
                    tuning_share=tuned_s / wall, launches=first["launches"],
                    tune_launches=first["tune_launches"])
    log(f"[phase3t] (b) CLI ipi_gmres f64, fresh cache, tuning on: 3a's "
        f"policy, counts {counts}, value bits and launches "
        f"{first['launches']}; tune launches {first['tune_launches']}; "
        f"wall {wall:.2f}s of which tuning {tuned_s:.3f}s "
        f"({100 * tuned_s / wall:.1f}%)")

    # (c) a second process reading the same file tunes nothing
    env_tuned = dict(env_src, MADUPITE_OPTIONS=(
        f"-kernel_tune on -kernel_tune_cache "
        f"{shlex.quote(str(TUNE_CACHE))}"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.solve",
                           *argv], env=env_tuned, capture_output=True,
                          text=True, timeout=EXAMPLE_TIMEOUT)
    wall_c = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"3t (c) second CLI exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    second = solve_lines(proc.stdout)
    # the in-process CLI printed every shape this process resolved so far
    out["b"]["shapes"] = {key: first["shapes"].get(key)
                          for key in second["shapes"]}
    same = out["b"]["shapes"] == second["shapes"]
    if sum(second["tune_launches"].values()) or not same \
            or not second["shapes"] \
            or second["launches"] != first["launches"] \
            or TUNE_CACHE.read_bytes() != cache:
        raise AssertionError(f"3t (c) second process: tune launches "
                             f"{second['tune_launches']}, shapes "
                             f"{second['shapes']} against "
                             f"{out['b']['shapes']}, launches "
                             f"{second['launches']}")
    out["c"] = dict(wall_s=wall_c, **second)
    log(f"[phase3t] (c) a second CLI process on the same file: 0 tune "
        f"launches, the same shapes {json.dumps(second['shapes'])}, "
        f"launches {second['launches']}, file unchanged, {wall_c:.1f}s")

    # (d) -kernel_impl torch on the card: no hand kernel, 3a's bits
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    r = driver.solve(mdp, IPIOptions(method="ipi_gmres", dtype="float64",
                                     atol=1e-8, max_outer=2000,
                                     impl="torch"), device="cuda")
    wall_d = time.perf_counter() - t0
    plain = ops.launch_counts()
    if any(plain.values()) or not (
            np.array_equal(r.v.view(np.uint64),
                           main["cli_v"].view(np.uint64))
            and np.array_equal(r.policy, main["cli_pi"])
            and (r.outer_iterations, r.inner_iterations)
            == (main["cli_outer"], main["cli_inner"])):
        raise AssertionError(f"3t (d) -kernel_impl torch: launches {plain}, "
                             f"{r.summary()}")
    out["d"] = dict(wall_s=wall_d, launches=plain)
    log(f"[phase3t] (d) -kernel_impl torch on the card: no kernel launched "
        f"{plain}, 3a's bits, policy and counts; wall {wall_d:.2f}s")

    # (f) two examples on the card side by side, their MDP kernels
    # launched
    out["f"] = {}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        examples = {name: pool.submit(run_example, name, env=env_tuned)
                    for name in ("quickstart", "epidemic_control")}
    for name, ran in examples.items():
        rc, text, wall_f = ran.result()
        launched = {k: int(c) for k, c in re.findall(
            r"(\w+)=(\d+)", _line(text, "kernel launches:"))} if rc == 0 \
            else {}
        if rc != 0 or not (launched.get("ell_backup")
                           and launched.get("ell_matvec")):
            raise AssertionError(f"3t (f) examples/torch/{name}.py exited "
                                 f"{rc}, launches {launched}")
        out["f"][name] = dict(wall_s=wall_f, launches=launched)
        log(f"[phase3t] (f) examples/torch/{name}.py on the card (the two "
            f"side by side): exit 0 in {wall_f:.1f}s, launches {launched}")

    # (e) collected last
    try:
        _, err = bad.communicate(timeout=EXAMPLE_TIMEOUT)
    finally:
        if bad.poll() is None:
            bad.kill()
            bad.wait()
    if bad.returncode == 0 or "take CUDA tensors" not in err:
        raise AssertionError(f"3t (e) --device cpu kernel_impl=cuda exited "
                             f"{bad.returncode}: {err[-1000:]}")
    out["e"] = dict(returncode=bad.returncode)
    log(f"[phase3t] (e) CLI --device cpu --option kernel_impl=cuda: exit "
        f"{bad.returncode}, {err.strip().splitlines()[-1]}")
    TUNE["seconds"]["(b)-(f)"] = time.perf_counter() - t_start
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    tuner_off()
    t_start = time.perf_counter()

    def stamp(phase: str) -> None:
        log(f"[time] {phase} at {time.perf_counter() - t_start:.1f}s")

    from repro_torch.core import generators
    from repro_torch.kernels import bellman_ell, build, dense_backup
    from repro_torch.kernels import flash_attention, spmv_ell

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[phase1] {torch.cuda.get_device_name(0)} torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = build.build_all([bellman_ell.SOURCE, spmv_ell.SOURCE,
                            dense_backup.SOURCE, flash_attention.SOURCE])
    log(f"[phase2] kernels built in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    mdp = generators.garnet(n=N, m=M, k=K, gamma=GAMMA, seed=0).to("cuda")
    log(f"[phase2] garnet n={N} m={M} k={K} on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    stamp("2")
    checks = kernel_checks(mdp, np.random.default_rng(1))
    ell_resources = ell_report(libs)
    stamp("2q")
    qchecks = qvalues_checks(mdp, np.random.default_rng(3))
    stamp("3")
    path = main_path(mdp)
    where_time_goes(mdp, "phase3b")
    stamp("3g")
    other = other_paths(mdp, path)
    path["launches"].update(other["launches"])
    stamp("3w")
    path["launches"].update(surface_paths(mdp, path)["launches"])
    stamp("4")
    parity()
    stamp("3h")
    fleet = fleet_paths(mdp)
    path["launches"].update(fleet["launches"])
    stamp("3m/3n")

    def after_3m(meshes):
        mf = matrix_free_paths(meshes, n=MF_N)
        stamp("3p (a)-(c)")
        fl = fleet_layout_paths(fleet)
        return dict(launches={**mf["launches"], **fl["launches"]}, mf=mf,
                    fleet_layouts=fl)

    def beside_3mc():
        stamp("3p (d), beside 3m (c)")
        return fleet_layout_cli(fleet)

    _, sharded = dryrun_cell_beside(lambda: sharded_paths(
        mdp, path, then=after_3m, beside=beside_3mc))
    path["launches"].update(sharded["launches"])
    path["launches"].update(sharded["then"]["launches"])
    fleet_cli = sharded["beside"]
    path["launches"].update(fleet_cli["launches"])
    del fleet["_seeds"], fleet["_results"]
    torch.cuda.empty_cache()
    stamp("3s")
    serve = serve_paths(mdp, path)
    path["launches"].update(serve["launches"])
    stamp("3t")
    ell_candidates(mdp, np.random.default_rng(11))
    kopt = kernel_option_paths(mdp, path)
    del mdp
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ell = generators.garnet(n=DN, m=DM, k=DK, gamma=GAMMA, seed=0).to("cuda")
    dmdp = ell.as_dense()
    dmdp.validate()
    torch.cuda.synchronize()
    log(f"[phase2d] as_dense() of garnet n={DN} m={DM} k={DK} on the card "
        f"({dmdp.p.nbytes / 1e9:.1f} GB) in {time.perf_counter() - t0:.1f}s")
    stamp("2d")
    dchecks = dense_kernel_checks(dmdp, np.random.default_rng(2))
    stamp("3t (a) dense")
    dense_candidates(dmdp, np.random.default_rng(10))
    dpath = dense_main_path(ell, dmdp)
    where_time_goes(dmdp, "phase3e")
    del ell, dmdp
    torch.cuda.empty_cache()
    stamp("3h (c)")
    dfleet = dense_fleet(np.random.default_rng(8))
    dpath["launches"].update(dfleet["launches"])
    dpath["launches"].update(serve["launches"])
    stamp("4d")
    dense_parity()
    stamp("2f")
    fchecks = flash_checks()
    fresources = flash_report(libs[flash_attention.SOURCE])
    stamp("3f")
    lm = lm_main_path()
    stamp("3v")
    placed = lm_placed(lm)
    stamp("4f")
    lm_parity()
    stamp("3l")
    families = lm_family_paths()
    stamp("4l")
    lm_family_parity()
    stamp("3r")

    def beside_3re():
        stamp("4r, beside 3r (e)'s torchrun CLI")
        return train_parity()

    train = train_paths(beside=beside_3re)

    sources = {"ell_backup": ("src/repro_torch/kernels/csrc/ell_backup.cu",
                              "src/repro/kernels/bellman_ell.py:109"),
               "ell_matvec": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                              "src/repro/kernels/spmv_ell.py:53")}
    kernels = []
    for name, (src, replaces) in sources.items():
        f64, f32 = checks[name]["float64"], checks[name]["float32"]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=path["launches"]["cli_ipi_gmres"][name],
            launches_by_path={p: c[name]
                              for p, c in path["launches"].items()},
            max_abs_err=max(f64["max_abs_err"], f32["max_abs_err"]),
            max_abs_diff=max(f64["max_abs_err"], f32["max_abs_err"]),
            ms=f64["ms"], plain_ms=f64["plain_ms"],
            bound_ms=f64["bound_ms"], bound_by=f64["bound_by"],
            library_ms=f64["library_ms"], dtype="float64", float32=f32,
            local_ms=f64["local_ms"], resources=ell_resources[name],
            shape=dict(n=N, m=M, k=K),
            batched=batched_rows(fleet["kernels"][name]),
            launch_shapes=[r for r in TUNE["rows"] if r["kernel"] == name]))
    f32, f64 = dchecks["float32"], dchecks["float64"]
    kernels.append(dict(
        name="dense_backup", route="cuda",
        source="src/repro_torch/kernels/csrc/dense_backup.cu",
        replaces="src/repro/kernels/dense_backup.py:52",
        launches=dpath["launches"]["session_ipi_gmres"]["dense_backup"],
        launches_by_path={p: c["dense_backup"]
                          for p, c in dpath["launches"].items()},
        max_abs_err=max(f64["max_abs_err"], f32["max_abs_err"]),
        max_abs_diff=max(f64["max_abs_err"], f32["max_abs_err"]),
        ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
        bound_by=f32["bound_by"], library_ms=f32["library_ms"],
        library=f32["library"], dtype="float32", float64=f64,
        shape=dict(n=DN, m=DM, n_cols=DN),
        batched=batched_rows(dfleet["kernel"]),
        launch_shapes=[r for r in TUNE["rows"]
                       if r["kernel"] == "dense_backup"]))
    f64, f32 = qchecks["float64"], qchecks["float32"]
    kernels.append(dict(
        name="ell_qvalues", route="cuda",
        source="src/repro_torch/kernels/csrc/ell_spmv.cu",
        replaces="src/repro/kernels/bellman_ell.py:168",
        launches=qchecks["launches"]["ell_qvalues"],
        launches_by_path={
            "ops_ell_qvalues": qchecks["launches"]["ell_qvalues"],
            "ops_ell_qvalues_fleet": fleet["qvalues_launches"][
                "ell_qvalues"]},
        max_abs_err=max(f64["max_abs_err"], f32["max_abs_err"]),
        max_abs_diff=max(f64["max_abs_err"], f32["max_abs_err"]),
        ms=f64["ms"], plain_ms=f64["plain_ms"], bound_ms=f64["bound_ms"],
        bound_by=f64["bound_by"], library_ms=f64["library_ms"],
        library="torch.sparse_csr_tensor @ v, then cost + gamma * pv",
        dtype="float64", float32=f32, shape=dict(n=N, m=M, k=K),
        batched=batched_rows(fleet["kernels"]["ell_qvalues"])))
    main_case = fchecks[FLASH_CASES[0][0]]
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:82",
        launches=lm["launches"]["serve_lm_cli"]["flash_attention"],
        launches_by_path={
            **{p: c["flash_attention"] for p, c in lm["launches"].items()},
            **{f"3l_{arch}_{p}": c["flash_attention"]
               for arch, row in families.items()
               for p, c in (("serve_lm_cli", row.get("cli_launches")),
                            *row["launches"].items()) if c},
            **{f"3v_{k}_prefill": v["flash_attention"]
               for k, v in placed["launches"].items()},
            "train": train["step"]["launches"]["flash_attention"],
            "train_cli": train["cli"]["launches"]["flash_attention"],
            "train_sharded":
                train["sharded"]["launches"]["flash_attention"],
            "train_cli_torchrun":
                train["sharded"]["cli"]["launches"]["flash_attention"],
            **{f"3r_{r['arch']}_{r['layers']}_{r['optimizer']}":
               r["launches"]["flash_attention"]
               for r in train["families"]}},
        max_abs_err=max(r["max_abs_err"] for r in fchecks.values()),
        ms=main_case["ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"],
        library="scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True)",
        dtype="bfloat16", shape=main_case["shape"], cases=fchecks,
        resources=fresources))
    log(f"[phase3t] kernel options and the tuner: "
        f"{json.dumps(TUNE['seconds'])}, "
        f"{sum(TUNE['seconds'].values()):.1f}s in all; "
        f"{json.dumps(kopt)}")
    stamp("end")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ranks"]:
        # --ranks DEVICE [N MAZE_SIZE]: one rank of phase 3m (d)
        sys.exit(ranks_main(sys.argv[2], *map(int, sys.argv[3:5])))
    if sys.argv[1:2] == ["--train-cli"]:
        # --train-cli [--] ARGS: the train CLI in one rank of phase 3r (e)
        sys.exit(train_cli_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--train-ranks"]:
        sys.exit(train_ranks_main())    # one rank of phase 3r (e), >= 2 cards
    sys.exit(main())
